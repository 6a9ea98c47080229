"""The contrastive trainer in the PyTorch port against the JAX package:
``contrastive_loss``, the train step (the masked margin loss over (orig,
comp, other) triples, its metrics and one Adam step), a 5-step trajectory,
the eval step (candidates ranked by embedding distance) and
``cli/contrastive.py``.  Sizes as ``test_torch_zoo`` (dim_v 128, K 24, B
16), f32, the weights carried by ``models/from_jax``.
"""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from vqa_counterexamples_tpu.core import policy as jax_policy
from vqa_counterexamples_tpu.data import synthetic as jax_synthetic
from vqa_counterexamples_tpu.data import vqacx as jax_vqacx
from vqa_counterexamples_tpu.engines import contrastive_engine as jax_ce
from vqa_counterexamples_tpu.engines import cx_engine as jax_engine
from vqa_counterexamples_tpu_torch.cli import contrastive as port_cli
from vqa_counterexamples_tpu_torch.data import vqacx as port_vqacx
from vqa_counterexamples_tpu_torch.engines import contrastive_engine as ce
from vqa_counterexamples_tpu_torch.engines import cx_engine as port_engine
from vqa_counterexamples_tpu_torch.models import from_jax

from test_torch_slice import _tiny_cli_options
from test_torch_zoo import zoo_pair

K, B, LR = 24, 16, 1e-3
METRICS = ("loss", "loss_comp", "loss_other", "dist_comp", "dist_other")


@pytest.fixture(autouse=True)
def f32(monkeypatch):
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "float32")
    with jax_policy.compute_dtype_scope("float32"):
        yield


@pytest.fixture(scope="module")
def world():
    dataset, store = jax_synthetic.make_synthetic_cx(
        n_examples=40, n_images=40, dim_v=128, knn_size=K, n_words=20,
        n_answers=20, seed=13)
    arrays = jax_vqacx.CXArrays.from_examples(dataset["examples_list"],
                                              dataset["name_to_index"])
    return SimpleNamespace(dataset=dataset, feats=store.features,
                           arrays=arrays)


def test_contrastive_loss_matches_jax():
    rng = np.random.default_rng(0)
    a, b = (rng.normal(size=(12, 30)).astype(np.float32) for _ in range(2))
    label = (rng.random(12) < 0.5).astype(np.float32)
    for margin in (2.0, 9.0):
        ref = jax_ce.contrastive_loss(jnp.asarray(a), jnp.asarray(b),
                                      jnp.asarray(label), margin)
        got = ce.contrastive_loss(torch.from_numpy(a), torch.from_numpy(b),
                                  torch.from_numpy(label), margin)
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


def _caches(jmodel, params, world):
    q, v, _, _ = jax_engine.build_frozen_caches(
        jmodel, params, jnp.asarray(world.feats), world.arrays, use_q=True,
        use_v=True, use_z=False)
    return np.asarray(q), np.asarray(v)


@pytest.mark.parametrize("cached", [False, True])
def test_train_steps_match_jax(world, cached):
    """5 steps over the triples of a pairwise view (B 16, the last batch
    padded: 8 of 16 valid), without and with the q / v caches: every
    step's metrics within rtol 1e-5, and after the first step every
    parameter (1e-6 where the gradient is well away from Adam's eps, 2 lr
    elsewhere); the backbone untouched."""
    jmodel, params, pmodel = zoo_pair("ContrastiveModel", world.dataset,
                                      knn=2, seed=5)
    tables = _caches(jmodel, params, world) if cached else (None, None)
    opt = optax.adam(LR)
    jparams = jax.tree.map(jnp.asarray, params)
    trainable, _ = jax_engine.split_params(
        jparams, jax_engine.frozen_param_keys(jmodel))
    jstate = jax_ce.ContrastiveState(jparams, opt.init(trainable),
                                     jnp.zeros((), jnp.int32))
    jstep = jax_ce.make_contrastive_train_step(
        jmodel, opt, use_q_cache=cached, use_v_cache=cached)
    backbone = {n: p.clone() for n, p in pmodel.named_parameters()
                if n.startswith("vqa_model.")}
    state = port_engine.init_cx_state(pmodel, lr=LR)
    assert isinstance(state, ce.ContrastiveState)
    pstep = ce.make_contrastive_train_step(pmodel, state.optimizer)
    rng = np.random.default_rng(3)
    view = world.arrays.pairwise_view(rng)
    port_view = port_vqacx.CXArrays(*view)
    steps = list(jax_vqacx.batch_indices(view.size, B, shuffle=True,
                                         rng=rng))
    steps = (steps * 2)[:5]
    ptables = [None if t is None else torch.from_numpy(t) for t in tables]
    for i, (idx, n_valid) in enumerate(steps):
        jstate, jm = jstep(jstate, jnp.asarray(world.feats),
                           jax_vqacx.gather_batch(view, idx),
                           jnp.asarray(n_valid, jnp.float32), *tables)
        state, pm = pstep(state, torch.from_numpy(world.feats),
                          port_vqacx.gather_batch(port_view, idx), n_valid,
                          *ptables)
        assert set(pm) == set(jm) == set(METRICS)
        for key in METRICS:
            np.testing.assert_allclose(float(pm[key]), float(jm[key]),
                                       rtol=1e-5, err_msg=key)
        if i == 0:
            ref = from_jax.cx_trainable_state_dict_from_jax(
                jax.device_get(jstate.params))
            for name, p in pmodel.named_parameters():
                if name in backbone:
                    assert torch.equal(p, backbone[name]), name
                    continue
                got, grad = p.detach().numpy(), p.grad.numpy()
                steady = np.abs(grad) > 1e-6
                np.testing.assert_allclose(got[steady],
                                           ref[name].numpy()[steady],
                                           rtol=0, atol=1e-6, err_msg=name)
                assert np.abs(got - ref[name].numpy()).max() <= 2 * LR
    assert state.step == 5


@pytest.mark.parametrize("cached", [False, True])
def test_eval_step_matches_jax(world, cached):
    """The 24-way eval: recall@5 and @1 counts over every batch (the last
    padded) equal JAX's, and ``loss_sum`` 0."""
    jmodel, params, pmodel = zoo_pair("ContrastiveModel", world.dataset,
                                      knn=2, seed=6)
    tables = _caches(jmodel, params, world) if cached else (None, None)
    jes = jax_ce.make_contrastive_eval_step(jmodel, use_q_cache=cached,
                                            use_v_cache=cached)
    pes = ce.make_contrastive_eval_step(pmodel)
    port_arrays = port_vqacx.CXArrays(*world.arrays)
    ptables = [None if t is None else torch.from_numpy(t) for t in tables]
    totals = []
    for step, (idx, n_valid) in enumerate(jax_vqacx.batch_indices(
            world.arrays.size, B, shuffle=False)):
        ref = jes(params, jnp.asarray(world.feats),
                  jax_vqacx.gather_batch(world.arrays, idx),
                  jnp.asarray(n_valid, jnp.float32),
                  jnp.asarray(step, jnp.int32), *tables)
        got = pes(torch.from_numpy(world.feats),
                  port_vqacx.gather_batch(port_arrays, idx), n_valid, step,
                  *ptables)
        assert set(got) == set(ref) == {"correct", "correct1", "loss_sum"}
        for key in ref:
            assert float(got[key]) == float(ref[key]), key
        totals.append(float(got["correct"]))
    assert sum(totals) > 0


def _run_dir(root):
    (run,) = os.listdir(root / "logs" / "cx")
    return root / "logs" / "cx" / run


@pytest.mark.parametrize("trainable", [False, True])
def test_contrastive_cli(tmp_path, capsys, trainable):
    """``cli/contrastive.py --device cpu --synthetic 96``: the checkpoint
    files, ``contrastive/recall`` and ``recall`` per epoch, the caches
    built only with a frozen backbone, and ``--resume`` going on from the
    next epoch."""
    argv = ["--synthetic", "96", "--device", "cpu", "--path_opt",
            _tiny_cli_options(tmp_path), "--project_dir", str(tmp_path)] + (
                ["--trainable_vqa"] if trainable else [])
    info = port_cli.main(argv + ["--epochs", "2"])
    assert ("caches" in capsys.readouterr().out) != trainable
    run_dir = _run_dir(tmp_path)
    for sub in ("ckpt", "best"):
        assert sorted(os.listdir(run_dir / sub)) == ["info.ckpt",
                                                     "model.ckpt"]
    assert len(info) == 2
    for row in info:
        assert set(row) == {"contrastive/recall", "recall"}
        assert row["recall"] == row["contrastive/recall"]
        assert 0.0 <= row["recall"] <= 1.0
    assert os.path.isdir(tmp_path / "runs" / run_dir.name)
    more = port_cli.main(argv + ["--epochs", "3", "--resume", run_dir.name])
    assert len(more) == 3 and more[:2] == info


def test_contrastive_cli_refusals(tmp_path, monkeypatch):
    """``--mesh data=2`` runs now (two gloo ranks, each on its rows of the
    triple batches, the gradients all-reduced): the same recall as one
    rank; the missing real data and the device rule still raise."""
    base = ["--synthetic", "64", "--epochs", "1", "--path_opt",
            _tiny_cli_options(tmp_path), "--project_dir", str(tmp_path)]
    monkeypatch.setenv("VQACX_DIST_TIMEOUT", "120")
    one = port_cli.main(base + ["--device", "cpu", "-c", "one"])
    ranked = port_cli.main(base + ["--mesh", "data=2", "--device", "cpu",
                                   "-c", "mesh"])
    assert ranked == one and len(one) == 1
    # without --synthetic the CLI reads the real VQA-CX pickles, and raises
    # as the JAX CLI does where they are missing
    (tmp_path / "real.yaml").write_text(yaml.safe_dump(
        {"base": base[5], "vqa": {"path_trainset": str(tmp_path / "no_cx")}}))
    with pytest.raises(FileNotFoundError, match="no_cx"):
        port_cli.main(["--epochs", "1", "--device", "cpu", "--path_opt",
                       str(tmp_path / "real.yaml"),
                       "--project_dir", str(tmp_path)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            port_cli.main(base)
