"""NeuralCX over a trainable VQA backbone (``trainable_vqa``) in the PyTorch
port against the JAX package.

The port's counterpart of ``tests/test_trainable_vqa.py`` (frozen: no
backbone gradient; trainable: gradients in the encoder, the fusion and the
classifier), one train step and a 10-step trajectory against JAX's step at
f32 with every dropout 0 (the two frameworks draw different bits from one
seed), Adam carried from optax over the backbone too, the caches and the
frozen-only kernel gates refused or closed, the dropout generator reaching
the backbone, and the CLI.  Sizes as ``test_torch_zoo`` (dim_v 128,
skip-thoughts 16 -> 32, MUTAN R 3 at 24), K 6, B 16.
"""

import copy
import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vqa_counterexamples_tpu.cli import counterexamples as jax_cli
from vqa_counterexamples_tpu.core import policy as jax_policy
from vqa_counterexamples_tpu.data import synthetic as jax_synthetic
from vqa_counterexamples_tpu.data import vqacx as jax_vqacx
from vqa_counterexamples_tpu.engines import cx_engine as jax_engine
from vqa_counterexamples_tpu_torch.cli import counterexamples as port_cli
from vqa_counterexamples_tpu_torch.core import msgpack_tree
from vqa_counterexamples_tpu_torch.core import rng as port_rng
from vqa_counterexamples_tpu_torch.data import vqacx as port_vqacx
from vqa_counterexamples_tpu_torch.engines import cx_engine as port_engine
from vqa_counterexamples_tpu_torch.models import from_jax

from test_torch_modules import tiny_options
from test_torch_slice import _tiny_cli_options
from test_torch_zoo import SPEC0, zoo_pair

K, B, LR = 6, 16, 1e-3
# out.bias shifts all K scores alike: the K-way CE's gradient of it is 0
# up to rounding, and Adam moves it by up to lr either way (ROADMAP Queue 3)
SHIFT_ONLY = ("out.bias",)


def no_dropout_options():
    """The tiny backbone with every dropout 0 (encoder, fusion inputs,
    classifier)."""
    opt = tiny_options(dim_v=128, n_answers=20)
    opt["seq2vec"]["dropout"] = 0.0
    opt["fusion"].update(dropout_v=0.0, dropout_q=0.0)
    opt["classif"] = {"dropout": 0.0}
    return opt


@pytest.fixture(autouse=True)
def f32(monkeypatch):
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "float32")
    with jax_policy.compute_dtype_scope("float32"):
        yield


@pytest.fixture(scope="module")
def world():
    dataset, store = jax_synthetic.make_synthetic_cx(
        n_examples=40, n_images=24, dim_v=128, knn_size=K, n_words=20,
        n_answers=20, seed=11)
    arrays = jax_vqacx.CXArrays.from_examples(dataset["examples_list"],
                                              dataset["name_to_index"])
    order = np.random.default_rng(0)
    steps = [b for _ in range(4) for b in jax_vqacx.batch_indices(
        arrays.size, B, shuffle=True, rng=order)][:10]
    return SimpleNamespace(dataset=dataset, feats=store.features,
                           arrays=arrays, steps=steps)


def _pair(world, trainable=True, opt=None, spec=SPEC0, seed=2):
    return zoo_pair("NeuralModel", world.dataset, knn=K, trainable=trainable,
                    opt=opt or no_dropout_options(), spec=spec, seed=seed)


def _port_inputs(world, idx):
    return (torch.from_numpy(world.feats[world.arrays.image_idxs[idx]]),
            torch.from_numpy(world.arrays.question_wids[idx]),
            torch.from_numpy(world.arrays.answer_aids[idx]))


@pytest.mark.parametrize("trainable", [False, True])
def test_backbone_gradient_follows_trainable_vqa(world, trainable):
    """sum(scores^2) in eval mode: a frozen backbone gets no gradient (and
    asks for none) while the head does; a trainable one gets gradients in
    the encoder, the fusion and the classifier."""
    _, _, model = _pair(world, trainable=trainable,
                        opt=tiny_options(dim_v=128, n_answers=20))
    gen = port_rng.step_generators(0, 0, ("lesion",), "cpu")
    scores = model(*_port_inputs(world, np.arange(3)),
                   lesion_gen=gen["lesion"])
    (scores ** 2).sum().backward()
    assert model.linear_1.weight.grad.abs().max() > 0
    vqa = model.vqa_model
    if not trainable:
        assert not any(p.requires_grad or p.grad is not None
                       for p in vqa.parameters())
        return
    for part in (vqa.seq2vec, vqa.fusion, vqa.linear_classif):
        assert max(float(p.grad.abs().max()) for p in part.parameters()
                   if p.grad is not None) > 0


def test_backbone_mode_follows_the_cx_model(world):
    """A frozen backbone stays in eval mode under ``.train()``; a trainable
    one follows; the trainable backbone's dropouts draw from the dropout
    generator (the same draws for the same (seed, step), others for
    another step) and ask for one in training."""
    _, _, frozen = _pair(world, trainable=False,
                         opt=tiny_options(dim_v=128, n_answers=20))
    _, _, model = _pair(world, opt=tiny_options(dim_v=128, n_answers=20),
                        spec=dict(SPEC0, drop_p=0.0))
    assert not frozen.train().vqa_model.training
    assert model.train().vqa_model.training
    inputs = _port_inputs(world, np.arange(B))

    def run(step):
        gens = port_rng.step_generators(0, step, ("dropout", "lesion"),
                                        "cpu")
        return model(*inputs, dropout_gen=gens["dropout"],
                     lesion_gen=gens["lesion"]).detach()

    assert torch.equal(run(0), run(0)) and not torch.equal(run(0), run(1))
    with pytest.raises(ValueError, match="generator"):
        model(*inputs)
    with torch.no_grad():
        a = model.eval()(*inputs)
        b = model.eval()(*inputs)
    assert torch.equal(a, b)


def test_caches_refused_and_frozen_gates_closed(world, monkeypatch):
    """The q/v/z caches need a frozen backbone (``ValueError``, as in
    JAX's ``make_cx_train_step``): ``build_frozen_caches``, the two step
    factories, a step given a table, the forward given a cache row.  Under bf16 the fused answer
    head and the vfeat table form stay closed."""
    _, _, model = _pair(world)
    feats = torch.from_numpy(world.feats)
    arrays = port_vqacx.CXArrays(*world.arrays)
    with pytest.raises(ValueError, match="frozen"):
        port_engine.build_frozen_caches(model, feats, arrays)
    for build in (port_engine.make_cx_eval_step,
                  lambda m, **kw: port_engine.make_cx_train_step(
                      m, None, **kw)):
        with pytest.raises(ValueError, match="frozen"):
            build(model, use_z_cache=True)
    state = port_engine.init_cx_state(model, lr=LR)
    step = port_engine.make_cx_train_step(model, state.optimizer)
    batch = port_vqacx.gather_batch(arrays, np.arange(B))
    with pytest.raises(ValueError, match="frozen"):
        step(state, feats, batch, B, q_table=torch.zeros(40, 32))
    with pytest.raises(ValueError, match="frozen"):
        model.eval()(*_port_inputs(world, np.arange(2)),
                     q_emb=torch.zeros(2, 32))
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "bfloat16")
    _, _, frozen = _pair(world, trainable=False)
    assert frozen._fused_head_ok() and frozen.wants_table_features()
    assert not model._fused_head_ok()
    assert not model.wants_table_features()


def _jax_state(jmodel, params, opt):
    params = jax.tree.map(jnp.asarray, params)
    assert jax_engine.frozen_param_keys(jmodel) == ()
    return jax_engine.CXTrainState(params, opt.init(params),
                                   jnp.zeros((), jnp.int32))


def _run(world, jmodel, params, pmodel, steps, jstate=None, pstate=None):
    """The same batches through both trainers (no caches) -> per-step
    (jax loss, port loss), and the two states."""
    opt = optax.adam(LR)
    jstep = jax_engine.make_cx_train_step(jmodel, opt, recall_k=5)
    jstate = jstate or _jax_state(jmodel, params, opt)
    pstate = pstate or port_engine.init_cx_state(pmodel, lr=LR)
    pstep = port_engine.make_cx_train_step(pmodel, pstate.optimizer,
                                           recall_k=5)
    port_arrays = port_vqacx.CXArrays(*world.arrays)
    losses = []
    for idx, n_valid in steps:
        jstate, jm = jstep(jstate, jnp.asarray(world.feats),
                           jax_vqacx.gather_batch(world.arrays, idx),
                           jnp.asarray(n_valid, jnp.float32))
        pstate, pm = pstep(pstate, torch.from_numpy(world.feats),
                           port_vqacx.gather_batch(port_arrays, idx),
                           n_valid)
        losses.append((float(jm["loss"]), float(pm["loss"])))
    return np.array(losses), jstate, pstate


def _params_as_port(jstate) -> dict:
    return {k: v.numpy() for k, v in from_jax.cx_state_dict_from_jax(
        jax.device_get(jstate.params)).items()}


def test_one_step_matches_jax(world):
    """One step, every dropout 0: the loss, and every parameter after Adam,
    the backbone's included (1e-6 where the gradient is well away from
    Adam's eps, 2 lr elsewhere); Adam holds state for every parameter."""
    jmodel, params, pmodel = _pair(world)
    w_hh = pmodel.vqa_model.seq2vec.gru_cell.weight_hh.detach().clone()
    idx = np.concatenate([np.arange(13), np.zeros(3, np.int64)])
    losses, jstate, pstate = _run(world, jmodel, params, pmodel,
                                  [(idx, 13)])
    np.testing.assert_allclose(losses[:, 1], losses[:, 0], rtol=1e-5)
    ref = _params_as_port(jstate)
    assert set(ref) == {n for n, _ in pmodel.named_parameters()}
    assert len(pstate.optimizer.state) == len(ref)
    for name, p in pmodel.named_parameters():
        got, grad = p.detach().numpy(), p.grad.numpy()
        if name in SHIFT_ONLY:
            continue
        steady = np.abs(grad) > 1e-6
        np.testing.assert_allclose(got[steady], ref[name][steady], rtol=0,
                                   atol=1e-6, err_msg=name)
        assert np.abs(got - ref[name]).max() <= 2 * LR + 1e-6, name
    assert not torch.equal(pmodel.vqa_model.seq2vec.gru_cell.weight_hh, w_hh)


def test_ten_step_trajectory_matches_jax(world):
    """10 steps (shuffled batches, the last of each epoch padded), every
    dropout 0: per-step losses within rtol 1e-4, the parameters after the
    last step within 1e-4 of their largest entry."""
    jmodel, params, pmodel = _pair(world, seed=3)
    losses, jstate, _ = _run(world, jmodel, params, pmodel, world.steps)
    assert len(losses) == 10 and np.isfinite(losses).all()
    np.testing.assert_allclose(losses[:, 1], losses[:, 0], rtol=1e-4)
    ref = _params_as_port(jstate)
    for name, p in pmodel.named_parameters():
        if name in SHIFT_ONLY:
            continue
        scale = max(np.abs(ref[name]).max(), 1e-3)
        assert np.abs(p.detach().numpy() - ref[name]).max() <= 1e-4 * scale \
            + 1e-5, name


def test_adam_state_over_the_backbone_carried_from_jax(world):
    """3 JAX steps, then the params and optax's mu / nu / count (over every
    parameter, the backbone's too) carried into a fresh port model and
    ``torch.optim.Adam``: step 4's loss and parameters agree."""
    jmodel, params, pmodel = _pair(world, seed=4)
    opt = optax.adam(LR)
    jstep = jax_engine.make_cx_train_step(jmodel, opt, recall_k=5)
    jstate = _jax_state(jmodel, params, opt)
    for idx, n_valid in world.steps[:3]:
        jstate, _ = jstep(jstate, jnp.asarray(world.feats),
                          jax_vqacx.gather_batch(world.arrays, idx),
                          jnp.asarray(n_valid, jnp.float32))
    host = jax.device_get(jstate)
    model = copy.deepcopy(pmodel)
    model.load_state_dict(from_jax.cx_state_dict_from_jax(host.params))
    state = port_engine.init_cx_state(model, lr=LR)
    from_jax.adam_state_from_jax(host.opt_state, model, state.optimizer)
    assert len(state.optimizer.state) == len(list(model.parameters()))
    state.step = 3
    losses, jstate, _ = _run(world, jmodel, params, model, world.steps[3:4],
                             jstate=jstate, pstate=state)
    np.testing.assert_allclose(losses[:, 1], losses[:, 0], rtol=1e-5)
    ref = _params_as_port(jstate)
    for name, p in model.named_parameters():
        if name not in SHIFT_ONLY:
            np.testing.assert_allclose(p.detach().numpy(), ref[name],
                                       rtol=0, atol=1e-5, err_msg=name)


def _run_dir(root):
    (run,) = os.listdir(root / "logs" / "cx")
    return root / "logs" / "cx" / run


def test_cli_trainable_vqa(tmp_path, capsys):
    """``--trainable_vqa`` on the CPU: no cache is built, the checkpoint
    holds the backbone's parameters and their Adam state, the results are
    finite, and ``--resume`` goes on from it."""
    argv = ["--cx_model", "NeuralModel", "--trainable_vqa", "--synthetic",
            "64", "--epochs", "1", "--test", "--device", "cpu", "--path_opt",
            _tiny_cli_options(tmp_path), "--project_dir", str(tmp_path)]
    info = port_cli.main(argv)
    assert "=> Train caches built: {}" in capsys.readouterr().out
    run_dir = _run_dir(tmp_path)
    payload = msgpack_tree.load(str(run_dir / "ckpt" / "model.ckpt"))
    adam = payload["opt_state"]["0"]
    # the backbone trains: its moments ride in the optax state beside the
    # head's, one count for all (the JAX package's file)
    assert "seq2vec" in adam["mu"]["vqa_model"]
    assert set(adam["mu"]) == set(adam["nu"]) == set(payload["params"])
    assert int(adam["count"]) == int(payload["step"]) > 0
    res = json.loads((run_dir / "final_results.txt").read_text())
    assert len(info) == 1 and np.isfinite(res["loss"])
    assert res["best_epoch"] == 2
    info = port_cli.main(argv + ["--resume", run_dir.name, "--epochs", "2"])
    assert len(info) == 2


def test_cli_yaml_trainable_vqa_follows_the_flag_as_jax(tmp_path):
    """Both CLIs override the YAML's ``cx_model.trainable_vqa`` with the
    flag's value (``--trainable_vqa`` is a store_true, so its False is
    not None): ``neuralcx_trainable_vqa.yaml`` without the flag runs with
    a frozen backbone in both, and the saved options say so."""
    tiny = tmp_path / "trainable.yaml"
    tiny.write_text("base: %s\ncx_model: {trainable_vqa: true}\n"
                    % _tiny_cli_options(tmp_path))
    argv = ["--cx_model", "NeuralModel", "--synthetic", "64", "--epochs",
            "0", "--path_opt", str(tiny)]
    jax_cli.main(argv + ["--project_dir", str(tmp_path / "jax")])
    port_cli.main(argv + ["--device", "cpu",
                          "--project_dir", str(tmp_path / "port")])
    import yaml

    for side in ("jax", "port"):
        options = yaml.safe_load((_run_dir(tmp_path / side)
                                  / "options.yaml").read_text())
        assert options["cx_model"]["trainable_vqa"] is False, side
