"""The rest of the CX zoo in the PyTorch port against the JAX package:
every model's forward, the baselines, the numpy and metric copies, one
train step of each trained zoo model, the pairwise eval and the CLI.

Sizes are small (dim_v 128, skip-thoughts emb 16 / hidden 32, MUTAN R 3
with dims 24, K 24, 20 answers).  The JAX model is initialised by flax and
its params go to the port through ``models/from_jax`` (a strict
``load_state_dict``).  At f32 the forwards hold to rtol 1e-5; one train
step holds the loss to rtol 1e-5 and every parameter after Adam to 1e-6
where its gradient is well away from Adam's eps (the Adam-near-eps rule:
such entries within 2 lr).
"""

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
from vqa_counterexamples_tpu.models import factory as jax_factory
from vqa_counterexamples_tpu.ops import metrics as jax_metrics
from vqa_counterexamples_tpu_torch.cli import counterexamples as port_cli
from vqa_counterexamples_tpu_torch.core import msgpack_tree
from vqa_counterexamples_tpu_torch.core import rng as port_rng
from vqa_counterexamples_tpu_torch.data import vqacx as port_vqacx
from vqa_counterexamples_tpu_torch.engines import cx_engine as port_engine
from vqa_counterexamples_tpu_torch.models import factory as port_factory
from vqa_counterexamples_tpu_torch.models import from_jax
from vqa_counterexamples_tpu_torch.ops import metrics as port_metrics

from test_torch_modules import SPEC, tiny_options
from test_torch_slice import _tiny_cli_options

K, DV, B, LR = 24, 128, 16, 1e-3
F32 = dict(rtol=1e-5, atol=1e-6)
BASELINES = ("RandomBaseline", "DistanceBaseline")
SPEC0 = dict(SPEC, drop_p=0.0)


@pytest.fixture(autouse=True)
def f32(monkeypatch):
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "float32")
    with jax_policy.compute_dtype_scope("float32"):
        yield


@pytest.fixture(scope="module")
def world():
    dataset, store = jax_synthetic.make_synthetic_cx(
        n_examples=40, n_images=40, dim_v=DV, knn_size=K, n_words=20,
        n_answers=20, seed=3)
    arrays = jax_vqacx.CXArrays.from_examples(dataset["examples_list"],
                                              dataset["name_to_index"])
    emb = np.random.default_rng(0).normal(size=(20, 40)).astype(np.float32)
    return SimpleNamespace(dataset=dataset, feats=store.features,
                           arrays=arrays,
                           emb_pairs=port_cli.answer_cosines(emb))


def zoo_pair(name, dataset, emb_pairs=None, *, knn=K, trainable=False,
             opt=None, spec=SPEC0, sb_lambda=0.5, seed=0):
    """(jax model, its flax params as numpy, the port model with those
    params, in eval mode)."""
    words, answers = dataset["vocab_words"], dataset["vocab_answers"]
    opt = opt or tiny_options(dim_v=DV, n_answers=len(answers))
    backbone = name not in BASELINES
    kw = dict(knn_size=knn, trainable_vqa=trainable, model_spec=spec,
              sb_lambda=sb_lambda)
    jmodel = jax_factory.factory_cx(
        name, jax_factory.factory_vqa(opt, words, answers)
        if backbone else None, **kw)
    pmodel = port_factory.factory_cx(
        name, port_factory.factory_vqa(opt, words, answers)
        if backbone else None, **kw)
    rng = np.random.default_rng(seed)
    extra = ((jnp.asarray(emb_pairs),) if name == "SemanticBaseline"
             else ())
    variables = jmodel.init(
        {"params": jax.random.key(seed), "dropout": jax.random.key(1),
         "lesion": jax.random.key(2)},
        jnp.asarray(rng.normal(size=(2, knn + 1, DV)), jnp.float32),
        jnp.asarray(rng.integers(1, 20, size=(2, 26)), jnp.int32),
        jnp.asarray(rng.integers(0, len(answers), size=(2,)), jnp.int32),
        *extra, deterministic=True)
    params = jax.tree.map(np.asarray, dict(variables.get("params", {})))
    pmodel.load_state_dict(from_jax.cx_state_dict_from_jax(params))
    return jmodel, params, pmodel.eval()


def _inputs(w, arrays, idx):
    img = w.feats[arrays.image_idxs[idx]]
    return (img, arrays.question_wids[idx], arrays.answer_aids[idx])


def _jax_apply(jmodel, params, inputs, extra=(), **kw):
    return np.asarray(jmodel.apply(
        {"params": params}, *[jnp.asarray(a) for a in inputs], *extra,
        deterministic=True, rngs={"lesion": jax.random.key(0)}, **kw))


def _port_apply(pmodel, inputs, extra=(), **kw):
    with torch.no_grad():
        return pmodel(*[torch.from_numpy(np.asarray(a)) for a in inputs],
                      *extra, **kw).numpy()


# ---------------------------------------------------------------- forwards

@pytest.mark.parametrize("name,view", [
    ("DistanceBaseline", "list"), ("BlackBox", "list"),
    ("LinearContext", "list"), ("SemanticBaseline", "list"),
    ("PairwiseModel", "list"), ("PairwiseModel", "pairwise"),
    ("PairwiseLinearModel", "list"), ("PairwiseLinearModel", "pairwise"),
    ("ContrastiveModel", "list"), ("ContrastiveModel", "pairwise"),
    ("SimilarityModel", "list")])
def test_zoo_forward_matches_jax(world, name, view):
    """Each model's output at f32 on the full candidate list (K 24) and,
    for the pairwise and contrastive models, on a pairwise view (K 2),
    with the same params; ContrastiveModel's embeddings and its
    ``get_scores``, SemanticBaseline with an ``emb_pairs``."""
    w = world
    arrays = (w.arrays if view == "list"
              else w.arrays.pairwise_view(np.random.default_rng(1)))
    jmodel, params, pmodel = zoo_pair(name, w.dataset, w.emb_pairs)
    inputs = _inputs(w, arrays, np.arange(B))
    extra_j = extra_p = ()
    if name == "SemanticBaseline":
        extra_j = (jnp.asarray(w.emb_pairs),)
        extra_p = (torch.from_numpy(w.emb_pairs),)
    ref = _jax_apply(jmodel, params, inputs, extra_j)
    got = _port_apply(pmodel, inputs, extra_p)
    k1 = arrays.image_idxs.shape[1]
    assert got.shape == ref.shape == ((B, k1, 300) if name ==
                                      "ContrastiveModel" else (B, k1 - 1))
    np.testing.assert_allclose(got, ref, **F32)
    if name == "ContrastiveModel":
        h = jnp.asarray(ref)
        s_ref = jmodel.get_scores(h[:, 0], h[:, 1:])
        s_got = pmodel.get_scores(torch.from_numpy(got[:, 0]),
                                  torch.from_numpy(got[:, 1:]))
        np.testing.assert_allclose(s_got.numpy(), np.asarray(s_ref), **F32)


def test_zoo_forward_with_caches_matches_jax(world):
    """BlackBox and PairwiseModel fed the JAX engine's q / v / z tables
    (the port reads the same rows): the scores of the uncached forward."""
    w = world
    idx = np.arange(B)
    for name in ("BlackBox", "PairwiseModel"):
        jmodel, params, pmodel = zoo_pair(name, w.dataset)
        q, v, z, _ = jax_engine.build_frozen_caches(
            jmodel, params, jnp.asarray(w.feats), w.arrays, use_q=True,
            use_v=True, use_z=False)
        q, v = np.asarray(q), np.asarray(v)
        inputs = _inputs(w, w.arrays, idx)
        ref = _jax_apply(jmodel, params, inputs)
        batch = port_engine.batch_to_device(
            port_vqacx.gather_batch(port_vqacx.CXArrays(*w.arrays), idx),
            "cpu")
        kw = port_engine.cache_kwargs(batch, torch.from_numpy(q),
                                      torch.from_numpy(v))
        got = _port_apply(pmodel, inputs, **kw)
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_random_baseline_draws(world):
    """RandomBaseline: (B, K) draws in [0, 1) from the lesion generator,
    the same for the same (seed, step), others for another step, in eval
    too.  (JAX's threefry bits cannot match PyTorch's.)"""
    model = port_factory.factory_cx("RandomBaseline", None, knn_size=K)
    assert not list(model.parameters()) and model.eval() is model
    inputs = [torch.from_numpy(np.asarray(a))
              for a in _inputs(world, world.arrays, np.arange(B))]

    def draw(step):
        gen = port_rng.step_generators(3, step, ("lesion",), "cpu")
        return model(*inputs, lesion_gen=gen["lesion"])

    a, b, c = draw(0), draw(0), draw(1)
    assert a.shape == (B, K) and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float(a.min()) >= 0.0 and float(a.max()) < 1.0
    with pytest.raises(ValueError, match="lesion_gen"):
        model(*inputs)


def test_distance_baseline_exact(world):
    jmodel, params, pmodel = zoo_pair("DistanceBaseline", world.dataset)
    inputs = _inputs(world, world.arrays, np.arange(B))
    got = _port_apply(pmodel, inputs)
    np.testing.assert_array_equal(got, _jax_apply(jmodel, params, inputs))
    np.testing.assert_array_equal(got[3], np.arange(K - 1, -1, -1))


# ---------------------------------------------------------------- copies

def test_cosine_similarity_matches_jax():
    """The formula bit for bit where every sum is exact (small integers,
    and zero rows that hit the eps clamp), within 1e-6 on random rows
    (the two libraries sum in other orders)."""
    rng = np.random.default_rng(5)
    a = rng.integers(-3, 4, size=(7, 1, 16)).astype(np.float32)
    b = rng.integers(-3, 4, size=(7, 5, 16)).astype(np.float32)
    a[2] = 0.0
    ref = np.asarray(jax_metrics.cosine_similarity(jnp.asarray(a),
                                                   jnp.asarray(b)))
    got = port_metrics.cosine_similarity(torch.from_numpy(a),
                                         torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got[2] == 0).all()
    a, b = (rng.normal(size=(9, 4, 300)).astype(np.float32)
            for _ in range(2))
    np.testing.assert_allclose(
        port_metrics.cosine_similarity(torch.from_numpy(a),
                                       torch.from_numpy(b)).numpy(),
        np.asarray(jax_metrics.cosine_similarity(jnp.asarray(a),
                                                 jnp.asarray(b))),
        rtol=1e-6, atol=1e-7)


def test_pairwise_view_bit_equal(world):
    """The same triples and labels from the same numpy rng, and the rng
    left in the same state."""
    port_arrays = port_vqacx.CXArrays(*world.arrays)
    rng_j, rng_p = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(2):
        ref = world.arrays.pairwise_view(rng_j)
        got = port_arrays.pairwise_view(rng_p)
        for field, g, r in zip(ref._fields, got, ref):
            assert g.dtype == r.dtype, field
            np.testing.assert_array_equal(g, r, err_msg=field)
    assert (got.comp_idxs == 0).all() and got.knn_size == 2
    assert rng_j.integers(1 << 30) == rng_p.integers(1 << 30)


# ---------------------------------------------------------------- training

def _assert_adam_close(got, ref, grad, name):
    """Params after one Adam step: 1e-6 where |g| > 1e-6, 2 lr elsewhere
    (the first update -lr g / (|g| + eps) swings there)."""
    steady = np.abs(grad) > 1e-6
    np.testing.assert_allclose(got[steady], ref[steady], rtol=0, atol=1e-6,
                               err_msg=name)
    assert np.abs(got - ref).max() <= 2 * LR + 1e-6, name


@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("name,view,recall_k", [
    ("LinearContext", "list", 5), ("PairwiseModel", "pairwise", 1),
    ("PairwiseLinearModel", "list", 5)])
def test_zoo_train_step_matches_jax(world, name, view, recall_k, cached):
    """One step on a padded batch (13 valid rows of 16), without and with
    the frozen backbone's q / v caches (the JAX engine's tables on both
    sides): the loss, the recall count and every trained parameter after
    Adam; the backbone untouched."""
    w = world
    arrays = (w.arrays if view == "list"
              else w.arrays.pairwise_view(np.random.default_rng(2)))
    jmodel, params, pmodel = zoo_pair(name, w.dataset, seed=4)
    idx = np.concatenate([np.arange(13), np.zeros(3, np.int64)])
    tables = (None, None)
    if cached:
        q, v, _, _ = jax_engine.build_frozen_caches(
            jmodel, params, jnp.asarray(w.feats), w.arrays, use_q=True,
            use_v=True, use_z=False)
        tables = (np.asarray(q), np.asarray(v))
    opt = optax.adam(LR)
    jparams = jax.tree.map(jnp.asarray, params)
    trainable, _ = jax_engine.split_params(
        jparams, jax_engine.frozen_param_keys(jmodel))
    jstate = jax_engine.CXTrainState(jparams, opt.init(trainable),
                                     jnp.zeros((), jnp.int32))
    jstep = jax_engine.make_cx_train_step(
        jmodel, opt, recall_k=recall_k, use_q_cache=cached,
        use_v_cache=cached)
    jstate, jm = jstep(jstate, jnp.asarray(w.feats),
                       jax_vqacx.gather_batch(arrays, idx),
                       jnp.asarray(13, jnp.float32),
                       *[t for t in tables if t is not None])
    backbone = {n: p.clone() for n, p in pmodel.vqa_model.named_parameters()}
    state = port_engine.init_cx_state(pmodel, lr=LR)
    pstep = port_engine.make_cx_train_step(pmodel, state.optimizer,
                                           recall_k=recall_k)
    batch = port_vqacx.gather_batch(port_vqacx.CXArrays(*arrays), idx)
    state, pm = pstep(state, torch.from_numpy(w.feats), batch, 13,
                      *[None if t is None else torch.from_numpy(t)
                        for t in tables])
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    assert float(pm["correct"]) == float(jm["correct"])
    ref = from_jax.cx_trainable_state_dict_from_jax(
        jax.device_get(jstate.params))
    grads = {n: p.grad.numpy() for n, p in pmodel.named_parameters()
             if p.grad is not None}
    assert set(grads) == set(ref) and ref
    for n, p in pmodel.named_parameters():
        if n in ref:
            _assert_adam_close(p.detach().numpy(), ref[n].numpy(), grads[n],
                               n)
        else:
            assert torch.equal(p, backbone[n.split(".", 1)[1]]), n


def test_eval_model_pairwise_matches_jax(world):
    """``eval_model(pairwise=True)`` on the same params and caches: the same
    keys, and the values of JAX's (``loss_pairwise`` / ``acc_pairwise``
    over the pairwise view of ``default_rng(123)``, per example of the
    main pass)."""
    w = world
    jmodel, params, pmodel = zoo_pair("PairwiseModel", w.dataset, seed=6)
    q, v, _, _ = jax_engine.build_frozen_caches(
        jmodel, params, jnp.asarray(w.feats), w.arrays, use_q=True,
        use_v=True, use_z=False)
    jes = jax_engine.make_cx_eval_step(jmodel, recall_k=5, use_q_cache=True,
                                       use_v_cache=True)
    ref = jax_engine.eval_model(jes, params, jnp.asarray(w.feats), w.arrays,
                                B, pairwise=True, pairwise_eval_step=jes,
                                rng=np.random.default_rng(123), q_table=q,
                                v_table=v)
    pes = port_engine.make_cx_eval_step(pmodel, recall_k=5)
    got = port_engine.eval_model(
        pes, torch.from_numpy(w.feats), port_vqacx.CXArrays(*w.arrays), B,
        pairwise=True, pairwise_eval_step=pes,
        rng=np.random.default_rng(123), q_table=torch.from_numpy(
            np.asarray(q)), v_table=torch.from_numpy(np.asarray(v)))
    assert set(got) == set(ref) == {"loss", "recall", "recall_1",
                                    "loss_pairwise", "acc_pairwise"}
    for key in ref:
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-5,
                                   err_msg=key)


def test_models_without_optimizer_and_device(world):
    """The models JAX trains with no optimizer get a state with none; the
    baselines (no parameters) take their device from a buffer."""
    model = port_factory.factory_cx("DistanceBaseline", None, knn_size=K)
    state = port_engine.init_cx_state(model, optimizer=None)
    assert state.optimizer is None
    assert port_engine._device(model) == torch.device("cpu")
    step = port_engine.make_cx_eval_step(model)
    out = port_engine.eval_model(step, torch.from_numpy(world.feats),
                                 port_vqacx.CXArrays(*world.arrays), B)
    assert set(out) == {"loss", "recall", "recall_1"}
    with pytest.raises(ValueError, match="adam"):
        port_engine.init_cx_state(model, optimizer="sgd")


def test_train_epoch_pairwise_refuses_z_table(world):
    _, _, pmodel = zoo_pair("PairwiseModel", world.dataset)
    state = port_engine.init_cx_state(pmodel, lr=LR)
    step = port_engine.make_cx_train_step(pmodel, state.optimizer)
    with pytest.raises(ValueError, match="pairwise"):
        port_engine.train_epoch(step, state, torch.from_numpy(world.feats),
                                port_vqacx.CXArrays(*world.arrays), B,
                                pairwise=True, z_table=torch.zeros(1))


# ---------------------------------------------------------------- the CLI

def _run_dir(root):
    (run,) = os.listdir(root / "logs" / "cx")
    return root / "logs" / "cx" / run


@pytest.mark.parametrize("name,extra", [
    ("RandomBaseline", []), ("DistanceBaseline", []), ("BlackBox", []),
    ("LinearContext", []), ("SemanticBaseline", ["--sb_lambda", "0.3"]),
    ("NeuralModel", []), ("PairwiseModel", []),
    ("PairwiseModel", ["--pairwise"]), ("PairwiseLinearModel", []),
    ("PairwiseLinearModel", ["--pairwise"]), ("SimilarityModel", [])])
def test_port_cli_runs_every_model(tmp_path, name, extra):
    """``--synthetic 96 --epochs 1 --test`` on the CPU: the checkpoint
    files, one info row a epoch, ``final_results.txt``'s keys (the
    pairwise ones under ``--pairwise``) and ``best_epoch`` (0 for the
    models trained with no optimizer, as JAX's CLI writes it)."""
    info = port_cli.main(["--cx_model", name, "--synthetic", "96",
                          "--epochs", "1", "--test", "--device", "cpu",
                          "--path_opt", _tiny_cli_options(tmp_path),
                          "--project_dir", str(tmp_path)] + extra)
    run_dir = _run_dir(tmp_path)
    assert sorted(os.listdir(run_dir / "best")) == ["info.ckpt",
                                                    "model.ckpt"]
    assert sorted(os.listdir(run_dir / "ckpt")) == ["info.ckpt",
                                                    "model.ckpt"]
    res = json.loads((run_dir / "final_results.txt").read_text())
    keys = {"loss", "recall", "recall_1"}
    if extra == ["--pairwise"]:
        keys |= {"loss_pairwise", "acc_pairwise"}
        assert 0.0 <= res["acc_pairwise"] <= 1.0
    assert len(info) == 1 and set(info[0]) == keys
    assert set(res) == keys | {"best_epoch"}
    assert all(np.isfinite(v) for v in res.values())
    trained = name in port_cli.TRAINED
    assert res["best_epoch"] == (2 if trained else 0)


def test_distance_baseline_cli_matches_jax(tmp_path):
    """The one model whose scores do not depend on weights or draws: the
    port's ``final_results.txt`` equals the JAX CLI's, the same keys, the
    recalls and ``best_epoch`` to the bit.  Each row's loss is bit-equal
    too; the loss's f32 sum over a batch's rows runs in XLA's order on
    one side and ATen's on the other, one rounding apart (1e-7 of the
    value here), so the loss is held to rtol 1e-6."""
    argv = ["--cx_model", "DistanceBaseline", "--synthetic", "96",
            "--epochs", "1", "--test", "--path_opt",
            _tiny_cli_options(tmp_path)]
    jax_cli.main(argv + ["--project_dir", str(tmp_path / "jax")])
    port_cli.main(argv + ["--device", "cpu",
                          "--project_dir", str(tmp_path / "port")])
    ref = json.loads((_run_dir(tmp_path / "jax")
                      / "final_results.txt").read_text())
    got = json.loads((_run_dir(tmp_path / "port")
                      / "final_results.txt").read_text())
    assert set(got) == set(ref)
    assert {k: v for k, v in got.items() if k != "loss"} == {
        k: v for k, v in ref.items() if k != "loss"}
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-6)


def test_cli_contrastive_model_and_sb_lambda_raise_as_jax(tmp_path):
    """ContrastiveModel's embeddings are no K-way scores: both CLIs raise
    ``ValueError`` on it; SemanticBaseline without ``--sb_lambda`` too."""
    base = ["--synthetic", "64", "--epochs", "1", "--path_opt",
            _tiny_cli_options(tmp_path)]
    for name in ("ContrastiveModel", "SemanticBaseline"):
        argv = ["--cx_model", name] + base
        with pytest.raises(ValueError):
            jax_cli.main(argv + ["--project_dir", str(tmp_path / "j")])
        with pytest.raises(ValueError):
            port_cli.main(argv + ["--device", "cpu",
                                  "--project_dir", str(tmp_path / "p")])


def test_cli_resumes_a_model_without_optimizer(tmp_path):
    """``--resume`` and ``--best`` for a model trained with no optimizer:
    the checkpoint holds no parameters and no optimizer state, and the
    resumed run goes on from the next epoch."""
    argv = ["--cx_model", "BlackBox", "--synthetic", "64", "--epochs", "1",
            "--device", "cpu", "--comment", "bb", "--path_opt",
            _tiny_cli_options(tmp_path), "--project_dir", str(tmp_path)]
    first = port_cli.main(argv)
    payload = msgpack_tree.load(str(_run_dir(tmp_path) / "ckpt" /
                                    "model.ckpt"))
    # the JAX package's state: the frozen backbone's params, no optimizer
    assert set(payload["params"]) == {"vqa_model"}
    assert payload["opt_state"] is None and int(payload["step"]) == 0
    info = port_cli.main(argv + ["--resume", _run_dir(tmp_path).name,
                                 "--epochs", "2", "--best"])
    assert len(info) == 2 and info[0] == first[0]
    assert info[1] == info[0]   # frozen, deterministic: the same eval
