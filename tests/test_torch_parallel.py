"""The port's runs over several ranks (``parallel/``) against the JAX
package's mesh and against the port's own one-rank runs.

Ranks are spawned processes on gloo over the CPU (``parallel.spawn``; the
rank functions live in ``tests/torch_parallel_ranks.py``), each collective
and the rendezvous bounded by ``VQACX_DIST_TIMEOUT`` (120 s here), so a
hung rank fails the test.  JAX runs its mesh on the 8 virtual CPU devices
of ``tests/conftest.py``.  Sizes are ``test_torch_train``'s (dim_v 128, K
6, 40 examples over 24 images, B 16), f32 with dropout off where the two
packages meet (their generators never draw the same bits), weights carried
by ``models/from_jax``.

Tolerances: one step against JAX's mesh at JAX's own (loss 1e-4 absolute,
parameters rtol 2e-4 / atol 2e-5, SGD as in ``tests/test_parallel.py``),
a 10-step Adam trajectory's losses at rtol 1e-4; the gather and the kNN
indices bit for bit.  Against the port's one rank only the sum order
differs: losses within 1e-5 relative (f32) and SGD's parameters within
1e-6 (f32) or bf16's one step (5e-2 relative) on the bf16 table path.
"""

import socket
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_parallel_ranks as ranks
from test_torch_modules import SPEC, build_pair, tiny_options
from vqa_counterexamples_tpu.core import policy as jax_policy
from vqa_counterexamples_tpu.data import synthetic as jax_synthetic
from vqa_counterexamples_tpu.data import vqacx as jax_vqacx
from vqa_counterexamples_tpu.engines import cx_engine as jax_engine
from vqa_counterexamples_tpu.engines import vqa_engine as jax_vqa_engine
from vqa_counterexamples_tpu.ops.topk import knn as jax_knn
from vqa_counterexamples_tpu.parallel import make_mesh as jax_make_mesh
from vqa_counterexamples_tpu.parallel import shard_batch as jax_shard_batch
from vqa_counterexamples_tpu.parallel.gather import (
    sharded_gather as jax_sharded_gather)
from vqa_counterexamples_tpu_torch import parallel
from vqa_counterexamples_tpu_torch.core import graphs
from vqa_counterexamples_tpu_torch.core import rng as port_rng
from vqa_counterexamples_tpu_torch.data.vqa_dataset import VQAArrays
from vqa_counterexamples_tpu_torch.models import from_jax
from vqa_counterexamples_tpu_torch.ops import topk as port_topk

K, B, LR = 6, 16, 1e-3
SPEC0 = dict(SPEC, drop_p=0.0)
DATA2 = {"data": 2}
DATA2_MODEL2 = {"data": 2, "model": 2}


@pytest.fixture(autouse=True)
def _bounded(monkeypatch):
    monkeypatch.setenv(parallel.sharding.TIMEOUT_ENV, "120")


def _world_size(axes):
    return int(np.prod(list(axes.values())))


# every spawned run of ranks here stops within this many seconds
SPAWN_TIMEOUT = 600


def _spawn(fn, *args, axes):
    return parallel.spawn(fn, args + (axes,), world=_world_size(axes),
                          timeout=SPAWN_TIMEOUT)


@pytest.fixture(scope="module")
def world():
    dataset, store = jax_synthetic.make_synthetic_cx(
        n_examples=40, n_images=24, dim_v=128, knn_size=K, n_words=20,
        n_answers=20, seed=9)
    jmodel, params, pmodel, arrays = build_pair(dataset, seed=5, spec=SPEC0)
    params = jax.tree.map(np.asarray, params)
    feats = store.features
    with jax_policy.compute_dtype_scope("float32"):
        q, _, z, _ = jax_engine.build_frozen_caches(
            jmodel, params, jnp.asarray(feats), arrays, use_q=True,
            use_v=False, use_z=True)
        v = jax_engine.precompute_v_proj(jmodel, params, jnp.asarray(feats))
    order = np.random.default_rng(0)
    # 10 steps of shuffled batches: every third one 8 valid rows of 16, so
    # rank 1 of data=2 holds none
    steps = [b for _ in range(4) for b in jax_vqacx.batch_indices(
        arrays.size, B, shuffle=True, rng=order)][:10]
    rank_world = dict(
        opt=tiny_options(dim_v=128, n_answers=len(dataset["vocab_answers"])),
        words=dataset["vocab_words"], answers=dataset["vocab_answers"],
        knn=K, spec=SPEC0,
        state={k: v_.numpy() for k, v_ in pmodel.state_dict().items()},
        feats=feats, arrays=tuple(arrays), batch=B)
    return SimpleNamespace(jmodel=jmodel, params=params, arrays=arrays,
                           feats=feats, q=np.array(q), z=np.array(z),
                           v=np.array(v), steps=steps, rank_world=rank_world)


def _jax_state(jmodel, params, optimizer):
    params = jax.tree.map(jnp.asarray, params)
    trainable, _ = jax_engine.split_params(
        params, jax_engine.frozen_param_keys(jmodel))
    return jax_engine.CXTrainState(params, optimizer.init(trainable),
                                   jnp.zeros((), jnp.int32))


def _trainable_as_port(tree) -> dict:
    return {k: v.numpy() for k, v in
            from_jax.cx_trainable_state_dict_from_jax(
                jax.device_get(tree)).items()}


def _jax_mesh_run(w, axes, steps, optimizer, tables):
    """JAX's mesh run (the batch over 'data'; with 'model' the features,
    and the v table, row-sharded over it, as its CLI lays them out) ->
    per-step (loss, correct), the trainable params."""
    n = _world_size(axes)
    mesh = jax_make_mesh(axes, jax.devices()[:n])
    repl = NamedSharding(mesh, P())
    rows_sh = NamedSharding(mesh, P("model", None)) if "model" in axes \
        else repl
    with jax_policy.compute_dtype_scope("float32"):
        state = jax.device_put(_jax_state(w.jmodel, w.params, optimizer),
                               repl)
        feats = jax.device_put(jnp.asarray(w.feats), rows_sh)
        q = jax.device_put(jnp.asarray(w.q), repl)
        v = z = None
        if "v" in tables:
            v = jax.device_put(jnp.asarray(w.v), NamedSharding(
                mesh, P("model", None, None)) if "model" in axes else repl)
        if "z" in tables:
            z = jax.device_put(jnp.asarray(w.z), repl)
        step = jax_engine.make_cx_train_step(
            w.jmodel, optimizer, use_q_cache=True, use_v_cache=v is not None,
            use_z_cache=z is not None)
        rows = []
        with jax.set_mesh(mesh):
            for idx, n_valid in steps:
                batch = jax_shard_batch(jax_vqacx.gather_batch(w.arrays, idx),
                                        mesh)
                state, m = step(state, feats, batch,
                                jnp.asarray(n_valid, jnp.float32), q, v, z)
                rows.append((float(m["loss"]), float(m["correct"])))
        params = _trainable_as_port(jax_engine.split_params(
            state.params, ("vqa_model",))[0])
    return np.array(rows), params


def _port_world(w, steps, optimizer, tables, **extra):
    out = dict(w.rank_world, steps=steps, optimizer=optimizer, lr=extra.pop(
        "lr", LR), q=w.q, **extra)
    for name in tables:
        out[name] = getattr(w, name)
    return out


# ------------------------------------------------------------ the pieces

def test_parse_mesh_corpus_rows_and_rank_layout():
    assert parallel.parse_mesh("data=8") == {"data": 8}
    assert parallel.parse_mesh("data=4,model=2") == {"data": 4, "model": 2}
    assert parallel.parse_mesh(None) is None
    for bad in ("batch=2", "data=0"):
        with pytest.raises(ValueError):
            parallel.parse_mesh(bad)
    assert parallel.corpus_rows(50, 4) == [(0, 13), (13, 26), (26, 38),
                                           (38, 50)]
    assert [b - a for a, b in parallel.corpus_rows(82783, 2)] == [41392,
                                                                   41391]
    # rank = d * M + m, as JAX's make_mesh reshapes its device list
    coords = [(parallel.Mesh(DATA2_MODEL2, r, 4, torch.device("cpu"),
                             "gloo").index("data"),
               parallel.Mesh(DATA2_MODEL2, r, 4, torch.device("cpu"),
                             "gloo").index("model")) for r in range(4)]
    assert coords == [(0, 0), (0, 1), (1, 0), (1, 1)]
    jmesh = jax_make_mesh(DATA2_MODEL2, jax.devices()[:4])
    assert [d.id for d in jmesh.devices.reshape(-1)] == [
        jax.devices()[r].id for r in range(4)]
    mesh = parallel.Mesh(DATA2_MODEL2, 3, 4, torch.device("cpu"), "gloo")
    batch = {"a": np.arange(16), "b": torch.arange(32).view(16, 2)}
    local = parallel.shard_batch(batch, mesh)
    np.testing.assert_array_equal(local["a"], np.arange(8, 16))
    assert torch.equal(local["b"], torch.arange(16, 32).view(8, 2))
    with pytest.raises(ValueError, match="divide"):
        parallel.shard_batch({"a": np.arange(15)}, mesh)


def test_global_batch_draws_are_the_one_rank_draws():
    """Under ``global_batch`` a draw is the global batch's, narrowed to the
    rank's rows: on the leading axis (B or B x f rows) or a named one."""
    def draw(shape, axis=0, split=None):
        gen = torch.Generator().manual_seed(7)
        if split is None:
            return port_rng.keep_mask(shape, 0.75, gen, axis)[0]
        with port_rng.global_batch(*split):
            return port_rng.keep_mask(shape, 0.75, gen, axis)[0]

    full = draw((8, 5))
    assert torch.equal(draw((4, 5), split=(8, 4, 4)), full[4:])
    full = draw((8 * 3, 5))            # 3 rows an example
    assert torch.equal(draw((2 * 3, 5), split=(8, 2, 2)), full[6:12])
    full = draw((3, 8, 5), axis=1)     # the GRU's per-gate masks
    assert torch.equal(draw((3, 4, 5), axis=1, split=(8, 0, 4)),
                       full[:, :4])
    with pytest.raises(ValueError, match="not the batch"):
        draw((3, 5), split=(8, 0, 4))
    gen = torch.Generator().manual_seed(1)
    u = torch.rand((6, 2), generator=gen)
    gen.manual_seed(1)
    with port_rng.global_batch(6, 3, 3):
        got = port_rng.global_draw((3, 2), lambda s: torch.rand(
            s, generator=gen))
    assert torch.equal(got, u[3:])


def test_vqa_batches_part_are_rows_of_the_whole():
    """``VQAArrays.batches(part=...)``: each rank's rows of every batch,
    the answers sampled for the whole batch (the same ``rng`` draws), the
    ragged tail split unevenly."""
    from vqa_counterexamples_tpu_torch.cli import train as port_train
    from test_torch_pretrain import _cli_options
    from test_torch_pretrain import tiny_options as vqa_options

    examples, store, _, _ = port_train._synthetic_vqa(
        21, _cli_options(vqa_options()), seed=5)
    arrays = VQAArrays(examples, store, samplingans=True)
    whole = list(arrays.batches(8, rng=np.random.default_rng(3)))
    for parts in (2, 3):
        got = [list(arrays.batches(8, rng=np.random.default_rng(3),
                                   part=(i, parts))) for i in range(parts)]
        for b, full in enumerate(whole):
            pieces = [g[b] for g in got]
            for key in ("question", "answer", "question_id", "visual"):
                np.testing.assert_array_equal(
                    np.concatenate([np.asarray(p[key]) for p in pieces]),
                    np.asarray(full[key]), err_msg=key)
            assert [p["rows"] for p in pieces] == [
                (a, len(full["answer"])) for a, _ in parallel.corpus_rows(
                    len(full["answer"]), parts)]


def test_spawn_reraises_a_ranks_exception_and_stops_at_its_timeout():
    """A rank's exception comes back as itself, the other ranks stopped;
    ranks that run past the timeout are killed and ``TimeoutError``
    raised; a world of one returns rank 0's result."""
    import time

    t0 = time.monotonic()
    with pytest.raises(KeyError, match="rank 1 failed"):
        parallel.spawn(ranks.fail_or_sleep, (60,), world=3,
                       timeout=SPAWN_TIMEOUT)
    with pytest.raises(TimeoutError, match="past 3 s"):
        parallel.spawn(ranks.fail_or_sleep, (60,), world=1, timeout=3)
    assert time.monotonic() - t0 < 50
    assert parallel.spawn(ranks.fail_or_sleep, (0,), world=1,
                          timeout=SPAWN_TIMEOUT) == 0


def test_graphed_step_under_gloo_is_eager_and_refuses_capture():
    mesh = parallel.Mesh(DATA2, 0, 2, torch.device("cpu"), "gloo")
    with pytest.raises(ValueError, match="gloo"):
        graphs.GraphedStep(lambda b: {}, "cpu", capture=True, mesh=mesh)
    step = graphs.GraphedStep(lambda b: {"x": b["x"].sum()}, "cpu",
                              mesh=mesh)
    assert step.capture is False
    assert float(step({"x": np.ones(3, np.float32)})["x"]) == 3.0


# ------------------------------------------------- against JAX's mesh

@pytest.mark.parametrize("axes,tables", [
    (DATA2, ("z",)), (DATA2_MODEL2, ("z",)), (DATA2_MODEL2, ("v",))],
    ids=["data2_z", "data2_model2_z", "data2_model2_v"])
def test_cx_step_matches_jax_mesh(world, monkeypatch, axes, tables):
    """One SGD step on a padded batch (13 valid rows of 16): the loss at
    JAX's 1e-4, the recall count equal, every trainable parameter at rtol
    2e-4 / atol 2e-5 (``tests/test_parallel.py``'s bounds)."""
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "float32")
    steps = [(np.concatenate([np.arange(13), np.zeros(3, np.int64)]), 13)]
    ref_rows, ref = _jax_mesh_run(world, axes, steps, optax.sgd(0.1),
                                  tables)
    got = _spawn(ranks.cx_run, _port_world(world, steps, "sgd", tables,
                                           lr=0.1), axes=axes)
    assert abs(got["losses"][0, 0] - ref_rows[0, 0]) < 1e-4
    assert got["losses"][0, 1] == ref_rows[0, 1]
    assert set(got["params"]) == set(ref)
    for name, value in ref.items():
        np.testing.assert_allclose(got["params"][name], value, rtol=2e-4,
                                   atol=2e-5, err_msg=name)


@pytest.mark.parametrize("axes", [DATA2, DATA2_MODEL2],
                         ids=["data2", "data2_model2"])
def test_cx_trajectory_10_steps_tracks_jax_mesh(world, monkeypatch, axes):
    """10 Adam steps (every third batch padded: 8 valid rows of 16, none
    on data rank 1), z cache: per-step losses within rtol 1e-4, equal
    recall counts."""
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "float32")
    ref_rows, _ = _jax_mesh_run(world, axes, world.steps, optax.adam(LR),
                                ("z",))
    got = _spawn(ranks.cx_run, _port_world(world, world.steps, "adam",
                                           ("z",)), axes=axes)
    assert got["losses"].shape == (10, 2)
    np.testing.assert_allclose(got["losses"][:, 0], ref_rows[:, 0],
                               rtol=1e-4)
    np.testing.assert_array_equal(got["losses"][:, 1], ref_rows[:, 1])


@pytest.mark.parametrize("axes,axis", [({"data": 4}, "data"),
                                       (DATA2_MODEL2, "model")])
def test_sharded_gather_matches_jax(axes, axis):
    feats = np.random.default_rng(2).standard_normal((48, 10)).astype(
        np.float32)
    idx = np.random.default_rng(3).integers(0, 48, (5, 7)).astype(np.int32)
    jmesh = jax_make_mesh(axes, jax.devices()[:_world_size(axes)])
    ref = np.asarray(jax_sharded_gather(
        jax.device_put(feats, NamedSharding(jmesh, P(axis, None))),
        jnp.asarray(idx), jmesh, axis=axis))
    got = parallel.spawn(ranks.gather_run, (feats, idx, axes, axis),
                         world=_world_size(axes),
                         timeout=SPAWN_TIMEOUT)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, feats[idx])
    # uneven shards (50 rows over 4), -0.0 kept: still a plain take
    feats = np.random.default_rng(4).standard_normal((50, 6)).astype(
        np.float32)
    feats[7, 2] = -0.0
    idx = np.arange(49, -1, -1)[None]
    got = parallel.spawn(ranks.gather_run, (feats, idx, {"data": 4},
                                            "data"), world=4,
                         timeout=SPAWN_TIMEOUT)
    assert got.tobytes() == feats[idx].tobytes()


def test_sharded_knn_matches_jax_mesh():
    """The corpus over 4 ranks against JAX's ``topk.knn(mesh=)`` on 4
    devices: equal indices, distances at ``tests/test_cli_mesh.py``'s
    tolerance."""
    feats = np.random.default_rng(5).standard_normal((48, 16)).astype(
        np.float32)
    jmesh = jax_make_mesh({"data": 4}, jax.devices()[:4])
    ref_d, ref_i = jax_knn(feats, k=5, batch_size=16, mesh=jmesh)
    dist, idx = parallel.spawn(ranks.knn_run, (feats, 5, 16, {"data": 4}),
                               world=4, timeout=SPAWN_TIMEOUT)
    np.testing.assert_array_equal(idx, ref_i)
    # the self-distances are f32 cancellation noise of about sqrt(eps)
    np.testing.assert_allclose(dist, ref_d, rtol=1e-4, atol=5e-3)


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
def test_sharded_knn_bit_equal_to_one_rank(ties):
    """50 rows over 4 uneven shards against the one-rank search, bit for
    bit; with ``ties`` every row has a twin in another shard (equal
    distances across shards, which the merge searches again)."""
    feats = np.random.default_rng(6).standard_normal((50, 12)).astype(
        np.float32)
    if ties:
        feats[25:] = feats[:25]
    ref = port_topk.knn(feats, k=7, batch_size=16, device="cpu")
    got = parallel.spawn(ranks.knn_run, (feats, 7, 16, {"data": 4}),
                         world=4, timeout=SPAWN_TIMEOUT)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_mutan_noatt_step_matches_jax_mesh(monkeypatch):
    """One SGD step of MutanNoAtt over data=2 against JAX's mesh step:
    loss, acc@1, acc@5 and every parameter."""
    from test_torch_pretrain import _cli_options, build_vqa_pair
    from test_torch_pretrain import tiny_options as vqa_options
    from vqa_counterexamples_tpu_torch.cli import train as port_train

    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "float32")
    opt = vqa_options()
    examples, store, words, answers = port_train._synthetic_vqa(
        40, _cli_options(opt), seed=5)
    jmodel, params, pmodel = build_vqa_pair(words, answers, opt, seed=3)
    arrays = VQAArrays(examples, store, samplingans=True)
    batch = next(arrays.batches(16, rng=np.random.default_rng(0),
                                drop_remainder=True))
    jmesh = jax_make_mesh(DATA2, jax.devices()[:2])
    sgd = optax.sgd(0.1)
    with jax_policy.compute_dtype_scope("float32"):
        jparams = jax.device_put(jax.tree.map(jnp.asarray, params),
                                 NamedSharding(jmesh, P()))
        jstate = jax_vqa_engine.VQATrainState(
            jparams, sgd.init(jparams), jnp.zeros((), jnp.int32))
        step = jax_vqa_engine.make_vqa_train_step(jmodel, sgd)
        with jax.set_mesh(jmesh):
            jstate, jm = step(jstate, jax_shard_batch(
                {k: jnp.asarray(batch[k]) for k in ("visual", "question",
                                                    "answer")}, jmesh))
        ref = {k: v.numpy() for k, v in from_jax.vqa_state_dict_from_jax(
            jax.device_get(jstate.params)).items()}
    got = parallel.spawn(ranks.vqa_run, (dict(
        opt=opt, words=words, answers=answers, optimizer="sgd", lr=0.1,
        state={k: v.numpy() for k, v in pmodel.state_dict().items()},
        batches=[batch]), DATA2), world=2, timeout=SPAWN_TIMEOUT)
    for i, k in enumerate(("loss", "acc1", "acc5")):
        assert got["losses"][0, i] == pytest.approx(float(jm[k]), abs=1e-4)
    for name, value in ref.items():
        np.testing.assert_allclose(got["params"][name], value, rtol=2e-4,
                                   atol=2e-5, err_msg=name)


# ------------------------------------------- against the port's one rank

@pytest.mark.parametrize("axes,dtype", [(DATA2, "float32"),
                                        (DATA2_MODEL2, "float32"),
                                        (DATA2_MODEL2, "bfloat16")],
                         ids=["data2", "data2_model2", "data2_model2_bf16"])
def test_cx_dropout_on_and_eval_match_one_rank(world, monkeypatch, axes,
                                               dtype):
    """Dropout on (the masks drawn at the global batch's shape), 4 SGD
    steps and an eval pass (the ranks' sums added): the ranks against the
    port's one rank.  Under bf16 the model takes the table form, over a
    compact table gathered from the row shards."""
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", dtype)
    w = dict(_port_world(world, world.steps[:4], "sgd", ("z",), lr=0.1),
             spec=SPEC, eval=True)
    ref = ranks.cx_run(w)
    got = _spawn(ranks.cx_run, w, axes=axes)
    rel = 1e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(got["losses"][:, 0], ref["losses"][:, 0],
                               rtol=rel)
    np.testing.assert_array_equal(got["losses"][:, 1], ref["losses"][:, 1])
    for k, v in ref["eval"].items():
        assert got["eval"][k] == pytest.approx(v, rel=rel), k
    for name, value in ref["params"].items():
        scale = max(np.abs(value).max(), 1.0)
        np.testing.assert_allclose(got["params"][name], value, rtol=0,
                                   atol=(1e-6 if dtype == "float32"
                                         else 5e-2) * scale, err_msg=name)


def _vqa_options(arch):
    """A tiny option tree of ``arch`` with every dropout at 0.25, and its
    CLI options."""
    import test_torch_mlb as mlb
    import test_torch_pretrain as mutan

    if arch == "MutanNoAtt":
        opt = mutan.tiny_options(dropout=0.25)
        return opt, mutan._cli_options(opt)
    opt = (mlb.noatt_options(dropout=0.25, gru_dropout=0.25)
           if arch == "MLBNoAtt" else mlb.att_options(dropout=0.25))
    return opt, mlb._cli_options(opt)


@pytest.mark.parametrize("arch", ["MutanNoAtt", "MLBNoAtt", "MLBAtt"])
def test_vqa_dropout_on_matches_one_rank(monkeypatch, arch):
    """A VQA arch with every dropout at 0.25 over data=2: the GRU's
    per-gate masks (batch on axis 1), the attention's over B x 196 map
    rows, the fusion's and the classifier's drawn at the global shape; 3
    SGD steps against one rank."""
    from vqa_counterexamples_tpu_torch.cli import train as port_train
    from vqa_counterexamples_tpu_torch.engines import vqa_engine
    from vqa_counterexamples_tpu_torch.models import factory

    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "float32")
    opt, cli_options = _vqa_options(arch)
    examples, store, words, answers = port_train._synthetic_vqa(
        48, cli_options, seed=5)
    model = vqa_engine.init_vqa_params(factory.factory_vqa(opt, words,
                                                           answers), seed=2)
    arrays = VQAArrays(examples, store, samplingans=True)
    w = dict(opt=opt, words=words, answers=answers, optimizer="sgd", lr=0.1,
             state={k: v.numpy() for k, v in model.state_dict().items()},
             batches=list(arrays.batches(16, rng=np.random.default_rng(1),
                                         drop_remainder=True)))
    ref = ranks.vqa_run(w)
    got = parallel.spawn(ranks.vqa_run, (w, DATA2), world=2,
                         timeout=SPAWN_TIMEOUT)
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
    for name, value in ref["params"].items():
        np.testing.assert_allclose(got["params"][name], value, rtol=0,
                                   atol=1e-6 * max(np.abs(value).max(), 1),
                                   err_msg=name)


def test_train_cli_trainval_test_rows_match_one_rank(tmp_path, monkeypatch):
    """A trainval run over data=2: each epoch's test pass splits its
    batches (24, 24 and a ragged 16: 8 rows a rank) and gathers the
    answers to every rank in row order; rank 0's test2015 and test-dev
    rows equal one rank's."""
    import json

    from test_torch_pretrain import _cli, _tiny_config
    from vqa_counterexamples_tpu_torch.cli import train as port_train

    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "float32")
    path, _ = _tiny_config(tmp_path, trainsplit="trainval")
    rows = {}
    for name, extra in (("one", []), ("mesh", ["--mesh", "data=2"])):
        logs = tmp_path / name
        port_train.main(_cli(path, "--epochs", "1", "-b", "24", "--dir_logs",
                             str(logs), *extra))
        rows[name] = [json.loads((logs / "results" / split /
                                  "vqa_OpenEnded_mscoco_epoch_1.json")
                                 .read_text())
                      for split in ("test2015", "test-dev2015")]
    assert [len(r) for r in rows["mesh"]] == [64, 32]
    assert rows["mesh"] == rows["one"]


def test_dryrun_multichip(capsys):
    parallel.dryrun_multichip(2)
    assert "dryrun_multichip(2): ok" in capsys.readouterr().out


# ------------------------------------------------ start-up and refusals

def _torchrun_env(monkeypatch, world=1):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k, v in {"RANK": "0", "WORLD_SIZE": str(world), "LOCAL_RANK": "0",
                 "LOCAL_WORLD_SIZE": str(world), "MASTER_ADDR": "127.0.0.1",
                 "MASTER_PORT": str(port)}.items():
        monkeypatch.setenv(k, v)


def test_distributed_reads_torchrun_env(tmp_path, monkeypatch):
    """``--distributed`` in a faked one-rank torchrun environment: the
    process group comes up from it, the run equals the plain one, and the
    group is gone after."""
    import torch.distributed as dist

    from vqa_counterexamples_tpu_torch.cli import knn as port_knn_cli
    from vqa_counterexamples_tpu_torch.data.features import FeatureStore

    feats = np.random.default_rng(8).standard_normal((30, 8)).astype(
        np.float32)
    prefix = str(tmp_path / "set")
    FeatureStore(feats, ["COCO_train2014_%012d.jpg" % i
                         for i in range(30)]).save(prefix)
    base = ["--path_features", prefix, "-k", "4", "--device", "cpu"]
    ref = port_knn_cli.main(base + ["--out", str(tmp_path / "a.npy")])
    _torchrun_env(monkeypatch)
    got = port_knn_cli.main(base + ["--distributed", "--out",
                                    str(tmp_path / "b.npy")])
    assert not dist.is_initialized()
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_cli_refusals(tmp_path, monkeypatch):
    """``batch_size % data`` (raised in the ranks, re-raised here), ranks
    that would share a card under NCCL, mesh axes that do not multiply to
    WORLD_SIZE."""
    from test_torch_slice import _tiny_cli_options
    from vqa_counterexamples_tpu_torch.cli import counterexamples as cx_cli

    argv = ["--cx_model", "NeuralModel", "--synthetic", "64", "--epochs",
            "1", "--path_opt", _tiny_cli_options(tmp_path), "--project_dir",
            str(tmp_path)]
    with pytest.raises(ValueError, match="must divide over data=2"):
        cx_cli.main(argv + ["-b", "25", "--mesh", "data=2", "--device",
                            "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="--dist_backend gloo"):
        cx_cli.main(argv + ["--mesh", "data=2"])
    with pytest.raises(ValueError, match="NCCL"):
        cx_cli.main(argv + ["--mesh", "data=2", "--device", "cpu",
                            "--dist_backend", "nccl"])
    _torchrun_env(monkeypatch, world=3)
    with pytest.raises(ValueError, match="WORLD_SIZE is 3"):
        cx_cli.main(argv + ["--mesh", "data=2", "--distributed", "--device",
                            "cpu"])
    assert not (tmp_path / "logs").exists()
