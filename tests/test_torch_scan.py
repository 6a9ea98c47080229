"""The port's scanned trainer (``make_cx_train_scan``, ``train_epoch``'s
grouping, ``--scan_steps``) and the machinery of its captured steps
(``core/graphs``), on the CPU, where every step runs eagerly.

Sizes are small (dim_v 128, K 6, 64 examples over 32 images, B 10: six
full batches and a padded seventh of 4, so ``scan_len`` 3 gives two full
groups and a short one).  Against JAX the weights go across through
``models/from_jax`` and dropout is off (the frameworks draw different
bits); port against port, dropout is on.  The capture itself needs a
card (tests/test_torch_cuda.py); here a fake graph stands in for it, to
check what the step does around a capture: the warm-up leaves no trace,
launch counts are recorded during the capture and added per replay, and
moved optimizer state is captured again.
"""

import copy
import json
import os
from contextlib import nullcontext
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vqa_counterexamples_tpu.core import policy as jax_policy
from vqa_counterexamples_tpu.data import synthetic as jax_synthetic
from vqa_counterexamples_tpu.engines import cx_engine as jax_engine
from vqa_counterexamples_tpu_torch.cli import counterexamples as port_cli
from vqa_counterexamples_tpu_torch.core import graphs, rng as port_rng
from vqa_counterexamples_tpu_torch.core import spans
from vqa_counterexamples_tpu_torch.data import vqacx as port_vqacx
from vqa_counterexamples_tpu_torch.engines import cx_engine as port_engine
from vqa_counterexamples_tpu_torch.models import seq2vec as port_seq2vec

from test_torch_modules import K, SPEC, build_pair
from test_torch_slice import _tiny_cli_options

B, LR, SCAN = 10, 1e-3, 3
SPEC0 = dict(SPEC, drop_p=0.0)


def _world(spec):
    dataset, store = jax_synthetic.make_synthetic_cx(
        n_examples=64, n_images=32, dim_v=128, knn_size=K, n_words=20,
        n_answers=20, seed=3)
    jmodel, params, pmodel, arrays = build_pair(dataset, seed=2, spec=spec)
    params = jax.tree.map(np.asarray, params)
    with jax_policy.compute_dtype_scope("float32"):
        q, _, z, _ = jax_engine.build_frozen_caches(
            jmodel, params, jnp.asarray(store.features), arrays, use_q=True,
            use_v=False, use_z=True)
    return SimpleNamespace(jmodel=jmodel, params=params, pmodel=pmodel,
                           arrays=port_vqacx.CXArrays(*arrays),
                           jarrays=arrays, feats=store.features,
                           q=np.array(q), z=np.array(z))


@pytest.fixture(scope="module")
def world():
    return _world(SPEC)


@pytest.fixture(scope="module")
def world0():
    return _world(SPEC0)


def _recording(fn, rows):
    """``fn`` (a step or a scan trainer) with each step's loss and
    correct count appended to ``rows``."""
    def wrapped(*args, **kwargs):
        state, m = fn(*args, **kwargs)
        rows.extend(zip(np.atleast_1d(np.asarray(m["loss"])).tolist(),
                        np.atleast_1d(np.asarray(m["correct"])).tolist()))
        return state, m
    return wrapped


def _port_epoch(w, caches, scan, seed=5):
    """One port epoch -> (state, per-step rows, hook batches, model)."""
    model = copy.deepcopy(w.pmodel)
    state = port_engine.init_cx_state(model, lr=LR)
    kw = dict(use_z_cache=True) if caches else {}
    tables = (dict(q_table=torch.from_numpy(w.q),
                   z_table=torch.from_numpy(w.z)) if caches else {})
    rows, hooks = [], []
    single = port_engine.make_cx_train_step(model, state.optimizer, **kw)
    step = _recording(single, rows)
    scan_step = (_recording(port_engine.make_cx_train_scan(single), rows)
                 if scan else None)
    state, res = port_engine.train_epoch(
        step, state, torch.from_numpy(w.feats), w.arrays, B,
        rng=np.random.default_rng(seed), print_freq=1,
        log_fn=lambda b, m: hooks.append(("log", b, m["loss"])),
        eval_fn=lambda st: hooks.append(("eval", st.step)) or {"n": 1},
        scan_step=scan_step, scan_len=SCAN if scan else 0, **tables)
    return state, rows, hooks, model


@pytest.mark.parametrize("caches", [False, True])
def test_train_epoch_scan_matches_single_steps(world, monkeypatch, caches):
    """Dropout on: the scanned epoch draws each step's masks from (seed,
    step, name) as the single steps do, so every per-step loss and count,
    every parameter and Adam moment, and ``state.step`` are bit-equal;
    the hooks fire at the groups' last batches (3, 6, 7) with those
    steps' metrics."""
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "float32")
    single, rows1, hooks1, m1 = _port_epoch(world, caches, scan=False)
    scanned, rows2, hooks2, m2 = _port_epoch(world, caches, scan=True)
    assert single.step == scanned.step == 7
    assert rows1 == rows2 and len(rows1) == 7
    assert [h[1] for h in hooks1 if h[0] == "log"] == list(range(1, 8))
    assert [h[1] for h in hooks2 if h[0] == "log"] == [3, 6, 7]
    logged = {h[1]: h[2] for h in hooks1 if h[0] == "log"}
    assert [h[2] for h in hooks2 if h[0] == "log"] == [
        logged[3], logged[6], logged[7]]
    assert [h for h in hooks2 if h[0] == "eval"] == [("eval", 7)]
    for (n, a), (_, b) in zip(m1.named_parameters(), m2.named_parameters()):
        assert torch.equal(a, b), n
    for p1, p2 in zip(single.optimizer.param_groups[0]["params"],
                      scanned.optimizer.param_groups[0]["params"]):
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(single.optimizer.state[p1][k],
                               scanned.optimizer.state[p2][k]), k


def test_train_scan_stacks_one_row_per_step(world, monkeypatch):
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "float32")
    model = copy.deepcopy(world.pmodel)
    state = port_engine.init_cx_state(model, lr=LR)
    scan = port_engine.make_cx_train_scan(
        port_engine.make_cx_train_step(model, state.optimizer))
    idx = [np.arange(i * B, (i + 1) * B) for i in range(SCAN)]
    batches = [port_vqacx.gather_batch(world.arrays, i) for i in idx]
    state, ms = scan(state, torch.from_numpy(world.feats), batches,
                     [B, B, 7])
    assert state.step == SCAN
    assert ms["loss"].shape == ms["correct"].shape == (SCAN,)
    assert ms["n"].tolist() == [B, B, 7]
    assert torch.isfinite(ms["loss"]).all()


def test_train_epoch_scan_tracks_jax(world0, monkeypatch):
    """The port's scanned epoch against JAX's ``train_epoch`` with its
    ``lax.scan`` trainer (z cache on, dropout off, f32): every per-step
    loss within rtol 1e-4, equal recall counts, the same step count and
    the hooks at the same batches."""
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "float32")
    w = world0
    opt = optax.adam(LR)
    jrows, jhooks = [], []
    with jax_policy.compute_dtype_scope("float32"):
        kw = dict(use_q_cache=True, use_z_cache=True)
        params = jax.tree.map(jnp.asarray, w.params)
        trainable, _ = jax_engine.split_params(
            params, jax_engine.frozen_param_keys(w.jmodel))
        jstate = jax_engine.CXTrainState(params, opt.init(trainable),
                                         jnp.zeros((), jnp.int32))
        jstate, _ = jax_engine.train_epoch(
            _recording(jax_engine.make_cx_train_step(w.jmodel, opt, **kw),
                       jrows),
            jstate, jnp.asarray(w.feats), w.jarrays, B,
            rng=np.random.default_rng(5), print_freq=1,
            log_fn=lambda b, m: jhooks.append(("log", b)),
            eval_fn=lambda st: jhooks.append(("eval", int(st.step))) or {},
            q_table=w.q, z_table=w.z,
            scan_step=_recording(jax_engine.make_cx_train_scan(
                w.jmodel, opt, **kw), jrows), scan_len=SCAN)
    state, rows, hooks, _ = _port_epoch(w, True, scan=True)
    assert int(jstate.step) == state.step == 7
    assert [h[:2] for h in hooks] == jhooks
    rows, jrows = np.array(rows), np.array(jrows)
    np.testing.assert_allclose(rows[:, 0], jrows[:, 0], rtol=1e-4)
    np.testing.assert_array_equal(rows[:, 1], jrows[:, 1])


def test_padded_batch_n_valid_on_the_device_matches_jax(world0, monkeypatch):
    """The padded last batch (4 valid rows of 10): ``n_valid`` reaches the
    step as a 0-d int32 buffer of its own, the loss and recall count match
    JAX's step, and the padded rows' contents do not matter."""
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "float32")
    w = world0
    idx = np.concatenate([np.arange(60, 64), np.zeros(6, np.int64)])
    opt = optax.adam(LR)
    with jax_policy.compute_dtype_scope("float32"):
        params = jax.tree.map(jnp.asarray, w.params)
        trainable, _ = jax_engine.split_params(params, ("vqa_model",))
        jstate = jax_engine.CXTrainState(params, opt.init(trainable),
                                         jnp.zeros((), jnp.int32))
        jstep = jax_engine.make_cx_train_step(w.jmodel, opt,
                                              use_q_cache=True,
                                              use_z_cache=True)
        _, jm = jstep(jstate, jnp.asarray(w.feats),
                      port_vqacx.gather_batch(w.arrays, idx),
                      jnp.asarray(4.0, jnp.float32), w.q, None, w.z)
    losses = []
    for pad in (0, 17):
        model = copy.deepcopy(w.pmodel)
        state = port_engine.init_cx_state(model, lr=LR)
        step = port_engine.make_cx_train_step(model, state.optimizer,
                                              use_z_cache=True)
        idx_p = idx.copy()
        idx_p[4:] = pad
        state, pm = step(state, torch.from_numpy(w.feats),
                         port_vqacx.gather_batch(w.arrays, idx_p), 4,
                         q_table=torch.from_numpy(w.q),
                         z_table=torch.from_numpy(w.z))
        (static,) = step.graphed._inputs.values()
        nv = static.tensors["n_valid"]
        assert nv.dtype == torch.int32 and nv.shape == () and int(nv) == 4
        assert pm["n"] == 4.0
        assert float(pm["correct"]) == float(jm["correct"])
        losses.append(float(pm["loss"]))
    assert losses[0] == losses[1]
    assert losses[0] == pytest.approx(float(jm["loss"]), rel=1e-5)


def test_cli_scan_steps_gives_the_same_final_results(tmp_path, monkeypatch):
    """``--scan_steps 2`` (64 examples at B 24: a group of 2 and a single
    step per epoch) writes the ``final_results.txt`` of the run without
    it, to the bit."""
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "float32")
    texts = []
    for extra in ([], ["--scan_steps", "2"]):
        proj = tmp_path / ("scan" if extra else "single")
        info = port_cli.main(["--cx_model", "NeuralModel", "--synthetic",
                              "64", "--z_cache", "--epochs", "2", "--test",
                              "--device", "cpu", "--project_dir", str(proj),
                              "--path_opt", _tiny_cli_options(tmp_path),
                              *extra])
        assert len(info) == 2
        (run,) = os.listdir(proj / "logs" / "cx")
        texts.append((proj / "logs" / "cx" / run /
                      "final_results.txt").read_text())
    assert texts[0] == texts[1]
    assert set(json.loads(texts[0])) == {"loss", "recall", "recall_1",
                                         "best_epoch"}


# ------------------------------------------ the capture, with a fake graph

class _FakeGraph:
    """Stands in for ``torch.cuda.CUDAGraph``: records its generators and
    its replays; a replay runs nothing."""

    def __init__(self):
        self.gens, self.replays = [], 0

    def register_generator_state(self, gen):
        self.gens.append(gen)

    def replay(self):
        self.replays += 1


class _FakeStream:
    def wait_stream(self, other):
        pass


def _fake_cuda(monkeypatch, at_capture):
    """Route ``GraphedStep``'s capture through fakes on the CPU: the
    capture context calls ``at_capture()`` on entry, then the body runs
    eagerly inside it (a real capture would only record it)."""
    class _graph:
        def __init__(self, graph, stream=None):
            self.graph = graph

        def __enter__(self):
            at_capture(self.graph)

        def __exit__(self, *exc):
            return False

    made = []

    def new_graph():
        made.append(_FakeGraph())
        return made[-1]

    monkeypatch.setattr(torch.cuda, "CUDAGraph", new_graph)
    monkeypatch.setattr(torch.cuda, "graph", _graph)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None:
                        _FakeStream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: nullcontext())
    return made


# launch counters that no kernel wrapper declares
TOY = ("kernels.launches.toy_a", "kernels.launches.toy_b")


def _toy_step(calls):
    """A linear model with dropout trained by Adam; its body counts two
    launches on ``TOY[0]`` and one on ``TOY[1]``, and a kernel build at
    its first call (as a wrapper's first launch builds its library)."""
    model = torch.nn.Linear(4, 3)
    with torch.no_grad():
        model.weight.copy_(torch.arange(12.0).view(3, 4) / 10)
        model.bias.zero_()
    opt = torch.optim.Adam(model.parameters(), lr=0.1)
    gens = port_rng.StepGenerators(("dropout",), "cpu")

    def body(inputs):
        calls.append(1)
        spans.count(TOY[0], 2)
        spans.count(TOY[1])
        if len(calls) == 1:
            spans.count("kernels.builds")
        keep, scale = port_rng.keep_mask(tuple(inputs["x"].shape), 0.75,
                                         gens["dropout"])
        x = torch.where(keep, inputs["x"] * scale, 0.0)
        loss = (model(x) ** 2).mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return {"loss": loss.detach()}

    run = graphs.GraphedStep(body, "cpu", generators=gens, optimizer=opt)
    run.capture = True
    return model, opt, gens, run


def _state(model, opt, gens):
    return ([p.detach().clone() for p in model.parameters()],
            [{k: v.clone() for k, v in opt.state[p].items()}
             for p in model.parameters()],
            gens["dropout"].get_state().clone())


def _same_state(a, b):
    params_a, adam_a, gen_a = a
    params_b, adam_b, gen_b = b
    return (all(torch.equal(x, y) for x, y in zip(params_a, params_b))
            and len(adam_a) == len(adam_b)
            and all(x.keys() == y.keys()
                    and all(torch.equal(x[k], y[k]) for k in x)
                    for x, y in zip(adam_a, adam_b))
            and torch.equal(gen_a, gen_b))


def test_warmup_is_undone_bit_for_bit(monkeypatch):
    """At the capture, after the warm-up has run a whole step: the
    parameters, the Adam state (zeroed, as Adam's lazy init makes it,
    where the warm-up created it; restored where it existed) and the
    generator hold what they held before the warm-up, and the grads are
    gone."""
    calls, seen = [], []
    model, opt, gens, run = _toy_step(calls)
    x = np.linspace(-1, 1, 20, dtype=np.float32).reshape(5, 4)

    # the reference: a fresh Adam's state after its lazy init, and the
    # generator as the step reseeds it
    gens.reseed(0, 0)
    fresh = _state(model, opt, gens)
    fresh = (fresh[0], [{"step": torch.tensor(0.0),
                         "exp_avg": torch.zeros_like(p),
                         "exp_avg_sq": torch.zeros_like(p)}
                        for p in model.parameters()], fresh[2])
    _fake_cuda(monkeypatch, lambda g: seen.append(
        (_state(model, opt, gens),
         [p.grad is None for p in model.parameters()])))
    run({"x": x}, seed=0, step=0)
    assert len(calls) == 2                   # warm-up and capture
    assert _same_state(seen[0][0], fresh) and all(seen[0][1])

    # again with Adam's state present: a new layout captures anew
    gens.reseed(0, 5)
    before = _state(model, opt, gens)
    run({"x": x[:4]}, seed=0, step=5)
    assert len(calls) == 4
    assert _same_state(seen[1][0], before) and all(seen[1][1])


def test_launches_recorded_at_capture_and_added_per_replay(monkeypatch):
    """Each call replays once and adds the capture's launch counts; the
    warm-up's and the capture's own counts are taken back.  Moved
    optimizer state (``load_state_dict`` makes new tensors) captures
    again; the same state and layout do not."""
    spans.count(TOY[0], 10)
    before = spans.counters()
    calls = []
    model, opt, gens, run = _toy_step(calls)
    made = _fake_cuda(monkeypatch, lambda g: None)
    x = np.ones((5, 4), np.float32)
    for step in range(3):
        out = run({"x": x}, seed=1, step=step)
        assert set(out) == {"loss"}
    assert len(calls) == 2 and len(made) == 1 and run.n_graphs == 1
    assert made[0].replays == 3 and made[0].gens == [gens["dropout"]]
    assert _moved(before, TOY) == [3 * 2, 3 * 1]
    opt.load_state_dict(copy.deepcopy(opt.state_dict()))
    run({"x": x}, seed=1, step=3)
    assert len(calls) == 4 and len(made) == 2 and run.n_graphs == 1
    assert _moved(before, TOY) == [4 * 2, 4 * 1]


def _moved(before, names):
    """How far each of ``names`` moved in the store since ``before``."""
    now = spans.counters()
    return [now.get(k, 0) - before.get(k, 0) for k in names]


def test_capture_rolls_back_the_launch_counters_alone(monkeypatch):
    """A step whose body counts launch counters that no wrapper declared
    and no one handed the step: each replay adds the capture's counts to
    the store, the warm-up and the capture leave none of their own;
    ``kernels.builds`` (the warm-up's build) and ``engine.captures`` keep
    what the warm-up and the capture added; after the optimizer's state
    moves the step captures again and goes on counting from there."""
    names = TOY + ("kernels.builds", "engine.captures")
    before = spans.counters()
    calls = []
    model, opt, gens, run = _toy_step(calls)
    made = _fake_cuda(monkeypatch, lambda g: None)
    x = np.ones((5, 4), np.float32)
    run({"x": x}, seed=2, step=0)
    assert len(calls) == 2 and made[0].replays == 1
    assert _moved(before, names) == [2, 1, 1, 1]
    run({"x": x}, seed=2, step=1)
    assert len(calls) == 2 and _moved(before, names) == [4, 2, 1, 1]
    opt.load_state_dict(copy.deepcopy(opt.state_dict()))
    for step in (2, 3):
        run({"x": x}, seed=2, step=step)
    assert len(calls) == 4 and len(made) == 2 and made[1].replays == 2
    assert _moved(before, names) == [8, 4, 1, 2]


def test_static_inputs_keep_their_buffers():
    """Host arrays of one dtype share one buffer, refilled in place each
    load; the tensors the body reads never move."""
    layout_in = {"a": np.zeros((2, 3), np.int32), "n": np.int32(0),
                 "v": np.zeros(4, np.float32)}
    layout = graphs.input_layout(layout_in)
    static = graphs.StaticInputs(layout, "cpu")
    ptrs = {k: t.data_ptr() for k, t in static.tensors.items()}
    for i in range(3):
        static.load({"a": np.full((2, 3), i, np.int32), "n": np.int32(7 + i),
                     "v": torch.full((4,), float(i))})
        assert {k: t.data_ptr() for k, t in static.tensors.items()} == ptrs
        assert static.tensors["a"].tolist() == [[i] * 3] * 2
        assert int(static.tensors["n"]) == 7 + i
        assert static.tensors["v"].tolist() == [float(i)] * 4
    # a and n share the int32 buffer
    assert static.tensors["n"].data_ptr() == ptrs["a"] + 6 * 4
    assert graphs.input_layout({"a": torch.zeros(2, 3, dtype=torch.int32),
                                "n": np.int32(1),
                                "v": np.ones(4, np.float32)}) == layout


def test_capture_runs_with_the_collector_off(monkeypatch):
    """Python's cyclic collector is off while a graph is captured (a
    collection there could destroy another graph, which invalidates a
    capture) and on again afterwards."""
    import gc

    seen = []
    model, opt, gens, run = _toy_step([])
    _fake_cuda(monkeypatch, lambda g: seen.append(gc.isenabled()))
    assert gc.isenabled()
    run({"x": np.ones((5, 4), np.float32)}, seed=0, step=0)
    assert seen == [False] and gc.isenabled()


def _launches():
    return {k[len("kernels.launches."):]: n
            for k, n in spans.counters().items()
            if k.startswith("kernels.launches.") and k not in TOY}


def test_steps_count_every_kernel_wrappers_launches(world):
    """The engines' steps count launches in the one store every kernel
    wrapper counts in: ``spans.counters()`` reports all thirteen wrappers,
    each an int, around a CX train epoch and an eval pass, which on the
    CPU launch none."""
    before = _launches()
    assert sorted(before) == sorted([
        "gru", "gru_pg", "gru_bwd", "vfeat", "vfeat_bwd", "mixture", "mutan",
        "attmutan", "attmutan_bwd", "knn", "xproj", "xproj_dx", "xproj_dw"])
    assert all(type(n) is int for n in before.values())
    state, _, _, model = _port_epoch(world, caches=False, scan=False)
    assert state.step == 7
    port_engine.eval_model(port_engine.make_cx_eval_step(model),
                           torch.from_numpy(world.feats), world.arrays, B)
    assert _launches() == before


def test_port_embedding_matches_f_embedding():
    """``models/seq2vec.embedding``: the rows and the table's gradient of
    ``F.embedding`` (repeated ids, padding id 0 among them)."""
    gen = torch.Generator().manual_seed(0)
    table = torch.randn(9, 5, generator=gen)
    ids = torch.randint(0, 9, (4, 7), generator=gen)
    cot = torch.randn(4, 7, 5, generator=gen)
    grads = []
    for fn in (torch.nn.functional.embedding, port_seq2vec.embedding):
        t = table.clone().requires_grad_(True)
        out = fn(ids, t)
        assert torch.equal(out, table[ids])
        out.backward(cot)
        grads.append(t.grad)
    assert torch.allclose(grads[0], grads[1], rtol=1e-6, atol=1e-6)
    assert not torch.are_deterministic_algorithms_enabled()


def test_capture_needs_a_card():
    with pytest.raises(ValueError, match="CUDA device"):
        graphs.GraphedStep(lambda inputs: {}, "cpu", capture=True)
    assert not graphs.GraphedStep(lambda inputs: {}, "cpu").capture


def test_state_step_is_a_host_int_that_advances_once_a_call(world,
                                                            monkeypatch):
    """The CX train step under a (fake) capture: at the capture the
    warm-up has left the trainable parameters as they started and
    ``state.step`` at 0; each call then advances ``state.step`` by one,
    a host int, and replays once."""
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "float32")
    model = copy.deepcopy(world.pmodel)
    state = port_engine.init_cx_state(model, lr=LR)
    start = [p.detach().clone() for p in
             state.optimizer.param_groups[0]["params"]]
    seen = []
    made = _fake_cuda(monkeypatch, lambda g: seen.append(
        (state.step, [torch.equal(p, s) for p, s in zip(
            state.optimizer.param_groups[0]["params"], start)])))
    step = port_engine.make_cx_train_step(model, state.optimizer)
    step.graphed.capture = True
    for i in range(3):
        state, m = step(state, torch.from_numpy(world.feats),
                        port_vqacx.gather_batch(world.arrays,
                                                np.arange(i * B,
                                                          (i + 1) * B)), B)
        assert type(state.step) is int and state.step == i + 1
        assert m["n"] == float(B)
    assert seen == [(0, [True] * len(start))]
    assert len(made) == 1 and made[0].replays == 3
