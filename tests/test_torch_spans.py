"""The port's spans and counters (``core/spans``) and the benchmark's
readers of them (``perfbench/metrics``): off with no profiler, nested on the
profiler's timeline under one, placed once per call at each layer boundary,
and read back by the eight per-layer metrics from synthetic traces.

The test marked ``cuda`` skips where no card is visible; on a host with a
card and no JAX run it as

    python -m pytest --noconftest -m cuda tests/test_torch_spans.py
"""

import sys
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from perfbench.harness.registry import Registry
from perfbench.harness.trace import Trace
from vqa_counterexamples_tpu_torch.core import graphs, spans
from vqa_counterexamples_tpu_torch.core.experiment import Experiment
from vqa_counterexamples_tpu_torch.core.meters import AvgMeter
from vqa_counterexamples_tpu_torch.data import synthetic, vqacx
from vqa_counterexamples_tpu_torch.data.vqa_dataset import VQAArrays
from vqa_counterexamples_tpu_torch.engines import cx_engine, vqa_engine
from vqa_counterexamples_tpu_torch.models import factory

READERS = ("loader_ms_per_step.train", "loader_ms_per_step.eval",
           "host_ms_per_step.train", "host_ms_per_step.eval",
           "step_idle_ms.train", "step_idle_ms.eval", "capture_s.train",
           "cache_build_s")


@pytest.fixture(autouse=True)
def fresh():
    spans.reset()
    yield
    spans.reset()


def _profiled(fn):
    """``fn()`` under a CPU profiler -> (its result, the profiler)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _names(recs=None):
    return [r[0] for r in (spans.records() if recs is None else recs)]


def _experiment():
    exp = Experiment("spans")
    for tag in ("train", "val"):
        exp.add_meters(tag, {k: AvgMeter() for k in (
            "loss", "acc1", "acc5", "batch_time", "data_time")})
    return exp


def test_span_off_records_nothing(monkeypatch):
    def refuse(name):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not spans.recording()
    with spans.span("engine.step", 3):
        with spans.span("engine.replay"):
            pass
    assert spans.records() == []


def test_spans_nest_on_the_profiler_timeline():
    def work():
        with spans.span("engine.step", 7):
            with spans.span("engine.stage"):
                torch.ones(3).sum()
            with spans.span("engine.replay"):
                with spans.span("inner"):
                    pass
        with spans.span("data.batch"):
            pass

    _, prof = _profiled(work)
    recs = spans.records()
    assert _names(recs) == ["engine.step", "engine.stage", "engine.replay",
                            "inner", "data.batch"]
    parents = [r[1] for r in recs]
    assert parents == [-1, 0, 0, 2, -1]
    assert [r[2] for r in recs] == [7, 7, 7, 7, None]
    for name, parent, _, start, end in recs:
        assert start <= end
        if parent >= 0:
            assert recs[parent][3] <= start and end <= recs[parent][4]
    seen = {e.name for e in prof.events()}
    assert {"engine.step", "engine.stage", "engine.replay", "inner",
            "data.batch"} <= seen
    rows = spans.summary(recs)
    step = rows["engine.step"]
    assert step["calls"] == 1
    children = sum(rows[n]["total_ms"] for n in ("engine.stage",
                                                 "engine.replay"))
    assert step["self_ms"] == pytest.approx(step["total_ms"] - children)
    # spans closed after the profiler stopped are not kept
    spans.reset()
    with spans.span("engine.step"):
        pass
    assert spans.records() == []


def test_counters_count_without_profiler():
    assert not spans.recording()
    spans.count("engine.captures")
    spans.count("engine.captures", 2)
    with spans.timed("kernels.build_s", "kernels.builds") as t:
        sum(range(1000))
    got = spans.counters()
    assert got["engine.captures"] == 3
    assert got["kernels.builds"] == 1
    assert got["kernels.build_s"] == t.seconds > 0
    # the wrappers' modules declared their launch counters at import
    assert got["kernels.launches.mutan"] == got["kernels.launches.knn"] == 0
    spans.add({"kernels.launches.mutan": 2, "engine.captures": 1})
    got = spans.counters()
    assert got["engine.captures"] == 4 and got["kernels.launches.mutan"] == 2
    spans.reset()
    got = spans.counters()
    assert "engine.captures" not in got and "kernels.builds" not in got
    assert got["kernels.launches.mutan"] == 0
    assert spans.records() == []


def test_eager_graphed_step_opens_its_parts_once_per_call():
    def body(t):
        return {"loss": (t["x"].float() * 2).sum()}

    step = graphs.GraphedStep(body, "cpu")
    x = np.arange(6, dtype=np.float32).reshape(2, 3)

    def calls():
        return [step({"x": x}, seed=1, step=s)["loss"] for s in range(3)]

    out, _ = _profiled(calls)
    assert [float(v) for v in out] == [30.0] * 3
    recs = spans.records()
    assert _names(recs) == ["engine.step", "engine.stage", "engine.reseed",
                            "engine.eager"] * 3
    for i in range(3):
        top = recs[4 * i]
        assert top[1] == -1 and top[2] == i
        assert [r[1] for r in recs[4 * i + 1:4 * i + 4]] == [4 * i] * 3
    assert spans.counters().get("engine.captures", 0) == 0


def test_cx_train_epoch_opens_data_batch_per_batch():
    n, k, batch_size = 23, 4, 5
    rng = np.random.default_rng(0)
    arrays = vqacx.CXArrays(
        rng.integers(0, 30, (n, k + 1)).astype(np.int32),
        rng.integers(0, 9, (n, 6)).astype(np.int32),
        rng.integers(0, 8, n).astype(np.int32),
        rng.integers(0, k, n).astype(np.int32))
    seen = []

    def train_step(state, features, batch, n_valid, **tables):
        assert spans.TRACER._stack() == []   # closed before the step
        seen.append((batch["example_idxs"].copy(), n_valid))
        return state, {}

    state = cx_engine.CXTrainState(None, None)
    _profiled(lambda: cx_engine.train_epoch(
        train_step, state, None, arrays, batch_size,
        rng=np.random.default_rng(1)))
    assert _names() == ["data.batch"] * 5
    assert [nv for _, nv in seen] == [5, 5, 5, 5, 3]
    order = np.arange(n)
    np.random.default_rng(1).shuffle(order)
    np.testing.assert_array_equal(
        np.concatenate([idx[:nv] for idx, nv in seen]), order)


@pytest.mark.parametrize("path", ["device_features", "host"])
def test_vqa_batches_open_data_batch_per_batch(path):
    examples, store, _, _ = synthetic.make_synthetic_vqa(
        40, 8, maxlength=10, dim_v=4, seed=0)
    for ex in examples:
        ex["answers_aid"] = [ex["answer_aid"], (ex["answer_aid"] + 1) % 8]
        ex["answers_count"] = [6, 4]
    arrays = VQAArrays(examples, store, samplingans=True)
    feats = torch.from_numpy(store.features) \
        if path == "device_features" else None

    def take():
        out = []
        for batch in arrays.batches(8, rng=np.random.default_rng(2),
                                    device_features=feats):
            assert spans.TRACER._stack() == []   # closed before the yield
            out.append(batch)
        return out

    batches, _ = _profiled(take)
    assert len(batches) == 5
    assert _names() == ["data.batch"] * 5


def test_validate_opens_pass_end_once_and_eval_step_per_batch():
    class Tiny(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = torch.nn.Linear(4, 8)

        def forward(self, visual, question):
            return self.lin(torch.as_tensor(visual).float())

    torch.manual_seed(0)
    eval_step = vqa_engine.make_vqa_eval_step(Tiny())
    rng = np.random.default_rng(0)
    loader = [{"visual": rng.normal(size=(6, 4)).astype(np.float32),
               "question": np.zeros((6, 3), np.int32),
               "answer": rng.integers(0, 8, 6).astype(np.int32),
               "question_id": np.arange(6) + 6 * i} for i in range(3)]
    answers = ["a%d" % i for i in range(8)]

    def passes():
        return [vqa_engine.validate(eval_step, loader, _experiment(), 0,
                                    aid_to_ans=answers,
                                    collect_results=True)
                for _ in range(2)]

    out, _ = _profiled(passes)
    assert [len(rows) for _, rows in out] == [18, 18]
    assert _names() == (["engine.step"] * 3 + ["engine.pass_end"]) * 2


def test_vqa_train_epoch_opens_meters_read_per_read():
    loader = [{"answer": np.zeros(4, np.int32)} for _ in range(5)]

    def train_step(state, batch):
        one = torch.tensor(1.0)
        return state, {"loss": one, "acc1": one, "acc5": one}

    _profiled(lambda: vqa_engine.train_epoch(train_step, None, loader,
                                             _experiment(), 0, print_freq=2))
    # reads at batches 0, 2 and 4; the epoch's end finds nothing pending
    assert _names() == ["engine.meters_read"] * 3


def test_frozen_caches_count_their_stages():
    opt = synthetic.tiny_vqa_options(dim_v=16, nans=8)
    dataset, store = synthetic.make_synthetic_cx(
        n_examples=12, n_images=10, dim_v=16, knn_size=4, n_words=20,
        n_answers=8, seed=1)
    vqa = factory.factory_vqa(opt, dataset["vocab_words"],
                              dataset["vocab_answers"])
    spec = dict(dim_h=16, n_layers=1, drop_p=0.1, v_emb=True, v_mult=True,
                v_dist=True, v_rank=True, q_emb=True, a_emb=True,
                z_emb=True, pretrained_emb=False, trainable_vqa=False)
    model = cx_engine.init_cx_params(
        factory.factory_cx("NeuralModel", vqa, knn_size=4, model_spec=spec))
    arrays = vqacx.CXArrays.from_examples(dataset["examples_list"],
                                          dataset["name_to_index"])
    for _ in range(2):
        q, v, z, stage_s = cx_engine.build_frozen_caches(
            model, torch.from_numpy(store.features), arrays)
    assert v is None and q.shape[0] == z.shape[0] == 12
    got = spans.counters()
    for stage in ("q", "v", "z"):
        total = got["cx.cache_build_s." + stage]
        assert 0 < stage_s[stage] < total
    assert spans.records() == []


LAUNCHES = ("gru", "gru_pg", "gru_bwd", "vfeat", "vfeat_bwd", "mixture",
            "mutan", "attmutan", "attmutan_bwd", "knn", "xproj", "xproj_dx",
            "xproj_dw")


def test_counters_after_a_cx_epoch_a_vqa_epoch_and_a_served_call():
    """What ``spans.counters()`` reports after a CX train epoch, a VQA
    train epoch and a served call on the CPU: every kernel wrapper's
    launch counter at 0 (the CPU runs the plain versions) and nothing else
    (nothing is captured, built or cached)."""
    from vqa_counterexamples_tpu_torch.models import convnets
    from vqa_counterexamples_tpu_torch.serve.demo_server import DemoEngine

    want = {"kernels.launches." + k: 0 for k in LAUNCHES}
    opt = synthetic.tiny_vqa_options(dim_v=16, nans=8)
    dataset, store = synthetic.make_synthetic_cx(
        n_examples=12, n_images=10, dim_v=16, knn_size=4, n_words=20,
        n_answers=8, seed=1)
    vqa = factory.factory_vqa(opt, dataset["vocab_words"],
                              dataset["vocab_answers"])
    spec = dict(dim_h=16, n_layers=1, drop_p=0.1, v_emb=True, v_mult=True,
                v_dist=True, v_rank=True, q_emb=True, a_emb=True,
                z_emb=True, pretrained_emb=False, trainable_vqa=False)
    model = cx_engine.init_cx_params(
        factory.factory_cx("NeuralModel", vqa, knn_size=4, model_spec=spec))
    arrays = vqacx.CXArrays.from_examples(dataset["examples_list"],
                                          dataset["name_to_index"])
    state = cx_engine.init_cx_state(model, lr=1e-3)
    state, _ = cx_engine.train_epoch(
        cx_engine.make_cx_train_step(model, state.optimizer), state,
        torch.from_numpy(store.features), arrays, 5,
        rng=np.random.default_rng(0))
    assert state.step == 3 and spans.counters() == want

    examples, vstore, words, answers = synthetic.make_synthetic_vqa(
        24, 8, maxlength=10, dim_v=16, seed=0)
    vmodel = factory.factory_vqa(opt, words, answers)
    vqa_engine.init_vqa_params(vmodel, seed=0)
    vstate = vqa_engine.init_vqa_state(vmodel, lr=1e-3)
    loader = list(VQAArrays(examples, vstore).batches(
        8, rng=np.random.default_rng(1)))
    vqa_engine.train_epoch(
        vqa_engine.make_vqa_train_step(vmodel, vstate.optimizer), vstate,
        loader, _experiment(), 0, print_freq=2)
    assert vstate.step == 3 and spans.counters() == want

    sopt = synthetic.tiny_vqa_options(dim_v=2048, nans=8)
    smodel = factory.factory_vqa(sopt, words, answers)
    vqa_engine.init_vqa_params(smodel, seed=0)
    cnn = convnets.init_resnet(convnets.ResNet(depths=(1, 1, 1, 1),
                                               dtype=torch.float32))
    server = DemoEngine({"vqa": {"maxlength": 8}, "coco": {"size": 32}},
                        smodel, cnn, words, answers, attention=False)
    vals, idxs, _ = server.predict_prepared(
        np.zeros((2, 32, 32, 3), np.uint8), np.ones((2, 8), np.int32))
    assert vals.shape == idxs.shape == (2, 5)
    assert server.n_graphs == 0 and spans.counters() == want


# ---- the readers, on synthetic traces and records ----

def _reader(name):
    return Registry().module("metrics", name)


def _view(trace, kind="train"):
    return types.SimpleNamespace(trace=trace, extra={},
                                 window={"kind": kind, "steps": trace.steps})


T0_NS = 987_654_321_000_000      # the program's clock at its first step
OFFSET_US = 125.0 - T0_NS / 1e3  # the profiler's clock less the program's
LAG_US = 3.0                     # a label's start to its span's


def _planted(n_steps=4, jitter=(0.0, 0.4, -0.3, 0.2), drop_label=False):
    """A window of ``n_steps`` steps 1 ms apart: each an ``engine.step``
    of 400 us (a replay of 100 us from 200 us), a ``data.batch`` of 300
    us before it, and kernels busy from 50 to 150 and 250 to 380 us into
    the step (on the profiler's clock, the span's start plus the planted
    offset)."""
    recs, kernels, labels = [], [], []
    for k in range(n_steps):
        s_ns = T0_NS + k * 1_000_000
        recs.append(("data.batch", -1, None, s_ns - 350_000, s_ns - 50_000))
        recs.append(("engine.step", -1, k, s_ns, s_ns + 400_000))
        recs.append(("engine.replay", len(recs) - 1, k, s_ns + 200_000,
                     s_ns + 300_000))
        at = s_ns / 1e3 + OFFSET_US
        labels.append((at - LAG_US + jitter[k % len(jitter)], at + 405))
        kernels += [("k", at + 50, at + 150), ("k", at + 250, at + 380)]
    if drop_label:
        labels.pop()
    lo = recs[0][3] / 1e3 + OFFSET_US
    hi = max(r[4] for r in recs) / 1e3 + OFFSET_US + 100
    trace = Trace(window_s=(hi - lo) / 1e6, steps=n_steps, kernels=kernels,
                  labels={"step": labels, "data": [], "epoch": []},
                  span=(lo, hi))
    return recs, trace


def test_step_idle_alignment_recovers_the_planted_offset(monkeypatch,
                                                         capsys):
    recs, trace = _planted()
    monkeypatch.setattr(spans, "records", lambda: recs)
    mod = _reader("step_idle_ms.train")
    offset, spread = mod.clock_offset(
        [s for s, _ in trace.labels["step"]],
        [r[3] for r in recs if r[0] == "engine.step"])
    assert offset == pytest.approx(OFFSET_US - LAG_US, abs=0.5)
    assert spread < 1.0
    # a gap counts where its midpoint lies: inside each step only the
    # 100 us from 150 to 250 (in the replay); the gaps from a step's last
    # kernel to the next step's first lie mostly in the loader's span
    assert mod.read(_view(trace)) == pytest.approx(0.100)
    err = capsys.readouterr().err
    assert "4 pairs" in err
    split = err.split("innermost program span")[1]
    assert "engine.replay" in split and "data.batch" in split


@pytest.mark.parametrize("case", ["counts", "spread"])
def test_step_idle_refuses_a_pairing_it_cannot_trust(monkeypatch, case):
    if case == "counts":
        recs, trace = _planted(drop_label=True)
    else:
        recs, trace = _planted(n_steps=8,
                               jitter=(0.0, 90.0, -60.0, 40.0, 0.0, -80.0))
    monkeypatch.setattr(spans, "records", lambda: recs)
    assert _reader("step_idle_ms.train").read(_view(trace)) is None
    assert _reader("step_idle_ms.eval").read(_view(trace, "eval")) is None


def test_loader_and_host_readers_read_the_planted_spans(monkeypatch,
                                                        capsys):
    recs, trace = _planted()
    monkeypatch.setattr(spans, "records", lambda: recs)
    for kind in ("train", "eval"):
        view = _view(trace, kind)
        assert _reader("loader_ms_per_step." + kind).read(view) == \
            pytest.approx(0.3)
        assert _reader("host_ms_per_step." + kind).read(view) == \
            pytest.approx(0.4)
        assert _reader("step_idle_ms." + kind).read(view) is not None
        # a reader of the other kind reads nothing here
        other = "eval" if kind == "train" else "train"
        assert _reader("host_ms_per_step." + other).read(view) is None
    assert "engine.replay 0.1000 / 0.1000" in capsys.readouterr().err


def test_counter_readers(monkeypatch, capsys):
    recs, trace = _planted()
    recs = recs + [("engine.capture", 1, 0, T0_NS + 10, T0_NS + 20)]
    monkeypatch.setattr(spans, "records", lambda: recs)
    spans.count("engine.captures", 3)
    spans.count("engine.capture_s", 2.5)
    spans.count("cx.cache_build_s.q", 1.25)
    spans.count("cx.cache_build_s.z", 0.5)
    view = _view(trace)
    assert _reader("capture_s.train").read(view) == 2.5
    assert "3 captures, 2 in set-up, 1 in the window" in \
        capsys.readouterr().err
    assert _reader("cache_build_s").read(view) == pytest.approx(1.75)
    spans.reset()
    assert _reader("capture_s.train").read(view) is None
    assert _reader("cache_build_s").read(view) is None


@pytest.mark.parametrize("name", READERS)
def test_readers_read_nothing_without_the_spans_module(monkeypatch, name):
    """A checkout whose port has no ``core/spans`` (the parent's): every
    reader returns None and raises nothing."""
    import vqa_counterexamples_tpu_torch.core as core

    recs, trace = _planted()
    monkeypatch.delattr(core, "spans")
    monkeypatch.setitem(sys.modules,
                        "vqa_counterexamples_tpu_torch.core.spans", None)
    kind = "eval" if name.endswith(".eval") else "train"
    assert _reader(name).read(_view(trace, kind)) is None


@pytest.mark.cuda
def test_captured_replay_span_encloses_its_graph_launch():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a captured graph runs on a card)")

    def body(t):
        return {"loss": (t["x"] * 2).sum()}

    step = graphs.GraphedStep(body, "cuda")
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    step({"x": x})                       # captures
    assert spans.counters()["engine.captures"] == 1
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = step({"x": x}, step=1)
        torch.cuda.synchronize()
    assert float(out["loss"]) == 132.0
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CPU]
    replay = [e for e in events if e.name == "engine.replay"]
    launch = [e for e in events if e.name.startswith("cudaGraphLaunch")]
    assert len(replay) == 1 and len(launch) == 1
    r, g = replay[0].time_range, launch[0].time_range
    assert r.start <= g.start and g.end <= r.end
    assert _names() == ["engine.step", "engine.stage", "engine.check",
                        "engine.reseed", "engine.replay", "engine.outputs"]
