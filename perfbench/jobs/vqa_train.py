"""Job ``vqa_train``: MutanNoAtt pretraining as the train CLI runs it,
through ``engines.vqa_engine``.

Set-up: the split from the seed, its features in a host ``FeatureStore``
and its examples in ``VQAArrays`` with answer sampling on, the feature
matrix moved to the card whole (the CLI's loader for the no-attention
models), the model built by the port's factory with the seeded weights,
Adam and the captured train step; then ``train_epoch`` over the first
batches of the first epoch: the steps the check follows (``Watched``),
which also warm the one batch shape the window uses.  Window: the same
epoch's next batches through ``train_epoch``, epoch after epoch, until
``--seconds`` have passed (the feed stops at a batch boundary).  The
loader's batches are recorded for the check's first steps: their sampled
answers.  Check: the reference's first steps and draws against the
program's.
"""

from __future__ import annotations

import sys

import numpy as np

from perfbench.harness import program, weights as weights_lib
from perfbench.traffic import generate

KIND = "train"


def image_names(n: int, split: str) -> list:
    return ["COCO_%s2014_%012d.jpg" % (split, i) for i in range(n)]


def build_arrays(cfg: dict, data: dict, split: str, samplingans: bool):
    """``VQAArrays`` over the split's examples, as the CLI's loader builds
    them from the processed examples; the host ``FeatureStore``."""
    from vqa_counterexamples_tpu_torch.data.features import FeatureStore
    from vqa_counterexamples_tpu_torch.data.vqa_dataset import VQAArrays

    names = image_names(data["features"].shape[0], split)
    store = FeatureStore(data["features"].numpy(), names)
    rows, wids = data["image_rows"], data["question_wids"]
    aids, counts, ks = data["ans_aids"], data["ans_counts"], data["ans_k"]
    examples = [{"question_id": i, "image_name": names[rows[i]],
                 "question_wids": wids[i], "answer_aid": int(aids[i, 0]),
                 "answers_aid": aids[i, :ks[i]].tolist(),
                 "answers_count": counts[i, :ks[i]].tolist()}
                for i in range(len(rows))]
    return VQAArrays(examples, store, samplingans=samplingans), store


def build_model(cfg: dict, weights: dict, device):
    from vqa_counterexamples_tpu_torch.models import factory

    words, answers = generate.vocab(cfg)
    model = factory.factory_vqa(cfg["model"], words, answers)
    model.to(device)
    model.load_state_dict(weights, strict=True)
    return model


def experiment(name: str):
    from vqa_counterexamples_tpu_torch.core.experiment import Experiment
    from vqa_counterexamples_tpu_torch.core.meters import AvgMeter

    exp = Experiment(name)
    for tag in ("train", "val"):
        exp.add_meters(tag, {k: AvgMeter() for k in (
            "loss", "acc1", "acc5", "batch_time", "data_time")})
    return exp


def order_rng(seed: int) -> np.random.Generator:
    return generate.seeds(seed, "vqa/order")


def setup(ctx):
    from vqa_counterexamples_tpu_torch.engines import vqa_engine

    cfg, traffic, dev = ctx.config, ctx.traffic, ctx.device
    split = traffic["split"]
    ref = ctx.registry.reference(cfg["name"])
    ctx.mark("imports")
    data = generate.vqa_data(cfg, split, ctx.seed, dev)
    ctx.mark("data")
    arrays, store = build_arrays(cfg, data, split, cfg["samplingans"])
    ctx.mark("arrays")
    weights = weights_lib.make(ref.param_specs(cfg), ctx.seed, dev)
    model = build_model(cfg, weights, dev)
    device_features = store.to_device(dev)
    ctx.mark("model")
    state = vqa_engine.init_vqa_state(model, lr=cfg["optim"]["lr"])
    step = vqa_engine.make_vqa_train_step(model, state.optimizer,
                                          base_seed=ctx.base_seed,
                                          capture=traffic.get("capture"))
    watched = program.Watched(step, state.optimizer,
                              list(model.named_parameters()), weights,
                              n_checked=traffic["check_steps"])
    rng = order_rng(ctx.seed)
    batch = traffic["batch_size"]
    js = dict(cfg=cfg, traffic=traffic, ctx=ctx, data=data, weights=weights,
              model=model, arrays=arrays, store=store,
              device_features=device_features, state=state, step=step,
              watched=watched, exp=experiment(ctx.cell["name"]),
              first_answers=[], steps=0, epoch=0)

    def on_batch(b):
        if len(js["first_answers"]) < traffic["check_steps"]:
            js["first_answers"].append(np.asarray(b["answer"]).copy())
        js["steps"] += 1

    js["feed"] = program.Feed(lambda: arrays.batches(
        batch, shuffle=True, rng=rng, drop_remainder=True,
        device_features=device_features, device=dev), on_batch)
    run_epoch(js, js["feed"].take(traffic["check_steps"]))
    ctx.mark("first steps")
    js["readings"] = watched.readings()
    js["steps"] = 0
    return js


def run_epoch(js, loader) -> None:
    from vqa_counterexamples_tpu_torch.engines import vqa_engine

    out, sys.stdout = sys.stdout, sys.stderr   # the engine's meter lines
    try:
        vqa_engine.train_epoch(js["watched"], js["state"], loader, js["exp"],
                               js["epoch"],
                               print_freq=js["traffic"]["print_freq"])
    finally:
        sys.stdout = out


def window(js, clock, seconds: float) -> dict:
    js["watched"].clock = clock
    feed = js["feed"]
    batch = js["traffic"]["batch_size"]
    meter = js["exp"].get_meter("train", "data_time")
    engine_data_s = 0.0
    clock.start()
    while clock.elapsed() < seconds:
        with clock.label("epoch"):
            run_epoch(js, feed.take(clock=clock, seconds=seconds))
        engine_data_s += meter.sum / batch   # each batch's seconds x B
        js["epoch"] += 1
    window_s = clock.stop()
    steps = js["steps"]
    return {"kind": KIND, "examples": steps * batch, "steps": steps,
            "window_s": window_s, "failed": js["watched"].failed_steps(),
            "shapes": {"batch": batch, "seq_len": js["cfg"]["maxlength"]},
            "extra": {"data_s": feed.data_s, "data_n": feed.data_n,
                      "engine_data_s": engine_data_s}}


def release(js) -> None:
    for key in ("model", "arrays", "store", "device_features", "state",
                "step", "watched", "feed", "exp"):
        js.pop(key, None)


def reference_readings(js, precision: str) -> tuple:
    """(the reference's first steps, its draws of the first batches'
    answers)."""
    from perfbench.reference import common

    ctx, cfg, traffic = js["ctx"], js["cfg"], js["traffic"]
    ref = ctx.registry.reference(cfg["name"])
    rng = order_rng(ctx.seed)
    order = np.arange(cfg["data"][traffic["split"]]["n_examples"])
    rng.shuffle(order)
    answers = ref.sample_answers(js["data"], order, traffic["batch_size"],
                                 traffic["check_steps"], rng)
    steps = ref.train_steps(cfg, js["weights"], js["data"], order, answers,
                            ctx.base_seed, common.Precision(precision),
                            ctx.device)
    return steps, answers


def check(js, precision: str = "f32") -> dict:
    from perfbench.harness import compare

    ref, answers = reference_readings(js, "f32")
    if precision == "f32":
        got = js["readings"]
        drawn = js["first_answers"]
        mismatch = sum(int((np.asarray(a) != b).sum())
                       for a, b in zip(drawn, answers))
        mismatch += abs(len(drawn) - len(answers)) * js["traffic"][
            "batch_size"]
    else:
        got, _ = reference_readings(js, precision)
        mismatch = 0
    head = js["ctx"].registry.reference(js["cfg"]["name"]).HEAD
    return {**compare.train_numbers(got, ref, head),
            "answers": float(mismatch)}
