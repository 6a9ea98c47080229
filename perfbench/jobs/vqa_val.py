"""Job ``vqa_val``: MutanNoAtt validation as the train CLI runs it every
epoch: ``engines.vqa_engine.validate`` with ``make_vqa_eval_step`` (eager),
collecting each question's predicted answer.

Set-up: the split from the seed, ``VQAArrays`` (no answer sampling), the
feature matrix on the card, the model with the seeded weights, and one
``validate`` over the first batches (it builds the kernels the pass uses).
Window: ``validate`` over the split's batches in order, pass after pass,
until ``--seconds`` have passed (the feed stops at a batch boundary).
Check: a sample of the answers the window produced, drawn from the seed
and holding the longest questions, against the reference's logits.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from perfbench.harness import program, weights as weights_lib
from perfbench.jobs import vqa_train
from perfbench.traffic import generate

KIND = "eval"


def setup(ctx):
    from vqa_counterexamples_tpu_torch.engines import vqa_engine

    cfg, traffic, dev = ctx.config, ctx.traffic, ctx.device
    split = traffic["split"]
    ref = ctx.registry.reference(cfg["name"])
    ctx.mark("imports")
    data = generate.vqa_data(cfg, split, ctx.seed, dev)
    ctx.mark("data")
    arrays, store = vqa_train.build_arrays(cfg, data, split, False)
    ctx.mark("arrays")
    weights = weights_lib.make(ref.param_specs(cfg), ctx.seed, dev)
    model = vqa_train.build_model(cfg, weights, dev)
    device_features = store.to_device(dev)
    ctx.mark("model")
    batch = traffic["batch_size"]
    js = dict(cfg=cfg, traffic=traffic, ctx=ctx, data=data, weights=weights,
              model=model, arrays=arrays, store=store,
              device_features=device_features,
              eval_step=vqa_engine.make_vqa_eval_step(model),
              exp=vqa_train.experiment(ctx.cell["name"]), steps=0,
              results=[], answers=generate.vocab(cfg)[1])

    def on_batch(_):
        js["steps"] += 1

    js["feed"] = program.Feed(lambda: arrays.batches(
        batch, shuffle=False, drop_remainder=True,
        device_features=device_features, device=dev), on_batch)
    run_pass(js, js["eval_step"], js["feed"].take(traffic["warm_batches"]))
    ctx.mark("first batches")
    js["feed"].current = None       # the window starts a pass afresh
    js["results"].clear()
    js["steps"] = 0
    return js


def run_pass(js, step, loader) -> None:
    from vqa_counterexamples_tpu_torch.engines import vqa_engine

    _, rows = vqa_engine.validate(step, loader, js["exp"], 0,
                                  aid_to_ans=js["answers"],
                                  collect_results=True)
    js["results"].append(rows)


def window(js, clock, seconds: float) -> dict:
    timed = program.Timed(js["eval_step"], clock)
    feed = js["feed"]
    clock.start()
    while clock.elapsed() < seconds:
        with clock.label("epoch"):
            run_pass(js, timed, feed.take(clock=clock, seconds=seconds))
    window_s = clock.stop()
    batch = js["traffic"]["batch_size"]
    steps = js["steps"]
    return {"kind": KIND, "examples": steps * batch, "steps": steps,
            "window_s": window_s, "failed": timed.failed_steps(),
            "shapes": {"batch": batch, "seq_len": js["cfg"]["maxlength"]},
            "extra": {"data_s": feed.data_s, "data_n": feed.data_n}}


def release(js) -> None:
    for key in ("model", "arrays", "store", "device_features", "eval_step",
                "feed", "exp"):
        js.pop(key, None)


def produced(js) -> tuple:
    """(question ids, answer ids) the window produced, first of each."""
    aid = {a: i for i, a in enumerate(js["answers"])}
    qids, preds = [], []
    for rows in js["results"]:
        qids.extend(r["question_id"] for r in rows)
        preds.extend(aid[r["answer"]] for r in rows)
    qids, first = np.unique(np.asarray(qids, np.int64), return_index=True)
    return qids, np.asarray(preds, np.int64)[first]


def sample(js, qids: np.ndarray) -> np.ndarray:
    """Positions into ``qids``: the longest questions and a draw from the
    seed, ``sample_rows`` in all."""
    traffic = js["traffic"]
    n = min(traffic["sample_rows"], len(qids))
    lengths = (js["data"]["question_wids"][qids] != 0).sum(1)
    longest = np.argsort(-lengths, kind="stable")[:traffic["longest_rows"]]
    rest = np.setdiff1d(np.arange(len(qids)), longest)
    rng = generate.seeds(js["ctx"].seed, "vqa/val/sample")
    drawn = rng.choice(rest, size=max(0, n - len(longest)), replace=False)
    return np.sort(np.concatenate([longest, drawn]))


def reference_logits(js, qids: np.ndarray, precision: str) -> torch.Tensor:
    from perfbench.reference import common

    ctx, cfg, data = js["ctx"], js["cfg"], js["data"]
    ref = ctx.registry.reference(cfg["name"])
    rows = torch.from_numpy(data["image_rows"][qids].astype(np.int64))
    visual = data["features"][rows].to(ctx.device)
    wids = torch.from_numpy(data["question_wids"][qids]).to(ctx.device)
    return ref.eval_logits(cfg, js["weights"], visual, wids,
                           common.Precision(precision))


def check(js, precision: str = "f32") -> dict:
    from perfbench.harness import compare

    qids, preds = produced(js)
    if not len(qids):
        return {"logit_gap": float("inf"), "_rows": 0}
    pick = sample(js, qids)
    qids, preds = qids[pick], preds[pick]
    ref = reference_logits(js, qids, "f32")
    if precision != "f32":
        preds = reference_logits(js, qids, precision).argmax(1).cpu().numpy()
    gaps = compare.logit_gaps(ref, torch.from_numpy(preds).to(ref.device))
    print("vqa_val check: %d rows, %d of them produced off the reference's "
          "best" % (len(qids), int((gaps > 0).sum())), file=sys.stderr)
    return {"logit_gap": float(gaps.max()), "_rows": int(len(qids))}
