"""Job ``cx_train``: NeuralCX training as the CX CLI runs it, through
``engines.cx_engine``.

Set-up: the split from the seed (features on the card), the model built
by the port's factory with the seeded weights, the q / v / z caches built
by ``build_frozen_caches`` and made bf16-resident, Adam, the captured
train step, then the first steps of an epoch of ``train_epoch``: the
ones the check follows (``Watched``, which stops the epoch after them).
They capture the one shape the window uses: the epoch's short last batch
is padded to the batch size.  Window: whole epochs of ``train_epoch``
until ``--seconds`` have passed, each over a new shuffle; the window ends
at that epoch's end.  Check: the reference's first steps against the
program's.
"""

from __future__ import annotations

import sys

import numpy as np

from perfbench.harness import program, weights as weights_lib
from perfbench.traffic import generate

KIND = "train"


def build_model(cfg: dict, weights: dict, device):
    """NeuralCX as the CX CLI builds it (``factory.cx_from_options``),
    with the seeded weights."""
    from vqa_counterexamples_tpu_torch.models import factory

    words, answers = generate.vocab(cfg)
    cx = {k: v for k, v in cfg["cx_model"].items()
          if k != "answer_embedding_std"}
    model = factory.cx_from_options(
        "NeuralModel", {"model": cfg["model"], "cx_model": cx}, words,
        answers, knn_size=cfg["knn_size"])
    model.to(device)
    model.load_state_dict(weights, strict=True)
    return model.eval()


def order_rng(seed: int) -> np.random.Generator:
    return generate.seeds(seed, "cx/order")


def setup(ctx):
    from vqa_counterexamples_tpu_torch.data import vqacx
    from vqa_counterexamples_tpu_torch.engines import cx_engine

    cfg, traffic, dev = ctx.config, ctx.traffic, ctx.device
    ref = ctx.registry.reference(cfg["name"])
    ctx.mark("imports")
    data = generate.cx_data(cfg, traffic["split"], ctx.seed, dev)
    ctx.mark("data")
    weights = weights_lib.make(ref.param_specs(cfg), ctx.seed, dev)
    model = build_model(cfg, weights, dev)
    ctx.mark("model")
    arrays = vqacx.CXArrays(data["image_idxs"], data["question_wids"],
                            data["answer_aids"], data["comp_idxs"])
    caches = cfg["caches"]
    q, v, z, stage_s = cx_engine.build_frozen_caches(
        model, data["features"], arrays, use_q=caches["q"],
        use_v=caches["v"], use_z=caches["z"])
    ctx.mark("caches")
    feats = data["features"]
    if caches["bf16_resident"]:
        feats, q, v, z = cx_engine.make_tables_bf16_resident(feats, q, v, z)
    state = cx_engine.init_cx_state(model, lr=cfg["optim"]["lr"])
    step = cx_engine.make_cx_train_step(model, state.optimizer,
                                        base_seed=ctx.base_seed,
                                        use_z_cache=caches["z"],
                                        capture=traffic.get("capture"))
    named = cx_engine.trainable_parameters(model)
    watched = program.Watched(step, state.optimizer, named,
                              {n: weights[n] for n, _ in named},
                              n_checked=traffic["check_steps"])
    js = dict(cfg=cfg, traffic=traffic, ctx=ctx, data=data, weights=weights,
              model=model, arrays=arrays, feats=feats, q=q, v=v, z=z,
              state=state, step=step, watched=watched,
              rng=order_rng(ctx.seed), stage_s=stage_s)
    watched.stop_after = traffic["check_steps"]
    try:
        run_epoch(js)   # the checked steps; they capture the window's shape
    except program.WindowOver:
        pass
    watched.stop_after = None
    ctx.mark("first steps")
    js["readings"] = watched.readings()
    return js


def _log(b, metrics):
    print("cx step %d: loss %.4f recall %.4f examples/s %.1f"
          % (b, metrics["loss"], metrics["recall"],
             metrics["examples_per_sec"]), file=sys.stderr)


def run_epoch(js) -> int:
    from vqa_counterexamples_tpu_torch.engines import cx_engine

    traffic = js["traffic"]
    cx_engine.train_epoch(js["watched"], js["state"], js["feats"],
                          js["arrays"], traffic["batch_size"], rng=js["rng"],
                          log_fn=_log, print_freq=traffic["print_freq"],
                          q_table=js["q"], v_table=js["v"], z_table=js["z"])
    return js["arrays"].size


def window(js, clock, seconds: float) -> dict:
    """Whole epochs until ``seconds`` have passed; a traced window stops at
    ``seconds``, mid-epoch (its trace would grow with a whole epoch)."""
    watched = js["watched"]
    watched.clock = clock
    if clock.traced:
        watched.deadline = seconds
    batch = js["traffic"]["batch_size"]
    examples = 0
    clock.start()
    while True:
        before = len(watched.window_losses)
        try:
            with clock.label("epoch"):
                examples += run_epoch(js)
        except program.WindowOver:
            examples += (len(watched.window_losses) - before) * batch
            break
        if clock.elapsed() >= seconds:
            break
    window_s = clock.stop()
    n_img = js["cfg"]["data"][js["traffic"]["split"]]["n_images"]
    return {"kind": KIND, "examples": examples,
            "steps": len(watched.window_losses), "window_s": window_s,
            "failed": js["watched"].failed_steps(),
            "shapes": {"batch": batch, "n_images": n_img}}


def release(js) -> None:
    for key in ("model", "arrays", "feats", "q", "v", "z", "state", "step",
                "watched"):
        js.pop(key, None)


def reference_readings(js, precision: str) -> dict:
    from perfbench.reference import common

    ctx, cfg = js["ctx"], js["cfg"]
    ref = ctx.registry.reference(cfg["name"])
    order = np.arange(cfg["data"][js["traffic"]["split"]]["n_examples"])
    order_rng(ctx.seed).shuffle(order)
    return ref.train_steps(cfg, js["weights"], js["data"], order,
                           js["traffic"]["batch_size"],
                           js["traffic"]["check_steps"], ctx.base_seed,
                           common.Precision(precision), ctx.device)


def check(js, precision: str = "f32") -> dict:
    """The program's readings against the reference's (``precision``
    "fp8": the control's against the reference's)."""
    from perfbench.harness import compare

    ref = reference_readings(js, "f32")
    got = (js["readings"] if precision == "f32"
           else reference_readings(js, precision))
    head = js["ctx"].registry.reference(js["cfg"]["name"]).HEAD
    return compare.train_numbers(got, ref, head)
