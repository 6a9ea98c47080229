"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It imports only the port
(``vqa_counterexamples_tpu_torch``), never JAX, and runs under the bf16
policy, where the port's three CUDA kernels are on the path.  Any failure
ends the run with a nonzero exit and no result line.

1. Kernels vs plain: builds every kernel from ``csrc/`` (nvcc, sm_90a),
   runs it at the shapes the slice gives it and holds it against its plain
   PyTorch version on the same inputs, with the stated tolerances; times
   both with CUDA events after a warm-up.
2. The slice at the flagship width (bench.py's configuration: dim_v 2048,
   K 24, BayesianUniSkip 620 -> 2400, MUTAN R 10 at 360, 2000 answers,
   NeuralCX 300 x 2, B 768; synthetic 2048 examples over 1024 images, random
   weights from a seed): builds the q/v/z caches, makes the tables
   bf16-resident and scores every example.  The kernels' launch counters
   are zeroed just before and must all have moved; one batch's scores are
   held against the same computation through the plain versions.
3. The CLI: ``cli.counterexamples.main([... --synthetic 2048 --z_cache
   --epochs 0 --test])`` in a temporary directory.

It prints the card's name and power limit, a ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

os.environ["VQACX_COMPUTE_DTYPE"] = "bfloat16"

import numpy as np  # noqa: E402
import torch  # noqa: E402

SEED = 0
TOL = {
    # GRU states: bf16 state carry, as tests/test_pallas_gru.py bounds it
    "gru": dict(atol=5e-2, rtol=5e-2),
    # vfeat: bf16 GEMM outputs (tests/test_vfeat_kernel.py); dist is f32
    "vfeat_h": dict(atol=3e-2, rtol=3e-2),
    "vfeat_dist": dict(atol=1e-4, rtol=1e-4),
    # mixture probs (tests/test_fused_head.py)
    "mixture": dict(atol=2e-3, rtol=2e-2),
    # NeuralCX scores, kernel path vs plain path (tests/test_fused_head.py)
    "scores": dict(atol=5e-2, rtol=5e-2),
}
REPLACES = {
    "gru": "vqa_counterexamples_tpu/ops/pallas/gru_kernel.py:183",
    "vfeat": "vqa_counterexamples_tpu/ops/pallas/vfeat_kernel.py:203",
    "mixture": "vqa_counterexamples_tpu/ops/pallas/mixture_kernel.py:58",
}


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def check_close(name, got, ref, tol):
    """Max abs / rel error of ``got`` vs ``ref``; raise past ``tol``."""
    got, ref = got.float(), ref.float()
    if got.shape != ref.shape or not torch.isfinite(got).all():
        raise AssertionError("%s: shape %s vs %s or non-finite values"
                             % (name, tuple(got.shape), tuple(ref.shape)))
    diff = (got - ref).abs()
    max_abs = diff.max().item()
    max_rel = (diff / ref.abs().clamp_min(1e-6)).max().item()
    bad = (diff > tol["atol"] + tol["rtol"] * ref.abs()).sum().item()
    log("  %-10s max_abs %.3e max_rel %.3e (atol %g, rtol %g): %s"
        % (name, max_abs, max_rel, tol["atol"], tol["rtol"],
           "ok" if bad == 0 else "%d elements out" % bad))
    if bad:
        raise AssertionError("%s disagrees with its plain version" % name)
    return max_abs


def time_ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernels(dev, card):
    from vqa_counterexamples_tpu_torch.ops.cuda import (
        build, gru_kernel, mixture_kernel, vfeat_kernel)

    log("== phase 1: kernels vs plain at the slice's shapes")
    for name in ("gru", "vfeat", "mixture"):
        t0 = time.perf_counter()
        path = build.build(name)
        log("  built %s in %.1f s: %s" % (name, time.perf_counter() - t0,
                                         path.name))
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log("    " + line.strip())
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).to(dtype)

    rows = {}
    # A: GRU recurrence, q-cache build chunk
    T, B, H = 26, 2048, 2400
    xp, w_hh = randn(T, B, 3 * H), randn(3 * H, H, scale=H ** -0.5)
    b_hh = randn(3 * H, scale=0.1, dtype=torch.float32)
    got, _ = gru_kernel.gru_recurrence(xp, w_hh, b_hh)
    ref, _ = gru_kernel.gru_recurrence_plain(xp, w_hh, b_hh)
    err = check_close("gru", got, ref, TOL["gru"])
    rows["gru"] = (err,
                   time_ms(lambda: gru_kernel.gru_recurrence(xp, w_hh, b_hh)),
                   time_ms(lambda: gru_kernel.gru_recurrence_plain(
                       xp, w_hh, b_hh)))
    del xp, got, ref
    # B: candidate image features, one scoring batch
    N, DV, B, K, HID = 1024, 2048, 768, 24, 300
    table = randn(N, DV)
    idx = torch.randint(0, N, (B, K + 1), generator=gen, device=dev,
                        dtype=torch.int32)
    w_o, w_m = randn(HID, DV, scale=DV ** -0.5), randn(HID, DV,
                                                       scale=DV ** -0.5)
    h1, d1 = vfeat_kernel.vfeat_scores(table, idx, w_o, w_m)
    h2, d2 = vfeat_kernel.vfeat_scores_plain(table, idx, w_o, w_m)
    err = max(check_close("vfeat h", h1, h2, TOL["vfeat_h"]),
              check_close("vfeat dist", d1, d2, TOL["vfeat_dist"]))
    rows["vfeat"] = (err,
                     time_ms(lambda: vfeat_kernel.vfeat_scores(
                         table, idx, w_o, w_m)),
                     time_ms(lambda: vfeat_kernel.vfeat_scores_plain(
                         table, idx, w_o, w_m)))
    # C: answer head + softmax over every candidate row of a batch
    M, DZ, A = 18432, 360, 2000
    z, w_cls, b_cls = randn(M, DZ), randn(A, DZ, scale=DZ ** -0.5), randn(A)
    p1 = mixture_kernel.classify_softmax(z, w_cls, b_cls)
    p2 = mixture_kernel.classify_softmax_plain(z, w_cls, b_cls)
    err = check_close("mixture", p1, p2, TOL["mixture"])
    rows["mixture"] = (err,
                       time_ms(lambda: mixture_kernel.classify_softmax(
                           z, w_cls, b_cls)),
                       time_ms(lambda: mixture_kernel.classify_softmax_plain(
                           z, w_cls, b_cls)))
    for name, (_, ms, plain_ms) in rows.items():
        log("  %-8s kernel %.3f ms  plain %.3f ms  (%s)"
            % (name, ms, plain_ms, card))
    return rows


def counters():
    from vqa_counterexamples_tpu_torch.ops.cuda import (
        gru_kernel, mixture_kernel, vfeat_kernel)

    return {"gru": gru_kernel.gru_recurrence,
            "vfeat": vfeat_kernel.vfeat_scores,
            "mixture": mixture_kernel.classify_softmax}


def reset_counters():
    for fn in counters().values():
        fn.launches = 0


def read_counters():
    return {name: fn.launches for name, fn in counters().items()}


class plain_kernels:
    """Swap the kernel wrappers the model modules call for their plain
    versions (the reference computation on the same card)."""

    def __enter__(self):
        from vqa_counterexamples_tpu_torch.models import cx
        from vqa_counterexamples_tpu_torch.ops import rnn, scorer
        from vqa_counterexamples_tpu_torch.ops.cuda import (
            gru_kernel, mixture_kernel, vfeat_kernel)

        self.swaps = [(rnn, "gru_recurrence",
                       gru_kernel.gru_recurrence_plain),
                      (cx, "vfeat_scores", vfeat_kernel.vfeat_scores_plain),
                      (scorer, "classify_softmax",
                       mixture_kernel.classify_softmax_plain)]
        self.saved = [getattr(m, n) for m, n, _ in self.swaps]
        for m, n, f in self.swaps:
            setattr(m, n, f)

    def __exit__(self, *exc):
        for (m, n, _), f in zip(self.swaps, self.saved):
            setattr(m, n, f)


def flagship_model(dataset, dev):
    from vqa_counterexamples_tpu_torch.data import synthetic
    from vqa_counterexamples_tpu_torch.engines import cx_engine
    from vqa_counterexamples_tpu_torch.models import factory

    opt = synthetic.tiny_vqa_options(dim_v=2048, nans=2000, dim_q=2400)
    opt["seq2vec"] = {"arch": "skipthoughts", "type": "BayesianUniSkip",
                      "dropout": 0.25, "fixed_emb": False}
    opt["fusion"].update(dim_hv=360, dim_hq=360, dim_mm=360, R=10)
    vqa = factory.factory_vqa(opt, dataset["vocab_words"],
                              dataset["vocab_answers"])
    spec = dict(dim_h=300, n_layers=2, drop_p=0.25, v_emb=True, v_mult=True,
                v_dist=True, v_rank=True, q_emb=True, a_emb=True, z_emb=True,
                pretrained_emb=False, trainable_vqa=False)
    model = factory.factory_cx("NeuralModel", vqa, knn_size=24,
                               model_spec=spec)
    return cx_engine.init_cx_params(model, seed=SEED).to(dev)


def phase_slice(dev, card):
    from vqa_counterexamples_tpu_torch.data import synthetic, vqacx
    from vqa_counterexamples_tpu_torch.engines import cx_engine

    log("== phase 2: the scoring slice at the flagship width")
    batch_size = 768
    dataset, store = synthetic.make_synthetic_cx(
        n_examples=2048, n_images=1024, dim_v=2048, knn_size=24,
        n_answers=2000, seed=SEED)
    arrays = vqacx.CXArrays.from_examples(dataset["examples_list"],
                                          dataset["name_to_index"])
    model = flagship_model(dataset, dev)
    features = store.to_device(dev)
    eval_step = cx_engine.make_cx_eval_step(model, recall_k=5,
                                            use_z_cache=True)
    if not model.wants_table_features():
        raise AssertionError("the vfeat kernel's gate is off")
    torch.cuda.synchronize()

    # --- the main path, counted ---
    reset_counters()
    t0 = time.perf_counter()
    q, _, z, stage_s = cx_engine.build_frozen_caches(
        model, features, arrays, use_q=True, use_v=False, use_z=True)
    feats_bf, q, _, z = cx_engine.make_tables_bf16_resident(features, q,
                                                           None, z)
    torch.cuda.synchronize()
    cache_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    res = cx_engine.eval_model(eval_step, feats_bf, arrays, batch_size,
                               q_table=q, z_table=z)
    eval_s = time.perf_counter() - t1
    launches = read_counters()
    log("  launches on the main path: %s" % launches)
    if min(launches.values()) <= 0:
        raise AssertionError("a kernel of the path never launched: %s"
                             % launches)
    log("  results: %s" % res)
    if not (np.isfinite(res["loss"]) and 0.0 <= res["recall_1"]
            <= res["recall"] <= 1.0):
        raise AssertionError("bad eval results %s" % res)
    if tuple(q.shape) != (2048, 2400) or tuple(z.shape) != (2048, 25, 360):
        raise AssertionError("cache shapes q %s z %s"
                             % (tuple(q.shape), tuple(z.shape)))

    # --- one batch: kernel path vs the plain versions on the same card ---
    idx = np.arange(batch_size)
    batch = cx_engine.batch_to_device(vqacx.gather_batch(arrays, idx), dev)
    with torch.no_grad():
        kw = cx_engine.cache_kwargs(batch, q, None, z)
        got = model(None, batch["question_wids"], batch["answer_aids"],
                    features_table=feats_bf, image_idxs=batch["image_idxs"],
                    **kw)
        sub = vqacx.CXArrays(*(a[idx] for a in arrays))
        with plain_kernels():
            q_p, _, z_p, _ = cx_engine.build_frozen_caches(
                model, features, sub, use_q=True, use_v=False, use_z=True)
            f_p, q_p, _, z_p = cx_engine.make_tables_bf16_resident(
                features, q_p, None, z_p)
            ref = model(None, batch["question_wids"], batch["answer_aids"],
                        features_table=f_p, image_idxs=batch["image_idxs"],
                        q_emb=q_p, z_emb=z_p)
    check_close("scores", got, ref, TOL["scores"])

    # --- rates (warm: kernels built, caches resident) ---
    reps = 5
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    for _ in range(reps):
        cx_engine.eval_model(eval_step, feats_bf, arrays, batch_size,
                             q_table=q, z_table=z)
    torch.cuda.synchronize()
    warm_s = (time.perf_counter() - t2) / reps
    log("  cache build %.3f s (stages %s), first eval %.3f s (%s)"
        % (cache_s, {k: round(v, 4) for k, v in stage_s.items()}, eval_s,
           card))
    log("  eval %.1f examples/s (warm, mean of %d passes over %d examples,"
        " B=%d; %s)" % (arrays.size / warm_s, reps, arrays.size, batch_size,
                        card))
    return launches


def phase_cli(dev):
    from vqa_counterexamples_tpu_torch.cli import counterexamples

    log("== phase 3: the CLI")
    reset_counters()
    with tempfile.TemporaryDirectory() as tmp:
        counterexamples.main(["--cx_model", "NeuralModel", "--synthetic",
                              "2048", "--z_cache", "--epochs", "0", "--test",
                              "-b", "768", "--seed", str(SEED),
                              "--device", str(dev), "--project_dir", tmp])
        (run,) = os.listdir(os.path.join(tmp, "logs", "cx"))
        path = os.path.join(tmp, "logs", "cx", run, "final_results.txt")
        with open(path) as f:
            res = json.load(f)
    launches = read_counters()
    log("  final_results.txt: %s; launches %s" % (res, launches))
    if min(launches.values()) <= 0:
        raise AssertionError("the CLI run missed a kernel: %s" % launches)
    if not (np.isfinite(res["loss"]) and 0.0 <= res["recall"] <= 1.0):
        raise AssertionError("bad CLI results %s" % res)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    log("card: %s; torch %s, CUDA %s" % (card, torch.__version__,
                                          torch.version.cuda))
    t0 = time.perf_counter()
    rows = phase_kernels(dev, card)
    launches = phase_slice(dev, card)
    phase_cli(dev)
    log("total %.1f s" % (time.perf_counter() - t0))
    kernels = [{"name": name, "route": "cuda",
                "source": "vqa_counterexamples_tpu_torch/csrc/%s.cu" % name,
                "replaces": REPLACES[name], "launches": launches[name],
                "max_abs_err": rows[name][0], "ms": rows[name][1],
                "plain_ms": rows[name][2]} for name in ("gru", "vfeat",
                                                        "mixture")]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
