"""What holds the kNN kernel and the GRU kernels back, on one card.

    python -m vqa_counterexamples_tpu_torch.cli.probe_kernels \\
        [--out logs/probe_kernels.json]

kNN, at the builder's chunk (1024 queries against 82,783 x 2048 f32 from
the seed): the kernel's ms at k 1, 25 and 100 (k 1 leaves the threshold
filter almost nothing to merge, so k 25 - k 1 is the filter's share), and
one cuBLAS product of the same shape in TF32 and in f32 (``torch.mm``, a
yardstick the port never calls: the kernel runs three TF32 products).

GRU forward, at T 26, H 2400, for B 128, 512 and 2048, without a mask
and with per-gate masks (h_proj out, as in training): the wrapper's ms
(CUDA events) with the tile ``gru_kernel.forward_tile`` picks and, under
``torch.profiler``, the device time of one step launch that carries the
product and of the first, which has none; beside them one bf16
``torch.mm`` of the step's shape, (B, H) x (H, 3H), a yardstick the port
never calls; and the wrapper's ms with every tile of
``gru_kernel.FWD_TILES`` at 3 to 6 stages, as many as fit.

GRU backward, at T 26, H 2400 with per-gate masks, for B 64, 128, 256 and
512: the wrapper's ms (CUDA events) and, under ``torch.profiler``, the
device time of one step launch that carries a back product and of the
first, which only runs the gate step.

Needs a card: it refuses to run without one.  The JSON report goes to
``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess

import torch


def _ms(fn, reps=5):
    """Mean ms per call over ``reps`` calls after a warm-up (CUDA events)."""
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


def probe_knn(dev, gen):
    from ..ops.cuda import knn_kernel

    n, dim, nq = 82783, 2048, 1024
    corpus = torch.randn(n, dim, generator=gen, device=dev)
    queries = corpus[torch.randperm(n, generator=gen, device=dev)[:nq]]
    queries = queries.contiguous()
    csq = (corpus * corpus).sum(1)
    out = {"shape": [nq, n, dim]}
    for k in (1, 25, 100):
        out["kernel_ms_k%d" % k] = _ms(
            lambda: knn_kernel.knn_chunk(queries, corpus, k, csq))
    for tf32 in (True, False):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        out["mm_%s_ms" % ("tf32" if tf32 else "f32")] = _ms(
            lambda: torch.mm(queries, corpus.t()))
    torch.backends.cuda.matmul.allow_tf32 = False
    return out


def _step_us(prof, name):
    """(first launch, mean of the others) device us of kernels ``name``."""
    steps = [e.device_time_total for e in prof.events() if name in e.name]
    return steps[0], sum(steps[1:]) / max(len(steps) - 1, 1), len(steps)


def probe_gru_fwd(dev, gen, batch, per_gate):
    from ..ops.cuda import gru_kernel

    seq, dim_h = 26, 2400

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).to(torch.bfloat16)

    xp, w = randn(seq, batch, 3 * dim_h), randn(3 * dim_h, dim_h,
                                                scale=dim_h ** -0.5)
    b = torch.randn(3 * dim_h, generator=gen, device=dev) * 0.1
    mask = (((torch.rand(3, batch, dim_h, generator=gen, device=dev) < 0.75)
             * (256.0 / 192)).to(torch.bfloat16) if per_gate else None)
    args = (xp, w, b, mask, per_gate)
    tile = gru_kernel.forward_tile(xp, w, b, mask)
    out = {"batch": batch, "mask": "per_gate" if per_gate else "none",
           "tile": list(tile),
           "wrapper_ms": _ms(lambda: gru_kernel.gru_recurrence(*args))}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    h = xp[0, :, :dim_h].contiguous()
    with torch.profiler.profile(activities=acts) as prof:
        gru_kernel.gru_recurrence(*args)
        for _ in range(seq):
            torch.mm(h, w.t())
        torch.cuda.synchronize()
    (out["first_step_us"], out["carry_step_us"],
     out["step_launches"]) = _step_us(prof, "gru_fwd_step")
    mm = [e.device_time_total for e in prof.events() if e.name == "aten::mm"]
    out["mm_bf16_step_us"] = sum(mm) / max(len(mm), 1)
    out["tiles"] = []
    for shape in gru_kernel.FWD_TILES:
        fit = gru_kernel.SMEM_BLOCK // gru_kernel.fwd_stage_bytes(
            3 if per_gate else 0, *shape)
        for stages in sorted({min(s, fit) for s in (3, 4, 5, 6)}):
            t = gru_kernel.FwdTile(*shape, stages, True)
            out["tiles"].append({"tile": list(t), "ms": _ms(
                lambda: gru_kernel._gru_fwd(*args, t))})
    return out


def probe_gru_bwd(dev, gen, batch):
    from ..ops.cuda import gru_kernel

    seq, dim_h = 26, 2400

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).to(torch.bfloat16)

    xp, w = randn(seq, batch, 3 * dim_h), randn(3 * dim_h, dim_h,
                                                scale=dim_h ** -0.5)
    b = torch.randn(3 * dim_h, generator=gen, device=dev) * 0.1
    mask = ((torch.rand(3, batch, dim_h, generator=gen, device=dev) < 0.75)
            * (256.0 / 192)).to(torch.bfloat16)
    states, hproj = gru_kernel.gru_recurrence(xp, w, b, mask,
                                              want_hproj=True)
    args = (xp, w, mask, states, hproj, randn(seq, batch, dim_h))
    out = {"batch": batch,
           "wrapper_ms": _ms(lambda: gru_kernel.gru_recurrence_bwd(*args))}
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        gru_kernel.gru_recurrence_bwd(*args)
        torch.cuda.synchronize()
    (out["gate_only_step_us"], out["carry_step_us"],
     out["step_launches"]) = _step_us(prof, "gru_bwd_step")
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default="logs/probe_kernels.json")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_kernels: no CUDA device visible")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    report = {"card": card, "knn": probe_knn(dev, gen),
              "gru_fwd": [probe_gru_fwd(dev, gen, batch, per_gate)
                          for batch in (128, 512, 2048)
                          for per_gate in (False, True)],
              "gru_bwd": [probe_gru_bwd(dev, gen, batch)
                          for batch in (64, 128, 256, 512)]}
    out = json.dumps(report, indent=1)
    print(out)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(out + "\n")
    return report


if __name__ == "__main__":
    main()
