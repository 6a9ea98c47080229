"""What holds the kNN kernel and the GRU backward back, on one card.

    python -m vqa_counterexamples_tpu_torch.cli.probe_kernels \\
        [--out logs/probe_kernels.json]

kNN, at the builder's chunk (1024 queries against 82,783 x 2048 f32 from
the seed): the kernel's ms at k 1, 25 and 100 (k 1 leaves the threshold
filter almost nothing to merge, so k 25 - k 1 is the filter's share), and
one cuBLAS product of the same shape in TF32 and in f32 (``torch.mm``, a
yardstick the port never calls: the kernel runs three TF32 products).

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
    steps = [e.device_time_total for e in prof.events()
             if "gru_bwd_step" in e.name]
    out["step_launches"] = len(steps)
    out["gate_only_step_us"] = steps[0]
    out["carry_step_us"] = sum(steps[1:]) / max(len(steps) - 1, 1)
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
