"""What holds the port's kernels back, on one card.

    python -m vqa_counterexamples_tpu_torch.cli.probe_kernels \\
        [--out logs/probe_kernels.json] [--sections knn,gru_fwd,...]

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

Mixture (the answer head's softmax), at the CX path's shape (M 18432,
dz 360, A 2000): the kernel's ms, the plain version's, and the ms of the
library composition ``torch.softmax(F.linear(z, w, b), dim=1)`` in bf16
(a yardstick the port never calls), and the plan the wrapper picks.

MUTAN's Tucker fusion, at MutanNoAtt's shape (B 512, dh 360 / 360, R 10,
dmm 360) and MutanAtt's classifier (B 128, dhv 620, dhq 310, R 5, dmm
510); the folded MUTAN forward and backward, at MutanAtt's attention
shape (B 128, K 196, Dh 310, R 5, M 510): the wrapper's ms (CUDA events,
after a warm-up), the plain version's, and, under ``torch.profiler``, the
device us of each of the wrapper's launches, by kernel name; for the
forward also the plan and the ms of every configuration of
``attmutan_kernel.FWD_CONFIGS``.

The vfeat forward and backward, at the CX path's shape (B 768, K 24,
dim_v 2048, H 300, bf16) over a table of 1,024 rows (chip_smoke's, 4 MB:
it stays in L2) and of 82,783 rows (COCO-train2014, 339 MB: the gathered
rows come from HBM): the wrapper's ms (CUDA events, after a warm-up), the
plain version's, the device us of each launch under ``torch.profiler``
by kernel name, and a yardstick the port never calls: the two bf16
``torch.mm`` of the kernel's products on operands gathered beforehand
(the gather not timed), (18432 x 2048) @ (2048 x 300) for x and bf16(o
* x) forward, (300 x 18432) @ (18432 x 2048) for each backward.

``--sections`` picks some of knn, gru_fwd, gru_bwd, mixture, mutan,
attmutan_fwd, attmutan_bwd, vfeat (all by default).  Needs a card: it refuses to
run without one.  The JSON report goes to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
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


def probe_mixture(dev, gen):
    from ..ops.cuda import mixture_kernel

    rows, dim_z, n_ans = 18432, 360, 2000

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).to(torch.bfloat16)

    z, w, b = randn(rows, dim_z), randn(n_ans, dim_z, scale=dim_z ** -0.5), \
        randn(n_ans)
    return {"shape": [rows, dim_z, n_ans],
            "kernel_ms": _ms(lambda: mixture_kernel.classify_softmax(
                z, w, b), reps=20),
            "plain_ms": _ms(lambda: mixture_kernel.classify_softmax_plain(
                z, w, b), reps=20),
            "library_ms": _ms(lambda: torch.softmax(
                torch.nn.functional.linear(z, w, b), dim=1), reps=20),
            "plan": list(mixture_kernel.mixture_plan(dim_z, n_ans))}


def _kernel_name(name):
    """A device kernel's name without its namespace, template arguments
    and parameters (``void ns::(anonymous namespace)::k<true>(P)`` ->
    ``k``)."""
    return re.sub(r"<.*", "", re.sub(r"\(.*", "", name.replace(
        "(anonymous namespace)::", "")).split("::")[-1])


def _launches(fn, reps, match):
    """Device us per launch and launches per call of the kernels whose
    names hold ``match``, under ``torch.profiler`` over ``reps`` calls."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    launches = {}
    for e in prof.events():
        if e.device_time_total > 0 and match in e.name:
            launches.setdefault(_kernel_name(e.name), []).append(
                e.device_time_total)
    return {"launch_us": {n: sum(v) / len(v) for n, v in launches.items()},
            "launches_per_call": {n: len(v) / reps
                                  for n, v in launches.items()},
            "device_us_per_call": sum(sum(v) for v in launches.values())
            / reps}


def _timed(fn, plain, match, reps=20):
    out = {"wrapper_ms": _ms(fn, reps=reps), "plain_ms": _ms(plain,
                                                             reps=reps)}
    out.update(_launches(fn, reps, match))
    return out


def _randn(gen, dev, *shape, scale=1.0, dtype=torch.bfloat16):
    return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)


def probe_mutan(dev, gen, batch, dhv, dhq, rank, dmm):
    from ..ops.cuda import mutan_kernel

    f32 = torch.float32
    args = (_randn(gen, dev, batch, dhv), _randn(gen, dev, batch, dhq),
            _randn(gen, dev, rank * dmm, dhv, scale=dhv ** -0.5),
            _randn(gen, dev, rank * dmm, scale=0.1, dtype=f32),
            _randn(gen, dev, rank * dmm, dhq, scale=dhq ** -0.5),
            _randn(gen, dev, rank * dmm, scale=0.1, dtype=f32), rank)
    out = {"shape": [batch, dhv, dhq, rank, dmm]}
    out.update(_timed(lambda: mutan_kernel.tucker_fusion(*args),
                      lambda: mutan_kernel.tucker_fusion_plain(*args),
                      "mutan"))
    return out


_ATT = (128, 196, 310, 5, 510)   # B, K, Dh, R, M


def _att_args(dev, gen):
    batch, k, dim_h, rank, dim_m = _ATT
    f32 = torch.float32
    return (_randn(gen, dev, batch, k, dim_h),
            _randn(gen, dev, rank * dim_m, dim_h, scale=dim_h ** -0.5),
            _randn(gen, dev, rank * dim_m, scale=0.1, dtype=f32),
            _randn(gen, dev, batch, rank, dim_m, dtype=f32))


def probe_attmutan_fwd(dev, gen):
    from ..ops.cuda import attmutan_kernel

    args = _att_args(dev, gen)
    out = {"shape": list(_ATT)}
    out.update(_timed(lambda: attmutan_kernel.folded_mutan(*args),
                      lambda: attmutan_kernel.folded_mutan_plain(*args),
                      "attmutan"))
    out["plan"] = attmutan_kernel.fwd_plan(*_ATT)
    out["configs"] = [{"config": list(c), "ms": _ms(
        lambda: attmutan_kernel._fwd_launch(*args, c[:2]), reps=20)}
        for c in attmutan_kernel.FWD_CONFIGS]
    return out


def probe_attmutan_bwd(dev, gen):
    from ..ops.cuda import attmutan_kernel

    batch, k, _, _, dim_m = _ATT
    args = _att_args(dev, gen) + (_randn(gen, dev, batch, k, dim_m,
                                         scale=0.1),)
    out = {"shape": list(_ATT)}
    out.update(_timed(lambda: attmutan_kernel.folded_mutan_bwd(*args),
                      lambda: attmutan_kernel.folded_mutan_bwd_plain(*args),
                      "attmutan"))
    return out


def probe_vfeat(dev, gen, n_rows):
    from ..ops.cuda import vfeat_kernel

    batch, k, dim_v, dim_h = 768, 24, 2048, 300
    table = _randn(gen, dev, n_rows, dim_v)
    idx = torch.randint(0, n_rows, (batch, k + 1), generator=gen,
                        device=dev, dtype=torch.int32)
    w_o = _randn(gen, dev, dim_h, dim_v, scale=dim_v ** -0.5)
    w_m = _randn(gen, dev, dim_h, dim_v, scale=dim_v ** -0.5)
    g = _randn(gen, dev, batch, k, dim_h, scale=1e-2)
    out = {"shape": [n_rows, dim_v, batch, k, dim_h]}
    with torch.no_grad():
        out["fwd"] = _timed(
            lambda: vfeat_kernel.vfeat_scores(table, idx, w_o, w_m),
            lambda: vfeat_kernel.vfeat_scores_plain(table, idx, w_o, w_m),
            "vfeat")
    out["bwd"] = _timed(
        lambda: vfeat_kernel.vfeat_weight_grads(table, idx, g),
        lambda: vfeat_kernel.vfeat_weight_grads_plain(table, idx, g),
        "vfeat")
    # the yardstick: cuBLAS on the same products, operands gathered first
    x = table[idx[:, 1:].long()].reshape(-1, dim_v)
    m = (x.view(batch, k, dim_v) * table[idx[:, 0].long()][:, None]
         ).reshape(-1, dim_v)
    g2 = g.reshape(-1, dim_h)
    out["fwd"]["library_ms"] = _ms(
        lambda: (torch.mm(x, w_o.t()), torch.mm(m, w_m.t())), reps=20)
    out["bwd"]["library_ms"] = _ms(
        lambda: (torch.mm(g2.t(), x), torch.mm(g2.t(), m)), reps=20)
    return out


SECTIONS = ("knn", "gru_fwd", "gru_bwd", "mixture", "mutan", "attmutan_fwd",
            "attmutan_bwd", "vfeat")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default="logs/probe_kernels.json")
    parser.add_argument("--sections", default=",".join(SECTIONS))
    args = parser.parse_args(argv)
    sections = args.sections.split(",")
    if not set(sections) <= set(SECTIONS):
        parser.error("--sections: pick from %s" % ", ".join(SECTIONS))
    if not torch.cuda.is_available():
        raise SystemExit("probe_kernels: no CUDA device visible")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    probes = {
        "knn": lambda: probe_knn(dev, gen),
        "gru_fwd": lambda: [probe_gru_fwd(dev, gen, batch, per_gate)
                            for batch in (128, 512, 2048)
                            for per_gate in (False, True)],
        "gru_bwd": lambda: [probe_gru_bwd(dev, gen, batch)
                            for batch in (64, 128, 256, 512)],
        "mixture": lambda: probe_mixture(dev, gen),
        "mutan": lambda: [probe_mutan(dev, gen, *shape) for shape in (
            (512, 360, 360, 10, 360), (128, 620, 310, 5, 510))],
        "attmutan_fwd": lambda: probe_attmutan_fwd(dev, gen),
        "attmutan_bwd": lambda: probe_attmutan_bwd(dev, gen),
        "vfeat": lambda: [probe_vfeat(dev, gen, n_rows)
                          for n_rows in (1024, 82783)]}
    report = {"card": card}
    for name in sections:
        report[name] = probes[name]()
    out = json.dumps(report, indent=1)
    print(out)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(out + "\n")
    return report


if __name__ == "__main__":
    main()
