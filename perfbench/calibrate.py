"""Readings that set a cell's limits, many seeds in one process.

    python3 perfbench/calibrate.py --workload <cell> --seeds 11,12,13 \\
        [--fault none|unchanged|half_batch|answer] [--seconds 1] [--out <file>]

For each seed: the cell's set-up and, for a cell that checks what its
window produced, a short window; then the numbers the run compares, for
the program against the plain reference and for the control (the
reference at float8) against it.  ``--fault`` plants a fault in the
program first: ``unchanged`` makes each step leave the parameters as
they were; ``half_batch`` takes the loss's mean over the first half
of each batch and leaves the rest out; ``answer`` alters the answers the
program produces (the sampled training answers, or the predictions).
One JSON line per seed on standard output, and in ``--out``.

Needs a card, as a run does.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def plant(fault: str):
    """A function that plants ``fault`` in the port's engines (None for
    none); the test of the faults uses the same functions."""
    if fault == "none":
        return None
    return getattr(sys.modules[__name__], "_plant_" + fault)


def _half(x):
    import torch

    n = x.shape[0] // 2
    keep = torch.zeros(x.shape[0], device=x.device)
    keep[:n] = x.shape[0] / n
    return x * keep


def _plant_half_batch(job) -> None:
    from vqa_counterexamples_tpu_torch.engines import cx_engine, vqa_engine

    nll, ce_mean = cx_engine.nll, vqa_engine.cross_entropy_mean
    cx_engine.nll = lambda scores, comp: _half(nll(scores, comp))
    vqa_engine.cross_entropy_mean = lambda out, ans: ce_mean(
        out[:out.shape[0] // 2], ans[:ans.shape[0] // 2])


def _plant_unchanged(job) -> None:
    import torch

    step = torch.optim.Adam.step

    def unchanged(self, *args, **kwargs):
        params = [p for g in self.param_groups for p in g["params"]]
        before = [p.detach().clone() for p in params]
        out = step(self, *args, **kwargs)
        with torch.no_grad():
            for p, b in zip(params, before):
                p.copy_(b)
        return out
    torch.optim.Adam.step = unchanged


def _plant_answer(job) -> None:
    from vqa_counterexamples_tpu_torch.data import vqa_dataset
    from vqa_counterexamples_tpu_torch.engines import vqa_engine

    sample = vqa_dataset.VQAArrays.sample_answers

    def altered(self, idx, rng):
        out = sample(self, idx, rng)
        return out - (out > 0) + (out == 0) if self.samplingans else out
    vqa_dataset.VQAArrays.sample_answers = altered
    make = vqa_engine.make_vqa_eval_step

    def make_altered(model, **kw):
        step = make(model, **kw)

        def altered_step(batch):
            out = step(batch)
            pred = out["pred"]
            out["pred"] = pred - (pred > 0).long() + (pred == 0).long()
            return out
        altered_step.mesh = step.mesh
        return altered_step
    vqa_engine.make_vqa_eval_step = make_altered


def readings(reg, cell: dict, seed: int, seconds: float, fault: str,
             device, planted: bool = False) -> dict:
    """One seed's numbers; ``planted``: the fault is in place already (it
    is planted once a process)."""
    from perfbench.harness import clock as clock_lib
    from perfbench.harness import runner

    ctx = runner.build_context(reg, cell, seed, device)
    runner.set_environment(ctx.config)
    job = reg.job(ctx.traffic["job"])
    patch = plant(fault)
    if patch is not None and not planted:
        patch(job)
    js = job.setup(ctx)
    if job.KIND == "eval":
        clock = clock_lib.StepClock(cuda=device.type == "cuda")
        job.window(js, clock, seconds)
    job.release(js)
    gc.collect()
    out = {"seed": seed, "fault": fault, "program": job.check(js)}
    if fault == "none":
        out["control"] = job.check(js, "fp8")
    del js
    gc.collect()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--fault", default="none",
                   choices=("none", "unchanged", "half_batch", "answer"))
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch

    from perfbench.harness.registry import Registry

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device is visible", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    reg = Registry()
    cell = reg.cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    for seed in seeds:
        t = time.time()
        row = readings(reg, cell, seed, args.seconds, args.fault, device,
                       planted=seed != seeds[0])
        row["seconds"] = time.time() - t
        line = json.dumps(row, default=str)
        print(line)
        sys.stdout.flush()
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
