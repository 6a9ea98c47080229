"""One run of a cell: arguments, the card, set-up, the window, the check,
the result line.  See ``perfbench/run.py``."""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field

from perfbench.harness import clock as clock_lib
from perfbench.harness import trace as trace_lib
from perfbench.harness.registry import ROOT, Registry

# top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "vqa_counterexamples_tpu")

# a traced run's window, at most (the profiler's records grow with it)
TRACE_SECONDS = 2.0


@dataclass
class Context:
    """What a job gets: the cell's files, the seed, the card; ``mark``
    records the end of a set-up stage (printed with the result)."""
    registry: Registry
    cell: dict
    config: dict
    traffic: dict
    seed: int
    base_seed: int
    device: object
    marks: list = field(default_factory=list)

    def mark(self, stage: str) -> None:
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)
        self.marks.append((stage, time.time()))


def parse(argv):
    p = argparse.ArgumentParser(description="one run of a benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(msg: str, code: int) -> int:
    print("perfbench: %s" % msg, file=sys.stderr)
    return code


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def set_environment(cfg: dict) -> None:
    """The configuration's compute dtype; build and kernel caches at fixed
    paths inside the checkout (the port's nvcc builds go to its own
    ``_build/`` there)."""
    os.environ["VQACX_COMPUTE_DTYPE"] = cfg["dtype"]
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(ROOT, ".perfbench_cache", "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(ROOT, ".perfbench_cache",
                                       "torch_extensions"))
    os.environ.setdefault("USE_FLAX", "0")
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def card_power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def build_context(reg: Registry, cell: dict, seed: int, device) -> Context:
    return Context(registry=reg, cell=cell, config=reg.config(cell["config"]),
                   traffic=reg.traffic(cell["traffic"]), seed=seed,
                   base_seed=seed % (2 ** 62), device=device)


def compared(cell: dict, numbers: dict) -> tuple:
    """(correct, {name: {value, limit}}): every number of the cell's
    ``limits`` at or under its limit; a number missing or not finite
    fails."""
    out, ok = {}, True
    for name, limit in cell["limits"].items():
        value = numbers.get(name, float("nan"))
        out[name] = {"value": value, "limit": limit}
        if not (value == value and value <= limit):
            ok = False
    return ok, out


def e2e_metrics(reg, cell_name: str, window: dict) -> dict:
    out = {}
    for m in reg.metrics_of(cell_name, "end_to_end"):
        value = reg.module("e2e", m["name"]).read(window)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def layer_metrics(reg, cell_name: str, view) -> dict:
    out = {}
    for m in reg.metrics_of(cell_name, "per_layer"):
        value = reg.module("metrics", m["name"]).read(view)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


@dataclass
class TraceView:
    """What a per-layer reader reads: the traced window, the shapes of its
    steps as the job handed them over, the cell's configuration, and the
    counts (``perfbench/counts``) that a reader works its bounds out
    from."""
    trace: trace_lib.Trace
    window: dict
    ctx: Context

    @property
    def extra(self) -> dict:
        return self.window.get("extra", {})

    @property
    def shapes(self) -> dict:
        return self.window.get("shapes", {})

    @property
    def config(self) -> dict:
        return self.ctx.config

    @property
    def kernels(self):
        """``perfbench/counts/kernels.py``: each kernel's operations and
        bytes, the peaks, ``bound_s``."""
        return self.ctx.registry.kernels()

    @property
    def counts(self):
        """``perfbench/counts/<config>.py``: the configuration's step
        counts."""
        return self.ctx.registry.counts(self.ctx.config["name"])


def main(argv=None, wall0: float | None = None) -> int:
    wall0 = time.time() if wall0 is None else wall0
    args = parse(argv)
    reg = Registry()
    cell = reg.cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        return fail("no CUDA device is visible: the benchmark runs on the "
                    "card only", 3)
    if torch.cuda.device_count() < cell["chips"]:
        return fail("the cell asks for %d cards, %d visible"
                    % (cell["chips"], torch.cuda.device_count()), 3)
    result = run(reg, cell, args.seed, args.seconds, bool(args.trace),
                 torch.device("cuda", 0), clock_lib.process_start_epoch(wall0))
    found = forbidden_modules()
    if found:
        return fail("modules loaded in this process: %s" % ", ".join(found),
                    4)
    for name, c in result["checks"].items():
        print("check %s %r limit %r" % (name, c["value"], c["limit"]),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(finite(result)))
    sys.stdout.flush()
    return 0


def finite(obj):
    """The result with every non-finite float as null (strict JSON)."""
    if isinstance(obj, dict):
        return {k: finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [finite(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    return obj


def run(reg: Registry, cell: dict, seed: int, seconds: float, traced: bool,
        device, start: float, job_patch=None) -> dict:
    """Set-up, window, check -> the result (``checks`` last).  ``job_patch``
    (tests): a function given the job module before set-up."""
    import torch

    on_card = device.type == "cuda"
    ctx = build_context(reg, cell, seed, device)
    ctx.mark("start")
    set_environment(ctx.config)
    job = reg.job(ctx.traffic["job"])
    if job_patch is not None:
        job_patch(job)
    if on_card:
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    js = job.setup(ctx)
    if on_card:
        torch.cuda.synchronize(device)
    setup_s = time.time() - start
    if traced:
        seconds = min(seconds, TRACE_SECONDS)
    clock = clock_lib.StepClock(traced=traced, cuda=on_card)
    with trace_lib.maybe_profile(traced) as prof:
        window = job.window(js, clock, seconds)
    window.update(setup_s=setup_s, step_ms=clock.intervals_ms())
    peak = int(torch.cuda.max_memory_allocated(device)) if on_card else 0
    forbidden = forbidden_modules()
    card = card_power_limit() if on_card else "cpu"
    trace = (prof.read(window["window_s"], window["steps"]) if traced
             else None)
    prof = None
    job.release(js)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers = job.check(js)
    correct, checks = compared(cell, numbers)
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": cell["chips"], "memory_peak_bytes": peak,
           "power_limit": card}
    result = {"correct": correct, "attempted": window["steps"],
              "failed": window["failed"]}
    if trace is None:
        result["metrics"] = e2e_metrics(reg, cell["name"], window)
    else:
        result["metrics"] = layer_metrics(
            reg, cell["name"], TraceView(trace, window, ctx))
        dev.update(busy_s=trace.busy_s, window_s=trace.window_s)
        result["breakdown"] = {"device_ops": trace.device_ops(),
                               "idle_gaps": trace.idle_gaps()}
    result["device"] = dev
    result["checks"] = checks
    extra = {k: v for k, v in numbers.items() if k.startswith("_")}
    stages, prev = [], start
    for name, t in ctx.marks:
        stages.append("%s %.2f" % (name, t - prev))
        prev = t
    print("perfbench: %s seed %d, %s; set-up %.3f s (%s), window %.3f s, "
          "%d steps; %s; loaded during the window: %s"
          % (cell["name"], seed, card, setup_s, ", ".join(stages),
             window["window_s"], window["steps"], json.dumps(extra),
             forbidden or "nothing forbidden"), file=sys.stderr)
    return result
