"""The traced window: ``torch.profiler`` over the window, read into the
few lists the per-layer readers need.

The arithmetic is copied from the port's profilers
(``cli/profile_cx.py``: ``GROUPS``, ``_busy_ms``, ``HOST_LAUNCHES``) and
kept here, where a change to the program cannot move the yardstick:

- device work is every kernel, copy and set on the device timeline, less
  the ranges the profiler mirrors there for annotations;
- busy time is the union of those intervals, idle the rest of the window;
- the host's launch calls are the CUDA runtime's kernel launches, graph
  launches and copies;
- kernels are grouped by name for the breakdown.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

GROUPS = (("vfeat_bwd", ("vfeat_bwd",)), ("vfeat_fwd", ("vfeat_fwd",)),
          ("mixture", ("mixture",)), ("gru_bwd", ("gru_bwd",)),
          ("gru", ("gru_",)), ("mutan", ("mutan",)),
          ("conv", ("fprop", "cudnn", "conv2d", "implicit_convolve")),
          ("gemm", ("gemm", "cutlass", "xmma", "cublas", "sm90_", "sm80_")),
          ("adam", ("adam", "foreach", "multi_tensor")),
          ("memcpy/memset", ("memcpy", "memset")))

HOST_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                 "cudaMemsetAsync")

# the benchmark's own host labels (harness/clock.py), innermost wins
LABELS = ("data", "step", "epoch")


def group(name: str) -> str:
    low = name.lower()
    for grp, keys in GROUPS:
        if any(k in low for k in keys):
            return grp
    return "elementwise/reduce/other"


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals (same unit out)."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


@dataclass
class Trace:
    """What one traced window holds, in microseconds on the profiler's
    clock (host and device share it)."""
    window_s: float
    steps: int
    kernels: list = field(default_factory=list)      # (name, start, end)
    host_launches: int = 0
    labels: dict = field(default_factory=dict)      # name -> [(s, e)]
    span: tuple = (0.0, 0.0)                         # the window on that clock

    @property
    def busy_s(self) -> float:
        return union_us((s, e) for _, s, e in self.kernels) / 1e6

    def device_ops(self, top: int = 10) -> list:
        by = {}
        for name, s, e in self.kernels:
            g = group(name)
            by[g] = by.get(g, 0.0) + (e - s) / 1e6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top: int = 10) -> list:
        """Device idle time inside the window, summed by the benchmark's
        innermost host label at each gap's midpoint (``other`` where none
        is open)."""
        ivs = sorted((s, e) for _, s, e in self.kernels)
        gaps, end = [], self.span[0]
        for s, e in ivs:
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
        if self.span[1] > end:
            gaps.append((end, self.span[1]))
        by = {}
        for s, e in gaps:
            mid = (s + e) / 2
            name = "other"
            for lab in LABELS:
                if any(a <= mid <= b for a, b in self.labels.get(lab, ())):
                    name = lab
                    break
            by[name] = by.get(name, 0.0) + (e - s) / 1e6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:top]

    def kernel_times_s(self, keys) -> float:
        """Summed device seconds of the kernels whose name holds any of
        ``keys``."""
        return sum((e - s) for n, s, e in self.kernels
                   if any(k in n for k in keys)) / 1e6

    def kernel_count(self, keys) -> int:
        return sum(1 for n, _, _ in self.kernels if any(k in n for k in keys))


class Profiler:
    """``with Profiler() as p: ...`` around the window; ``p.read(...)``
    after it.  The tracer opens on a one-kernel warm-up step whose records
    are discarded (the port's profilers saw a window opened on the calls
    themselves lose the record of one of their first kernels)."""

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, schedule

        self._torch = torch
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA],
                            schedule=schedule(wait=0, warmup=1, active=1))
        self.prof.__enter__()
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        self.prof.step()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        return False

    def read(self, window_s: float, steps: int) -> Trace:
        torch = self._torch
        cuda = torch.autograd.DeviceType.CUDA
        kernels, labels, host = [], {k: [] for k in LABELS}, 0
        lo, hi = float("inf"), float("-inf")
        for e in self.prof.events():
            s, t = e.time_range.start, e.time_range.end
            if e.device_type == cuda:
                if getattr(e, "is_user_annotation", False):
                    continue
                kernels.append((e.name, s, t))
            else:
                name = e.name
                if name in labels:
                    labels[name].append((s, t))
                    if name == "epoch" or name == "step":
                        lo, hi = min(lo, s), max(hi, t)
                elif name.split("_v")[0] in HOST_LAUNCHES:
                    host += 1
        if kernels:
            lo = min(lo, min(s for _, s, _ in kernels))
            hi = max(hi, max(t for _, _, t in kernels))
        return Trace(window_s=window_s, steps=steps, kernels=kernels,
                     host_launches=host, labels=labels, span=(lo, hi))


@contextlib.contextmanager
def maybe_profile(on: bool):
    if not on:
        yield None
        return
    with Profiler() as p:
        yield p
