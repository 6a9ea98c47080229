"""Timing of a window: the process's start, the host clock around the
window, and one CUDA event per step on the step's stream.

``StepClock.step()`` records an event on the current stream right after a
step's call returns: the event completes when the step's work on the
device does.  Nothing waits on it inside the window; the intervals between
consecutive completions are read once, after the window has closed.
``label(name)`` marks what the host does (``data``: the loader's
``next()``; ``step``: the step's call; ``epoch``: an engine's epoch or
pass, so that the rest of it is the epoch's own boundary work) for the
traced run's idle gaps, and costs nothing untraced.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np


def process_start_epoch(fallback: float) -> float:
    """Wall time at which this process started (Linux ``/proc``), or
    ``fallback`` where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        ticks = int(fields[19])   # field 22: starttime, clock ticks
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        start = btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return fallback
    # btime is whole seconds: never later than the first line's clock
    return min(start, fallback)


class StepClock:
    """Events at the window's start and after every step.  Off the card
    (the CPU tests) the events are host clock readings."""

    def __init__(self, traced: bool = False, cuda: bool = True):
        import torch

        self._torch = torch
        self.traced = traced
        self.cuda = cuda
        self.events = []
        self.start_event = None
        self.t0 = self.t1 = None

    def _sync(self) -> None:
        if self.cuda:
            self._torch.cuda.synchronize()

    def _event(self):
        if not self.cuda:
            return time.perf_counter()
        ev = self._torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def start(self) -> None:
        self._sync()
        self.t0 = time.perf_counter()
        self.start_event = self._event()

    def step(self) -> None:
        self.events.append(self._event())

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def stop(self) -> float:
        """Synchronise and close the window -> its wall seconds."""
        self._sync()
        self.t1 = time.perf_counter()
        return self.t1 - self.t0

    def intervals_ms(self) -> np.ndarray:
        """Device time between consecutive step completions (the first
        from the window's start)."""
        out, prev = [], self.start_event
        for ev in self.events:
            out.append(prev.elapsed_time(ev) if self.cuda
                       else (ev - prev) * 1e3)
            prev = ev
        return np.asarray(out, dtype=np.float64)

    def label(self, name: str):
        if not self.traced:
            return contextlib.nullcontext()
        return self._torch.profiler.record_function(name)
