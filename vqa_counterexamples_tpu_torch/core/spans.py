"""Spans and counters of the port: where its host time goes, on the
profiler's clock.

- :func:`span` ``(name, step=None)`` wraps one piece of host work at a layer
  boundary (``data.batch``, ``engine.step`` and its parts, ...).  With no
  profiler recording it costs one flag read and does nothing.  While a
  ``torch.profiler`` or ``torch.autograd.profiler`` records, it opens
  ``torch.profiler.record_function(name)``, so the span sits on the
  profiler's timeline beside the kernels, and keeps ``(name, parent, step,
  start_ns, end_ns)`` on ``time.perf_counter_ns()`` in memory.  ``parent``
  is the index in :func:`records` of the span open around it on the same
  thread (-1 for none); ``step`` is given, or taken from that parent, so
  every part of an ``engine.step`` carries its step.  The profiler is the
  only switch: there is no flag or variable of its own.
- :func:`count`, :func:`add` and :func:`timed` are always on: they count
  rare events (captures, kernel builds, cache builds), their host seconds
  and each kernel's launches (``kernels.launches.<name>``, declared by its
  wrapper's module with :func:`declare`: 0 until it counts).
- :func:`records`, :func:`counters`, :func:`summary` read the store,
  :func:`reset` clears it.

No span stays open across a ``yield``: a generator's span closes before
the generator hands its item out.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler

# spans kept, newest last (a traced benchmark window of 2 s holds ~12k)
MAX_RECORDS = 1 << 18


def recording() -> bool:
    """Whether a profiler records now: torch's own Python flag, set and
    cleared as its trace starts and stops, or its C++ query where that
    flag is missing."""
    flag = getattr(_autograd_profiler, "_is_profiler_enabled", None)
    return torch.autograd._profiler_enabled() if flag is None else flag


# the span handed out while no profiler records
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("tracer", "name", "step", "seq", "parent", "start", "range")

    def __init__(self, tracer, name, step):
        self.tracer, self.name, self.step = tracer, name, step

    # the clock is read outside the profiler's range: its enter and exit
    # (some microseconds, and their spread) fall inside the span, not
    # between the span and the work around it
    def __enter__(self):
        self.start = time.perf_counter_ns()
        stack = self.tracer._stack()
        outer = stack[-1] if stack else None
        self.parent = -1 if outer is None else outer.seq
        if self.step is None and outer is not None:
            self.step = outer.step
        self.seq = next(self.tracer._seq)
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        self.tracer._stack().pop()
        self.range.__exit__(*exc)
        self.tracer._records.append((self.seq, self.name, self.parent,
                                     self.step, self.start,
                                     time.perf_counter_ns()))
        return False


class _Timer:
    """Adds a block's host seconds to a counter (and 1 to another);
    ``seconds`` holds them afterwards."""

    def __init__(self, tracer, name, counted):
        self.tracer, self.name, self.counted = tracer, name, counted
        self.seconds = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        self.tracer.count(self.name, self.seconds)
        if self.counted is not None:
            self.tracer.count(self.counted)
        return False


class Tracer:
    """The store behind the module's functions: spans in a bounded deque,
    counters in a dict."""

    def __init__(self):
        self._records = collections.deque(maxlen=MAX_RECORDS)
        self._seq = itertools.count()
        self._local = threading.local()
        self._counters = {}
        self._declared = {}
        self._lock = threading.Lock()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str, step: int | None = None):
        if not recording():
            return _OFF
        return _Span(self, name, step)

    def count(self, name: str, n=1) -> None:
        self.add({name: n})

    def add(self, counts: dict) -> None:
        """Adds each of ``counts`` to its counter, in one locked update."""
        with self._lock:
            for name, n in counts.items():
                self._counters[name] = self._counters.get(name, 0) + n

    def declare(self, *names: str) -> None:
        """Reports ``names`` as 0 until they count."""
        with self._lock:
            self._declared.update(dict.fromkeys(names, 0))

    def timed(self, name: str, counted: str | None = None) -> _Timer:
        """``with timed("engine.capture_s", "engine.captures") as t:``
        adds the block's host seconds to ``name`` and 1 to ``counted``."""
        return _Timer(self, name, counted)

    def records(self) -> list:
        """The closed spans in the order they opened: ``(name, parent,
        step, start_ns, end_ns)``, ``parent`` an index into this list (-1:
        none, or no longer kept)."""
        kept = sorted(self._records)
        at = {r[0]: i for i, r in enumerate(kept)}
        return [(name, at.get(parent, -1), step, start, end)
                for _, name, parent, step, start, end in kept]

    def counters(self) -> dict:
        """Every counter, the declared ones that have not counted at 0."""
        with self._lock:
            return {**self._declared, **self._counters}

    def reset(self) -> None:
        """Forget every span and count (the declared names stay)."""
        self._records.clear()
        with self._lock:
            self._counters.clear()


def summary(recs: list, since: int = 0) -> dict:
    """``{name: {calls, total_ms, self_ms}}`` over ``recs[since:]``
    (:func:`records`), a span's self time its duration less its children's
    (spans on the same thread)."""
    dur = [end - start for *_, start, end in recs]
    own = list(dur)
    for i, (_, parent, *_) in enumerate(recs):
        if parent >= 0:
            own[parent] -= dur[i]
    out = {}
    for i in range(since, len(recs)):
        row = out.setdefault(recs[i][0], [0, 0, 0])
        row[0] += 1
        row[1] += dur[i]
        row[2] += own[i]
    return {name: {"calls": c, "total_ms": t / 1e6, "self_ms": s / 1e6}
            for name, (c, t, s) in out.items()}


TRACER = Tracer()
span = TRACER.span
count = TRACER.count
add = TRACER.add
declare = TRACER.declare
timed = TRACER.timed
records = TRACER.records
counters = TRACER.counters
reset = TRACER.reset
