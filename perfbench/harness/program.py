"""Wrappers the benchmark puts around the port's own calls: they time and
observe, and change nothing the port computes.

- ``Watched``: a train step that, on its first ``n`` calls, keeps what the
  check compares: each step's loss, each leaf's first gradient as Adam
  holds it after step 1 (``exp_avg / (1 - beta1)``, copied before step 2
  runs) and each leaf's change after step n, read before step n + 1
  runs.  With ``stop_after`` set, a call past it raises ``WindowOver``
  before it runs (set-up's epoch ends after the checked steps).
  Afterwards it records a step event per call and keeps each step's loss
  tensor (for ``failed``).
- ``Feed``: the loader handed to the engine: the port's own batches,
  epoch after epoch, stopping at a batch boundary once the window's time
  is up; it times each ``next()`` (the ``data`` span).
"""

from __future__ import annotations

import time

import torch


class WindowOver(Exception):
    """Raised by a watched step past its ``deadline`` or its
    ``stop_after``: a traced window ends there, mid-epoch, so that its
    trace stays small, and so does set-up's epoch after the checked
    steps."""


class Watched:
    def __init__(self, fn, optimizer, named_params, start: dict,
                 n_checked: int = 3, clock=None):
        self.fn = fn
        self.optimizer = optimizer
        self.named = list(named_params)
        self.start = start
        self.n_checked = n_checked
        self.clock = clock
        self.calls = 0
        self.losses = []          # the checked steps' loss tensors
        self.grads = None         # {leaf: the first gradient, on the card}
        self.change_norms = None
        self.window_losses = []   # every timed step's loss tensor
        self.deadline = None      # seconds into a traced window
        self.stop_after = None    # calls, outside the window

    def __call__(self, *args, **kwargs):
        if self.clock is None:
            if self.stop_after is not None and self.calls >= self.stop_after:
                raise WindowOver()
            return self._checked(*args, **kwargs)
        if self.deadline is not None and self.clock.elapsed() >= self.deadline:
            raise WindowOver()
        with self.clock.label("step"):
            state, metrics = self.fn(*args, **kwargs)
            self.clock.step()
        self.window_losses.append(metrics["loss"])
        return state, metrics

    def _checked(self, *args, **kwargs):
        state, metrics = self.fn(*args, **kwargs)
        self.calls += 1
        if self.calls > self.n_checked:
            return state, metrics
        self.losses.append(metrics["loss"].detach().float().clone())
        if self.calls == 1:
            beta1 = self.optimizer.param_groups[0]["betas"][0]
            self.grads = {
                name: self.optimizer.state[p]["exp_avg"].detach().float()
                / (1 - beta1) for name, p in self.named}
        if self.calls == self.n_checked:
            self.change_norms = {
                name: torch.linalg.vector_norm(
                    (p.detach() - self.start[name]).double())
                for name, p in self.named}
        return state, metrics

    def readings(self) -> dict:
        """The checked steps' numbers as floats, and the first gradient."""
        grads = self.grads or {}
        return {"losses": [float(x) for x in self.losses],
                "grads": grads,
                "grad_norms": {k: float(torch.linalg.vector_norm(v.double()))
                               for k, v in grads.items()},
                "change_norms": {k: float(v) for k, v in
                                 (self.change_norms or {}).items()}}

    def failed_steps(self) -> int:
        if not self.window_losses:
            return 0
        return int((~torch.isfinite(torch.stack(
            [x.float() for x in self.window_losses]))).sum())


class Timed:
    """An eval step: a step event per call, its outputs kept."""

    def __init__(self, fn, clock):
        self.fn, self.clock = fn, clock
        self.losses = []

    def __call__(self, batch):
        with self.clock.label("step"):
            out = self.fn(batch)
            self.clock.step()
        self.losses.append(out["loss"])
        return out

    def failed_steps(self) -> int:
        if not self.losses:
            return 0
        return int((~torch.isfinite(torch.stack(
            [x.float() for x in self.losses]))).sum())


class Feed:
    """Batches from ``make_epoch()`` (a fresh generator of one epoch's
    batches), handed out across calls of :meth:`take`: set-up takes the
    first few, the window the rest, and an epoch's generator carries on
    from one call to the next."""

    def __init__(self, make_epoch, on_batch=None):
        self.make_epoch = make_epoch
        self.on_batch = on_batch
        self.current = None
        self.data_s = 0.0
        self.data_n = 0

    def take(self, n: int | None = None, clock=None,
             seconds: float | None = None):
        """Yield up to ``n`` batches, or until ``clock`` has run
        ``seconds``, or to the end of the current epoch."""
        if self.current is None:
            self.current = self.make_epoch()
        got = 0
        while n is None or got < n:
            if clock is not None and clock.elapsed() >= seconds:
                return
            t = time.perf_counter()
            label = clock.label("data") if clock is not None else None
            try:
                if label is None:
                    batch = next(self.current)
                else:
                    with label:
                        batch = next(self.current)
            except StopIteration:
                self.current = None
                return
            if clock is not None:
                self.data_s += time.perf_counter() - t
                self.data_n += 1
            if self.on_batch is not None:
                self.on_batch(batch)
            got += 1
            yield batch
