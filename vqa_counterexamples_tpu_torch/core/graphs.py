"""Steps as captured CUDA graphs: the port's counterpart of a step that the
JAX package compiles to one dispatch with ``jax.jit``.

A step is written once, as ``body(inputs, *tables) -> {name: 0-d
tensor}`` over input buffers that do not move.  :class:`GraphedStep` runs
it:

- the inputs (a batch's host arrays, ``n_valid``, or tensors already on
  the card) are copied into device buffers that belong to the step
  (:class:`StaticInputs`); host arrays go through pinned staging, one
  copy per dtype;
- the step's generators are reseeded on the host from (seed, step)
  (``core/rng.StepGenerators``);
- on a CUDA device (the default there) the body is captured once per
  input layout and table set, as ``jit`` keeps one program per shape, and
  every call replays its graph; on the CPU, or with ``capture=False``,
  the body runs eagerly on the same buffers.

Capture follows PyTorch's whole-network recipe: a warm-up call on a side
stream (it also builds the kernels and sets their attributes), then one
capture of forward, backward and ``optimizer.step()`` on that stream.  The
warm-up does not train: the parameters, the optimizer's state and the
generators are snapshotted before it and restored bit for bit before the
capture, so the first replay is the first step.  A capture that fails
raises with its CUDA error; there is no eager fallback on a card.

Under a mesh (``parallel/``) a step's body runs collectives (the
gradients' all-reduce).  NCCL's collectives are captured in the graph: the
eager warm-up creates the communicator before the capture.  Gloo's cannot
be captured: a step under a gloo mesh runs eagerly (``capture=True`` is
refused there), and :attr:`GraphedStep.eager_reason` says why.  While a
process group exists, every capture (a step's with or without a mesh)
runs in thread-local mode (:func:`capture_kwargs`): NCCL's watchdog
thread polls the events of its collectives, and the global mode would
count those polls against the capture.

A graph holds the addresses of the parameters and of the optimizer's
state.  Before each replay the step compares them with those it captured
and captures again where one moved (``Optimizer.load_state_dict``
replaces the state tensors): a graph never reads freed state.  Parameters
loaded with ``Module.load_state_dict`` are copied in place and keep their
addresses.

Kernel launch counts: a kernel wrapper counts its Python calls in
``core/spans`` (``kernels.launches.<name>``), and a replay makes none.
Every capture (:meth:`_Graphed._capture_graph`) keeps those counters'
increase over the capture with its graph, puts them back as they were
before the warm-up (neither runs a step that is kept) and adds the
increase at every replay, so they count the launches the calls executed.

Under a profiler a step's call is the span ``engine.step`` (``core/spans``)
with its parts in order: ``engine.stage`` (the inputs' copies),
``engine.check`` (the addresses), ``engine.capture`` (a first call or a
recapture, warm-up included), ``engine.reseed``, ``engine.replay`` (with
its launch counts) and ``engine.outputs``; eagerly ``engine.stage``,
``engine.reseed`` and ``engine.eager`` (the body).  Every capture, of a
step or of a :class:`GraphedCall`, counts in ``engine.captures`` and its
host seconds in ``engine.capture_s``.
"""

from __future__ import annotations

import contextlib
import gc
import threading
from dataclasses import dataclass

import numpy as np
import torch

from . import spans

# pinned staging buffers a step's inputs rotate through
_STAGING_SLOTS = 2


def _launches() -> dict:
    """The counters a capture rolls back and a replay advances."""
    return {k: n for k, n in spans.counters().items()
            if k.startswith("kernels.launches.")}


def input_layout(inputs: dict) -> tuple:
    """``(name, shape, dtype, on_card)`` of each input: the key of a step's
    buffers and graphs.  A tensor on a CUDA device is copied on the card;
    anything else is a host array."""
    out = []
    for name, v in inputs.items():
        if isinstance(v, torch.Tensor) and v.is_cuda:
            out.append((name, tuple(v.shape), v.dtype, True))
        else:
            a = _host_array(v)
            out.append((name, a.shape, a.dtype, False))
    return tuple(out)


def _host_array(v) -> np.ndarray:
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


class StaticInputs:
    """A step's inputs in device buffers that keep their addresses.

    Host arrays of one dtype share one flat device buffer, filled by one
    ``copy_`` from one of ``_STAGING_SLOTS`` pinned staging buffers on the
    current stream; a staging buffer is written again only after the copy that
    read it has finished (an event per slot).  Inputs already on the card
    are copied into a buffer of their own.  On the CPU the host arrays are
    written straight into the buffers."""

    def __init__(self, layout: tuple, device):
        device = torch.device(device)
        self.staged = device.type == "cuda"
        self.tensors = {}
        self._on_card = []
        self._groups = []   # (flat buffer, staging buffers, [(name, views)])
        by_dtype = {}
        for name, shape, dtype, on_card in layout:
            if on_card:
                self.tensors[name] = torch.empty(shape, dtype=dtype,
                                                 device=device)
                self._on_card.append(name)
            else:
                by_dtype.setdefault(dtype, []).append((name, shape))
        for dtype, fields in by_dtype.items():
            sizes = [int(np.prod(shape)) for _, shape in fields]
            tdtype = torch.from_numpy(np.empty(0, dtype)).dtype
            flat = torch.empty(sum(sizes), dtype=tdtype, device=device)
            stages = ([torch.empty(sum(sizes), dtype=tdtype, pin_memory=True)
                       for _ in range(_STAGING_SLOTS)]
                      if self.staged else [flat])
            views = []
            offset = 0
            for (name, shape), size in zip(fields, sizes):
                self.tensors[name] = flat[offset:offset + size].view(shape)
                views.append((name, [s.numpy()[offset:offset + size].reshape(
                    shape) for s in stages]))
                offset += size
            self._groups.append((flat, stages, views))
        self._events = ([torch.cuda.Event()
                         for _ in range(_STAGING_SLOTS)]
                        if self.staged else [])
        self._slot = 0

    def load(self, inputs: dict) -> None:
        """Copy ``inputs`` (of this layout) into the buffers, on the
        current stream."""
        slot = self._slot
        if self.staged:
            self._slot = (slot + 1) % len(self._events)
            self._events[slot].synchronize()
        for flat, stages, views in self._groups:
            for name, per_slot in views:
                np.copyto(per_slot[slot], _host_array(inputs[name]))
            if self.staged:
                flat.copy_(stages[slot], non_blocking=True)
        if self.staged:
            self._events[slot].record()
        for name in self._on_card:
            self.tensors[name].copy_(inputs[name])


def capture_kwargs(meshed: bool = False) -> dict:
    """``torch.cuda.graph``'s error mode: ``thread_local`` for a meshed
    step or while a process group exists (NCCL's watchdog thread polls its
    collectives' events meanwhile, which only this thread's capture must
    not see), else the default (global)."""
    import torch.distributed as dist

    if meshed or (dist.is_available() and dist.is_initialized()):
        return {"capture_error_mode": "thread_local"}
    return {}


def _table_key(t):
    if t is None:
        return None
    return (t.data_ptr(), tuple(t.shape), tuple(t.stride()), t.dtype)


class _Snapshot:
    """The trainable parameters, the optimizer's state and the generators'
    states, restored bit for bit by :meth:`restore`, which also drops the
    gradients.  A state tensor that did not exist at the snapshot (Adam
    creates its state at its first step) is zeroed, which is what the
    optimizer's lazy init holds."""

    def __init__(self, optimizer, generators):
        self.optimizer = optimizer
        self.params = ([p for g in optimizer.param_groups
                        for p in g["params"]] if optimizer else [])
        with torch.no_grad():
            self.values = [p.detach().clone() for p in self.params]
            self.state = [{k: v.clone() for k, v in
                           optimizer.state.get(p, {}).items()}
                          for p in self.params]
        self.gens = [(g, g.get_state()) for g in generators]

    def restore(self) -> None:
        with torch.no_grad():
            for p, v in zip(self.params, self.values):
                p.copy_(v)
            for p, saved in zip(self.params, self.state):
                for k, v in self.optimizer.state.get(p, {}).items():
                    if k in saved:
                        v.copy_(saved[k])
                    else:
                        v.zero_()
        for g, s in self.gens:
            g.set_state(s)
        if self.optimizer is not None:
            self.optimizer.zero_grad(set_to_none=True)


@dataclass
class _Captured:
    graph: object
    out: object        # what the captured call returned
    launches: dict     # the launch counts a replay adds

    def replay(self) -> None:
        self.graph.replay()
        spans.add(self.launches)


class _Graphed:
    """What :class:`GraphedStep` and :class:`GraphedCall` share, the one
    capture routine among it."""

    def __init__(self, body, device, capture):
        self.body = body
        self.device = torch.device(device)
        self.capture = (self.device.type == "cuda" if capture is None
                        else bool(capture))
        if self.capture and self.device.type != "cuda":
            raise ValueError("a CUDA graph needs a CUDA device, got %s"
                             % self.device)
        self._inputs = {}     # layout -> StaticInputs
        self._graphs = {}     # key -> _Captured
        self._stream = None

    @property
    def n_graphs(self) -> int:
        return len(self._graphs)

    def _load(self, layout, inputs) -> StaticInputs:
        static = self._inputs.get(layout)
        if static is None:
            static = self._inputs[layout] = StaticInputs(layout, self.device)
        static.load(inputs)
        return static

    def _capture_graph(self, run, between=None, generators=(),
                       **kwargs) -> _Captured:
        """``run()`` on the side stream as the warm-up (it builds kernels
        and plans), ``between()``, then ``run()`` captured there with
        ``generators`` registered (``kwargs``: ``torch.cuda.graph``'s);
        the launch counters as in the module docstring."""
        current = torch.cuda.current_stream(self.device)
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        stream = self._stream
        before = _launches()
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            run()
        current.wait_stream(stream)
        if between is not None:
            between()
        warm = _launches()
        graph = torch.cuda.CUDAGraph()
        for gen in generators:
            graph.register_generator_state(gen)
        # no collection inside the capture: one could destroy another
        # graph held in a dead reference cycle (a served engine's), and a
        # graph destroyed while a global-mode capture runs invalidates it
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, stream=stream, **kwargs):
                out = run()
        finally:
            if collecting:
                gc.enable()
        after = _launches()
        spans.add({k: before.get(k, 0) - n for k, n in after.items()})
        return _Captured(graph, out, {k: n - warm.get(k, 0)
                                      for k, n in after.items()
                                      if n != warm.get(k, 0)})


class GraphedStep(_Graphed):
    """``body`` run as described in the module docstring.

    ``generators``: a ``core/rng.StepGenerators`` the body draws from,
    reseeded from (``seed``, ``step``) before every call and registered
    with every graph.  ``optimizer``: the optimizer the body steps (its
    parameters and state are snapshotted around the warm-up and their
    addresses checked before each replay); None for a step that trains
    nothing.  ``capture``: None captures on a CUDA device and runs eagerly
    elsewhere.  ``mesh``: the ``parallel.Mesh`` whose collectives the body
    runs, or None."""

    def __init__(self, body, device, *, generators=None, optimizer=None,
                 capture=None, mesh=None):
        gloo = mesh is not None and mesh.backend == "gloo"
        if gloo and capture:
            raise ValueError("a step under a gloo mesh cannot be captured: "
                             "gloo's collectives run on the host (build it "
                             "with capture=False, or use NCCL)")
        super().__init__(body, device, False if gloo else capture)
        self.generators = generators
        self.optimizer = optimizer
        self.eager_reason = ("gloo's collectives cannot be captured"
                             if gloo and self.device.type == "cuda" else None)
        self.meshed = mesh is not None
        self._addresses = None   # of the state the graphs read

    def __call__(self, inputs: dict, tables=(), *, seed: int = 0,
                 step: int = 0) -> dict:
        with spans.span("engine.step", step):
            return self._run(inputs, tables, seed, step)

    def _run(self, inputs, tables, seed, step) -> dict:
        with spans.span("engine.stage"):
            layout = input_layout(inputs)
            static = self._load(layout, inputs)
        if not self.capture:
            with spans.span("engine.reseed"):
                self._reseed(seed, step)
            with spans.span("engine.eager"):
                return self.body(static.tensors, *tables)
        with spans.span("engine.check"):
            if (self._addresses is not None
                    and self._addresses != self._state_addresses()):
                self._graphs.clear()
        key = (layout, tuple(_table_key(t) for t in tables))
        entry = self._graphs.get(key)
        if entry is None:
            with spans.span("engine.capture"), spans.timed(
                    "engine.capture_s", "engine.captures"):
                entry = self._graphs[key] = self._capture(static, tables,
                                                          seed, step)
                self._addresses = self._state_addresses()
        with spans.span("engine.reseed"):
            self._reseed(seed, step)
        with spans.span("engine.replay"):
            entry.replay()
        with spans.span("engine.outputs"):
            names, packed = entry.out
            return dict(zip(names, packed.clone().unbind()))

    def _reseed(self, seed, step) -> None:
        if self.generators is not None:
            self.generators.reseed(seed, step)

    def _state_addresses(self) -> tuple:
        if self.optimizer is None:
            return ()
        out = []
        for group in self.optimizer.param_groups:
            for p in group["params"]:
                out.append(p.data_ptr())
                out.extend(v.data_ptr() for v in
                           self.optimizer.state.get(p, {}).values())
        return tuple(out)

    def _capture(self, static, tables, seed, step) -> _Captured:
        gens = tuple(self.generators.values()) if self.generators else ()
        saved = _Snapshot(self.optimizer, gens)
        self._reseed(seed, step)

        def run():
            out = self.body(static.tensors, *tables)
            return tuple(out), torch.stack([out[n].float() for n in out])

        return self._capture_graph(run, saved.restore, gens,
                                   **capture_kwargs(self.meshed))


class GraphedCall(_Graphed):
    """A forward-only sibling of :class:`GraphedStep` for serving:
    ``body(inputs) -> {name: tensor}`` (tensors of any shape), no optimizer,
    no generators.

    On a CUDA device (``capture`` None or True) each input layout gets one
    graph, captured at its first call after a warm-up on a side stream (as
    ``jax.jit`` compiles one program per shape); every later call copies
    its inputs into the layout's static buffers, replays, and returns
    clones of the graph's outputs, so a caller's results outlive the next
    replay.  On the CPU, or with ``capture=False``, the body runs eagerly
    on the same buffers.

    Calls may come from many threads at once.  A lock per layout covers
    fill, replay (or the eager body) and copy-out.  On a card one more
    lock covers each call's device work (its buffers' allocation, the
    fill, the replay and the copy-out, or a capture with its warm-up), so
    a capture never runs beside another thread's allocations, copies or
    replays (with them beside it, a capture in a concurrent prewarm of
    four buckets was once invalidated on an H100).  Captures run in
    ``thread_local`` error mode.  :meth:`exclusive` holds every layout's
    lock: an in-place weight update under it waits for in-flight calls
    and is read by every later replay, since a graph reads the parameters
    by address and never copies them."""

    def __init__(self, body, device, *, capture=None):
        super().__init__(body, device, capture)
        self._locks = {}      # layout -> threading.Lock
        self._guard = threading.Lock()        # the dicts
        # a call's device work on a card; captures exclude the rest
        self._device_lock = (threading.Lock() if self.capture
                             else contextlib.nullcontext())

    def _lock(self, layout):
        with self._guard:
            return self._locks.setdefault(layout, threading.Lock())

    @contextlib.contextmanager
    def exclusive(self):
        """Hold every layout's lock (in a fixed order) and the guard that
        creates them; on a card, the device is synchronized before they
        are released."""
        # holding the guard too: no call on a new layout starts meanwhile
        with self._guard, contextlib.ExitStack() as stack:
            for key in sorted(self._locks, key=repr):
                stack.enter_context(self._locks[key])
            yield
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    def __call__(self, inputs: dict) -> dict:
        layout = input_layout(inputs)
        with self._lock(layout), self._device_lock:
            static = self._load(layout, inputs)
            if not self.capture:
                return self.body(static.tensors)
            entry = self._graphs.get(layout)
            if entry is None:
                with spans.timed("engine.capture_s", "engine.captures"):
                    entry = self._graphs[layout] = self._capture_graph(
                        lambda: self.body(static.tensors),
                        capture_error_mode="thread_local")
            entry.replay()
            return {k: v.clone() for k, v in entry.out.items()}
