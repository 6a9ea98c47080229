"""Batches and corpora split over the ranks, and the ranks' start-up (port
of ``parallel/sharding.py``).

- :func:`shard_batch`: this rank's rows of a host batch.  Every rank
  builds the same global batch from the same numpy generator (JAX's
  multi-host rule) and rank (d, m) takes rows ``[d B/D, (d+1) B/D)``.
- :func:`corpus_rows`: the row range of each shard of an N-row corpus;
  shards may be uneven (the first ``N % P`` hold one row more).
- :func:`replicated`: rank 0's parameters on every rank.
- :func:`gather_rows`: every rank's rows of a split array, in row order,
  on every rank.
- The ranks' start-up.  ``--mesh data=N[,model=M]`` alone starts one
  worker process per rank on this host (:func:`spawn`, ``spawn`` mode:
  CUDA forbids ``fork``); each re-enters the CLI with ``--distributed``
  and torchrun's environment, which ``--distributed`` reads
  (:func:`mesh_from_env`).  Rank r uses ``cuda:(LOCAL_RANK % cards)``.
  The backend is NCCL on the card and gloo on the CPU; ranks that would
  share a card raise unless ``--dist_backend gloo`` is given, and nothing
  switches backend or device on its own.  Only rank 0 prints.
"""

from __future__ import annotations

import contextlib
import importlib
import os
import pickle
import socket
import sys
import tempfile
import traceback
from datetime import timedelta

import numpy as np
import torch

from .mesh import Mesh, make_mesh, mesh_size, parse_mesh

# seconds a collective (and the rendezvous) may wait before it fails
TIMEOUT_ENV = "VQACX_DIST_TIMEOUT"
_DEFAULT_TIMEOUT_S = 1800


def shard_batch(batch: dict, mesh: Mesh, axis: str = "data") -> dict:
    """This rank's rows of every array (numpy or tensor) of ``batch``,
    split evenly on the leading axis over ``axis`` (a batch that does not
    divide raises ``ValueError``)."""
    n, parts = len(next(iter(batch.values()))), mesh.size(axis)
    if n % parts:
        raise ValueError("a batch of %d rows does not divide over %s=%d"
                         % (n, axis, parts))
    lo = mesh.index(axis) * (n // parts)
    return {k: v[lo:lo + n // parts] for k, v in batch.items()}


def corpus_rows(n: int, parts: int) -> list:
    """``[(start, stop)]`` of the ``parts`` shards of ``n`` rows, in order:
    ``np.array_split``'s split (the first ``n % parts`` one row longer)."""
    base, extra = divmod(n, parts)
    out, start = [], 0
    for p in range(parts):
        stop = start + base + (p < extra)
        out.append((start, stop))
        start = stop
    return out


def replicated(module: torch.nn.Module, mesh: Mesh | None
               ) -> torch.nn.Module:
    """Rank 0's parameters and buffers on every rank, in place."""
    if mesh is not None and mesh.world_size > 1:
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                mesh.broadcast(t.data)
    return module


def gather_rows(local: torch.Tensor, start: int, n: int, mesh: Mesh,
                axis: str = "data") -> torch.Tensor:
    """The ``n``-row array whose rows ``[start, start + len(local))`` this
    rank holds, with every other rank of ``axis`` holding the rest: a
    zero-filled buffer, this rank's slot filled, all-reduced (each row
    comes from one rank, so the sum is exact)."""
    out = local.new_zeros((n,) + tuple(local.shape[1:]))
    out[start:start + local.shape[0]] = local
    return mesh.all_reduce(out, axis)


def batch_split(mesh: Mesh | None, n_local: int):
    """``(row0, draws)`` for this rank's ``n_local`` rows of an even split
    of the batch: the global index of its first row and the context in
    which the random draws are made at the global batch's shape
    (``core/rng.global_batch``); ``(0, a no-op)`` with no mesh."""
    from ..core import rng

    if mesh is None:
        return 0, contextlib.nullcontext()
    row0 = mesh.index("data") * n_local
    return row0, rng.global_batch(n_local * mesh.size("data"), row0,
                                  n_local)


def report_eager(run, what: str, mesh: Mesh) -> None:
    """Print, on rank 0, that the step ``run`` (a ``core/graphs``
    ``GraphedStep``) runs eagerly under this mesh, and why."""
    if run.eager_reason and mesh.is_main:
        print("=> %s runs eagerly on the card: %s" % (what, run.eager_reason))


def all_reduce_grads(optimizer, mesh: Mesh, metrics=()) -> tuple:
    """Sum the gradients of ``optimizer``'s parameters and the 0-d
    ``metrics`` over the data group, in one all-reduce of their
    concatenation; the gradients are written back in place.  Returns the
    summed metrics."""
    grads = [p.grad for g in optimizer.param_groups for p in g["params"]
             if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [m.reshape(1).to(grads[0].dtype) for m in metrics])
    mesh.all_reduce(flat, "data")
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
    return tuple(flat[offset:].unbind())


# ---------------------------------------------------------------- start-up

def add_distributed_flag(parser) -> None:
    """``--distributed`` and ``--dist_backend`` on a CLI."""
    parser.add_argument("--distributed", action="store_true",
                        help="run as one rank of a torchrun launch: RANK, "
                             "WORLD_SIZE, LOCAL_RANK and MASTER_ADDR/PORT "
                             "come from the environment; the --mesh axes "
                             "(default data=WORLD_SIZE) must multiply to "
                             "WORLD_SIZE")
    parser.add_argument("--dist_backend", default=None,
                        choices=["nccl", "gloo"],
                        help="the ranks' transport (default: nccl on the "
                             "card, gloo on the CPU); gloo lets ranks share "
                             "a card and runs the steps eagerly")


def _timeout() -> timedelta:
    return timedelta(seconds=float(os.environ.get(TIMEOUT_ENV,
                                                  _DEFAULT_TIMEOUT_S)))


def _env_int(name: str) -> int:
    try:
        return int(os.environ[name])
    except KeyError:
        raise ValueError("--distributed reads torchrun's environment: %s is "
                         "not set" % name) from None


def resolve_backend(device_type: str, backend: str | None,
                    ranks_here: int) -> str:
    """The process backend for ``ranks_here`` ranks of this host on
    ``device_type``: NCCL on the card (one card a rank), gloo on the CPU;
    ranks that would share a card need ``backend='gloo'``."""
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is visible: the port runs on "
                               "the card; pass --device cpu to run on the "
                               "CPU")
        backend = backend or "nccl"
        cards = torch.cuda.device_count()
        if backend == "nccl" and ranks_here > cards:
            raise ValueError(
                "%d ranks on this host would share %d card(s), which NCCL "
                "cannot run; pass --dist_backend gloo" % (ranks_here, cards))
        return backend
    if backend == "nccl":
        raise ValueError("NCCL runs on CUDA devices: use gloo (the "
                         "default) on the CPU")
    return "gloo"


@contextlib.contextmanager
def mesh_from_env(axes: dict | None = None, device="cuda",
                  backend: str | None = None):
    """This rank's :class:`Mesh` from torchrun's environment; the default
    process group is created here (unless one exists) and destroyed on
    exit.  ``axes`` defaults to ``{'data': WORLD_SIZE}``."""
    import torch.distributed as dist

    rank, world = _env_int("RANK"), _env_int("WORLD_SIZE")
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    axes = dict(axes or {"data": world})
    if mesh_size(axes) != world:
        raise ValueError("mesh %r has %d ranks, WORLD_SIZE is %d"
                         % (axes, mesh_size(axes), world))
    device = torch.device(device)
    backend = resolve_backend(device.type, backend, int(
        os.environ.get("LOCAL_WORLD_SIZE", world)))
    if device.type == "cuda":
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:   # the host's cores shared out, not each rank taking them all
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
            os.environ.get("LOCAL_WORLD_SIZE", world))))
    owned = not dist.is_initialized()
    if owned:
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=world, timeout=_timeout())
    try:
        yield make_mesh(axes, device)
    finally:
        if owned:
            dist.destroy_process_group()


def run(body, args, argv, entry):
    """Run a CLI's ``body(args, mesh)``: with no ``--mesh`` and no
    ``--distributed`` as it is (``mesh`` None); with ``--mesh`` alone in
    one spawned worker per rank, each re-entering ``entry`` (the CLI's
    ``main``) with ``--distributed`` (returns rank 0's result); with
    ``--distributed`` as this rank, only rank 0 printing."""
    mesh_spec = getattr(args, "mesh", None)
    if not mesh_spec and not args.distributed:
        return body(args, None)
    axes = parse_mesh(mesh_spec)
    if not args.distributed:
        argv = list(sys.argv[1:] if argv is None else argv)
        world = mesh_size(axes)
        device = torch.device(args.device)
        resolve_backend(device.type, args.dist_backend, world)
        return spawn(_cli_rank, (_module_name(entry), argv
                                 + ["--distributed"]), world=world)
    with mesh_from_env(axes, args.device, args.dist_backend) as mesh:
        quiet = None if mesh.is_main else open(os.devnull, "w")
        with contextlib.redirect_stdout(quiet) if quiet else \
                contextlib.nullcontext():
            try:
                return body(args, mesh)
            finally:
                if quiet:
                    quiet.close()


def _module_name(fn) -> str:
    module = sys.modules[fn.__module__]
    spec = getattr(module, "__spec__", None)
    return spec.name if spec is not None else fn.__module__


def _cli_rank(module: str, argv: list):
    return importlib.import_module(module).main(argv)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, fn_args, env, out_dir):
    """A spawned rank: torchrun's environment, then ``fn(*fn_args)``; rank
    0's result (``torch.save``d, or None where it does not pickle) and any
    rank's exception go to ``out_dir``."""
    os.environ.update(env)
    os.environ["RANK"] = os.environ["LOCAL_RANK"] = str(rank)
    path = os.path.join(out_dir, "rank%d.pkl" % rank)
    try:
        result = fn(*fn_args)
    except BaseException as exc:
        with open(path, "wb") as f:
            try:
                pickle.dump(("error", exc), f)
            except (pickle.PicklingError, TypeError, AttributeError):
                f.seek(0)
                f.truncate()
                pickle.dump(("error", RuntimeError(
                    traceback.format_exc())), f)
        raise
    if rank == 0:
        with open(path, "wb") as f:
            try:
                torch.save(("ok", result), f)
            except (pickle.PicklingError, TypeError, AttributeError):
                f.seek(0)
                f.truncate()
                torch.save(("ok", None), f)


def spawn(fn, fn_args=(), *, world: int, timeout: float | None = None):
    """Run ``fn(*fn_args)`` in ``world`` spawned processes on this host,
    each with torchrun's environment for its rank (they meet on
    localhost), and return rank 0's result, its tensors on the CPU.  When
    a rank fails, the others are stopped and the lowest failing rank's
    exception is raised here; past ``timeout`` seconds every rank is
    stopped and ``TimeoutError`` raised."""
    import time

    import torch.multiprocessing as mp

    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port()),
           "WORLD_SIZE": str(world), "LOCAL_WORLD_SIZE": str(world)}
    with tempfile.TemporaryDirectory() as out_dir:
        ctx = mp.start_processes(_rank_main, (fn, fn_args, env, out_dir),
                                 nprocs=world, join=False,
                                 start_method="spawn")
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while not ctx.join(None if deadline is None else max(
                    deadline - time.monotonic(), 0.0)):
                if deadline is not None and time.monotonic() >= deadline:
                    for p in ctx.processes:
                        p.kill()
                    for p in ctx.processes:
                        p.join()
                    raise TimeoutError("%d ranks ran past %.0f s"
                                       % (world, timeout))
        except (mp.ProcessRaisedException, mp.ProcessExitedException) \
                as failure:
            for rank in range(world):
                path = os.path.join(out_dir, "rank%d.pkl" % rank)
                if os.path.exists(path) and os.path.getsize(path):
                    with open(path, "rb") as f:
                        kind, value = pickle.load(f)
                    if kind == "error":
                        raise value from failure
            raise
        return torch.load(os.path.join(out_dir, "rank0.pkl"),
                          map_location="cpu", weights_only=False)[1]
