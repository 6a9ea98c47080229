"""Ranks laid out on a named mesh (port of ``parallel/mesh.py``).

The JAX package lays its devices on a ``jax.sharding.Mesh`` with a 'data'
axis that carries the batch and a 'model' axis that row-shards the feature
corpus; XLA then inserts the gradient all-reduce.  The port runs one
process per rank (``torch.distributed``) and writes those collectives out.
With axes ``{data: D, model: M}``, rank ``r = d * M + m``, as
``make_mesh`` reshapes JAX's device list:

- the *data group* holds the ranks with the same ``m`` (D of them): each
  takes its rows of the batch, and the gradients and metric sums are
  all-reduced over it;
- the *model group* holds the ranks with the same ``d`` (M of them): each
  keeps its row range of the feature corpus, and a gather by global row
  (``parallel/gather.py``) is all-reduced over it.

Every collective here is a ``broadcast`` or an ``all_reduce``, the two that
gloo carries for CUDA tensors as well as for CPU ones: an all-gather is an
all-reduce of a zero-filled buffer in which each rank fills its own slot.
An axis of one rank in a world of several has no group (its collectives
are no-ops); in a world of one rank the group is the world, so the
collectives still run (under NCCL they are captured in the step's graph).
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass, field

import numpy as np
import torch

AXES = ("data", "model")


def parse_mesh(spec: str | None) -> dict | None:
    """'data=8' or 'data=4,model=2' -> {'data': 8} / {'data': 4, 'model':
    2} (the CLIs' ``--mesh``); None for no spec.  Only the axes 'data' and
    'model' exist."""
    if not spec:
        return None
    axes = {}
    for part in spec.split(","):
        name, _, size = part.partition("=")
        name = name.strip()
        if name not in AXES:
            raise ValueError("mesh axis %r: the axes are %s" % (name, AXES))
        axes[name] = int(size)
        if axes[name] < 1:
            raise ValueError("mesh axis %s=%d: sizes start at 1"
                             % (name, axes[name]))
    return axes


def mesh_size(axes: dict) -> int:
    return int(np.prod(list(axes.values()), dtype=np.int64))


@dataclass(eq=False)
class Mesh:
    """This rank's place on the mesh: ``axes`` ({'data': D, 'model': M}),
    ``rank`` and ``world_size``, the rank's ``device``, the process
    ``backend`` ('nccl' or 'gloo') and the group of each axis (None where
    the axis needs no collective)."""
    axes: dict
    rank: int
    world_size: int
    device: torch.device
    backend: str
    groups: dict = field(default_factory=dict)

    def size(self, axis: str) -> int:
        return self.axes.get(axis, 1)

    def index(self, axis: str) -> int:
        """This rank's coordinate on ``axis``."""
        m = self.size("model")
        return self.rank // m if axis == "data" else self.rank % m

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def all_reduce(self, tensor: torch.Tensor, axis: str | None = "data"
                   ) -> torch.Tensor:
        """Sum ``tensor`` in place over the ranks of ``axis`` (None: every
        rank); returns it."""
        import torch.distributed as dist

        group = self.groups.get(axis) if axis is not None \
            else dist.group.WORLD
        if group is not None:
            dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=group)
        return tensor

    def broadcast(self, tensor: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``tensor`` on every rank, in place; returns it."""
        import torch.distributed as dist

        if self.world_size > 1:
            dist.broadcast(tensor, src=0)
        return tensor

    def barrier(self) -> None:
        """Every rank reaches this point before any goes on (an all-reduce
        of one element, waited for)."""
        flag = torch.ones(1, device=self.device)
        self.all_reduce(flag, None)
        float(flag[0])

    def broadcast_object(self, obj):
        """Rank 0's picklable ``obj`` on every rank (its pickle's length,
        then its bytes, each broadcast as a tensor)."""
        data = pickle.dumps(obj) if self.is_main else b""
        size = self.broadcast(torch.tensor([len(data)], dtype=torch.int64,
                                           device=self.device))
        buf = torch.zeros(int(size[0]), dtype=torch.uint8, device=self.device)
        if self.is_main:
            buf.copy_(torch.frombuffer(bytearray(data), dtype=torch.uint8))
        self.broadcast(buf)
        return pickle.loads(buf.cpu().numpy().tobytes())


def _axis_groups(axes: dict, world: int) -> dict:
    """The process group of each axis, created in one fixed order on every
    rank (``new_group`` is collective): the 'data' groups (one per m),
    then the 'model' groups (one per d)."""
    import torch.distributed as dist

    d_size, m_size = axes.get("data", 1), axes.get("model", 1)
    rank = dist.get_rank()
    layout = np.arange(world).reshape(d_size, m_size)
    groups = {}
    for axis, lines in (("data", layout.T), ("model", layout)):
        size = lines.shape[1]
        if size == world:
            groups[axis] = dist.group.WORLD
            continue
        groups[axis] = None
        if size == 1:
            continue
        for line in lines:
            group = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[axis] = group
    return groups


def make_mesh(axes: dict | None = None, device=None) -> Mesh:
    """This rank's :class:`Mesh` over the initialized default process
    group, e.g. ``make_mesh({'data': 4, 'model': 2})`` at world size 8;
    ``axes`` defaults to ``{'data': world_size}``.  ``device`` defaults to
    the current CUDA device under NCCL and the CPU under gloo."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(parallel/sharding.mesh_from_env)")
    world = dist.get_world_size()
    axes = dict(axes or {"data": world})
    for name in axes:
        if name not in AXES:
            raise ValueError("mesh axis %r: the axes are %s" % (name, AXES))
    if mesh_size(axes) != world:
        raise ValueError("mesh %r needs %d ranks, the world has %d"
                         % (axes, mesh_size(axes), world))
    backend = dist.get_backend()
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if backend == "nccl" else torch.device("cpu"))
    return Mesh(axes, dist.get_rank(), world, torch.device(device), backend,
                _axis_groups(axes, world))


def default_mesh(device=None) -> Mesh:
    """A 'data' mesh over every rank of the initialized process group."""
    return make_mesh(None, device)
