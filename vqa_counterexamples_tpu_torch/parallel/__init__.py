"""Data- and corpus-parallel runs over several ranks (port of
``parallel/``): the mesh (``mesh.py``), batch and corpus splits and the
ranks' start-up (``sharding.py``), and the gather by global row from a
row-sharded corpus (``gather.py``)."""

from .gather import RowShard, shard_rows, sharded_gather
from .mesh import Mesh, default_mesh, make_mesh, parse_mesh
from .sharding import (add_distributed_flag, corpus_rows, gather_rows,
                       mesh_from_env, replicated, run, shard_batch, spawn)


def dryrun_multichip(n_ranks: int) -> None:
    """One CX train step at tiny shapes on ``n_ranks`` gloo CPU ranks
    (spawned here), held against the same step on one rank: the loss
    within 1e-5 and every parameter within 1e-5 (sum order only); then
    ``sharded_gather`` and the sharded kNN against a plain take and the
    one-rank search, bit for bit.  The step updates with SGD, as JAX's test
    of its mesh step does (``tests/test_parallel.py``).  Prints
    ``dryrun_multichip(n): ok`` (the counterpart of the JAX package's
    ``__graft_entry__.py``)."""
    from . import dryrun

    single = dryrun.cx_step(None)
    ranked = spawn(dryrun.rank, (n_ranks,), world=n_ranks)
    dryrun.compare(single, ranked)
    print("dryrun_multichip(%d): ok" % n_ranks)
