"""Row gather from a corpus whose rows are sharded over a mesh axis (port
of ``parallel/gather.py``).

Each rank holds one contiguous row range of the (N, D) matrix
(``sharding.corpus_rows``) and every rank of the axis asks for the same
global row indices: each takes the rows that fall in its shard (a masked
local ``index_select``) and one ``all_reduce(SUM)`` over the axis
assembles them.  Each row comes from exactly one shard and the others add
zeros, so the result equals a plain take bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .mesh import Mesh


class RowShard(NamedTuple):
    """This rank's rows ``[start, start + len(rows))`` of a corpus
    row-sharded over the 'model' axis (``shard_rows``)."""
    rows: torch.Tensor
    start: int


def shard_rows(table: torch.Tensor, mesh: Mesh, axis: str = "model"
               ) -> RowShard:
    """This rank's :class:`RowShard` of ``table`` (a copy, so the full
    table can be freed): ``sharding.corpus_rows``' split over ``axis``."""
    from .sharding import corpus_rows

    start, stop = corpus_rows(table.shape[0], mesh.size(axis))[
        mesh.index(axis)]
    return RowShard(table[start:stop].clone(), start)


def sharded_gather(features_shard: torch.Tensor, indices: torch.Tensor,
                   mesh: Mesh, axis: str = "model",
                   row_start=None) -> torch.Tensor:
    """``features_shard`` (n_local, ...) this rank's rows of the corpus,
    ``indices`` (...) global row ids, the same on every rank of ``axis``
    -> (..., *row shape), the same on every rank.  ``row_start``: the
    global index of the shard's first row, an int or a 0-d device tensor
    (default: an even split, ``index(axis) * n_local``)."""
    n_local = features_shard.shape[0]
    if row_start is None:
        row_start = mesh.index(axis) * n_local
    local = indices.long() - row_start
    mine = (local >= 0) & (local < n_local)
    safe = torch.where(mine, local, torch.zeros_like(local))
    rows = features_shard.index_select(0, safe.reshape(-1)).reshape(
        tuple(indices.shape) + tuple(features_shard.shape[1:]))
    keep = mine.reshape(tuple(mine.shape) + (1,) * (features_shard.dim() - 1))
    rows = torch.where(keep, rows, torch.zeros((), dtype=rows.dtype,
                                               device=rows.device))
    return _sum_bits(rows, mesh, axis)


def _sum_bits(rows: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """All-reduce ``rows`` summed as integers of their own width (bf16 in
    pairs), so a -0.0 meeting the other shards' zeros keeps its sign."""
    width = rows.element_size()
    if rows.dim() and (width == 4 or (width == 2 and rows.shape[-1] % 2
                                      == 0)):
        mesh.all_reduce(rows.view(torch.int32), axis)
    elif width == 8:
        mesh.all_reduce(rows.view(torch.int64), axis)
    else:
        mesh.all_reduce(rows, axis)
    return rows
