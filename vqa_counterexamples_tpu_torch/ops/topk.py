"""Exact brute-force k-nearest-neighbour search (port of ``ops/topk.py``).

``knn`` drives query chunks against the whole corpus on one device: on the
card the fused distance + top-k kernel (``ops/cuda/knn_kernel.py``) by
default, ``engine="plain"`` its plain version (one f32 GEMM + ``topk``,
JAX's ``xla`` engine); on the CPU the plain version.  Distances ascend
euclidean, as sklearn's ``kneighbors`` (so index 0 is the query itself in a
self-kNN).  ``approx`` (the TPU's ``approx_max_k``) is not ported.

With a mesh each rank holds one row range of the corpus
(``parallel.corpus_rows``: shards may be uneven, nothing is padded) and
runs every query chunk against it through the same kernel; the P x k
candidates are then gathered (one all-reduce) and merged by distance,
ties to the lower global index (``lax.top_k``'s rule, which JAX's
shard-major merge gives).  The kernel selects by its split-TF32 score and
reports f32 distances, so a merge of distances alone could pick another
k-th neighbour, or order two equal distances another way, than the
one-rank search.  A query where that can happen (its k-th and (k+1)-th
merged candidates within ``_NEAR`` of each other relative to the scores'
magnitude, or equal distances from two shards in its list) is searched
again against the union of its candidates, gathered from their shards:
the kernel's own selection over a corpus that holds its k winners.  The
result then equals the one-rank search bit for bit, indices and
distances.
"""

from __future__ import annotations

import numpy as np
import torch

from .cuda import knn_kernel

ENGINES = ("cuda", "plain")

# a near tie at the merge's k-th place, relative to 2 |q|^2 + d^2 (the
# magnitude of the terms of the score): far wider than the split-TF32
# score's distance from the f32 one, so every query whose k winners a merge
# of distances could get wrong is searched again
_NEAR = 2.0 ** -18


def windows(n: int, chunk: int):
    """Full-``chunk``-size windows covering [0, n) (``ops/chunking``):
    (start, offset), ``offset`` leading rows of the window repeating the
    previous one (only the tail window, shifted back, overlaps)."""
    for i in range(0, n, chunk):
        s = min(i, max(n - chunk, 0))
        yield s, i - s


def knn(features, k: int = 25, queries=None, batch_size: int = 1024,
        engine: str = "cuda", approx: bool = False, mesh=None,
        device=None, mesh_axis: str = "data"):
    """k-NN of every query row against ``features`` (the corpus, (N, D));
    ``queries`` defaults to the corpus itself.  Arrays (numpy or tensors,
    f32 or bf16) go to ``device`` and are cast to f32 there: by default
    the corpus tensor's own device, else the card (as JAX's ``topk.knn``
    runs on the default device, the accelerator); with no CUDA device
    visible that default raises, and the CPU must be asked for with
    ``device="cpu"``.  The corpus's squared norms are computed once.
    ``mesh``: a ``parallel.Mesh`` whose ``mesh_axis`` ranks split the
    corpus rows (``device`` defaults to the mesh's); every rank returns
    the whole result.  Returns numpy (dist (Nq, k) f32, idx (Nq, k)
    int32)."""
    if approx:
        raise NotImplementedError("approximate top-k (the TPU's "
                                  "approx_max_k) is not ported (ROADMAP.md, "
                                  "Queue 1)")
    if device is None and mesh is not None:
        device = mesh.device
    if engine not in ENGINES:
        raise ValueError("engine %r: one of %s" % (engine, ENGINES))
    if device is None:
        if isinstance(features, torch.Tensor):
            device = features.device
        elif torch.cuda.is_available():
            device = torch.device("cuda")
        else:
            raise RuntimeError("no CUDA device is visible: the port runs on "
                               "the card; pass device=\"cpu\" to run on the "
                               "CPU")

    def to_dev(a):
        if not isinstance(a, torch.Tensor):
            from ..data.features import to_tensor
            a = to_tensor(np.asarray(a))
        return a.to(device).float().contiguous()

    corpus = to_dev(features)
    qs = corpus if queries is None else to_dev(queries)
    chunk_fn = (knn_kernel.knn_chunk if engine == "cuda"
                else knn_kernel.knn_chunk_plain)
    search = None
    if mesh is not None and mesh.size(mesh_axis) > 1:
        search = _ShardSearch(corpus, k, mesh, mesh_axis, chunk_fn)
        corpus = None
    else:
        csq = (corpus * corpus).sum(1)
    n = qs.shape[0]
    size = min(batch_size, n)
    dists, idxs = [], []
    for s, off in windows(n, size):
        if search is not None:
            dist, idx = search(qs[s:s + size])
        else:
            dist, idx = chunk_fn(qs[s:s + size], corpus, k,
                                 corpus_sqnorm=csq)
        dists.append(dist[off:])
        idxs.append(idx[off:])
    return (torch.cat(dists).cpu().numpy(),
            torch.cat(idxs).cpu().numpy())


class _ShardSearch:
    """One rank's part of the sharded search (the module docstring): its
    shard of the corpus (a copy of rows ``[start, stop)``) and their
    squared norms; a call takes one chunk of queries to the merged
    (dist, idx) of every rank."""

    def __init__(self, corpus, k, mesh, axis, chunk_fn):
        from ..parallel.sharding import corpus_rows

        parts = mesh.size(axis)
        bounds = corpus_rows(corpus.shape[0], parts)
        if min(b - a for a, b in bounds) < k:
            raise ValueError("each corpus shard must hold at least k rows: "
                             "%d rows over %s=%d, k %d"
                             % (corpus.shape[0], axis, parts, k))
        self.start, stop = bounds[mesh.index(axis)]
        self.shard = corpus[self.start:stop].clone()
        self.csq = (self.shard * self.shard).sum(1)
        self.k, self.mesh, self.axis, self.chunk_fn = k, mesh, axis, chunk_fn

    def __call__(self, q):
        k, mesh, axis = self.k, self.mesh, self.axis
        parts, me = mesh.size(axis), mesh.index(axis)
        dist, idx = self.chunk_fn(q, self.shard, k,
                                  corpus_sqnorm=self.csq)
        # every rank's candidates, (P, Bq, 2k) int32: distance bits, index
        cand = torch.zeros((parts, q.shape[0], 2 * k), dtype=torch.int32,
                           device=q.device)
        cand[me, :, :k] = dist.view(torch.int32)
        cand[me, :, k:] = idx + self.start
        mesh.all_reduce(cand, axis)
        cand = cand.permute(1, 0, 2)                  # (Bq, P, 2k)
        all_d = cand[..., :k].contiguous().view(torch.float32).reshape(
            q.shape[0], parts * k)
        all_i = cand[..., k:].reshape(q.shape[0], parts * k)
        # by distance; a stable sort keeps each shard's own order and puts
        # the lower shard (the lower indices) first among equals
        d_sorted, order = torch.sort(all_d, dim=1, stable=True)
        i_sorted = torch.gather(all_i, 1, order)
        src = order // k                              # the shard of each
        ahead, behind = d_sorted[:, :k], d_sorted[:, 1:k + 1]
        last, first_out = ahead[:, -1], behind[:, -1]
        near = (first_out * first_out - last * last
                <= _NEAR * (2.0 * (q * q).sum(1) + first_out * first_out))
        mixed = ((ahead == behind) & (src[:, :k] != src[:, 1:k + 1])).any(1)
        dist, idx = d_sorted[:, :k].contiguous(), i_sorted[:, :k].contiguous()
        again = torch.nonzero(near | mixed)[:, 0]
        if again.numel():
            dist, idx = self._search_again(q, all_i, again, dist, idx)
        return dist, idx

    def _search_again(self, q, all_i, again, dist, idx):
        """The queries ``again`` searched against the union of their
        candidates, gathered in global index order: the chunk's queries go
        in whole, so their norms are those of the first search."""
        from ..parallel import sharded_gather

        union = torch.unique(all_i[again])           # sorted
        rows = sharded_gather(self.shard, union, self.mesh, self.axis,
                              self.start)
        csq = sharded_gather(self.csq[:, None], union, self.mesh, self.axis,
                             self.start)[:, 0]
        d_u, i_u = self.chunk_fn(q, rows, self.k, corpus_sqnorm=csq)
        dist, idx = dist.clone(), idx.clone()
        dist[again] = d_u[again]
        idx[again] = union[i_u[again].long()].to(idx.dtype)
        return dist, idx
