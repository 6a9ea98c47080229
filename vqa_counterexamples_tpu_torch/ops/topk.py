"""Exact brute-force k-nearest-neighbour search (port of ``ops/topk.py``).

``knn`` drives query chunks against the whole corpus on one device: on the
card the fused distance + top-k kernel (``ops/cuda/knn_kernel.py``) by
default, ``engine="plain"`` its plain version (one f32 GEMM + ``topk``,
JAX's ``xla`` engine); on the CPU the plain version.  Distances ascend
euclidean, as sklearn's ``kneighbors`` (so index 0 is the query itself in a
self-kNN).

``approx=True`` (the plain route only, JAX's ``xla`` engine) is the TPU's
``lax.approx_max_k(recall_target=0.999)``: the f32 scores of a chunk
(the plain route's), reduced to ``approx_reduction_size`` bins, then an
exact top-k over the bins' winners.  Bin ``b`` of ``O`` holds the columns
``b, b + O, b + 2 O, ...`` (the score row padded with -inf to ``O *
2**r`` columns and folded as ``(2**r, O)``, the layout of the TPU's
partial reduce over its 128-lane tiles); a bin keeps its largest score,
the lowest column among equals.  Where the size is N (below 47,976 rows
at k 25) nothing is reduced and the result is the exact route's.  The
distances are the plain route's f32 distances of the winners.  On CPU
and GPU XLA runs ``approx_max_k`` as the exact top-k: the TPU's
algorithm is the one carried here.

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

import math

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


def approx_reduction_size(n: int, k: int, recall_target: float = 0.999):
    """XLA's ``ApproxTopKReductionOutputSize(n, rank 2, k, recall_target,
    aggregate_to_topk=False)`` -> (bins, log2 of the reduction): enough
    bins that a top-k element meets another in its bin with probability
    ``1 - recall_target`` (``(1 - k) / ln(recall)`` windows, the recall in
    f32), at least one 128-lane tile, rounded to whole tiles."""
    tiling = 128
    if n <= tiling:
        return n, 0
    tiles = -(-n // tiling)
    if k == 1:
        log2r = (tiles - 1).bit_length()
    else:
        windows = int((1.0 - k)
                      / math.log(float(np.float32(recall_target))))
        log2r = (n // min(max(windows, tiling), n)).bit_length() - 1
        if log2r == 0:
            return n, 0
        log2r = min(log2r, (n // tiling - 1).bit_length())
    return -(-tiles // (1 << log2r)) * tiling, log2r


def approx_chunk(queries, corpus, k: int, corpus_sqnorm=None,
                 recall_target: float = 0.999):
    """The TPU's ``approx_max_k`` over one chunk (the module docstring):
    (dist (Bq, k) f32 ascending, idx (Bq, k) int32)."""
    neg = knn_kernel.neg_sqdist_plain(queries, corpus, corpus_sqnorm)
    n = neg.shape[1]
    bins, log2r = approx_reduction_size(n, k, recall_target)
    if bins < n:
        folded = torch.full((neg.shape[0], bins << log2r), -float("inf"),
                            device=neg.device)
        folded[:, :n] = neg
        best, slab = folded.view(neg.shape[0], 1 << log2r, bins).max(1)
        top, pos = torch.topk(best, k, dim=1)
        idx = torch.gather(slab, 1, pos) * bins + pos
    else:
        top, idx = torch.topk(neg, k, dim=1)
    return torch.sqrt(torch.clamp(-top, min=0.0)), idx.to(torch.int32)


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
    int32).  ``approx`` takes the plain route alone (JAX ignores it on its
    ``pallas`` engine and under a mesh; here those raise)."""
    if approx and (engine != "plain" or mesh is not None):
        raise ValueError("approx (the TPU's approx_max_k) runs on the plain "
                         "route only (--engine plain, no mesh)")
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
    chunk_fn = (knn_kernel.knn_chunk if engine == "cuda" else approx_chunk
                if approx else knn_kernel.knn_chunk_plain)
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
