"""Exact k-nearest-neighbour search with the distances and the top-k fused
(CUDA, ``csrc/knn.cu``), and its plain PyTorch version.

Replaces the TPU kernel ``vqa_counterexamples_tpu/ops/pallas/knn_kernel.py``
``knn_chunk_pallas`` (its ``_make_kernel``), which ``ops/topk.knn`` runs for
each chunk of queries when the kNN builder (``cli/knn.py``) asks for it::

    score[q, c] = 2 q.c - |q|^2 - |c|^2          (= -|q - c|^2, f32)
    the k largest scores per query, ties to the smallest corpus index,
    dist = sqrt(max(-score, 0)), ascending

The norms come in from the caller (f32 sums, as the JAX driver computes
them outside its kernel), so the corpus's are computed once per build.

What bounds it on the H100: at the builder's shape (1024 queries against
COCO-train's 82,783 x 2048 features, k 25) it is 347 GFLOP of f32 FMAs on
678 MB: 5.2 ms at the 67 TFLOP/s f32 peak against 0.2 ms of memory, so
operations bound it.  It stays in full f32 (TF32 would change which
neighbours win), and the (Bq, N) score matrix never reaches device memory:
a block owns 64 queries and a slice of the corpus, keeps each query's
running top-k in shared memory and writes only that list; a second pass
merges the slices' lists in index order.  The lists are sized from k, so k
is capped by a block's shared memory: :func:`kmax`, 405 on the H100.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

_QB = 64
_CB = 64
_SMS = 132
_MAX_SLICES = 256


def knn_chunk_plain(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                    corpus_sqnorm: torch.Tensor | None = None):
    """Plain version (the JAX ``ops/topk.knn_chunk``): one f32 GEMM, the
    scores in the same expression order, ``torch.topk``, sqrt.  Returns
    (dist (Bq, k) f32 ascending, idx (Bq, k) int32)."""
    q, c = queries.float(), corpus.float()
    csq = (c * c).sum(1) if corpus_sqnorm is None else corpus_sqnorm
    dots = torch.matmul(q, c.t())
    qsq = (q * q).sum(1, keepdim=True)
    neg = 2.0 * dots - qsq - csq[None, :]
    top, idx = torch.topk(neg, k, dim=1)
    return torch.sqrt(torch.clamp(-top, min=0.0)), idx.to(torch.int32)


def _slices(bq: int, n: int):
    """(slice width, number of slices): about two blocks per SM over the
    query blocks, each slice a multiple of the tile."""
    qblocks = -(-bq // _QB)
    want = max(1, min(_MAX_SLICES, -(-2 * _SMS // qblocks), -(-n // _CB)))
    width = -(-(-(-n // want)) // _CB) * _CB
    return width, -(-n // width)


def knn_chunk(queries: torch.Tensor, corpus: torch.Tensor, k: int,
              corpus_sqnorm: torch.Tensor | None = None):
    """The search (see the module docstring): queries (Bq, D) and corpus
    (N, D) f32, ``corpus_sqnorm`` (N,) f32 or None (computed here).  On CPU
    tensors this is :func:`knn_chunk_plain`; on CUDA tensors it launches the
    kernel or raises."""
    if queries.device.type == "cpu":
        return knn_chunk_plain(queries, corpus, k, corpus_sqnorm)
    bq, dim = queries.shape
    n = corpus.shape[0]
    if corpus.shape[1] != dim or queries.dtype != torch.float32 \
            or corpus.dtype != torch.float32:
        raise ValueError("knn_chunk: f32 queries %s and corpus %s"
                         % (tuple(queries.shape), tuple(corpus.shape)))
    limit = kmax(queries.device)
    if not 1 <= k <= min(limit, n):
        raise ValueError("knn_chunk: k %d outside [1, min(%d, N %d)]: the "
                         "kernel holds k neighbours per query in shared "
                         "memory" % (k, limit, n))
    csq = ((corpus * corpus).sum(1) if corpus_sqnorm is None
           else corpus_sqnorm.float().contiguous())
    qsq = (queries * queries).sum(1)
    build.require_cuda("knn_chunk", queries, corpus, csq, qsq)
    lib = _lib()
    width, slices = _slices(bq, n)
    dev = queries.device
    dist = torch.empty((bq, k), dtype=torch.float32, device=dev)
    idx = torch.empty((bq, k), dtype=torch.int32, device=dev)
    pvals = torch.empty((slices, bq, k), dtype=torch.float32, device=dev)
    pidx = torch.empty((slices, bq, k), dtype=torch.int32, device=dev)
    rc = lib.vqacx_knn(build.ptr(queries), build.ptr(qsq), build.ptr(corpus),
                       build.ptr(csq), build.ptr(dist), build.ptr(idx),
                       build.ptr(pvals), build.ptr(pidx), bq, n, dim, k,
                       width, build.stream_of(dev))
    build.check(lib, rc, "knn_chunk")
    knn_chunk.launches += 1
    return dist, idx


# one count per launch
knn_chunk.launches = 0


def kmax(device: torch.device) -> int:
    """The largest k the kernel takes on ``device`` (a CUDA device): its
    running lists, 512 bytes per neighbour, share a block's shared memory
    with the tiles."""
    lib = _lib()
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    limit = lib.vqacx_knn_kmax(index)
    build.check(lib, max(0, -limit), "knn kmax")
    return limit


def _lib():
    lib = build.load("knn")
    if lib.vqacx_knn.argtypes is None:
        lib.vqacx_knn_kmax.argtypes = [ctypes.c_int]
        lib.vqacx_knn_kmax.restype = ctypes.c_int
        lib.vqacx_knn.argtypes = [ctypes.c_void_p] * 8 \
            + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.vqacx_knn.restype = ctypes.c_int
    return lib
