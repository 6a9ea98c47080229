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
COCO-train's 82,783 x 2048 features, k 25) the product is 347 GFLOP on
678 MB.  It runs on the tensor cores at f32 accuracy by split TF32
(:func:`split_tf32`, three TF32 products per f32 one): 1,041 GFLOP, 2.1 ms
at the 495 TFLOP/s TF32 peak against 0.2 ms of memory, so operations
bound it.  Plain TF32 alone would change which neighbours win.  The
(Bq, N) score matrix never reaches device memory: a block owns 128 queries
and a slice of the corpus, streams D through a cp.async ring, filters each
tile's scores against each query's k-th best so far in registers and
merges the few survivors into the query's running list, which lives in the
per-slice scratch in device memory, so k has no cap but N; a second pass
merges the slices' lists in index order.
"""

from __future__ import annotations

import ctypes

import torch

from ...core import spans
from . import build

_TILE = 128        # queries per block and corpus rows per tile (knn.cu)
_MAX_SLICES = 256


def knn_chunk_plain(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                    corpus_sqnorm: torch.Tensor | None = None):
    """Plain version (the JAX ``ops/topk.knn_chunk``): one f32 GEMM, the
    scores in the same expression order, ``torch.topk``, sqrt.  Returns
    (dist (Bq, k) f32 ascending, idx (Bq, k) int32)."""
    top, idx = torch.topk(neg_sqdist_plain(queries, corpus, corpus_sqnorm),
                          k, dim=1)
    return torch.sqrt(torch.clamp(-top, min=0.0)), idx.to(torch.int32)


def neg_sqdist_plain(queries: torch.Tensor, corpus: torch.Tensor,
                     corpus_sqnorm: torch.Tensor | None = None
                     ) -> torch.Tensor:
    """The plain version's scores -(||q - f||^2), (Bq, N) f32: one f32
    GEMM, ``2 q.f - |q|^2 - |f|^2`` in JAX's expression order."""
    q, c = queries.float(), corpus.float()
    csq = (c * c).sum(1) if corpus_sqnorm is None else corpus_sqnorm
    dots = torch.matmul(q, c.t())
    qsq = (q * q).sum(1, keepdim=True)
    return 2.0 * dots - qsq - csq[None, :]


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32 (10 mantissa bits) to nearest, ties away
    from zero, as the kernel rounds them: add half a TF32 unit to the bits,
    clear the low 13."""
    return ((x.view(torch.int32) + 0x1000) & -8192).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """(hi, lo) with hi = tf32(x) and lo = tf32(x - hi): the kernel's split
    of each f32 operand into two TF32 ones (x - hi - lo is below 2^-21
    of |x|)."""
    hi = _tf32(x.float().contiguous())
    return hi, _tf32(x.float() - hi)


def _slices(bq: int, n: int, sms: int):
    """(slice width, number of slices) for ``bq`` queries against ``n``
    corpus rows on a card of ``sms`` SMs, each holding one block (the
    kernel's 145 KB of shared memory): the split of the corpus tiles whose
    blocks finish soonest, in waves of ``sms`` blocks, the fewest slices
    among equals.  Every slice is a whole number of tiles and none is
    empty."""
    qblocks = -(-bq // _TILE)
    tiles = -(-n // _TILE)
    best = None
    for want in range(1, min(_MAX_SLICES, tiles) + 1):
        width = -(-tiles // want)
        slices = -(-tiles // width)
        cost = -(-qblocks * slices // sms) * width
        if best is None or cost < best[0]:
            best = (cost, width * _TILE, slices)
    return best[1], best[2]


def knn_chunk(queries: torch.Tensor, corpus: torch.Tensor, k: int,
              corpus_sqnorm: torch.Tensor | None = None):
    """The search (see the module docstring): queries (Bq, D) and corpus
    (N, D) f32, ``corpus_sqnorm`` (N,) f32 or None (computed here), any k
    up to N.  On CPU tensors this is :func:`knn_chunk_plain`; on CUDA
    tensors it launches the kernel or raises."""
    if queries.device.type == "cpu":
        return knn_chunk_plain(queries, corpus, k, corpus_sqnorm)
    bq, dim = queries.shape
    n = corpus.shape[0]
    if corpus.shape[1] != dim or queries.dtype != torch.float32 \
            or corpus.dtype != torch.float32:
        raise ValueError("knn_chunk: f32 queries %s and corpus %s"
                         % (tuple(queries.shape), tuple(corpus.shape)))
    if not 1 <= k <= n:
        raise ValueError("knn_chunk: k %d outside [1, N %d]" % (k, n))
    csq = ((corpus * corpus).sum(1) if corpus_sqnorm is None
           else corpus_sqnorm.float().contiguous())
    qsq = (queries * queries).sum(1)
    build.require_cuda("knn_chunk", queries, corpus, csq, qsq)
    lib = _lib()
    dev = queries.device
    width, slices = _slices(
        bq, n, torch.cuda.get_device_properties(dev).multi_processor_count)
    dist = torch.empty((bq, k), dtype=torch.float32, device=dev)
    idx = torch.empty((bq, k), dtype=torch.int32, device=dev)
    pvals = torch.empty((slices, bq, k), dtype=torch.float32, device=dev)
    pidx = torch.empty((slices, bq, k), dtype=torch.int32, device=dev)
    rc = lib.vqacx_knn(build.ptr(queries), build.ptr(qsq), build.ptr(corpus),
                       build.ptr(csq), build.ptr(dist), build.ptr(idx),
                       build.ptr(pvals), build.ptr(pidx), bq, n, dim, k,
                       width, build.stream_of(dev))
    build.check(lib, rc, "knn_chunk")
    spans.count("kernels.launches.knn")
    return dist, idx


spans.declare("kernels.launches.knn")


def _lib():
    lib = build.load("knn")
    if lib.vqacx_knn.argtypes is None:
        lib.vqacx_knn.argtypes = [ctypes.c_void_p] * 8 \
            + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.vqacx_knn.restype = ctypes.c_int
    return lib
