"""Candidate image-feature kernel (CUDA, ``csrc/vfeat.cu``) and its plain
PyTorch version.

Replaces the TPU kernel
``vqa_counterexamples_tpu/ops/pallas/vfeat_kernel.py`` ``vfeat_scores_pallas``
(forward, ``_fwd_kernel``), reached from ``models/cx.NeuralModel`` when the
z cache is on.  For each example b and candidate k, with x = table[idx[b,
k+1]] and o = table[idx[b, 0]]::

    h[b, k]    = bf16(x @ W_other^T) + bf16(bf16(o * x) @ W_mult^T)
    dist[b, k] = || o - x + 1e-6 ||_2                        (f32)

What bounds it on the H100: at the flagship shape (B=768, K=24,
dim_v=2048, H=300) it is two (18432 x 2048) x (2048 x 300) GEMMs, 45 GFLOP
in bf16, over candidate rows gathered from a 4 MB bf16 table that stays in
L2.  The TPU version gathered the rows K-major outside the kernel because
of a Mosaic DMA limit; here each block loads its own indices and gathers
the rows itself, so the (B, K, dim_v) candidate tensor, the o * x product
and the distance's differences never exist in device memory.  One block
owns 64 candidate rows x 64 output columns; the o * x tile is formed in
shared memory while the x tile is loaded, both GEMMs run on bf16 WMMA
fragments with f32 accumulators, and the blocks of the first column tile
also accumulate the f32 squared distance, each thread always over the same
(row, 8-column chunk) so the sum is deterministic.

Forward only: the weight-gradient backward comes with the training path.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

_BF16 = torch.bfloat16
DIST_EPS = 1e-6


def vfeat_scores_plain(table: torch.Tensor, image_idxs: torch.Tensor,
                       w_other: torch.Tensor, w_mult: torch.Tensor):
    """Plain PyTorch version with the kernel's rounding points.

    table (N, dim_v) bf16; image_idxs (B, K+1) int (column 0 the original
    image); w_other / w_mult (H, dim_v) bf16 (torch ``Linear.weight``
    column slices).  Returns (h (B, K, H) bf16, dist (B, K) f32).
    """
    idx = image_idxs.long().clamp(0, table.shape[0] - 1)
    x = table[idx[:, 1:]].to(_BF16)                   # (B, K, dv)
    o = table[idx[:, 0]].to(_BF16)[:, None, :]        # (B, 1, dv)
    m = o * x
    h = (torch.matmul(x, w_other.to(_BF16).t())
         + torch.matmul(m, w_mult.to(_BF16).t()))
    diff = o.float() - x.float() + DIST_EPS
    dist = torch.sqrt(torch.sum(diff * diff, dim=-1))
    return h, dist


def vfeat_scores(table: torch.Tensor, image_idxs: torch.Tensor,
                 w_other: torch.Tensor, w_mult: torch.Tensor):
    """Fused v_other / v_mult / v_dist for table-form candidates (see the
    module docstring).  On a CPU tensor this is :func:`vfeat_scores_plain`;
    on a CUDA tensor it launches the kernel or raises."""
    if table.device.type == "cpu":
        return vfeat_scores_plain(table, image_idxs, w_other, w_mult)
    n_rows, dim_v = table.shape
    batch, k1 = image_idxs.shape
    dim_h = w_other.shape[0]
    if tuple(w_other.shape) != (dim_h, dim_v) or w_mult.shape != w_other.shape:
        raise ValueError("vfeat_scores: w_other %s / w_mult %s vs dim_v %d"
                         % (tuple(w_other.shape), tuple(w_mult.shape), dim_v))
    if table.dtype != _BF16 or w_other.dtype != _BF16 \
            or w_mult.dtype != _BF16:
        raise ValueError("vfeat_scores: table and weights must be bf16")
    if image_idxs.dtype != torch.int32:
        raise ValueError("vfeat_scores: image_idxs must be int32")
    build.require_cuda("vfeat_scores", table, image_idxs, w_other, w_mult)
    lib = _lib()
    k = k1 - 1
    h = torch.empty((batch, k, dim_h), dtype=_BF16, device=table.device)
    dist = torch.empty((batch, k), dtype=torch.float32, device=table.device)
    rc = lib.vqacx_vfeat_fwd(build.ptr(table), n_rows, dim_v,
                             build.ptr(image_idxs), batch, k,
                             build.ptr(w_other), build.ptr(w_mult), dim_h,
                             build.ptr(h), build.ptr(dist),
                             build.stream_of(table.device))
    build.check(lib, rc, "vfeat_scores")
    vfeat_scores.launches += 1
    return h, dist


vfeat_scores.launches = 0


def _lib():
    lib = build.load("vfeat")
    fn = lib.vqacx_vfeat_fwd
    if fn.argtypes is None:
        c_p, c_i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [c_p, c_i, c_i, c_p, c_i, c_i, c_p, c_p, c_i, c_p,
                       c_p, c_p]
        fn.restype = ctypes.c_int
    return lib
