"""Candidate image-feature kernels (CUDA, ``csrc/vfeat.cu``), forward and
backward, their plain PyTorch versions and the autograd Function that joins
them.

Replaces the TPU kernel
``vqa_counterexamples_tpu/ops/pallas/vfeat_kernel.py`` ``vfeat_scores_pallas``
(forward ``_fwd_kernel``, backward ``_bwd_kernel`` behind its custom VJP),
reached from ``models/cx.NeuralModel`` when the z cache is on.  For each
example b and candidate k, with x = table[idx[b, k+1]] and o = table[idx[b,
0]]::

    h[b, k]    = bf16(x @ W_other^T) + bf16(bf16(o * x) @ W_mult^T)
    dist[b, k] = || o - x + 1e-6 ||_2                        (f32)

    dW_other = g^T x,  dW_mult = g^T bf16(o * x)   (g = dL/dh, f32 sums)

What bounds them on the H100: at the flagship shape (B=768, K=24,
dim_v=2048, H=300) each direction is two GEMMs of 2 x 18432 x 2048 x 300,
45 GFLOP in bf16, over candidate rows gathered from a 4 MB bf16 table that
stays in L2.  The TPU version gathered the rows K-major outside the kernel
because of a Mosaic DMA limit; here each block loads its own indices and
gathers the rows itself, so the (B, K, dim_v) candidate tensor, the o * x
product and the distance's differences never exist in device memory, in
either direction.

Forward: one block owns 64 candidate rows x 64 output columns; the o * x
tile is formed in shared memory while the x tile is loaded, both GEMMs run
on bf16 WMMA fragments with f32 accumulators, and the blocks of the first
column tile also accumulate the f32 squared distance, each thread always
over the same (row, 8-column chunk) so the sum is deterministic.

Backward: one block owns a 64 (h) x 128 (d) tile of both weight gradients
and reduces over its share of the B*K rows, gathering x and forming o * x
per 32-row chunk exactly as the forward does.  The rows are split into a
few contiguous ranges when the output tiles alone would leave SMs idle;
the f32 partials are summed in split order by a second pass, so the result
is the same on every run (no float atomics).

The features get no gradient (they are frozen dataset rows), and neither
do the indices or the distance.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

_BF16 = torch.bfloat16
DIST_EPS = 1e-6


def _gather(table: torch.Tensor, image_idxs: torch.Tensor):
    """(x (B, K, dv), o (B, 1, dv)) in bf16, clipped like the kernels."""
    idx = image_idxs.long().clamp(0, table.shape[0] - 1)
    return table[idx[:, 1:]].to(_BF16), table[idx[:, 0]].to(_BF16)[:, None, :]


def vfeat_scores_plain(table: torch.Tensor, image_idxs: torch.Tensor,
                       w_other: torch.Tensor, w_mult: torch.Tensor):
    """Plain PyTorch version with the kernel's rounding points.

    table (N, dim_v) bf16; image_idxs (B, K+1) int (column 0 the original
    image); w_other / w_mult (H, dim_v) bf16 (torch ``Linear.weight``
    column slices).  Returns (h (B, K, H) bf16, dist (B, K) f32).
    """
    x, o = _gather(table, image_idxs)
    m = o * x
    h = (torch.matmul(x, w_other.to(_BF16).t())
         + torch.matmul(m, w_mult.to(_BF16).t()))
    diff = o.float() - x.float() + DIST_EPS
    dist = torch.sqrt(torch.sum(diff * diff, dim=-1))
    return h, dist


def vfeat_weight_grads_plain(table: torch.Tensor, image_idxs: torch.Tensor,
                             g: torch.Tensor):
    """Plain PyTorch version of the backward: g (B, K, H) -> (dW_other,
    dW_mult), each (H, dim_v) f32, summed over all B*K rows in f32."""
    x, o = _gather(table, image_idxs)
    m = o * x
    gf = g.float().reshape(-1, g.shape[-1]).t()
    return (gf @ x.float().reshape(-1, x.shape[-1]),
            gf @ m.float().reshape(-1, m.shape[-1]))


def _scores_forward(table, image_idxs, w_other, w_mult):
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


# the backward's output tile (csrc/vfeat.cu GBM x GBN) and row chunk (GBK)
_BWD_TILE_H, _BWD_TILE_D, _BWD_ROWS = 64, 128, 32


def _bwd_splits(device, dim_h: int, dim_v: int, rows: int) -> int:
    """Row splits so that about two blocks run on every SM (one wave)."""
    tiles = (-(-dim_h // _BWD_TILE_H)) * (-(-dim_v // _BWD_TILE_D))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(2 * sms // tiles, -(-rows // _BWD_ROWS)))


def vfeat_weight_grads(table: torch.Tensor, image_idxs: torch.Tensor,
                       g: torch.Tensor):
    """The backward kernel: g = dL/dh (B, K, H) bf16 -> (dW_other, dW_mult)
    (H, dim_v) f32.  On a CPU tensor this is
    :func:`vfeat_weight_grads_plain`; on a CUDA tensor it launches the
    kernel or raises."""
    if table.device.type == "cpu":
        return vfeat_weight_grads_plain(table, image_idxs, g)
    n_rows, dim_v = table.shape
    batch, k1 = image_idxs.shape
    k = k1 - 1
    if g.dim() != 3 or tuple(g.shape[:2]) != (batch, k):
        raise ValueError("vfeat_weight_grads: g %s vs (B, K) = (%d, %d)"
                         % (tuple(g.shape), batch, k))
    if table.dtype != _BF16 or g.dtype != _BF16:
        raise ValueError("vfeat_weight_grads: table and g must be bf16")
    if image_idxs.dtype != torch.int32:
        raise ValueError("vfeat_weight_grads: image_idxs must be int32")
    build.require_cuda("vfeat_weight_grads", table, image_idxs, g)
    lib = _lib()
    dim_h = g.shape[2]
    dev = table.device
    splits = _bwd_splits(dev, dim_h, dim_v, batch * k)
    dwo = torch.empty((dim_h, dim_v), dtype=torch.float32, device=dev)
    dwm = torch.empty((dim_h, dim_v), dtype=torch.float32, device=dev)
    part = (torch.empty((splits, 2, dim_h, dim_v), dtype=torch.float32,
                        device=dev) if splits > 1 else None)
    rc = lib.vqacx_vfeat_bwd(build.ptr(table), n_rows, dim_v,
                             build.ptr(image_idxs), batch, k, build.ptr(g),
                             dim_h, splits, build.ptr(part), build.ptr(dwo),
                             build.ptr(dwm), build.stream_of(dev))
    build.check(lib, rc, "vfeat_weight_grads")
    vfeat_weight_grads.launches += 1
    return dwo, dwm


class _VFeatScores(torch.autograd.Function):
    """Forward kernel, backward kernel.  Saves only the table and the
    indices: the backward gathers the rows again."""

    @staticmethod
    def forward(ctx, table, image_idxs, w_other, w_mult):
        h, dist = _scores_forward(table, image_idxs, w_other, w_mult)
        ctx.mark_non_differentiable(dist)
        ctx.save_for_backward(table, image_idxs)
        ctx.w_dtypes = (w_other.dtype, w_mult.dtype)
        return h, dist

    @staticmethod
    def backward(ctx, g_h, _g_dist):
        table, image_idxs = ctx.saved_tensors
        dwo, dwm = vfeat_weight_grads(
            table, image_idxs, g_h.to(table.dtype).contiguous())
        # the f32 sums come back in the weights' own dtype (bf16 under the
        # policy), as the TPU kernel's VJP returns them
        return None, None, dwo.to(ctx.w_dtypes[0]), dwm.to(ctx.w_dtypes[1])


def vfeat_scores(table: torch.Tensor, image_idxs: torch.Tensor,
                 w_other: torch.Tensor, w_mult: torch.Tensor):
    """Fused v_other / v_mult / v_dist for table-form candidates (see the
    module docstring), differentiable in ``w_other`` and ``w_mult``.  On a
    CPU tensor both directions are the plain versions; on a CUDA tensor
    they launch the kernels or raise."""
    return _VFeatScores.apply(table, image_idxs, w_other, w_mult)


# one count per launch of each kernel
vfeat_scores.launches = 0
vfeat_weight_grads.launches = 0


def _lib():
    lib = build.load("vfeat")
    c_p, c_i = ctypes.c_void_p, ctypes.c_int
    if lib.vqacx_vfeat_fwd.argtypes is None:
        lib.vqacx_vfeat_fwd.argtypes = [c_p, c_i, c_i, c_p, c_i, c_i, c_p,
                                        c_p, c_i, c_p, c_p, c_p]
        lib.vqacx_vfeat_fwd.restype = c_i
    if lib.vqacx_vfeat_bwd.argtypes is None:
        lib.vqacx_vfeat_bwd.argtypes = [c_p, c_i, c_i, c_p, c_i, c_i, c_p,
                                        c_i, c_i, c_p, c_p, c_p, c_p]
        lib.vqacx_vfeat_bwd.restype = c_i
    return lib
