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
45.3 GFLOP in bf16 (46 us at the tensor-core peak), over candidate rows
gathered from the feature table (4 MB at chip_smoke's 1,024 rows: L2; 339
MB at COCO-train's 82,783: HBM).  The operands never exist in device
memory: each CTA gathers its rows and forms bf16(o * x) on chip.  What
holds the kernels back is feeding the tensor cores: per 64-row or
64-deep chunk a CTA gathers its rows by ``cp.async`` (TMA has no row
gather, and one box a row measured slower), forms their bf16(o * x) and
receives 39 KB (forward) or 48 KB (backward) of dense operand by TMA,
while the chunk's products take about 1,200 cycles (``PERF.md`` §6).

Both kernels (``csrc/vfeat.cu``) are warp-specialized: a producer
warpgroup gathers x and the distinct o rows, starts the TMA loads of the
dense operand (the weight slices; g), forms bf16(o * x) once the rows
land and marks the stage full on an mbarrier; two consumer warpgroups run
both products of a stage on ``wgmma`` m64n152k16 (two sets of 76 f32
accumulators a thread) and release it.

Forward (:func:`fwd_plan`): a CTA owns 128 candidate rows x 152 output
columns (two column halves at H 300), both operands K-major; the producer
of column half b also sums the f32 squared distance of the tile's 64-row
block b, each thread over fixed cells in a fixed order.  The epilogue rounds each product,
sums, rounds again and stores whole rows.

Backward (:func:`bwd_plan`): a cluster owns a 64 (d) x 304 (h) tile of
both weight gradients (a consumer each 152 of h, so that a row is
gathered and its m formed once for all of H), computed transposed (dW^T =
x^T g) with the operands MN-major as they lie; its CTAs split the rows (3 at the
flagship shape, one wave of 96 CTAs: the plan weighs the waves of
clusters the card holds against the rows a CTA walks) and sum their f32
partials through distributed shared memory in rank order: one launch, no
atomics, the same bits on every run.  g goes in by TMA, whose strides must
be 16-byte multiples, so the wrapper pads H 300's rows of 600 bytes to
608 (one copy of g, 11 MB).

The features get no gradient (they are frozen dataset rows), and neither
do the indices or the distance.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...core import spans
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


_SMEM_MAX = 232448      # the H100's per-block shared memory limit
BN = 152                # wgmma N: forward columns, backward h (csrc BN)
FWD_ROWS = 128          # forward rows per CTA (csrc F_BM)
FWD_STAGES = (3, 2)     # forward ring depths, deepest that fits first
BWD_D = 64              # backward d per CTA (csrc B_BD)
BWD_H = 2 * BN          # backward h per CTA, a half per consumer (B_BH)
BWD_ROWS = 64           # backward rows per chunk (csrc B_BR)
BWD_STAGES = (3, 2)     # backward ring depths, deepest that fits first
# f32 accumulators a consumer thread holds: both products' m64 x 152
# fragments, of the 208 registers it takes (csrc C_REGS)
ACC_PER_THREAD = 2 * BN // 2
ACC_MAX = 168


def _r1024(b: int) -> int:
    return -(-b // 1024) * 1024


def o_rows(rows: int, k: int) -> int:
    """Distinct o rows (examples) that ``rows`` consecutive GEMM rows of K
    candidates each can touch."""
    return min(rows, -(-(rows - 1) // k) + 1)


def fwd_smem(n_o: int, stages: int) -> int:
    """Forward shared memory (bytes, with the 1024-byte alignment slack):
    a ring of (x and m 128 x 64, Wo and Wm 152 x 64, ``n_o`` o rows)
    stages, the row indices (x rows, their o rows, o rows) and the full
    and empty mbarriers.  Mirrors ``fwd_bytes`` in csrc/vfeat.cu (held
    equal when the library loads)."""
    stage = 2 * 128 * 128 + 2 * BN * 128 + _r1024(n_o * 128)
    return (1024 + stages * stage + -(-(2 * FWD_ROWS + n_o) * 4 // 8) * 8
            + 2 * stages * 8)


def bwd_smem(n_o: int, stages: int) -> int:
    """Backward shared memory: a ring of (x and m 64 x 64, g 64 x 384,
    ``n_o`` o rows x 64, the rows' o rows) stages, at least the two f32
    partial tiles staged at the end (304 x 68 each), two slots of 192 row
    indices and the full and empty mbarriers.  Mirrors ``bwd_bytes``."""
    stage = _r1024(2 * 8192 + 6 * 8192 + _r1024(n_o * 128) + BWD_ROWS * 4)
    return (1024 + _r1024(max(stages * stage, 2 * BWD_H * 68 * 4))
            + 2 * 192 * 4 + 2 * stages * 8)


def _even(what: str, dim_v: int, dim_h: int):
    if dim_v % 2 or dim_h % 2:
        raise ValueError("%s: dim_v %d and H %d must be even (the kernels "
                         "copy rows in 4-byte words)" % (what, dim_v, dim_h))


def _deepest(what: str, k: int, n_o: int, depths, smem):
    for stages in depths:
        if smem(n_o, stages) <= _SMEM_MAX:
            return stages
    raise ValueError("%s: K %d needs %d o rows a stage, more than %d bytes "
                     "of shared memory at %d stages"
                     % (what, k, n_o, _SMEM_MAX, depths[-1]))


def fwd_plan(batch: int, k: int, dim_v: int, dim_h: int):
    """(row_tiles, col_tiles, n_o, stages, smem) of the forward: 128-row
    x 152-column CTAs, ``n_o`` o rows a stage, the deepest ring of
    FWD_STAGES that fits.  ValueError if none does or a width is odd."""
    _even("vfeat_scores", dim_v, dim_h)
    n_o = o_rows(FWD_ROWS, k)
    stages = _deepest("vfeat_scores", k, n_o, FWD_STAGES, fwd_smem)
    return (-(-batch * k // FWD_ROWS), -(-dim_h // BN), n_o, stages,
            fwd_smem(n_o, stages))


def bwd_ring(batch: int, k: int, dim_v: int, dim_h: int):
    """(n_o, stages, smem) of the backward: the deepest ring of
    BWD_STAGES that fits.  ValueError if none does or a width is odd."""
    _even("vfeat_weight_grads", dim_v, dim_h)
    n_o = o_rows(BWD_ROWS, k)
    stages = _deepest("vfeat_weight_grads", k, n_o, BWD_STAGES, bwd_smem)
    return n_o, stages, bwd_smem(n_o, stages)


def bwd_plan(batch: int, k: int, dim_v: int, dim_h: int, clusters):
    """(d_tiles, h_tiles, cl, n_o, stages, smem) of the backward: a
    cluster of ``cl`` CTAs per 64 x 304 tile splits the 64-row chunks.
    ``clusters(cl)`` is how many clusters of ``cl`` such CTAs the card
    holds at once; ``cl`` (1 to 8, at most one chunk's worth each) takes
    the fewest chunks a CTA times waves of clusters, the smaller ``cl`` on
    a tie."""
    n_o, stages, smem = bwd_ring(batch, k, dim_v, dim_h)
    d_tiles, h_tiles = -(-dim_v // BWD_D), -(-dim_h // BWD_H)
    chunks = -(-batch * k // BWD_ROWS)

    def cost(cl):
        waves = -(-d_tiles * h_tiles // max(clusters(cl), 1))
        return waves * -(-chunks // cl), cl

    cl = min(range(1, min(8, chunks) + 1), key=cost)
    return d_tiles, h_tiles, cl, n_o, stages, smem


def _aligned4(what: str, *tensors):
    if any(t.data_ptr() % 4 for t in tensors):
        raise ValueError("%s: operands must be 4-byte aligned" % what)


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
    k = k1 - 1
    _, _, n_o, stages, _ = fwd_plan(batch, k, dim_v, dim_h)
    _aligned4("vfeat_scores", table, w_other, w_mult)
    lib = _lib()
    h = torch.empty((batch, k, dim_h), dtype=_BF16, device=table.device)
    dist = torch.empty((batch, k), dtype=torch.float32, device=table.device)
    rc = lib.vqacx_vfeat_fwd(build.ptr(table), n_rows, dim_v,
                             build.ptr(image_idxs), batch, k,
                             build.ptr(w_other), build.ptr(w_mult), dim_h,
                             build.ptr(h), build.ptr(dist), n_o, stages,
                             build.stream_of(table.device))
    build.check(lib, rc, "vfeat_scores")
    spans.count("kernels.launches.vfeat")
    return h, dist


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
    dim_h = g.shape[2]
    dev = table.device
    n_o, stages, _ = bwd_ring(batch, k, dim_v, dim_h)
    lib = _lib()
    _, _, cl, _, _, _ = bwd_plan(
        batch, k, dim_v, dim_h,
        lambda c: _clusters(lib, dev.index, n_o, c, stages))
    _aligned4("vfeat_weight_grads", table)
    # g goes in by TMA, whose rows must be 16-byte strides from a 16-byte
    # aligned base: H 300's rows of 600 bytes are padded to 608 (one copy
    # of g, 11 MB at the CX path's shape)
    g = g.reshape(batch * k, dim_h)
    if dim_h % 8:
        g = torch.nn.functional.pad(g, (0, -dim_h % 8))
    elif g.data_ptr() % 16:
        g = g.clone()
    dwo = torch.empty((dim_h, dim_v), dtype=torch.float32, device=dev)
    dwm = torch.empty((dim_h, dim_v), dtype=torch.float32, device=dev)
    rc = lib.vqacx_vfeat_bwd(build.ptr(table), n_rows, dim_v,
                             build.ptr(image_idxs), batch, k, build.ptr(g),
                             dim_h, g.shape[1], build.ptr(dwo),
                             build.ptr(dwm), n_o, cl, stages,
                             build.stream_of(dev))
    build.check(lib, rc, "vfeat_weight_grads")
    spans.count("kernels.launches.vfeat_bwd")
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


spans.declare("kernels.launches.vfeat", "kernels.launches.vfeat_bwd")


@functools.lru_cache(maxsize=None)
def _clusters(lib, device: int, n_o: int, cl: int, stages: int) -> int:
    """Clusters of ``cl`` backward CTAs the card holds at once (the CUDA
    occupancy query, once per configuration)."""
    with torch.cuda.device(device):
        n = lib.vqacx_vfeat_bwd_clusters(n_o, cl, stages)
    if n < 0:
        raise RuntimeError("vfeat_weight_grads: the cluster occupancy query "
                           "failed for clusters of %d" % cl)
    return n


def _lib():
    lib = build.load("vfeat")
    c_p, c_i = ctypes.c_void_p, ctypes.c_int
    if lib.vqacx_vfeat_fwd.argtypes is None:
        lib.vqacx_vfeat_fwd_smem.argtypes = [c_i, c_i]
        lib.vqacx_vfeat_bwd_smem.argtypes = [c_i, c_i]
        # the plans' shared memory is fwd_smem's / bwd_smem's: once, at
        # load, they are held equal to the kernels' own counts
        for n_o in (1, 7, 23, 64, 128):
            for stages in (2, 3):
                need = lib.vqacx_vfeat_fwd_smem(n_o, stages)
                if need != fwd_smem(n_o, stages):
                    raise RuntimeError(
                        "vfeat_scores: fwd_smem(%d, %d) disagrees with "
                        "csrc/vfeat.cu's %d bytes" % (n_o, stages, need))
                need = lib.vqacx_vfeat_bwd_smem(min(n_o, 64), stages)
                if need != bwd_smem(min(n_o, 64), stages):
                    raise RuntimeError(
                        "vfeat_weight_grads: bwd_smem(%d, %d) disagrees "
                        "with csrc/vfeat.cu's %d bytes"
                        % (min(n_o, 64), stages, need))
        lib.vqacx_vfeat_bwd_clusters.argtypes = [c_i, c_i, c_i]
        lib.vqacx_vfeat_bwd.argtypes = [c_p, c_i, c_i, c_p, c_i, c_i, c_p,
                                        c_i, c_i, c_p, c_p, c_i, c_i, c_i,
                                        c_p]
        lib.vqacx_vfeat_bwd.restype = c_i
        lib.vqacx_vfeat_fwd.argtypes = [c_p, c_i, c_i, c_p, c_i, c_i, c_p,
                                        c_p, c_i, c_p, c_p, c_i, c_i, c_p]
        lib.vqacx_vfeat_fwd.restype = c_i
    return lib
