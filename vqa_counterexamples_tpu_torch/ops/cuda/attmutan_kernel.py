"""The folded attention-MUTAN fusion kernels (CUDA, ``csrc/attmutan.cu``),
forward and backward, and their plain PyTorch versions.

Replace the TPU kernels of ``vqa_counterexamples_tpu/ops/pallas/
attmutan_kernel.py``: ``folded_mutan_pallas`` (its ``_fwd_call`` /
``_fwd_kernel``) and the backward of its custom VJP (``_bwd_call`` /
``_bwd_kernel``), reached through ``ops/fusion.folded_mutan_auto`` from
``models/fusion.MutanFusion.fuse_candidates`` in MutanAtt's attention
stage, where each of the 196 positions is fused with the question::

    weff[b]     = sum_r w_r^T * hq[b, r]          (Dh, M), rounded to bf16
    out[b, k]   = x_v[b, k] @ weff[b] + sum_r b_r * hq[b, r]

with ``w`` the stacked per-rank ``Linear`` weight (R * M, Dh) (row
``r * M + m``), ``b`` its bias (R * M,), ``hq`` (B, R, M) the question's
rank projections.  The rounding points are the TPU kernel's: ``b`` and
``hq`` rounded to bf16, weff's f32 sum rounded to bf16, f32 accumulation,
a bf16 output.  The backward returns ``dx_v = bf16(g @ weff^T)``, ``dw`` and
``db`` (f32 sums over every example) and ``dhq = bf16(sum_d w * dweff + b *
sum_k g)`` with ``dweff[b] = x_v[b]^T g[b]`` in f32.

What bounds them on the H100: at MutanAtt's shape (B 128, K 196, Dh 310,
R 5, M 510) the forward is 7.9 GFLOP on about 42 MB, the backward twice the
GEMM work: about 8 / 16 us of tensor-core time against 13 / 26 us of
memory, so bytes bound both.  weff (81 MB in f32 at this batch) never
reaches device memory: each block builds the slice of it that it
multiplies with in shared memory, as the TPU kernel built it in VMEM.

The forward (``csrc/attmutan.cu``, one launch, :func:`fwd_plan`) is bound
in practice by w's reads from L2 (each example's weff is built once, from
all of w: 1.6 MB an example, 203 MB a call) and by its product, which a
CTA runs only after its build.  A CTA owns (example, NB of M) over all 196
positions: it builds its weff slice once from 8-byte loads of 5 ranks'
rows of w (contiguous), the next round's loads in flight under this
round's sums, summing in JAX's rank order and rounding once, while the
first x_v stages load; then it streams x_v[b] through a cp.async ring into
wgmma, adds the folded bias in f32 and writes whole rows of out through
shared memory.

The backward (``csrc/attmutan.cu``, three launches, :func:`bwd_plan`) is
bound in practice by its loads from L2: w (1.6 MB) once per example to
build weff, and x_v and g once per output tile of dweff, in 4-byte copies
whose latency the few stages that fit beside the weff slice and the w
tile do not hide (``PERF.md`` §6).  A dx CTA owns
an example and 160 of Dh over all 196 positions and builds its weff slice
once, in JAX's rank order (each example's weff is built once in all), then
streams g[b] into wgmma; a dweff CTA owns a 64 x 64 (M, Dh) tile for one
of 8 groups of examples and computes dweff = x_v[b]^T g[b] on wgmma with
both operands MN-major, its cp.async ring running across the examples,
while dw and this tile's part of dhq accumulate in registers and a product
against ones gives sum_k g.  The rows of x_v, g and w (620 and 1020
bytes) are off TMA's 16-byte strides, so 4-byte cp.async copies fill the
swizzled stages.  The cross-block sums go in a fixed order with no
atomics, so reruns are bit-equal: the 8 groups of a tile form a cluster
that adds its dw partials through distributed shared memory in group
order; the d tiles' parts of dhq and the examples' terms of db are added
by a last small launch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...core import spans
from . import build

_BF16 = torch.bfloat16
_TILE = 64
_SMEM_MAX = 232448          # the H100's per-block shared memory limit
_GROUPS = 8                 # example groups of a dweff cluster (WCL)
_RANKS = 5                  # ranks per dweff launch (WRG)


# The forward's configurations (NB of M a CTA, warpgroups, the deepest
# ring tried), in the order fwd_plan tries them; csrc/attmutan.cu
# instantiates each.  The first is the fastest at MutanAtt's shape
# (``cli/probe_kernels`` sweeps them; ``PERF.md`` §6); the others take a Dh
# whose slice the first cannot hold (above 320; the last up to about
# 1,600).
FWD_CONFIGS = ((256, 2, 3), (128, 2, 4), (64, 1, 4))


def fwd_smem(nb: int, nwg: int, dc: int, rank: int, stages: int) -> int:
    """The forward's shared memory (bytes, with the alignment slack): the
    weff slice (``dc`` 64-wide chunks of Dh x ``nb`` rows, 128 bytes a
    row), a ring of 8 KB x ``nwg`` x_v stages, hq and the bias in f32.
    Mirrors ``fwd_bytes``."""
    return 1024 + dc * nb * 128 + stages * nwg * 8192 + (rank + 1) * nb * 4


def fwd_plan(batch: int, k: int, dim_h: int, rank: int, dim_m: int,
             config=None):
    """The forward's launch plan (pure Python; ``csrc/attmutan.cu`` takes it
    as given): the first of :data:`FWD_CONFIGS` (or ``config``, an (nb,
    nwg) pair of them) whose weff slice and a ring of at least 2 stages fit
    a CTA's shared memory, with the deepest ring up to its limit.  Returns
    ``nb``, ``nwg``, ``stages``, ``smem`` and the ``grid`` (M blocks,
    examples).  ValueError when none fits (Dh beyond about 1,600)."""
    dc = -(-dim_h // _TILE)
    configs = FWD_CONFIGS if config is None else [
        c for c in FWD_CONFIGS if tuple(c[:2]) == tuple(config)]
    if not configs:
        raise ValueError("folded_mutan: no configuration %s" % (config,))
    for nb, nwg, most in configs:
        fits = [st for st in range(most, 1, -1)
                if fwd_smem(nb, nwg, dc, rank, st) <= _SMEM_MAX]
        if fits:
            return {"nb": nb, "nwg": nwg, "stages": fits[0],
                    "smem": fwd_smem(nb, nwg, dc, rank, fits[0]),
                    "grid": (-(-dim_m // nb), batch)}
    raise ValueError(
        "folded_mutan: Dh %d, R %d: the weff slice and a ring of 2 stages "
        "need %d bytes of shared memory (at most %d)"
        % (dim_h, rank, fwd_smem(*configs[-1][:2], dc, rank, 2), _SMEM_MAX))


def bwd_plan(batch: int, k: int, dim_h: int, rank: int, dim_m: int):
    """The backward's launch plan (pure Python; ``csrc/attmutan.cu`` takes
    it as given).  Returns a dict:

    - ``groups``: the 8 dweff example groups, ``(lo, hi)`` each, contiguous
      and in order, ``ceil(B / 8)`` examples each at most (the last ones
      short or empty when 8 does not divide B); CTA c of a dweff cluster
      takes group c;
    - ``dx_stages``: the dx kernel's ring depth, the deepest of 4, 3, 2 that
      fits (``dx_smem`` bytes: the weff slice, the ring, hq in bf16);
    - ``dweff_smem``: the dweff kernel's bytes (a ring of 3, the w tile);
    - ``scratch``: the f32 scratch shapes, ``pdhq`` and ``gsum``.

    ValueError when the dx kernel's weff slice does not fit (M beyond about
    512)."""
    mc = -(-dim_m // _TILE)
    dt = -(-dim_h // _TILE)
    per_group = -(-batch // _GROUPS)
    groups = [(min(batch, g * per_group), min(batch, (g + 1) * per_group))
              for g in range(_GROUPS)]
    fits = [st for st in (4, 3, 2)
            if dx_smem(mc, rank, st) <= _SMEM_MAX]
    if not fits:
        raise ValueError(
            "folded_mutan_bwd: M %d, R %d: the dx kernel's weff slice and "
            "ring need %d bytes of shared memory (at most %d)"
            % (dim_m, rank, dx_smem(mc, rank, 2), _SMEM_MAX))
    return {
        "groups": groups,
        "dx_stages": fits[0], "dx_smem": dx_smem(mc, rank, fits[0]),
        "dweff_smem": dweff_smem(),
        "scratch": {"pdhq": (dt, batch, rank, dim_m),
                    "gsum": (batch, dim_m)}}


def dx_smem(mc: int, rank: int, stages: int) -> int:
    """The dx kernel's shared memory (bytes, with the alignment slack):
    ``mc`` 64-wide M chunks of the 160-row weff slice (20 KB each), a ring
    of 16 KB g stages, hq (R, 64 mc) in bf16.  Mirrors ``dx_bytes``."""
    return 1024 + mc * 20480 + stages * 16384 + rank * mc * 64 * 2


def dweff_smem() -> int:
    """The dweff kernel's shared memory: a ring of 3 stages of two 8 KB
    tiles and the example's hq (1 KB), a 1 KB tile of ones, the w tile
    (5, 64, 72) bf16.  Mirrors ``dweff_bytes``."""
    return 1024 + 3 * 17408 + 1024 + _RANKS * 64 * 72 * 2


def _weff(w: torch.Tensor, hq: torch.Tensor) -> torch.Tensor:
    """(B, M, Dh) bf16: sum over ranks of w_r * hq_r in f32, rank by rank,
    rounded once (the order of the TPU kernel's ``_weff``)."""
    batch, rank, m = hq.shape
    w3 = w.float().reshape(rank, m, -1)
    h = hq.to(_BF16).float()
    acc = None
    for r in range(rank):
        term = w3[r][None] * h[:, r, :, None]
        acc = term if acc is None else acc + term
    return acc.to(_BF16)


def _bias(b: torch.Tensor, hq: torch.Tensor) -> torch.Tensor:
    """(B, M) f32: sum_r bf16(b_r) * bf16(hq_r), rank by rank."""
    rank, m = hq.shape[1:]
    b3 = b.to(_BF16).float().reshape(rank, m)
    h = hq.to(_BF16).float()
    acc = None
    for r in range(rank):
        term = b3[r][None] * h[:, r]
        acc = term if acc is None else acc + term
    return acc


def folded_mutan_plain(x_v: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       hq: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version with the kernel's rounding points.

    x_v (B, K, Dh) bf16, w (R * M, Dh) bf16, b (R * M,) and hq (B, R, M)
    of any float dtype (rounded to bf16 here).  Returns (B, K, M) bf16.
    """
    weff = _weff(w, hq).float()
    out = torch.matmul(x_v.float(), weff.transpose(1, 2))
    return (out + _bias(b, hq)[:, None, :]).to(_BF16)


def folded_mutan_bwd_plain(x_v: torch.Tensor, w: torch.Tensor,
                           b: torch.Tensor, hq: torch.Tensor,
                           g: torch.Tensor):
    """Plain version of the backward: (dx_v (B, K, Dh) bf16, dw (R * M, Dh)
    f32, db (R * M,) f32, dhq (B, R, M) bf16) for the cotangent g (B, K, M)
    bf16."""
    batch, rank, m = hq.shape
    weff = _weff(w, hq).float()
    gf = g.float()
    h = hq.to(_BF16).float()
    dxv = torch.matmul(gf, weff).to(_BF16)
    dweff = torch.matmul(x_v.float().transpose(1, 2), gf)     # (B, Dh, M)
    gsum = gf.sum(1)                                           # (B, M)
    dw = torch.einsum("bdm,brm->rmd", dweff, h).reshape(rank * m, -1)
    db = torch.einsum("bm,brm->rm", gsum, h).reshape(-1)
    w3 = w.float().reshape(rank, m, -1)
    b3 = b.to(_BF16).float().reshape(rank, m)
    dhq = (torch.einsum("rmd,bdm->brm", w3, dweff)
           + b3[None] * gsum[:, None]).to(_BF16)
    return dxv, dw, db, dhq


def _check(what, x_v, w, b, hq, g=None):
    batch, k, dh = x_v.shape
    rank, m = hq.shape[1:]
    if (tuple(w.shape) != (rank * m, dh) or b.numel() != rank * m
            or hq.shape[0] != batch
            or (g is not None and tuple(g.shape) != (batch, k, m))):
        raise ValueError("%s: x_v %s w %s b %s hq %s g %s" % (
            what, tuple(x_v.shape), tuple(w.shape), tuple(b.shape),
            tuple(hq.shape), None if g is None else tuple(g.shape)))
    if x_v.dtype != _BF16 or w.dtype != _BF16 or (
            g is not None and g.dtype != _BF16):
        raise ValueError("%s: x_v, w and g must be bf16" % what)


def folded_mutan(x_v: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 hq: torch.Tensor) -> torch.Tensor:
    """The forward (see the module docstring).  On CPU tensors this is
    :func:`folded_mutan_plain`; on CUDA tensors it launches the kernel or
    raises.  Forward only: the gradient is ``ops/fusion.FoldedMutan``'s."""
    build.refuse_grad("folded_mutan", x_v, w, b, hq)
    if x_v.device.type == "cpu":
        return folded_mutan_plain(x_v, w, b, hq)
    return _fwd_launch(x_v, w, b, hq)


def _fwd_launch(x_v, w, b, hq, config=None):
    """The kernel at :func:`fwd_plan`'s pick, or at ``config`` (an (nb,
    nwg) pair of :data:`FWD_CONFIGS`: every one gives the same bits)."""
    _check("folded_mutan", x_v, w, b, hq)
    b16 = b.to(_BF16).contiguous()
    hq16 = hq.to(_BF16).contiguous()
    build.require_cuda("folded_mutan", x_v, w, b16, hq16)
    batch, k, dh = x_v.shape
    rank, m = hq.shape[1:]
    plan = _fwd_plan(batch, k, dh, rank, m, config)
    lib = _lib()
    out = torch.empty((batch, k, m), dtype=_BF16, device=x_v.device)
    rc = lib.vqacx_attmutan_fwd(build.ptr(x_v), build.ptr(w), build.ptr(b16),
                                build.ptr(hq16), build.ptr(out), batch, k, dh,
                                rank, m, plan["nb"], plan["nwg"],
                                plan["stages"], build.stream_of(x_v.device))
    build.check(lib, rc, "folded_mutan")
    spans.count("kernels.launches.attmutan")
    return out


def folded_mutan_bwd(x_v: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     hq: torch.Tensor, g: torch.Tensor):
    """The backward: (dx_v bf16, dw f32, db f32, dhq bf16), as
    :func:`folded_mutan_bwd_plain` on CPU tensors; on CUDA tensors the
    kernels or an error."""
    if x_v.device.type == "cpu":
        return folded_mutan_bwd_plain(x_v, w, b, hq, g)
    _check("folded_mutan_bwd", x_v, w, b, hq, g)
    b16 = b.to(_BF16).contiguous()
    hq16 = hq.to(_BF16).contiguous()
    build.require_cuda("folded_mutan_bwd", x_v, w, b16, hq16, g)
    batch, k, dh = x_v.shape
    rank, m = hq.shape[1:]
    plan = bwd_plan(batch, k, dh, rank, m)
    bounds = [lo for lo, _ in plan["groups"]] + [plan["groups"][-1][1]]
    lib = _lib()
    dev = x_v.device
    f32 = dict(dtype=torch.float32, device=dev)
    dxv = torch.empty((batch, k, dh), dtype=_BF16, device=dev)
    dhq = torch.empty((batch, rank, m), dtype=_BF16, device=dev)
    dw = torch.empty((rank * m, dh), **f32)
    db = torch.empty((rank * m,), **f32)
    pdhq = torch.empty(plan["scratch"]["pdhq"], **f32)
    gsum = torch.empty(plan["scratch"]["gsum"], **f32)
    rc = lib.vqacx_attmutan_bwd(
        build.ptr(x_v), build.ptr(w), build.ptr(b16), build.ptr(hq16),
        build.ptr(g), build.ptr(dxv), build.ptr(dhq), build.ptr(dw),
        build.ptr(db), build.ptr(pdhq), build.ptr(gsum), batch, k, dh, rank,
        m, (ctypes.c_int * len(bounds))(*bounds), plan["dx_stages"],
        build.stream_of(dev))
    build.check(lib, rc, "folded_mutan_bwd")
    spans.count("kernels.launches.attmutan_bwd")
    return dxv, dw, db, dhq


spans.declare("kernels.launches.attmutan", "kernels.launches.attmutan_bwd")
# the forward's plans, once per shape (the wrapper never modifies them)
_fwd_plan = functools.lru_cache(maxsize=64)(fwd_plan)


def _lib():
    lib = build.load("attmutan")
    if lib.vqacx_attmutan_fwd.argtypes is None:
        lib.vqacx_attmutan_smem.argtypes = [ctypes.c_int] * 7
        lib.vqacx_attmutan_smem.restype = ctypes.c_size_t
        # the plans' shared memory is fwd_smem's, dx_smem's and
        # dweff_smem's: once, at load, they are held equal to the kernels'
        # own counts over the plans' range
        for nb, nwg, most in FWD_CONFIGS:
            for dc, rank, stages in ((1, 1, 2), (5, 5, most), (25, 3, 2)):
                need = lib.vqacx_attmutan_smem(0, 64 * dc, rank, 64, stages,
                                               nb, nwg)
                if need != fwd_smem(nb, nwg, dc, rank, stages):
                    raise RuntimeError(
                        "folded_mutan: fwd_smem(%d, %d, %d, %d, %d) disagrees"
                        " with csrc/attmutan.cu's %d bytes"
                        % (nb, nwg, dc, rank, stages, need))
        for mc, rank, stages in ((1, 1, 2), (8, 5, 4), (8, 5, 3), (3, 7, 2)):
            need = lib.vqacx_attmutan_smem(1, 64, rank, 64 * mc, stages, 0, 0)
            if need != dx_smem(mc, rank, stages):
                raise RuntimeError(
                    "folded_mutan_bwd: dx_smem(%d, %d, %d) disagrees with "
                    "csrc/attmutan.cu's %d bytes" % (mc, rank, stages, need))
        if lib.vqacx_attmutan_smem(2, 64, 1, 64, 0, 0, 0) != dweff_smem():
            raise RuntimeError("folded_mutan_bwd: dweff_smem disagrees with "
                               "csrc/attmutan.cu's")
        lib.vqacx_attmutan_bwd.argtypes = [ctypes.c_void_p] * 11 \
            + [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int),
                                    ctypes.c_int, ctypes.c_void_p]
        lib.vqacx_attmutan_bwd.restype = ctypes.c_int
        lib.vqacx_attmutan_fwd.argtypes = [ctypes.c_void_p] * 5 \
            + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        lib.vqacx_attmutan_fwd.restype = ctypes.c_int
    return lib
