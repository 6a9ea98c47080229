"""GRU recurrence kernels (CUDA, ``csrc/gru.cu``), forward and backward,
their plain PyTorch versions and the autograd Function that joins them.

Replaces the TPU kernels of ``vqa_counterexamples_tpu/ops/pallas/
gru_kernel.py``: ``gru_fwd_pallas`` (the shared-mask ``_fwd_kernel`` and the
per-gate ``_fwd_kernel_pg``) and ``gru_bwd_pallas`` (``_bwd_kernel`` /
``_bwd_kernel_pg``), reached through ``ops/rnn.gru_scan``: the forward
alone when the question-embedding cache is built or a batch is evaluated,
both through :class:`GRURecurrence` when the encoder trains.

Math per timestep, h_0 = 0 (``ops/rnn.py:524-533`` of the JAX package),
with one mask per gate (r, z, n; the three are one tensor for a shared
(B, H) mask, ones without dropout)::

    h_proj_g = bf16(h_{t-1} * mask_g) @ W_g^T + b_g      (f32 accumulation)
    r = sigmoid(x_r + h_r); z = sigmoid(x_z + h_z); n = tanh(x_n + r * h_n)
    h_t = bf16((1 - z) * n + z * h_{t-1})

and in reverse, with the f32 state cotangent dh carried from t + 1::

    g = ds_t + dh;   dn = g (1 - z);   dsz = g (h_{t-1} - n) z (1 - z)
    dsn = dn (1 - n^2);   dhn = dsn r;   dsr = dsn h_n r (1 - r)
    dxp_t = bf16([dsr, dsz, dsn]);   dh_proj_t = bf16([dsr, dsz, dhn])
    dh <- g z + sum_g (dh_proj_g @ W_g) * mask_g                (f32)
    dW_g = sum_t dh_proj_g^T bf16(h_{t-1} * mask_g),   db = sum_t dh_proj

What bounds them on the H100: each timestep is a (B, H) x (H, 3H) GEMM in
either direction — at VQA pretraining's shape (B=512, H=2400) 17.7 GFLOP
per step on 34.6 MB of bf16 W_hh — followed by elementwise gate math.  The
TPU kernels kept h (forward) and dh (backward) in VMEM across a sequential
grid; CUDA blocks run in no order and cannot synchronise across the grid,
so the design is one launch per timestep in both directions (T launches
from one C call).  W_hh fits in the 50 MB L2, so after the first step the
operands come from L2.  What a forward step costs on the card is latency,
of the ring's loads and of the gate epilogue's, more than the bytes its
blocks pull from L2 (halving those with clusters did not help).

The forward reads ``states[t-1]`` and writes ``states[t]``.  A block owns
BM batch rows x BJ hidden units and all three gates' columns for those
units, so the gate epilogue needs no exchange between blocks.  The masked
operand bf16(h * mask_g) is made once a step, in the epilogue of the step
that writes h, into a ping-pong scratch the wrapper allocates (JAX's
``hin_scr`` snapshot); without a mask the operand is ``states[t-1]``.  A
producer warp streams A and W tiles through a TMA + mbarrier ring, and
one or two consumer warpgroups run ``wgmma`` per gate on them; the sums
then go through shared memory so that the gate math loads and stores 16
bytes at a time along rows.  :func:`fwd_tile` picks (BM, BJ, BK,
stages) from (B, H, gates) and the SM count: one wave of blocks where it
can, the fewest L2 bytes per block.  Shapes off TMA's rules (H % 8 != 0,
unaligned operands) run the same kernel template with plain loads
(``tma=False``).

The backward's launch for step s first adds step s + 1's back product
``dh_proj @ W`` to the f32 carry (it needs whole dh_proj rows, a
grid-wide dependency, hence a launch per step), then runs step s's gate
math in the same block's epilogue: the carry makes one round trip per
step.  A backward block owns 64 rows x 32 hidden units, so B 128 gives
150 blocks for the H100's 132 SMs, and holds one accumulator per gate over
one K loop of depth 3H: bf16 ``mma.sync`` fed by a 3-stage ``cp.async``
ring, W read MN-major through ``ldmatrix.trans``.  The gates fold into dh
with each gate's mask in JAX's order r, z, n; the shared-mask case is the
same kernels with a gate stride of 0.  No atomics: reruns are bit-equal.

The backward does not compute the mask's cotangent (JAX's kernel does):
the masks are drawn, never trained, so nothing consumes it.  dW and db are
sums over all timesteps outside the TPU kernel too (``gru_kernel.py:
505-532`` of the JAX package); here they are ``torch.matmul`` / ``sum``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from . import build

_BF16 = torch.bfloat16

# The forward's kernel instances (``VQACX_FWD_TILES`` in csrc/gru.cu), each
# for one and for three gate masks: (BM, BJ, BK) of the TMA path, and the
# one tile of the plain-load path for shapes off TMA's rules.  A mirror of
# the C table, not read from the library, so that the chooser runs (and is
# tested) where nothing is built; a CPU test holds the two equal.
FWD_TILES = ((128, 80, 64), (128, 80, 32), (64, 40, 64))
RAGGED_TILE = (64, 40, 64)
# shared memory a block may use on the H100 (232,448 bytes), less the
# kernel's alignment slack; the ring's depth is capped where more stages
# stopped helping (cli/probe_kernels.py's tile sweep: with per-gate masks
# 5 stages were slower than 4 at every batch)
SMEM_BLOCK = 232448 - 1024
MAX_STAGES = 6
MAX_STAGES_PER_GATE = 4


class FwdTile(NamedTuple):
    """A forward launch's tile: BM batch rows x BJ hidden units a block,
    BK deep stages, ``stages`` of them in the ring, TMA or plain loads."""
    bm: int
    bj: int
    bk: int
    stages: int
    tma: bool


def fwd_stage_bytes(gates: int, bm: int, bj: int, bk: int) -> int:
    """One ring stage: an A box per gate mask (one without or with one
    shared mask), three W boxes each in a 1024-byte slot, plus its two
    mbarriers."""
    ng = 3 if gates == 3 else 1
    return ng * bm * bk * 2 + 3 * (-(-bj * bk * 2 // 1024) * 1024) + 16


def fwd_max_stages(gates: int, bm: int, bj: int, bk: int) -> int:
    """The deepest ring of this tile that fits a block's shared memory,
    capped at MAX_STAGES (MAX_STAGES_PER_GATE with per-gate masks)."""
    cap = MAX_STAGES_PER_GATE if gates == 3 else MAX_STAGES
    return min(cap, SMEM_BLOCK // fwd_stage_bytes(gates, bm, bj, bk))


def fwd_tile(batch: int, dim_h: int, gates: int, sm_count: int,
             tma: bool = True) -> FwdTile:
    """The forward's tile for (B, H, mask gates 0 / 1 / 3) on a card of
    ``sm_count`` SMs.  Off TMA's rules the plain-load tile; else the TMA
    tile whose blocks pull the fewest bytes each wave, waves x (A rows x
    gates + W rows) x H: one wave where the grid allows it (B 128 takes
    64 x 40, 120 blocks; B 512 128 x 80, 120 blocks), taller and wider
    tiles as the batch grows, so A and W are re-read fewer times.  Ties go
    to the earlier entry of FWD_TILES.  The ring is as deep as
    :func:`fwd_max_stages` allows."""
    ng = 3 if gates == 3 else 1
    if not tma:
        return FwdTile(*RAGGED_TILE, fwd_max_stages(gates, *RAGGED_TILE),
                       False)
    best = None
    for bm, bj, bk in FWD_TILES:
        blocks = -(-batch // bm) * -(-dim_h // bj)
        cost = math.ceil(blocks / sm_count) * (ng * bm + 3 * bj)
        stages = fwd_max_stages(gates, bm, bj, bk)
        if stages >= 3 and (best is None or cost < best[0]):
            best = (cost, FwdTile(bm, bj, bk, stages, True))
    return best[1]


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def forward_tile(xp: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                 mask: torch.Tensor | None = None) -> FwdTile:
    """The tile :func:`gru_recurrence` launches with on these operands (a
    CUDA tensor's): TMA needs H % 8 == 0 and 16-byte aligned operands."""
    batch, dim_h = xp.shape[1], xp.shape[2] // 3
    tma = dim_h % 8 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (xp, w_hh, b_hh, mask)
        if t is not None)
    return fwd_tile(batch, dim_h, _mask_gates(mask), _sm_count(xp.device),
                    tma)


def _mask_gates(mask: torch.Tensor | None) -> int:
    """0 (no mask), 1 (one (B, H) mask) or 3 ((3, B, H), one per gate)."""
    return 0 if mask is None else (3 if mask.dim() == 3 else 1)


def _gate_masks(mask: torch.Tensor | None):
    """The (r, z, n) masks as f32 tensors (None without a mask)."""
    if mask is None:
        return (None, None, None)
    m = mask.float()
    return tuple(m[g] for g in range(3)) if m.dim() == 3 else (m, m, m)


def gru_recurrence_plain(xp: torch.Tensor, w_hh: torch.Tensor,
                         b_hh: torch.Tensor, mask: torch.Tensor | None = None,
                         want_hproj: bool = False):
    """Plain PyTorch version with the kernel's rounding points.

    xp (T, B, 3H) bf16 input projections, gate-major columns [r | z | n];
    w_hh (3H, H) bf16 (``nn.GRUCell.weight_hh`` layout); b_hh (3H,) f32;
    mask (B, H) or (3, B, H) bf16 or None (ones).  Returns (states
    (T, B, H) bf16, h_proj (T, B, 3H) bf16 or None).
    """
    seq_len, batch, h3 = xp.shape
    dim_h = h3 // 3
    w = w_hh.to(_BF16).float()
    b = b_hh.float()
    h = torch.zeros((batch, dim_h), dtype=_BF16, device=xp.device)
    states = torch.empty((seq_len, batch, dim_h), dtype=_BF16,
                         device=xp.device)
    hprojs = [] if want_hproj else None
    per_gate = _mask_gates(mask) == 3
    for t in range(seq_len):
        if per_gate:
            m = mask.to(_BF16)
            hp = torch.cat([
                torch.matmul((h * m[g]).float(),
                             w[g * dim_h:(g + 1) * dim_h].t())
                for g in range(3)], dim=-1) + b
        else:
            h_in = h if mask is None else h * mask.to(_BF16)
            hp = torch.matmul(h_in.float(), w.t()) + b
        xr, xz, xn = xp[t].float().split(dim_h, dim=-1)
        hr, hz, hn = hp.split(dim_h, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = ((1.0 - z) * n + z * h.float()).to(_BF16)
        states[t] = h
        if want_hproj:
            hprojs.append(hp.to(_BF16))
    return states, (torch.stack(hprojs) if want_hproj else None)


def _check_operands(what, xp, w_hh, mask):
    seq_len, batch, h3 = xp.shape
    dim_h = h3 // 3
    if h3 != 3 * dim_h or tuple(w_hh.shape) != (h3, dim_h):
        raise ValueError("%s: xp %s, w_hh %s"
                         % (what, tuple(xp.shape), tuple(w_hh.shape)))
    if xp.dtype != _BF16 or w_hh.dtype != _BF16:
        raise ValueError("%s: xp/w_hh bf16, got %s/%s"
                         % (what, xp.dtype, w_hh.dtype))
    if mask is not None and (
            tuple(mask.shape) not in ((batch, dim_h), (3, batch, dim_h))
            or mask.dtype != _BF16):
        raise ValueError("%s: mask must be (B, H) or (3, B, H) bf16, got %s "
                         "%s" % (what, tuple(mask.shape), mask.dtype))
    return seq_len, batch, dim_h


def gru_recurrence(xp: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                   mask: torch.Tensor | None = None,
                   want_hproj: bool = False):
    """The recurrence over a whole sequence (see the module docstring).

    On a CPU tensor this is :func:`gru_recurrence_plain`; on a CUDA tensor
    it launches the kernel with :func:`forward_tile`'s tile (T launches)
    or raises.  A (3, B, H) mask takes the per-gate variant, counted on
    :func:`gru_recurrence_pg`.  Forward only: an operand that requires
    grad (with grad mode on) raises; the trainable recurrence is
    :class:`GRURecurrence`.
    """
    build.refuse_grad("gru_recurrence", xp, w_hh, b_hh, mask)
    if xp.device.type == "cpu":
        return gru_recurrence_plain(xp, w_hh, b_hh, mask, want_hproj)
    return _gru_fwd(xp, w_hh, b_hh, mask, want_hproj, None)


def _gru_fwd(xp, w_hh, b_hh, mask, want_hproj, tile: FwdTile | None):
    """Launch the forward on CUDA tensors with ``tile`` (None: the one
    :func:`forward_tile` picks).  The probe's tile sweep and the every-tile
    card test pass a tile; every tile gives the same bits."""
    seq_len, batch, dim_h = _check_operands("gru_recurrence", xp, w_hh,
                                            mask)
    if tuple(b_hh.shape) != (3 * dim_h,) or b_hh.dtype != torch.float32:
        raise ValueError("gru_recurrence: b_hh must be (3H,) f32")
    gates = _mask_gates(mask)
    build.require_cuda("gru_recurrence", xp, w_hh, b_hh,
                       *([mask] if mask is not None else []))
    tile = tile or forward_tile(xp, w_hh, b_hh, mask)
    lib = _lib()
    states = torch.empty((seq_len, batch, dim_h), dtype=_BF16,
                         device=xp.device)
    hproj = (torch.empty((seq_len, batch, 3 * dim_h), dtype=_BF16,
                         device=xp.device) if want_hproj else None)
    # bf16(h_t * mask_g) for step t + 1, two slots used in turn
    scratch = (torch.empty((2, 3 if gates == 3 else 1, batch, dim_h),
                           dtype=_BF16, device=xp.device) if gates else None)
    rc = lib.vqacx_gru_fwd(build.ptr(xp), build.ptr(w_hh), build.ptr(b_hh),
                           build.ptr(mask), gates, build.ptr(states),
                           build.ptr(hproj), build.ptr(scratch), seq_len,
                           batch, dim_h, tile.bm, tile.bj, tile.bk,
                           int(tile.tma), tile.stages,
                           build.stream_of(xp.device))
    build.check(lib, rc, "gru_recurrence (tile %s)" % (tile,))
    if gates == 3:
        gru_recurrence_pg.launches += 1
    else:
        gru_recurrence.launches += 1
    return states, hproj


def gru_recurrence_pg(xp: torch.Tensor, w_hh: torch.Tensor,
                      b_hh: torch.Tensor, mask: torch.Tensor,
                      want_hproj: bool = False):
    """:func:`gru_recurrence` with one mask per gate, (3, B, H) bf16."""
    if mask is None or mask.dim() != 3:
        raise ValueError("gru_recurrence_pg takes a (3, B, H) mask")
    return gru_recurrence(xp, w_hh, b_hh, mask, want_hproj)


# one count per call that launches a forward kernel (T launches, one per
# step): the shared-mask (or unmasked) variant here, the per-gate one on
# gru_recurrence_pg
gru_recurrence.launches = 0
gru_recurrence_pg.launches = 0


def _weight_grads(dhproj, states, mask, dim_h):
    """dW (3H, H) bf16 and db (3H,) f32 from the gate cotangents: dW_g =
    dh_proj_g^T bf16(h_{t-1} * mask_g) summed over (t, b) with f32
    accumulation and one rounding, db the f32 sum of dh_proj."""
    seq_len, batch = states.shape[:2]
    h_prev = torch.cat([torch.zeros_like(states[:1]), states[:-1]])
    h_prev = h_prev.reshape(seq_len * batch, dim_h)
    dhp = dhproj.reshape(seq_len * batch, 3 * dim_h)
    db = dhp.float().sum(dim=0)
    masks = _gate_masks(mask)
    if _mask_gates(mask) == 3:
        dw = torch.cat([
            torch.matmul(dhp[:, g * dim_h:(g + 1) * dim_h].t(),
                         (h_prev.float() * masks[g].repeat(seq_len, 1))
                         .to(_BF16))
            for g in range(3)])
    else:
        h_in = h_prev if mask is None else (
            h_prev.float() * masks[0].repeat(seq_len, 1)).to(_BF16)
        dw = torch.matmul(dhp.t(), h_in)
    return dw.to(_BF16), db


def gru_recurrence_bwd_plain(xp: torch.Tensor, w_hh: torch.Tensor,
                             mask: torch.Tensor | None,
                             states: torch.Tensor, hproj: torch.Tensor,
                             dstates: torch.Tensor):
    """Plain PyTorch version of the backward, the reverse scan of the JAX
    package's ``_bwd_scan_pg`` (``gru_kernel.py:603-664``) with the
    kernel's rounding points: the gate cotangents rounded to bf16, the back
    product ``bf16(dh_proj_g) @ W_g`` in f32, the carry in f32.

    xp, hproj (T, B, 3H) bf16; w_hh (3H, H) bf16; mask as for the forward;
    states, dstates (T, B, H) bf16.  Returns (dxp (T, B, 3H) bf16, dW_hh
    (3H, H) bf16, db_hh (3H,) f32).
    """
    seq_len, batch, h3 = xp.shape
    dim_h = h3 // 3
    w = w_hh.to(_BF16).float()
    masks = _gate_masks(mask)
    dxp = torch.empty_like(xp, dtype=_BF16)
    dhproj = torch.empty_like(xp, dtype=_BF16)
    dh = torch.zeros((batch, dim_h), dtype=torch.float32, device=xp.device)
    for t in range(seq_len - 1, -1, -1):
        g = dstates[t].float() + dh
        xr, xz, xn = xp[t].float().split(dim_h, dim=-1)
        hr, hz, hn = hproj[t].float().split(dim_h, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        hprev = (states[t - 1].float() if t > 0 else
                 torch.zeros_like(g))
        dn = g * (1.0 - z)
        dsz = g * (hprev - n) * z * (1.0 - z)
        dsn = dn * (1.0 - n * n)
        dhn = dsn * r
        dsr = dsn * hn * r * (1.0 - r)
        dxp[t] = torch.cat([dsr, dsz, dsn], dim=-1).to(_BF16)
        dhproj[t] = torch.cat([dsr, dsz, dhn], dim=-1).to(_BF16)
        dh = g * z
        if t == 0:
            break  # the carry into h_{-1} is never used
        for gi in range(3):
            part = dhproj[t, :, gi * dim_h:(gi + 1) * dim_h].float()
            back = torch.matmul(part, w[gi * dim_h:(gi + 1) * dim_h])
            dh = dh + (back if masks[gi] is None else back * masks[gi])
    dw, db = _weight_grads(dhproj, states, mask, dim_h)
    return dxp, dw, db


def gru_recurrence_bwd(xp: torch.Tensor, w_hh: torch.Tensor,
                       mask: torch.Tensor | None, states: torch.Tensor,
                       hproj: torch.Tensor, dstates: torch.Tensor):
    """The backward over the forward's residuals (see the module
    docstring) -> (dxp, dW_hh bf16, db_hh f32).

    On CPU tensors this is :func:`gru_recurrence_bwd_plain`; on CUDA
    tensors it launches the reverse sweep (T launches) or raises.
    """
    if xp.device.type == "cpu":
        return gru_recurrence_bwd_plain(xp, w_hh, mask, states, hproj,
                                        dstates)
    seq_len, batch, dim_h = _check_operands("gru_recurrence_bwd", xp, w_hh,
                                            mask)
    for name, t in (("states", states), ("dstates", dstates)):
        if tuple(t.shape) != (seq_len, batch, dim_h) or t.dtype != _BF16:
            raise ValueError("gru_recurrence_bwd: %s must be (T, B, H) bf16"
                             % name)
    if tuple(hproj.shape) != tuple(xp.shape) or hproj.dtype != _BF16:
        raise ValueError("gru_recurrence_bwd: hproj must be (T, B, 3H) bf16")
    build.require_cuda("gru_recurrence_bwd", xp, w_hh, states, hproj,
                       dstates, *([mask] if mask is not None else []))
    lib = _lib()
    dxp = torch.empty_like(xp)
    dhproj = torch.empty_like(xp)
    dh = torch.empty((batch, dim_h), dtype=torch.float32, device=xp.device)
    rc = lib.vqacx_gru_bwd(build.ptr(xp), build.ptr(w_hh), build.ptr(mask),
                           _mask_gates(mask), build.ptr(states),
                           build.ptr(hproj), build.ptr(dstates),
                           build.ptr(dxp), build.ptr(dhproj), build.ptr(dh),
                           seq_len, batch, dim_h, build.stream_of(xp.device))
    build.check(lib, rc, "gru_recurrence_bwd")
    gru_recurrence_bwd.launches += 1
    dw, db = _weight_grads(dhproj, states, mask, dim_h)
    return dxp, dw, db


# one count per call that launches the reverse sweep (T launches)
gru_recurrence_bwd.launches = 0


class GRURecurrence(torch.autograd.Function):
    """The trainable recurrence: the forward kernel with ``want_hproj``,
    saving (xp, states, h_proj, mask, W_hh), and the backward kernel.
    Gradients reach xp (bf16), W_hh (bf16, the weights' dtype, as the JAX
    package's VJP rounds it) and b_hh (f32); the mask gets none.  On CPU
    tensors both directions are the plain versions."""

    @staticmethod
    def forward(ctx, xp, w_hh, b_hh, mask):
        states, hproj = gru_recurrence(xp, w_hh, b_hh, mask, want_hproj=True)
        ctx.save_for_backward(xp, w_hh, mask, states, hproj)
        return states

    @staticmethod
    def backward(ctx, dstates):
        xp, w_hh, mask, states, hproj = ctx.saved_tensors
        dxp, dw, db = gru_recurrence_bwd(xp, w_hh, mask, states, hproj,
                                         dstates.to(_BF16).contiguous())
        return dxp, dw, db, None


def gru_recurrence_train(xp, w_hh, b_hh, mask=None) -> torch.Tensor:
    """(T, B, H) bf16 states through :class:`GRURecurrence`."""
    return GRURecurrence.apply(xp, w_hh, b_hh, mask)


def _lib():
    lib = build.load("gru")
    # (name, pointer arguments before mask_gates, pointer arguments after,
    # int arguments before the stream)
    for name, before, after, ints in (("vqacx_gru_fwd", 4, 3, 8),
                                      ("vqacx_gru_bwd", 3, 6, 3)):
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = ([ctypes.c_void_p] * before + [ctypes.c_int]
                           + [ctypes.c_void_p] * after
                           + [ctypes.c_int] * ints + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
    return lib
