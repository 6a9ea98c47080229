"""GRU recurrence kernel (CUDA, ``csrc/gru.cu``) and its plain PyTorch
version.

Replaces the TPU kernel ``vqa_counterexamples_tpu/ops/pallas/gru_kernel.py``
``gru_fwd_pallas`` (its shared-mask ``_fwd_kernel``), reached through
``ops/rnn.gru_scan`` when the question-embedding cache is built.

Math per timestep, h_0 = 0 (``ops/rnn.py:524-533`` of the JAX package)::

    h_proj = bf16(h_{t-1} * mask) @ W_hh^T + b_hh        (f32 accumulation)
    r = sigmoid(x_r + h_r); z = sigmoid(x_z + h_z); n = tanh(x_n + r * h_n)
    h_t = bf16((1 - z) * n + z * h_{t-1})

What bounds it on the H100: one timestep is a (B, H) x (H, 3H) GEMM — at
the flagship shape (B=2048, H=2400) 70.8 GFLOP on 34.6 MB of bf16 W_hh —
followed by elementwise gate math.  The TPU kernel kept h in VMEM across a
sequential grid and updated it in place behind a snapshot; CUDA blocks run
in no order and cannot synchronise across the grid, so the design is one
launch per timestep (T launches from one C call), each reading
``states[t-1]`` and writing ``states[t]`` — ping-pong with no in-place
hazard.  W_hh (34.6 MB) fits in the 50 MB L2, so after the first timestep
the per-step weight re-reads are served from L2, not HBM.  Each block owns
a (64 batch rows x 32 hidden units) tile and computes all three gates'
columns for those units with bf16 WMMA fragments (f32 accumulators), so
the gate epilogue needs no exchange between blocks and h_proj never
reaches device memory unless asked for.

The (B, H) variational-dropout mask operand and the optional ``h_proj``
output are kept for the training path (the backward recomputes gates from
them); the eval path passes no mask (ones).
"""

from __future__ import annotations

import ctypes

import torch

from . import build

_BF16 = torch.bfloat16


def gru_recurrence_plain(xp: torch.Tensor, w_hh: torch.Tensor,
                         b_hh: torch.Tensor, mask: torch.Tensor | None = None,
                         want_hproj: bool = False):
    """Plain PyTorch version with the kernel's rounding points.

    xp (T, B, 3H) bf16 input projections, gate-major columns [r | z | n];
    w_hh (3H, H) bf16 (``nn.GRUCell.weight_hh`` layout); b_hh (3H,) f32;
    mask (B, H) bf16 or None (ones).  Returns (states (T, B, H) bf16,
    h_proj (T, B, 3H) bf16 or None).
    """
    seq_len, batch, h3 = xp.shape
    dim_h = h3 // 3
    w = w_hh.to(_BF16).float().t()
    b = b_hh.float()
    h = torch.zeros((batch, dim_h), dtype=_BF16, device=xp.device)
    states = torch.empty((seq_len, batch, dim_h), dtype=_BF16,
                         device=xp.device)
    hprojs = [] if want_hproj else None
    for t in range(seq_len):
        h_in = h if mask is None else h * mask.to(_BF16)
        hp = torch.matmul(h_in.float(), w) + b
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


def gru_recurrence(xp: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                   mask: torch.Tensor | None = None,
                   want_hproj: bool = False):
    """The recurrence over a whole sequence (see the module docstring).

    On a CPU tensor this is :func:`gru_recurrence_plain`; on a CUDA tensor
    it launches the kernel (T launches) or raises.  Forward only: an
    operand that requires grad (with grad mode on) raises.
    """
    build.refuse_grad("gru_recurrence", xp, w_hh, b_hh, mask)
    if xp.device.type == "cpu":
        return gru_recurrence_plain(xp, w_hh, b_hh, mask, want_hproj)
    seq_len, batch, h3 = xp.shape
    dim_h = h3 // 3
    if (h3 != 3 * dim_h or tuple(w_hh.shape) != (h3, dim_h)
            or tuple(b_hh.shape) != (h3,)):
        raise ValueError("gru_recurrence: xp %s, w_hh %s, b_hh %s"
                         % (tuple(xp.shape), tuple(w_hh.shape),
                            tuple(b_hh.shape)))
    if xp.dtype != _BF16 or w_hh.dtype != _BF16 or b_hh.dtype != torch.float32:
        raise ValueError("gru_recurrence: xp/w_hh bf16 and b_hh f32, got "
                         "%s/%s/%s" % (xp.dtype, w_hh.dtype, b_hh.dtype))
    operands = [xp, w_hh, b_hh]
    if mask is not None:
        if tuple(mask.shape) != (batch, dim_h) or mask.dtype != _BF16:
            raise ValueError("gru_recurrence: mask must be (B, H) bf16")
        operands.append(mask)
    build.require_cuda("gru_recurrence", *operands)
    lib = _lib()
    states = torch.empty((seq_len, batch, dim_h), dtype=_BF16,
                         device=xp.device)
    hproj = (torch.empty((seq_len, batch, h3), dtype=_BF16, device=xp.device)
             if want_hproj else None)
    rc = lib.vqacx_gru_fwd(build.ptr(xp), build.ptr(w_hh), build.ptr(b_hh),
                           build.ptr(mask), build.ptr(states),
                           build.ptr(hproj), seq_len, batch, dim_h,
                           build.stream_of(xp.device))
    build.check(lib, rc, "gru_recurrence")
    gru_recurrence.launches += 1
    return states, hproj


# one count per call that launches the kernel (T launches, one per step)
gru_recurrence.launches = 0


def _lib():
    lib = build.load("gru")
    fn = lib.vqacx_gru_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
