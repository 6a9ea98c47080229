"""The recurrences over a question (port of ``ops/rnn.py``): the GRU, with
variational dropout in training, and the LSTM.

The input projection for all timesteps is computed time-major outside the
recurrence (``ops/cuda/xproj_kernel.py``: policy-dtype operands, f32
accumulation and bias, one rounding; on the tensor cores under the bf16
policy); the recurrence then runs over the (T, B, 3H) stack.  Gate
convention (torch.nn.GRU and skip-thoughts)::

    r = sigmoid(W_ir x + b_ir + W_hr h + b_hr)
    z = sigmoid(W_iz x + b_iz + W_hz h + b_hz)
    n = tanh  (W_in x + b_in + r * (W_hn h + b_hn))
    h' = (1 - z) * n + z * h

"Bayesian" (variational) dropout draws one mask per sequence, shared across
timesteps: by default six independent masks, one per gate on each side
((3, B, D) on the input, (3, B, H) on the state), as skip-thoughts.torch's
BayesianGRU; one (B, D) and one (B, H) mask with
``VQACX_GRU_SHARED_MASKS=1``.  The carry term ``z * h`` reads the raw state.

Under the bf16 policy the projection stack is rounded to bf16 and the
recurrence is the CUDA kernel (``ops/cuda/gru_kernel.py``, state carried in
bf16, as the TPU kernel did; through its autograd Function when a weight
needs a gradient); under f32 it is a plain f32 loop under autograd (the
JAX ``lax.scan`` paths).  Weights use the ``nn.GRUCell`` layout:
``weight_ih`` (3H, D), ``weight_hh`` (3H, H), gate-major rows r, z, n.

The LSTM (:func:`lstm_scan`, gate rows i, f, g, o as ``nn.LSTM``'s) is
plain PyTorch under autograd at both policies, JAX's default branch step
for step: the JAX package has no Pallas LSTM kernel, and cuDNN's
``nn.LSTM`` rounds elsewhere.
"""

from __future__ import annotations

import os

import torch

from ..core import rng as rng_lib
from ..core.policy import cast_in, compute_dtype, dot_f32
from .cuda import gru_kernel, xproj_kernel
from .cuda.gru_kernel import gru_recurrence


def process_lengths(wids: torch.Tensor) -> torch.Tensor:
    """Length = maxlength - (#zero tokens)."""
    return wids.shape[1] - (wids == 0).sum(dim=1)


def select_last_tm(states_tm: torch.Tensor,
                   lengths: torch.Tensor) -> torch.Tensor:
    """Hidden state at timestep ``length - 1`` of time-major (T, B, H)
    states (lengths clipped into [1, T])."""
    seq_len, batch = states_tm.shape[:2]
    idx = (lengths.long() - 1).clamp(0, seq_len - 1)
    return states_tm[idx, torch.arange(batch, device=states_tm.device)]


def per_gate_masks() -> bool:
    """Six independent masks (the default) unless
    ``VQACX_GRU_SHARED_MASKS=1`` (``models/seq2vec.py:116`` of the JAX
    package); read at call time."""
    return os.environ.get("VQACX_GRU_SHARED_MASKS", "0") != "1"


def variational_masks(generator: torch.Generator, dropout: float,
                      batch: int, dim_in: int, dim_h: int,
                      per_gate: bool = True):
    """(mask_x, mask_h) f32 inverted-dropout masks, one per sequence:
    (3, B, D) and (3, B, H) per gate, or (B, D) and (B, H) shared.  The
    input mask is drawn first, then the state mask, from ``generator``."""
    lead = (3,) if per_gate else ()
    keep_x, scale_x = rng_lib.keep_mask(lead + (batch, dim_in),
                                        1.0 - dropout, generator, len(lead))
    keep_h, scale_h = rng_lib.keep_mask(lead + (batch, dim_h),
                                        1.0 - dropout, generator, len(lead))
    return keep_x.float() * scale_x, keep_h.float() * scale_h


def _gru_loop_f32(x_proj: torch.Tensor, weight_hh: torch.Tensor,
                  bias_hh: torch.Tensor,
                  mask_h: torch.Tensor | None) -> torch.Tensor:
    """The f32 recurrence under autograd: one (B, H) x (H, 3H) GEMM a step
    on h * mask, or three (one per gate) with per-gate masks."""
    seq_len, batch, h3 = x_proj.shape
    dim_h = h3 // 3
    h = x_proj.new_zeros((batch, dim_h))
    per_gate = mask_h is not None and mask_h.dim() == 3
    w = weight_hh.t()
    states = []
    for t in range(seq_len):
        if per_gate:
            hp = torch.cat([
                torch.matmul(h * mask_h[g],
                             weight_hh[g * dim_h:(g + 1) * dim_h].t())
                + bias_hh[g * dim_h:(g + 1) * dim_h] for g in range(3)],
                dim=-1)
        else:
            h_in = h if mask_h is None else h * mask_h
            hp = torch.matmul(h_in, w) + bias_hh
        xr, xz, xn = x_proj[t].split(dim_h, dim=-1)
        hr, hz, hn = hp.split(dim_h, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = (1.0 - z) * n + z * h
        states.append(h)
    return torch.stack(states)


def gru_scan(weight_ih: torch.Tensor, bias_ih: torch.Tensor,
             weight_hh: torch.Tensor, bias_hh: torch.Tensor,
             x: torch.Tensor, mask_x: torch.Tensor | None = None,
             mask_h: torch.Tensor | None = None) -> torch.Tensor:
    """Run the GRU over (B, T, D) -> all hidden states, time-major
    (T, B, H); h_0 = 0.  ``mask_x`` / ``mask_h``: variational dropout masks
    (see :func:`variational_masks`), None for none."""
    if compute_dtype() == torch.bfloat16:
        x_proj = xproj_kernel.x_proj(x, mask_x, weight_ih, bias_ih)
        w_hh = weight_hh.to(torch.bfloat16).contiguous()
        b_hh = bias_hh.float().contiguous()
        # the kernel's recurrent mask is bf16: the 0.25 scale 256/192
        # rounds to 1.3359375 there, as in the JAX package (rnn.py:284-288)
        mask = (None if mask_h is None
                else mask_h.to(torch.bfloat16).contiguous())
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (x_proj, w_hh, b_hh)):
            return gru_kernel.gru_recurrence_train(x_proj, w_hh, b_hh, mask)
        states, _ = gru_recurrence(x_proj, w_hh, b_hh, mask)
        return states
    x_proj = xproj_kernel.x_proj_plain(x, mask_x, weight_ih, bias_ih,
                                       torch.float32)
    return _gru_loop_f32(x_proj, weight_hh, bias_hh, mask_h)


def lstm_scan(weight_ih: torch.Tensor, bias_ih: torch.Tensor,
              weight_hh: torch.Tensor, bias_hh: torch.Tensor,
              x_tm: torch.Tensor) -> torch.Tensor:
    """Run an LSTM over time-major (T, B, D) inputs -> all hidden states
    (T, B, H), h_0 = c_0 = 0 (JAX ``lstm_scan`` with ``time_major_in`` /
    ``_out``, its default branch).  The input projections of every step in
    one product (policy-dtype operands, f32 accumulation and bias), then
    rounded to the policy dtype; each step adds h (rounded to the policy
    dtype) times ``weight_hh`` with f32 accumulation, and ``bias_hh``; the
    gates, c and h in f32.  Stacked layers chain time-major."""
    seq_len, batch, dim_in = x_tm.shape
    h4 = weight_ih.shape[0]
    dim_h = h4 // 4
    x_proj = dot_f32(x_tm.reshape(seq_len * batch, dim_in),
                     weight_ih.t()) + bias_ih
    x_proj = x_proj.reshape(seq_len, batch, h4).to(compute_dtype())
    # the products of policy-dtype values are exact in f32: rounding the
    # weight once and multiplying in f32 gives JAX's f32-accumulated dot
    w = cast_in(weight_hh.t()).float()
    h = x_tm.new_zeros((batch, dim_h), dtype=torch.float32)
    c = torch.zeros_like(h)
    states = []
    for t in range(seq_len):
        gates = (x_proj[t].float() + torch.matmul(cast_in(h).float(), w)
                 + bias_hh)
        i, f, g, o = gates.split(dim_h, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        states.append(h)
    return torch.stack(states)
