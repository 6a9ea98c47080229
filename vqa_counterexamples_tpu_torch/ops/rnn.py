"""The GRU over a question, eval mode (port of ``ops/rnn.py``).

The input projection for all timesteps is one (T*B, D) x (D, 3H) GEMM
computed time-major outside the recurrence; the recurrence then runs over
the (T, B, 3H) stack.  Gate convention (torch.nn.GRU and skip-thoughts)::

    r = sigmoid(W_ir x + b_ir + W_hr h + b_hr)
    z = sigmoid(W_iz x + b_iz + W_hz h + b_hz)
    n = tanh  (W_in x + b_in + r * (W_hn h + b_hn))
    h' = (1 - z) * n + z * h

Under the bf16 policy the projection stack is rounded to bf16 and the
recurrence is the CUDA kernel (``ops/cuda/gru_kernel.py``, state carried in
bf16, as the TPU kernel did); under f32 it is a plain f32 loop (the JAX
``lax.scan`` path).  Weights use the ``nn.GRUCell`` layout: ``weight_ih``
(3H, D), ``weight_hh`` (3H, H), gate-major rows r, z, n.
"""

from __future__ import annotations

import torch

from ..core.policy import compute_dtype, dot_f32
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


def _gru_loop_f32(x_proj: torch.Tensor, weight_hh: torch.Tensor,
                  bias_hh: torch.Tensor) -> torch.Tensor:
    seq_len, batch, h3 = x_proj.shape
    dim_h = h3 // 3
    w = weight_hh.t()
    h = x_proj.new_zeros((batch, dim_h))
    states = x_proj.new_empty((seq_len, batch, dim_h))
    for t in range(seq_len):
        hp = torch.matmul(h, w) + bias_hh
        xr, xz, xn = x_proj[t].split(dim_h, dim=-1)
        hr, hz, hn = hp.split(dim_h, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = (1.0 - z) * n + z * h
        states[t] = h
    return states


def gru_scan(weight_ih: torch.Tensor, bias_ih: torch.Tensor,
             weight_hh: torch.Tensor, bias_hh: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """Run the GRU over (B, T, D) -> all hidden states, time-major
    (T, B, H); h_0 = 0, no dropout (eval)."""
    batch, seq_len, dim_in = x.shape
    h3 = weight_ih.shape[0]
    xt = x.transpose(0, 1).reshape(seq_len * batch, dim_in)
    x_proj = (dot_f32(xt, weight_ih.t()) + bias_ih).reshape(seq_len, batch,
                                                            h3)
    if compute_dtype() == torch.bfloat16:
        states, _ = gru_recurrence(x_proj.to(torch.bfloat16),
                                   weight_hh.to(torch.bfloat16).contiguous(),
                                   bias_hh.float().contiguous())
    else:
        states = _gru_loop_f32(x_proj, weight_hh, bias_hh)
    return states
