"""MUTAN's Tucker rank fusion op (port of ``ops/fusion.py``)::

    x_mm = sum_r (x_v @ Wv_r^T + bv_r) * (x_q @ Wq_r^T + bq_r)

Weights come rank-major in the reference's per-rank ``Linear`` layout,
stacked: w_v (R*dmm, dhv), b_v (R*dmm,).  Under the bf16 policy on the card
the forward is the CUDA kernel (``ops/cuda/mutan_kernel.py``) behind
:class:`TuckerFusion`, whose backward recomputes both projections (cheaper
than keeping the (B, R*dmm) intermediates, as ``_tucker_bwd`` of the JAX
package does); elsewhere it is the plain autograd path.
"""

from __future__ import annotations

import torch

from ..core.policy import cast_in, compute_dtype, dot_f32
from .cuda import mutan_kernel


def tucker_rank_fusion(x_v: torch.Tensor, x_q: torch.Tensor,
                       w_v: torch.Tensor, b_v: torch.Tensor,
                       w_q: torch.Tensor, b_q: torch.Tensor,
                       rank: int) -> torch.Tensor:
    """The plain op (JAX ``tucker_rank_fusion``): operands in the policy
    dtype, f32 accumulation and biases, (B, dmm) f32."""
    batch = x_v.shape[0]
    dmm = w_v.shape[0] // rank
    hv = (dot_f32(x_v, w_v.t()) + b_v).reshape(batch, rank, dmm)
    hq = (dot_f32(x_q, w_q.t()) + b_q).reshape(batch, rank, dmm)
    return torch.sum(hv * hq, dim=1)


class TuckerFusion(torch.autograd.Function):
    """The kernel's forward on policy-dtype operands (x, w bf16; biases
    f32) and a backward that recomputes the projections in f32 on the same
    operands.  Gradients come back in each operand's dtype."""

    @staticmethod
    def forward(ctx, x_v, x_q, w_v, b_v, w_q, b_q, rank):
        ctx.rank = rank
        ctx.save_for_backward(x_v, x_q, w_v, b_v, w_q, b_q)
        return mutan_kernel.tucker_fusion(x_v, x_q, w_v, b_v, w_q, b_q, rank)

    @staticmethod
    def backward(ctx, g):
        x_v, x_q, w_v, b_v, w_q, b_q = ctx.saved_tensors
        rank = ctx.rank
        batch = x_v.shape[0]
        dmm = w_v.shape[0] // rank
        xv, xq, wv, wq = (t.float() for t in (x_v, x_q, w_v, w_q))
        hv = (xv @ wv.t() + b_v.float()).reshape(batch, rank, dmm)
        hq = (xq @ wq.t() + b_q.float()).reshape(batch, rank, dmm)
        g = g.float()[:, None, :]
        g_hv = (g * hq).reshape(batch, rank * dmm)
        g_hq = (g * hv).reshape(batch, rank * dmm)
        return ((g_hv @ wv).to(x_v.dtype), (g_hq @ wq).to(x_q.dtype),
                (g_hv.t() @ xv).to(w_v.dtype), g_hv.sum(0).to(b_v.dtype),
                (g_hq.t() @ xq).to(w_q.dtype), g_hq.sum(0).to(b_q.dtype),
                None)


def tucker_rank_fusion_auto(x_v: torch.Tensor, x_q: torch.Tensor,
                            w_v: torch.Tensor, b_v: torch.Tensor,
                            w_q: torch.Tensor, b_q: torch.Tensor,
                            rank: int) -> torch.Tensor:
    """:class:`TuckerFusion` (the kernel) on the card under the bf16 policy,
    :func:`tucker_rank_fusion` otherwise.  The same function on either
    path."""
    if x_v.device.type == "cuda" and compute_dtype() == torch.bfloat16:
        xv, wv = cast_in(x_v, w_v)
        xq, wq = cast_in(x_q, w_q)
        return TuckerFusion.apply(xv.contiguous(), xq.contiguous(),
                                  wv.contiguous(), b_v.float().contiguous(),
                                  wq.contiguous(), b_q.float().contiguous(),
                                  rank)
    return tucker_rank_fusion(x_v, x_q, w_v, b_v, w_q, b_q, rank)
