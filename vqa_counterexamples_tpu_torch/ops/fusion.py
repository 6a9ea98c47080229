"""MUTAN's fusion ops (port of ``ops/fusion.py`` and of the folded path of
``models/fusion.MutanFusion.fuse_candidates``).

The Tucker rank fusion::

    x_mm = sum_r (x_v @ Wv_r^T + bv_r) * (x_q @ Wq_r^T + bq_r)

Weights come rank-major in the reference's per-rank ``Linear`` layout,
stacked: w_v (R*dmm, dhv), b_v (R*dmm,).  Under the bf16 policy on the card
the forward is the CUDA kernel (``ops/cuda/mutan_kernel.py``) behind
:class:`TuckerFusion`, whose backward recomputes both projections (cheaper
than keeping the (B, R*dmm) intermediates, as ``_tucker_bwd`` of the JAX
package does); elsewhere it is the plain autograd path.

The folded form fuses K candidates (MutanAtt's 196 positions) with one
question: the question side is folded into a per-example weight,
``x_mm[b, k] = x_v[b, k] @ weff[b] + sum_r b_r * hq[b, r]`` with ``weff[b] =
sum_r Wv_r^T * hq[b, r]``.  :func:`folded_mutan` is JAX's XLA form (plain
autograd); :class:`FoldedMutan` wraps the CUDA kernels
(``ops/cuda/attmutan_kernel.py``), which round differently under bf16 (as
the TPU kernel does).
"""

from __future__ import annotations

import torch

from ..core.policy import cast_in, compute_dtype, dot_f32
from .cuda import attmutan_kernel, mutan_kernel


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


def folded_mutan(x_v: torch.Tensor, w_v: torch.Tensor, b_v: torch.Tensor,
                 hq: torch.Tensor) -> torch.Tensor:
    """JAX's folded path (``models/fusion.py`` ``fuse_candidates``, the XLA
    branch): x_v (B, K, dhv) and w_v (R*dmm, dhv) in the policy dtype, b_v
    (R*dmm,) f32, hq (B, R, dmm) f32.  weff is an f32 sum of the policy
    dtype's products, cast to x_v's dtype; the output and the bias are
    f32.  Plain autograd."""
    batch, rank, dmm = hq.shape
    w3 = w_v.reshape(rank, dmm, -1)
    weff = torch.einsum("rmd,brm->bmd", w3.float(),
                        hq.to(w3.dtype).float()).to(x_v.dtype)
    x_mm = torch.matmul(x_v.float(), weff.float().transpose(1, 2))
    bias = torch.einsum("rm,brm->bm", b_v.float().reshape(rank, dmm),
                        hq.float())
    return x_mm + bias[:, None, :]


class FoldedMutan(torch.autograd.Function):
    """The folded kernels: the forward and its backward on bf16 x_v and
    w_v (b_v and hq rounded to bf16 inside, the output bf16), gradients to
    all four inputs cast back to each input's dtype, as the TPU kernel's
    custom VJP does (``_vjp_bwd``: dhq bf16 -> f32, dw f32 -> w's
    bf16)."""

    @staticmethod
    def forward(ctx, x_v, w_v, b_v, hq):
        ctx.save_for_backward(x_v, w_v, b_v, hq)
        return attmutan_kernel.folded_mutan(x_v, w_v, b_v, hq)

    @staticmethod
    def backward(ctx, g):
        x_v, w_v, b_v, hq = ctx.saved_tensors
        dxv, dw, db, dhq = attmutan_kernel.folded_mutan_bwd(
            x_v, w_v, b_v, hq, g.to(torch.bfloat16).contiguous())
        return (dxv.to(x_v.dtype), dw.to(w_v.dtype), db.to(b_v.dtype),
                dhq.to(hq.dtype))
