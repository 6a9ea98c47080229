"""Batched candidate scoring for NeuralCX (port of ``ops/scorer.py``).

The whole candidate axis is one batched GEMM, and the first layer is
decomposed so work that is constant across candidates is done once per
example::

    concat([s_1..s_m, c_1..c_n]) @ W  ==  sum_i s_i @ W_si  +  sum_j c_j @ W_cj

Static features (v_orig, q_emb, z_orig, a_emb_gt) take one (B, 7208) GEMM;
the one-hot rank feature is a row of W; the scalar distance a rank-1
product; the per-candidate features one dot per block over (B*K) rows.
``w1`` here is the (input_size, H) view of ``linear_1.weight`` (its
transpose), so the column slices read as the JAX package's row slices.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import rng
from ..core.policy import cast_in, dot_f32, pdot
from .cuda.mixture_kernel import classify_softmax


class FeatureSlices(NamedTuple):
    """Column offsets of each feature block inside the first-layer weight.

    Order matches the reference concat: v_orig, v_other, v_mult, v_dist,
    v_rank, q_emb, z_orig, z_other, a_emb_gt, a_emb_other.
    """
    dim_v: int
    dim_q: int
    dim_z: int
    dim_a: int
    knn_size: int

    @property
    def input_size(self) -> int:
        return (3 * self.dim_v + 1 + self.knn_size + self.dim_q
                + 2 * self.dim_z + 2 * self.dim_a)

    def offsets(self):
        sizes = [self.dim_v, self.dim_v, self.dim_v, 1, self.knn_size,
                 self.dim_q, self.dim_z, self.dim_z, self.dim_a, self.dim_a]
        names = ["v_orig", "v_other", "v_mult", "v_dist", "v_rank",
                 "q_emb", "z_orig", "z_other", "a_emb_gt", "a_emb_other"]
        out, off = {}, 0
        for name, size in zip(names, sizes):
            out[name] = (off, off + size)
            off += size
        return out


def first_layer_decomposed(w1, b1, slices: FeatureSlices, *, v_orig,
                           v_knns, v_mult, v_dist, q_emb, z_orig, z_knns,
                           a_emb_gt, a_emb_knns_factored=None,
                           a_emb_knns=None, v_rank=None,
                           h_v_fused=None) -> torch.Tensor:
    """Pre-activation of linear_1 for all candidates at once -> (B, K, H).

    Shapes: v_orig (B, Dv); v_knns / v_mult (B, K, Dv); v_dist (B, K);
    q_emb (B, Dq); z_orig (B, Dz); z_knns (B, K, Dz); a_emb_gt (B, Da).
    ``v_rank``: None for the identity one-hot rank feature, or a dense
    (B, K, K) block (the lesion's random placeholder).

    ``a_emb_knns_factored`` is the soft answer-embedding mixture in
    factored form: ``(logits (B, K, A), table (A, Da))``, contracted as
    ``softmax(logits) @ (table @ W_a)``; or ``("fused", z_knns, w_cls,
    b_cls, table)``, whose probs come from the fused answer-head kernel
    (``ops/cuda/mixture_kernel.py``) and never need the logits.  When it is
    None, ``a_emb_knns`` (B, K, Da) is a dense candidate feature (the
    a_emb lesion's placeholder).

    ``h_v_fused``: the v_other + v_mult contribution (B, K, H) from the
    candidate image-feature kernel (``ops/cuda/vfeat_kernel.py``); when
    given, ``v_knns`` / ``v_mult`` are unused.
    """
    offs = slices.offsets()

    def wslice(name):
        lo, hi = offs[name]
        return w1[lo:hi]

    w_static = torch.cat([wslice("v_orig"), wslice("q_emb"),
                          wslice("z_orig"), wslice("a_emb_gt")], dim=0)
    x_static = torch.cat([v_orig, q_emb, z_orig, a_emb_gt], dim=-1)
    h_static = pdot(x_static, w_static)  # (B, H), policy dtype

    if h_v_fused is None:
        cand = [("v_other", v_knns), ("v_mult", v_mult), ("z_other", z_knns)]
    else:
        cand = [("z_other", z_knns)]

    h_aemb = None
    if a_emb_knns_factored is None:
        cand.append(("a_emb_other", a_emb_knns))
    elif isinstance(a_emb_knns_factored[0], str):
        _, zk, w_cls, b_cls, table = a_emb_knns_factored
        ew = pdot(table, wslice("a_emb_other"))  # (A, H)
        bk, kk = zk.shape[:2]
        probs = classify_softmax(
            cast_in(zk.reshape(bk * kk, -1)).contiguous(),
            w_cls.to(torch.bfloat16).contiguous(),
            b_cls.to(torch.bfloat16).contiguous())
        h_aemb = pdot(probs, ew).reshape(bk, kk, -1)
    else:
        logits, table = a_emb_knns_factored
        ew = pdot(table, wslice("a_emb_other"))  # (A, H)
        lt = cast_in(logits)
        bk, kk = logits.shape[:2]
        if lt.dtype == torch.bfloat16:
            # softmax folded around the GEMM: exp in bf16, the normalizer
            # accumulated f32, the division a bf16 reciprocal on the
            # H-wide output
            m = lt.amax(dim=-1, keepdim=True)
            u = torch.exp(lt - m)
            s = u.sum(dim=-1, keepdim=True, dtype=torch.float32)
            uh = pdot(u.reshape(bk * kk, -1), ew)
            r = (1.0 / s.reshape(bk * kk, 1)).to(uh.dtype)
            h_aemb = (uh * r).reshape(bk, kk, -1)
        else:
            probs = torch.softmax(lt, dim=-1)
            h_aemb = pdot(probs.reshape(bk * kk, -1), ew).reshape(bk, kk, -1)

    # one dot per feature block, summed in the JAX order
    h_cand = h_aemb
    for name, feat in cand:
        h_blk = pdot(feat, wslice(name))
        h_cand = h_blk if h_cand is None else h_cand + h_blk
    if h_v_fused is not None:
        h_cand = h_cand + h_v_fused

    if v_rank is None:
        # rank one-hot: the identity GEMM selects per-candidate rows of W
        h_rank = cast_in(wslice("v_rank"))[None]
    else:
        h_rank = cast_in(torch.einsum("bkr,rh->bkh", v_rank,
                                      wslice("v_rank")))
    # scalar distance feature: rank-1 outer product
    h_dist = cast_in(v_dist[..., None] * wslice("v_dist")[0][None, None, :])
    return h_static[:, None, :] + h_cand + h_rank + h_dist + cast_in(b1)


def mlp_tail(h: torch.Tensor, hidden_ws, hidden_bs, w_out: torch.Tensor,
             b_out: torch.Tensor, *, drop_p: float = 0.0,
             generator: torch.Generator | None = None) -> torch.Tensor:
    """ReLU + dropout stack over (B, K, H) then the scalar head -> (B, K)
    f32.  ``h`` is the pre-activation of linear_1; ``hidden_ws`` / ``w_out``
    are (in, out) views.  Dropout follows every ReLU, as in the reference
    (cx.py:322-326), with masks drawn from ``generator`` in that order; with
    no generator or ``drop_p == 0`` it is the identity (eval)."""
    def drop(x):
        if generator is None or drop_p == 0.0:
            return x
        keep, scale = rng.keep_mask(x.shape, 1.0 - drop_p, generator)
        return torch.where(keep, x * scale, x.new_zeros(()))

    h = drop(torch.relu(h))
    for w, b in zip(hidden_ws, hidden_bs):
        h = drop(torch.relu(pdot(h, w) + cast_in(b)))
    # the scalar head stays f32: the 24-way CE loss reads these scores
    return (dot_f32(h, w_out) + b_out)[..., 0]
