"""The fusions (port of ``models/fusion.py``): MLB (``MLBFusion``, a
Hadamard product) and MUTAN (``MutanFusion`` / ``MutanFusion2d``).

MLB: ``act_v(linear_v(drop_v(v))) * act_q(linear_q(drop_q(q)))``; a side
whose ``dim_v`` / ``dim_q`` the options omit is used as it comes, and its
Linear does not exist.  Its linears are flax ``Dense`` with the default
dtype in JAX, so they compute in f32 under either policy.

MUTAN: ``sum_r (x_v @ Wv_r + bv_r) * (x_q @ Wq_r + bq_r)`` with
``x_v = act_v(linear_v(drop_v(v)))`` and ``x_q = act_q(linear_q(
drop_q(q)))``; with ``visual_embedding`` / ``question_embedding`` off (the
attention models' two fusions) that side's input is used as it comes and
``linear_v`` / ``linear_q`` do not exist.  The per-rank projections are kept
as the reference's ``list_linear_hv.{r}`` / ``list_linear_hq.{r}`` Linears
(checkpoint names) and stacked rank-major into one (R*dim_mm, dim_h) GEMM
operand when used.  In the reference default configuration (no per-rank
dropout or activation) the rank sum is the Tucker op of ``ops/fusion`` (the
CUDA kernel under bf16 on the card), and the image side is cacheable per
image (``v_project``); the general configuration runs the per-rank dropout
and activations in plain PyTorch.  ``fuse_candidates`` fuses K candidates
(CX's K+1 images, MutanAtt's 196 positions) with one question per example
(JAX's three branches: duplicated, folded, and the folded kernels).
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.policy import cast_in, compute_dtype, dot_f32
from ..ops import fusion as fusion_ops
from .common import dropout

_ACTIVATIONS = {
    "tanh": torch.tanh,
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "softmax": lambda x: torch.softmax(x, dim=-1),
}


def activation(name: str):
    return _ACTIVATIONS[name]


def att_kernel_ok(k1: int, device: torch.device) -> bool:
    """Gate for the folded-MUTAN kernels (JAX ``_att_pallas_ok`` without its
    TPU and mesh parts): tensors on the card, the bf16 policy and the
    spatial scale (k1 >= 64; the CX candidate axis stays on the other
    branches).  Elsewhere the XLA folded form, as JAX off the TPU."""
    return (device.type == "cuda" and compute_dtype() == torch.bfloat16
            and k1 >= 64)


def dense(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """flax ``nn.Dense`` with its default dtype: computed in the promoted
    dtype of the input and the (f32) params."""
    dt = torch.promote_types(x.dtype, layer.weight.dtype)
    return torch.nn.functional.linear(x.to(dt), layer.weight.to(dt),
                                      layer.bias.to(dt))


@torch.no_grad()
def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """flax ``lecun_normal`` for a torch (out, in) weight: truncated normal
    (two std) with variance 1/fan_in."""
    std = (1.0 / weight.shape[1]) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


class MLBFusion(nn.Module):
    """dropout -> linear -> activation on each modality, then their
    Hadamard product (reference ``fusion.py:16-50``, JAX
    ``fusion.py:66-133``): (B, dim_v) x (B, dim_q) -> (B, dim_h) f32."""

    def __init__(self, opt: dict):
        super().__init__()
        self.opt = dict(opt)
        if "dim_v" in opt:
            self.linear_v = nn.Linear(opt["dim_v"], opt["dim_h"])
        if "dim_q" in opt:
            self.linear_q = nn.Linear(opt["dim_q"], opt["dim_h"])

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """JAX initializers: lecun_normal kernels, zero biases."""
        for name in ("linear_v", "linear_q"):
            if hasattr(self, name):
                lecun_normal_(getattr(self, name).weight, generator)
                getattr(self, name).bias.zero_()

    def _side(self, x, side, training, generator):
        if not hasattr(self, "linear_" + side):
            return x
        x = dropout(x, self.opt.get("dropout_" + side, 0), generator,
                    training)
        x = dense(x, getattr(self, "linear_" + side))
        if "activation_" + side in self.opt:
            x = activation(self.opt["activation_" + side])(x)
        return x

    def forward(self, input_v: torch.Tensor, input_q: torch.Tensor,
                training: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """In training the v mask is drawn first, then the q mask."""
        x_v = self._side(input_v, "v", training, generator)
        return x_v * self._side(input_q, "q", training, generator)

    def v_project(self, input_v: torch.Tensor) -> torch.Tensor:
        """The image side in eval mode, (N, dim_v) -> (N, dim_h): a
        constant per image under a frozen backbone."""
        return self._side(input_v, "v", False, None)

    def fuse_candidates(self, input_v: torch.Tensor | None,
                        input_q: torch.Tensor,
                        hv: torch.Tensor | None = None,
                        training: bool = False,
                        generator: torch.Generator | None = None
                        ) -> torch.Tensor:
        """(B, K, Dv) x (B, Dq) -> (B, K, dim_h) with the question side
        computed once per example; ``hv``: precomputed ``v_project`` rows
        (B, K, dim_h) in its place (eval mode).  In training the question
        is duplicated over the candidates, each row drawing its own masks
        (JAX's duplicated path)."""
        if hv is not None:
            if training:
                raise ValueError("cached v projections need eval mode")
            return hv * self._side(input_q, "q", False, None)[:, None]
        batch, k1 = input_v.shape[:2]
        if training:
            q_dup = input_q[:, None, :].expand(
                batch, k1, input_q.shape[-1]).reshape(batch * k1, -1)
            out = self(input_v.reshape(batch * k1, -1), q_dup, training,
                       generator)
            return out.reshape(batch, k1, -1)
        x_v = self._side(input_v.reshape(batch * k1, -1), "v", False, None)
        x_q = self._side(input_q, "q", False, None)
        return x_v.reshape(batch, k1, -1) * x_q[:, None]


class MutanFusion(nn.Module):
    def __init__(self, opt: dict, visual_embedding: bool = True,
                 question_embedding: bool = True):
        super().__init__()
        self.opt = dict(opt)
        self.visual_embedding = visual_embedding
        self.question_embedding = question_embedding
        rank, dim_mm = opt["R"], opt["dim_mm"]
        if visual_embedding:
            self.linear_v = nn.Linear(opt["dim_v"], opt["dim_hv"])
        if question_embedding:
            self.linear_q = nn.Linear(opt["dim_q"], opt["dim_hq"])
        self.list_linear_hv = nn.ModuleList(
            [nn.Linear(opt["dim_hv"], dim_mm) for _ in range(rank)])
        self.list_linear_hq = nn.ModuleList(
            [nn.Linear(opt["dim_hq"], dim_mm) for _ in range(rank)])

    @property
    def simple(self) -> bool:
        """No per-rank dropout or activation (the reference default): the
        rank sum is one Tucker op and the image side caches per image."""
        opt = self.opt
        return (opt.get("dropout_hv", 0) == 0 and opt.get("dropout_hq", 0) == 0
                and "activation_hv" not in opt and "activation_hq" not in opt)

    @property
    def has_input_dropout(self) -> bool:
        """The module draws dropout masks on its inputs itself (an
        embedding on, with its dropout): then training-mode candidate
        fusion must draw per-candidate masks (the duplicated path)."""
        opt = self.opt
        return ((self.visual_embedding and opt.get("dropout_v", 0) > 0)
                or (self.question_embedding and opt.get("dropout_q", 0) > 0))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """JAX initializers: lecun_normal kernels, zero biases."""
        layers = [getattr(self, name) for name in ("linear_v", "linear_q")
                  if hasattr(self, name)]
        for layer in [*layers, *self.list_linear_hv, *self.list_linear_hq]:
            lecun_normal_(layer.weight, generator)
            layer.bias.zero_()

    @staticmethod
    def _stacked(layers: nn.ModuleList):
        """(R*dmm, din) weight and (R*dmm,) bias, rank-major blocks."""
        w = torch.cat([layer.weight for layer in layers], dim=0)
        b = torch.cat([layer.bias for layer in layers], dim=0)
        return w, b

    def _v_side(self, input_v: torch.Tensor, training: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if not self.visual_embedding:
            return input_v
        x_v = dropout(input_v, self.opt.get("dropout_v", 0), generator,
                      training)
        x_v = dense(x_v, self.linear_v)
        if "activation_v" in self.opt:
            x_v = activation(self.opt["activation_v"])(x_v)
        return x_v

    def _q_side(self, input_q: torch.Tensor, training: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if not self.question_embedding:
            return input_q
        x_q = dropout(input_q, self.opt.get("dropout_q", 0), generator,
                      training)
        x_q = dense(x_q, self.linear_q)
        if "activation_q" in self.opt:
            x_q = activation(self.opt["activation_q"])(x_q)
        return x_q

    def forward(self, input_v: torch.Tensor, input_q: torch.Tensor,
                training: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """(B, dim_v) x (B, dim_q) -> (B, dim_mm) f32; (B, WH, dim_v) spatial
        inputs (with (B, WH, dim_q) questions) flatten through the same
        path (reference ``MutanFusion2d``).  Dropout masks are drawn from
        ``generator`` in training: v, q, then the per-rank ones."""
        opt = self.opt
        rank, dim_mm = opt["R"], opt["dim_mm"]
        spatial = input_v.dim() == 3
        if spatial:
            batch0, wh = input_v.shape[:2]
            input_v = input_v.reshape(batch0 * wh, -1)
            input_q = input_q.reshape(batch0 * wh, -1)
        x_v = self._v_side(input_v, training, generator)
        x_q = self._q_side(input_q, training, generator)
        w_hv, b_hv = self._stacked(self.list_linear_hv)
        w_hq, b_hq = self._stacked(self.list_linear_hq)
        if self.simple:
            x_mm = fusion_ops.tucker_rank_fusion_auto(x_v, x_q, w_hv, b_hv,
                                                      w_hq, b_hq, rank)
        else:
            batch = x_v.shape[0]
            hv_in = dropout(x_v, opt.get("dropout_hv", 0), generator,
                            training)
            hq_in = dropout(x_q, opt.get("dropout_hq", 0), generator,
                            training)
            hv = (hv_in @ w_hv.t() + b_hv).reshape(batch, rank, dim_mm)
            hq = (hq_in @ w_hq.t() + b_hq).reshape(batch, rank, dim_mm)
            if "activation_hv" in opt:
                hv = activation(opt["activation_hv"])(hv)
            if "activation_hq" in opt:
                hq = activation(opt["activation_hq"])(hq)
            x_mm = torch.sum(hv * hq, dim=1)
        if "activation_mm" in opt:
            x_mm = activation(opt["activation_mm"])(x_mm)
        if spatial:
            x_mm = x_mm.reshape(batch0, wh, dim_mm)
        return x_mm

    def v_project(self, input_v: torch.Tensor) -> torch.Tensor:
        """Everything on the visual side that depends only on the image,
        through the rank projection: (N, dim_v) -> (N, R, dim_mm) f32.
        Eval mode and the simple configuration only."""
        if not self.simple:
            raise ValueError("per-rank dropout/activation is not cacheable")
        w_hv, b_hv = self._stacked(self.list_linear_hv)
        flat = dot_f32(self._v_side(input_v), w_hv.t()) + b_hv
        return flat.reshape(flat.shape[0], self.opt["R"], self.opt["dim_mm"])

    def fuse_candidates(self, input_v: torch.Tensor | None,
                        input_q: torch.Tensor,
                        hv: torch.Tensor | None = None,
                        training: bool = False,
                        generator: torch.Generator | None = None
                        ) -> torch.Tensor:
        """(B, K, Dv) x (B, Dq) -> (B, K, dim_mm) with the question side
        computed once per example.  ``hv``: precomputed ``v_project`` rows
        (B, K, R, dim_mm) that replace the image side (eval mode, the
        simple configuration).  Otherwise JAX's three branches: the
        duplicated path when this module's own dropout is live or the
        configuration is not simple; the folded kernels
        (:class:`ops.fusion.FoldedMutan`) where :func:`att_kernel_ok`
        allows; else the folded form (:func:`ops.fusion.folded_mutan`), or
        the rank rows when K < R."""
        opt = self.opt
        rank, dim_mm = opt["R"], opt["dim_mm"]
        if hv is None:
            batch, k1 = input_v.shape[:2]
            if (training and self.has_input_dropout) or not self.simple:
                q_dup = input_q[:, None, :].expand(
                    batch, k1, input_q.shape[-1]).reshape(batch * k1, -1)
                out = self(input_v.reshape(batch * k1, -1), q_dup, training,
                           generator)
                return out.reshape(batch, k1, -1)
            x_v = self._v_side(input_v.reshape(batch * k1, -1), training,
                               generator)
        x_q = self._q_side(input_q, training, generator)
        w_hq, b_hq = self._stacked(self.list_linear_hq)
        hq = (dot_f32(x_q, w_hq.t()) + b_hq).reshape(-1, rank, dim_mm)
        if hv is not None:
            x_mm = torch.sum(hv * hq[:, None], dim=2)
        else:
            w_hv, b_hv = self._stacked(self.list_linear_hv)
            xv, wv = cast_in(x_v, w_hv)
            xv = xv.reshape(batch, k1, -1)
            if k1 >= rank and att_kernel_ok(k1, xv.device):
                x_mm = fusion_ops.FoldedMutan.apply(
                    xv.contiguous(), wv.contiguous(),
                    b_hv.float().contiguous(), hq.contiguous())
            elif k1 >= rank:
                x_mm = fusion_ops.folded_mutan(xv, wv, b_hv, hq)
            else:
                rows = (dot_f32(xv, wv.t()) + b_hv).reshape(
                    batch, k1, rank, dim_mm)
                x_mm = torch.sum(rows * hq[:, None], dim=2)
        if "activation_mm" in opt:
            x_mm = activation(opt["activation_mm"])(x_mm)
        return x_mm


# reference name: MUTAN over a (B, W*H, D) spatial axis (``fusion.py:124-146``);
# the flattening lives in ``MutanFusion.forward``, the candidate form in
# ``fuse_candidates``
MutanFusion2d = MutanFusion
