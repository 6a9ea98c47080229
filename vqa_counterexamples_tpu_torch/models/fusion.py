"""MUTAN fusion (port of ``models/fusion.MutanFusion``).

``sum_r (x_v @ Wv_r + bv_r) * (x_q @ Wq_r + bq_r)`` with
``x_v = act_v(linear_v(drop_v(v)))`` and ``x_q = act_q(linear_q(
drop_q(q)))``.  The per-rank projections are kept as the reference's
``list_linear_hv.{r}`` / ``list_linear_hq.{r}`` Linears (checkpoint names)
and stacked rank-major into one (R*dim_mm, dim_h) GEMM operand when used.
In the reference default configuration (no per-rank dropout or
activation) the rank sum is the Tucker op of ``ops/fusion`` (the CUDA
kernel under bf16 on the card), and the image side is cacheable per image
(``v_project``); the general configuration runs the per-rank dropout and
activations in plain PyTorch.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.policy import dot_f32
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


class MutanFusion(nn.Module):
    def __init__(self, opt: dict):
        super().__init__()
        self.opt = dict(opt)
        rank, dim_mm = opt["R"], opt["dim_mm"]
        self.linear_v = nn.Linear(opt["dim_v"], opt["dim_hv"])
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

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """JAX initializers: lecun_normal kernels, zero biases."""
        for layer in [self.linear_v, self.linear_q, *self.list_linear_hv,
                      *self.list_linear_hq]:
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
        x_v = dropout(input_v, self.opt.get("dropout_v", 0), generator,
                      training)
        x_v = dense(x_v, self.linear_v)
        if "activation_v" in self.opt:
            x_v = activation(self.opt["activation_v"])(x_v)
        return x_v

    def _q_side(self, input_q: torch.Tensor, training: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
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
                        hv: torch.Tensor | None = None) -> torch.Tensor:
        """(B, K, Dv) x (B, Dq) -> (B, K, dim_mm) with the question side
        computed once per example (eval mode, the simple configuration).
        ``hv``: precomputed ``v_project`` rows (B, K, R, dim_mm) that
        replace the image side."""
        if hv is None:
            batch, k1 = input_v.shape[:2]
            hv = self.v_project(input_v.reshape(batch * k1, -1)).reshape(
                batch, k1, self.opt["R"], self.opt["dim_mm"])
        batch = hv.shape[0]
        w_hq, b_hq = self._stacked(self.list_linear_hq)
        hq = (dot_f32(self._q_side(input_q), w_hq.t()) + b_hq).reshape(
            batch, 1, self.opt["R"], self.opt["dim_mm"])
        x_mm = torch.sum(hv * hq, dim=2)
        if "activation_mm" in self.opt:
            x_mm = activation(self.opt["activation_mm"])(x_mm)
        return x_mm
