"""Attention VQA classifiers (port of ``models/att.py``): ``MutanAtt`` and
``MLBAtt`` over the reference's ``AbstractAtt`` tower.

Visual features come channels-last ``(B, H, W, C)``, as in the JAX
package.  The reference's 1x1 convolutions (``conv_v_att``, ``conv_att``)
are ``nn.Conv2d`` modules with its ``(out, in, 1, 1)`` weights, applied as
a linear over the channels of the flattened ``(B, W*H, C)`` tensor.  The
tower's linears follow the compute policy (flax ``Dense(dtype=policy)``):
under bf16 their operands and outputs are bf16, the bias added in bf16.

Forward: the question vector from ``seq2vec``; the attention stage fuses
every position with the question (MutanAtt: ``fusion_att``, MUTAN over the
positions as candidates, the folded kernels under bf16 on the card;
MLBAtt: a Hadamard product), ``conv_att`` gives ``nb_glimpses`` maps, a
softmax over the positions, and each glimpse is the map-weighted sum of
the raw features; each glimpse through its ``list_linear_v_fusion.{g}``,
concatenated, fused with the question (MutanAtt: ``fusion_classif``;
MLBAtt: a Hadamard product) and classified.  The two archs differ only in
those two fusions and the widths around them, the hooks of
``AbstractAtt``.  In training every dropout draws from the one
``generator``, in the JAX package's order: the encoder's masks, then the
attention stage's v, q and mm, the glimpses', the question's for the
fusion, the classifier's.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.policy import cast_in, pdot
from . import fusion as fusion_mod
from . import seq2vec as seq2vec_mod
from .common import dropout


def policy_linear(x: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor) -> torch.Tensor:
    """flax ``Dense(dtype=policy)``: the product in the policy dtype with f32
    accumulation, rounded once, plus the bias in the policy dtype.  A 1x1
    convolution's (out, in, 1, 1) weight is used as (out, in)."""
    w = weight.reshape(weight.shape[0], -1)
    return pdot(x, w.t()) + cast_in(bias)


class AbstractAtt(nn.Module):
    """The tower (reference ``att.py:39-163``).  A subclass gives the
    widths of the glimpse projections, of the question's projection for
    the fusion and of the classifier's input, and the two fusions (and
    adds the modules they need after the tower's)."""

    def __init__(self, opt: dict, vocab_words, vocab_answers):
        super().__init__()
        self.opt = opt
        self.vocab_words = tuple(vocab_words)
        self.vocab_answers = tuple(vocab_answers)
        opt_att = opt["attention"]
        glimpses = opt_att["nb_glimpses"]
        dim_v = opt["dim_v"]
        dim_q = opt.get("dim_q") or seq2vec_mod.output_dim(opt["seq2vec"])
        self.seq2vec = seq2vec_mod.factory(self.vocab_words, opt["seq2vec"])
        self.conv_v_att = nn.Conv2d(dim_v, opt_att["dim_v"], 1)
        self.linear_q_att = nn.Linear(dim_q, opt_att["dim_q"])
        self.conv_att = nn.Conv2d(opt_att["dim_mm"], glimpses, 1)
        self.list_linear_v_fusion = nn.ModuleList(
            [nn.Linear(dim_v, self._glimpse_fusion_dim())
             for _ in range(glimpses)])
        self.linear_q_fusion = nn.Linear(dim_q, self._q_fusion_dim())
        self.linear_classif = nn.Linear(self._classif_dim(),
                                        len(self.vocab_answers))

    # subclass hooks ------------------------------------------------------
    def _glimpse_fusion_dim(self) -> int:
        raise NotImplementedError

    def _q_fusion_dim(self) -> int:
        raise NotImplementedError

    def _classif_dim(self) -> int:
        raise NotImplementedError

    def _fusion_att(self, x_v, x_q, training, generator):
        """(B, WH, dim_hv) positions x (B, dim_hq) question -> (B, WH,
        dim_mm)."""
        raise NotImplementedError

    def _fusion_classif(self, x_v, x_q, training, generator):
        raise NotImplementedError

    def _linears(self):
        return [self.conv_v_att, self.linear_q_att, self.conv_att,
                *self.list_linear_v_fusion, self.linear_q_fusion,
                self.linear_classif]

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """JAX initializers: the encoder's, lecun_normal kernels and zero
        biases for every linear and 1x1 convolution."""
        self.seq2vec.reset_parameters(generator)
        for layer in self._linears():
            fusion_mod.lecun_normal_(layer.weight, generator)
            layer.bias.zero_()

    def encode_question(self, input_q: torch.Tensor, training: bool = False,
                        generator: torch.Generator | None = None
                        ) -> torch.Tensor:
        return self.seq2vec(input_q, training, generator)

    def _attention(self, input_v, x_q_vec, training, generator):
        """-> (v_att (B, G, dim_v) f32, att_maps (B, G, W*H))."""
        opt_att = self.opt["attention"]
        batch, height, width, dim_v = input_v.shape
        v_flat = input_v.reshape(batch, height * width, dim_v)
        x_v = dropout(v_flat, opt_att["dropout_v"], generator, training)
        x_v = policy_linear(x_v, self.conv_v_att.weight, self.conv_v_att.bias)
        if "activation_v" in opt_att:
            x_v = fusion_mod.activation(opt_att["activation_v"])(x_v)
        x_q = dropout(x_q_vec, opt_att["dropout_q"], generator, training)
        x_q = policy_linear(x_q, self.linear_q_att.weight,
                            self.linear_q_att.bias)
        if "activation_q" in opt_att:
            x_q = fusion_mod.activation(opt_att["activation_q"])(x_q)
        # the question stays (B, dim_hq): its side of the fusion runs once
        # per example, not once per position
        x_att = self._fusion_att(x_v, x_q, training, generator)
        if "activation_mm" in opt_att:
            x_att = fusion_mod.activation(opt_att["activation_mm"])(x_att)
        x_att = dropout(x_att, opt_att["dropout_mm"], generator, training)
        x_att = policy_linear(x_att, self.conv_att.weight, self.conv_att.bias)
        att_maps = torch.softmax(x_att, dim=1)          # over the positions
        # every glimpse in one product; bf16 maps promote against the f32
        # features, as JAX's einsum does
        dt = torch.promote_types(att_maps.dtype, v_flat.dtype)
        v_att = torch.matmul(att_maps.transpose(1, 2).to(dt), v_flat.to(dt))
        return v_att, att_maps.transpose(1, 2)

    def _fusion_glimpses(self, v_att, x_q_vec, training, generator):
        opt_f = self.opt["fusion"]
        glimpses = []
        for i, layer in enumerate(self.list_linear_v_fusion):
            x_v = dropout(v_att[:, i], opt_f["dropout_v"], generator,
                          training)
            x_v = policy_linear(x_v, layer.weight, layer.bias)
            if "activation_v" in opt_f:
                x_v = fusion_mod.activation(opt_f["activation_v"])(x_v)
            glimpses.append(x_v)
        x_v = torch.cat(glimpses, dim=1)
        x_q = dropout(x_q_vec, opt_f["dropout_q"], generator, training)
        x_q = policy_linear(x_q, self.linear_q_fusion.weight,
                            self.linear_q_fusion.bias)
        if "activation_q" in opt_f:
            x_q = fusion_mod.activation(opt_f["activation_q"])(x_q)
        return self._fusion_classif(x_v, x_q, training, generator)

    def classify(self, x: torch.Tensor, training: bool = False,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        """Answer logits, f32 whatever the policy."""
        opt_c = self.opt["classif"]
        if "activation" in opt_c:
            x = fusion_mod.activation(opt_c["activation"])(x)
        x = dropout(x, opt_c.get("dropout", 0.0), generator, training)
        return policy_linear(x, self.linear_classif.weight,
                             self.linear_classif.bias).float()

    def classif_params(self):
        """(weight (A, dz), bias (A,)) of the answer head."""
        return self.linear_classif.weight, self.linear_classif.bias

    def forward(self, input_v: torch.Tensor, input_q: torch.Tensor,
                training: bool = False,
                generator: torch.Generator | None = None,
                return_att: bool = False):
        """(B, H, W, dim_v) feature maps and (B, T) word ids -> (B,
        n_answers) f32 logits, and with ``return_att`` the attention maps
        (B, G, W*H)."""
        if input_v.dim() != 4:
            raise ValueError("attention models need (B, H, W, C) feature "
                             "maps, got %s" % (tuple(input_v.shape),))
        x_q_vec = self.encode_question(input_q, training, generator)
        v_att, att_maps = self._attention(input_v, x_q_vec, training,
                                          generator)
        x = self._fusion_glimpses(v_att, x_q_vec, training, generator)
        x = self.classify(x, training, generator)
        return (x, att_maps) if return_att else x



class MutanAtt(AbstractAtt):
    """MUTAN at both stages (reference ``att.py:195-223``):
    ``fusion_att`` over the positions and ``fusion_classif`` over the
    glimpses, both with their embeddings off (the tower embeds)."""

    def __init__(self, opt: dict, vocab_words, vocab_answers):
        super().__init__(opt, vocab_words, vocab_answers)
        self.fusion_att = fusion_mod.MutanFusion2d(
            opt["attention"], visual_embedding=False,
            question_embedding=False)
        self.fusion_classif = fusion_mod.MutanFusion(
            opt["fusion"], visual_embedding=False, question_embedding=False)

    def _glimpse_fusion_dim(self) -> int:
        return int(self.opt["fusion"]["dim_hv"]
                   // self.opt["attention"]["nb_glimpses"])

    def _q_fusion_dim(self) -> int:
        return self.opt["fusion"]["dim_hq"]

    def _classif_dim(self) -> int:
        return self.opt["fusion"]["dim_mm"]

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        super().reset_parameters(generator)
        self.fusion_att.reset_parameters(generator)
        self.fusion_classif.reset_parameters(generator)

    def _fusion_att(self, x_v, x_q, training, generator):
        # positions as candidates: the rank projection of the question runs
        # once per example; exact in training too, as the module draws no
        # dropout
        return self.fusion_att.fuse_candidates(x_v, x_q, training=training,
                                               generator=generator)

    def _fusion_classif(self, x_v, x_q, training, generator):
        return self.fusion_classif(x_v, x_q, training, generator)


class MLBAtt(AbstractAtt):
    """Hadamard products at both stages (reference ``att.py:166-192``, JAX
    ``att.py:160-183``); the attention widths are tied to its ``dim_h`` by
    the factory.  The question's projection for the fusion is ``dim_h``
    per glimpse, the classifier reads ``dim_h * nb_glimpses``."""

    def _glimpse_fusion_dim(self) -> int:
        return self.opt["fusion"]["dim_h"]

    def _q_fusion_dim(self) -> int:
        return self.opt["fusion"]["dim_h"] * self.opt["attention"][
            "nb_glimpses"]

    def _classif_dim(self) -> int:
        return self._q_fusion_dim()

    def _fusion_att(self, x_v, x_q, training, generator):
        return x_v * x_q[:, None, :]

    def _fusion_classif(self, x_v, x_q, training, generator):
        return x_v * x_q
