"""No-attention VQA classifiers (port of ``models/noatt.py``): ``MLBNoAtt``
and ``MutanNoAtt`` over one ``AbstractNoAtt`` tower.

question -> seq2vec -> fusion with the pooled visual features (MLB's
Hadamard product or MUTAN) -> classifier over the answer vocabulary.  The
pieces are exposed as methods because the CX models drive them
separately.  Attribute names follow the reference checkpoint: ``seq2vec``,
``fusion``, ``linear_classif``.

In training (``training=True``) every dropout of the reference draws its
mask from the one ``generator`` passed in: the encoder's masks, the
fusion's input dropouts, then the classifier's.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.policy import cast_in, pdot
from . import fusion as fusion_mod
from . import seq2vec as seq2vec_mod
from .common import dropout


class AbstractNoAtt(nn.Module):
    """The tower; a subclass names its fusion (:meth:`_make_fusion`) and
    the width ``dim_z`` of the fused vector the classifier reads."""

    def __init__(self, opt: dict, vocab_words, vocab_answers):
        super().__init__()
        self.opt = opt
        self.vocab_words = tuple(vocab_words)
        self.vocab_answers = tuple(vocab_answers)
        self.seq2vec = seq2vec_mod.factory(self.vocab_words, opt["seq2vec"])
        self.fusion = self._make_fusion(opt["fusion"])
        self.linear_classif = nn.Linear(self.dim_z, len(self.vocab_answers))

    def _make_fusion(self, opt_fusion: dict) -> nn.Module:
        raise NotImplementedError

    @property
    def dim_z(self) -> int:
        raise NotImplementedError

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.seq2vec.reset_parameters(generator)
        self.fusion.reset_parameters(generator)
        fusion_mod.lecun_normal_(self.linear_classif.weight, generator)
        self.linear_classif.bias.zero_()

    def encode_question(self, input_q: torch.Tensor, training: bool = False,
                        generator: torch.Generator | None = None
                        ) -> torch.Tensor:
        return self.seq2vec(input_q, training, generator)

    def project_image(self, input_v: torch.Tensor) -> torch.Tensor:
        """Image-only half of the fusion: a constant per image under a
        frozen backbone (``engines/cx_engine.precompute_v_proj``)."""
        return self.fusion.v_project(input_v)

    def fuse_candidates(self, input_v, x_q: torch.Tensor,
                        v_proj: torch.Tensor | None = None,
                        training: bool = False,
                        generator: torch.Generator | None = None
                        ) -> torch.Tensor:
        return self.fusion.fuse_candidates(input_v, x_q, hv=v_proj,
                                           training=training,
                                           generator=generator)

    def classify(self, z: torch.Tensor, training: bool = False,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        """Answer logits (f32).  The head follows the compute policy: bf16
        GEMM and bias add under bf16 (flax ``Dense(dtype=policy)``)."""
        opt_c = self.opt["classif"]
        x = z
        if "activation" in opt_c:
            x = fusion_mod.activation(opt_c["activation"])(x)
        x = dropout(x, opt_c.get("dropout", 0.0), generator, training)
        out = pdot(x, self.linear_classif.weight.t()) \
            + cast_in(self.linear_classif.bias)
        return out.float()

    def forward(self, input_v: torch.Tensor, input_q: torch.Tensor,
                training: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """(B, dim_v) features and (B, T) word ids -> (B, n_answers) f32
        logits."""
        x_q = self.encode_question(input_q, training, generator)
        z = self.fusion(input_v, x_q, training, generator)
        return self.classify(z, training, generator)

    def classif_params(self):
        """(weight (A, dz), bias (A,)) of the answer head, for the fused
        classify + softmax kernel."""
        return self.linear_classif.weight, self.linear_classif.bias


class MLBNoAtt(AbstractNoAtt):
    """Hadamard-product fusion (reference ``noatt.py:38-46``): z is
    ``fusion.dim_h`` wide."""

    def _make_fusion(self, opt_fusion: dict) -> nn.Module:
        return fusion_mod.MLBFusion(opt_fusion)

    @property
    def dim_z(self) -> int:
        return self.opt["fusion"]["dim_h"]


class MutanNoAtt(AbstractNoAtt):
    """Tucker rank-R fusion (reference ``noatt.py:49-58``): z is
    ``fusion.dim_mm`` wide."""

    def _make_fusion(self, opt_fusion: dict) -> nn.Module:
        return fusion_mod.MutanFusion(opt_fusion)

    @property
    def dim_z(self) -> int:
        return self.opt["fusion"]["dim_mm"]
