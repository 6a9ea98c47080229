"""NeuralCX over a frozen VQA backbone, eval mode (port of
``models/cx.CXModelBase`` / ``NeuralModel``).

Contract: ``forward(image_features (B, K+1, dim_v) | None, question_wids
(B, T), answer_aids (B,)) -> scores (B, K)``; index 0 of the candidate
axis is the original image, 1..K its KNNs.  The table form
(``features_table=`` + ``image_idxs=``) replaces the materialized gather.

The per-candidate MLP over the 14089-d concat [v_orig, v_other, v_mult,
v_dist, rank one-hot, q_emb, z_orig, z_other, a_emb_gt, a_emb_other] is
scored for all candidates at once by ``ops/scorer``.  Two CUDA kernels sit
on this path under the bf16 policy: the candidate image features
(``ops/cuda/vfeat_kernel.py``, table form + z cache) and the answer head
fused with its softmax (``ops/cuda/mixture_kernel.py``).

Attribute names follow the reference checkpoint (``vqa_model``,
``answer_embedding``, ``linear_1`` .. ``linear_n``, ``out``).  Lesion flags
that draw random placeholders and the training mode are not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.policy import cast_in, compute_dtype
from ..ops import scorer as scorer_ops
from ..ops.cuda.vfeat_kernel import vfeat_scores
from ..ops.metrics import pairwise_distance
from .fusion import lecun_normal_

_RANDOM_LESIONS = ("v_emb", "v_rank", "a_emb")


class CXModelBase(nn.Module):
    """Holds the VQA backbone and runs it over all K+1 images at once."""

    def __init__(self, vqa_model: nn.Module, knn_size: int = 24,
                 trainable_vqa: bool = False):
        super().__init__()
        if trainable_vqa:
            raise NotImplementedError(
                "a trainable VQA backbone needs the training path "
                "(ROADMAP.md, Queue 1 #4)")
        self.vqa_model = vqa_model
        self.knn_size = knn_size

    def vqa_forward(self, image_features, question_wids, q_emb=None,
                    v_proj=None, z_emb=None, want_logits: bool = True):
        """-> (z_orig, a_knns | None, z_knns, q_emb).  With ``z_emb`` (the
        per-example fused-embedding cache) the raw features are not read."""
        if q_emb is None:
            q_emb = self.vqa_model.encode_question(question_wids)
        if z_emb is not None:
            z = z_emb
        else:
            z = self.vqa_model.fuse_candidates(image_features, q_emb,
                                               v_proj=v_proj)
        z_orig, z_knns = z[:, 0], z[:, 1:]
        a_knns = None
        if want_logits:
            batch, k = z_knns.shape[:2]
            a_knns = self.vqa_model.classify(
                z_knns.reshape(batch * k, -1)).reshape(batch, k, -1)
        return z_orig, a_knns, z_knns, q_emb

    def _fused_head_ok(self) -> bool:
        """The fused classify + softmax kernel serves the frozen (the only
        ported case), activation-free answer head under the bf16 policy."""
        return ("activation" not in self.vqa_model.opt.get("classif", {})
                and compute_dtype() == torch.bfloat16)


class NeuralModel(CXModelBase):
    def __init__(self, vqa_model: nn.Module, knn_size: int = 24,
                 trainable_vqa: bool = False, model_spec: dict | None = None,
                 dim_h: int = 300, n_layers: int = 2, dim_a: int = 2400):
        super().__init__(vqa_model, knn_size, trainable_vqa)
        spec = dict(model_spec or {})
        lesioned = [k for k in _RANDOM_LESIONS if not spec.get(k, True)]
        if not spec.get("q_emb", True) and not spec.get("z_emb", True):
            lesioned.append("q_emb+z_emb")
        if lesioned:
            raise NotImplementedError(
                "lesions that draw random placeholders (%s) are not ported "
                "yet" % ", ".join(lesioned))
        self.model_spec = spec
        self.dim_h = dim_h
        self.n_layers = n_layers
        self.dim_a = dim_a
        fus = vqa_model.opt["fusion"]
        self.slices = scorer_ops.FeatureSlices(
            dim_v=fus["dim_v"], dim_q=fus["dim_q"], dim_z=fus["dim_mm"],
            dim_a=dim_a, knn_size=knn_size)
        self.answer_embedding = nn.Embedding(len(vqa_model.vocab_answers),
                                             dim_a)
        self.linear_1 = nn.Linear(self.slices.input_size, dim_h)
        for layer in range(2, n_layers + 1):
            setattr(self, "linear_%d" % layer, nn.Linear(dim_h, dim_h))
        self.out = nn.Linear(dim_h, 1)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX initializers (answer embedding N(0, 1), lecun_normal
        kernels, zero biases), drawn from ``generator``."""
        self.vqa_model.reset_parameters(generator)
        self.answer_embedding.weight.normal_(0.0, 1.0, generator=generator)
        for layer in self._layers() + [self.out]:
            lecun_normal_(layer.weight, generator)
            layer.bias.zero_()

    def _layers(self):
        return [getattr(self, "linear_%d" % i)
                for i in range(1, self.n_layers + 1)]

    def _fused_vfeat_ok(self) -> bool:
        """The candidate image-feature kernel needs the full v spec (it
        computes v_other, v_mult and v_dist from one read) and the bf16
        policy (the backbone is always frozen here)."""
        spec = self.model_spec
        return (spec.get("v_mult", True) and spec.get("v_dist", True)
                and compute_dtype() == torch.bfloat16)

    def wants_table_features(self) -> bool:
        """When True, engines pass ``features_table=`` / ``image_idxs=``
        instead of the materialized (B, K+1, dim_v) gather (needs the z
        cache)."""
        return self._fused_vfeat_ok()

    def forward(self, image_features, question_wids, answer_aids,
                q_emb=None, v_proj=None, z_emb=None, features_table=None,
                image_idxs=None) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "NeuralModel training mode (dropout) is not ported yet; "
                "call .eval() (ROADMAP.md, Queue 1 #4)")
        spec = self.model_spec
        K = self.knn_size
        if image_features is not None:
            batch, k1, _ = image_features.shape
        else:
            if features_table is None or image_idxs is None:
                raise ValueError("pass image_features or features_table + "
                                 "image_idxs")
            batch, k1 = image_idxs.shape
        if k1 != K + 1:
            raise ValueError("expected %d candidates + 1, got %d" % (K, k1))

        fused_v = (image_features is None and z_emb is not None
                   and self._fused_vfeat_ok())
        if image_features is None and not fused_v:
            image_features = features_table[image_idxs.long()]
        if fused_v:
            v_orig = features_table[image_idxs[:, 0].long()]
            v_knns = None
        else:
            v_orig = image_features[:, 0]
            v_knns = image_features[:, 1:]

        fused_head = self._fused_head_ok()
        z_orig, a_knns, z_knns, q_emb = self.vqa_forward(
            image_features, question_wids, q_emb=q_emb, v_proj=v_proj,
            z_emb=z_emb, want_logits=not fused_head)

        table = self.answer_embedding.weight
        a_emb_gt = table[answer_aids.long()]
        if fused_head:
            w_cls, b_cls = self.vqa_model.classif_params()
            a_emb_factored = ("fused", z_knns, w_cls, b_cls, table)
        else:
            a_emb_factored = (a_knns, table)

        v_mult = v_dist = None
        if not fused_v:
            v_mult = (v_orig[:, None, :] * v_knns if spec.get("v_mult", True)
                      else torch.zeros_like(v_knns))
            v_dist = (pairwise_distance(v_orig[:, None, :], v_knns,
                                        keepdims=False)
                      if spec.get("v_dist", True)
                      else v_knns.new_zeros((batch, K)).float())

        w1 = self.linear_1.weight.t()  # (input_size, H)
        h_v_fused = None
        if fused_v:
            h_v_fused, v_dist = self._fused_vfeat(features_table, image_idxs,
                                                  w1)
        h = scorer_ops.first_layer_decomposed(
            w1, self.linear_1.bias, self.slices, v_orig=v_orig,
            v_knns=v_knns, v_mult=v_mult, v_dist=v_dist, q_emb=q_emb,
            z_orig=z_orig, z_knns=z_knns, a_emb_gt=a_emb_gt,
            a_emb_knns_factored=a_emb_factored, h_v_fused=h_v_fused)
        hidden = self._layers()[1:]
        return scorer_ops.mlp_tail(
            h, [layer.weight.t() for layer in hidden],
            [layer.bias for layer in hidden], self.out.weight.t(),
            self.out.bias)

    def _fused_vfeat(self, features_table, image_idxs, w1):
        """Candidate image features from the table + indices in one kernel
        -> (h_v (B, K, H) bf16, v_dist (B, K) f32)."""
        offs = self.slices.offsets()
        w_other = cast_in(w1[slice(*offs["v_other"])].t()).contiguous()
        w_mult = cast_in(w1[slice(*offs["v_mult"])].t()).contiguous()
        return vfeat_scores(cast_in(features_table).contiguous(),
                            image_idxs.to(torch.int32).contiguous(),
                            w_other, w_mult)
