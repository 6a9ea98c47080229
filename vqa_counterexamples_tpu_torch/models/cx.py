"""NeuralCX over a frozen VQA backbone (port of ``models/cx.CXModelBase`` /
``NeuralModel``).

Contract: ``forward(image_features (B, K+1, dim_v) | None, question_wids
(B, T), answer_aids (B,)) -> scores (B, K)``; index 0 of the candidate
axis is the original image, 1..K its KNNs.  The table form
(``features_table=`` + ``image_idxs=``) replaces the materialized gather.

The per-candidate MLP over the 14089-d concat [v_orig, v_other, v_mult,
v_dist, rank one-hot, q_emb, z_orig, z_other, a_emb_gt, a_emb_other] is
scored for all candidates at once by ``ops/scorer``.  Two CUDA kernels sit
on this path under the bf16 policy: the candidate image features, forward
and weight-gradient backward (``ops/cuda/vfeat_kernel.py``, table form + z
cache), and the answer head fused with its softmax
(``ops/cuda/mixture_kernel.py``).

In training mode (``.train()``) dropout follows every ReLU of the MLP,
with masks from the ``dropout_gen`` generator.  The ``model_spec`` lesion
flags replace features with U[0, 1) placeholders drawn from ``lesion_gen``
(in either mode, as the reference's ``torch.rand`` did), including the
reference quirk that the q_emb lesion acts only when z_emb is lesioned
too.  The backbone is frozen: no gradient, no optimizer state, and it stays
in eval mode whatever the CX model's mode.

Attribute names follow the reference checkpoint (``vqa_model``,
``answer_embedding``, ``linear_1`` .. ``linear_n``, ``out``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.policy import cast_in, compute_dtype
from ..ops import scorer as scorer_ops
from ..ops.cuda.vfeat_kernel import vfeat_scores
from ..ops.metrics import pairwise_distance
from .fusion import lecun_normal_


def _uniform(gen: torch.Generator | None, shape) -> torch.Tensor:
    """torch.rand placeholder: U[0, 1) from the lesion generator."""
    if gen is None:
        raise ValueError("a lesioned model_spec draws placeholders: pass "
                         "lesion_gen")
    return torch.rand(tuple(shape), generator=gen, device=gen.device)


class CXModelBase(nn.Module):
    """Holds the VQA backbone and runs it over all K+1 images at once."""

    def __init__(self, vqa_model: nn.Module, knn_size: int = 24,
                 trainable_vqa: bool = False):
        super().__init__()
        if trainable_vqa:
            raise NotImplementedError(
                "a trainable VQA backbone needs the backbone's backward "
                "wired into the CX train step (ROADMAP.md, Queue 1: "
                "[trainable_vqa])")
        self.trainable_vqa = trainable_vqa
        self.vqa_model = vqa_model
        self.knn_size = knn_size
        # the frozen backbone (JAX: stop_gradient + eval-mode VQA) holds no
        # grads and gets no optimizer state
        vqa_model.requires_grad_(False)

    def train(self, mode: bool = True):
        """The frozen backbone stays in eval mode (reference cx.py:59-60)."""
        super().train(mode)
        self.vqa_model.eval()
        return self

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
        """The fused classify + softmax kernel serves the frozen,
        activation-free answer head under the bf16 policy."""
        return ("activation" not in self.vqa_model.opt.get("classif", {})
                and compute_dtype() == torch.bfloat16)


class NeuralModel(CXModelBase):
    def __init__(self, vqa_model: nn.Module, knn_size: int = 24,
                 trainable_vqa: bool = False, model_spec: dict | None = None,
                 dim_h: int = 300, n_layers: int = 2, drop_p: float = 0.25,
                 dim_a: int = 2400):
        super().__init__(vqa_model, knn_size, trainable_vqa)
        spec = {k: True for k in ("v_emb", "v_mult", "v_dist", "v_rank",
                                  "q_emb", "a_emb", "z_emb")}
        spec.update(model_spec or {})
        self.model_spec = spec
        self.dim_h = dim_h
        self.n_layers = n_layers
        self.drop_p = drop_p
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
        policy."""
        spec = self.model_spec
        return (spec["v_emb"] and spec["v_mult"] and spec["v_dist"]
                and compute_dtype() == torch.bfloat16)

    def wants_table_features(self) -> bool:
        """When True, engines pass ``features_table=`` / ``image_idxs=``
        instead of the materialized (B, K+1, dim_v) gather (needs the z
        cache)."""
        return self._fused_vfeat_ok()

    def forward(self, image_features, question_wids, answer_aids,
                q_emb=None, v_proj=None, z_emb=None, features_table=None,
                image_idxs=None, dropout_gen: torch.Generator | None = None,
                lesion_gen: torch.Generator | None = None) -> torch.Tensor:
        """Scores (B, K) f32.  ``dropout_gen`` draws the dropout masks in
        training mode (required there when ``drop_p > 0``); ``lesion_gen``
        draws the lesions' placeholders (required when the spec has
        one)."""
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
        if self.training and self.drop_p > 0 and dropout_gen is None:
            raise ValueError("training mode draws dropout masks: pass "
                             "dropout_gen")
        sl = self.slices

        fused_v = (image_features is None and z_emb is not None
                   and self._fused_vfeat_ok())
        if image_features is None and not fused_v:
            image_features = features_table[image_idxs.long()]
        if not spec["v_emb"]:
            image_features = _uniform(lesion_gen, (batch, K + 1, sl.dim_v))
            # the placeholders are redrawn per forward: the per-image and
            # per-example caches no longer describe them
            v_proj = z_emb = None
            fused_v = False
        if fused_v:
            v_orig = features_table[image_idxs[:, 0].long()]
            v_knns = None
        else:
            v_orig = image_features[:, 0]
            v_knns = image_features[:, 1:]

        fused_head = spec["a_emb"] and self._fused_head_ok()
        fused_z = a_knns = None
        if spec["q_emb"] or spec["z_emb"] or spec["a_emb"]:
            z_orig, a_knns, z_knns, q_emb = self.vqa_forward(
                image_features, question_wids, q_emb=q_emb, v_proj=v_proj,
                z_emb=z_emb, want_logits=spec["a_emb"] and not fused_head)
            # the answer head reads the real fused embeddings, even when the
            # z feature itself is lesioned below
            fused_z = z_knns
            if not spec["q_emb"] and not spec["z_emb"]:
                # (the reference's quirk: the q_emb lesion acts only here)
                q_emb = _uniform(lesion_gen, (batch, sl.dim_q))
                z_orig = _uniform(lesion_gen, (batch, sl.dim_z))
                z_knns = _uniform(lesion_gen, (batch, K, sl.dim_z))
        else:
            q_emb = _uniform(lesion_gen, (batch, sl.dim_q))
            z_orig = _uniform(lesion_gen, (batch, sl.dim_z))
            z_knns = _uniform(lesion_gen, (batch, K, sl.dim_z))

        table = self.answer_embedding.weight
        a_emb_factored = a_emb_knns = None
        if spec["a_emb"]:
            a_emb_gt = table[answer_aids.long()]
            if fused_head:
                w_cls, b_cls = self.vqa_model.classif_params()
                a_emb_factored = ("fused", fused_z, w_cls, b_cls, table)
            else:
                a_emb_factored = (a_knns, table)
        else:
            a_emb_gt = _uniform(lesion_gen, (batch, self.dim_a))
            a_emb_knns = _uniform(lesion_gen, (batch, K, self.dim_a))

        v_mult = v_dist = None
        if not fused_v:
            v_mult = (v_orig[:, None, :] * v_knns if spec["v_mult"]
                      else torch.zeros_like(v_knns))
            v_dist = (pairwise_distance(v_orig[:, None, :], v_knns,
                                        keepdims=False)
                      if spec["v_dist"]
                      else v_knns.new_zeros((batch, K)).float())
        v_rank = (None if spec["v_rank"]
                  else _uniform(lesion_gen, (batch, K, K)))

        w1 = self.linear_1.weight.t()  # (input_size, H)
        h_v_fused = None
        if fused_v:
            h_v_fused, v_dist = self._fused_vfeat(features_table, image_idxs,
                                                  w1)
        h = scorer_ops.first_layer_decomposed(
            w1, self.linear_1.bias, sl, v_orig=v_orig, v_knns=v_knns,
            v_mult=v_mult, v_dist=v_dist, v_rank=v_rank, q_emb=q_emb,
            z_orig=z_orig, z_knns=z_knns, a_emb_gt=a_emb_gt,
            a_emb_knns=a_emb_knns, a_emb_knns_factored=a_emb_factored,
            h_v_fused=h_v_fused)
        hidden = self._layers()[1:]
        return scorer_ops.mlp_tail(
            h, [layer.weight.t() for layer in hidden],
            [layer.bias for layer in hidden], self.out.weight.t(),
            self.out.bias, drop_p=self.drop_p,
            generator=dropout_gen if self.training else None)

    def _fused_vfeat(self, features_table, image_idxs, w1):
        """Candidate image features from the table + indices in one kernel
        -> (h_v (B, K, H) bf16, v_dist (B, K) f32); differentiable in the
        v_other / v_mult columns of ``linear_1.weight`` (the backward
        kernel)."""
        offs = self.slices.offsets()
        w_other = cast_in(w1[slice(*offs["v_other"])].t()).contiguous()
        w_mult = cast_in(w1[slice(*offs["v_mult"])].t()).contiguous()
        return vfeat_scores(cast_in(features_table).contiguous(),
                            image_idxs.to(torch.int32).contiguous(),
                            w_other, w_mult)
