"""The counterexample (CX) model zoo (port of ``models/cx.py``): ten
scorers of the K candidate images of a question.

Contract: ``forward(image_features (B, K+1, dim_v) | None, question_wids
(B, T), answer_aids (B,)) -> scores (B, K)``; index 0 of the candidate
axis is the original image, 1..K its KNNs (ContrastiveModel returns the
embeddings (B, K+1, H) instead; its scores come from ``get_scores``).
RandomBaseline and DistanceBaseline hold no backbone and no parameters;
the others drive a VQA backbone over all K+1 images at once
(``CXModelBase.vqa_forward``).  The pairwise models take K from the input
shape: K 2 in pairwise training, the full list in eval.

NeuralCX (``NeuralModel``): the per-candidate MLP over the 14089-d concat
[v_orig, v_other, v_mult, v_dist, rank one-hot, q_emb, z_orig, z_other,
a_emb_gt, a_emb_other] is scored for all candidates at once by
``ops/scorer``.  The table form (``features_table=`` + ``image_idxs=``)
replaces the materialized gather.  Two CUDA kernels sit on this path under
the bf16 policy with a frozen backbone: the candidate image features,
forward and weight-gradient backward (``ops/cuda/vfeat_kernel.py``, table
form + z cache), and the answer head fused with its softmax
(``ops/cuda/mixture_kernel.py``).  In training mode (``.train()``) dropout
follows every ReLU of the MLP, with masks from the ``dropout_gen``
generator.  The ``model_spec`` lesion flags replace features with U[0, 1)
placeholders drawn from ``lesion_gen`` (in either mode, as the reference's
``torch.rand`` did), including the reference quirk that the q_emb lesion
acts only when z_emb is lesioned too.

The backbone is frozen by default: no gradient, no optimizer state, eval
mode whatever the CX model's mode, and its outputs may come from the q/v/z
caches.  With ``trainable_vqa`` it follows the CX model's mode and trains
with it (JAX ``models/cx.py:75-153``); in training its dropouts are live
and draw from the step's ``dropout_gen``, in this order: the encoder's
variational masks (input, then state), the fusion's ``dropout_v`` then
``dropout_q`` (per candidate: the duplicated fusion path), the
classifier's dropout, then the CX head's own.  The caches, the fused
answer head and the vfeat table form need a frozen backbone and are closed
with a trainable one.  PairwiseModel stops the gradient through the
candidates' fused embeddings even then (JAX ``cx.py:538``).

Attribute names follow the reference checkpoint (``vqa_model``,
``answer_embedding``, ``linear_1`` .. ``linear_n``, ``linear``, ``out``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..core.policy import cast_in, compute_dtype
from ..ops import scorer as scorer_ops
from ..ops.cuda.vfeat_kernel import vfeat_scores
from ..ops.metrics import cosine_similarity, pairwise_distance
from .fusion import dense, lecun_normal_
from .seq2vec import embedding


def _uniform(gen: torch.Generator | None, shape) -> torch.Tensor:
    """torch.rand placeholder: U[0, 1) from the lesion generator."""
    if gen is None:
        raise ValueError("a lesioned model_spec draws placeholders: pass "
                         "lesion_gen")
    return torch.rand(tuple(shape), generator=gen, device=gen.device)


def _at_answer(x: torch.Tensor, answer_aids: torch.Tensor) -> torch.Tensor:
    """(B, K, A) -> (B, K): each row's entry at the example's answer."""
    idx = answer_aids.long()[:, None, None].expand(x.shape[0], x.shape[1], 1)
    return torch.gather(x, -1, idx)[..., 0]


def _tile(x: torch.Tensor, k: int) -> torch.Tensor:
    """(B, D) -> (B, k, D), f32."""
    return x.float()[:, None, :].expand(x.shape[0], k, x.shape[-1])


class _NoBackbone(nn.Module):
    """A baseline with no parameters: a buffer of size 0 carries its device
    (engines read it), and nothing is initialized."""

    def __init__(self, knn_size: int = 24):
        super().__init__()
        self.knn_size = knn_size
        self.register_buffer("device_anchor", torch.empty(0),
                             persistent=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """No parameters to draw."""


class RandomBaseline(_NoBackbone):
    """Uniform random scores (JAX ``cx.py:41-51``): U[0, 1) from
    ``lesion_gen``, in eval too."""

    def forward(self, image_features, question_wids, answer_aids,
                q_emb=None, v_proj=None, z_emb=None, dropout_gen=None,
                lesion_gen=None) -> torch.Tensor:
        return _uniform(lesion_gen, (image_features.shape[0],
                                     self.knn_size))


class DistanceBaseline(_NoBackbone):
    """The candidates' NN-rank order reversed, ``K-1 ... 0`` (JAX
    ``cx.py:54-65``)."""

    def forward(self, image_features, question_wids, answer_aids,
                q_emb=None, v_proj=None, z_emb=None, dropout_gen=None,
                lesion_gen=None) -> torch.Tensor:
        row = torch.arange(self.knn_size - 1, -1, -1, dtype=torch.float32,
                           device=image_features.device)
        return row[None, :].expand(image_features.shape[0], self.knn_size)


class CXModelBase(nn.Module):
    """Holds the VQA backbone and runs it over all K+1 images at once."""

    def __init__(self, vqa_model: nn.Module, knn_size: int = 24,
                 trainable_vqa: bool = False):
        super().__init__()
        self.trainable_vqa = trainable_vqa
        self.vqa_model = vqa_model
        self.knn_size = knn_size
        if not trainable_vqa:
            # the frozen backbone (JAX: stop_gradient + eval-mode VQA)
            # holds no grads and gets no optimizer state
            vqa_model.requires_grad_(False)

    def train(self, mode: bool = True):
        """A frozen backbone stays in eval mode (reference cx.py:59-60); a
        trainable one follows the CX model."""
        super().train(mode)
        if not self.trainable_vqa:
            self.vqa_model.eval()
        return self

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The backbone's JAX initializers, then this model's layers':
        lecun_normal kernels, zero biases."""
        self.vqa_model.reset_parameters(generator)
        for layer in self._dense_layers():
            lecun_normal_(layer.weight, generator)
            layer.bias.zero_()

    def _dense_layers(self) -> list:
        return [getattr(self, name) for name in ("linear", "out")
                if hasattr(self, name)]

    def _dims(self):
        """(dim_v, dim_q, dim_mm) of the backbone's fusion."""
        fus = self.vqa_model.opt["fusion"]
        return fus["dim_v"], fus["dim_q"], fus["dim_mm"]

    def vqa_forward(self, image_features, question_wids, q_emb=None,
                    v_proj=None, z_emb=None, want_logits: bool = True,
                    generator: torch.Generator | None = None):
        """-> (z_orig, a_knns | None, z_knns, q_emb).  With ``z_emb`` (the
        per-example fused-embedding cache) the raw features are not read.
        A trainable backbone in training draws its dropout masks from
        ``generator`` (the order is in the module docstring)."""
        if self.trainable_vqa and not (q_emb is None and v_proj is None
                                       and z_emb is None):
            raise ValueError("the q_emb/v_proj/z_emb caches need a frozen "
                             "VQA backbone")
        training = self.trainable_vqa and self.training
        if q_emb is None:
            q_emb = self.vqa_model.encode_question(question_wids, training,
                                                   generator)
        if z_emb is not None:
            z = z_emb
        else:
            z = self.vqa_model.fuse_candidates(image_features, q_emb,
                                               v_proj=v_proj,
                                               training=training,
                                               generator=generator)
        z_orig, z_knns = z[:, 0], z[:, 1:]
        a_knns = None
        if want_logits:
            batch, k = z_knns.shape[:2]
            a_knns = self.vqa_model.classify(
                z_knns.reshape(batch * k, -1), training,
                generator).reshape(batch, k, -1)
        return z_orig, a_knns, z_knns, q_emb

    def _fused_head_ok(self) -> bool:
        """The fused classify + softmax kernel serves the frozen,
        activation-free answer head under the bf16 policy (JAX
        ``cx.py:171``: never with a trainable backbone)."""
        return (not self.trainable_vqa
                and "activation" not in self.vqa_model.opt.get("classif", {})
                and compute_dtype() == torch.bfloat16)


class BlackBox(CXModelBase):
    """score_i = -softmax(a_knn_i)[original answer] (JAX ``cx.py:192-206``):
    candidates likely to repeat the answer are bad counterexamples."""

    def forward(self, image_features, question_wids, answer_aids,
                q_emb=None, v_proj=None, z_emb=None, dropout_gen=None,
                lesion_gen=None) -> torch.Tensor:
        _, a_knns, _, _ = self.vqa_forward(
            image_features, question_wids, q_emb=q_emb, v_proj=v_proj,
            z_emb=z_emb, generator=dropout_gen)
        return -_at_answer(torch.softmax(a_knns, dim=-1), answer_aids)


class LinearContext(CXModelBase):
    """One linear over the concat of all K fused embeddings (JAX
    ``cx.py:209-223``)."""

    def __init__(self, vqa_model: nn.Module, knn_size: int = 24,
                 trainable_vqa: bool = False):
        super().__init__(vqa_model, knn_size, trainable_vqa)
        self.linear = nn.Linear(knn_size * self._dims()[2], knn_size)

    def forward(self, image_features, question_wids, answer_aids,
                q_emb=None, v_proj=None, z_emb=None, dropout_gen=None,
                lesion_gen=None) -> torch.Tensor:
        _, _, z_knns, _ = self.vqa_forward(
            image_features, question_wids, q_emb=q_emb, v_proj=v_proj,
            z_emb=z_emb, want_logits=False, generator=dropout_gen)
        return dense(z_knns.reshape(z_knns.shape[0], -1), self.linear)


class SemanticBaseline(CXModelBase):
    """lam * (answer-similarity-weighted mass) - (1 - lam) * log p(orig
    answer), softmaxed over the candidates (JAX ``cx.py:226-253``).
    ``emb_pairs`` is the (A, A) cosine-similarity matrix of the answer
    embedding table.  The reference's quirks are kept: the candidate's own
    mass on the original answer is subtracted from the weighted sum, and
    the log takes ``p + 1e-8``."""

    def __init__(self, vqa_model: nn.Module, knn_size: int = 24,
                 trainable_vqa: bool = False, lam: float = 0.5):
        super().__init__(vqa_model, knn_size, trainable_vqa)
        self.lam = lam

    def forward(self, image_features, question_wids, answer_aids,
                emb_pairs=None, q_emb=None, v_proj=None, z_emb=None,
                dropout_gen=None, lesion_gen=None) -> torch.Tensor:
        if emb_pairs is None:
            raise ValueError("pass emb_pairs, the (A, A) cosine matrix")
        _, a_knns, _, _ = self.vqa_forward(
            image_features, question_wids, q_emb=q_emb, v_proj=v_proj,
            z_emb=z_emb, generator=dropout_gen)
        nb = torch.softmax(a_knns, dim=-1)                     # (B, K, A)
        sim_rows = emb_pairs[answer_aids.long()]                # (B, A)
        weighted_sim = torch.einsum("ba,bka->bk", sim_rows, nb)
        p_orig = _at_answer(nb, answer_aids)                    # (B, K)
        weighted_sim = weighted_sim - p_orig
        logp = torch.log(p_orig + 1e-8)
        scores = self.lam * weighted_sim - (1.0 - self.lam) * logp
        return torch.softmax(scores, dim=-1)


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
        cache, so a frozen backbone)."""
        return not self.trainable_vqa and self._fused_vfeat_ok()

    def forward(self, image_features, question_wids, answer_aids,
                q_emb=None, v_proj=None, z_emb=None, features_table=None,
                image_idxs=None, dropout_gen: torch.Generator | None = None,
                lesion_gen: torch.Generator | None = None) -> torch.Tensor:
        """Scores (B, K) f32.  ``dropout_gen`` draws the dropout masks in
        training mode (required there when ``drop_p > 0`` or the backbone
        trains); ``lesion_gen`` draws the lesions' placeholders (required
        when the spec has one)."""
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
                z_emb=z_emb, want_logits=spec["a_emb"] and not fused_head,
                generator=dropout_gen)
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


class PairwiseModel(CXModelBase):
    """Hard-negative pairwise scorer (JAX ``cx.py:518-550``): an MLP over
    [v_orig, v_other, q_emb, z_other] -> relu(score), hidden width 300.
    Trained with K 2 (the comp against a random other), evaluated with the
    full list: K comes from the input shape."""

    def __init__(self, vqa_model: nn.Module, knn_size: int = 24,
                 trainable_vqa: bool = False):
        super().__init__(vqa_model, knn_size, trainable_vqa)
        dim_v, dim_q, dim_mm = self._dims()
        self.linear = nn.Linear(2 * dim_v + dim_q + dim_mm, 300)
        self.out = nn.Linear(300, 1)

    def forward(self, image_features, question_wids, answer_aids,
                q_emb=None, v_proj=None, z_emb=None, dropout_gen=None,
                lesion_gen=None) -> torch.Tensor:
        k = image_features.shape[1] - 1
        _, _, z_knns, q_emb = self.vqa_forward(
            image_features, question_wids, q_emb=q_emb, v_proj=v_proj,
            z_emb=z_emb, want_logits=False, generator=dropout_gen)
        x = torch.cat([_tile(image_features[:, 0], k),
                       image_features[:, 1:].float(), _tile(q_emb, k),
                       z_knns.detach().float()], dim=-1)
        h = torch.relu(dense(x, self.linear))
        return torch.relu(dense(h, self.out))[..., 0]


class PairwiseLinearModel(CXModelBase):
    """The pairwise scorer with a learned 300-d answer embedding (JAX
    ``cx.py:553-582``): an MLP over [v_orig, v_other, q_emb, z_orig,
    z_other, a_emb]; K from the input shape."""

    def __init__(self, vqa_model: nn.Module, knn_size: int = 24,
                 trainable_vqa: bool = False, dim_a: int = 300):
        super().__init__(vqa_model, knn_size, trainable_vqa)
        dim_v, dim_q, dim_mm = self._dims()
        self.dim_a = dim_a
        self.answer_embedding = nn.Embedding(len(vqa_model.vocab_answers),
                                             dim_a)
        self.linear = nn.Linear(2 * dim_v + dim_q + 2 * dim_mm + dim_a, 300)
        self.out = nn.Linear(300, 1)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """As the base, and flax ``Embed``'s default for the answer table:
        variance 1/dim_a, truncated at two std (lecun_normal's)."""
        super().reset_parameters(generator)
        lecun_normal_(self.answer_embedding.weight, generator)

    def forward(self, image_features, question_wids, answer_aids,
                q_emb=None, v_proj=None, z_emb=None, dropout_gen=None,
                lesion_gen=None) -> torch.Tensor:
        k = image_features.shape[1] - 1
        z_orig, _, z_knns, q_emb = self.vqa_forward(
            image_features, question_wids, q_emb=q_emb, v_proj=v_proj,
            z_emb=z_emb, want_logits=False, generator=dropout_gen)
        a_emb = embedding(answer_aids.long(), self.answer_embedding.weight)
        x = torch.cat([_tile(image_features[:, 0], k),
                       image_features[:, 1:].float(), _tile(q_emb, k),
                       _tile(z_orig, k), z_knns.float(), _tile(a_emb, k)],
                      dim=-1)
        h = torch.relu(dense(x, self.linear))
        return torch.relu(dense(h, self.out))[..., 0]


class ContrastiveModel(CXModelBase):
    """Embeds each of the K+1 images to h = relu(Linear([v, z])) (JAX
    ``cx.py:585-608``) -> (B, K+1, dim_h); trained with the margin loss of
    ``engines/contrastive_engine``, scored by the Euclidean distance from
    the original (``get_scores``)."""

    def __init__(self, vqa_model: nn.Module, knn_size: int = 24,
                 trainable_vqa: bool = False, dim_h: int = 300):
        super().__init__(vqa_model, knn_size, trainable_vqa)
        dim_v, _, dim_mm = self._dims()
        self.dim_h = dim_h
        self.linear = nn.Linear(dim_v + dim_mm, dim_h)

    def forward(self, image_features, question_wids, answer_aids,
                q_emb=None, v_proj=None, z_emb=None, dropout_gen=None,
                lesion_gen=None) -> torch.Tensor:
        z_orig, _, z_knns, _ = self.vqa_forward(
            image_features, question_wids, q_emb=q_emb, v_proj=v_proj,
            z_emb=z_emb, want_logits=False, generator=dropout_gen)
        z_all = torch.cat([z_orig[:, None, :], z_knns], dim=1).float()
        x = torch.cat([image_features.float(), z_all], dim=-1)
        return torch.relu(dense(x, self.linear))

    @staticmethod
    def get_scores(h_orig: torch.Tensor, h_knns: torch.Tensor
                   ) -> torch.Tensor:
        """Euclidean distances (B, K); larger = better counterexample."""
        return pairwise_distance(h_orig[:, None, :], h_knns, keepdims=False)


class SimilarityModel(CXModelBase):
    """No parameters of its own: v cosine + z cosine + the answer's cross
    entropy (JAX ``cx.py:611-630``)."""

    def forward(self, image_features, question_wids, answer_aids,
                q_emb=None, v_proj=None, z_emb=None, dropout_gen=None,
                lesion_gen=None) -> torch.Tensor:
        z_orig, a_knns, z_knns, _ = self.vqa_forward(
            image_features, question_wids, q_emb=q_emb, v_proj=v_proj,
            z_emb=z_emb, generator=dropout_gen)
        v_cos = cosine_similarity(image_features[:, :1],
                                  image_features[:, 1:])
        z_cos = cosine_similarity(z_orig[:, None, :], z_knns)
        a_xent = -_at_answer(torch.log_softmax(a_knns, dim=-1), answer_aids)
        return v_cos + z_cos + a_xent


@torch.no_grad()
def init_answer_embedding(model: NeuralModel, emb) -> NeuralModel:
    """Copy a pretrained (A, dim_a) answer-embedding table into
    NeuralModel's ``answer_embedding`` in place (JAX ``models/cx.py:633``;
    reference cx.py:240-243 loads answer_embedding.pickle)."""
    weight = model.answer_embedding.weight
    value = torch.from_numpy(np.asarray(emb, dtype=np.float32))
    if tuple(value.shape) != tuple(weight.shape):
        raise ValueError("answer embedding table %s, the model's %s"
                         % (tuple(value.shape), tuple(weight.shape)))
    weight.copy_(value)
    return model
