"""Metrics: recall@K over candidate rankings, top-k accuracy, CE losses,
distances and cosine similarity (port of ``ops/metrics.py``).  All return tensors on the input's
device: nothing here waits for the card."""

from __future__ import annotations

import torch


def recall_at_k(scores: torch.Tensor, ground_truth: torch.Tensor,
                k: int = 5) -> torch.Tensor:
    """Per-example 0/1 (f32): is the ground-truth index within the top-k
    scores?  scores (B, C); ground_truth (B,) int.  Ties rank the lower
    index first, as ``jax.lax.top_k`` does (``torch.topk`` leaves their
    order open): the ground truth is in the top k when fewer than k
    candidates score above it or tie with it at a lower index.  The
    pairwise models' ReLU scores tie at 0 often."""
    gt = ground_truth[:, None].long()
    s_gt = torch.gather(scores, 1, gt)
    idx = torch.arange(scores.shape[1], device=scores.device)[None, :]
    ahead = (scores > s_gt) | ((scores == s_gt) & (idx < gt))
    return (ahead.sum(dim=1) < k).to(torch.float32)


def accuracy_topk(output: torch.Tensor, target: torch.Tensor,
                  topk=(1,)) -> list:
    """Precision@k in percent (reference ``vqa/lib/utils.py:23-38``), as 0-d
    f32 tensors.  ``target`` may be (B,) class ids or (B, C) scores (then
    its argmax); k is clamped to the class count."""
    n_classes = output.shape[-1]
    maxk = min(max(topk), n_classes)
    batch_size = target.shape[0]
    if target.dim() == 2:
        target = torch.argmax(target, dim=1)
    pred = torch.topk(output, maxk, dim=1).indices
    correct = pred == target[:, None].long()
    return [torch.sum(correct[:, :min(k, n_classes)]).to(torch.float32)
            * (100.0 / batch_size) for k in topk]


def cross_entropy_sum(logits: torch.Tensor,
                      labels: torch.Tensor) -> torch.Tensor:
    """Summed (not averaged) softmax cross-entropy (reference
    ``nn.CrossEntropyLoss(size_average=False)``)."""
    return nll(logits, labels).sum()


def cross_entropy_mean(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    return cross_entropy_sum(logits, labels) / logits.shape[0]


def nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-row negative log-likelihood of ``labels`` under softmax(logits)."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels[:, None].long())[:, 0]


def pairwise_distance(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-6,
                      keepdims: bool = True) -> torch.Tensor:
    """Euclidean distance along the last axis (torch F.pairwise_distance
    semantics: eps inside the norm)."""
    d = torch.sqrt(torch.sum((a - b + eps) ** 2, dim=-1))
    return d[..., None] if keepdims else d


def cosine_similarity(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-8,
                      dim: int = -1) -> torch.Tensor:
    """Cosine similarity along ``dim``, the norms' product clamped below at
    ``eps`` (JAX ``ops/metrics.py:67``)."""
    na = torch.sqrt(torch.sum(a * a, dim=dim))
    nb = torch.sqrt(torch.sum(b * b, dim=dim))
    return torch.sum(a * b, dim=dim) / torch.clamp(na * nb, min=eps)
