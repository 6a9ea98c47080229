"""The numbers a run compares with the plain reference, each a gap that
is 0 where the two agree.

Training (the first steps, set out in PERF.md):
- ``loss``: the relative gap of the first step's loss (the later steps'
  gaps, which Adam's sign-like first updates make noisy, are printed
  beside it);
- ``grad``: the worst leaf's gap between the norms of the first gradient,
  against the larger of that leaf's reference norm and the median leaf's;
- ``grad_diff``: the worst leaf's norm of the difference of the two first
  gradients, against the same: the gap of norms is blind to rounding that
  is unbiased (it cancels in a norm), which this is not;
- ``head_grad_diff``: the same for the last layer's weight, which no ReLU
  follows: a pre-activation rounded across zero flips a ReLU, and those
  flips give every earlier leaf a difference that grows as the square
  root of the rounding (PERF.md), this one as the rounding;
- ``change``: the same for the norm of each leaf's change after the
  steps, leaving out the leaves whose reference gradient is under a
  thousandth of the median leaf's (moved by round-off alone).

Answers that a window produced:
- ``logit_gap``: the widest gap by which the logit of a produced answer
  lies below the reference's best, in units of that row's reference
  logits' standard deviation.
"""

from __future__ import annotations

import statistics

import torch

ROUNDOFF_SHARE = 1e-3


def loss_gap(prog: list, ref: list) -> float:
    if len(prog) != len(ref) or not prog:
        return float("inf")
    return max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog, ref))


def roundoff_leaves(ref_grads: dict) -> set:
    med = statistics.median(ref_grads.values())
    return {k for k, v in ref_grads.items() if v < ROUNDOFF_SHARE * med}


def leaf_gaps(prog: dict, ref: dict, skip=()) -> dict:
    """Each leaf of ``ref`` not in ``skip``: the gap between the two norms
    against the larger of the leaf's reference norm and the median
    leaf's; a leaf missing from ``prog`` reads infinite."""
    keys = [k for k in ref if k not in skip]
    med = statistics.median(ref[k] for k in keys)
    out = {}
    for k in keys:
        p = prog.get(k)
        out[k] = float("inf") if p is None or p != p else (
            abs(p - ref[k]) / max(ref[k], med, 1e-30))
    return out


def leaf_gap(prog: dict, ref: dict, skip=()) -> tuple:
    """(worst gap, its leaf)."""
    gaps = leaf_gaps(prog, ref, skip)
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf


def diff_gaps(prog: dict, ref: dict) -> dict:
    """Each leaf: the norm of the difference of the two first gradients,
    against the larger of the leaf's reference norm and the median
    leaf's."""
    norms = {k: float(torch.linalg.vector_norm(v.double()))
             for k, v in ref.items()}
    med = statistics.median(norms.values())
    out = {}
    for k, r in ref.items():
        p = prog.get(k)
        if p is None or p.shape != r.shape:
            out[k] = float("inf")
            continue
        d = float(torch.linalg.vector_norm((p.double() - r.double())))
        out[k] = d / max(norms[k], med, 1e-30) if d == d else float("inf")
    return out


def train_numbers(prog: dict, ref: dict, head: str | None = None) -> dict:
    """``prog`` / ``ref``: {losses, grads, grad_norms, change_norms};
    ``head``: the leaf of the model's last layer (``head_grad_diff``)."""
    skip = roundoff_leaves(ref["grad_norms"])
    grad, grad_leaf = leaf_gap(prog["grad_norms"], ref["grad_norms"])
    diffs = diff_gaps(prog["grads"], ref["grads"])
    change, change_leaf = leaf_gap(prog["change_norms"], ref["change_norms"],
                                   skip)
    return {"loss": loss_gap(prog["losses"][:1], ref["losses"][:1]),
            "grad": grad, "grad_diff": max(diffs.values()),
            "head_grad_diff": diffs.get(head, float("nan")),
            "change": change,
            "_worst_leaves": {"grad": grad_leaf, "change": change_leaf,
                              "grad_diff": max(diffs, key=diffs.get)},
            "_grad_diffs": diffs,
            "_step_loss_gaps": [abs(p - r) / max(abs(r), 1e-30) for p, r in
                                zip(prog["losses"], ref["losses"])],
            "_grad_gaps": leaf_gaps(prog["grad_norms"], ref["grad_norms"]),
            "_change_gaps": leaf_gaps(prog["change_norms"],
                                      ref["change_norms"], skip),
            "_roundoff_leaves": sorted(skip)}


def logit_gaps(ref_logits: torch.Tensor, picks: torch.Tensor
               ) -> torch.Tensor:
    """Per row: (reference max - reference logit of the pick) / the row's
    standard deviation."""
    ref = ref_logits.double()
    best = ref.max(dim=1).values
    got = ref.gather(1, picks.long().view(-1, 1))[:, 0]
    return (best - got) / ref.std(dim=1).clamp_min(1e-30)
