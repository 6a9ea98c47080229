"""Shared model helpers (port of ``models/common.py``)."""

from __future__ import annotations

import torch

from ..core import rng as rng_lib


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None,
            training: bool) -> torch.Tensor:
    """Inverted dropout with the keep-mask of ``core/rng.keep_mask`` (8 bits
    per element: rate 0.5 keeps 128/256, 0.25 keeps 192/256), drawn from
    ``generator``.  The identity outside training or at rate 0."""
    if not training or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("training-mode dropout draws its mask from a "
                         "generator: pass one")
    keep, scale = rng_lib.keep_mask(x.shape, 1.0 - rate, generator)
    return torch.where(keep, x * scale, 0.0)
