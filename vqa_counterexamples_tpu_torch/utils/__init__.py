"""The reference's ``vqa/lib/utils.py`` surface (port of ``utils/``):
``update_values``, ``merge_dict`` and ``str2bool`` from ``core/config``,
``accuracy`` (``ops/metrics.accuracy_topk``), ``params_count`` and
``create_n_hot``."""

from __future__ import annotations

import numpy as np
import torch

from ..core.config import merge_dict, str2bool, update_values  # noqa: F401
from ..ops.metrics import accuracy_topk as accuracy  # noqa: F401


def params_count(params) -> int:
    """Total parameter count of a module or a ``state_dict`` (reference
    ``utils.py:40-47``)."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    return sum(int(np.prod(tuple(v.shape))) for v in params.values())


def create_n_hot(idxs, n: int) -> torch.Tensor:
    """Normalized multi-hot vector, f32 (reference ``utils.py:61-65``)."""
    out = np.zeros(n, dtype=np.float32)
    for i in idxs:
        out[i] += 1
    return torch.from_numpy(out / out.sum())
