"""Feature store: extracted CNN features + the name<->index contract (port
of ``data/features.py``).  ``to_device`` pins the whole matrix on the device
once, so steps gather rows by index on the device."""

from __future__ import annotations

import numpy as np
import torch


class FeatureStore:
    def __init__(self, features: np.ndarray, names: list[str]):
        if features.shape[0] != len(names):
            raise ValueError("%d feature rows vs %d names"
                             % (features.shape[0], len(names)))
        self.features = features
        self.names = list(names)
        self.name_to_index = {name: i for i, name in enumerate(self.names)}

    def to_device(self, device) -> torch.Tensor:
        """The feature matrix as a tensor on ``device``."""
        return torch.from_numpy(np.ascontiguousarray(self.features)).to(device)
