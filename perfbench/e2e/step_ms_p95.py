"""The 95th percentile, over every step of the window, of the device time
between consecutive step completions (CUDA events recorded after each
step's call on its stream, read once after the window; the first interval
from the window's start).  A host stall between steps shows in it."""

import numpy as np


def read(window: dict):
    ms = np.asarray(window["step_ms"], dtype=np.float64)
    if ms.size == 0:
        return None
    return float(np.percentile(ms, 95))
