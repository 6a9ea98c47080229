"""Scalar event sink (port of ``core/experiment.ScalarWriter``): one JSON
line per scalar in ``<log_dir>/events.jsonl``."""

from __future__ import annotations

import json
import os
import time


class ScalarWriter:
    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._fh = open(os.path.join(log_dir, "events.jsonl"), "a")

    def add_scalar(self, tag: str, value, step: int):
        rec = {"tag": tag, "value": float(value), "step": int(step),
               "wall_time": time.time()}
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def close(self):
        self._fh.close()
