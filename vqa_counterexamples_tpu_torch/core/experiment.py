"""Experiment logger and scalar event sink (port of
``core/experiment.py``).

``Experiment`` holds named meter groups per split and serialises what was
logged to JSON, as the reference ``vqa/lib/logger.py:8-82`` does;
``ScalarWriter`` writes one JSON line per scalar in
``<log_dir>/events.jsonl``.
"""

from __future__ import annotations

import copy
import json
import os
import time
from collections import defaultdict

from .meters import AvgMeter, SumMeter, ValueMeter  # noqa: F401 (re-export)


class Experiment:
    def __init__(self, name: str, options: dict | None = None):
        self.name = name
        self.options = dict(options or {})
        self.date_and_time = time.strftime("%d-%m-%Y--%H-%M-%S")
        self.info = defaultdict(dict)
        self.logged = defaultdict(dict)
        self.meters = defaultdict(dict)

    def add_meters(self, tag: str, meters_dict: dict):
        assert tag not in self.meters
        for name, meter in meters_dict.items():
            self.add_meter(tag, name, meter)

    def add_meter(self, tag: str, name: str, meter):
        assert name not in self.meters[tag], (
            "meter with tag %s and name %s already exists" % (tag, name))
        self.meters[tag][name] = meter

    def log_meter(self, tag: str, name: str, n: int = 1):
        meter = self.get_meter(tag, name)
        self.logged[tag].setdefault(name, {})[n] = meter.value()

    def log_meters(self, tag: str, n: int = 1):
        for name in self.get_meters(tag):
            self.log_meter(tag, name, n=n)

    def reset_meters(self, tag: str):
        meters = self.get_meters(tag)
        for meter in meters.values():
            meter.reset()
        return meters

    def get_meters(self, tag: str):
        assert tag in self.meters
        return self.meters[tag]

    def get_meter(self, tag: str, name: str):
        assert tag in self.meters and name in self.meters[tag]
        return self.meters[tag][name]

    def to_json(self, filename: str):
        os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
        var_dict = copy.copy(vars(self))
        var_dict.pop("meters")
        var_dict["info"] = dict(self.info)
        var_dict["logged"] = {k: dict(v) for k, v in self.logged.items()}
        with open(filename, "w") as f:
            json.dump(var_dict, f)


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


class NullWriter:
    """A :class:`ScalarWriter` that writes nothing (the ranks other than 0
    of a data-parallel run)."""

    def add_scalar(self, tag: str, value, step: int):
        pass

    def close(self):
        pass


def scalar_writer(log_dir: str, mesh=None):
    """A :class:`ScalarWriter` on rank 0 (or with no mesh), else a
    :class:`NullWriter`."""
    return ScalarWriter(log_dir) if mesh is None or mesh.is_main \
        else NullWriter()
