"""Finds what belongs to a cell by name: files only, no table in code.

- ``BENCHMARK.json`` at the root of the checkout: the cells and metrics;
- ``perfbench/workloads/<cell>.json``: config, traffic, chips, why and the
  limits of its correctness check;
- ``perfbench/configs/<config>.json``: the model and data sizes;
- ``perfbench/traffic/<traffic>.json``: the mix's parameters, with the
  job (``perfbench/jobs/<job>.py``) that drives the port;
- ``perfbench/metrics/<metric>.py``: a per-layer reader, ``read(trace)``;
- ``perfbench/e2e/<metric>.py``: an end-to-end reader, ``read(window)``;
- ``perfbench/counts/<config>.py``: a step's operations;
  ``perfbench/counts/kernels.py``: each kernel's operations and bytes;
- ``perfbench/reference/<config>.py``: the plain reference.

A later cell, configuration or metric is a new file and a new entry in
``BENCHMARK.json``; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os

PERFBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PERFBENCH)


class Registry:
    """The benchmark's files under ``base`` (a checkout's ``perfbench/``)
    and its ``BENCHMARK.json`` (``bench_file``)."""

    def __init__(self, base: str = PERFBENCH, bench_file: str | None = None):
        self.base = base
        self.bench_file = bench_file or os.path.join(
            os.path.dirname(base), "BENCHMARK.json")

    def _json(self, *parts) -> dict:
        path = os.path.join(self.base, *parts)
        with open(path) as f:
            return json.load(f)

    def benchmark(self) -> dict:
        with open(self.bench_file) as f:
            return json.load(f)

    def cell(self, name: str) -> dict:
        cell = self._json("workloads", name + ".json")
        if cell.get("name") != name:
            raise ValueError("workloads/%s.json names itself %r"
                             % (name, cell.get("name")))
        return cell

    def config(self, name: str) -> dict:
        return self._json("configs", name + ".json")

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name + ".json")

    def module(self, kind: str, name: str):
        """``perfbench/<kind>/<name>.py`` loaded by its path (metric names
        hold dots, so they are not import names)."""
        path = os.path.join(self.base, kind, name + ".py")
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        spec = importlib.util.spec_from_file_location(
            "perfbench_%s_%s" % (kind, name.replace(".", "_")), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def job(self, name: str):
        return self.module("jobs", name)

    def counts(self, config: str):
        return self.module("counts", config)

    def kernels(self):
        return self.module("counts", "kernels")

    def reference(self, config: str):
        return self.module("reference", config)

    def metrics_of(self, cell: str, group: str) -> list:
        """The entries of ``BENCHMARK.json[group]`` that ``cell`` reports:
        those whose ``workloads`` list it, or, without the key, every cell
        (an end-to-end metric) or every cell that reports the end-to-end
        metric the entry ``moves`` (a per-layer metric)."""
        bench = self.benchmark()
        e2e = [m["name"] for m in self.metrics_of_e2e(bench, cell)]
        if group == "end_to_end":
            return self.metrics_of_e2e(bench, cell)
        out = []
        for m in bench.get("per_layer", []):
            listed = m.get("workloads")
            if (cell in listed) if listed is not None else (
                    m["moves"] in e2e):
                out.append(m)
        return out

    @staticmethod
    def metrics_of_e2e(bench: dict, cell: str) -> list:
        return [m for m in bench.get("end_to_end", [])
                if m.get("workloads") is None or cell in m["workloads"]]
