"""A copy of the benchmark's files at toy widths and sizes, for the CPU
tests: the same cells, traffic and code, every width and count cut, and
the check's limits ten times the card's, at most 0.5 (a toy width's
sums average fewer terms)."""

from __future__ import annotations

import json
import os
import shutil

from perfbench.harness.registry import PERFBENCH, Registry

TINY_MODEL = {
    "seq2vec": {"emb_size": 16, "hidden_size": 24},
    "fusion": {"dim_v": 32, "dim_q": 24, "dim_hv": 12, "dim_hq": 12,
               "dim_mm": 12, "R": 3},
}


def shrink(cfg: dict) -> dict:
    cfg = json.loads(json.dumps(cfg))
    cfg["model"]["seq2vec"].update(TINY_MODEL["seq2vec"])
    cfg["model"]["fusion"].update(TINY_MODEL["fusion"])
    cfg["nans"], cfg["n_words"] = 20, 50
    if "cx_model" in cfg:
        cfg["cx_model"].update(dim_h=8, dim_a=24)
        cfg["knn_size"] = 6
        cfg["data"]["train"].update(n_examples=300, n_images=60)
    else:
        cfg["data"]["train"].update(n_examples=400, n_images=80)
        cfg["data"]["val"].update(n_examples=300, n_images=50)
    return cfg


def tiny_tree(dest: str, batch: int = 32) -> Registry:
    """``dest``/perfbench with the configurations and traffic shrunk, and
    ``dest``/BENCHMARK.json; returns its registry."""
    base = os.path.join(dest, "perfbench")
    for sub in ("configs", "workloads", "traffic"):
        shutil.copytree(os.path.join(PERFBENCH, sub), os.path.join(base, sub))
    for sub in ("jobs", "metrics", "e2e", "counts", "reference"):
        shutil.copytree(os.path.join(PERFBENCH, sub), os.path.join(base, sub),
                        ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(os.path.dirname(PERFBENCH), "BENCHMARK.json"),
                os.path.join(dest, "BENCHMARK.json"))
    for name in os.listdir(os.path.join(base, "configs")):
        path = os.path.join(base, "configs", name)
        with open(path) as f:
            cfg = json.load(f)
        with open(path, "w") as f:
            json.dump(shrink(cfg), f)
    for name in os.listdir(os.path.join(base, "workloads")):
        path = os.path.join(base, "workloads", name)
        with open(path) as f:
            cell = json.load(f)
        # toy widths average over fewer terms: ten times the card's limits,
        # at most half of what a state left unchanged reads
        cell["limits"] = {k: min(v * 10, 0.5)
                          for k, v in cell["limits"].items()}
        with open(path, "w") as f:
            json.dump(cell, f)
    for name in sorted(n for n in os.listdir(os.path.join(base, "traffic"))
                       if n.endswith(".json")):
        path = os.path.join(base, "traffic", name)
        with open(path) as f:
            tr = json.load(f)
        tr["batch_size"] = batch
        tr["sample_rows"] = min(tr.get("sample_rows", 64), 64)
        tr["longest_rows"] = min(tr.get("longest_rows", 8), 8)
        with open(path, "w") as f:
            json.dump(tr, f)
    return Registry(base)
