"""The harness on the CPU: the files a cell resolves to, the contract's
rules on ``BENCHMARK.json``, the generator's determinism and sizes, the
imports, a run with no card, and every cell run end to end at toy sizes."""

from __future__ import annotations

import ast
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from perfbench.harness import runner
from perfbench.harness.registry import PERFBENCH, ROOT, Registry
from perfbench.tests.tiny import tiny_tree
from perfbench.traffic import generate

REG = Registry()
BENCH = REG.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_has_the_contract_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(REG.bench_file) <= 64 * 1024
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word
    assert any(w.startswith("perfbench/") for w in BENCH["command"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    data = REG.cell(cell)
    for key in ("config", "traffic", "chips", "why"):
        assert data[key] == entry[key]
    cfg = REG.config(entry["config"])
    traffic = REG.traffic(entry["traffic"])
    assert cfg["name"] == entry["config"]
    assert REG.job(traffic["job"]).KIND in ("train", "eval")
    assert REG.reference(cfg["name"]).param_specs(cfg)
    assert REG.counts(cfg["name"]).dims(cfg)
    assert data["limits"]


def test_every_config_and_metric_resolves():
    for c in BENCH["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert c["file"].startswith("perfbench/")
        assert REG.config(c["name"])["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    for m in BENCH["end_to_end"]:
        assert hasattr(REG.module("e2e", m["name"]), "read")
    for m in BENCH["per_layer"]:
        assert hasattr(REG.module("metrics", m["name"]), "read")


def test_a_cell_file_added_to_a_copy_is_found(tmp_path):
    shutil.copytree(PERFBENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = dict(BENCH)
    new = dict(bench["workloads"][0], name="cx_train.b768_copy")
    bench["workloads"] = bench["workloads"] + [new]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = dict(REG.cell("cx_train.b768"), name="cx_train.b768_copy")
    (tmp_path / "perfbench" / "workloads" / "cx_train.b768_copy.json"
     ).write_text(json.dumps(cell))
    reg = Registry(str(tmp_path / "perfbench"))
    assert reg.cell("cx_train.b768_copy")["traffic"] == "cx_train_b768"
    names = [m["name"] for m in reg.metrics_of("cx_train.b768_copy",
                                               "end_to_end")]
    assert "setup_s" in names and "step_ms_p95" in names


def test_each_layer_metric_moves_one_reported_metric():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", CELLS):
            reported = [x["name"] for x in REG.metrics_of(cell, "end_to_end")]
            assert m["moves"] in reported, (m["name"], cell)
    for cell in CELLS:
        reported = [x["name"] for x in REG.metrics_of(cell, "end_to_end")]
        assert "setup_s" in reported and len(reported) >= 2
        assert REG.metrics_of(cell, "per_layer")


def test_names_units_and_lines():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in (
                    "lower", "higher")
                assert e["source"] in ("device_trace", "program_span",
                                       "program_counter", "host_clock")
            for key in ("why", "layer", "source"):
                if key in e and group in ("configs", "workloads",
                                          "per_layer"):
                    assert 1 <= len(e[key]) <= 200
                    assert "\n" not in e[key] and "\t" not in e[key]
    assert len(names) == len(set(names))
    for e in BENCH["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25
        assert e["source"] in ("host_clock", "device_trace")
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers == {"engines", "data", "device", "kernels"}
    for m in BENCH["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def _sizes(cfg, split):
    return cfg["data"][split]["n_examples"], cfg["data"][split]["n_images"]


def test_generator_is_deterministic_and_sized_as_the_configs():
    cx = REG.config("neuralcx_300_2_mutan_noatt")
    vqa = REG.config("mutan_noatt_bayesian_uniskip")
    assert _sizes(cx, "train") == (216000, 82783)
    assert vqa["data"]["train"]["n_questions"] == 443757
    assert vqa["data"]["train"]["n_examples"] == round(
        443757 * vqa["data"]["train"]["answer_filter_keep"])
    assert _sizes(vqa, "train")[1] == 82783
    assert _sizes(vqa, "val") == (214354, 40504)
    seed = 2 ** 31 + 12345
    a = generate.cx_data(cx, "train", seed, "cpu", with_features=False)
    b = generate.cx_data(cx, "train", seed, "cpu", with_features=False)
    for key in ("image_idxs", "question_wids", "answer_aids", "comp_idxs"):
        np.testing.assert_array_equal(a[key], b[key])
    assert a["image_idxs"].shape == (216000, 25)
    assert a["image_idxs"].max() < 82783
    own = a["image_idxs"][:, :1]
    assert not (a["image_idxs"][:, 1:] == own).any()
    srt = np.sort(a["image_idxs"][:, 1:], axis=1)
    assert (np.diff(srt, axis=1) > 0).all()
    c = generate.cx_data(cx, "train", seed + 1, "cpu", with_features=False)
    assert not np.array_equal(a["question_wids"], c["question_wids"])
    for split in ("train", "val"):
        v = generate.vqa_data(vqa, split, seed, "cpu", with_features=False)
        w = generate.vqa_data(vqa, split, seed, "cpu", with_features=False)
        n, n_img = _sizes(vqa, split)
        assert v["question_wids"].shape == (n, 26)
        assert v["image_rows"].max() < n_img
        for key in v:
            if v[key] is not None:
                np.testing.assert_array_equal(v[key], w[key])
        lengths = (v["question_wids"] != 0).sum(1)
        assert lengths.min() >= 2 and lengths.max() <= 26
        assert 5.5 < lengths.mean() < 7.5
        assert (v["ans_counts"].sum(1) == 10).all()


def test_features_are_seeded():
    a = generate.features(64, 8, 7, "t", "cpu", True)
    b = generate.features(64, 8, 7, "t", "cpu", True)
    assert torch.equal(a, b) and (a >= 0).all()
    assert torch.equal(a, a.bfloat16().float())


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and not \
                node.level:
            yield node.module


def _py_files(base):
    for dirpath, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_imports_are_clean():
    for path in _py_files(PERFBENCH):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax",
                               "vqa_counterexamples_tpu"), (path, name)
            if os.sep + "reference" + os.sep in path:
                assert top != "vqa_counterexamples_tpu_torch", (path, name)
    for path in _py_files(os.path.join(PERFBENCH, "reference")):
        assert "vqa_counterexamples_tpu" not in open(path).read(), path


def test_the_forbidden_check_compares_whole_names(monkeypatch):
    assert runner.forbidden_modules() == [] or "jax" in sys.modules
    monkeypatch.setitem(sys.modules, "vqa_counterexamples_tpu_torch_x",
                        sys)
    assert "vqa_counterexamples_tpu_torch_x" not in runner.forbidden_modules()
    monkeypatch.setitem(sys.modules, "vqa_counterexamples_tpu.ops", sys)
    assert "vqa_counterexamples_tpu" in runner.forbidden_modules()


def test_a_run_with_no_card_fails_and_prints_nothing():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the run would measure")
    proc = subprocess.run(
        [sys.executable, os.path.join(PERFBENCH, "run.py"), "--workload",
         "cx_train.b768", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no CUDA device" in proc.stderr


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_runs_at_toy_size_on_the_cpu(cell, tmp_path):
    reg = tiny_tree(str(tmp_path))
    result = runner.run(reg, reg.cell(cell), 2 ** 31 + 99, 0.3, False,
                        torch.device("cpu"), time.time())
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    reported = {m["name"] for m in REG.metrics_of(cell, "end_to_end")}
    assert set(result["metrics"]) == reported
    for m in result["metrics"].values():
        assert m["value"] > 0
    assert result["attempted"] > 0 and result["failed"] == 0
