"""The plain references against the port's CPU path at toy widths, both
in float32: one NeuralCX train step, three MutanNoAtt train steps (with
the loader's answer draws) and a MutanNoAtt validation pass agree to
float32 round-off, so the card's check starts from a reference known to
be right.  The dropout masks are drawn on both sides from the same
(seed, step) streams."""

from __future__ import annotations

import json
import os

import pytest
import torch

from perfbench import calibrate
from perfbench.tests.tiny import tiny_tree


@pytest.fixture(scope="module")
def f32_tree(tmp_path_factory):
    dest = str(tmp_path_factory.mktemp("f32"))
    reg = tiny_tree(dest)
    for name in os.listdir(os.path.join(reg.base, "configs")):
        path = os.path.join(reg.base, "configs", name)
        cfg = json.load(open(path))
        cfg["dtype"] = "float32"
        if "caches" in cfg:
            cfg["caches"]["bf16_resident"] = False
        json.dump(cfg, open(path, "w"))
    for name in ("cx_train_b768", "vqa_train_b512"):
        path = os.path.join(reg.base, "traffic", name + ".json")
        tr = json.load(open(path))
        tr["check_steps"] = 1 if name.startswith("cx") else 3
        json.dump(tr, open(path, "w"))
    return reg


@pytest.fixture(autouse=True)
def _restore_dtype(monkeypatch):
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "float32")


def readings(reg, cell, seed):
    return calibrate.readings(reg, reg.cell(cell), seed, 0.3, "none",
                              torch.device("cpu"))["program"]


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 17])
def test_one_cx_step_agrees(f32_tree, seed):
    got = readings(f32_tree, "cx_train.b768", seed)
    assert got["loss"] < 1e-6
    assert got["grad"] < 1e-5 and got["grad_diff"] < 1e-5
    assert got["change"] < 1e-4


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 17])
def test_mutan_noatt_train_steps_agree(f32_tree, seed):
    got = readings(f32_tree, "vqa_train.b512", seed)
    assert got["answers"] == 0
    assert got["loss"] < 1e-6
    assert got["grad"] < 1e-5 and got["grad_diff"] < 1e-5
    assert got["change"] < 1e-4


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 17])
def test_mutan_noatt_validation_agrees(f32_tree, seed):
    got = readings(f32_tree, "vqa_val.b512", seed)
    assert got["_rows"] > 0
    assert got["logit_gap"] < 1e-5
