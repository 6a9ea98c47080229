"""The check catches what it is there to catch (CPU, toy widths): the
control, the reference in float8 put in the program's place, reads far
above the program; and a whole run with a fault planted under the timed
path comes out not correct, for each fault a cell can have (one card: no
exchange between chips to leave out).  The same control and faults at
the cells' own sizes run on the card (``perfbench/calibrate.py``; the
``cuda`` test below)."""

from __future__ import annotations

import time

import pytest
import torch

from perfbench import calibrate
from perfbench.harness import runner
from perfbench.harness.registry import Registry
from perfbench.tests.tiny import tiny_tree

FAULTS = {
    "cx_train.b768": ("unchanged", "half_batch"),
    "cx_train.b64": ("unchanged", "half_batch"),
    "vqa_train.b512": ("unchanged", "half_batch", "answer"),
    "vqa_val.b512": ("answer",),
}
NUMBERS = {"cx_train.b768": ("loss", "grad", "head_grad_diff", "change"),
           "cx_train.b64": ("loss", "grad", "head_grad_diff", "change"),
           "vqa_train.b512": ("grad", "grad_diff", "change"),
           "vqa_val.b512": ("logit_gap",)}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tiny_tree(str(tmp_path_factory.mktemp("tiny")))


@pytest.fixture
def restore(monkeypatch):
    """Every attribute a planted fault replaces, put back afterwards."""
    from vqa_counterexamples_tpu_torch.data import vqa_dataset
    from vqa_counterexamples_tpu_torch.engines import cx_engine, vqa_engine

    for obj, name in ((cx_engine, "nll"),
                      (vqa_engine, "cross_entropy_mean"),
                      (vqa_engine, "make_vqa_eval_step"),
                      (vqa_dataset.VQAArrays, "sample_answers"),
                      (torch.optim.Adam, "step")):
        monkeypatch.setattr(obj, name, getattr(obj, name))


@pytest.mark.parametrize("cell", sorted(NUMBERS))
def test_the_control_reads_far_above_the_program(tree, cell, restore):
    for seed in (5, 2 ** 31 + 3):
        got = calibrate.readings(tree, tree.cell(cell), seed, 0.3, "none",
                                 torch.device("cpu"))
        prog, ctrl = got["program"], got["control"]
        ratios = [ctrl[k] / max(prog[k], 1e-12) for k in NUMBERS[cell]]
        assert max(ratios) >= 3.0, (prog, ctrl)


@pytest.mark.parametrize("cell, fault", [
    (cell, fault) for cell, faults in sorted(FAULTS.items())
    for fault in faults])
def test_a_planted_fault_comes_out_not_correct(tree, cell, fault, restore):
    result = runner.run(tree, tree.cell(cell), 2 ** 31 + 11, 0.3, False,
                        torch.device("cpu"), time.time(),
                        job_patch=calibrate.plant(fault))
    assert not result["correct"], result["checks"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control at the cells' own "
                    "sizes runs on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(NUMBERS))
def test_the_control_fails_the_limits_at_full_size(card, cell):
    reg = Registry()
    got = calibrate.readings(reg, reg.cell(cell), 2 ** 31 + 77, 1.0, "none",
                             card)
    ok, _ = runner.compared(reg.cell(cell), got["program"])
    bad, _ = runner.compared(reg.cell(cell), got["control"])
    assert ok and not bad, got
