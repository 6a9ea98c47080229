"""The benchmark's operation and byte counts (CPU): the kernel table's
bound column at its shapes, and the step counts behind ``mfu`` as the sum
of their parts."""

from __future__ import annotations

import pytest
import torch

from perfbench.harness.registry import Registry

REG = Registry()
K = REG.module("counts", "kernels")


@pytest.mark.parametrize("name, work, bound_ms", [
    ("3b at T 26, B 512, H 2400", K.gru_bwd(26, 512, 2400), 0.912),
    ("3f' at B 512", K.gru_fwd(26, 512, 2400, 3, True), 0.447),
    ("3f at B 512, no mask", K.gru_fwd(26, 512, 2400, 0, False), 0.447),
    ("1f at B 768, K 24", K.vfeat_fwd(768, 24, 2048, 300, 1024), 0.0458),
    ("1b at B 768, K 24", K.vfeat_bwd(768, 24, 2048, 300, 1024), 0.0458),
    ("mixture at M 18432", K.mixture(18432, 360, 2000), 0.0268),
])
def test_bounds_reproduce_the_kernel_table(name, work, bound_ms):
    got = K.bound_s(work) * 1e3
    assert got == pytest.approx(bound_ms, abs=5e-4 * max(1.0, bound_ms)), name


def test_peaks_are_the_data_sheet():
    pk = K.peaks()
    assert (pk["bf16_flops"], pk["hbm_bytes"]) == (989e12, 3.35e12)


def test_vqa_step_counts_are_the_sum_of_their_parts():
    counts = REG.counts("mutan_noatt_bayesian_uniskip")
    cfg = REG.config("mutan_noatt_bayesian_uniskip")
    b, t, d, h, a = 512, 26, 620, 2400, 2000
    words = b * t
    shapes = {"batch": b, "seq_len": t}
    parts = counts.train_step_flops(cfg, shapes)
    by_hand = (2 * words * d * 3 * h * 3            # x_proj fwd, dW, dX
               + 2 * (words - b) * h * 3 * h * 2    # recurrence fwd, back
               + 2 * words * 3 * h * h              # dW_hh
               + 2 * b * (2048 * 360 + 2400 * 360) * 1
               + 2 * b * (2048 * 360 + 2 * 2400 * 360)
               + 2 * b * 10 * 360 * 720 * 3
               + 2 * b * 360 * a * 3)
    assert sum(parts.values()) == by_hand
    assert sum(parts.values()) / 1e12 == pytest.approx(1.716, abs=1e-3)
    fwd = counts.eval_step_flops(cfg, shapes)
    assert set(fwd) < set(parts) and sum(fwd.values()) < sum(parts.values())


def test_cx_step_counts_are_the_sum_of_their_parts():
    counts = REG.counts("neuralcx_300_2_mutan_noatt")
    cfg = REG.config("neuralcx_300_2_mutan_noatt")
    b, k, h, a = 768, 24, 300, 2000
    rows = b * k
    parts = counts.train_step_flops(cfg, {"batch": b, "n_images": 82783})
    by_hand = (8 * rows * 2048 * h                    # vfeat fwd + bwd
               + 4 * b * 7208 * h + 2 * b * h * 2400   # static block
               + 4 * rows * 360 * h                    # z_other block
               + 2 * rows * 360 * a                    # the answer head
               + 2 * a * 2400 * h + 4 * rows * a * h + 4 * a * 2400 * h
               + 6 * rows * h * h + 6 * rows * h)      # hidden layer, head
    assert sum(parts.values()) == by_hand


class _Trace:
    """A traced window's readings, as the readers see them."""

    def __init__(self, window_s, steps, kernel_s=0.0, n_fwd=0, n_bwd=0):
        self.window_s, self.steps = window_s, steps
        self._s, self._n = kernel_s, {"vfeat_fwd_kernel": n_fwd,
                                      "vfeat_bwd_kernel": n_bwd}

    def kernel_times_s(self, names):
        return self._s

    def kernel_count(self, names):
        return sum(self._n.get(n, 0) for n in names)


def _view(config, kind, shapes, trace):
    from perfbench.harness.runner import Context, TraceView

    ctx = Context(registry=REG, cell={}, config=REG.config(config),
                  traffic={}, seed=0, base_seed=0, device=torch.device("cpu"))
    return TraceView(trace=trace, window={"kind": kind, "steps": trace.steps,
                                          "shapes": shapes}, ctx=ctx)


def test_mfu_reads_the_window_count_over_the_peak():
    cfg = "mutan_noatt_bayesian_uniskip"
    shapes = {"batch": 512, "seq_len": 26}
    per_step = sum(REG.counts(cfg).train_step_flops(
        REG.config(cfg), shapes).values())
    view = _view(cfg, "train", shapes, _Trace(window_s=2.0, steps=10))
    got = REG.module("metrics", "mfu.train").read(view)
    assert got == pytest.approx(100 * per_step * 10 / 2.0 / 989e12)
    assert REG.module("metrics", "mfu.eval").read(view) is None
    view.window["kind"] = "eval"
    assert REG.module("metrics", "mfu.eval").read(view) < got


def test_rooflines_work_their_bounds_out_from_the_shapes():
    """vfeat at B 768 over the COCO table: the kernel table's 0.0458 ms a
    launch; 3b's sweep over a padded B 512 batch."""
    cx = _view("neuralcx_300_2_mutan_noatt", "train",
               {"batch": 768, "n_images": 82783},
               _Trace(2.0, 100, kernel_s=2 * 0.0458e-3, n_fwd=1, n_bwd=1))
    assert REG.module("metrics", "vfeat_roofline").read(cx) == \
        pytest.approx(100.0, abs=1.0)
    sweep = K.bound_s(K.gru_bwd_sweep(512 * 25, 512 * 26, 512, 2400))
    vqa = _view("mutan_noatt_bayesian_uniskip", "train",
                {"batch": 512, "seq_len": 26},
                _Trace(2.0, 4, kernel_s=40 * sweep))
    assert REG.module("metrics", "gru_bwd_roofline").read(vqa) == \
        pytest.approx(10.0)
    assert REG.module("metrics", "vfeat_roofline").read(
        _view("neuralcx_300_2_mutan_noatt", "train",
              {"batch": 768, "n_images": 82783}, _Trace(2.0, 100))) is None
