"""The port's ``utils`` against the JAX package's, the capture mode that
``core/graphs`` picks while a process group exists, and the ablation
grid's runner (``vqa_counterexamples_tpu_torch/scripts/run_ablations``)."""

import json
import math
import os
import socket
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqa_counterexamples_tpu import utils as jax_utils
from vqa_counterexamples_tpu_torch import utils as port_utils
from vqa_counterexamples_tpu_torch.core import graphs
from vqa_counterexamples_tpu_torch.scripts import run_ablations

from test_torch_slice import _tiny_cli_options


def test_config_helpers_match_jax():
    a = {"x": {"y": 1, "z": [1, 2]}, "w": 3}
    b = {"x": {"y": None, "z": [3], "n": {"m": 1}}, "w": 4, "v": None}
    assert port_utils.merge_dict(a, b) == jax_utils.merge_dict(a, b)
    to_j, to_p = {"x": {"q": 0}}, {"x": {"q": 0}}
    assert port_utils.update_values(b, to_p) == jax_utils.update_values(
        b, to_j)
    for v in ("yes", "True", "t", "Y", "1", "no", "F", "0", None, False):
        assert port_utils.str2bool(v) == jax_utils.str2bool(v)
    with pytest.raises(ValueError):
        port_utils.str2bool("maybe")


@pytest.mark.parametrize("target_2d", [False, True])
def test_accuracy_matches_jax(target_2d):
    rng = np.random.default_rng(0)
    out = rng.normal(size=(32, 7)).astype(np.float32)
    target = (rng.random(size=(32, 7)).astype(np.float32) if target_2d
              else rng.integers(0, 7, 32))
    got = port_utils.accuracy(torch.from_numpy(out),
                              torch.from_numpy(target), topk=(1, 5, 10))
    want = jax_utils.accuracy(jnp.asarray(out), jnp.asarray(target),
                              topk=(1, 5, 10))
    for g, w in zip(got, want):
        assert float(g) == pytest.approx(float(w), rel=1e-6)


def test_params_count_and_n_hot_match_jax():
    model = torch.nn.Sequential(torch.nn.Linear(5, 3), torch.nn.Linear(3, 2))
    want = jax_utils.params_count(jax.tree.map(
        np.asarray, {"a": {"kernel": np.zeros((5, 3)), "bias": np.zeros(3)},
                     "b": {"kernel": np.zeros((3, 2)), "bias": np.zeros(2)}}))
    assert port_utils.params_count(model) == want == 26
    assert port_utils.params_count(model.state_dict()) == want
    got = port_utils.create_n_hot([1, 3, 3], 5)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jax_utils.create_n_hot([1, 3, 3], 5)))


def test_capture_mode_follows_the_process_group():
    """Thread-local capture while a process group exists (a one-rank gloo
    group here) or for a meshed step; the default (global) otherwise."""
    import torch.distributed as dist

    assert graphs.capture_kwargs() == {}
    assert graphs.capture_kwargs(meshed=True) == {
        "capture_error_mode": "thread_local"}
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:%d" % port,
                            rank=0, world_size=1)
    try:
        assert graphs.capture_kwargs() == {
            "capture_error_mode": "thread_local"}
    finally:
        dist.destroy_process_group()
    assert graphs.capture_kwargs() == {}


# ------------------------------------------------------ the ablation grid

def test_run_ablations_parses_and_builds_jaxs_command():
    """The defaults are the JAX script's protocol (3 epochs, B 256, 2,048
    examples, seed 42) and the 19 YAMLs of ``configs/cx``; the command is
    the JAX script's, on the port's CLI."""
    args = run_ablations.build_parser().parse_args([])
    assert (args.epochs, args.batch_size, args.synthetic) == (3, 256, 2048)
    assert not hasattr(args, "seed")
    cfgs = run_ablations.config_paths(None)
    assert len(cfgs) == 19
    assert all(os.path.isfile(c) for c in cfgs)
    assert run_ablations.config_paths("neuralcx_lesion_a_emb") == [
        os.path.join(run_ablations.REPO, "configs", "cx",
                     "neuralcx_lesion_a_emb.yaml")]
    args.project_dir = "/p"
    cmd = run_ablations.command(cfgs[0], args)
    assert cmd[:3] == [sys.executable, "-m",
                       "vqa_counterexamples_tpu_torch.cli.counterexamples"]
    assert cmd[3:] == ["--cx_model", "NeuralModel", "--path_opt", cfgs[0],
                       "--epochs", "3", "--synthetic", "2048",
                       "--batch_size", "256", "--seed", "42",
                       "--project_dir", "/p", "--device", "cuda"]


def test_run_ablations_rows_and_table():
    out = ("Epoch 1 val: {'loss': 3.2, 'recall': 0.25, 'recall_1': 0.05}\n"
           "Epoch 2 val: {'loss': nan, 'recall': 0.2, 'recall_1': 0.0}\n")
    row = run_ablations.parse_row("a", 0, 1.234, out, "")
    assert row == {"config": "a", "rc": 0, "wall_s": 1.2,
                   "loss": row["loss"], "recall5": 0.2, "recall1": 0.0}
    assert math.isnan(row["loss"]) and not run_ablations.ok(row)
    failed = run_ablations.parse_row("b", 1, 2.0, "", "Traceback: boom")
    assert failed["tail"] == "Traceback: boom"
    table = run_ablations.table([dict(row, loss=3.0), failed])
    assert "| a | 3.0000 | 0.2000 | 0.0000 | 1.2 |" in table
    assert "| b | FAILED rc=1 | | | 2.0 |" in table


def test_run_ablations_one_tiny_config(tmp_path, capsys):
    """One narrowed config through the port's CLI on the CPU: rc 0, a
    finite val loss, its JSON line and the table."""
    rows = run_ablations.main([
        "--configs", _tiny_cli_options(tmp_path), "--epochs", "1",
        "--synthetic", "64", "--batch_size", "24", "--device", "cpu",
        "--project_dir", str(tmp_path / "grid")])
    (row,) = rows
    assert run_ablations.ok(row), row
    line = json.loads(capsys.readouterr().out.splitlines()[0])
    assert line["config"] == "tiny" and line["rc"] == 0
    table = (tmp_path / "grid" / "ablations_rows.md").read_text()
    assert table.splitlines()[2].startswith("| tiny | ")
