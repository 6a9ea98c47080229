"""The port's CX CLI against the JAX CLI: ``final_results.txt`` on the same
synthetic run."""

import json
import os

import pytest

from vqa_counterexamples_tpu.cli import counterexamples as jax_cli
from vqa_counterexamples_tpu.core import policy as jax_policy
from vqa_counterexamples_tpu_torch.cli import counterexamples as port_cli

from test_torch_slice import _tiny_cli_options


def _final_results(root):
    (run,) = os.listdir(root / "logs" / "cx")
    return json.loads((root / "logs" / "cx" / run /
                       "final_results.txt").read_text())


@pytest.mark.parametrize("epochs", [1, 2])
def test_best_epoch_matches_jax_cli(tmp_path, monkeypatch, epochs):
    """Both CLIs write ``best_epoch`` as the reference does: the epoch after
    the best checkpoint's (``load_cx_checkpoint``'s next epoch).  At lr 0
    every epoch scores the same, so the first one is the best in both runs
    whatever their initialisations, and both write 2."""
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "float32")
    argv = ["--cx_model", "NeuralModel", "--synthetic", "64", "--epochs",
            str(epochs), "--learning_rate", "0", "--test",
            "--path_opt", _tiny_cli_options(tmp_path)]
    with jax_policy.compute_dtype_scope("float32"):
        info_j = jax_cli.main(argv + ["--project_dir", str(tmp_path / "jax")])
    info_p = port_cli.main(argv + ["--device", "cpu",
                                   "--project_dir", str(tmp_path / "port")])
    assert len(info_j) == len(info_p) == epochs
    assert len({e["recall"] for e in info_p}) == 1
    res_j = _final_results(tmp_path / "jax")
    res_p = _final_results(tmp_path / "port")
    assert res_p["best_epoch"] == res_j["best_epoch"] == 2
