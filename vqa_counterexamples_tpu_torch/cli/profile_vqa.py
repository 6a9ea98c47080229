"""Where the time of the VQA pretraining step and its eval goes, on one
card.

    python -m vqa_counterexamples_tpu_torch.cli.profile_vqa \\
        [--epochs 3] [--out logs/profile_vqa.json]

Builds MutanNoAtt from ``configs/vqa2/mutan_noatt_train.yaml`` at its full
width (dim_v 2048, BayesianUniSkip 620 -> 2400 with per-gate masks, MUTAN
R 10 at 360, 2000 answers; random weights from ``--seed``) on 2048
synthetic examples, under the bf16 policy, B 512, and warms up.  Then it
times ``--epochs`` passes of ``engines/vqa_engine.train_epoch`` (4 steps
each, Adam at 1e-4, the reference's dropouts) and of ``validate`` over
the same 2048 examples on the host clock, runs them again under
``torch.profiler``, and reports per batch what ``cli/profile_cx.py``
reports (wall, host and drain ms; device-busy ms and idle share; kernel
launches; device time by kernel group and the top kernels).

Needs a card: it refuses to run without one.  The JSON report goes to
``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess

import numpy as np
import torch

from .profile_cx import profile_calls

CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                      "configs", "vqa2", "mutan_noatt_train.yaml")


def flagship_vqa(seed: int = 0):
    """(model, examples, store, options): MutanNoAtt at the configuration's
    widths with 2000 answers, seeded random weights, on the CPU, and 2048
    synthetic examples at its dim_v and maxlength."""
    from ..core import config as config_lib
    from ..data import synthetic
    from ..engines import vqa_engine
    from ..models import factory

    options = config_lib.load_options_file(CONFIG)
    examples, store, words, answers = synthetic.make_synthetic_vqa(
        2048, 2000, options["vqa"]["maxlength"],
        dim_v=options["model"]["fusion"]["dim_v"], seed=seed)
    model = factory.factory_vqa(options["model"], words, answers)
    vqa_engine.init_vqa_params(model, seed=seed)
    return model, examples, store, options


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default="logs/profile_vqa.json")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_vqa: no CUDA device visible")
    os.environ["VQACX_COMPUTE_DTYPE"] = "bfloat16"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from ..core.experiment import Experiment
    from ..core.meters import AvgMeter
    from ..data.vqa_dataset import VQAArrays
    from ..engines import vqa_engine

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    batch_size = 512
    model, examples, store, _ = flagship_vqa(seed=args.seed)
    model.to(dev)
    arrays = VQAArrays(examples, store, samplingans=True)
    feats = store.to_device(dev)
    state = vqa_engine.init_vqa_state(model, lr=1e-4)
    train_step = vqa_engine.make_vqa_train_step(model, state.optimizer,
                                                base_seed=args.seed)
    eval_step = vqa_engine.make_vqa_eval_step(model)
    exp = Experiment("profile_vqa")
    for tag in ("train", "val"):
        exp.add_meters(tag, {k: AvgMeter() for k in (
            "loss", "acc1", "acc5", "batch_time", "data_time")})
    rng = np.random.default_rng(args.seed)

    def train_pass():
        vqa_engine.train_epoch(
            train_step, state, arrays.batches(
                batch_size, shuffle=True, rng=rng, drop_remainder=True,
                device_features=feats), exp, 1, print_freq=10 ** 9)

    def eval_pass():
        vqa_engine.validate(eval_step, arrays.batches(
            batch_size, shuffle=False, drop_remainder=True,
            device_features=feats), exp, 1)

    for fn in (train_pass, eval_pass):
        fn()
    per_pass = arrays.size // batch_size
    report = {"card": card, "batch_size": batch_size,
              "examples": arrays.size, "passes": args.epochs,
              "train_step": profile_calls(train_pass, args.epochs, per_pass),
              "eval_batch": profile_calls(eval_pass, args.epochs, per_pass)}
    out = json.dumps(report, indent=1)
    print(out)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(out + "\n")
    return report


if __name__ == "__main__":
    main()
