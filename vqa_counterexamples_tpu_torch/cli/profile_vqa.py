"""Where the time of the VQA pretraining step and its eval goes, on one
card.

    python -m vqa_counterexamples_tpu_torch.cli.profile_vqa \\
        [--path_opt configs/vqa2/mutan_noatt_train.yaml] [--epochs 3] \\
        [--out logs/profile_vqa.json]

Builds the configuration's model at its full width with 2000 answers and
random weights from ``--seed``: MutanNoAtt from
``configs/vqa2/mutan_noatt_train.yaml`` (dim_v 2048, BayesianUniSkip 620
-> 2400 with per-gate masks, MUTAN R 10 at 360) on 2048 synthetic
examples, or MutanAtt from ``configs/vqa2/mutan_att_train.yaml`` (14 x 14
maps of 2048, two glimpses, MUTAN R 5 at both stages) on 1024 examples over
256 images, their maps gathered on the host (``--examples`` sets another
count: a pass syncs at its start and end, so short passes weigh on the
per-step figures).  Under the bf16 policy, at
the configuration's batch size (512 / 128), it warms up, then times
``--epochs`` passes of ``engines/vqa_engine.train_epoch`` (Adam at 1e-4,
the reference's dropouts) and of ``validate`` over the same examples on
the host clock, runs them again under ``torch.profiler``, and reports per
batch what ``cli/profile_cx.py`` reports (wall, host and drain ms;
device-busy ms and idle share; kernel launches and the host's launch
calls; device time by kernel group and the top kernels; the program's
spans, among them ``data.batch``, a batch's answer sampling and gather,
and its counters), for the train
step the CLI runs (a captured CUDA graph: ``train_step``) and beside it
for the same step run eagerly from a copy of the starting state
(``train_step_eager``); the eval batches run eagerly (``eval_batch``).

Needs a card: it refuses to run without one.  The JSON report goes to
``--out``.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess

import numpy as np
import torch

from .profile_cx import profile_calls

CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                      "configs", "vqa2", "mutan_noatt_train.yaml")


def flagship_vqa(seed: int = 0, path_opt: str = CONFIG,
                 n_examples: int = 2048):
    """(model, examples, store, options): the configuration's model at its
    widths with 2000 answers, seeded random weights, on the CPU, and
    ``n_examples`` synthetic examples at its dim_v and maxlength (spatial
    maps for the attention archs)."""
    from ..core import config as config_lib
    from ..data import synthetic
    from ..engines import vqa_engine
    from ..models import factory

    options = config_lib.load_options_file(path_opt)
    model_opt = options["model"]
    arch = model_opt["arch"]
    examples, store, words, answers = synthetic.make_synthetic_vqa(
        n_examples, 2000, options["vqa"]["maxlength"],
        dim_v=model_opt.get("dim_v") or model_opt["fusion"]["dim_v"],
        spatial=arch.endswith("Att") and not arch.endswith("NoAtt"),
        seed=seed)
    model = factory.factory_vqa(model_opt, words, answers)
    vqa_engine.init_vqa_params(model, seed=seed)
    return model, examples, store, options


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--path_opt", default=CONFIG)
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--examples", type=int, default=0,
                        help="synthetic examples (default 2048 for "
                             "MutanNoAtt, 1024 for MutanAtt): a pass is "
                             "examples / B steps")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default="logs/profile_vqa.json")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_vqa: no CUDA device visible")
    os.environ["VQACX_COMPUTE_DTYPE"] = "bfloat16"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from ..core import config as config_lib
    from ..core import spans
    from ..core.experiment import Experiment
    from ..core.meters import AvgMeter
    from ..data.vqa_dataset import VQAArrays
    from ..engines import vqa_engine

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    options = config_lib.load_options_file(args.path_opt)
    noatt = options["coco"]["mode"] == "noatt"
    batch_size = options["optim"]["batch_size"]
    model, examples, store, _ = flagship_vqa(
        seed=args.seed, path_opt=args.path_opt,
        n_examples=args.examples or (2048 if noatt else 1024))
    model.to(dev)
    arrays = VQAArrays(examples, store, samplingans=True)
    feats = store.to_device(dev) if noatt else None
    exp = Experiment("profile_vqa")
    for tag in ("train", "val"):
        exp.add_meters(tag, {k: AvgMeter() for k in (
            "loss", "acc1", "acc5", "batch_time", "data_time")})
    per_pass = arrays.size // batch_size
    report = {"card": card, "config": os.path.basename(args.path_opt),
              "batch_size": batch_size,
              "examples": arrays.size, "passes": args.epochs}
    torch.cuda.reset_peak_memory_stats()
    for suffix, capture in (("", None), ("_eager", False)):
        m = copy.deepcopy(model)
        state = vqa_engine.init_vqa_state(m, lr=1e-4)
        train_step = vqa_engine.make_vqa_train_step(
            m, state.optimizer, base_seed=args.seed, capture=capture)
        rng = np.random.default_rng(args.seed)

        def train_pass():
            vqa_engine.train_epoch(
                train_step, state, arrays.batches(
                    batch_size, shuffle=True, rng=rng, drop_remainder=True,
                    device_features=feats, device=dev), exp, 1,
                print_freq=10 ** 9)

        train_pass()
        report["train_step" + suffix] = profile_calls(train_pass,
                                                      args.epochs, per_pass)
    eval_step = vqa_engine.make_vqa_eval_step(model)

    def eval_pass():
        vqa_engine.validate(eval_step, arrays.batches(
            batch_size, shuffle=False, drop_remainder=True,
            device_features=feats, device=dev), exp, 1)

    eval_pass()
    report["eval_batch"] = profile_calls(eval_pass, args.epochs, per_pass)
    report["max_memory_allocated_mib"] = (torch.cuda.max_memory_allocated()
                                          / 2 ** 20)
    report["counters"] = spans.counters()
    out = json.dumps(report, indent=1)
    print(out)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(out + "\n")
    return report


if __name__ == "__main__":
    main()
