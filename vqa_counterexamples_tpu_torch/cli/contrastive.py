"""Contrastive CX training CLI (port of ``cli/contrastive.py``; reference
``contrastive.py``).

Trains ``ContrastiveModel`` on each epoch's (orig, comp, random-other)
triples (``CXArrays.pairwise_view``, drawn from the run's numpy rng) with
the Hadsell-Chopra margin loss (``engines/contrastive_engine``); the eval
ranks the val examples' candidates by embedding distance, larger being a
better counterexample, and records ``contrastive/recall`` and ``recall``.
The run dir is the CX CLI's (``logs/cx/<run>/{ckpt,best}``, ``runs/<run>``);
the best checkpoint is the one with the highest ``contrastive/recall``::

    python -m vqa_counterexamples_tpu_torch.cli.contrastive \\
        --synthetic 2048 --epochs 2 [--device cpu]

The frozen backbone's q and v caches feed the steps (none with
``--trainable_vqa``).  On a card the train and eval steps are captured
CUDA graphs.  The device is ``cuda``; with no card visible the CLI refuses
to run unless ``--device cpu`` is given.  Without ``--synthetic`` it reads
the real VQA-CX data through the CX CLI's ``load_real_data`` (the
augmented pickles of ``cli/build_vqacx``, the ``_small`` train pickle under
``--dev_mode``); the backbone stays at its seeded init, as in the JAX CLI.
``--mesh`` raises ``NotImplementedError`` (see ROADMAP.md).
"""

from __future__ import annotations

import argparse
import os
from datetime import datetime

import numpy as np
import torch


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--path_opt",
                        default="configs/cx/counterexamples_default.yaml")
    parser.add_argument("-lr", "--learning_rate", type=float)
    parser.add_argument("-b", "--batch_size", type=int)
    parser.add_argument("--epochs", type=int)
    parser.add_argument("--project_dir", default=".", type=str)
    parser.add_argument("--resume", default="", type=str)
    parser.add_argument("--best", action="store_true")
    parser.add_argument("-c", "--comment", type=str, default="contrastive")
    parser.add_argument("-p", "--print_freq", default=100, type=int)
    parser.add_argument("-v", "--eval_freq", default=-1, type=int)
    group = parser.add_mutually_exclusive_group(required=False)
    group.add_argument("--pretrained_vqa", dest="pretrained_vqa",
                       action="store_true")
    group.add_argument("--untrained_vqa", dest="pretrained_vqa",
                       action="store_false")
    parser.set_defaults(pretrained_vqa=True)
    parser.add_argument("--trainable_vqa", action="store_true")
    parser.add_argument("-dev", "--dev_mode", action="store_true")
    parser.add_argument("--synthetic", type=int, default=0, metavar="N")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--mesh", type=str, default=None,
                        help="data-parallel mesh spec, e.g. 'data=8'")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda; cpu must be asked "
                             "for)")
    return parser


def main(argv=None):
    from ..core import checkpoint as ckpt_lib
    from ..core import config as config_lib
    from ..core.experiment import ScalarWriter
    from ..data import vqacx
    from ..engines import contrastive_engine as ce
    from ..engines import cx_engine
    from ..models import factory
    from .counterexamples import (check_unported, load_real_data,
                                  load_synthetic_data, resolve_device)

    args = build_parser().parse_args(argv)
    args.test = False
    options = config_lib.resolve_options({}, args.path_opt, {
        "optim": {"lr": args.learning_rate, "batch_size": args.batch_size,
                  "epochs": args.epochs}})
    check_unported(args)
    device = resolve_device(args.device)

    run_name = args.resume or (
        datetime.now().strftime("%b%d-%H-%M-%S") + "_" + args.comment)
    save_dir = os.path.join(args.project_dir, "logs", "cx", run_name)
    os.makedirs(os.path.join(save_dir, "ckpt"), exist_ok=True)
    os.makedirs(os.path.join(save_dir, "best"), exist_ok=True)
    writer = ScalarWriter(os.path.join(args.project_dir, "runs", run_name))

    print("=> Loading data...")
    if args.synthetic:
        trainset, valset, _, f_train, f_val = load_synthetic_data(
            args, args.synthetic)
    else:
        trainset, valset, _, f_train, f_val = load_real_data(options, args)
    train_arrays = vqacx.CXArrays.from_examples(trainset["examples_list"],
                                                f_train.name_to_index)
    val_arrays = vqacx.CXArrays.from_examples(valset["examples_list"],
                                              f_val.name_to_index)
    features_train = f_train.to_device(device)
    features_val = f_val.to_device(device)

    print("=> Building model...")
    vqa_model = factory.factory_vqa(options["model"],
                                    trainset["vocab_words"],
                                    trainset["vocab_answers"])
    model = factory.factory_cx("ContrastiveModel", vqa_model, knn_size=2,
                               trainable_vqa=args.trainable_vqa)
    cx_engine.init_cx_params(model, seed=args.seed)
    model.to(device)
    state = cx_engine.init_cx_state(model, lr=options["optim"]["lr"])

    batch_size = options["optim"]["batch_size"]
    rng = np.random.default_rng(args.seed)
    # JAX's CLI draws a pairwise view for its init batch: the same draw
    # keeps the epochs' views and shuffles on its stream
    train_arrays.pairwise_view(rng)

    info, start_epoch, best_recall = [], 1, 0.0
    if args.resume:
        state, info, start_epoch, best_recall = \
            ckpt_lib.load_cx_checkpoint(state, save_dir,
                                        resume_best=args.best)

    # frozen-backbone caches: the pairwise triples keep row i = example i,
    # so the q table indexes by example_idxs as usual
    use_cache = not args.trainable_vqa
    q_train = q_val = v_train = v_val = None
    if use_cache:
        print("=> Precomputing frozen-backbone q_emb/v_proj caches...")
        q_train, v_train, _, _ = cx_engine.build_frozen_caches(
            model, features_train, train_arrays, use_q=True, use_v=True,
            use_z=False)
        q_val, v_val, _, _ = cx_engine.build_frozen_caches(
            model, features_val, val_arrays, use_q=True, use_v=True,
            use_z=False)

    train_step = ce.make_contrastive_train_step(model, state.optimizer,
                                                base_seed=args.seed)
    eval_step = ce.make_contrastive_eval_step(model)

    def run_eval():
        sums, n = [], 0
        for step, (idx, n_valid) in enumerate(vqacx.batch_indices(
                val_arrays.size, batch_size, shuffle=False)):
            out = eval_step(features_val,
                            vqacx.gather_batch(val_arrays, idx), n_valid,
                            step, q_table=q_val, v_table=v_val)
            sums.append(out["correct"])
            n += n_valid
        # float64 sum of the per-batch counts, as JAX's ``float(...) +=``
        correct = sum(torch.stack(sums).cpu().tolist())
        return {"contrastive/recall": correct / n, "recall": correct / n}

    print("=> Starting training...")
    for epoch in range(start_epoch, options["optim"]["epochs"] + 1):
        pw = train_arrays.pairwise_view(rng)
        for b, (idx, n_valid) in enumerate(vqacx.batch_indices(
                pw.size, batch_size, shuffle=True, rng=rng), start=1):
            state, m = train_step(state, features_train,
                                  vqacx.gather_batch(pw, idx), n_valid,
                                  q_table=q_train, v_table=v_train)
            if b % args.print_freq == 0:
                metrics = {k: float(v) for k, v in m.items()}
                for k, v in metrics.items():
                    writer.add_scalar("contrastive/" + k, v, state.step)
                print("Epoch {} train: {}".format(
                    epoch, {k: round(v, 4) for k, v in metrics.items()}))
            if args.eval_freq > 0 and b % args.eval_freq == 0:
                mid = run_eval()
                print("Epoch {} eval@{}: {}".format(
                    epoch, b,
                    {k: round(float(v), 4) for k, v in mid.items()}))
        eval_results = run_eval()
        print("Epoch {} val: {}".format(
            epoch,
            {k: round(float(v), 4) for k, v in eval_results.items()}))
        info.append({k: float(v) for k, v in eval_results.items()})
        is_best = eval_results["contrastive/recall"] > best_recall
        if is_best:
            best_recall = eval_results["contrastive/recall"]
        ckpt_lib.save_cx_checkpoint(state, info, save_dir, is_best=is_best)
    writer.close()
    return info


if __name__ == "__main__":
    main()
