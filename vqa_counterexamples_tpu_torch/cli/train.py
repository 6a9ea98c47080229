"""VQA pretraining CLI (port of ``cli/train.py``; reference ``train.py``).

Trains the MutanNoAtt or MutanAtt classifier with per-epoch validation
(acc@1 / acc@5 and the OpenEnded result rows), the best epoch by val acc@1
kept as ``best_*`` beside the last ``ckpt_*`` (or every epoch from
``--save_all_from`` on), and ``logger.json``; a trainval run writes the
test2015 / test-dev2015 rows each epoch instead of validating::

    python -m vqa_counterexamples_tpu_torch.cli.train \\
        --path_opt configs/vqa2/mutan_noatt_train.yaml --synthetic 2048 \\
        --epochs 1

``--resume best|ckpt`` continues from ``dir_logs``; ``-e`` only evaluates.
The device is ``cuda``; with no card visible the CLI refuses to run unless
``--device cpu`` is given.  MutanAtt's att maps stay on the host and
stream through ``VQAArrays.batches``' gather (the next batch prefetched, in
pinned buffers for a card), as the JAX CLI's do.  ``--mesh``,
``--distributed``, real data, an encoder other than skip-thoughts and the
MLB archs raise ``NotImplementedError`` (see ROADMAP.md for when they
come).  The OpenEnded scoring of val rows against real annotations (the
JAX CLI's ``eval_res`` thread) is not ported: it only runs on real data.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch


def str2bool(v):
    """CLI boolean parser (reference ``utils.py:49-59``)."""
    if v is None or isinstance(v, bool):
        return v
    if isinstance(v, str):
        if v.lower() in ("yes", "true", "t", "y", "1"):
            return True
        if v.lower() in ("no", "false", "f", "n", "0"):
            return False
    raise ValueError("Boolean value expected, got %r" % (v,))


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--path_opt",
                        default="configs/vqa2/mutan_noatt_train.yaml")
    parser.add_argument("--dir_logs", type=str, help="dir logs override")
    parser.add_argument("-lr", "--learning_rate", type=float)
    parser.add_argument("-b", "--batch_size", type=int)
    parser.add_argument("--epochs", type=int)
    parser.add_argument("--start_epoch", default=1, type=int)
    parser.add_argument("--resume", default="", type=str,
                        help="best | ckpt (resume from dir_logs)")
    parser.add_argument("--save_model", default=True, type=str2bool)
    parser.add_argument("--save_all_from", type=int,
                        help="keep all checkpoints from this epoch on")
    parser.add_argument("-e", "--evaluate", action="store_true",
                        help="evaluate only")
    parser.add_argument("-p", "--print_freq", default=10, type=int)
    parser.add_argument("--synthetic", type=int, default=0, metavar="N")
    parser.add_argument("--mesh", type=str, default=None,
                        help="data-parallel mesh spec, e.g. 'data=8'")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--distributed", action="store_true",
                        help="multi-host bootstrap")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda; cpu must be asked "
                             "for)")
    return parser


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        "%s is not ported to the PyTorch package yet (ROADMAP.md, %s)"
        % (what, item))


def _synthetic_vqa(n, options, seed):
    """Synthetic processed-like examples + features for smoke runs (the
    JAX CLI's, draw for draw: at most 50 answers, 80 words)."""
    from ..data import synthetic

    model_opt = options["model"]
    arch = model_opt.get("arch", "")
    # att archs consume the spatial (14, 14, C) feature map; dim_v lives at
    # the model level in att configs (reference options/vqa2/mutan_att_*)
    return synthetic.make_synthetic_vqa(
        n, min(options["vqa"]["nans"], 50), options["vqa"]["maxlength"],
        dim_v=model_opt.get("dim_v") or model_opt["fusion"]["dim_v"],
        spatial=arch.endswith("Att") and not arch.endswith("NoAtt"),
        seed=seed)


def main(argv=None):
    from ..core import checkpoint as ckpt_lib
    from ..core import config as config_lib
    from ..core.experiment import Experiment
    from ..core.meters import AvgMeter, SumMeter, ValueMeter
    from ..data.vqa_dataset import VQAArrays
    from ..engines import vqa_engine
    from ..models import factory

    args = build_parser().parse_args(argv)
    for flag in ("mesh", "distributed"):
        if getattr(args, flag):
            _not_ported("--" + flag, "Queue 1 #12")
    if not args.synthetic:
        _not_ported("loading the real VQA data (processed pickles and the "
                    "feature store)", "Queue 1 #7")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible: the port runs on the "
                           "card; pass --device cpu to run on the CPU")
    options = config_lib.resolve_options({}, args.path_opt, {
        "logs": {"dir_logs": args.dir_logs},
        "optim": {"lr": args.learning_rate, "batch_size": args.batch_size,
                  "epochs": args.epochs},
    })
    dir_logs = options["logs"]["dir_logs"]
    os.makedirs(dir_logs, exist_ok=True)
    config_lib.save_options(options, dir_logs)
    batch_size = options["optim"]["batch_size"]

    # ---- data ----
    print("=> Loading dataset...")
    train_ex, store, vocab_words, vocab_answers = _synthetic_vqa(
        args.synthetic, options, args.seed)
    val_ex, val_store = train_ex, store
    train_arrays = VQAArrays(train_ex, store,
                             samplingans=options["vqa"].get("samplingans",
                                                            False))
    val_arrays = VQAArrays(val_ex, val_store, samplingans=False)
    noatt = options["coco"]["mode"] == "noatt"
    device_features = store.to_device(device) if noatt else None
    val_device_features = device_features

    # trainval training has no held-out val: each epoch emits test2015 +
    # test-dev2015 submission rows instead (reference train.py:130-133,
    # 241-262, engine.py:117-153)
    test_arrays = None
    if options["vqa"]["trainsplit"] == "trainval":
        test_ex = [{k: v for k, v in ex.items()
                    if k not in ("answer_aid", "answers_aid",
                                 "answers_count")} for ex in train_ex]
        test_arrays = VQAArrays(test_ex, store)
        test_arrays.is_qid_testdev = {
            ex["question_id"] for ex in test_ex[:len(test_ex) // 2]}

    # ---- model/optim ----
    print("=> Building model...")
    model = factory.factory_vqa(options["model"], vocab_words, vocab_answers)
    vqa_engine.init_vqa_params(model, seed=args.seed)
    # pretrained skip-thoughts init (reference seq2vec.py:80-85), only from
    # a local adapted npz named by the options; absent file = random init
    seq_opt = options["model"].get("seq2vec", {})
    if seq_opt.get("arch") == "skipthoughts" and not args.resume:
        from ..models.seq2vec import load_skipthoughts_npz

        dir_st = seq_opt.get("dir_st", "")
        st_npz = seq_opt.get(
            "weights",
            os.path.join(dir_st, "adapted_uniskip.npz") if dir_st else "")
        if st_npz and os.path.exists(st_npz):
            load_skipthoughts_npz(model.seq2vec, st_npz)
            print("=> seq2vec initialized from %s" % st_npz)
    model.to(device)
    state = vqa_engine.init_vqa_state(model, lr=options["optim"]["lr"])
    print("Built {} on {}".format(options["model"]["arch"], device))

    exp = Experiment(os.path.basename(dir_logs), options=dict(options))

    def meter_set():
        return {"loss": AvgMeter(), "acc1": AvgMeter(), "acc5": AvgMeter(),
                "batch_time": AvgMeter(), "data_time": AvgMeter(),
                "epoch_time": SumMeter(), "best_epoch": ValueMeter(),
                "best_acc1": ValueMeter()}

    exp.add_meters("train", meter_set())
    exp.add_meters("val", meter_set())

    best_acc1 = 0.0
    start_epoch = args.start_epoch
    if args.resume:
        path = (os.path.join(dir_logs, "best") if args.resume == "best"
                else dir_logs)
        info = ckpt_lib.load_vqa_checkpoint(state, path)
        start_epoch = int(info.get("epoch", 0)) + 1
        best_acc1 = float(info.get("best_acc1", 0.0))

    train_step = vqa_engine.make_vqa_train_step(model, state.optimizer,
                                                base_seed=args.seed)
    eval_step = vqa_engine.make_vqa_eval_step(model)

    def val_loader():
        return val_arrays.batches(batch_size, shuffle=False,
                                  drop_remainder=True,
                                  device_features=val_device_features,
                                  device=device)

    def run_test_pass(epoch):
        """OpenEnded submission rows for test2015 + the test-dev subset
        (no ground truth; reference engine.test)."""
        predict = vqa_engine.make_vqa_predict_step(model)
        loader = test_arrays.batches(batch_size, shuffle=False,
                                     device_features=device_features,
                                     device=device)
        rows = vqa_engine.test_pass(predict, loader, vocab_answers)
        qids = test_arrays.is_qid_testdev
        testdev_rows = [r for r in rows if r["question_id"] in qids]
        _save_results(rows, epoch, dir_logs, "test2015")
        _save_results(testdev_rows, epoch, dir_logs, "test-dev2015")
        print("Epoch %d test: %d rows (%d test-dev)"
              % (epoch, len(rows), len(testdev_rows)))
        return rows, testdev_rows

    if args.evaluate:
        if test_arrays is not None:
            return run_test_pass(start_epoch - 1)
        res, rows = vqa_engine.validate(eval_step, val_loader(), exp, 0,
                                        aid_to_ans=vocab_answers,
                                        collect_results=True)
        print("Evaluate:", res)
        _save_results(rows, 0, dir_logs, "val")
        return res

    # ---- epochs ----
    rng = np.random.default_rng(args.seed)
    for epoch in range(start_epoch, options["optim"]["epochs"] + 1):
        loader = train_arrays.batches(batch_size, shuffle=True, rng=rng,
                                      drop_remainder=True,
                                      device_features=device_features,
                                      device=device)
        state = vqa_engine.train_epoch(train_step, state, loader, exp, epoch,
                                       print_freq=args.print_freq)
        if test_arrays is not None:
            # trainval: no val metrics; checkpoint every epoch and emit
            # submission rows (reference train.py:241-262)
            run_test_pass(epoch)
            exp.to_json(os.path.join(dir_logs, "logger.json"))
            ckpt_lib.save_vqa_checkpoint(
                {"epoch": epoch, "best_acc1": best_acc1}, state, dir_logs,
                save_model=args.save_model,
                save_all_from=args.save_all_from, is_best=False)
            continue
        res, rows = vqa_engine.validate(eval_step, val_loader(), exp, epoch,
                                        aid_to_ans=vocab_answers,
                                        collect_results=True)
        print("Epoch {} val: {}".format(epoch, res))
        is_best = res["acc1"] > best_acc1
        best_acc1 = max(res["acc1"], best_acc1)
        exp.get_meter("val", "best_epoch").update(
            epoch if is_best else exp.get_meter("val", "best_epoch").value())
        exp.get_meter("val", "best_acc1").update(best_acc1)
        exp.to_json(os.path.join(dir_logs, "logger.json"))
        ckpt_lib.save_vqa_checkpoint(
            {"epoch": epoch, "best_acc1": best_acc1, "acc1": res["acc1"],
             "acc5": res["acc5"]}, state, dir_logs,
            save_model=args.save_model, save_all_from=args.save_all_from,
            is_best=is_best)
        _save_results(rows, epoch, dir_logs, "val")
    return state


def _save_results(rows, epoch, dir_logs, split):
    """OpenEnded result rows (reference ``train.py:276-288``)."""
    results_dir = os.path.join(dir_logs, "results", split)
    os.makedirs(results_dir, exist_ok=True)
    path = os.path.join(results_dir,
                        "vqa_OpenEnded_mscoco_epoch_%d.json" % epoch)
    with open(path, "w") as f:
        json.dump(rows, f)
    return path


if __name__ == "__main__":
    main()
