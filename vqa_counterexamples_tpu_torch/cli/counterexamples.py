"""CX CLI (port of ``cli/counterexamples.py``): same flags, same run-dir
layout (``logs/cx/<run>/{ckpt,best}``, ``runs/<run>/{train,val}``).

``--cx_model`` names any model of ``models/factory.cx_model_names``.
NeuralModel, LinearContext, PairwiseModel and PairwiseLinearModel train
with Adam; the others (RandomBaseline and DistanceBaseline, built with no
backbone, BlackBox, SemanticBaseline, which needs ``--sb_lambda``,
and SimilarityModel) are evaluated once an epoch, as JAX's CLI runs them.
ContrastiveModel raises ``ValueError`` here, as it does in JAX's CLI: it
trains with ``cli/contrastive.py``.  The run builds the frozen-backbone
q/v/z caches, runs ``--epochs`` epochs (per-epoch val, the best epoch by
recall kept in ``best/``, the last in ``ckpt/``), then with ``--test``
loads the best checkpoint and scores every test example's candidates,
writing loss, recall@5, recall@1 and ``best_epoch`` to
``final_results.txt``::

    python -m vqa_counterexamples_tpu_torch.cli.counterexamples \\
        --cx_model NeuralModel --synthetic 2048 --z_cache --epochs 2 --test

``--pairwise`` trains on the (orig, comp, other) triples of each epoch's
``CXArrays.pairwise_view`` (recall@1, no z cache) and adds
``loss_pairwise`` / ``acc_pairwise`` to every eval.  ``--trainable_vqa``
trains the backbone with the CX model (no caches); the YAML's
``cx_model.trainable_vqa`` is overridden by the flag's value, as in JAX's
CLI.  ``--resume <run>`` continues a run from its ``ckpt/`` (``--best``:
from ``best/``).  ``--epochs 0 --test`` only scores.  On a card the train
and eval steps are captured CUDA graphs; ``--scan_steps S`` (S > 1) runs
S train steps a call, as S replays of the captured step (eager steps on
the CPU), with the results of S single steps.

Without ``--synthetic`` it reads the real VQA-CX data as the JAX CLI does
(``load_real_data``): the augmented pickles of ``cli/build_vqacx`` in
``vqa.path_trainset`` (or its ``pickle/`` subdirectory), the train pickle's
``_small`` subset under ``--dev_mode`` and ``valset_augmented.pickle`` for
``--test``, and the feature stores ``trainset`` / ``valset`` in
``coco.path_features``.  The backbone is then the VQA checkpoint
``best_*`` under ``logs.dir_logs`` (unless ``--untrained_vqa``), and
NeuralModel's answer embedding, with ``cx_model.pretrained_emb``, the
table ``answer_embedding.pickle`` in ``vqa.path_trainset`` (written by
``cli/build_answer_embedding``).  Missing files raise
``FileNotFoundError``.  ``--mesh``, ``--distributed``, ``--init_params``
and ``--viz`` raise ``NotImplementedError`` (see ROADMAP.md for when they
come).  The device is ``cuda``; with no card visible the CLI refuses to
run unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
from datetime import datetime

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--path_opt",
                        default="configs/cx/counterexamples_default.yaml",
                        type=str, help="path to a yaml options file")
    parser.add_argument("-cx", "--cx_model", required=True, type=str,
                        help="Counterexample model type")
    parser.add_argument("-lr", "--learning_rate", type=float,
                        help="initial learning rate")
    parser.add_argument("-lb", "--sb_lambda", type=float,
                        help="semantic baseline lambda")
    parser.add_argument("-b", "--batch_size", type=int, help="mini-batch size")
    parser.add_argument("--epochs", type=int,
                        help="number of total epochs to run")
    parser.add_argument("--project_dir", default=".", type=str,
                        help="path to project root whose data to use")
    parser.add_argument("--resume", default="", type=str,
                        help="run name to resume")
    parser.add_argument("--best", action="store_true",
                        help="whether to resume best checkpoint")
    parser.add_argument("-c", "--comment", type=str, default="")
    parser.add_argument("-p", "--print_freq", default=100, type=int)
    parser.add_argument("-v", "--eval_freq", default=-1, type=int)
    parser.add_argument("-t", "--test", action="store_true",
                        help="Run eval on full testset after training")
    parser.add_argument("--viz", action="store_true",
                        help="Run viz on valset after training")
    parser.add_argument("--pairwise", action="store_true",
                        help="Pairwise training")
    group = parser.add_mutually_exclusive_group(required=False)
    group.add_argument("--pretrained_vqa", dest="pretrained_vqa",
                       action="store_true")
    group.add_argument("--untrained_vqa", dest="pretrained_vqa",
                       action="store_false")
    parser.set_defaults(pretrained_vqa=True)
    parser.add_argument("--trainable_vqa", action="store_true",
                        help="If true, backprop through VQA model")
    parser.add_argument("-dev", "--dev_mode", action="store_true")
    parser.add_argument("--synthetic", type=int, default=0, metavar="N",
                        help="run on N synthetic examples instead of COCO")
    parser.add_argument("--no_q_cache", action="store_true",
                        help="disable the precomputed frozen-encoder q_emb "
                             "cache")
    parser.add_argument("--z_cache", action="store_true",
                        help="precompute the fused embedding z per "
                             "(example, candidate); needs a frozen backbone "
                             "and the q and v caches")
    parser.add_argument("--scan_steps", type=int, default=0,
                        help="train steps a call: S replays of the captured "
                             "step (identical numerics); 0 = one step a "
                             "call")
    parser.add_argument("--no_v_cache", action="store_true",
                        help="disable the precomputed per-image fusion "
                             "v-projection cache")
    parser.add_argument("--mesh", type=str, default=None,
                        help="data-parallel mesh spec, e.g. 'data=8'")
    parser.add_argument("--distributed", action="store_true",
                        help="multi-host bootstrap")
    parser.add_argument("--init_params", type=str, default=None,
                        help="params file to graft over the initialized CX "
                             "params")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda; cpu must be asked "
                             "for)")
    return parser


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        "%s is not ported to the PyTorch package yet (ROADMAP.md, %s)"
        % (what, item))


def load_real_data(options, args):
    """The augmented sets and the feature stores (JAX
    ``cli/counterexamples.py:114-140``; reference
    ``counterexamples.py:178-207``) -> (trainset, valset, testset or None,
    train store, val store)."""
    from ..data import vqacx
    from ..data.features import FeatureStore

    # the augmented pickles live in <path_trainset>/pickle/ (the reference
    # uses a pickle_old/ subdir, counterexamples.py:185) or directly in
    # path_trainset (cli/build_vqacx --out_dir)
    root = options["vqa"]["path_trainset"]
    base = os.path.join(root, "pickle")
    if not os.path.isdir(base):
        base = root
    train_name = ("trainset_augmented_small.pickle" if args.dev_mode
                  else "trainset_augmented.pickle")
    trainset = vqacx.load_dataset(os.path.join(base, train_name))
    valset = vqacx.load_dataset(
        os.path.join(base, "valset_augmented_small.pickle"))
    testset = None
    if args.test:
        testset = vqacx.load_dataset(
            os.path.join(base, "valset_augmented.pickle"))

    feats = options["coco"]["path_features"]
    features_train = FeatureStore.load(os.path.join(feats, "trainset"))
    features_val = FeatureStore.load(os.path.join(feats, "valset"))
    return trainset, valset, testset, features_train, features_val


def load_synthetic_data(args, n_examples):
    from ..data import synthetic

    trainset, store = synthetic.make_synthetic_cx(
        n_examples=n_examples, n_images=max(128, n_examples // 4),
        dim_v=2048, knn_size=24, n_answers=100, seed=args.seed, split="train")
    valset, val_store = synthetic.make_synthetic_cx(
        n_examples=max(n_examples // 4, 64),
        n_images=max(128, n_examples // 8), dim_v=2048, knn_size=24,
        n_answers=100, seed=args.seed + 1, split="val")
    # synthetic shares one answer/word vocab
    valset["vocab_words"] = trainset["vocab_words"]
    valset["vocab_answers"] = trainset["vocab_answers"]
    return trainset, valset, valset, store, val_store


def check_unported(args) -> None:
    """Raise for the flags the port does not cover yet, each with its
    ROADMAP tag, before anything is built."""
    for flag, item in (("mesh", "Queue 1 #12"), ("distributed", "Queue 1 #12"),
                       ("init_params", "Queue 1: the msgpack bridge"),
                       ("viz", "Queue 1 #13")):
        if getattr(args, flag, None):
            _not_ported("--" + flag, item)


def resolve_device(name: str) -> torch.device:
    """The run's device: ``cuda`` must be visible, ``cpu`` asked for."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible: the port runs on the "
                           "card; pass --device cpu to run on the CPU")
    return device


# the models JAX's CLI trains with Adam (its counterexamples.py:255-257);
# the others are only evaluated
TRAINED = ("NeuralModel", "LinearContext", "PairwiseModel",
           "PairwiseLinearModel")


def main(argv=None):
    from ..core import checkpoint as ckpt_lib
    from ..core import config as config_lib
    from ..core.experiment import ScalarWriter
    from ..data import vqacx
    from ..engines import cx_engine
    from ..models import factory
    from ..models.cx import init_answer_embedding

    args = build_parser().parse_args(argv)
    # ---- options (CLI non-None > YAML > defaults) ----
    cli_overrides = {
        "optim": {"lr": args.learning_rate, "batch_size": args.batch_size,
                  "epochs": args.epochs},
        "cx_model": {"pretrained_vqa": args.pretrained_vqa,
                     "trainable_vqa": args.trainable_vqa},
    }
    options = config_lib.resolve_options({}, args.path_opt, cli_overrides)
    options["vgenome"] = None
    check_unported(args)
    if args.cx_model == "ContrastiveModel":
        # its forward returns (B, K+1, H) embeddings, which the K-way CE of
        # the CX steps cannot score: JAX's CLI fails on it with a
        # ValueError in its first eval; the model trains in cli/contrastive
        raise ValueError("ContrastiveModel returns embeddings, not scores: "
                         "train it with cli/contrastive.py")
    device = resolve_device(args.device)

    # ---- run-dir bookkeeping ----
    if args.cx_model == "NeuralModel" and not args.comment:
        args.comment = options["cx_model"]["name"]
    if args.resume:
        run_name = args.resume
        save_dir = os.path.join(args.project_dir, "logs", "cx", run_name)
        if not os.path.isdir(save_dir):
            raise FileNotFoundError("no run to resume at %s" % save_dir)
    else:
        run_name = datetime.now().strftime("%b%d-%H-%M-%S")
        if args.comment:
            run_name += "_" + args.comment
        save_dir = os.path.join(args.project_dir, "logs", "cx", run_name)
        os.makedirs(os.path.join(save_dir, "ckpt"), exist_ok=True)
        os.makedirs(os.path.join(save_dir, "best"), exist_ok=True)
    log_dir = os.path.join(args.project_dir, "runs", run_name)
    train_writer = ScalarWriter(os.path.join(log_dir, "train"))
    val_writer = ScalarWriter(os.path.join(log_dir, "val"))
    config_lib.save_options(options, save_dir)
    print("Saving model to {}".format(save_dir))

    # ---- data ----
    print("=> Loading VQA-CX dataset...")
    if args.synthetic:
        trainset, valset, testset, f_train, f_val = load_synthetic_data(
            args, args.synthetic)
    else:
        trainset, valset, testset, f_train, f_val = load_real_data(
            options, args)
    train_arrays = vqacx.CXArrays.from_examples(trainset["examples_list"],
                                                f_train.name_to_index)
    val_arrays = vqacx.CXArrays.from_examples(valset["examples_list"],
                                              f_val.name_to_index)
    features_train = f_train.to_device(device)
    features_val = f_val.to_device(device)

    # ---- model (JAX counterexamples.py:224-258) ----
    print("=> Building model...")
    trainable_vqa = options["cx_model"]["trainable_vqa"]
    extra_args = ()
    if args.cx_model == "SemanticBaseline":
        if args.sb_lambda is None:
            raise ValueError("SemanticBaseline requires --sb_lambda")
        extra_args = (torch.from_numpy(answer_cosines(_load_answer_embedding(
            options, args, len(trainset["vocab_answers"])))).to(device),)
    cx_model = factory.cx_from_options(
        args.cx_model, options, trainset["vocab_words"],
        trainset["vocab_answers"], knn_size=train_arrays.knn_size,
        sb_lambda=args.sb_lambda)
    cx_engine.init_cx_params(cx_model, seed=args.seed)
    cx_model.to(device)
    if not args.synthetic:
        # pretrained pieces grafted over the init (JAX :267-280)
        if (hasattr(cx_model, "vqa_model")
                and options["cx_model"].get("pretrained_vqa")):
            _load_pretrained_vqa(cx_model, options)
        if (args.cx_model == "NeuralModel"
                and options["cx_model"].get("pretrained_emb")):
            init_answer_embedding(cx_model, _load_answer_embedding(
                options, args, len(trainset["vocab_answers"])))
    state = cx_engine.init_cx_state(
        cx_model, lr=options["optim"]["lr"],
        optimizer="adam" if args.cx_model in TRAINED else None)
    print("Built {} on {}".format(args.cx_model, device))

    info = []
    start_epoch = 1
    best_recall = 0.0
    if args.resume:
        state, info, start_epoch, best_recall = ckpt_lib.load_cx_checkpoint(
            state, save_dir, resume_best=args.best)

    # ---- frozen-backbone caches (JAX :300-345; none for a trainable one) --
    frozen = hasattr(cx_model, "vqa_model") and not trainable_vqa
    use_q_cache = frozen and not args.no_q_cache
    use_v_cache = frozen and not args.no_v_cache
    use_z_cache = (args.z_cache and use_q_cache and use_v_cache
                   and not args.pairwise)
    if args.z_cache and not use_z_cache:
        print("=> z-emb cache needs a frozen backbone with q+v caches and "
              "a non-pairwise run; disabled")
    n_epochs = options["optim"]["epochs"]
    q_train = v_train = z_train = None
    if start_epoch <= n_epochs and state.optimizer is not None:
        q_train, v_train, z_train, stage_s = cx_engine.build_frozen_caches(
            cx_model, features_train, train_arrays, use_q=use_q_cache,
            use_v=use_v_cache, use_z=use_z_cache)
        print("=> Train caches built: %s"
              % {k: round(v, 3) for k, v in stage_s.items()})
    q_val, v_val, z_val, _ = cx_engine.build_frozen_caches(
        cx_model, features_val, val_arrays, use_q=use_q_cache,
        use_v=use_v_cache, use_z=use_z_cache)

    # ---- engines ----
    batch_size = options["optim"]["batch_size"]
    train_step = scan_step = None
    if state.optimizer is not None:
        train_step = cx_engine.make_cx_train_step(
            cx_model, state.optimizer, recall_k=1 if args.pairwise else 5,
            base_seed=args.seed, extra_apply_args=extra_args,
            use_z_cache=use_z_cache)
        if args.scan_steps > 1:
            scan_step = cx_engine.make_cx_train_scan(train_step)
            print("=> Scanned trainer: %d steps a call (%d replays of the "
                  "captured step on a card, eager steps on the CPU)"
                  % (args.scan_steps, args.scan_steps))
    eval_step = cx_engine.make_cx_eval_step(cx_model, recall_k=5,
                                            extra_apply_args=extra_args,
                                            use_z_cache=use_z_cache)

    def run_eval(st):
        return cx_engine.eval_model(
            eval_step, features_val, val_arrays, batch_size,
            pairwise=args.pairwise, pairwise_eval_step=eval_step,
            rng=np.random.default_rng(123), q_table=q_val, v_table=v_val,
            z_table=z_val)

    # ---- train loop ----
    print("=> Starting training...")
    if args.pairwise:
        print("==> Pairwise training")
    rng = np.random.default_rng(args.seed)
    epoch = None
    for epoch in range(start_epoch, n_epochs + 1):
        if train_step is not None:
            def log_fn(b, metrics, _epoch=epoch):
                step = (_epoch - 1) * 10000 + b
                for k, v in metrics.items():
                    train_writer.add_scalar(k, v, step)
                print("Epoch {} train: {}".format(
                    _epoch, {k: round(v, 4) for k, v in metrics.items()}))

            state, eval_results = cx_engine.train_epoch(
                train_step, state, features_train, train_arrays, batch_size,
                pairwise=args.pairwise, rng=rng, log_fn=log_fn,
                print_freq=args.print_freq, eval_fn=run_eval,
                eval_freq=args.eval_freq, q_table=q_train, v_table=v_train,
                z_table=z_train, scan_step=scan_step,
                scan_len=args.scan_steps)
        else:
            eval_results = run_eval(state)
        for k, v in eval_results.items():
            val_writer.add_scalar(k, v, epoch)
        print("Epoch {} val: {}".format(
            epoch, {k: round(float(v), 4) for k, v in eval_results.items()}))
        info.append({k: float(v) for k, v in eval_results.items()})
        is_best = info[-1]["recall"] > best_recall
        if is_best:
            best_recall = info[-1]["recall"]
        ckpt_lib.save_cx_checkpoint(state, info, save_dir, is_best=is_best)
        print("{}Saved checkpoint to {}".format("* " if is_best else "",
                                                save_dir))

    # ---- final test on the best checkpoint (reference :373-386) ----
    if args.test:
        best_epoch = 0
        if epoch is not None and state.optimizer is not None:
            # the reference's value: load_cx_checkpoint's next epoch
            state, _, best_epoch, _ = ckpt_lib.load_cx_checkpoint(
                state, save_dir, resume_best=True)
        test_arrays = vqacx.CXArrays.from_examples(
            testset["examples_list"], f_val.name_to_index)
        q_test, _, z_test, _ = cx_engine.build_frozen_caches(
            cx_model, features_val, test_arrays, use_q=use_q_cache,
            use_v=False, use_z=use_z_cache)
        test_results = cx_engine.eval_model(
            eval_step, features_val, test_arrays, batch_size,
            pairwise=args.pairwise, pairwise_eval_step=eval_step,
            rng=np.random.default_rng(123), q_table=q_test, v_table=v_val,
            z_table=z_test)
        test_results["best_epoch"] = best_epoch
        with open(os.path.join(save_dir, "final_results.txt"), "w") as f:
            f.write(json.dumps(test_results))
        print("FINAL RESULTS ON BEST EPOCH {}".format(best_epoch),
              test_results)
    train_writer.close()
    val_writer.close()
    return info


def _load_pretrained_vqa(cx_model, options) -> None:
    """Graft the VQA checkpoint ``best_*`` under ``logs.dir_logs`` into the
    CX model's backbone in place (JAX ``:512-528``; reference
    ``counterexamples.py:226-228`` -> ``train.py:332``)."""
    from ..core import checkpoint as ckpt_lib

    path = os.path.join(options["logs"]["dir_logs"], "best")
    if ckpt_lib.load_vqa_model(cx_model.vqa_model, path):
        print("Loaded pretrained VQA model from {}".format(path))


def _load_answer_embedding(options, args, n_answers: int) -> np.ndarray:
    """The answer embedding table (A, dim): ``answer_embedding.pickle`` in
    ``vqa.path_trainset``; under ``--synthetic`` N(0, 1) of width 2400 from
    ``default_rng(0)`` in f32, as JAX's CLI draws it."""
    if args.synthetic:
        return np.random.default_rng(0).normal(
            size=(n_answers, 2400)).astype(np.float32)
    path = os.path.join(options["vqa"]["path_trainset"],
                        "answer_embedding.pickle")
    with open(path, "rb") as f:
        return pickle.load(f)


def answer_cosines(emb: np.ndarray) -> np.ndarray:
    """(A, A) cosine similarities of the rows of ``emb`` in f32, the norms
    clamped below at 1e-8 (JAX ``cli/counterexamples.py:245-248``)."""
    emb = np.asarray(emb, np.float32)
    norm = np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-8)
    return (emb / norm) @ (emb / norm).T


if __name__ == "__main__":
    main()
