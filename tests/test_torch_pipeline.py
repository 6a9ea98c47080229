"""The port's replication pipeline end to end on the rehearsal fixtures
(CPU, f32, ``--device cpu``).

``scripts/replicate_reference.stage_rehearsal_fixtures`` writes the
miniature raw set (VQA2-format questions, annotations and complementary
pairs over 32 train / 28 val COCO-named images, a skip-thoughts artifact
set at hidden 64) at the rehearsal's scaled knobs; the features come from
a seed in place of ``extract`` (the fixture's fbresnet checkpoint is not
written: nothing here extracts).  The port's CLIs then run the stages in
the runbook's order: preprocess -> port_skipthoughts -> knn -> train ->
build_answer_embedding -> build_vqacx -> counterexamples ``--test``, and
``contrastive`` on the same pickles.  The JAX package's CLIs of the numpy
stages (preprocess, port_skipthoughts, knn, build_vqacx) run on a copy of
the same fixture, and their outputs must be byte-equal; the
answer-embedding table is held against JAX's ``build_table`` over the
port's trained encoder (its checkpoint read by JAX's ``load_pytree``) at
rtol 1e-4.
"""

import glob
import json
import os
import pickle
import shutil
import sys
import threading
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from vqa_counterexamples_tpu.cli import build_answer_embedding as jax_bae
from vqa_counterexamples_tpu.cli import build_vqacx as jax_build_vqacx
from vqa_counterexamples_tpu.cli import knn as jax_knn
from vqa_counterexamples_tpu.cli import port_skipthoughts as jax_st
from vqa_counterexamples_tpu.cli import preprocess as jax_preprocess
from vqa_counterexamples_tpu.core import checkpoint as jax_ckpt
from vqa_counterexamples_tpu.models import factory as jax_model_factory
from vqa_counterexamples_tpu_torch.cli import (build_answer_embedding,
                                               build_vqacx, contrastive,
                                               counterexamples, knn,
                                               port_skipthoughts, preprocess,
                                               train)
from vqa_counterexamples_tpu_torch.core import msgpack_tree
from vqa_counterexamples_tpu_torch.data.features import FeatureStore
from vqa_counterexamples_tpu_torch.engines import cx_engine
from vqa_counterexamples_tpu_torch.models import from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import replicate_reference as rr  # noqa: E402


def _knobs(project_dir):
    """The runbook's path layout at ``--rehearsal``'s scaled knobs
    (``replicate_reference.main``)."""
    P = SimpleNamespace(project_dir=project_dir, rehearsal=True,
                        n_train_images=32, n_val_images=28, nans=10,
                        dim_q=64, extract_size=64, vqa_epochs=2,
                        vqa_batch=16, cx_epochs=2)
    P.dir_vqa = os.path.join(project_dir, "data", "vqa2")
    P.vqa_raw = os.path.join(P.dir_vqa, "raw")
    P.dir_coco = os.path.join(project_dir, "data", "coco")
    P.coco_raw = os.path.join(P.dir_coco, "raw")
    P.knn_dir = os.path.join(P.dir_coco, "knn")
    P.dir_st = os.path.join(project_dir, "data", "skip-thoughts")
    P.weights_dir = os.path.join(project_dir, "data", "weights")
    P.processed = os.path.join(
        P.dir_vqa, "processed", "nans,%d_maxlength,26_minwcount,0_nlp,mcb_"
        "pad,right_trainsplit,train" % P.nans)
    P.features = os.path.join(P.dir_coco, "extract",
                              "arch,fbresnet152_size,%d" % P.extract_size)
    P.dir_logs_vqa = os.path.join(project_dir, "logs", "vqa2",
                                  "mutan_noatt_train")
    P.cx_data = os.path.join(project_dir, "data", "cx")
    return P


def _run_stages(P, cli, device):
    """The numpy stages through one package's CLIs (``cli``: module by
    stage name), and the seeded features."""
    cli["preprocess"].main(["interim", "--dir_vqa", P.dir_vqa,
                            "--version", "2"])
    cli["preprocess"].main(["processed", "--dirname", P.dir_vqa, "--nans",
                            str(P.nans), "--maxlength", "26", "--minwcount",
                            "0", "--nlp", "mcb", "--pad", "right"])
    cli["port_skipthoughts"].main([
        "--dir_st", P.dir_st, "--vocab",
        os.path.join(P.processed, "wid_to_word.pickle"), "--table",
        "utable", "--out", os.path.join(P.dir_st, "adapted_uniskip.npz")])
    rng = np.random.default_rng(0)
    os.makedirs(P.features, exist_ok=True)
    for split, n in (("train", P.n_train_images),
                     ("val", P.n_val_images)):
        # images 2i-1 and 2i (a complementary pair) near one centre
        centres = rng.normal(size=((n + 1) // 2, 2048))
        feats = (np.repeat(centres, 2, axis=0)[:n]
                 + 0.3 * rng.normal(size=(n, 2048))).astype(np.float32)
        prefix = os.path.join(P.features, "%sset" % split)
        FeatureStore(feats, ["COCO_%s2014_%012d.jpg" % (split, i)
                             for i in range(1, n + 1)]).save(prefix)
        cli["knn"].main(["--path_features", prefix, "-k", "25", "--split",
                         split, "--json-out", os.path.join(
                             P.knn_dir, "computed_%s2014_nn_images.json"
                             % split)] + device)


def _build_vqacx(P, cli):
    for split in ("train", "val"):
        cli.main(["--split", split, "--path_processed", P.processed,
                  "--path_comp_pairs", os.path.join(
                      P.vqa_raw, "annotations",
                      "v2_mscoco_%s2014_complementary_pairs.json" % split),
                  "--path_knn_json", os.path.join(
                      P.knn_dir, "computed_%s2014_nn_images.json" % split),
                  "--path_features_txt",
                  os.path.join(P.features, "%sset.txt" % split),
                  "--out_dir", P.cx_data])


def _cx_yaml(P, vqa_yaml):
    """``stage_counterexamples``' rewrite of the CX options, at its
    rehearsal widths."""
    with open(os.path.join(REPO, "configs", "cx",
                           "counterexamples_default.yaml")) as f:
        opt = yaml.safe_load(f)
    opt["logs"]["dir_logs"] = P.dir_logs_vqa
    opt["vqa"]["dir"] = P.dir_vqa
    opt["vqa"]["path_trainset"] = P.cx_data
    opt["coco"]["dir"] = P.dir_coco
    opt["coco"]["path_features"] = P.features
    with open(vqa_yaml) as f:
        vqa_opt = yaml.safe_load(f)
    opt["model"] = vqa_opt["model"]
    opt["vqa"]["nans"] = vqa_opt["vqa"]["nans"]
    opt["coco"]["size"] = vqa_opt["coco"]["size"]
    opt["cx_model"].update(dim_h=16, dim_a=P.dim_q)
    opt["optim"]["batch_size"] = 16
    path = os.path.join(P.project_dir, "cx_replication.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(opt, f)
    return path


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("VQACX_COMPUTE_DTYPE", "float32")
    # nothing here extracts: the fixture's fbresnet checkpoint is skipped
    mp.setattr(rr, "_write_fake_fbresnet", lambda path: None)
    root = tmp_path_factory.mktemp("pipeline")
    P = _knobs(str(root / "port"))
    rr.stage_rehearsal_fixtures(P, None)
    J = _knobs(str(root / "jax"))
    shutil.copytree(P.project_dir, J.project_dir)

    port = {"preprocess": preprocess, "port_skipthoughts": port_skipthoughts,
            "knn": knn}
    _run_stages(P, port, ["--device", "cpu"])
    _run_stages(J, {"preprocess": jax_preprocess,
                    "port_skipthoughts": jax_st, "knn": jax_knn}, [])

    vqa_yaml = rr.write_vqa_train_yaml(P)
    state = train.main(["--path_opt", vqa_yaml, "--dir_logs",
                        P.dir_logs_vqa, "--epochs", str(P.vqa_epochs),
                        "-b", str(P.vqa_batch), "--device", "cpu"])
    os.makedirs(P.cx_data, exist_ok=True)
    table = build_answer_embedding.main([
        "--path_opt", vqa_yaml, "--path_processed", P.processed,
        "--dir_logs", P.dir_logs_vqa, "--out",
        os.path.join(P.cx_data, "answer_embedding.pickle"), "--device",
        "cpu"])
    _build_vqacx(P, build_vqacx)
    _build_vqacx(J, jax_build_vqacx)

    # the CX model as the CLI hands it to its optimizer: the grafted
    # backbone and answer embedding, before any step
    seen = {}
    init_state = cx_engine.init_cx_state

    def spy(model, *args, **kwargs):
        seen.setdefault(type(model).__name__, {
            k: v.detach().clone() for k, v in model.state_dict().items()})
        return init_state(model, *args, **kwargs)

    mp.setattr(cx_engine, "init_cx_state", spy)
    cx_yaml = _cx_yaml(P, vqa_yaml)
    info = counterexamples.main([
        "--cx_model", "NeuralModel", "--epochs", str(P.cx_epochs),
        "--path_opt", cx_yaml, "--project_dir", P.project_dir,
        "--comment", "replication", "--test", "--device", "cpu"])
    c_info = contrastive.main(["--epochs", "1", "--path_opt", cx_yaml,
                               "--project_dir", P.project_dir, "--device",
                               "cpu"])
    for thread in threading.enumerate():  # the eval_res scoring threads
        if thread is not threading.current_thread():
            thread.join(timeout=60)
    yield SimpleNamespace(P=P, J=J, state=state, table=table, info=info,
                          c_info=c_info, seen=seen, vqa_yaml=vqa_yaml)
    mp.undo()


def _tree(root, sub):
    out = {}
    for path in glob.glob(os.path.join(root, sub, "**", "*"),
                          recursive=True):
        if os.path.isfile(path):
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def test_preprocess_matches_jax(runs):
    P, J = runs.P, runs.J
    for sub in ("data/vqa2/interim", "data/vqa2/processed"):
        got, want = _tree(P.project_dir, sub), _tree(J.project_dir, sub)
        assert got and got == want, sub
    with open(os.path.join(P.processed, "aid_to_ans.pickle"), "rb") as f:
        assert len(pickle.load(f)) == P.nans
    with open(os.path.join(P.processed, "trainset.pickle"), "rb") as f:
        n_train = len(pickle.load(f))
    # the rehearsal's rare answers drop out of the 10-answer vocab
    assert 20 < n_train < 6 * P.n_train_images


def test_skipthoughts_and_knn_match_jax(runs):
    P, J = runs.P, runs.J
    got = np.load(os.path.join(P.dir_st, "adapted_uniskip.npz"))
    want = np.load(os.path.join(J.dir_st, "adapted_uniskip.npz"))
    assert got["embedding"].shape[1] == 620
    assert got["w_hh"].shape == (P.dim_q, 3 * P.dim_q)
    for key in want.files:
        assert np.array_equal(got[key], want[key]), key
    for split, n in (("train", P.n_train_images), ("val", P.n_val_images)):
        name = "computed_%s2014_nn_images.json" % split
        with open(os.path.join(P.knn_dir, name)) as f:
            lists = json.load(f)
        with open(os.path.join(J.knn_dir, name)) as f:
            assert lists == json.load(f)
        assert len(lists) == n
        assert all(len(v) == 24 for v in lists.values())


def test_pretraining_ran_on_real_data(runs):
    P = runs.P
    n_steps = runs.state.step
    assert n_steps >= 2 * P.vqa_epochs
    with open(os.path.join(P.dir_logs_vqa, "logger.json")) as f:
        logged = json.load(f)["logged"]
    assert set(logged["val"]["acc1"]) == {"1", "2"}
    for epoch in (1, 2):
        path = os.path.join(P.dir_logs_vqa, "results", "val",
                            "vqa_OpenEnded_mscoco_epoch_%d_accuracy.json"
                            % epoch)
        with open(path) as f:
            scores = json.load(f)
        assert scores["n"] > 0 and 0.0 <= scores["overall"] <= 100.0
    assert os.path.isfile(os.path.join(P.dir_logs_vqa, "best_model.msgpack"))


def test_answer_embedding_matches_jax(runs):
    """The table over the port's trained encoder against JAX's
    ``build_table`` over the same weights (the port's ``best_model.msgpack``
    read by JAX's ``load_pytree``) at f32."""
    P = runs.P
    table = runs.table
    assert table.shape == (P.nans, P.dim_q)
    assert (np.abs(table).sum(1) > 0).mean() > 0.5
    with open(runs.vqa_yaml) as f:
        options = yaml.safe_load(f)
    with open(os.path.join(P.processed, "wid_to_word.pickle"), "rb") as f:
        wid_to_word = pickle.load(f)
    words = [wid_to_word[i] for i in sorted(wid_to_word)]
    with open(os.path.join(P.processed, "aid_to_ans.pickle"), "rb") as f:
        answers = pickle.load(f)
    jmodel = jax_model_factory.factory_vqa(options["model"], tuple(words),
                                           tuple(answers))
    template = jmodel.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        jnp.zeros((1, options["model"]["fusion"]["dim_v"])),
        jnp.zeros((1, 26), jnp.int32), deterministic=True)["params"]
    params = jax_ckpt.load_pytree(
        template, os.path.join(P.dir_logs_vqa, "best_model.msgpack"))
    assert "fusion_module" in params      # MutanNoAtt

    @jax.jit
    def encode(wids):
        return jmodel.apply({"params": params}, jnp.asarray(wids),
                            deterministic=True,
                            method=jmodel.encode_question)

    want = jax_bae.build_table(encode, answers,
                               {w: i + 1 for i, w in enumerate(words)},
                               maxlength=26, dim=P.dim_q)
    np.testing.assert_allclose(table, want, rtol=1e-4, atol=1e-6)


def test_build_vqacx_matches_jax(runs):
    P, J = runs.P, runs.J
    for split in ("train", "val"):
        for name in ("%sset_augmented.pickle", "%sset_augmented_small"
                                                ".pickle"):
            with open(os.path.join(P.cx_data, name % split), "rb") as f:
                got = f.read()
            with open(os.path.join(J.cx_data, name % split), "rb") as f:
                assert got == f.read(), name % split
        ds = pickle.loads(got)
        # the pair mates share a centre: most pairs survive the join
        assert len(ds["examples_list"]) > 4
        for ex in ds["examples_list"]:
            assert len(ex["knns"]) == 24 and 0 <= ex["comp"]["knn_index"] \
                < 24


def test_counterexamples_on_real_data(runs):
    """``--test`` on ``valset_augmented.pickle``: finite recalls in
    [0, 1]; the model the CLI trained started from the ``best`` VQA
    checkpoint's backbone bit for bit and from the answer-embedding
    pickle's rows."""
    P = runs.P
    assert len(runs.info) == P.cx_epochs
    (path,) = glob.glob(os.path.join(P.project_dir, "logs", "cx",
                                     "*replication*", "final_results.txt"))
    with open(path) as f:
        res = json.load(f)
    assert set(res) == {"loss", "recall", "recall_1", "best_epoch"}
    assert np.isfinite(res["loss"])
    assert 0.0 <= res["recall_1"] <= res["recall"] <= 1.0
    start = runs.seen["NeuralModel"]
    best = from_jax.vqa_state_dict_from_jax(msgpack_tree.load(
        os.path.join(P.dir_logs_vqa, "best_model.msgpack")))
    for key, value in best.items():
        assert torch.equal(start["vqa_model." + key], value), key
    with open(os.path.join(P.cx_data, "answer_embedding.pickle"), "rb") as f:
        emb = pickle.load(f)
    assert np.array_equal(start["answer_embedding.weight"].numpy(), emb)


def test_contrastive_on_real_data(runs):
    (row,) = runs.c_info
    assert set(row) == {"contrastive/recall", "recall"}
    assert 0.0 <= row["recall"] <= 1.0
    # the contrastive trainer keeps its backbone's seeded init, as JAX's
    assert "ContrastiveModel" in runs.seen


def test_cx_cli_missing_data_raises_like_jax(runs, tmp_path):
    with open(os.path.join(runs.P.project_dir, "cx_replication.yaml")) as f:
        opt = yaml.safe_load(f)
    opt["vqa"]["path_trainset"] = str(tmp_path / "none")
    path = tmp_path / "cx.yaml"
    path.write_text(yaml.safe_dump(opt))
    for main, extra in ((counterexamples.main, ["--cx_model",
                                                "NeuralModel"]),
                        (contrastive.main, [])):
        with pytest.raises(FileNotFoundError):
            main(extra + ["--epochs", "1", "--path_opt", str(path),
                          "--project_dir", str(tmp_path), "--device", "cpu"])
