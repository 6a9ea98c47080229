"""The port's real-data layer against the JAX package, module by module.

Every input is made here from a numpy seed: the raw VQA (1.0 and 2.0)
annotation files with punctuation, contractions, articles and digits in
the questions and answers, tied answer counts (``Counter.most_common``
keeps first-seen order) and a long tail of answers past ``nans``; a
Visual Genome QA file; feature stores; a skip-thoughts artifact set.  The
same inputs go through the JAX module and the port's, each in a directory
of its own, and the outputs must agree: the interim JSON files and the
pickles byte for byte, the ``adapted_uniskip.npz`` arrays bit for bit,
the ``VQAArrays`` / ``CXArrays`` fields bit for bit, the OpenEnded
scores exactly, and the answer-embedding table (JAX's ``build_table``
with the same encoder weights, moved across by ``models/from_jax``) at
rtol 1e-4 in f32.
"""

import json
import os
import pickle
import shutil
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from vqa_counterexamples_tpu.cli import build_answer_embedding as jax_bae
from vqa_counterexamples_tpu.cli import build_vqacx as jax_build_vqacx
from vqa_counterexamples_tpu.cli import counterexamples as jax_cx_cli
from vqa_counterexamples_tpu.cli import eval_res as jax_eval_res
from vqa_counterexamples_tpu.cli import port_skipthoughts as jax_st
from vqa_counterexamples_tpu.cli import preprocess as jax_preprocess
from vqa_counterexamples_tpu.core import config as jax_config
from vqa_counterexamples_tpu.data import factory as jax_factory
from vqa_counterexamples_tpu.data import interim as jax_interim
from vqa_counterexamples_tpu.data import tokenizers as jax_tok
from vqa_counterexamples_tpu.data import vgenome as jax_vgenome
from vqa_counterexamples_tpu.data import vqacx as jax_vqacx
from vqa_counterexamples_tpu.engines import openended as jax_oe
from vqa_counterexamples_tpu.models import factory as jax_model_factory
from vqa_counterexamples_tpu_torch.cli import build_answer_embedding as bae
from vqa_counterexamples_tpu_torch.cli import build_vqacx
from vqa_counterexamples_tpu_torch.cli import counterexamples as cx_cli
from vqa_counterexamples_tpu_torch.cli import eval_res
from vqa_counterexamples_tpu_torch.cli import port_skipthoughts as st
from vqa_counterexamples_tpu_torch.cli import preprocess
from vqa_counterexamples_tpu_torch.cli import train as train_cli
from vqa_counterexamples_tpu_torch.core import config as port_config
from vqa_counterexamples_tpu_torch.data import factory
from vqa_counterexamples_tpu_torch.data import interim
from vqa_counterexamples_tpu_torch.data import tokenizers
from vqa_counterexamples_tpu_torch.data import vgenome
from vqa_counterexamples_tpu_torch.data import vqacx
from vqa_counterexamples_tpu_torch.data.features import FeatureStore
from vqa_counterexamples_tpu_torch.engines import openended
from vqa_counterexamples_tpu_torch.models import cx as port_cx
from vqa_counterexamples_tpu_torch.models import factory as port_factory
from vqa_counterexamples_tpu_torch.models import from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORDS = ["what", "color", "is", "the", "man's", "t-shirt", "dog", "cat",
         "how", "many", "are", "there", "isn't", "it", "a", "an", "on/off",
         "kite", "(left)", "u.s.a.", "whats", "dont", "2", "people;",
         "sign:", "$5", "@home", "shirt-sleeve", "yes!"]
ANSWERS = ["yes", "no", "2", "two", "red", "a dog", "the cat", "1,000",
           "dont", "t-shirt", "u.s.a.", "blue", "3", "none", "kite",
           "on/off", "white", "green", "black", "pink", "purple", "grey",
           "tan", "teal", "navy", "olive"]
N_IMAGES = {"train": 12, "val": 10, "test": 8}
DIM_V = 8


def _question(rng):
    n = int(rng.integers(3, 12))
    words = [WORDS[i] for i in rng.integers(0, len(WORDS), n)]
    text = " ".join(words)
    return text[0].upper() + text[1:] + rng.choice(["?", " ?", ".", ""])


def _answers(rng):
    """Ten human answers; half of the questions split 5 / 5 between two
    answers in a shuffled order (a tie that ``most_common`` breaks by first
    appearance), and the answer pool has a tail past the test's nans."""
    a, b = (ANSWERS[i] for i in rng.choice(len(ANSWERS), 2, replace=False,
                                             p=_ANSWER_P))
    if rng.random() < 0.5:
        humans = [a] * 5 + [b] * 5
    else:
        humans = [a] * int(rng.integers(6, 11))
        humans += [b] * (10 - len(humans))
    order = rng.permutation(10)
    return a, [{"answer": humans[i], "answer_confidence": "yes",
                "answer_id": j + 1} for j, i in enumerate(order)]


_ANSWER_P = np.linspace(3.0, 0.2, len(ANSWERS))
_ANSWER_P = _ANSWER_P / _ANSWER_P.sum()


def _write_raw(root, seed=0):
    """The raw VQA2 (OpenEnded, ``v2_`` names) and VQA 1.0
    (MultipleChoice) files of train / val / test / test-dev, a Visual
    Genome QA file, and the feature stores."""
    rng = np.random.default_rng(seed)
    ann_dir = os.path.join(root, "vqa", "raw", "annotations")
    os.makedirs(ann_dir)
    for split in ("train", "val", "test"):
        questions, annotations = [], []
        for image in range(1, N_IMAGES[split] + 1):
            for q in range(3):
                qid = image * 10 + q
                questions.append({
                    "question_id": qid, "image_id": image,
                    "question": _question(rng),
                    "multiple_choices": list(rng.choice(ANSWERS, 4))})
                answer, humans = _answers(rng)
                annotations.append({
                    "question_id": qid, "image_id": image,
                    "multiple_choice_answer": answer, "answers": humans,
                    "question_type": rng.choice(["what", "how many"]),
                    "answer_type": rng.choice(["other", "number"])})
        subtype = "test2015" if split == "test" else split + "2014"
        for prefix, v2 in (("OpenEnded", "v2_"), ("MultipleChoice", "")):
            with open(os.path.join(ann_dir, "%s%s_mscoco_%s_questions.json"
                                   % (v2, prefix, subtype)), "w") as f:
                json.dump({"questions": questions}, f)
            if split == "test":
                with open(os.path.join(
                        ann_dir, "%s%s_mscoco_test-dev2015_questions.json"
                        % (v2, prefix)), "w") as f:
                    json.dump({"questions": questions[::3]}, f)
        if split != "test":
            for v2 in ("v2_", ""):
                with open(os.path.join(ann_dir, "%smscoco_%s_annotations.json"
                                       % (v2, subtype)), "w") as f:
                    json.dump({"annotations": annotations}, f)
            pairs = [[a * 10 + q, (a + 1) * 10 + q] for a in
                     range(1, N_IMAGES[split], 2) for q in range(3)]
            with open(os.path.join(
                    ann_dir, "v2_mscoco_%s_complementary_pairs.json"
                    % subtype), "w") as f:
                json.dump(pairs, f)
    os.makedirs(os.path.join(root, "vg", "raw"))
    qas = [{"id": image, "qas": [
        {"qa_id": 9000 + image * 10 + q, "image_id": image,
         "question": _question(rng),
         "answer": str(rng.choice(ANSWERS + ["Red.", "A Dog", "zebra"]))}
        for q in range(3)]} for image in range(1, 7)]
    with open(os.path.join(root, "vg", "raw", "question_answers.json"),
              "w") as f:
        json.dump(qas, f)
    # trainset holds the train, val and Visual Genome images (a trainval
    # run and the VG concatenation read it), valset the val images
    names = {
        "trainset": ["COCO_train2014_%012d.jpg" % i for i in range(1, 13)]
        + ["COCO_val2014_%012d.jpg" % i for i in range(1, 11)]
        + ["%d.jpg" % i for i in range(1, 7)],
        "valset": ["COCO_val2014_%012d.jpg" % i for i in range(1, 11)],
        "testset": ["COCO_test2015_%012d.jpg" % i for i in range(1, 9)]}
    feats = os.path.join(root, "coco", "extract", "arch,fbresnet152_size,448")
    os.makedirs(feats)
    for split, ns in names.items():
        FeatureStore(rng.normal(size=(len(ns), DIM_V)).astype(np.float32),
                     ns).save(os.path.join(feats, split))
    return root


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    return _write_raw(str(tmp_path_factory.mktemp("raw")))


def _copy(raw_root, dest):
    """Copy of the fixture for one package's run (each writes its
    interim / processed files into its own tree)."""
    shutil.copytree(raw_root, dest)
    return str(dest)


def _files(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _opt_vqa(root, **kw):
    opt = {"dataset": "VQA2", "dir": os.path.join(root, "vqa"),
           "trainsplit": "train", "nans": 12, "maxlength": 9,
           "minwcount": 1, "nlp": "mcb", "pad": "right",
           "samplingans": True}
    opt.update(kw)
    return opt


def _opt_coco(root, mode="noatt"):
    return {"dir": os.path.join(root, "coco"), "arch": "fbresnet152",
            "size": 448, "mode": mode}


# --------------------------------------------------------------- modules


@pytest.mark.parametrize("params", [
    {"nans": 2000, "maxlength": 26, "minwcount": 0, "nlp": "mcb",
     "pad": "right", "trainsplit": "train"},
    {"nans": 3, "maxlength": 7, "minwcount": 2, "nlp": "nltk",
     "pad": "left", "trainsplit": "trainval", "dir": "x"}])
def test_options_subdir_matches_jax(params):
    assert port_config.options_subdir(params) == \
        jax_config.options_subdir(params)
    keys = ("nlp", "pad")
    assert port_config.options_subdir(params, keys) == \
        jax_config.options_subdir(params, keys)


SENTENCES = ["What's the man's t-shirt color?", "Is it on/off; (left)?",
             "How many people: 2,000 or $5?", "isn't it a dog-cat @home!",
             "  Two   spaces\nand a newline.", "U.S.A. \"quoted\" 'single'"]


@pytest.mark.parametrize("nlp", ["mcb", "naive", "nltk"])
def test_tokenizers_match_jax(nlp):
    """``nltk`` is imported when the tokenizer runs, on both sides: where
    nltk or its data is missing both raise the same error."""
    assert (tokenizers.tokenize("a-b c") == jax_tok.tokenize("a-b c"))
    port_tok, jax_tok_fn = (tokenizers.get_tokenizer(nlp),
                            jax_tok.get_tokenizer(nlp))
    for sentence in SENTENCES:
        try:
            want = jax_tok_fn(sentence)
        except Exception as exc:  # noqa: BLE001 - nltk absent or no data
            with pytest.raises(type(exc)):
                port_tok(sentence)
            continue
        assert port_tok(sentence) == want


@pytest.mark.parametrize("version", [1, 2])
def test_interim_files_byte_equal(raw, tmp_path, version):
    """``vqa_interim`` (train, val, trainval, test, testdev) and
    ``vgenome_interim``: the JSON files byte for byte, with the tied
    ``answers_occurence`` counts in first-seen order."""
    out = {}
    for name, mod in (("jax", jax_interim), ("port", interim)):
        root = _copy(raw, tmp_path / name)
        mod.vqa_interim(os.path.join(root, "vqa"), version=version)
        mod.vgenome_interim(os.path.join(root, "vg"))
        out[name] = {k: v for k, v in _files(root).items()
                     if "interim" in k}
    assert len(out["port"]) == 6
    assert out["port"] == out["jax"]
    rows = json.loads(out["port"][os.path.join(
        "vqa", "interim", "train_questions_annotations.json")])
    ties = [r["answers_occurence"] for r in rows
            if r["answers_occurence"][0][1] == 5]
    assert ties and ("MC_answer" in rows[0]) == (version == 1)


@pytest.mark.parametrize("params", [
    dict(trainsplit="train", pad="right", nlp="mcb", minwcount=0,
         maxlength=9),
    dict(trainsplit="train", pad="left", nlp="naive", minwcount=1,
         maxlength=40),
    dict(trainsplit="trainval", pad="right", nlp="mcb", minwcount=1,
         maxlength=9)])
def test_processed_pickles_byte_equal(raw, tmp_path, params):
    """``cli/preprocess interim`` then ``processed``: every pickle byte for
    byte (vocab order, UNK, padding, the OOV answer drop).  Left padding
    takes a maxlength above every question's length: the reference's
    left-pad encoder indexes past the list for longer ones (both packages
    keep that)."""
    argv = ["--nans", "12", "--maxlength", str(params["maxlength"]),
            "--minwcount", str(params["minwcount"]), "--nlp", params["nlp"],
            "--pad", params["pad"], "--trainsplit", params["trainsplit"]]
    out = {}
    for name, cli in (("jax", jax_preprocess), ("port", preprocess)):
        root = _copy(raw, tmp_path / name)
        cli.main(["interim", "--dir_vqa", os.path.join(root, "vqa")])
        cli.main(["processed", "--dirname", os.path.join(root, "vqa")]
                 + argv)
        out[name] = {k: v for k, v in _files(root).items()
                     if "processed" in k}
    assert out["port"] == out["jax"]
    names = {os.path.basename(k) for k in out["port"]}
    split = ("trainvalset.pickle" if params["trainsplit"] == "trainval"
             else "trainset.pickle")
    assert {split, "testset.pickle", "testdevset.pickle",
            "aid_to_ans.pickle", "wid_to_word.pickle"} <= names
    examples = pickle.loads(next(v for k, v in out["port"].items()
                                 if k.endswith(split)))
    n_rows = 3 * (N_IMAGES["train"] + (N_IMAGES["val"] if params[
        "trainsplit"] == "trainval" else 0))
    assert len(examples) < n_rows  # the OOV answers dropped
    if params["minwcount"]:
        assert any("UNK" in ex["question_words_UNK"] for ex in examples) \
            or "UNK" in pickle.loads(next(
                v for k, v in out["port"].items()
                if k.endswith("word_to_wid.pickle")))


def test_vgenome_processed_and_merge_match_jax(raw, tmp_path):
    rows = {}
    for name, mod in (("jax", jax_interim), ("port", interim)):
        root = _copy(raw, tmp_path / name)
        mod.vgenome_interim(os.path.join(root, "vg"))
        with open(os.path.join(root, "vg", "interim",
                               "train_questions_annotations.json")) as f:
            rows[name] = json.load(f)
    params = {"nans": 6, "nlp": "mcb", "minwcount": 0, "maxlength": 9,
              "pad": "right"}
    got = vgenome.vgenome_processed(rows["port"], params)
    want = jax_vgenome.vgenome_processed(rows["jax"], params)
    assert got == want
    vocab = {"the": 1, "UNK": 2, "what": 3}
    answers = {a: i for i, a in enumerate(["red", "a dog", "yes", "no"])}
    base = [{"question_id": 1}]
    assert (vgenome.merge_vqa_vgenome(base, got[0], answers, vocab)
            == jax_vgenome.merge_vqa_vgenome(base, want[0], answers, vocab))


def _arrays_equal(got, want):
    for field in ("question_wids", "answer_aids", "image_rows",
                  "question_ids"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    assert got.samplingans == want.samplingans
    assert len(got._ans_aid) == len(want._ans_aid)
    for a, b, pa, pb in zip(got._ans_aid, want._ans_aid, got._ans_p,
                            want._ans_p):
        assert (a is None) == (b is None)
        if a is not None:
            assert np.array_equal(a, b) and np.array_equal(pa, pb)


@pytest.mark.parametrize("split,vg", [
    ("train", False), ("val", False), ("trainval", False), ("test", False),
    ("testdev", False), ("train", True)])
def test_factory_vqa_dataset_matches_jax(raw, tmp_path, split, vg):
    """``factory_vqa_dataset`` builds interim and processed on first use
    and returns the same arrays, vocabs, store and ``is_qid_testdev``."""
    out = {}
    for name, mod in (("jax", jax_factory), ("port", factory)):
        root = _copy(raw, tmp_path / name)
        opt_vg = None
        if vg:
            (jax_interim if name == "jax" else interim).vgenome_interim(
                os.path.join(root, "vg"))
            opt_vg = {"dir": os.path.join(root, "vg"), "nans": 6,
                      "nlp": "mcb", "minwcount": 0, "maxlength": 9,
                      "pad": "right"}
        out[name] = mod.factory_vqa_dataset(split, _opt_vqa(root),
                                            _opt_coco(root), opt_vg)
    (arrays, words, answers, store), (j_arrays, j_words, j_answers,
                                      j_store) = out["port"], out["jax"]
    _arrays_equal(arrays, j_arrays)
    assert arrays.is_qid_testdev == j_arrays.is_qid_testdev
    assert (arrays.is_qid_testdev is not None) == (split == "test")
    assert words == j_words and answers == j_answers
    assert store.names == j_store.names
    assert np.array_equal(store.features, np.asarray(j_store.features))
    assert arrays.examples == j_arrays.examples
    if vg:
        assert any(ex["image_name"].endswith(".jpg")
                   and not ex["image_name"].startswith("COCO")
                   for ex in arrays.examples)


def test_factory_missing_raw_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        factory.factory_vqa_dataset("train", _opt_vqa(str(tmp_path)),
                                    _opt_coco(str(tmp_path)))


# -------------------------------------------------------- skip-thoughts


def _write_skipthoughts(dir_st, words, h=8, seed=0):
    """A dictionary missing the last word (the UNK fallback runs), a
    620-wide table and a theano-layout GRU at hidden ``h``; uni and bi."""
    rng = np.random.default_rng(seed)
    os.makedirs(dir_st, exist_ok=True)
    dict_words = ["UNK"] + sorted(words)[:-1] + ["extra%d" % i
                                                  for i in range(5)]
    with open(os.path.join(dir_st, "dictionary.txt"), "w") as f:
        f.write("\n".join(dict_words) + "\n")
    for table, skip in (("utable", "uni_skip"), ("btable", "bi_skip")):
        np.save(os.path.join(dir_st, table + ".npy"),
                rng.normal(size=(len(dict_words), 620)).astype(np.float32))
        np.savez(os.path.join(dir_st, skip + ".npz"),
                 encoder_W=rng.normal(size=(620, 2 * h)).astype(np.float32),
                 encoder_U=rng.normal(size=(h, 2 * h)).astype(np.float32),
                 encoder_b=rng.normal(size=2 * h).astype(np.float32),
                 encoder_Wx=rng.normal(size=(620, h)).astype(np.float32),
                 encoder_Ux=rng.normal(size=(h, h)).astype(np.float32),
                 encoder_bx=rng.normal(size=h).astype(np.float32))


@pytest.mark.parametrize("mode", ["utable", "btable", "src_npz",
                                  "src_pth"])
def test_port_skipthoughts_bit_equal(tmp_path, mode):
    words = ["what", "color", "is", "dog", "zebra"]
    vocab = tmp_path / "wid_to_word.pickle"
    with open(vocab, "wb") as f:
        pickle.dump({i + 1: w for i, w in enumerate(words)}, f)
    if mode in ("utable", "btable"):
        _write_skipthoughts(str(tmp_path / "st"), words)
        argv = ["--dir_st", str(tmp_path / "st"), "--vocab", str(vocab),
                "--table", mode]
    else:
        rng = np.random.default_rng(1)
        sd = {"embedding.weight": rng.normal(size=(6, 620)),
              "rnn.weight_ih_l0": rng.normal(size=(24, 620)),
              "rnn.weight_hh_l0": rng.normal(size=(24, 8)),
              "rnn.bias_ih_l0": rng.normal(size=24),
              "rnn.bias_hh_l0": rng.normal(size=24)}
        sd = {k: v.astype(np.float32) for k, v in sd.items()}
        src = tmp_path / ("src.npz" if mode == "src_npz" else "src.pth")
        if mode == "src_npz":
            np.savez(src, **sd)
        else:
            torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, src)
        argv = ["--src", str(src), "--vocab_size", "5"]
    st.main(argv + ["--out", str(tmp_path / "port.npz")])
    jax_st.main(argv + ["--out", str(tmp_path / "jax.npz")])
    got, want = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert sorted(got.files) == sorted(want.files) == [
        "b_hh", "b_ih", "embedding", "w_hh", "w_ih"]
    for key in want.files:
        assert got[key].dtype == want[key].dtype
        assert np.array_equal(got[key], want[key]), key
    if mode == "utable":
        table = np.load(tmp_path / "st" / "utable.npy")
        # "zebra" is not in the dictionary: its row is UNK's
        assert np.array_equal(got["embedding"][5], table[0])


# ---------------------------------------------------------------- VQA-CX


def _processed_dir(raw, root):
    """Port-processed pickles (the options of :func:`_opt_vqa`) in
    ``root``."""
    root = _copy(raw, root)
    preprocess.main(["interim", "--dir_vqa", os.path.join(root, "vqa")])
    preprocess.main(["processed", "--dirname", os.path.join(root, "vqa"),
                     "--nans", "12", "--maxlength", "9", "--minwcount", "1",
                     "--pad", "right"])
    return root, os.path.join(root, "vqa", "processed", os.listdir(
        os.path.join(root, "vqa", "processed"))[0])


def _write_knns(path, split, k=5, seed=0):
    """A kNN JSON keyed by image id: ``k`` other images in a shuffled
    order, the image's complementary-pair mate among them but for image
    3's."""
    rng = np.random.default_rng(seed)
    n = N_IMAGES[split]
    knns = {}
    for i in range(1, n + 1):
        mate = i + 1 if i % 2 else i - 1
        others = [j for j in rng.permutation(np.arange(1, n + 1)).tolist()
                  if j not in (i, mate)]
        near = ([] if i == 3 else [mate]) + others
        knns[str(i)] = rng.permutation(near[:k]).tolist()
    with open(path, "w") as f:
        json.dump(knns, f)


def _build_vqacx(cli, root, processed_dir, split, out_dir, small=None):
    argv = ["--split", split, "--path_processed", processed_dir,
            "--path_comp_pairs", os.path.join(
                root, "vqa", "raw", "annotations",
                "v2_mscoco_%s2014_complementary_pairs.json" % split),
            "--path_knn_json", os.path.join(root, "knn_%s.json" % split),
            "--path_features_txt", os.path.join(
                root, "coco", "extract", "arch,fbresnet152_size,448",
                "%sset.txt" % split),
            "--out_dir", out_dir]
    cli.main(argv + (["--small_size", str(small)] if small else []))


@pytest.fixture(scope="module")
def cx_root(raw, tmp_path_factory):
    root, proc = _processed_dir(raw, tmp_path_factory.mktemp("cx") / "r")
    for split in ("train", "val"):
        _write_knns(os.path.join(root, "knn_%s.json" % split), split)
    return SimpleNamespace(root=root, processed=proc)


@pytest.mark.parametrize("split,small", [("train", None), ("val", None),
                                         ("val", 4), ("train", 3)])
def test_build_vqacx_pickles_byte_equal(cx_root, tmp_path, split, small):
    """The augmented sets and their ``_small`` subsets (val shuffled by
    ``random.Random(123)``) byte for byte."""
    for name, cli in (("jax", jax_build_vqacx), ("port", build_vqacx)):
        _build_vqacx(cli, cx_root.root, cx_root.processed, split,
                     str(tmp_path / name), small)
    got, want = _files(str(tmp_path / "port")), _files(str(tmp_path / "jax"))
    assert sorted(got) == ["%sset_augmented.pickle" % split,
                           "%sset_augmented_small.pickle" % split]
    assert got == want
    ds = pickle.loads(got["%sset_augmented.pickle" % split])
    assert ds["examples_list"]
    for ex in ds["examples_list"]:
        assert len(ex["knns"]) == 5 and 0 <= ex["comp"]["knn_index"] < 5
    if small:
        assert len(pickle.loads(got["%sset_augmented_small.pickle"
                                    % split])["examples_list"]) == small


def test_vqacx_helpers_match_jax(cx_root, tmp_path):
    knns = vqacx.load_knns_json(os.path.join(cx_root.root, "knn_train.json"))
    assert knns == jax_vqacx.load_knns_json(
        os.path.join(cx_root.root, "knn_train.json"))
    with open(os.path.join(cx_root.processed, "trainset.pickle"), "rb") as f:
        examples = pickle.load(f)
    with open(os.path.join(cx_root.root, "vqa", "raw", "annotations",
                           "v2_mscoco_train2014_complementary_pairs.json"
                           )) as f:
        pairs = json.load(f)
    got = vqacx.build_augmented_examples(examples, pairs, knns)
    assert got == jax_vqacx.build_augmented_examples(examples, pairs, knns)
    ds = vqacx.make_dataset_dict(got, {}, ["a"], ["b"])
    vqacx.save_dataset(ds, str(tmp_path / "a.pickle"))
    jax_vqacx.save_dataset(ds, str(tmp_path / "b.pickle"))
    assert (tmp_path / "a.pickle").read_bytes() == \
        (tmp_path / "b.pickle").read_bytes()
    assert vqacx.load_dataset(str(tmp_path / "b.pickle")) == ds


@pytest.fixture(scope="module")
def cx_data(cx_root, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("cxdata"))
    for split in ("train", "val"):
        _build_vqacx(build_vqacx, cx_root.root, cx_root.processed, split,
                     out, small=2)
    return out


@pytest.mark.parametrize("subdir,dev_mode,test", [
    (False, False, True), (True, True, False), (False, True, True)])
def test_load_real_data_matches_jax(cx_root, cx_data, tmp_path, subdir,
                                    dev_mode, test):
    """The CX CLI's ``load_real_data``: the ``pickle/`` subdirectory or
    its absence, ``--dev_mode``'s ``_small`` train pickle, ``--test``'s
    full val pickle; the sets equal and their ``CXArrays`` bit-equal."""
    path = cx_data
    if subdir:
        path = str(tmp_path / "ds")
        shutil.copytree(cx_data, os.path.join(path, "pickle"))
    options = {"vqa": {"path_trainset": path}, "coco": {
        "path_features": os.path.join(cx_root.root, "coco", "extract",
                                      "arch,fbresnet152_size,448")}}
    args = SimpleNamespace(dev_mode=dev_mode, test=test)
    got = cx_cli.load_real_data(options, args)
    want = jax_cx_cli.load_real_data(options, args)
    assert got[:3] == want[:3]
    assert (got[2] is None) == (not test)
    n_train = len(got[0]["examples_list"])
    assert (n_train == 2) == dev_mode
    for ds, j_ds, store, j_store in ((got[0], want[0], got[3], want[3]),
                                     (got[1], want[1], got[4], want[4])):
        assert store.names == j_store.names
        assert np.array_equal(store.features, np.asarray(j_store.features))
        a = vqacx.CXArrays.from_examples(ds["examples_list"],
                                         store.name_to_index)
        b = jax_vqacx.CXArrays.from_examples(j_ds["examples_list"],
                                             j_store.name_to_index)
        for field in b._fields:
            assert getattr(a, field).dtype == getattr(b, field).dtype
            assert np.array_equal(getattr(a, field), getattr(b, field))


def test_init_answer_embedding_copies_the_table():
    opt = _encoder_options()["model"]
    vqa = port_factory.factory_vqa(opt, ["a", "b"], list("uvwxyz"))
    model = port_factory.factory_cx("NeuralModel", vqa, knn_size=3,
                                    model_spec={"dim_a": 5, "dim_h": 4})
    emb = np.random.default_rng(0).normal(size=(6, 5)).astype(np.float32)
    assert port_cx.init_answer_embedding(model, emb) is model
    assert np.array_equal(model.answer_embedding.weight.detach().numpy(),
                          emb)
    with pytest.raises(ValueError, match="answer embedding"):
        port_cx.init_answer_embedding(model, emb[:, :4])


# ------------------------------------------------------------- OpenEnded


CASES = [("two", ["two"] * 6 + ["2"] * 4), ("2", ["two"] * 10),
         ("1000", ["1,000"] * 9 + ["100"]), ("usa", ["u.s.a."] * 9 + ["us"]),
         ("a dog", ["dog"] * 5 + ["the dog"] * 5),
         ("dont", ["don't"] * 7 + ["no"] * 3),
         ("whats up", ["what's up"] * 4 + ["whats up"] * 6),
         ("none", ["0"] * 3 + ["none"] * 7), ("Yes!", ["yes"] * 9 + ["no"]),
         ("on/off", ["on off"] * 5 + ["onoff"] * 5),
         ("t-shirt", ["t shirt"] * 5 + ["tshirt"] * 5),
         ("  Ten\tcats ", ["10 cats"] * 8 + ["ten cats"] * 2)]


def test_openended_matches_jax():
    results, anns = [], {}
    for qid, (pred, humans) in enumerate(CASES):
        results.append({"question_id": qid, "answer": pred})
        anns[qid] = {"answers": [{"answer": a} for a in humans],
                     "question_type": "t%d" % (qid % 3),
                     "answer_type": "a%d" % (qid % 2)}
    results.append({"question_id": 999, "answer": "x"})  # not annotated
    assert openended.evaluate(results, anns) == jax_oe.evaluate(results,
                                                                anns)
    for pred, humans in CASES:
        for text in [pred] + humans:
            assert openended.normalize_answer(text) == \
                jax_oe.normalize_answer(text)
            assert openended.process_punctuation(text) == \
                jax_oe.process_punctuation(text)
    ann_json = {"annotations": [dict(v, question_id=k)
                                for k, v in anns.items()]}
    assert openended.annotations_from_vqa_json(ann_json) == \
        jax_oe.annotations_from_vqa_json(ann_json)


def test_eval_res_cli_matches_jax(raw, tmp_path):
    ann = os.path.join(raw, "vqa", "raw", "annotations",
                       "v2_mscoco_val2014_annotations.json")
    with open(ann) as f:
        qids = [a["question_id"] for a in json.load(f)["annotations"]]
    rng = np.random.default_rng(3)
    rows = [{"question_id": q, "answer": str(rng.choice(ANSWERS))}
            for q in qids]
    for name, cli in (("jax", jax_eval_res), ("port", eval_res)):
        (tmp_path / name).mkdir()
        path = tmp_path / name / "res.json"
        path.write_text(json.dumps(rows))
        cli.main(["--path_results", str(path), "--path_annotations", ann])
    got = (tmp_path / "port" / "res_accuracy.json").read_bytes()
    assert got == (tmp_path / "jax" / "res_accuracy.json").read_bytes()
    assert json.loads(got)["n"] == len(rows)


# ------------------------------------------------------ answer embedding


def _encoder_options(maxlength=26):
    return {
        "vqa": {"maxlength": maxlength, "pad": "right"},
        "model": {
            "arch": "MutanNoAtt",
            "seq2vec": {"arch": "skipthoughts", "type": "BayesianUniSkip",
                        "dropout": 0.25, "fixed_emb": False,
                        "emb_size": 16, "hidden_size": 40},
            "fusion": {"dim_v": 12, "dim_q": 40, "dim_hv": 8, "dim_hq": 8,
                       "dim_mm": 8, "R": 2, "dropout_v": 0.5,
                       "dropout_q": 0.5, "activation_v": "tanh",
                       "activation_q": "tanh", "dropout_hv": 0,
                       "dropout_hq": 0},
            "classif": {"dropout": 0.5}}}


def test_build_answer_embedding_matches_jax(tmp_path, monkeypatch):
    """300 answers over a 40-word vocab, some with out-of-vocab words and
    some of more words than fit: three batches of 128, the last padded.
    The JAX model's initial weights go to the port through
    ``models/from_jax`` and into a ``best_model.pt``; the port's CLI
    loads it and its table must match JAX's ``build_table`` of the same
    encoder at rtol 1e-4."""
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "float32")
    rng = np.random.default_rng(0)
    words = ["w%d" % i for i in range(40)]
    answers = []
    while len(answers) < 300:
        n = int(rng.integers(1, 4))
        ans = " ".join(rng.choice(words + ["oov"] * 3, n))
        if ans not in answers:
            answers.append(ans)
    answers[7] = " ".join(words[:30])  # more words than maxlength
    proc = tmp_path / "processed"
    proc.mkdir()
    with open(proc / "wid_to_word.pickle", "wb") as f:
        pickle.dump({i + 1: w for i, w in enumerate(words)}, f)
    with open(proc / "aid_to_ans.pickle", "wb") as f:
        pickle.dump(answers, f)
    options = _encoder_options()
    path_opt = tmp_path / "opt.yaml"
    path_opt.write_text(yaml.safe_dump(options))

    jmodel = jax_model_factory.factory_vqa(options["model"], tuple(words),
                                           tuple(answers))
    params = jmodel.init(
        {"params": jax.random.key(3), "dropout": jax.random.key(4)},
        jnp.zeros((1, 12)), jnp.zeros((1, 26), jnp.int32),
        deterministic=True)["params"]
    params = jax.tree.map(np.asarray, params)
    # unit-scale word vectors, so the GRU states are not near 0
    s2v = dict(params["seq2vec"])
    s2v["embedding"] = rng.normal(size=s2v["embedding"].shape).astype(
        np.float32)
    params = dict(params, seq2vec=s2v)
    logs = tmp_path / "logs"
    logs.mkdir()
    torch.save(from_jax.vqa_state_dict_from_jax(params),
               logs / "best_model.pt")

    table = bae.main(["--path_opt", str(path_opt), "--path_processed",
                      str(proc), "--dir_logs", str(logs), "--device", "cpu",
                      "--out", str(tmp_path / "emb.pickle")])
    with open(tmp_path / "emb.pickle", "rb") as f:
        saved = pickle.load(f)
    assert np.array_equal(saved, table) and saved.dtype == np.float32

    @jax.jit
    def encode(wids):
        return jmodel.apply({"params": params}, jnp.asarray(wids),
                            deterministic=True,
                            method=jmodel.encode_question)

    want = jax_bae.build_table(encode, answers,
                               {w: i + 1 for i, w in enumerate(words)},
                               maxlength=26, dim=40)
    covered = np.abs(want).sum(1) > 0
    assert 128 < covered.sum() < 300 and covered[7]
    assert np.array_equal(np.abs(table).sum(1) > 0, covered)
    np.testing.assert_allclose(table, want, rtol=1e-4, atol=1e-6)


def test_build_answer_embedding_device_rule(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        bae.main(["--path_processed", str(tmp_path)])


# ------------------------------------------------------------ train CLI


def _train_yaml(root, trainsplit="train"):
    opt = _encoder_options(maxlength=9)
    opt["model"]["fusion"]["dim_v"] = DIM_V
    opt["vqa"] = _opt_vqa(root, trainsplit=trainsplit)
    opt["coco"] = _opt_coco(root)
    opt["logs"] = {"dir_logs": os.path.join(root, "logs")}
    opt["optim"] = {"lr": 1e-3, "batch_size": 4, "epochs": 1}
    path = os.path.join(root, "train_%s.yaml" % trainsplit)
    with open(path, "w") as f:
        yaml.safe_dump(opt, f)
    return path


def test_train_cli_real_data(raw, tmp_path, monkeypatch):
    """Without ``--synthetic``: the processed pickles and the ``noatt``
    stores, the val rows scored by ``eval_res`` on a thread (the
    annotations are on disk) as the JAX CLI scores them; a trainval run
    writes the test2015 / test-dev2015 rows of the test split."""
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "float32")
    root, _ = _processed_dir(raw, tmp_path / "r")
    state = train_cli.main(["--path_opt", _train_yaml(root), "--device",
                            "cpu", "-p", "1000"])
    logs = os.path.join(root, "logs")
    with open(os.path.join(root, "vqa", "processed", os.listdir(
            os.path.join(root, "vqa", "processed"))[0],
            "trainset.pickle"), "rb") as f:
        n_train = len(pickle.load(f))
    assert state.step == n_train // 4
    res = os.path.join(logs, "results", "val",
                       "vqa_OpenEnded_mscoco_epoch_1.json")
    with open(res) as f:
        rows = json.load(f)
    assert len(rows) == 3 * N_IMAGES["val"] // 4 * 4
    thread = train_cli._save_results(
        rows, 7, logs, "val", dir_vqa=os.path.join(root, "vqa"))
    thread.join(timeout=60)
    with open(os.path.join(logs, "results", "val",
                           "vqa_OpenEnded_mscoco_epoch_7_accuracy.json")
              ) as f:
        scores = json.load(f)
    ann = os.path.join(root, "vqa", "raw", "annotations",
                       "v2_mscoco_val2014_annotations.json")
    with open(ann) as f:
        want = jax_oe.evaluate(rows, jax_oe.annotations_from_vqa_json(
            json.load(f)))
    assert scores == want

    train_cli.main(["--path_opt", _train_yaml(root, "trainval"),
                    "--device", "cpu", "-p", "1000", "--dir_logs",
                    os.path.join(root, "tv")])
    with open(os.path.join(root, "tv", "results", "test2015",
                           "vqa_OpenEnded_mscoco_epoch_1.json")) as f:
        test_rows = json.load(f)
    with open(os.path.join(root, "tv", "results", "test-dev2015",
                           "vqa_OpenEnded_mscoco_epoch_1.json")) as f:
        dev_rows = json.load(f)
    assert len(test_rows) == 3 * N_IMAGES["test"]
    assert len(dev_rows) == N_IMAGES["test"]


def test_train_cli_missing_data_raises_like_jax(tmp_path):
    path = _train_yaml(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        train_cli.main(["--path_opt", path, "--device", "cpu"])


def test_new_modules_leave_jax_out():
    code = ("import sys\n"
            "import vqa_counterexamples_tpu_torch.cli.preprocess\n"
            "import vqa_counterexamples_tpu_torch.cli.port_skipthoughts\n"
            "import vqa_counterexamples_tpu_torch.cli.build_vqacx\n"
            "import vqa_counterexamples_tpu_torch.cli.build_answer_embedding\n"
            "import vqa_counterexamples_tpu_torch.cli.eval_res\n"
            "import vqa_counterexamples_tpu_torch.cli.contrastive\n"
            "import vqa_counterexamples_tpu_torch.data.factory\n"
            "import vqa_counterexamples_tpu_torch.data.tokenizers\n"
            "import vqa_counterexamples_tpu_torch.data.interim\n"
            "import vqa_counterexamples_tpu_torch.data.processed\n"
            "import vqa_counterexamples_tpu_torch.data.vgenome\n"
            "import vqa_counterexamples_tpu_torch.engines.openended\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'nltk', 'vqa_counterexamples_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
