"""Dataset factory (port of ``data/factory.py``; the reference's
``datasets.factory_VQA``).

As reference ``vqa/datasets/vqa.py:250-267`` + ``utils.py:7-68``: asking
for a split builds raw -> interim -> processed on first use, then loads
the processed pickles and the COCO feature store of the split; with a
vgenome option tree the train split is concatenated with Visual Genome QA
mapped into the VQA vocab.  Fetching the raw files (the JAX package's
``download_raw``) is not ported: they must be on disk.
"""

from __future__ import annotations

import json
import os
import pickle

from ..core.config import options_subdir
from . import interim as interim_mod
from . import processed as processed_mod
from . import vgenome as vgenome_mod
from .features import FeatureStore
from .vqa_dataset import VQAArrays


def ensure_processed(opt_vqa: dict, version: int = 2) -> str:
    """Run the interim and processed builders if the pickles are missing;
    returns the processed dir."""
    processed_dir = os.path.join(opt_vqa["dir"], "processed",
                                 options_subdir(opt_vqa))
    split = ("trainvalset" if opt_vqa["trainsplit"] == "trainval"
             else "trainset")
    if os.path.exists(os.path.join(processed_dir, split + ".pickle")):
        return processed_dir
    interim_file = os.path.join(opt_vqa["dir"], "interim",
                                "train_questions_annotations.json")
    if not os.path.exists(interim_file):
        interim_mod.vqa_interim(opt_vqa["dir"], version=version)
    processed_mod.vqa_processed({
        "dir": opt_vqa["dir"], "trainsplit": opt_vqa["trainsplit"],
        "nans": opt_vqa["nans"], "maxlength": opt_vqa["maxlength"],
        "minwcount": opt_vqa["minwcount"], "nlp": opt_vqa["nlp"],
        "pad": opt_vqa["pad"]})
    return processed_dir


def load_vocabs(processed_dir: str):
    """(vocab_words in word-id order, vocab_answers) of a processed dir."""
    with open(os.path.join(processed_dir, "wid_to_word.pickle"), "rb") as f:
        wid_to_word = pickle.load(f)
    with open(os.path.join(processed_dir, "aid_to_ans.pickle"), "rb") as f:
        vocab_answers = pickle.load(f)
    return [wid_to_word[i] for i in sorted(wid_to_word)], vocab_answers


def features_dir(opt_coco: dict) -> str:
    """``{coco.dir}/extract/arch,<arch>_size,<size>``, where the extractor
    writes the feature stores."""
    return os.path.join(
        opt_coco["dir"], "extract",
        "arch,%s_size,%d" % (opt_coco["arch"], opt_coco.get("size", 448)))


def factory_vqa_dataset(split: str, opt_vqa: dict, opt_coco: dict,
                        opt_vgenome: dict | None = None):
    """(VQAArrays, vocab_words, vocab_answers, FeatureStore) of ``split``:
    'train' | 'val' | 'trainval' | 'test' | 'testdev' (factory_VQA's
    dispatch, reference vqa.py:250-267).  For 'test' the arrays carry
    ``is_qid_testdev``, the question ids of the test-dev subset (reference
    vqa.py:30-36,63-66), so the trainer can write both test2015 and
    test-dev2015 submission files."""
    version = 2 if opt_vqa.get("dataset", "VQA2") == "VQA2" else 1
    base_split = ("trainval" if split in ("test", "testdev")
                  else "train" if split == "val" else split)
    processed_dir = ensure_processed(dict(opt_vqa, trainsplit=base_split),
                                     version=version)
    fname = {"train": "trainset", "val": "valset",
             "trainval": "trainvalset", "test": "testset",
             "testdev": "testdevset"}[split] + ".pickle"
    with open(os.path.join(processed_dir, fname), "rb") as f:
        examples = pickle.load(f)
    is_qid_testdev = None
    if split == "test":
        testdev_path = os.path.join(processed_dir, "testdevset.pickle")
        if os.path.exists(testdev_path):
            with open(testdev_path, "rb") as f:
                is_qid_testdev = {ex["question_id"]
                                  for ex in pickle.load(f)}
    vocab_words, vocab_answers = load_vocabs(processed_dir)

    store_split = {"val": "valset", "test": "testset",
                   "testdev": "testset"}.get(split, "trainset")
    store = FeatureStore.load(os.path.join(features_dir(opt_coco),
                                           store_split),
                              dataset=opt_coco.get("mode", "noatt"))

    if opt_vgenome and split in ("train", "trainval"):
        vg_interim = os.path.join(opt_vgenome["dir"], "interim",
                                  "train_questions_annotations.json")
        if os.path.exists(vg_interim):
            with open(vg_interim) as f:
                vg_rows = json.load(f)
            vg_examples, _, _ = vgenome_mod.vgenome_processed(
                vg_rows, opt_vgenome)
            ans_to_aid = {a: i for i, a in enumerate(vocab_answers)}
            word_to_wid = {w: i + 1 for i, w in enumerate(vocab_words)}
            examples = vgenome_mod.merge_vqa_vgenome(
                examples, vg_examples, ans_to_aid, word_to_wid)
        else:
            print("vgenome interim missing at %s; skipping concat"
                  % vg_interim)

    arrays = VQAArrays(examples, store,
                       samplingans=opt_vqa.get("samplingans", False)
                       and split in ("train", "trainval"))
    arrays.is_qid_testdev = is_qid_testdev
    return arrays, vocab_words, vocab_answers, store
