"""VQA preprocessing (port of ``data/processed.py``): answer vocab,
question vocab with UNK, encodings.

As reference ``vqa/datasets/vqa_processed.py``, whose vocab order and
encodings feed every model: the top-nans answer vocab by count (ties in
reverse lexicographic order, :19-32), train examples with an answer outside
it dropped (:34-40), long-tail words to UNK (:74-103), question word ids
padded left or right to maxlength (:110-123), answer and answers_occurence
encodings (:125-145).  The pickles come out as the JAX package's do.
"""

from __future__ import annotations

import json
import os
import pickle

from ..core.config import options_subdir
from .tokenizers import get_tokenizer


def get_top_answers(examples: list, nans: int = 3000) -> list:
    counts: dict = {}
    for ex in examples:
        ans = ex["answer"]
        counts[ans] = counts.get(ans, 0) + 1
    cw = sorted([(count, w) for w, count in counts.items()], reverse=True)
    return [w for _, w in cw[:nans]]


def remove_examples(examples: list, ans_to_aid: dict) -> list:
    return [ex for ex in examples if ex["answer"] in ans_to_aid]


def preprocess_questions(examples: list, nlp: str = "mcb") -> list:
    tok = get_tokenizer(nlp)
    for ex in examples:
        ex["question_words"] = tok(ex["question"])
    return examples


def remove_long_tail_train(examples: list, minwcount: int = 0):
    counts: dict = {}
    for ex in examples:
        for w in ex["question_words"]:
            counts[w] = counts.get(w, 0) + 1
    vocab = [w for w, n in counts.items() if n > minwcount]
    vocab.append("UNK")
    for ex in examples:
        ex["question_words_UNK"] = [
            w if counts.get(w, 0) > minwcount else "UNK"
            for w in ex["question_words"]]
    return examples, vocab


def remove_long_tail_test(examples: list, word_to_wid: dict) -> list:
    for ex in examples:
        ex["question_words_UNK"] = [
            w if w in word_to_wid else "UNK" for w in ex["question_words"]]
    return examples


def encode_question(examples: list, word_to_wid: dict, maxlength: int = 15,
                    pad: str = "left") -> list:
    for ex in examples:
        ex["question_length"] = min(maxlength, len(ex["question_words_UNK"]))
        ex["question_wids"] = [0] * maxlength
        for k, w in enumerate(ex["question_words_UNK"]):
            if k < maxlength:
                if pad == "right":
                    ex["question_wids"][k] = word_to_wid[w]
                else:
                    new_k = k + maxlength - len(ex["question_words_UNK"])
                    ex["question_wids"][new_k] = word_to_wid[w]
                ex["seq_length"] = len(ex["question_words_UNK"])
    return examples


def encode_answer(examples: list, ans_to_aid: dict) -> list:
    # an answer outside the vocab maps to its last id (reference :126-128)
    last = len(ans_to_aid) - 1
    for ex in examples:
        ex["answer_aid"] = ans_to_aid.get(ex["answer"], last)
    return examples


def encode_answers_occurence(examples: list, ans_to_aid: dict) -> list:
    for ex in examples:
        answers, answers_aid, answers_count = [], [], []
        for ans, count in ex.get("answers_occurence", []):
            aid = ans_to_aid.get(ans, -1)
            if aid != -1:
                answers.append(ans)
                answers_aid.append(aid)
                answers_count.append(count)
        ex["answers"] = answers
        ex["answers_aid"] = answers_aid
        ex["answers_count"] = answers_count
    return examples


def _load_json(path: str):
    with open(path) as f:
        return json.load(f)


def vqa_processed(params: dict) -> dict:
    """Interim -> processed, as ``vqa_processed.py:147-260``.

    ``params``: dir, trainsplit, nans, maxlength, minwcount, nlp, pad.
    Writes the pickles into ``processed/<options_subdir>/`` and returns
    their paths by name.
    """
    interim = os.path.join(params["dir"], "interim")
    trainsplit = params["trainsplit"]
    trainset = _load_json(os.path.join(
        interim, trainsplit + "_questions_annotations.json"))
    valset = None
    if trainsplit == "train":
        valset = _load_json(os.path.join(interim,
                                         "val_questions_annotations.json"))
    testset = testdevset = None
    test_path = os.path.join(interim, "test_questions.json")
    if os.path.exists(test_path):
        testset = _load_json(test_path)
    testdev_path = os.path.join(interim, "testdev_questions.json")
    if os.path.exists(testdev_path):
        testdevset = _load_json(testdev_path)

    top_answers = get_top_answers(trainset, params["nans"])
    aid_to_ans = list(top_answers)
    ans_to_aid = {a: i for i, a in enumerate(top_answers)}
    trainset = remove_examples(trainset, ans_to_aid)

    trainset = preprocess_questions(trainset, params["nlp"])
    trainset, top_words = remove_long_tail_train(trainset,
                                                params["minwcount"])
    wid_to_word = {i + 1: w for i, w in enumerate(top_words)}
    word_to_wid = {w: i + 1 for i, w in enumerate(top_words)}

    splits = {"trainset": trainset}
    for name, split in (("valset", valset), ("testset", testset),
                        ("testdevset", testdevset)):
        if split is not None:
            split = preprocess_questions(split, params["nlp"])
            splits[name] = remove_long_tail_test(split, word_to_wid)

    for split in splits.values():
        encode_question(split, word_to_wid, params["maxlength"],
                        params["pad"])
    encode_answer(trainset, ans_to_aid)
    encode_answers_occurence(trainset, ans_to_aid)
    if valset is not None:
        encode_answer(valset, ans_to_aid)
        encode_answers_occurence(valset, ans_to_aid)

    outdir = os.path.join(params["dir"], "processed",
                          options_subdir(params))
    os.makedirs(outdir, exist_ok=True)
    paths = {}
    for obj, name in [(wid_to_word, "wid_to_word"),
                      (word_to_wid, "word_to_wid"),
                      (aid_to_ans, "aid_to_ans"),
                      (ans_to_aid, "ans_to_aid")]:
        paths[name] = os.path.join(outdir, name + ".pickle")
        with open(paths[name], "wb") as f:
            pickle.dump(obj, f)
    name_map = {"trainset": ("trainvalset" if trainsplit == "trainval"
                             else "trainset")}
    for key, split in splits.items():
        fname = name_map.get(key, key)
        paths[fname] = os.path.join(outdir, fname + ".pickle")
        with open(paths[fname], "wb") as f:
            pickle.dump(split, f)
    return paths
