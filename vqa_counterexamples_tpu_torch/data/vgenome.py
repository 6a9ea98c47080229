"""Visual Genome QA (port of ``data/vgenome.py``): the processed builder
and the VQA + VG concatenation.

As reference ``vqa/datasets/vgenome_processed.py`` (answers are tokenized
and re-joined, :25-39) and its ``VQAVisualGenome`` concat dataset
(``vqa/datasets/vqa.py:186-247``): VG examples whose tokenized answer is
outside the VQA answer vocab are dropped, and the question word ids are
mapped into the VQA question vocab with UNK for the rest.
"""

from __future__ import annotations

from . import processed as proc
from .tokenizers import get_tokenizer


def preprocess_answers(examples: list, nlp: str = "mcb") -> list:
    tok = get_tokenizer(nlp)
    for ex in examples:
        ex["answer"] = " ".join(tok(str(ex["answer"]).lower())
                                if nlp != "nltk" else tok(ex["answer"]))
    return examples


def vgenome_processed(examples: list, params: dict):
    """Interim VG rows -> processed examples with their own vocabs
    (vgenome_processed.py:59-134)."""
    examples = preprocess_answers(examples, params["nlp"])
    top_answers = proc.get_top_answers(examples, params["nans"])
    ans_to_aid = {a: i for i, a in enumerate(top_answers)}
    examples = proc.remove_examples(examples, ans_to_aid)
    examples = proc.preprocess_questions(examples, params["nlp"])
    examples, top_words = proc.remove_long_tail_train(examples,
                                                     params["minwcount"])
    word_to_wid = {w: i + 1 for i, w in enumerate(top_words)}
    examples = proc.encode_question(examples, word_to_wid,
                                    params["maxlength"], params["pad"])
    examples = proc.encode_answer(examples, ans_to_aid)
    return examples, top_answers, top_words


def merge_vqa_vgenome(vqa_examples: list, vg_examples: list,
                      ans_to_aid: dict, word_to_wid: dict) -> list:
    """VQA + VG examples in the VQA vocab space (vqa.py:194-213)."""
    kept = []
    dropped = 0
    unk = word_to_wid.get("UNK", 1)
    for ex in vg_examples:
        if ex["answer"] not in ans_to_aid:
            dropped += 1
            continue
        ex = dict(ex)
        ex["answer_aid"] = ans_to_aid[ex["answer"]]
        wids = list(ex["question_wids"])
        for j, word in enumerate(ex["question_words_UNK"]):
            if j >= len(wids):
                break
            if wids[j] != 0:
                wids[j] = word_to_wid.get(word, unk)
        ex["question_wids"] = wids
        kept.append(ex)
    print("-> %d / %d visual genome items removed (answer OOV)"
          % (dropped, len(vg_examples)))
    return list(vqa_examples) + kept
