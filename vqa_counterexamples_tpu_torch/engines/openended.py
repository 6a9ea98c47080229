"""OpenEnded VQA accuracy in Python 3 (port of ``engines/openended.py``).

Replaces the reference's Python-2 external toolkit shim (``eval_res.py:15-45``,
spawned async at ``train.py:287-288``).  Implements the official evaluator's
normalization rules (contractions, number words, articles, punctuation) and
the 10-choose-9 consensus accuracy: for each question with 10 human answers,

    acc = mean_i min(#{j != i : answer == human_j} / 3, 1)

over the 10 leave-one-out folds.
"""

from __future__ import annotations

import re

CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't",
    "couldve": "could've", "couldnt": "couldn't",
    "couldn'tve": "couldn't've", "couldnt've": "couldn't've",
    "didnt": "didn't", "doesnt": "doesn't", "dont": "don't",
    "hadnt": "hadn't", "hadnt've": "hadn't've", "hadn'tve": "hadn't've",
    "hasnt": "hasn't", "havent": "haven't", "hed": "he'd",
    "hed've": "he'd've", "he'dve": "he'd've", "hes": "he's",
    "howd": "how'd", "howll": "how'll", "hows": "how's",
    "Id've": "I'd've", "I'dve": "I'd've", "Im": "I'm", "Ive": "I've",
    "isnt": "isn't", "itd": "it'd", "itd've": "it'd've",
    "it'dve": "it'd've", "itll": "it'll", "let's": "let's",
    "maam": "ma'am", "mightnt": "mightn't", "mightnt've": "mightn't've",
    "mightn'tve": "mightn't've", "mightve": "might've",
    "mustnt": "mustn't", "mustve": "must've", "neednt": "needn't",
    "notve": "not've", "oclock": "o'clock", "oughtnt": "oughtn't",
    "ow's'at": "'ow's'at", "'ows'at": "'ow's'at", "'ow'sat": "'ow's'at",
    "shant": "shan't", "shed've": "she'd've", "she'dve": "she'd've",
    "she's": "she's", "shouldve": "should've", "shouldnt": "shouldn't",
    "shouldnt've": "shouldn't've", "shouldn'tve": "shouldn't've",
    "somebody'd": "somebodyd", "somebodyd've": "somebody'd've",
    "somebody'dve": "somebody'd've", "somebodyll": "somebody'll",
    "somebodys": "somebody's", "someoned": "someone'd",
    "someoned've": "someone'd've", "someone'dve": "someone'd've",
    "someonell": "someone'll", "someones": "someone's",
    "somethingd": "something'd", "somethingd've": "something'd've",
    "something'dve": "something'd've", "somethingll": "something'll",
    "thats": "that's", "thered": "there'd", "thered've": "there'd've",
    "there'dve": "there'd've", "therere": "there're",
    "theres": "there's", "theyd": "they'd", "theyd've": "they'd've",
    "they'dve": "they'd've", "theyll": "they'll", "theyre": "they're",
    "theyve": "they've", "twas": "'twas", "wasnt": "wasn't",
    "wed've": "we'd've", "we'dve": "we'd've", "weve": "we've",
    "werent": "weren't", "whatll": "what'll", "whatre": "what're",
    "whats": "what's", "whatve": "what've", "whens": "when's",
    "whered": "where'd", "wheres": "where's", "whereve": "where've",
    "whod": "who'd", "whod've": "who'd've", "who'dve": "who'd've",
    "wholl": "who'll", "whos": "who's", "whove": "who've",
    "whyll": "why'll", "whyre": "why're", "whys": "why's",
    "wont": "won't", "wouldve": "would've", "wouldnt": "wouldn't",
    "wouldnt've": "wouldn't've", "wouldn'tve": "wouldn't've",
    "yall": "y'all", "yall'll": "y'all'll", "y'allll": "y'all'll",
    "yall'd've": "y'all'd've", "y'alld've": "y'all'd've",
    "y'all'dve": "y'all'd've", "youd": "you'd", "youd've": "you'd've",
    "you'dve": "you'd've", "youll": "you'll", "youre": "you're",
    "youve": "you've",
}

MANUAL_MAP = {"none": "0", "zero": "0", "one": "1", "two": "2",
              "three": "3", "four": "4", "five": "5", "six": "6",
              "seven": "7", "eight": "8", "nine": "9", "ten": "10"}

ARTICLES = ["a", "an", "the"]

PUNCT = [";", r"/", "[", "]", '"', "{", "}", "(", ")", "=", "+", "\\",
         "_", "-", ">", "<", "@", "`", ",", "?", "!"]

_PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")
_COMMA_STRIP = re.compile(r"(\d)(\,)(\d)")


def process_punctuation(text: str) -> str:
    out = text
    for p in PUNCT:
        if (p + " " in text or " " + p in text) \
                or (re.search(_COMMA_STRIP, text) is not None):
            out = out.replace(p, "")
        else:
            out = out.replace(p, " ")
    out = _PERIOD_STRIP.sub("", out, re.UNICODE)
    return out


def process_digit_article(text: str) -> str:
    out = []
    for word in text.lower().split():
        word = MANUAL_MAP.get(word, word)
        if word not in ARTICLES:
            out.append(word)
    for i, word in enumerate(out):
        if word in CONTRACTIONS:
            out[i] = CONTRACTIONS[word]
    return " ".join(out)


def normalize_answer(ans: str) -> str:
    ans = ans.replace("\n", " ").replace("\t", " ").strip()
    return process_digit_article(process_punctuation(ans))


def evaluate(results: list, annotations: dict) -> dict:
    """OpenEnded accuracy.

    Args:
      results: [{'question_id': int, 'answer': str}, ...] model outputs.
      annotations: question_id -> {'answers': [{'answer': str}, ...] (10),
                   optionally 'question_type' / 'answer_type'}.

    Returns {'overall': pct, 'perQuestionType': {...}, 'perAnswerType': {...}}.
    """
    accs = []
    per_qtype: dict[str, list] = {}
    per_atype: dict[str, list] = {}
    for res in results:
        qid = res["question_id"]
        if qid not in annotations:
            continue
        ann = annotations[qid]
        gts = [a["answer"].replace("\n", " ").replace("\t", " ").strip()
               for a in ann["answers"]]
        pred = res["answer"].replace("\n", " ").replace("\t", " ").strip()
        # official-evaluator quirk (vqaEval.py): normalization applies ONLY
        # when the 10 humans disagree — and ground truths get punctuation
        # processing only, never the digit/article/contraction pass
        if len(set(gts)) > 1:
            gts = [process_punctuation(g) for g in gts]
            pred = process_digit_article(process_punctuation(pred))
        fold_accs = []
        for i in range(len(gts)):
            others = gts[:i] + gts[i + 1:]
            matches = sum(1 for g in others if g == pred)
            fold_accs.append(min(matches / 3.0, 1.0))
        acc = sum(fold_accs) / len(fold_accs)
        accs.append(acc)
        if "question_type" in ann:
            per_qtype.setdefault(ann["question_type"], []).append(acc)
        if "answer_type" in ann:
            per_atype.setdefault(ann["answer_type"], []).append(acc)

    def pct(values):
        return round(100.0 * sum(values) / max(len(values), 1), 2)

    return {
        "overall": pct(accs),
        "perQuestionType": {k: pct(v) for k, v in per_qtype.items()},
        "perAnswerType": {k: pct(v) for k, v in per_atype.items()},
        "n": len(accs),
    }


def annotations_from_vqa_json(ann_json: dict) -> dict:
    """Index an official v2_mscoco_*_annotations.json by question_id."""
    return {a["question_id"]: a for a in ann_json["annotations"]}
