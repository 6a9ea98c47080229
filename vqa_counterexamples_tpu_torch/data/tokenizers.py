"""Question tokenizers: naive, mcb, nltk (port of ``data/tokenizers.py``).

Re-implementations of reference ``vqa/datasets/vqa_processed.py:42-72``:
the exact token streams feed the question vocab, so they must match.
"""

from __future__ import annotations

import re

_NAIVE_SPLIT = re.compile(r"([-.\"',:? !\$#@~()*&\^%;\[\]/\\\+<>\n=])")

_MCB_REMOVE = [r"\?", r"\!", r"\'", r"\"", r"\$", r"\:", r"\@", r"\(",
               r"\)", r"\,", r"\.", r"\;"]
_MCB_SPACE = [r"\-", r"\/"]


def tokenize(sentence: str) -> list[str]:
    """Split on punctuation, keeping the separators (vqa_processed.py:42-43)."""
    return [t for t in _NAIVE_SPLIT.split(sentence)
            if t != "" and t != " " and t != "\n"]


def tokenize_mcb(s: str) -> list[str]:
    """MCB-style: lowercase, strip punctuation, dashes/slashes to spaces
    (vqa_processed.py:45-53)."""
    t_str = s.lower()
    for pat in _MCB_REMOVE:
        t_str = re.sub(pat, "", t_str)
    for pat in _MCB_SPACE:
        t_str = re.sub(pat, " ", t_str)
    q_list = re.sub(r"\?", "", t_str.lower()).split(" ")
    return [w for w in q_list if len(w) > 0]


def tokenize_nltk(s: str) -> list[str]:
    """nltk's ``word_tokenize`` of the lowercased text; nltk is imported
    here, so a host without it fails only when this tokenizer is asked
    for."""
    from nltk.tokenize import word_tokenize
    return word_tokenize(str(s).lower())


def get_tokenizer(nlp: str):
    if nlp == "mcb":
        return tokenize_mcb
    if nlp == "nltk":
        return tokenize_nltk
    return tokenize
