"""Synthetic VQA-CX fixtures shaped like the real pipeline outputs (numpy
copy of ``data/synthetic.py``; the CPU tests hold it to the JAX package's
output bit for bit).

Images have random features; each example's KNN list is the true nearest
neighbours of its image, and the comp image is one of them.  With
``learnable`` the comp rank is ``answer_aid % knn_size``.
"""

from __future__ import annotations

import numpy as np

from . import vqacx
from .features import FeatureStore


def synthetic_vocab(n_words: int = 50, n_answers: int = 20):
    vocab_words = ["w%d" % i for i in range(n_words)]
    vocab_answers = ["a%d" % i for i in range(n_answers)]
    return vocab_words, vocab_answers


def make_synthetic_cx(n_examples: int = 256, n_images: int = 128,
                      dim_v: int = 2048, knn_size: int = 24,
                      maxlength: int = 26, n_words: int = 50,
                      n_answers: int = 20, seed: int = 0,
                      split: str = "train", learnable: bool = True,
                      true_knn: bool = True):
    """Returns (dataset_dict, FeatureStore).  ``true_knn=False`` replaces the
    exact KNN lists with sampled ones (the O(N^2) distance matrix does not
    fit at COCO scale)."""
    rng = np.random.default_rng(seed)
    if n_images <= knn_size + 1:
        raise ValueError(
            "make_synthetic_cx needs n_images > knn_size + 1 (got %d vs %d):"
            " candidate lists are %d DISTINCT non-self images per row"
            % (n_images, knn_size, knn_size))

    features = rng.normal(size=(n_images, dim_v)).astype(np.float32)
    names = [vqacx.coco_num_to_name(i, split) for i in range(n_images)]
    store = FeatureStore(features, names)

    if true_knn:
        norms = (features ** 2).sum(1)
        d2 = norms[:, None] - 2 * features @ features.T + norms[None, :]
        np.fill_diagonal(d2, np.inf)
        part = np.argpartition(d2, knn_size, axis=1)[:, :knn_size]
        part_d = np.take_along_axis(d2, part, axis=1)
        order = np.argsort(part_d, axis=1)
        knn_idx = np.take_along_axis(part, order, axis=1)
    else:
        # distinct non-self offsets per row: sorted draws from a reduced
        # range plus arange are strictly increasing, then shuffled in-row
        off = np.sort(rng.integers(1, n_images - knn_size + 1,
                                   size=(n_images, knn_size)), axis=1)
        off = rng.permuted(off + np.arange(knn_size), axis=1)
        knn_idx = (np.arange(n_images)[:, None] + off) % n_images

    vocab_words, vocab_answers = synthetic_vocab(n_words, n_answers)

    examples = []
    for ei in range(n_examples):
        img = int(rng.integers(0, n_images))
        knns = [names[j] for j in knn_idx[img]]
        qlen = int(rng.integers(3, 10))
        wids = [0] * maxlength
        for k in range(qlen):
            wids[k] = int(rng.integers(1, n_words + 1))  # right padding
        aid = int(rng.integers(0, n_answers))
        if learnable:
            comp_rank = aid % knn_size
        else:
            comp_rank = int(rng.integers(0, knn_size))
        comp_name = knns[comp_rank]
        examples.append({
            "question_id": ei,
            "image_name": names[img],
            "question": " ".join("w%d" % (w - 1) for w in wids[:qlen]),
            "question_wids": wids,
            "question_length": qlen,
            "answer": vocab_answers[aid],
            "answer_aid": aid,
            "comp": {
                "image_name": comp_name,
                "answer": vocab_answers[int(rng.integers(0, n_answers))],
                "knn_index": comp_rank,
            },
            "knns": knns,
        })

    dataset = vqacx.make_dataset_dict(examples, store.name_to_index,
                                      vocab_words, vocab_answers)
    return dataset, store


def make_synthetic_vqa(n_examples: int, n_answers: int, maxlength: int = 26,
                       dim_v: int = 2048, spatial: bool = False,
                       seed: int = 0):
    """Processed-like VQA examples + a feature store for smoke runs: the
    JAX package's ``cli/train._synthetic_vqa`` draw for draw (which caps
    ``n_answers`` at 50 and passes ``spatial`` for the att archs' (14, 14,
    dim_v) maps).  Returns (examples, store, vocab_words,
    vocab_answers)."""
    rng = np.random.default_rng(seed)
    n_words = 80
    n_images = max(64, n_examples // 4)
    shape = (n_images, 14, 14, dim_v) if spatial else (n_images, dim_v)
    feats = rng.normal(size=shape).astype(np.float32)
    names = ["COCO_train2014_%012d.jpg" % i for i in range(n_images)]
    store = FeatureStore(feats, names)
    vocab_words, vocab_answers = synthetic_vocab(n_words, n_answers)
    examples = []
    for i in range(n_examples):
        qlen = int(rng.integers(3, 10))
        wids = [0] * maxlength
        for k in range(qlen):
            wids[k] = int(rng.integers(1, n_words + 1))
        aid = int(rng.integers(0, n_answers))
        examples.append({
            "question_id": i,
            "image_name": names[int(rng.integers(0, n_images))],
            "question_wids": wids, "answer_aid": aid,
            "answers_aid": [aid], "answers_count": [10],
        })
    return examples, store, vocab_words, vocab_answers


def tiny_vqa_options(dim_v: int = 2048, nans: int = 20,
                     seq2vec_arch: str = "2-lstm",
                     dim_q: int | None = None) -> dict:
    """A MutanNoAtt option tree with reference keys but tiny dims."""
    dim_q = dim_q or 48
    return {
        "arch": "MutanNoAtt",
        "seq2vec": {"arch": seq2vec_arch, "emb_size": 16,
                    "hidden_size": dim_q // 2},
        "fusion": {
            "dim_v": dim_v, "dim_q": dim_q, "dim_hv": 24, "dim_hq": 24,
            "dim_mm": 24, "R": 3, "dropout_v": 0.5, "dropout_q": 0.5,
            "activation_v": "tanh", "activation_q": "tanh",
            "dropout_hv": 0, "dropout_hq": 0,
        },
        "classif": {"dropout": 0.5},
    }
