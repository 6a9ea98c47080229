"""VQA-CX dataset views (numpy copy of ``data/vqacx.py``).

The JAX package's ``data/__init__`` imports its jax-bound feature store, so
its numpy-only modules cannot be imported on a host without jax; this
module carries the pieces the port needs (the augmented-set join of
``cli/build_vqacx`` among them), and the CPU tests hold it to the JAX
package's output bit for bit.

All index math happens once up front: ``CXArrays.from_examples`` vectorizes
every example into int32 arrays, the batch iterator yields index slices,
and the feature rows are gathered on the device from the device-resident
feature matrix.
"""

from __future__ import annotations

import json
import pickle
from typing import NamedTuple

import numpy as np


def coco_name_to_num(name: str) -> int:
    if not (name.endswith(".jpg") and name[-17] == "_"):
        raise ValueError(name)
    return int(name[-16:-4])


def coco_num_to_name(num: int, split: str = "train") -> str:
    if len(str(num)) > 12:
        raise ValueError(num)
    if split not in ("train", "val"):
        raise ValueError("split must be train or val; got %s" % split)
    return "COCO_%s2014_%012d.jpg" % (split, num)


def build_augmented_examples(examples_list: list, comp_pairs: list,
                             knns: dict, split: str = "train") -> list:
    """Join processed VQA2 examples with the complementary pairs and the
    24-NN lists (vqacx_{train,val}set_builder.ipynb cells 7-18): an example
    is kept iff its question has a complement whose image is in the
    example image's kNN list; it gains ``comp`` (with ``knn_index``) and
    ``knns``."""
    comp_q = {}
    for q1, q2 in comp_pairs:
        comp_q[q1] = q2
        comp_q[q2] = q1
    qid_to_example = {ex["question_id"]: ex for ex in examples_list}
    valid_qids = set(comp_q.keys()) & set(qid_to_example.keys())

    filtered = []
    for ex in examples_list:
        q1 = ex["question_id"]
        if q1 not in valid_qids:
            continue
        q2 = comp_q[q1]
        if q2 not in valid_qids:
            continue
        i1 = coco_name_to_num(ex["image_name"])
        ex2 = qid_to_example[q2]
        i2 = coco_name_to_num(ex2["image_name"])
        if i1 not in knns or i2 not in knns[i1]:
            continue
        ex = dict(ex)
        ex["comp"] = dict(ex2)
        ex["comp"]["knn_index"] = knns[i1].index(i2)
        ex["knns"] = [coco_num_to_name(i, split) for i in knns[i1]]
        filtered.append(ex)
    return filtered


def make_dataset_dict(examples_list: list, name_to_index: dict,
                      vocab_words: list, vocab_answers: list) -> dict:
    return {"examples_list": examples_list, "name_to_index": name_to_index,
            "vocab_words": vocab_words, "vocab_answers": vocab_answers}


def load_dataset(path: str) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f)


def save_dataset(dataset: dict, path: str) -> None:
    with open(path, "wb") as f:
        pickle.dump(dataset, f)


def load_knns_json(path: str) -> dict:
    """A kNN JSON keyed by COCO image id (counterexamples.py:194-196)."""
    with open(path, "r") as f:
        knns = json.load(f)
    return {int(k): v for k, v in knns.items()}


class CXArrays(NamedTuple):
    """Vectorized dataset view; everything int32, static widths."""
    image_idxs: np.ndarray      # (N, K+1) rows into the feature matrix
    question_wids: np.ndarray   # (N, maxlength)
    answer_aids: np.ndarray     # (N,)
    comp_idxs: np.ndarray       # (N,) ground-truth candidate index in [0, K)

    @property
    def size(self) -> int:
        return self.image_idxs.shape[0]

    @property
    def knn_size(self) -> int:
        return self.image_idxs.shape[1] - 1

    @classmethod
    def from_examples(cls, examples_list: list, name_to_index: dict
                      ) -> "CXArrays":
        n = len(examples_list)
        if n == 0:
            raise ValueError("empty examples_list")
        k = len(examples_list[0]["knns"])
        maxlength = len(examples_list[0]["question_wids"])
        image_idxs = np.empty((n, k + 1), dtype=np.int32)
        question_wids = np.empty((n, maxlength), dtype=np.int32)
        answer_aids = np.empty((n,), dtype=np.int32)
        comp_idxs = np.empty((n,), dtype=np.int32)
        for i, ex in enumerate(examples_list):
            image_idxs[i, 0] = name_to_index[ex["image_name"]]
            image_idxs[i, 1:] = [name_to_index[nm] for nm in ex["knns"]]
            question_wids[i] = ex["question_wids"]
            answer_aids[i] = ex["answer_aid"]
            comp_idxs[i] = ex["comp"]["knn_index"]
        return cls(image_idxs, question_wids, answer_aids, comp_idxs)

    def pairwise_view(self, rng: np.random.Generator) -> "CXArrays":
        """(orig, comp, random-other) triples for hard-negative training
        (reference counterexamples.py:526-533): the other candidate is
        uniform over the K-1 that are not the comp, drawn from ``rng``; the
        label is always candidate 0 (the comp).  Row i stays example i."""
        n = self.size
        k = self.knn_size
        rows = np.arange(n)
        comp_col = self.comp_idxs + 1  # column 0 is the original image
        comp_feat = self.image_idxs[rows, comp_col]
        draw = rng.integers(0, k - 1, size=n)
        draw = draw + (draw >= self.comp_idxs)  # skip the comp slot
        other_feat = self.image_idxs[rows, draw + 1]
        image_idxs = np.stack(
            [self.image_idxs[:, 0], comp_feat, other_feat], axis=1)
        return CXArrays(image_idxs.astype(np.int32), self.question_wids,
                        self.answer_aids, np.zeros(n, dtype=np.int32))


def batch_indices(n: int, batch_size: int, shuffle: bool = True,
                  rng: np.random.Generator | None = None):
    """Yield (index_array, n_valid) pairs; the final short batch is padded to
    the static batch size (padding rows repeat index 0 and are masked out by
    n_valid)."""
    order = np.arange(n)
    if shuffle:
        (rng or np.random.default_rng()).shuffle(order)
    for start in range(0, n, batch_size):
        idx = order[start:start + batch_size]
        n_valid = idx.shape[0]
        if n_valid < batch_size:
            idx = np.concatenate(
                [idx, np.zeros(batch_size - n_valid, dtype=idx.dtype)])
        yield idx, n_valid


def gather_batch(arrays: CXArrays, idx: np.ndarray) -> dict:
    """Host-side slice of the int32 index arrays (the only per-batch
    host-to-device payload)."""
    return {
        "image_idxs": arrays.image_idxs[idx],
        "question_wids": arrays.question_wids[idx],
        "answer_aids": arrays.answer_aids[idx],
        "comp_idxs": arrays.comp_idxs[idx],
        # row ids into per-dataset side tables (the q/z caches)
        "example_idxs": np.asarray(idx, dtype=np.int32),
    }
