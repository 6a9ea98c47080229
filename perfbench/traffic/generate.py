"""The one generator of the benchmark's data: every array a run feeds the
port, made from ``--seed`` and the sizes of the configuration file.

- ``questions``: right-padded word ids, lengths from the configuration's
  length table, words Zipf-distributed over the vocabulary (id 0 pads);
- ``cx_data``: a VQA-CX split: each example's image, its K candidate images
  (K distinct images other than its own, one list per image), question,
  answer and the complementary image's rank; the feature table on the
  device;
- ``vqa_data``: a VQA2 split: each question's image, words, majority answer
  and 1 to 4 human answers with counts; the feature table on the host.

Features are |N(0, 1)| (non-negative, as pooled ResNet features are); a
table served in bfloat16 holds bfloat16 values.  The same seed gives the
same arrays on the same device; the host arrays do not depend on the
device.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch


def seeds(seed: int, tag: str) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(
        [int(seed), zlib.crc32(tag.encode())]))


def torch_seed(seed: int, tag: str) -> int:
    return int(seeds(seed, tag).integers(0, 2 ** 62))


def vocab(cfg: dict) -> tuple:
    """(question words, answers): the vocabularies' names (ids are what
    the data holds)."""
    return (["w%d" % i for i in range(cfg["n_words"])],
            ["a%d" % i for i in range(cfg["nans"])])


def zipf(rng: np.random.Generator, n_items: int, s: float, size
         ) -> np.ndarray:
    """Ids in [0, n_items), P(i) proportional to 1 / (i + 1)^s."""
    w = 1.0 / np.arange(1, n_items + 1, dtype=np.float64) ** s
    cdf = np.cumsum(w / w.sum())
    return np.minimum(np.searchsorted(cdf, rng.random(size)),
                      n_items - 1).astype(np.int32)


def questions(rng: np.random.Generator, n: int, cfg: dict) -> np.ndarray:
    """(n, maxlength) int32 word ids in [1, n_words], 0 after the last."""
    qc, maxlength = cfg["questions"], cfg["maxlength"]
    lengths_p = {int(k): v for k, v in qc["length_probs"].items()}
    if abs(sum(lengths_p.values()) - 1.0) > 1e-9 or max(lengths_p) > maxlength:
        raise ValueError("length_probs must sum to 1 over lengths <= %d"
                         % maxlength)
    lens = np.array(sorted(lengths_p))
    probs = np.array([lengths_p[k] for k in lens])
    length = rng.choice(lens, size=n, p=probs / probs.sum())
    wids = zipf(rng, cfg["n_words"], qc["word_zipf_s"], (n, maxlength)) + 1
    wids[np.arange(maxlength)[None, :] >= length[:, None]] = 0
    return wids.astype(np.int32)


def features(n: int, dim: int, seed: int, tag: str, device,
             bf16_values: bool) -> torch.Tensor:
    """(n, dim) f32 |N(0, 1)| made on ``device`` in one call."""
    gen = torch.Generator(device=device)
    gen.manual_seed(torch_seed(seed, tag))
    x = torch.randn((n, dim), generator=gen, device=device).abs_()
    return x.bfloat16().float() if bf16_values else x


def distinct_offsets(rng: np.random.Generator, n: int, k: int, span: int
                     ) -> np.ndarray:
    """(n, k) distinct offsets in [1, span] per row, in random order."""
    off = np.sort(rng.integers(1, span - k + 2, size=(n, k)), axis=1)
    return rng.permuted(off + np.arange(k), axis=1)


def cx_data(cfg: dict, split: str, seed: int, device,
            with_features: bool = True) -> dict:
    sizes = cfg["data"][split]
    n_ex, n_img, k = sizes["n_examples"], sizes["n_images"], cfg["knn_size"]
    rng = seeds(seed, "cx/" + split)
    knn = ((np.arange(n_img)[:, None]
            + distinct_offsets(rng, n_img, k, n_img - 1)) % n_img)
    img = rng.integers(0, n_img, n_ex)
    image_idxs = np.concatenate([img[:, None], knn[img]], 1).astype(np.int32)
    return {
        "features": features(n_img, cfg["model"]["fusion"]["dim_v"], seed,
                             "cx/features/" + split, device, True)
        if with_features else None,
        "image_idxs": image_idxs,
        "question_wids": questions(rng, n_ex, cfg),
        "answer_aids": zipf(rng, cfg["nans"], cfg["questions"]["answer_zipf_s"],
                            n_ex),
        "comp_idxs": rng.integers(0, k, n_ex).astype(np.int32),
    }


def vqa_data(cfg: dict, split: str, seed: int, device,
             with_features: bool = True) -> dict:
    sizes = cfg["data"][split]
    n_ex, n_img, nans = sizes["n_examples"], sizes["n_images"], cfg["nans"]
    qc = cfg["questions"]
    rng = seeds(seed, "vqa/" + split)
    ks = sorted(int(k) for k in qc["answers_per_question"])
    kp = np.array([qc["answers_per_question"][str(k)] for k in ks])
    n_ans = rng.choice(ks, size=n_ex, p=kp / kp.sum()).astype(np.int32)
    major = zipf(rng, nans, qc["answer_zipf_s"], n_ex)
    others = (major[:, None] + distinct_offsets(rng, n_ex, max(ks) - 1,
                                                nans - 1)) % nans
    ans_aids = np.concatenate([major[:, None], others], 1).astype(np.int32)
    ans_counts = np.zeros((n_ex, max(ks)), np.int32)
    for k in ks:
        ans_counts[n_ans == k, :k] = qc["answer_counts"][str(k)]
    feats = (features(n_img, cfg["model"]["fusion"]["dim_v"], seed,
                      "vqa/features/" + split, device, False).cpu()
             if with_features else None)
    return {
        "features": feats,
        "image_rows": rng.integers(0, n_img, n_ex).astype(np.int32),
        "question_wids": questions(rng, n_ex, cfg),
        "answer_aids": major,
        "ans_aids": ans_aids,
        "ans_counts": ans_counts,
        "ans_k": n_ans,
    }
