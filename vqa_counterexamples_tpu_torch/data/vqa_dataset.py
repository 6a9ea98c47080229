"""VQA classification dataset: processed examples + feature store -> batches
(numpy copy of ``data/vqa_dataset.py``; the CPU tests hold its batches to
the JAX package's bit for bit for one numpy ``rng``).

All question/answer tensors are precomputed as int32 arrays once.  With
the feature matrix on the device (the noatt case) a batch's visual rows
are gathered there by index; otherwise the host gathers them (no prefetch
thread: the att-map stream that needs one is not ported).
``samplingans=True`` draws the train answer from the human answers
weighted by occurrence count (reference ``vqa.py:62-76``).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from .features import FeatureStore


class VQAArrays:
    def __init__(self, examples: list, store: FeatureStore,
                 samplingans: bool = False):
        self.examples = examples
        self.store = store
        self.samplingans = samplingans
        n = len(examples)
        maxlength = len(examples[0]["question_wids"])
        self.question_wids = np.empty((n, maxlength), dtype=np.int32)
        self.answer_aids = np.empty((n,), dtype=np.int32)
        self.image_rows = np.empty((n,), dtype=np.int32)
        self.question_ids = np.empty((n,), dtype=np.int64)
        # ragged answer-occurrence lists for sampling
        self._ans_aid: list = []
        self._ans_p: list = []
        for i, ex in enumerate(examples):
            self.question_wids[i] = ex["question_wids"]
            self.answer_aids[i] = ex.get("answer_aid", 0)
            self.image_rows[i] = store.name_to_index[ex["image_name"]]
            self.question_ids[i] = ex["question_id"]
            if samplingans and ex.get("answers_aid"):
                counts = np.asarray(ex["answers_count"], dtype=np.float64)
                self._ans_aid.append(np.asarray(ex["answers_aid"],
                                                dtype=np.int32))
                self._ans_p.append(counts / counts.sum())
            else:
                self._ans_aid.append(None)
                self._ans_p.append(None)

    @property
    def size(self) -> int:
        return self.question_wids.shape[0]

    def sample_answers(self, idx: np.ndarray,
                       rng: np.random.Generator) -> np.ndarray:
        out = self.answer_aids[idx].copy()
        if self.samplingans:
            for j, i in enumerate(idx):
                if self._ans_aid[i] is not None:
                    out[j] = rng.choice(self._ans_aid[i], p=self._ans_p[i])
        return out

    def batches(self, batch_size: int, *, shuffle: bool = True,
                rng: np.random.Generator | None = None,
                drop_remainder: bool = False,
                device_features: torch.Tensor | None = None
                ) -> Iterator[dict]:
        """Yield {visual, question, answer, question_id} batches (numpy,
        but ``visual`` a tensor gathered on ``device_features``' device by
        ``index_select`` when the matrix is given there)."""
        rng = rng or np.random.default_rng()
        order = np.arange(self.size)
        if shuffle:
            rng.shuffle(order)
        starts = list(range(0, self.size, batch_size))
        if drop_remainder:
            starts = [s for s in starts if s + batch_size <= self.size]
        if device_features is not None:
            # the pass's row order goes to the device once: a batch's rows
            # are then sliced and gathered there, with no host-to-device
            # copy per batch (one from pageable memory waits for the card)
            dev = device_features.device
            rows_dev = torch.from_numpy(
                self.image_rows[order].astype(np.int64)).to(dev)
        for s in starts:
            idx = order[s:s + batch_size]
            if device_features is None:
                visual = self.store.features[self.image_rows[idx]]
            else:
                visual = device_features.index_select(
                    0, rows_dev[s:s + batch_size])
            yield {"question": self.question_wids[idx],
                   "answer": self.sample_answers(idx, rng),
                   "question_id": self.question_ids[idx],
                   "visual": visual}
