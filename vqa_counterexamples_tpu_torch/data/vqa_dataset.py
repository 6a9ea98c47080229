"""VQA classification dataset: processed examples + feature store -> batches
(numpy copy of ``data/vqa_dataset.py``; the CPU tests hold its batches to
the JAX package's bit for bit for one numpy ``rng``).

All question/answer tensors are precomputed as int32 arrays once.  With
the feature matrix on the device (the noatt case) a batch's visual rows
are gathered there by index; otherwise (att maps) the host gathers them,
the next batch's rows on one worker thread while the current batch is
consumed (the JAX package's thread path).  For a card the worker gathers
straight into two reused pinned buffers and the batch goes up on a copy
stream of its own (see :meth:`VQAArrays.batches`).
``samplingans=True`` draws the train answer from the human answers
weighted by occurrence count (reference ``vqa.py:62-76``).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch

from .features import FeatureStore

# host threads that copy one batch's att-map rows into a pinned buffer
GATHER_THREADS = 4


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
                device_features: torch.Tensor | None = None,
                device=None) -> Iterator[dict]:
        """Yield {visual, question, answer, question_id} batches (numpy,
        but ``visual`` a tensor when it is gathered or copied to a device).

        ``device_features``: the matrix on a device; a batch's rows are
        gathered there by ``index_select``.  Otherwise the host gathers the
        rows, the next batch's on a worker thread; with a CUDA ``device``
        into two reused pinned buffers, each batch then copied to the card
        on a side stream that the consuming stream waits for, and a buffer
        refilled only after its copy has finished.  Answers are sampled in
        batch order on the calling thread, so the ``rng`` draws are the
        same on every path."""
        rng = rng or np.random.default_rng()
        order = np.arange(self.size)
        if shuffle:
            rng.shuffle(order)
        starts = list(range(0, self.size, batch_size))
        if drop_remainder:
            starts = [s for s in starts if s + batch_size <= self.size]

        def assemble(s, visual):
            idx = order[s:s + batch_size]
            return {"question": self.question_wids[idx],
                    "answer": self.sample_answers(idx, rng),
                    "question_id": self.question_ids[idx],
                    "visual": visual}

        if device_features is not None:
            # the pass's row order goes to the device once: a batch's rows
            # are then sliced and gathered there, with no host-to-device
            # copy per batch (one from pageable memory waits for the card)
            dev = device_features.device
            rows_dev = torch.from_numpy(
                self.image_rows[order].astype(np.int64)).to(dev)
            for s in starts:
                yield assemble(s, device_features.index_select(
                    0, rows_dev[s:s + batch_size]))
            return
        if not starts:
            return
        rows = [self.image_rows[order[s:s + batch_size]] for s in starts]
        if device is not None and torch.device(device).type == "cuda":
            yield from self._pinned_batches(starts, rows, assemble,
                                            torch.device(device))
            return
        with ThreadPoolExecutor(max_workers=1) as pool:
            future = pool.submit(self.store.gather_rows, rows[0])
            for i, s in enumerate(starts):
                visual = future.result()
                if i + 1 < len(starts):
                    future = pool.submit(self.store.gather_rows, rows[i + 1])
                yield assemble(s, visual)

    def _pinned_batches(self, starts, rows, assemble, device):
        """The host gather for a card: batch i is gathered into pinned
        buffer i % 2 on the worker thread (its rows split over
        ``GATHER_THREADS`` copying threads), copied up on ``copy``; the
        consuming stream waits for the copy's event, and the worker waits
        for it before it refills that buffer (batch i + 2)."""
        shape = (len(rows[0]),) + self.store.row_shape
        bufs = [torch.empty(shape, dtype=torch.float32, pin_memory=True)
                for _ in range(2)]
        done = [None, None]
        copy = torch.cuda.Stream(device)

        def fill(i):
            if done[i % 2] is not None:
                done[i % 2].synchronize()
            out = bufs[i % 2][:len(rows[i])]
            host = out.numpy()
            parts = np.array_split(np.arange(len(rows[i])), GATHER_THREADS)
            list(gather.map(lambda p: self.store.gather_rows(
                rows[i][p], out=host[p[0]:p[-1] + 1]),
                [p for p in parts if len(p)]))
            return out

        with ThreadPoolExecutor(GATHER_THREADS) as gather, \
                ThreadPoolExecutor(max_workers=1) as pool:
            future = pool.submit(fill, 0)
            for i, s in enumerate(starts):
                host = future.result()
                consumer = torch.cuda.current_stream(device)
                with torch.cuda.stream(copy):
                    visual = host.to(device, non_blocking=True)
                    event = torch.cuda.Event()
                    event.record(copy)
                done[i % 2] = event
                consumer.wait_event(event)
                visual.record_stream(consumer)
                if i + 1 < len(starts):
                    future = pool.submit(fill, i + 1)
                yield assemble(s, visual)
