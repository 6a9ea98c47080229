"""VQA classification dataset: processed examples + feature store -> batches
(numpy copy of ``data/vqa_dataset.py``; the CPU tests hold its batches to
the JAX package's bit for bit for one numpy ``rng``).

All question/answer tensors are precomputed as int32 arrays once.  With
the feature matrix on the device (the noatt case) a batch's visual rows
are gathered there by index; otherwise (att maps) the host gathers them,
the next batch's rows while the current batch is consumed: through the
native C++ store's prefetch tickets where an ``.npy`` backs the store
(the JAX package's native path), else on a worker thread (its thread
path).  For a card the rows go straight into two reused pinned buffers and
the batch goes up on a copy stream of its own (see
:meth:`VQAArrays.batches`).
``samplingans=True`` draws the train answer from the human answers
weighted by occurrence count (reference ``vqa.py:62-76``).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch

from ..core import spans
from ..parallel.sharding import corpus_rows
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
                device=None, part: tuple | None = None) -> Iterator[dict]:
        """Yield {visual, question, answer, question_id} batches (numpy,
        but ``visual`` a tensor when it is gathered or copied to a device).

        ``device_features``: the matrix on a device; a batch's rows are
        gathered there by ``index_select``.  Otherwise the host gathers the
        rows, the next batch's ahead of time (through the native store
        where :attr:`gather_path` is ``"native"``, else on a worker
        thread); with a CUDA ``device`` into two reused pinned buffers,
        each batch then copied to the card on a side stream that the
        consuming stream waits for, and a buffer refilled only after its
        copy has finished.  Answers are sampled in
        batch order on the calling thread, so the ``rng`` draws are the
        same on every path.

        ``part=(i, n)``: only the i-th of n row ranges of each batch
        (``parallel.corpus_rows``' split: a data-parallel rank's rows);
        the answers are still sampled for the whole batch, so the draws
        are those of the whole, and the batch's ``rows`` entry holds
        (first row, batch size).

        On every path a batch's assembly (its answers, its rows' gather
        or copy) is the span ``data.batch`` (``core/spans``), closed
        before the batch is yielded."""
        rng = rng or np.random.default_rng()
        order = np.arange(self.size)
        if shuffle:
            rng.shuffle(order)
        starts = list(range(0, self.size, batch_size))
        if drop_remainder:
            starts = [s for s in starts if s + batch_size <= self.size]

        def span(s):
            """Rows [lo, hi) of the batch at ``s`` that this pass yields
            and the batch's size."""
            size = min(batch_size, self.size - s)
            if part is None:
                return 0, size, size
            lo, hi = corpus_rows(size, part[1])[part[0]]
            return lo, hi, size

        def assemble(s, visual):
            idx = order[s:s + batch_size]
            answers = self.sample_answers(idx, rng)
            lo, hi, size = span(s)
            out = {"question": self.question_wids[idx][lo:hi],
                   "answer": answers[lo:hi],
                   "question_id": self.question_ids[idx][lo:hi],
                   "visual": visual}
            if part is not None:
                out["rows"] = (lo, size)
            return out

        if device_features is not None:
            # the pass's row order goes to the device once: a batch's rows
            # are then sliced and gathered there, with no host-to-device
            # copy per batch (one from pageable memory waits for the card)
            dev = device_features.device
            rows_dev = torch.from_numpy(
                self.image_rows[order].astype(np.int64)).to(dev)
            for s in starts:
                with spans.span("data.batch"):
                    lo, hi, _ = span(s)
                    batch = assemble(s, device_features.index_select(
                        0, rows_dev[s + lo:s + hi]))
                yield batch
            return
        if not starts:
            return
        rows = [self.image_rows[order[s + span(s)[0]:s + span(s)[1]]]
                for s in starts]
        if device is not None and torch.device(device).type == "cuda":
            yield from self._pinned_batches(starts, rows, assemble,
                                            torch.device(device))
            return
        store = self.store
        if store.gather_path == "native":
            def start(i):
                buf = np.empty((len(rows[i]),) + store.row_shape,
                               store.dtype)
                return _ticket(store, store.prefetch_rows(rows[i], buf), buf)

            yield from _ahead(len(starts), start,
                              lambda i, visual: assemble(starts[i], visual))
            return
        with ThreadPoolExecutor(max_workers=1) as pool:
            yield from _ahead(
                len(starts),
                lambda i: pool.submit(store.gather_rows, rows[i]).result,
                lambda i, visual: assemble(starts[i], visual))

    @property
    def gather_path(self) -> str:
        """Which host gather serves the att-map batches: ``"native"`` (the
        C++ store's prefetch tickets) or ``"numpy"``."""
        return self.store.gather_path

    def _pinned_batches(self, starts, rows, assemble, device):
        """The host gather for a card: batch i is gathered into pinned
        buffer i % 2 (by a native prefetch ticket, or on a worker thread
        whose rows are split over ``GATHER_THREADS`` copying threads),
        copied up on ``copy``; the consuming stream waits for the copy's
        event, and the buffer is refilled (batch i + 2) only after that
        copy has finished."""
        store = self.store
        shape = (len(rows[0]),) + store.row_shape
        dtype = torch.bfloat16 if store.dtype.itemsize == 2 else torch.float32
        bufs = [torch.empty(shape, dtype=dtype, pin_memory=True)
                for _ in range(2)]
        done = [None, None]
        copy = torch.cuda.Stream(device)

        def host_rows(i):
            """Buffer i % 2 as the numpy array batch i is gathered into,
            once the copy of the batch it held (i - 2) has finished."""
            if done[i % 2] is not None:
                done[i % 2].synchronize()
            out = bufs[i % 2][:len(rows[i])]
            view = out.view(torch.int16) if out.dtype == torch.bfloat16 \
                else out
            return out, view.numpy().view(store.dtype)

        def prefetch(i):
            out, host = host_rows(i)
            return _ticket(store, store.prefetch_rows(rows[i], host), out)

        def fill(i):
            out, host = host_rows(i)
            parts = np.array_split(np.arange(len(rows[i])), GATHER_THREADS)
            list(gather.map(lambda p: store.gather_rows(
                rows[i][p], out=host[p[0]:p[-1] + 1]),
                [p for p in parts if len(p)]))
            return out

        def ship(i, out):
            consumer = torch.cuda.current_stream(device)
            with torch.cuda.stream(copy):
                visual = out.to(device, non_blocking=True)
                event = torch.cuda.Event()
                event.record(copy)
            done[i % 2] = event
            consumer.wait_event(event)
            visual.record_stream(consumer)
            return assemble(starts[i], visual)

        with ThreadPoolExecutor(GATHER_THREADS) as gather, \
                ThreadPoolExecutor(max_workers=1) as pool:
            start = (prefetch if store.gather_path == "native"
                     else lambda i: pool.submit(fill, i).result)
            yield from _ahead(len(starts), start, ship)


def _ticket(store: FeatureStore, ticket, out):
    """A fetch that waits for a native prefetch ``ticket`` and gives
    ``out``, the buffer it writes."""
    def finish():
        store.wait_rows(ticket)
        return out
    return finish


def _ahead(n: int, start, make):
    """Yield ``make(i, start(i)())`` for i < n, the fetch of batch i + 1
    started before batch i is made and handed out.  ``start(i)`` begins a
    fetch and returns the call that finishes it.  A fetch in flight is
    finished before the generator lets go of it, also when the consumer
    closes the generator early: a native ticket must not outlive the
    buffer it writes.  Each item's wait, next start and make are the span
    ``data.batch``, closed before the item is handed out."""
    pending = start(0)
    try:
        for i in range(n):
            with spans.span("data.batch"):
                fetched, pending = pending(), None
                if i + 1 < n:
                    pending = start(i + 1)
                batch = make(i, fetched)
            yield batch
    finally:
        if pending is not None:
            pending()
