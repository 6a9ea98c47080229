"""Exact brute-force k-nearest-neighbour search (port of ``ops/topk.py``).

``knn`` drives query chunks against the whole corpus on one device: on the
card the fused distance + top-k kernel (``ops/cuda/knn_kernel.py``) by
default, ``engine="plain"`` its plain version (one f32 GEMM + ``topk``,
JAX's ``xla`` engine); on the CPU the plain version.  Distances ascend
euclidean, as sklearn's ``kneighbors`` (so index 0 is the query itself in a
self-kNN).  ``approx`` (the TPU's ``approx_max_k``) and a corpus sharded
over a mesh are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from .cuda import knn_kernel

ENGINES = ("cuda", "plain")


def windows(n: int, chunk: int):
    """Full-``chunk``-size windows covering [0, n) (``ops/chunking``):
    (start, offset), ``offset`` leading rows of the window repeating the
    previous one (only the tail window, shifted back, overlaps)."""
    for i in range(0, n, chunk):
        s = min(i, max(n - chunk, 0))
        yield s, i - s


def knn(features, k: int = 25, queries=None, batch_size: int = 1024,
        engine: str = "cuda", approx: bool = False, mesh=None,
        device=None):
    """k-NN of every query row against ``features`` (the corpus, (N, D));
    ``queries`` defaults to the corpus itself.  Arrays (numpy or tensors)
    go to ``device`` in f32: by default the corpus tensor's own device,
    else the card (as JAX's ``topk.knn`` runs on the default device, the
    accelerator); with no CUDA device visible that default raises, and the
    CPU must be asked for with ``device="cpu"``.  The corpus's squared
    norms are computed once.  Returns numpy (dist (Nq, k) f32, idx (Nq, k)
    int32)."""
    if approx:
        raise NotImplementedError("approximate top-k (the TPU's "
                                  "approx_max_k) is not ported (ROADMAP.md, "
                                  "Queue 1)")
    if mesh is not None:
        raise NotImplementedError("a corpus sharded over a mesh is not "
                                  "ported (ROADMAP.md, Queue 1)")
    if engine not in ENGINES:
        raise ValueError("engine %r: one of %s" % (engine, ENGINES))
    if device is None:
        if isinstance(features, torch.Tensor):
            device = features.device
        elif torch.cuda.is_available():
            device = torch.device("cuda")
        else:
            raise RuntimeError("no CUDA device is visible: the port runs on "
                               "the card; pass device=\"cpu\" to run on the "
                               "CPU")

    def to_dev(a):
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(a, np.float32))
        return t.to(device=device, dtype=torch.float32).contiguous()

    corpus = to_dev(features)
    qs = corpus if queries is None else to_dev(queries)
    csq = (corpus * corpus).sum(1)
    chunk_fn = (knn_kernel.knn_chunk if engine == "cuda"
                else knn_kernel.knn_chunk_plain)
    n = qs.shape[0]
    size = min(batch_size, n)
    dists, idxs = [], []
    for s, off in windows(n, size):
        dist, idx = chunk_fn(qs[s:s + size], corpus, k, corpus_sqnorm=csq)
        dists.append(dist[off:])
        idxs.append(idx[off:])
    return (torch.cat(dists).cpu().numpy(),
            torch.cat(idxs).cpu().numpy())
