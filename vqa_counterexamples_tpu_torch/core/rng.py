"""Random streams for training (port of ``core/rng.py``).

Every random draw of a step comes from an explicit ``torch.Generator``,
one per consumer ("dropout", "lesion"), seeded from (seed, step, name)
before the step: no global RNG, so a step's masks depend only on those
three, and a resumed run redraws the masks it would have drawn.
Generators live on the device of the tensors they fill, so masks are drawn
there.  A step keeps its generators (:class:`StepGenerators`) and reseeds
them on the host before each call: a captured CUDA graph holds fixed
generator objects, and a replay copies a registered generator's seed and
offset into the graph in its prologue, so a replay draws what a freshly
seeded generator draws eagerly.

The JAX package draws with threefry (or the TPU's generator), this port
with PyTorch's (Philox on the card): the two never give the same bits from
one seed, so parity tests between them run with dropout off.

Under a data-parallel split (:func:`global_batch`) each rank holds some
rows of the batch; a draw is then made at the global batch's shape from
the same (seed, step, name) stream and the rank takes its own rows, so
every rank sees the masks of the one-rank run (JAX's mesh run draws at
the global shape too).  A draw's batch axis is its leading one, of B or
B x f rows (example-major, e.g. the att maps' B x 196 positions); the
GRU's per-gate masks (3, B, D) name theirs (axis 1).
"""

from __future__ import annotations

import contextlib
import threading
import zlib

import numpy as np
import torch


_SPLIT = threading.local()


@contextlib.contextmanager
def global_batch(n_global: int, start: int, n_local: int):
    """Draws inside are made for the ``n_global``-row batch, of which this
    rank holds rows ``[start, start + n_local)``."""
    prev = getattr(_SPLIT, "rows", None)
    _SPLIT.rows = (n_global, start, n_local)
    try:
        yield
    finally:
        _SPLIT.rows = prev


def global_draw(shape, draw, batch_axis: int = 0) -> torch.Tensor:
    """``draw(shape)``, or under :func:`global_batch` ``draw`` at the
    global batch's shape narrowed to this rank's rows on ``batch_axis``
    (B x f rows there: f per example)."""
    shape = tuple(shape)
    split = getattr(_SPLIT, "rows", None)
    if split is None:
        return draw(shape)
    n_global, start, n_local = split
    per, rem = divmod(shape[batch_axis], n_local)
    if rem or not per:
        raise ValueError("a draw of shape %s under a split of %d batch rows: "
                         "its axis %d is not the batch"
                         % (shape, n_local, batch_axis))
    full = shape[:batch_axis] + (n_global * per,) + shape[batch_axis + 1:]
    return draw(full).narrow(batch_axis, start * per, n_local * per)


def keep_mask(shape, keep_prob: float, generator: torch.Generator,
              batch_axis: int = 0):
    """Boolean keep-mask + unbiased inverse scale for inverted dropout, as
    ``core/rng.keep_mask`` of the JAX package: 8 random bits per element,
    kept where ``bits < round(keep_prob * 256)``, scale ``256 / thresh``
    (exact for the reference rates: 0.75 -> 192/256).  Falls back to a
    Bernoulli draw with scale ``1 / keep_prob`` when the threshold rounds
    to 0 or 256.  Drawn on ``generator``'s device, at the global batch's
    shape under :func:`global_batch` (``batch_axis``: the batch's axis).

    Returns ``(mask, scale)``; apply as ``where(mask, x * scale, 0)``.
    """
    device = generator.device
    thresh = int(round(keep_prob * 256))
    if 0 < thresh < 256:
        bits = global_draw(shape, lambda s: torch.randint(
            0, 256, s, generator=generator, device=device,
            dtype=torch.uint8), batch_axis)
        return bits < thresh, 256.0 / thresh
    u = global_draw(shape, lambda s: torch.rand(
        s, generator=generator, device=device), batch_axis)
    return u < keep_prob, 1.0 / keep_prob


def stream_seed(seed: int, step: int, name: str) -> int:
    """A 63-bit seed for the (seed, step, name) stream."""
    state = np.random.SeedSequence(
        [int(seed), int(step), zlib.crc32(name.encode())]).generate_state(
            2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def step_generators(seed: int, step: int, names, device
                    ) -> dict[str, torch.Generator]:
    """One freshly seeded generator per name for this step, on ``device``."""
    out = {}
    for name in names:
        gen = torch.Generator(device=device)
        gen.manual_seed(stream_seed(seed, step, name))
        out[name] = gen
    return out


class StepGenerators:
    """One persistent generator per name on ``device``, reseeded from
    (seed, step, name) before every step (:meth:`reseed`): the masks of a
    step are those of :func:`step_generators` for the same three."""

    def __init__(self, names, device):
        self.gens = {name: torch.Generator(device=device) for name in names}

    def __getitem__(self, name: str) -> torch.Generator:
        return self.gens[name]

    def values(self):
        return self.gens.values()

    def reseed(self, seed: int, step: int) -> None:
        for name, gen in self.gens.items():
            gen.manual_seed(stream_seed(seed, step, name))
