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
"""

from __future__ import annotations

import zlib

import numpy as np
import torch


def keep_mask(shape, keep_prob: float, generator: torch.Generator):
    """Boolean keep-mask + unbiased inverse scale for inverted dropout, as
    ``core/rng.keep_mask`` of the JAX package: 8 random bits per element,
    kept where ``bits < round(keep_prob * 256)``, scale ``256 / thresh``
    (exact for the reference rates: 0.75 -> 192/256).  Falls back to a
    Bernoulli draw with scale ``1 / keep_prob`` when the threshold rounds
    to 0 or 256.  Drawn on ``generator``'s device.

    Returns ``(mask, scale)``; apply as ``where(mask, x * scale, 0)``.
    """
    device = generator.device
    thresh = int(round(keep_prob * 256))
    if 0 < thresh < 256:
        bits = torch.randint(0, 256, tuple(shape), generator=generator,
                             device=device, dtype=torch.uint8)
        return bits < thresh, 256.0 / thresh
    u = torch.rand(tuple(shape), generator=generator, device=device)
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
