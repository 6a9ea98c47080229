"""Seeded weights, made on the device in one draw: one ``randn`` over
every parameter, each leaf a view of it scaled by its standard deviation.
Both sides get the same tensors: the program copies them into its modules
(``load_state_dict``), the reference reads them."""

from __future__ import annotations

import math

import torch

from perfbench.traffic.generate import torch_seed


def make(specs: list, seed: int, device, tag: str = "weights") -> dict:
    """``specs``: (name, shape, std) -> {name: f32 tensor on ``device``}."""
    total = sum(math.prod(shape) for _, shape, _ in specs)
    gen = torch.Generator(device=device)
    gen.manual_seed(torch_seed(seed, tag))
    flat = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    for name, shape, std in specs:
        n = math.prod(shape)
        out[name] = flat[off:off + n].view(shape).mul_(std)
        off += n
    return out
