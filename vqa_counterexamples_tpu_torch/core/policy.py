"""Compute-dtype policy for the hot GEMMs (port of ``core/policy.py``).

The policy casts *matmul operands* to the policy dtype while accumulating in
f32; params stay f32.  Default is float32 (reference numerics);
``VQACX_COMPUTE_DTYPE=bfloat16`` switches to bf16, and only then do the CUDA
kernels of this package engage (they are part of the bf16 policy, as their
TPU counterparts were).

The environment variable is read at call time, so a process (or a test's
``monkeypatch``) may set it after import.
"""

from __future__ import annotations

import os

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype() -> torch.dtype:
    return _DTYPES.get(os.environ.get("VQACX_COMPUTE_DTYPE", "float32"),
                       torch.float32)


def cast_in(*tensors):
    """Cast matmul operands to the policy dtype (no-op under f32)."""
    dt = compute_dtype()
    out = tuple(t if t.dtype == dt else t.to(dt) for t in tensors)
    return out if len(out) > 1 else out[0]


def pdot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Policy dot: operands in the policy dtype, f32 accumulation, and the
    output rounded once to the policy dtype (``jnp.dot(...,
    preferred_element_type=f32).astype(policy)``).  A bf16 ``torch.matmul``
    accumulates in f32 and rounds its output once on both the CPU and CUDA
    backends."""
    xc, wc = cast_in(x, w)
    return torch.matmul(xc, wc)


def dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Operands in the policy dtype, f32 accumulation, f32 OUTPUT — the
    JAX ``jnp.dot(cast_in(x), cast_in(w), preferred_element_type=f32)``
    that callers follow with an f32 bias add before any rounding.  The
    products of bf16 values are exact in f32, so upcasting the rounded
    operands and multiplying in f32 gives the same sums."""
    xc, wc = cast_in(x, w)
    if xc.dtype != torch.float32:
        xc, wc = xc.float(), wc.float()
    return torch.matmul(xc, wc)
