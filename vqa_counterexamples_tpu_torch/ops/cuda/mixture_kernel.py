"""Frozen answer head fused with its softmax (CUDA, ``csrc/mixture.cu``)
and its plain PyTorch version.

Replaces the TPU kernel
``vqa_counterexamples_tpu/ops/pallas/mixture_kernel.py``
``classify_softmax_pallas``, reached from ``ops/scorer.first_layer_decomposed``
under the bf16 policy with a frozen backbone::

    l = bf16(bf16(z @ W_cls^T) + bf16(b))
    u = bf16(exp(bf16(l - rowmax(l)))),  s = rowsum_f32(u)
    probs = bf16(u * bf16(1 / s))

What bounds it on the H100: the GEMM is small (M=18432, dz=360, A=2000:
26.5 GFLOP), so the (M, A) bf16 output — 74 MB written once and read and
rewritten twice by its own block — dominates.  W_cls (1.44 MB bf16) does
not fit in the 227 KB of shared memory a block may use, unlike the TPU's
VMEM, so each block owns 64 rows and walks the answer axis in 64-column
tiles in three sweeps: (1) the GEMM tile on bf16 WMMA fragments, rounded
and biased, written to the output while the row max is taken; (2) u in
place, with the f32 row sum; (3) the scale by the bf16 reciprocal.  The
three sweeps keep the JAX rounding points exactly (an online softmax would
not).  Every element a thread touches in sweeps 2 and 3 is one it wrote in
sweep 1, and a warp walks a row's columns contiguously, so the re-reads
are coalesced and mostly served from L2.  The ragged answer edge is masked
instead of padded with a -1e9 bias.

Forward only: the head is frozen, so callers treat probs as a constant,
and the wrapper refuses an operand that requires grad.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

_BF16 = torch.bfloat16


def classify_softmax_plain(z: torch.Tensor, w_cls: torch.Tensor,
                           b_cls: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: z (M, dz); w_cls (A, dz) (``Linear.weight``
    layout); b_cls (A,) -> probs (M, A) bf16."""
    logits = torch.matmul(z.to(_BF16), w_cls.to(_BF16).t()) + b_cls.to(_BF16)
    m = logits.amax(dim=1, keepdim=True)
    u = torch.exp(logits - m)
    s = u.sum(dim=1, keepdim=True, dtype=torch.float32)
    return u * (1.0 / s).to(_BF16)


def classify_softmax(z: torch.Tensor, w_cls: torch.Tensor,
                     b_cls: torch.Tensor) -> torch.Tensor:
    """softmax(z @ W_cls^T + b) per row (see the module docstring).  On a
    CPU tensor this is :func:`classify_softmax_plain`; on a CUDA tensor it
    launches the kernel or raises.  Forward only: an operand that requires
    grad (with grad mode on) raises."""
    build.refuse_grad("classify_softmax", z, w_cls, b_cls)
    if z.device.type == "cpu":
        return classify_softmax_plain(z, w_cls, b_cls)
    rows, dim_z = z.shape
    n_ans = w_cls.shape[0]
    if tuple(w_cls.shape) != (n_ans, dim_z) or tuple(b_cls.shape) != (n_ans,):
        raise ValueError("classify_softmax: z %s, w_cls %s, b_cls %s"
                         % (tuple(z.shape), tuple(w_cls.shape),
                            tuple(b_cls.shape)))
    if z.dtype != _BF16 or w_cls.dtype != _BF16 or b_cls.dtype != _BF16:
        raise ValueError("classify_softmax: z, w_cls and b_cls must be bf16")
    build.require_cuda("classify_softmax", z, w_cls, b_cls)
    lib = _lib()
    out = torch.empty((rows, n_ans), dtype=_BF16, device=z.device)
    rc = lib.vqacx_mixture_fwd(build.ptr(z), rows, dim_z, build.ptr(w_cls),
                               build.ptr(b_cls), n_ans, build.ptr(out),
                               build.stream_of(z.device))
    build.check(lib, rc, "classify_softmax")
    classify_softmax.launches += 1
    return out


classify_softmax.launches = 0


def _lib():
    lib = build.load("mixture")
    fn = lib.vqacx_mixture_fwd
    if fn.argtypes is None:
        c_p, c_i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [c_p, c_i, c_i, c_p, c_p, c_i, c_p, c_p]
        fn.restype = ctypes.c_int
    return lib
