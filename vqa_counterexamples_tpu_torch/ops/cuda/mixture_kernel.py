"""Frozen answer head fused with its softmax (CUDA, ``csrc/mixture.cu``)
and its plain PyTorch version.

Replaces the TPU kernel
``vqa_counterexamples_tpu/ops/pallas/mixture_kernel.py``
``classify_softmax_pallas``, reached from ``ops/scorer.first_layer_decomposed``
under the bf16 policy with a frozen backbone::

    l = bf16(bf16(z @ W_cls^T) + bf16(b))
    u = bf16(exp(bf16(l - rowmax(l)))),  s = rowsum_f32(u)
    probs = bf16(u * bf16(1 / s))

What bounds it on the H100: the (M, A) bf16 output.  At the CX path's
shape (M 18432, dz 360, A 2000) it is 74 MB, 22 us at 3.35 TB/s, against
26.5 GFLOP, 27 us at the bf16 tensor-core peak: the function is as much
bytes as operations, so the output must be written once and never read
back.  The kernel (``csrc/mixture.cu``) keeps each 64-row block's logits on
chip until its softmax is done: W_cls (1.44 MB, L2-resident) does not fit
a block's 227 KB of shared memory, and a 64-row block's bf16 logits over
2000 answers (256 KB) do not either, so a cluster of CTAs splits the
answer axis (four CTAs of 512 columns at A 2000; :func:`mixture_plan`).
Each CTA loads its z rows once with TMA, streams W through a TMA ring into
wgmma, keeps its bf16 logits in shared memory, and trades the per-row max
and then the per-row sum with the other CTAs of its cluster through
distributed shared memory.  The three steps keep the JAX rounding points
(an online softmax would not: it rescales u by the max seen so far);
every sum is taken in one fixed order, so reruns are bit-equal.  The
probabilities leave shared memory once, by TMA stores.  The ragged answer
edge is masked instead of padded with a -1e9 bias.  What holds it back
now is W: every 64-row block streams all of it from L2, 384 KB into each
CTA, and a CTA runs its product, its softmax and its stores in turn, one
CTA on an SM (``PERF.md`` §6).

Forward only: the head is frozen, so callers treat probs as a constant,
and the wrapper refuses an operand that requires grad.
"""

from __future__ import annotations

import ctypes

import torch

from ...core import spans
from . import build

_BF16 = torch.bfloat16
_SMEM_MAX = 232448          # the H100's per-block shared memory limit
_BN = 256                   # answers per W tile (csrc/mixture.cu BN)


def mixture_smem(kc: int, cw: int, stages: int) -> int:
    """Shared memory of one CTA (bytes, with the 1024-byte alignment
    slack): ``kc`` z chunks and ``cw / 64`` logit panels of 8 KB, a ring of
    32 KB W stages, five f32 row vectors of 64, the bias slice in bf16 and
    the mbarriers.  Mirrors ``mix_smem`` in ``csrc/mixture.cu`` (the two
    are held equal when the library loads)."""
    return (1024 + (kc + cw // 64) * 8192 + stages * 32768 + 5 * 64 * 4
            + cw * 2 + (1 + 2 * stages) * 8)


MAX_STAGES = 8


def mixture_plan(dim_z: int, n_ans: int):
    """(cl, cw, stages) for dz and A: clusters of ``cl`` CTAs (2, 4 or 8)
    split the answers, ``cw`` each (a multiple of 256), with a W ring of
    ``stages``.  The smallest ``cl`` whose CTA holds its z rows, its logits
    and a ring of at least 3 stages (else 2), as many stages as fit up to
    MAX_STAGES.  ValueError if none fits."""
    kc = -(-dim_z // 64)
    for min_stages in (3, 2):
        for c in (2, 4, 8):
            cw = -(-(-(-n_ans // c)) // _BN) * _BN
            fit = [st for st in range(MAX_STAGES, min_stages - 1, -1)
                   if mixture_smem(kc, cw, st) <= _SMEM_MAX]
            if fit:
                return c, cw, fit[0]
    raise ValueError("classify_softmax: dz %d, A %d do not fit the kernel's "
                     "shared memory (z rows, 1/8 of the logits, two stages)"
                     % (dim_z, n_ans))


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
    cl, cw, stages = mixture_plan(dim_z, n_ans)
    lib = _lib()
    out = torch.empty((rows, n_ans), dtype=_BF16, device=z.device)
    rc = lib.vqacx_mixture_fwd(build.ptr(z), rows, dim_z, build.ptr(w_cls),
                               build.ptr(b_cls), n_ans, build.ptr(out), cl,
                               cw, stages, build.stream_of(z.device))
    build.check(lib, rc, "classify_softmax")
    spans.count("kernels.launches.mixture")
    return out


spans.declare("kernels.launches.mixture")


def _lib():
    lib = build.load("mixture")
    fn = lib.vqacx_mixture_fwd
    if fn.argtypes is None:
        c_p, c_i = ctypes.c_void_p, ctypes.c_int
        lib.vqacx_mixture_smem.argtypes = [c_i, c_i, c_i]
        lib.vqacx_mixture_smem.restype = c_i
        # the plan's shared memory is mixture_smem's: once, at load, it is
        # held equal to the kernel's own count over the plans' range
        for kc, cw, stages in ((1, 256, 2), (6, 512, 3), (6, 256, 4),
                               (8, 1024, 2), (4, 768, 8)):
            need = lib.vqacx_mixture_smem(kc, cw, stages)
            if need != mixture_smem(kc, cw, stages):
                raise RuntimeError(
                    "classify_softmax: mixture_smem(%d, %d, %d) disagrees "
                    "with csrc/mixture.cu's %d bytes"
                    % (kc, cw, stages, need))
        fn.argtypes = [c_p, c_i, c_i, c_p, c_p, c_i, c_p, c_i, c_i, c_i, c_p]
        fn.restype = ctypes.c_int
    return lib
