"""MUTAN's rank-R Tucker fusion kernel (CUDA, ``csrc/mutan.cu``) and its
plain PyTorch version.

Replaces the TPU kernel ``vqa_counterexamples_tpu/ops/pallas/
mutan_kernel.py`` ``tucker_rank_fusion_pallas`` (its ``_kernel``), reached
through ``ops/fusion.tucker_rank_fusion_auto`` from
``models/fusion.MutanFusion.forward`` in every VQA pretraining step and
evaluation batch::

    out = sum_r (x_v @ Wv_r^T + bv_r) * (x_q @ Wq_r^T + bq_r)

with bf16 operands (the compute policy's cast), f32 accumulation, f32
biases and an f32 output, as the JAX package's default XLA path
(``ops/fusion.tucker_rank_fusion``) computes it.  The weights come in the
reference's per-rank ``Linear`` layout stacked rank-major: Wv (R*dmm,
dhv), row ``r*dmm + m`` is output column m of rank r.

What bounds it on the H100: at VQA pretraining's shape (B=512, dh=360,
R=10, dmm=360) it is 2.65 GFLOP on about 7 MB: a few microseconds of
either, so a launch and its short waves bound it.  As on the TPU, neither
(B, R*dmm) projection reaches device memory: a block owns a (32 rows x 32
output columns) tile, loops over the ranks, runs both projections of its
tile on bf16 WMMA fragments with f32 accumulators, adds the biases and
accumulates the product into registers; the output is written once.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

_BF16 = torch.bfloat16


def tucker_fusion_plain(x_v: torch.Tensor, x_q: torch.Tensor,
                        w_v: torch.Tensor, b_v: torch.Tensor,
                        w_q: torch.Tensor, b_q: torch.Tensor,
                        rank: int) -> torch.Tensor:
    """Plain PyTorch version with the kernel's rounding points.

    x_v (B, dhv) and x_q (B, dhq) bf16; w_v (R*dmm, dhv) and w_q (R*dmm,
    dhq) bf16; b_v, b_q (R*dmm,) f32.  Returns (B, dmm) f32.
    """
    batch = x_v.shape[0]
    dmm = w_v.shape[0] // rank
    hv = torch.matmul(x_v.float(), w_v.float().t()) + b_v.float()
    hq = torch.matmul(x_q.float(), w_q.float().t()) + b_q.float()
    return torch.sum(hv.reshape(batch, rank, dmm)
                     * hq.reshape(batch, rank, dmm), dim=1)


def tucker_fusion(x_v: torch.Tensor, x_q: torch.Tensor, w_v: torch.Tensor,
                  b_v: torch.Tensor, w_q: torch.Tensor, b_q: torch.Tensor,
                  rank: int) -> torch.Tensor:
    """The fusion (see the module docstring).  On CPU tensors this is
    :func:`tucker_fusion_plain`; on CUDA tensors it launches the kernel or
    raises.  Forward only: the gradient is ``ops/fusion.TuckerFusion``'s."""
    build.refuse_grad("tucker_fusion", x_v, x_q, w_v, b_v, w_q, b_q)
    if x_v.device.type == "cpu":
        return tucker_fusion_plain(x_v, x_q, w_v, b_v, w_q, b_q, rank)
    batch, dhv = x_v.shape
    dhq = x_q.shape[1]
    rdmm = w_v.shape[0]
    dmm = rdmm // rank
    if (rdmm != rank * dmm or x_q.shape[0] != batch
            or tuple(w_v.shape) != (rdmm, dhv)
            or tuple(w_q.shape) != (rdmm, dhq)
            or tuple(b_v.shape) != (rdmm,) or tuple(b_q.shape) != (rdmm,)):
        raise ValueError("tucker_fusion: x_v %s x_q %s w_v %s w_q %s b_v %s "
                         "b_q %s, rank %d"
                         % tuple([tuple(t.shape) for t in
                                  (x_v, x_q, w_v, w_q, b_v, b_q)] + [rank]))
    if any(t.dtype != _BF16 for t in (x_v, x_q, w_v, w_q)) or any(
            t.dtype != torch.float32 for t in (b_v, b_q)):
        raise ValueError("tucker_fusion: x/w bf16 and biases f32")
    build.require_cuda("tucker_fusion", x_v, x_q, w_v, b_v, w_q, b_q)
    lib = _lib()
    out = torch.empty((batch, dmm), dtype=torch.float32, device=x_v.device)
    rc = lib.vqacx_mutan_fwd(build.ptr(x_v), build.ptr(x_q), build.ptr(w_v),
                             build.ptr(b_v), build.ptr(w_q), build.ptr(b_q),
                             build.ptr(out), batch, dhv, dhq, rank, dmm,
                             build.stream_of(x_v.device))
    build.check(lib, rc, "tucker_fusion")
    tucker_fusion.launches += 1
    return out


# one count per launch
tucker_fusion.launches = 0


def _lib():
    lib = build.load("mutan")
    fn = lib.vqacx_mutan_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
