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
R=10, dmm=360) it is 2.65 GFLOP on about 7 MB, at MutanAtt's classifier
(B 128, dhv 620, dhq 310, R 5, dmm 510) 0.6 GFLOP on 5.1 MB: a few
microseconds of either, so the launch, the reads of W from L2 (every
64-row block of the batch reads all of it) and how many SMs get work
bound it.  As on the TPU, neither (B, R*dmm) projection reaches device
memory.  A cluster of CTAs owns a 64 x 64 output tile and splits the
ranks (:func:`tucker_plan`: clusters x CTAs up to 3 on each SM, 5 x 48
at B 512 and 5 x 16 at the classifier); each CTA streams x and W chunks
through a cp.async ring into wgmma, adds the biases, multiplies and
stages each rank's product in shared memory; then the cluster sums the
products in rank order through distributed shared memory and writes the
output once.  The sums have a fixed order and no atomics, so reruns are
bit-equal.  Rows of 720 bytes (dh 360) would take TMA; the cp.async ring
takes them by 16-byte copies and MutanAtt's rows of 1,240 and 620 bytes
by 4-byte ones, one code path for both.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...core import spans
from . import build

_BF16 = torch.bfloat16
_SMEM_MAX = 232448          # the H100's per-block shared memory limit
_SLOTS = 3 * 132            # CTAs resident at once: 3 on each of 132 SMs
_MAX_CL = 8                 # the portable cluster size


def mutan_smem(rg: int) -> int:
    """A CTA's shared memory (bytes, with the alignment slack): a ring of
    two 16 KB stages (an x and a W chunk) and ``rg`` staged (64, 72) f32
    product tiles.  Mirrors ``mutan_bytes`` in ``csrc/mutan.cu``."""
    return 1024 + 2 * 16384 + rg * 64 * 72 * 4


def tucker_plan(batch: int, dhv: int, dhq: int, rank: int, dmm: int):
    """The kernel's launch plan (pure Python; ``csrc/mutan.cu`` takes it as
    given): ``cl`` CTAs a cluster (at most 8), ``rg`` ranks each (``cl =
    ceil(R / rg)``: no CTA without a rank), its ``smem`` (3 CTAs share an
    SM at MutanNoAtt's and MutanAtt's shapes) and the ``grid`` (CTAs).
    Clusters own the 64 x 64 output tiles; ``cl`` is the most that keeps
    the grid within 3 CTAs on each SM (at least 1, at most R), or more
    where the ranks' product tiles would not fit.  ValueError when R needs
    more than 8 CTAs of ranks whose tiles fit."""
    tiles = -(-batch // 64) * -(-dmm // 64)
    rg_max = max([rg for rg in range(1, rank + 1)
                  if mutan_smem(rg) <= _SMEM_MAX], default=0)
    if rg_max == 0 or -(-rank // rg_max) > _MAX_CL:
        raise ValueError("tucker_fusion: R %d needs more than %d CTAs a "
                         "cluster (at most %d ranks' product tiles fit one)"
                         % (rank, _MAX_CL, rg_max))
    cl = min(rank, _MAX_CL, max(1, _SLOTS // tiles))
    rg = min(-(-rank // cl), rg_max)
    cl = -(-rank // rg)
    return {"cl": cl, "rg": rg, "smem": mutan_smem(rg),
            "grid": cl * tiles}


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
    plan = _plan(batch, dhv, dhq, rank, dmm)
    lib = _lib()
    out = torch.empty((batch, dmm), dtype=torch.float32, device=x_v.device)
    rc = lib.vqacx_mutan_fwd(build.ptr(x_v), build.ptr(x_q), build.ptr(w_v),
                             build.ptr(b_v), build.ptr(w_q), build.ptr(b_q),
                             build.ptr(out), batch, dhv, dhq, rank, dmm,
                             plan["cl"], plan["rg"],
                             build.stream_of(x_v.device))
    build.check(lib, rc, "tucker_fusion")
    spans.count("kernels.launches.mutan")
    return out


spans.declare("kernels.launches.mutan")
# the wrapper's plans, once per shape (it never modifies them)
_plan = functools.lru_cache(maxsize=64)(tucker_plan)


def _lib():
    lib = build.load("mutan")
    fn = lib.vqacx_mutan_fwd
    if fn.argtypes is None:
        lib.vqacx_mutan_smem.argtypes = [ctypes.c_int]
        lib.vqacx_mutan_smem.restype = ctypes.c_size_t
        # the plan's shared memory is mutan_smem's: once, at load, held
        # equal to the kernel's own count
        for rg in (1, 2, 10):
            need = lib.vqacx_mutan_smem(rg)
            if need != mutan_smem(rg):
                raise RuntimeError(
                    "tucker_fusion: mutan_smem(%d) disagrees with "
                    "csrc/mutan.cu's %d bytes" % (rg, need))
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
