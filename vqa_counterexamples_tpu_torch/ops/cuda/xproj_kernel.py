"""The GRU's input projection on the bf16 tensor cores (CUDA C++,
``csrc/xproj.cu``), forward and both gradients, their plain PyTorch
versions and the autograd Function that joins them.

Replaces no TPU kernel: the JAX package leaves the projection to XLA
(``vqa_counterexamples_tpu/ops/rnn.py``: ``_per_gate_x_proj``, one
``jnp.dot(..., preferred_element_type=f32)`` per gate, and the
shared-mask product in ``gru_scan``).  Reached from ``ops/rnn.gru_scan``
under the bf16 policy for every encoder pass: the forward alone when a
batch is evaluated or the question cache is built, all three when the
encoder trains.  Rows are time-major, r = t * B + b, x is read in its own
(B, T, D) layout, and the gates' columns are r, z, n of ``weight_ih``
(3H, D)::

    out[t, b, g] = bf16(bf16(x[b, t] * m_g[b]) @ bf16(W_g)^T + b_g)
    dx[b, t]     = sum_g m_g[b] * bf16(dG_g[t, b] @ bf16(W_g))        (f32)
    dW_g         = bf16(sum_{t,b} dG_g[t, b]^T bf16(x[b, t] * m_g[b]))  (f32)
    db_g         = sum_{t,b} dG_g[t, b]                               (f32)

with one mask per gate ((3, B, D)), one shared mask ((B, D): the same m
for every gate) or none; without per-gate masks the three gates are one
product over 3H, rounded once, as the plain composition computes them.
Every operand holds bf16 values (the rounded x * m and W; the cotangent
dG is the GRU backward's bf16 dxp), and their products are exact in f32,
so a bf16 product with f32 accumulation gives the plain composition's f32
sums in another order: the configuration's precision is kept.

What bounds them on the H100: at MutanNoAtt's shape (B 512, T 26, D 620,
3H 7,200) each product is 118.8 GFLOP, 0.12 ms at the bf16 tensor-core
peak, on 71-101 MB of operands and outputs (0.02-0.03 ms at 3.35 TB/s):
operations bound all three.  The plain composition runs them as f32
SGEMMs on the CUDA cores (no TF32: the benchmark turns it off) beside its
glue (the masks repeated per gate, the masked copies, casts, three f32
outputs, the bias adds, the ``cat``), 3.0-3.8 ms each on an H100.

Design (the kernels' own note is at the top of ``csrc/xproj.cu``): one
pack pass forms the bf16 operands, bf16(W) and bf16(x * m_g) of each mask
gate in time-major rows, padded from D to a multiple of 8 so that every
row starts on 16 bytes (D 620's bf16 rows are 1,240 bytes); then each
product is a wgmma GEMM of 128 x 128 tiles fed by a cp.async ring (its
depth and CTAs an SM fixed a product, from sweeps on an H100), whose
epilogue adds the bias and rounds (forward), rounds each gate's product
and folds the masks in the composition's autograd order, n, z, r, writing
x's (B, T, D) layout (dX), or rounds dW and sums db from the cotangent
tiles already in shared memory (dW).  The forward keeps the packed
operands for the backward when a gradient will be needed.  Sums run in
one fixed order: reruns are bit-equal, no atomics.
"""

from __future__ import annotations

import ctypes
import torch

from ...core import spans
from . import build

_BF16 = torch.bfloat16
_F32 = torch.float32


def _gates(mask: torch.Tensor | None) -> int:
    return 3 if mask is not None and mask.dim() == 3 else 1


def _gate_masks(mask, seq_len):
    """Each gate's mask repeated over the T time-major row blocks (f32),
    or None."""
    if mask is None:
        return (None, None, None)
    if mask.dim() == 2:
        m = mask.repeat(seq_len, 1)
        return (m, m, m)
    return tuple(mask[g].repeat(seq_len, 1) for g in range(3))


def x_proj_plain(x: torch.Tensor, mask: torch.Tensor | None,
                 weight_ih: torch.Tensor, bias_ih: torch.Tensor,
                 cdt: torch.dtype = _BF16) -> torch.Tensor:
    """Plain PyTorch version, the composition the kernels replace.

    x (B, T, D); mask (3, B, D), (B, D) or None; weight_ih (3H, D); bias_ih
    (3H,).  Operands rounded to ``cdt``, f32 accumulation and bias, one
    rounding to ``cdt``: (T, B, 3H) gate-major columns.  Under f32 the
    operands stay f32 (the f32 policy's projection)."""
    xt = x.transpose(0, 1)
    seq_len, batch, dim_in = xt.shape
    h3 = weight_ih.shape[0]
    dim_h = h3 // 3
    flat = xt.reshape(seq_len * batch, dim_in)

    def dot(a, w):
        if cdt != _F32:
            a, w = a.to(cdt).float(), w.to(cdt).float()
        return torch.matmul(a, w)

    if mask is None or mask.dim() == 2:
        if mask is not None:
            flat = flat * mask.repeat(seq_len, 1)
        proj = dot(flat, weight_ih.t()) + bias_ih
    else:
        proj = torch.cat([
            dot(flat * mask[g].repeat(seq_len, 1),
                weight_ih[g * dim_h:(g + 1) * dim_h].t())
            + bias_ih[g * dim_h:(g + 1) * dim_h] for g in range(3)], dim=-1)
    return proj.reshape(seq_len, batch, h3).to(cdt)


def x_proj_dx_plain(dout: torch.Tensor, mask: torch.Tensor | None,
                    weight_ih: torch.Tensor) -> torch.Tensor:
    """Plain version of dX: what autograd computes through
    :func:`x_proj_plain` (bf16) for x, op for op: each gate's f32 product
    dG_g @ bf16(W_g) rounded to bf16 (the backward of the operand's cast),
    times its mask, the gates summed n, z, r (autograd's order).  dout
    (T, B, 3H) bf16 -> dx (B, T, D) f32."""
    seq_len, batch, h3 = dout.shape
    dim_h = h3 // 3
    dg = dout.reshape(seq_len * batch, h3).float()
    w = weight_ih.to(_BF16).float()
    masks = _gate_masks(mask, seq_len)
    if _gates(mask) == 3:
        parts = [torch.matmul(dg[:, g * dim_h:(g + 1) * dim_h],
                              w[g * dim_h:(g + 1) * dim_h])
                 .to(_BF16).float() * masks[g] for g in range(3)]
        dflat = parts[2] + parts[1] + parts[0]
    else:
        dflat = torch.matmul(dg, w).to(_BF16).float()
        if mask is not None:
            dflat = dflat * masks[0]
    return dflat.reshape(seq_len, batch, -1).transpose(0, 1).contiguous()


def x_proj_operand_plain(x: torch.Tensor,
                         mask: torch.Tensor | None) -> torch.Tensor:
    """The rounded operand bf16(x * m_g) of each mask gate, time-major rows:
    (gates, T * B, D) bf16, gates 3 with per-gate masks, else 1 (what the
    forward kernel writes for dW)."""
    seq_len = x.shape[1]
    flat = x.transpose(0, 1).reshape(seq_len * x.shape[0], -1)
    masks = _gate_masks(mask, seq_len)
    return torch.stack([flat if m is None else flat * m
                        for m in masks[:_gates(mask)]]).to(_BF16)


def x_proj_dw_plain(dout: torch.Tensor, xm: torch.Tensor):
    """Plain version of dW and db: dW_g = (dG_g^T bf16(x * m_g)) rounded
    to bf16, both f32 (the weight's and the bias's dtype), as autograd
    computes them through :func:`x_proj_plain` (bf16).  dout (T, B, 3H)
    bf16, xm the operand (:func:`x_proj_operand_plain`) -> (dW (3H, D)
    f32, db (3H,) f32)."""
    seq_len, batch, h3 = dout.shape
    gates = xm.shape[0]
    cols = h3 // gates
    dg = dout.reshape(seq_len * batch, h3).float()
    dw = torch.cat([torch.matmul(dg[:, g * cols:(g + 1) * cols].t(),
                                 xm[g].float()) for g in range(gates)])
    return dw.to(_BF16).float(), dg.sum(dim=0)




def _padded(dim_in: int) -> int:
    """The packed operands' row length: D rounded up to a multiple of 8."""
    return -(-dim_in // 8) * 8


def _check(x, mask, weight_ih, bias_ih):
    batch, seq_len, dim_in = x.shape
    h3 = weight_ih.shape[0]
    if (h3 % 3 or tuple(weight_ih.shape) != (h3, dim_in)
            or tuple(bias_ih.shape) != (h3,)):
        raise ValueError("x_proj: x %s, weight_ih %s, bias_ih %s"
                         % (tuple(x.shape), tuple(weight_ih.shape),
                            tuple(bias_ih.shape)))
    if mask is not None and tuple(mask.shape) not in (
            (batch, dim_in), (3, batch, dim_in)):
        raise ValueError("x_proj: mask must be (B, D) or (3, B, D), got %s"
                         % (tuple(mask.shape),))
    for name, t in (("x", x), ("mask", mask), ("weight_ih", weight_ih),
                    ("bias_ih", bias_ih)):
        if t is not None and t.dtype not in (_F32, _BF16):
            raise ValueError("x_proj: %s must be f32 or bf16, got %s"
                             % (name, t.dtype))
        if t is not None and (t.device != x.device
                              or t.device.type != "cuda"):
            raise ValueError("x_proj: tensors must share one CUDA device, "
                             "got %s and %s" % (x.device, t.device))


def _check_dout(dout, dev):
    if (dout.dim() != 3 or dout.dtype != _BF16 or dout.device != dev
            or not dout.is_contiguous()):
        raise ValueError("x_proj: the cotangent must be (T, B, 3H) bf16, "
                         "contiguous, on %s; got %s %s on %s"
                         % (dev, tuple(dout.shape), dout.dtype, dout.device))


def _f32(t):
    return None if t is None else t.float().contiguous()


def _mask_gates(mask) -> int:
    return 0 if mask is None else (3 if mask.dim() == 3 else 1)


def _fwd(x, mask, weight_ih, bias_ih):
    """Pack the operands and launch the forward -> (out (T, B, 3H) bf16,
    bf16(x * m) (gates, T * B, D) and bf16(W) (3H, D): views of the packed
    rows, padded to a multiple of 8 so that they start on 16 bytes)."""
    _check(x, mask, weight_ih, bias_ih)
    x, m, w, b = _f32(x), _f32(mask), _f32(weight_ih), _f32(bias_ih)
    batch, seq_len, dim_in = x.shape
    h3, rows, gates = w.shape[0], batch * seq_len, _gates(mask)
    padded = _padded(dim_in)
    lib = _lib()
    stream = build.stream_of(x.device)
    xm = torch.empty((gates, rows, padded), dtype=_BF16, device=x.device)
    wp = torch.empty((h3, padded), dtype=_BF16, device=x.device)
    rc = lib.vqacx_xproj_pack(build.ptr(w), build.ptr(wp), h3, build.ptr(x),
                              build.ptr(m), build.ptr(xm), batch, seq_len,
                              dim_in, padded, gates, _mask_gates(mask),
                              stream)
    build.check(lib, rc, "x_proj (pack)")
    out = torch.empty((seq_len, batch, h3), dtype=_BF16, device=x.device)
    rc = lib.vqacx_xproj_fwd(build.ptr(xm), build.ptr(wp), build.ptr(b),
                             build.ptr(out), rows, padded, h3, gates,
                             stream)
    build.check(lib, rc, "x_proj")
    spans.count("kernels.launches.xproj")
    return out, xm[..., :dim_in], wp[:, :dim_in]


def _is_packed(t: torch.Tensor) -> bool:
    """Whether ``t`` is a bf16 view of whole packed rows (the forward's):
    its last dimension contiguous, rows a multiple of 8 apart, the base on
    16 bytes."""
    pitch = t.stride(-2)
    return (t.dtype == _BF16 and t.stride(-1) == 1 and pitch % 8 == 0
            and pitch >= t.shape[-1] and t.data_ptr() % 16 == 0
            and (t.dim() == 2 or t.stride(0) == t.shape[1] * pitch))


def _dx(dout, mask, wp):
    """Launch dX from the forward's packed bf16(W) (3H, D) -> dx (B, T, D)
    f32."""
    _check_dout(dout, wp.device)
    seq_len, batch, h3 = dout.shape
    if not _is_packed(wp) or wp.dim() != 2 or wp.shape[0] != h3:
        raise ValueError("x_proj_dx: W must be the forward's packed bf16 "
                         "rows (%d, D); got %s %s strides %s"
                         % (h3, tuple(wp.shape), wp.dtype, wp.stride()))
    dim_in = wp.shape[1]
    m = _f32(mask)
    dx = torch.empty((batch, seq_len, dim_in), dtype=_F32,
                     device=dout.device)
    lib = _lib()
    rc = lib.vqacx_xproj_dx(build.ptr(dout), build.ptr(wp), build.ptr(m),
                            build.ptr(dx), batch, seq_len, dim_in,
                            wp.stride(0), h3, _mask_gates(mask),
                            build.stream_of(dout.device))
    build.check(lib, rc, "x_proj_dx")
    spans.count("kernels.launches.xproj_dx")
    return dx


def _dw(dout, xm, want_db: bool):
    """Launch dW (and db) from the forward's packed bf16(x * m) (gates,
    T * B, D) -> (dW (3H, D) f32, db (3H,) f32 or None)."""
    _check_dout(dout, xm.device)
    seq_len, batch, h3 = dout.shape
    gates, rows, dim_in = xm.shape
    if (not _is_packed(xm) or rows != seq_len * batch
            or gates not in (1, 3)):
        raise ValueError("x_proj_dw: the operand must be the forward's "
                         "packed bf16 rows (gates, T * B, D) for a (%d, %d, "
                         "%d) cotangent; got %s %s strides %s"
                         % (seq_len, batch, h3, tuple(xm.shape), xm.dtype,
                            xm.stride()))
    dw = torch.empty((h3, dim_in), dtype=_F32, device=dout.device)
    db = torch.empty((h3,), dtype=_F32, device=dout.device) if want_db \
        else None
    lib = _lib()
    rc = lib.vqacx_xproj_dw(build.ptr(dout), build.ptr(xm), build.ptr(dw),
                            build.ptr(db), rows, dim_in, xm.stride(1), h3,
                            gates, build.stream_of(dout.device))
    build.check(lib, rc, "x_proj_dw")
    spans.count("kernels.launches.xproj_dw")
    return dw, db


class XProj(torch.autograd.Function):
    """The trainable projection: the forward packs bf16(x * m) and bf16(W)
    and keeps them for dW and dX.  Gradients reach x (f32),
    ``weight_ih`` and ``bias_ih`` (f32); the mask gets none."""

    @staticmethod
    def forward(ctx, x, mask, weight_ih, bias_ih):
        out, xm, wp = _fwd(x, mask, weight_ih, bias_ih)
        want_w = ctx.needs_input_grad[2] or ctx.needs_input_grad[3]
        ctx.save_for_backward(mask, wp, xm if want_w else None)
        ctx.dtypes = (x.dtype, weight_ih.dtype)
        return out

    @staticmethod
    def backward(ctx, dout):
        mask, wp, xm = ctx.saved_tensors
        dout = dout.to(_BF16).contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = x_proj_dx(dout, mask, wp).to(ctx.dtypes[0])
        if xm is not None:
            dw, db = x_proj_dw(dout, xm, ctx.needs_input_grad[3])
            dw = dw.to(ctx.dtypes[1])
        return dx, None, dw, db


def x_proj(x: torch.Tensor, mask: torch.Tensor | None,
           weight_ih: torch.Tensor, bias_ih: torch.Tensor) -> torch.Tensor:
    """The bf16 policy's input projections (T, B, 3H) bf16 of x (B, T, D)
    (see the module docstring).  On a CPU tensor this is
    :func:`x_proj_plain` under autograd; on a CUDA tensor it launches the
    pack pass and the forward, through :class:`XProj` when grad mode is on
    and an operand requires grad, or raises."""
    if x.device.type == "cpu":
        return x_proj_plain(x, mask, weight_ih, bias_ih)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, weight_ih, bias_ih)):
        return XProj.apply(x, mask, weight_ih, bias_ih)
    return _fwd(x, mask, weight_ih, bias_ih)[0]


def x_proj_dx(dout: torch.Tensor, mask: torch.Tensor | None,
              weight: torch.Tensor) -> torch.Tensor:
    """dX of the projection (:class:`XProj`'s backward) from the forward's
    packed bf16(W) (:func:`x_proj_dx_plain` on a CPU tensor, which takes
    ``weight_ih`` too)."""
    if dout.device.type == "cpu":
        return x_proj_dx_plain(dout, mask, weight)
    return _dx(dout.to(_BF16).contiguous(), mask, weight)


def x_proj_dw(dout: torch.Tensor, xm: torch.Tensor, want_db: bool = True):
    """dW and db of the projection (:class:`XProj`'s backward) from the
    forward's packed operand ``xm`` (:func:`x_proj_dw_plain` on a CPU
    tensor; db None unless ``want_db``)."""
    if dout.device.type == "cpu":
        dw, db = x_proj_dw_plain(dout, xm)
        return dw, (db if want_db else None)
    return _dw(dout.to(_BF16).contiguous(), xm, want_db)


spans.declare("kernels.launches.xproj", "kernels.launches.xproj_dx",
              "kernels.launches.xproj_dw")


def _lib():
    lib = build.load("xproj")
    if lib.vqacx_xproj_fwd.argtypes is None:
        c_p, c_i = ctypes.c_void_p, ctypes.c_int
        lib.vqacx_xproj_pack.argtypes = [c_p, c_p, c_i, c_p, c_p, c_p, c_i,
                                         c_i, c_i, c_i, c_i, c_i, c_p]
        lib.vqacx_xproj_fwd.argtypes = [c_p, c_p, c_p, c_p, c_i, c_i, c_i,
                                        c_i, c_p]
        lib.vqacx_xproj_dx.argtypes = [c_p, c_p, c_p, c_p, c_i, c_i, c_i,
                                       c_i, c_i, c_i, c_p]
        lib.vqacx_xproj_dw.argtypes = [c_p, c_p, c_p, c_p, c_i, c_i, c_i,
                                       c_i, c_i, c_p]
        for fn in (lib.vqacx_xproj_pack, lib.vqacx_xproj_fwd,
                   lib.vqacx_xproj_dx, lib.vqacx_xproj_dw):
            fn.restype = c_i
    return lib
