"""The GRU's input projection (``ops/cuda/xproj_kernel.py``) on the CPU:
its plain versions against the composition ``ops/rnn.gru_scan`` ran
before the projection had kernels, bit for bit, at the bf16 policy, in
the output and in the gradients of x, ``weight_ih`` and ``bias_ih``; and
which operands the kernels take as packed.  The kernels themselves are held to
the plain versions on the card (``tests/test_torch_cuda.py``)."""

import pytest
import torch

from vqa_counterexamples_tpu_torch.core.policy import dot_f32
from vqa_counterexamples_tpu_torch.ops import rnn
from vqa_counterexamples_tpu_torch.ops.cuda import xproj_kernel


def _composition(weight_ih, bias_ih, xt, mask_x, cdt):
    """``ops/rnn._x_proj`` as it stood before the kernels, verbatim."""
    seq_len, batch, dim_in = xt.shape
    h3 = weight_ih.shape[0]
    dim_h = h3 // 3
    flat = xt.reshape(seq_len * batch, dim_in)
    if mask_x is None or mask_x.dim() == 2:
        if mask_x is not None:
            flat = flat * mask_x.repeat(seq_len, 1)
        proj = dot_f32(flat, weight_ih.t()) + bias_ih
    else:
        proj = torch.cat([
            dot_f32(flat * mask_x[g].repeat(seq_len, 1),
                    weight_ih[g * dim_h:(g + 1) * dim_h].t())
            + bias_ih[g * dim_h:(g + 1) * dim_h] for g in range(3)], dim=-1)
    return proj.reshape(seq_len, batch, h3).to(cdt)


def _inputs(batch, seq_len, dim_in, dim_h, mask_kind, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(batch, seq_len, dim_in, generator=gen)
    w = torch.randn(3 * dim_h, dim_in, generator=gen) * dim_in ** -0.5
    b = torch.randn(3 * dim_h, generator=gen) * 0.1
    lead = {"none": None, "shared": (), "per_gate": (3,)}[mask_kind]
    mask = None
    if lead is not None:
        keep = torch.rand(lead + (batch, dim_in), generator=gen) > 0.25
        mask = keep.float() * (1.0 / 0.75)
    dout = (torch.randn(seq_len, batch, 3 * dim_h, generator=gen)
            * 1e-2).to(torch.bfloat16)
    return x, w, b, mask, dout


@pytest.mark.parametrize("shape", [(5, 4, 10, 6), (16, 7, 20, 12)],
                         ids=["ragged", "tile"])
@pytest.mark.parametrize("mask_kind", ["none", "shared", "per_gate"])
def test_plain_versions_equal_the_composition(monkeypatch, shape, mask_kind):
    """The wrapper's CPU route (``x_proj``, reached from ``gru_scan``), the
    plain dX and the plain dW / db over the plain operand give the
    composition's bits, outputs and gradients."""
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "bfloat16")
    x, w, b, mask, dout = _inputs(*shape, mask_kind)
    grads = []
    for route in ("composition", "wrapper"):
        xs, ws, bs = (t.clone().requires_grad_(True) for t in (x, w, b))
        if route == "composition":
            out = _composition(ws, bs, xs.transpose(0, 1), mask,
                               torch.bfloat16)
        else:
            out = xproj_kernel.x_proj(xs, mask, ws, bs)
        out.backward(dout)
        grads.append((out.detach(), xs.grad, ws.grad, bs.grad))
    (out_c, dx_c, dw_c, db_c), (out_w, dx_w, dw_w, db_w) = grads
    assert out_c.dtype == torch.bfloat16
    for got, want in ((out_w, out_c), (dx_w, dx_c), (dw_w, dw_c),
                      (db_w, db_c)):
        assert torch.equal(got, want)
    assert torch.equal(xproj_kernel.x_proj_dx_plain(dout, mask, w), dx_c)
    xm = xproj_kernel.x_proj_operand_plain(x, mask)
    assert xm.shape == (3 if mask_kind == "per_gate" else 1,
                        shape[0] * shape[1], shape[2])
    dw, db = xproj_kernel.x_proj_dw_plain(dout, xm)
    assert torch.equal(dw, dw_c) and torch.equal(db, db_c)
    assert torch.equal(xproj_kernel.x_proj_dx(dout, mask, w), dx_c)
    dw2, db2 = xproj_kernel.x_proj_dw(dout, xm)
    assert torch.equal(dw2, dw_c) and torch.equal(db2, db_c)


def test_f32_policy_keeps_the_composition(monkeypatch):
    """Under f32 ``gru_scan`` projects through the plain version with f32
    operands: the composition's bits, the recurrence unchanged."""
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "float32")
    x, w, b, mask, _ = _inputs(6, 5, 8, 4, "per_gate")
    want = _composition(w, b, x.transpose(0, 1), mask, torch.float32)
    got = xproj_kernel.x_proj_plain(x, mask, w, b, torch.float32)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    w_hh = torch.randn(12, 4, generator=torch.Generator().manual_seed(1))
    states = rnn.gru_scan(w, b, w_hh, torch.zeros(12), x, mask, None)
    assert torch.equal(states, rnn._gru_loop_f32(want, w_hh, torch.zeros(12),
                                                 None))


@pytest.mark.parametrize("dim_in", [620, 20, 36, 8])
def test_packed_rows_are_told_apart(dim_in):
    """dX and dW take the forward's packed operands as they are: bf16 views
    of rows padded to a multiple of 8 elements (16 bytes).  They refuse
    anything else, ``weight_ih`` itself among them unless its rows happen
    to be 16 bytes apart."""
    padded = xproj_kernel._padded(dim_in)
    assert padded % 8 == 0 and dim_in <= padded < dim_in + 8
    rows = torch.zeros(3, 10, padded, dtype=torch.bfloat16)
    assert xproj_kernel._is_packed(rows[..., :dim_in])
    assert xproj_kernel._is_packed(rows[0, :, :dim_in])
    assert not xproj_kernel._is_packed(rows[..., :dim_in].float())
    assert not xproj_kernel._is_packed(rows[..., ::2])
    weight = torch.zeros(12, dim_in, dtype=torch.bfloat16)
    assert xproj_kernel._is_packed(weight) == (dim_in % 8 == 0)
