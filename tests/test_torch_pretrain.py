"""VQA pretraining in the PyTorch port against the JAX package: the GRU's
per-gate forward and its backward, the variational masks, MUTAN's Tucker
fusion, MutanNoAtt, the train step, trajectories, Adam carried across,
the data, the checkpoints and the CLI.

Sizes are small: BayesianUniSkip 16 -> GRU 48, MUTAN R 3 with dims 24,
dim_v 24, 20 answers, T 10 (the synthetic questions reach 9 words), B 16.  The same weights go to both packages
through ``models/port_torch`` / ``models/from_jax``.  Parity runs of the
model and the step have every dropout at 0 (the two frameworks draw
different bits from one seed); the dropout math itself is checked by
handing the same numpy masks to both (``gru_scan`` with injected masks).

Tolerances: f32 within rtol 1e-4 (params after Adam 1e-6 abs where the
gradient is away from Adam's eps, see ``_assert_adam_close``); bf16
within 5e-2, with the JAX side running its Pallas kernels in interpret
mode (``VQACX_GRU_PALLAS=interpret``) and the port its kernels' plain
versions, as the JAX package bounds its own bf16 paths
(tests/test_pallas_gru.py).  Kernel-level bf16 comparisons hold bf16
cotangents that come from f32 sums in another order to 2e-2 of the
tensor's largest entry (a few bf16 steps).
"""

import copy
import json
import os
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from vqa_counterexamples_tpu.cli import train as jax_train_cli
from vqa_counterexamples_tpu.core import experiment as jax_experiment
from vqa_counterexamples_tpu.core import policy as jax_policy
from vqa_counterexamples_tpu.data.features import FeatureStore as JaxStore
from vqa_counterexamples_tpu.data.vqa_dataset import VQAArrays as JaxArrays
from vqa_counterexamples_tpu.engines import vqa_engine as jax_engine
from vqa_counterexamples_tpu.models import factory as jax_factory
from vqa_counterexamples_tpu.models import port_torch
from vqa_counterexamples_tpu.ops import fusion as jax_fusion
from vqa_counterexamples_tpu.ops import metrics as jax_metrics
from vqa_counterexamples_tpu.ops import rnn as jax_rnn
from vqa_counterexamples_tpu.ops.pallas import gru_kernel as jax_gru
from vqa_counterexamples_tpu.ops.pallas import mutan_kernel as jax_mutan
from vqa_counterexamples_tpu_torch.cli import train as port_cli
from vqa_counterexamples_tpu_torch.core import checkpoint as port_ckpt
from vqa_counterexamples_tpu_torch.core import config as port_config
from vqa_counterexamples_tpu_torch.core import experiment as port_experiment
from vqa_counterexamples_tpu_torch.core import meters as port_meters
from vqa_counterexamples_tpu_torch.data.vqa_dataset import VQAArrays
from vqa_counterexamples_tpu_torch.engines import vqa_engine as port_engine
from vqa_counterexamples_tpu_torch.models import common as port_common
from vqa_counterexamples_tpu_torch.models import factory as port_factory
from vqa_counterexamples_tpu_torch.models import from_jax
from vqa_counterexamples_tpu_torch.ops import fusion as port_fusion
from vqa_counterexamples_tpu_torch.ops import metrics as port_metrics
from vqa_counterexamples_tpu_torch.ops import rnn as port_rnn
from vqa_counterexamples_tpu_torch.ops.cuda import gru_kernel, mutan_kernel

from test_torch_kernels_ref import _from_jax_gates, _to_jax_gates

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LANE = jax_gru.LANE
B, T, LR = 16, 10, 1e-3
BF16 = torch.bfloat16


def _bf16(a):
    """numpy f32 values rounded to bf16 (both sides see equal inputs)."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF16).float() \
        .numpy()


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dtype)


def _np(x):
    return (x.detach().float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


def _assert_rel(got, ref, rel, name=""):
    """max |got - ref| within ``rel`` of ref's largest entry."""
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    assert np.isfinite(got).all(), name
    assert np.abs(got - ref).max() <= rel * np.abs(ref).max() + 1e-12, (
        name, np.abs(got - ref).max(), np.abs(ref).max())


def _pad(a, hp):
    return np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, hp - a.shape[-1])])


def _mask(rng, shape, dropout=0.25):
    """An inverted-dropout mask with the 8-bit keep-mask's scale."""
    thresh = int(round((1.0 - dropout) * 256))
    return ((rng.random(shape) < (1.0 - dropout))
            * (256.0 / thresh)).astype(np.float32)


# ------------------------------------------------------------ GRU kernels

def _gru_case(seq, batch, dim_h, mask_kind, seed):
    """Port-layout inputs (numpy, bf16 values): xp (T, B, 3H), W_hh (3H, H),
    b_hh (3H,), a mask (None, (B, H) or (3, B, H)) and dstates."""
    rng = np.random.default_rng(seed)
    xp = _bf16(rng.normal(size=(seq, batch, 3 * dim_h)))
    w = _bf16(rng.normal(size=(3 * dim_h, dim_h)) * dim_h ** -0.5)
    b = (rng.normal(size=(3 * dim_h,)) * 0.1).astype(np.float32)
    shape = {"none": None, "shared": (batch, dim_h),
             "per_gate": (3, batch, dim_h)}[mask_kind]
    mask = None if shape is None else _bf16(_mask(rng, shape))
    ds = _bf16(rng.normal(size=(seq, batch, dim_h)))
    return xp, w, b, mask, ds


def _jax_pg_operands(xp, w, b, mask, hp):
    """Gate-major per-gate operands of the JAX kernels: (xr, xz, xn) slabs,
    W (3, Hp, Hp) with W[g][k, j] = W_hh[g*H + j, k], b (3, 1, Hp)."""
    dim_h = w.shape[1]
    xs = tuple(jnp.asarray(_pad(xp[..., g * dim_h:(g + 1) * dim_h], hp),
                           jnp.bfloat16) for g in range(3))
    w3 = np.stack([np.pad(w[g * dim_h:(g + 1) * dim_h].T,
                          ((0, hp - dim_h), (0, hp - dim_h)))
                   for g in range(3)])
    b3 = np.stack([_pad(b[g * dim_h:(g + 1) * dim_h], hp)
                   for g in range(3)])[:, None]
    return (xs, jnp.asarray(w3, jnp.bfloat16), jnp.asarray(b3),
            jnp.asarray(_pad(mask, hp), jnp.bfloat16))


def _jax_shared_operands(xp, w, b, mask, hp, batch):
    dim_h = w.shape[1]
    m = np.ones((batch, dim_h), np.float32) if mask is None else mask
    w_j = np.pad(_to_jax_gates(w.T, dim_h, hp), ((0, hp - dim_h), (0, 0)))
    return (jnp.asarray(_to_jax_gates(xp, dim_h, hp), jnp.bfloat16),
            jnp.asarray(w_j, jnp.bfloat16),
            jnp.asarray(_to_jax_gates(b, dim_h, hp))[None],
            jnp.asarray(_pad(m, hp), jnp.bfloat16))


@pytest.mark.parametrize("seq,batch,dim_h", [(5, 4, 20), (7, 9, 130)])
def test_gru_pg_plain_matches_pallas(seq, batch, dim_h):
    """The per-gate forward (3f') against ``gru_fwd_pallas`` with gate-major
    padded operands (``_fwd_kernel_pg``): states and h_proj."""
    xp, w, b, mask, _ = _gru_case(seq, batch, dim_h, "per_gate", seed=dim_h)
    hp = -(-dim_h // LANE) * LANE
    xs, w3, b3, m3 = _jax_pg_operands(xp, w, b, mask, hp)
    states_j, hprojs_j = jax_gru.gru_fwd_pallas(xs, w3, b3, m3,
                                                interpret=True)
    states_p, hproj_p = gru_kernel.gru_recurrence(
        _t(xp, BF16), _t(w, BF16), _t(b), _t(mask, BF16), want_hproj=True)
    assert states_p.dtype == BF16 and states_p.shape == (seq, batch, dim_h)
    np.testing.assert_allclose(_np(states_p),
                               np.asarray(states_j[..., :dim_h], np.float32),
                               atol=5e-2, rtol=5e-2)
    ref_h = np.concatenate([np.asarray(h[..., :dim_h], np.float32)
                            for h in hprojs_j], axis=-1)
    np.testing.assert_allclose(_np(hproj_p), ref_h, atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("mask_kind", ["none", "shared", "per_gate"])
@pytest.mark.parametrize("seq,batch,dim_h", [(4, 6, 24), (6, 5, 130)])
def test_gru_bwd_plain_matches_pallas(seq, batch, dim_h, mask_kind):
    """The backward's plain version (3b) against ``gru_bwd_pallas`` in
    interpret mode, on the JAX forward's own residuals: dxp, dW (JAX's f32
    sum rounded to bf16 as its VJP does) and db; per-gate also against
    the reverse scan ``_bwd_scan_pg``."""
    xp, w, b, mask, ds = _gru_case(seq, batch, dim_h, mask_kind,
                                   seed=seq + dim_h)
    hp = -(-dim_h // LANE) * LANE
    ds_j = jnp.asarray(_pad(ds, hp), jnp.bfloat16)
    if mask_kind == "per_gate":
        xs, w3, b3, m3 = _jax_pg_operands(xp, w, b, mask, hp)
        states_j, hprojs_j = jax_gru.gru_fwd_pallas(xs, w3, b3, m3,
                                                    interpret=True)
        dw_j, db_j, dxp_j, _ = jax_gru.gru_bwd_pallas(
            w3, xs, m3, states_j, hprojs_j, ds_j, interpret=True)
        dw_s, db_s, dxp_s, _ = jax_gru._bwd_scan_pg(
            w3, xs, m3.astype(jnp.float32), states_j, hprojs_j,
            ds_j.astype(jnp.float32))

        def port_dw(dw):
            return np.concatenate([np.asarray(dw[g], np.float32)[
                :dim_h, :dim_h].T for g in range(3)])

        def port_gates(parts):
            return np.concatenate([np.asarray(p, np.float32)[..., :dim_h]
                                   for p in parts], axis=-1)

        def port_db(db):
            return np.asarray(db, np.float32)[:, 0, :dim_h].reshape(-1)

        hproj = port_gates(hprojs_j)
        refs = [(port_gates(dxp_j), port_dw(dw_j), port_db(db_j)),
                (port_gates(dxp_s), port_dw(dw_s), port_db(db_s))]
    else:
        xp_j, w_j, b_j, m_j = _jax_shared_operands(xp, w, b, mask, hp, batch)
        states_j, hproj_j = jax_gru.gru_fwd_pallas(xp_j, w_j, b_j, m_j,
                                                   interpret=True)
        dw_j, db_j, dxp_j, _ = jax_gru.gru_bwd_pallas(
            w_j, xp_j, m_j, states_j, hproj_j, ds_j, interpret=True)
        hproj = _from_jax_gates(np.asarray(hproj_j, np.float32), dim_h, hp)
        refs = [(_from_jax_gates(np.asarray(dxp_j, np.float32), dim_h, hp),
                 _from_jax_gates(np.asarray(dw_j, np.float32)[:dim_h], dim_h,
                                 hp).T,
                 _from_jax_gates(np.asarray(db_j, np.float32)[0], dim_h,
                                 hp))]
    states = np.asarray(states_j, np.float32)[..., :dim_h]
    got = gru_kernel.gru_recurrence_bwd(
        _t(xp, BF16), _t(w, BF16), None if mask is None else _t(mask, BF16),
        _t(states, BF16), _t(hproj, BF16), _t(ds, BF16))
    assert got[0].dtype == BF16 and got[1].dtype == BF16
    assert got[2].dtype == torch.float32
    for ref in refs:
        for name, g, r in zip(("dxp", "dW", "db"), got, ref):
            if name == "dW":
                r = _bf16(r)
            _assert_rel(g, r, 2e-2, name)


@pytest.mark.parametrize("mask_kind", ["none", "shared", "per_gate"])
def test_gru_function_grads_match_jax_vjp(mask_kind):
    """``GRURecurrence`` (plain forward and backward on the CPU) against
    ``jax.vjp`` of ``gru_recurrence_pallas`` (both kernels in interpret
    mode): the states and the cotangents of xp, W_hh and b_hh."""
    seq, batch, dim_h = 5, 6, 40
    xp, w, b, mask, ds = _gru_case(seq, batch, dim_h, mask_kind, seed=11)
    hp = -(-dim_h // LANE) * LANE
    if mask_kind == "per_gate":
        xs, w3, b3, m3 = _jax_pg_operands(xp, w, b, mask, hp)
        states_j, vjp = jax.vjp(
            lambda w_, b_, x_: jax_gru.gru_recurrence_pallas(
                w_, b_, x_, m3, True, True), w3, b3, xs)
        dw_j, db_j, dxp_j = vjp(jnp.asarray(_pad(ds, hp), jnp.bfloat16))
        ref = (np.concatenate([np.asarray(d, np.float32)[..., :dim_h]
                               for d in dxp_j], axis=-1),
               np.concatenate([np.asarray(dw_j[g], np.float32)[
                   :dim_h, :dim_h].T for g in range(3)]),
               np.asarray(db_j, np.float32)[:, 0, :dim_h].reshape(-1))
    else:
        xp_j, w_j, b_j, m_j = _jax_shared_operands(xp, w, b, mask, hp, batch)
        states_j, vjp = jax.vjp(
            lambda w_, b_, x_: jax_gru.gru_recurrence_pallas(
                w_, b_, x_, m_j, True, True), w_j, b_j, xp_j)
        dw_j, db_j, dxp_j = vjp(jnp.asarray(_pad(ds, hp), jnp.bfloat16))
        ref = (_from_jax_gates(np.asarray(dxp_j, np.float32), dim_h, hp),
               _from_jax_gates(np.asarray(dw_j, np.float32)[:dim_h], dim_h,
                               hp).T,
               _from_jax_gates(np.asarray(db_j, np.float32)[0], dim_h, hp))
    leaves = [_t(xp, BF16).requires_grad_(), _t(w, BF16).requires_grad_(),
              _t(b).requires_grad_()]
    states = gru_kernel.gru_recurrence_train(
        *leaves, None if mask is None else _t(mask, BF16))
    np.testing.assert_allclose(_np(states), np.asarray(
        states_j[..., :dim_h], np.float32), atol=5e-2, rtol=5e-2)
    states.backward(_t(ds, BF16))
    assert [t.grad.dtype for t in leaves] == [BF16, BF16, torch.float32]
    for name, leaf, r in zip(("dxp", "dW", "db"), leaves, ref):
        _assert_rel(leaf.grad, r, 2e-2, name)


def test_gru_recurrence_stays_forward_only():
    """The forward wrapper refuses grad; the trainable path is the
    Function."""
    xp = torch.zeros(2, 3, 6, dtype=BF16, requires_grad=True)
    w = torch.zeros(6, 2, dtype=BF16)
    with pytest.raises(RuntimeError, match="forward-only"):
        gru_kernel.gru_recurrence(xp, w, torch.zeros(6))
    states = gru_kernel.gru_recurrence_train(xp, w, torch.zeros(6))
    states.float().sum().backward()
    assert xp.grad is not None and xp.grad.shape == xp.shape


# ------------------------------------------------- gru_scan with masks

def _scan_case(seed, batch=6, seq=5, dim_in=10, dim_h=24):
    rng = np.random.default_rng(seed)
    p = SimpleNamespace(
        w_ih=(rng.normal(size=(dim_in, 3 * dim_h)) * 0.3).astype(np.float32),
        b_ih=(rng.normal(size=(3 * dim_h,)) * 0.1).astype(np.float32),
        w_hh=(rng.normal(size=(dim_h, 3 * dim_h)) * 0.3).astype(np.float32),
        b_hh=(rng.normal(size=(3 * dim_h,)) * 0.1).astype(np.float32))
    x = rng.normal(size=(batch, seq, dim_in)).astype(np.float32)
    g = rng.normal(size=(seq, batch, dim_h)).astype(np.float32)
    return p, x, g, rng


def _jax_scan(p, x, mask_x, mask_h, per_gate, dtype):
    """JAX states (T, B, H): ``_gru_scan_per_gate`` / ``_gru_core`` at f32,
    ``_per_gate_x_proj`` / the shared input mask + ``_gru_pallas_path``
    (the kernels in interpret mode) at bf16."""
    params = jax_rnn.GRUParams(*(jnp.asarray(a) for a in
                                 (p.w_ih, p.b_ih, p.w_hh, p.b_hh)))

    def run(params):
        if dtype == "bfloat16":
            if per_gate:
                x_proj = jax_rnn._per_gate_x_proj(params, x, mask_x)
                return jax_rnn._gru_pallas_path(params, None, mask_h, True,
                                                x_proj=x_proj)
            xt = jnp.swapaxes(x * mask_x[:, None, :], 0, 1)
            return jax_rnn._gru_pallas_path(params, xt, mask_h, True)
        h0 = jnp.zeros((x.shape[0], p.w_hh.shape[0]), jnp.float32)
        if per_gate:
            return jax_rnn._gru_scan_per_gate(params, x, mask_x, mask_h, h0,
                                              1, True)
        xt = jnp.swapaxes(x * mask_x[:, None, :], 0, 1)
        x_proj = xt @ params.w_ih + params.b_ih
        return jax_rnn._gru_core(1, params.w_hh, params.b_hh, x_proj, h0,
                                 mask_h)
    return run, params


@pytest.mark.parametrize("per_gate", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gru_scan_with_injected_masks_matches_jax(monkeypatch, per_gate,
                                                  dtype):
    """The same numpy variational masks (per gate (3, B, ·), or shared)
    into ``ops/rnn.gru_scan`` and the JAX paths: states and the gradients
    of every GRU weight, f32 within rtol 1e-4, bf16 within 5e-2 (the
    recurrent mask rounded to bf16 on both sides: 256/192 -> 1.3359375)."""
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", dtype)
    monkeypatch.setenv("VQACX_GRU_PALLAS", "interpret")
    p, x, g, rng = _scan_case(seed=3 if per_gate else 4)
    lead = (3,) if per_gate else ()
    batch, _, dim_in = x.shape
    dim_h = p.w_hh.shape[0]
    mask_x = _mask(rng, lead + (batch, dim_in))
    mask_h = _mask(rng, lead + (batch, dim_h))
    with jax_policy.compute_dtype_scope(dtype):
        run, params = _jax_scan(p, x, mask_x, mask_h, per_gate, dtype)
        states_j = run(params)
        grads = jax.grad(
            lambda q: jnp.sum(jnp.tanh(run(q).astype(jnp.float32)) * g))(
                params)
    leaves = {"weight_ih": _t(p.w_ih.T).requires_grad_(),
              "bias_ih": _t(p.b_ih).requires_grad_(),
              "weight_hh": _t(p.w_hh.T).requires_grad_(),
              "bias_hh": _t(p.b_hh).requires_grad_()}
    states = port_rnn.gru_scan(leaves["weight_ih"], leaves["bias_ih"],
                               leaves["weight_hh"], leaves["bias_hh"],
                               _t(x), _t(mask_x), _t(mask_h))
    (torch.tanh(states.float()) * _t(g)).sum().backward()
    tol = (dict(rtol=1e-4, atol=1e-5) if dtype == "float32"
           else dict(rtol=5e-2, atol=5e-2))
    np.testing.assert_allclose(_np(states), np.asarray(states_j, np.float32),
                               **tol)
    ref_grads = {"weight_ih": grads.w_ih.T, "bias_ih": grads.b_ih,
                 "weight_hh": grads.w_hh.T, "bias_hh": grads.b_hh}
    for name, leaf in leaves.items():
        if dtype == "float32":
            np.testing.assert_allclose(_np(leaf.grad), np.asarray(
                ref_grads[name], np.float32), rtol=1e-4, atol=1e-5,
                err_msg=name)
        else:
            _assert_rel(leaf.grad, ref_grads[name], 5e-2, name)


def test_variational_masks_shapes_rates_and_order():
    gen = torch.Generator().manual_seed(0)
    mx, mh = port_rnn.variational_masks(gen, 0.25, 300, 40, 50)
    assert mx.shape == (3, 300, 40) and mh.shape == (3, 300, 50)
    assert set(np.unique(mh.numpy())) == {0.0, np.float32(256.0 / 192)}
    assert abs((mh > 0).float().mean().item() - 0.75) < 0.02
    # per gate: three independent masks
    assert not torch.equal(mh[0], mh[1])
    sx, sh = port_rnn.variational_masks(torch.Generator().manual_seed(0),
                                        0.25, 300, 40, 50, per_gate=False)
    assert sx.shape == (300, 40) and sh.shape == (300, 50)


def test_dropout_helper():
    x = torch.ones(400, 500)
    gen = torch.Generator().manual_seed(1)
    y = port_common.dropout(x, 0.5, gen, True)
    assert set(np.unique(y.numpy())) == {0.0, 2.0}
    assert abs((y > 0).float().mean().item() - 0.5) < 0.01
    assert port_common.dropout(x, 0.5, None, False) is x
    assert port_common.dropout(x, 0.0, None, True) is x
    with pytest.raises(ValueError):
        port_common.dropout(x, 0.5, None, True)


# ------------------------------------------------------------------ Tucker

def _tucker_inputs(batch=48, dhv=24, dhq=20, dmm=16, rank=3, seed=0):
    """JAX layout: x_v (B, dhv), x_q (B, dhq), w (dh, R*dmm), b (R*dmm,)."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(batch, dhv)).astype(np.float32),
            rng.normal(size=(batch, dhq)).astype(np.float32),
            (rng.normal(size=(dhv, rank * dmm)) * 0.1).astype(np.float32),
            rng.normal(size=(rank * dmm,)).astype(np.float32),
            (rng.normal(size=(dhq, rank * dmm)) * 0.1).astype(np.float32),
            rng.normal(size=(rank * dmm,)).astype(np.float32))


def _port_tucker_args(args):
    """The port's layout (weights (R*dmm, dh)), f32 tensors."""
    xv, xq, wv, bv, wq, bq = args
    return _t(xv), _t(xq), _t(wv.T), _t(bv), _t(wq.T), _t(bq)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tucker_matches_jax(monkeypatch, dtype):
    """``ops/fusion.tucker_rank_fusion`` against the JAX op under the same
    policy, and the kernel's plain version on bf16 operands against the
    TPU kernel (interpret mode) on the same values: rtol 1e-4 (f32 sums of
    the same products, in another order)."""
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", dtype)
    args = _tucker_inputs(batch=77)
    with jax_policy.compute_dtype_scope(dtype):
        ref = np.asarray(jax_fusion.tucker_rank_fusion(
            *map(jnp.asarray, args), rank=3))
    got = port_fusion.tucker_rank_fusion(*_port_tucker_args(args), rank=3)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())
    if dtype == "bfloat16":
        rounded = [(_bf16(a) if i in (0, 1, 2, 4) else a)
                   for i, a in enumerate(args)]
        ref_k = np.asarray(jax_mutan.tucker_rank_fusion_pallas(
            *map(jnp.asarray, rounded), rank=3, tile_b=32, interpret=True))
        xv, xq, wv, bv, wq, bq = _port_tucker_args(rounded)
        got_k = mutan_kernel.tucker_fusion(
            xv.to(BF16), xq.to(BF16), wv.to(BF16), bv, wq.to(BF16), bq, 3)
        np.testing.assert_allclose(_np(got_k), ref_k, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref_k).max())


# the card tests' shapes (tests/test_torch_cuda.py::_TUCKER_SHAPES), the
# two path shapes, a B whose tiles fill the card alone, the largest R
_TUCKER_PLAN_SHAPES = [
    (5, 24, 24, 3, 24), (70, 40, 36, 2, 50), (513, 360, 360, 10, 360),
    (128, 620, 310, 5, 510), (37, 62, 30, 7, 70), (9, 21, 23, 4, 33),
    (512, 360, 360, 10, 360), (2048, 360, 360, 10, 360), (64, 8, 8, 80, 64)]


@pytest.mark.parametrize("batch,dhv,dhq,rank,dmm", _TUCKER_PLAN_SHAPES)
def test_tucker_plan(batch, dhv, dhq, rank, dmm):
    """The Tucker kernel's launch plan (``mutan_kernel.tucker_plan``, a pure
    function the kernel takes as given): the cluster's CTAs take every rank
    once, in order, and each at least one; the grid covers every 64 x 64
    output tile with one cluster; a CTA's shared memory fits the H100's
    232,448 bytes; the grid is as large as 3 CTAs on each of 132 SMs
    allow."""
    plan = mutan_kernel.tucker_plan(batch, dhv, dhq, rank, dmm)
    cl, rg = plan["cl"], plan["rg"]
    assert 1 <= cl <= 8 and cl <= rank
    ranks = [r for c in range(cl) for r in range(c * rg, min(rank, (c + 1)
                                                              * rg))]
    assert ranks == list(range(rank))
    assert all(c * rg < rank for c in range(cl))
    tiles = -(-batch // 64) * -(-dmm // 64)
    assert plan["grid"] == cl * tiles
    assert plan["smem"] == mutan_kernel.mutan_smem(rg) <= 232448
    # as many CTAs as 3 on each SM take (one cluster a tile at least): a
    # finer split of the ranks would overflow them or the cluster
    assert plan["grid"] <= max(396, tiles)
    assert rg == 1 or -(-rank // (rg - 1)) * tiles > 396 or -(-rank // (
        rg - 1)) > 8
    if (batch, dhv, rank) == (512, 360, 10):
        assert (cl, rg, plan["grid"]) == (5, 2, 240)
        assert 3 * (plan["smem"] + 1024) <= 233472   # three CTAs an SM
    if (batch, dhv, rank) == (128, 620, 5):
        assert (cl, rg, plan["grid"]) == (5, 1, 80)


def test_tucker_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="cluster"):
        mutan_kernel.tucker_plan(64, 8, 8, 81, 64)


def test_tucker_function_grads_match_jax():
    """``TuckerFusion`` (the kernel's plain forward on the CPU, the
    recomputing backward) against ``jax.grad`` through the TPU kernel's
    custom VJP (interpret mode) and through the XLA path, at f32."""
    args = _tucker_inputs()

    def loss_xla(*a):
        return jnp.sum(jax_fusion.tucker_rank_fusion(*a, rank=3) ** 2)

    def loss_pallas(*a):
        return jnp.sum(jax_fusion._tucker_pallas_vjp(*a, 3) ** 2)

    orig = jax_mutan.tucker_rank_fusion_pallas

    def interp(*a, **kw):
        return orig(*a, **dict(kw, interpret=True))

    jax_mutan.tucker_rank_fusion_pallas = interp
    try:
        with jax_policy.compute_dtype_scope("float32"):
            refs = [jax.grad(f, argnums=tuple(range(6)))(
                *map(jnp.asarray, args)) for f in (loss_xla, loss_pallas)]
    finally:
        jax_mutan.tucker_rank_fusion_pallas = orig
    leaves = [a.requires_grad_() for a in _port_tucker_args(args)]
    out = port_fusion.TuckerFusion.apply(*leaves, 3)
    (out ** 2).sum().backward()
    for ref in refs:
        for i, (leaf, r) in enumerate(zip(leaves, ref)):
            r = np.asarray(r)
            r = r.T if i in (2, 4) else r
            np.testing.assert_allclose(_np(leaf.grad), r, rtol=1e-4,
                                       atol=1e-4 * np.abs(r).max(),
                                       err_msg=str(i))


def test_tucker_auto_is_plain_on_cpu(monkeypatch):
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "bfloat16")
    args = _port_tucker_args(_tucker_inputs())
    before = mutan_kernel.tucker_fusion.launches
    got = port_fusion.tucker_rank_fusion_auto(*args, rank=3)
    assert torch.equal(got, port_fusion.tucker_rank_fusion(*args, rank=3))
    assert mutan_kernel.tucker_fusion.launches == before


# --------------------------------------------------------- model and step

def tiny_options(dropout=0.0, n_answers=20):
    return {
        "arch": "MutanNoAtt",
        "seq2vec": {"arch": "skipthoughts", "type": "BayesianUniSkip",
                    "dropout": dropout, "fixed_emb": False, "emb_size": 16,
                    "hidden_size": 48},
        "fusion": {"dim_v": 24, "dim_q": 48, "dim_hv": 24, "dim_hq": 24,
                   "dim_mm": 24, "R": 3, "dropout_v": dropout,
                   "dropout_q": dropout, "activation_v": "tanh",
                   "activation_q": "tanh", "dropout_hv": 0,
                   "dropout_hq": 0},
        "classif": {"dropout": dropout},
    }


def _cli_options(opt):
    return {"vqa": {"nans": 20, "maxlength": T, "trainsplit": "train",
                    "samplingans": True},
            "coco": {"mode": "noatt"}, "model": opt}


def build_vqa_pair(words, answers, opt, seed=0):
    """(jax model, jax params, port model) with the same weights: the
    port's seeded init (unit-scale word embeddings, so the GRU states are
    not near 0) read into the flax tree by ``port_torch``, and back into a
    second port model through ``from_jax``."""
    jmodel = jax_factory.factory_vqa(opt, words, answers)
    source = port_engine.init_vqa_params(
        port_factory.factory_vqa(opt, words, answers), seed=seed)
    with torch.no_grad():
        source.seq2vec.embedding.weight.normal_(
            0.0, 1.0, generator=torch.Generator().manual_seed(seed + 1))
    params, arch = port_torch.port_vqa_state_dict(source.state_dict())
    assert arch == "MutanNoAtt"
    params = jax.tree.map(np.asarray, params)
    pmodel = port_factory.factory_vqa(opt, words, answers)
    pmodel.load_state_dict(from_jax.vqa_state_dict_from_jax(params))
    return jmodel, params, pmodel


@pytest.fixture(scope="module")
def world():
    opt = tiny_options()
    examples, store, words, answers = port_cli._synthetic_vqa(
        40, _cli_options(opt), seed=5)
    jmodel, params, pmodel = build_vqa_pair(words, answers, opt, seed=3)
    arrays = VQAArrays(examples, store, samplingans=True)
    order = np.random.default_rng(0)
    batches = [b for _ in range(15) for b in arrays.batches(
        B, shuffle=True, rng=order, drop_remainder=True)]
    return SimpleNamespace(opt=opt, jmodel=jmodel, params=params,
                           pmodel=pmodel, store=store, arrays=arrays,
                           batches=batches, words=words, answers=answers)


def _as_port(tree) -> dict:
    """A JAX VQA tree (params, grads, moments) under the port's names."""
    return {k: v.numpy() for k, v in from_jax.vqa_state_dict_from_jax(
        jax.device_get(tree)).items()}


def _jbatch(b):
    return {"visual": jnp.asarray(b["visual"]),
            "question": jnp.asarray(b["question"]),
            "answer": jnp.asarray(b["answer"])}


def _jax_state(params, optimizer):
    params = jax.tree.map(jnp.asarray, params)
    return jax_engine.VQATrainState(params, optimizer.init(params),
                                    jnp.zeros((), jnp.int32))


@pytest.fixture(params=["float32", "bfloat16"])
def dtype(request, monkeypatch):
    if request.param == "bfloat16":
        monkeypatch.setenv("VQACX_GRU_PALLAS", "interpret")
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", request.param)
    with jax_policy.compute_dtype_scope(request.param):
        yield request.param


def test_mutan_noatt_forward_and_grads_match_jax(world, dtype):
    """Logits and the gradient of every parameter, training mode with the
    dropouts at 0: f32 rtol 1e-4, bf16 within 5e-2 of each tensor's largest
    entry."""
    w = world
    b = w.batches[0]
    g = np.random.default_rng(1).normal(size=(B, 20)).astype(np.float32)

    def loss_fn(params):
        out = w.jmodel.apply({"params": params}, jnp.asarray(b["visual"]),
                             jnp.asarray(b["question"]), deterministic=False,
                             rngs={"dropout": jax.random.key(0)})
        return jnp.sum(out * g), out

    (_, ref), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, w.params))
    model = copy.deepcopy(w.pmodel)
    out = model(_t(b["visual"]), torch.from_numpy(b["question"]),
                training=True, generator=torch.Generator().manual_seed(0))
    (out * _t(g)).sum().backward()
    assert out.dtype == torch.float32 and out.shape == (B, 20)
    ref_g = _as_port(grads)
    named = dict(model.named_parameters())
    assert set(ref_g) == set(named)
    if dtype == "float32":
        np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=1e-4,
                                   atol=1e-5)
        for name, r in ref_g.items():
            np.testing.assert_allclose(_np(named[name].grad), r, rtol=1e-4,
                                       atol=1e-6 * max(np.abs(r).max(), 1),
                                       err_msg=name)
    else:
        np.testing.assert_allclose(_np(out), np.asarray(ref, np.float32),
                                   rtol=5e-2, atol=5e-2)
        for name, r in ref_g.items():
            _assert_rel(named[name].grad, r, 5e-2, name)


def test_mutan_noatt_eval_matches_jax(world, dtype):
    """The eval forward (deterministic) at both policies."""
    w = world
    b = w.batches[1]
    ref = w.jmodel.apply({"params": jax.tree.map(jnp.asarray, w.params)},
                         jnp.asarray(b["visual"]), jnp.asarray(b["question"]),
                         deterministic=True)
    with torch.no_grad():
        got = w.pmodel(_t(b["visual"]), torch.from_numpy(b["question"]))
    tol = (dict(rtol=1e-4, atol=1e-5) if dtype == "float32"
           else dict(rtol=5e-2, atol=5e-2))
    np.testing.assert_allclose(_np(got), np.asarray(ref, np.float32), **tol)


def _assert_adam_close(got, ref, grad, name):
    """Params after one Adam step from the same start; the first update is
    -lr g / (|g| + eps), which swings between -lr and lr where |g| is near
    eps: those entries are held to 2 lr, the rest to 1e-6."""
    steady = np.abs(grad) > 1e-6
    np.testing.assert_allclose(got[steady], ref[steady], rtol=0, atol=1e-6,
                               err_msg=name)
    assert np.abs(got - ref).max() <= 2 * LR + 1e-6, name


def test_vqa_train_step_matches_jax_f32(world, monkeypatch):
    """One ``make_vqa_train_step``: loss, acc@1, acc@5, the gradient of
    every parameter and every parameter after Adam."""
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "float32")
    w = world
    b = w.batches[0]
    opt = optax.adam(LR)
    with jax_policy.compute_dtype_scope("float32"):
        jstate = _jax_state(w.params, opt)
        jb = _jbatch(b)

        @jax.jit
        def grad_fn(params):
            def loss_fn(p):
                out = w.jmodel.apply({"params": p}, jb["visual"],
                                     jb["question"], deterministic=False,
                                     rngs={"dropout": jax.random.key(0)})
                return jax_metrics.cross_entropy_mean(out, jb["answer"])
            return jax.grad(loss_fn)(params)

        jgrads = _as_port(grad_fn(jstate.params))
        jstep = jax_engine.make_vqa_train_step(w.jmodel, opt)
        jstate, jm = jstep(jstate, jb)
        jnew = _as_port(jstate.params)
    model = copy.deepcopy(w.pmodel)
    state = port_engine.init_vqa_state(model, lr=LR)
    step = port_engine.make_vqa_train_step(model, state.optimizer)
    state, pm = step(state, dict(b, visual=_t(b["visual"])))
    assert state.step == 1
    for k in ("loss", "acc1", "acc5"):
        assert pm[k].dim() == 0
        assert float(pm[k]) == pytest.approx(float(jm[k]), rel=1e-5), k
    named = dict(model.named_parameters())
    assert set(jgrads) == set(named)
    for name, ref in jgrads.items():
        np.testing.assert_allclose(
            named[name].grad.numpy(), ref, rtol=1e-4,
            atol=1e-6 * max(np.abs(ref).max(), 1), err_msg=name)
        _assert_adam_close(named[name].detach().numpy(), jnew[name], ref,
                           name)


def _run_pair(w, model, batches, opt, jstate, pstate):
    jstep = jax_engine.make_vqa_train_step(w.jmodel, opt)
    pstep = port_engine.make_vqa_train_step(model, pstate.optimizer)
    losses = []
    for b in batches:
        jstate, jm = jstep(jstate, _jbatch(b))
        pstate, pm = pstep(pstate, dict(b, visual=_t(b["visual"])))
        losses.append((float(jm["loss"]), float(pm["loss"]),
                       float(jm["acc1"]), float(pm["acc1"])))
    return np.array(losses), jstate, pstate


def test_trajectory_30_steps_f32_tracks_jax(world, monkeypatch):
    """30 steps (samplingans batches, dropouts at 0): per-step losses
    within rtol 1e-4, equal acc@1, and the final eval logits within 1e-3."""
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "float32")
    w = world
    opt = optax.adam(LR)
    model = copy.deepcopy(w.pmodel)
    with jax_policy.compute_dtype_scope("float32"):
        losses, jstate, pstate = _run_pair(
            w, model, w.batches[:30], opt, _jax_state(w.params, opt),
            port_engine.init_vqa_state(model, lr=LR))
        b = w.batches[0]
        ref = w.jmodel.apply({"params": jstate.params},
                             jnp.asarray(b["visual"]),
                             jnp.asarray(b["question"]), deterministic=True)
    assert len(losses) == 30 and pstate.step == 30
    np.testing.assert_allclose(losses[:, 1], losses[:, 0], rtol=1e-4)
    np.testing.assert_array_equal(losses[:, 3], losses[:, 2])
    assert losses[-3:, 0].mean() < losses[:3, 0].mean()  # it learns
    with torch.no_grad():
        got = model(_t(b["visual"]), torch.from_numpy(b["question"]))
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-3,
                               atol=1e-4)


def test_trajectory_bf16_tracks_jax(world, monkeypatch):
    """10 steps under the bf16 policy: the JAX step runs the GRU forward
    and backward Pallas kernels in interpret mode (Tucker on its XLA path
    at this batch), the port their plain versions: per-step losses within
    5e-2 relative."""
    monkeypatch.setenv("VQACX_GRU_PALLAS", "interpret")
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "bfloat16")
    w = world
    opt = optax.adam(LR)
    model = copy.deepcopy(w.pmodel)
    with jax_policy.compute_dtype_scope("bfloat16"):
        losses, _, pstate = _run_pair(
            w, model, w.batches[:10], opt, _jax_state(w.params, opt),
            port_engine.init_vqa_state(model, lr=LR))
    assert pstate.step == 10 and np.isfinite(losses).all()
    np.testing.assert_allclose(losses[:, 1], losses[:, 0], rtol=5e-2)


def test_vqa_adam_state_carried_from_jax(world, monkeypatch):
    """5 JAX steps, then params and optax's mu / nu / count carried into a
    fresh port model and ``torch.optim.Adam`` over every parameter: step 6
    agrees."""
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "float32")
    w = world
    opt = optax.adam(LR)
    with jax_policy.compute_dtype_scope("float32"):
        jstep = jax_engine.make_vqa_train_step(w.jmodel, opt)
        jstate = _jax_state(w.params, opt)
        for b in w.batches[:5]:
            jstate, _ = jstep(jstate, _jbatch(b))
        host = jax.device_get(jstate)
        model = copy.deepcopy(w.pmodel)
        model.load_state_dict(from_jax.vqa_state_dict_from_jax(host.params))
        state = port_engine.init_vqa_state(model, lr=LR)
        from_jax.vqa_adam_state_from_jax(host.opt_state, model,
                                         state.optimizer)
        state.step = 5
        losses, jstate, state = _run_pair(w, model, w.batches[5:6], opt,
                                          jstate, state)
        jnew = _as_port(jstate.params)
    assert float(state.optimizer.state[
        model.linear_classif.weight]["step"]) == 6
    np.testing.assert_allclose(losses[:, 1], losses[:, 0], rtol=1e-4)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jnew[name], rtol=0,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("shared", [False, True])
def test_train_step_with_dropout(world, monkeypatch, shared):
    """Training at the reference's rates (0.25 in the encoder, 0.5 in the
    fusion and the head): finite losses, the step's masks a function of
    (seed, step) only, per-gate masks other than shared ones, and eval
    unaffected by the generator."""
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "float32")
    if shared:
        monkeypatch.setenv("VQACX_GRU_SHARED_MASKS", "1")
    w = world
    opt = tiny_options(dropout=0.25)
    opt["fusion"].update(dropout_v=0.5, dropout_q=0.5)
    opt["classif"]["dropout"] = 0.5
    b = dict(w.batches[0], visual=_t(w.batches[0]["visual"]))
    losses = []
    for _ in range(2):
        model = port_factory.factory_vqa(opt, w.words, w.answers)
        model.load_state_dict(w.pmodel.state_dict())
        state = port_engine.init_vqa_state(model, lr=LR)
        step = port_engine.make_vqa_train_step(model, state.optimizer,
                                               base_seed=7)
        run = []
        for _ in range(3):
            state, m = step(state, b)
            run.append(float(m["loss"]))
        losses.append(run)
    assert np.isfinite(losses).all() and losses[0] == losses[1]
    assert len(set(losses[0])) == 3
    with torch.no_grad():
        e1 = model(b["visual"], torch.from_numpy(b["question"]))
        e2 = model(b["visual"], torch.from_numpy(b["question"]),
                   generator=torch.Generator().manual_seed(9))
    assert torch.equal(e1, e2)
    gen = torch.Generator().manual_seed(0)
    mx, mh = port_rnn.variational_masks(gen, 0.25, 4, 16, 48,
                                        port_rnn.per_gate_masks())
    assert mh.dim() == (2 if shared else 3)


def test_fixed_emb_and_uniskip():
    """``fixed_emb``: the embedding gets no gradient; UniSkip: plain
    dropout on the embeddings and no variational masks."""
    words = ["w%d" % i for i in range(10)]
    answers = ["a%d" % i for i in range(5)]
    opt = tiny_options(dropout=0.25)
    opt["seq2vec"].update(fixed_emb=True)
    model = port_engine.init_vqa_params(
        port_factory.factory_vqa(opt, words, answers))
    q = torch.tensor([[1, 2, 3, 0, 0], [4, 5, 0, 0, 0]])
    out = model(torch.randn(2, 24), q, training=True,
                generator=torch.Generator().manual_seed(0))
    out.sum().backward()
    assert model.seq2vec.embedding.weight.grad is None
    assert model.seq2vec.gru_cell.weight_hh.grad is not None
    opt["seq2vec"].update(type="UniSkip", fixed_emb=False)
    uni = port_factory.factory_vqa(opt, words, answers)
    assert not uni.seq2vec.bayesian and uni.seq2vec.dropout == 0.25
    calls = []
    orig = port_rnn.variational_masks
    port_rnn.variational_masks = lambda *a, **k: calls.append(1) or orig(
        *a, **k)
    try:
        uni.seq2vec(q, training=True,
                    generator=torch.Generator().manual_seed(0))
    finally:
        port_rnn.variational_masks = orig
    assert not calls


def test_load_skipthoughts_npz(tmp_path):
    words = ["w%d" % i for i in range(10)]
    model = port_factory.factory_vqa(tiny_options(), words, ["a0", "a1"])
    rng = np.random.default_rng(0)
    arrays = {"embedding": rng.normal(size=(11, 16)),
              "w_ih": rng.normal(size=(16, 144)),
              "b_ih": rng.normal(size=(144,)),
              "w_hh": rng.normal(size=(48, 144)),
              "b_hh": rng.normal(size=(144,))}
    path = tmp_path / "adapted_uniskip.npz"
    np.savez(path, **arrays)
    from vqa_counterexamples_tpu_torch.models.seq2vec import (
        load_skipthoughts_npz)
    load_skipthoughts_npz(model.seq2vec, str(path))
    cell = model.seq2vec.gru_cell
    np.testing.assert_allclose(cell.weight_ih.detach().numpy(),
                               arrays["w_ih"].T, rtol=1e-6)
    np.testing.assert_allclose(model.seq2vec.embedding.weight.detach()
                               .numpy(), arrays["embedding"], rtol=1e-6)
    np.savez(path, **dict(arrays, w_hh=rng.normal(size=(40, 144))))
    with pytest.raises(ValueError):
        load_skipthoughts_npz(model.seq2vec, str(path))


def test_mutan_general_path_and_spatial(world):
    """The per-rank dropout / activation configuration (plain PyTorch)
    against the JAX module at f32, eval; and (B, WH, ·) spatial inputs."""
    opt = dict(world.opt["fusion"], activation_hv="tanh",
               activation_hq="relu", activation_mm="tanh")
    from vqa_counterexamples_tpu.models import fusion as jax_fusion_mod
    from vqa_counterexamples_tpu_torch.models import fusion as port_fusion_mod

    port = port_fusion_mod.MutanFusion(opt)
    port.reset_parameters(torch.Generator().manual_seed(0))
    sub = {"fusion." + k: v for k, v in port.state_dict().items()}
    params = port_torch.port_mutan_fusion(
        {k[len("fusion."):]: v for k, v in sub.items()})
    rng = np.random.default_rng(0)
    v = rng.normal(size=(2, 5, 24)).astype(np.float32)
    q = rng.normal(size=(2, 5, 48)).astype(np.float32)
    with jax_policy.compute_dtype_scope("float32"):
        ref = jax_fusion_mod.MutanFusion(opt).apply(
            {"params": jax.tree.map(jnp.asarray, params)}, jnp.asarray(v),
            jnp.asarray(q), deterministic=True)
    with torch.no_grad():
        got = port(_t(v), _t(q))
    assert got.shape == (2, 5, 24)
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)
    assert not port.simple


# ------------------------------------------------------------------- data

def test_synthetic_vqa_matches_jax():
    opt = _cli_options(tiny_options())
    ex_p, store_p, words_p, ans_p = port_cli._synthetic_vqa(70, opt, 3)
    ex_j, store_j, words_j, ans_j = jax_train_cli._synthetic_vqa(70, opt, 3)
    assert ex_p == ex_j and words_p == words_j and ans_p == ans_j
    np.testing.assert_array_equal(store_p.features, store_j.features)
    assert store_p.names == store_j.names


@pytest.mark.parametrize("drop_remainder", [False, True])
@pytest.mark.parametrize("on_device", [False, True])
def test_vqa_batches_match_jax(drop_remainder, on_device):
    """Batches for one numpy ``rng`` (shuffle, answer sampling) are the JAX
    package's, the JAX generator consumed to its end."""
    opt = _cli_options(tiny_options())
    examples, store, _, _ = port_cli._synthetic_vqa(45, opt, 2)
    rng = np.random.default_rng(4)
    for ex in examples:   # several human answers per question to sample
        ex["answers_aid"] = sorted({ex["answer_aid"],
                                    int(rng.integers(0, 20))})
        ex["answers_count"] = [int(c) for c in
                               rng.integers(1, 10, len(ex["answers_aid"]))]
    a_port = VQAArrays(examples, store, samplingans=True)
    a_jax = JaxArrays(examples, JaxStore(store.features, store.names),
                      samplingans=True)
    feats = torch.from_numpy(store.features) if on_device else None
    got = list(a_port.batches(8, shuffle=True, rng=np.random.default_rng(1),
                              drop_remainder=drop_remainder,
                              device_features=feats))
    ref = list(a_jax.batches(8, shuffle=True, rng=np.random.default_rng(1),
                             drop_remainder=drop_remainder,
                             device_features=jnp.asarray(store.features)))
    assert len(got) == len(ref) == (5 if drop_remainder else 6)
    for gp, gj in zip(got, ref):
        assert gp.keys() == gj.keys()
        for k in ("question", "answer", "question_id"):
            np.testing.assert_array_equal(gp[k], gj[k])
            assert gp[k].dtype == gj[k].dtype
        np.testing.assert_array_equal(_np(gp["visual"]),
                                      np.asarray(gj["visual"]))


def test_metrics_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(12, 7)).astype(np.float32)
    labels = rng.integers(0, 7, size=12).astype(np.int32)
    for target in (labels, rng.normal(size=(12, 7)).astype(np.float32)):
        for topk in ((1, 5), (1, 9)):
            ref = jax_metrics.accuracy_topk(jnp.asarray(logits),
                                            jnp.asarray(target), topk)
            got = port_metrics.accuracy_topk(_t(logits),
                                             torch.from_numpy(target), topk)
            for g, r in zip(got, ref):
                assert g.dim() == 0
                assert float(g) == pytest.approx(float(r), rel=1e-6)
    assert float(port_metrics.cross_entropy_mean(
        _t(logits), torch.from_numpy(labels))) == pytest.approx(
            float(jax_metrics.cross_entropy_mean(jnp.asarray(logits),
                                                 jnp.asarray(labels))),
            rel=1e-6)


def test_train_epoch_meters_time_the_step(monkeypatch, capsys):
    """The pretraining meters mean what JAX's mean: ``data_time`` sums to
    the loader's time and ``batch_time`` to the epoch's wall time, the
    reads that wait for the card included (the last batch's too), and the
    print still comes every ``print_freq`` steps.  The fake step sleeps for
    its dispatch, as a queued step returns early; the fake read sleeps as
    long as the card would take for the steps it reads.  Tolerance 10 ms on sums of about
    0.16 and 0.28 s: the loop's own overhead and the clock's jitter; a
    read's wait timed as data_time would be 60 ms off here."""
    load_s, dispatch_s, step_s = 0.02, 0.002, 0.015
    n_batches, print_freq = 8, 3
    loaded = []

    def loader():
        for _ in range(n_batches):
            t0 = time.time()
            time.sleep(load_s)
            loaded.append(time.time() - t0)
            yield {"answer": np.zeros(4, np.int64)}

    def train_step(state, batch):
        time.sleep(dispatch_s)
        return state + 1, {k: torch.zeros(()) for k in ("loss", "acc1",
                                                        "acc5")}

    read = port_engine._read
    monkeypatch.setattr(port_engine, "_read", lambda pending: (
        time.sleep(step_s * len(pending)), read(pending))[1])
    exp = port_experiment.Experiment("meters")
    exp.add_meters("train", {k: port_meters.AvgMeter() for k in (
        "loss", "acc1", "acc5", "batch_time", "data_time")})
    t0 = time.time()
    state = port_engine.train_epoch(train_step, 0, loader(), exp, 0,
                                    print_freq=print_freq)
    wall = time.time() - t0
    meters = exp.get_meters("train")
    assert state == n_batches
    assert meters["batch_time"].count == meters["data_time"].count == 32
    printed = [line for line in capsys.readouterr().out.splitlines()
               if line.startswith("Epoch: [0]")]
    assert [line.split("\t")[0] for line in printed] == [
        "Epoch: [0][%d]" % i for i in (0, 3, 6)]
    assert abs(meters["data_time"].avg * n_batches - sum(loaded)) < 1e-2
    assert abs(meters["batch_time"].avg * n_batches - wall) < 1e-2
    assert wall > n_batches * (load_s + dispatch_s + step_s)


def test_experiment_json_matches_jax(tmp_path):
    """The same meters, updates and logs give the same ``logger.json``
    (save the timestamp)."""
    outs = []
    for mod, meters in ((jax_experiment, jax_experiment),
                        (port_experiment, port_experiment)):
        exp = mod.Experiment("run", options={"a": 1})
        exp.add_meters("train", {"loss": meters.AvgMeter(),
                                 "n": meters.SumMeter(),
                                 "best": meters.ValueMeter()})
        for i, v in enumerate((3.0, 2.0, 1.5)):
            exp.get_meter("train", "loss").update(v, n=i + 1)
            exp.get_meter("train", "n").update(v)
        exp.get_meter("train", "best").update(7)
        exp.log_meters("train", n=1)
        exp.reset_meters("train")
        exp.log_meters("train", n=2)
        path = tmp_path / ("%s.json" % mod.__name__)
        exp.to_json(str(path))
        d = json.loads(path.read_text())
        d.pop("date_and_time")
        outs.append(d)
    assert outs[0] == outs[1]


# ------------------------------------------------ checkpoints and the CLI

def _tiny_config(tmp_path, trainsplit="train"):
    opt = port_config.load_options_file(
        os.path.join(REPO, "configs", "vqa2", "mutan_noatt_train.yaml"))
    opt["model"]["seq2vec"].update(emb_size=16, hidden_size=48)
    opt["model"]["fusion"].update(dim_v=24, dim_q=48, dim_hv=24, dim_hq=24,
                                  dim_mm=24, R=3)
    opt["vqa"].update(maxlength=T, trainsplit=trainsplit)
    opt["model"]["seq2vec"]["dir_st"] = str(tmp_path / "no_st")
    opt["logs"]["dir_logs"] = str(tmp_path / "logs")
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(opt))
    return str(path), tmp_path / "logs"


def _cli(path, *extra):
    return ["--path_opt", path, "--synthetic", "64", "-b", "16",
            "--device", "cpu", "-p", "2", *extra]


def test_train_cli_trains_checkpoints_and_resumes(tmp_path, monkeypatch):
    """2 epochs: ``ckpt_*`` and ``best_*`` triplets, ``logger.json`` with
    the train and val meters per epoch, the val rows; ``--resume ckpt``
    with ``--epochs 3`` trains epoch 3 from the saved Adam state."""
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "float32")
    path, logs = _tiny_config(tmp_path)
    state = port_cli.main(_cli(path, "--epochs", "2"))
    assert state.step == 2 * 4
    names = sorted(os.listdir(logs))
    for prefix in ("ckpt", "best"):
        for suffix in ("info.json", "model.pt", "optim.pt"):
            assert "%s_%s" % (prefix, suffix) in names
    info = json.loads((logs / "ckpt_info.json").read_text())
    assert info["epoch"] == 2 and set(info) == {"epoch", "best_acc1", "acc1",
                                                "acc5"}
    logged = json.loads((logs / "logger.json").read_text())["logged"]
    assert set(logged["train"]["loss"]) == {"1", "2"}
    assert set(logged["val"]["acc1"]) == {"1", "2"}
    rows = json.loads((logs / "results" / "val" /
                       "vqa_OpenEnded_mscoco_epoch_2.json").read_text())
    assert len(rows) == 64 and set(rows[0]) == {"question_id", "answer"}
    state = port_cli.main(_cli(path, "--epochs", "3", "--resume", "ckpt"))
    assert state.step == 3 * 4
    assert json.loads((logs / "ckpt_info.json").read_text())["epoch"] == 3


def test_train_cli_evaluate_and_trainval(tmp_path, monkeypatch):
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "float32")
    path, logs = _tiny_config(tmp_path)
    port_cli.main(_cli(path, "--epochs", "1"))
    res = port_cli.main(_cli(path, "-e", "--resume", "best"))
    assert set(res) == {"acc1", "acc5", "loss"} and np.isfinite(res["loss"])
    assert (logs / "results" / "val" /
            "vqa_OpenEnded_mscoco_epoch_0.json").is_file()
    (tmp_path / "tv").mkdir()
    path_tv, logs_tv = _tiny_config(tmp_path / "tv", trainsplit="trainval")
    port_cli.main(_cli(path_tv, "--epochs", "1"))
    rows = json.loads((logs_tv / "results" / "test2015" /
                       "vqa_OpenEnded_mscoco_epoch_1.json").read_text())
    dev = json.loads((logs_tv / "results" / "test-dev2015" /
                      "vqa_OpenEnded_mscoco_epoch_1.json").read_text())
    assert len(rows) == 64 and len(dev) == 32
    assert not (logs_tv / "best_info.json").exists()


def test_train_cli_device_rule_and_unported_flags(tmp_path, monkeypatch):
    path, _ = _tiny_config(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = [a for a in _cli(path, "--epochs", "1")
            if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="--device cpu"):
        port_cli.main(args)
    for extra in (["--mesh", "data=4"], ["--distributed"]):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            port_cli.main(_cli(path, "--epochs", "1", *extra))
    # without --synthetic the CLI reads the real data, and raises as the
    # JAX CLI does where it is missing
    opt = yaml.safe_load(open(path))
    opt["vqa"]["dir"] = str(tmp_path / "no_vqa")
    (tmp_path / "real.yaml").write_text(yaml.safe_dump(opt))
    with pytest.raises(FileNotFoundError, match="no_vqa"):
        port_cli.main(["--path_opt", str(tmp_path / "real.yaml"),
                       "--device", "cpu"])


def test_vqa_checkpoint_save_all_from_and_prefix(tmp_path, world):
    """Keep-all-from-epoch with the rolling delete that spares the best
    epoch, and the prefix rule of ``load_vqa_checkpoint``."""
    model = copy.deepcopy(world.pmodel)
    state = port_engine.init_vqa_state(model, lr=LR)
    d = str(tmp_path)
    port_ckpt.save_vqa_checkpoint({"epoch": 1, "best_acc1": 5.0}, state, d)
    for epoch in (2, 3, 4):
        state.step = epoch
        port_ckpt.save_vqa_checkpoint({"epoch": epoch}, state, d,
                                      save_all_from=2)
    names = sorted(os.listdir(d))
    assert "ckpt_model_epoch,4.pt" in names
    assert "ckpt_model_epoch,2.pt" not in names
    assert "ckpt_model_epoch,3.pt" not in names
    fresh = port_engine.init_vqa_state(copy.deepcopy(world.pmodel), lr=LR)
    info = port_ckpt.load_vqa_checkpoint(fresh, os.path.join(d, "best"))
    assert info == {"epoch": 1, "best_acc1": 5.0} and fresh.step == 0
    info = port_ckpt.load_vqa_checkpoint(fresh, d)
    assert info == {"epoch": 4}
