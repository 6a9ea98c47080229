"""MutanAtt pretraining in the PyTorch port against the JAX package: the
folded attention-MUTAN kernels' plain versions and their autograd
Function, ``MutanFusion2d.fuse_candidates``, MutanAtt, the train step,
trajectories, the weights and Adam carried across, the spatial batches
and the train CLI.

Sizes are small: 4 x 4 maps of dim_v 24, BayesianUniSkip 16 -> GRU 48,
attention MUTAN R 3 at 20 / 20 / 18 with two glimpses, classifier MUTAN R 3
at 40 / 20 / 18, 20 answers, T 10, B 8.  The same weights go to both
packages through ``models/port_torch`` / ``models/from_jax``.

Tolerances: f32 within rtol 1e-4 (params after Adam 1e-6 abs where the
gradient is away from Adam's eps); bf16 within 5e-2, with the JAX side
running its Pallas kernels in interpret mode (``VQACX_GRU_PALLAS`` /
``VQACX_ATT_PALLAS=interpret``) and the port its kernels' plain versions
(its folded-MUTAN gate, which opens only on the card, forced open).
The folded kernel against its plain version: bf16 outputs of f32 sums of
the same exact products in another order, within 8e-3 (about two bf16
steps) of the tensor's largest entry; f32 sums over examples within 1e-3.
JAX's kernel and JAX's XLA folded path round differently under bf16, so
each comparison names the one it holds against.
"""

import copy
import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from vqa_counterexamples_tpu.cli import train as jax_train_cli
from vqa_counterexamples_tpu.core import policy as jax_policy
from vqa_counterexamples_tpu.data.features import FeatureStore as JaxStore
from vqa_counterexamples_tpu.data.vqa_dataset import VQAArrays as JaxArrays
from vqa_counterexamples_tpu.engines import vqa_engine as jax_engine
from vqa_counterexamples_tpu.models import factory as jax_factory
from vqa_counterexamples_tpu.models import fusion as jax_fusion_mod
from vqa_counterexamples_tpu.models import port_torch
from vqa_counterexamples_tpu.ops import metrics as jax_metrics
from vqa_counterexamples_tpu.ops import rnn as jax_rnn
from vqa_counterexamples_tpu.ops.pallas.attmutan_kernel import (
    folded_mutan_pallas)
from vqa_counterexamples_tpu_torch.cli import train as port_cli
from vqa_counterexamples_tpu_torch.core import config as port_config
from vqa_counterexamples_tpu_torch.core import spans
from vqa_counterexamples_tpu_torch.data.features import FeatureStore
from vqa_counterexamples_tpu_torch.data.vqa_dataset import VQAArrays
from vqa_counterexamples_tpu_torch.engines import vqa_engine as port_engine
from vqa_counterexamples_tpu_torch.models import factory as port_factory
from vqa_counterexamples_tpu_torch.models import fusion as port_fusion_mod
from vqa_counterexamples_tpu_torch.models import from_jax
from vqa_counterexamples_tpu_torch.ops import fusion as port_fusion
from vqa_counterexamples_tpu_torch.ops import rnn as port_rnn
from vqa_counterexamples_tpu_torch.ops.cuda import attmutan_kernel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T, LR = 8, 10, 1e-3
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


# ------------------------------------------------- the folded kernels

def _folded_case(batch, k, dh, rank, m, seed=0):
    """JAX layout (x_v bf16 values, w3 (Dh, R, M) bf16 values, b3 (R, M),
    hq (B, R, M) f32) and the cotangent g (bf16 values)."""
    rng = np.random.default_rng(seed)
    x_v = _bf16(rng.normal(size=(batch, k, dh)) * 0.5)
    w3 = _bf16(rng.normal(size=(dh, rank, m)) * 0.2)
    b3 = (rng.normal(size=(rank, m)) * 0.1).astype(np.float32)
    hq = (rng.normal(size=(batch, rank, m)) * 0.5).astype(np.float32)
    g = _bf16(rng.normal(size=(batch, k, m)) * 0.1)
    return x_v, w3, b3, hq, g


def _port_w(w3):
    """(Dh, R, M) -> the stacked per-rank Linear weight (R*M, Dh)."""
    dh, rank, m = w3.shape
    return np.ascontiguousarray(w3.transpose(1, 2, 0).reshape(rank * m, dh))


def _jax_folded_vjp(x_v, w3, b3, hq, g):
    args = (jnp.asarray(x_v, jnp.bfloat16), jnp.asarray(w3, jnp.bfloat16),
            jnp.asarray(b3), jnp.asarray(hq))
    out, vjp = jax.vjp(lambda *a: folded_mutan_pallas(*a, True), *args)
    return out, vjp(jnp.asarray(g, jnp.bfloat16))


# K off the sublane multiple, Dh and M off 16 and the lane multiple
_FOLDED_SHAPES = [(3, 13, 22, 4, 30), (2, 70, 40, 2, 50)]


@pytest.mark.parametrize("batch,k,dh,rank,m", _FOLDED_SHAPES)
def test_folded_plain_matches_pallas(batch, k, dh, rank, m):
    """``folded_mutan_plain`` and ``folded_mutan_bwd_plain`` against
    ``folded_mutan_pallas`` in interpret mode and ``jax.vjp`` of it: the
    output, dx_v, dw (JAX's f32 sum rounded to w's bf16), db, dhq."""
    x_v, w3, b3, hq, g = _folded_case(batch, k, dh, rank, m, seed=k)
    out_j, (dxv_j, dw3_j, db3_j, dhq_j) = _jax_folded_vjp(x_v, w3, b3, hq, g)
    args = (_t(x_v, BF16), _t(_port_w(w3), BF16), _t(b3.reshape(-1)),
            _t(hq))
    out = attmutan_kernel.folded_mutan_plain(*args)
    assert out.dtype == BF16 and out.shape == (batch, k, m)
    _assert_rel(out, np.asarray(out_j, np.float32), 8e-3, "out")
    dxv, dw, db, dhq = attmutan_kernel.folded_mutan_bwd_plain(
        *args, _t(g, BF16))
    assert [t.dtype for t in (dxv, dw, db, dhq)] == [
        BF16, torch.float32, torch.float32, BF16]
    _assert_rel(dxv, np.asarray(dxv_j, np.float32), 8e-3, "dx_v")
    _assert_rel(_bf16(_np(dw)), _port_w(np.asarray(dw3_j, np.float32)),
                8e-3, "dw")
    _assert_rel(db, np.asarray(db3_j).reshape(-1), 1e-3, "db")
    _assert_rel(dhq, np.asarray(dhq_j, np.float32), 8e-3, "dhq")


def test_folded_function_grads_match_jax_vjp():
    """``FoldedMutan`` (the wrappers' plain versions on the CPU) against
    ``jax.vjp`` of the TPU kernel: the gradients reach each input in its
    own dtype (x_v, w bf16; b, hq f32), as the custom VJP casts them."""
    x_v, w3, b3, hq, g = _folded_case(4, 21, 30, 3, 40, seed=5)
    _, ref = _jax_folded_vjp(x_v, w3, b3, hq, g)
    leaves = [_t(x_v, BF16).requires_grad_(),
              _t(_port_w(w3), BF16).requires_grad_(),
              _t(b3.reshape(-1)).requires_grad_(), _t(hq).requires_grad_()]
    before = spans.counters()["kernels.launches.attmutan"]
    out = port_fusion.FoldedMutan.apply(*leaves)
    out.backward(_t(g, BF16))
    # the CPU: plain
    assert spans.counters()["kernels.launches.attmutan"] == before
    assert [t.grad.dtype for t in leaves] == [BF16, BF16, torch.float32,
                                              torch.float32]
    refs = [np.asarray(ref[0], np.float32),
            _port_w(np.asarray(ref[1], np.float32)),
            np.asarray(ref[2]).reshape(-1), np.asarray(ref[3])]
    for name, leaf, r in zip(("x_v", "w", "b", "hq"), leaves, refs):
        _assert_rel(leaf.grad, r, 1e-2, name)


def test_folded_forward_wrapper_refuses_grad():
    x_v, w3, b3, hq, _ = _folded_case(2, 5, 8, 2, 6)
    with pytest.raises(RuntimeError, match="forward-only"):
        attmutan_kernel.folded_mutan(_t(x_v, BF16).requires_grad_(),
                                     _t(_port_w(w3), BF16),
                                     _t(b3.reshape(-1)), _t(hq))


_ATT_FUSION = {"dim_hv": 20, "dim_hq": 20, "dim_mm": 18, "R": 3,
               "dropout_v": 0.5, "dropout_q": 0.5, "dropout_mm": 0.5,
               "activation_v": "tanh", "activation_q": "tanh",
               "dropout_hv": 0, "dropout_hq": 0}


def _force_att_kernel(monkeypatch, open_):
    """Force the port's folded-MUTAN gate (on the CPU the kernels' wrappers
    run their plain versions)."""
    monkeypatch.setattr(port_fusion_mod, "att_kernel_ok",
                        lambda *a: open_)


def test_att_kernel_gate():
    """The folded kernels only for tensors on the card, under the bf16
    policy, at the spatial scale (k1 >= 64), as JAX's gate on the TPU."""
    gate, cuda = port_fusion_mod.att_kernel_ok, torch.device("cuda")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VQACX_COMPUTE_DTYPE", "bfloat16")
        assert gate(64, cuda) and gate(196, cuda)
        assert not gate(63, cuda) and not gate(25, cuda)
        assert not gate(196, torch.device("cpu"))
        mp.setenv("VQACX_COMPUTE_DTYPE", "float32")
        assert not gate(196, cuda)


# (policy, JAX's VQACX_ATT_PALLAS, the port's gate forced or None, k1)
@pytest.mark.parametrize("dtype,mode,force,k1", [
    ("float32", "auto", None, 16), ("bfloat16", "interpret", True, 16),
    ("bfloat16", "0", None, 16), ("bfloat16", "auto", None, 64),
    ("bfloat16", "auto", None, 2)])
def test_fuse_candidates_matches_jax(monkeypatch, dtype, mode, force, k1):
    """``MutanFusion2d.fuse_candidates`` with both embeddings off (the
    attention stage, training mode: the module draws no dropout) against
    JAX: the kernel branch (JAX's in interpret mode, the port's gate forced
    open and its plain versions, bf16 out), the XLA folded branch (f32 out;
    at k1 64 both gates closed off the card), and the rank rows (K < R).
    Output and the gradients of the inputs and of every weight: f32 rtol
    1e-4, bf16 within 2e-2 of the largest entry."""
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", dtype)
    monkeypatch.setenv("VQACX_ATT_PALLAS", mode)
    if force is not None:
        _force_att_kernel(monkeypatch, force)
    port = port_fusion_mod.MutanFusion2d(_ATT_FUSION, visual_embedding=False,
                                         question_embedding=False)
    port.reset_parameters(torch.Generator().manual_seed(0))
    assert not hasattr(port, "linear_v") and not hasattr(port, "linear_q")
    params = port_torch.port_mutan_fusion(port.state_dict())
    assert set(params) == {"w_hv", "b_hv", "w_hq", "b_hq"}
    rng = np.random.default_rng(1)
    x_v = np.tanh(rng.normal(size=(B, k1, 20))).astype(np.float32)
    x_q = np.tanh(rng.normal(size=(B, 20))).astype(np.float32)
    g = rng.normal(size=(B, k1, 18)).astype(np.float32)
    jmod = jax_fusion_mod.MutanFusion2d(_ATT_FUSION, visual_embedding=False,
                                        question_embedding=False)

    def loss(p, v, q):
        out = jmod.apply({"params": p}, v, q, deterministic=False,
                         method=jax_fusion_mod.MutanFusion.fuse_candidates)
        return jnp.sum(out.astype(jnp.float32) * g), out

    with jax_policy.compute_dtype_scope(dtype):
        (_, ref), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                             has_aux=True)(
            jax.tree.map(jnp.asarray, params), jnp.asarray(x_v),
            jnp.asarray(x_q))
    v, q = _t(x_v).requires_grad_(), _t(x_q).requires_grad_()
    out = port.fuse_candidates(v, q, training=True)
    (out.float() * _t(g)).sum().backward()
    assert out.dtype == (BF16 if mode == "interpret" else torch.float32)
    assert ref.dtype == (jnp.bfloat16 if mode == "interpret"
                         else jnp.float32)
    ref_sd = {}
    from_jax._mutan(ref_sd, "", jax.device_get(grads[0]), 18)
    pairs = [("out", out, ref), ("x_v", v.grad, grads[1]),
             ("x_q", q.grad, grads[2])]
    pairs += [(n, p.grad, ref_sd[n]) for n, p in port.named_parameters()]
    for name, got, r in pairs:
        if dtype == "float32":
            r = np.asarray(r, np.float32)
            np.testing.assert_allclose(_np(got), r, rtol=1e-4,
                                       atol=1e-5 * np.abs(r).max(),
                                       err_msg=name)
        else:
            _assert_rel(got, r, 2e-2, name)


# ------------------------------------------------------------- the model

def tiny_options(dropout=0.0, gru_dropout=0.0, n_answers=20):
    drops = dict(dropout_v=dropout, dropout_q=dropout)
    return {
        "arch": "MutanAtt", "dim_v": 24, "dim_q": 48,
        "seq2vec": {"arch": "skipthoughts", "type": "BayesianUniSkip",
                    "dropout": gru_dropout, "fixed_emb": False,
                    "emb_size": 16, "hidden_size": 48},
        "attention": dict(_ATT_FUSION, nb_glimpses=2, dropout_mm=dropout,
                          **drops),
        "fusion": {"dim_hv": 40, "dim_hq": 20, "dim_mm": 18, "R": 3,
                   "activation_v": "tanh", "activation_q": "tanh",
                   "dropout_hv": 0, "dropout_hq": 0, **drops},
        "classif": {"dropout": dropout},
    }


def _shift_free(name: str) -> bool:
    """Biases that shift every position's attention score alike (conv_att's,
    and the attention fusion's visual rank biases, which reach every
    position as the same per-example term): the softmax over the positions
    cannot see them, so their gradient is 0 up to rounding."""
    return name == "conv_att.bias" or (
        name.startswith("fusion_att.list_linear_hv.")
        and name.endswith(".bias"))


def _cli_options(opt):
    return {"vqa": {"nans": 20, "maxlength": T, "trainsplit": "train",
                    "samplingans": True},
            "coco": {"mode": "att"}, "model": opt}


def _small_maps(store, side=4):
    """The synthetic 14 x 14 maps cut to side x side (a copy)."""
    return FeatureStore(np.ascontiguousarray(
        store.features[:, :side, :side]), store.names)


def build_att_pair(words, answers, opt, seed=0):
    """(jax model, jax params, port model) with the same weights: the
    port's seeded init (unit-scale word embeddings) read into the flax tree
    by ``port_torch``, and back into a second port model by
    ``from_jax``."""
    jmodel = jax_factory.factory_vqa(opt, words, answers)
    source = port_engine.init_vqa_params(
        port_factory.factory_vqa(opt, words, answers), seed=seed)
    with torch.no_grad():
        source.seq2vec.embedding.weight.normal_(
            0.0, 1.0, generator=torch.Generator().manual_seed(seed + 1))
    params, arch = port_torch.port_vqa_state_dict(source.state_dict())
    assert arch == "MutanAtt"
    params = jax.tree.map(np.asarray, params)
    pmodel = port_factory.factory_vqa(opt, words, answers)
    pmodel.load_state_dict(from_jax.vqa_state_dict_from_jax(params))
    return jmodel, params, pmodel


@pytest.fixture(scope="module")
def world():
    opt = tiny_options()
    examples, store, words, answers = port_cli._synthetic_vqa(
        48, _cli_options(opt), seed=5)
    store = _small_maps(store)
    jmodel, params, pmodel = build_att_pair(words, answers, opt, seed=3)
    arrays = VQAArrays(examples, store, samplingans=True)
    order = np.random.default_rng(0)
    batches = [b for _ in range(3) for b in arrays.batches(
        B, shuffle=True, rng=order, drop_remainder=True)]
    return SimpleNamespace(opt=opt, jmodel=jmodel, params=params,
                           pmodel=pmodel, store=store, arrays=arrays,
                           batches=batches, words=words, answers=answers)


def _as_port(tree) -> dict:
    """A JAX MutanAtt tree (params, grads, moments) under the port's
    names."""
    return {k: v.numpy() for k, v in from_jax.vqa_state_dict_from_jax(
        jax.device_get(tree)).items()}


def _jbatch(b):
    return {"visual": jnp.asarray(b["visual"]),
            "question": jnp.asarray(b["question"]),
            "answer": jnp.asarray(b["answer"])}


def _pbatch(b):
    return dict(b, visual=_t(b["visual"]))


def _jax_state(params, optimizer):
    params = jax.tree.map(jnp.asarray, params)
    return jax_engine.VQATrainState(params, optimizer.init(params),
                                    jnp.zeros((), jnp.int32))


@pytest.fixture(params=["float32", "bfloat16"])
def dtype(request, monkeypatch):
    if request.param == "bfloat16":
        monkeypatch.setenv("VQACX_GRU_PALLAS", "interpret")
        monkeypatch.setenv("VQACX_ATT_PALLAS", "interpret")
        _force_att_kernel(monkeypatch, True)
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", request.param)
    with jax_policy.compute_dtype_scope(request.param):
        yield request.param


def _inject_gru_masks(monkeypatch, batch, dim_in, dim_h, seed=0):
    """The same per-gate variational masks (keep 192/256, scale 256/192)
    into both packages' BayesianUniSkip: JAX's keep-mask draws in
    ``ops/rnn.gru_scan`` and the port's ``variational_masks``."""
    rng = np.random.default_rng(seed)
    keep = {dim_in: rng.random((3, batch, dim_in)) < 0.75,
            dim_h: rng.random((3, batch, dim_h)) < 0.75}
    scale = 256.0 / 192

    def jax_keep_mask(key, keep_prob, shape):
        return jnp.asarray(keep[shape[-1]]), scale

    def port_masks(generator, dropout, b, d_in, d_h, per_gate=True):
        return (_t(keep[d_in] * scale), _t(keep[d_h] * scale))

    monkeypatch.setattr(jax_rnn.rng_lib, "keep_mask", jax_keep_mask)
    monkeypatch.setattr(port_rnn, "variational_masks", port_masks)


def test_mutan_att_forward_and_grads_match_jax(world, dtype, monkeypatch):
    """Logits, the attention maps and the gradient of every parameter in
    training mode: the encoder's per-gate masks injected on both sides,
    every other dropout at 0.  f32 rtol 1e-4; bf16 within 5e-2 (JAX's
    Pallas GRU and folded kernels in interpret mode, the port's plain
    versions)."""
    w = world
    opt = tiny_options(gru_dropout=0.25)
    jmodel = jax_factory.factory_vqa(opt, w.words, w.answers)
    _inject_gru_masks(monkeypatch, B, 16, 48)
    b = w.batches[0]
    g = np.random.default_rng(1).normal(size=(B, 20)).astype(np.float32)

    def loss_fn(params):
        out, att = jmodel.apply({"params": params}, jnp.asarray(b["visual"]),
                                jnp.asarray(b["question"]),
                                deterministic=False, return_att=True,
                                rngs={"dropout": jax.random.key(0)})
        return jnp.sum(out * g), (out, att)

    (_, (ref, ref_att)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, w.params))
    model = port_factory.factory_vqa(opt, w.words, w.answers)
    model.load_state_dict(w.pmodel.state_dict())
    out, att = model(_t(b["visual"]), torch.from_numpy(b["question"]),
                     training=True, generator=torch.Generator().manual_seed(0),
                     return_att=True)
    (out * _t(g)).sum().backward()
    assert out.dtype == torch.float32 and out.shape == (B, 20)
    assert att.shape == (B, 2, 16)
    ref_g = _as_port(grads)
    named = dict(model.named_parameters())
    assert set(ref_g) == set(named)
    for name in [n for n in ref_g if _shift_free(n)]:
        # 0 up to rounding on both sides, against the weight's gradient
        scale = np.abs(ref_g[name.replace("bias", "weight")]).max()
        rel = 1e-3 if dtype == "float32" else 5e-2
        for grad in (_np(named[name].grad), ref_g.pop(name)):
            assert np.abs(grad).max() <= rel * scale, name
    if dtype == "float32":
        np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(_np(att), np.asarray(ref_att), rtol=1e-4,
                                   atol=1e-6)
        for name, r in ref_g.items():
            np.testing.assert_allclose(_np(named[name].grad), r, rtol=1e-4,
                                       atol=1e-5 * max(np.abs(r).max(), 1e-3),
                                       err_msg=name)
    else:
        np.testing.assert_allclose(_np(out), np.asarray(ref, np.float32),
                                   rtol=5e-2, atol=5e-2)
        _assert_rel(att, np.asarray(ref_att, np.float32), 5e-2, "att")
        for name, r in ref_g.items():
            _assert_rel(named[name].grad, r, 5e-2, name)


def test_mutan_att_eval_matches_jax(world, dtype):
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


def test_mutan_att_needs_maps_and_mlb_is_not_ported(world):
    """MutanAtt refuses pooled features; the factory now builds MLBAtt
    from the same tree (tests/test_torch_mlb.py holds it against JAX), and
    an arch it does not know raises ``ValueError`` as JAX's does."""
    with pytest.raises(ValueError, match="feature maps"):
        world.pmodel(torch.zeros(2, 24), torch.zeros(2, 3, dtype=torch.long))
    opt = copy.deepcopy(dict(tiny_options(), arch="MLBAtt"))
    opt["attention"]["dim_h"] = opt["fusion"]["dim_h"] = 20
    mlb = port_factory.factory_vqa(opt, world.words, world.answers)
    assert type(mlb).__name__ == "MLBAtt" and not hasattr(mlb, "fusion_att")
    with pytest.raises(ValueError, match="arch"):
        port_factory.factory_vqa(dict(opt, arch="NoSuchAtt"), world.words,
                                 world.answers)
    m = world.pmodel
    assert m.opt["attention"]["dim_v"] == 20 and m.opt["attention"][
        "dim_q"] == 20
    assert tuple(m.conv_v_att.weight.shape) == (20, 24, 1, 1)
    assert tuple(m.conv_att.weight.shape) == (2, 18, 1, 1)
    assert tuple(m.list_linear_v_fusion[1].weight.shape) == (20, 24)


def _assert_adam_close(got, ref, grad, name):
    """Params after one Adam step from the same start; the first update is
    -lr g / (|g| + eps), which swings between -lr and lr where |g| is near
    eps: those entries are held to 2 lr, the rest to 1e-6."""
    steady = np.abs(grad) > 1e-6
    np.testing.assert_allclose(got[steady], ref[steady], rtol=0, atol=1e-6,
                               err_msg=name)
    assert np.abs(got - ref).max() <= 2 * LR + 1e-6, name


def test_att_train_step_matches_jax_f32(world, monkeypatch):
    """One ``make_vqa_train_step`` (every dropout at 0): loss, acc@1,
    acc@5, the gradient of every parameter and every parameter after
    Adam."""
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "float32")
    w = world
    b = w.batches[0]
    opt = optax.adam(LR)
    with jax_policy.compute_dtype_scope("float32"):
        jstate = _jax_state(w.params, opt)
        jb = _jbatch(b)

        def loss_fn(p):
            out = w.jmodel.apply({"params": p}, jb["visual"], jb["question"],
                                 deterministic=False,
                                 rngs={"dropout": jax.random.key(0)})
            return jax_metrics.cross_entropy_mean(out, jb["answer"])

        jgrads = _as_port(jax.jit(jax.grad(loss_fn))(jstate.params))
        jstep = jax_engine.make_vqa_train_step(w.jmodel, opt)
        jstate, jm = jstep(jstate, jb)
        jnew = _as_port(jstate.params)
    model = copy.deepcopy(w.pmodel)
    state = port_engine.init_vqa_state(model, lr=LR)
    step = port_engine.make_vqa_train_step(model, state.optimizer)
    state, pm = step(state, _pbatch(b))
    assert state.step == 1
    for k in ("loss", "acc1", "acc5"):
        assert float(pm[k]) == pytest.approx(float(jm[k]), rel=1e-5), k
    named = dict(model.named_parameters())
    assert set(jgrads) == set(named)
    for name, ref in jgrads.items():
        np.testing.assert_allclose(
            named[name].grad.numpy(), ref, rtol=1e-4,
            atol=1e-5 * max(np.abs(ref).max(), 1e-3), err_msg=name)
        _assert_adam_close(named[name].detach().numpy(), jnew[name], ref,
                           name)


def _run_pair(w, model, batches, opt, jstate, pstate):
    jstep = jax_engine.make_vqa_train_step(w.jmodel, opt)
    pstep = port_engine.make_vqa_train_step(model, pstate.optimizer)
    losses = []
    for b in batches:
        jstate, jm = jstep(jstate, _jbatch(b))
        pstate, pm = pstep(pstate, _pbatch(b))
        losses.append((float(jm["loss"]), float(pm["loss"])))
    return np.array(losses), jstate, pstate


def test_att_trajectory_bf16_tracks_jax(world, monkeypatch):
    """10 steps under the bf16 policy (every dropout at 0): the JAX step
    runs the GRU and folded-MUTAN Pallas kernels in interpret mode, the
    port their plain versions; per-step losses within 5e-2 relative."""
    monkeypatch.setenv("VQACX_GRU_PALLAS", "interpret")
    monkeypatch.setenv("VQACX_ATT_PALLAS", "interpret")
    _force_att_kernel(monkeypatch, True)
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
    assert losses[-3:, 1].mean() < losses[:3, 1].mean()  # it learns


def test_att_weights_round_trip_through_port_torch(world):
    """state_dict -> ``port_torch.port_vqa_state_dict`` -> flax tree (the
    tree JAX's init builds, leaf for leaf) -> ``from_jax`` -> the same
    state_dict."""
    w = world
    sd = w.pmodel.state_dict()
    params, arch = port_torch.port_vqa_state_dict(sd)
    assert arch == "MutanAtt"
    init = w.jmodel.init(jax.random.key(0), jnp.asarray(w.batches[0][
        "visual"]), jnp.asarray(w.batches[0]["question"]))["params"]

    def leaves(tree):
        flat, _ = jax.tree_util.tree_flatten_with_path(tree)
        return sorted((jax.tree_util.keystr(p), tuple(np.shape(a)))
                      for p, a in flat)

    assert leaves(params) == leaves(init)
    back = from_jax.vqa_state_dict_from_jax(jax.tree.map(np.asarray,
                                                         params))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].shape == v.shape, k
        np.testing.assert_array_equal(back[k].numpy(), v.numpy(),
                                      err_msg=k)


def test_att_adam_state_carried_from_jax(world, monkeypatch):
    """3 JAX steps, then params and optax's mu / nu / count carried into a
    fresh port MutanAtt and ``torch.optim.Adam``: step 4 agrees."""
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "float32")
    w = world
    opt = optax.adam(LR)
    with jax_policy.compute_dtype_scope("float32"):
        jstep = jax_engine.make_vqa_train_step(w.jmodel, opt)
        jstate = _jax_state(w.params, opt)
        for b in w.batches[:3]:
            jstate, _ = jstep(jstate, _jbatch(b))
        host = jax.device_get(jstate)
        model = copy.deepcopy(w.pmodel)
        model.load_state_dict(from_jax.vqa_state_dict_from_jax(host.params))
        state = port_engine.init_vqa_state(model, lr=LR)
        from_jax.vqa_adam_state_from_jax(host.opt_state, model,
                                         state.optimizer)
        state.step = 3
        losses, jstate, state = _run_pair(w, model, w.batches[3:4], opt,
                                          jstate, state)
        jnew = _as_port(jstate.params)
    assert float(state.optimizer.state[model.conv_v_att.weight]["step"]) == 4
    np.testing.assert_allclose(losses[:, 1], losses[:, 0], rtol=1e-4)
    for name, p in model.named_parameters():
        # Adam turns a rounding-noise gradient into a step of up to lr
        atol = 2 * LR if _shift_free(name) else 1e-6
        np.testing.assert_allclose(p.detach().numpy(), jnew[name], rtol=0,
                                   atol=atol, err_msg=name)


# ------------------------------------------------------------------- data

@pytest.mark.parametrize("drop_remainder", [False, True])
def test_spatial_batches_match_jax_thread_path(drop_remainder):
    """Host-gathered att-map batches (the next one prefetched on a worker
    thread) against the JAX package's thread path for one numpy ``rng``,
    bit for bit; in-memory stores on both sides."""
    opt = _cli_options(tiny_options())
    examples, store, _, _ = port_cli._synthetic_vqa(45, opt, 2)
    store = _small_maps(store, side=3)
    rng = np.random.default_rng(4)
    for ex in examples:   # several human answers per question to sample
        ex["answers_aid"] = sorted({ex["answer_aid"],
                                    int(rng.integers(0, 20))})
        ex["answers_count"] = [int(c) for c in
                               rng.integers(1, 10, len(ex["answers_aid"]))]
    a_port = VQAArrays(examples, store, samplingans=True)
    a_jax = JaxArrays(examples, JaxStore(store.features, store.names),
                      samplingans=True)
    got = list(a_port.batches(8, shuffle=True, rng=np.random.default_rng(1),
                              drop_remainder=drop_remainder))
    ref = list(a_jax.batches(8, shuffle=True, rng=np.random.default_rng(1),
                             drop_remainder=drop_remainder))
    assert len(got) == len(ref) == (5 if drop_remainder else 6)
    for gp, gj in zip(got, ref):
        assert gp.keys() == gj.keys()
        for k in ("question", "answer", "question_id", "visual"):
            np.testing.assert_array_equal(gp[k], gj[k])
            assert gp[k].dtype == gj[k].dtype
    assert got[0]["visual"].shape == (8, 3, 3, 24)


def test_feature_store_rows(tmp_path):
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(6, 2, 2, 3)).astype(np.float32)
    store = FeatureStore(feats, ["n%d" % i for i in range(6)])
    assert store.row_shape == (2, 2, 3) and len(store) == 6
    rows = np.array([4, 1, 4])
    out = np.empty((3, 2, 2, 3), np.float32)
    assert store.gather_rows(rows, out=out) is out
    np.testing.assert_array_equal(out, feats[rows])
    np.testing.assert_array_equal(store.gather_rows(rows), feats[rows])


# ------------------------------------------------------------------- CLI

def _tiny_config(tmp_path):
    opt = port_config.load_options_file(
        os.path.join(REPO, "configs", "vqa2", "mutan_att_train.yaml"))
    model = opt["model"]
    model.update(dim_v=24, dim_q=48)
    model["seq2vec"].update(emb_size=16, hidden_size=48,
                            dir_st=str(tmp_path / "no_st"))
    model["attention"].update(dim_hv=20, dim_hq=20, dim_mm=18, R=3)
    model["fusion"].update(dim_hv=40, dim_hq=20, dim_mm=18, R=3)
    opt["vqa"].update(maxlength=T)
    opt["logs"]["dir_logs"] = str(tmp_path / "logs")
    path = tmp_path / "tiny_att.yaml"
    path.write_text(yaml.safe_dump(opt))
    return str(path), tmp_path / "logs"


def test_train_cli_mutan_att(tmp_path, monkeypatch):
    """MutanAtt through the train CLI on the CPU (14 x 14 synthetic maps
    gathered on the host): the ``ckpt_*`` files, ``logger.json``, the val
    rows, a resumed epoch, and ``-e``."""
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "float32")
    path, logs = _tiny_config(tmp_path)
    base = ["--path_opt", path, "--synthetic", "32", "-b", "8", "--device",
            "cpu", "-p", "2"]
    state = port_cli.main(base + ["--epochs", "1"])
    assert state.step == 4
    assert type(state.model).__name__ == "MutanAtt"
    names = sorted(os.listdir(logs))
    for suffix in ("info.json", "model.msgpack", "optim.msgpack"):
        assert "ckpt_" + suffix in names
    logged = json.loads((logs / "logger.json").read_text())["logged"]
    assert set(logged["val"]["acc1"]) == {"1"}
    rows = json.loads((logs / "results" / "val" /
                       "vqa_OpenEnded_mscoco_epoch_1.json").read_text())
    assert len(rows) == 32
    state = port_cli.main(base + ["--epochs", "2", "--resume", "ckpt"])
    assert state.step == 8
    res = port_cli.main(base + ["-e", "--resume", "ckpt"])
    assert set(res) == {"acc1", "acc5", "loss"} and np.isfinite(res["loss"])


def test_synthetic_att_data_matches_jax():
    opt = _cli_options(tiny_options())
    ex_p, store_p, _, _ = port_cli._synthetic_vqa(20, opt, 3)
    ex_j, store_j, _, _ = jax_train_cli._synthetic_vqa(20, opt, 3)
    assert ex_p == ex_j
    assert store_p.features.shape == (64, 14, 14, 24)
    np.testing.assert_array_equal(store_p.features, store_j.features)


@pytest.mark.parametrize("batch,k,dh,rank,m", [
    (128, 196, 310, 5, 510), (3, 5, 20, 2, 24), (5, 70, 72, 3, 130),
    (2, 65, 40, 1, 64), (1, 196, 310, 5, 510), (13, 37, 42, 3, 66),
    (3, 9, 21, 2, 25), (2, 20, 30, 7, 40), (300, 196, 310, 5, 510)])
def test_folded_bwd_plan(batch, k, dh, rank, m):
    """The folded backward's launch plan (``attmutan_kernel.bwd_plan``, a
    pure function the kernels take as given): its 8 example groups, the
    bounds the dweff CTAs of a cluster read, cover every example exactly
    once, in order, ceil(B / 8) at most each; each launch's shared memory
    fits the H100's 232,448 bytes; the scratch the kernels add in a fixed
    order.  The shapes are the card tests'
    (``tests/test_torch_cuda.py::_ATT_BWD_SHAPES``), MutanAtt's first, and
    a batch past 8 * 32."""
    from vqa_counterexamples_tpu_torch.ops.cuda import attmutan_kernel

    plan = attmutan_kernel.bwd_plan(batch, k, dh, rank, m)
    groups = plan["groups"]
    assert len(groups) == 8
    assert [b for lo, hi in groups for b in range(lo, hi)] == list(
        range(batch))
    assert all(hi - lo <= -(-batch // 8) for lo, hi in groups)
    assert groups[0][0] == 0 and groups[-1][1] == batch
    assert all(g0[1] == g1[0] for g0, g1 in zip(groups, groups[1:]))
    assert plan["dx_smem"] <= 232448 and plan["dweff_smem"] <= 232448
    assert 2 <= plan["dx_stages"] <= 4
    assert plan["scratch"] == {"pdhq": (-(-dh // 64), batch, rank, m),
                               "gsum": (batch, m)}
    if (batch, k, dh, rank, m) == (128, 196, 310, 5, 510):
        # two dweff CTAs fit an SM
        assert 2 * (plan["dweff_smem"] + 1024) <= 233472


@pytest.mark.parametrize("batch,k,dh,rank,m", [
    (128, 196, 310, 5, 510), (3, 5, 20, 2, 24), (5, 70, 72, 3, 130),
    (2, 65, 40, 1, 64), (1, 196, 310, 5, 510), (13, 37, 42, 3, 66),
    (3, 9, 21, 2, 25), (2, 20, 30, 7, 40), (2, 9, 400, 2, 40),
    (2, 9, 1536, 2, 40)])
def test_folded_fwd_plan(batch, k, dh, rank, m):
    """The folded forward's launch plan (``attmutan_kernel.fwd_plan``, a
    pure function the kernel takes as given): its CTAs cover every example
    and every column of M; every configuration that the plan can be asked
    for fits the H100's 232,448 bytes with a ring of 2 to its limit; the
    plan takes the first that fits (at MutanAtt's shape, 256 of M and two
    warpgroups a CTA).  The shapes are the
    card tests' (``tests/test_torch_cuda.py::_ATT_FWD_SHAPES``), MutanAtt's
    first."""
    from vqa_counterexamples_tpu_torch.ops.cuda import attmutan_kernel

    plan = attmutan_kernel.fwd_plan(batch, k, dh, rank, m)
    nb, grid = plan["nb"], plan["grid"]
    assert grid == (-(-m // nb), batch)
    assert sorted({c for i in range(grid[0]) for c in range(
        i * nb, min(m, (i + 1) * nb))}) == list(range(m))
    dc = -(-dh // 64)
    fits = []
    for nb_c, nwg, most in attmutan_kernel.FWD_CONFIGS:
        if attmutan_kernel.fwd_smem(nb_c, nwg, dc, rank, 2) > 232448:
            continue
        fits.append((nb_c, nwg))
        c = attmutan_kernel.fwd_plan(batch, k, dh, rank, m, (nb_c, nwg))
        assert c["smem"] <= 232448 and 2 <= c["stages"] <= most
        assert c["smem"] == attmutan_kernel.fwd_smem(nb_c, nwg, dc, rank,
                                                     c["stages"])
        assert c["stages"] == most or attmutan_kernel.fwd_smem(
            nb_c, nwg, dc, rank, c["stages"] + 1) > 232448
    assert (plan["nb"], plan["nwg"]) == fits[0]
    if (batch, k, dh, rank, m) == (128, 196, 310, 5, 510):
        assert (nb, plan["nwg"], plan["stages"]) == (256, 2, 3)


def test_folded_fwd_plan_refuses_what_does_not_fit():
    from vqa_counterexamples_tpu_torch.ops.cuda import attmutan_kernel

    with pytest.raises(ValueError, match="shared memory"):
        attmutan_kernel.fwd_plan(4, 10, 1700, 5, 510)
    with pytest.raises(ValueError, match="configuration"):
        attmutan_kernel.fwd_plan(4, 10, 64, 5, 510, (96, 1))


def test_folded_bwd_plan_refuses_what_does_not_fit():
    from vqa_counterexamples_tpu_torch.ops.cuda import attmutan_kernel

    with pytest.raises(ValueError, match="shared memory"):
        attmutan_kernel.bwd_plan(4, 10, 64, 5, 700)
