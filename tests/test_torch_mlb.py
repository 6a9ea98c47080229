"""The MLB family of the PyTorch port against the JAX package:
``MLBFusion``, ``MLBNoAtt`` and ``MLBAtt`` (logits, attention maps and
every gradient), one train step and a 30-step MLBNoAtt trajectory, the
factory's dim tying, the weights through ``port_torch`` / ``from_jax``
both ways with a reference-named torch oracle as a third arm, the UniSkip
encoder's no-mask training path, NeuralCX over an MLB backbone (caches,
the mixture gate closed by the head's tanh), and the train and CX CLIs on
narrowed copies of the MLB YAMLs.

Sizes: dim_v 24 (NeuralCX's 128), UniSkip / BayesianUniSkip 16 -> GRU 48,
MLB dim_h 32, 4 x 4 maps with two glimpses, 20 answers, T 10, B 8.
Tolerances: f32 within rtol 1e-4; bf16 within 5e-2 (the JAX side's GRU
through its Pallas kernels in interpret mode, the port's plain versions);
params after one Adam step within 1e-6 where the gradient is away from
Adam's eps, else 2 lr.
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
from torch import nn

from vqa_counterexamples_tpu.core import policy as jax_policy
from vqa_counterexamples_tpu.data import synthetic as jax_synthetic
from vqa_counterexamples_tpu.data import vqacx as jax_vqacx
from vqa_counterexamples_tpu.engines import cx_engine as jax_cx_engine
from vqa_counterexamples_tpu.engines import vqa_engine as jax_engine
from vqa_counterexamples_tpu.models import factory as jax_factory
from vqa_counterexamples_tpu.models import fusion as jax_fusion
from vqa_counterexamples_tpu.models import port_torch
from vqa_counterexamples_tpu.models import seq2vec as jax_seq2vec
from vqa_counterexamples_tpu.ops import metrics as jax_metrics
from vqa_counterexamples_tpu_torch.cli import counterexamples as port_cx_cli
from vqa_counterexamples_tpu_torch.cli import train as port_cli
from vqa_counterexamples_tpu_torch.core import config as port_config
from vqa_counterexamples_tpu_torch.data import vqacx as port_vqacx
from vqa_counterexamples_tpu_torch.data.vqa_dataset import VQAArrays
from vqa_counterexamples_tpu_torch.engines import cx_engine as port_cx_engine
from vqa_counterexamples_tpu_torch.engines import vqa_engine as port_engine
from vqa_counterexamples_tpu_torch.models import factory as port_factory
from vqa_counterexamples_tpu_torch.models import fusion as port_fusion
from vqa_counterexamples_tpu_torch.models import from_jax
from vqa_counterexamples_tpu_torch.models import seq2vec as port_seq2vec
from vqa_counterexamples_tpu_torch.ops.cuda import gru_kernel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T, LR = 8, 10, 1e-3
DV, DQ, DH = 24, 48, 32


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _np(x):
    return (x.detach().float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


def _close(got, ref, dtype, name=""):
    """f32: rtol 1e-4 (atol 1e-5 of the largest entry); bf16: within 5e-2
    of the largest entry."""
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    assert np.isfinite(got).all(), name
    scale = max(np.abs(ref).max(), 1e-6)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5 * scale,
                                   err_msg=name)
    else:
        assert np.abs(got - ref).max() <= 5e-2 * scale, (
            name, np.abs(got - ref).max(), scale)


def _fusion_opt(dropout=0.0, **kw):
    return {"dim_v": DV, "dim_q": DQ, "dim_h": DH, "dropout_v": dropout,
            "dropout_q": dropout, "activation_v": "tanh",
            "activation_q": "tanh", **kw}


def noatt_options(dropout=0.0, gru_dropout=0.0, seq2vec=None):
    return {
        "arch": "MLBNoAtt",
        "seq2vec": seq2vec or {"arch": "skipthoughts", "type": "UniSkip",
                               "dropout": gru_dropout, "fixed_emb": False,
                               "emb_size": 16, "hidden_size": DQ},
        "fusion": _fusion_opt(dropout),
        "classif": {"activation": "tanh", "dropout": dropout},
    }


def att_options(dropout=0.0):
    drops = dict(dropout_v=dropout, dropout_q=dropout)
    return {
        "arch": "MLBAtt", "dim_v": DV, "dim_q": DQ,
        "seq2vec": {"arch": "skipthoughts", "type": "BayesianUniSkip",
                    "dropout": 0.0, "fixed_emb": False, "emb_size": 16,
                    "hidden_size": DQ},
        "attention": {"nb_glimpses": 2, "dim_h": DH, "dropout_mm": dropout,
                      "activation_v": "tanh", "activation_q": "tanh",
                      "activation_mm": "tanh", **drops},
        "fusion": {"dim_h": DH, "activation_v": "tanh",
                   "activation_q": "tanh", **drops},
        "classif": {"activation": "tanh", "dropout": dropout},
    }


def _cli_options(opt):
    att = opt["arch"] == "MLBAtt"
    return {"vqa": {"nans": 20, "maxlength": T, "trainsplit": "train",
                    "samplingans": True},
            "coco": {"mode": "att" if att else "noatt"},
            "model": dict(opt, dim_v=DV) if att else opt}


def build_pair(words, answers, opt, seed=0, seq2vec_arch=None):
    """(jax model, jax params, port model) with the same weights: the
    port's seeded init (unit-scale word embeddings) read into the flax
    tree by ``port_torch``, and back into a second port model by
    ``from_jax``."""
    jmodel = jax_factory.factory_vqa(opt, words, answers)
    source = port_engine.init_vqa_params(
        port_factory.factory_vqa(opt, words, answers), seed=seed)
    with torch.no_grad():
        source.seq2vec.embedding.weight.normal_(
            0.0, 1.0, generator=torch.Generator().manual_seed(seed + 1))
    params, arch = port_torch.port_vqa_state_dict(source.state_dict())
    assert arch == opt["arch"]
    params = jax.tree.map(np.asarray, params)
    pmodel = port_factory.factory_vqa(opt, words, answers)
    pmodel.load_state_dict(from_jax.vqa_state_dict_from_jax(
        params, seq2vec_arch=seq2vec_arch))
    return jmodel, params, pmodel


def _world(opt, n, side=None):
    examples, store, words, answers = port_cli._synthetic_vqa(
        n, _cli_options(opt), seed=5)
    if side is not None:
        from vqa_counterexamples_tpu_torch.data.features import FeatureStore

        store = FeatureStore(np.ascontiguousarray(
            store.features[:, :side, :side]), store.names)
    jmodel, params, pmodel = build_pair(words, answers, opt, seed=3)
    arrays = VQAArrays(examples, store, samplingans=True)
    order = np.random.default_rng(0)
    batches = [b for _ in range(15) for b in arrays.batches(
        B, shuffle=True, rng=order, drop_remainder=True)][:30]
    return SimpleNamespace(opt=opt, jmodel=jmodel, params=params,
                           pmodel=pmodel, store=store, arrays=arrays,
                           batches=batches, words=words, answers=answers)


@pytest.fixture(scope="module")
def noatt():
    return _world(noatt_options(), 40)


@pytest.fixture(scope="module")
def att():
    return _world(att_options(), 32, side=4)


@pytest.fixture(params=["float32", "bfloat16"])
def dtype(request, monkeypatch):
    if request.param == "bfloat16":
        monkeypatch.setenv("VQACX_GRU_PALLAS", "interpret")
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", request.param)
    with jax_policy.compute_dtype_scope(request.param):
        yield request.param


def _as_port(tree) -> dict:
    """A JAX MLB tree (params, grads, moments) under the port's names."""
    return {k: v.numpy() for k, v in from_jax.vqa_state_dict_from_jax(
        jax.device_get(tree)).items()}


def _jbatch(b):
    return {k: jnp.asarray(b[k]) for k in ("visual", "question", "answer")}


def _jax_state(params, optimizer):
    params = jax.tree.map(jnp.asarray, params)
    return jax_engine.VQATrainState(params, optimizer.init(params),
                                    jnp.zeros((), jnp.int32))


# ------------------------------------------------------------- the fusion

@pytest.mark.parametrize("omit", [None, "dim_v"])
def test_mlb_fusion_matches_jax(dtype, omit):
    """``MLBFusion`` (eval): the Hadamard forward, ``v_project`` and
    ``fuse_candidates`` with and without the cached image side, against
    JAX's module on the same weights; an omitted ``dim_v`` leaves the
    image side as it comes (no ``linear_v``)."""
    opt = _fusion_opt(0.5)
    if omit:
        del opt[omit]
    port = port_fusion.MLBFusion(opt)
    port.reset_parameters(torch.Generator().manual_seed(0))
    assert hasattr(port, "linear_v") == (omit is None)
    params = jax.tree.map(jnp.asarray, port_torch.port_mlb_fusion(
        port.state_dict()))
    jmod = jax_fusion.MLBFusion(opt)
    rng = np.random.default_rng(1)
    dv = DV if omit is None else DH
    v = rng.normal(size=(B, 5, dv)).astype(np.float32)
    q = rng.normal(size=(B, DQ)).astype(np.float32)

    def japply(method, *args):
        return jmod.apply({"params": params}, *args, method=method)

    ref = japply(lambda m, a, b: m(a, b, True), jnp.asarray(v[:, 0]),
                 jnp.asarray(q))
    ref_c = japply(lambda m, a, b: m.fuse_candidates(a, b, True),
                   jnp.asarray(v), jnp.asarray(q))
    ref_hv = japply(lambda m, a: m.v_project(a, True),
                    jnp.asarray(v.reshape(-1, dv)))
    with torch.no_grad():
        _close(port(_t(v[:, 0]), _t(q)), ref, dtype, "forward")
        _close(port.fuse_candidates(_t(v), _t(q)), ref_c, dtype, "cand")
        hv = port.v_project(_t(v.reshape(-1, dv)))
        _close(hv, ref_hv, dtype, "v_project")
        cached = port.fuse_candidates(None, _t(q), hv=hv.reshape(B, 5, -1))
        _close(cached, ref_c, dtype, "cached")
    with pytest.raises(ValueError, match="eval"):
        port.fuse_candidates(None, _t(q), hv=hv.reshape(B, 5, -1),
                             training=True)


def test_mlb_fusion_training_draws_per_candidate_masks():
    """In training each candidate row draws its own masks (JAX's
    duplicated path): v's first, then q's, as the forward does."""
    port = port_fusion.MLBFusion(_fusion_opt(0.5))
    port.reset_parameters(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(2)
    v, q = _t(rng.normal(size=(3, 4, DV))), _t(rng.normal(size=(3, DQ)))
    got = port.fuse_candidates(v, q, training=True,
                               generator=torch.Generator().manual_seed(7))
    want = port(v.reshape(12, DV), q[:, None].expand(3, 4, DQ).reshape(
        12, DQ), True, torch.Generator().manual_seed(7)).reshape(3, 4, DH)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# ------------------------------------------------------------- the models

def test_mlb_noatt_forward_and_grads_match_jax(noatt, dtype):
    """MLBNoAtt logits and the gradient of every parameter, training mode
    with the dropouts at 0 (UniSkip: the GRU without a mask)."""
    w = noatt
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
    _close(out, ref, dtype, "logits")
    for name, r in ref_g.items():
        _close(named[name].grad, r, dtype, name)


def _shift_free(name: str) -> bool:
    """conv_att's bias shifts every position's score alike: the softmax
    over the positions cannot see it, so its gradient is 0 up to
    rounding."""
    return name == "conv_att.bias"


def test_mlb_att_forward_maps_and_grads_match_jax(att, dtype):
    """MLBAtt logits, its two glimpses' attention maps (``return_att``)
    and the gradient of every parameter, training mode, dropouts at 0.
    Under bf16 a gradient may also differ from JAX's by up to twice JAX's
    own bf16 distance from its f32 gradient (chip_smoke's ``own_bf16``
    rule): the biases of the bf16 tower sum their cotangents over every
    position, and the Hadamard products there round in bf16 with no f32
    rank sum between them, so those sums cancel to a few bf16 steps."""
    w = att
    b = w.batches[0]
    g = np.random.default_rng(1).normal(size=(B, 20)).astype(np.float32)

    def loss_fn(params):
        out, maps = w.jmodel.apply(
            {"params": params}, jnp.asarray(b["visual"]),
            jnp.asarray(b["question"]), deterministic=False, return_att=True,
            rngs={"dropout": jax.random.key(0)})
        return jnp.sum(out * g), (out, maps)

    (_, (ref, ref_att)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, w.params))
    with jax_policy.compute_dtype_scope("float32"):
        _, grads_f32 = jax.value_and_grad(loss_fn, has_aux=True)(
            jax.tree.map(jnp.asarray, w.params))
    own = {k: np.abs(v - r).max() for (k, v), r in zip(
        _as_port(grads).items(), _as_port(grads_f32).values())}
    model = copy.deepcopy(w.pmodel)
    out, maps = model(_t(b["visual"]), torch.from_numpy(b["question"]),
                      training=True,
                      generator=torch.Generator().manual_seed(0),
                      return_att=True)
    (out * _t(g)).sum().backward()
    assert out.shape == (B, 20) and maps.shape == (B, 2, 16)
    torch.testing.assert_close(maps.float().sum(-1), torch.ones(B, 2),
                               rtol=0, atol=2e-2)
    _close(out, ref, dtype, "logits")
    _close(maps, ref_att, dtype, "maps")
    ref_g = _as_port(grads)
    named = dict(model.named_parameters())
    assert set(ref_g) == set(named)
    for name, r in ref_g.items():
        if _shift_free(name):
            scale = np.abs(ref_g["conv_att.weight"]).max()
            rel = 1e-3 if dtype == "float32" else 5e-2
            assert np.abs(_np(named[name].grad)).max() <= rel * scale
        elif dtype == "float32":
            _close(named[name].grad, r, dtype, name)
        else:
            err = np.abs(_np(named[name].grad) - r).max()
            assert err <= max(5e-2 * np.abs(r).max(), 2 * own[name]), (
                name, err, np.abs(r).max(), own[name])


def test_mlb_eval_matches_jax(noatt, att, dtype):
    for w in (noatt, att):
        b = w.batches[1]
        ref = w.jmodel.apply({"params": jax.tree.map(jnp.asarray, w.params)},
                             jnp.asarray(b["visual"]),
                             jnp.asarray(b["question"]), deterministic=True)
        with torch.no_grad():
            got = w.pmodel(_t(b["visual"]), torch.from_numpy(b["question"]))
        _close(got, ref, dtype, w.opt["arch"])


def test_factory_ties_dims(noatt, att):
    """MLBAtt's attention dim_v, dim_q and dim_mm are tied to its dim_h
    (the options copied, the caller's left alone), MLBNoAtt keeps its
    fusion's; the widths the modules get follow."""
    opt = att_options()
    m = port_factory.factory_vqa(opt, att.words, att.answers)
    assert {k: m.opt["attention"][k] for k in ("dim_v", "dim_q", "dim_mm")} \
        == {"dim_v": DH, "dim_q": DH, "dim_mm": DH}
    assert "dim_v" not in opt["attention"]
    assert tuple(m.conv_v_att.weight.shape) == (DH, DV, 1, 1)
    assert tuple(m.linear_q_att.weight.shape) == (DH, DQ)
    assert tuple(m.conv_att.weight.shape) == (2, DH, 1, 1)
    assert tuple(m.list_linear_v_fusion[1].weight.shape) == (DH, DV)
    assert tuple(m.linear_q_fusion.weight.shape) == (2 * DH, DQ)
    assert tuple(m.linear_classif.weight.shape) == (20, 2 * DH)
    n = port_factory.factory_vqa(noatt_options(), noatt.words,
                                 noatt.answers)
    assert n.dim_z == DH and "dim_mm" not in n.opt["fusion"]
    assert tuple(n.fusion.linear_v.weight.shape) == (DH, DV)
    assert tuple(n.linear_classif.weight.shape) == (20, DH)
    assert port_factory.model_names == jax_factory.model_names


def test_weights_round_trip_through_port_torch(noatt, att):
    """state_dict -> ``port_torch.port_vqa_state_dict`` -> the flax tree
    JAX's init builds (leaf for leaf) -> ``from_jax`` -> the same
    state_dict, for both archs."""
    for w in (noatt, att):
        sd = w.pmodel.state_dict()
        params, arch = port_torch.port_vqa_state_dict(sd)
        assert arch == w.opt["arch"]
        init = w.jmodel.init(jax.random.key(0), jnp.asarray(
            w.batches[0]["visual"]), jnp.asarray(
                w.batches[0]["question"]))["params"]

        def leaves(tree):
            flat, _ = jax.tree_util.tree_flatten_with_path(tree)
            return sorted((jax.tree_util.keystr(p), tuple(np.shape(a)))
                          for p, a in flat)

        assert leaves(params) == leaves(init)
        back = from_jax.vqa_state_dict_from_jax(jax.tree.map(np.asarray,
                                                             params))
        assert set(back) == set(sd)
        for k, v in sd.items():
            np.testing.assert_array_equal(back[k].numpy(), v.numpy(),
                                          err_msg=k)


# ------------------------------------------- a reference-named torch oracle

class TorchTwoLSTM(nn.Module):
    """The reference's ``seq2vec.TwoLSTM`` (batch first, eval mode: its
    dropout is the identity) on ``nn.LSTM``, with its attribute names."""

    def __init__(self, n_words, emb, hid):
        super().__init__()
        self.embedding = nn.Embedding(n_words + 1, emb, padding_idx=0)
        self.rnn_0 = nn.LSTM(emb, hid, batch_first=True)
        self.rnn_1 = nn.LSTM(hid, hid, batch_first=True)

    def forward(self, wids):
        last = (wids != 0).sum(1) - 1
        rows = torch.arange(wids.shape[0])
        x0, _ = self.rnn_0(torch.tanh(self.embedding(wids)))
        x1, _ = self.rnn_1(x0)
        return torch.cat([x0[rows, last], x1[rows, last]], dim=1)


class TorchMLBNoAtt(nn.Module):
    """The reference's ``MLBNoAtt`` (``noatt.py:38-46``, ``fusion.py:16-50``)
    in eval mode, with its attribute names."""

    def __init__(self, n_words, n_answers, emb, hid):
        super().__init__()
        self.seq2vec = TorchTwoLSTM(n_words, emb, hid)
        self.fusion = nn.Module()
        self.fusion.linear_v = nn.Linear(DV, DH)
        self.fusion.linear_q = nn.Linear(2 * hid, DH)
        self.linear_classif = nn.Linear(DH, n_answers)

    def forward(self, v, wids):
        q = self.seq2vec(wids)
        z = torch.tanh(self.fusion.linear_v(v)) \
            * torch.tanh(self.fusion.linear_q(q))
        return self.linear_classif(torch.tanh(z))


def test_mlb_noatt_two_lstm_against_reference_oracle(noatt):
    """A reference-named MLBNoAtt with a TwoLSTM encoder (torch's own
    ``nn.LSTM``): its ``state_dict`` loads into the port's model as is and
    through JAX's ``port_torch``, and the three give the same logits at
    f32 (rtol 1e-4)."""
    w = noatt
    hid = 12
    s2v = {"arch": "2-lstm", "emb_size": 16, "hidden_size": hid}
    opt = noatt_options(seq2vec=s2v)
    opt["fusion"]["dim_q"] = 2 * hid
    torch.manual_seed(0)
    oracle = TorchMLBNoAtt(len(w.words), len(w.answers), 16, hid).eval()
    port = port_factory.factory_vqa(opt, w.words, w.answers)
    port.load_state_dict(oracle.state_dict())
    params, arch = port_torch.port_vqa_state_dict(oracle.state_dict())
    assert arch == "MLBNoAtt"
    back = from_jax.vqa_state_dict_from_jax(jax.tree.map(np.asarray, params),
                                            seq2vec_arch="2-lstm")
    assert set(back) == set(oracle.state_dict())
    b = w.batches[2]
    jmodel = jax_factory.factory_vqa(opt, w.words, w.answers)
    with jax_policy.compute_dtype_scope("float32"):
        ref = jmodel.apply({"params": jax.tree.map(jnp.asarray, params)},
                           jnp.asarray(b["visual"]),
                           jnp.asarray(b["question"]), deterministic=True)
    with torch.no_grad():
        want = oracle(_t(b["visual"]), torch.from_numpy(b["question"]).long())
        got = port(_t(b["visual"]), torch.from_numpy(b["question"]))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)


# ------------------------------------------------ the UniSkip no-mask path

def test_uniskip_training_path_matches_jax_f32(noatt, monkeypatch):
    """UniSkip in training: dropout on the word embeddings, then the GRU
    with no mask.  The same numpy mask injected on both sides (JAX's flax
    ``Dropout``, the port's ``dropout``), every other dropout at 0: logits
    and every gradient at f32 (rtol 1e-4).  Under the bf16 policy the
    port sends that GRU to ``gru_recurrence_train`` with no mask (the
    kernels' plain versions here)."""
    w = noatt
    opt = noatt_options(gru_dropout=0.25)
    b = w.batches[3]
    keep = np.random.default_rng(9).random((B, T, 16)) < 0.75
    mask = keep / 0.75

    class InjectedDropout:
        def __init__(self, rate):
            assert rate == 0.25

        def __call__(self, x, deterministic):
            return x if deterministic else x * mask

    def port_dropout(x, rate, generator, training):
        assert rate == 0.25
        return x * _t(mask) if training else x

    monkeypatch.setattr(jax_seq2vec.nn, "Dropout", InjectedDropout)
    monkeypatch.setattr(port_seq2vec, "dropout_fn", port_dropout)
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "float32")
    jmodel = jax_factory.factory_vqa(opt, w.words, w.answers)
    g = np.random.default_rng(1).normal(size=(B, 20)).astype(np.float32)

    def loss_fn(params):
        out = jmodel.apply({"params": params}, jnp.asarray(b["visual"]),
                           jnp.asarray(b["question"]), deterministic=False,
                           rngs={"dropout": jax.random.key(0)})
        return jnp.sum(out * g), out

    with jax_policy.compute_dtype_scope("float32"):
        (_, ref), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            jax.tree.map(jnp.asarray, w.params))
    model = port_factory.factory_vqa(opt, w.words, w.answers)
    model.load_state_dict(w.pmodel.state_dict())
    out = model(_t(b["visual"]), torch.from_numpy(b["question"]),
                training=True, generator=torch.Generator().manual_seed(0))
    (out * _t(g)).sum().backward()
    _close(out, ref, "float32", "logits")
    ref_g = _as_port(grads)
    for name, p in model.named_parameters():
        _close(p.grad, ref_g[name], "float32", name)
    with torch.no_grad():   # eval: no dropout, so the logits differ
        assert not torch.allclose(model(_t(b["visual"]), torch.from_numpy(
            b["question"])), out)

    seen = []
    real = gru_kernel.gru_recurrence_train

    def spy(xp, w_hh, b_hh, mask_h):
        seen.append(mask_h)
        return real(xp, w_hh, b_hh, mask_h)

    monkeypatch.setattr(gru_kernel, "gru_recurrence_train", spy)
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "bfloat16")
    out = model(_t(b["visual"]), torch.from_numpy(b["question"]),
                training=True, generator=torch.Generator().manual_seed(0))
    out.sum().backward()
    assert seen == [None] and torch.isfinite(out).all()


# ------------------------------------------------------------- training

def _assert_adam_close(got, ref, grad, name):
    """Params after one Adam step from the same start; the first update is
    -lr g / (|g| + eps), which swings between -lr and lr where |g| is near
    eps: those entries are held to 2 lr, the rest to 1e-6."""
    steady = np.abs(grad) > 1e-6
    np.testing.assert_allclose(got[steady], ref[steady], rtol=0, atol=1e-6,
                               err_msg=name)
    assert np.abs(got - ref).max() <= 2 * LR + 1e-6, name


@pytest.mark.parametrize("arch", ["MLBNoAtt", "MLBAtt"])
def test_train_step_matches_jax_f32(noatt, att, monkeypatch, arch):
    """One ``make_vqa_train_step`` (every dropout at 0): loss, acc@1,
    acc@5, the gradient of every parameter and every parameter after
    Adam (conv_att's bias, which only shifts the attention scores, to
    2 lr)."""
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "float32")
    w = noatt if arch == "MLBNoAtt" else att
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
        jstate, jm = jax_engine.make_vqa_train_step(w.jmodel, opt)(jstate,
                                                                   jb)
        jnew = _as_port(jstate.params)
    model = copy.deepcopy(w.pmodel)
    state = port_engine.init_vqa_state(model, lr=LR)
    step = port_engine.make_vqa_train_step(model, state.optimizer)
    state, pm = step(state, dict(b, visual=_t(b["visual"])))
    assert state.step == 1
    for k in ("loss", "acc1", "acc5"):
        assert float(pm[k]) == pytest.approx(float(jm[k]), rel=1e-5), k
    named = dict(model.named_parameters())
    assert set(jgrads) == set(named)
    for name, ref in jgrads.items():
        if _shift_free(name):
            continue
        np.testing.assert_allclose(
            named[name].grad.numpy(), ref, rtol=1e-4,
            atol=1e-5 * max(np.abs(ref).max(), 1e-3), err_msg=name)
        _assert_adam_close(named[name].detach().numpy(), jnew[name], ref,
                           name)
    if arch == "MLBAtt":
        got = named["conv_att.bias"].detach().numpy()
        assert np.abs(got - jnew["conv_att.bias"]).max() <= 2 * LR + 1e-6


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


def test_mlb_noatt_trajectory_30_steps_f32(noatt, monkeypatch):
    """30 steps (samplingans batches, dropouts at 0): per-step losses
    within rtol 1e-4, equal acc@1, and the final eval logits within
    1e-3."""
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "float32")
    w = noatt
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


def test_mlb_trajectory_bf16_tracks_jax(noatt, att, monkeypatch):
    """8 steps of each arch under the bf16 policy (dropouts at 0): the JAX
    step runs its GRU Pallas kernels in interpret mode, the port their
    plain versions; per-step losses within 5e-2 relative."""
    monkeypatch.setenv("VQACX_GRU_PALLAS", "interpret")
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "bfloat16")
    opt = optax.adam(LR)
    for w in (noatt, att):
        model = copy.deepcopy(w.pmodel)
        with jax_policy.compute_dtype_scope("bfloat16"):
            losses, _, pstate = _run_pair(
                w, model, w.batches[:8], opt, _jax_state(w.params, opt),
                port_engine.init_vqa_state(model, lr=LR))
        assert pstate.step == 8 and np.isfinite(losses).all()
        np.testing.assert_allclose(losses[:, 1], losses[:, 0], rtol=5e-2)


def test_mlb_adam_state_carried_from_jax(noatt, monkeypatch):
    """3 JAX steps, then params and optax's mu / nu / count carried into a
    fresh port MLBNoAtt and ``torch.optim.Adam``: step 4 agrees."""
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "float32")
    w = noatt
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
    assert float(state.optimizer.state[model.fusion.linear_v.weight][
        "step"]) == 4
    np.testing.assert_allclose(losses[:, 1], losses[:, 0], rtol=1e-4)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jnew[name], rtol=0,
                                   atol=1e-6, err_msg=name)


# ---------------------------------------------------- NeuralCX over MLB

CX_SPEC = dict(dim_h=24, n_layers=2, drop_p=0.25, dim_a=40, v_emb=True,
               v_mult=True, v_dist=True, v_rank=True, q_emb=True, a_emb=True,
               z_emb=True, pretrained_emb=False, trainable_vqa=False)


def test_neural_cx_over_mlb_backbone(monkeypatch):
    """NeuralCX over an MLBNoAtt backbone: scores with the q / v / z caches
    (z ``dim_h`` wide) equal to the uncached forward and to JAX's NeuralCX
    on the same weights (f32; JAX's NeuralCX reads ``fusion.dim_mm`` for
    z's width, so its options carry ``dim_h`` there too); the fused
    classify + softmax gate closed under the bf16 policy because the MLB
    head has ``activation: tanh``, and only because of it."""
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "float32")
    k = 6
    dataset, store = jax_synthetic.make_synthetic_cx(
        n_examples=16, n_images=20, dim_v=128, knn_size=k, n_words=20,
        n_answers=20, seed=4)
    opt = noatt_options()
    opt["fusion"].update(dim_v=128)
    words, answers = dataset["vocab_words"], dataset["vocab_answers"]
    port = port_factory.factory_cx(
        "NeuralModel", port_factory.factory_vqa(opt, words, answers),
        knn_size=k, model_spec=CX_SPEC)
    port_cx_engine.init_cx_params(port, seed=0).eval()
    assert port.slices.dim_z == DH
    jopt = copy.deepcopy(opt)
    jopt["fusion"]["dim_mm"] = DH
    jmodel = jax_factory.factory_cx(
        "NeuralModel", jax_factory.factory_vqa(jopt, words, answers),
        knn_size=k, model_spec=CX_SPEC)
    params, _, arch = port_torch.port_cx_state_dict(port.state_dict())
    assert arch == "MLBNoAtt"
    arrays = port_vqacx.CXArrays.from_examples(dataset["examples_list"],
                                               dataset["name_to_index"])
    feats = torch.from_numpy(store.features)
    q, v, z, _ = port_cx_engine.build_frozen_caches(port, feats, arrays,
                                                    use_z=True)
    assert z.shape == (arrays.size, k + 1, DH) and v is None
    with torch.no_grad():
        img = feats[arrays.image_idxs]
        plain = port(img, torch.from_numpy(arrays.question_wids),
                     torch.from_numpy(arrays.answer_aids))
        cached = port(None, torch.from_numpy(arrays.question_wids),
                      torch.from_numpy(arrays.answer_aids), q_emb=q,
                      z_emb=z, features_table=feats,
                      image_idxs=torch.from_numpy(arrays.image_idxs))
    torch.testing.assert_close(cached, plain, rtol=1e-5, atol=1e-6)
    jarr = jax_vqacx.CXArrays.from_examples(dataset["examples_list"],
                                            dataset["name_to_index"])
    with jax_policy.compute_dtype_scope("float32"):
        ref = jmodel.apply({"params": jax.tree.map(jnp.asarray, params)},
                           jnp.asarray(store.features[jarr.image_idxs]),
                           jnp.asarray(jarr.question_wids),
                           jnp.asarray(jarr.answer_aids), deterministic=True,
                           rngs={"lesion": jax.random.key(0)})
        jv = jax_cx_engine.precompute_v_proj(jmodel, params, store.features)
    np.testing.assert_allclose(_np(plain), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)
    with torch.no_grad():
        np.testing.assert_allclose(_np(port.vqa_model.project_image(feats)),
                                   np.asarray(jv), rtol=1e-4, atol=1e-6)
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "bfloat16")
    assert not port._fused_head_ok()
    del port.vqa_model.opt["classif"]["activation"]
    assert port._fused_head_ok()


# ------------------------------------------------------------------ CLIs

def _narrow(name, tmp_path):
    """A YAML of ``configs/vqa2`` (its ``base`` resolved) cut to the test's
    widths, the arch, encoder type, glimpses, dropouts and activations
    kept."""
    opt = port_config.load_options_file(os.path.join(REPO, "configs", "vqa2",
                                                     name))
    model = opt["model"]
    model["seq2vec"].update(emb_size=16, hidden_size=DQ,
                            dir_st=str(tmp_path / "no_st"))
    if "attention" in model:
        model.update(dim_v=DV, dim_q=DQ)
        model["attention"]["dim_h"] = DH
        model["fusion"]["dim_h"] = DH
    else:
        model["fusion"].update(dim_v=DV, dim_q=DQ, dim_h=DH)
    opt["vqa"].update(maxlength=T)
    opt["logs"]["dir_logs"] = str(tmp_path / "logs")
    path = tmp_path / ("tiny_" + name)
    path.write_text(yaml.safe_dump(opt))
    return str(path), opt


@pytest.mark.parametrize("name,arch,glimpses", [
    ("default.yaml", "MLBNoAtt", 0), ("mlb_noatt_train.yaml", "MLBNoAtt", 0),
    ("mlb_att_trainval.yaml", "MLBAtt", 4)])
def test_train_cli_mlb_configs(tmp_path, monkeypatch, name, arch, glimpses):
    """``cli/train.py --synthetic`` on each MLB YAML, narrowed: the arch it
    names is built and trained an epoch, and writes its checkpoints and
    (train split) val rows or (trainval) test rows."""
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "float32")
    path, opt = _narrow(name, tmp_path)
    state = port_cli.main(["--path_opt", path, "--synthetic", "32", "-b",
                           "8", "--epochs", "1", "--device", "cpu", "-p",
                           "2"])
    assert type(state.model).__name__ == arch and state.step == 4
    assert type(state.model.seq2vec).__name__ == "SkipThoughts"
    assert state.model.seq2vec.bayesian == (arch == "MLBAtt")
    if glimpses:
        assert len(state.model.list_linear_v_fusion) == glimpses
    logs = tmp_path / "logs"
    assert (logs / "ckpt_model.msgpack").exists()
    split = "test2015" if opt["vqa"]["trainsplit"] == "trainval" else "val"
    rows = json.loads((logs / "results" / split /
                       "vqa_OpenEnded_mscoco_epoch_1.json").read_text())
    assert rows and all(set(r) == {"question_id", "answer"} for r in rows)


def test_cx_cli_over_mlb_backbone(tmp_path, monkeypatch):
    """The CX CLI trains NeuralCX over a (narrowed) MLBNoAtt backbone,
    caches on, and scores it."""
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "float32")
    base = os.path.join(REPO, "configs", "cx", "counterexamples_default.yaml")
    path = tmp_path / "mlb_cx.yaml"
    path.write_text(
        "base: %s\n"
        "model:\n"
        "  arch: MLBNoAtt\n"
        "  seq2vec: {type: UniSkip, emb_size: 16, hidden_size: 32}\n"
        "  fusion: {dim_v: 2048, dim_q: 32, dim_h: 24, dropout_v: 0.5,\n"
        "           dropout_q: 0.5, activation_v: tanh, activation_q: tanh}\n"
        "  classif: {activation: tanh, dropout: 0.5}\n"
        "cx_model: {dim_h: 24, dim_a: 40}\n"
        "optim: {batch_size: 24}\n" % base)
    port_cx_cli.main(["--cx_model", "NeuralModel", "--synthetic", "64",
                      "--z_cache", "--epochs", "1", "--test", "--device",
                      "cpu", "--untrained_vqa", "--path_opt", str(path),
                      "--project_dir", str(tmp_path)])
    (run,) = os.listdir(tmp_path / "logs" / "cx")
    res = json.loads((tmp_path / "logs" / "cx" / run /
                      "final_results.txt").read_text())
    assert np.isfinite(res["loss"]) and res["best_epoch"] >= 1
    assert 0.0 <= res["recall_1"] <= res["recall"] <= 1.0
