"""The LSTM encoders of the PyTorch port against the JAX package:
``ops/rnn.lstm_scan`` (forward and the gradients of the inputs and every
weight, f32 and bf16 policies), ``LSTMEncoder`` with 1 and 2 layers and
``TwoLSTM`` in eval mode, their reference attribute names read by
``models/port_torch.port_seq2vec`` into JAX's own tree, ``from_jax`` back
(optax's Adam state too), and the factory's dispatch and ``output_dim``.

Sizes: vocabulary 30, embedding 12, hidden 20, T 9, B 5.  Tolerances: f32
within rtol 1e-4 (atol 1e-5 of the tensor's largest entry); bf16 within
5e-2 of the largest entry (the same roundings in another summation
order, compounded over the steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqa_counterexamples_tpu.core import policy as jax_policy
from vqa_counterexamples_tpu.models import port_torch
from vqa_counterexamples_tpu.models import seq2vec as jax_seq2vec
from vqa_counterexamples_tpu.ops import rnn as jax_rnn
from vqa_counterexamples_tpu_torch.models import from_jax
from vqa_counterexamples_tpu_torch.models import seq2vec as port_seq2vec
from vqa_counterexamples_tpu_torch.ops import rnn as port_rnn

V, E, H, T, B = 30, 12, 20, 9, 5


def _np(x):
    return (x.detach().float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


def _close(got, ref, dtype, name=""):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    scale = np.abs(ref).max()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5 * scale,
                                   err_msg=name)
    else:
        assert np.abs(got - ref).max() <= 5e-2 * scale, (
            name, np.abs(got - ref).max(), scale)


@pytest.fixture(params=["float32", "bfloat16"])
def dtype(request, monkeypatch):
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", request.param)
    with jax_policy.compute_dtype_scope(request.param):
        yield request.param


def _wids(seed=0):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, T + 1, B)
    return np.where(np.arange(T)[None] < lengths[:, None],
                    rng.integers(1, V + 1, (B, T)), 0).astype(np.int32)


def test_lstm_scan_forward_and_grads_match_jax(dtype):
    """Time-major states of one layer and the gradients of x, w_ih, b_ih,
    w_hh and b_hh (the port's (4H, D) weights against JAX's (D, 4H)
    transposed), for one cotangent."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(T, B, E)).astype(np.float32)
    s = H ** -0.5
    w_ih = rng.uniform(-s, s, (E, 4 * H)).astype(np.float32)
    w_hh = rng.uniform(-s, s, (H, 4 * H)).astype(np.float32)
    b_ih = rng.normal(size=4 * H).astype(np.float32) * 0.1
    b_hh = rng.normal(size=4 * H).astype(np.float32) * 0.1
    g = rng.normal(size=(T, B, H)).astype(np.float32)

    def loss(xx, p):
        out = jax_rnn.lstm_scan(p, xx, time_major_in=True,
                                time_major_out=True)
        return jnp.sum(out * g), out

    params = jax_rnn.LSTMParams(*(jnp.asarray(a) for a in (w_ih, b_ih,
                                                           w_hh, b_hh)))
    (_, ref), (dx, dp) = jax.value_and_grad(loss, argnums=(0, 1),
                                            has_aux=True)(jnp.asarray(x),
                                                          params)
    leaves = [torch.tensor(a).requires_grad_() for a in (
        x, w_ih.T.copy(), b_ih, w_hh.T.copy(), b_hh)]
    xt, wi, bi, wh, bh = leaves
    out = port_rnn.lstm_scan(wi, bi, wh, bh, xt)
    assert out.dtype == torch.float32 and out.shape == (T, B, H)
    (out * torch.from_numpy(g)).sum().backward()
    _close(out, ref, dtype, "states")
    refs = [dx, np.asarray(dp.w_ih).T, dp.b_ih, np.asarray(dp.w_hh).T,
            dp.b_hh]
    for name, leaf, r in zip(("x", "w_ih", "b_ih", "w_hh", "b_hh"), leaves,
                             refs):
        _close(leaf.grad, r, dtype, name)


def _pair(opt, seed=0):
    """(port encoder with the port's seeded init, JAX module, JAX params
    read from the port's state_dict by the JAX package's reader)."""
    port = port_seq2vec.factory(["w%d" % i for i in range(V)], opt)
    port.reset_parameters(torch.Generator().manual_seed(seed))
    jmod = jax_seq2vec.factory(tuple("w%d" % i for i in range(V)), opt)
    params = port_torch.port_seq2vec(port.state_dict())
    return port, jmod, jax.tree.map(np.asarray, params)


ENCODERS = [
    ({"arch": "lstm", "emb_size": E, "hidden_size": H}, H),
    ({"arch": "lstm", "emb_size": E, "hidden_size": H, "num_layers": 2}, H),
    ({"arch": "2-lstm", "emb_size": E, "hidden_size": H}, 2 * H),
]


@pytest.mark.parametrize("opt,width", ENCODERS)
def test_encoders_match_jax(dtype, opt, width):
    """``LSTMEncoder`` (1 and 2 layers) and ``TwoLSTM`` in eval mode: the
    sentence vectors of ragged questions against JAX's modules on the same
    weights; the width is ``output_dim``."""
    port, jmod, params = _pair(opt)
    wids = _wids()
    ref = jmod.apply({"params": jax.tree.map(jnp.asarray, params)},
                     jnp.asarray(wids), deterministic=True)
    with torch.no_grad():
        got = port(torch.from_numpy(wids))
    assert got.shape == (B, width) == (B, port_seq2vec.output_dim(opt))
    assert port_seq2vec.output_dim(opt) == jax_seq2vec.output_dim(opt)
    _close(got, ref, dtype, opt["arch"])


@pytest.mark.parametrize("opt,width", ENCODERS)
def test_reference_names_and_round_trip(opt, width):
    """The reference's attribute names (``embedding``, ``rnn`` with
    ``weight_ih_l{k}`` ..., or ``rnn_0`` / ``rnn_1``), read by JAX's
    ``port_seq2vec`` into the tree JAX's own init builds (leaf for leaf,
    shape for shape), and ``from_jax`` back to the same state_dict."""
    port, jmod, params = _pair(opt, seed=3)
    layers = opt.get("num_layers", 1)
    if opt["arch"] == "lstm":
        rnns = [("rnn", k) for k in range(layers)]
    else:
        rnns = [("rnn_0", 0), ("rnn_1", 0)]
    want = {"embedding.weight"} | {"%s.%s_l%d" % (r, n, k) for r, k in rnns
                                   for n in ("weight_ih", "weight_hh",
                                             "bias_ih", "bias_hh")}
    sd = port.state_dict()
    assert set(sd) == want
    assert tuple(sd["%s.weight_ih_l0" % rnns[0][0]].shape) == (4 * H, E)
    init = jmod.init(jax.random.key(0), jnp.asarray(_wids()))["params"]

    def leaves(tree):
        flat, _ = jax.tree_util.tree_flatten_with_path(tree)
        return sorted((jax.tree_util.keystr(p), tuple(np.shape(a)))
                      for p, a in flat)

    assert leaves(params) == leaves(init)
    back = from_jax.vqa_state_dict_from_jax(
        {"seq2vec": params, "linear_classif": {"kernel": np.zeros((2, 2)),
                                               "bias": np.zeros(2)},
         "fusion_module": {}}, seq2vec_arch=opt["arch"])
    back = {k[len("seq2vec."):]: v for k, v in back.items()
            if k.startswith("seq2vec.")}
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)
    with pytest.raises(ValueError, match="2-lstm"):
        from_jax.vqa_state_dict_from_jax({"seq2vec": params,
                                          "linear_classif": {
                                              "kernel": np.zeros((2, 2)),
                                              "bias": np.zeros(2)},
                                          "fusion_module": {}})


def test_two_lstm_dropout_and_init():
    """TwoLSTM in training draws a 0.3 dropout mask on each half from the
    generator (the same generator state gives the same vector); the init
    is JAX's families: LSTM weights within 1/sqrt(H), zero biases, the
    embedding a truncated normal of variance 1/E."""
    port, _, _ = _pair({"arch": "2-lstm", "emb_size": E, "hidden_size": H})
    wids = torch.from_numpy(_wids())
    with torch.no_grad():
        a = port(wids, training=True,
                 generator=torch.Generator().manual_seed(5))
        b = port(wids, training=True,
                 generator=torch.Generator().manual_seed(5))
        ev = port(wids)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    dropped = a == 0
    assert dropped.any() and not (ev == 0).any()
    kept = ~dropped
    torch.testing.assert_close(a[kept], ev[kept] / 0.69921875)  # 179/256
    with pytest.raises(ValueError, match="generator"):
        port(wids, training=True)
    for name, p in port.named_parameters():
        if name.startswith("rnn") and "bias" in name:
            assert not p.any(), name
        elif name.startswith("rnn"):
            assert p.abs().max() <= H ** -0.5, name
    emb = port.embedding.weight
    assert abs(emb.std().item() * E ** 0.5 - 1.0) < 0.15
    assert emb.abs().max() <= 2 * E ** -0.5 / 0.87962566103423978 + 1e-6


def test_factory_refuses_unknown_encoders():
    for fn in (lambda o: port_seq2vec.factory(["a"], o),
               port_seq2vec.output_dim):
        with pytest.raises(NotImplementedError, match="gru"):
            fn({"arch": "gru"})


@pytest.mark.parametrize("arch", ["lstm", "2-lstm"])
def test_vqa_adam_state_carried_for_lstm_encoders(arch):
    """optax's Adam state over an MLBNoAtt with an LSTM encoder carried
    into ``torch.optim.Adam`` by ``from_jax.vqa_adam_state_from_jax``: the
    encoder's arch is read from the model, each moment lands on its
    parameter (mu = 2 p, nu = p * p here), and the step count."""
    import optax

    from vqa_counterexamples_tpu_torch.engines import vqa_engine
    from vqa_counterexamples_tpu_torch.models import factory

    width = 2 * H if arch == "2-lstm" else H
    opt = {"arch": "MLBNoAtt",
           "seq2vec": {"arch": arch, "emb_size": E, "hidden_size": H,
                       "num_layers": 2},
           "fusion": {"dim_v": 6, "dim_q": width, "dim_h": 8,
                      "activation_v": "tanh", "activation_q": "tanh"},
           "classif": {"activation": "tanh", "dropout": 0.0}}
    words = ["w%d" % i for i in range(V)]
    model = vqa_engine.init_vqa_params(
        factory.factory_vqa(opt, words, ["a", "b", "c"]), seed=2)
    params, _ = port_torch.port_vqa_state_dict(model.state_dict())
    params = jax.tree.map(np.asarray, params)
    adam = optax.ScaleByAdamState(
        count=np.asarray(3, np.int32), mu=jax.tree.map(lambda p: 2 * p,
                                                       params),
        nu=jax.tree.map(lambda p: p * p, params))
    state = vqa_engine.init_vqa_state(model, lr=1e-3)
    from_jax.vqa_adam_state_from_jax((adam, optax.EmptyState()), model,
                                     state.optimizer)
    named = dict(model.named_parameters())
    assert {n for n in named if n.startswith("seq2vec.rnn")} and len(
        state.optimizer.state) == len(named)
    for name, p in named.items():
        st = state.optimizer.state[p]
        assert float(st["step"]) == 3, name
        torch.testing.assert_close(st["exp_avg"], 2 * p.detach(), rtol=0,
                                   atol=0)
        torch.testing.assert_close(st["exp_avg_sq"], p.detach() ** 2,
                                   rtol=0, atol=0)
