"""NeuralCX training in the PyTorch port against the JAX engine: the vfeat
backward, dropout masks, the train step, multi-step trajectories, Adam
carried across, the lesions, checkpoints and the CLI.

Sizes are small (dim_v 128, K 6, 40 examples over 24 images, B 16, widths
of ``test_torch_modules.SPEC``).  The same weights go to both packages
through ``models/port_torch`` / ``models/from_jax``, and both get the same
cache tables (built by the JAX engine).  Dropout is off in every parity run
(``drop_p=0``): the two frameworks draw different random bits from one seed
(threefry vs PyTorch's generators), so their masks can never be equal.

Tolerances: one f32 step holds grads to rtol 1e-4 and params to 1e-6 abs
where the gradient is well away from Adam's eps (Adam moves each param by
about lr = 1e-3 per step, see ``_assert_adam_close``); the 30-step f32
trajectory holds per-step losses to rtol 1e-4.  At bf16 the JAX side runs
its Pallas kernels in interpret mode and the port the kernels' plain
versions: losses within 5e-2 relative, and the vfeat weight gradients (the
columns of ``linear_1`` that the vfeat kernels own) within 5e-2 of their
largest entry, as the JAX package bounds its own bf16 paths
(tests/test_fused_head.py).
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

from vqa_counterexamples_tpu.core import policy as jax_policy
from vqa_counterexamples_tpu.core import rng as jax_rng
from vqa_counterexamples_tpu.data import synthetic as jax_synthetic
from vqa_counterexamples_tpu.data import vqacx as jax_vqacx
from vqa_counterexamples_tpu.engines import cx_engine as jax_engine
from vqa_counterexamples_tpu.ops.pallas.vfeat_kernel import (
    vfeat_scores_pallas)
from vqa_counterexamples_tpu_torch.cli import counterexamples as port_cli
from vqa_counterexamples_tpu_torch.core import msgpack_tree
from vqa_counterexamples_tpu_torch.core import rng as port_rng
from vqa_counterexamples_tpu_torch.data import vqacx as port_vqacx
from vqa_counterexamples_tpu_torch.engines import cx_engine as port_engine
from vqa_counterexamples_tpu_torch.models import cx as port_cx
from vqa_counterexamples_tpu_torch.models import from_jax
from vqa_counterexamples_tpu_torch.ops import scorer as port_scorer
from vqa_counterexamples_tpu_torch.ops.cuda import (
    gru_kernel, mixture_kernel, vfeat_kernel)

from test_torch_modules import KERNEL_ENVS, SPEC, build_pair
from test_torch_slice import _tiny_cli_options

K, B, LR = 6, 16, 1e-3
SPEC0 = dict(SPEC, drop_p=0.0)


def _bf16(a):
    """numpy f32 values rounded to bf16 (both sides see equal inputs)."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


@pytest.fixture(scope="module")
def world():
    dataset, store = jax_synthetic.make_synthetic_cx(
        n_examples=40, n_images=24, dim_v=128, knn_size=K, n_words=20,
        n_answers=20, seed=9)
    jmodel, params, pmodel, arrays = build_pair(dataset, seed=5, spec=SPEC0)
    params = jax.tree.map(np.asarray, params)
    feats = store.features
    with jax_policy.compute_dtype_scope("float32"):
        q, _, z, _ = jax_engine.build_frozen_caches(
            jmodel, params, jnp.asarray(feats), arrays, use_q=True,
            use_v=False, use_z=True)
    # 30 steps of shuffled batches (40 examples: the third batch of each
    # epoch has 8 valid rows and 8 padded ones)
    order = np.random.default_rng(0)
    steps = [b for _ in range(10) for b in jax_vqacx.batch_indices(
        arrays.size, B, shuffle=True, rng=order)]
    return SimpleNamespace(dataset=dataset, jmodel=jmodel, params=params,
                           pmodel=pmodel, arrays=arrays, feats=feats,
                           q=np.array(q), z=np.array(z), steps=steps)


def _jax_state(jmodel, params, optimizer):
    params = jax.tree.map(jnp.asarray, params)
    trainable, _ = jax_engine.split_params(
        params, jax_engine.frozen_param_keys(jmodel))
    return jax_engine.CXTrainState(params, optimizer.init(trainable),
                                   jnp.zeros((), jnp.int32))


def _port_batch(arrays, idx):
    return port_engine.batch_to_device(
        port_vqacx.gather_batch(port_vqacx.CXArrays(*arrays), idx), "cpu")


def _trainable_as_port(tree) -> dict:
    """A JAX trainable subtree (params, grads, moments) under the port's
    state_dict names, as numpy."""
    return {k: v.numpy() for k, v in
            from_jax.cx_trainable_state_dict_from_jax(
                jax.device_get(tree)).items()}


def _run_pair(w, pmodel, steps, *, jax_step, port_step, pstate, jstate,
              tables_j, tables_p, features_j, features_p):
    """Run the same batches through both trainers -> per-step losses."""
    losses = []
    for idx, n_valid in steps:
        jbatch = jax_vqacx.gather_batch(w.arrays, idx)
        jstate, jm = jax_step(jstate, features_j, jbatch,
                              jnp.asarray(n_valid, jnp.float32), *tables_j)
        pstate, pm = port_step(pstate, features_p, _port_batch(w.arrays, idx),
                               n_valid, **tables_p)
        losses.append((float(jm["loss"]), float(pm["loss"]),
                       float(jm["correct"]), float(pm["correct"])))
    return np.array(losses), jstate, pstate


# ---------------------------------------------------------------- kernels

@pytest.mark.parametrize("n_rows,dim_v,batch,knn,dim_h", [
    (40, 128, 32, 5, 16), (70, 256, 64, 3, 40)])
def test_vfeat_weight_grads_plain_match_pallas_vjp(n_rows, dim_v, batch,
                                                   knn, dim_h):
    """The backward's plain version against ``jax.vjp`` of the TPU kernel
    (interpret mode) on the K-major gather of the same rows.  JAX returns
    the f32 sums rounded to the weights' bf16; the plain version keeps
    f32: within one bf16 step (rtol 1e-2), plus 1e-4 of the largest entry
    for the sums' order near zero."""
    rng = np.random.default_rng(dim_v + knn)
    table = _bf16(rng.normal(size=(n_rows, dim_v)))
    idx = rng.integers(0, n_rows, size=(batch, knn + 1)).astype(np.int32)
    w_o = _bf16(rng.normal(size=(dim_h, dim_v)) * 0.1)
    w_m = _bf16(rng.normal(size=(dim_h, dim_v)) * 0.1)
    g = _bf16(rng.normal(size=(batch, knn, dim_h)))

    xk3 = jnp.asarray(np.transpose(table[idx[:, 1:]], (1, 0, 2)),
                      jnp.bfloat16)
    xo = jnp.asarray(table[idx[:, 0]], jnp.bfloat16)
    _, vjp = jax.vjp(lambda wo, wm: vfeat_scores_pallas(xk3, xo, wo, wm, 0,
                                                        True),
                     jnp.asarray(w_o, jnp.bfloat16),
                     jnp.asarray(w_m, jnp.bfloat16))
    ref = vjp((jnp.asarray(np.transpose(g, (1, 0, 2)), jnp.bfloat16),
               jnp.zeros((knn, batch, 1), jnp.float32)))

    got = vfeat_kernel.vfeat_weight_grads(
        torch.from_numpy(table).to(torch.bfloat16), torch.from_numpy(idx),
        torch.from_numpy(g).to(torch.bfloat16))
    for p, j in zip(got, ref):
        assert p.dtype == torch.float32 and tuple(p.shape) == (dim_h, dim_v)
        j = np.asarray(j, np.float32)
        np.testing.assert_allclose(p.numpy(), j, rtol=1e-2,
                                   atol=1e-4 * np.abs(j).max())


def test_vfeat_function_matches_plain_autograd():
    """The autograd Function on CPU (plain forward + plain backward) against
    autograd through ``vfeat_scores_plain``: the same forward, and the
    weight grads reach the f32 leaves through the bf16 cast alike (each
    an f32 sum rounded once to bf16: equal up to one bf16 step where the
    sums' order differs)."""
    rng = np.random.default_rng(3)
    table = torch.from_numpy(rng.normal(size=(30, 64)).astype(
        np.float32)).to(torch.bfloat16)
    idx = torch.from_numpy(rng.integers(0, 30, size=(9, 5)).astype(np.int32))
    g = torch.from_numpy(rng.normal(size=(9, 4, 12)).astype(np.float32))
    leaves = [torch.from_numpy(rng.normal(size=(12, 64)).astype(np.float32))
              .requires_grad_() for _ in range(2)]
    outs, grads = [], []
    for fn in (vfeat_kernel.vfeat_scores, vfeat_kernel.vfeat_scores_plain):
        h, dist = fn(table, idx, *(w.to(torch.bfloat16) for w in leaves))
        assert h.requires_grad and not dist.requires_grad
        (h.float() * g).sum().backward()
        outs.append((h.detach(), dist))
        grads.append([w.grad.clone() for w in leaves])
        for w in leaves:
            w.grad = None
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    for got, ref in zip(*grads):
        torch.testing.assert_close(got, ref, rtol=8e-3,
                                   atol=1e-6 * ref.abs().max().item())


def test_forward_only_wrappers_refuse_grad():
    """The GRU and mixture kernels have no backward (nor had their TPU
    originals): with grad mode on, an operand that requires grad
    raises instead of losing its gradient."""
    bf = torch.bfloat16
    w = torch.zeros(6, 2, dtype=bf, requires_grad=True)
    xp = torch.zeros(2, 3, 6, dtype=bf)
    with pytest.raises(RuntimeError, match="forward-only"):
        gru_kernel.gru_recurrence(xp, w, torch.zeros(6))
    w_cls = torch.zeros(7, 4, dtype=bf, requires_grad=True)
    z = torch.zeros(3, 4, dtype=bf)
    with pytest.raises(RuntimeError, match="forward-only"):
        mixture_kernel.classify_softmax(z, w_cls, torch.zeros(7, dtype=bf))
    with torch.no_grad():
        gru_kernel.gru_recurrence(xp, w, torch.zeros(6))
        mixture_kernel.classify_softmax(z, w_cls, torch.zeros(7, dtype=bf))


# ------------------------------------------------------------ rng, dropout

def test_keep_mask_rate_and_scale():
    gen = torch.Generator().manual_seed(0)
    mask, scale = port_rng.keep_mask((400, 500), 0.75, gen)
    assert mask.dtype == torch.bool and tuple(mask.shape) == (400, 500)
    rate = mask.float().mean().item()
    assert abs(rate - 0.75) <= 3 * (0.75 * 0.25 / mask.numel()) ** 0.5
    # the quantized threshold and its unbiased scale, as the JAX package's
    for keep in (0.75, 0.5, 0.7, 0.999, 0.001):
        _, s_port = port_rng.keep_mask((8,), keep, gen)
        _, s_jax = jax_rng.keep_mask(jax.random.key(0), keep, (8,))
        assert s_port == pytest.approx(float(s_jax), rel=1e-12), keep
    assert scale == 256.0 / 192


def test_step_generators_are_deterministic_per_stream():
    def draw(seed, step, name):
        gen = port_rng.step_generators(seed, step, (name,), "cpu")[name]
        return torch.rand(16, generator=gen)

    assert torch.equal(draw(42, 3, "dropout"), draw(42, 3, "dropout"))
    assert not torch.equal(draw(42, 3, "dropout"), draw(42, 4, "dropout"))
    assert not torch.equal(draw(42, 3, "dropout"), draw(42, 3, "lesion"))
    assert not torch.equal(draw(42, 3, "dropout"), draw(43, 3, "dropout"))


def test_mlp_tail_dropout_follows_every_relu():
    """Masks are drawn in order, one after each ReLU; with no generator
    the tail is the eval identity."""
    rng = np.random.default_rng(1)
    h = torch.from_numpy(rng.normal(size=(4, 6, 10)).astype(np.float32))
    ws, bs = [torch.from_numpy(rng.normal(size=(10, 10)).astype(
        np.float32))], [torch.zeros(10)]
    wo, bo = torch.from_numpy(rng.normal(size=(10, 1)).astype(
        np.float32)), torch.zeros(1)
    got = port_scorer.mlp_tail(h, ws, bs, wo, bo, drop_p=0.25,
                               generator=torch.Generator().manual_seed(7))
    gen = torch.Generator().manual_seed(7)
    m1, s = port_rng.keep_mask(h.shape, 0.75, gen)
    x = torch.where(m1, torch.relu(h) * s, 0.0)
    m2, _ = port_rng.keep_mask(h.shape, 0.75, gen)
    x = torch.where(m2, torch.relu(x @ ws[0]) * s, 0.0)
    torch.testing.assert_close(got, (x @ wo)[..., 0])
    eval_out = port_scorer.mlp_tail(h, ws, bs, wo, bo, drop_p=0.25)
    torch.testing.assert_close(
        eval_out, port_scorer.mlp_tail(h, ws, bs, wo, bo, drop_p=0.0))
    assert not torch.allclose(got, eval_out)


def test_frozen_backbone_is_frozen(world):
    model = copy.deepcopy(world.pmodel)
    assert all(not p.requires_grad for p in model.vqa_model.parameters())
    model.train()
    assert model.training and not model.vqa_model.training
    names = {n for n, _ in port_engine.trainable_parameters(model)}
    assert names and not any(n.startswith("vqa_model.") for n in names)


# ------------------------------------------------------------- train step

# The scalar head's bias shifts all K scores of an example alike, which the
# K-way softmax CE cannot see: its gradient is 0 up to rounding, and Adam
# moves it by up to lr per step on that noise, differently in each
# framework.  Scores are compared as log-softmax for the same reason.
SHIFT_ONLY = ("out.bias",)


def _log_softmax(scores):
    s = np.asarray(scores, np.float64)
    s = s - s.max(axis=-1, keepdims=True)
    return s - np.log(np.exp(s).sum(axis=-1, keepdims=True))


def _assert_adam_close(got, ref, grad, name):
    """Params after one Adam step from the same start.  The first update is
    -lr * g / (|g| + eps): where |g| is near eps (1e-8) it swings between
    -lr and lr on differences of 1e-12 in g, so those entries are held to
    2 lr; the rest to 1e-6."""
    steady = np.abs(grad) > 1e-6
    np.testing.assert_allclose(got[steady], ref[steady], rtol=0, atol=1e-6,
                               err_msg=name)
    assert np.abs(got - ref).max() <= 2 * LR + 1e-6, name


def test_train_step_matches_jax_f32(world, monkeypatch):
    """One step on a padded batch (13 valid rows of 16): loss, recall
    count, every trainable gradient (``linear_1.weight`` feature block by
    feature block), every parameter after Adam; the backbone unchanged,
    with no grad and no Adam state."""
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "float32")
    w = world
    idx = np.concatenate([np.arange(13), np.zeros(3, np.int64)])
    n_valid = 13
    jbatch = jax_vqacx.gather_batch(w.arrays, idx)
    opt = optax.adam(LR)
    with jax_policy.compute_dtype_scope("float32"):
        jstate = _jax_state(w.jmodel, w.params, opt)
        trainable, frozen = jax_engine.split_params(jstate.params,
                                                    ("vqa_model",))
        kw = jax_engine.cache_kwargs(jbatch, w.q, None, w.z)
        mask = jnp.arange(B) < n_valid

        # the loss of _make_cx_step_body, written out
        @jax.jit
        def grad_fn(tr):
            def loss_fn(tr):
                scores = w.jmodel.apply(
                    {"params": {**tr, **frozen}},
                    jnp.asarray(w.feats)[jbatch["image_idxs"]],
                    jbatch["question_wids"], jbatch["answer_aids"],
                    deterministic=False,
                    rngs={"dropout": jax.random.key(0),
                          "lesion": jax.random.key(1)}, **kw)
                logp = jax.nn.log_softmax(scores, axis=-1)
                nll = -jnp.take_along_axis(
                    logp, jbatch["comp_idxs"][:, None], axis=-1)[:, 0]
                return jnp.sum(nll * mask) / n_valid
            return jax.grad(loss_fn)(tr)

        jgrads = _trainable_as_port(grad_fn(trainable))
        jstep = jax_engine.make_cx_train_step(
            w.jmodel, opt, use_q_cache=True, use_z_cache=True)
        jstate, jm = jstep(jstate, jnp.asarray(w.feats), jbatch,
                           jnp.asarray(n_valid, jnp.float32), w.q, None, w.z)
        jnew = _trainable_as_port(jax_engine.split_params(
            jstate.params, ("vqa_model",))[0])

    model = copy.deepcopy(w.pmodel)
    backbone = {k: v.clone() for k, v in model.vqa_model.state_dict().items()}
    state = port_engine.init_cx_state(model, lr=LR)
    step = port_engine.make_cx_train_step(model, state.optimizer,
                                          use_z_cache=True)
    state, pm = step(state, torch.from_numpy(w.feats),
                     _port_batch(w.arrays, idx), n_valid,
                     q_table=torch.from_numpy(w.q),
                     z_table=torch.from_numpy(w.z))
    assert state.step == 1 and pm["n"] == n_valid
    assert float(pm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(pm["correct"]) == float(jm["correct"])
    params = dict(model.named_parameters())
    assert set(jgrads) == {n for n, _ in
                           port_engine.trainable_parameters(model)}
    # linear_1.weight block by block (the vfeat columns reach it through
    # the Function, a cast, a copy and two transposes)
    got1 = params["linear_1.weight"].grad.t().numpy()
    ref1 = jgrads["linear_1.weight"].T
    for block, (lo, hi) in model.slices.offsets().items():
        np.testing.assert_allclose(got1[lo:hi], ref1[lo:hi], rtol=1e-4,
                                   atol=1e-7, err_msg=block)
    for name, ref in jgrads.items():
        np.testing.assert_allclose(params[name].grad.numpy(), ref,
                                   rtol=1e-4, atol=1e-7, err_msg=name)
        _assert_adam_close(params[name].detach().numpy(), jnew[name], ref,
                           name)
    for name, p in model.vqa_model.named_parameters():
        assert p.grad is None and p not in state.optimizer.state, name
        assert torch.equal(p, backbone[name]), name


def test_trajectory_30_steps_f32_tracks_jax(world, monkeypatch):
    """30 steps (10 epochs of 3 batches, z cache on, dropout off): per-step
    losses within rtol 1e-4, equal recall counts, and the final
    log-softmax scores of every example within rtol 1e-3."""
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "float32")
    w = world
    opt = optax.adam(LR)
    model = copy.deepcopy(w.pmodel)
    state = port_engine.init_cx_state(model, lr=LR)
    with jax_policy.compute_dtype_scope("float32"):
        jstep = jax_engine.make_cx_train_step(
            w.jmodel, opt, use_q_cache=True, use_z_cache=True)
        losses, jstate, state = _run_pair(
            w, model, w.steps, jax_step=jstep,
            port_step=port_engine.make_cx_train_step(
                model, state.optimizer, use_z_cache=True),
            pstate=state, jstate=_jax_state(w.jmodel, w.params, opt),
            tables_j=(w.q, None, w.z),
            tables_p=dict(q_table=torch.from_numpy(w.q),
                          z_table=torch.from_numpy(w.z)),
            features_j=jnp.asarray(w.feats),
            features_p=torch.from_numpy(w.feats))
        assert len(losses) == 30 and state.step == 30
        np.testing.assert_allclose(losses[:, 1], losses[:, 0], rtol=1e-4)
        np.testing.assert_array_equal(losses[:, 3], losses[:, 2])
        assert losses[-3:, 0].mean() < losses[:3, 0].mean()  # it learns
        ref = w.jmodel.apply(
            {"params": jstate.params}, jnp.asarray(w.feats)[
                w.arrays.image_idxs], w.arrays.question_wids,
            w.arrays.answer_aids, deterministic=True, q_emb=w.q, z_emb=w.z,
            rngs={"lesion": jax.random.key(0)})
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(w.feats[w.arrays.image_idxs]),
                           torch.from_numpy(w.arrays.question_wids),
                           torch.from_numpy(w.arrays.answer_aids),
                           q_emb=torch.from_numpy(w.q),
                           z_emb=torch.from_numpy(w.z))
    np.testing.assert_allclose(_log_softmax(got.numpy()), _log_softmax(ref),
                               rtol=1e-3, atol=1e-4)


def test_trajectory_bf16_tracks_jax(world, monkeypatch):
    """10 steps under the bf16 policy, z cache on, table form: the JAX step
    runs the vfeat (forward and backward) and mixture Pallas kernels in
    interpret mode, the port their plain versions.  Per-step losses
    within 5e-2 relative; the first step's vfeat weight gradients (the
    v_other and v_mult columns of ``linear_1``) within 5e-2 of the largest
    entry."""
    for env in KERNEL_ENVS:
        monkeypatch.setenv(env, "interpret")
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "bfloat16")
    w = world
    opt = optax.adam(LR)
    model = copy.deepcopy(w.pmodel)
    state = port_engine.init_cx_state(model, lr=LR)
    assert model.wants_table_features()
    with jax_policy.compute_dtype_scope("bfloat16"):
        assert w.jmodel.wants_table_features()
        feats, q, _, z = jax_engine.make_tables_bf16_resident(
            jnp.asarray(w.feats), jnp.asarray(w.q), None, jnp.asarray(w.z))
        jstate = _jax_state(w.jmodel, w.params, opt)
        idx, n_valid = w.steps[0]
        jbatch = jax_vqacx.gather_batch(w.arrays, idx)
        trainable, frozen = jax_engine.split_params(jstate.params,
                                                    ("vqa_model",))
        kw = jax_engine.cache_kwargs(jbatch, q, None, z)

        @jax.jit
        def grad_w1(tr):
            def loss_fn(tr):
                scores = w.jmodel.apply(
                    {"params": {**tr, **frozen}}, None,
                    jbatch["question_wids"], jbatch["answer_aids"],
                    deterministic=False, features_table=feats,
                    image_idxs=jbatch["image_idxs"],
                    rngs={"dropout": jax.random.key(0),
                          "lesion": jax.random.key(1)}, **kw)
                logp = jax.nn.log_softmax(scores, axis=-1)
                nll = -jnp.take_along_axis(
                    logp, jbatch["comp_idxs"][:, None], axis=-1)[:, 0]
                return jnp.sum(nll * (jnp.arange(B) < n_valid)) / n_valid
            return jax.grad(loss_fn)(tr)["linear_1_w"]

        g1 = np.asarray(grad_w1(trainable), np.float32)
        f32 = np.array(feats.astype(jnp.float32))
        tables_p = {name + "_table": torch.from_numpy(np.array(
            t.astype(jnp.float32))).to(torch.bfloat16)
            for name, t in (("q", q), ("z", z))}
        jstep = jax_engine.make_cx_train_step(w.jmodel, opt,
                                              use_q_cache=True,
                                              use_z_cache=True)
        pstep = port_engine.make_cx_train_step(model, state.optimizer,
                                               use_z_cache=True)
        run = dict(jax_step=jstep, port_step=pstep, tables_j=(q, None, z),
                   tables_p=tables_p, features_j=feats,
                   features_p=torch.from_numpy(f32).to(torch.bfloat16))
        first, jstate, state = _run_pair(w, model, w.steps[:1], pstate=state,
                                         jstate=jstate, **run)
        got = model.linear_1.weight.grad.t().numpy()
        offs = model.slices.offsets()
        for name in ("v_other", "v_mult"):
            lo, hi = offs[name]
            ref = g1[lo:hi]
            assert np.abs(got[lo:hi] - ref).max() <= \
                5e-2 * np.abs(ref).max(), name
        rest, _, state = _run_pair(w, model, w.steps[1:10], pstate=state,
                                   jstate=jstate, **run)
    losses = np.concatenate([first, rest])
    assert len(losses) == 10 and state.step == 10
    assert np.isfinite(losses).all()
    np.testing.assert_allclose(losses[:, 1], losses[:, 0], rtol=5e-2)


def test_q_v_cache_path_without_z_tracks_jax(world, monkeypatch):
    """The q + v cache path (no z cache: the fusion runs in the step on the
    per-image v projections), 6 steps at f32."""
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "float32")
    w = world
    opt = optax.adam(LR)
    model = copy.deepcopy(w.pmodel)
    state = port_engine.init_cx_state(model, lr=LR)
    with jax_policy.compute_dtype_scope("float32"):
        _, v, _, _ = jax_engine.build_frozen_caches(
            w.jmodel, w.params, jnp.asarray(w.feats), w.arrays, use_q=False,
            use_v=True, use_z=False)
        v = np.asarray(v)
        losses, jstate, state = _run_pair(
            w, model, w.steps[:6], jax_step=jax_engine.make_cx_train_step(
                w.jmodel, opt, use_q_cache=True, use_v_cache=True),
            port_step=port_engine.make_cx_train_step(model, state.optimizer),
            pstate=state, jstate=_jax_state(w.jmodel, w.params, opt),
            tables_j=(w.q, v), tables_p=dict(q_table=torch.from_numpy(w.q),
                                             v_table=torch.from_numpy(v)),
            features_j=jnp.asarray(w.feats),
            features_p=torch.from_numpy(w.feats))
        jnew = _trainable_as_port(jax_engine.split_params(
            jstate.params, ("vqa_model",))[0])
    np.testing.assert_allclose(losses[:, 1], losses[:, 0], rtol=1e-4)
    params = dict(model.named_parameters())
    for name, ref in jnew.items():
        if name not in SHIFT_ONLY:
            np.testing.assert_allclose(params[name].detach().numpy(), ref,
                                       rtol=0, atol=1e-5, err_msg=name)


def test_adam_state_carried_from_jax(world, monkeypatch):
    """5 JAX steps, then params and optax's mu / nu / count carried into a
    fresh port model and ``torch.optim.Adam``: step 6 agrees.  A fresh
    Adam (no moments) would move every param by about lr instead."""
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "float32")
    w = world
    opt = optax.adam(LR)
    with jax_policy.compute_dtype_scope("float32"):
        jstep = jax_engine.make_cx_train_step(w.jmodel, opt,
                                              use_q_cache=True,
                                              use_z_cache=True)
        jstate = _jax_state(w.jmodel, w.params, opt)
        for idx, n_valid in w.steps[:5]:
            jstate, _ = jstep(jstate, jnp.asarray(w.feats),
                              jax_vqacx.gather_batch(w.arrays, idx),
                              jnp.asarray(n_valid, jnp.float32), w.q, None,
                              w.z)
        host = jax.device_get(jstate)
        model = copy.deepcopy(w.pmodel)
        model.load_state_dict(from_jax.cx_state_dict_from_jax(host.params))
        state = port_engine.init_cx_state(model, lr=LR)
        from_jax.adam_state_from_jax(host.opt_state, model, state.optimizer)
        state.step = 5
        losses, jstate, state = _run_pair(
            w, model, w.steps[5:6], jax_step=jstep,
            port_step=port_engine.make_cx_train_step(
                model, state.optimizer, use_z_cache=True),
            pstate=state, jstate=jstate, tables_j=(w.q, None, w.z),
            tables_p=dict(q_table=torch.from_numpy(w.q),
                          z_table=torch.from_numpy(w.z)),
            features_j=jnp.asarray(w.feats),
            features_p=torch.from_numpy(w.feats))
        jnew = _trainable_as_port(jax_engine.split_params(
            jstate.params, ("vqa_model",))[0])
    assert float(state.optimizer.state[model.out.weight]["step"]) == 6
    np.testing.assert_allclose(losses[:, 1], losses[:, 0], rtol=1e-4)
    params = dict(model.named_parameters())
    for name, ref in jnew.items():
        if name not in SHIFT_ONLY:
            np.testing.assert_allclose(params[name].detach().numpy(), ref,
                                       rtol=0, atol=1e-6, err_msg=name)


# ---------------------------------------------------------------- lesions

def _scores(model, w, idx, **kw):
    return model(torch.from_numpy(w.feats[w.arrays.image_idxs[idx]]),
                 torch.from_numpy(w.arrays.question_wids[idx]),
                 torch.from_numpy(w.arrays.answer_aids[idx]), **kw)


def test_q_emb_lesion_alone_is_a_no_op(world):
    """The reference quirk: q_emb=False with z_emb=True lesions nothing,
    in both packages (the scores equal the unlesioned ones)."""
    w = world
    spec = dict(SPEC0, q_emb=False)
    jmodel, params, pmodel, _ = build_pair(w.dataset, seed=5, spec=spec)
    idx = np.arange(B)
    img = jnp.asarray(w.feats[w.arrays.image_idxs[idx]])
    args = (img, w.arrays.question_wids[idx], w.arrays.answer_aids[idx])
    with jax_policy.compute_dtype_scope("float32"):
        ref0 = w.jmodel.apply({"params": w.params}, *args,
                              deterministic=True,
                              rngs={"lesion": jax.random.key(0)})
        ref1 = jmodel.apply({"params": params}, *args, deterministic=True,
                            rngs={"lesion": jax.random.key(1)})
    np.testing.assert_array_equal(np.asarray(ref1), np.asarray(ref0))
    with torch.no_grad():
        got0 = _scores(w.pmodel.eval(), w, idx)
        got1 = _scores(pmodel.eval(), w, idx,
                       lesion_gen=torch.Generator().manual_seed(1))
    assert torch.equal(got0, got1)
    np.testing.assert_allclose(got1.numpy(), np.asarray(ref1), rtol=1e-4,
                               atol=1e-5)


LESIONS = {"v_emb": dict(v_emb=False), "v_rank": dict(v_rank=False),
           "a_emb": dict(a_emb=False),
           "q_emb+z_emb": dict(q_emb=False, z_emb=False)}


@pytest.mark.parametrize("lesion", sorted(LESIONS))
def test_random_lesion_trains(world, monkeypatch, lesion):
    """A lesioned model trains a step (finite loss, its parameters move)
    with placeholders drawn in [0, 1) from the step's lesion generator,
    and its eval is reproducible (the lesion stream is seeded per
    batch)."""
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "float32")
    w = world
    _, _, model, _ = build_pair(w.dataset, seed=5,
                                spec=dict(SPEC, **LESIONS[lesion]))
    draws = []
    uniform = port_cx._uniform

    def recording(gen, shape):
        draws.append(uniform(gen, shape))
        return draws[-1]

    monkeypatch.setattr(port_cx, "_uniform", recording)
    state = port_engine.init_cx_state(model, lr=LR)
    step = port_engine.make_cx_train_step(model, state.optimizer,
                                          use_z_cache=True)
    before = model.out.weight.detach().clone()
    idx, n_valid = w.steps[0]
    tables = dict(q_table=torch.from_numpy(w.q),
                  z_table=torch.from_numpy(w.z))
    state, m = step(state, torch.from_numpy(w.feats),
                    _port_batch(w.arrays, idx), n_valid, **tables)
    assert np.isfinite(float(m["loss"]))
    assert not torch.equal(before, model.out.weight)
    assert draws and all(0.0 <= d.min() and d.max() < 1.0 for d in draws)
    es = port_engine.make_cx_eval_step(model, use_z_cache=True)
    p_arrays = port_vqacx.CXArrays(*w.arrays)
    res = [port_engine.eval_model(es, torch.from_numpy(w.feats), p_arrays, B,
                                  **tables) for _ in range(2)]
    assert res[0] == res[1] and np.isfinite(res[0]["loss"])


def test_v_emb_lesion_ignores_the_caches(world):
    """With v_emb lesioned the features are redrawn per forward, so the
    per-image and per-example caches no longer apply: the scores do not
    depend on them."""
    w = world
    _, _, model, _ = build_pair(w.dataset, seed=5,
                                spec=dict(SPEC0, v_emb=False))
    idx = np.arange(B)
    q = torch.from_numpy(w.q[idx])
    z = torch.from_numpy(w.z[idx])
    out = []
    with torch.no_grad():
        for z_emb in (z, torch.randn_like(z), None):
            out.append(_scores(model.eval(), w, idx, q_emb=q, z_emb=z_emb,
                               lesion_gen=torch.Generator().manual_seed(3)))
    assert torch.equal(out[0], out[1]) and torch.equal(out[0], out[2])


# ---------------------------------------------------------- checkpoints, CLI

def _cli_args(tmp_path, *extra):
    return ["--cx_model", "NeuralModel", "--synthetic", "64", "--test",
            "--device", "cpu", "--path_opt", _tiny_cli_options(tmp_path),
            "--project_dir", str(tmp_path), *extra]


def _run_dir(tmp_path):
    (run,) = os.listdir(tmp_path / "logs" / "cx")
    return run, tmp_path / "logs" / "cx" / run


@pytest.mark.parametrize("z_cache", [True, False])
def test_port_cli_trains_checkpoints_and_tests(tmp_path, monkeypatch,
                                               z_cache):
    """``--epochs 2 --test``: per-epoch val, ckpt/ and best/ written, the
    test scored on the best epoch's checkpoint."""
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "float32")
    info = port_cli.main(_cli_args(tmp_path, "--epochs", "2",
                                   *(["--z_cache"] if z_cache else [])))
    assert len(info) == 2
    _, run_dir = _run_dir(tmp_path)
    for sub in ("ckpt", "best"):
        for name in ("model.ckpt", "info.ckpt"):
            assert (run_dir / sub / name).is_file(), (sub, name)
    assert len(json.loads((run_dir / "ckpt" / "info.ckpt").read_text())) == 2
    res = json.loads((run_dir / "final_results.txt").read_text())
    assert set(res) == {"loss", "recall", "recall_1", "best_epoch"}
    recalls = [e["recall"] for e in info]
    # the reference's convention: the epoch after the best checkpoint's
    assert res["best_epoch"] == 2 + int(np.argmax(recalls))
    assert np.isfinite(res["loss"])


def test_port_cli_resumes(tmp_path, monkeypatch):
    """``--resume <run>`` picks up the Adam state, the step and the epoch
    count: a 2-epoch run resumed with ``--epochs 3`` trains epoch 3."""
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "float32")
    port_cli.main(_cli_args(tmp_path, "--epochs", "2", "--z_cache"))
    run, run_dir = _run_dir(tmp_path)
    step2 = int(msgpack_tree.load(str(run_dir / "ckpt" /
                                      "model.ckpt"))["step"])
    info = port_cli.main(_cli_args(tmp_path, "--epochs", "3", "--z_cache",
                                   "--resume", run))
    assert len(info) == 3
    payload = msgpack_tree.load(str(run_dir / "ckpt" / "model.ckpt"))
    assert int(payload["step"]) == step2 * 3 // 2
    assert len(json.loads((run_dir / "ckpt" / "info.ckpt").read_text())) == 3


def test_port_cli_needs_a_card_or_cpu_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = [a for a in _cli_args(tmp_path, "--epochs", "0")
            if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="--device cpu"):
        port_cli.main(args)
