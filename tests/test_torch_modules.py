"""Modules of the PyTorch port against their JAX counterparts, with the
weights carried across by ``models/from_jax``.

Sizes are small (dim_v 128, skip-thoughts emb 16 / hidden 32, MUTAN R 3
with dims 24, K 6, 20 answers).  At f32 the port holds to rtol 1e-4 /
atol 1e-5.  At bf16 the JAX side runs its Pallas kernels in interpret mode
(``VQACX_{GRU_PALLAS,FUSED_VFEAT,FUSED_HEAD}=interpret``) and the port its
kernels' plain versions (CPU tensors); the bound is 5e-2, as the JAX
package holds its fused and unfused bf16 paths (tests/test_fused_head.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqa_counterexamples_tpu.core import policy as jax_policy
from vqa_counterexamples_tpu.data import synthetic as jax_synthetic
from vqa_counterexamples_tpu.data import vqacx as jax_vqacx
from vqa_counterexamples_tpu.engines import cx_engine as jax_engine
from vqa_counterexamples_tpu.models import factory as jax_factory
from vqa_counterexamples_tpu.models import port_torch
from vqa_counterexamples_tpu.ops import scorer as jax_scorer
from vqa_counterexamples_tpu_torch.engines import cx_engine as port_engine
from vqa_counterexamples_tpu_torch.models import factory as port_factory
from vqa_counterexamples_tpu_torch.models import from_jax
from vqa_counterexamples_tpu_torch.ops import scorer as port_scorer

K = 6
F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=5e-2, atol=5e-2)
KERNEL_ENVS = ("VQACX_GRU_PALLAS", "VQACX_FUSED_VFEAT", "VQACX_FUSED_HEAD")


def tiny_options(dim_v=128, n_answers=20):
    opt = jax_synthetic.tiny_vqa_options(dim_v=dim_v, nans=n_answers,
                                         dim_q=32)
    opt["seq2vec"] = {"arch": "skipthoughts", "type": "BayesianUniSkip",
                      "dropout": 0.25, "fixed_emb": False, "emb_size": 16,
                      "hidden_size": 32}
    return opt


SPEC = dict(dim_h=24, n_layers=2, drop_p=0.25, dim_a=40, v_emb=True,
            v_mult=True, v_dist=True, v_rank=True, q_emb=True, a_emb=True,
            z_emb=True, pretrained_emb=False, trainable_vqa=False)


def build_pair(dataset, knn=K, dim_v=128, seed=0, spec=None):
    """(jax model, jax params, port model): the port model's seeded init is
    read into the flax tree by the JAX package's ``port_torch``, and a
    second port model takes the weights back through ``from_jax``."""
    opt = tiny_options(dim_v=dim_v, n_answers=len(dataset["vocab_answers"]))
    words, answers = dataset["vocab_words"], dataset["vocab_answers"]
    spec = SPEC if spec is None else spec
    jmodel = jax_factory.factory_cx(
        "NeuralModel", jax_factory.factory_vqa(opt, words, answers),
        knn_size=knn, model_spec=spec)

    def port_model():
        return port_factory.factory_cx(
            "NeuralModel", port_factory.factory_vqa(opt, words, answers),
            knn_size=knn, model_spec=spec)

    source = port_engine.init_cx_params(port_model(), seed=seed)
    # unit-scale word embeddings (the init's N(0, 0.02) leaves the GRU
    # states near 0.01, where the bf16 bounds would say nothing)
    with torch.no_grad():
        source.vqa_model.seq2vec.embedding.weight.normal_(
            0.0, 1.0, generator=torch.Generator().manual_seed(seed + 1))
    params, _, _ = port_torch.port_cx_state_dict(source.state_dict())
    pmodel = port_model()
    pmodel.load_state_dict(from_jax.cx_state_dict_from_jax(params))
    arrays = jax_vqacx.CXArrays.from_examples(dataset["examples_list"],
                                              dataset["name_to_index"])
    return jmodel, params, pmodel.eval(), arrays


@pytest.fixture(scope="module")
def setup():
    dataset, store = jax_synthetic.make_synthetic_cx(
        n_examples=16, n_images=20, dim_v=128, knn_size=K, n_words=20,
        n_answers=20, seed=4)
    jmodel, params, pmodel, arrays = build_pair(dataset)
    return jmodel, params, pmodel, arrays, store.features


@pytest.fixture(params=["float32", "bfloat16"])
def dtype(request, monkeypatch):
    if request.param == "bfloat16":
        for env in KERNEL_ENVS:
            monkeypatch.setenv(env, "interpret")
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", request.param)
    with jax_policy.compute_dtype_scope(request.param):
        yield request.param


def _close(port, ref, dtype):
    np.testing.assert_allclose(
        port.detach().float().numpy(), np.asarray(ref, np.float32),
        **(F32 if dtype == "float32" else BF16))


def _jax_vqa(jmodel, params, method, *args):
    return jmodel.apply({"params": params}, *[jnp.asarray(a) for a in args],
                        method=lambda m, *a: method(m.vqa_model, *a))


def test_skipthoughts_matches_jax(setup, dtype):
    jmodel, params, pmodel, arrays, _ = setup
    wids = arrays.question_wids
    ref = _jax_vqa(jmodel, params,
                   lambda v, w: v.encode_question(w, True), wids)
    got = pmodel.vqa_model.encode_question(torch.from_numpy(wids))
    assert got.dtype == (torch.float32 if dtype == "float32"
                         else torch.bfloat16)
    _close(got, ref, dtype)


def test_mutan_fusion_and_head_match_jax(setup, dtype):
    jmodel, params, pmodel, arrays, feats = setup
    vqa = pmodel.vqa_model
    ref_v = _jax_vqa(jmodel, params, lambda v, x: v.project_image(x, True),
                     feats)
    got_v = vqa.project_image(torch.from_numpy(feats))
    _close(got_v, ref_v, dtype)

    q = np.random.default_rng(0).normal(size=(arrays.size, 32)).astype(
        np.float32)
    hv = np.asarray(ref_v)[arrays.image_idxs]          # (N, K+1, R, dmm)
    ref_z = _jax_vqa(jmodel, params,
                     lambda v, q_, h: v.fuse_candidates(None, q_, True,
                                                        v_proj=h), q, hv)
    got_z = vqa.fuse_candidates(None, torch.from_numpy(q),
                                v_proj=torch.from_numpy(hv))
    _close(got_z, ref_z, dtype)

    z = np.array(ref_z, np.float32).reshape(-1, 24)
    ref_a = _jax_vqa(jmodel, params, lambda v, x: v.classify(x, True), z)
    _close(vqa.classify(torch.from_numpy(z)), ref_a, dtype)


def test_neural_model_table_form_matches_jax(setup, dtype):
    """NeuralModel fed like the engine's step: table form + q/z caches.
    At bf16 this is the path through all three kernels (JAX: Pallas in
    interpret mode; port: the kernels' plain versions)."""
    jmodel, params, pmodel, arrays, feats = setup
    table = feats if dtype == "float32" else np.array(
        jnp.asarray(feats, jnp.bfloat16).astype(jnp.float32))
    idx = np.arange(arrays.size)
    q = np.asarray(jax_engine.precompute_q_emb(jmodel, params,
                                               arrays.question_wids),
                   np.float32)
    v = np.asarray(jax_engine.precompute_v_proj(jmodel, params, table))
    z = np.asarray(jax_engine.precompute_z_emb(
        jmodel, params, table, arrays.image_idxs, q, v_table=v),
        np.float32)
    tdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    ref = jmodel.apply(
        {"params": params}, None, jnp.asarray(arrays.question_wids[idx]),
        jnp.asarray(arrays.answer_aids[idx]), deterministic=True,
        q_emb=jnp.asarray(q[idx], tdt), z_emb=jnp.asarray(z[idx], tdt),
        features_table=jnp.asarray(table, tdt),
        image_idxs=jnp.asarray(arrays.image_idxs[idx]),
        rngs={"lesion": jax.random.key(0)})

    pdt = torch.float32 if dtype == "float32" else torch.bfloat16
    got = pmodel(None, torch.from_numpy(arrays.question_wids[idx]),
                 torch.from_numpy(arrays.answer_aids[idx]),
                 q_emb=torch.from_numpy(q[idx]).to(pdt),
                 z_emb=torch.from_numpy(z[idx]).to(pdt),
                 features_table=torch.from_numpy(table).to(pdt),
                 image_idxs=torch.from_numpy(arrays.image_idxs[idx]))
    assert tuple(got.shape) == (arrays.size, K)
    assert got.dtype == torch.float32
    _close(got, ref, dtype)


def test_neural_model_image_features_matches_jax(setup):
    """The materialized-gather form with no caches (encoder and fusion in
    the forward), f32."""
    jmodel, params, pmodel, arrays, feats = setup
    img = feats[arrays.image_idxs]
    ref = jmodel.apply({"params": params}, jnp.asarray(img),
                       jnp.asarray(arrays.question_wids),
                       jnp.asarray(arrays.answer_aids), deterministic=True,
                       rngs={"lesion": jax.random.key(0)})
    got = pmodel(torch.from_numpy(img), torch.from_numpy(arrays.question_wids),
                 torch.from_numpy(arrays.answer_aids))
    _close(got, ref, "float32")


def test_scorer_matches_jax():
    rng = np.random.default_rng(5)
    slices = port_scorer.FeatureSlices(dim_v=12, dim_q=8, dim_z=6, dim_a=10,
                                       knn_size=4)
    assert tuple(slices) == tuple(jax_scorer.FeatureSlices(12, 8, 6, 10, 4))
    assert slices.offsets() == jax_scorer.FeatureSlices(
        12, 8, 6, 10, 4).offsets()
    b, n_ans, hid = 3, 7, 5

    def r(*s):
        return rng.normal(size=s).astype(np.float32)

    w1, b1 = r(slices.input_size, hid), r(hid)
    feats = dict(v_orig=r(b, 12), v_knns=r(b, 4, 12), v_mult=r(b, 4, 12),
                 v_dist=np.abs(r(b, 4)), q_emb=r(b, 8), z_orig=r(b, 6),
                 z_knns=r(b, 4, 6), a_emb_gt=r(b, 10))
    logits, table = r(b, 4, n_ans), r(n_ans, 10)
    ref = jax_scorer.first_layer_decomposed(
        jnp.asarray(w1), jnp.asarray(b1), slices,
        v_rank=jnp.broadcast_to(jnp.eye(4)[None], (b, 4, 4)),
        a_emb_knns_factored=(jnp.asarray(logits), jnp.asarray(table)),
        **{k: jnp.asarray(v) for k, v in feats.items()})
    got = port_scorer.first_layer_decomposed(
        torch.from_numpy(w1), torch.from_numpy(b1), slices,
        a_emb_knns_factored=(torch.from_numpy(logits),
                             torch.from_numpy(table)),
        **{k: torch.from_numpy(v) for k, v in feats.items()})
    _close(got, ref, "float32")

    ws, bs, wo, bo = [r(hid, hid)], [r(hid)], r(hid, 1), r(1)
    ref_t = jax_scorer.mlp_tail(ref, [jnp.asarray(ws[0])],
                                [jnp.asarray(bs[0])], jnp.asarray(wo),
                                jnp.asarray(bo), drop_p=0.25,
                                deterministic=True, rng=None)
    got_t = port_scorer.mlp_tail(got, [torch.from_numpy(ws[0])],
                                 [torch.from_numpy(bs[0])],
                                 torch.from_numpy(wo), torch.from_numpy(bo))
    _close(got_t, ref_t, "float32")


def test_port_cx_state_dict_round_trip(setup):
    """flax tree -> from_jax -> port state_dict -> port_torch -> the same
    flax tree, leaf for leaf; and the tree fits the JAX model's own init."""
    jmodel, params, pmodel, arrays, feats = setup
    back, name, arch = port_torch.port_cx_state_dict(pmodel.state_dict())
    assert (name, arch) == ("NeuralModel", "MutanNoAtt")
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    flat_ref = dict(jax.tree_util.tree_leaves_with_path(params))
    assert len(flat_back) == len(flat_ref)
    for path, leaf in flat_back:
        np.testing.assert_array_equal(np.asarray(leaf), flat_ref[path])
    template = jax.eval_shape(
        lambda: jmodel.init(
            {"params": jax.random.key(0), "lesion": jax.random.key(1)},
            jnp.asarray(feats[arrays.image_idxs[:2]]),
            jnp.asarray(arrays.question_wids[:2]),
            jnp.asarray(arrays.answer_aids[:2]),
            deterministic=True)["params"])
    port_torch.graft(template, back)  # raises on a missing key or shape


def test_metrics_match_jax():
    from vqa_counterexamples_tpu.ops import metrics as jax_metrics
    from vqa_counterexamples_tpu_torch.ops import metrics as port_metrics

    rng = np.random.default_rng(11)
    scores = rng.normal(size=(9, 24)).astype(np.float32)
    labels = rng.integers(0, 24, size=9).astype(np.int32)
    for k in (1, 5):
        np.testing.assert_array_equal(
            port_metrics.recall_at_k(torch.from_numpy(scores),
                                     torch.from_numpy(labels), k).numpy(),
            np.asarray(jax_metrics.recall_at_k(jnp.asarray(scores),
                                               jnp.asarray(labels), k)))
    _close(port_metrics.cross_entropy_sum(torch.from_numpy(scores),
                                          torch.from_numpy(labels)),
           jax_metrics.cross_entropy_sum(jnp.asarray(scores),
                                         jnp.asarray(labels)), "float32")
    a = rng.normal(size=(9, 1, 16)).astype(np.float32)
    b = rng.normal(size=(9, 24, 16)).astype(np.float32)
    for keep in (True, False):
        _close(port_metrics.pairwise_distance(torch.from_numpy(a),
                                              torch.from_numpy(b),
                                              keepdims=keep),
               jax_metrics.pairwise_distance(jnp.asarray(a), jnp.asarray(b),
                                             keepdims=keep), "float32")


def test_neural_model_v_feature_lesion_matches_jax(monkeypatch):
    """v_mult / v_dist lesioned (zeros, no random draw): the kernel gate
    turns off and both sides take the gathered path (bf16)."""
    for env in KERNEL_ENVS:
        monkeypatch.setenv(env, "interpret")
    monkeypatch.setitem(SPEC, "v_mult", False)
    monkeypatch.setitem(SPEC, "v_dist", False)
    dataset, store = jax_synthetic.make_synthetic_cx(
        n_examples=8, n_images=12, dim_v=128, knn_size=K, n_words=20,
        n_answers=20, seed=6)
    jmodel, params, pmodel, arrays = build_pair(dataset, seed=2)
    feats = store.features
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "bfloat16")
    with jax_policy.compute_dtype_scope("bfloat16"):
        assert not pmodel.wants_table_features()
        ref = jmodel.apply({"params": params},
                           jnp.asarray(feats[arrays.image_idxs]),
                           jnp.asarray(arrays.question_wids),
                           jnp.asarray(arrays.answer_aids),
                           deterministic=True,
                           rngs={"lesion": jax.random.key(0)})
        with torch.no_grad():
            got = pmodel(None, torch.from_numpy(arrays.question_wids),
                         torch.from_numpy(arrays.answer_aids),
                         features_table=torch.from_numpy(feats),
                         image_idxs=torch.from_numpy(arrays.image_idxs))
    _close(got, ref, "bfloat16")


def test_unported_options_raise():
    """A trainable backbone (its backward is not wired into the CX step
    yet) and the other CX models still raise.  The lesions and the training mode are ported:
    what stays to refuse is training or lesioning without a generator."""
    dataset, _ = jax_synthetic.make_synthetic_cx(
        n_examples=4, n_images=10, dim_v=8, knn_size=3, n_answers=5)
    opt = tiny_options(dim_v=8, n_answers=5)
    vqa = port_factory.factory_vqa(opt, dataset["vocab_words"],
                                   dataset["vocab_answers"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_factory.factory_cx("NeuralModel", vqa, knn_size=3,
                                trainable_vqa=True, model_spec=SPEC)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_factory.factory_cx("PairwiseModel", vqa)
    args = (torch.zeros(1, 4, 8), torch.ones(1, 26, dtype=torch.int64),
            torch.zeros(1, dtype=torch.int64))
    model = port_factory.factory_cx("NeuralModel", vqa, knn_size=3,
                                    model_spec=SPEC)
    with pytest.raises(ValueError, match="dropout_gen"):
        model.train()(*args)
    lesioned = port_factory.factory_cx("NeuralModel", vqa, knn_size=3,
                                       model_spec=dict(SPEC, v_rank=False))
    with pytest.raises(ValueError, match="lesion_gen"):
        lesioned.eval()(*args)
