"""The port's scoring slice end to end against the JAX engine: the
frozen-backbone caches (q via the GRU, v, z) and ``eval_model`` over a
dataset, plus the port's CLI on synthetic data.

At f32 the port's loss / recall / recall_1 hold to the JAX engine's at rtol
1e-4.  At bf16 the JAX side runs its three Pallas kernels in interpret
mode and the port its kernels' plain versions; scores hold within 5e-2
(tests/test_fused_head.py's bound for the JAX package's own fused vs
unfused bf16 paths).
"""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqa_counterexamples_tpu.core import policy as jax_policy
from vqa_counterexamples_tpu.data import synthetic as jax_synthetic
from vqa_counterexamples_tpu.engines import cx_engine as jax_engine
from vqa_counterexamples_tpu_torch.cli import counterexamples as port_cli
from vqa_counterexamples_tpu_torch.data import vqacx as port_vqacx
from vqa_counterexamples_tpu_torch.engines import cx_engine as port_engine

from test_torch_modules import KERNEL_ENVS, build_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, BATCH = 6, 16


@pytest.fixture(scope="module")
def setup():
    dataset, store = jax_synthetic.make_synthetic_cx(
        n_examples=40, n_images=24, dim_v=128, knn_size=K, n_words=20,
        n_answers=20, seed=8)
    jmodel, params, pmodel, arrays = build_pair(dataset, seed=3)
    return jmodel, params, pmodel, arrays, store.features


def _run_jax(jmodel, params, feats, arrays, bf16):
    q, _, z, _ = jax_engine.build_frozen_caches(
        jmodel, params, jnp.asarray(feats), arrays, use_q=True, use_v=False,
        use_z=True)
    features = jnp.asarray(feats)
    if bf16:
        features, q, _, z = jax_engine.make_tables_bf16_resident(
            features, q, None, z)
    es = jax_engine.make_cx_eval_step(jmodel, recall_k=5, use_q_cache=True,
                                      use_z_cache=True)
    res = jax_engine.eval_model(es, params, features, arrays, BATCH,
                                q_table=q, z_table=z)
    idx = np.arange(BATCH)
    kw = {"q_emb": q[idx], "z_emb": z[idx]}
    if jmodel.wants_table_features():
        kw.update(features_table=features,
                  image_idxs=jnp.asarray(arrays.image_idxs[idx]))
        img = None
    else:
        img = features[arrays.image_idxs[idx]]
    scores = jmodel.apply({"params": params}, img,
                          jnp.asarray(arrays.question_wids[idx]),
                          jnp.asarray(arrays.answer_aids[idx]),
                          deterministic=True,
                          rngs={"lesion": jax.random.key(0)}, **kw)
    return res, np.asarray(scores, np.float32), np.asarray(q, np.float32), \
        np.asarray(z, np.float32)


def _run_port(pmodel, feats, arrays, bf16):
    p_arrays = port_vqacx.CXArrays(*arrays)
    features = torch.from_numpy(feats)
    q, v, z, stage_s = port_engine.build_frozen_caches(
        pmodel, features, p_arrays, use_q=True, use_v=False, use_z=True)
    assert v is None and set(stage_s) == {"q", "v", "z"}
    if bf16:
        features, q, _, z = port_engine.make_tables_bf16_resident(
            features, q, None, z)
    es = port_engine.make_cx_eval_step(pmodel, recall_k=5, use_z_cache=True)
    res = port_engine.eval_model(es, features, p_arrays, BATCH, q_table=q,
                                 z_table=z)
    batch = port_engine.batch_to_device(
        port_vqacx.gather_batch(p_arrays, np.arange(BATCH)), "cpu")
    kw = port_engine.cache_kwargs(batch, q, None, z)
    with torch.no_grad():
        scores = pmodel(None, batch["question_wids"], batch["answer_aids"],
                        features_table=features,
                        image_idxs=batch["image_idxs"], **kw)
    return res, scores.numpy(), q.float().numpy(), z.float().numpy()


def test_slice_matches_jax_engine_f32(setup, monkeypatch):
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "float32")
    jmodel, params, pmodel, arrays, feats = setup
    with jax_policy.compute_dtype_scope("float32"):
        r_j, s_j, q_j, z_j = _run_jax(jmodel, params, feats, arrays, False)
        r_p, s_p, q_p, z_p = _run_port(pmodel, feats, arrays, False)
    np.testing.assert_allclose(q_p, q_j, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(z_p, z_j, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(s_p, s_j, rtol=1e-4, atol=1e-5)
    assert set(r_p) == {"loss", "recall", "recall_1"}
    for key in r_j:
        assert r_p[key] == pytest.approx(r_j[key], rel=1e-4, abs=1e-6), key


def test_slice_matches_jax_engine_bf16(setup, monkeypatch):
    for env in KERNEL_ENVS:
        monkeypatch.setenv(env, "interpret")
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", "bfloat16")
    jmodel, params, pmodel, arrays, feats = setup
    with jax_policy.compute_dtype_scope("bfloat16"):
        assert jmodel.wants_table_features() and pmodel.wants_table_features()
        r_j, s_j, q_j, z_j = _run_jax(jmodel, params, feats, arrays, True)
        r_p, s_p, q_p, z_p = _run_port(pmodel, feats, arrays, True)
    np.testing.assert_allclose(q_p, q_j, rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(z_p, z_j, rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(s_p, s_j, rtol=5e-2, atol=5e-2)
    assert r_p["loss"] == pytest.approx(r_j["loss"], rel=5e-2)
    for key in ("recall", "recall_1"):
        assert 0.0 <= r_p[key] <= 1.0


def _tiny_cli_options(tmp_path):
    base = os.path.join(REPO, "configs", "cx", "counterexamples_default.yaml")
    path = tmp_path / "tiny.yaml"
    path.write_text(
        "base: %s\n"
        "model:\n"
        "  seq2vec: {emb_size: 16, hidden_size: 32}\n"
        "  fusion: {dim_q: 32, dim_hv: 24, dim_hq: 24, dim_mm: 24, R: 3}\n"
        "cx_model: {dim_h: 24, dim_a: 40}\n"
        "optim: {batch_size: 24}\n" % base)
    return str(path)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_cli_scores_synthetic(tmp_path, monkeypatch, dtype):
    monkeypatch.setenv("VQACX_COMPUTE_DTYPE", dtype)
    port_cli.main(["--cx_model", "NeuralModel", "--synthetic", "64",
                   "--z_cache", "--epochs", "0", "--test", "--device", "cpu",
                   "--path_opt", _tiny_cli_options(tmp_path),
                   "--project_dir", str(tmp_path)])
    (run,) = os.listdir(tmp_path / "logs" / "cx")
    run_dir = tmp_path / "logs" / "cx" / run
    assert (run_dir / "options.yaml").exists()
    res = json.loads((run_dir / "final_results.txt").read_text())
    assert set(res) == {"loss", "recall", "recall_1", "best_epoch"}
    assert np.isfinite(res["loss"]) and res["loss"] > 0
    assert 0.0 <= res["recall_1"] <= res["recall"] <= 1.0


@pytest.mark.parametrize("flag,tag", [
    (["--mesh", "data=2"], "Queue 1 #12"), (["--viz"], "Queue 1 #13"),
    (["--init_params", "p.msgpack"], "Queue 1: the msgpack bridge")])
def test_port_cli_refuses_training(tmp_path, monkeypatch, flag, tag):
    """Training runs now (tests/test_torch_train.py), the scanned trainer
    too (``--scan_steps``, tests/test_torch_scan.py), pairwise training and
    the zoo as well (tests/test_torch_zoo.py), and the flags the port once
    refused run on a scanned run (without ``--pairwise``: NeuralModel does
    not train on pairwise triples).  ``--mesh`` (#12): two gloo ranks, the
    scan ignored as JAX's CLI ignores it under a mesh, the same evals as
    one rank's scanned run (to the sum order).  ``--viz`` (#13): the best checkpoint ranked and, with no raw
    image directory, no grid drawn.  ``--init_params`` (the msgpack
    bridge): the params of a run's checkpoint start a second run, whose
    first eval is the first run's best one."""
    argv = ["--cx_model", "NeuralModel", "--synthetic", "64", "--epochs",
            "1", "--scan_steps", "4", "--device", "cpu", "--path_opt",
            _tiny_cli_options(tmp_path)]
    if "--mesh" in flag:
        monkeypatch.setenv("VQACX_DIST_TIMEOUT", "120")
        one = port_cli.main(argv + ["--project_dir", str(tmp_path / "one")])
        ranked = port_cli.main(argv + ["--project_dir",
                                       str(tmp_path / "mesh")] + flag)
        assert len(ranked) == len(one) == 1
        assert set(ranked[0]) == set(one[0]) == {"loss", "recall",
                                                 "recall_1"}
        for k, v in one[0].items():
            assert ranked[0][k] == pytest.approx(v, rel=1e-4, abs=1e-6), k
        (run,) = os.listdir(tmp_path / "mesh" / "logs" / "cx")
        assert os.path.exists(tmp_path / "mesh" / "logs" / "cx" / run /
                              "ckpt" / "model.ckpt")
        return
    first = port_cli.main(argv + ["--project_dir", str(tmp_path / "a")] + (
        flag if "--viz" in flag else []))
    (run,) = os.listdir(tmp_path / "a" / "logs" / "cx")
    if "--viz" in flag:
        assert os.listdir(tmp_path / "a" / "viz" / "cx" / run) == []
        return
    from vqa_counterexamples_tpu_torch.core import msgpack_tree

    params = str(tmp_path / flag[1])
    msgpack_tree.save(msgpack_tree.load(str(
        tmp_path / "a" / "logs" / "cx" / run / "best" / "model.ckpt"))[
            "params"], params)
    second = port_cli.main(argv + ["--epochs", "0", "--test",
                                   "--project_dir", str(tmp_path / "b"),
                                   "--init_params", params])
    assert second == []
    (run,) = os.listdir(tmp_path / "b" / "logs" / "cx")
    res = json.loads((tmp_path / "b" / "logs" / "cx" / run /
                      "final_results.txt").read_text())
    # synthetic runs score their val set as the test set
    for k in ("loss", "recall"):
        assert res[k] == pytest.approx(first[0][k], rel=1e-6), k
