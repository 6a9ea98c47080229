"""The multi-rank dry run behind ``parallel.dryrun_multichip``: one CX
train step at tiny shapes (NeuralCX over MutanNoAtt, the q and z caches,
dropout on), on one rank and on n gloo CPU ranks, then the row-sharded
gather and the sharded kNN on the ranks."""

from __future__ import annotations

import numpy as np
import torch

BATCH = 16


def _world():
    from ..data import synthetic, vqacx
    from ..engines import cx_engine
    from ..models import factory

    dataset, store = synthetic.make_synthetic_cx(
        n_examples=2 * BATCH, n_images=40, dim_v=32, knn_size=6,
        n_words=20, n_answers=10, seed=0)
    opt = synthetic.tiny_vqa_options(dim_v=32, nans=10)
    vqa = factory.factory_vqa(opt, dataset["vocab_words"],
                              dataset["vocab_answers"])
    spec = dict(dim_h=16, n_layers=2, drop_p=0.25, v_emb=True, v_mult=True,
                v_dist=True, v_rank=True, q_emb=True, a_emb=True,
                z_emb=True, pretrained_emb=False, trainable_vqa=False)
    model = cx_engine.init_cx_params(factory.factory_cx(
        "NeuralModel", vqa, knn_size=6, model_spec=spec), seed=0)
    arrays = vqacx.CXArrays.from_examples(dataset["examples_list"],
                                          dataset["name_to_index"])
    return model, arrays, torch.from_numpy(store.features)


def cx_step(mesh) -> dict:
    """One train step on the first batch (13 valid rows of 16) -> the
    loss and every trainable parameter after the update, as numpy."""
    from ..data import vqacx
    from ..engines import cx_engine

    model, arrays, features = _world()
    q, _, z, _ = cx_engine.build_frozen_caches(model, features, arrays)
    # SGD, as JAX's test of its mesh step: Adam's first update is +-lr
    # wherever a gradient is near 0, and the sum order flips its sign
    sgd = torch.optim.SGD([p for _, p in cx_engine.trainable_parameters(
        model)], lr=0.1)
    state = cx_engine.CXTrainState(model, sgd)
    step = cx_engine.make_cx_train_step(model, sgd,
                                        use_z_cache=True, mesh=mesh)
    idx = np.concatenate([np.arange(13), np.zeros(3, np.int64)])
    _, m = step(state, features, vqacx.gather_batch(arrays, idx), 13,
                q_table=q, z_table=z)
    out = {n: p.detach().numpy().copy()
           for n, p in cx_engine.trainable_parameters(model)}
    out["loss"] = np.float32(m["loss"])
    return out


def rank(n_ranks: int) -> dict:
    """This rank's part of the dry run: the step, then the gather and the
    kNN held against their one-rank values here."""
    from ..ops import topk
    from . import mesh_from_env, shard_rows, sharded_gather

    with mesh_from_env({"data": n_ranks}, "cpu") as mesh:
        out = cx_step(mesh)
        feats = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (50, 8), dtype=np.float32))
        shard = shard_rows(feats, mesh, "data")
        idx = torch.arange(49, -1, -3)
        if not torch.equal(sharded_gather(shard.rows, idx, mesh, "data",
                                          shard.start), feats[idx]):
            raise AssertionError("sharded_gather differs from a plain take")
        got = topk.knn(feats, k=4, device="cpu", mesh=mesh, batch_size=16)
        ref = topk.knn(feats, k=4, device="cpu", batch_size=16)
        if not all(np.array_equal(a, b) for a, b in zip(got, ref)):
            raise AssertionError("the sharded kNN differs from one rank's")
    return out


def compare(single: dict, ranked: dict) -> None:
    if abs(float(single["loss"]) - float(ranked["loss"])) > 1e-5:
        raise AssertionError("loss %r on the ranks, %r on one"
                             % (ranked["loss"], single["loss"]))
    for name, ref in single.items():
        np.testing.assert_allclose(ranked[name], ref, rtol=0, atol=1e-5,
                                   err_msg=name)
