"""Rank functions for tests/test_torch_parallel.py.

``parallel.spawn`` starts each rank in a fresh process that imports its
target's module, so these live apart from the test module and import the
port only (no JAX).  Each builds its model from weights passed in as
numpy, runs the same steps as the one-rank reference and returns rank
0's losses and parameters.
"""

from __future__ import annotations

import numpy as np
import torch

from vqa_counterexamples_tpu_torch import parallel
from vqa_counterexamples_tpu_torch.data import vqacx
from vqa_counterexamples_tpu_torch.engines import cx_engine, vqa_engine
from vqa_counterexamples_tpu_torch.models import factory


def _optimizer(params, name, lr):
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr)
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def _ranked(fn, w, axes):
    """``fn(w, mesh)`` on one rank (``axes`` None) or as this rank of a
    gloo CPU mesh."""
    if axes is None:
        return fn(w, None)
    with parallel.mesh_from_env(axes, "cpu") as mesh:
        return fn(w, mesh)


def cx_run(w, axes=None):
    return _ranked(_cx_run, w, axes)


def _cx_run(w, mesh):
    """NeuralCX from ``w['state']``; ``w['steps']`` train steps, then an
    eval pass when ``w['eval']``.  The tables: the q / z caches (``w['q']``,
    ``w['z']``) or q / v (``w['v']``); with ``model`` > 1 the features and
    the v table are row-sharded."""
    model = factory.factory_cx(
        "NeuralModel", factory.factory_vqa(w["opt"], w["words"],
                                           w["answers"]),
        knn_size=w["knn"], model_spec=w["spec"])
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in w["state"].items()})
    model.eval()
    opt = _optimizer([p for _, p in cx_engine.trainable_parameters(model)],
                     w["optimizer"], w["lr"])
    state = cx_engine.CXTrainState(model, opt)
    features = torch.from_numpy(w["feats"])
    tables = {k + "_table": torch.from_numpy(w[k]) for k in ("q", "v", "z")
              if w.get(k) is not None}
    if mesh is not None and mesh.size("model") > 1:
        features = parallel.shard_rows(features, mesh)
        if "v_table" in tables:
            tables["v_table"] = parallel.shard_rows(tables["v_table"], mesh)
    use_z = "z_table" in tables
    step = cx_engine.make_cx_train_step(model, opt, use_z_cache=use_z,
                                        base_seed=w.get("seed", 42),
                                        mesh=mesh)
    arrays = vqacx.CXArrays(*w["arrays"])
    rows = []
    for idx, n_valid in w["steps"]:
        state, m = step(state, features, vqacx.gather_batch(arrays, idx),
                        n_valid, **tables)
        rows.append((float(m["loss"]), float(m["correct"])))
    out = {"losses": np.array(rows),
           "params": {n: p.detach().numpy().copy() for n, p in
                      cx_engine.trainable_parameters(model)}}
    if w.get("eval"):
        out["eval"] = cx_engine.eval_model(
            cx_engine.make_cx_eval_step(model, use_z_cache=use_z,
                                        mesh=mesh),
            features, arrays, w["batch"], **tables)
    return out


def vqa_run(w, axes=None):
    return _ranked(_vqa_run, w, axes)


def _vqa_run(w, mesh):
    """A VQA model from ``w['state']``; a train step on this rank's rows of
    each batch of ``w['batches']``."""
    model = factory.factory_vqa(w["opt"], w["words"], w["answers"])
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in w["state"].items()})
    opt = _optimizer(list(model.parameters()), w["optimizer"], w["lr"])
    state = vqa_engine.VQATrainState(model, opt)
    step = vqa_engine.make_vqa_train_step(model, opt, mesh=mesh)
    rows = []
    for b in w["batches"]:
        b = {k: b[k] for k in ("visual", "question", "answer")}
        if mesh is not None:
            b = parallel.shard_batch(b, mesh)
        state, m = step(state, dict(b, visual=torch.from_numpy(
            np.ascontiguousarray(b["visual"]))))
        rows.append([float(m[k]) for k in ("loss", "acc1", "acc5")])
    return {"losses": np.array(rows),
            "params": {n: p.detach().numpy().copy()
                       for n, p in model.named_parameters()}}


def gather_run(feats, idx, axes, axis):
    """``sharded_gather`` of rows ``idx`` of ``feats`` row-sharded over
    ``axis`` (uneven shards where the rows do not divide)."""
    with parallel.mesh_from_env(axes, "cpu") as mesh:
        shard = parallel.shard_rows(torch.from_numpy(feats), mesh, axis)
        return parallel.sharded_gather(shard.rows, torch.from_numpy(idx),
                                       mesh, axis, shard.start).numpy()


def fail_or_sleep(seconds):
    """Rank 1 raises ``KeyError``; the others sleep ``seconds`` (a rank
    that never reaches a collective)."""
    import os
    import time

    if os.environ["RANK"] == "1":
        raise KeyError("rank 1 failed")
    time.sleep(seconds)
    return int(os.environ["RANK"])


def knn_run(feats, k, batch_size, axes):
    from vqa_counterexamples_tpu_torch.ops import topk

    with parallel.mesh_from_env(axes, "cpu") as mesh:
        return topk.knn(feats, k=k, batch_size=batch_size, mesh=mesh)
