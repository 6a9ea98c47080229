"""Contrastive CX training (port of ``engines/contrastive_engine.py``;
reference ``contrastive.py``).

ContrastiveModel trains on (orig, comp, random-other) triples
(``CXArrays.pairwise_view``) with the Hadsell-Chopra margin loss: the comp
embedding is pushed at least ``margin`` away from the original's and the
random other pulled toward it.  In eval the candidates are ranked by
their embedding's Euclidean distance from the original's, larger being a
better counterexample (reference contrastive.py:217-219, 259-309).

The steps are built as the CX engine's are: a step body run by
``core/graphs.GraphedStep`` (a captured CUDA graph on a card, eager on the
CPU or with ``capture=False``), its dropout and lesion generators reseeded
from (seed, step) before each call, its metrics 0-d device tensors.  The
state is the CX engine's ``CXTrainState``.  Under a mesh (the steps'
``mesh=``) a step takes its rank's rows of the global triple batch, as
the CX engine's steps do: the masked means divide by the global
``n_valid``, the draws are made at the global shape, and one all-reduce
over the data group sums the gradients and the metrics.
"""

from __future__ import annotations

import torch

from ..core import graphs
from ..core import rng as rng_lib
from ..ops.metrics import pairwise_distance, recall_at_k
from ..parallel.sharding import all_reduce_grads, batch_split, report_eager
from .cx_engine import (CXTrainState, _device, _valid_mask, cache_kwargs,
                        mesh_inputs, refuse_caches)

ContrastiveState = CXTrainState


def contrastive_loss(out1: torch.Tensor, out2: torch.Tensor,
                     label: torch.Tensor, margin: float = 2.0
                     ) -> torch.Tensor:
    """mean((1 - label) d^2 + label max(margin - d, 0)^2), d the Euclidean
    distance of the rows of ``out1`` and ``out2``."""
    d = pairwise_distance(out1, out2, keepdims=False)
    same = (1.0 - label) * d ** 2
    diff = label * torch.clamp(margin - d, min=0.0) ** 2
    return torch.mean(same + diff)


def _embed(model, features, batch, q_table, v_table, **gens):
    """(B, K+1, H) embeddings of a batch's images (the materialized
    gather, the caches' rows where given)."""
    kw = cache_kwargs(batch, q_table, v_table)
    return model(features[batch["image_idxs"].long()],
                 batch["question_wids"], batch["answer_aids"], **gens, **kw)


def make_contrastive_train_step(model, optimizer, *, margin: float = 2.0,
                                base_seed: int = 42,
                                capture: bool | None = None, mesh=None):
    """Returns ``train_step(state, features, batch, n_valid, q_table=None,
    v_table=None)`` -> ``(state, metrics)`` over a batch of triples
    (column 0 the original, 1 the comp, 2 the other): ``loss_comp`` =
    masked mean of max(margin - d(orig, comp), 0)^2, ``loss_other`` =
    masked mean of d(orig, other)^2, ``loss`` their sum (one backward, one
    Adam step), ``dist_comp`` / ``dist_other`` the distances' means over
    the batch's rows.  The tables are the frozen-backbone caches.
    ``mesh``: a ``parallel.Mesh`` (see the module docstring)."""
    gens = rng_lib.StepGenerators(("dropout", "lesion"), _device(model))

    def body(batch, features, q_table, v_table):
        model.train()
        row0, draws = batch_split(mesh, batch["comp_idxs"].shape[0])
        with draws:
            h = _embed(model, features, batch, q_table, v_table,
                       dropout_gen=gens["dropout"],
                       lesion_gen=gens["lesion"])
        w = _valid_mask(batch["comp_idxs"], batch["n_valid"], row0)
        # the global batch's mask sums to n_valid
        wsum = torch.clamp(torch.sum(w) if mesh is None
                           else batch["n_valid"].float(), min=1.0)
        d_comp = pairwise_distance(h[:, 0], h[:, 1], keepdims=False)
        d_other = pairwise_distance(h[:, 0], h[:, 2], keepdims=False)
        loss_comp = torch.sum(
            w * torch.clamp(margin - d_comp, min=0.0) ** 2) / wsum
        loss_other = torch.sum(w * d_other ** 2) / wsum
        loss = loss_comp + loss_other
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if mesh is None:
            optimizer.step()
        out = {"loss": loss.detach(), "loss_comp": loss_comp.detach(),
               "loss_other": loss_other.detach(),
               "dist_comp": torch.mean(d_comp.detach()),
               "dist_other": torch.mean(d_other.detach())}
        if mesh is not None:
            share = 1.0 / mesh.size("data")
            for k in ("dist_comp", "dist_other"):
                out[k] = out[k] * share
            out = dict(zip(out, all_reduce_grads(optimizer, mesh,
                                                 tuple(out.values()))))
            optimizer.step()
        return out

    run = graphs.GraphedStep(body, _device(model), generators=gens,
                             optimizer=optimizer, capture=capture, mesh=mesh)
    if mesh is not None:
        report_eager(run, "the contrastive train step", mesh)

    def train_step(state: CXTrainState, features, batch, n_valid,
                   q_table=None, v_table=None):
        refuse_caches(model, q_table is not None or v_table is not None)
        inputs, tables = mesh_inputs(batch, n_valid,
                                     (features, q_table, v_table), mesh)
        metrics = run(inputs, tables, seed=base_seed, step=state.step)
        state.step += 1
        return state, metrics

    train_step.graphed = run
    train_step.mesh = mesh
    return train_step


def make_contrastive_eval_step(model, *, recall_k: int = 5,
                               base_seed: int = 123,
                               capture: bool | None = None, mesh=None):
    """Returns ``eval_step(features, batch, n_valid, step, q_table=None,
    v_table=None)``: the candidates ranked by their embedding's distance
    from the original's -> recall@``recall_k`` and recall@1 hit counts
    (``correct``, ``correct1``) over the first ``n_valid`` rows and a
    ``loss_sum`` of 0 (reference contrastive.py:259-290).  Under ``mesh``
    the counts are this rank's rows' (``cx_engine.eval_model``'s pass adds
    the ranks')."""
    gens = rng_lib.StepGenerators(("lesion",), _device(model))

    @torch.no_grad()
    def body(batch, features, q_table, v_table):
        model.eval()
        comp = batch["comp_idxs"]
        row0, draws = batch_split(mesh, comp.shape[0])
        with draws:
            h = _embed(model, features, batch, q_table, v_table,
                       lesion_gen=gens["lesion"])
        scores = pairwise_distance(h[:, :1], h[:, 1:], keepdims=False)
        mask = _valid_mask(comp, batch["n_valid"], row0)
        return {"correct": torch.sum(recall_at_k(scores, comp, k=recall_k)
                                     * mask),
                "loss_sum": scores.new_zeros(()),
                "correct1": torch.sum(recall_at_k(scores, comp, k=1)
                                      * mask)}

    run = graphs.GraphedStep(body, _device(model), generators=gens,
                             capture=capture, mesh=mesh)
    if mesh is not None:
        report_eager(run, "the contrastive eval step", mesh)

    def eval_step(features, batch, n_valid, step, q_table=None,
                  v_table=None):
        refuse_caches(model, q_table is not None or v_table is not None)
        inputs, tables = mesh_inputs(batch, n_valid,
                                     (features, q_table, v_table), mesh)
        return run(inputs, tables, seed=base_seed, step=step)

    eval_step.graphed = run
    eval_step.mesh = mesh
    return eval_step
