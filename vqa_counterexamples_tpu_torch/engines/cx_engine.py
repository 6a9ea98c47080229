"""CX training and scoring engine (port of ``engines/cx_engine.py``).

With the VQA backbone frozen, its outputs are constants of the CX model:
the question embedding per example (``precompute_q_emb``, the GRU kernel),
the image side of the fusion per image (``precompute_v_proj``) and the whole
fused embedding per (example, candidate) (``precompute_z_emb``).  Training
and scoring then gather rows of those tables by index; z subsumes v in the
step.  The tables are written in place into preallocated tensors.

Training (``make_cx_train_step``, ``train_epoch``) updates the model's
trainable parameters in place with ``torch.optim.Adam`` (optax's defaults);
a frozen backbone holds no grads and no Adam state, a trainable one
(``trainable_vqa``) trains with the rest and takes no cache.  The models
the JAX CLI builds no optimizer for (the two baselines, BlackBox,
SemanticBaseline, SimilarityModel) get a state without one (``init_cx_state(..., optimizer=None)``) and are only evaluated.
``pairwise=True`` trains on and evaluates the (orig, comp, other) triples
of ``CXArrays.pairwise_view``.  Each step's dropout and lesion draws come from generators seeded from (seed, step, name)
(``core/rng``), so a run is reproducible and a resumed run redraws the
same masks.  A step returns its metrics as 0-d device tensors: nothing in
it waits for the card.

On a card the train and eval steps are captured CUDA graphs
(``core/graphs.GraphedStep``), as the JAX package jits them: a batch's
index arrays and ``n_valid`` are copied into the step's own buffers and
the graph is replayed.  ``make_cx_train_scan`` runs S steps a call (S
replays), as JAX's ``lax.scan`` trainer runs S steps a dispatch.  On the
CPU, or with ``capture=False``, the same step bodies run eagerly.

Under a mesh (``parallel/``; the steps' ``mesh=``) every rank builds the
same global batch and a step takes its rows (``parallel.shard_batch``):
the loss is the rank's masked sum over the *global* ``n_valid``, the
padded tail masked by global row, the dropout and lesion draws made at the
global batch's shape (``core/rng.global_batch``), and one all-reduce over
the data group sums the gradients and the metrics before Adam steps, so
every rank steps the same numbers.  With ``model=M > 1`` the feature
matrix and the v table come row-sharded (``parallel.RowShard``): a step
gathers its batch's rows by global index (``parallel.sharded_gather``)
into a compact table, and the vfeat kernels read that table with the
indices renumbered.  An eval pass all-reduces its per-batch sums once, at
the end.  Under NCCL the steps stay captured (the all-reduce inside the
graph); under gloo they run eagerly and say so.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..core import graphs
from ..core import rng as rng_lib
from ..core import spans
from ..data import vqacx
from ..ops.cuda import launch_counters
from ..ops.metrics import nll, recall_at_k
from ..parallel import RowShard, sharded_gather
from ..parallel.sharding import (all_reduce_grads, batch_split,
                                 report_eager, shard_batch)


def init_cx_params(model: torch.nn.Module, seed: int = 42
                   ) -> torch.nn.Module:
    """The port's seeded init (the JAX initializer families, drawn from a
    CPU ``torch.Generator``); returns ``model`` in eval mode."""
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.eval()


def frozen_param_keys(model) -> tuple:
    """Top-level submodules held frozen during CX training: the backbone,
    unless it is trainable (reference ``cx.py:80`` sets
    ``requires_grad=False`` on it)."""
    return () if getattr(model, "trainable_vqa", True) else ("vqa_model",)


def trainable_parameters(model) -> list:
    """``(name, param)`` of every parameter outside the frozen keys."""
    frozen = frozen_param_keys(model)
    return [(n, p) for n, p in model.named_parameters()
            if n.split(".")[0] not in frozen]


@dataclass
class CXTrainState:
    """The model (its parameters updated in place), the Adam over its
    trainable parameters (None for a model trained with no optimizer), and
    the number of steps taken."""
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer | None
    step: int = 0


def init_cx_state(model, lr: float = 1e-4, *,
                  optimizer: str | None = "adam") -> CXTrainState:
    """``optimizer="adam"``: Adam at ``lr`` with optax's defaults (betas
    0.9 / 0.999, eps 1e-8) over the trainable parameters only (the
    backbone's too when it trains); ``capturable`` on a card (its step
    count lives on the device, so a graph can replay the update), on the
    CPU as torch builds it by default.  ``optimizer=None``: no optimizer,
    as JAX's CLI builds none for the models it only evaluates."""
    if optimizer is None:
        return CXTrainState(model, None, 0)
    if optimizer != "adam":
        raise ValueError("optimizer must be 'adam' or None, got %r"
                         % optimizer)
    params = [p for _, p in trainable_parameters(model)]
    adam = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            capturable=_device(model).type == "cuda")
    return CXTrainState(model, adam, 0)


def _device(model) -> torch.device:
    """The device of the model's parameters, or of its buffers for the
    baselines, which have none."""
    for t in itertools.chain(model.parameters(), model.buffers()):
        return t.device
    raise ValueError("%s holds no tensor to take a device from"
                     % type(model).__name__)


def refuse_caches(model, cached: bool) -> None:
    """The caches hold a frozen backbone's outputs: ``cached`` is refused
    for a trainable one (JAX ``cx_engine.py:565-569``)."""
    if cached and getattr(model, "trainable_vqa", False):
        raise ValueError(
            "q_emb/v_proj/z_emb caches require a frozen VQA backbone")


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def precompute_q_emb(model, question_wids, batch_size: int = 2048
                     ) -> torch.Tensor:
    """Encode every question once through the frozen encoder -> (N, dim_q)
    on the model's device, indexed by ``batch['example_idxs']``."""
    wids = torch.from_numpy(np.asarray(question_wids)).to(_device(model))
    n = wids.shape[0]
    table = None
    for s in range(0, n, batch_size):
        out = model.vqa_model.encode_question(wids[s:s + batch_size])
        if table is None:
            table = out.new_empty((n,) + tuple(out.shape[1:]))
        table[s:s + out.shape[0]] = out
    return table


@torch.no_grad()
def precompute_v_proj(model, features: torch.Tensor,
                      batch_size: int = 8192) -> torch.Tensor:
    """Project every image through the frozen fusion image side once ->
    (n_images, R, dim_mm) f32, aligned with the feature-matrix rows."""
    n = features.shape[0]
    table = None
    for s in range(0, n, batch_size):
        out = model.vqa_model.project_image(features[s:s + batch_size])
        if table is None:
            table = out.new_empty((n,) + tuple(out.shape[1:]))
        table[s:s + out.shape[0]] = out
    return table


@torch.no_grad()
def precompute_z_emb(model, image_idxs, q_table: torch.Tensor,
                     v_table: torch.Tensor, batch_size: int = 2048
                     ) -> torch.Tensor:
    """Fuse every (example, candidate) pair through the frozen backbone once
    -> (n_examples, K+1, dim_mm), aligned with example order.  ``v_table``
    (from :func:`precompute_v_proj`) turns the fusion's image side into a
    gather."""
    idxs = torch.from_numpy(np.asarray(image_idxs)).long().to(q_table.device)
    n = idxs.shape[0]
    table = None
    for s in range(0, n, batch_size):
        out = model.vqa_model.fuse_candidates(
            None, q_table[s:s + batch_size],
            v_proj=v_table[idxs[s:s + batch_size]])
        if table is None:
            table = out.new_empty((n,) + tuple(out.shape[1:]))
        table[s:s + out.shape[0]] = out
    return table


def build_frozen_caches(model, features: torch.Tensor,
                        arrays: vqacx.CXArrays, *, use_q: bool = True,
                        use_v: bool = False, use_z: bool = True):
    """Build the cache tables in dependency order (q -> v -> z).

    The z build needs q and the per-image v projection, so v is built
    whenever z is; with the z cache on, ``v_table`` is then dropped (z
    subsumes v in the step).  Returns ``(q_table, v_table, z_table,
    stage_s)`` with each stage's synchronised wall seconds, which also add
    to the counters ``cx.cache_build_s.q`` / ``.v`` / ``.z``
    (``core/spans``).
    """
    if use_z and not use_q:
        raise ValueError("the z cache is built from the q cache")
    refuse_caches(model, use_q or use_v or use_z)
    device = features.device
    stage_s = {}
    q_table = v_table = z_table = None
    if use_q:
        with spans.timed("cx.cache_build_s.q") as t:
            q_table = precompute_q_emb(model, arrays.question_wids)
            _sync(device)
        stage_s["q"] = t.seconds
    if use_v or use_z:
        with spans.timed("cx.cache_build_s.v") as t:
            v_table = precompute_v_proj(model, features)
            _sync(device)
        stage_s["v"] = t.seconds
    if use_z:
        with spans.timed("cx.cache_build_s.z") as t:
            z_table = precompute_z_emb(model, arrays.image_idxs, q_table,
                                       v_table)
            _sync(device)
        stage_s["z"] = t.seconds
        v_table = None  # z subsumes v in the step
    return q_table, v_table, z_table, stage_s


def make_tables_bf16_resident(features, q_table=None, v_table=None,
                              z_table=None):
    """Cast the feature matrix and cache tables to bf16 (the step casts its
    GEMM inputs to bf16 anyway under the bf16 policy).  Returns
    ``(features, q_table, v_table, z_table)``."""
    def cast(t):
        return None if t is None else t.to(torch.bfloat16)

    return cast(features), cast(q_table), cast(v_table), cast(z_table)


def cache_kwargs(batch: dict, q_table=None, v_table=None,
                 z_table=None) -> dict:
    """Model kwargs for the caches: q/z rows per example
    (``batch['example_idxs']``), v rows per image (``batch['image_idxs']``)."""
    kw = {}
    if q_table is not None:
        kw["q_emb"] = q_table[batch["example_idxs"].long()]
    if v_table is not None:
        kw["v_proj"] = v_table[batch["image_idxs"].long()]
    if z_table is not None:
        kw["z_emb"] = z_table[batch["example_idxs"].long()]
    return kw


def batch_to_device(batch: dict, device) -> dict:
    return {k: torch.from_numpy(np.asarray(v)).to(device, non_blocking=True)
            for k, v in batch.items()}


def step_inputs(batch: dict, n_valid) -> dict:
    """A step's inputs: the batch's arrays (host arrays, or tensors) and
    ``n_valid`` as a 0-d int32, which the step reads on the device."""
    return {**batch, "n_valid": np.int32(int(n_valid))}


def _pass_table(model, use_z_cache: bool) -> bool:
    """Whether the model takes the feature table + row indices (NeuralCX's
    vfeat kernels, which need the z cache)."""
    wants = getattr(model, "wants_table_features", None)
    return bool(use_z_cache and wants is not None and wants())


def _model_inputs(model, features, batch, pass_table, q_table, v_table,
                  z_table, mesh=None):
    """(image_features, kwargs) for the model: the table form or the
    materialized gather, plus the cache rows.  Over a row-sharded corpus
    (``model`` > 1) the batch's rows are gathered first, into a compact
    table that the table form reads by renumbered indices."""
    if mesh is not None and mesh.size("model") > 1:
        idx, start = batch["image_idxs"], batch["row_start"]
        kw = cache_kwargs(batch, q_table, None, z_table)
        if v_table is not None:
            kw["v_proj"] = sharded_gather(v_table, idx, mesh, "model", start)
        table = sharded_gather(features, idx.reshape(-1), mesh, "model",
                               start)
        if pass_table:
            kw.update(features_table=table, image_idxs=torch.arange(
                table.shape[0], dtype=idx.dtype,
                device=idx.device).view(idx.shape))
            return None, kw
        return table.view(tuple(idx.shape) + tuple(table.shape[1:])), kw
    kw = cache_kwargs(batch, q_table, v_table, z_table)
    if pass_table:
        kw.update(features_table=features, image_idxs=batch["image_idxs"])
        return None, kw
    return features[batch["image_idxs"].long()], kw


def _valid_mask(comp, n_valid, row0: int = 0):
    """1.0 for the first ``n_valid`` rows, 0.0 for the padded tail;
    ``row0``: the global index of the first of these rows."""
    rows = torch.arange(comp.shape[0], device=comp.device)
    if row0:
        rows = rows + row0
    return (rows < n_valid).float()


def mesh_inputs(batch, n_valid, tables, mesh):
    """A step's inputs and tables under ``mesh``: this rank's rows of the
    batch and, for row-sharded tables, their rows and the shard's first
    global row (``row_start``, read on the device)."""
    inputs = step_inputs(batch if mesh is None else shard_batch(batch, mesh),
                         n_valid)
    out = []
    for t in tables:
        if isinstance(t, RowShard):
            inputs["row_start"] = np.int64(t.start)
            t = t.rows
        out.append(t)
    return inputs, tuple(out)


def make_cx_train_step(model, optimizer, *, recall_k: int = 5,
                       base_seed: int = 42, extra_apply_args: tuple = (),
                       use_z_cache: bool = False,
                       capture: bool | None = None, mesh=None):
    """Returns ``train_step(state, features, batch, n_valid, q_table=None,
    v_table=None, z_table=None)`` -> ``(state, metrics)``.

    One step: the model in training mode over the batch, loss =
    ``sum(CE(scores, comp) * mask) / n_valid`` (the reference's
    ``counterexamples.py:333-334``; ``n_valid`` masks the padded tail of
    the last batch and is read on the device), one backward, one Adam
    step, and the recall@k hit count.  ``batch`` holds the index arrays of
    ``vqacx.gather_batch`` (numpy, or tensors).  ``metrics`` holds
    ``loss`` and ``correct`` as 0-d device tensors and ``n`` as a float.
    The dropout and lesion generators are seeded from (``base_seed``,
    ``state.step``); ``state.step`` stays a host int.

    ``extra_apply_args``: tensors passed to the model after the answer ids
    (SemanticBaseline's ``emb_pairs``), read by the graph by address as
    the tables are.  A trainable backbone takes no cache table
    (``ValueError``); its dropouts draw from the step's dropout generator.

    ``capture``: None captures the step as a CUDA graph on a card and runs
    it eagerly on the CPU (``core/graphs``); False runs it eagerly
    anywhere.  Whether the model takes the feature table + row indices
    (the vfeat kernels, which need the z cache) is resolved here, at build
    time.

    ``mesh``: a ``parallel.Mesh``; the step then takes the global batch
    and trains on this rank's rows (see the module docstring); the
    features and v table may be ``parallel.RowShard``s."""
    refuse_caches(model, use_z_cache)
    pass_table = _pass_table(model, use_z_cache)
    gens = rng_lib.StepGenerators(("dropout", "lesion"), _device(model))
    extra = tuple(extra_apply_args)

    def body(batch, features, q_table, v_table, z_table, *extra_args):
        model.train()
        comp = batch["comp_idxs"]
        row0, draws = batch_split(mesh, comp.shape[0])
        with draws:
            image_features, kw = _model_inputs(model, features, batch,
                                               pass_table, q_table, v_table,
                                               z_table, mesh)
            scores = model(image_features, batch["question_wids"],
                           batch["answer_aids"], *extra_args,
                           dropout_gen=gens["dropout"],
                           lesion_gen=gens["lesion"], **kw)
        mask = _valid_mask(comp, batch["n_valid"], row0)
        loss = (torch.sum(nll(scores, comp) * mask)
                / batch["n_valid"].float())
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if mesh is None:
            optimizer.step()
        k = min(recall_k, scores.shape[-1])
        correct = torch.sum(recall_at_k(scores.detach(), comp, k=k) * mask)
        loss = loss.detach()
        if mesh is not None:
            loss, correct = all_reduce_grads(optimizer, mesh, (loss, correct))
            optimizer.step()
        return {"loss": loss, "correct": correct}

    run = graphs.GraphedStep(body, _device(model), generators=gens,
                             optimizer=optimizer, capture=capture,
                             counters=launch_counters().values(), mesh=mesh)
    if mesh is not None:
        report_eager(run, "the CX train step", mesh)

    def train_step(state: CXTrainState, features, batch, n_valid,
                   q_table=None, v_table=None, z_table=None):
        refuse_caches(model, any(t is not None
                                 for t in (q_table, v_table, z_table)))
        inputs, tables = mesh_inputs(batch, n_valid, (features, q_table,
                                                      v_table, z_table), mesh)
        metrics = run(inputs, tables + extra, seed=base_seed,
                      step=state.step)
        state.step += 1
        metrics["n"] = float(n_valid)
        return state, metrics

    train_step.graphed = run
    train_step.mesh = mesh
    return train_step


def make_cx_train_scan(train_step):
    """Multi-step trainer (JAX's ``make_cx_train_scan``):
    ``train_scan(state, features, batches, n_valids, q_table=None,
    v_table=None, z_table=None)`` runs S train steps in one call.

    ``batches`` holds the S host batches, ``n_valids`` their S valid
    counts.  The steps are S calls of ``train_step`` (a
    :func:`make_cx_train_step`): S replays of its captured graph on a card,
    the generators reseeded from (``base_seed``, ``state.step``) before
    each, so the result is that of S single steps.  Metrics come back
    stacked, one row per step."""

    def train_scan(state: CXTrainState, features, batches, n_valids,
                   q_table=None, v_table=None, z_table=None):
        rows = []
        for batch, n_valid in zip(batches, n_valids):
            state, m = train_step(state, features, batch, n_valid,
                                  q_table=q_table, v_table=v_table,
                                  z_table=z_table)
            rows.append(m)
        return state, {"loss": torch.stack([m["loss"] for m in rows]),
                       "correct": torch.stack([m["correct"] for m in rows]),
                       "n": np.asarray([m["n"] for m in rows], np.float32)}

    return train_scan


def make_cx_eval_step(model, *, recall_k: int = 5, base_seed: int = 123,
                      extra_apply_args: tuple = (),
                      use_z_cache: bool = False,
                      capture: bool | None = None, mesh=None):
    """Returns ``eval_step(features, batch, n_valid, step, q_table=None,
    v_table=None, z_table=None)`` -> summed CE loss and recall@K / @1 hit
    counts over the first ``n_valid`` rows, as 0-d device tensors.  The
    tables passed in select the caches.  The model runs in eval mode; the
    lesion generator (the reference draws its placeholders in eval too) is
    seeded from (``base_seed``, ``step``), the batch's index in the pass.

    ``extra_apply_args`` and ``capture`` as in :func:`make_cx_train_step`:
    a graph per batch layout and table set.  Whether the model takes the
    feature table + row indices (the candidate image-feature kernel, which
    needs the z cache) is resolved here, at build time.  Under ``mesh``
    the sums are this rank's rows' (``eval_model`` adds the ranks')."""
    refuse_caches(model, use_z_cache)
    pass_table = _pass_table(model, use_z_cache)
    gens = rng_lib.StepGenerators(("lesion",), _device(model))
    extra = tuple(extra_apply_args)

    @torch.no_grad()
    def body(batch, features, q_table, v_table, z_table, *extra_args):
        model.eval()
        comp = batch["comp_idxs"]
        row0, draws = batch_split(mesh, comp.shape[0])
        with draws:
            image_features, kw = _model_inputs(model, features, batch,
                                               pass_table, q_table, v_table,
                                               z_table, mesh)
            scores = model(image_features, batch["question_wids"],
                           batch["answer_aids"], *extra_args,
                           lesion_gen=gens["lesion"], **kw)
        mask = _valid_mask(comp, batch["n_valid"], row0)
        k = min(recall_k, scores.shape[-1])
        return {"loss_sum": torch.sum(nll(scores, comp) * mask),
                "correct": torch.sum(recall_at_k(scores, comp, k=k) * mask),
                "correct1": torch.sum(recall_at_k(scores, comp, k=1) * mask)}

    run = graphs.GraphedStep(body, _device(model), generators=gens,
                             capture=capture,
                             counters=launch_counters().values(), mesh=mesh)
    if mesh is not None:
        report_eager(run, "the CX eval step", mesh)

    def eval_step(features, batch, n_valid, step, q_table=None,
                  v_table=None, z_table=None):
        refuse_caches(model, any(t is not None
                                 for t in (q_table, v_table, z_table)))
        inputs, tables = mesh_inputs(batch, n_valid, (features, q_table,
                                                      v_table, z_table), mesh)
        return run(inputs, tables + extra, seed=base_seed, step=step)

    eval_step.graphed = run
    eval_step.mesh = mesh
    return eval_step


def eval_sums(eval_step, features, arrays, batch_size, tables) -> tuple:
    """Every batch through ``eval_step`` -> (f32 per-batch sums of
    loss_sum / correct / correct1 (n_batches, 3) on the host, n_total).
    The sums stay on the device until one synchronisation at the end; under
    a mesh the ranks' sums are added there, in one all-reduce."""
    keys = ("loss_sum", "correct", "correct1")
    sums = []
    n_total = 0
    for step, (idx, n_valid) in enumerate(vqacx.batch_indices(
            arrays.size, batch_size, shuffle=False)):
        out = eval_step(features, vqacx.gather_batch(arrays, idx), n_valid,
                        step, **tables)
        sums.append(torch.stack([out[k].float() for k in keys]))
        n_total += n_valid
    rows = torch.stack(sums)
    mesh = getattr(eval_step, "mesh", None)
    if mesh is not None:
        mesh.all_reduce(rows, "data")
    return rows.cpu().numpy(), n_total


def eval_model(eval_step, features, arrays: vqacx.CXArrays,
               batch_size: int, *, pairwise: bool = False,
               pairwise_eval_step=None, rng=None, q_table=None,
               v_table=None, z_table=None) -> dict:
    """Full-dataset eval -> {'loss', 'recall', 'recall_1'}.  With
    ``pairwise``, also ``loss_pairwise`` and ``acc_pairwise`` from a pass
    of ``pairwise_eval_step`` (no cache tables) over
    ``arrays.pairwise_view(rng)`` (``rng`` defaults to
    ``default_rng(123)``), both divided by the main pass's example count
    (JAX ``cx_engine.py:792-807``)."""
    rows, n_total = eval_sums(eval_step, features, arrays, batch_size,
                               dict(q_table=q_table, v_table=v_table,
                                    z_table=z_table))
    # f32 sums in batch order, as the JAX engine adds its batches' sums
    totals = [float(sum(rows[:, i], np.float32(0))) for i in range(3)]
    results = {"loss": totals[0] / n_total, "recall": totals[1] / n_total,
               "recall_1": totals[2] / n_total}
    if pairwise:
        if pairwise_eval_step is None:
            raise ValueError("pairwise eval needs pairwise_eval_step")
        view = arrays.pairwise_view(rng or np.random.default_rng(123))
        prows, _ = eval_sums(pairwise_eval_step, features, view,
                              batch_size, {})
        # float64 sums of the per-batch values, as JAX's ``float(...) +=``
        results["loss_pairwise"] = (sum(float(x) for x in prows[:, 0])
                                    / n_total)
        results["acc_pairwise"] = (sum(float(x) for x in prows[:, 2])
                                   / n_total)
    return results


def train_epoch(train_step, state: CXTrainState, features,
                arrays: vqacx.CXArrays, batch_size: int, *,
                pairwise: bool = False, rng=None, log_fn=None,
                print_freq: int = 100, eval_fn=None, eval_freq: int = -1,
                q_table=None, v_table=None, z_table=None, scan_step=None,
                scan_len: int = 0):
    """One epoch over shuffled batches (reference counterexamples.py:
    312-361) -> ``(state, eval_results)``.

    ``log_fn(step_in_epoch, metrics)`` fires every ``print_freq`` batches
    (and synchronises, to read the loss); ``eval_fn(state)`` fires every
    ``eval_freq`` batches and at the end of the epoch, and its last result
    is returned.  The batch order comes from the numpy ``rng``.  With
    ``pairwise`` the epoch trains on ``arrays.pairwise_view(rng)`` (drawn
    before the shuffle), where the z cache, whose rows hold the fixed
    candidate lists, is refused.

    ``scan_step`` / ``scan_len``: a :func:`make_cx_train_scan` trainer
    over ``train_step``; full groups of ``scan_len`` batches go to it in
    one call, a short final group runs as single steps, as the JAX engine
    groups them.  The hooks then fire once per group, at the group's last
    batch, with its last step's metrics.  Under a mesh (a step built with
    ``mesh=``) the scan is ignored, as the JAX engine ignores it.  Each
    batch's draw and gather is the span ``data.batch`` (``core/spans``)."""
    rng = rng or np.random.default_rng()
    if pairwise and z_table is not None:
        raise ValueError("z_table rows are per fixed candidate list; "
                         "pairwise views resample candidates per epoch")
    if pairwise:
        arrays = arrays.pairwise_view(rng)
    n_batches = (arrays.size + batch_size - 1) // batch_size
    eval_results = None
    t0 = time.time()
    n_seen = 0
    use_scan = (scan_step is not None and scan_len > 1
                and getattr(train_step, "mesh", None) is None)
    pending = []   # (batch, n_valid) held for the next scan call

    def fire_hooks(b, metrics, n_valid):
        nonlocal eval_results
        if log_fn is not None and b % print_freq == 0:
            log_fn(b, {"loss": float(metrics["loss"]),
                       "recall": float(metrics["correct"]) / n_valid,
                       "examples_per_sec": n_seen / (time.time() - t0)})
        if eval_fn is not None and ((eval_freq > 0 and b % eval_freq == 0)
                                    or b == n_batches):
            eval_results = eval_fn(state)

    tables = dict(q_table=q_table, v_table=v_table, z_table=z_table)
    draws = vqacx.batch_indices(arrays.size, batch_size, shuffle=True,
                                rng=rng)
    for b in range(1, n_batches + 1):
        with spans.span("data.batch"):
            idx, n_valid = next(draws)
            batch = vqacx.gather_batch(arrays, idx)
        n_seen += n_valid
        if not use_scan:
            state, metrics = train_step(state, features, batch, n_valid,
                                        **tables)
            fire_hooks(b, metrics, n_valid)
            continue
        pending.append((batch, n_valid))
        if len(pending) < scan_len and b < n_batches:
            continue
        if len(pending) == scan_len:
            state, ms = scan_step(state, features, [p[0] for p in pending],
                                  [p[1] for p in pending], **tables)
            metrics = {k: v[-1] for k, v in ms.items()}
        else:   # the final short group: single steps
            for pbatch, pnv in pending:
                state, metrics = train_step(state, features, pbatch, pnv,
                                            **tables)
        pending = []
        fire_hooks(b, metrics, n_valid)
    return state, eval_results
