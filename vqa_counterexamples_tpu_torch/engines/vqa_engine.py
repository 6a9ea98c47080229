"""VQA pretraining engine (port of ``engines/vqa_engine.py``; reference
``train.py`` + ``vqa/lib/engine.py``).

Train / eval steps for the MUTAN classifier: mean CE over the answer head,
acc@1 / acc@5 meters, the reference's meter set per epoch.  A step
updates the model's parameters in place with ``torch.optim.Adam``
(optax's defaults, over every parameter) and returns its metrics as 0-d
device tensors: nothing in a step waits for the card.  ``train_epoch``
reads them in bulk at print time and at the end of the epoch, in step
order, so the meters hold what the JAX engine's per-step reads would.
Each step's dropout masks come from a generator seeded from (seed, step,
"dropout") (``core/rng``).  On a card the train step is a captured CUDA
graph (``core/graphs.GraphedStep``), as the JAX package jits it: the
batch is copied into the step's own buffers and the graph replayed, one
graph per batch shape.  The eval and predict steps run eagerly.

Under a mesh (``parallel/``; the steps' ``mesh=``) each rank takes its
rows of every batch (``VQAArrays.batches(part=...)``: the att maps are
gathered for those rows only): the train loss is the rank's summed CE
over the global batch size, the dropout masks are drawn at the global
batch's shape (``core/rng.global_batch``), and one all-reduce over the
data group sums the gradients and the metrics before Adam steps.  The
eval and predict passes add the ranks' metrics and gather the
predictions, in row order, to every rank.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..core import graphs
from ..core import rng as rng_lib
from ..core import spans
from ..ops.cuda import launch_counters
from ..ops.metrics import accuracy_topk, cross_entropy_mean, cross_entropy_sum
from ..parallel.sharding import (all_reduce_grads, batch_split, gather_rows,
                                 report_eager)


@dataclass
class VQATrainState:
    """The model (its parameters updated in place), its Adam and the
    number of steps taken."""
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def init_vqa_params(model: torch.nn.Module, seed: int = 42
                    ) -> torch.nn.Module:
    """The port's seeded init (the JAX initializer families, drawn from a
    CPU ``torch.Generator``)."""
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model


def init_vqa_state(model, lr: float = 1e-4) -> VQATrainState:
    """Adam at ``lr`` with optax's defaults (betas 0.9 / 0.999, eps 1e-8)
    over all parameters; ``capturable`` on a card, as in
    ``cx_engine.init_cx_state``."""
    optimizer = torch.optim.Adam(model.parameters(), lr=lr,
                                 betas=(0.9, 0.999), eps=1e-8,
                                 capturable=_device(model).type == "cuda")
    return VQATrainState(model, optimizer, 0)


def batch_to_device(batch: dict, device) -> dict:
    """question / answer as device tensors; visual moved if on the host.
    Host arrays go through pinned memory to a card: a copy from pageable
    memory would wait for the card to finish the queued steps first."""
    device = torch.device(device)
    out = {}
    for key in ("visual", "question", "answer"):
        v = batch[key]
        v = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.asarray(v))
        if device.type == "cuda" and v.device.type == "cpu":
            v = v.pin_memory()
        out[key] = v.to(device, non_blocking=True)
    return out


def _device(model) -> torch.device:
    return next(model.parameters()).device


def make_vqa_train_step(model, optimizer, base_seed: int = 42, *,
                        capture: bool | None = None, mesh=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``: the model in
    training mode over the batch, the mean CE, one backward, one Adam
    step; ``metrics`` holds ``loss``, ``acc1``, ``acc5`` as 0-d device
    tensors.  ``batch``'s ``visual`` may be a host array or a tensor
    already on the card (it is copied into the step's buffer either way),
    ``question`` and ``answer`` host arrays.  The dropout generator is
    seeded from (``base_seed``, ``state.step``).

    ``capture``: None captures the step as a CUDA graph on a card (one
    per batch shape) and runs it eagerly on the CPU; False runs it
    eagerly anywhere.  ``mesh``: a ``parallel.Mesh``; ``batch`` then
    holds this rank's rows of the batch (see the module docstring)."""
    gens = rng_lib.StepGenerators(("dropout",), _device(model))

    def body(b):
        model.train()
        n_local = b["answer"].shape[0]
        _, draws = batch_split(mesh, n_local)
        with draws:
            output = model(b["visual"], b["question"], training=True,
                           generator=gens["dropout"])
        if mesh is None:
            loss = cross_entropy_mean(output, b["answer"])
        else:
            loss = (cross_entropy_sum(output, b["answer"])
                    / (n_local * mesh.size("data")))
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if mesh is None:
            optimizer.step()
        acc1, acc5 = accuracy_topk(output.detach(), b["answer"], (1, 5))
        loss = loss.detach()
        if mesh is not None:
            share = 1.0 / mesh.size("data")
            loss, acc1, acc5 = all_reduce_grads(
                optimizer, mesh, (loss, acc1 * share, acc5 * share))
            optimizer.step()
        return {"loss": loss, "acc1": acc1, "acc5": acc5}

    run = graphs.GraphedStep(body, _device(model), generators=gens,
                             optimizer=optimizer, capture=capture,
                             counters=launch_counters().values(), mesh=mesh)
    if mesh is not None:
        report_eager(run, "the VQA train step", mesh)

    def train_step(state: VQATrainState, batch: dict):
        metrics = run({k: batch[k] for k in ("visual", "question", "answer")},
                      seed=base_seed, step=state.step)
        state.step += 1
        return state, metrics

    train_step.graphed = run
    train_step.mesh = mesh
    return train_step


def make_vqa_eval_step(model, *, mesh=None):
    """Returns ``eval_step(batch)`` -> loss, acc1, acc5 and the argmax
    answer ids ``pred``, as device tensors (eval mode, no dropout).  Under
    ``mesh`` the metrics are this rank's share of the batch's means
    (:func:`validate` adds the ranks') and ``pred`` its rows'.  A call is
    the span ``engine.step`` (``core/spans``)."""
    @torch.no_grad()
    def eval_step(batch: dict):
        with spans.span("engine.step"):
            b = batch_to_device(batch, _device(model))
            model.eval()
            output = model(b["visual"], b["question"])
            acc1, acc5 = accuracy_topk(output, b["answer"], (1, 5))
            out = {"loss": cross_entropy_mean(output, b["answer"]),
                   "acc1": acc1, "acc5": acc5,
                   "pred": torch.argmax(output, dim=-1)}
            if mesh is not None:
                share = output.shape[0] / batch["rows"][1]
                for k in _KEYS:
                    out[k] = out[k] * share
            return out

    eval_step.mesh = mesh
    return eval_step


def make_vqa_predict_step(model, *, mesh=None):
    """argmax answer ids only (for :func:`test_pass`); under ``mesh``
    this rank's rows'."""
    @torch.no_grad()
    def predict(batch: dict):
        b = batch_to_device(batch, _device(model))
        model.eval()
        return torch.argmax(model(b["visual"], b["question"]), dim=-1)

    predict.mesh = mesh
    return predict


def _batch_size(batch: dict) -> int:
    """The whole batch's size (a rank's batch holds only its rows)."""
    return batch["rows"][1] if "rows" in batch else len(batch["answer"])


def _with_ids(pred: torch.Tensor, qid: np.ndarray) -> torch.Tensor:
    """(n, 2) int64: the predictions beside their question ids."""
    return torch.stack([pred.long(), torch.from_numpy(qid).long().to(
        pred.device)], 1)


def _gathered(step, batch, values: torch.Tensor):
    """(n_local, 2) ``values`` of this rank's rows of ``batch`` -> the
    whole batch's two columns, in row order, on every rank."""
    start, size = batch["rows"]
    return gather_rows(values, start, size, step.mesh).unbind(1)


def _host_ids(qids: list) -> np.ndarray:
    """The question ids of a pass (host arrays, or device tensors under a
    mesh) as one host array."""
    if qids and isinstance(qids[0], torch.Tensor):
        return torch.cat(qids).cpu().numpy()
    return np.concatenate(qids)


_KEYS = ("loss", "acc1", "acc5")


def _read(pending: list, mesh=None) -> np.ndarray:
    """The (n, 3) loss / acc1 / acc5 values of ``pending`` metric dicts,
    read from the device in one transfer (summed over the data group
    first under ``mesh``)."""
    values = torch.stack([torch.stack([m[k].float() for k in _KEYS])
                          for m in pending])
    if mesh is not None:
        mesh.all_reduce(values, "data")
    return values.cpu().numpy()


def train_epoch(train_step, state, loader, experiment, epoch: int,
                print_freq: int = 10):
    """Epoch driver with the reference's meter set (``engine.py:6-56``).

    The steps' metrics stay on the device until a print (every
    ``print_freq`` batches) or the end of the epoch, which read them all
    at once and update the meters in step order.  The meters mean what
    JAX's mean: ``data_time`` is the loader's time, and ``batch_time`` runs
    from the end of the previous batch to the end of this one, the read
    that waits for the card included, so an epoch's ``batch_time`` values
    sum to its wall time (less the prints).  A batch that ends on no read
    is timed when the next one starts, or after the epoch's last read.
    A read is the span ``engine.meters_read`` (``core/spans``)."""
    meters = experiment.reset_meters("train")
    pending = []   # (metrics, batch size) not yet read from the device

    def flush():
        if pending:
            with spans.span("engine.meters_read"):
                values = _read([m for m, _ in pending])
                for (_, n), row in zip(pending, values):
                    for k, v in zip(_KEYS, row):
                        meters[k].update(float(v), n=n)
            pending.clear()

    end = time.time()
    held = None   # (start, size) of a batch whose batch_time is not taken
    for i, batch in enumerate(loader):
        if held is not None:
            meters["batch_time"].update(end - held[0], n=held[1])
            held = None
        start, batch_size = end, _batch_size(batch)
        meters["data_time"].update(time.time() - start, n=batch_size)
        state, m = train_step(state, batch)
        pending.append((m, batch_size))
        if i % print_freq != 0:
            held = (start, batch_size)
        else:
            flush()
            meters["batch_time"].update(time.time() - start, n=batch_size)
            print("Epoch: [{0}][{1}]\t"
                  "Time {bt.val:.3f} ({bt.avg:.3f})\t"
                  "Loss {loss.val:.4f} ({loss.avg:.4f})\t"
                  "Acc@1 {acc1.val:.3f} ({acc1.avg:.3f})\t"
                  "Acc@5 {acc5.val:.3f} ({acc5.avg:.3f})".format(
                      epoch, i, bt=meters["batch_time"],
                      loss=meters["loss"], acc1=meters["acc1"],
                      acc5=meters["acc5"]))
        end = time.time()
    flush()
    if held is not None:
        meters["batch_time"].update(time.time() - held[0], n=held[1])
    experiment.log_meters("train", n=epoch)
    return state


def validate(eval_step, loader, experiment, epoch: int, aid_to_ans=None,
             collect_results: bool = False):
    """Validation pass (reference ``engine.py:65-114``); with
    ``collect_results`` also the OpenEnded rows [{question_id, answer}].
    One read from the device, at the end; under a mesh the ranks' metrics
    are added there, in one all-reduce, and the rows gathered per batch.
    The read and the rows are the span ``engine.pass_end``
    (``core/spans``)."""
    meters = experiment.reset_meters("val")
    mesh = getattr(eval_step, "mesh", None)
    outs, sizes, qids = [], [], []
    for batch in loader:
        out = eval_step(batch)
        qid = np.asarray(batch["question_id"])
        if mesh is not None and collect_results:
            out["pred"], qid = _gathered(eval_step, batch,
                                         _with_ids(out["pred"], qid))
        outs.append(out)
        sizes.append(_batch_size(batch))
        qids.append(qid)
    results = []
    if outs:
        with spans.span("engine.pass_end"):
            values = _read(outs, mesh)
            for n, row in zip(sizes, values):
                for k, v in zip(_KEYS, row):
                    meters[k].update(float(v), n=n)
            if collect_results and aid_to_ans is not None:
                preds = torch.cat([o["pred"] for o in outs]).cpu().numpy()
                for qid, aid in zip(_host_ids(qids), preds):
                    results.append({"question_id": int(qid),
                                    "answer": aid_to_ans[int(aid)]})
    experiment.log_meters("val", n=epoch)
    out = {"acc1": meters["acc1"].value(), "acc5": meters["acc5"].value(),
           "loss": meters["loss"].value()}
    return (out, results) if collect_results else out


def test_pass(predict_step, loader, aid_to_ans) -> list:
    """Answer-only pass over test / test-dev (no ground truth; reference
    ``engine.py:117-153``): the OpenEnded result rows."""
    mesh = getattr(predict_step, "mesh", None)
    preds, qids = [], []
    for batch in loader:
        pred = predict_step(batch)
        qid = np.asarray(batch["question_id"])
        if mesh is not None:
            pred, qid = _gathered(predict_step, batch, _with_ids(pred, qid))
        preds.append(pred)
        qids.append(qid)
    if not preds:
        return []
    ids = torch.cat(preds).cpu().numpy()
    return [{"question_id": int(q), "answer": aid_to_ans[int(a)]}
            for q, a in zip(_host_ids(qids), ids)]
