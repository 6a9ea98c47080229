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
"dropout") (``core/rng``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..core import rng as rng_lib
from ..ops.metrics import accuracy_topk, cross_entropy_mean


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
    over all parameters."""
    optimizer = torch.optim.Adam(model.parameters(), lr=lr,
                                 betas=(0.9, 0.999), eps=1e-8)
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


def make_vqa_train_step(model, optimizer, base_seed: int = 42):
    """Returns ``train_step(state, batch) -> (state, metrics)``: the model in
    training mode over the batch, the mean CE, one backward, one Adam
    step; ``metrics`` holds ``loss``, ``acc1``, ``acc5`` as 0-d device
    tensors."""
    def train_step(state: VQATrainState, batch: dict):
        device = _device(model)
        b = batch_to_device(batch, device)
        gens = rng_lib.step_generators(base_seed, state.step, ("dropout",),
                                       device)
        model.train()
        output = model(b["visual"], b["question"], training=True,
                       generator=gens["dropout"])
        loss = cross_entropy_mean(output, b["answer"])
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        state.step += 1
        acc1, acc5 = accuracy_topk(output.detach(), b["answer"], (1, 5))
        return state, {"loss": loss.detach(), "acc1": acc1, "acc5": acc5}

    return train_step


def make_vqa_eval_step(model):
    """Returns ``eval_step(batch)`` -> loss, acc1, acc5 and the argmax
    answer ids ``pred``, as device tensors (eval mode, no dropout)."""
    @torch.no_grad()
    def eval_step(batch: dict):
        b = batch_to_device(batch, _device(model))
        model.eval()
        output = model(b["visual"], b["question"])
        acc1, acc5 = accuracy_topk(output, b["answer"], (1, 5))
        return {"loss": cross_entropy_mean(output, b["answer"]),
                "acc1": acc1, "acc5": acc5,
                "pred": torch.argmax(output, dim=-1)}

    return eval_step


def make_vqa_predict_step(model):
    """argmax answer ids only (for :func:`test_pass`)."""
    @torch.no_grad()
    def predict(batch: dict):
        b = batch_to_device(batch, _device(model))
        model.eval()
        return torch.argmax(model(b["visual"], b["question"]), dim=-1)

    return predict


_KEYS = ("loss", "acc1", "acc5")


def _read(pending: list) -> np.ndarray:
    """The (n, 3) loss / acc1 / acc5 values of ``pending`` metric dicts,
    read from the device in one transfer."""
    return torch.stack([torch.stack([m[k].float() for k in _KEYS])
                        for m in pending]).cpu().numpy()


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
    is timed when the next one starts, or after the epoch's last read."""
    meters = experiment.reset_meters("train")
    pending = []   # (metrics, batch size) not yet read from the device

    def flush():
        if pending:
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
        start, batch_size = end, len(batch["answer"])
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
    One read from the device, at the end."""
    meters = experiment.reset_meters("val")
    outs, sizes, qids = [], [], []
    for batch in loader:
        outs.append(eval_step(batch))
        sizes.append(len(batch["answer"]))
        qids.append(np.asarray(batch["question_id"]))
    results = []
    if outs:
        values = _read(outs)
        for n, row in zip(sizes, values):
            for k, v in zip(_KEYS, row):
                meters[k].update(float(v), n=n)
        if collect_results and aid_to_ans is not None:
            preds = torch.cat([o["pred"] for o in outs]).cpu().numpy()
            for qid, aid in zip(np.concatenate(qids), preds):
                results.append({"question_id": int(qid),
                                "answer": aid_to_ans[int(aid)]})
    experiment.log_meters("val", n=epoch)
    out = {"acc1": meters["acc1"].value(), "acc5": meters["acc5"].value(),
           "loss": meters["loss"].value()}
    return (out, results) if collect_results else out


def test_pass(predict_step, loader, aid_to_ans) -> list:
    """Answer-only pass over test / test-dev (no ground truth; reference
    ``engine.py:117-153``): the OpenEnded result rows."""
    preds, qids = [], []
    for batch in loader:
        preds.append(predict_step(batch))
        qids.append(np.asarray(batch["question_id"]))
    if not preds:
        return []
    ids = torch.cat(preds).cpu().numpy()
    return [{"question_id": int(q), "answer": aid_to_ans[int(a)]}
            for q, a in zip(np.concatenate(qids), ids)]
