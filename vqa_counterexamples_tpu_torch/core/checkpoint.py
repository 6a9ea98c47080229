"""CX checkpoints with best-metric retention (port of the CX scheme of
``core/checkpoint.py``).

Layout as in the JAX package (reference ``counterexamples.py:550-580``):
``<save_dir>/ckpt/{model.ckpt, info.ckpt}``, copied into ``best/`` when the
val recall improves; ``info.ckpt`` is the JSON list of per-epoch eval dicts
and resume infers the epoch from its length.  ``model.ckpt`` is a
``torch.save`` of the parameters the optimizer trains (the frozen backbone
is rebuilt, not saved), the Adam ``state_dict`` and the step.  It
is not the JAX package's msgpack format.
"""

from __future__ import annotations

import json
import os
import shutil

import torch


def _trainable_state_dict(state) -> dict:
    """The parameters the optimizer updates, by name."""
    ids = {id(p) for group in state.optimizer.param_groups
           for p in group["params"]}
    return {n: p.detach() for n, p in state.model.named_parameters()
            if id(p) in ids}


def save_cx_checkpoint(state, info: list, save_dir: str,
                       is_best: bool = True) -> None:
    """``state``: an ``engines.cx_engine.CXTrainState``."""
    ckpt_dir = os.path.join(save_dir, "ckpt")
    os.makedirs(ckpt_dir, exist_ok=True)
    path_model = os.path.join(ckpt_dir, "model.ckpt")
    path_info = os.path.join(ckpt_dir, "info.ckpt")
    torch.save({"model": _trainable_state_dict(state),
                "optimizer": state.optimizer.state_dict(),
                "step": state.step}, path_model)
    with open(path_info, "w") as f:
        json.dump(info, f)
    if is_best:
        best_dir = os.path.join(save_dir, "best")
        os.makedirs(best_dir, exist_ok=True)
        shutil.copyfile(path_model, os.path.join(best_dir, "model.ckpt"))
        shutil.copyfile(path_info, os.path.join(best_dir, "info.ckpt"))


def load_cx_checkpoint(state, save_dir: str, resume_best: bool = True):
    """Load ``best/`` (or ``ckpt/``) into ``state`` in place -> ``(state,
    info, next_epoch, best_recall)``."""
    sub = os.path.join(save_dir, "best" if resume_best else "ckpt")
    device = next(state.model.parameters()).device
    payload = torch.load(os.path.join(sub, "model.ckpt"),
                         map_location=device, weights_only=True)
    expected = set(_trainable_state_dict(state))
    if set(payload["model"]) != expected:
        raise ValueError("checkpoint %s holds %s, the model trains %s"
                         % (sub, sorted(payload["model"]), sorted(expected)))
    state.model.load_state_dict(payload["model"], strict=False)
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    with open(os.path.join(sub, "info.ckpt")) as f:
        info = json.load(f)
    if not info:
        raise ValueError("empty info.ckpt in %s" % sub)
    return state, info, len(info) + 1, info[-1]["recall"]
