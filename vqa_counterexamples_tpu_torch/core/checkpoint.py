"""Checkpoints with best-metric retention (port of the CX and VQA schemes
of ``core/checkpoint.py``).

Layout as in the JAX package (reference ``counterexamples.py:550-580``):
``<save_dir>/ckpt/{model.ckpt, info.ckpt}``, copied into ``best/`` when the
val recall improves; ``info.ckpt`` is the JSON list of per-epoch eval dicts
and resume infers the epoch from its length.  ``model.ckpt`` is a
``torch.save`` of the parameters the optimizer trains (the frozen backbone
is rebuilt, not saved; a trainable backbone is saved, since the optimizer
trains it), the Adam ``state_dict`` (None for a model trained with no
optimizer) and the step.  The contrastive trainer's state is a CX state
too.  It is not the JAX package's msgpack format.

The VQA scheme (reference ``train.py:290-367``) keeps the JAX layout: a
``ckpt_info.json`` (the same JSON as the JAX package's) with
``ckpt_model.pt`` / ``ckpt_optim.pt`` beside it, copied to ``best_*`` when
val acc@1 improves, or kept per epoch from ``save_all_from`` on with a
rolling delete.  The payloads are ``torch.save`` files named ``*.pt``,
so no reader takes them for the JAX package's ``*.msgpack``.
"""

from __future__ import annotations

import itertools
import json
import os
import shutil

import torch


def _trainable_state_dict(state) -> dict:
    """The parameters the optimizer updates, by name (none without an
    optimizer)."""
    if state.optimizer is None:
        return {}
    ids = {id(p) for group in state.optimizer.param_groups
           for p in group["params"]}
    return {n: p.detach() for n, p in state.model.named_parameters()
            if id(p) in ids}


def save_cx_checkpoint(state, info: list, save_dir: str,
                       is_best: bool = True) -> None:
    """``state``: an ``engines.cx_engine.CXTrainState`` (a model trained
    with no optimizer saves no parameters and ``optimizer`` None, as JAX's
    saves ``opt_state`` None)."""
    ckpt_dir = os.path.join(save_dir, "ckpt")
    os.makedirs(ckpt_dir, exist_ok=True)
    path_model = os.path.join(ckpt_dir, "model.ckpt")
    path_info = os.path.join(ckpt_dir, "info.ckpt")
    torch.save({"model": _trainable_state_dict(state),
                "optimizer": (None if state.optimizer is None
                              else state.optimizer.state_dict()),
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
    # the baselines hold no parameters: their buffer carries the device
    device = next(itertools.chain(state.model.parameters(),
                                  state.model.buffers())).device
    payload = torch.load(os.path.join(sub, "model.ckpt"),
                         map_location=device, weights_only=True)
    expected = set(_trainable_state_dict(state))
    if set(payload["model"]) != expected:
        raise ValueError("checkpoint %s holds %s, the model trains %s"
                         % (sub, sorted(payload["model"]), sorted(expected)))
    if (payload["optimizer"] is None) != (state.optimizer is None):
        raise ValueError("checkpoint %s and the state disagree on having an "
                         "optimizer" % sub)
    state.model.load_state_dict(payload["model"], strict=False)
    if state.optimizer is not None:
        state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    with open(os.path.join(sub, "info.ckpt")) as f:
        info = json.load(f)
    if not info:
        raise ValueError("empty info.ckpt in %s" % sub)
    return state, info, len(info) + 1, info[-1]["recall"]


# ---------------------------------------------------------------- VQA scheme

def _save_json(obj, path: str) -> None:
    with open(path, "w") as f:
        json.dump(obj, f)


def _epoch_path(path: str, epoch: int) -> str:
    base, ext = os.path.splitext(path)
    return "%s_epoch,%d%s" % (base, epoch, ext)


def _is_best_epoch(dir_logs: str, epoch: int) -> bool:
    path = os.path.join(dir_logs, "best_info.json")
    if not os.path.isfile(path):
        return False
    with open(path) as f:
        return int(json.load(f).get("epoch", -1)) == epoch


def _save_payloads(state, path_model: str, path_optim: str) -> None:
    torch.save({k: v.detach() for k, v in state.model.state_dict().items()},
               path_model)
    torch.save({"optimizer": state.optimizer.state_dict(),
                "step": state.step}, path_optim)


def save_vqa_checkpoint(info: dict, state, dir_logs: str,
                        save_model: bool = True,
                        save_all_from: int | None = None,
                        is_best: bool = True) -> None:
    """``state``: an ``engines.vqa_engine.VQATrainState``."""
    os.makedirs(dir_logs, exist_ok=True)
    path_ckpt_info = os.path.join(dir_logs, "ckpt_info.json")
    path_ckpt_model = os.path.join(dir_logs, "ckpt_model.pt")
    path_ckpt_optim = os.path.join(dir_logs, "ckpt_optim.pt")
    _save_json(info, path_ckpt_info)
    if save_all_from is None:
        if save_model:
            _save_payloads(state, path_ckpt_model, path_ckpt_optim)
        if is_best:
            shutil.copyfile(path_ckpt_info,
                            os.path.join(dir_logs, "best_info.json"))
            if save_model:
                shutil.copyfile(path_ckpt_model,
                                os.path.join(dir_logs, "best_model.pt"))
                shutil.copyfile(path_ckpt_optim,
                                os.path.join(dir_logs, "best_optim.pt"))
        return
    # keep-all-from-epoch mode with rolling delete (train.py:303-325)
    epoch = int(info["epoch"])
    if epoch >= save_all_from:
        _save_payloads(state, _epoch_path(path_ckpt_model, epoch),
                       _epoch_path(path_ckpt_optim, epoch))
        for old in range(save_all_from, epoch):
            for p in (_epoch_path(path_ckpt_model, old),
                      _epoch_path(path_ckpt_optim, old)):
                if os.path.isfile(p) and not _is_best_epoch(dir_logs, old):
                    os.remove(p)


def load_vqa_checkpoint(state, path_ckpt: str) -> dict:
    """Load the triplet saved above into ``state`` in place -> the info
    dict.  ``path_ckpt`` is a prefix, as in the reference: ``<dir>/best``
    selects the ``best_*`` files inside ``<dir>``, ``<dir>`` the ``ckpt_*``
    ones (or ``best_*`` when only those exist).  Missing pieces warn and
    are skipped (reference ``train.py:344-364``)."""
    if (os.path.basename(path_ckpt) == "best"
            and not os.path.isdir(path_ckpt)):
        base, prefix = os.path.dirname(path_ckpt), "best"
    else:
        base, prefix = path_ckpt, "ckpt"
        if not os.path.isfile(os.path.join(base, "ckpt_info.json")):
            prefix = "best"
    path_info, path_model, path_optim = (
        os.path.join(base, "%s_%s" % (prefix, name))
        for name in ("info.json", "model.pt", "optim.pt"))
    info = {}
    if os.path.isfile(path_info):
        with open(path_info) as f:
            info = json.load(f)
    else:
        print("Warning: no info checkpoint found at %s" % path_ckpt)
    device = next(state.model.parameters()).device
    if os.path.isfile(path_model):
        state.model.load_state_dict(torch.load(
            path_model, map_location=device, weights_only=True))
    else:
        print("Warning: no model checkpoint found at %s" % path_ckpt)
    if os.path.isfile(path_optim):
        payload = torch.load(path_optim, map_location=device,
                             weights_only=True)
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
    else:
        print("Warning: no optim checkpoint found at %s" % path_ckpt)
    return info
