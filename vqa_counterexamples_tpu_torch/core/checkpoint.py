"""Checkpoints with best-metric retention, in the JAX package's files (port
of ``core/checkpoint.py``): flax msgpack pytrees (``core/msgpack_tree``)
of the JAX param and optax state trees (``models/to_jax``), so a run of
either package resumes, serves or fine-tunes in the other.

CX scheme (reference ``counterexamples.py:550-580``):
``<save_dir>/ckpt/{model.ckpt, info.ckpt}``, copied into ``best/`` when the
val recall improves; ``info.ckpt`` is the JSON list of per-epoch eval
dicts and resume infers the epoch from its length.  ``model.ckpt`` is
JAX's ``CXTrainState`` as a state dict: ``params`` (the whole tree, a
frozen ``vqa_model`` included), ``opt_state`` (optax's Adam state over the
trained parameters; None for a model trained with no optimizer) and
``step`` (int32).  The contrastive trainer's state is a CX state too.

VQA scheme (reference ``train.py:290-367``): ``ckpt_info.json`` with
``ckpt_model.msgpack`` (the param tree) and ``ckpt_optim.msgpack`` (the
Adam state) beside it, copied to ``best_*`` when val acc@1 improves, or
kept per epoch from ``save_all_from`` on with a rolling delete.  A load
path is a prefix: ``<dir>/best`` selects the ``best_*`` files in
``<dir>``.

Every load checks the file's tree against the model's, key for key and
shape for shape, and copies the parameters in place (a captured step
keeps reading them); the Adam state is rebuilt as new tensors
(``models/from_jax``), so a captured step captures again.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np

from ..models import from_jax, to_jax
from . import msgpack_tree


def check_tree(got, want, path: str = "") -> None:
    """``ValueError`` unless ``got`` has ``want``'s keys at every level
    and its leaves' shapes (None where ``want`` has None)."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            have = sorted(got) if isinstance(got, dict) else type(got)
            raise ValueError("checkpoint tree at %s holds %s, the model's "
                             "holds %s" % (path or "/", have, sorted(want)))
        for key in want:
            check_tree(got[key], want[key], "%s/%s" % (path, key))
    elif want is None or got is None:
        if got is not want:
            raise ValueError("checkpoint tree at %s: %r against the model's "
                             "%r" % (path, type(got), type(want)))
    elif tuple(np.shape(got)) != tuple(np.shape(want)):
        raise ValueError("shape mismatch at %s: checkpoint %s, model %s"
                         % (path, tuple(np.shape(got)),
                            tuple(np.shape(want))))


def _encoder_arch(vqa_model):
    return getattr(getattr(vqa_model, "seq2vec", None), "arch", None)


def _load_params(model, state_dict: dict, path: str) -> None:
    """Copy ``state_dict`` into ``model``'s parameters in place; every
    parameter must be covered."""
    names = {n for n, _ in model.named_parameters()}
    if set(state_dict) != names:
        raise ValueError("%s: parameters %s missing, %s unexpected" % (
            path, sorted(names - set(state_dict)),
            sorted(set(state_dict) - names)))
    model.load_state_dict(state_dict, strict=False)


def load_cx_params(model, params: dict, path: str = "params") -> None:
    """A CX model's JAX param tree (checked against the model's) into the
    model, in place (``--init_params``, the CX scheme's loads)."""
    check_tree(params, to_jax.cx_params(model), path)
    _load_params(model, from_jax.cx_state_dict_from_jax(
        params, _encoder_arch(getattr(model, "vqa_model", None))), path)


def _cx_adam_tree(state) -> dict:
    return to_jax.adam_state(state.model, state.optimizer, to_jax.cx_params)


def cx_state_tree(state) -> dict:
    """``state`` (an ``engines.cx_engine.CXTrainState``) as the JAX
    package's ``CXTrainState`` state dict."""
    return {"params": to_jax.cx_params(state.model),
            "opt_state": (None if state.optimizer is None
                          else _cx_adam_tree(state)),
            "step": np.asarray(state.step, np.int32)}


def save_cx_checkpoint(state, info: list, save_dir: str,
                       is_best: bool = True) -> None:
    """``state``: an ``engines.cx_engine.CXTrainState``."""
    path_model = os.path.join(save_dir, "ckpt", "model.ckpt")
    path_info = os.path.join(save_dir, "ckpt", "info.ckpt")
    msgpack_tree.save(cx_state_tree(state), path_model)
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
    path = os.path.join(sub, "model.ckpt")
    tree = msgpack_tree.load(path)
    if not isinstance(tree, dict) or set(tree) != {"params", "opt_state",
                                                   "step"}:
        raise ValueError("%s is not a CXTrainState: it holds %s" % (
            path, sorted(tree) if isinstance(tree, dict) else type(tree)))
    check_tree(tree["opt_state"], None if state.optimizer is None
               else _cx_adam_tree(state), path + "/opt_state")
    check_tree(tree["step"], np.zeros((), np.int32), path + "/step")
    # the params are checked there, before anything is copied
    load_cx_params(state.model, tree["params"], path + "/params")
    if state.optimizer is not None:
        from_jax.adam_state_from_jax(tree["opt_state"], state.model,
                                     state.optimizer)
    state.step = int(tree["step"])
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


def _vqa_adam_tree(state) -> dict:
    return to_jax.adam_state(state.model, state.optimizer, to_jax.vqa_params)


def _save_trees(state, path_model: str, path_optim: str) -> None:
    msgpack_tree.save(to_jax.vqa_params(state.model), path_model)
    msgpack_tree.save(_vqa_adam_tree(state), path_optim)


def save_vqa_checkpoint(info: dict, state, dir_logs: str,
                        save_model: bool = True,
                        save_all_from: int | None = None,
                        is_best: bool = True) -> None:
    """``state``: an ``engines.vqa_engine.VQATrainState``."""
    os.makedirs(dir_logs, exist_ok=True)
    path_ckpt_info = os.path.join(dir_logs, "ckpt_info.json")
    path_ckpt_model = os.path.join(dir_logs, "ckpt_model.msgpack")
    path_ckpt_optim = os.path.join(dir_logs, "ckpt_optim.msgpack")
    _save_json(info, path_ckpt_info)
    if save_all_from is None:
        if save_model:
            _save_trees(state, path_ckpt_model, path_ckpt_optim)
        if is_best:
            shutil.copyfile(path_ckpt_info,
                            os.path.join(dir_logs, "best_info.json"))
            if save_model:
                shutil.copyfile(path_ckpt_model,
                                os.path.join(dir_logs, "best_model.msgpack"))
                shutil.copyfile(path_ckpt_optim,
                                os.path.join(dir_logs, "best_optim.msgpack"))
        return
    # keep-all-from-epoch mode with rolling delete (train.py:303-325)
    epoch = int(info["epoch"])
    if epoch >= save_all_from:
        _save_trees(state, _epoch_path(path_ckpt_model, epoch),
                    _epoch_path(path_ckpt_optim, epoch))
        for old in range(save_all_from, epoch):
            for p in (_epoch_path(path_ckpt_model, old),
                      _epoch_path(path_ckpt_optim, old)):
                if os.path.isfile(p) and not _is_best_epoch(dir_logs, old):
                    os.remove(p)


def vqa_paths(path_ckpt: str):
    """(info, model, optim) paths of the triplet at the prefix
    ``path_ckpt``: ``<dir>/best`` selects the ``best_*`` files inside
    ``<dir>``, ``<dir>`` the ``ckpt_*`` ones (or ``best_*`` when only those
    exist)."""
    if (os.path.basename(path_ckpt) == "best"
            and not os.path.isdir(path_ckpt)):
        base, prefix = os.path.dirname(path_ckpt), "best"
    else:
        base, prefix = path_ckpt, "ckpt"
        if not os.path.isfile(os.path.join(base, "ckpt_info.json")):
            prefix = "best"
    return tuple(os.path.join(base, "%s_%s" % (prefix, name))
                 for name in ("info.json", "model.msgpack", "optim.msgpack"))


def read_vqa_params(model, path_model: str) -> dict:
    """The param tree at ``path_model``, checked against ``model``'s, as
    a ``state_dict`` of ``model``."""
    tree = msgpack_tree.load(path_model)
    check_tree(tree, to_jax.vqa_params(model), path_model)
    return from_jax.vqa_state_dict_from_jax(tree,
                                            seq2vec_arch=_encoder_arch(model))


def load_vqa_model(model, path_ckpt: str) -> bool:
    """Load only the model file of the triplet at ``path_ckpt`` (the
    prefix rule of :func:`load_vqa_checkpoint`) into ``model`` in place;
    False, with a warning, when there is none."""
    _, path_model, _ = vqa_paths(path_ckpt)
    if not os.path.isfile(path_model):
        print("Warning: no model checkpoint found at %s" % path_ckpt)
        return False
    _load_params(model, read_vqa_params(model, path_model), path_model)
    return True


def load_vqa_checkpoint(state, path_ckpt: str) -> dict:
    """Load the triplet saved above into ``state`` in place -> the info
    dict.  Missing pieces warn and are skipped (reference
    ``train.py:344-364``); the step is Adam's count."""
    path_info, _, path_optim = vqa_paths(path_ckpt)
    info = {}
    if os.path.isfile(path_info):
        with open(path_info) as f:
            info = json.load(f)
    else:
        print("Warning: no info checkpoint found at %s" % path_ckpt)
    load_vqa_model(state.model, path_ckpt)
    if os.path.isfile(path_optim):
        tree = msgpack_tree.load(path_optim)
        check_tree(tree, _vqa_adam_tree(state), path_optim)
        from_jax.vqa_adam_state_from_jax(tree, state.model, state.optimizer)
        state.step = int(tree["0"]["count"])
    else:
        print("Warning: no optim checkpoint found at %s" % path_ckpt)
    return info


def write_vqa_params(params: dict, out_dir: str, info: dict) -> None:
    """A VQA param tree as the ``best_*`` / ``ckpt_*`` model and info
    files of ``out_dir``, with no optim file (a ported checkpoint: the
    loader warns and the optimizer starts fresh)."""
    os.makedirs(out_dir, exist_ok=True)
    for stem in ("best", "ckpt"):
        msgpack_tree.save(params,
                          os.path.join(out_dir, stem + "_model.msgpack"))
        _save_json(info, os.path.join(out_dir, stem + "_info.json"))

