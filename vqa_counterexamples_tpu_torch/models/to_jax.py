"""This port's weights as the JAX package's param trees: the inverse of
``models/from_jax.py``, so the port writes (and reads back) the JAX
package's checkpoint files (``core/checkpoint.py``).

The input is a module (its parameters, by their reference names) or a
``state_dict``; the output is a tree of numpy f32 arrays shaped as the
JAX package's flax params, each dict's keys sorted as ``jax.device_get``
leaves them in that package's files, and the ``GRUParams`` /
``LSTMParams`` leaves as flax's state dicts of those NamedTuples (fields
``w_ih``, ``b_ih``, ``w_hh``, ``b_hh`` in that order).  The layout
conversions are ``from_jax``'s read backwards: an ``nn.Linear`` weight
(out, in) -> a Dense ``kernel`` (in, out); a 1x1 ``nn.Conv2d`` (out, in,
1, 1) -> a Dense kernel; the per-rank ``list_linear_h{v,q}.{r}`` Linears
-> the fused ``w_h{v,q}`` (din, R*dmm) column blocks; recurrent weights
transposed, gate order unchanged.

Optimizer state: :func:`adam_state` gives optax's ``adam`` state,
``(ScaleByAdamState(count, mu, nu), EmptyState())``, as flax's state dict
of it, ``{'0': {'count', 'mu', 'nu'}, '1': {}}``, over the parameters the
optimizer trains.
"""

from __future__ import annotations

import numpy as np
import torch

_RNN_LEAVES = (("w_ih", "weight_ih"), ("b_ih", "bias_ih"),
               ("w_hh", "weight_hh"), ("b_hh", "bias_hh"))


def _np(t) -> np.ndarray:
    """A copy (never a view of a parameter that trains on)."""
    return t.detach().to("cpu", torch.float32, copy=True).numpy()


def _sorted(tree: dict) -> dict:
    return dict(sorted(tree.items()))


def _dense(sd: dict, name: str) -> dict:
    w = _np(sd[name + ".weight"])
    if w.ndim == 4:                         # a 1x1 conv
        w = w[:, :, 0, 0]
    return {"bias": _np(sd[name + ".bias"]), "kernel": np.ascontiguousarray(
        w.T)}


def _sub(sd: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _rnn(sd: dict, prefix: str, suffix: str = "") -> dict:
    return {jax_name: (np.ascontiguousarray(_np(sd[prefix + ours + suffix]).T)
                       if ours.startswith("weight")
                       else _np(sd[prefix + ours + suffix]))
            for jax_name, ours in _RNN_LEAVES}


def _seq2vec(sd: dict) -> dict:
    """The encoder's keys (``seq2vec.`` stripped): the skip-thoughts GRU
    (``gru_cell.*``), an LSTM (``rnn.*_l{k}``) or a TwoLSTM
    (``rnn_0`` / ``rnn_1``)."""
    emb = _np(sd["embedding.weight"])
    if "gru_cell.weight_ih" in sd:
        return {"embedding": emb, "gru": _rnn(sd, "gru_cell.")}
    out = {"embedding": {"embedding": emb}}
    if "rnn_0.weight_ih_l0" in sd:
        for layer in (0, 1):
            out["lstm_%d" % layer] = _rnn(sd, "rnn_%d." % layer, "_l0")
        return out
    layer = 0
    while "rnn.weight_ih_l%d" % layer in sd:
        out["lstm_%d" % layer] = _rnn(sd, "rnn.", "_l%d" % layer)
        layer += 1
    if layer == 0:
        raise ValueError("unrecognized encoder keys: %s" % sorted(sd)[:5])
    return _sorted(out)


def _stack_ranks(sd: dict, name: str):
    ranks = 0
    while "%s.%d.weight" % (name, ranks) in sd:
        ranks += 1
    w = np.concatenate([_np(sd["%s.%d.weight" % (name, r)]).T
                        for r in range(ranks)], axis=1)
    b = np.concatenate([_np(sd["%s.%d.bias" % (name, r)])
                        for r in range(ranks)])
    return w, b


def _fusion(sd: dict) -> dict:
    """A MutanFusion's keys (its per-rank Linears, ``linear_v`` /
    ``linear_q`` where it has them) or an MLBFusion's (only the latter)."""
    out = {}
    for side in ("v", "q"):
        if "linear_%s.weight" % side in sd:
            out["linear_" + side] = _dense(sd, "linear_" + side)
        if "list_linear_h%s.0.weight" % side in sd:
            out["w_h" + side], out["b_h" + side] = _stack_ranks(
                sd, "list_linear_h" + side)
    return _sorted(out)


def vqa_params(sd) -> dict:
    """A MutanNoAtt, MLBNoAtt, MutanAtt or MLBAtt module (or its
    ``state_dict``) -> the JAX package's param tree."""
    if isinstance(sd, torch.nn.Module):
        sd = dict(sd.named_parameters())
    out = {"seq2vec": _seq2vec(_sub(sd, "seq2vec.")),
           "linear_classif": _dense(sd, "linear_classif")}
    if "conv_v_att.weight" not in sd:
        out["fusion_module"] = _fusion(_sub(sd, "fusion."))
        return _sorted(out)
    for name in ("conv_v_att", "conv_att", "linear_q_att", "linear_q_fusion"):
        out[name] = _dense(sd, name)
    g = 0
    while "list_linear_v_fusion.%d.weight" % g in sd:
        out["list_linear_v_fusion_%d" % g] = _dense(
            sd, "list_linear_v_fusion.%d" % g)
        g += 1
    if "fusion_att.list_linear_hv.0.weight" in sd:      # MutanAtt
        out["fusion_att_module"] = _fusion(_sub(sd, "fusion_att."))
        out["fusion_classif_module"] = _fusion(_sub(sd, "fusion_classif."))
    return _sorted(out)


def _cx_own(sd: dict) -> dict:
    """The CX model's own (non-backbone) keys -> its part of the tree:
    NeuralModel's ``answer_embedding`` / ``linear_{i}_{w,b}`` /
    ``out_{w,b}``, or the zoo's ``linear`` / ``out`` Dense and
    PairwiseLinearModel's ``answer_embedding`` Embed.  Serves any
    ``state_dict`` shaped like the parameters (Adam's moments)."""
    out = {}
    if "linear_1.weight" in sd:                 # NeuralModel
        out["answer_embedding"] = _np(sd["answer_embedding.weight"])
        layer = 1
        while "linear_%d.weight" % layer in sd:
            lin = _dense(sd, "linear_%d" % layer)
            out["linear_%d_w" % layer] = lin["kernel"]
            out["linear_%d_b" % layer] = lin["bias"]
            layer += 1
        lin = _dense(sd, "out")
        out["out_w"], out["out_b"] = lin["kernel"], lin["bias"]
        return _sorted(out)
    if "answer_embedding.weight" in sd:
        out["answer_embedding"] = {
            "embedding": _np(sd["answer_embedding.weight"])}
    for name in ("linear", "out"):
        if name + ".weight" in sd:
            out[name] = _dense(sd, name)
    return _sorted(out)


def cx_params(sd) -> dict:
    """A CX model (or its ``state_dict``) -> the JAX package's param tree,
    the backbone nested under ``vqa_model`` where the model has one
    (frozen or not: the JAX package's trees hold it either way)."""
    if isinstance(sd, torch.nn.Module):
        sd = dict(sd.named_parameters())
    own = {k: v for k, v in sd.items() if not k.startswith("vqa_model.")}
    out = _cx_own(own)
    if len(own) < len(sd):
        out["vqa_model"] = vqa_params(_sub(sd, "vqa_model."))
    return _sorted(out)


def adam_state(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
               to_tree) -> dict:
    """``optimizer``'s Adam state over ``model``'s parameters it trains ->
    flax's state dict of optax's ``adam`` state; ``to_tree`` maps a
    ``state_dict`` of those parameters (or of their moments) to the JAX
    tree (:func:`cx_params`, :func:`vqa_params`).  A parameter with no
    state (no step taken, or never a gradient: torch's Adam skips it)
    has zero moments, as optax's would; the count is the steps taken."""
    trained = {id(p) for g in optimizer.param_groups for p in g["params"]}
    params = {n: p for n, p in model.named_parameters() if id(p) in trained}
    mu, nu, count = {}, {}, 0
    for name, p in params.items():
        state = optimizer.state.get(p, {})
        mu[name] = state.get("exp_avg", torch.zeros_like(p))
        nu[name] = state.get("exp_avg_sq", torch.zeros_like(p))
        count = max(count, int(state.get("step", 0)))
    return {"0": {"count": np.asarray(count, np.int32), "mu": to_tree(mu),
                  "nu": to_tree(nu)}, "1": {}}
