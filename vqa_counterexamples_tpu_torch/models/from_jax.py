"""Carry weights from the JAX package's param trees into this port (the
counterpart of ``vqa_counterexamples_tpu/models/port_torch.py``).

The input is a flax param tree with numpy (or array-like) leaves; the
output is a ``state_dict`` with the reference attribute names this port's
modules use, so ``module.load_state_dict(...)`` takes it as is, and
``port_torch.port_cx_state_dict`` reads it back into the flax tree.

Layout conversions: flax ``Dense`` kernel (in, out) -> ``nn.Linear.weight``
(out, in), or a 1x1 ``nn.Conv2d`` weight (out, in, 1, 1) for the attention
models' ``conv_*``; the fused MUTAN ``w_hv`` (din, R*dmm) -> per-rank
``list_linear_hv.{r}`` Linears; ``list_linear_v_fusion_{g}`` ->
``list_linear_v_fusion.{g}``; GRU ``w_ih`` (D, 3H) / ``w_hh`` (H, 3H)
-> ``gru_cell.weight_ih`` (3H, D) / ``weight_hh`` (3H, H), gate order
r, z, n unchanged.  The same conversions carry optax's Adam moments into
``torch.optim.Adam`` (:func:`adam_state_from_jax`).
"""

from __future__ import annotations

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _field(tree, name):
    return tree[name] if isinstance(tree, dict) else getattr(tree, name)


def _linear(sd: dict, prefix: str, kernel, bias) -> None:
    sd[prefix + ".weight"] = _t(kernel).t().contiguous()
    sd[prefix + ".bias"] = _t(bias)


def _mutan(sd: dict, prefix: str, fus: dict, dmm: int) -> None:
    """A MutanFusion subtree: ``linear_v`` / ``linear_q`` where the module
    has them, the per-rank Linears from the stacked ``w_h*`` / ``b_h*``."""
    for side in ("v", "q"):
        if "linear_" + side in fus:
            lin = fus["linear_" + side]
            _linear(sd, prefix + "linear_" + side, lin["kernel"],
                    lin["bias"])
        w, b = np.asarray(fus["w_h" + side]), np.asarray(fus["b_h" + side])
        for r in range(w.shape[1] // dmm):
            cols = slice(r * dmm, (r + 1) * dmm)
            _linear(sd, prefix + "list_linear_h%s.%d" % (side, r),
                    w[:, cols], b[cols])


def _conv1x1(sd: dict, prefix: str, kernel, bias) -> None:
    w = _t(kernel).t().contiguous()
    sd[prefix + ".weight"] = w.reshape(w.shape[0], w.shape[1], 1, 1)
    sd[prefix + ".bias"] = _t(bias)


def vqa_state_dict_from_jax(params: dict, prefix: str = "") -> dict:
    """MutanNoAtt or MutanAtt (skip-thoughts encoder) param tree ->
    state_dict."""
    sd = {}
    s2v = params["seq2vec"]
    sd[prefix + "seq2vec.embedding.weight"] = _t(s2v["embedding"])
    gru = s2v["gru"]
    cell = prefix + "seq2vec.gru_cell."
    sd[cell + "weight_ih"] = _t(_field(gru, "w_ih")).t().contiguous()
    sd[cell + "bias_ih"] = _t(_field(gru, "b_ih"))
    sd[cell + "weight_hh"] = _t(_field(gru, "w_hh")).t().contiguous()
    sd[cell + "bias_hh"] = _t(_field(gru, "b_hh"))
    cls = params["linear_classif"]
    dmm = np.asarray(cls["kernel"]).shape[0]
    if "conv_v_att" in params:
        for name in ("conv_v_att", "conv_att"):
            _conv1x1(sd, prefix + name, params[name]["kernel"],
                     params[name]["bias"])
        g = 0
        while "list_linear_v_fusion_%d" % g in params:
            lin = params["list_linear_v_fusion_%d" % g]
            _linear(sd, prefix + "list_linear_v_fusion.%d" % g,
                    lin["kernel"], lin["bias"])
            g += 1
        for name in ("linear_q_att", "linear_q_fusion"):
            _linear(sd, prefix + name, params[name]["kernel"],
                    params[name]["bias"])
        _mutan(sd, prefix + "fusion_att.", params["fusion_att_module"],
               np.asarray(params["conv_att"]["kernel"]).shape[0])
        _mutan(sd, prefix + "fusion_classif.",
               params["fusion_classif_module"], dmm)
    else:
        _mutan(sd, prefix + "fusion.", params["fusion_module"], dmm)
    _linear(sd, prefix + "linear_classif", cls["kernel"], cls["bias"])
    return sd


def cx_trainable_state_dict_from_jax(tree: dict) -> dict:
    """The CX model's own (non-backbone) part of its tree -> state_dict:
    NeuralModel's ``answer_embedding`` / ``linear_{i}_{w,b}`` / ``out_*``,
    or the zoo's ``linear`` / ``out`` Dense and PairwiseLinearModel's
    ``answer_embedding`` Embed.  Serves the params and any tree shaped like
    them (grads, Adam moments)."""
    sd = {}
    emb = tree.get("answer_embedding")
    if emb is not None:
        if isinstance(emb, dict):
            emb = emb["embedding"]
        sd["answer_embedding.weight"] = _t(emb)
    layer = 1
    while "linear_%d_w" % layer in tree:
        _linear(sd, "linear_%d" % layer, tree["linear_%d_w" % layer],
                tree["linear_%d_b" % layer])
        layer += 1
    if "out_w" in tree:
        _linear(sd, "out", tree["out_w"], tree["out_b"])
    for name in ("linear", "out"):
        if isinstance(tree.get(name), dict):
            _linear(sd, name, tree[name]["kernel"], tree[name]["bias"])
    return sd


def cx_state_dict_from_jax(params: dict) -> dict:
    """A CX model's param tree (with the nested ``vqa_model`` where the
    model has a backbone) -> state_dict.  Serves any tree shaped like the
    params, e.g. the Adam moments of a trainable backbone."""
    sd = {}
    if "vqa_model" in params:
        sd.update(vqa_state_dict_from_jax(params["vqa_model"],
                                          prefix="vqa_model."))
    sd.update(cx_trainable_state_dict_from_jax(params))
    return sd


def _carry_adam(opt_state, model, optimizer, to_state_dict) -> None:
    adam = next(s for s in (opt_state if isinstance(opt_state, (tuple, list))
                            else (opt_state,)) if hasattr(s, "mu"))
    mu = to_state_dict(adam.mu)
    nu = to_state_dict(adam.nu)
    step = float(np.asarray(adam.count))
    # a capturable Adam keeps its step count beside the parameter
    capturable = optimizer.defaults.get("capturable", False)
    for name, param in model.named_parameters():
        if name not in mu:
            continue
        optimizer.state[param] = {
            "step": torch.tensor(step, dtype=torch.float32,
                                 device=param.device if capturable
                                 else None),
            "exp_avg": mu[name].to(param.device, param.dtype),
            "exp_avg_sq": nu[name].to(param.device, param.dtype)}


def adam_state_from_jax(opt_state, model: torch.nn.Module,
                        optimizer: torch.optim.Optimizer) -> None:
    """Carry optax's Adam state (``ScaleByAdamState``: ``count``, ``mu``,
    ``nu`` over the trainable subtree, the backbone's ``vqa_model`` too
    when it trains) into ``optimizer``'s state for ``model``'s trainable
    parameters (``step``, ``exp_avg``, ``exp_avg_sq``), in place.  Leaves
    are numpy (or array-like)."""
    _carry_adam(opt_state, model, optimizer, cx_state_dict_from_jax)


def vqa_adam_state_from_jax(opt_state, model: torch.nn.Module,
                            optimizer: torch.optim.Optimizer) -> None:
    """The same for a MutanNoAtt or MutanAtt trained by the VQA engine:
    optax's Adam over the whole VQA param tree into the state of every
    parameter of ``model``."""
    _carry_adam(opt_state, model, optimizer, vqa_state_dict_from_jax)
