"""Read a trained reference (PyTorch) checkpoint into this port: the port's
own copy of what ``vqa_counterexamples_tpu/models/port_torch.py`` and
``cli/port_checkpoint.load_state_dict`` need (``cli/port_checkpoint.py``
is the command-line wrapper).

A reference user holds ``state_dict`` files: VQA classifiers from
``train.py`` (``best_model.pth.tar``; reference ``train.py:290-330``) and
CX models from ``counterexamples.py`` (``ckpt/model.ckpt``, the VQA model
nested under ``vqa_model.``; reference ``counterexamples.py:550-560``).
This port's modules carry the reference's names, so the output is the
input with three changes:

- the skip-thoughts encoders' keys become the port's ``gru_cell.*``:
  UniSkip's ``nn.GRU`` (``rnn.weight_ih_l0`` with 3H rows) as it is, and
  the genuine ``BayesianGRUCell``'s six per-gate Linears
  (``[rnn.]gru_cell.weight_{ir,ii,in,hr,hi,hn}``; r reset, i carry, n
  new) packed in the port's (r, z, n) order with z <- i, a missing bias
  zero (JAX ``port_torch.port_seq2vec``);
- keys the port's model does not hold are dropped (ContrastiveModel's
  dangling ``answer_embedding``, reference ``cx.py:441-442``);
- every value becomes an f32 CPU tensor.

The architecture is read from the keys (``infer_vqa_arch``,
``infer_cx_model``), as JAX's ``port_torch`` reads it.
"""

from __future__ import annotations

import numpy as np
import torch


def load_state_dict(path: str) -> dict:
    """A torch ``state_dict`` file (``.pth`` / ``.pth.tar``, read with
    ``weights_only=True``) or an ``.npz`` of the same keys; the common
    wrappers (``state_dict``, ``model_state``, ``model``) and a uniform
    ``module.`` prefix (``nn.DataParallel``) are taken off."""
    if path.endswith(".npz"):
        return dict(np.load(path))
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    for key in ("state_dict", "model_state", "model"):
        if isinstance(sd, dict) and key in sd and isinstance(sd[key], dict):
            sd = sd[key]
    if sd and all(k.startswith("module.") for k in sd):
        sd = {k[len("module."):]: v for k, v in sd.items()}
    return sd


def _f32(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32).contiguous()
    return torch.from_numpy(np.array(v, dtype=np.float32))


def _sub(sd: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def infer_vqa_arch(sd: dict) -> str:
    """MutanAtt / MLBAtt / MutanNoAtt / MLBNoAtt from the keys (JAX
    ``port_torch.py:195``)."""
    if any(k.startswith("conv_v_att.") for k in sd):
        mutan = any(k.startswith("fusion_classif.list_linear_hv.")
                    for k in sd)
        return "MutanAtt" if mutan else "MLBAtt"
    mutan = any(k.startswith("fusion.list_linear_hv.") for k in sd)
    return "MutanNoAtt" if mutan else "MLBNoAtt"


def infer_cx_model(sd: dict) -> str:
    """The CX model from its own keys (JAX ``port_torch.py:248``):
    LinearContext's Linear maps K*dim_z to K (24 in the reference), the
    ContrastiveModel's to 300."""
    own = {k for k in sd if not k.startswith("vqa_model.")}
    if "linear_1.weight" in own:
        return "NeuralModel"
    if "out.weight" in own:
        return ("PairwiseLinearModel" if "answer_embedding.weight" in own
                else "PairwiseModel")
    if "linear.weight" in own:
        rows, cols = np.shape(sd["linear.weight"])
        return ("LinearContext" if rows == 24 and cols % rows == 0
                else "ContrastiveModel")
    raise ValueError("unrecognized CX model keys: %s" % sorted(own)[:6])


_RNN_LEAVES = ("weight_ih", "bias_ih", "weight_hh", "bias_hh")


def seq2vec_state_dict(sd: dict) -> dict:
    """The encoder's keys (``seq2vec.`` stripped), the reference's names
    -> the port's (JAX ``port_torch.py:89``)."""
    out = {"embedding.weight": _f32(sd["embedding.weight"])}
    if "rnn_0.weight_ih_l0" in sd or "gru_cell.weight_ih" in sd:
        # TwoLSTM and the pre-packed BayesianUniSkip: the port's names
        keep = [k for k in sd if k.startswith(("rnn_0.", "rnn_1.",
                                                "gru_cell."))]
        return {**out, **{k: _f32(sd[k]) for k in keep}}
    for cell in ("rnn.gru_cell", "gru_cell"):
        if "%s.weight_ir.weight" % cell not in sd:
            continue
        hid = np.shape(sd["%s.weight_hr.weight" % cell])[0]

        def gates(names, part):
            parts = []
            for g in names:
                key = "%s.weight_%s.%s" % (cell, g, part)
                parts.append(_f32(sd[key]) if key in sd
                             else torch.zeros(hid))
            return torch.cat(parts, 0)

        for ours, names in (("ih", ("ir", "ii", "in")),
                            ("hh", ("hr", "hi", "hn"))):
            out["gru_cell.weight_" + ours] = gates(names, "weight")
            out["gru_cell.bias_" + ours] = gates(names, "bias")
        return out
    if "rnn.weight_ih_l0" not in sd:
        raise ValueError("unrecognized seq2vec keys: %s" % sorted(sd)[:5])
    hidden = np.shape(sd["rnn.weight_hh_l0"])[1]
    if np.shape(sd["rnn.weight_ih_l0"])[0] == 3 * hidden:     # UniSkip
        for leaf in _RNN_LEAVES:
            out["gru_cell." + leaf] = _f32(sd["rnn.%s_l0" % leaf])
        return out
    layer = 0                                                 # an LSTM
    while "rnn.weight_ih_l%d" % layer in sd:
        for leaf in _RNN_LEAVES:
            key = "rnn.%s_l%d" % (leaf, layer)
            out[key] = _f32(sd[key])
        layer += 1
    return out


def vqa_state_dict(sd: dict) -> tuple:
    """A reference VQA ``state_dict`` -> (the port's ``state_dict``, the
    arch)."""
    arch = infer_vqa_arch(sd)
    out = {"seq2vec." + k: v
           for k, v in seq2vec_state_dict(_sub(sd, "seq2vec.")).items()}
    out.update({k: _f32(v) for k, v in sd.items()
                if not k.startswith("seq2vec.")})
    return out, arch


# the CX model's own keys by model (the rest of the reference's dropped)
_CX_OWN = {"NeuralModel": ("answer_embedding.", "linear_", "out."),
           "PairwiseModel": ("linear.", "out."),
           "PairwiseLinearModel": ("answer_embedding.", "linear.", "out."),
           "LinearContext": ("linear.",), "ContrastiveModel": ("linear.",)}


def cx_state_dict(sd: dict, cx_model: str | None = None) -> tuple:
    """A reference CX ``state_dict`` -> (the port's ``state_dict``, the
    model's name, the backbone's arch)."""
    model = cx_model or infer_cx_model(sd)
    if model not in _CX_OWN:
        raise ValueError("unsupported CX model %r" % model)
    vqa, vqa_arch = vqa_state_dict(_sub(sd, "vqa_model."))
    out = {"vqa_model." + k: v for k, v in vqa.items()}
    out.update({k: _f32(v) for k, v in sd.items()
                if k.startswith(_CX_OWN[model])})
    return out, model, vqa_arch
