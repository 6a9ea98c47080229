"""Model factories (port of ``models/factory.py``): ``factory_vqa`` for
MutanNoAtt and ``factory_cx`` for NeuralModel."""

from __future__ import annotations

import copy
from typing import Sequence

from torch import nn

from . import cx as cx_mod
from . import noatt as noatt_mod


def factory_vqa(opt: dict, vocab_words: Sequence[str],
                vocab_answers: Sequence[str]) -> nn.Module:
    opt = copy.deepcopy(opt)
    arch = opt["arch"]
    if arch == "MutanNoAtt":
        opt["fusion"]["dim_h"] = opt["fusion"]["dim_mm"]  # noatt.py:52
        return noatt_mod.MutanNoAtt(opt, vocab_words, vocab_answers)
    raise NotImplementedError(
        "VQA arch %r is not ported yet (ROADMAP.md, Queue 1)" % arch)


def factory_cx(cx_name: str, vqa_model: nn.Module, *, knn_size: int = 24,
               trainable_vqa: bool = False, model_spec: dict | None = None
               ) -> nn.Module:
    if cx_name != "NeuralModel":
        raise NotImplementedError(
            "cx_model %r is not ported yet (ROADMAP.md, Queue 1 #8)"
            % cx_name)
    spec = dict(model_spec or {})
    return cx_mod.NeuralModel(
        vqa_model, knn_size=knn_size, trainable_vqa=trainable_vqa,
        model_spec=spec, dim_h=spec.get("dim_h", 300),
        n_layers=spec.get("n_layers", 2), dim_a=spec.get("dim_a", 2400))
