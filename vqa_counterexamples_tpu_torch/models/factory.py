"""Model factories (port of ``models/factory.py``): ``factory_vqa`` for the
four VQA archs of ``model_names`` (with the reference constructors' dim
tying), ``factory_cx`` for the ten CX models of ``cx_model_names``, and
``flagship_cx``, the flagship configuration at full width."""

from __future__ import annotations

import copy
from typing import Sequence

from torch import nn

from . import att as att_mod
from . import cx as cx_mod
from . import noatt as noatt_mod


model_names = ["MLBNoAtt", "MutanNoAtt", "MLBAtt", "MutanAtt"]


def factory_vqa(opt: dict, vocab_words: Sequence[str],
                vocab_answers: Sequence[str]) -> nn.Module:
    """The dispatch of JAX ``factory.py:35-60`` (reference
    ``models/utils.py:14-30``); the options are copied, then tied as the
    reference constructors tie them."""
    opt = copy.deepcopy(opt)
    arch = opt["arch"]
    if arch == "MLBNoAtt":
        return noatt_mod.MLBNoAtt(opt, vocab_words, vocab_answers)
    if arch == "MutanNoAtt":
        opt["fusion"]["dim_h"] = opt["fusion"]["dim_mm"]  # noatt.py:52
        return noatt_mod.MutanNoAtt(opt, vocab_words, vocab_answers)
    if arch == "MLBAtt":
        opt["attention"]["dim_v"] = opt["attention"]["dim_h"]   # att.py:170
        opt["attention"]["dim_q"] = opt["attention"]["dim_h"]
        opt["attention"]["dim_mm"] = opt["attention"]["dim_h"]
        return att_mod.MLBAtt(opt, vocab_words, vocab_answers)
    if arch == "MutanAtt":
        opt["attention"]["dim_v"] = opt["attention"]["dim_hv"]  # att.py:199
        opt["attention"]["dim_q"] = opt["attention"]["dim_hq"]
        return att_mod.MutanAtt(opt, vocab_words, vocab_answers)
    raise ValueError("unknown VQA model arch %r" % arch)


cx_model_names = ["RandomBaseline", "DistanceBaseline", "BlackBox",
                  "LinearContext", "SemanticBaseline", "NeuralModel",
                  "PairwiseModel", "PairwiseLinearModel", "ContrastiveModel",
                  "SimilarityModel"]


def factory_cx(cx_name: str, vqa_model: nn.Module | None, *,
               knn_size: int = 24, trainable_vqa: bool = False,
               model_spec: dict | None = None, sb_lambda: float = 0.5
               ) -> nn.Module:
    """The dispatch of JAX ``factory.py:63-101`` (reference
    ``counterexamples.py:216-273``).  The two baselines take no backbone
    (``vqa_model`` may be None); every other name needs one."""
    if cx_name == "RandomBaseline":
        return cx_mod.RandomBaseline(knn_size=knn_size)
    if cx_name == "DistanceBaseline":
        return cx_mod.DistanceBaseline(knn_size=knn_size)
    if cx_name not in cx_model_names:
        raise ValueError("Unrecognized cx_model %s" % cx_name)
    if vqa_model is None:
        raise ValueError("%s needs a VQA backbone" % cx_name)
    common = dict(vqa_model=vqa_model, knn_size=knn_size,
                  trainable_vqa=trainable_vqa)
    if cx_name == "SemanticBaseline":
        return cx_mod.SemanticBaseline(lam=sb_lambda, **common)
    if cx_name == "NeuralModel":
        spec = dict(model_spec or {})
        return cx_mod.NeuralModel(
            model_spec=spec, dim_h=spec.get("dim_h", 300),
            n_layers=spec.get("n_layers", 2),
            drop_p=spec.get("drop_p", 0.25), dim_a=spec.get("dim_a", 2400),
            **common)
    return getattr(cx_mod, cx_name)(**common)


def cx_from_options(cx_name: str, options: dict,
                    vocab_words: Sequence[str], vocab_answers: Sequence[str],
                    *, knn_size: int = 24, sb_lambda: float = 0.5
                    ) -> nn.Module:
    """A CX model from a resolved option tree (``core/config``), as the CX
    CLI builds it: the ``model`` backbone (none for the two baselines),
    ``cx_model`` as the model spec and its ``trainable_vqa``.  Weights are
    left at torch's defaults: call ``engines.cx_engine.init_cx_params``."""
    vqa = (None if cx_name in ("RandomBaseline", "DistanceBaseline")
           else factory_vqa(options["model"], vocab_words, vocab_answers))
    spec = dict(options["cx_model"])
    return factory_cx(cx_name, vqa, knn_size=knn_size,
                      trainable_vqa=spec["trainable_vqa"], model_spec=spec,
                      sb_lambda=sb_lambda)


def flagship_cx(vocab_words: Sequence[str], vocab_answers: Sequence[str],
                drop_p: float = 0.25) -> nn.Module:
    """NeuralCX at the flagship width (bench.py's configuration): dim_v
    2048, K 24, BayesianUniSkip 620 -> 2400, MUTAN R 10 with every dim
    360, the answer head over ``vocab_answers``, NeuralCX 300 x 2 with
    dim_a 2400.  Weights are left at torch's defaults: call
    ``engines.cx_engine.init_cx_params``."""
    from ..data import synthetic

    opt = synthetic.tiny_vqa_options(dim_v=2048, nans=len(vocab_answers),
                                     dim_q=2400)
    opt["seq2vec"] = {"arch": "skipthoughts", "type": "BayesianUniSkip",
                      "dropout": 0.25, "fixed_emb": False}
    opt["fusion"].update(dim_hv=360, dim_hq=360, dim_mm=360, R=10)
    spec = dict(dim_h=300, n_layers=2, drop_p=drop_p, v_emb=True,
                v_mult=True, v_dist=True, v_rank=True, q_emb=True,
                a_emb=True, z_emb=True, pretrained_emb=False,
                trainable_vqa=False)
    return factory_cx("NeuralModel",
                      factory_vqa(opt, vocab_words, vocab_answers),
                      knn_size=24, model_spec=spec)
