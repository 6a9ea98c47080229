"""Model operations of one MutanNoAtt step, from the shapes of the batch
the engine hands the step (``shapes``: ``batch`` and ``seq_len``, the
right-padded question length): the forward, and for a train step the
backward of every part (the image features take no gradient), nothing
recomputed.  The encoder runs every position of the padded batch and
selects each question's state at its last word, so a step is counted at
its shape, whatever the questions' lengths: ``seq_len`` input projections
a question and ``seq_len - 1`` recurrent products (h_{-1} = 0).
Elementwise work is left out.  ``*_flops`` return the parts; their sum is
the step's count."""

from __future__ import annotations

def dims(cfg: dict) -> dict:
    m = cfg["model"]
    st, fu = m["seq2vec"], m["fusion"]
    return dict(d=st.get("emb_size", 620), h=st.get("hidden_size", 2400),
                dv=fu["dim_v"], dq=fu["dim_q"], dhv=fu["dim_hv"],
                dhq=fu["dim_hq"], r=fu["R"], dmm=fu["dim_mm"], a=cfg["nans"])


def forward_flops(cfg: dict, shapes: dict) -> dict:
    x = dims(cfg)
    g3 = 3 * x["h"]
    batch = shapes["batch"]
    words = batch * shapes["seq_len"]
    return {
        "x_proj_fwd": 2 * words * x["d"] * g3,
        "recurrence_fwd": 2 * (words - batch) * x["h"] * g3,
        "fusion_in_fwd": 2 * batch * (x["dv"] * x["dhv"] + x["dq"] * x["dhq"]),
        "mutan_fwd": 2 * batch * x["r"] * x["dmm"] * (x["dhv"] + x["dhq"]),
        "classif_fwd": 2 * batch * x["dmm"] * x["a"],
    }


def train_step_flops(cfg: dict, shapes: dict) -> dict:
    x = dims(cfg)
    g3 = 3 * x["h"]
    batch = shapes["batch"]
    words = batch * shapes["seq_len"]
    fwd = forward_flops(cfg, shapes)
    return {**fwd,
            "x_proj_bwd": 2 * fwd["x_proj_fwd"],
            "recurrence_bwd": (2 * (words - batch) * g3 * x["h"]
                               + 2 * words * g3 * x["h"]),
            "fusion_in_bwd": 2 * batch * (x["dv"] * x["dhv"]
                                          + 2 * x["dq"] * x["dhq"]),
            "mutan_bwd": 2 * fwd["mutan_fwd"],
            "classif_bwd": 2 * fwd["classif_fwd"]}


def eval_step_flops(cfg: dict, shapes: dict) -> dict:
    return forward_flops(cfg, shapes)
