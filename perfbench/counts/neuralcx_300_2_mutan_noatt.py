"""Model operations of one NeuralCX train step over the frozen, cached
backbone, from the shapes: the forward and the backward of the trained
parts (the scorer and the answer embedding), nothing recomputed, each
product in its least form (the soft answer embedding contracted as
probs @ (table @ W), as the port and the JAX package do).  Elementwise work
is left out.  ``train_step_flops`` returns the parts; their sum is the
step's count."""

from __future__ import annotations

def dims(cfg: dict) -> dict:
    fu, cx = cfg["model"]["fusion"], cfg["cx_model"]
    return dict(dv=fu["dim_v"], dq=fu["dim_q"], dz=fu["dim_mm"],
                da=cx["dim_a"], h=cx["dim_h"], k=cfg["knn_size"],
                a=cfg["nans"], layers=cx["n_layers"])


def train_step_flops(cfg: dict, shapes: dict) -> dict:
    """``shapes``: ``batch`` (the step's padded batch)."""
    d = dims(cfg)
    b, k, h = shapes["batch"], d["k"], d["h"]
    static = d["dv"] + d["dq"] + d["dz"] + d["da"]
    rows = b * k
    hidden = d["layers"] - 1
    return {
        "vfeat_fwd": 4 * rows * d["dv"] * h,
        "vfeat_bwd": 4 * rows * d["dv"] * h,
        "static_fwd": 2 * b * static * h,
        "static_bwd": 2 * b * static * h + 2 * b * h * d["da"],
        "z_other_fwd": 2 * rows * d["dz"] * h,
        "z_other_bwd": 2 * rows * d["dz"] * h,
        "mixture_fwd": 2 * rows * d["dz"] * d["a"],
        "answer_table_fwd": 2 * d["a"] * d["da"] * h,
        "answer_mix_fwd": 2 * rows * d["a"] * h,
        "answer_bwd": 2 * rows * d["a"] * h + 4 * d["a"] * d["da"] * h,
        "hidden_fwd": hidden * 2 * rows * h * h,
        "hidden_bwd": hidden * 4 * rows * h * h,
        "head_fwd": 2 * rows * h,
        "head_bwd": 4 * rows * h,
    }
