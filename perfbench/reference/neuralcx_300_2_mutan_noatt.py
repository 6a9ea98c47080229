"""Plain reference of NeuralCX 300 x 2 with every input on, over a frozen
MutanNoAtt + BayesianUniSkip backbone (arXiv:1806.00857; the reference
code's ``options/cx/counterexamples_default.yaml``), in float32 with TF32
off, or in float8 for the control (``common.Precision``).

For each (image, question, answer) and its K = 24 candidate images, the
scorer reads the 14,089-wide concat of the reference's ``cx.py``:
[v_orig, v_other, v_orig * v_other, |v_orig - v_other|, the candidate's
rank one-hot, the question's encoding, z_orig, z_other, the answer's
embedding, the candidate's soft answer embedding] where z is the frozen
backbone's MUTAN fusion of the question with an image and the soft answer
embedding is softmax(backbone classifier(z_other)) @ the answer-embedding
table.  Two Linear + ReLU + dropout layers (300) and a scalar head score
the candidates; the loss is the mean cross-entropy over the K scores
against the complementary image's rank; Adam updates the scorer and the
answer embedding.  The backbone is evaluated here from the weights, for
the batch's rows: the program's q / v / z tables are never read.  As the
program stores its tables in bfloat16, the control stores them in float8.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import common
from perfbench.reference import mutan_noatt_bayesian_uniskip as backbone

BACKBONE = "vqa_model."

# the weight of the last layer
HEAD = "out.weight"


def input_size(cfg: dict) -> int:
    fu = cfg["model"]["fusion"]
    return (3 * fu["dim_v"] + 1 + cfg["knn_size"] + fu["dim_q"]
            + 2 * fu["dim_mm"] + 2 * cfg["cx_model"]["dim_a"])


def param_specs(cfg: dict) -> list:
    """The backbone's (``vqa_model.*``), then the scorer's: the answer
    embedding N(0, std_a^2), lecun-scaled Linears, small biases."""
    cx = cfg["cx_model"]
    hid = cx["dim_h"]
    out = backbone.param_specs(cfg, BACKBONE)
    out.append(("answer_embedding.weight", (cfg["nans"], cx["dim_a"]),
                cx.get("answer_embedding_std", 1.0)))
    d_in = input_size(cfg)
    for i in range(1, cx["n_layers"] + 1):
        out += [("linear_%d.weight" % i, (hid, d_in), d_in ** -0.5),
                ("linear_%d.bias" % i, (hid,), 0.02)]
        d_in = hid
    out += [("out.weight", (1, hid), hid ** -0.5), ("out.bias", (1,), 0.02)]
    return out


def trainable(names) -> list:
    return [n for n in names if not n.startswith(BACKBONE)]


@torch.no_grad()
def frozen_inputs(cfg: dict, p: dict, feats: torch.Tensor,
                  wids: torch.Tensor, prec: common.Precision):
    """The backbone's constants for a batch: the question encoding and
    the fused embedding of every candidate, each stored at ``prec``, and
    the answer distribution of the K neighbours -> (q (B, Dq), z (B, K+1,
    dmm), probs (B*K, A))."""
    fu = cfg["model"]["fusion"]
    rank, dmm = fu["R"], fu["dim_mm"]
    batch, k1, dim_v = feats.shape
    q = common.skipthoughts(p, BACKBONE + "seq2vec.", wids, prec)
    hv = common.mutan_v(p, BACKBONE + "fusion.", feats.reshape(-1, dim_v),
                        rank, dmm, prec).reshape(batch, k1, rank, dmm)
    hq = common.mutan_q(p, BACKBONE + "fusion.", q, rank, dmm, prec)
    z = prec.q((hv * hq[:, None]).sum(dim=2))
    logits = (prec.mm(z[:, 1:].reshape(-1, dmm),
                      p[BACKBONE + "linear_classif.weight"].t())
              + p[BACKBONE + "linear_classif.bias"])
    return prec.q(q), z, torch.softmax(logits, dim=-1)


def scores(cfg: dict, p: dict, feats: torch.Tensor, q: torch.Tensor,
           z: torch.Tensor, probs: torch.Tensor, aids: torch.Tensor,
           prec: common.Precision, gen: torch.Generator | None
           ) -> torch.Tensor:
    """(B, K) scores from the explicit concat; ``gen`` draws the two
    dropout masks (None: eval)."""
    cx = cfg["cx_model"]
    batch, k1, dim_v = feats.shape
    k = k1 - 1
    table = p["answer_embedding.weight"]
    v_orig, v_knn = feats[:, 0], feats[:, 1:]
    dist = torch.nn.functional.pairwise_distance(
        v_orig[:, None].expand_as(v_knn).reshape(-1, dim_v),
        v_knn.reshape(-1, dim_v), eps=1e-6).reshape(batch, k, 1)
    rank = torch.eye(k, device=feats.device)[None].expand(batch, k, k)

    def tile(x):
        return x[:, None, :].expand(batch, k, x.shape[-1])

    a_other = prec.mm(probs, table).reshape(batch, k, -1)
    x = torch.cat([tile(v_orig), v_knn, v_orig[:, None] * v_knn, dist, rank,
                   tile(q), tile(z[:, 0]), z[:, 1:], tile(table[aids.long()]),
                   a_other], dim=-1)
    h = x.reshape(batch * k, -1)
    for i in range(1, cx["n_layers"] + 1):
        h = torch.relu(prec.mm(h, p["linear_%d.weight" % i].t())
                       + p["linear_%d.bias" % i])
        h = common.dropout(h.reshape(batch, k, -1), cx["drop_p"],
                           gen).reshape(batch * k, -1)
    return (prec.mm(h, p["out.weight"].t()) + p["out.bias"]).reshape(
        batch, k)


def train_steps(cfg: dict, weights: dict, data: dict, order: np.ndarray,
                batch: int, n_steps: int, seed: int,
                prec: common.Precision, device) -> dict:
    """The first ``n_steps`` train steps on the batches ``order`` gives ->
    each step's loss, each trained leaf's gradient at step 1 (and its norm)
    and the norm of each trained leaf's change after the last step."""
    common.no_tf32()
    names = trainable(weights)
    frozen = {k: v.detach().to(device).float() for k, v in weights.items()
              if k not in names}
    p = {k: weights[k].detach().to(device).float().clone().requires_grad_(
        True) for k in names}
    start = {k: v.detach().clone() for k, v in p.items()}
    opt = common.Adam(p, cfg["optim"]["lr"])
    features = data["features"]
    losses, grads = [], None
    for s in range(n_steps):
        idx = order[s * batch:(s + 1) * batch]
        img = torch.from_numpy(data["image_idxs"][idx].astype(np.int64))
        feats = prec.q(features[img.to(features.device)].to(device).float())
        wids = torch.from_numpy(data["question_wids"][idx]).to(device)
        aids = torch.from_numpy(data["answer_aids"][idx]).to(device)
        comp = torch.from_numpy(data["comp_idxs"][idx]).to(device)
        q, z, probs = frozen_inputs(cfg, frozen, feats, wids, prec)
        gen = common.generator(seed, s, "dropout", device)
        out = scores(cfg, {**frozen, **p}, feats, q, z, probs, aids, prec,
                     gen)
        loss = common.cross_entropy(out, comp).mean()
        loss.backward()
        if s == 0:
            grads = {k: v.grad.detach().clone() for k, v in p.items()}
        losses.append(float(loss.detach()))
        opt.step()
    change = common.leaf_norms({k: p[k].detach() - start[k] for k in p})
    return {"losses": losses, "grads": grads,
            "grad_norms": common.leaf_norms(grads), "change_norms": change}
