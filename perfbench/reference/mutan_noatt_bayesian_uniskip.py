"""Plain reference of MUTAN without attention over BayesianUniSkip
(arXiv:1705.06676; the reference code's ``options/vqa2/
mutan_noatt_train.yaml``), in float32 with TF32 off, or in float8 for the
control (``common.Precision``).

Forward: question -> embedding (620) -> GRU (2400) with six variational
masks in training -> the state at the last word; image (2048) and question
each through dropout, a Linear and tanh (360); MUTAN: sum over R = 10 of the
Hadamard products of the two sides' rank projections (360); dropout; the
answer classifier (2000).  Loss: the mean cross-entropy.  Update: Adam.
Dropout masks come from the step's generator in the order input-side GRU
mask, state-side GRU mask, image, question, classifier.

Parameter names are the reference checkpoint's (``seq2vec.*``,
``fusion.*``, ``linear_classif.*``).
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import common

# the weight of the last layer
HEAD = "linear_classif.weight"


def param_specs(cfg: dict, prefix: str = "") -> list:
    """(name, shape, std) of every parameter: weights N(0, 1/fan_in),
    the GRU's N(0, 1/(3H)) (the variance of U(+-1/sqrt(H))), the
    embedding N(0, 0.02^2), biases N(0, 0.02^2)."""
    m = cfg["model"]
    st, fu = m["seq2vec"], m["fusion"]
    emb, hid = st.get("emb_size", 620), st.get("hidden_size", 2400)
    rank, dmm = fu["R"], fu["dim_mm"]
    n_words, nans = cfg["n_words"], cfg["nans"]
    out = [(prefix + "seq2vec.embedding.weight", (n_words + 1, emb), 0.02)]
    g = (3 * hid) ** -0.5
    out += [(prefix + "seq2vec.gru_cell.weight_ih", (3 * hid, emb), g),
            (prefix + "seq2vec.gru_cell.weight_hh", (3 * hid, hid), g),
            (prefix + "seq2vec.gru_cell.bias_ih", (3 * hid,), 0.02),
            (prefix + "seq2vec.gru_cell.bias_hh", (3 * hid,), 0.02)]

    def linear(name, d_in, d_out):
        return [(prefix + name + ".weight", (d_out, d_in), d_in ** -0.5),
                (prefix + name + ".bias", (d_out,), 0.02)]

    out += linear("fusion.linear_v", fu["dim_v"], fu["dim_hv"])
    out += linear("fusion.linear_q", fu["dim_q"], fu["dim_hq"])
    for r in range(rank):
        out += linear("fusion.list_linear_hv.%d" % r, fu["dim_hv"], dmm)
    for r in range(rank):
        out += linear("fusion.list_linear_hq.%d" % r, fu["dim_hq"], dmm)
    out += linear("linear_classif", dmm, nans)
    return out


def logits(p: dict, cfg: dict, visual: torch.Tensor, wids: torch.Tensor,
           prec: common.Precision, gen: torch.Generator | None = None,
           prefix: str = "") -> torch.Tensor:
    """(B, 2048) features, (B, T) word ids -> (B, A) f32 logits; ``gen``
    draws the training masks (None: eval)."""
    m = cfg["model"]
    fu = m["fusion"]
    q = common.skipthoughts(p, prefix + "seq2vec.", wids, prec, gen,
                            m["seq2vec"].get("dropout", 0.25))
    hv = common.mutan_v(p, prefix + "fusion.", visual.float(),
                        fu["R"], fu["dim_mm"], prec, gen,
                        fu.get("dropout_v", 0.0))
    hq = common.mutan_q(p, prefix + "fusion.", q, fu["R"], fu["dim_mm"],
                        prec, gen, fu.get("dropout_q", 0.0))
    z = (hv * hq).sum(dim=1)
    z = common.dropout(z, m["classif"].get("dropout", 0.0), gen)
    return (prec.mm(z, p[prefix + "linear_classif.weight"].t())
            + p[prefix + "linear_classif.bias"])


def sample_answers(data: dict, order: np.ndarray, batch: int, n_steps: int,
                   rng: np.random.Generator) -> list:
    """The loader's draws: for each of the first ``n_steps`` batches of
    ``order``, each example's answer drawn from its human answers weighted
    by count, with ``rng`` (already past the shuffle), in batch order."""
    out = []
    for s in range(n_steps):
        idx = order[s * batch:(s + 1) * batch]
        ans = np.empty(len(idx), np.int64)
        for j, i in enumerate(idx):
            k = int(data["ans_k"][i])
            p = np.asarray(data["ans_counts"][i, :k], np.float64)
            ans[j] = rng.choice(np.asarray(data["ans_aids"][i, :k], np.int32),
                                p=p / p.sum())
        out.append(ans)
    return out


def train_steps(cfg: dict, weights: dict, data: dict, order: np.ndarray,
                answers: list, seed: int, prec: common.Precision,
                device) -> dict:
    """The first ``len(answers)`` train steps from ``weights`` on the
    batches ``order`` gives -> each step's loss, each leaf's gradient at step 1
    (and its norm) and the norm of each leaf's change after the last step."""
    common.no_tf32()
    p = {k: v.detach().to(device).float().clone().requires_grad_(True)
         for k, v in weights.items()}
    start = {k: v.detach().clone() for k, v in p.items()}
    opt = common.Adam(p, cfg["optim"]["lr"])
    feats = data["features"]
    losses, grads = [], None
    start_row = 0
    for s, ans in enumerate(answers):
        idx = order[start_row:start_row + len(ans)]
        start_row += len(ans)
        rows = torch.from_numpy(data["image_rows"][idx].astype(np.int64))
        visual = feats[rows.to(feats.device)].to(device).float()
        wids = torch.from_numpy(data["question_wids"][idx]).to(device)
        gen = common.generator(seed, s, "dropout", device)
        out = logits(p, cfg, visual, wids, prec, gen)
        loss = common.cross_entropy(out, torch.from_numpy(ans).to(device)
                                    ).mean()
        loss.backward()
        if s == 0:
            grads = {k: v.grad.detach().clone() for k, v in p.items()}
        losses.append(float(loss.detach()))
        opt.step()
    change = common.leaf_norms({k: p[k].detach() - start[k] for k in p})
    return {"losses": losses, "grads": grads,
            "grad_norms": common.leaf_norms(grads), "change_norms": change}


@torch.no_grad()
def eval_logits(cfg: dict, weights: dict, visual: torch.Tensor,
                wids: torch.Tensor, prec: common.Precision,
                block: int = 1024) -> torch.Tensor:
    """Eval-mode logits of rows, ``block`` at a time."""
    common.no_tf32()
    p = {k: v.float() for k, v in weights.items()}
    out = []
    for s in range(0, wids.shape[0], block):
        out.append(logits(p, cfg, visual[s:s + block], wids[s:s + block],
                          prec))
    return torch.cat(out)
