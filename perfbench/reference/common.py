"""Plain PyTorch pieces of the references: the GRU of skip-thoughts, MUTAN,
inverted dropout with the benchmark's draws, Adam, and the precisions the
reference runs in.

Nothing here imports the port.  The dropout masks are inputs both sides
draw alike: the port draws each step's masks from a generator seeded from
(seed, step, name), and ``stream_seed`` / ``keep_mask`` below are a frozen
copy of that scheme (the port's ``core/rng.py`` as of this benchmark), so
the reference draws the same bits on the same device in the same order.

Precision.  ``Precision("f32")`` computes every product in float32 with
TF32 off (the reference).  ``Precision("fp8")`` rounds both operands of
every product, every stored table and the GRU's state at each step to
float8 e4m3 with one scale per tensor (its absolute maximum to 448) and
accumulates in float32: the control, one step below the bfloat16 the
configurations state (where the program rounds the same tensors to
bfloat16).
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

FP8_MAX = 448.0


class Precision:
    def __init__(self, name: str = "f32"):
        if name not in ("f32", "fp8"):
            raise ValueError("precision f32 or fp8, got %r" % name)
        self.name = name

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as stored at this precision (f32 values)."""
        if self.name == "f32":
            return x
        scale = x.detach().abs().amax().float().clamp_min(1e-30) / FP8_MAX
        y = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
        # rounding passes the gradient straight through
        return x + (y - x).detach() if x.requires_grad else y

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.q(a.float()), self.q(b.float()))


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# --- the draws (frozen copy of the port's scheme) -------------------------

def stream_seed(seed: int, step: int, name: str) -> int:
    state = np.random.SeedSequence(
        [int(seed), int(step), zlib.crc32(name.encode())]).generate_state(
            2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def generator(seed: int, step: int, name: str, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, step, name))
    return gen


def keep_mask(shape, keep_prob: float, gen: torch.Generator):
    """(bool mask, scale): 8 random bits per element, kept below
    round(keep_prob * 256)."""
    thresh = int(round(keep_prob * 256))
    bits = torch.randint(0, 256, tuple(shape), generator=gen,
                         device=gen.device, dtype=torch.uint8)
    return bits < thresh, 256.0 / thresh


def dropout(x: torch.Tensor, rate: float, gen: torch.Generator | None):
    if gen is None or rate == 0.0:
        return x
    keep, scale = keep_mask(x.shape, 1.0 - rate, gen)
    return torch.where(keep, x * scale, torch.zeros((), device=x.device))


# --- the model pieces -------------------------------------------------------

def question_lengths(wids: torch.Tensor) -> torch.Tensor:
    """Right-padded word ids (0 = padding) -> the number of words."""
    return wids.shape[1] - (wids == 0).sum(dim=1)


def skipthoughts(p: dict, prefix: str, wids: torch.Tensor, prec: Precision,
                 gen: torch.Generator | None = None,
                 drop: float = 0.25) -> torch.Tensor:
    """BayesianUniSkip: embedding (padding 0 zeroed), a GRU over every
    timestep (gates r, z, n), the state at the last word.  With ``gen``
    (training) six variational masks, one per gate on the input and on
    the state, drawn input first."""
    table = p[prefix + "embedding.weight"]
    emb = table[wids.long()] * (wids != 0)[..., None].float()
    w_ih, b_ih = p[prefix + "gru_cell.weight_ih"], p[prefix + "gru_cell.bias_ih"]
    w_hh, b_hh = p[prefix + "gru_cell.weight_hh"], p[prefix + "gru_cell.bias_hh"]
    batch, seq_len, dim_in = emb.shape
    dim_h = w_hh.shape[1]
    mask_x = mask_h = None
    if gen is not None:
        kx, sx = keep_mask((3, batch, dim_in), 1.0 - drop, gen)
        kh, sh = keep_mask((3, batch, dim_h), 1.0 - drop, gen)
        mask_x, mask_h = kx.float() * sx, kh.float() * sh
    gates = slice(0, dim_h), slice(dim_h, 2 * dim_h), slice(2 * dim_h, 3 * dim_h)
    xp = []
    for g, sl in enumerate(gates):
        x = emb if mask_x is None else emb * mask_x[g][:, None, :]
        xp.append((prec.mm(x.reshape(batch * seq_len, dim_in), w_ih[sl].t())
                   + b_ih[sl]).reshape(batch, seq_len, dim_h))
    h = emb.new_zeros((batch, dim_h))
    states = []
    for t in range(seq_len):
        hp = [prec.mm(h if mask_h is None else h * mask_h[g], w_hh[sl].t())
              + b_hh[sl] for g, sl in enumerate(gates)]
        r = torch.sigmoid(xp[0][:, t] + hp[0])
        z = torch.sigmoid(xp[1][:, t] + hp[1])
        n = torch.tanh(xp[2][:, t] + r * hp[2])
        # the state is carried at the reference's precision (the program
        # carries it in its compute dtype)
        h = prec.q((1.0 - z) * n + z * h)
        states.append(h)
    states = torch.stack(states, dim=1)
    last = (question_lengths(wids).long() - 1).clamp(0, seq_len - 1)
    return states[torch.arange(batch, device=wids.device), last]


def mutan_sides(p: dict, prefix: str, rank: int):
    """Each rank's Linear stacked rank-major: (R*dmm, d) weights."""
    def stack(side):
        w = torch.cat([p["%slist_linear_h%s.%d.weight" % (prefix, side, r)]
                       for r in range(rank)], 0)
        b = torch.cat([p["%slist_linear_h%s.%d.bias" % (prefix, side, r)]
                       for r in range(rank)], 0)
        return w, b
    return stack("v"), stack("q")


def mutan_v(p, prefix, v, rank, dmm, prec, gen=None, drop=0.0):
    """The image side through the rank projections: (N, R, dmm)."""
    x = dropout(v, drop, gen)
    x = torch.tanh(prec.mm(x, p[prefix + "linear_v.weight"].t())
                   + p[prefix + "linear_v.bias"])
    (w, b), _ = mutan_sides(p, prefix, rank)
    return (prec.mm(x, w.t()) + b).reshape(x.shape[0], rank, dmm)


def mutan_q(p, prefix, q, rank, dmm, prec, gen=None, drop=0.0):
    x = dropout(q, drop, gen)
    x = torch.tanh(prec.mm(x, p[prefix + "linear_q.weight"].t())
                   + p[prefix + "linear_q.bias"])
    _, (w, b) = mutan_sides(p, prefix, rank)
    return (prec.mm(x, w.t()) + b).reshape(x.shape[0], rank, dmm)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Per-row negative log-likelihood."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[:, None])[:, 0]


class Adam:
    """torch.optim.Adam's update (betas 0.9 / 0.999, eps 1e-8, bias
    correction), on a dict of leaf tensors updated in place."""

    def __init__(self, params: dict, lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        self.params, self.lr, self.betas, self.eps = params, lr, betas, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self) -> None:
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1.0 - b1 ** self.t, 1.0 - b2 ** self.t
        for k, p in self.params.items():
            if p.grad is None:
                continue
            g = p.grad
            self.m[k].mul_(b1).add_(g, alpha=1.0 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            denom = (self.v[k].sqrt() / c2 ** 0.5).add_(self.eps)
            p.addcdiv_(self.m[k], denom, value=-self.lr / c1)
            p.grad = None


def leaf_norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.detach().double()))
            for k, v in tensors.items()}
