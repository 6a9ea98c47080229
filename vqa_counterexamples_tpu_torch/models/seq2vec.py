"""Question encoder: the skip-thoughts GRU (port of
``models/seq2vec.SkipThoughts``).

Word id 0 is padding: the embedding is masked by ``wids != 0`` and the
sentence vector is the hidden state at the last valid timestep.
Attribute names follow the reference checkpoint (``seq2vec.embedding``,
``seq2vec.gru_cell.weight_ih`` ...), so ``state_dict()`` carries the keys
``models/port_torch.port_seq2vec`` of the JAX package reads.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops import rnn as rnn_ops
from .common import dropout as dropout_fn


class _Embedding(torch.autograd.Function):
    """``F.embedding`` whose backward sums each word's rows in a fixed
    order.  PyTorch's default CUDA ``embedding_dense_backward`` does not:
    two calls on a MutanNoAtt batch's 13,312 word ids and one cotangent
    differ; its deterministic path, taken here, gives the same bits every
    call and under a CUDA graph."""

    @staticmethod
    def forward(ctx, wids, table):
        ctx.save_for_backward(wids)
        ctx.n_rows = table.shape[0]
        return nn.functional.embedding(wids, table)

    @staticmethod
    def backward(ctx, grad):
        (wids,) = ctx.saved_tensors
        was = (torch.are_deterministic_algorithms_enabled(),
               torch.is_deterministic_algorithms_warn_only_enabled())
        torch.use_deterministic_algorithms(True)
        try:
            dtable = torch.ops.aten.embedding_dense_backward(
                grad, wids, ctx.n_rows, -1, False)
        finally:
            torch.use_deterministic_algorithms(was[0], warn_only=was[1])
        return None, dtable


def embedding(wids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` at the int64 ``wids``; the table's gradient sums
    a repeated word's rows in a fixed order (:class:`_Embedding`)."""
    return _Embedding.apply(wids, table)


class SkipThoughts(nn.Module):
    """UniSkip / BayesianUniSkip sentence encoder (620 -> GRU 2400).

    In training, BayesianUniSkip applies variational dropout to the GRU's
    input and state (six independent per-gate masks by default, see
    ``ops/rnn``), UniSkip plain dropout to the word embeddings.  With
    ``fixed_emb`` the embedding table gets no gradient.  In eval both
    flavours are the same GRU.
    """

    def __init__(self, vocab_size: int, emb_size: int = 620,
                 hidden_size: int = 2400, dropout: float = 0.25,
                 fixed_emb: bool = False, bayesian: bool = True):
        super().__init__()
        self.dropout = dropout
        self.fixed_emb = fixed_emb
        self.bayesian = bayesian
        self.embedding = nn.Embedding(vocab_size + 1, emb_size)
        # parameter container only (weight_ih (3H, D), weight_hh (3H, H),
        # gate rows r, z, n); the recurrence is ops/rnn.gru_scan
        self.gru_cell = nn.GRUCell(emb_size, hidden_size)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """JAX initializers: embedding N(0, 0.02), GRU weights
        U(-1/sqrt(H), 1/sqrt(H)), zero biases."""
        self.embedding.weight.normal_(0.0, 0.02, generator=generator)
        s = self.gru_cell.hidden_size ** -0.5
        self.gru_cell.weight_ih.uniform_(-s, s, generator=generator)
        self.gru_cell.weight_hh.uniform_(-s, s, generator=generator)
        self.gru_cell.bias_ih.zero_()
        self.gru_cell.bias_hh.zero_()

    def forward(self, wids: torch.Tensor, training: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        lengths = rnn_ops.process_lengths(wids)
        table = self.embedding.weight
        if self.fixed_emb:
            table = table.detach()
        # an embedding lookup: its backward sums rows per word, where
        # indexing's serialises on the repeated padding and common words
        emb = embedding(wids.long(), table) * (wids != 0)[..., None]
        cell = self.gru_cell
        mask_x = mask_h = None
        if self.bayesian:
            if training and self.dropout > 0.0:
                if generator is None:
                    raise ValueError("training-mode dropout draws its masks "
                                     "from a generator: pass one")
                mask_x, mask_h = rnn_ops.variational_masks(
                    generator, self.dropout, wids.shape[0], emb.shape[-1],
                    cell.hidden_size, per_gate=rnn_ops.per_gate_masks())
        else:
            emb = dropout_fn(emb, self.dropout, generator, training)
        states = rnn_ops.gru_scan(cell.weight_ih, cell.bias_ih,
                                  cell.weight_hh, cell.bias_hh, emb,
                                  mask_x, mask_h)
        return rnn_ops.select_last_tm(states, lengths)


def factory(vocab_words, opt: dict) -> nn.Module:
    """Dispatch of the reference ``seq2vec.factory`` (``seq2vec.py:79-97``):
    only the skip-thoughts encoders are ported."""
    arch = opt["arch"]
    if arch != "skipthoughts":
        raise NotImplementedError(
            "seq2vec arch %r is not ported yet (ROADMAP.md, Queue 1 #9)"
            % arch)
    return SkipThoughts(
        vocab_size=len(vocab_words), emb_size=opt.get("emb_size", 620),
        hidden_size=opt.get("hidden_size", 2400),
        dropout=opt.get("dropout", 0.25),
        fixed_emb=opt.get("fixed_emb", False),
        bayesian=opt.get("type", "BayesianUniSkip").startswith("Bayesian"))


@torch.no_grad()
def load_skipthoughts_npz(encoder: SkipThoughts, path: str) -> None:
    """Load ported skip-thoughts weights (an npz with ``embedding``,
    ``w_ih`` (D, 3H), ``b_ih``, ``w_hh`` (H, 3H), ``b_hh``, the JAX
    package's layout) into ``encoder`` in place; a local file, read with
    numpy."""
    data = np.load(path)
    cell = encoder.gru_cell

    def put(param, array):
        value = torch.from_numpy(np.asarray(array, np.float32))
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError("%s: %s in the file, %s in the model"
                             % (path, tuple(value.shape),
                                tuple(param.shape)))
        param.copy_(value)

    put(encoder.embedding.weight, data["embedding"])
    put(cell.weight_ih, np.asarray(data["w_ih"]).T)
    put(cell.bias_ih, data["b_ih"])
    put(cell.weight_hh, np.asarray(data["w_hh"]).T)
    put(cell.bias_hh, data["b_hh"])
