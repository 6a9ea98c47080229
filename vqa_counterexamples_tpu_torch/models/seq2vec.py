"""Question encoder: the skip-thoughts GRU, eval mode (port of
``models/seq2vec.SkipThoughts``).

Word id 0 is padding: the embedding is masked by ``wids != 0`` and the
sentence vector is the hidden state at the last valid timestep.
Attribute names follow the reference checkpoint (``seq2vec.embedding``,
``seq2vec.gru_cell.weight_ih`` ...), so ``state_dict()`` carries the keys
``models/port_torch.port_seq2vec`` of the JAX package reads.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import rnn as rnn_ops


class SkipThoughts(nn.Module):
    """UniSkip / BayesianUniSkip sentence encoder (620 -> GRU 2400).

    The variational dropout of BayesianUniSkip acts only in training, which
    this port does not run yet; in eval both flavours are the same GRU.
    """

    def __init__(self, vocab_size: int, emb_size: int = 620,
                 hidden_size: int = 2400):
        super().__init__()
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

    def forward(self, wids: torch.Tensor) -> torch.Tensor:
        lengths = rnn_ops.process_lengths(wids)
        emb = self.embedding(wids.long()) * (wids != 0)[..., None]
        cell = self.gru_cell
        states = rnn_ops.gru_scan(cell.weight_ih, cell.bias_ih,
                                  cell.weight_hh, cell.bias_hh, emb)
        return rnn_ops.select_last_tm(states, lengths)


def factory(vocab_words, opt: dict) -> nn.Module:
    arch = opt["arch"]
    if arch != "skipthoughts":
        raise NotImplementedError(
            "seq2vec arch %r is not ported yet (ROADMAP.md, Queue 1 #9)"
            % arch)
    return SkipThoughts(vocab_size=len(vocab_words),
                        emb_size=opt.get("emb_size", 620),
                        hidden_size=opt.get("hidden_size", 2400))
