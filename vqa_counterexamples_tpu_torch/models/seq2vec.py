"""Question encoders (port of ``models/seq2vec.py``): the skip-thoughts GRU
(``SkipThoughts``: UniSkip / BayesianUniSkip), ``LSTMEncoder`` and
``TwoLSTM``.

Word id 0 is padding: the embedding is masked by ``wids != 0`` and the
sentence vector is the hidden state at the last valid timestep.
Attribute names follow the reference checkpoint (``seq2vec.embedding``,
``seq2vec.gru_cell.weight_ih``, ``seq2vec.rnn.weight_ih_l0`` for the LSTM,
``seq2vec.rnn_0`` / ``rnn_1`` for TwoLSTM ...), so ``state_dict()`` carries
the keys ``models/port_torch.port_seq2vec`` of the JAX package reads.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops import rnn as rnn_ops
from .common import dropout as dropout_fn
from .fusion import lecun_normal_


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
    arch = "skipthoughts"

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


def _lstm_layer(rnn: nn.LSTM, layer: int):
    """(weight_ih, bias_ih, weight_hh, bias_hh) of one layer of ``rnn``."""
    return tuple(getattr(rnn, "%s_l%d" % (name, layer)) for name in (
        "weight_ih", "bias_ih", "weight_hh", "bias_hh"))


@torch.no_grad()
def _reset_lstm(rnn: nn.LSTM, generator: torch.Generator) -> None:
    """JAX ``lstm_init``: weights U(-1/sqrt(H), 1/sqrt(H)), zero biases."""
    s = rnn.hidden_size ** -0.5
    for layer in range(rnn.num_layers):
        w_ih, b_ih, w_hh, b_hh = _lstm_layer(rnn, layer)
        w_ih.uniform_(-s, s, generator=generator)
        w_hh.uniform_(-s, s, generator=generator)
        b_ih.zero_()
        b_hh.zero_()


class _LSTMBase(nn.Module):
    """The embedding and the LSTM helpers both LSTM encoders share.  The
    ``nn.LSTM`` modules are parameter containers only (``weight_ih_l{k}``
    (4H, D), ``weight_hh_l{k}`` (4H, H), gate rows i, f, g, o); the
    recurrence is ``ops/rnn.lstm_scan``."""

    def __init__(self, vocab_size: int, emb_size: int):
        super().__init__()
        self.embedding = nn.Embedding(vocab_size + 1, emb_size)

    def _embed(self, wids: torch.Tensor) -> torch.Tensor:
        """(B, T) word ids -> time-major (T, B, E) embeddings, padding 0."""
        emb = embedding(wids.long(), self.embedding.weight) \
            * (wids != 0)[..., None]
        return emb.transpose(0, 1)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """JAX initializers: flax ``Embed``'s (truncated normal, variance
        1/E), then each LSTM's, in the order they were added."""
        lecun_normal_(self.embedding.weight, generator)
        for module in self.children():
            if isinstance(module, nn.LSTM):
                _reset_lstm(module, generator)


class LSTMEncoder(_LSTMBase):
    """Reference ``LSTM`` (JAX ``seq2vec.py:30-52``): embed -> an
    ``num_layers`` LSTM, layers chained time-major -> the state at the
    last word."""
    arch = "lstm"

    def __init__(self, vocab_size: int, emb_size: int, hidden_size: int,
                 num_layers: int = 1):
        super().__init__(vocab_size, emb_size)
        self.rnn = nn.LSTM(emb_size, hidden_size, num_layers=num_layers,
                           batch_first=True)

    def forward(self, wids: torch.Tensor, training: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = self._embed(wids)
        for layer in range(self.rnn.num_layers):
            x = rnn_ops.lstm_scan(*_lstm_layer(self.rnn, layer), x)
        return rnn_ops.select_last_tm(x, rnn_ops.process_lengths(wids))


class TwoLSTM(_LSTMBase):
    """Reference ``TwoLSTM`` (JAX ``seq2vec.py:55-80``): embed -> tanh ->
    two stacked LSTMs (``rnn_0``, ``rnn_1``); the last state of each,
    dropout 0.3 on each in training (first ``rnn_0``'s, then ``rnn_1``'s
    mask from ``generator``), concatenated: 2H wide."""
    arch = "2-lstm"

    def __init__(self, vocab_size: int, emb_size: int, hidden_size: int):
        super().__init__(vocab_size, emb_size)
        self.rnn_0 = nn.LSTM(emb_size, hidden_size, batch_first=True)
        self.rnn_1 = nn.LSTM(hidden_size, hidden_size, batch_first=True)

    def forward(self, wids: torch.Tensor, training: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        lengths = rnn_ops.process_lengths(wids)
        x0 = rnn_ops.lstm_scan(*_lstm_layer(self.rnn_0, 0),
                               torch.tanh(self._embed(wids)))
        x1 = rnn_ops.lstm_scan(*_lstm_layer(self.rnn_1, 0), x0)
        vecs = [dropout_fn(rnn_ops.select_last_tm(x, lengths), 0.3,
                           generator, training) for x in (x0, x1)]
        return torch.cat(vecs, dim=1)


def factory(vocab_words, opt: dict) -> nn.Module:
    """Dispatch of the reference ``seq2vec.factory`` (``seq2vec.py:79-97``;
    JAX ``seq2vec.py:127-149``)."""
    arch = opt["arch"]
    if arch == "skipthoughts":
        return SkipThoughts(
            vocab_size=len(vocab_words), emb_size=opt.get("emb_size", 620),
            hidden_size=opt.get("hidden_size", 2400),
            dropout=opt.get("dropout", 0.25),
            fixed_emb=opt.get("fixed_emb", False),
            bayesian=opt.get("type", "BayesianUniSkip").startswith(
                "Bayesian"))
    if arch == "2-lstm":
        return TwoLSTM(len(vocab_words), opt["emb_size"], opt["hidden_size"])
    if arch == "lstm":
        return LSTMEncoder(len(vocab_words), opt["emb_size"],
                           opt["hidden_size"], opt.get("num_layers", 1))
    raise NotImplementedError(arch)


def output_dim(opt: dict) -> int:
    """Width of the sentence vector of the encoder ``opt`` selects."""
    arch = opt["arch"]
    if arch == "skipthoughts":
        return opt.get("hidden_size", 2400)
    if arch == "2-lstm":
        return 2 * opt["hidden_size"]
    if arch == "lstm":
        return opt["hidden_size"]
    raise NotImplementedError(arch)


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
