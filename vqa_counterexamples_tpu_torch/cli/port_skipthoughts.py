"""Skip-thoughts weight porter (port of ``cli/port_skipthoughts.py``).

Produces the npz layout ``models/seq2vec.load_skipthoughts_npz`` reads
(the JAX package's, array for array):
``embedding`` (V+1, 620), ``w_ih`` (620, 7200), ``b_ih`` (7200,),
``w_hh`` (2400, 7200), ``b_hh`` (7200,) with torch gate order (r, z, n).

Two input modes:

1. ``--dir_st DIR --vocab FILE`` — the *raw* published Cadene/skip-thoughts
   artifacts (the reference's ``dir_st`` download, ``seq2vec.py:80-85`` of
   the reference): ``dictionary.txt`` (~930k words, one per line),
   ``utable.npy``/``btable.npy`` (620-d word vectors, row order =
   dictionary order) and ``uni_skip.npz``/``bi_skip.npz`` (theano GRU
   params ``encoder_{W,U,b,Wx,Ux,bx}``).  The embedding table is adapted to
   the given question vocab exactly like skip-thoughts.torch: row 0 is the
   zero padding vector, vocab word i maps to dictionary row at index i+1,
   out-of-dictionary words fall back to the pretrained ``UNK`` row.  The
   theano GRU weights (gate slices [r, z] in W/U/b plus candidate Wx/Ux/bx)
   are repacked into torch (r, z, n) order with ``b_hh = 0`` (the theano
   formulation has no recurrent candidate bias).

2. ``--src FILE`` — an *already adapted* torch .pth state dict (keys
   embedding.weight, rnn.weight_ih_l0/… or gru_cell.weight_*) or a numpy
   .npz with the same names.
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np
import torch


def convert_state_dict(sd: dict, vocab_size: int | None = None) -> dict:
    def get(*names):
        for n in names:
            if n in sd:
                v = sd[n]
                return v.numpy() if hasattr(v, "numpy") else np.asarray(v)
        raise KeyError(names)

    emb = get("embedding.weight", "embedding")
    w_ih = get("rnn.weight_ih_l0", "gru_cell.weight_ih", "w_ih")
    w_hh = get("rnn.weight_hh_l0", "gru_cell.weight_hh", "w_hh")
    b_ih = get("rnn.bias_ih_l0", "gru_cell.bias_ih", "b_ih")
    b_hh = get("rnn.bias_hh_l0", "gru_cell.bias_hh", "b_hh")
    if w_ih.shape[0] == 3 * w_hh.shape[1] or w_ih.shape[0] > w_ih.shape[1]:
        # torch layout (3H, D) -> ours (D, 3H)
        w_ih = w_ih.T
        w_hh = w_hh.T
    if vocab_size is not None and emb.shape[0] != vocab_size + 1:
        raise ValueError("embedding rows %d != vocab+1 %d"
                         % (emb.shape[0], vocab_size + 1))
    return {"embedding": emb.astype(np.float32),
            "w_ih": w_ih.astype(np.float32),
            "b_ih": b_ih.astype(np.float32),
            "w_hh": w_hh.astype(np.float32),
            "b_hh": b_hh.astype(np.float32)}


def load_vocab(path: str) -> list:
    """Vocab word list: .txt (one word per line), or a pickle holding either
    a word list or a ``wid_to_word`` dict (wids start at 1, as written by
    ``data/processed.py``)."""
    if path.endswith((".pickle", ".pkl")):
        with open(path, "rb") as f:
            obj = pickle.load(f)
        if isinstance(obj, dict):
            return [obj[wid] for wid in sorted(obj)]
        return list(obj)
    with open(path, "r", encoding="utf-8") as f:
        return [line.rstrip("\n") for line in f if line.rstrip("\n")]


def load_dictionary(dir_st: str) -> dict:
    """word -> row index of dictionary.txt (skip-thoughts table order)."""
    with open(os.path.join(dir_st, "dictionary.txt"), encoding="utf-8") as f:
        return {line.rstrip("\n"): i for i, line in enumerate(f)}


def adapt_embedding(table: np.ndarray, dictionary: dict,
                    vocab_words: list) -> np.ndarray:
    """(V+1, 620) question-vocab embedding from the pretrained table.

    Row 0 = zeros (padding id); vocab word i -> row i+1; words missing from
    the skip-thoughts dictionary take the pretrained 'UNK' row (the
    skip-thoughts.torch adaptation the reference relies on via
    ``seq2vec.py:80-85``).
    """
    if "UNK" not in dictionary:
        raise ValueError("skip-thoughts dictionary has no UNK row")
    unk = table[dictionary["UNK"]]
    emb = np.zeros((len(vocab_words) + 1, table.shape[1]), np.float32)
    n_unknown = 0
    for i, word in enumerate(vocab_words):
        row = dictionary.get(word)
        if row is None:
            emb[i + 1] = unk
            n_unknown += 1
        else:
            emb[i + 1] = table[row]
    if n_unknown:
        print("Warning: %d/%d vocab words not in skip-thoughts dictionary, "
              "set to UNK" % (n_unknown, len(vocab_words)))
    return emb


def convert_theano_gru(p: dict) -> dict:
    """theano skip-thoughts GRU -> our (D, 3H) torch-gate-order layout.

    theano packs reset+update gates in encoder_W (D, 2H) / encoder_U (H, 2H)
    / encoder_b (2H,) and the candidate in encoder_Wx/Ux/bx; torch order is
    (r, z, n) so the packed halves concatenate directly.  The theano
    candidate is tanh(x Wx + bx + r * (h Ux)) — no recurrent bias — hence
    b_hh = 0.
    """
    def get(name):
        for k in (name, "encoder_" + name):
            if k in p:
                return np.asarray(p[k], np.float32)
        raise KeyError(name)

    w, wx = get("W"), get("Wx")
    u, ux = get("U"), get("Ux")
    b, bx = get("b"), get("bx")
    dim_h = wx.shape[1]
    if w.shape[1] != 2 * dim_h or u.shape != (dim_h, 2 * dim_h):
        raise ValueError("unexpected theano GRU shapes: W%s U%s Wx%s"
                         % (w.shape, u.shape, wx.shape))
    return {"w_ih": np.concatenate([w, wx], axis=1),
            "b_ih": np.concatenate([b, bx], axis=0),
            "w_hh": np.concatenate([u, ux], axis=1),
            "b_hh": np.zeros((3 * dim_h,), np.float32)}


def adapt_from_cadene(dir_st: str, vocab_words: list,
                      table: str = "utable") -> dict:
    """Raw Cadene artifacts (dictionary.txt + {u,b}table.npy +
    {uni,bi}_skip.npz) -> our adapted npz dict."""
    dictionary = load_dictionary(dir_st)
    emb_table = np.load(os.path.join(dir_st, table + ".npy"),
                        allow_pickle=True, encoding="latin1")
    emb_table = np.asarray(emb_table, np.float32)
    skip_name = "uni_skip.npz" if table == "utable" else "bi_skip.npz"
    rnn = dict(np.load(os.path.join(dir_st, skip_name),
                       allow_pickle=True, encoding="latin1"))
    out = convert_theano_gru(rnn)
    out["embedding"] = adapt_embedding(emb_table, dictionary, vocab_words)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--src", type=str, default=None,
                        help="already-adapted .pth state dict or .npz")
    parser.add_argument("--dir_st", type=str, default=None,
                        help="dir with raw Cadene artifacts (dictionary.txt,"
                             " utable.npy, uni_skip.npz)")
    parser.add_argument("--vocab", type=str, default=None,
                        help="question vocab: .txt one word per line, or a "
                             "wid_to_word/word-list pickle (required with "
                             "--dir_st)")
    parser.add_argument("--table", type=str, default="utable",
                        choices=["utable", "btable"])
    parser.add_argument("--out", required=True, type=str,
                        help="output .npz path")
    parser.add_argument("--vocab_size", type=int, default=None)
    args = parser.parse_args(argv)

    if (args.src is None) == (args.dir_st is None):
        parser.error("exactly one of --src / --dir_st is required")
    if args.dir_st is not None:
        if args.vocab is None:
            parser.error("--dir_st requires --vocab")
        vocab_words = load_vocab(args.vocab)
        out = adapt_from_cadene(args.dir_st, vocab_words, args.table)
        if args.vocab_size is not None and len(vocab_words) != args.vocab_size:
            raise ValueError("vocab has %d words, expected %d"
                             % (len(vocab_words), args.vocab_size))
    else:
        if args.src.endswith(".npz"):
            sd = dict(np.load(args.src))
        else:
            sd = torch.load(args.src, map_location="cpu", weights_only=True)
            if hasattr(sd, "state_dict"):
                sd = sd.state_dict()
        out = convert_state_dict(sd, args.vocab_size)
    np.savez(args.out, **out)
    print("Wrote", args.out,
          {k: v.shape for k, v in out.items()})
    return out


if __name__ == "__main__":
    main()
