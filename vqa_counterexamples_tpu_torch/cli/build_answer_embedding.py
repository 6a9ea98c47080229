"""Answer-embedding table builder CLI (port of
``cli/build_answer_embedding.py``; reference ``answer_embedding.ipynb``).

For each answer of the vocab whose words are all in the question vocab
("good answers", notebook cells 24-29), encode its word-id sequence with
the pretrained skip-thoughts question encoder of the VQA checkpoint under
``--dir_logs``; every other row is zero.  The (nans, dim) table, dim the
encoder's output width (2400 for skip-thoughts), is saved as
``answer_embedding.pickle``: the pretrained init of NeuralCX's answer
embedding (cx.py:240-243) and SemanticBaseline's similarity matrix
(cx.py:173-175)::

    python -m vqa_counterexamples_tpu_torch.cli.build_answer_embedding \\
        --path_opt configs/vqa2/mutan_noatt_train.yaml \\
        --path_processed <processed dir> \\
        --dir_logs logs/vqa2/mutan_noatt_train --out data/cx/answer_embedding.pickle

The answers go through the encoder in batches of 128 (the GRU forward
kernel on a card under the bf16 policy).  The device is ``cuda``; with no
card visible the CLI refuses to run unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np
import torch


def build_table(encode_fn, vocab_answers, word_to_wid, maxlength=26,
                pad="right", dim=2400, batch_size=128):
    """encode_fn: (B, maxlength) int32 -> (B, dim); the last batch is
    padded with all-padding rows to ``batch_size``."""
    n = len(vocab_answers)
    table = np.zeros((n, dim), dtype=np.float32)
    rows, wid_batches = [], []
    for aid, ans in enumerate(vocab_answers):
        words = ans.split()
        if not words or not all(w in word_to_wid for w in words):
            continue
        wids = [word_to_wid[w] for w in words][:maxlength]
        enc = np.zeros((maxlength,), dtype=np.int32)
        if pad == "right":
            enc[:len(wids)] = wids
        else:
            enc[maxlength - len(wids):] = wids
        rows.append(aid)
        wid_batches.append(enc)
    print("%d/%d answers coverable by the question vocab" % (len(rows), n))
    for start in range(0, len(rows), batch_size):
        chunk = np.stack(wid_batches[start:start + batch_size])
        pad_rows = batch_size - chunk.shape[0]
        if pad_rows:
            chunk = np.concatenate(
                [chunk, np.zeros((pad_rows, maxlength), np.int32)])
        out = np.asarray(encode_fn(chunk))
        if pad_rows:
            out = out[:-pad_rows]
        table[rows[start:start + batch_size]] = out
    return table


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--path_opt",
                        default="configs/vqa2/mutan_noatt_train.yaml")
    parser.add_argument("--path_processed", required=True, type=str,
                        help="processed dir with vocab pickles")
    parser.add_argument("--dir_logs", default=None, type=str,
                        help="VQA checkpoint to take seq2vec params from")
    parser.add_argument("--out", default=None, type=str)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda; cpu must be asked "
                             "for)")
    args = parser.parse_args(argv)

    from ..core import checkpoint as ckpt_lib
    from ..core import config as config_lib
    from ..data.factory import load_vocabs
    from ..engines import vqa_engine
    from ..models import factory
    from .counterexamples import resolve_device

    device = resolve_device(args.device)
    options = config_lib.resolve_options({}, args.path_opt, {})
    vocab_words, vocab_answers = load_vocabs(args.path_processed)
    word_to_wid = {w: i + 1 for i, w in enumerate(vocab_words)}

    model = factory.factory_vqa(options["model"], vocab_words, vocab_answers)
    vqa_engine.init_vqa_params(model, seed=0)
    model.to(device).eval()
    if args.dir_logs and ckpt_lib.load_vqa_model(
            model, os.path.join(args.dir_logs, "best")):
        print("Loaded seq2vec from VQA checkpoint", args.dir_logs)

    @torch.no_grad()
    def encode(wids):
        out = model.encode_question(torch.from_numpy(wids).to(device))
        return out.float().cpu().numpy()

    # the table's width is the encoder's output width (2400 for the
    # skip-thoughts encoder; whatever dim_q the configured model emits)
    table = build_table(encode, vocab_answers, word_to_wid,
                        maxlength=options["vqa"]["maxlength"],
                        dim=model.seq2vec.gru_cell.hidden_size,
                        pad=options["vqa"].get("pad", "right"))
    out = args.out or os.path.join(args.path_processed,
                                   "answer_embedding.pickle")
    with open(out, "wb") as f:
        pickle.dump(table, f)
    print("Saved answer embedding table %s to %s" % (table.shape, out))
    return table


if __name__ == "__main__":
    main()
