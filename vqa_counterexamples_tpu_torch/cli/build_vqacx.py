"""VQA-CX dataset builder CLI (port of ``cli/build_vqacx.py``).

The reference's notebook pipeline (vqacx_{train,val}set_builder.ipynb):
join the processed VQA2 examples with the complementary-pairs JSON and the
24-NN JSON, attach comp / knns, and write the dataset dicts the CX CLI
reads ({train,val}set_augmented.pickle, and the small dev subsets: train
cell 21, val cell 16 after a shuffle with seed 123)::

    python -m vqa_counterexamples_tpu_torch.cli.build_vqacx --split train \\
        --path_processed <processed dir> --path_comp_pairs \\
        data/vqa2/raw/annotations/v2_mscoco_train2014_complementary_pairs.json \\
        --path_knn_json <knn json> --path_features_txt <prefix>.txt \\
        --out_dir data/cx
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import random


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--split", required=True, choices=["train", "val"])
    parser.add_argument("--path_processed", required=True, type=str,
                        help="processed dir with {split}set.pickle + vocabs")
    parser.add_argument("--path_comp_pairs", required=True, type=str)
    parser.add_argument("--path_knn_json", required=True, type=str)
    parser.add_argument("--path_features_txt", required=True, type=str,
                        help="extract-order name list ({prefix}.txt)")
    parser.add_argument("--out_dir", required=True, type=str)
    parser.add_argument("--small_size", type=int, default=None,
                        help="dev subset size (default 1000 train/10000 val)")
    args = parser.parse_args(argv)

    from ..data import vqacx
    from ..data.factory import load_vocabs

    split = args.split
    with open(os.path.join(args.path_processed,
                           "%sset.pickle" % split), "rb") as f:
        examples = pickle.load(f)
    with open(args.path_comp_pairs) as f:
        comp_pairs = json.load(f)
    knns = vqacx.load_knns_json(args.path_knn_json)

    filtered = vqacx.build_augmented_examples(examples, comp_pairs, knns,
                                              split=split)
    print("%d/%d examples kept after the comp x KNN join"
          % (len(filtered), len(examples)))

    vocab_words, vocab_answers = load_vocabs(args.path_processed)
    with open(args.path_features_txt) as f:
        names = [line.strip() for line in f if line.strip()]
    name_to_index = {n: i for i, n in enumerate(names)}

    if split == "val":
        random.Random(123).shuffle(filtered)  # valset builder cell 16
        small = args.small_size or 10000
    else:
        small = args.small_size or 1000

    dataset = vqacx.make_dataset_dict(filtered, name_to_index, vocab_words,
                                      vocab_answers)
    small_ds = vqacx.make_dataset_dict(filtered[:small], name_to_index,
                                       vocab_words, vocab_answers)

    os.makedirs(args.out_dir, exist_ok=True)
    full_path = os.path.join(args.out_dir,
                             "%sset_augmented.pickle" % split)
    small_path = os.path.join(args.out_dir,
                              "%sset_augmented_small.pickle" % split)
    vqacx.save_dataset(dataset, full_path)
    vqacx.save_dataset(small_ds, small_path)
    print("Saved", full_path, "and", small_path)


if __name__ == "__main__":
    main()
