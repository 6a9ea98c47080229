"""Dataset preprocessing CLI (port of ``cli/preprocess.py``): raw ->
interim -> processed.

The reference's standalone builder scripts (``vqa/datasets/{vqa_interim,
vqa2_interim,vqa_processed,vgenome_interim}.py`` __main__ blocks) as
subcommands::

    python -m vqa_counterexamples_tpu_torch.cli.preprocess interim \\
        --dir_vqa data/vqa2
    python -m vqa_counterexamples_tpu_torch.cli.preprocess processed \\
        --dirname data/vqa2 --nans 2000 --maxlength 26 --minwcount 0 \\
        --nlp mcb --pad right

The raw files must be on disk (``{dir_vqa}/raw/annotations``): the JAX
CLI's ``download`` subcommand is not ported (ROADMAP.md, Queue 1 #7).
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_int = sub.add_parser("interim", help="flatten official VQA jsons")
    p_int.add_argument("--dir_vqa", default="data/vqa2", type=str)
    p_int.add_argument("--version", type=int, default=2, choices=[1, 2])

    p_proc = sub.add_parser("processed", help="vocabs + encodings")
    p_proc.add_argument("--dirname", default="data/vqa2", type=str)
    p_proc.add_argument("--trainsplit", default="train",
                        choices=["train", "trainval"])
    p_proc.add_argument("--nans", default=2000, type=int)
    p_proc.add_argument("--maxlength", default=26, type=int)
    p_proc.add_argument("--minwcount", default=0, type=int)
    p_proc.add_argument("--nlp", default="mcb",
                        choices=["mcb", "nltk", "naive"])
    p_proc.add_argument("--pad", default="left", choices=["left", "right"])

    p_vg = sub.add_parser("vgenome-interim", help="Visual Genome QA rows")
    p_vg.add_argument("--dir_vg", default="data/vgenome", type=str)

    args = parser.parse_args(argv)
    from ..data import interim as interim_mod
    from ..data import processed as processed_mod

    if args.cmd == "interim":
        interim_mod.vqa_interim(args.dir_vqa, version=args.version)
    elif args.cmd == "processed":
        paths = processed_mod.vqa_processed({
            "dir": args.dirname, "trainsplit": args.trainsplit,
            "nans": args.nans, "maxlength": args.maxlength,
            "minwcount": args.minwcount, "nlp": args.nlp, "pad": args.pad})
        print("Wrote:", "\n  ".join(sorted(paths.values())))
    else:
        interim_mod.vgenome_interim(args.dir_vg)


if __name__ == "__main__":
    main()
