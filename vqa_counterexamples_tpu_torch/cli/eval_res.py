"""OpenEnded result scoring CLI (port of ``cli/eval_res.py``; reference
``eval_res.py`` without python2).

Scores a results JSON ([{'question_id', 'answer'}, ...]) against the
official annotations with ``engines/openended.py`` and writes
``*_accuracy.json`` next to it::

    python -m vqa_counterexamples_tpu_torch.cli.eval_res \\
        --path_results <results.json> \\
        --path_annotations data/vqa2/raw/annotations/v2_mscoco_val2014_annotations.json
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--path_results", required=True, type=str)
    parser.add_argument("--path_annotations", required=True, type=str,
                        help="official v2_mscoco_*_annotations.json")
    args = parser.parse_args(argv)

    from ..engines import openended

    with open(args.path_results) as f:
        results = json.load(f)
    with open(args.path_annotations) as f:
        ann = json.load(f)
    annotations = openended.annotations_from_vqa_json(ann)
    scores = openended.evaluate(results, annotations)
    out = os.path.splitext(args.path_results)[0] + "_accuracy.json"
    with open(out, "w") as f:
        json.dump(scores, f)
    print("OpenEnded accuracy: %.2f (n=%d) -> %s"
          % (scores["overall"], scores["n"], out))
    return scores


if __name__ == "__main__":
    main()
