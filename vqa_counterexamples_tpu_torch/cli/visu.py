"""Training-curve dashboard CLI (port of ``cli/visu.py``; reference
``visu.py``).

Single or multi-experiment: pass one or more run dirs (each holding a
``logger.json`` and/or ``{train,val}/events.jsonl``); writes ``view.html``.
``--watch N`` re-renders every N seconds (the reference's auto-refresh loop,
visu.py:185-215).  plotly draws the curves where it imports, else
matplotlib (PNGs inside the HTML)::

    python -m vqa_counterexamples_tpu_torch.cli.visu logs/vqa2/mutan_noatt
"""

from __future__ import annotations

import argparse
import os
import time


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("dir_logs", nargs="+",
                        help="experiment run dir(s)")
    parser.add_argument("--out", default=None, type=str)
    parser.add_argument("--meters", nargs="+",
                        default=["loss", "acc1", "acc5", "recall"])
    parser.add_argument("--watch", type=int, default=0, metavar="SECONDS")
    args = parser.parse_args(argv)

    from ..viz import curves as curves_mod

    out = args.out or os.path.join(args.dir_logs[0], "view.html")

    def render():
        experiments = {os.path.basename(os.path.normpath(d)):
                       curves_mod.load_curves(d) for d in args.dir_logs}
        path = curves_mod.render_html(experiments, out,
                                      meters=tuple(args.meters))
        print("Wrote", path)

    render()
    while args.watch > 0:
        time.sleep(args.watch)
        render()


if __name__ == "__main__":
    main()
