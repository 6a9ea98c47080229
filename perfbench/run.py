"""One run of one benchmark cell of ``vqa_counterexamples_tpu_torch`` on
the card(s) of this machine.

    python3 perfbench/run.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

The cell is ``perfbench/workloads/<cell>.json``; it names its
configuration (``perfbench/configs/``), its traffic mix
(``perfbench/traffic/``) and, through the mix, the job that drives the
port (``perfbench/jobs/``).  The run makes its inputs and weights from
``--seed``, builds the port's objects on the card, warms up every shape the
window uses (set-up), measures for ``--seconds``, checks what the timed
path produced against the plain reference (``perfbench/reference/``),
and prints one JSON line last on standard output.  ``--trace 1`` runs a
shorter window under ``torch.profiler`` and reports the per-layer metrics
(``perfbench/metrics/``) instead of the end-to-end ones.

With no card, too few cards, JAX loaded, or the port missing, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import os
import sys
import time

_WALL0 = time.time()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    from perfbench.harness import runner

    return runner.main(argv, wall0=_WALL0)


if __name__ == "__main__":
    sys.exit(main())
