"""engines: host seconds the program spent building its frozen q / v / z
cache tables in set-up (``cx_engine.build_frozen_caches``, each stage
synchronised): the sum of its ``cx.cache_build_s.*`` counters
(``core/spans`` of the port), each printed on standard error.  None where
the program keeps no such counter."""

import sys


def read(view):
    try:
        from vqa_counterexamples_tpu_torch.core import spans
    except ImportError:
        return None
    stages = {k: v for k, v in spans.counters().items()
              if k.startswith("cx.cache_build_s.")}
    if not stages:
        return None
    print("cache_build_s: %s" % stages, file=sys.stderr)
    return sum(stages.values())
