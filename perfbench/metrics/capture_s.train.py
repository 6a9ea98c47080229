"""engines: host seconds the program spent capturing CUDA graphs over the
whole run (set-up and window): its ``engine.capture_s`` counter
(``core/spans`` of the port), a warm-up and a capture each.  Printed on
standard error: the captures in all (``engine.captures``), those inside the
traced window (its ``engine.capture`` spans: recaptures), and the kernel
counters (``kernels.builds``, ``kernels.build_s``, ``kernels.loads``).
None where the program keeps no such counter."""

import sys


def read(view):
    if view.window["kind"] != "train":
        return None
    try:
        from vqa_counterexamples_tpu_torch.core import spans
    except ImportError:
        return None
    counters = spans.counters()
    if "engine.capture_s" not in counters:
        return None
    in_window = sum(1 for r in spans.records() if r[0] == "engine.capture")
    total = counters.get("engine.captures", 0)
    print("capture_s.train: %d captures, %d in set-up, %d in the window; "
          "%.3f s; kernels: %s"
          % (total, total - in_window, in_window,
             counters["engine.capture_s"],
             {k: counters.get(k, 0) for k in (
                 "kernels.builds", "kernels.build_s", "kernels.loads")}),
          file=sys.stderr)
    return counters["engine.capture_s"]
