"""engines: host milliseconds of a train step's call into the engine: the
mean of the program's ``engine.step`` spans (``core/spans`` of the port) in
the traced window.  Printed on standard error: each part of the step
(``engine.stage``, ``engine.check``, ``engine.reseed``, ``engine.replay``,
``engine.outputs``, ``engine.eager``, ``engine.capture``) in ms a step,
total and self, the step's own self time, and the mean of the benchmark's
``step`` labels, which hold the steps' calls.  None where the program
records no such span."""

import sys


def read(view, kind="train"):
    if view.window["kind"] != kind:
        return None
    try:
        from vqa_counterexamples_tpu_torch.core import spans
    except ImportError:
        return None
    recs = spans.records()
    rows = spans.summary(recs)
    step = rows.get("engine.step")
    if step is None:
        return None
    n = step["calls"]
    parts = sorted({r[0] for r in recs
                    if r[1] >= 0 and recs[r[1]][0] == "engine.step"})
    labels = view.trace.labels.get("step", ())
    label_ms = (sum(e - s for s, e in labels) / len(labels) / 1e3
                if labels else float("nan"))
    print("host_ms_per_step.%s: engine.step %.4f ms a step over %d calls "
          "(the benchmark's step label %.4f over %d), self %.4f; parts (ms a "
          "step, self): %s"
          % (kind, step["total_ms"] / n, n, label_ms, len(labels),
             step["self_ms"] / n,
             ", ".join("%s %.4f / %.4f (%d calls)"
                       % (p, rows[p]["total_ms"] / n, rows[p]["self_ms"] / n,
                          rows[p]["calls"]) for p in parts)),
          file=sys.stderr)
    return step["total_ms"] / n
