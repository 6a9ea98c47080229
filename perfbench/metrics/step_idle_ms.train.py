"""engines: device idle milliseconds a train step that fall inside the
program's ``engine.step`` spans (``core/spans`` of the port): the window's
device gaps, recomputed from the traced kernels as ``Trace.idle_gaps``
does, each counted whole where its midpoint lies inside an ``engine.step``,
over the window's steps.

The kernels and the benchmark's labels are on the profiler's clock
(microseconds from its start), the program's spans on
``time.perf_counter_ns()``.  Each of the benchmark's ``step`` labels holds
one ``engine.step``: the offset between the clocks is the median of the
differences of their starts, in order, so a span reads early by the median
lag from a label's start to its span's (a few microseconds of Python).
The pairing's spread (the distance between the quartiles of those
differences) is printed; None where the counts differ or the spread
exceeds ``MAX_SPREAD_US``.  Printed too: every gap's seconds by the
innermost program span open at its midpoint (``none`` outside them),
beside the benchmark's own split by label in the result's ``breakdown``."""

import statistics
import sys

MAX_SPREAD_US = 20.0


def device_gaps(trace) -> list:
    """(start, end) of each device gap inside the window, microseconds on
    the profiler's clock."""
    gaps, end = [], trace.span[0]
    for s, e in sorted((s, e) for _, s, e in trace.kernels):
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if trace.span[1] > end:
        gaps.append((end, trace.span[1]))
    return gaps


def clock_offset(label_starts_us, span_starts_ns):
    """(offset, spread) in microseconds: a span at ``t`` ns sits at ``t /
    1e3 + offset`` on the profiler's clock; None where the counts differ."""
    if not span_starts_ns or len(label_starts_us) != len(span_starts_ns):
        return None
    diffs = [a - s / 1e3 for a, s in zip(sorted(label_starts_us),
                                         sorted(span_starts_ns))]
    if len(diffs) < 2:
        return diffs[0], 0.0
    q1, _, q3 = statistics.quantiles(diffs, n=4)
    return statistics.median(diffs), q3 - q1


def innermost(spans_us, points) -> list:
    """For each of ``points`` (ascending), the names of the spans open
    there, outermost first; ``spans_us`` (start, end, name) sorted by
    start."""
    out, active, j = [], [], 0
    for t in points:
        while j < len(spans_us) and spans_us[j][0] <= t:
            active.append(spans_us[j])
            j += 1
        active = [sp for sp in active if sp[1] >= t]
        out.append([sp[2] for sp in active])
    return out


def read(view, kind="train"):
    if view.window["kind"] != kind:
        return None
    try:
        from vqa_counterexamples_tpu_torch.core import spans
    except ImportError:
        return None
    recs = spans.records()
    starts = [r[3] for r in recs if r[0] == "engine.step"]
    labels = [s for s, _ in view.trace.labels.get("step", ())]
    aligned = clock_offset(labels, starts)
    tag = "step_idle_ms.%s" % kind
    if aligned is None:
        print("%s: %d step labels, %d engine.step spans: no pairing"
              % (tag, len(labels), len(starts)), file=sys.stderr)
        return None
    offset, spread = aligned
    print("%s: %d pairs, clock offset %.3f us, spread %.3f us"
          % (tag, len(starts), offset, spread), file=sys.stderr)
    if spread > MAX_SPREAD_US:
        return None
    on_trace = sorted((r[3] / 1e3 + offset, r[4] / 1e3 + offset, r[0])
                      for r in recs)
    gaps = device_gaps(view.trace)
    open_at = innermost(on_trace, [(s + e) / 2 for s, e in gaps])
    by, in_step = {}, 0.0
    for (s, e), names in zip(gaps, open_at):
        name = names[-1] if names else "none"
        by[name] = by.get(name, 0.0) + (e - s) / 1e6
        if "engine.step" in names:
            in_step += e - s
    print("%s: idle s by innermost program span %s"
          % (tag, sorted(([k, v] for k, v in by.items()),
                         key=lambda kv: -kv[1])), file=sys.stderr)
    return in_step / 1e3 / len(starts)
