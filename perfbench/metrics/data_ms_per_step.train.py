"""data: host milliseconds a train step waits on the loader, the
benchmark's ``data`` span around each ``next()`` of the loader it hands to
the engine, from the traced window's ranges (the engine's ``data_time``
meter times the same wait and is printed beside it on standard error)."""

import sys


def read(view):
    if view.window["kind"] != "train":
        return None
    spans = view.trace.labels.get("data", [])
    if not spans:
        return None
    ms = sum(e - s for s, e in spans) / len(spans) / 1e3
    extra = view.extra
    if extra.get("engine_data_s") is not None and extra.get("data_n"):
        print("data_ms_per_step: trace %.4f ms, engine data_time %.4f ms, "
              "feed clock %.4f ms over %d batches"
              % (ms, extra["engine_data_s"] / extra["data_n"] * 1e3,
                 extra["data_s"] / extra["data_n"] * 1e3, extra["data_n"]),
              file=sys.stderr)
    return ms
