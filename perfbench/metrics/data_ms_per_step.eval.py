"""data: host milliseconds an eval batch waits on the loader, the
benchmark's ``data`` span around each ``next()`` of the loader it hands to
``validate``, from the traced window's ranges."""


def read(view):
    if view.window["kind"] != "eval":
        return None
    spans = view.trace.labels.get("data", [])
    if not spans:
        return None
    return sum(e - s for s, e in spans) / len(spans) / 1e3
