"""device: the share of the traced window in which no kernel, copy or set
ran on the card (1 - the union of their intervals / the window), in %."""


def read(view):
    if view.window["kind"] != "eval" or view.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - view.trace.busy_s / view.trace.window_s)
