"""Training examples completed per second: every example of every step
in the window, over the window's wall time (host clock, ending in a
synchronise).  Train cells only."""


def read(window: dict):
    if window["kind"] != "train":
        return None
    return window["examples"] / window["window_s"]
