"""Validation examples completed per second: every example of every eval
batch in the window, over the window's wall time (host clock, ending in a
synchronise).  Eval cells only."""


def read(window: dict):
    if window["kind"] != "eval":
        return None
    return window["examples"] / window["window_s"]
