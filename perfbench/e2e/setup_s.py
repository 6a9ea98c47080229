"""Seconds from the process's start to the window's start: imports, the
data and weights made from the seed, the port's model, caches and tables,
the kernels' builds, the captures and the warm-up steps."""


def read(window: dict):
    return window["setup_s"]
