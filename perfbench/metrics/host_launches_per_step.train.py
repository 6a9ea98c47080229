"""engines: the host's CUDA-runtime calls that put work on the card
(kernel launches, graph launches, copies and sets) per train step, from
the traced window's CPU events."""


def read(view):
    if view.window["kind"] != "train" or not view.trace.steps:
        return None
    return view.trace.host_launches / view.trace.steps
