"""engines: the host's CUDA-runtime calls that put work on the card
(kernel launches, graph launches, copies and sets) per eval batch, from
the traced window's CPU events."""


def read(view):
    if view.window["kind"] != "eval" or not view.trace.steps:
        return None
    return view.trace.host_launches / view.trace.steps
