"""device: the window's model operations (``perfbench/counts/<config>.py``:
a train step's forward and backward of the trained parts at the shapes
the job handed the step, nothing recomputed, times the traced window's
steps) over the traced window's wall time, as a share of the card's bf16
peak (989 TFLOP/s), in %."""


def read(view):
    if view.window["kind"] != "train" or not view.trace.steps:
        return None
    per_step = sum(view.counts.train_step_flops(view.config,
                                                view.shapes).values())
    return (100.0 * per_step * view.window["steps"] / view.trace.window_s
            / view.kernels.peaks()["bf16_flops"])
