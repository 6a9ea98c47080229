"""data: host milliseconds the program's loader takes to assemble an eval
batch: the mean of its ``data.batch`` spans in the traced window, as
``loader_ms_per_step.train`` reads them."""

import importlib.util
import os


def read(view):
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "loader_ms_per_step.train.py")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metrics_loader_ms_per_step_train", path)
    train = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(train)
    return train.read(view, kind="eval")
