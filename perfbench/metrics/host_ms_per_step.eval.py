"""engines: host milliseconds of an eval batch's call into the engine: the
mean of the program's ``engine.step`` spans in the traced window, as
``host_ms_per_step.train`` reads them (its parts printed the same way)."""

import importlib.util
import os


def read(view):
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "host_ms_per_step.train.py")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metrics_host_ms_per_step_train", path)
    train = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(train)
    return train.read(view, kind="eval")
