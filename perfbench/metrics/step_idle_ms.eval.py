"""engines: device idle milliseconds an eval batch that fall inside the
program's ``engine.step`` spans, as ``step_idle_ms.train`` reads them (the
same alignment of clocks and split printed)."""

import importlib.util
import os


def read(view):
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "step_idle_ms.train.py")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metrics_step_idle_ms_train", path)
    train = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(train)
    return train.read(view, kind="eval")
