"""data: host milliseconds the program's loader takes to assemble a train
step's batch: the mean of its ``data.batch`` spans (``core/spans`` of the
port) in the traced window.  In the CX engine a span is a batch's draw and
``vqacx.gather_batch``; in ``VQAArrays.batches`` the answer sampling and
the rows' gather.  None where the program records no such span."""


def read(view, kind="train"):
    if view.window["kind"] != kind:
        return None
    try:
        from vqa_counterexamples_tpu_torch.core import spans
    except ImportError:
        return None
    row = spans.summary(spans.records()).get("data.batch")
    return None if row is None else row["total_ms"] / row["calls"]
