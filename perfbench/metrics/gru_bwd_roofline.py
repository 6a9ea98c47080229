"""kernels: the GRU's reverse sweep (3b's own launches,
``gru_bwd_step_kernel``): the sweep's roofline bound over a padded batch
(``perfbench/counts/kernels.py``: B x (T - 1) back products, B x T
positions read and written) times the traced window's train steps, over
the summed device time of those launches, in %.  The dW product that
follows the sweep is a library GEMM and is in neither sum.  None where no
launch ran."""


def read(view):
    if view.window["kind"] != "train":
        return None
    spent = view.trace.kernel_times_s(("gru_bwd_step_kernel",))
    if spent <= 0:
        return None
    k, shapes = view.kernels, view.shapes
    batch, seq_len = shapes["batch"], shapes["seq_len"]
    hidden = view.config["model"]["seq2vec"]["hidden_size"]
    sweep = k.bound_s(k.gru_bwd_sweep(batch * (seq_len - 1), batch * seq_len,
                                      batch, hidden))
    return 100.0 * sweep * view.window["steps"] / spent
