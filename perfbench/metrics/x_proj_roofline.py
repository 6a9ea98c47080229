"""kernels: the GRU input projection's kernels (``xproj_pack_kernel``,
which forms the bf16 operands, and ``xproj_gemm_fwd_kernel``,
``xproj_gemm_dx_kernel``, ``xproj_gemm_dw_kernel``): the sum of a train
step's three roofline bounds (each the larger of its operations over
989 TFLOP/s and its bytes over 3.35 TB/s; the operations are the
configuration's ``x_proj_fwd`` count and half its ``x_proj_bwd`` each for
dX and dW; the bytes each operand read once and each output written once:
f32 x, the per-gate f32 masks, f32 W and b, the bf16 projection and its
bf16 cotangent, f32 dx, dW and db) times the traced window's train steps,
over the summed device time of those launches, in %.  None where no
launch ran: a program that projects otherwise has no such kernels."""


def read(view):
    if view.window["kind"] != "train":
        return None
    spent = view.trace.kernel_times_s(("xproj_pack_kernel", "xproj_gemm_"))
    if spent <= 0:
        return None
    cfg, shapes, k = view.config, view.shapes, view.kernels
    flops = view.counts.train_step_flops(cfg, shapes)
    seq2vec = cfg["model"]["seq2vec"]
    dim_in, h3 = seq2vec["emb_size"], 3 * seq2vec["hidden_size"]
    batch = shapes["batch"]
    rows = batch * shapes["seq_len"]
    x, masks, w = rows * dim_in * 4, 3 * batch * dim_in * 4, h3 * dim_in * 4
    proj = rows * h3 * 2
    fwd = flops["x_proj_fwd"]
    bwd = flops["x_proj_bwd"] / 2
    bound = (k.bound_s((fwd, x + masks + w + h3 * 4 + proj))
             + k.bound_s((bwd, proj + w + masks + x))
             + k.bound_s((bwd, proj + x + masks + w + h3 * 4)))
    return 100.0 * bound * view.window["steps"] / spent
