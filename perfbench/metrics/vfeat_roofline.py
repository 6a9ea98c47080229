"""kernels: the candidate image-feature kernels (1f ``vfeat_fwd_kernel``,
1b ``vfeat_bwd_kernel``): the sum of their launches' roofline bounds
(``perfbench/counts/kernels.py``: max(operations / 989 TFLOP/s, bytes /
3.35 TB/s) at the step's batch, the configuration's K, dim_v and hidden
width, and the B x (K + 1) table rows a batch reads, at most the table)
over the sum of their device times in the traced window, in %.  None
where no launch ran."""


def read(view):
    tr, cfg, shapes, k = view.trace, view.config, view.shapes, view.kernels
    n_fwd = tr.kernel_count(("vfeat_fwd_kernel",))
    n_bwd = tr.kernel_count(("vfeat_bwd_kernel",))
    spent = tr.kernel_times_s(("vfeat_fwd_kernel", "vfeat_bwd_kernel"))
    if not (n_fwd or n_bwd) or spent <= 0:
        return None
    batch, knn = shapes["batch"], cfg["knn_size"]
    dims = (batch, knn, cfg["model"]["fusion"]["dim_v"],
            cfg["cx_model"]["dim_h"],
            min(shapes["n_images"], batch * (knn + 1)))
    bound = (n_fwd * k.bound_s(k.vfeat_fwd(*dims))
             + n_bwd * k.bound_s(k.vfeat_bwd(*dims)))
    return 100.0 * bound / spent
