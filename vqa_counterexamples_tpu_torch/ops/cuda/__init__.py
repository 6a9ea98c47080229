"""Hand-written CUDA kernels (csrc/) with their build, bindings and plain
PyTorch versions."""


def launch_counters() -> dict:
    """Every kernel wrapper by name, each counting the launches of its
    kernel in ``.launches``."""
    from . import (attmutan_kernel, gru_kernel, knn_kernel, mixture_kernel,
                   mutan_kernel, vfeat_kernel, xproj_kernel)

    return {"gru": gru_kernel.gru_recurrence,
            "gru_pg": gru_kernel.gru_recurrence_pg,
            "gru_bwd": gru_kernel.gru_recurrence_bwd,
            "vfeat": vfeat_kernel.vfeat_scores,
            "vfeat_bwd": vfeat_kernel.vfeat_weight_grads,
            "mixture": mixture_kernel.classify_softmax,
            "mutan": mutan_kernel.tucker_fusion,
            "attmutan": attmutan_kernel.folded_mutan,
            "attmutan_bwd": attmutan_kernel.folded_mutan_bwd,
            "knn": knn_kernel.knn_chunk,
            "xproj": xproj_kernel.x_proj,
            "xproj_dx": xproj_kernel.x_proj_dx,
            "xproj_dw": xproj_kernel.x_proj_dw}
