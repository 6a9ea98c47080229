"""Hand-written CUDA kernels (csrc/) with their build, bindings and plain
PyTorch versions.  Importing one wrapper module imports all: each declares
its launch counters to ``core/spans``, which then reports every one."""

from . import (attmutan_kernel, gru_kernel, knn_kernel,  # noqa: F401
               mixture_kernel, mutan_kernel, vfeat_kernel, xproj_kernel)
