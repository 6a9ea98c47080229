"""Hand-written CUDA kernels (csrc/) with their build, bindings and plain
PyTorch versions."""
