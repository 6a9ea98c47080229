"""Tensor ops: metrics, the GRU scan, the NeuralCX scorer and the CUDA kernels."""
