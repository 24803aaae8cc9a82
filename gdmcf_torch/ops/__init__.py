"""Kernels and tensor ops: block-sparse SpMM (CUDA), top-k, bit packing."""
