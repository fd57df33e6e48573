"""Compute primitives and the CUDA kernels (with their plain PyTorch versions)."""
