"""Hopper kernels (CUDA C++ in ../csrc) and their plain PyTorch twins."""
