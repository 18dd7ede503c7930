"""Hopper kernels of the port (CUDA C++ under csrc/) with their plain
PyTorch versions, the gather oracle and the kernel wrappers."""
