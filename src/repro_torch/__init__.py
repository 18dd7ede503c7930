"""Stencil Matrixization in PyTorch for NVIDIA Hopper.

A port of the JAX package ``repro`` (which stays the reference): the same
layout module by module, the Pallas TPU kernels rewritten as hand-written
CUDA kernels for ``sm_90a``.  Start from :mod:`repro_torch.api`.
"""
