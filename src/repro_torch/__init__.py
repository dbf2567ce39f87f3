"""PyTorch/CUDA port of the DeepFusion reproduction.

A second package beside the JAX reference ``repro``: the same module
layout, the same parameter layout, plain functions on tensors, and
hand-written CUDA kernels for the H100 in place of the Pallas TPU
kernels.  It imports neither ``jax`` nor anything of ``repro``.
"""
