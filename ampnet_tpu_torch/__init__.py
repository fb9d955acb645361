"""PyTorch/CUDA port of ampnet_tpu for NVIDIA Hopper (H100).

A package of its own beside the JAX reference: it imports torch, never
jax, and nothing of ``ampnet_tpu``. Hand-written Hopper kernels live in
``ops/hopper/csrc`` and build with nvcc at first use.
"""
