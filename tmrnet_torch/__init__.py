"""PyTorch/CUDA port of tmrnet_tpu for NVIDIA Hopper (H100).

The JAX package `tmrnet_tpu` is the reference; this package imports nothing
of it. Every Pallas kernel on a ported path has a hand-written Hopper kernel
here (CUDA C++ under `csrc/`), with a plain PyTorch version beside it that
CPU tensors take.
"""
