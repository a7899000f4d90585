"""Numerical kernels (counterpart of ``pgdrome_tpu/ops``): the fused sweep,
hand-written in CUDA for Hopper, with its plain PyTorch version."""
