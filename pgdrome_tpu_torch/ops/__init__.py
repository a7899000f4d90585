"""Numerical kernels (counterpart of ``pgdrome_tpu/ops``): the fused sweep,
hand-written in CUDA for Hopper, with its plain PyTorch version; the
double-f32 compensated arithmetic of the rhs contraction (:mod:`.ddf32`,
plain elementwise ``torch``); and the per-dim solvers (:mod:`.solvers`:
host Newton and Picard, Newton on the device)."""
