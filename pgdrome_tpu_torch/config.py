"""Global configuration: dtypes, the device picker and matmul precision.

Counterpart of ``pgdrome_tpu/config.py``.  Host builders work in numpy f64
as there; device copies take :func:`default_dtype`.  The serving path runs
float32 on the GPU, and float32 there must mean true float32: TF32 keeps
about three decimal digits, which is the GPU's version of the TPU's bf16
matmul trap (``pgdrome_tpu/ops/pallas_kernels.py:138-145``) and would
break the 1e-6 accuracy gate while passing toy tests.
"""

from __future__ import annotations

import torch


def default_dtype() -> torch.dtype:
    """Floating dtype for device copies: torch's default (float32 unless
    the caller changed it with ``torch.set_default_dtype``)."""
    return torch.get_default_dtype()


def get_device(device="cuda") -> torch.device:
    """The device an entry point runs on.  CUDA is the default; without a
    CUDA device this raises instead of carrying on quietly on the CPU —
    pass ``device="cpu"`` to ask for the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def use_full_f32_matmul() -> None:
    """Force true-f32 matrix products and convolutions globally (TF32 off).

    Called when the serving modules are imported."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
