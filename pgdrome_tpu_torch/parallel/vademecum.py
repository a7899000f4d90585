"""Batched vademecum sweeps (counterpart of the single-device part of
``pgdrome_tpu/parallel/vademecum.py``).

The serving workload is the parameter sweep: reconstruct u(·; p) for a
large batch of parameter samples.  Each builder returns a function of a
(B, d−1) sample batch on the vademecum's device, through one of two paths:

* ``method="fused"`` — the hand-written CUDA kernel
  (:mod:`pgdrome_tpu_torch.ops.fused_sweep`; its plain version when the
  tables lie on the CPU).  Uniform P1/P2 parameter grids, float32 only.
* ``method="torch"`` — plain PyTorch: per-dim mode evaluation by gather
  (:func:`~pgdrome_tpu_torch.separated.evaluate_modes_1d`), factor product
  and ``torch.matmul``; any grid, any float dtype.
* ``method="auto"`` — the kernel, unless the JAX package's gate would also
  refuse it (non-uniform grid, degree outside {1, 2}, float64 modes) or the
  tables lie on the CPU.  A failed build or launch is never a reason: it
  raises.
"""

from __future__ import annotations

import numpy as np
import torch

from pgdrome_tpu_torch.config import use_full_f32_matmul
from pgdrome_tpu_torch.separated import evaluate_modes_1d

use_full_f32_matmul()

_METHODS = ("torch", "fused", "auto")


def _try_fused(spaces, dim0_table, other_modes, n_modes, method, kind,
               out_dtype=None):
    """Shared kernel gate for the field, sensor and factor sweeps: returns
    the bound fused sweep, or None for the caller's plain path.  Float64
    modes are refused on method='fused' (the kernel is float32-only)."""
    if method not in _METHODS:
        raise ValueError(f"method must be one of {_METHODS}, got {method!r}")
    if method == "torch":
        return None
    from pgdrome_tpu_torch.ops.fused_sweep import make_fused_sweep, sweep_grid

    ref = other_modes[0]
    if ref.dtype == torch.float64:
        if method == "fused":
            raise ValueError(
                f"fused {kind} kernel is float32-only; use method='torch' "
                "for float64 modes"
            )
        return None
    if method == "auto" and ref.device.type == "cpu":
        return None
    try:
        sweep_grid(spaces)
    except ValueError:  # kernel constraints (grids/degree) not met
        if method == "fused":
            raise
        return None
    return make_fused_sweep(spaces, [dim0_table, *other_modes], n_modes,
                            out_dtype=out_dtype, device=ref.device)


def _factors(spaces, modes, samples, mask):
    """Plain per-sample mode-product factors (B, K), masked."""
    fac = None
    for j in range(1, len(spaces)):
        vals = evaluate_modes_1d(spaces[j], modes[j], samples[:, j - 1])
        fac = vals if fac is None else fac * vals
    return fac * mask[None, :]


def _as_samples(samples, like):
    return torch.as_tensor(samples).to(device=like.device, dtype=like.dtype)


def make_sweep_fn(spaces, modes, n_modes, method="torch", out_dtype=None):
    """Build the field sweep: samples (B, d−1) → fields (B, n0).

    spaces: per-dim function spaces (free dims 1..d−1 must be 1D);
    modes: per-dim (n_max, n_d) mode tensors on one device.
    out_dtype: optional narrower output dtype (``torch.bfloat16``): compute
    stays full precision, only the store narrows."""
    fused = _try_fused(spaces, modes[0], modes[1:], n_modes, method, "sweep",
                       out_dtype=out_dtype)
    if fused is not None:
        return fused
    modes0 = modes[0]
    mask = (torch.arange(modes0.shape[0], device=modes0.device)
            < n_modes).to(modes0.dtype)

    def sweep(samples):
        fac = _factors(spaces, modes, _as_samples(samples, modes0), mask)
        out = fac @ modes0
        return out if out_dtype is None else out.to(out_dtype)

    return sweep


def sensor_table(V0, modes0, points) -> np.ndarray:
    """(n_max, n_pts) host table of the dim-0 modes evaluated at the
    sensor points (f64 point evaluation of the modes as stored, cast back
    to their dtype — as the JAX package builds it)."""
    from pgdrome_tpu_torch.fem.interpolate import eval_dofs_at_points

    m0 = modes0.detach().cpu().numpy()
    pts = np.asarray(points)
    return np.stack(
        [np.asarray(eval_dofs_at_points(V0, m0[k], pts)) for k in range(m0.shape[0])]
    ).reshape(m0.shape[0], -1).astype(m0.dtype)


def make_sensor_sweep_fn(spaces, modes, n_modes, points, method="auto",
                         table=None):
    """Build the sensor sweep: samples (B, d−1) → responses (B, n_pts).

    The dim-0 modes are evaluated at the sensor points once (or a
    caller-built ``(n_max, n_pts)`` ``table`` is used), so the sweep is the
    mode-product factors times that table; on the kernel path the table
    stands in for the dim-0 modes."""
    modes0 = modes[0]
    n_max = modes0.shape[0]
    if table is None:
        table = sensor_table(spaces[0], modes0, points)
    table = torch.as_tensor(np.asarray(table).reshape(n_max, -1)).to(
        device=modes0.device, dtype=modes0.dtype).contiguous()
    fused = _try_fused(spaces, table, modes[1:], n_modes, method, "sensor")
    if fused is not None:
        return fused
    mask = (torch.arange(n_max, device=modes0.device) < n_modes).to(modes0.dtype)

    def sweep(samples):
        return _factors(spaces, modes, _as_samples(samples, modes0), mask) @ table

    return sweep


def make_factor_moments_fn(spaces, modes, n_modes, method="auto"):
    """Build the streaming-moment accumulator:
    fn(samples (B, d−1), w (B,)) → (Σ_b w_b·fac_b (n_max,),
                                    Σ_b w_b·fac_b fac_bᵀ (n_max, n_max)).

    ``fac_b`` is the per-sample masked factor vector; ``w`` a 0/1 validity
    mask (tail padding, w² = w).  On the kernel path the factors come from
    the kernel's factor wiring; the two reductions are plain products, as
    the JAX package left them to XLA.  Outputs are per-chunk partial sums
    in the modes' dtype — accumulate across chunks on the host in f64
    (:meth:`~pgdrome_tpu_torch.serving.Vademecum.factor_moments`)."""
    if len(spaces) < 2:
        raise ValueError("factor moments need at least one parameter dim")
    ref = modes[1]
    n_max = ref.shape[0]
    mask = (torch.arange(n_max, device=ref.device) < n_modes).to(ref.dtype)
    fac_fused = _try_fused(spaces, None, modes[1:], n_modes, method, "moments")

    def acc(samples, w):
        s = _as_samples(samples, ref)
        fac = fac_fused(s) if fac_fused is not None else _factors(spaces, modes, s, mask)
        fac = fac * w.to(fac.dtype)[:, None]
        return fac.sum(0), fac.T @ fac

    return acc
