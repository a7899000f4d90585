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
  and ``torch.matmul`` (in f32 above 1024 modes summed as the kernels sum,
  :func:`~pgdrome_tpu_torch.ops.fused_sweep.chunked_product`); any grid,
  any float dtype.
* ``method="auto"`` — the kernel, unless the JAX package's gate would also
  refuse it (non-uniform grid, degree outside {1, 2}, float64 modes) or the
  tables lie on the CPU.  A failed build or launch is never a reason: it
  raises.

The parameter Jacobian (:func:`make_sensor_jacobian_fn`) and the batched
Gauss–Newton fit (:func:`make_fit_fn`) are plain factor × table products
in the modes' dtype, as the JAX package computes them outside its kernel;
:func:`sweep_errors` runs whichever sweep its ``method`` picks.
"""

from __future__ import annotations

import numpy as np
import torch

from pgdrome_tpu_torch.config import use_full_f32_matmul
from pgdrome_tpu_torch.ops.fused_sweep import chunked_product
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


def _mode_mask(modes0, n_modes):
    """(n_max,) 0/1 row of the modes served, in the modes' dtype."""
    return (torch.arange(modes0.shape[0], device=modes0.device) < n_modes).to(modes0.dtype)


def _factor_values(spaces, modes, samples, derivative=False):
    """Per parameter dim, every mode's value (or derivative) at the
    samples: [(B, n_max), ...]."""
    return [evaluate_modes_1d(spaces[j], modes[j], samples[:, j - 1],
                              derivative=derivative)
            for j in range(1, len(spaces))]


def _masked_product(vals, mask):
    """The mode-product factors (B, n_max) of per-dim values, masked (the
    0/1 mask multiplies exactly, wherever it stands)."""
    fac = vals[0]
    for v in vals[1:]:
        fac = fac * v
    return fac * mask[None, :]


def _factors(spaces, modes, samples, mask):
    """Plain per-sample mode-product factors (B, K), masked."""
    return _masked_product(_factor_values(spaces, modes, samples), mask)


def _as_samples(samples, like):
    return torch.as_tensor(samples, dtype=like.dtype, device=like.device)


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
    mask = _mode_mask(modes0, n_modes)

    def sweep(samples):
        fac = _factors(spaces, modes, _as_samples(samples, modes0), mask)
        out = chunked_product(fac, modes0)
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


def _table_tensor(spaces, modes0, points, table):
    """The (n_max, n_out) dim-0 table at the sensor points on the modes'
    device and in their dtype: :func:`sensor_table`, or a caller-built
    host ``table``."""
    if table is None:
        table = sensor_table(spaces[0], modes0, points)
    return torch.as_tensor(np.asarray(table).reshape(modes0.shape[0], -1)).to(
        device=modes0.device, dtype=modes0.dtype).contiguous()


def make_sensor_sweep_fn(spaces, modes, n_modes, points, method="auto",
                         table=None):
    """Build the sensor sweep: samples (B, d−1) → responses (B, n_pts).

    The dim-0 modes are evaluated at the sensor points once (or a
    caller-built ``(n_max, n_pts)`` ``table`` is used), so the sweep is the
    mode-product factors times that table; on the kernel path the table
    stands in for the dim-0 modes."""
    modes0 = modes[0]
    table = _table_tensor(spaces, modes0, points, table)
    fused = _try_fused(spaces, table, modes[1:], n_modes, method, "sensor")
    if fused is not None:
        return fused
    mask = _mode_mask(modes0, n_modes)

    def sweep(samples):
        return chunked_product(_factors(spaces, modes, _as_samples(samples, modes0), mask),
                               table)

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
    mask = _mode_mask(ref, n_modes)
    fac_fused = _try_fused(spaces, None, modes[1:], n_modes, method, "moments")

    def acc(samples, w):
        s = _as_samples(samples, ref)
        fac = fac_fused(s) if fac_fused is not None else _factors(spaces, modes, s, mask)
        fac = fac * w.to(fac.dtype)[:, None]
        return fac.sum(0), fac.T @ fac

    return acc


def _jacobian_columns(vals, dvals, mask, table):
    """∂(response)/∂p_j for every parameter j: the factor product with
    factor j differentiated, times the table — (B, n_out, d_p)."""
    cols = []
    for j in range(len(vals)):
        fac = mask[None, :] * dvals[j]
        for l, v in enumerate(vals):
            if l != j:
                fac = fac * v
        cols.append(fac @ table)
    return torch.stack(cols, dim=-1)


def param_box(spaces):
    """Per-parameter (lo, hi) bounds of the factor meshes of ``spaces[1:]``,
    host float64 arrays."""
    lo = np.array([float(V.mesh().coordinates().min()) for V in spaces[1:]])
    hi = np.array([float(V.mesh().coordinates().max()) for V in spaces[1:]])
    return lo, hi


def parse_prior(prior, d_p):
    """``(p_prior, gamma)`` → host float64 (p_prior (d_p,), γ² (d_p,));
    gamma a scalar or (d_p,)."""
    p_prior = np.asarray(prior[0], dtype=np.float64).reshape(-1)
    if p_prior.shape[0] != d_p:
        raise ValueError(f"p_prior must be ({d_p},)")
    g2 = np.broadcast_to(np.asarray(prior[1], dtype=np.float64) ** 2, (d_p,)).copy()
    return p_prior, g2


def _like(arrays, like):
    """Host arrays as tensors of ``like``'s dtype on its device."""
    return [torch.as_tensor(a, dtype=like.dtype, device=like.device) for a in arrays]


def make_sensor_jacobian_fn(spaces, modes, n_modes, points, table=None):
    """Build the parameter-sensitivity sweep: samples (B, d−1) → Jacobian
    (B, n_pts, d−1) of the sensor responses w.r.t. the parameters.

    The rank-1 structure gives it analytically: column j is the sensor
    sweep with factor j differentiated,
    ∂r_p/∂p_j = Σ_k table[k, p] · f'_{j,k}(p_j) · Π_{l≠j} f_{l,k}(p_l)
    (:func:`~pgdrome_tpu_torch.separated.evaluate_modes_1d` with
    ``derivative=True`` gives f', one-sided at grid nodes): d−1 products
    of the sensor sweep's size, no finite differences."""
    modes0 = modes[0]
    table = _table_tensor(spaces, modes0, points, table)
    mask = _mode_mask(modes0, n_modes)

    def jac(samples):
        s = _as_samples(samples, modes0)
        return _jacobian_columns(_factor_values(spaces, modes, s),
                                 _factor_values(spaces, modes, s, derivative=True),
                                 mask, table)

    return jac


def make_fit_fn(spaces, modes, n_modes, points, table=None, n_iter=30,
                damping=1e-9, weights=None, prior=None):
    """Build the batched parameter-identification solver:
    ``fit(observations (B, n_out), p0 (B, d−1)) → (p_hat (B, d−1),
    resnorm (B,))`` — box-projected, damped Gauss–Newton on

        min_p ‖W·(sensor(p) − observations)‖² + ‖Γ·(p − p_prior)‖²

    with the analytic Jacobian of :func:`make_sensor_jacobian_fn`.
    ``weights``: optional (n_out,) per-observation weights W (1/σ_o makes
    resnorm a χ statistic); ``prior``: optional ``(p_prior (d_p,), gamma
    scalar | (d_p,))`` Tikhonov term, which makes an underdetermined
    calibration well-posed.

    Each of the ``n_iter`` steps solves the damped normal equations of
    every problem at once (a batched (B, d_p, d_p) solve) with a relative
    damping λ·tr(JᵀJ)/d_p per problem; a trial step, clipped to the
    parameter box (the factor meshes' bounds), is taken only if it lowers
    the true cost, and λ shrinks 3× on success and grows 4× otherwise
    (clipped to [``damping``, 1e10]).  All control flow is elementwise
    (``torch.where``), so the loop never waits for the device.  The
    observations and starts are cast to the modes' dtype and device:
    float64 modes recover interior optima to ~1e-9, float32 ones to ~1e-4
    (the normal equations square the conditioning)."""
    modes0 = modes[0]
    dt, dev = modes0.dtype, modes0.device
    d_p = len(spaces) - 1
    table = _table_tensor(spaces, modes0, points, table)
    mask = _mode_mask(modes0, n_modes)
    w = None
    if weights is not None:
        w = torch.as_tensor(np.asarray(weights, dtype=np.float64).reshape(-1)).to(dev, dt)
        if w.shape[0] != table.shape[1]:
            raise ValueError(f"weights must have one entry per output "
                             f"({table.shape[1]}), got {w.shape[0]}")
    if prior is not None:
        pp, g2 = _like(parse_prior(prior, d_p), modes0)
    lo, hi = _like(param_box(spaces), modes0)
    eye = torch.eye(d_p, dtype=dt, device=dev)
    tiny = torch.finfo(dt).tiny

    def residual(p, obs, with_jac):
        vals = _factor_values(spaces, modes, p)
        r = _masked_product(vals, mask) @ table - obs
        if not with_jac:
            return r, None
        dvals = _factor_values(spaces, modes, p, derivative=True)
        return r, _jacobian_columns(vals, dvals, mask, table)

    def cost(p, r):
        if w is not None:
            r = r * w[None, :]
        c = (r * r).sum(-1)
        if prior is not None:
            c = c + (g2[None, :] * (p - pp[None, :]) ** 2).sum(-1)
        return c

    def fit(observations, p0):
        obs = torch.as_tensor(observations, dtype=dt, device=dev)
        p = torch.as_tensor(p0, dtype=dt, device=dev).clone()
        lam = torch.full((p.shape[0],), max(1e-3, damping), dtype=dt, device=dev)
        for _ in range(int(n_iter)):
            r, J = residual(p, obs, with_jac=True)
            if w is not None:
                rw, Jw = r * w[None, :], J * w[None, :, None]
            else:
                rw, Jw = r, J
            JtJ = torch.einsum("bod,boe->bde", Jw, Jw)
            g = torch.einsum("bod,bo->bd", Jw, rw)
            if prior is not None:
                JtJ = JtJ + torch.diag(g2)[None]
                g = g + g2[None, :] * (p - pp[None, :])
            scale = torch.diagonal(JtJ, dim1=-2, dim2=-1).sum(-1) / d_p + tiny
            # unchecked solve: a singular system gives non-finite steps,
            # which the cost test rejects, without a wait on the device
            delta = torch.linalg.solve_ex(JtJ + (lam * scale)[:, None, None] * eye,
                                          -g[..., None])[0][..., 0]
            p_try = torch.clamp(p + delta, lo, hi)
            r_try, _ = residual(p_try, obs, with_jac=False)
            better = cost(p_try, r_try) < cost(p, r)
            p = torch.where(better[:, None], p_try, p)
            lam = torch.clamp(torch.where(better, lam / 3.0, lam * 4.0), damping, 1e10)
        r, _ = residual(p, obs, with_jac=False)
        if w is not None:
            r = r * w[None, :]
        return p, torch.sqrt((r * r).sum(-1))

    return fit


def rel_l2_errors(u, fom_fields):
    """Per-sample relative L2 errors ‖u − fom‖/‖fom‖ over the dofs, in
    float64 on ``u``'s device."""
    u = torch.as_tensor(u).double()
    fom = torch.as_tensor(fom_fields).to(u.device, torch.float64)
    return torch.linalg.norm(u - fom, dim=1) / torch.linalg.norm(fom, dim=1)


def sweep_errors(spaces, modes, n_modes, samples, fom_fields, method="torch"):
    """Relative L2 errors of the reconstruction against precomputed FOM
    fields over a sample batch, (B,) float64 on the modes' device: the
    field sweep of ``method`` (the JAX package's builds its default path),
    then :func:`rel_l2_errors`."""
    u = make_sweep_fn(spaces, modes, n_modes, method=method)(samples)
    return rel_l2_errors(u, fom_fields)
