"""Goal-oriented (primal–dual) output correction for separated vademecums
(counterpart of ``pgdrome_tpu/dual.py``).

Serving users often consume outputs, s(p) = l·u(p), not whole fields.  With
an adjoint vademecum z_r(p) ≈ A(p)⁻ᵀ l the corrected output

    s_corr(p) = l·u_r(p) + z_r(p)·r(p),     r(p) = b(p) − A(p) u_r(p)

has error s(p) − s_corr(p) = (z(p) − z_r(p))·r(p), exactly for the linear
problems here: dual error times primal residual, so a modest adjoint on a
rank-walled primal certifies outputs far below the field error.

Everything is reduced: the affine coefficients θ_t(p) of A(p) = Σ_t θ_t(p)
A_t and of the rhs are read off the collocation-diagonal parameter stacks,
so a corrected output costs O(rank_z · rank_u) per sample after a one-off
sparse assembly of the couplings C_t = Z₀ᵀ A_t U₀ on the host in f64.

:class:`DualCorrector` is the host f64 corrector (certification grade);
:func:`make_corrected_sensor_fn` serves the same outputs on the card, the
primal and dual mode-product factors through the sweep's factor kernel
(:mod:`pgdrome_tpu_torch.ops.fused_sweep`), the rest in plain ``torch``.
:func:`adjoint_problem_nd` builds the space-time adjoint of the transient
family (``DualCorrector(n_fixed=2)`` corrects its outputs), and
:func:`rhs_parametric_qoi` gives outputs exactly where only the load
depends on the parameters.

Conventions match the problem builders (:mod:`~pgdrome_tpu_torch.models.problems`):
a host-f64 un-preconditioned :class:`~pgdrome_tpu_torch.separated.SeparatedProblem`,
parameter dims collocation-lumped (diagonal stacks), term 0 the
unit-coefficient base term (its parameter diagonals are the collocation
measure weights; the boundary-boost reweighting cancels out of θ).
"""

from __future__ import annotations

import numpy as np
import torch

from pgdrome_tpu_torch.config import get_device, use_full_f32_matmul
from pgdrome_tpu_torch.separated import SeparatedProblem, evaluate_modes_1d, host_f64

use_full_f32_matmul()

__all__ = ["adjoint_problem", "adjoint_problem_nd", "collocation_weights",
           "corrected_sweep_bound", "DualCorrector", "guaranteed_output_bound",
           "make_corrected_sensor_fn", "point_functional", "rhs_parametric_qoi"]


def point_functional(V, x0):
    """Point-evaluation functional over a 1D space: l with l·u = u(x0)
    (the usual sensor output; any dim-0 dof functional works as ``l_vec``,
    e.g. a load vector for a weighted average)."""
    from pgdrome_tpu_torch.fem.interpolate import _locate_1d, _shape_1d_x

    verts = V.mesh().coordinates()[:, 0]
    if not (verts[0] <= float(x0) <= verts[-1]):
        raise ValueError(
            f"sensor x0={x0} is outside the mesh domain [{verts[0]}, {verts[-1]}] "
            "(the clipped cell locate would silently extrapolate)"
        )
    cell, xi = _locate_1d(V.mesh(), np.asarray([float(x0)]), np)
    basis = _shape_1d_x(V.degree, xi, np)[0]
    l = np.zeros(V.dim(), dtype=np.float64)
    l[np.asarray(V.element_dofs)[int(cell[0])]] = basis
    return l


def collocation_weights(sep, dim):
    """Collocation measure weights w_j of parameter dim ``dim``: the
    diagonal of the base (term-0) lumped operator.  Raises when the dim's
    stack is not collocation-diagonal."""
    ops = host_f64(sep.ops[dim])
    off = ops - ops * np.eye(ops.shape[1])[None]
    if np.abs(off).max() > 1e-12 * max(np.abs(ops).max(), 1.0):
        raise ValueError(
            f"dim {dim} operator stack is not collocation-diagonal; pass "
            "explicit theta_ops/theta_rhs to DualCorrector (affine "
            "coefficients cannot be extracted from consistent-Galerkin "
            "parameter operators)"
        )
    w = np.diagonal(ops[0]).astype(np.float64)
    if np.any(w <= 0):
        raise ValueError(f"dim {dim} base-term diagonal is not positive")
    return w


def _masked(l, sep, d):
    """A copy of the functional factor ``l`` over dim ``d`` in f64, zero at
    the dim's constrained dofs."""
    l = np.asarray(l, dtype=np.float64).copy()
    if sep.bc_dofs[d] is not None and len(sep.bc_dofs[d]):
        l[np.asarray(sep.bc_dofs[d])] = 0.0
    return l


def adjoint_problem(sep, l_vec, *, param_rhs=None):
    """Adjoint separated problem A(p)ᵀ z = l for the output s(p) = l·u(p):
    each term's operator stacks transposed, rhs = l ⊗ w_1 ⊗ … ⊗ w_d with
    w_j the collocation weights (so the per-grid-point system is the FEM
    adjoint at that parameter point).

    ``l_vec`` is the functional over full dim-0 dofs; its entries at
    constrained dofs are zeroed.  ``param_rhs`` overrides the per-dim
    parameter rhs factors (a list over dims 1..).  Returns a host-f64
    :class:`SeparatedProblem`, ready for ``precondition_dim0`` and any
    solve pipeline."""
    return adjoint_problem_nd(sep, [l_vec], n_fixed=1, param_rhs=param_rhs)


def adjoint_problem_nd(sep, l_factors, *, n_fixed=2, param_rhs=None):
    """Adjoint separated problem A(p)ᵀ z = ⊗_d l_d over the leading
    ``n_fixed`` deterministic dims, collocation parameters after (the
    space-time case: dims x ⊗ t ⊗ p…).

    Every dim's operator stack is transposed per term: the upwind time
    stencil becomes the downwind one, so the adjoint runs backward in time
    from the functional.  The bc bookkeeping is the discrete adjoint's: the
    solver's masked system mAm + diag(1−m) transposes to mAᵀm + diag(1−m),
    the same constrained dofs (the primal's t = 0 rows), with the
    functional masked there, so s = (ml)·u = z·(mb) holds exactly.

    ``l_factors``: one functional factor per fixed dim (e.g. a sensor row
    e_{x0} and a final-time row e_T).  The parameter-dim rhs factors are
    the collocation weights unless ``param_rhs`` gives them.  Returns a
    host-f64 :class:`SeparatedProblem`."""
    nd = sep.num_dims
    if not 1 <= n_fixed < nd:
        raise ValueError(f"n_fixed must be in [1, {nd})")
    if len(l_factors) != n_fixed:
        raise ValueError(f"need {n_fixed} functional factors, got {len(l_factors)}")
    rhs = []
    for d in range(n_fixed):
        l = np.asarray(l_factors[d], dtype=np.float64)
        if l.shape != (sep.sizes[d],):
            raise ValueError(
                f"l_factors[{d}] has shape {l.shape}, expected ({sep.sizes[d]},)")
        rhs.append(_masked(l, sep, d)[None, :])
    if param_rhs is None:
        param_rhs = [collocation_weights(sep, j) for j in range(n_fixed, nd)]
    rhs += [np.asarray(w, dtype=np.float64)[None, :] for w in param_rhs]
    return SeparatedProblem(
        ops=[np.swapaxes(host_f64(o), 1, 2) for o in sep.ops],
        rhs=rhs,
        mass=[host_f64(m) for m in sep.mass],
        bc_dofs=[np.array([], dtype=np.int64) if b is None else np.asarray(b)
                 for b in sep.bc_dofs],
    )


class DualCorrector:
    """Reduced primal–dual corrected outputs over a separated vademecum, in
    host f64.

    sep: the host-f64 un-preconditioned primal problem (the source of the
    affine operator and rhs decomposition); Vs: the spaces (dims
    0..n_fixed−1 fixed, then the parameters); l_vec: the output functional
    over full dim-0 dofs; res_u, tf_u: the primal result and its dim-0
    transform (``precondition_dim0``), or ``tf_u=None`` for nodal modes;
    res_z, tf_z: the adjoint's (:func:`adjoint_problem`).  theta_ops,
    theta_rhs: optional ``(samples) → (S, T)`` / ``(S, R)`` coefficient
    callables; by default read off the collocation-diagonal parameter
    stacks (exact on the grid, P1 between).  cache: a dict reused across
    correctors that share (sep, Vs, l_vec, res_u, tf_u) and differ in the
    dual only (the per-stage verification of
    :func:`~pgdrome_tpu_torch.recipes.goal_oriented_frontier`).  n_fixed,
    l_factors: space-time correctors, with one functional factor per
    fixed dim.

    The constructor does the one-off reduced assembly (sparse fixed-dim
    operators, ~T·rank_z·n·rank_u flops); :meth:`corrected` then costs
    O(rank_z·rank_u) per sample."""

    def __init__(self, sep, Vs, l_vec, res_u, tf_u, res_z, tf_z, *,
                 theta_ops=None, theta_rhs=None, cache=None,
                 n_fixed: int = 1, l_factors=None):
        import scipy.sparse as sp

        self.Vs = Vs
        self.res_u, self.res_z = res_u, res_z
        nd = sep.num_dims
        self.n_fixed = nf = int(n_fixed)
        self.num_params = nd - nf
        if nf > 1 and l_factors is None:
            raise ValueError("space-time correctors (n_fixed > 1) need l_factors "
                             "(per-fixed-dim functional factors)")
        if l_factors is None:
            l_factors = [l_vec]
        cache = cache if cache is not None else {}

        def _full(res, tf, d=0):
            md = host_f64(res.modes[d])[: res.n_modes]
            return tf.modes_to_full(md) if (tf is not None and d == 0) else md

        if "U0" not in cache:
            cache["U0"] = [_full(res_u, tf_u, d) for d in range(nf)]
        Us = cache["U0"]  # per fixed dim (ru, n_d)
        Zs = [_full(res_z, tf_z, d) for d in range(nf)]
        if "L" not in cache:
            L = np.ones(res_u.n_modes)
            for d in range(nf):
                L = L * (Us[d] @ _masked(l_factors[d], sep, d))
            cache["L"] = L
        self.L = cache["L"]  # (ru,)
        if "A_csr" not in cache:
            # banded fixed-dim matrices: dense n²·rank products would cost
            # far more on the host at frontier widths
            cache["A_csr"] = [[sp.csr_matrix(host_f64(sep.ops[d])[t])
                               for t in range(sep.num_terms)] for d in range(nf)]
        C = np.ones((sep.num_terms, res_z.n_modes, res_u.n_modes))
        for d in range(nf):
            C = C * np.stack([Zs[d] @ (A @ Us[d].T) for A in cache["A_csr"][d]])
        self.C = C  # (T, rz, ru)
        B = np.ones((sep.num_rhs, res_z.n_modes))
        for d in range(nf):
            B = B * (host_f64(sep.rhs[d]) @ Zs[d].T)
        self.B = B  # (R, rz)

        self._grids = self._g_ops = self._g_rhs = None
        self._ranges = [(float(Vs[nf + j].mesh().coordinates()[0, 0]),
                         float(Vs[nf + j].mesh().coordinates()[-1, 0]))
                        for j in range(self.num_params)]
        both_auto = theta_ops is None and theta_rhs is None
        if theta_ops is None or theta_rhs is None:
            if "theta_tables" not in cache:
                grids = [Vs[nf + j].tabulate_dof_coordinates()[:, 0]
                         for j in range(self.num_params)]
                w = [collocation_weights(sep, nf + j) for j in range(self.num_params)]
                cache["theta_tables"] = (
                    grids,
                    [np.diagonal(host_f64(sep.ops[nf + j]), axis1=1, axis2=2) / w[j][None, :]
                     for j in range(self.num_params)],  # (T, n_p)
                    [host_f64(sep.rhs[nf + j]) / w[j][None, :]
                     for j in range(self.num_params)],  # (R, n_p)
                )
            grids, g_ops, g_rhs = cache["theta_tables"]
            # kept for the device sweep only when both thetas are read off
            # the tables: a user callable beside an interpolated table
            # would make the sweep disagree with corrected()
            if both_auto:
                self._grids, self._g_ops, self._g_rhs = grids, g_ops, g_rhs

            def _theta(tables):
                def ev(samples):
                    s = np.atleast_2d(np.asarray(samples, dtype=np.float64))
                    out = np.ones((s.shape[0], tables[0].shape[0]))
                    for j, tab in enumerate(tables):
                        for t in range(tab.shape[0]):
                            out[:, t] *= np.interp(s[:, j], grids[j], tab[t])
                    return out
                return ev

            theta_ops = theta_ops or _theta(g_ops)
            theta_rhs = theta_rhs or _theta(g_rhs)
        self.theta_ops, self.theta_rhs = theta_ops, theta_rhs

    def _factors(self, res, samples):
        s = np.atleast_2d(np.asarray(samples, dtype=np.float64))
        fac = np.ones((s.shape[0], res.n_modes))
        for j in range(self.num_params):
            modes = torch.as_tensor(host_f64(res.modes[self.n_fixed + j]))
            fac *= evaluate_modes_1d(self.Vs[self.n_fixed + j], modes,
                                     torch.from_numpy(s[:, j])).numpy()[:, : res.n_modes]
        return fac

    def check_in_box(self, samples):
        """Raise unless every sample lies in the vademecum's parameter box:
        outside it the θ tables clamp while the mode factors extrapolate,
        and the reduced residual matches no A(p)u − b(p)."""
        s = np.atleast_2d(np.asarray(samples, dtype=np.float64))
        for j, (lo, hi) in enumerate(self._ranges):
            if s[:, j].min() < lo or s[:, j].max() > hi:
                raise ValueError(
                    f"samples leave the parameter box in dim {j} ([{lo}, {hi}]): "
                    "corrected outputs are only defined inside the vademecum's box"
                )

    def qoi(self, samples):
        """Plain vademecum outputs l·u_r(p), shape (S,)."""
        return self._factors(self.res_u, samples) @ self.L

    def corrected(self, samples, *, return_parts=False):
        """Dual-corrected outputs s_corr(p) = l·u_r + z_r·(b(p) − A(p)u_r),
        shape (S,).  ``return_parts`` also returns ``(s_plain, z_dot_r)``:
        the correction z_r·r(p) is the output error estimate (effectivity
        → 1 as the dual converges)."""
        self.check_in_box(samples)
        fu = self._factors(self.res_u, samples)  # (S, ru)
        fz = self._factors(self.res_z, samples)  # (S, rz)
        th = self.theta_ops(samples)  # (S, T)
        hr = self.theta_rhs(samples)  # (S, R)
        s_plain = fu @ self.L
        z_b = np.einsum("sr,rs->s", hr, self.B @ fz.T)
        # one (S, ru) temporary per term, not (S, T, ru)
        z_au = np.zeros(fu.shape[0])
        for t in range(self.C.shape[0]):
            z_au += th[:, t] * ((fz @ self.C[t]) * fu).sum(axis=1)
        z_r = z_b - z_au
        s = s_plain + z_r
        if return_parts:
            return s, s_plain, z_r
        return s


def rhs_parametric_qoi(sep, Vs, sensors, *, fixed_dims=(0, 1)):
    """Exact separated output surrogate for problems whose parameters enter
    the rhs only (the moving heat source: A = ρc_p·M⊗D1_up + k·K⊗M_t, only
    the load carries (P, v)).  Then s(p) = lᵀA⁻¹b(p) = zᵀb(p) with
    z = A⁻ᵀl, one backward space-time solve a sensor, and since b(p) =
    Σ_r ⊗_f g_rf · Π_j c_rj(p_j) the output is the closed form
    s(p) = Σ_r W_r Π_j c_rj(p_j), W_r = zᵀ(⊗_f g_rf): no vademecum rank,
    the source-separation floor only.  The pointwise coefficients
    c_rj = M_j⁻¹ rhs_j[r] are read back from the weak factors (exact for
    the builders' P1 quadrature), and interpolated P1 between grid points.

    ``sep``: the host-f64 problem; ``Vs`` its spaces; ``sensors``: one
    coordinate tuple a sensor over the fixed dims (each becomes
    l = ⊗_f point_functional); ``fixed_dims``: (0,) or (0, 1).  Every other
    dim's operator terms must equal its mass (checked) and carry no bc
    dofs.  Host scipy: one sparse LU of the masked kron system.

    Returns ``qoi(samples) -> (S, n_sensors)`` with ``.weights``
    (n_sensors, R) and ``.adjoints`` (the z fields)."""
    from functools import reduce

    from scipy import sparse as sps
    from scipy.sparse import linalg as spla

    if tuple(fixed_dims) not in ((0,), (0, 1)):
        raise ValueError("fixed_dims must be (0,) or (0, 1)")
    nd = sep.num_dims
    param_dims = [d for d in range(nd) if d not in fixed_dims]
    for d in param_dims:
        od, md = host_f64(sep.ops[d]), host_f64(sep.mass[d])
        for t in range(od.shape[0]):
            if not np.allclose(od[t], md, rtol=0.0, atol=1e-12 * np.abs(md).max()):
                raise ValueError(
                    f"parameter dim {d} operator term {t} is not the mass: the "
                    "operator is parameter-dependent — use "
                    "adjoint_problem/DualCorrector instead")
        if sep.bc_dofs[d] is not None and len(sep.bc_dofs[d]):
            raise ValueError(f"parameter dim {d} carries bc dofs")

    sizes = [sep.sizes[f] for f in fixed_dims]
    opsF = [host_f64(sep.ops[f]) for f in fixed_dims]
    A = sum(reduce(sps.kron, (sps.csr_matrix(o[t]) for o in opsF))
            for t in range(opsF[0].shape[0])).tolil()
    # constrained rows of the kron system become identity rows (the
    # per-sample FOM's convention)
    bc_mask = np.zeros(tuple(sizes), dtype=bool)
    for k, f in enumerate(fixed_dims):
        dofs = sep.bc_dofs[f]
        if dofs is not None and len(dofs):
            np.moveaxis(bc_mask, k, 0)[np.asarray(dofs)] = True
    bc_rows = np.nonzero(bc_mask.reshape(-1))[0]
    for rr in bc_rows:
        A.rows[rr] = [int(rr)]
        A.data[rr] = [1.0]
    lu = spla.splu(A.tocsr().tocsc())

    rhsF = [host_f64(sep.rhs[f]) for f in fixed_dims]
    R = rhsF[0].shape[0]
    adjoints, weights = [], []
    for coords in sensors:
        if np.ndim(coords) == 0:
            coords = (coords,)
        if len(coords) != len(fixed_dims):
            raise ValueError(f"sensor {coords!r}: need one coordinate per fixed dim")
        l = reduce(np.kron, (point_functional(Vs[f], c) for f, c in zip(fixed_dims, coords)))
        l[bc_rows] = 0.0
        z = lu.solve(l, trans="T")
        adjoints.append(z)
        # the per-sample FOM zeroes b at constrained rows: masking z there
        # is the same contraction (A's bc rows are identity, its bc
        # columns are not, so z is nonzero on them)
        zm = z.copy()
        zm[bc_rows] = 0.0
        if len(fixed_dims) == 2:
            weights.append(np.einsum("ri,ij,rj->r", rhsF[0], zm.reshape(sizes), rhsF[1]))
        else:
            weights.append(rhsF[0] @ zm)
    W = np.stack(weights)  # (n_sensors, R)

    grids = [Vs[j].tabulate_dof_coordinates()[:, 0] for j in param_dims]
    cs = [np.linalg.solve(host_f64(sep.mass[j]), host_f64(sep.rhs[j]).T).T
          for j in param_dims]  # (R, n_j) pointwise coefficients

    def qoi(samples):
        s = np.atleast_2d(np.asarray(samples, dtype=np.float64))
        if s.shape[1] != len(param_dims):
            raise ValueError(f"samples have {s.shape[1]} columns, expected "
                             f"{len(param_dims)} (one per parameter dim)")
        fac = np.ones((s.shape[0], R))
        for k, g in enumerate(grids):
            if s[:, k].min() < g[0] or s[:, k].max() > g[-1]:
                raise ValueError(
                    f"samples leave the parameter box in column {k} ([{g[0]}, {g[-1]}]): "
                    "the closed form would silently extrapolate the coefficient tables")
            i = np.clip(np.searchsorted(g, s[:, k], side="right") - 1, 0, len(g) - 2)
            w = (s[:, k] - g[i]) / (g[i + 1] - g[i])
            fac *= (cs[k][:, i] * (1.0 - w) + cs[k][:, i + 1] * w).T
        return fac @ W.T  # (S, n_sensors)

    qoi.weights = W
    qoi.adjoints = adjoints
    return qoi


def guaranteed_output_bound(sep, Vs, l_vec, res_u, tf_u, res_z, tf_z, *,
                            chunk=None, device="cuda", primal_indicator=None):
    """Guaranteed (not calibrated) per-sample bound on the corrected output
    error: ``bound(samples) → (B,)`` with

        |s(p) − s_corr(p)| = |(z − z_r)ᵀ r(p)| ≤ ‖r_dual(p)‖_{K0⁻¹} ‖r_primal(p)‖_{K0⁻¹}

    valid when A(p) ⪰ K0 on the parameter box (every K_t PSD, θ_t ≥ 0,
    θ_0 ≡ 1): then ‖z − z_r‖_{K0} ≤ ‖r_dual‖_{K0⁻¹} and Cauchy–Schwarz in
    the K0 inner product gives the product.  Both residual norms are the
    energy-preconditioned dd indicators of
    :func:`~pgdrome_tpu_torch.parallel.certify.make_residual_indicator`,
    run on ``device``; ``primal_indicator``: the primal's, already built
    by ``make_residual_indicator(sep, Vs, res_u, tf=tf_u)`` (one serves
    every sensor's bound).  θ-nonnegativity and θ_0 ≡ 1 are checked on the
    collocation tables; the K_t's PSD is structural for the builders and
    not re-checked.  Attributes ``rhs_norm_primal``, ``rhs_norm_dual``,
    ``primal_indicator``."""
    from pgdrome_tpu_torch.parallel.certify import (
        make_residual_indicator,
        validate_spd_family,
    )

    g0 = host_f64(sep.rhs[0])
    if g0.shape[0] != 1:
        raise ValueError(
            "guaranteed_output_bound assumes a single p-independent primal rhs term "
            f"(got {g0.shape[0]}): the per-sample ‖b(p)‖ would otherwise vary"
        )
    validate_spd_family(sep)
    device = get_device(device)
    l = _masked(l_vec, sep, 0)
    ind_u = primal_indicator or make_residual_indicator(sep, Vs, res_u, tf=tf_u, chunk=chunk,
                                                        device=device)
    ind_z = make_residual_indicator(adjoint_problem(sep, l), Vs, res_z, tf=tf_z, chunk=chunk,
                                    device=device)

    # the indicators are relative to ‖L⁻¹b‖; both rhs are p-independent
    # here (unit load, sensor functional), so the norms are host constants
    def _rhs_norm(tf, b):
        v = np.asarray(b, dtype=np.float64)[tf.interior]
        return float(np.linalg.norm(tf.apply_Linv(v[:, None])[:, 0]))

    mask0 = host_f64(sep.bc_masks[0])
    nb = _rhs_norm(tf_u, g0[0] * mask0)
    nl = _rhs_norm(tf_z, l * mask0)

    def bound(samples, primal_residuals=None):
        """(B,) bounds; ``primal_residuals``: ``primal_indicator(samples)``
        already computed (the same for every sensor's bound)."""
        r_u = ind_u(samples) if primal_residuals is None else primal_residuals
        return np.asarray(ind_z(samples)) * nl * np.asarray(r_u) * nb

    bound.rhs_norm_primal = nb
    bound.rhs_norm_dual = nl
    bound.primal_indicator = ind_u
    return bound


def corrected_sweep_bound(dc, samples):
    """The f32 corrected sweep's rounding bound against the host f64
    corrector ``dc`` at ``samples``: ``(bound (S,), c)``, γ_c times the
    same sum over absolute values (|fu|·|L|, the W products'
    |θ_t||fz||C_t||fu|, the rhs part's |hr||B||fz|), c counting the longest
    chain of f32 roundings an output goes through: 4·NP in each factor,
    rz + T + 1 in W, ru in the primal-rank sum (in any order), and 4 in
    the final sums."""
    fu = np.abs(dc._factors(dc.res_u, samples))
    fz = np.abs(dc._factors(dc.res_z, samples))
    th = np.abs(dc.theta_ops(samples))
    hr = np.abs(dc.theta_rhs(samples))
    aw = sum(th[:, t : t + 1] * (fz @ np.abs(dc.C[t])) for t in range(dc.C.shape[0]))
    scale = (fu * (np.abs(dc.L)[None, :] + aw)).sum(1) + (hr * (fz @ np.abs(dc.B).T)).sum(1)
    c = (4 * dc.num_params + dc.res_z.n_modes + dc.C.shape[0] + 1
         + dc.res_u.n_modes + 4)
    u = 2.0 ** -24
    return c * u / (1 - c * u) * scale, c


def corrected_dd_zb(B_dd_hi, B_dd_lo, fz):
    """z_r·b(p) before the rhs coefficients, compensated over the dual
    rank: (R, B) double-f32 ``(hi, lo)`` of Σ_m B[r, m]·fz[b, m], from
    the dd table B (R, rz) as its two f32 words and the f32 dual factors
    fz (B, rz).  Plain elementwise ``torch`` (:mod:`~pgdrome_tpu_torch.ops.ddf32`),
    bit for bit the JAX package's op by op."""
    from pgdrome_tpu_torch.ops.ddf32 import dd_mul_f, dd_sum

    ph, pl = dd_mul_f(B_dd_hi[:, None, :], B_dd_lo[:, None, :], fz[None, :, :])  # (R, B, rz)
    return dd_sum(ph, pl, axis=2)


def make_corrected_sensor_fn(dc: DualCorrector, *, method="auto", device="cuda"):
    """The corrected-output sweep on ``device``: ``samples (B, d) →
    (s_corr, s_plain)``, both (B,) float32.

    * fu and fz, the primal and dual mode-product factors, come from the
      sweep's factor kernel (``method`` as the sweep builders take it;
      the plain factor product for tables on the CPU), the θ tables' from
      the plain factor path;
    * the adjoint identity pre-cancels the large terms per primal mode:
      c_n(p) = L_n − Σ_t θ_t (f_zᵀ C_t)_n is O(dual error · |u_n|); the
      products f_z C_t run in true f32 (TF32 off);
    * the sum Σ_n fu_n c_n(p) over the primal rank is one f32 reduction,
      as the reference's: the W products' f32 rounding, amplified by
      |fu|, sets the sweep's error at the d=10 widths, not this sum
      (PERF.md §6.1);
    * z_r·b(p), the one large reduction (O(output), rz terms), runs
      compensated in double-f32 (:func:`corrected_dd_zb`);
    * s_plain = fu·L (for the estimate s_corr − s_plain), one f32
      product.

    Needs the corrector's auto-extracted collocation thetas.  Launches of
    the factor kernel count in ``ops.fused_sweep.LAUNCHES["factors"]``."""
    from pgdrome_tpu_torch.ops.ddf32 import dd_from_f64
    from pgdrome_tpu_torch.parallel.vademecum import _try_fused

    if dc._g_ops is None:
        raise ValueError("make_corrected_sensor_fn needs the auto-extracted collocation "
                         "thetas (explicit theta callables cannot be staged onto the device)")
    device = get_device(device)
    nf = dc.n_fixed
    spaces = [dc.Vs[0]] + list(dc.Vs[nf:])  # the parameter dims after one fixed dim
    ru, rz = dc.res_u.n_modes, dc.res_z.n_modes
    f32 = torch.float32

    def put(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32)).to(device).contiguous()

    mu = [put(host_f64(dc.res_u.modes[nf + j])[:ru]) for j in range(dc.num_params)]
    mz = [put(host_f64(dc.res_z.modes[nf + j])[:rz]) for j in range(dc.num_params)]
    g_ops = [put(g) for g in dc._g_ops]
    g_rhs = [put(g) for g in dc._g_rhs]
    L = put(dc.L)  # (ru,)
    C = put(dc.C)  # (T, rz, ru)
    B_dd = torch.as_tensor(dd_from_f64(dc.B)).to(device)  # (R, rz, 2)
    B_hi, B_lo = B_dd[..., 0].contiguous(), B_dd[..., 1].contiguous()
    fu_fused = _try_fused(spaces, None, mu, ru, method, "factors")
    fz_fused = _try_fused(spaces, None, mz, rz, method, "factors")

    def _prod(tables, samples):
        out = None
        for j, tab in enumerate(tables):
            v = evaluate_modes_1d(spaces[1 + j], tab, samples[:, j])
            out = v if out is None else out * v
        return out

    def fn(samples):
        s = torch.as_tensor(samples).to(device, f32).contiguous()
        fu = fu_fused(s) if fu_fused is not None else _prod(mu, s)  # (B, ru)
        fz = fz_fused(s) if fz_fused is not None else _prod(mz, s)  # (B, rz)
        th = _prod(g_ops, s)  # (B, T)
        hr = _prod(g_rhs, s)  # (B, R)
        W = torch.zeros_like(fu)
        for t in range(C.shape[0]):
            W = W + th[:, t : t + 1] * torch.matmul(fz, C[t])
        corr = (fu * (L[None, :] - W)).sum(dim=1)
        zb_h, zb_l = corrected_dd_zb(B_hi, B_lo, fz)  # (R, B)
        zb = ((zb_h + zb_l).T * hr).sum(dim=1)
        s_plain = torch.matmul(fu, L)
        return zb + corr, s_plain

    fn.factor_sweeps = (fu_fused, fz_fused)  # the kernels' bound sweeps (None: plain)
    return fn
