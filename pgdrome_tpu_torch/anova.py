"""Anchored-ANOVA start for high-dimensional collocation PGD (counterpart
of ``pgdrome_tpu/anova.py``: ``CollocationPointSolver``,
``_rand_range_svd``, ``anova_init``).

With collocation (diagonal) parameter operators the tensor system
decouples into one banded dim-0 FEM system per parameter grid point, so
full axis sweeps (d·n_p solves) and pair tables (n_p² solves each) are
exact host f64 solves.  The anchored-ANOVA surrogate

    u ≈ u(p̄) + Σ_i [u(p_i, p̄_-i) − u(p̄)]
          + Σ_{i<j} [u(p_i, p_j, p̄_-ij) − u_i − u_j − u(p̄)]

is exact on every axis line (order ≥ 1) and pair plane (order ≥ 2)
through the anchor p̄; the tables are SVD-compressed into separated
rank-1 modes whose factors are ones on the untouched dims, the format
every later stage takes (:func:`~pgdrome_tpu_torch.recipes.adaptive_cascade`
``init_result``).  Everything here is host numpy/scipy f64: a per-point
banded solve and an SVD compression, no device work.
"""

from __future__ import annotations

import time

import numpy as np

from pgdrome_tpu_torch.separated import PGDResult, SeparatedProblem, host_f64

__all__ = ["CollocationPointSolver", "anova_init"]


class CollocationPointSolver:
    """Exact f64 solver at one parameter grid point of a collocation
    separated problem: a banded dim-0 solve with the point's separated
    coefficients.

    Every parameter dim's operator stack must be diagonal (collocation or
    lumped); then ``solve(idx)`` is the exact full-order solution at grid
    multi-index ``idx`` (boundary-boost re-weightings cancel between the
    lhs and the rhs)."""

    def __init__(self, sep: SeparatedProblem):
        ops0 = host_f64(sep.ops[0])
        m = host_f64(sep.bc_masks[0])
        T, n, _ = ops0.shape
        Am = ops0 * m[None, :, None] * m[None, None, :]
        bw = 0
        for t in range(T):
            r, c = np.nonzero(Am[t])
            if r.size:
                bw = max(bw, int(np.abs(r - c).max()))
        self.bw = bw
        self.n0 = n
        bands = np.zeros((T, 2 * bw + 1, n))
        for t in range(T):
            for k in range(-bw, bw + 1):
                d = np.diagonal(Am[t], k)
                if k >= 0:
                    bands[t, bw - k, k:k + d.size] = d
                else:
                    bands[t, bw - k, :d.size] = d
        self.bands = bands
        self.diag_bc = 1.0 - m  # identity rows on constrained dofs
        self.rhs0 = host_f64(sep.rhs[0]) * m[None, :]
        self.C = []  # per param dim: (T, n_d) lhs diagonals
        self.G = []  # per param dim: (R, n_d) rhs factors
        for d in range(1, sep.num_dims):
            od = host_f64(sep.ops[d])
            diag = np.ascontiguousarray(np.diagonal(od, axis1=1, axis2=2))
            off = np.abs(od - diag[:, :, None] * np.eye(od.shape[1])).max()
            if off > 1e-12 * max(np.abs(diag).max(), 1.0):
                raise ValueError(
                    f"dim {d} operator stack is not diagonal (max "
                    f"off-diagonal {off:.2e}): anchored-ANOVA axis sweeps "
                    "need a collocation discretization (parametric_elliptic "
                    "param_discretization='collocation')"
                )
            self.C.append(diag)
            self.G.append(host_f64(sep.rhs[d]))

    def solve_coeffs(self, c_t: np.ndarray, g_r: np.ndarray) -> np.ndarray:
        """Solve the dim-0 system with lhs term weights ``c_t`` (T,) and
        rhs term weights ``g_r`` (R,)."""
        from scipy.linalg import solve_banded

        ab = np.tensordot(c_t, self.bands, axes=1)
        ab[self.bw] += self.diag_bc
        b = g_r @ self.rhs0
        return solve_banded((self.bw, self.bw), ab, b)

    def point_coeffs(self, idx):
        """(c_t, g_r) at the parameter grid multi-index ``idx``."""
        c = np.ones(self.bands.shape[0])
        g = np.ones(self.rhs0.shape[0])
        for d, a in enumerate(idx):
            c = c * self.C[d][:, a]
            g = g * self.G[d][:, a]
        return c, g

    def solve(self, idx) -> np.ndarray:
        """Exact full-order dof vector at parameter grid multi-index
        ``idx``."""
        return self.solve_coeffs(*self.point_coeffs(idx))


def _rand_range_svd(X: np.ndarray, k: int, n_power: int = 2, rng=None):
    """Randomized thin SVD of ``X.T`` (n0 × n_ab): ``(U (n0, k), s (k,),
    Vt (k, n_ab))`` at O(n0·n_ab·k), with ``n_power`` power iterations."""
    rng = rng or np.random.default_rng(0)
    n_ab, n0 = X.shape
    k = min(k, n_ab, n0)
    Om = rng.standard_normal((n_ab, k))
    Y = X.T @ Om  # (n0, k)
    Q, _ = np.linalg.qr(Y)
    for _ in range(n_power):
        Z = X @ Q  # (n_ab, k)
        Q, _ = np.linalg.qr(X.T @ Z)
    B = Q.T @ X.T  # (k, n_ab)
    Ub, s, Vt = np.linalg.svd(B, full_matrices=False)
    return Q @ Ub, s, Vt


def anova_init(sep: SeparatedProblem, *, order: int = 2, anchor=None,
               tf=None, tol_axis: float = 1e-10, tol_pair: float = 2e-7,
               pairs=None, max_pair_rank: int = 48, pair_dtype=np.float32,
               log=None):
    """The anchored-ANOVA surrogate of a collocation separated problem as
    a :class:`~pgdrome_tpu_torch.separated.PGDResult` — an ``init_result``
    for :func:`~pgdrome_tpu_torch.recipes.adaptive_cascade`.

    sep: the host f64 problem in the nodal basis.  order: 1 = anchor solve
    plus axis corrections (exact on the axis lines through the anchor);
    2 = also the pair corrections (exact on the pair planes).  anchor:
    per-param grid indices of p̄ (default: the grid middle).
    tol_axis / tol_pair: singular-value cut-offs relative to ‖u(p̄)‖₂.
    pairs: the (i, j) 0-based param pairs of order 2 (default: all).
    tf: a :class:`~pgdrome_tpu_torch.separated.Dim0Transform` — the dim-0
    factors are then given in its preconditioned basis
    (:meth:`~pgdrome_tpu_torch.separated.Dim0Transform.full_to_modes`).
    pair_dtype: the pair tables' storage (f32 resolves their O(1e-3)·‖u‖
    deltas to ~1e-10 absolute at half the memory of f64).

    Returns ``(result, report)``: the result's modes are host f64 arrays,
    its amplitudes, alpha ones and fp_its zeros; the report holds the
    anchor, ‖u(p̄)‖, per-axis and per-pair kept ranks, truncation tails
    (the first dropped σ relative to ‖u(p̄)‖; a pair whose rank hit
    ``max_pair_rank`` reports its last computed σ and ``rank_capped``),
    each pair's seconds (``s``), the rank and the wall seconds."""
    say = log or (lambda *a: None)
    ps = CollocationPointSolver(sep)
    P = sep.num_dims - 1
    sizes = [int(sep.ops[d].shape[1]) for d in range(sep.num_dims)]
    if anchor is None:
        anchor = [sizes[1 + d] // 2 for d in range(P)]
    anchor = list(anchor)

    t0 = time.perf_counter()
    cA = [ps.C[d][:, anchor[d]] for d in range(P)]
    gA = [ps.G[d][:, anchor[d]] for d in range(P)]

    def coeffs_at(over: dict):
        """(c_t, g_r) with the dims in ``over`` at the given grid index and
        every other dim at the anchor."""
        c = np.ones(ps.bands.shape[0])
        g = np.ones(ps.rhs0.shape[0])
        for d in range(P):
            a = over.get(d)
            if a is None:
                c, g = c * cA[d], g * gA[d]
            else:
                c, g = c * ps.C[d][:, a], g * ps.G[d][:, a]
        return c, g

    u0 = ps.solve_coeffs(*coeffs_at({}))
    nrm0 = float(np.linalg.norm(u0))

    # axis sweeps: each dim's exact line through the anchor, minus u0
    axis_tab = []
    mode_x = [u0]  # dim-0 factors (nodal, scale folded in)
    mode_p = [[np.ones(sizes[1 + d]) for d in range(P)]]
    report = {"order": int(order), "anchor": anchor, "norm_u0": nrm0,
              "axis": [], "pairs": []}
    for i in range(P):
        n_i = sizes[1 + i]
        Ui = np.empty((n_i, ps.n0))
        for a in range(n_i):
            Ui[a] = ps.solve_coeffs(*coeffs_at({i: a}))
        Ui -= u0[None, :]
        axis_tab.append(Ui.copy())
        U, s, Vt = np.linalg.svd(Ui.T, full_matrices=False)
        k = int(np.sum(s > tol_axis * nrm0))
        report["axis"].append({
            "dim": i, "rank": k,
            "tail": float(s[k] / nrm0) if k < s.size else 0.0,
        })
        for r in range(k):
            mode_x.append(U[:, r] * s[r])
            fac = [np.ones(sizes[1 + d]) for d in range(P)]
            fac[i] = Vt[r].copy()
            mode_p.append(fac)
    say(f"anova axes: {P} sweeps, ranks "
        f"{[a['rank'] for a in report['axis']]}, "
        f"{time.perf_counter() - t0:.1f} s")

    # pair tables: the exact pair plane minus its two axis lines and u0
    if order >= 2:
        if pairs is None:
            pairs = [(i, j) for i in range(P) for j in range(i + 1, P)]
        rng = np.random.default_rng(7)
        for (i, j) in pairs:
            t1 = time.perf_counter()
            n_i, n_j = sizes[1 + i], sizes[1 + j]
            D = np.empty((n_i * n_j, ps.n0), dtype=pair_dtype)
            for a in range(n_i):
                base = u0 + axis_tab[i][a]
                for b in range(n_j):
                    c, g = coeffs_at({i: a, j: b})
                    D[a * n_j + b] = ps.solve_coeffs(c, g) - base - axis_tab[j][b]
            U, s, Vt = _rand_range_svd(D, max_pair_rank, rng=rng)
            k = int(np.sum(s > tol_pair * nrm0))
            # rank cap hit: the dropped tail is unknown, bounded by the
            # last computed σ, and reported as such
            capped = k == s.size
            kept = 0
            for r in range(k):
                W = Vt[r].reshape(n_i, n_j)
                Uw, sw, Vtw = np.linalg.svd(W, full_matrices=False)
                for q in range(sw.size):
                    if s[r] * sw[q] <= tol_pair * nrm0:
                        break
                    mode_x.append(U[:, r] * (s[r] * sw[q]))
                    fac = [np.ones(sizes[1 + d]) for d in range(P)]
                    fac[i] = Uw[:, q].copy()
                    fac[j] = Vtw[q].copy()
                    mode_p.append(fac)
                    kept += 1
            report["pairs"].append({
                "pair": (i, j), "rank": kept,
                "sigma1": float(s[0] / nrm0) if s.size else 0.0,
                "tail": (float(s[k] / nrm0) if not capped
                         else float(s[-1] / nrm0)),
                "rank_capped": bool(capped),
                "s": round(time.perf_counter() - t1, 2),
            })
            say(f"anova pair ({i},{j}): sigma1 {s[0] / nrm0:.2e} "
                f"rank {kept} ({time.perf_counter() - t1:.1f} s)")

    K = len(mode_x)
    m0 = np.stack(mode_x)  # (K, n0) nodal
    if tf is not None:
        m0 = tf.full_to_modes(m0)
    modes = [m0]
    for d in range(P):
        modes.append(np.stack([mode_p[r][d] for r in range(K)]))
    report["rank"] = K
    report["wall_s"] = round(time.perf_counter() - t0, 1)
    say(f"anova init: rank {K} ({report['wall_s']} s)")
    res = PGDResult(
        modes=modes, n_modes=K, amplitudes=np.ones(K),
        alpha=np.ones(K), fp_its=np.zeros(K), normU0=1.0,
    )
    return res, report
