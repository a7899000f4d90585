"""Greedy separated (CP-like) approximation of multivariate functions
(counterpart of ``pgdrome_tpu/utils/separation.py``; host numpy).

PGD needs LOADS in separated form (Σ_r ⊗_d g_rd).  Simple sources separate
by inspection, but e.g. a moving heat source q(x − v·t) (welding and
additive-manufacturing surrogates) does not.  This module builds a rank-R
separated approximation of a sampled tensor by greedy successive SVDs:

    values ≈ Σ_r  u_r ⊗ w_r(rest)   with  w_r  separated recursively.

For 2D tensors this is the truncated SVD (optimal); for d > 2 it is the
standard greedy PGD-style separation (each rank-1 term from leading
singular vectors of the residual's unfoldings).
"""

from __future__ import annotations

import numpy as np


def separate_rank1(values: np.ndarray, als_iters: int = 12):
    """Dominant rank-1 term of a d-way tensor: HOSVD leading vectors as the
    initial guess, refined by alternating least squares (each factor is the
    tensor contracted with all other normalized factors — the optimal
    rank-1 update per dimension).  Returns (factors, rank1_tensor)."""
    d = values.ndim
    factors = []
    for axis in range(d):
        unfold = np.moveaxis(values, axis, 0).reshape(values.shape[axis], -1)
        u, _, _ = np.linalg.svd(unfold, full_matrices=False)
        factors.append(u[:, 0])

    letters = "ijklmnop"[:d]
    for _ in range(als_iters):
        for axis in range(d):
            others = [factors[a] for a in range(d) if a != axis]
            sub = letters.replace(letters[axis], "")
            expr = f"{letters}," + ",".join(sub) + f"->{letters[axis]}"
            num = np.einsum(expr, values, *others)
            denom = np.prod([f @ f for f in others])
            factors[axis] = num / (denom + 1e-300)
        # renormalize all but the first factor for stability
        for axis in range(1, d):
            n = np.linalg.norm(factors[axis])
            if n > 0:
                factors[axis] /= n
                factors[0] *= n

    t = factors[0]
    for f in factors[1:]:
        t = np.multiply.outer(t, f)
    return factors, t


def separate(values: np.ndarray, rank: int, tol: float = 1e-10):
    """Greedy rank-R separation: returns a list over dims of (R, n_d)
    factor matrices with  values ≈ Σ_r ⊗_d factors[d][r].

    Greedy: repeatedly strip the dominant rank-1 term from the residual.
    Relative Frobenius tolerance `tol` stops early."""
    values = np.asarray(values, dtype=np.float64)
    d = values.ndim
    norm0 = np.linalg.norm(values)
    residual = values.copy()
    facs = [[] for _ in range(d)]
    for r in range(rank):
        f, t = separate_rank1(residual)
        for dim in range(d):
            facs[dim].append(f[dim])
        residual = residual - t
        if norm0 > 0 and np.linalg.norm(residual) / norm0 < tol:
            break
    return [np.stack(f) for f in facs]


def separation_error(values: np.ndarray, factors) -> float:
    """Relative Frobenius error of a separated representation."""
    approx = np.zeros_like(values, dtype=np.float64)
    R = factors[0].shape[0]
    for r in range(R):
        t = factors[0][r]
        for d in range(1, len(factors)):
            t = np.multiply.outer(t, factors[d][r])
        approx += t
    return float(np.linalg.norm(values - approx) / np.linalg.norm(values))


def separate_function(fn, grids, rank: int, tol: float = 1e-10):
    """Sample ``fn(*mesh coordinates)`` on the tensor grid and separate.

    fn: callable taking d broadcastable coordinate arrays;
    grids: per-dim 1D coordinate arrays.  Returns factor matrices (R, n_d).
    """
    mesh = np.meshgrid(*grids, indexing="ij")
    values = np.asarray(fn(*mesh), dtype=np.float64)
    return separate(values, rank, tol)


def separate_hierarchical(values: np.ndarray, tol: float = 1e-6,
                          max_terms: int = 200):
    """Two-level SVD separation of a 3-way tensor (hierarchical-Tucker
    style): SVD over axis 0 vs (1,2), then each right singular vector over
    axis 1 vs 2.  Every kept pair becomes a rank-1 (x, t, v) term.

    For transport-like tensors (moving sources q(x − v·t)) this reaches a
    given accuracy with far fewer terms than the greedy CP sweep: both SVD
    levels are optimal truncations.  Returns factor matrices (R, n_d) in
    the same layout as :func:`separate`."""
    values = np.asarray(values, dtype=np.float64)
    if values.ndim != 3:
        raise ValueError("separate_hierarchical expects a 3-way tensor")
    n0, n1, n2 = values.shape
    U, S, Vt = np.linalg.svd(values.reshape(n0, n1 * n2), full_matrices=False)
    total = np.sqrt(np.sum(S**2))
    # keep outer components until the tail is below tol
    tail = np.sqrt(np.maximum(np.cumsum(S[::-1] ** 2)[::-1] - S**2, 0.0))
    R1 = int(np.searchsorted(-tail, -tol * total) + 1)
    R1 = min(max(R1, 1), len(S))

    # split every kept outer component, then keep the globally largest
    # (i, j) terms — truncating per-component instead would starve later
    # outer components of budget
    cand = []  # (magnitude, x_factor, t_factor, v_factor)
    for i in range(R1):
        W = (S[i] * Vt[i]).reshape(n1, n2)
        Ui, Si, Vit = np.linalg.svd(W, full_matrices=False)
        wtail = np.sqrt(np.maximum(np.cumsum(Si[::-1] ** 2)[::-1] - Si**2, 0.0))
        R2 = int(np.searchsorted(-wtail, -tol * max(total, 1e-300)) + 1)
        R2 = min(max(R2, 1), len(Si))
        for j in range(R2):
            cand.append((Si[j], U[:, i] * Si[j], Ui[:, j], Vit[j]))
    cand.sort(key=lambda c: -c[0])
    cand = cand[:max_terms]
    f0 = np.stack([c[1] for c in cand])
    f1 = np.stack([c[2] for c in cand])
    f2 = np.stack([c[3] for c in cand])
    return [f0, f1, f2]
