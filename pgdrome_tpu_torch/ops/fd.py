"""Finite-difference operators on non-uniform 1D grids (counterpart of
``pgdrome_tpu/ops/fd.py``).

Semantics match the reference free function ``FD_matrices``
(pgdrome/solver.py:947-988): lumped trapezoid mass M, 3-point second
derivative D2 (mass-weighted), and upwind first derivative D1_up whose
M·backward-difference structure makes the FD time dimension exactly
equivalent to backward Euler.

Returned as dense host f64 arrays (per-dim grids are small; a solve moves
them to the device once); use
:func:`apply_matrix_bc`/:func:`apply_vector_bc` for the row/column BC
zeroing idiom the reference applies in user callbacks
(test_laplace.py:398-401, 560-561).
"""

from __future__ import annotations

import numpy as np


def FD_matrices(x):
    """Build (M, D2, D1_up) on grid ``x`` (ascending, possibly non-uniform)."""
    x = np.asarray(x, dtype=np.float64).ravel()
    N = len(x)
    h = np.diff(x)  # (N-1,)
    hp = np.concatenate([h, [h[-1]]])  # hp[i] = x[i+1]-x[i] (last: dup)
    hm = np.concatenate([[h[0]], h])  # hm[i] = x[i]-x[i-1] (first: dup)

    M = np.zeros((N, N))
    D2 = np.zeros((N, N))
    D1 = np.zeros((N, N))

    idx = np.arange(1, N - 1)
    # mass (lumped trapezoid)
    M[0, 0] = h[0] / 2
    M[idx, idx] = (hp[idx] + hm[idx]) / 2
    M[N - 1, N - 1] = h[-1] / 2

    # second derivative (M-weighted 3-point)
    D2[0, 0] = -1 / h[0]
    D2[0, 1] = 1 / h[0]
    D2[idx, idx] = -(hp[idx] + hm[idx]) / (hp[idx] * hm[idx])
    D2[idx, idx + 1] = 1 / hp[idx]
    D2[idx, idx - 1] = 1 / hm[idx]
    D2[N - 1, N - 1] = -1 / h[-1]
    D2[N - 1, N - 2] = 1 / h[-1]

    # upwind first derivative (M-weighted backward difference)
    D1[0, 0] = -0.5
    D1[0, 1] = 0.5
    D1[idx, idx] = (hp[idx] + hm[idx]) / (2 * hm[idx])
    D1[idx, idx - 1] = -(hp[idx] + hm[idx]) / (2 * hm[idx])
    # last row: the reference reuses hp from the second-to-last interior
    # iteration, which equals h[-1] == hm there → coefficient 1
    D1[N - 1, N - 1] = (h[-1] + h[-1]) / (2 * h[-1])
    D1[N - 1, N - 2] = -(h[-1] + h[-1]) / (2 * h[-1])

    return M, D2, D1


def apply_matrix_bc(A, idx):
    """Zero rows+columns `idx` and put 1 on the diagonal (dense copy).

    The FD-callback BC idiom of the reference (test_laplace.py:398-401)."""
    A = np.array(A, dtype=np.float64)
    idx = np.asarray(idx)
    A[idx, :] = 0.0
    A[:, idx] = 0.0
    A[idx, idx] = 1.0
    return A


def apply_vector_bc(b, idx, value=0.0):
    """Set vector entries `idx` to `value` (test_laplace.py:560-561)."""
    b = np.array(b, dtype=np.float64)
    b[np.asarray(idx)] = value
    return b
