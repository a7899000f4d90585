"""Linear and nonlinear solvers for the per-dimension PGD subproblems
(counterpart of ``pgdrome_tpu/ops/solvers.py``).

:func:`solve_dense`, :func:`newton_solve_np` and :func:`picard_solve_np`
are host numpy/scipy, as in the JAX package.  :func:`newton_solve` runs on
the device: the Jacobian comes from ``torch.func.jacfwd`` and the loop is a
fixed count of ``max_iter`` steps in place of ``lax.while_loop``, each step
after convergence masked out with ``torch.where`` on 0-d tensors, so the
result equals the reference's early exit and nothing in the loop waits for
the device.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["solve_dense", "newton_solve_np", "picard_solve_np", "newton_solve"]


def solve_dense(A, b):
    """Dense direct solve: numpy inputs solve on the host, tensors where
    they lie (``torch.linalg.solve``)."""
    if isinstance(A, np.ndarray) and isinstance(b, np.ndarray):
        return np.linalg.solve(A, b)
    return torch.linalg.solve(torch.as_tensor(A), torch.as_tensor(b))


def newton_solve_np(residual_fn, u0, bc_dofs=None, bc_values=None, atol=1e-10,
                    rtol=1e-9, max_iter=50):
    """Host Newton with a finite-difference Jacobian (for callbacks that
    return residual vectors; per-dim systems are small, so n + 1 residual
    evaluations a step are cheap).  Returns ``(u, converged, num_iter)``."""
    u = np.array(u0, dtype=np.float64)
    n = len(u)
    have_bc = bc_dofs is not None and len(bc_dofs) > 0

    def cres(v):
        r = np.asarray(residual_fn(v), dtype=np.float64).copy()
        if have_bc:
            r[bc_dofs] = v[bc_dofs] - bc_values
        return r

    r = cres(u)
    r0 = np.linalg.norm(r)
    it = 0
    while it < max_iter:
        rn = np.linalg.norm(r)
        if rn <= atol or rn <= rtol * (r0 + 1e-300):
            return u, True, it
        J = np.zeros((n, n))
        eps = 1e-7 * max(1.0, np.linalg.norm(u))
        for j in range(n):
            up = u.copy()
            up[j] += eps
            J[:, j] = (cres(up) - r) / eps
        u = u + np.linalg.solve(J, -r)
        r = cres(u)
        it += 1
    rn = np.linalg.norm(r)
    return u, bool(rn <= atol or rn <= rtol * (r0 + 1e-300)), it


def picard_solve_np(system_fn, u0, bcs=(), atol=1e-12, rtol=1e-10, max_iter=50):
    """Host Picard iteration for quasi-linear ``A(u) u = b(u)``:
    u ← solve(A(u), b(u)) until the update stalls (one step for a linear
    problem).  ``bcs``: objects whose ``apply_system(A, b)`` returns the
    constrained pair.  Returns ``(u, converged, num_iter)``."""
    from scipy import sparse as sps
    from scipy.sparse import linalg as spla

    u = np.array(u0, dtype=np.float64)
    for it in range(max_iter):
        A, b = system_fn(u)
        b = np.array(b, dtype=np.float64)
        for bc in bcs:
            A, b = bc.apply_system(A, b)
        if sps.issparse(A):
            u_new = spla.spsolve(A.tocsr(), b)
        else:
            u_new = np.linalg.solve(np.asarray(A, dtype=np.float64), b)
        dn = np.linalg.norm(u_new - u)
        u = u_new
        if dn <= atol or dn <= rtol * (np.linalg.norm(u) + 1e-300):
            return u, True, it + 1
    return u, False, max_iter


def newton_solve(residual_fn, u0, bc_dofs=None, bc_values=None, atol=1e-10, rtol=1e-9,
                 max_iter=50):
    """Newton's method on ``residual_fn(u) = 0`` on the device, with
    optional Dirichlet constraints (rows replaced by ``u[d] − g``).

    ``residual_fn`` must be ``torch.func``-traceable (no in-place writes to
    its argument, no host reads).  The loop runs ``max_iter`` masked steps:
    a step is taken while the residual norm is above ``atol`` and above
    ``rtol``·‖r(u0)‖ — the reference's while-loop condition — and the
    steps after that leave ``u`` as it is.  Returns ``(u, converged,
    num_iter)``, the last two 0-d tensors on ``u0``'s device."""
    u = torch.as_tensor(u0)
    have_bc = bc_dofs is not None and len(bc_dofs) > 0
    if have_bc:
        idx = torch.as_tensor(np.asarray(bc_dofs), device=u.device)
        mask = torch.zeros(u.shape[0], dtype=torch.bool, device=u.device)
        mask[idx] = True
        g = torch.zeros_like(u)
        g[idx] = torch.as_tensor(np.asarray(bc_values), dtype=u.dtype, device=u.device)

    def constrained_residual(v):
        r = residual_fn(v)
        if have_bc:
            r = torch.where(mask, v - g, r)
        return r

    jac = torch.func.jacfwd(constrained_residual)
    r0norm = torch.linalg.norm(constrained_residual(u))
    limit = rtol * (r0norm + 1e-300)
    rnorm = r0norm
    it = torch.zeros((), dtype=torch.int64, device=u.device)
    for _ in range(max_iter):
        active = (rnorm > atol) & (rnorm > limit)
        du = torch.linalg.solve_ex(jac(u), -constrained_residual(u))[0]
        u_new = u + du
        u = torch.where(active, u_new, u)
        rnorm = torch.where(active, torch.linalg.norm(constrained_residual(u_new)), rnorm)
        it = it + active.to(it.dtype)
    converged = (rnorm <= atol) | (rnorm <= limit)
    return u, converged, it
