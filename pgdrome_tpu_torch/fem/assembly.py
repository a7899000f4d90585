"""Operator assembly on 1D spaces: mass and stiffness matrices and load
vectors as dense host f64 arrays (counterpart of the scalar part of
``pgdrome_tpu/fem/assembly.py``).

Assembly is one einsum over cells plus a scatter-add, done once per
(space, operator, weight) at setup time.  The scatter is numpy's
``np.add.at``, which adds in element order — the same order, and so the
same sums, as the JAX package's native scatter.
"""

from __future__ import annotations

import numpy as np

from pgdrome_tpu_torch.fem.space import FunctionSpace
from pgdrome_tpu_torch.fem.function import Function, Constant


def _weight_at_quadrature(V: FunctionSpace, w):
    """Evaluate a weight (None | scalar | Constant | Function | callable)
    at the space's quadrature points: an (nc, nq) array or a scalar."""
    if w is None:
        return 1.0
    if isinstance(w, (int, float)):
        return float(w)
    if isinstance(w, Constant):
        return float(w)
    if isinstance(w, Function):
        Vw = w.function_space()
        if Vw is V or (Vw.mesh() is V.mesh() and Vw.degree == V.degree):
            return np.einsum("cl,clq->cq", w.array[V.element_dofs], V.q_basis)
        from pgdrome_tpu_torch.fem.interpolate import eval_dofs_at_points

        return eval_dofs_at_points(Vw, w.array, V.q_points[..., 0])
    # Expression / plain callable
    return np.asarray(w(V.q_points[..., 0]), dtype=np.float64)


def _scatter_matrix(V: FunctionSpace, Ae):
    """Scatter per-cell element matrices (nc, nl, nl) into a dense (n, n)."""
    ed = V.element_dofs
    rows = np.broadcast_to(ed[:, :, None], Ae.shape).ravel()
    cols = np.broadcast_to(ed[:, None, :], Ae.shape).ravel()
    A = np.zeros((V.ndofs, V.ndofs))
    np.add.at(A, (rows, cols), np.ascontiguousarray(Ae, dtype=np.float64).ravel())
    return A


def _scatter_vector(V: FunctionSpace, be):
    b = np.zeros(V.ndofs)
    np.add.at(b, V.element_dofs.ravel(),
              np.ascontiguousarray(be, dtype=np.float64).ravel())
    return b


def mass_matrix(V: FunctionSpace, weight=None):
    """M[i,j] = ∫ w φi φj dx."""
    if weight is None and "mass" in V._cache:
        return V._cache["mass"]
    wq = _weight_at_quadrature(V, weight)
    Ae = np.einsum("cq,ciq,cjq->cij", V.q_weights * wq, V.q_basis, V.q_basis)
    M = _scatter_matrix(V, Ae)
    if weight is None:
        V._cache["mass"] = M
    return M


def stiffness_matrix(V: FunctionSpace, weight=None):
    """K[i,j] = ∫ w φi' φj' dx."""
    if weight is None and "stiff" in V._cache:
        return V._cache["stiff"]
    wq = _weight_at_quadrature(V, weight)
    Ae = np.einsum("cq,ciqg,cjqg->cij", V.q_weights * wq, V.q_grads, V.q_grads)
    K = _scatter_matrix(V, Ae)
    if weight is None:
        V._cache["stiff"] = K
    return K


def load_vector(V: FunctionSpace, g, weight=None) -> np.ndarray:
    """b[i] = ∫ w g φi dx; g may be a Function, an Expression, a callable
    or a Constant."""
    gq = _weight_at_quadrature(V, g)
    wq = _weight_at_quadrature(V, weight)
    if np.isscalar(gq):
        gq = gq * np.ones_like(V.q_weights)
    be = np.einsum("cq,ciq->ci", V.q_weights * wq * gq, V.q_basis)
    return _scatter_vector(V, be)
