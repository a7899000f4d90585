"""Operator assembly: mass, stiffness, advection and elasticity matrices,
vector mass, load and boundary-load vectors, as host f64 arrays, dense or
scipy-sparse (counterpart of ``pgdrome_tpu/fem/assembly.py``).

Assembly is one einsum over cells plus a scatter-add, done once per
(space, operator, weight) at set-up time.  The dense scatter is numpy's
``np.add.at``, which adds in element order — the same order, and so the
same sums, as the JAX package's native scatter.  The sparse forms (for
large reference solves; the PGD per-dim operators stay dense) are scipy
COO → CSR, as in the JAX package.
"""

from __future__ import annotations

import numpy as np

from pgdrome_tpu_torch.fem.space import FunctionSpace, gauss_legendre_01, _shape_1d
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
    pts = V.q_points[..., 0] if V.mesh().geometry_dim() == 1 else V.q_points
    if isinstance(w, Function):
        Vw = w.function_space()
        if Vw.value_size > 1:
            raise ValueError("scalar weight required")
        if Vw is V or (Vw.mesh() is V.mesh() and Vw.degree == V.degree
                       and Vw.family == V.family):
            return np.einsum("cl,clq->cq", w.array[V.element_dofs], V.q_basis)
        from pgdrome_tpu_torch.fem.interpolate import eval_dofs_at_points

        return eval_dofs_at_points(Vw, w.array, pts)
    # Expression / plain callable
    return np.asarray(w(pts), dtype=np.float64)


def _add_at(n, rows, cols, Ae):
    """Dense (n, n) sum of the entries ``Ae`` at (rows, cols), in element
    order."""
    A = np.zeros((n, n))
    np.add.at(A, (np.broadcast_to(rows, Ae.shape).ravel(),
                  np.broadcast_to(cols, Ae.shape).ravel()),
              np.ascontiguousarray(Ae, dtype=np.float64).ravel())
    return A


def _coo(n, rows, cols, Ae):
    """scipy CSR (n, n) sum of the entries ``Ae`` at (rows, cols)."""
    from scipy import sparse

    return sparse.coo_matrix(
        (np.asarray(Ae).ravel(), (np.broadcast_to(rows, Ae.shape).ravel(),
                                  np.broadcast_to(cols, Ae.shape).ravel())),
        shape=(n, n)).tocsr()


def _scatter_matrix(V: FunctionSpace, Ae):
    """Scatter per-cell element matrices (nc, nl, nl) into a dense (n, n)."""
    ed = V.element_dofs
    return _add_at(V.ndofs, ed[:, :, None], ed[:, None, :], Ae)


def _scatter_matrix_sparse(V: FunctionSpace, Ae):
    """Scatter element matrices into a scipy CSR matrix."""
    ed = V.element_dofs
    return _coo(V.ndofs, ed[:, :, None], ed[:, None, :], Ae)


def _scatter_vector(V: FunctionSpace, be):
    b = np.zeros(V.ndofs)
    np.add.at(b, V.element_dofs.ravel(),
              np.ascontiguousarray(be, dtype=np.float64).ravel())
    return b


def _require_scalar(V):
    if V.value_size > 1:
        raise ValueError(
            "scalar-space operator requested on a vector space; "
            "use the elasticity/vector variants"
        )


def mass_matrix(V: FunctionSpace, weight=None, sparse: bool = False):
    """M[i,j] = ∫ w φi φj dx."""
    _require_scalar(V)
    if weight is None and not sparse and "mass" in V._cache:
        return V._cache["mass"]
    wq = _weight_at_quadrature(V, weight)
    Ae = np.einsum("cq,ciq,cjq->cij", V.q_weights * wq, V.q_basis, V.q_basis)
    if sparse:
        return _scatter_matrix_sparse(V, Ae)
    M = _scatter_matrix(V, Ae)
    if weight is None:
        V._cache["mass"] = M
    return M


def stiffness_matrix(V: FunctionSpace, weight=None, sparse: bool = False):
    """K[i,j] = ∫ w ∇φi·∇φj dx."""
    _require_scalar(V)
    if weight is None and not sparse and "stiff" in V._cache:
        return V._cache["stiff"]
    wq = _weight_at_quadrature(V, weight)
    Ae = np.einsum("cq,ciqg,cjqg->cij", V.q_weights * wq, V.q_grads, V.q_grads)
    if sparse:
        return _scatter_matrix_sparse(V, Ae)
    K = _scatter_matrix(V, Ae)
    if weight is None:
        V._cache["stiff"] = K
    return K


def advection_matrix(V: FunctionSpace, weight=None, direction: int = 0) -> np.ndarray:
    """A[i,j] = ∫ w φi ∂φj/∂x_direction dx (test i rows, trial j columns)."""
    _require_scalar(V)
    wq = _weight_at_quadrature(V, weight)
    Ae = np.einsum("cq,ciq,cjq->cij", V.q_weights * wq, V.q_basis,
                   V.q_grads[..., direction])
    return _scatter_matrix(V, Ae)


def load_vector(V: FunctionSpace, g, weight=None) -> np.ndarray:
    """b[i] = ∫ w g φi dx; g may be a Function, an Expression, a callable
    or a Constant."""
    _require_scalar(V)
    gq = _weight_at_quadrature(V, g)
    wq = _weight_at_quadrature(V, weight)
    if np.isscalar(gq):
        gq = gq * np.ones_like(V.q_weights)
    be = np.einsum("cq,ciq->ci", V.q_weights * wq * gq, V.q_basis)
    return _scatter_vector(V, be)


def assemble_vector(V: FunctionSpace, g, weight=None) -> np.ndarray:
    """Alias of :func:`load_vector` (reads closer to dolfin.assemble)."""
    return load_vector(V, g, weight)


# the Voigt strain rows of one scalar basis gradient's vector components
# (2D: εxx, εyy, γxy; 3D: εxx, εyy, εzz, γyz, γxz, γxy), as indices into
# (∂x, ∂y[, ∂z]) with -1 for a zero entry
_VOIGT = {
    2: ((0, -1, 1), (-1, 1, 0)),
    3: ((0, -1, -1, -1, 2, 1), (-1, 1, -1, 2, -1, 0), (-1, -1, 2, 1, 0, -1)),
}


def _elasticity(V: FunctionSpace, C, gdim: int, sparse: bool):
    """K[i,j] = ∫ ε(φi) : C : ε(φj) dx on a ``gdim``-vector space, C the
    constant Voigt matrix (engineering shear)."""
    if V.value_size != gdim:
        raise ValueError(f"elasticity_matrix{'_3d' if gdim == 3 else ''} needs a "
                         f"{gdim}D vector space")
    C = np.asarray(C, dtype=np.float64)
    grads = V.q_grads  # (nc, nl, nq, gdim) scalar-basis gradients
    nc, nl, nq, _ = grads.shape
    z = np.zeros((nc, nl, nq))
    comps = [np.stack([z if a < 0 else grads[..., a] for a in rows], axis=-1)
             for rows in _VOIGT[gdim]]
    B = np.stack(comps, axis=2).reshape(nc, nl * gdim, nq, C.shape[0])  # dof-major (l, c)
    CB = np.einsum("vw,cjqw->cjqv", C, B)
    Ae = np.einsum("cq,ciqv,cjqv->cij", V.q_weights, B, CB)
    ed = V.element_dofs
    vd = (ed[:, :, None] * gdim + np.arange(gdim)[None, None, :]).reshape(nc, nl * gdim)
    rows, cols = vd[:, :, None], vd[:, None, :]
    return _coo(V.dim(), rows, cols, Ae) if sparse else _add_at(V.dim(), rows, cols, Ae)


def elasticity_matrix(V: FunctionSpace, C, sparse: bool = False):
    """K[i,j] = ∫ ε(φi) : C : ε(φj) dx for a 2D vector space, with C a
    constant 3×3 Voigt matrix (εxx, εyy, γxy)."""
    return _elasticity(V, C, 2, sparse)


def elasticity_matrix_3d(V: FunctionSpace, C, sparse: bool = False):
    """K[i,j] = ∫ ε(φi) : C : ε(φj) dx for a 3D vector space; C is a 6×6
    Voigt matrix (εxx, εyy, εzz, γyz, γxz, γxy)."""
    return _elasticity(V, C, 3, sparse)


def vector_mass_matrix(V: FunctionSpace, weight=None, sparse: bool = False):
    """Block mass matrix of a vector space (interleaved dofs)."""
    key = "vmass_sp" if sparse else "vmass"
    if weight is None and key in V._cache:
        return V._cache[key]
    Vs = FunctionSpace(V.mesh(), V.family, V.degree)
    vs = V.value_size
    n = Vs.ndofs
    if sparse:
        from scipy import sparse as sps

        Ms = mass_matrix(Vs, weight, sparse=True).tocoo()
        rows = np.concatenate([Ms.row * vs + c for c in range(vs)])
        cols = np.concatenate([Ms.col * vs + c for c in range(vs)])
        data = np.concatenate([Ms.data for _ in range(vs)])
        M = sps.coo_matrix((data, (rows, cols)), shape=(n * vs, n * vs)).tocsr()
    else:
        Ms = mass_matrix(Vs, weight)
        M = np.zeros((n * vs, n * vs))
        for c in range(vs):
            idx = np.arange(n) * vs + c
            M[np.ix_(idx, idx)] += Ms
    if weight is None:
        V._cache[key] = M
    return M


def _boundary_edges(V: FunctionSpace):
    """Boundary edges of a 2D mesh: the scalar dofs whose trace lives on
    each edge, in 1D order [va, (mid,) vb], and its endpoint coordinates."""
    mesh = V.mesh()
    cells = mesh.cells()
    e_all = np.concatenate([cells[:, [1, 2]], cells[:, [0, 2]], cells[:, [0, 1]]], axis=0)
    uniq, counts = np.unique(np.sort(e_all, axis=1), axis=0, return_counts=True)
    coords = mesh.coordinates()
    nv = mesh.num_vertices()
    out = []
    for eidx in np.where(counts == 1)[0]:
        va, vb = uniq[eidx]
        # a P2 edge dof is nv + the edge's index among the sorted pairs
        dofs = np.array([va, nv + eidx, vb]) if V.degree == 2 else np.array([va, vb])
        out.append((dofs, coords[[va, vb]]))
    return out


def boundary_load_vector(V: FunctionSpace, g, marker=None) -> np.ndarray:
    """b[i] = ∫_Γ g·φi ds over the boundary edges selected by ``marker``
    (a callable on the edge midpoint → bool; None = the whole boundary)."""
    vs = max(V.value_size, 1)
    deg = V.degree
    xi, w = gauss_legendre_01(2 * deg + 1)
    vals, _ = _shape_1d(deg, xi)  # trace basis (nl1d, nq)
    b = np.zeros(V.dim())
    for dofs, (pa, pb) in _boundary_edges(V):
        if marker is not None and not marker(0.5 * (pa + pb)):
            continue
        length = float(np.linalg.norm(pb - pa))
        qpts = pa[None, :] + xi[:, None] * (pb - pa)[None, :]  # (nq, 2)
        gvals = np.asarray(g(qpts), dtype=np.float64)  # (nq,) or (nq, vs)
        if vs == 1:
            b[dofs] += (vals * (w * gvals)[None, :]).sum(axis=1) * length
            continue
        if gvals.ndim == 1:
            gvals = np.tile(gvals[:, None], (1, vs))
        for c in range(vs):
            b[dofs * vs + c] += (vals * (w * gvals[:, c])[None, :]).sum(axis=1) * length
    return b


def gram(f, A, g) -> float:
    """Scalar ⟨f, A g⟩ = fᵀ A g for Functions or arrays (A dense or
    scipy-sparse)."""
    fa = f.array if isinstance(f, Function) else np.asarray(f)
    ga = g.array if isinstance(g, Function) else np.asarray(g)
    return float(fa @ (A @ ga))


def _space_mass(V):
    return vector_mass_matrix(V) if V.value_size > 1 else mass_matrix(V)


def norm(f, M=None) -> float:
    """L2 norm sqrt(fᵀ M f); M defaults to the consistent mass matrix of
    f's space (dolfin.norm parity)."""
    if isinstance(f, Function):
        if M is None:
            M = _space_mass(f.function_space())
        arr = f.array
    else:
        arr = np.asarray(f)
        if M is None:
            raise ValueError("raw-array norm needs an explicit mass matrix")
    return float(np.sqrt(np.abs(arr @ (M @ arr))))


def inner_l2(f, g, M=None) -> float:
    """⟨f, g⟩_L2 = fᵀ M g with the consistent mass matrix."""
    if isinstance(f, Function) and M is None:
        M = _space_mass(f.function_space())
    return gram(f, M, g)
