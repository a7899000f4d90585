"""Exact derivatives of FE functions onto DG spaces (counterpart of
``pgdrome_tpu/fem/derivative.py``).

The derivative of a piecewise polynomial of degree k is a discontinuous
piecewise polynomial of degree k − 1, so projecting it onto DG(k − 1) is
interpolation at the DG nodes: no solve.

* 1D scalar CG(k) → DG(k − 1) scalar (d/dx);
* 2D/3D scalar CG(k) → DG(k − 1) gdim-vector (∇u), :func:`gradient_function`;
  :func:`derivative_function` keeps one component (``direction``);
* 2D/3D vector CG(k) → DG(k − 1) ``vs·gdim``-vector, the row-major ∇u
  tensor (component ``i·gdim + j`` = ∂u_i/∂x_j).
"""

from __future__ import annotations

import numpy as np

from pgdrome_tpu_torch.fem.function import Function
from pgdrome_tpu_torch.fem.space import (
    _DG_NODES,
    FunctionSpace,
    VectorFunctionSpace,
    _shape_1d,
    _shape_tet,
    _shape_tri,
)


def _dg_local_nodes(tdim: int, deg: int) -> np.ndarray:
    """Barycentric positions of the DG(deg) local nodes, in the DG
    dofmap's order (``FunctionSpace._build_dofmap``)."""
    if tdim == 2:
        if deg == 0:
            return np.array([[1 / 3, 1 / 3, 1 / 3]])
        if deg == 1:
            return np.eye(3)
        if deg == 2:
            return np.concatenate(
                [np.eye(3), np.array([[0, 0.5, 0.5], [0.5, 0, 0.5], [0.5, 0.5, 0]])])
    if tdim == 3 and deg == 0:
        return np.full((1, 4), 0.25)
    raise NotImplementedError(f"DG local nodes tdim={tdim} deg={deg}")


def _cell_jacobian_inverse(mesh):
    """Per-cell inverse affine Jacobians (nc, tdim, tdim), cached on the
    mesh: serving maps every mode through the same inverses."""
    cached = getattr(mesh, "_jinv_cache", None)
    if cached is not None:
        return cached
    verts = mesh.coordinates()[mesh.cells()]
    v0 = verts[:, 0]
    J = np.stack([verts[:, i + 1] - v0 for i in range(mesh.topology_dim())], axis=2)
    mesh._jinv_cache = np.linalg.inv(J)
    return mesh._jinv_cache


def _dg_space(mesh, deg, dim=None):
    """The DG(deg) target space of derivative outputs (a vector space of
    ``dim`` components when given), cached on the mesh: serving maps every
    mode of a vademecum through the same space."""
    cache = getattr(mesh, "_dg_space_cache", None)
    if cache is None:
        cache = {}
        mesh._dg_space_cache = cache
    key = (deg, dim)
    if key not in cache:
        cache[key] = (FunctionSpace(mesh, "DG", deg) if dim is None
                      else VectorFunctionSpace(mesh, "DG", deg, dim=dim))
    return cache[key]


def _simplex_gradients(V: FunctionSpace, bar: np.ndarray) -> np.ndarray:
    """Global gradients of V's local basis at barycentric points ``bar``:
    (nc, nl, nq, gdim), cached on the mesh by degree and point values."""
    mesh = V.mesh()
    tdim = mesh.topology_dim()
    cache = getattr(mesh, "_basis_grad_cache", None)
    if cache is None:
        cache = {}
        mesh._basis_grad_cache = cache
    key = (V.degree, bar.shape[0], hash(np.ascontiguousarray(bar).tobytes()))
    if key in cache:
        return cache[key]
    _, dbary = (_shape_tri if tdim == 2 else _shape_tet)(V.degree, bar)  # (nl, nq, tdim+1)
    dref = np.stack([dbary[:, :, i + 1] - dbary[:, :, 0] for i in range(tdim)], axis=2)
    cache[key] = np.einsum("lqr,crg->clqg", dref, _cell_jacobian_inverse(mesh))
    return cache[key]


def gradient_function(f: Function) -> Function:
    """Exact ∇f as a DG(degree − 1) Function: a scalar source gives a DG
    gdim-vector, a vector source the row-major ∇u tensor stored as a DG
    vector space of ``vs·gdim`` components (∂u_i/∂x_j at ``i·gdim + j``).
    A 1D scalar source gives its scalar DG derivative
    (:func:`derivative_function`)."""
    V = f.function_space()
    mesh = V.mesh()
    tdim = mesh.topology_dim()
    if tdim == 1:
        if V.value_size > 1:
            raise NotImplementedError("1D vector gradient not needed")
        return derivative_function(f)
    deg = V.degree
    if deg < 1:
        raise ValueError("gradient of a DG0/P0 function is zero")
    grads = _simplex_gradients(V, _dg_local_nodes(tdim, deg - 1))  # (nc, nl, nq, gdim)
    vs = max(V.value_size, 1)
    gdim = mesh.geometry_dim()
    ed = V.element_dofs  # (nc, nl) scalar dofs
    arr = np.asarray(f.array)
    ncomp = gdim * vs
    Vd = _dg_space(mesh, deg - 1, dim=ncomp)
    ed_d = Vd.element_dofs  # (nc, nq): scalar DG dof of (cell, node)
    out = np.zeros(Vd.dim())
    for i in range(vs):
        src = arr[ed * vs + i] if vs > 1 else arr[ed]  # (nc, nl)
        vals = np.einsum("cl,clqg->cqg", src, grads)  # (nc, nq, gdim)
        for j in range(gdim):
            out[ed_d * ncomp + i * gdim + j] = vals[..., j]
    return Function(Vd, out)


def derivative_function(f: Function, direction: int = 0) -> Function:
    """The derivative of a CG function as a DG(degree − 1) Function:

    * 1D scalar → d/dx (``direction`` must be 0): at each DG node, the
      reference-cell derivative of the cell's polynomial over its width;
    * 2D/3D scalar → ∂/∂x_direction (scalar DG);
    * 2D/3D vector → the full ∇f tensor (:func:`gradient_function`)."""
    V = f.function_space()
    mesh = V.mesh()
    if mesh.topology_dim() != 1:
        if V.value_size > 1:
            return gradient_function(f)
        gdim = mesh.geometry_dim()
        if not 0 <= direction < gdim:
            raise ValueError(f"direction {direction} out of range")
        G = gradient_function(f)
        comps = np.asarray(G.array).reshape(-1, G.function_space().value_size)
        return Function(_dg_space(mesh, V.degree - 1), comps[:, direction].copy())
    if direction != 0:
        raise ValueError(f"direction {direction} out of range for an interval")
    if V.value_size > 1:
        raise NotImplementedError("1D vector derivative not needed")
    if V.family != "P" or V.degree < 1:
        raise ValueError("derivative_function needs a CG space of degree >= 1")
    deg = V.degree
    Vd = _dg_space(mesh, deg - 1)
    cells = mesh.cells()
    coords = mesh.coordinates()[:, 0]
    h = coords[cells[:, 1]] - coords[cells[:, 0]]
    _, dref = _shape_1d(deg, _DG_NODES[deg - 1])  # (nl_src, n_loc)
    src = np.asarray(f.array)[V.element_dofs]  # (nc, nl_src)
    vals = (src @ dref) / h[:, None]  # (nc, n_loc)
    return Function(Vd, vals.reshape(-1))
