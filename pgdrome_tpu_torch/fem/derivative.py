"""Exact derivatives of FE functions onto DG spaces (counterpart of the
interval part of ``pgdrome_tpu/fem/derivative.py``).

The derivative of a piecewise polynomial of degree k is a discontinuous
piecewise polynomial of degree k − 1, so projecting ``f.dx(0)`` onto
DG(k − 1) is interpolation at the DG nodes: no solve.  A 1D scalar CG(k)
function, k ∈ {1, 2}, becomes a DG(k − 1) function.
"""

from __future__ import annotations

import numpy as np

from pgdrome_tpu_torch.fem.function import Function
from pgdrome_tpu_torch.fem.space import _DG_NODES, FunctionSpace, _shape_1d


def _dg_space(mesh, deg):
    """The DG(deg) target space of derivative outputs, cached on the mesh:
    serving maps every mode of a vademecum through the same space."""
    cache = getattr(mesh, "_dg_space_cache", None)
    if cache is None:
        cache = {}
        mesh._dg_space_cache = cache
    if deg not in cache:
        cache[deg] = FunctionSpace(mesh, "DG", deg)
    return cache[deg]


def derivative_function(f: Function, direction: int = 0) -> Function:
    """d/dx of a 1D scalar CG function as a DG(degree − 1) Function: at
    each DG node, the reference-cell derivative of the cell's local
    polynomial over the cell width.  ``direction`` must be 0 (the
    interval has one)."""
    V = f.function_space()
    mesh = V.mesh()
    if mesh.topology_dim() != 1:
        raise NotImplementedError("only interval meshes are ported")
    if direction != 0:
        raise ValueError(f"direction {direction} out of range for an interval")
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
