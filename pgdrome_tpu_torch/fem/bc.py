"""Dirichlet boundary conditions on 1D spaces: constrained dof lookup and
their values (counterpart of ``pgdrome_tpu/fem/bc.py::DirichletBC``).

Constrained dofs are found by evaluating the user predicate at the dof
coordinates, exactly as in the JAX package.
"""

from __future__ import annotations

import inspect

import numpy as np

from pgdrome_tpu_torch.fem.space import FunctionSpace
from pgdrome_tpu_torch.fem.function import Expression


def _on_boundary_mask(V: FunctionSpace) -> np.ndarray:
    x = V.tabulate_dof_coordinates()[:, 0]
    verts = V.mesh().coordinates()[:, 0]
    lo, hi = verts.min(), verts.max()
    return (np.abs(x - lo) < 1e-12) | (np.abs(x - hi) < 1e-12)


class DirichletBC:
    """Dirichlet condition on a scalar 1D space.

    :param V: function space
    :param value: scalar, Expression/Constant or callable of x
    :param where: predicate ``f(x)`` or ``f(x, on_boundary)`` on dof
        coordinates; None = the whole boundary
    """

    def __init__(self, V: FunctionSpace, value, where=None):
        self._V = V
        x = V.tabulate_dof_coordinates()[:, 0]
        onb = _on_boundary_mask(V)
        if where is None:
            mask = onb
        else:
            nargs = len(inspect.signature(where).parameters)
            mask = np.array(
                [bool(where(xi, onb[i]) if nargs >= 2 else where(xi))
                 for i, xi in enumerate(x)],
                dtype=bool,
            )
        self.dofs = np.where(mask)[0].astype(np.int64)
        if isinstance(value, Expression) or callable(value):
            self.values = np.array(
                [float(np.asarray(value(np.asarray([x[d]]))).reshape(-1)[0])
                 for d in self.dofs]
            )
        else:
            self.values = np.full(len(self.dofs), float(value))
