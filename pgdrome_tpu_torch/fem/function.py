"""FE functions, expressions, constants and interpolation (counterpart of
``pgdrome_tpu/fem/function.py``).

A ``Function`` is a function space plus a host f64 dof array (interleaved
components on a vector space); an ``Expression`` wraps a coordinate
callable with named parameters, or a tuple of them for a vector value; a
``Constant`` is a scalar or a vector.  The JAX package's dolfin-like shims
(``vector()``, ``ufl_*``) belong to its reference-parity layer and are not
carried over.
"""

from __future__ import annotations

import inspect

import numpy as np

from pgdrome_tpu_torch.fem.space import FunctionSpace
from pgdrome_tpu_torch.fem.interpolate import eval_dofs_at_points, check_in_range


class Function:
    """FE function: function space + dof array."""

    def __init__(self, V: FunctionSpace, array=None, name: str = "f"):
        self._V = V
        self.name = name
        if array is None:
            self.array = np.zeros(V.dim(), dtype=np.float64)
        else:
            self.array = np.array(array, dtype=np.float64).reshape(-1)
            if self.array.shape != (V.dim(),):
                raise ValueError(
                    f"dof array shape {self.array.shape} != ({V.dim()},)"
                )

    def function_space(self) -> FunctionSpace:
        return self._V

    def copy(self) -> "Function":
        return Function(self._V, self.array.copy(), name=self.name)

    def __call__(self, x):
        """Point evaluation: a scalar or a batch of scalars on an interval,
        a (gdim,) point or a batch of them otherwise; vector functions give
        (..., value_size)."""
        pts = np.asarray(x.coords if hasattr(x, "coords") else x, dtype=np.float64)
        check_in_range(self._V, pts)
        out = np.asarray(eval_dofs_at_points(self._V, self.array, pts))
        return float(out) if out.ndim == 0 else out

    def compute_vertex_values(self):
        """Values at the mesh vertices; a vector field component-major
        ([u_x at all vertices, u_y at all vertices, ...], dolfin parity)."""
        V = self._V
        mesh = V.mesh()
        nv = mesh.num_vertices()
        vs = max(V.value_size, 1)
        if V.family == "P":
            # P1 and 2D/3D P2 number the vertices first; 1D P2 at 2i
            step = 2 if mesh.topology_dim() == 1 and V.degree == 2 else 1
            sdofs = step * np.arange(nv)
            if vs == 1:
                return self.array[sdofs]
            return np.concatenate([self.array[sdofs * vs + c] for c in range(vs)])
        # DG: point evaluation at the vertices
        pts = mesh.coordinates()
        vals = np.asarray(eval_dofs_at_points(
            V, self.array, pts[:, 0] if mesh.geometry_dim() == 1 else pts))
        if vs == 1:
            return vals
        return np.concatenate([vals[:, c] for c in range(vs)])

    def split(self):
        """Per-component scalar Functions of a vector function."""
        V = self._V
        vs = V.value_size
        if vs <= 1:
            raise ValueError("split() needs a vector function")
        scalar_V = FunctionSpace(V.mesh(), V.family, V.degree)
        return tuple(Function(scalar_V, self.array[np.arange(V.ndofs) * vs + c])
                     for c in range(vs))

    def __repr__(self):
        return f"Function({self._V!r}, name={self.name})"


class Expression:
    """Coordinate expression: a callable ``f(x)`` or ``f(x, **params)``, a
    tuple/list of them (a vector value, stacked on the last axis), or a
    constant value.  Parity: dolfin.Expression; the ``degree`` keyword is
    accepted and ignored (the space chooses the quadrature).  Interval
    expressions receive coordinates of any shape ``(...,)``; 2D/3D points
    arrive as ``(..., gdim)``."""

    def __init__(self, expr, degree: int = 1, **params):
        self.degree = degree
        self.params = dict(params)
        self._components = None
        if isinstance(expr, (tuple, list)):
            self._components = [Expression(e, degree=degree, **params) for e in expr]
            self._fn = None
        elif callable(expr):
            self._fn = expr
        else:
            val = float(expr)
            self._fn = lambda x: val * np.ones_like(_first_coord(x))

    @property
    def value_size(self):
        return len(self._components) if self._components else 1

    def __call__(self, x, **extra):
        if self._components:
            return np.stack([c(x, **extra) for c in self._components], axis=-1)
        p = {**self.params, **extra}
        x = np.asarray(x, dtype=np.float64)
        out = self._fn(x, **p) if _wants_params(self._fn) else self._fn(x)
        return np.asarray(out, dtype=np.float64)


def _wants_params(fn):
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return False
    return len(sig.parameters) > 1 or any(
        p.kind == p.VAR_KEYWORD for p in sig.parameters.values()
    )


def _first_coord(x):
    """The first coordinate of 2D/3D points (..., gdim); 1D points as
    they are."""
    x = np.asarray(x, dtype=np.float64)
    if x.ndim >= 2 and x.shape[-1] in (2, 3):
        return x[..., 0]
    return x


class Constant(Expression):
    """Constant scalar or vector (dolfin.Constant parity)."""

    def __init__(self, value):
        if isinstance(value, (tuple, list, np.ndarray)):
            vals = [float(v) for v in np.asarray(value).ravel()]
            super().__init__(tuple(
                (lambda v: (lambda x: v * np.ones_like(_first_coord(x))))(v) for v in vals))
        else:
            vals = [float(value)]
            super().__init__(vals[0])
        self.values_list = vals

    def values(self):
        return np.asarray(self.values_list)

    def __float__(self):
        return float(self.values_list[0])


def interpolate(expr, V: FunctionSpace) -> Function:
    """Interpolate an Expression, a callable or a Function onto ``V`` at
    its dof coordinates (dolfin.interpolate parity)."""
    pts = V.tabulate_dof_coordinates()
    if isinstance(expr, Function):
        if expr.function_space() is V:
            return expr.copy()
        Vf = expr.function_space()
        vals = np.asarray(eval_dofs_at_points(
            Vf, expr.array, pts[:, 0] if Vf.mesh().geometry_dim() == 1 else pts))
        return Function(V, vals.reshape(-1))
    pts_in = pts[:, 0] if V.mesh().geometry_dim() == 1 else pts
    vals = np.asarray(expr(pts_in) if callable(expr) else expr, dtype=np.float64)
    vs = max(V.value_size, 1)
    if vs == 1:
        if vals.ndim == 0:
            vals = np.full(V.ndofs, float(vals))
        return Function(V, vals)
    if vals.ndim == 1:  # the same value for every component
        vals = np.tile(vals[:, None], (1, vs))
    return Function(V, vals.reshape(-1))
