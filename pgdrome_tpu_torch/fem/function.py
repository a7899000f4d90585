"""FE functions, expressions, constants and interpolation (counterpart of
``pgdrome_tpu/fem/function.py``).

A ``Function`` is a function space plus a host f64 dof array (interleaved
components on a vector space); an ``Expression`` wraps a coordinate
callable with named parameters, or a tuple of them for a vector value; a
``Constant`` is a scalar or a vector.  The dolfin-like shims the
reference-parity layer (:mod:`pgdrome_tpu_torch.solver`,
:mod:`pgdrome_tpu_torch.model`) and its users' callbacks rely on are kept:
``f.vector()`` (a mutable view of the dof array: ``f.vector()[:]``,
``get_local``/``set_local``, ``axpy``), ``ufl_element()``, string
expressions over ``x[0]``/``x[1]``, and parameter updates by
``expr.assign(p=...)`` or ``expr.p = ...``.
"""

from __future__ import annotations

import inspect
import math

import numpy as np

from pgdrome_tpu_torch.fem.space import FunctionSpace
from pgdrome_tpu_torch.fem.interpolate import eval_dofs_at_points, check_in_range


class _VectorView:
    """Mutable view of a Function's dof array (dolfin Vector parity)."""

    def __init__(self, fn: "Function"):
        self._fn = fn

    def __getitem__(self, idx):
        return self._fn.array[idx]

    def __setitem__(self, idx, val):
        self._fn.array[idx] = val

    def __len__(self):
        return self._fn.array.shape[0]

    def get_local(self):
        return self._fn.array

    def set_local(self, values):
        self._fn.array[:] = np.asarray(values)

    def axpy(self, a, other: "_VectorView"):
        self._fn.array += a * other._fn.array

    def max(self):
        return float(np.max(self._fn.array))

    def min(self):
        return float(np.min(self._fn.array))

    def __array__(self, dtype=None, copy=None):
        arr = self._fn.array
        return arr.astype(dtype) if dtype is not None else arr


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

    def vector(self) -> _VectorView:
        return _VectorView(self)

    def copy(self, deepcopy: bool = True) -> "Function":
        return Function(self._V, self.array.copy(), name=self.name)

    def ufl_element(self):
        return self._V.ufl_element()

    def __call__(self, x):
        """Point evaluation: a scalar or a batch of scalars on an interval,
        a (gdim,) point or a batch of them otherwise; vector functions give
        (..., value_size)."""
        pts = _points_as_array(x)
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


def _points_as_array(x):
    """A :class:`~pgdrome_tpu_torch.fem.mesh.Point`, a scalar or an array
    of points as a float64 array."""
    return np.asarray(x.coords if hasattr(x, "coords") else x, dtype=np.float64)


class Expression:
    """Coordinate expression: a callable ``f(x)`` or ``f(x, **params)``, a
    tuple/list of them (a vector value, stacked on the last axis), or a
    constant value.  Parity: dolfin.Expression; the ``degree`` keyword is
    accepted and ignored (the space chooses the quadrature).  Interval
    expressions receive coordinates of any shape ``(...,)``; 2D/3D points
    arrive as ``(..., gdim)``."""

    def __init__(self, expr, degree: int = 1, element=None, **params):
        self.degree = degree
        self.params = dict(params)
        self._components = None
        if isinstance(expr, (tuple, list)):
            self._components = [Expression(e, degree=degree, **params) for e in expr]
            self._fn = None
        elif callable(expr):
            self._fn = expr
        elif isinstance(expr, str):
            self._fn = _compile_expr(expr)
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

    def assign(self, **params):
        self.params.update(params)

    def __setattr__(self, key, value):
        # ``expr.p = 2.0`` updates a parameter (the dolfin idiom)
        if key not in ("degree", "params", "_components", "_fn") and key in self.__dict__.get(
                "params", {}):
            self.params[key] = value
        else:
            object.__setattr__(self, key, value)


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


def _compile_expr(src: str):
    """A callable of ``x`` (and keyword parameters) evaluating the
    expression string ``src`` over ``x[0]``/``x[1]``/``x[2]``."""

    def fn(x, **params):
        x = np.asarray(x, dtype=np.float64)
        if x.ndim >= 2 and x.shape[-1] in (2, 3) and "x[1]" in src:
            xv = [x[..., i] for i in range(x.shape[-1])]
        else:
            xv = [x]
        ns = {"x": xv, "np": np, "pi": math.pi, "sin": np.sin, "cos": np.cos,
              "exp": np.exp, "sqrt": np.sqrt, "pow": np.power, "abs": np.abs,
              "where": np.where}
        ns.update(params)
        out = eval(src, {"__builtins__": {}}, ns)
        return np.broadcast_to(np.asarray(out, dtype=np.float64), xv[0].shape).copy()

    return fn


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

    def assign(self, value):
        Constant.__init__(self, float(value))

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
