"""FE functions, expressions and constants — the pieces assembly and
boundary conditions need (counterpart of ``pgdrome_tpu/fem/function.py``).

A ``Function`` is a function space plus a host f64 dof array; an
``Expression`` wraps a coordinate callable with named parameters; a
``Constant`` is a scalar.
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

    def __call__(self, x):
        """Point evaluation at a scalar or a batch of points."""
        pts = np.asarray(x, dtype=np.float64)
        check_in_range(self._V, pts)
        out = np.asarray(eval_dofs_at_points(self._V, self.array, pts))
        return float(out) if out.ndim == 0 else out

    def __repr__(self):
        return f"Function({self._V!r}, name={self.name})"


class Expression:
    """Coordinate expression: a callable ``f(x)`` or ``f(x, **params)``, or
    a constant value.  Parity: dolfin.Expression; the ``degree`` keyword is
    accepted and ignored (the space chooses the quadrature)."""

    def __init__(self, expr, degree: int = 1, **params):
        self.degree = degree
        self.params = dict(params)
        if callable(expr):
            self._fn = expr
        else:
            val = float(expr)
            self._fn = lambda x: val * np.ones_like(np.asarray(x, dtype=np.float64))

    def __call__(self, x, **extra):
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


class Constant(Expression):
    """Constant scalar (dolfin.Constant parity)."""

    def __init__(self, value):
        v = float(value)
        super().__init__(v)
        self._value = v

    def __float__(self):
        return self._value
