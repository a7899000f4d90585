"""Device-side assembly: operator assembly and matrix-free applies as
``torch`` operations on one device (counterpart of
``pgdrome_tpu/fem/assembly_jax.py``; a torch module is not named after
JAX).  Name map: ``assembly_jax.AssemblyTables`` → ``AssemblyTables``, and
``at_quadrature``, ``mass_matrix``, ``stiffness_matrix``,
``advection_matrix``, ``load_vector``, ``mass_apply``,
``stiffness_apply``, ``quasilinear_diffusion`` keep their names.

The host assembly (:mod:`.assembly`) runs once at set-up and feeds the
solver fixed per-term operators, which suits separable problems.  When an
operator depends on the current iterate (a quasi-linear diffusion
K[w(u)]), it has to be assembled inside the fixed point instead: the
quadrature and topology tables of a space are fixed tensors, so assembly
is one einsum over cells and a scatter-add, both traceable by
``torch.func`` (the Newton solver's ``jacfwd``).
:func:`quasilinear_diffusion` plugs such an operator into
``SeparatedPGD(nonlinear=...)``.  The matrix-free applies skip the
(n, n) scatter: gather, quadrature contraction, scatter-add of a vector.

Scalar spaces on intervals, triangles and tets (vector and elasticity
operators assemble on the host, as in the JAX package).  The JAX
package's table fingerprint keys its ahead-of-time cache; eager PyTorch
compiles nothing ahead of a call, so there is none here.
"""

from __future__ import annotations

import numpy as np
import torch

from pgdrome_tpu_torch.config import get_device, use_full_f32_matmul
from pgdrome_tpu_torch.fem.space import FunctionSpace

use_full_f32_matmul()

__all__ = ["AssemblyTables", "at_quadrature", "mass_matrix", "stiffness_matrix",
           "advection_matrix", "load_vector", "mass_apply", "stiffness_apply",
           "quasilinear_diffusion"]


class AssemblyTables:
    """Static per-space assembly data as tensors on one device.

    ``qw`` (nc, nq) quadrature weights × Jacobians; ``qb`` (nc, nl, nq)
    basis values; ``qg`` (nc, nl, nq, g) basis gradients; ``ed`` (nc, nl)
    element → dof map; ``n`` the number of dofs."""

    def __init__(self, V: FunctionSpace, dtype=torch.float32, device="cuda"):
        if V.value_size > 1:
            raise ValueError("AssemblyTables covers scalar spaces; vector operators "
                             "assemble on the host")
        dev = get_device(device)
        self.qw = torch.as_tensor(np.asarray(V.q_weights, dtype=np.float64)).to(dev, dtype)
        self.qb = torch.as_tensor(np.ascontiguousarray(V.q_basis, dtype=np.float64)).to(
            dev, dtype)
        self.qg = torch.as_tensor(np.asarray(V.q_grads, dtype=np.float64)).to(dev, dtype)
        self.ed = torch.as_tensor(np.asarray(V.element_dofs), dtype=torch.int64, device=dev)
        self.n = int(V.ndofs)
        self.dtype = dtype


def at_quadrature(tables: AssemblyTables, u):
    """Nodal coefficients → values at quadrature points: (n,) → (nc, nq)."""
    return torch.einsum("cl,clq->cq", u[tables.ed], tables.qb)


def _wq(tables, wq):
    return tables.qw if wq is None else tables.qw * wq


def _scatter_vector(tables, be):
    return torch.zeros(tables.n, dtype=be.dtype, device=be.device).index_add(
        0, tables.ed.reshape(-1), be.reshape(-1))


def _scatter_matrix(tables, Ae):
    """Scatter element matrices (nc, nl, nl) into a dense (n, n)."""
    n = tables.n
    flat = (tables.ed[:, :, None] * n + tables.ed[:, None, :]).reshape(-1)
    return torch.zeros(n * n, dtype=Ae.dtype, device=Ae.device).index_add(
        0, flat, Ae.reshape(-1)).reshape(n, n)


def mass_matrix(tables: AssemblyTables, wq=None):
    """M[i,j] = ∫ w φi φj dx; ``wq`` (nc, nq) a weight at quadrature (None = 1)."""
    Ae = torch.einsum("cq,ciq,cjq->cij", _wq(tables, wq), tables.qb, tables.qb)
    return _scatter_matrix(tables, Ae)


def stiffness_matrix(tables: AssemblyTables, wq=None):
    """K[i,j] = ∫ w ∇φi·∇φj dx; ``wq`` (nc, nq) a weight at quadrature."""
    Ae = torch.einsum("cq,ciqg,cjqg->cij", _wq(tables, wq), tables.qg, tables.qg)
    return _scatter_matrix(tables, Ae)


def advection_matrix(tables: AssemblyTables, wq=None, direction: int = 0):
    """A[i,j] = ∫ w φi ∂φj/∂x_dir dx (test i rows, trial j columns)."""
    Ae = torch.einsum("cq,ciq,cjq->cij", _wq(tables, wq), tables.qb,
                      tables.qg[..., direction])
    return _scatter_matrix(tables, Ae)


def load_vector(tables: AssemblyTables, gq):
    """b[i] = ∫ g φi dx with ``gq`` (nc, nq) the load at quadrature."""
    return _scatter_vector(tables, torch.einsum("cq,ciq->ci", tables.qw * gq, tables.qb))


def mass_apply(tables: AssemblyTables, wq, u):
    """Matrix-free M[w] @ u: gather → quadrature → scatter, O(n) memory."""
    uq = at_quadrature(tables, u)
    return _scatter_vector(tables, torch.einsum("cq,ciq->ci", _wq(tables, wq) * uq, tables.qb))


def stiffness_apply(tables: AssemblyTables, wq, u):
    """Matrix-free K[w] @ u (weighted flux form)."""
    du = torch.einsum("cl,clqg->cqg", u[tables.ed], tables.qg)
    return _scatter_vector(
        tables, torch.einsum("cqg,ciqg->ci", _wq(tables, wq)[..., None] * du, tables.qg))


def quasilinear_diffusion(V: FunctionSpace, wfun, dtype=torch.float32, device="cuda"):
    """Quasi-linear diffusion hook for ``SeparatedPGD(nonlinear=...)``: the
    dim's nonlinear operator N(u) = K[wfun(u_q)] @ u, assembled matrix-free
    on the device at every evaluation inside the fixed point.

    ``wfun`` maps the solution's values at quadrature points to the
    diffusion weight there, e.g. ``lambda uq: eps * uq**2`` for
    κ(u) = κ0 + ε u² (the constant κ0 goes in the linear terms; the hook
    carries only the u-dependent part).  Returns the ``(apply_fn,
    weight_fn)`` pair of the ``nonlinear`` protocol
    (:func:`~pgdrome_tpu_torch.separated._solve_dim`)."""
    tb = AssemblyTables(V, dtype=dtype, device=device)

    def apply_fn(u):
        return stiffness_apply(tb, wfun(at_quadrature(tb, u)), u)

    def weight_fn(F):
        return F @ apply_fn(F)

    return apply_fn, weight_fn
