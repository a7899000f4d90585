"""Separated-problem containers, the dim-0 energy-basis transform and 1D
mode evaluation — the serving part of ``pgdrome_tpu/separated.py``.

* :class:`SeparatedProblem` and :class:`PGDResult` are plain containers.
* :func:`precondition_dim` / :func:`precondition_dim0` congruence-transform
  one dimension by the banded Cholesky factor of its first operator (host
  f64, scipy), and :class:`Dim0Transform` maps modes solved in that basis
  back to full dofs — what a trained state needs in order to be served.
* :func:`evaluate_modes_1d` evaluates all buffered modes of a 1D space at
  a batch of points.  Only the gather form is carried over: the JAX
  package's two-hot matmul form exists to dodge slow TPU gathers
  (``pgdrome_tpu/separated.py:1826-1832``) and has no reason on a GPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch


@dataclass
class SeparatedProblem:
    """Separated weak form: Σ_t ⊗_d O_td (lhs) and Σ_r ⊗_d g_rd (rhs).

    ops:   per dim, stacked lhs operators (T, n_d, n_d)
    rhs:   per dim, stacked rhs vectors (R, n_d)  (lift terms included)
    mass:  per dim, consistent mass matrix (n_d, n_d) for norms
    bc_dofs: per dim, constrained dof indices (possibly empty) — homogenized
    """

    ops: Sequence[np.ndarray]
    rhs: Sequence[np.ndarray]
    mass: Sequence[np.ndarray]
    bc_dofs: Sequence[np.ndarray]

    def __post_init__(self):
        self.num_dims = len(self.ops)
        self.num_terms = self.ops[0].shape[0]
        self.num_rhs = self.rhs[0].shape[0]
        self.sizes = tuple(o.shape[1] for o in self.ops)
        # bc masks: 1 interior, 0 constrained
        self.bc_masks = []
        for d in range(self.num_dims):
            m = np.ones(self.sizes[d], dtype=np.asarray(self.ops[d]).dtype)
            if self.bc_dofs[d] is not None and len(self.bc_dofs[d]):
                m[np.asarray(self.bc_dofs[d])] = 0.0
            self.bc_masks.append(m)


@dataclass
class PGDResult:
    modes: list  # per dim (n_max, n_d) padded buffers (tensors or arrays)
    n_modes: int
    amplitudes: np.ndarray  # relConv per enrichment (trimmed)
    alpha: np.ndarray
    fp_its: np.ndarray
    normU0: float = 1.0  # absolute normU of the first mode (resume scale)


@dataclass
class Dim0Transform:
    """Back-transform data from :func:`precondition_dim`: full-dof mode
    reconstruction is ``u = scatter(Linv.T @ y)``.

    Holds the Cholesky factor data (banded ``Lb``/``Ub`` storage, or a dense
    ``L``); ``apply_Linv`` / ``apply_LinvT`` map an (n_int, m) block through
    L⁻¹ / L⁻ᵀ by triangular solves, never an explicit inverse.  ``dim``
    records which dimension the transform applies to."""

    interior: np.ndarray  # interior dof indices into the full dof vector
    n_full: int
    dim: int = 0
    # exactly one of the two factor representations is set:
    banded: tuple | None = None  # (Lb, Ub): lower/upper banded storage
    dense_L: np.ndarray | None = None

    def apply_Linv(self, B):
        """L⁻¹ @ B for an (n_int, m) block."""
        from scipy.linalg import solve_banded, solve_triangular

        if self.banded is not None:
            Lb, _ = self.banded
            return solve_banded((Lb.shape[0] - 1, 0), Lb, B)
        return solve_triangular(self.dense_L, B, lower=True)

    def apply_LinvT(self, B):
        """L⁻ᵀ @ B for an (n_int, m) block."""
        from scipy.linalg import solve_banded, solve_triangular

        if self.banded is not None:
            _, Ub = self.banded
            return solve_banded((0, Ub.shape[0] - 1), Ub, B)
        return solve_triangular(self.dense_L.T, B, lower=False)

    def modes_to_full(self, modes0):
        """(n_max, n_int) transformed modes → (n_max, n_full) dof modes."""
        y = np.asarray(modes0, dtype=np.float64)
        u_int = self.apply_LinvT(y.T).T  # rows: Linv.T @ y_k
        out = np.zeros((y.shape[0], self.n_full), dtype=u_int.dtype)
        out[:, self.interior] = u_int
        return out


def precondition_dim0(sep: SeparatedProblem, dtype=None):
    """:func:`precondition_dim` on dimension 0 (the usual space dim)."""
    return precondition_dim(sep, dim=0, dtype=dtype)


def precondition_dim(sep: SeparatedProblem, dim: int = 0, dtype=None,
                     base=None):
    """Congruence-transform dimension ``dim`` by the Cholesky factor of its
    first operator (or of ``base``), so its transformed stack is
    ``[I, G_1, ...]`` with condition number O(1) — every f32 device solve
    in that basis is backward-stable.  Dirichlet dofs of ``dim`` are
    eliminated by restriction.  Host f64 throughout; returns
    ``(problem, Dim0Transform)`` with the problem's arrays cast to
    ``dtype`` (float32 by default)."""
    dt = dtype or np.float32
    from scipy.linalg import cholesky, cholesky_banded

    n0 = sep.sizes[dim]
    interior = np.setdiff1d(
        np.arange(n0), np.asarray(sep.bc_dofs[dim], dtype=np.int64)
    )
    ii = np.ix_(interior, interior)

    ops0 = [np.asarray(o, dtype=np.float64) for o in sep.ops[dim]]
    K = (np.asarray(base, dtype=np.float64)[ii] if base is not None
         else ops0[0][ii])
    n = len(interior)

    # FEM stiffness on a 1D mesh is banded (P1: tri-, P2: penta-diagonal):
    # banded Cholesky is O(n·b²) and each L⁻¹ application O(n·b) a column
    nz_i, nz_j = np.nonzero(K)
    bw = int(np.max(np.abs(nz_i - nz_j))) if nz_i.size else 0
    if (bw + 1) * 8 <= n:
        ab = np.zeros((bw + 1, n))
        for k in range(bw + 1):
            ab[k, : n - k] = np.diagonal(K, -k)
        Lb = cholesky_banded(ab, lower=True)  # Lb[k, j] = L[j+k, j]
        # upper-banded storage of L.T for the back-transform solves
        Ub = np.zeros_like(Lb)
        for k in range(bw + 1):
            Ub[bw - k, k:] = Lb[k, : n - k]
        tf = Dim0Transform(
            interior=interior, n_full=n0, dim=dim, banded=(Lb, Ub)
        )
    else:
        L = cholesky(K, lower=True)
        tf = Dim0Transform(interior=interior, n_full=n0, dim=dim, dense_L=L)
    apply_Linv = tf.apply_Linv

    if base is None:
        new_ops0 = [np.eye(n)]  # Linv O_0 LinvT is exactly I by construction
        rest = range(1, len(ops0))
    else:
        new_ops0 = []
        rest = range(len(ops0))
    for t in rest:
        X = apply_Linv(ops0[t][ii])  # Linv @ A
        new_ops0.append(apply_Linv(X.T).T)  # (Linv @ A) @ Linv.T
    new_rhs0 = apply_Linv(
        np.asarray(sep.rhs[dim], dtype=np.float64)[:, interior].T
    ).T
    Xm = apply_Linv(np.asarray(sep.mass[dim], dtype=np.float64)[ii])
    new_mass0 = apply_Linv(Xm.T).T

    new_ops = [np.asarray(o, dtype=dt) for o in sep.ops]
    new_rhs = [np.asarray(r, dtype=dt) for r in sep.rhs]
    new_mass = [np.asarray(m, dtype=dt) for m in sep.mass]
    new_bc = list(sep.bc_dofs)
    new_ops[dim] = np.stack([a.astype(dt, copy=False) for a in new_ops0])
    new_rhs[dim] = new_rhs0.astype(dt, copy=False)
    new_mass[dim] = new_mass0.astype(dt, copy=False)
    new_bc[dim] = np.array([], dtype=np.int64)
    new = SeparatedProblem(ops=new_ops, rhs=new_rhs, mass=new_mass,
                           bc_dofs=new_bc)
    return new, tf


def evaluate_modes_1d(V, modes_buf: torch.Tensor, points: torch.Tensor):
    """Evaluate all buffered modes of a 1D space at a batch of points:
    (npoints,) → (npoints, n_max), computed in ``modes_buf``'s dtype on its
    device.  Cell locate by binary search over the vertices (any grid),
    then the 2–3 dof rows of each point's cell gathered and weighted by
    the Lagrange basis."""
    from pgdrome_tpu_torch.fem.interpolate import _locate_1d, _shape_1d_x

    pts = torch.as_tensor(points).to(device=modes_buf.device,
                                      dtype=modes_buf.dtype)
    cell, xi = _locate_1d(V.mesh(), pts, torch)
    basis = _shape_1d_x(V.degree, xi, torch)  # (B, nl)
    local = V.element_dofs_device(modes_buf.device)[cell]  # (B, nl)
    gathered = modes_buf.T[local]  # (B, nl, n_max)
    return torch.einsum("bl,bln->bn", basis, gathered)
