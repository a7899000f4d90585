"""Function spaces: P1/P2 Lagrange and DG0/DG1 on 1D intervals
(counterpart of the interval part of ``pgdrome_tpu/fem/space.py``).

Dof layout is deterministic and coordinate-sorted: for P2, vertex i is dof
2i and the midpoint of cell e is dof 2e+1, so the dofs of cell c start at
``degree·c`` — the layout the fused sweep kernel relies on.  A DG(k) space
numbers its dofs cell by cell, cell c owning ``(k+1)·c … (k+1)·c + k`` at
the local nodes ξ = 1/2 (k = 0) or ξ = 0, 1 (k = 1), as the JAX package's
DG dofmap does — the layout derivative fields are served in.  Per-cell
quadrature (points, weights×|J|, basis values and global gradients) is
tabulated once on the host for assembly.
"""

from __future__ import annotations

import numpy as np
import torch

from pgdrome_tpu_torch.fem.mesh import Mesh

_CG_FAMILIES = {"P", "CG", "Lagrange"}
_DG_FAMILIES = {"DG", "Discontinuous Lagrange"}
# local DG node positions on the reference cell, by degree
_DG_NODES = {0: np.array([0.5]), 1: np.array([0.0, 1.0])}


def gauss_legendre_01(n: int):
    """n-point Gauss-Legendre rule on [0, 1]."""
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


def _shape_1d(degree: int, xi: np.ndarray):
    """Values and d/dxi of the 1D Lagrange basis at reference coords
    xi ∈ [0, 1].  Returns (vals, grads), each (ndof_local, nq)."""
    xi = np.asarray(xi)
    if degree == 0:
        vals = np.ones((1,) + xi.shape)
        grads = np.zeros((1,) + xi.shape)
    elif degree == 1:
        vals = np.stack([1.0 - xi, xi])
        grads = np.stack([-np.ones_like(xi), np.ones_like(xi)])
    elif degree == 2:
        # nodes at xi = 0, 0.5, 1
        vals = np.stack(
            [
                (1.0 - xi) * (1.0 - 2.0 * xi),
                4.0 * xi * (1.0 - xi),
                xi * (2.0 * xi - 1.0),
            ]
        )
        grads = np.stack([4.0 * xi - 3.0, 4.0 - 8.0 * xi, 4.0 * xi - 1.0])
    else:
        raise NotImplementedError(f"1D degree {degree}")
    return vals, grads


class FunctionSpace:
    """Scalar P1/P2 Lagrange or DG0/DG1 space on an interval mesh.

    Parity: dolfin.FunctionSpace(mesh, family, degree), as in the JAX
    package; only the 1D part is ported."""

    value_size = 1  # scalar spaces only

    def __init__(self, mesh: Mesh, family: str = "P", degree: int = 1):
        if family not in _CG_FAMILIES | _DG_FAMILIES:
            raise ValueError(f"unsupported family '{family}' (P or DG)")
        if mesh.topology_dim() != 1:
            raise NotImplementedError("only 1D interval meshes are ported")
        self._mesh = mesh
        self.family = "DG" if family in _DG_FAMILIES else "P"
        self.degree = int(degree)
        self._build_dofmap()
        self._tabulate_quadrature()
        self._cache = {}

    def _build_dofmap(self):
        mesh, deg = self._mesh, self.degree
        cells = mesh.cells()
        coords = mesh.coordinates()
        if self.family == "DG":
            if deg not in _DG_NODES:
                raise NotImplementedError("1D DG degree must be 0 or 1")
            loc = _DG_NODES[deg]
            ncells = mesh.num_cells()
            self.element_dofs = np.arange(ncells * loc.size, dtype=np.int32).reshape(
                ncells, loc.size)
            a = coords[cells[:, 0], 0]
            b = coords[cells[:, 1], 0]
            self.dof_coords = (a[:, None] + (b - a)[:, None] * loc[None, :]).reshape(-1, 1)
            self.ndofs = self.element_dofs.size
        elif deg == 1:
            self.element_dofs = cells.astype(np.int32)
            self.dof_coords = coords.copy()
            self.ndofs = mesh.num_vertices()
        elif deg == 2:
            # vertex i -> dof 2i, midpoint of cell e -> dof 2e+1
            ncells = mesh.num_cells()
            self.element_dofs = np.stack(
                [2 * cells[:, 0], 2 * np.arange(ncells) + 1, 2 * cells[:, 1]],
                axis=1,
            ).astype(np.int32)
            dof_x = np.zeros(2 * ncells + 1)
            dof_x[::2] = coords[:, 0]
            dof_x[1::2] = 0.5 * (coords[cells[:, 0], 0] + coords[cells[:, 1], 0])
            self.dof_coords = dof_x[:, None]
            self.ndofs = 2 * ncells + 1
        else:
            raise NotImplementedError("1D CG degree must be 1 or 2")

    def _tabulate_quadrature(self):
        """Per-cell quadrature: global points, weights×|J|, basis values
        and global basis gradients (host numpy, setup-time work)."""
        coords = self._mesh.coordinates()
        cells = self._mesh.cells()
        nq = max(2 * self.degree + 1, 3)
        xi, w = gauss_legendre_01(nq)
        vals, dref = _shape_1d(self.degree, xi)  # (nl, nq)
        a = coords[cells[:, 0], 0]
        b = coords[cells[:, 1], 0]
        h = b - a
        self.q_points = (a[:, None] + np.outer(h, xi))[..., None]  # (nc, nq, 1)
        self.q_weights = np.outer(h, w)  # (nc, nq)
        self.q_basis = np.broadcast_to(vals, (len(cells),) + vals.shape)
        self.q_grads = (dref[None, :, :] / h[:, None, None])[..., None]

    def element_dofs_device(self, device="cpu") -> torch.Tensor:
        """Element dof table as an int64 tensor on ``device`` (lazy)."""
        key = ("element_dofs", str(torch.device(device)))
        if key not in self._cache:
            self._cache[key] = torch.as_tensor(
                self.element_dofs, dtype=torch.int64, device=device
            )
        return self._cache[key]

    def mesh(self) -> Mesh:
        return self._mesh

    def dim(self) -> int:
        return self.ndofs

    def tabulate_dof_coordinates(self) -> np.ndarray:
        """Dof coordinates, one row per dof (dolfin parity)."""
        return self.dof_coords

    def __repr__(self):
        return f"FunctionSpace({self.family}{self.degree}, ndofs={self.dim()}, tdim=1)"
