"""Function spaces: P1/P2 Lagrange and DG on intervals, triangles and
tetrahedra, scalar or vector-valued (counterpart of
``pgdrome_tpu/fem/space.py``).

Dofs are numbered by the JAX package's own numpy code, so dofmaps agree to
the index:

* intervals: for P2, vertex i is dof 2i and the midpoint of cell e is dof
  2e+1, so the dofs of cell c start at ``degree·c`` — the layout the fused
  sweep kernel relies on;
* triangles and tets: P1 dofs are the vertices; P2 adds one dof per edge
  after them, edges numbered by ``np.unique`` of their sorted vertex pairs
  (``edge_vertices``), local edge i of a triangle opposite local vertex i,
  a tet's local edges in the order of ``_TET_EDGES``;
* DG(k) numbers its dofs cell by cell at the local nodes (intervals:
  ξ = 1/2 for k = 0, ξ = 0, 1 for k = 1; triangles: the centroid, the
  vertices, the vertices then the edge midpoints for k = 0, 1, 2; tets: the
  centroid, k = 0 only) — the spaces derivative fields are served in;
* a :class:`VectorFunctionSpace` interleaves its components, dof
  ``s·value_size + c`` for scalar dof s and component c.

Per-cell quadrature (points, weights×|J|, basis values and global
gradients) is tabulated once on the host for assembly: Gauss–Legendre on
intervals, the symmetric 3- and 6-point rules on triangles, the 4-point
rule on P1 tets and Keast's 14-point degree-5 rule on P2 tets.
"""

from __future__ import annotations

import numpy as np
import torch

from pgdrome_tpu_torch.fem.mesh import Mesh

_CG_FAMILIES = {"P", "CG", "Lagrange"}
_DG_FAMILIES = {"DG", "Discontinuous Lagrange"}
# local DG node positions on the reference interval, by degree
_DG_NODES = {0: np.array([0.5]), 1: np.array([0.0, 1.0])}


def gauss_legendre_01(n: int):
    """n-point Gauss-Legendre rule on [0, 1]."""
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


# symmetric triangle rules on the reference triangle (area 1/2), exact to
# the stated polynomial degree; points are barycentric triplets
_TRI_RULES = {
    2: (
        np.array([[2 / 3, 1 / 6, 1 / 6], [1 / 6, 2 / 3, 1 / 6], [1 / 6, 1 / 6, 2 / 3]]),
        np.array([1 / 6, 1 / 6, 1 / 6]),
    ),
    # Dunavant's 6-point rule
    4: (
        np.array([
            [0.108103018168070, 0.445948490915965, 0.445948490915965],
            [0.445948490915965, 0.108103018168070, 0.445948490915965],
            [0.445948490915965, 0.445948490915965, 0.108103018168070],
            [0.816847572980459, 0.091576213509771, 0.091576213509771],
            [0.091576213509771, 0.816847572980459, 0.091576213509771],
            [0.091576213509771, 0.091576213509771, 0.816847572980459],
        ]),
        0.5 * np.array([0.223381589678011, 0.223381589678011, 0.223381589678011,
                        0.109951743655322, 0.109951743655322, 0.109951743655322]),
    ),
}


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


def _shape_tri(degree: int, bary: np.ndarray):
    """Values (nl, nq) and barycentric gradients (nl, nq, 3) of the
    triangle Lagrange basis at barycentric points ``bary`` (nq, 3).  P2
    dof order: the 3 vertices, then the 3 edge midpoints, edge i opposite
    vertex i (edge0 = (v1, v2), edge1 = (v0, v2), edge2 = (v0, v1))."""
    l0, l1, l2 = bary[:, 0], bary[:, 1], bary[:, 2]
    if degree == 1:
        vals = np.stack([l0, l1, l2])
        d = np.zeros((3, len(l0), 3))
        d[0, :, 0] = 1.0
        d[1, :, 1] = 1.0
        d[2, :, 2] = 1.0
    elif degree == 2:
        vals = np.stack([l0 * (2 * l0 - 1), l1 * (2 * l1 - 1), l2 * (2 * l2 - 1),
                         4 * l1 * l2, 4 * l0 * l2, 4 * l0 * l1])
        d = np.zeros((6, len(l0), 3))
        d[0, :, 0] = 4 * l0 - 1
        d[1, :, 1] = 4 * l1 - 1
        d[2, :, 2] = 4 * l2 - 1
        d[3, :, 1] = 4 * l2
        d[3, :, 2] = 4 * l1
        d[4, :, 0] = 4 * l2
        d[4, :, 2] = 4 * l0
        d[5, :, 0] = 4 * l1
        d[5, :, 1] = 4 * l0
    elif degree == 0:
        vals = np.ones((1, len(l0)))
        d = np.zeros((1, len(l0), 3))
    else:
        raise NotImplementedError(f"triangle degree {degree}")
    return vals, d


# 4-point degree-2 rule on the reference tetrahedron (volume 1/6)
_TET_RULE = (
    np.array([
        [0.5854101966249685, 0.1381966011250105, 0.1381966011250105, 0.1381966011250105],
        [0.1381966011250105, 0.5854101966249685, 0.1381966011250105, 0.1381966011250105],
        [0.1381966011250105, 0.1381966011250105, 0.5854101966249685, 0.1381966011250105],
        [0.1381966011250105, 0.1381966011250105, 0.1381966011250105, 0.5854101966249685],
    ]),
    np.full(4, 1.0 / 24.0),
)


def _keast14():
    """Keast's 14-point degree-5 rule on the reference tet (volume 1/6):
    two vertex-type orbits and one edge-type orbit.  P2 tet mass
    integrands are degree 4, which the 4-point rule under-integrates."""
    pts, wts = [], []
    for a, w in ((0.0673422422100983, 0.1126879257180162),
                 (0.7217942490673264, 0.0734930431163619)):
        b = (1.0 - a) / 3.0
        for i in range(4):
            p = [b, b, b, b]
            p[i] = a
            pts.append(p)
            wts.append(w)
    a, w = 0.4544962958743506, 0.0425460207770812
    b = 0.5 - a  # (a, a, b, b) permutations
    for (i, j) in ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)):
        p = [b, b, b, b]
        p[i] = p[j] = a
        pts.append(p)
        wts.append(w)
    return np.asarray(pts), np.asarray(wts) / 6.0


_TET_RULE_DEG5 = _keast14()

# local edges of the reference tet for P2 dofs (lexicographic pairs); the
# dofmap's edge enumeration and _shape_tet agree on them
_TET_EDGES = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def _shape_tet(degree: int, bary: np.ndarray):
    """P0/P1/P2 tetrahedral basis: values (nl, nq) and barycentric
    gradients (nl, nq, 4).  P2 dof order: the 4 vertices, then the 6 edges
    of ``_TET_EDGES``."""
    nq = bary.shape[0]
    if degree == 1:
        vals = bary.T.copy()
        d = np.zeros((4, nq, 4))
        for i in range(4):
            d[i, :, i] = 1.0
    elif degree == 2:
        vals = np.empty((10, nq))
        d = np.zeros((10, nq, 4))
        for i in range(4):
            li = bary[:, i]
            vals[i] = li * (2.0 * li - 1.0)
            d[i, :, i] = 4.0 * li - 1.0
        for e, (a, b) in enumerate(_TET_EDGES):
            la, lb = bary[:, a], bary[:, b]
            vals[4 + e] = 4.0 * la * lb
            d[4 + e, :, a] = 4.0 * lb
            d[4 + e, :, b] = 4.0 * la
    elif degree == 0:
        vals = np.ones((1, nq))
        d = np.zeros((1, nq, 4))
    else:
        raise NotImplementedError("3D supports P1/P2 (and DG0)")
    return vals, d


class FunctionSpace:
    """Scalar Lagrange (P1/P2) or DG space on an interval, triangle or tet
    mesh.  Parity: dolfin.FunctionSpace(mesh, family, degree), as in the
    JAX package."""

    def __init__(self, mesh: Mesh, family: str = "P", degree: int = 1):
        if family not in _CG_FAMILIES | _DG_FAMILIES:
            raise ValueError(f"unknown family '{family}'")
        self._mesh = mesh
        self.family = "DG" if family in _DG_FAMILIES else "P"
        self.degree = int(degree)
        self.num_sub_spaces = 0  # scalar
        self.value_size = 1
        self._build_dofmap()
        self._tabulate_quadrature()
        self._cache = {}

    # ------------------------------------------------------------------ dofs
    def _build_dofmap(self):
        mesh, deg = self._mesh, self.degree
        tdim = mesh.topology_dim()
        cells = mesh.cells()
        coords = mesh.coordinates()
        if self.family == "DG":
            nl = {1: deg + 1, 2: (deg + 1) * (deg + 2) // 2,
                  3: (deg + 1) * (deg + 2) * (deg + 3) // 6}[tdim]
            if tdim == 3 and deg > 0:
                raise NotImplementedError("3D DG degree must be 0")
            if tdim == 1 and deg not in _DG_NODES:
                raise NotImplementedError("1D DG degree must be 0 or 1")
            ncells = mesh.num_cells()
            self.element_dofs = np.arange(ncells * nl, dtype=np.int32).reshape(ncells, nl)
            # dof coordinates: local nodes mapped per cell
            if tdim == 1:
                a = coords[cells[:, 0], 0]
                b = coords[cells[:, 1], 0]
                dof_x = a[:, None] + (b - a)[:, None] * _DG_NODES[deg][None, :]
                self.dof_coords = dof_x.reshape(-1, 1)
            elif tdim == 3:  # DG0 only: the centroid of each tet
                bar = np.full((1, 4), 0.25)
                tet = coords[cells]  # (nc, 4, gdim)
                self.dof_coords = np.einsum("lk,ckg->clg", bar, tet).reshape(
                    -1, coords.shape[1])
            else:
                if deg == 0:
                    bar = np.array([[1 / 3, 1 / 3, 1 / 3]])
                elif deg == 1:
                    bar = np.eye(3)
                else:
                    bar = np.concatenate(
                        [np.eye(3), np.array([[0, 0.5, 0.5], [0.5, 0, 0.5], [0.5, 0.5, 0]])])
                tri = coords[cells]  # (nc, 3, gdim)
                self.dof_coords = np.einsum("lk,ckg->clg", bar, tri).reshape(
                    -1, coords.shape[1])
            self.ndofs = self.element_dofs.size
            return

        nv = mesh.num_vertices()
        if deg == 1 and tdim in (1, 2, 3):
            self.element_dofs = cells.astype(np.int32)
            self.dof_coords = coords.copy()
            self.ndofs = nv
        elif deg == 2 and tdim == 1:
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
        elif deg == 2 and tdim in (2, 3):
            # edges: unique sorted vertex pairs; a triangle's local edge i
            # lies opposite its local vertex i, a tet's follow _TET_EDGES
            local = ([(1, 2), (0, 2), (0, 1)] if tdim == 2 else _TET_EDGES)
            e_all = np.concatenate([cells[:, list(e)] for e in local], axis=0)
            e_sorted = np.sort(e_all, axis=1)
            uniq, inv = np.unique(e_sorted, axis=0, return_inverse=True)
            ncells = mesh.num_cells()
            edge_dof = nv + inv.reshape(len(local), ncells).T  # (ncells, n_edges)
            self.element_dofs = np.concatenate([cells, edge_dof], axis=1).astype(np.int32)
            mid = 0.5 * (coords[uniq[:, 0]] + coords[uniq[:, 1]])
            self.dof_coords = np.concatenate([coords, mid], axis=0)
            self.ndofs = nv + len(uniq)
            # sorted vertex pair of edge e → dof nv + e (the topological
            # boundary of an unstructured mesh is found through it)
            self.edge_vertices = uniq
        else:
            raise NotImplementedError(f"{tdim}D CG degree must be 1 or 2")

    # ----------------------------------------------------------- quadrature
    def _tabulate_quadrature(self):
        """Per-cell quadrature: global points, weights×|J|, basis values
        and global basis gradients (host numpy, set-up work)."""
        mesh, deg = self._mesh, self.degree
        tdim = mesh.topology_dim()
        coords = mesh.coordinates()
        cells = mesh.cells()
        if tdim == 1:
            nq = max(2 * deg + 1, 3)
            xi, w = gauss_legendre_01(nq)
            vals, dref = _shape_1d(deg, xi)  # (nl, nq)
            a = coords[cells[:, 0], 0]
            b = coords[cells[:, 1], 0]
            h = b - a
            self.q_points = (a[:, None] + np.outer(h, xi))[..., None]  # (nc, nq, 1)
            self.q_weights = np.outer(h, w)  # (nc, nq)
            self.q_basis = np.broadcast_to(vals, (len(cells),) + vals.shape)
            self.q_grads = (dref[None, :, :] / h[:, None, None])[..., None]
            return
        if tdim == 3:
            bary, w = _TET_RULE if deg <= 1 else _TET_RULE_DEG5
            vals, dbary = _shape_tet(deg, bary)  # (nl, nq), (nl, nq, 4)
            tet = coords[cells]  # (nc, 4, 3)
            v0 = tet[:, 0]
            J = np.stack([tet[:, 1] - v0, tet[:, 2] - v0, tet[:, 3] - v0], axis=2)
            detJ = np.linalg.det(J)
            Jinv = np.linalg.inv(J)
            dref = np.stack([dbary[:, :, i + 1] - dbary[:, :, 0] for i in range(3)], axis=2)
            simplex = tet
        else:
            bary, w = _TRI_RULES[2 if deg <= 1 else 4]
            vals, dbary = _shape_tri(deg, bary)  # (nl, nq), (nl, nq, 3)
            tri = coords[cells]  # (nc, 3, 2)
            # affine map x = v0 + J @ (l1, l2), J's columns v1 − v0, v2 − v0
            v0 = tri[:, 0]
            J = np.stack([tri[:, 1] - v0, tri[:, 2] - v0], axis=2)  # (nc, 2, 2)
            detJ = J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0]
            Jinv = np.stack(
                [np.stack([J[:, 1, 1], -J[:, 0, 1]], axis=1),
                 np.stack([-J[:, 1, 0], J[:, 0, 0]], axis=1)],
                axis=1,
            ) / detJ[:, None, None]
            # gradients wrt (l1, l2): d/dl1 = d/dbary1 − d/dbary0, etc.
            dref = np.stack([dbary[:, :, 1] - dbary[:, :, 0],
                             dbary[:, :, 2] - dbary[:, :, 0]], axis=2)
            simplex = tri
        self.q_points = np.einsum("qk,ckg->cqg", bary, simplex)
        self.q_weights = np.abs(detJ)[:, None] * w[None, :]
        self.q_basis = np.broadcast_to(vals, (len(cells),) + vals.shape)
        self.q_grads = np.einsum("lqr,crg->clqg", dref, Jinv)  # (nc, nl, nq, gdim)

    def element_dofs_device(self, device="cpu") -> torch.Tensor:
        """Element dof table as an int64 tensor on ``device`` (lazy)."""
        key = ("element_dofs", str(torch.device(device)))
        if key not in self._cache:
            self._cache[key] = torch.as_tensor(
                self.element_dofs, dtype=torch.int64, device=device
            )
        return self._cache[key]

    # -------------------------------------------------------------- queries
    def mesh(self) -> Mesh:
        return self._mesh

    def dim(self) -> int:
        return self.ndofs * max(self.value_size, 1)

    def tabulate_dof_coordinates(self) -> np.ndarray:
        """Dof coordinates, one row per scalar dof (dolfin parity)."""
        return self.dof_coords

    def scalar_space(self) -> "FunctionSpace":
        return self

    def ufl_element(self):
        return _ElementShim(self)

    def ufl_function_space(self):
        return self

    def __repr__(self):
        kind = "Vector" if self.value_size > 1 else ""
        return (f"{kind}FunctionSpace({self.family}{self.degree}, ndofs={self.dim()}, "
                f"tdim={self._mesh.topology_dim()})")


class _ElementShim:
    """The ``ufl_element()`` of a space: its degree and family (dolfin
    parity)."""

    def __init__(self, V):
        self._V = V

    def degree(self):
        return self._V.degree

    def family(self):
        return self._V.family

    def __str__(self):
        if self._V.value_size > 1:
            return f"<vector element {self._V.family}{self._V.degree}>"
        return f"<element {self._V.family}{self._V.degree}>"


class VectorFunctionSpace(FunctionSpace):
    """Vector-valued space with interleaved (node-major) dofs:
    dof(scalar dof s, component c) = s·value_size + c.  ``dim`` defaults
    to the mesh's geometric dimension.  Parity: dolfin.VectorFunctionSpace."""

    def __init__(self, mesh: Mesh, family: str = "P", degree: int = 1,
                 dim: int | None = None):
        super().__init__(mesh, family, degree)
        self.value_size = int(dim if dim is not None else mesh.geometry_dim())
        self.num_sub_spaces = self.value_size

    def component_dofs(self, c: int) -> np.ndarray:
        """The dofs of component ``c``."""
        return np.arange(self.ndofs) * self.value_size + c
