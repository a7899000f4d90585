"""Meshes: 1D intervals, 2D rectangles (right, left and crossed
diagonals), 3D boxes (the Kuhn split) and general simplicial meshes
(counterpart of ``pgdrome_tpu/fem/mesh.py``).

Topology and coordinates are host numpy, built once, by the JAX package's
own numpy code, so vertex and cell numbering agree to the index.  The
device copy of the coordinates is made lazily on first use, per device, so
host-only work (assembly, preconditioning) never touches the GPU.  A
:class:`SimplicialMesh` finds its topological boundary (facets incident to
one cell) and locates points through a bucketed search
(:class:`~pgdrome_tpu_torch.fem.interpolate.BucketLocator`), built on
first use.
"""

from __future__ import annotations

import numpy as np
import torch

from pgdrome_tpu_torch.config import default_dtype


class Point:
    """Geometric point; mirrors the two-argument mesh-constructor idiom."""

    def __init__(self, *coords: float):
        self.coords = tuple(float(c) for c in coords)

    def __getitem__(self, i):
        return self.coords[i]

    def __iter__(self):
        return iter(self.coords)

    def __len__(self):
        return len(self.coords)


class Mesh:
    """Base mesh: static topology (numpy int32) + host f64 coordinates."""

    def __init__(self, coordinates: np.ndarray, cells: np.ndarray, tdim: int):
        self._coords_np = np.asarray(coordinates, dtype=np.float64)
        if self._coords_np.ndim == 1:
            self._coords_np = self._coords_np[:, None]
        self._cells_np = np.asarray(cells, dtype=np.int32)
        self._tdim = int(tdim)
        self._coords_dev = {}  # (device, dtype) → lazy tensor copy

    def coordinates(self) -> np.ndarray:
        """Vertex coordinates, shape (num_vertices, gdim); host numpy."""
        return self._coords_np

    def coordinates_device(self, device="cpu", dtype=None) -> torch.Tensor:
        """Vertex coordinates as a tensor on ``device`` (made on first use)."""
        dtype = dtype or default_dtype()
        key = (str(torch.device(device)), dtype)
        if key not in self._coords_dev:
            self._coords_dev[key] = torch.as_tensor(
                self._coords_np, dtype=dtype, device=device
            )
        return self._coords_dev[key]

    def cells(self) -> np.ndarray:
        """Cell connectivity, shape (num_cells, verts_per_cell)."""
        return self._cells_np

    def num_cells(self) -> int:
        return self._cells_np.shape[0]

    def num_vertices(self) -> int:
        return self._coords_np.shape[0]

    def topology_dim(self) -> int:
        return self._tdim

    def geometry_dim(self) -> int:
        return self._coords_np.shape[1]

    # dolfin's mesh.topology().dim() and mesh.geometry().dim()
    def topology(self):
        return _DimShim(self._tdim)

    def geometry(self):
        return _DimShim(self._coords_np.shape[1])

    def hmin(self) -> float:
        raise NotImplementedError

    def __repr__(self):
        return (
            f"{self.__class__.__name__}(vertices={self.num_vertices()}, "
            f"cells={self.num_cells()}, tdim={self._tdim})"
        )


class _DimShim:
    """What ``topology()`` and ``geometry()`` return: their ``dim()``."""

    def __init__(self, d):
        self._d = d

    def dim(self):
        return self._d


class IntervalMesh(Mesh):
    """1D mesh of ``n`` cells on ``[a, b]`` with ascending vertex order.

    Also accepts explicit (possibly non-uniform) vertex coordinates via
    :meth:`from_points`.
    """

    def __init__(self, n: int, a: float, b: float):
        if n < 1:
            raise ValueError("IntervalMesh needs at least 1 cell")
        pts = np.linspace(float(a), float(b), int(n) + 1)
        cells = np.stack([np.arange(n), np.arange(1, n + 1)], axis=1)
        super().__init__(pts, cells, tdim=1)

    @classmethod
    def from_points(cls, points) -> "IntervalMesh":
        pts = np.sort(np.asarray(points, dtype=np.float64).ravel())
        self = cls.__new__(cls)
        n = len(pts) - 1
        cells = np.stack([np.arange(n), np.arange(1, n + 1)], axis=1)
        Mesh.__init__(self, pts, cells, tdim=1)
        return self

    def hmin(self) -> float:
        return float(np.min(np.diff(self._coords_np[:, 0])))


class RectangleMesh(Mesh):
    """Structured triangulation of ``[p0, p1]`` with nx × ny quads.

    ``diagonal`` in {'right', 'left', 'crossed'}: 'right'/'left' split each
    quad into 2 triangles; 'crossed' adds the quad centre and splits it
    into 4.  Vertex order: grid vertices row-major (x fastest), then — for
    'crossed' — the quad centres."""

    def __init__(self, p0: Point, p1: Point, nx: int, ny: int, diagonal: str = "right"):
        x0, y0 = p0[0], p0[1]
        x1, y1 = p1[0], p1[1]
        nx, ny = int(nx), int(ny)
        xs = np.linspace(x0, x1, nx + 1)
        ys = np.linspace(y0, y1, ny + 1)
        X, Y = np.meshgrid(xs, ys, indexing="xy")  # row-major over y rows
        verts = np.stack([X.ravel(), Y.ravel()], axis=1)  # idx = j*(nx+1)+i

        def vid(i, j):
            return j * (nx + 1) + i

        tris = []
        if diagonal in ("right", "left"):
            for j in range(ny):
                for i in range(nx):
                    v00, v10 = vid(i, j), vid(i + 1, j)
                    v01, v11 = vid(i, j + 1), vid(i + 1, j + 1)
                    if diagonal == "right":
                        tris.append([v00, v10, v11])
                        tris.append([v00, v11, v01])
                    else:
                        tris.append([v00, v10, v01])
                        tris.append([v10, v11, v01])
        elif diagonal == "crossed":
            centers = []
            cbase = (nx + 1) * (ny + 1)
            for j in range(ny):
                for i in range(nx):
                    cx = 0.5 * (xs[i] + xs[i + 1])
                    cy = 0.5 * (ys[j] + ys[j + 1])
                    cidx = cbase + len(centers)
                    centers.append([cx, cy])
                    v00, v10 = vid(i, j), vid(i + 1, j)
                    v01, v11 = vid(i, j + 1), vid(i + 1, j + 1)
                    tris.append([v00, v10, cidx])
                    tris.append([v10, v11, cidx])
                    tris.append([v11, v01, cidx])
                    tris.append([v01, v00, cidx])
            verts = np.concatenate([verts, np.asarray(centers)], axis=0)
        else:
            raise ValueError(f"unknown diagonal '{diagonal}'")

        super().__init__(verts, np.asarray(tris, dtype=np.int32), tdim=2)
        self.nx, self.ny = nx, ny
        self.bounds = ((x0, x1), (y0, y1))
        self.diagonal = diagonal

    def hmin(self) -> float:
        (x0, x1), (y0, y1) = self.bounds
        return float(min((x1 - x0) / self.nx, (y1 - y0) / self.ny))


class BoxMesh(Mesh):
    """Structured tetrahedralisation of ``[p0, p1]`` with nx × ny × nz
    hexes, each split into 6 tets (the conforming Kuhn split).  Vertex
    order: x fastest, then y, then z (idx = (k·(ny+1) + j)·(nx+1) + i)."""

    _KUHN_PERMS = [(0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0)]

    def __init__(self, p0: Point, p1: Point, nx: int, ny: int, nz: int):
        x0, y0, z0 = p0[0], p0[1], p0[2]
        x1, y1, z1 = p1[0], p1[1], p1[2]
        nx, ny, nz = int(nx), int(ny), int(nz)
        xs = np.linspace(x0, x1, nx + 1)
        ys = np.linspace(y0, y1, ny + 1)
        zs = np.linspace(z0, z1, nz + 1)
        Z, Y, X = np.meshgrid(zs, ys, xs, indexing="ij")
        verts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

        def vid(i, j, k):
            return (k * (ny + 1) + j) * (nx + 1) + i

        tets = []
        # Kuhn split: each tet is the path 0 -> e_{p0} -> e_{p0}+e_{p1} -> 1
        for k in range(nz):
            for j in range(ny):
                for i in range(nx):
                    corner = np.array([i, j, k])
                    for perm in self._KUHN_PERMS:
                        path = [corner.copy()]
                        cur = corner.copy()
                        for ax in perm:
                            cur = cur.copy()
                            cur[ax] += 1
                            path.append(cur)
                        tets.append([vid(*p) for p in path])
        super().__init__(verts, np.asarray(tets, dtype=np.int32), tdim=3)
        self.nx, self.ny, self.nz = nx, ny, nz
        self.bounds = ((x0, x1), (y0, y1), (z0, z1))


class SimplicialMesh(Mesh):
    """General unstructured simplicial mesh from explicit arrays: ``cells``
    (num_cells, tdim+1) vertex indices, ``coordinates`` (num_vertices,
    gdim) with gdim == tdim.  Its boundary is topological (facets incident
    to exactly one cell — the bounding box is not the boundary of an
    unstructured mesh), and its points are located by a bucketed search
    (:meth:`locator`)."""

    def __init__(self, coordinates, cells):
        coords = np.asarray(coordinates, dtype=np.float64)
        if coords.ndim == 1:
            coords = coords[:, None]
        cells = np.asarray(cells, dtype=np.int32)
        if cells.ndim != 2 or cells.shape[1] < 2:
            raise ValueError("cells must be (num_cells, verts_per_simplex)")
        tdim = cells.shape[1] - 1
        if tdim not in (1, 2, 3):
            raise ValueError(f"simplex with {cells.shape[1]} vertices unsupported")
        if coords.shape[1] != tdim:
            raise ValueError(f"gdim {coords.shape[1]} != tdim {tdim}: embedded/manifold "
                             "meshes not supported")
        if cells.min() < 0 or cells.max() >= coords.shape[0]:
            raise ValueError("cell vertex index out of range")
        # a degenerate (zero-volume) cell would make the locator's affine
        # inverse singular
        verts = coords[cells]
        v0 = verts[:, 0]
        T = np.stack([verts[:, i + 1] - v0 for i in range(tdim)], axis=2)
        det = np.linalg.det(T) if tdim > 1 else T[:, 0, 0]
        if np.any(np.abs(det) < 1e-300):
            raise ValueError("degenerate (zero-volume) cell in mesh")
        if tdim == 1 and (np.any(np.diff(coords[:, 0]) <= 0.0) or not np.array_equal(
                cells, np.stack([np.arange(len(cells)), np.arange(1, len(cells) + 1)],
                                axis=1))):
            # the 1D quadrature (signed h) and locate (searchsorted) assume
            # interval ordering
            raise ValueError("1D SimplicialMesh requires strictly increasing coordinates "
                             "and cells [[0,1],[1,2],...]; sort/renumber the input (or use "
                             "IntervalMesh for uniform grids)")
        super().__init__(coords, cells, tdim=tdim)
        self.bounds = tuple((float(coords[:, a].min()), float(coords[:, a].max()))
                            for a in range(coords.shape[1]))
        self._locator = None
        self._boundary_facets = None

    def hmin(self) -> float:
        verts = self._coords_np[self._cells_np]  # (nc, nl, gdim)
        nl = verts.shape[1]
        h = np.inf
        for i in range(nl):
            for j in range(i + 1, nl):
                h = min(h, float(np.linalg.norm(verts[:, i] - verts[:, j], axis=1).min()))
        return h

    def boundary_facets(self) -> np.ndarray:
        """(n_bfacets, tdim) sorted vertex indices of the facets incident to
        exactly one cell — the topological boundary."""
        if self._boundary_facets is None:
            cells = self._cells_np
            # facet i of a simplex = all vertices but local vertex i
            facets = np.concatenate([np.delete(cells, i, axis=1)
                                     for i in range(self._tdim + 1)], axis=0)
            facets = np.sort(facets, axis=1)
            uniq, counts = np.unique(facets, axis=0, return_counts=True)
            self._boundary_facets = uniq[counts == 1]
        return self._boundary_facets

    def boundary_vertex_mask(self) -> np.ndarray:
        """(num_vertices,) bool: the vertex lies on the topological boundary."""
        mask = np.zeros(self.num_vertices(), dtype=bool)
        mask[np.unique(self.boundary_facets())] = True
        return mask

    def locator(self):
        """The bucketed point locator, built on first use."""
        if self._locator is None:
            from pgdrome_tpu_torch.fem.interpolate import BucketLocator

            self._locator = BucketLocator(self)
        return self._locator
