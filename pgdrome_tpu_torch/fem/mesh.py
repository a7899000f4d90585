"""Meshes: 1D intervals (counterpart of ``pgdrome_tpu/fem/mesh.py``).

Topology and coordinates are host numpy, built once.  The device copy of
the coordinates is made lazily on first use, per device, so host-only
work (assembly, preconditioning) never touches the GPU.
"""

from __future__ import annotations

import numpy as np
import torch

from pgdrome_tpu_torch.config import default_dtype


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

    def __repr__(self):
        return (
            f"{self.__class__.__name__}(vertices={self.num_vertices()}, "
            f"cells={self.num_cells()}, tdim={self._tdim})"
        )


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
