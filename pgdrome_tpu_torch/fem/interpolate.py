"""Point evaluation of FE functions: cell locate + local basis (counterpart
of ``pgdrome_tpu/fem/interpolate.py``).

Intervals are located by a sorted search, ``RectangleMesh`` and
``BoxMesh`` cells by arithmetic (no search), and unstructured simplicial
meshes by a bucketed candidate search (:class:`BucketLocator`).  Values,
and with ``derivative=True`` gradients, of scalar and vector functions.

Array-module generic like the JAX version: ``xp=numpy`` (default) for the
host, ``xp=torch`` for tensors on any device.  With ``xp=torch`` the mesh
tables are taken on the points' device and in their dtype, so a float32
sweep stays float32 on the GPU.  The bucketed locate of unstructured meshes
is host numpy only.
"""

from __future__ import annotations

import numpy as np
import torch

from pgdrome_tpu_torch.fem.mesh import RectangleMesh


class BucketLocator:
    """Static-shape bucketed point locator for unstructured simplicial
    meshes (``SimplicialMesh.locator()``): a uniform bucket grid over the
    bounding box, each bucket a padded candidate-cell list, and per point
    the candidate with the largest minimum barycentric coordinate."""

    # round-off slack on barycentric containment (points on edges and
    # vertices sit at exactly 0)
    CONTAIN_TOL = 1e-9

    def __init__(self, mesh, max_buckets_per_axis: int = 64):
        import itertools

        coords = mesh.coordinates()
        cells = mesh.cells()
        tdim = mesh.topology_dim()
        verts = coords[cells]  # (nc, tdim+1, gdim)
        v0 = verts[:, 0]
        # x = v0 + T @ bary_rest with T's columns the edge vectors
        T = np.stack([verts[:, i + 1] - v0 for i in range(tdim)], axis=2)
        self.v0 = v0
        self.Tinv = np.linalg.inv(T)  # (nc, tdim, tdim)
        nc = cells.shape[0]
        lo = coords.min(axis=0)
        hi = coords.max(axis=0)
        # about one cell a bucket (a cell lands in every bucket its bounding
        # box overlaps, so the candidate lists stay short)
        nb = int(np.clip(round(nc ** (1.0 / tdim)), 1, max_buckets_per_axis))
        h = (hi - lo) / nb
        h[h == 0] = 1.0
        self.lo, self.h, self.nb, self.tdim = lo, h, nb, tdim
        bmin = np.clip(np.floor((verts.min(axis=1) - lo) / h).astype(np.int64), 0, nb - 1)
        bmax = np.clip(np.floor((verts.max(axis=1) - lo) / h).astype(np.int64), 0, nb - 1)
        buckets = [[] for _ in range(nb ** tdim)]
        for c in range(nc):
            for idx in itertools.product(
                    *[range(bmin[c, a], bmax[c, a] + 1) for a in range(tdim)]):
                flat = 0
                for a in range(tdim):
                    flat = flat * nb + idx[a]
                buckets[flat].append(c)
        K = max(1, max(len(b) for b in buckets))
        cand = np.zeros((len(buckets), K), dtype=np.int32)
        for i, b in enumerate(buckets):
            if b:
                cand[i, : len(b)] = b
                cand[i, len(b):] = b[-1]  # pad by repetition: harmless under the argmax
        self.cand = cand

    def locate(self, pts):
        """Host points (..., gdim) → (cell (...,), bary (..., tdim+1)).
        Raises for points outside the mesh (the best candidate's smallest
        barycentric coordinate below −CONTAIN_TOL, e.g. in a hole of a
        non-convex mesh)."""
        pts = np.asarray(pts)
        idx = np.clip(np.floor((pts - self.lo) / self.h).astype(np.int32), 0, self.nb - 1)
        flat = idx[..., 0]
        for a in range(1, self.tdim):
            flat = flat * self.nb + idx[..., a]
        cand = self.cand[flat]  # (..., K)
        rel = pts[..., None, :] - self.v0[cand]
        br = np.einsum("...ij,...j->...i", self.Tinv[cand], rel)  # (..., K, tdim)
        bary = np.concatenate([1.0 - np.sum(br, axis=-1, keepdims=True), br], axis=-1)
        best = np.argmax(np.min(bary, axis=-1), axis=-1)
        cell = np.take_along_axis(cand, best[..., None], axis=-1)[..., 0]
        bary_best = np.take_along_axis(bary, best[..., None, None], axis=-2)[..., 0, :]
        outside = np.min(bary_best, axis=-1) < -self.CONTAIN_TOL
        if np.any(outside):
            bad = pts[outside]
            raise ValueError(f"{bad.shape[0]} point(s) outside the mesh (first few: "
                             f"{bad[:3].tolist()})")
        return cell, bary_best


# ----------------------------------------------------------- array helpers

def _ifloor(v, xp):
    """floor(v) as an integer index array."""
    return torch.floor(v).to(torch.int64) if xp is torch else np.floor(v).astype(np.int32)


def _as_float(i, like, xp):
    """An integer index array in the float dtype of ``like`` (torch would
    otherwise promote int × float to its default float32)."""
    return i.to(like.dtype) if xp is torch else i


def _mesh_tables(mesh, like, xp):
    """(coordinates, cells) of ``mesh`` as arrays of ``xp`` (for torch on
    ``like``'s device, the coordinates in its dtype)."""
    if xp is torch:
        return (mesh.coordinates_device(like.device, like.dtype),
                torch.as_tensor(mesh.cells(), dtype=torch.int64, device=like.device))
    return mesh.coordinates(), mesh.cells()


# ---------------------------------------------------------------- 1D

def _locate_1d(mesh, x, xp):
    """Cell index + local coordinate xi for 1D points."""
    nc = mesh.num_cells()
    if xp is torch:
        x = torch.as_tensor(x)
        verts = mesh.coordinates_device(x.device, x.dtype)[:, 0].contiguous()
        idx = torch.searchsorted(verts, x.contiguous(), right=True) - 1
        idx = torch.clip(idx, 0, nc - 1)
    else:
        verts = np.asarray(mesh.coordinates()[:, 0])
        x = np.asarray(x)
        idx = np.clip(np.searchsorted(verts, x, side="right") - 1, 0, nc - 1)
    a = verts[idx]
    b = verts[idx + 1]
    xi = (x - a) / (b - a)
    return idx, xi


def _shape_1d_x(degree, xi, xp):
    """Lagrange basis values at local coordinates xi: (..., degree+1)."""
    if degree == 0:
        return xp.ones_like(xi)[..., None]
    if degree == 1:
        return xp.stack([1.0 - xi, xi], -1)
    if degree == 2:
        return xp.stack(
            [(1.0 - xi) * (1.0 - 2.0 * xi), 4.0 * xi * (1.0 - xi),
             xi * (2.0 * xi - 1.0)],
            -1,
        )
    raise NotImplementedError(f"1D degree {degree}")


def _dshape_1d_x(degree, xi, xp):
    """d/dξ of the Lagrange basis at local coordinates xi: (..., degree+1)."""
    if degree == 0:
        return xp.zeros_like(xi)[..., None]
    if degree == 1:
        return xp.stack([-xp.ones_like(xi), xp.ones_like(xi)], -1)
    if degree == 2:
        return xp.stack([4.0 * xi - 3.0, 4.0 - 8.0 * xi, 4.0 * xi - 1.0], -1)
    raise NotImplementedError(f"1D degree {degree}")


def _cell_widths(mesh, cell, like, xp):
    """Width h of each located cell, as an array like ``like``."""
    if xp is torch:
        verts = mesh.coordinates_device(like.device, like.dtype)[:, 0]
    else:
        verts = np.asarray(mesh.coordinates()[:, 0])
    return verts[cell + 1] - verts[cell]


# ---------------------------------------------------------------- 2D

def _shape_tri_x(degree, bary, xp):
    """Triangle basis values at barycentric points: (..., nl)."""
    l0, l1, l2 = bary[..., 0], bary[..., 1], bary[..., 2]
    if degree == 1:
        return xp.stack([l0, l1, l2], -1)
    if degree == 2:
        return xp.stack([l0 * (2 * l0 - 1), l1 * (2 * l1 - 1), l2 * (2 * l2 - 1),
                         4 * l1 * l2, 4 * l0 * l2, 4 * l0 * l1], -1)
    if degree == 0:
        return xp.ones_like(l0)[..., None]
    raise NotImplementedError(f"triangle degree {degree}")


def _locate_2d(mesh: RectangleMesh, pts, xp):
    """Cell index of points in a RectangleMesh (arithmetic, no search)."""
    (x0, x1), (y0, y1) = mesh.bounds
    nx, ny = mesh.nx, mesh.ny
    hx = (x1 - x0) / nx
    hy = (y1 - y0) / ny
    x = pts[..., 0]
    y = pts[..., 1]
    i = xp.clip(_ifloor((x - x0) / hx, xp), 0, nx - 1)
    j = xp.clip(_ifloor((y - y0) / hy, xp), 0, ny - 1)
    u = (x - (x0 + _as_float(i, x, xp) * hx)) / hx
    v = (y - (y0 + _as_float(j, y, xp) * hy)) / hy
    quad = j * nx + i
    if mesh.diagonal == "crossed":
        # 4 triangles per quad: bottom(0), right(1), top(2), left(3)
        below_main = v <= u
        below_anti = v <= 1.0 - u
        local = xp.where(below_main & below_anti, 0,
                         xp.where(below_main, 1, xp.where(~below_anti, 2, 3)))
        return quad * 4 + local
    if mesh.diagonal == "right":
        return quad * 2 + xp.where(v <= u, 0, 1)
    return quad * 2 + xp.where(u + v <= 1.0, 0, 1)  # left


def _bary_in_cell(mesh, cell, pts, xp):
    """Barycentric coordinates of points in their (triangle) cells."""
    coords, cells = _mesh_tables(mesh, pts, xp)
    tri = coords[cells[cell]]  # (..., 3, 2)
    v0, v1, v2 = tri[..., 0, :], tri[..., 1, :], tri[..., 2, :]
    d = (v1[..., 0] - v0[..., 0]) * (v2[..., 1] - v0[..., 1]) - (
        v2[..., 0] - v0[..., 0]) * (v1[..., 1] - v0[..., 1])
    l1 = ((pts[..., 0] - v0[..., 0]) * (v2[..., 1] - v0[..., 1])
          - (v2[..., 0] - v0[..., 0]) * (pts[..., 1] - v0[..., 1])) / d
    l2 = ((v1[..., 0] - v0[..., 0]) * (pts[..., 1] - v0[..., 1])
          - (pts[..., 0] - v0[..., 0]) * (v1[..., 1] - v0[..., 1])) / d
    l0 = 1.0 - l1 - l2
    return xp.stack([l0, l1, l2], -1)


def _dshape_tri_x(degree, bary, xp):
    """Triangle basis gradients wrt the barycentric coords: (..., nl, 3)."""
    l0, l1, l2 = bary[..., 0], bary[..., 1], bary[..., 2]
    z = xp.zeros_like(l0)
    if degree == 1:
        o = xp.ones_like(l0)
        rows = [[o, z, z], [z, o, z], [z, z, o]]
    elif degree == 2:
        rows = [[4 * l0 - 1, z, z], [z, 4 * l1 - 1, z], [z, z, 4 * l2 - 1],
                [z, 4 * l2, 4 * l1], [4 * l2, z, 4 * l0], [4 * l1, 4 * l0, z]]
    elif degree == 0:
        rows = [[z, z, z]]
    else:
        raise NotImplementedError(f"triangle degree {degree}")
    return xp.stack([xp.stack(r, -1) for r in rows], -2)


# ---------------------------------------------------------------- 3D

# local edge pairs of the P2 tet (fem.space._TET_EDGES)
_TET_EDGE_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def _shape_tet_x(degree, bary, xp):
    """Tet basis values at barycentric points: (..., nl)."""
    if degree == 1:
        return bary
    if degree == 2:
        ls = [bary[..., i] for i in range(4)]
        vals = [li * (2.0 * li - 1.0) for li in ls]
        vals += [4.0 * ls[a] * ls[b] for (a, b) in _TET_EDGE_PAIRS]
        return xp.stack(vals, -1)
    if degree == 0:
        return xp.ones_like(bary[..., 0])[..., None]
    raise NotImplementedError(f"tet degree {degree}")


def _dshape_tet_x(degree, bary, xp):
    """Tet basis gradients wrt the barycentric coords: (..., nl, 4)."""
    ls = [bary[..., i] for i in range(4)]
    z = xp.zeros_like(ls[0])
    if degree == 1:
        o = xp.ones_like(ls[0])
        rows = [[o if j == i else z for j in range(4)] for i in range(4)]
    elif degree == 2:
        rows = [[4 * ls[i] - 1 if j == i else z for j in range(4)] for i in range(4)]
        for (a, b) in _TET_EDGE_PAIRS:
            r = [z, z, z, z]
            r[a] = 4 * ls[b]
            r[b] = 4 * ls[a]
            rows.append(r)
    elif degree == 0:
        rows = [[z, z, z, z]]
    else:
        raise NotImplementedError(f"tet degree {degree}")
    return xp.stack([xp.stack(r, -1) for r in rows], -2)


def _cell_jinv(mesh, cell, like, xp, tdim):
    """Inverse Jacobian of each point's located cell: (..., tdim, tdim),
    J's columns the cell's edge vectors v_i − v_0."""
    coords, cells = _mesh_tables(mesh, like, xp)
    verts = coords[cells[cell]]  # (..., nl_v, gdim)
    v0 = verts[..., 0, :]
    J = xp.stack([verts[..., i + 1, :] - v0 for i in range(tdim)], -1)  # (..., gdim, tdim)
    if tdim == 2:
        a, b = J[..., 0, 0], J[..., 0, 1]
        c, d = J[..., 1, 0], J[..., 1, 1]
        det = a * d - b * c
        return xp.stack([xp.stack([d, -b], -1), xp.stack([-c, a], -1)], -2) / det[..., None, None]
    # 3×3 adjugate
    m = J
    c00 = m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1]
    c01 = m[..., 0, 2] * m[..., 2, 1] - m[..., 0, 1] * m[..., 2, 2]
    c02 = m[..., 0, 1] * m[..., 1, 2] - m[..., 0, 2] * m[..., 1, 1]
    c10 = m[..., 1, 2] * m[..., 2, 0] - m[..., 1, 0] * m[..., 2, 2]
    c11 = m[..., 0, 0] * m[..., 2, 2] - m[..., 0, 2] * m[..., 2, 0]
    c12 = m[..., 0, 2] * m[..., 1, 0] - m[..., 0, 0] * m[..., 1, 2]
    c20 = m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]
    c21 = m[..., 0, 1] * m[..., 2, 0] - m[..., 0, 0] * m[..., 2, 1]
    c22 = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
    det = m[..., 0, 0] * c00 + m[..., 0, 1] * c10 + m[..., 0, 2] * c20
    adj = xp.stack([xp.stack([c00, c01, c02], -1), xp.stack([c10, c11, c12], -1),
                    xp.stack([c20, c21, c22], -1)], -2)
    return adj / det[..., None, None]


def _grad_basis_simplex(mesh, V, cell, bary, xp, tdim):
    """Global basis gradients at located points, (..., nl, gdim): the
    barycentric gradients mapped through the cell's inverse Jacobian
    (d/dl_i wrt the reference coords l_1..l_tdim is dbary_i − dbary_0)."""
    dbary = (_dshape_tri_x if tdim == 2 else _dshape_tet_x)(V.degree, bary, xp)
    dref = xp.stack([dbary[..., i + 1] - dbary[..., 0] for i in range(tdim)], -1)
    Jinv = _cell_jinv(mesh, cell, bary, xp, tdim)
    return xp.einsum("...lr,...rg->...lg", dref, Jinv)


def _locate_3d(mesh, pts, xp):
    """Cell index + barycentric coords of points in a BoxMesh (Kuhn split:
    the tet of permutation π holds the local coords with u_π0 ≥ u_π1 ≥
    u_π2)."""
    (x0, x1), (y0, y1), (z0, z1) = mesh.bounds
    nx, ny, nz = mesh.nx, mesh.ny, mesh.nz
    hx, hy, hz = (x1 - x0) / nx, (y1 - y0) / ny, (z1 - z0) / nz
    i = xp.clip(_ifloor((pts[..., 0] - x0) / hx, xp), 0, nx - 1)
    j = xp.clip(_ifloor((pts[..., 1] - y0) / hy, xp), 0, ny - 1)
    k = xp.clip(_ifloor((pts[..., 2] - z0) / hz, xp), 0, nz - 1)
    u = (pts[..., 0] - (x0 + _as_float(i, pts, xp) * hx)) / hx
    v = (pts[..., 1] - (y0 + _as_float(j, pts, xp) * hy)) / hy
    w = (pts[..., 2] - (z0 + _as_float(k, pts, xp) * hz)) / hz
    hexid = (k * ny + j) * nx + i
    # the Kuhn tet holding (u, v, w) follows the descending order of the
    # local coords; rank each axis (0 = largest, ties toward the lower
    # axis: an adjacent tet, the barycentric coords stay continuous)
    a0 = (u < v) * 1 + (u < w) * 1  # rank of u
    a1 = (v <= u) * 1 + (v < w) * 1  # rank of v
    # permutation index in BoxMesh._KUHN_PERMS order:
    # (0,1,2)->0 (0,2,1)->1 (1,0,2)->2 (1,2,0)->3 (2,0,1)->4 (2,1,0)->5
    first = xp.where(a0 == 0, 0, xp.where(a1 == 0, 1, 2))
    second = xp.where(a0 == 1, 0, xp.where(a1 == 1, 1, 2))
    local = xp.where(
        (first == 0) & (second == 1), 0,
        xp.where((first == 0) & (second == 2), 1,
                 xp.where((first == 1) & (second == 0), 2,
                          xp.where((first == 1) & (second == 2), 3,
                                   xp.where((first == 2) & (second == 0), 4, 5)))))
    cell = hexid * 6 + local
    # barycentric coords along the Kuhn path: s0 ≥ s1 ≥ s2 sorted, then
    # l0 = 1 − s0, l1 = s0 − s1, l2 = s1 − s2, l3 = s2
    s0 = xp.maximum(xp.maximum(u, v), w)
    s2 = xp.minimum(xp.minimum(u, v), w)
    s1 = u + v + w - s0 - s2
    return cell, xp.stack([1.0 - s0, s0 - s1, s1 - s2, s2], -1)


def eval_dofs_at_points(V, dofs, points, xp=np, derivative=False):
    """Evaluate a FE function (dof vector ``dofs`` on the space ``V``) at
    ``points``: (...,) or (..., 1) on an interval, (..., gdim) otherwise.
    Returns (...,) for scalar spaces and (..., value_size) for vector ones.
    ``derivative=True`` evaluates the spatial derivative instead: d/dx on
    an interval (same shapes; one-sided at cell boundaries, a vertex
    belonging to the cell on its right, the right end to the last cell),
    the gradient in 2D/3D — (..., gdim) for scalar spaces, (...,
    value_size, gdim) for vector ones."""
    mesh = V.mesh()
    tdim = mesh.topology_dim()
    vs = max(V.value_size, 1)
    if xp is torch:
        pts = torch.as_tensor(points)
        dofs = torch.as_tensor(dofs, device=pts.device)
        ed = V.element_dofs_device(pts.device)
    else:
        pts = np.asarray(points)
        dofs = np.asarray(dofs)
        ed = V.element_dofs
    if tdim == 1:
        if pts.ndim > 1 and pts.shape[-1] == 1:
            pts = pts[..., 0]
        cell, xi = _locate_1d(mesh, pts, xp)
        if derivative:
            basis = _dshape_1d_x(V.degree, xi, xp) / _cell_widths(mesh, cell, xi, xp)[..., None]
        else:
            basis = _shape_1d_x(V.degree, xi, xp)  # (..., nl)
    else:
        if isinstance(mesh, RectangleMesh):
            cell = _locate_2d(mesh, pts, xp)
            bary = _bary_in_cell(mesh, cell, pts, xp)
        elif hasattr(mesh, "nz"):  # BoxMesh
            cell, bary = _locate_3d(mesh, pts, xp)
        else:  # unstructured simplices: the bucketed locate (host)
            if xp is torch:
                raise NotImplementedError("unstructured meshes locate on the host (xp=numpy)")
            cell, bary = mesh.locator().locate(pts)
        if derivative:
            basis = _grad_basis_simplex(mesh, V, cell, bary, xp, tdim)  # (..., nl, gdim)
        else:
            basis = (_shape_tri_x if tdim == 2 else _shape_tet_x)(V.degree, bary, xp)
    local = ed[cell]  # (..., nl)
    grad_nd = derivative and tdim >= 2
    if vs == 1:
        return ((dofs[local][..., None] * basis).sum(-2) if grad_nd
                else (dofs[local] * basis).sum(-1))
    if grad_nd:
        return xp.stack([(dofs[local * vs + c][..., None] * basis).sum(-2)
                         for c in range(vs)], -2)  # (..., vs, gdim)
    return xp.stack([(dofs[local * vs + c] * basis).sum(-1) for c in range(vs)], -1)


def check_in_range(V, points) -> None:
    """Raise ValueError if any point lies outside the mesh's range
    (interval) or bounding box (host-side)."""
    mesh = V.mesh()
    pts = np.asarray(points, dtype=np.float64)
    if mesh.topology_dim() == 1:
        verts = mesh.coordinates()[:, 0]
        lo, hi = float(verts.min()), float(verts.max())
        flat = pts.ravel()
        if np.any(flat < lo - 1e-12) or np.any(flat > hi + 1e-12):
            raise ValueError(
                f"point(s) outside mesh range [{lo}, {hi}]: "
                f"{flat[(flat < lo) | (flat > hi)]}"
            )
        return
    pflat = pts.reshape(-1, mesh.geometry_dim())
    for ax, (lo, hi) in enumerate(mesh.bounds):
        if np.any(pflat[:, ax] < lo - 1e-12) or np.any(pflat[:, ax] > hi + 1e-12):
            raise ValueError(f"point(s) outside mesh bounds on axis {ax}")
