"""Point evaluation of FE functions on 1D intervals: cell locate + local
basis (counterpart of the interval part of
``pgdrome_tpu/fem/interpolate.py``).

Array-module generic like the JAX version: ``xp=numpy`` (default) for the
host, ``xp=torch`` for tensors on any device.  With ``xp=torch`` the vertex
array is taken on the points' device and in their dtype, so a float32
sweep stays float32 on the GPU.
"""

from __future__ import annotations

import numpy as np
import torch


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


def eval_dofs_at_points(V, dofs, points, xp=np, derivative=False):
    """Evaluate a FE function (dof vector ``dofs`` on the 1D space ``V``)
    at ``points`` of shape (...,) or (..., 1); returns (...,).
    ``derivative=True`` evaluates d/dx instead: the reference-cell
    derivative over h, one-sided at cell boundaries (a vertex belongs to
    the cell on its right, the right end to the last cell)."""
    if xp is torch:
        pts = torch.as_tensor(points)
        dofs = torch.as_tensor(dofs, device=pts.device)
        ed = V.element_dofs_device(pts.device)
    else:
        pts = np.asarray(points)
        dofs = np.asarray(dofs)
        ed = V.element_dofs
    if pts.ndim > 1 and pts.shape[-1] == 1:
        pts = pts[..., 0]
    cell, xi = _locate_1d(V.mesh(), pts, xp)
    if derivative:
        h = _cell_widths(V.mesh(), cell, xi, xp)
        basis = _dshape_1d_x(V.degree, xi, xp) / h[..., None]
    else:
        basis = _shape_1d_x(V.degree, xi, xp)  # (..., nl)
    return (dofs[ed[cell]] * basis).sum(-1)


def check_in_range(V, points) -> None:
    """Raise ValueError if any point lies outside the mesh (host-side)."""
    verts = V.mesh().coordinates()[:, 0]
    lo, hi = float(verts.min()), float(verts.max())
    flat = np.asarray(points, dtype=np.float64).ravel()
    if np.any(flat < lo - 1e-12) or np.any(flat > hi + 1e-12):
        raise ValueError(
            f"point(s) outside mesh range [{lo}, {hi}]: "
            f"{flat[(flat < lo) | (flat > hi)]}"
        )
