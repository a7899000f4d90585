"""Dirichlet boundary conditions (counterpart of ``pgdrome_tpu/fem/bc.py``).

Constrained dofs are found by evaluating the user predicate at the dof
coordinates, exactly as in the JAX package.  The boundary is the interval's
ends, a structured mesh's bounding box, or — on a ``SimplicialMesh`` — the
topological boundary (facets incident to one cell): vertices, the P2
dofs of boundary edges, and DG dofs lying on a boundary facet.  ``apply``
sets the values in a vector; ``apply_system`` eliminates them from a dense
or scipy-sparse system symmetrically, with lifting.
"""

from __future__ import annotations

import inspect

import numpy as np

from pgdrome_tpu_torch.fem.space import FunctionSpace
from pgdrome_tpu_torch.fem.function import Function, Expression, _VectorView


def _on_boundary_mask(V: FunctionSpace) -> np.ndarray:
    mesh = V.mesh()
    pts = V.tabulate_dof_coordinates()
    if mesh.topology_dim() == 1:
        x = pts[:, 0]
        verts = mesh.coordinates()[:, 0]
        lo, hi = verts.min(), verts.max()
        return (np.abs(x - lo) < 1e-12) | (np.abs(x - hi) < 1e-12)
    if hasattr(mesh, "boundary_vertex_mask"):
        # unstructured: the topological boundary, not the bounding box
        if V.family != "DG":
            # P1: the boundary vertices; P2: and the midpoints of the edges
            # of boundary facets (the facet is the edge in 2D, a triangle
            # of three edges in 3D)
            nv = mesh.num_vertices()
            mask = np.zeros(len(pts), dtype=bool)
            mask[:nv] = mesh.boundary_vertex_mask()
            if V.degree == 2 and hasattr(V, "edge_vertices"):
                bset = set()
                for f in mesh.boundary_facets():
                    f = [int(v) for v in f]
                    for i in range(len(f)):
                        for j in range(i + 1, len(f)):
                            bset.add(tuple(sorted((f[i], f[j]))))
                for e, (a, b) in enumerate(V.edge_vertices):
                    if (int(a), int(b)) in bset:
                        mask[nv + e] = True
            return mask
        # DG dofs are per cell: a dof is on the boundary iff it lies on a
        # boundary facet; only the dofs of cells touching the boundary
        # are candidates
        bcells = mesh.boundary_vertex_mask()[mesh.cells()].any(axis=1)
        cand = np.unique(V.element_dofs[bcells].ravel())
        mask = np.zeros(len(pts), dtype=bool)
        if cand.size:
            mask[cand] = _points_on_facets_mask(mesh, pts[cand])
        return mask
    mask = np.zeros(len(pts), dtype=bool)
    for ax, (lo, hi) in enumerate(mesh.bounds):
        mask |= np.abs(pts[:, ax] - lo) < 1e-12
        mask |= np.abs(pts[:, ax] - hi) < 1e-12
    return mask


def _points_on_facets_mask(mesh, pts: np.ndarray) -> np.ndarray:
    """(len(pts),) bool: the point lies on some boundary facet (within a
    scale-relative tolerance); 2D facets are segments, 3D ones triangles."""
    coords = mesh.coordinates()
    facets = mesh.boundary_facets()
    scale = float(np.max(coords.max(axis=0) - coords.min(axis=0))) or 1.0
    tol = 1e-10 * scale
    mask = np.zeros(len(pts), dtype=bool)
    if mesh.topology_dim() == 2:
        for a, b in facets:
            pa, pb = coords[a], coords[b]
            d = pb - pa
            t = np.clip((pts - pa) @ d / float(d @ d), 0.0, 1.0)
            mask |= np.linalg.norm(pts - (pa + t[:, None] * d), axis=1) < tol
        return mask
    for a, b, c in facets:  # point in triangle through the closest point
        pa = coords[a]
        e1, e2 = coords[b] - pa, coords[c] - pa
        # least-squares (u, v) of p − pa ≈ u e1 + v e2, then the distance to
        # the plane and the barycentric bounds
        G = np.array([[e1 @ e1, e1 @ e2], [e1 @ e2, e2 @ e2]])
        rel = pts - pa
        uv = np.stack([rel @ e1, rel @ e2], axis=1) @ np.linalg.inv(G).T
        proj = pa + uv[:, :1] * e1 + uv[:, 1:] * e2
        dist = np.linalg.norm(pts - proj, axis=1)
        inside = ((uv[:, 0] >= -1e-10) & (uv[:, 1] >= -1e-10)
                  & (uv.sum(axis=1) <= 1 + 1e-10))
        mask |= (dist < tol) & inside
    return mask


class DirichletBC:
    """Dirichlet condition on a scalar or vector space.

    :param V: function space
    :param value: scalar, tuple (one value a component), Expression,
        Constant or callable of x
    :param where: predicate ``f(x)`` or ``f(x, on_boundary)`` on the dof
        coordinates (a scalar x on an interval, a (gdim,) point otherwise);
        None = the whole boundary
    :param component: restrict a vector-space condition to one component
    """

    def __init__(self, V: FunctionSpace, value, where=None, component=None):
        self._V = V
        self.component = component
        pts = V.tabulate_dof_coordinates()
        onb = _on_boundary_mask(V)
        gdim = V.mesh().geometry_dim()
        if where is None:
            mask = onb
        else:
            nargs = len(inspect.signature(where).parameters)
            mask = np.zeros(len(pts), dtype=bool)
            for i, p in enumerate(pts):
                x = p[0] if gdim == 1 else p
                mask[i] = bool(where(x, onb[i]) if nargs >= 2 else where(x))
        sdofs = np.where(mask)[0]
        vs = max(V.value_size, 1)
        # vector dofs interleave the components
        if vs == 1:
            self.dofs = sdofs.astype(np.int64)
        else:
            comps = range(vs) if component is None else [component]
            self.dofs = np.sort(np.concatenate([sdofs * vs + c for c in comps]).astype(np.int64))
        if isinstance(value, Expression) or callable(value):
            vals = np.zeros(len(self.dofs))
            for k, d in enumerate(self.dofs):
                s, c = d // vs, d % vs
                x = pts[s, 0] if gdim == 1 else pts[s]
                v = value(np.asarray([x]))
                v = np.asarray(v).reshape(-1) if np.ndim(v) else np.asarray([v])
                vals[k] = v[c] if (vs > 1 and v.size >= vs) else v[0]
            self.values = vals
        elif isinstance(value, (tuple, list, np.ndarray)):
            vv = np.asarray(value, dtype=np.float64).ravel()
            self.values = np.array([vv[d % vs] for d in self.dofs])
        else:
            self.values = np.full(len(self.dofs), float(value))

    def apply(self, target):
        """Set the constrained entries of a Function, its ``vector()`` view
        or an array (in place)."""
        if isinstance(target, Function):
            target.array[self.dofs] = self.values
            return target
        if isinstance(target, _VectorView):
            target[self.dofs] = self.values
            return target
        target = np.asarray(target)
        target[self.dofs] = self.values
        return target

    def zero(self, target):
        """Zero the constrained entries (the homogenised condition)."""
        if isinstance(target, Function):
            target.array[self.dofs] = 0.0
            return target
        target = np.asarray(target)
        target[self.dofs] = 0.0
        return target

    def apply_system(self, A, b):
        """Symmetric elimination with lifting on a dense or scipy-sparse
        system: returns (A', b') with A'[d,:] = A'[:,d] = 0, A'[d,d] = 1,
        b' = b − A[:,d]·g off the constrained set and b'[d] = g."""
        from scipy import sparse as sps

        d = self.dofs
        g = self.values
        b = np.array(b, dtype=np.float64)
        if sps.issparse(A):
            A = A.tocsr()
            b = b - A[:, d] @ g
            b[d] = g
            mask = np.ones(A.shape[0])
            mask[d] = 0.0
            D = sps.diags(mask)
            A = D @ A @ D + sps.coo_matrix((np.ones(len(d)), (d, d)), shape=A.shape).tocsr()
            return A.tocsr(), b
        A = np.array(A, dtype=np.float64)
        b = b - A[:, d] @ g
        b[d] = g
        A[d, :] = 0.0
        A[:, d] = 0.0
        A[d, d] = 1.0
        return A, b

    def homogenize(self):
        self.values = np.zeros_like(self.values)
        return self


def combine_bcs(bc):
    """Normalise a per-dim bc entry (0 | BC | [BC, ...]) into a list
    (possibly empty)."""
    if bc is None or (isinstance(bc, int) and bc == 0):
        return []
    if isinstance(bc, (list, tuple)):
        return list(bc)
    return [bc]
