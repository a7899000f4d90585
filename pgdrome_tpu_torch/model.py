"""PGD solution container: evaluation, derivatives, error computation and
persistence (counterpart of ``pgdrome_tpu/model.py``).

Reference parity: pgdrome/model.py (PGD at model.py:25, PGDMesh at
model.py:1573, PGDAttribute at model.py:1456, PGDErrorComputation at
model.py:1666).  The structure follows the pxdmf file format: one PGDMesh
per coordinate, one PGDAttribute per field, the mode data per attribute.

Host numpy in f64, as in the JAX package.  Where the reference evaluates
mode by mode with dolfin point evaluation (model.py:822-842), all modes of
a free dimension are evaluated at a coordinate with one cell locate and one
basis evaluation, and the rank-1 reconstruction is one product
``factors @ stacked``.  :func:`pgd_from_result` brings a
:class:`~pgdrome_tpu_torch.separated.PGDResult` (host arrays or tensors on
any device) into this container.
"""

from __future__ import annotations

import logging
import os

import numpy as np

from pgdrome_tpu_torch.fem.function import Function
from pgdrome_tpu_torch.fem.interpolate import eval_dofs_at_points, check_in_range
from pgdrome_tpu_torch.fem.derivative import derivative_function

LOGGER = logging.getLogger(__name__)


class _Interp1D:
    """Linear/nearest 1D interpolant over nodal data with bounds checking
    (scipy.interp1d parity, reference model.py:614-639)."""

    def __init__(self, x, y, kind="linear"):
        order = np.argsort(x)
        self.x = np.asarray(x, dtype=np.float64)[order]
        self.y = np.asarray(y, dtype=np.float64)[order]
        self.kind = kind
        if kind in ("linear", "nearest"):
            self._spline = None
        else:
            # spline kinds ('quadratic', 'cubic', integer orders, ...):
            # delegate to scipy like the reference (model.py:628-636) —
            # unknown kinds raise there instead of silently degrading
            from scipy.interpolate import interp1d

            self._spline = interp1d(self.x, self.y, kind=kind)

    def __call__(self, xq):
        xq = np.asarray(xq, dtype=np.float64)
        if np.any(xq < self.x[0] - 1e-12) or np.any(xq > self.x[-1] + 1e-12):
            raise ValueError(
                f"A value in x_new is out of the interpolation range "
                f"[{self.x[0]}, {self.x[-1]}]"
            )
        if self._spline is not None:
            return self._spline(np.clip(xq, self.x[0], self.x[-1]))
        if self.kind == "nearest":
            idx = np.clip(np.searchsorted(self.x, xq), 0, len(self.x) - 1)
            return self.y[idx]
        return np.interp(xq, self.x, self.y)


def _eval_stack_at_point(V, stacked, x):
    """Evaluate K dof vectors (rows of `stacked`) of the same scalar space
    at one 1D coordinate: one cell-locate + basis eval, one (K,nl)·(nl,)
    product."""
    from pgdrome_tpu_torch.fem.interpolate import _locate_1d, _shape_1d_x

    cell, xi = _locate_1d(V.mesh(), np.asarray(x), np)
    basis = _shape_1d_x(V.degree, xi, np)  # (nl,)
    local = V.element_dofs[int(cell)]  # (nl,)
    return stacked[:, local] @ basis


class PGDAttribute(object):
    """Per-(mesh, field) mode store (reference model.py:1456-1570)."""

    def __init__(self, num_modes=0, mesh=None, pgd_modes=None, modes_info=None):
        self.logger = logging.getLogger(__name__ + "." + self.__class__.__name__)
        if modes_info is not None:
            self.name = modes_info[0]
            self._type = modes_info[1]  # 'Node' or 'Cell'
            self.field = modes_info[2]  # 'Scalar' or 'Vector'
        self.data = list()
        self.interpolationInfo = {"name": 1}
        self.interpolationfct = list()
        self.derivationfct = list()
        for ctr in range(num_modes):
            self.interpolationfct.append(pgd_modes[ctr])
        if num_modes:
            self.fill_data(num_modes, mesh, pgd_modes)

    def fill_data(self, num_modes, mesh, pgd_modes):
        """Extract nodal (vertex) values per mode.

        Note: fixes the reference's latent vector-branch bug
        (model.py:1529 `self.field.lower == "vector"` missing call)."""
        self.data = list()
        for ctr in range(num_modes):
            if self._type.lower() == "node":
                mode = np.zeros((mesh.numNodes, mesh.meshdim))
            elif self._type.lower() == "cell":
                mode = np.zeros((mesh.numElements, mesh.meshdim))
            else:
                raise ValueError("Error in filling attribute data: _type unknown")

            vv = pgd_modes[ctr].compute_vertex_values()
            if self.field.lower() == "scalar" and self._type.lower() == "node":
                mode[:, 0] = vv
            elif self.field.lower() == "vector":
                if self._type.lower() != "node":
                    raise ValueError("CELL VALUES NOT IMPLEMENTED YET!!")
                nn = mesh.numNodes
                for c in range(mesh.meshdim):
                    mode[:, c] = vv[c * nn : (c + 1) * nn]
            self.data.append(mode)
        return self

    def print_info(self):
        print("\nsummary of PGDAttribute class")
        print("----------------------------")
        print("name:                        ", self.name)
        print("type:                        ", self._type)
        print("field type:                  ", self.field)
        print("len of data:                 ", len(self.data))
        print("interpolationInfo:           ", self.interpolationInfo)
        print("len of interpolation fct     ", len(self.interpolationfct))


class PGDMesh(object):
    """Mesh wrapper for save/load (reference model.py:1573-1663)."""

    def __init__(
        self,
        name=None,
        mesh=None,
        name_coord=None,
        pgd_modes=None,
        num_modes=0,
        modes_info=None,
    ):
        self.logger = logging.getLogger(__name__ + "." + self.__class__.__name__)
        self.name = name
        self.meshdim = mesh.topology_dim() if mesh is not None and mesh != 0 else 0
        self.info = [self.meshdim, name_coord, "-?-"]
        self.numElements = mesh.num_cells() if mesh is not None and mesh != 0 else None
        self.numNodes = mesh.num_vertices() if mesh is not None and mesh != 0 else 0
        self.topology = mesh.cells() if mesh is not None and mesh != 0 else None
        self.typGeometry = "XYZ"
        self.dataX = np.zeros(self.numNodes)
        self.dataY = np.zeros(self.numNodes)
        self.dataZ = np.zeros(self.numNodes)
        self.fenics_mesh = mesh if mesh != 0 else None  # name kept for parity

        if self.meshdim == 1:
            self.dataX = mesh.coordinates()[:, 0]
            self.typElements = "Polyline"
        elif self.meshdim == 2:
            xy = mesh.coordinates()
            self.dataX = xy[:, 0]
            self.dataY = xy[:, 1]
            self.typElements = "Triangle"
        elif self.meshdim == 3:
            xyz = mesh.coordinates()
            self.dataX = xyz[:, 0]
            self.dataY = xyz[:, 1]
            self.dataZ = xyz[:, 2]
            self.typElements = "Tetrahedron"

        self.attributes = list()
        if num_modes:
            att = PGDAttribute(num_modes, self, pgd_modes, modes_info=modes_info)
            self.attributes.append(att)

    @property
    def mesh(self):
        return self.fenics_mesh

    def print_info(self):
        print("\nsummary of PGDMesh class")
        print("----------------------------")
        print("name:                            ", self.name)
        print("info:                            ", self.info)
        print("number of Elements:              ", self.numElements)
        print("number of Nodes:                 ", self.numNodes)
        print("type of Elements:                ", self.typElements)


class PGD:
    """Whole PGD solution: meshes + modes, evaluation and persistence
    (reference model.py:25-1453)."""

    def __init__(
        self,
        name=None,
        n_modes=None,
        fmeshes=[],
        pgd_modes=None,
        name_coord=None,
        modes_info=None,
        verbose=False,
        problem=None,
        spaces=None,
        *args,
        **kwargs,
    ):
        self.logger = logging.getLogger(__name__)
        self.name = name
        self.folder = ""
        self.numModes = n_modes
        self.used_numModes = n_modes
        self.mesh = list()
        self.name_coord = name_coord
        self.modes_info = modes_info
        self.spaces = spaces  # function spaces per coordinate (an extension)

        for ctr, mesh in enumerate(fmeshes):
            _name = "PGD" + str(ctr + 1)
            grid = PGDMesh(
                _name,
                mesh,
                self.name_coord[ctr],
                pgd_modes[ctr],
                self.numModes,
                modes_info=self.modes_info,
            )
            self.mesh.append(grid)
            if verbose:
                for att in grid.attributes:
                    att.print_info()
                grid.print_info()
        self.problem = problem
        self.pos = 0
        self._eval_fixed_modes = {}
        self._stacked_cache = {}

    def __str__(self):
        return "PGD(name: %s)(meshes: %s)(modes: %s)" % (
            self.name,
            len(self.mesh),
            self.numModes,
        )

    __repr__ = __str__

    # --------------------------------------------------------------- props
    @property
    def num_pgd_var(self):
        return len(self.mesh)

    @property
    def fenics_meshes(self):
        return [m.fenics_mesh for m in self.mesh]

    def _info_str(self):
        info = "summary of PGDModel class\n-------------------------------\n"
        info += "name:                          %s\n" % self.name
        info += "number of PGD variables:       %s\n" % self.num_pgd_var
        info += "number of modes for each mesh -- max: %s -- used: %s\n" % (
            self.numModes,
            self.used_numModes,
        )
        info += "number of saved meshes:        %s\n" % len(self.mesh)
        info += "folder:                        %s" % self.folder
        return info

    def print_info(self):
        print("\n" + self._info_str() + "\n")

    def create_from_problem(self, problem=None):
        self.problem = problem
        self.name = problem.name
        return self

    # -------------------------------------------------------- interpolation
    def create_interpolation_fcts(self, free_dim, attri, verbose=False):
        """Build per-mode interpolants for the free dims
        (reference model.py:589-722): info name==0 → linear interpolation of
        nodal data; name==1 → FE Functions (from the solve, or reloaded from
        the `_data.h5` checkpoint)."""
        if len(free_dim) > self.num_pgd_var:
            raise ValueError(
                "given number of Dimensions larger then existing Meshes in PGD solution"
            )
        if attri > len(self.mesh[free_dim[0]].attributes):
            raise ValueError("attribute number not possible")

        for i in range(len(free_dim)):
            att = self.mesh[free_dim[i]].attributes[attri]
            info = att.interpolationInfo

            if info["name"] == 0:
                if (
                    np.sum(self.mesh[free_dim[i]].dataY) != 0
                    and np.sum(self.mesh[free_dim[i]].dataZ) != 0
                ):
                    raise ValueError(
                        "free Dimensions are not 1D, interpolation with "
                        "INTERP1D not possible"
                    )
                att.interpolationfct = list()
                kind = info.get("kind", "linear")
                for k in range(self.numModes):
                    att.interpolationfct.append(
                        _Interp1D(
                            self.mesh[free_dim[i]].dataX, att.data[k][:, 0], kind
                        )
                    )
            elif info["name"] == 1:
                if len(att.interpolationfct) == self.numModes and isinstance(
                    att.interpolationfct[0], Function
                ):
                    continue  # already populated from the solve
                # reload from checkpoint
                from pgdrome_tpu_torch import io as pgd_io

                filepath = os.path.join(
                    self.folder, self.mesh[free_dim[i]].name + "_data.h5"
                )
                V, fcts = pgd_io.read_modes_hdf5(filepath, info, attri=attri)
                att.interpolationfct = fcts
                self.mesh[free_dim[i]].fenics_mesh = V.mesh()
            else:
                raise ValueError(f"interpolation name not defined: {info['name']}")

    def _free_factors(self, free_dim, coord, attri, d_dim=None):
        """Per-mode product of free-dim interpolants at `coord`
        (vectorized over the mode axis). d_dim selects derivative fcts."""
        K = self.used_numModes
        tmp = np.ones(K)
        for i in range(len(free_dim)):
            att = self.mesh[free_dim[i]].attributes[attri]
            fcts = (
                att.derivationfct if (d_dim is not None and free_dim[i] == d_dim)
                else att.interpolationfct
            )
            f0 = fcts[0]
            if isinstance(f0, Function):
                V = f0.function_space()
                check_in_range(V, np.asarray([coord[i]]))
                # evaluate ALL modes at the one coordinate with a single
                # shared basis evaluation (the BASELINE.json "one einsum"
                # path): basis φ(coord) is mode-independent, so the K mode
                # values are one (K, nl) gather · (nl,) dot
                stacked = np.stack([fcts[k].array for k in range(K)])  # (K, nd)
                vals = _eval_stack_at_point(V, stacked, float(coord[i]))
                tmp = tmp * vals
            else:
                tmp_i = np.array([float(fcts[k](coord[i])) for k in range(K)])
                tmp = tmp * tmp_i
        return tmp

    # ------------------------------------------------------------ evaluate
    def evaluate(self, fixed_dim, free_dim, coord, attri):
        """Rank-1 reconstruction over the fixed dim for given coordinates
        (reference model.py:724-860).  Returns a Function (FE path) or an
        ndarray (interp1d path).  NOTE: like the reference, this evaluates
        the homogenized solution — BC/IC lifts are added externally by the
        caller (test_laplace.py:986-1010)."""
        if len(free_dim) != self.num_pgd_var - 1:
            raise ValueError(
                f"given variables are missing or too much, free_dim={free_dim} "
                f"<-> num_pgd_var-1={self.num_pgd_var - 1}"
            )
        if len(coord) != self.num_pgd_var - 1:
            raise ValueError(
                f"given variables are missing or too much, coord={coord}"
            )
        if len(free_dim) != len(coord):
            raise ValueError("free_dim and coord lengths differ")
        if attri >= len(self.mesh[fixed_dim].attributes):
            raise ValueError("attribute number not possible")

        for idx in free_dim:
            if len(self.mesh[idx].attributes[attri].interpolationfct) == 0:
                self.create_interpolation_fcts(free_dim, attri)
                break

        factors = self._free_factors(free_dim, coord, attri)  # (K,)

        att_fixed = self.mesh[fixed_dim].attributes[attri]
        if self.mesh[free_dim[0]].attributes[attri].interpolationInfo["name"] == 0:
            # nodal-data path → ndarray like data[0]
            data = np.stack(
                [att_fixed.data[k] for k in range(self.used_numModes)]
            )  # (K, n, m)
            return np.einsum("k,knm->nm", factors, data)

        # FE path → Function on the fixed-dim space
        fixed0 = att_fixed.interpolationfct[0]
        V = fixed0.function_space()
        stacked = np.stack(
            [att_fixed.interpolationfct[k].array for k in range(self.used_numModes)]
        )  # (K, ndof)
        return Function(V, factors @ stacked)

    def eval_fixed_modes(self, sensor_points, fixed_dim, attri,
                         derivative=False):
        """All fixed-dim modes evaluated at sensor points, cached
        (reference model.py:107-130; fenicstools.Probes → one batched point
        evaluation per mode).

        ``derivative=True`` evaluates the DG derivative modes
        (derivationfct) instead — the fixed-dim-derivative sensor path.

        Returns (npoints, numModes) for scalar fields, (npoints, vs,
        numModes) for vector fields."""
        sensor_points = np.asarray(sensor_points, dtype=np.float64)
        # collision-free cache key (the reference hashes by sum(points),
        # model.py:116, which collides for permuted / sum-equal point sets;
        # deliberately fixed here)
        key = (
            sensor_points.tobytes(), sensor_points.shape, fixed_dim, attri,
            derivative,
        )
        if key in self._eval_fixed_modes:
            return self._eval_fixed_modes[key]

        att = self.mesh[fixed_dim].attributes[attri]
        if derivative and len(att.derivationfct) == 0:
            # lazily create like evaluate_derivative does (the
            # interpolation path never hits this: interpolationfct always
            # exists by construction)
            self.create_derivation_fct([fixed_dim], attri)
        fcts = att.derivationfct if derivative else att.interpolationfct
        f0 = fcts[0]
        V = f0.function_space()
        gdim = V.mesh().geometry_dim()
        pts = sensor_points.reshape(-1) if gdim == 1 else sensor_points.reshape(-1, gdim)
        out = np.stack(
            [
                np.asarray(eval_dofs_at_points(V, fcts[k].array, pts))
                for k in range(self.numModes)
            ],
            axis=-1,
        )  # (np, K) or (np, vs, K)
        if self.numModes == 1:
            out = out[..., 0]
        self._eval_fixed_modes[key] = out
        return out

    def evaluate_sensor_response(self, fixed_dim, free_dim, coord, attri, sensor_points):
        """Reconstruction at arbitrary fixed-dim sensor points
        (reference model.py:862-953)."""
        if len(coord) != self.num_pgd_var - 1:
            raise ValueError("given variables are missing or too much")
        for i in range(len(free_dim)):
            if (
                np.sum(self.mesh[free_dim[i]].dataY) != 0
                and np.sum(self.mesh[free_dim[i]].dataZ) != 0
            ):
                raise ValueError("free Dimensions are not 1D")
        if attri >= len(self.mesh[fixed_dim].attributes):
            raise ValueError("attribute number not possible")
        for idx in free_dim:
            if len(self.mesh[idx].attributes[attri].interpolationfct) == 0:
                self.create_interpolation_fcts(free_dim, attri)
                break

        eval_fixedmode = self.eval_fixed_modes(sensor_points, fixed_dim, attri)
        tmp = self._free_factors(free_dim, coord, attri)

        if self.numModes == 1:
            return eval_fixedmode * tmp[0]
        return np.sum(eval_fixedmode[..., 0 : self.used_numModes] * tmp, axis=-1)

    # ---------------------------------------------------------- reductions
    def _as_values(self, result, free_dim, attri):
        if self.mesh[free_dim[0]].attributes[attri].interpolationInfo["name"] == 0:
            return np.asarray(result)
        return np.asarray(result.array)

    def evaluate_min(self, fixed_dim, free_dim, coord, attri, *args, **kwargs):
        return float(
            self._as_values(
                self.evaluate(fixed_dim, free_dim, coord, attri), free_dim, attri
            ).min()
        )

    def evaluate_min_abs(self, fixed_dim, free_dim, coord, attri, *args, **kwargs):
        return float(
            np.abs(
                self._as_values(
                    self.evaluate(fixed_dim, free_dim, coord, attri), free_dim, attri
                )
            ).min()
        )

    def evaluate_max(self, fixed_dim, free_dim, coord, attri, *args, **kwargs):
        return float(
            self._as_values(
                self.evaluate(fixed_dim, free_dim, coord, attri), free_dim, attri
            ).max()
        )

    def evaluate_max_abs(self, fixed_dim, free_dim, coord, attri, *args, **kwargs):
        return float(
            np.abs(
                self._as_values(
                    self.evaluate(fixed_dim, free_dim, coord, attri), free_dim, attri
                )
            ).max()
        )

    def evaluate_max_norm(self, fixed_dim, free_dim, coord, attri, *args, **kwargs):
        """Max pointwise vector norm (reference model.py:1033-1069)."""
        new = self.evaluate(fixed_dim, free_dim, coord, attri)
        if self.mesh[free_dim[0]].attributes[attri].interpolationInfo["name"] == 0:
            arr = np.asarray(new)
            return float(np.max(np.linalg.norm(arr, axis=1)))
        V = new.function_space()
        if V.mesh().geometry_dim() == 1 and V.value_size <= 1:
            raise ValueError("Function is 1D use evaluate_max instead!!")
        arr = np.asarray(new.array).reshape(-1, V.value_size)
        return float(np.max(np.linalg.norm(arr, axis=1)))

    def evaluate_abs_value(self, fixed_dim, free_dim, coord, attri, *args, **kwargs):
        new = self.evaluate(fixed_dim, free_dim, coord, attri)
        return np.abs(np.asarray(new(self.pos))).max()

    # ----------------------------------------------------------- derivative
    def create_derivation_fct(self, free_dim, attri, direction=0):
        """Derivative interpolants on DG(degree-1)
        (reference model.py:1088-1206).  ``direction``: spatial
        component for multi-D SCALAR dims (the reference hardcodes
        ``f.dx(0)``; vector dims always build the full ∇ tensor and
        ignore it)."""
        if len(free_dim) > self.num_pgd_var:
            raise ValueError("too many dimensions")
        if attri > len(self.mesh[free_dim[0]].attributes):
            raise ValueError("attribute number not possible")
        for i in range(len(free_dim)):
            att = self.mesh[free_dim[i]].attributes[attri]
            if att.interpolationInfo["name"] == 0:
                raise ValueError(
                    "derivation for interp1 functions not implemented "
                    "(only FE functions)"
                )
            att.derivationfct = list()
            for k in range(self.numModes):
                att.derivationfct.append(
                    derivative_function(att.interpolationfct[k],
                                        direction=direction)
                )
            # rebuilt derivatives invalidate any cached fixed-mode
            # derivative tables (e.g. a direction switch must not serve
            # stale sensor responses)
            self._eval_fixed_modes = {
                key: v for key, v in self._eval_fixed_modes.items()
                if not (key[2] == free_dim[i] and key[3] == attri
                        and key[4])
            }

    def evaluate_derivative(self, fixed_dim, free_dim, coord, attri, d_dim):
        """Reconstruction with the d_dim factor replaced by its derivative
        (reference model.py:1208-1303).

        ``d_dim == fixed_dim`` derives the FIXED dimension (2D: spatial
        derivative/strain fields) — the reference raises "not possible in
        the moment" there (model.py:1232); implemented here: returns a
        Function on the DG derivative space, with the reference's
        create_derivation_fct semantics (model.py:1124-1173): scalar
        fields → the DG ∂/∂x0 field (``f.dx(0)``; use
        :meth:`create_derivation_fct` with another direction, or
        serving's ``gradient()``, for other components), vector fields →
        the row-major ∇u tensor (the ``grad`` branch)."""
        if len(coord) != self.num_pgd_var - 1:
            raise ValueError("given variables are missing or too much")
        if attri >= len(self.mesh[fixed_dim].attributes):
            raise ValueError("attribute number not possible")
        if self.mesh[free_dim[0]].attributes[attri].interpolationInfo["name"] == 0:
            raise ValueError(
                "derivation for interp1 functions not implemented (only FE functions)"
            )
        for idx in free_dim:
            if len(self.mesh[idx].attributes[attri].interpolationfct) == 0:
                self.create_interpolation_fcts(free_dim, attri)

        if fixed_dim == d_dim:
            att_fixed = self.mesh[fixed_dim].attributes[attri]
            if len(att_fixed.derivationfct) == 0:
                self.create_derivation_fct([fixed_dim], attri)
            factors = self._free_factors(free_dim, coord, attri)
            Vd = att_fixed.derivationfct[0].function_space()
            stacked = np.stack(
                [
                    att_fixed.derivationfct[k].array
                    for k in range(self.used_numModes)
                ]
            )
            return Function(Vd, factors @ stacked)

        if len(self.mesh[d_dim].attributes[attri].derivationfct) == 0:
            self.create_derivation_fct(free_dim, attri)

        factors = self._free_factors(free_dim, coord, attri, d_dim=d_dim)
        att_fixed = self.mesh[fixed_dim].attributes[attri]
        V = att_fixed.interpolationfct[0].function_space()
        stacked = np.stack(
            [att_fixed.interpolationfct[k].array for k in range(self.used_numModes)]
        )
        return Function(V, factors @ stacked)

    def evaluate_derivative_sensor_response(
        self, fixed_dim, free_dim, coord, attri, d_dim, sensor_points
    ):
        """(reference model.py:1305-1412).  ``d_dim == fixed_dim`` (beyond
        the reference) samples the fixed dim's DG derivative modes at the
        sensor points."""
        if len(coord) != self.num_pgd_var - 1:
            raise ValueError("given variables are missing or too much")
        for idx in free_dim:
            if len(self.mesh[idx].attributes[attri].interpolationfct) == 0:
                self.create_interpolation_fcts(free_dim, attri)

        if fixed_dim == d_dim:
            att_fixed = self.mesh[fixed_dim].attributes[attri]
            if len(att_fixed.derivationfct) == 0:
                self.create_derivation_fct([fixed_dim], attri)
            eval_fixedmode = self.eval_fixed_modes(
                sensor_points, fixed_dim, attri, derivative=True
            )
            tmp = self._free_factors(free_dim, coord, attri)
            if self.numModes == 1:
                return eval_fixedmode * tmp[0]
            return np.sum(
                eval_fixedmode[..., 0 : self.used_numModes] * tmp, axis=-1
            )

        if len(self.mesh[d_dim].attributes[attri].derivationfct) == 0:
            self.create_derivation_fct(free_dim, attri)

        eval_fixedmode = self.eval_fixed_modes(sensor_points, fixed_dim, attri)
        tmp = self._free_factors(free_dim, coord, attri, d_dim=d_dim)
        if self.numModes == 1:
            return eval_fixedmode * tmp[0]
        return np.sum(eval_fixedmode[..., 0 : self.used_numModes] * tmp, axis=-1)

    def reconstruct_tensor(self, attri: int = 0):
        """Full-tensor reconstruction on all nodal grids:
        T[i1..id] = Σ_k Π_d data_d[k][i_d].

        The reference's class docstring advertises this method
        (model.py:35) but never implements it; provided here as an
        extension.  Scalar attributes only; mind the memory (product of
        grid sizes)."""
        d = self.num_pgd_var
        if d > 6:
            raise ValueError("tensor reconstruction limited to 6 dims")
        letters = "abcdef"[:d]
        expr = ",".join("k" + c for c in letters) + "->" + letters
        stacks = []
        for dim in range(d):
            att = self.mesh[dim].attributes[attri]
            if not att.data:
                raise ValueError("attribute has no nodal data")
            stacks.append(
                np.stack([att.data[k][:, 0] for k in range(self.used_numModes)])
            )
        return np.einsum(expr, *stacks, optimize=True)

    # ------------------------------------------------------------------ I/O
    def write_hdf5(self, folder):
        from pgdrome_tpu_torch import io as pgd_io

        pgd_io.write_hdf5(self, folder)

    def write_pxdmf(self, folder, xdmf_exist=False):
        from pgdrome_tpu_torch import io as pgd_io

        pgd_io.write_pxdmf(self, folder)

    def load_pxdmf(self, filepath, verbose=False):
        from pgdrome_tpu_torch import io as pgd_io

        pgd_io.load_pxdmf(self, filepath)
        if verbose:
            self.print_info()
        return self

    def save_modes_latex(self, folder, attri, prefix="_"):
        """1D mode table export for latex plotting
        (reference model.py:1414-1453)."""
        name = "modes_%s_%i_%s.out"
        for k in range(self.num_pgd_var):
            if self.mesh[k].typElements.lower() != "polyline":
                continue
            f0 = self.mesh[k].attributes[attri].interpolationfct[0]
            V = f0.function_space()
            dof_coord = V.tabulate_dof_coordinates()[:, 0]
            order = np.argsort(dof_coord)
            out_k = np.zeros((len(dof_coord), self.numModes + 1))
            out_k[:, 0] = dof_coord[order]
            for m in range(self.numModes):
                arr = np.asarray(self.mesh[k].attributes[attri].interpolationfct[m].array)
                out_k[:, m + 1] = arr[order]
            np.savetxt(
                os.path.join(folder, name % (prefix, attri, self.mesh[k].info[1])),
                out_k,
                delimiter=",",
            )


class PGDErrorComputation(object):
    """Sampling-based error vs a full-order model
    (reference model.py:1666-1825): Latin-Hypercube samples with the same
    seed 3452 for reproducibility parity, relative L2 errors, optional
    point-restricted comparison."""

    def __init__(
        self,
        fixed_dim=0,
        n_samples=1,
        data_test=[],
        FOM_model=[],
        PGD_model=[],
        lim_samples=[],
        fixed_var=[],
        *args,
        **kwargs,
    ):
        self.fixed_dim = fixed_dim
        self.n_smp = n_samples
        self.data_test = data_test
        self.FOM_sol = FOM_model
        self.PGD_sol = PGD_model
        self.lim_smp = lim_samples
        self.fixed_var = fixed_var
        self.free_dim = [
            item
            for item in list(range(0, self.PGD_sol.num_pgd_var))
            if item not in fixed_dim
        ]

    def sampling_LHS(self):
        from scipy.stats import qmc

        sampler = qmc.LatinHypercube(d=len(self.free_dim), seed=3452)
        sample = sampler.random(n=self.n_smp)

        min_bnd = [None] * len(self.free_dim)
        max_bnd = [None] * len(self.free_dim)
        ind = 0
        if not self.lim_smp:
            for i in self.free_dim:
                coords = self.PGD_sol.problem.meshes[i].coordinates()
                if coords.shape[1] == 1:
                    min_bnd[ind] = float(coords.min())
                    max_bnd[ind] = float(coords.max())
                    ind += 1
                else:
                    print("Not implemented")
        else:
            for i in self.free_dim:
                if len(self.lim_smp[i]) == 2:
                    min_bnd[ind] = float(min(self.lim_smp[i]))
                    max_bnd[ind] = float(max(self.lim_smp[i]))
                    ind += 1
                else:
                    print("Not implemented")

        data_test = qmc.scale(sample, min_bnd, max_bnd)
        return data_test.tolist()

    def compute_SampleError(self, u_FOM, u_PGD):
        u_FOM_arr = (
            np.asarray(u_FOM) if not isinstance(u_FOM, Function) else None
        )
        if not isinstance(u_FOM, Function) and not isinstance(u_PGD, Function):
            residual = np.asarray(u_PGD).reshape(-1) - u_FOM_arr.reshape(-1)
            return np.linalg.norm(residual, 2) / np.linalg.norm(
                u_FOM_arr.reshape(-1), 2
            )
        if not isinstance(u_FOM, Function) and isinstance(u_PGD, Function):
            residual = u_PGD.compute_vertex_values() - u_FOM_arr.reshape(-1)
            return np.linalg.norm(residual, 2) / np.linalg.norm(
                u_FOM_arr.reshape(-1), 2
            )
        diff = np.asarray(u_FOM.array) - np.asarray(u_PGD.array)
        return np.linalg.norm(diff, 2) / np.linalg.norm(np.asarray(u_FOM.array), 2)

    def evaluate_error(self):
        if not self.data_test:
            self.data_test = self.sampling_LHS()

        errorL2 = np.zeros(len(self.data_test))
        for i in range(len(self.data_test)):
            if self.FOM_sol:
                u_fem = self.FOM_sol(self.data_test[i])
                if isinstance(u_fem, float):
                    u_fem = np.array(u_fem)
            else:
                raise ValueError("FEM not defined")

            if self.PGD_sol:
                u_pgd = self.PGD_sol.evaluate(
                    int(self.fixed_dim[0]), self.free_dim, self.data_test[i], 0
                )
            else:
                raise ValueError("PGD model not defined")

            if not self.fixed_var:
                errorL2[i] = self.compute_SampleError(u_fem, u_pgd)
            else:
                u_pgdPoint = np.array([u_pgd(item) for item in self.fixed_var])
                errorL2[i] = self.compute_SampleError(u_fem, u_pgdPoint)

        return errorL2, np.mean(errorL2), np.max(errorL2)


def pgd_from_result(result, spaces, name="pgd", name_coord=None,
                    modes_info=None, dim0_transform=None):
    """Bring a :class:`~pgdrome_tpu_torch.separated.PGDResult` (modes as host
    arrays or as tensors on any device, in any float dtype) into the
    reference-style :class:`PGD` container, with the whole model layer:
    evaluate, reducers, derivatives, sensor responses, pxdmf/HDF5
    persistence and :class:`PGDErrorComputation`.  The modes are taken to
    host f64.

    dim0_transform: the Dim0Transform from precondition_dim0 when the solve
    ran in the energy basis (maps the transformed modes back to full dofs).
    """
    from pgdrome_tpu_torch.separated import host_f64

    nd = len(spaces)
    name_coord = name_coord or [f"D{i}" for i in range(nd)]
    modes_info = modes_info or ["U", "Node", "Scalar"]
    K = result.n_modes

    mode_fns = []
    for d in range(nd):
        arrs = host_f64(result.modes[d])[:K]
        if d == 0 and dim0_transform is not None:
            arrs = dim0_transform.modes_to_full(arrs)
        mode_fns.append([Function(spaces[d], arrs[k]) for k in range(K)])

    return PGD(
        name=name,
        n_modes=K,
        fmeshes=[V.mesh() for V in spaces],
        pgd_modes=mode_fns,
        name_coord=name_coord,
        modes_info=modes_info,
        spaces=list(spaces),
    )
