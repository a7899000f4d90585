"""Persistence: HDF5 mode checkpoints and pxdmf (ParaView PGD plugin) files
(counterpart of ``pgdrome_tpu/io.py``).

Reference parity: model.py write_hdf5 (model.py:162-181), write_pxdmf
(model.py:198-397), load_pxdmf (model.py:399-575).  The ``<PGDi>_data.h5``
files are the checkpoint (the mesh and the MODE_k dof vectors, enough to
rebuild an evaluable solution); the pxdmf and its per-mesh ``.h5`` files
are the visualisation view (XDMF-style /Mesh/0/mesh/{topology,geometry}
and /VisualisationVector/k vertex data, the ParaView PGD plugin's layout).
The files are the JAX package's, byte layout for byte layout, so either
package reads what the other wrote.

Every function here reads or writes HDF5 and imports ``h5py`` in its body
(the package itself never needs it); without ``h5py`` it raises an
``ImportError`` that names it.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as et

import numpy as np

from pgdrome_tpu_torch.fem.mesh import (
    BoxMesh,
    IntervalMesh,
    Point,
    RectangleMesh,
    SimplicialMesh,
)
from pgdrome_tpu_torch.fem.space import FunctionSpace, VectorFunctionSpace
from pgdrome_tpu_torch.fem.function import Function


def _h5py():
    """The ``h5py`` module, imported on first need."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            "pxdmf and HDF5 files need h5py, which is not installed; a "
            "Vademecum's .npz snapshot (Vademecum.save) needs no h5py"
        ) from e
    return h5py


# ------------------------------------------------------------- checkpoints

def write_hdf5(pgd, folder):
    """One `<PGDi>_data.h5` per coordinate: mesh + MODE_k dof vectors
    (reference model.py:162-181)."""
    h5py = _h5py()
    os.makedirs(folder, exist_ok=True)
    for coord, mesh in enumerate(pgd.mesh):
        filepath = os.path.join(folder, mesh.name + "_data.h5")
        fmesh = mesh.fenics_mesh
        with h5py.File(filepath, "w") as f:
            g = f.create_group("mesh")
            g.create_dataset("coordinates", data=fmesh.coordinates())
            g.create_dataset("cells", data=fmesh.cells())
            g.attrs["tdim"] = fmesh.topology_dim()
            if isinstance(fmesh, RectangleMesh):
                g.attrs["mesh_class"] = "rectangle"
                g.attrs["bounds"] = np.asarray(fmesh.bounds)
                g.attrs["nx"] = fmesh.nx
                g.attrs["ny"] = fmesh.ny
                g.attrs["diagonal"] = fmesh.diagonal
            elif isinstance(fmesh, BoxMesh):
                g.attrs["mesh_class"] = "box"
                g.attrs["bounds"] = np.asarray(fmesh.bounds)
                g.attrs["nx"] = fmesh.nx
                g.attrs["ny"] = fmesh.ny
                g.attrs["nz"] = fmesh.nz
            elif fmesh.topology_dim() == 1:
                g.attrs["mesh_class"] = "interval"
            else:
                # general (unstructured) mesh: coordinates+cells above are
                # the full description — rebuilds as a SimplicialMesh
                g.attrs["mesh_class"] = "simplicial"
            for a, att in enumerate(mesh.attributes):
                f0 = att.interpolationfct[0]
                V = f0.function_space()
                # attribute 0 keeps the reference's root-level layout
                # (model.py:162-181); further attributes are namespaced
                # under ATTR_{a} so multiple fields on one mesh don't
                # collide on the MODE_k dataset names
                dest = f if a == 0 else f.create_group(f"ATTR_{a}")
                dest.attrs["family"] = V.family
                dest.attrs["degree"] = V.degree
                dest.attrs["value_size"] = V.value_size
                for mode in range(pgd.numModes):
                    dest.create_dataset(
                        "MODE_" + str(mode),
                        data=np.asarray(att.interpolationfct[mode].array),
                    )
    pgd.folder = folder


def _rebuild_mesh(g):
    tdim = int(g.attrs["tdim"])
    cls = str(g.attrs.get("mesh_class", ""))
    if tdim == 1:
        return IntervalMesh.from_points(np.asarray(g["coordinates"])[:, 0])
    if cls == "rectangle":
        bounds = np.asarray(g.attrs["bounds"])
        return RectangleMesh(
            Point(bounds[0][0], bounds[1][0]),
            Point(bounds[0][1], bounds[1][1]),
            int(g.attrs["nx"]),
            int(g.attrs["ny"]),
            str(g.attrs["diagonal"]),
        )
    if cls == "box":
        bounds = np.asarray(g.attrs["bounds"])
        return BoxMesh(
            Point(bounds[0][0], bounds[1][0], bounds[2][0]),
            Point(bounds[0][1], bounds[1][1], bounds[2][1]),
            int(g.attrs["nx"]),
            int(g.attrs["ny"]),
            int(g.attrs["nz"]),
        )
    # "simplicial" or legacy/foreign checkpoints without a class tag:
    # coordinates+cells fully describe the mesh (reference parity — dolfin
    # HDF5 mesh reload is exactly this, reference model.py:450-461)
    return SimplicialMesh(np.asarray(g["coordinates"]), np.asarray(g["cells"]))


def read_modes_hdf5(filepath, info=None, attri=0):
    """Rebuild (space, [Function per mode]) from a `_data.h5` checkpoint
    (reference model.py:641-714).  `info` may override family/degree/_type
    like the reference's interpolationInfo dict; ``attri`` selects the
    attribute (0 = root-level MODE_k layout, ≥1 = the ATTR_{a} group)."""
    h5py = _h5py()
    info = info or {}
    with h5py.File(filepath, "r") as f:
        mesh = _rebuild_mesh(f["mesh"])
        src = f if attri == 0 else f[f"ATTR_{attri}"]
        family = info.get("family", str(src.attrs.get("family", "P")))
        degree = int(info.get("degree", src.attrs.get("degree", 1)))
        fs_type = str(info.get("_type", "scalar")).lower()
        vs_stored = int(src.attrs.get("value_size", 1))
        if fs_type == "vector" or vs_stored > 1:
            V = VectorFunctionSpace(mesh, family, degree)
        else:
            V = FunctionSpace(mesh, family, degree)
        fcts = []
        k = 0
        while f"MODE_{k}" in src:
            fcts.append(Function(V, np.asarray(src[f"MODE_{k}"])))
            k += 1
    return V, fcts


# ------------------------------------------------------------ pxdmf / viz

def _write_viz_h5(pgd, folder):
    """Per-coordinate `<PGDi>.h5` with XDMF-style layout."""
    h5py = _h5py()
    for mesh in pgd.mesh:
        filepath = os.path.join(folder, mesh.name + ".h5")
        with h5py.File(filepath, "w") as f:
            topo = np.asarray(mesh.topology, dtype=np.uint64)
            f.create_dataset("Mesh/0/mesh/topology", data=topo)
            if mesh.meshdim >= 2 or np.any(mesh.dataY):
                geom = np.stack([mesh.dataX, mesh.dataY], axis=1)
            else:
                geom = np.stack([mesh.dataX, np.zeros_like(mesh.dataX)], axis=1)
            if mesh.meshdim == 3:
                geom = np.stack([mesh.dataX, mesh.dataY, mesh.dataZ], axis=1)
            f.create_dataset("Mesh/0/mesh/geometry", data=geom)
            for att in mesh.attributes:
                for k, data in enumerate(att.data):
                    f.create_dataset(f"VisualisationVector/{k}", data=data)


def write_pxdmf(pgd, folder):
    """Merged pxdmf XML (reference model.py:198-397), with the same
    vector-padding-to-3D convention when mesh dimensions differ."""
    h5py = _h5py()
    os.makedirs(folder, exist_ok=True)
    _write_viz_h5(pgd, folder)

    dims = np.array([m.info[0] for m in pgd.mesh], dtype=float)
    pad_vectors = dims.max() != dims.min()

    with open(os.path.join(folder, pgd.name + ".pxdmf"), "w") as out:
        out.write(
            '<?xml version="1.0"?><!--pxdmf written by pgdrome_tpu-->\n'
            '<!DOCTYPE Xdmf SYSTEM "Xdmf.dtd" []>\n'
            '<Xdmf Version="3.0" xmlns:xi="http://www.w3.org/2001/XInclude">\n'
        )
        out.write(f'  <Domain Name="{pgd.name}.pxdmf">\n')
        for mesh in pgd.mesh:
            out.write(f'    <Grid Name="{mesh.name}">\n')
            out.write(f'      <Information Name="Dims" Value="{mesh.info[0]}" />\n')
            out.write(f'      <Information Name="Dim0" Value="{mesh.info[1]}" />\n')
            out.write(f'      <Information Name="Unit0" Value="{mesh.info[2]}" />\n')

            with h5py.File(os.path.join(folder, mesh.name + ".h5"), "r") as hf:
                topo_shape = hf["Mesh/0/mesh/topology"].shape
                geom_shape = hf["Mesh/0/mesh/geometry"].shape

            out.write(
                f'        <Topology NumberOfElements = "{mesh.numElements}" '
                f'TopologyType = "{mesh.typElements}" '
                f'NodesPerElement = "{topo_shape[1]}" >\n'
            )
            out.write(
                f'          <DataItem Dimensions = "{topo_shape[0]} {topo_shape[1]}" '
                f'NumberType = "UInt" Format = "HDF">{mesh.name}.h5:'
                f"/Mesh/0/mesh/topology</DataItem>\n        </Topology>\n"
            )
            gtype = "XY" if geom_shape[1] == 2 else "XYZ"
            out.write(f'        <Geometry GeometryType = "{gtype}">\n')
            out.write(
                f'          <DataItem Dimensions = "{geom_shape[0]} {geom_shape[1]}" '
                f'Format = "HDF">{mesh.name}.h5:/Mesh/0/mesh/geometry</DataItem>\n'
                "        </Geometry>\n"
            )

            for att in mesh.attributes:
                for count, data in enumerate(att.data):
                    if att.field.lower() == "vector" and pad_vectors:
                        ext = np.zeros((data.shape[0], 3))
                        if mesh.info[0] > 1:
                            ext[:, : data.shape[1]] = data
                        else:
                            for c in range(3):
                                ext[:, c] = data[:, 0]
                        out.write(
                            f'        <Attribute Name="{att.name}_{count}" '
                            f'AttributeType="{att.field}" Center="Node">\n'
                        )
                        out.write(
                            f'          <DataItem Dimensions="{data.shape[0]} 3" '
                            f'Format="XML" NumberType="float" >\n'
                        )
                        for row in ext:
                            out.write("%.8e %.8e %.8e\n" % (row[0], row[1], row[2]))
                        out.write("          </DataItem>\n        </Attribute>\n")
                    else:
                        out.write(
                            f'        <Attribute Name="{att.name}_{count}" '
                            f'AttributeType="{att.field}" Center="Node">\n'
                        )
                        out.write(
                            f'          <DataItem Dimensions="{data.shape[0]} '
                            f'{data.shape[1]}" Format="HDF">{mesh.name}.h5:'
                            f"/VisualisationVector/{count}</DataItem>\n"
                        )
                        out.write("        </Attribute>\n")
            out.write("    </Grid>\n")
        out.write("  </Domain>\n</Xdmf>")
    pgd.folder = folder


def _attr_base_name(fullname):
    """'Temp_12' → 'Temp': pxdmf attribute names carry a _<mode> suffix."""
    return fullname.rsplit("_", 1)[0]


def _parse_xml_item(text, as_int=False):
    """Whitespace-separated inline XML DataItem body → list of rows."""
    conv = int if as_int else float
    return [
        [conv(tok) for tok in line.split()]
        for line in text.strip().splitlines()
        if line.strip()
    ]


def load_pxdmf(pgd, filepath):
    """Parse a pxdmf file + its h5 data back into a PGD instance
    (reference model.py:399-575)."""
    h5py = _h5py()
    from pgdrome_tpu_torch.model import PGDMesh, PGDAttribute

    folder = os.path.dirname(os.path.abspath(filepath))
    xmlroot = et.parse(filepath).getroot()

    pgd.folder = folder
    pgd.name = xmlroot.findall("Domain")[0].attrib.get("Name")
    pgd.mesh = list()

    for grid in xmlroot.iter("Grid"):
        pm = PGDMesh(grid.get("Name"))
        data_path = os.path.join(folder, pm.name + "_data.h5")
        if os.path.exists(data_path):
            with h5py.File(data_path, "r") as f:
                pm.fenics_mesh = _rebuild_mesh(f["mesh"])
        else:
            pm.fenics_mesh = None

        pm.info = [
            [e.attrib.get("Name"), e.attrib.get("Value")]
            for e in grid.iter("Information")
        ]
        pm.meshdim = int(pm.info[0][1])

        for elems in grid.iter("Topology"):
            pm.numElements = int(elems.attrib.get("NumberOfElements"))
            pm.typElements = elems.attrib.get("TopologyType")
            if elems[0].get("Format") == "XML":
                pm.topology = np.array(_parse_xml_item(elems[0].text, as_int=True))
            else:
                with h5py.File(folder + "/" + elems[0].text.split(":")[0], "r") as hf:
                    pm.topology = np.array(hf.get(elems[0].text.split(":")[1]))

        for elems in grid.iter("Geometry"):
            if elems[0].get("Format") == "XML":
                pm.typGeometry = elems.attrib.get("GeometryType")
                geom = np.array(_parse_xml_item(elems[0].text))
            else:
                with h5py.File(folder + "/" + elems[0].text.split(":")[0], "r") as hf:
                    geom = np.array(hf.get(elems[0].text.split(":")[1]))
            pm.numNodes = geom.shape[0]
            pm.dataX = geom[:, 0]
            pm.dataY = geom[:, 1] if geom.shape[1] >= 2 else np.zeros(pm.numNodes)
            pm.dataZ = geom[:, 2] if geom.shape[1] == 3 else np.zeros(pm.numNodes)

        pm.attributes = list()
        for elems in grid.iter("Attribute"):
            name = _attr_base_name(elems.attrib.get("Name"))
            position = None
            for i, att in enumerate(pm.attributes):
                if att.name == name:
                    position = i
            if elems[0].get("Format") == "XML":
                arr = np.array(_parse_xml_item(elems[0].text))
            else:
                with h5py.File(folder + "/" + elems[0].text.split(":")[0], "r") as hf:
                    arr = np.array(hf.get(elems[0].text.split(":")[1]))
            if position is not None:
                pm.attributes[position].data.append(arr)
            else:
                attr = PGDAttribute()
                attr.name = name
                attr._type = elems.attrib.get("Center")
                attr.field = elems.attrib.get("AttributeType")
                attr.data = [arr]
                pm.attributes.append(attr)
        pgd.mesh.append(pm)

    pgd.numModes = len(pgd.mesh[0].attributes[0].data)
    pgd.used_numModes = pgd.numModes
    return pgd


# ------------------------------------------------- solver-state checkpoints

def save_result(result, filepath):
    """Persist a PGDResult (mode buffers, as host copies of tensors on any
    device, and the convergence trace) — the enrichment-loop resume
    checkpoint the reference lacks."""
    h5py = _h5py()
    with h5py.File(filepath, "w") as f:
        f.attrs["n_modes"] = result.n_modes
        f.attrs["normU0"] = result.normU0
        f.create_dataset("amplitudes", data=np.asarray(result.amplitudes))
        f.create_dataset("alpha", data=np.asarray(result.alpha))
        f.create_dataset("fp_its", data=np.asarray(result.fp_its))
        for d, m in enumerate(result.modes):
            f.create_dataset(f"modes_{d}", data=_host(m))


def _host(a):
    """A tensor (any device) or an array as a host array of its dtype."""
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def load_result(filepath):
    """Load a PGDResult checkpoint saved by :func:`save_result`."""
    h5py = _h5py()
    from pgdrome_tpu_torch.separated import PGDResult

    with h5py.File(filepath, "r") as f:
        modes = []
        d = 0
        while f"modes_{d}" in f:
            modes.append(np.asarray(f[f"modes_{d}"]))
            d += 1
        return PGDResult(
            modes=modes,
            n_modes=int(f.attrs["n_modes"]),
            amplitudes=np.asarray(f["amplitudes"]),
            alpha=np.asarray(f["alpha"]),
            fp_its=np.asarray(f["fp_its"]),
            normU0=float(f.attrs["normU0"]),
        )
