"""The port's persistence (``io.py``: the ``_data.h5`` checkpoints, the
pxdmf view, ``load_pxdmf``, ``save_result`` / ``load_result``) against the
JAX package's, on the CPU: the twins of ``tests/unit/test_io_roundtrip.py``
run in both packages, every file written by one package read back by the
other (the bytes of the pxdmf XML equal), both foreign pxdmf fixtures and
the unstructured checkpoint fixture read by the port as by the JAX package,
and the ``ImportError`` that names ``h5py`` when it is missing.
"""

import os
import sys

import numpy as np
import pytest

from tests.test_torch_reference_solver import JAXP, PORT, close

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def build_pgd(P):
    """u(x, p, E) = x²·p·(1/E) from FE functions (test_io_roundtrip.py)."""
    mesh_x = P.IntervalMesh(50, 0.0, 1.0)
    mesh_p = P.IntervalMesh(10, 0.0, 2.0)
    mesh_E = P.IntervalMesh(10, 0.5, 1.0)
    V_x, V_p = P.FunctionSpace(mesh_x, "CG", 1), P.FunctionSpace(mesh_p, "CG", 1)
    V_E = P.FunctionSpace(mesh_E, "CG", 2)
    modes = [[P.interpolate(lambda x: x * x, V_x)], [P.interpolate(lambda p: p, V_p)],
             [P.interpolate(lambda E: 1.0 / E, V_E)]]
    return P.PGD(name="Test", n_modes=1, fmeshes=[mesh_x, mesh_p, mesh_E], pgd_modes=modes,
                 name_coord=["X", "P", "E"], modes_info=["U_x", "Node", "Scalar"],
                 verbose=False)


INFO = [{"name": 1, "family": "CG", "degree": d, "_type": "scalar"} for d in (1, 1, 2)]


def _reload(P, folder):
    """load_pxdmf + the interpolants rebuilt from the ``_data.h5``
    checkpoints, in package ``P``."""
    pgd = P.PGD().load_pxdmf(os.path.join(folder, "Test.pxdmf"))
    for m, info in zip(pgd.mesh, INFO):
        m.attributes[0].interpolationInfo = dict(info)
    pgd.create_interpolation_fcts([0, 1, 2], 0)
    return pgd


@pytest.mark.parametrize("writer,reader", [(PORT, PORT), (PORT, JAXP), (JAXP, PORT)],
                         ids=["port-port", "port-jax", "jax-port"])
def test_write_load_evaluate(tmp_path, writer, reader):
    """Written by ``writer`` (pxdmf + checkpoints), loaded by ``reader``:
    the mode interpolants and the evaluation, equal across packages and
    to the exact function."""
    src = build_pgd(writer)
    src.write_pxdmf(str(tmp_path), False)
    src.write_hdf5(str(tmp_path))
    got = _reload(reader, str(tmp_path))
    fcts = [m.attributes[0].interpolationfct[0] for m in got.mesh]
    np.testing.assert_allclose([fcts[0](0.8), fcts[1](0.8), fcts[2](0.8)],
                               [0.64, 0.8, 1.25], rtol=1e-3)
    u = got.evaluate(0, [1, 2], [0.75, 0.75], 0)
    ref = build_pgd(PORT).evaluate(0, [1, 2], [0.75, 0.75], 0)
    close(u.array, ref.array)
    assert abs(u(0.5) - 0.25 * 0.75 / 0.75) < 1e-2


def test_pxdmf_files_equal(tmp_path):
    """The pxdmf XML of both packages is byte for byte the same, and the
    viz and checkpoint ``.h5`` hold the same datasets."""
    import h5py

    dirs = {}
    for P in (PORT, JAXP):
        d = tmp_path / P.root
        pgd = build_pgd(P)
        pgd.write_pxdmf(str(d))
        pgd.write_hdf5(str(d))
        dirs[P.root] = d
    t, j = dirs["pgdrome_tpu_torch"], dirs["pgdrome_tpu"]
    assert (t / "Test.pxdmf").read_bytes() == (j / "Test.pxdmf").read_bytes()
    for name in ("PGD1.h5", "PGD2_data.h5", "PGD3_data.h5"):
        with h5py.File(t / name, "r") as ft, h5py.File(j / name, "r") as fj:
            keys, jkeys = [], []
            ft.visit(keys.append)
            fj.visit(jkeys.append)
            assert keys == jkeys
            for obj_t, obj_j in [(ft, fj)] + [(ft[k], fj[k]) for k in keys]:
                assert sorted(obj_t.attrs) == sorted(obj_j.attrs)
                for a in obj_t.attrs:
                    np.testing.assert_array_equal(obj_t.attrs[a], obj_j.attrs[a])
                if isinstance(obj_t, h5py.Dataset):
                    np.testing.assert_array_equal(obj_t[()], obj_j[()])


def test_data_h5_checkpoint(tmp_path):
    build_pgd(PORT).write_hdf5(str(tmp_path))
    for P in (PORT, JAXP):
        V, fcts = P.io.read_modes_hdf5(str(tmp_path / "PGD1_data.h5"))
        assert len(fcts) == 1 and abs(fcts[0](0.3) - 0.09) < 1e-3


def test_two_attributes_roundtrip(tmp_path):
    """Two fields on one mesh: attribute 0 at the root, attribute 1 under
    ATTR_1 — written by the port, read by both."""
    P = PORT
    V_x = P.FunctionSpace(P.IntervalMesh(20, 0.0, 1.0), "CG", 1)
    modes = [[P.interpolate(lambda x: x, V_x)], [P.interpolate(lambda x: x, V_x)]]
    pgd = P.PGD(name="Two", n_modes=1, fmeshes=[V_x.mesh(), V_x.mesh()], pgd_modes=modes,
                name_coord=["X", "P"], modes_info=["U", "Node", "Scalar"])
    from pgdrome_tpu_torch.model import PGDAttribute

    pgd.mesh[0].attributes.append(PGDAttribute(
        1, pgd.mesh[0], [P.interpolate(lambda x: 2.0 * x, V_x)], ["V", "Node", "Scalar"]))
    pgd.write_hdf5(str(tmp_path))
    path = str(tmp_path / "PGD1_data.h5")
    for Q in (PORT, JAXP):
        _, f0 = Q.io.read_modes_hdf5(path, attri=0)
        _, f1 = Q.io.read_modes_hdf5(path, attri=1)
        assert abs(f0[0](0.3) - 0.3) < 1e-12 and abs(f1[0](0.3) - 0.6) < 1e-12


def test_vector_checkpoint_and_padding(tmp_path):
    """A vector P1 mode on a rectangle: the checkpoint read back by both
    packages, the pxdmf vector attribute padded to 3 components."""
    import xml.etree.ElementTree as et

    P = PORT
    mesh2 = P.RectangleMesh(P.Point(0, 0), P.Point(1, 1), 3, 3)
    V2 = P.VectorFunctionSpace(mesh2, "P", 1)
    V1 = P.FunctionSpace(P.IntervalMesh(6, 0.0, 1.0), "P", 1)
    m2 = [P.interpolate(lambda p: np.stack([p[..., 0], 2.0 * p[..., 1]], axis=-1), V2)]
    pgd = P.PGD(name="Vec", n_modes=1, fmeshes=[mesh2, V1.mesh()],
                pgd_modes=[m2, [P.interpolate(lambda x: 1.0 + x, V1)]],
                name_coord=["X", "P"], modes_info=["U", "Node", "Vector"])
    pgd.write_pxdmf(str(tmp_path))
    pgd.write_hdf5(str(tmp_path))
    for Q in (PORT, JAXP):
        Vr, fcts = Q.io.read_modes_hdf5(str(tmp_path / "PGD1_data.h5"))
        assert Vr.value_size == 2
        np.testing.assert_array_equal(fcts[0].array, m2[0].array)
    root = et.parse(str(tmp_path / "Vec.pxdmf")).getroot()
    attrs = [a for a in root.iter("Attribute") if a.get("AttributeType") == "Vector"]
    assert int(attrs[0].find("DataItem").get("Dimensions").split()[-1]) == 3


def _loaded(P, name):
    return P.PGD().load_pxdmf(os.path.join(FIXTURES, "foreign_pxdmf", name))


@pytest.mark.parametrize("name", ["Foreign.pxdmf", "PluginQuirks.pxdmf"])
def test_foreign_fixtures(name):
    """Both pxdmf fixtures the original library's writer layout produced,
    loaded by the port as by the JAX package: the same meshes, attributes
    and data, and the nodal evaluation equal."""
    t, j = _loaded(PORT, name), _loaded(JAXP, name)
    assert t.numModes == j.numModes == 2 and len(t.mesh) == len(j.mesh)
    for mt, mj in zip(t.mesh, j.mesh):
        assert (mt.name, mt.numNodes, mt.numElements, mt.typElements) == (
            mj.name, mj.numNodes, mj.numElements, mj.typElements)
        np.testing.assert_array_equal(mt.dataX, mj.dataX)
        np.testing.assert_array_equal(mt.dataY, mj.dataY)
        assert [(a.name, a._type, a.field) for a in mt.attributes] == [
            (a.name, a._type, a.field) for a in mj.attributes]
        for at, aj in zip(mt.attributes, mj.attributes):
            for dt, dj in zip(at.data, aj.data):
                np.testing.assert_array_equal(dt, dj)
    for m in (*t.mesh, *j.mesh):
        for a in m.attributes:
            a.interpolationInfo = {"name": 0, "kind": "linear"}
    free = list(range(1, len(t.mesh)))
    coord = [1.25, 0.5][: len(free)]
    close(np.asarray(t.evaluate(0, free, coord, 0)), np.asarray(j.evaluate(0, free, coord, 0)))
    if name == "Foreign.pxdmf":
        xs = t.mesh[0].dataX
        np.testing.assert_allclose(np.asarray(t.evaluate(0, [1], [1.5], 0)).ravel(),
                                   xs**2 * 1.5 + xs, atol=1e-9)


def test_unstructured_fixture():
    """The unstructured checkpoint (no mesh class tag) as a SimplicialMesh
    with the fixture's two analytic modes."""
    path = os.path.join(FIXTURES, "unstructured_tri", "Unstr_data.h5")
    V, fcts = PORT.io.read_modes_hdf5(path)
    xy = V.mesh().coordinates()
    assert type(V.mesh()).__name__ == "SimplicialMesh" and len(fcts) == 2
    np.testing.assert_allclose(fcts[0].array,
                               xy[:, 0] * (1 - xy[:, 0]) * xy[:, 1] * (1 - xy[:, 1]), atol=1e-12)
    np.testing.assert_allclose(fcts[1].array, np.sin(np.pi * xy[:, 0]) * xy[:, 1], atol=1e-12)


def test_result_checkpoint(tmp_path):
    """``save_result`` / ``load_result``: a port result (tensors) read by
    the JAX package, a JAX result read by the port."""
    import torch

    rng = np.random.default_rng(3)
    modes = [rng.standard_normal((4, n)) for n in (7, 5)]
    kw = dict(n_modes=3, amplitudes=np.array([1.0, 0.1, 0.01]), alpha=np.array([2.0, 1.0, 0.5]),
              fp_its=np.array([3, 4, 5]), normU0=1.5)
    res_t = PORT.PGDResult(modes=[torch.from_numpy(m) for m in modes], **kw)
    res_j = JAXP.PGDResult(modes=modes, **kw)
    PORT.io.save_result(res_t, str(tmp_path / "t.h5"))
    JAXP.io.save_result(res_j, str(tmp_path / "j.h5"))
    for got in (JAXP.io.load_result(str(tmp_path / "t.h5")),
                PORT.io.load_result(str(tmp_path / "j.h5"))):
        assert got.n_modes == 3 and got.normU0 == 1.5
        for a, b in zip(got.modes, modes):
            np.testing.assert_array_equal(np.asarray(a), b)
        np.testing.assert_array_equal(got.fp_its, kw["fp_its"])


def test_missing_h5py_is_named(tmp_path, monkeypatch):
    """Without h5py the port imports, and a file call raises an ImportError
    that names it."""
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        build_pgd(PORT).write_hdf5(str(tmp_path))
    with pytest.raises(ImportError, match="h5py"):
        PORT.io.load_result(str(tmp_path / "missing.h5"))
