"""The port's model layer (``PGD``, ``PGDAttribute``, ``PGDMesh``,
``_Interp1D``) and the dolfin-like FEM shims against the JAX package's, on
the CPU: the twins of ``tests/unit/test_model_extras.py`` — sensor
responses and their cache, derivatives (free and fixed dims), reducers,
the latex table, the full-tensor reconstruction, the interpolation kinds and
vector attributes — each run in both packages on the same rank-2 model,
equal to 1e-12 and to the exact function; and ``Function.vector()``,
``ufl_element()``, string ``Expression``s and parameter updates,
``Constant.assign``, the mesh's ``topology()`` / ``geometry()``.
"""

import os
import tempfile

import numpy as np
import pytest

from tests.test_torch_reference_solver import JAXP, PORT, close

BOTH = [JAXP, PORT]
IDS = ["jax", "port"]


def build_pgd(P):
    """u(x, p, E) = (x − x²)·p·E² + x·E (rank 2, smooth factors)."""
    Vx = P.FunctionSpace(P.IntervalMesh(40, 0.0, 1.0), "P", 2)
    Vp = P.FunctionSpace(P.IntervalMesh(12, 0.0, 2.0), "P", 1)
    VE = P.FunctionSpace(P.IntervalMesh(16, 0.5, 1.5), "P", 2)
    modes = [
        [P.interpolate(lambda x: x - x**2, Vx), P.interpolate(lambda x: x, Vx)],
        [P.interpolate(lambda p: p, Vp), P.interpolate(lambda p: np.ones_like(p), Vp)],
        [P.interpolate(lambda E: E**2, VE), P.interpolate(lambda E: E, VE)],
    ]
    return P.PGD(name="rank2", n_modes=2, fmeshes=[Vx.mesh(), Vp.mesh(), VE.mesh()],
                 pgd_modes=modes, name_coord=["X", "P", "E"],
                 modes_info=["U", "Node", "Scalar"])


def exact(x, p, E):
    return (x - x**2) * p * E**2 + x * E


def both(fn):
    """fn(model) of the port and of the JAX package: (port, jax)."""
    return fn(build_pgd(PORT)), fn(build_pgd(JAXP))


def test_sensor_points():
    pts = np.array([0.1, 0.35, 0.62, 0.97])
    t, j = both(lambda m: m.evaluate_sensor_response(0, [1, 2], [1.25, 0.8], 0, pts))
    close(t, j)
    np.testing.assert_allclose(t, exact(pts, 1.25, 0.8), atol=1e-12)


def test_sensor_cache():
    """The cache is hit on a second call, and its key is free of the
    reference's sum collision ([0.25, 0.5] against [0.5, 0.25])."""
    m = build_pgd(PORT)
    pts = np.array([0.25, 0.5])
    m.evaluate_sensor_response(0, [1, 2], [1.25, 0.8], 0, pts)
    key = (pts.tobytes(), pts.shape, 0, 0, False)
    cached = m._eval_fixed_modes[key]
    m.evaluate_sensor_response(0, [1, 2], [1.0, 1.0], 0, pts)
    assert m._eval_fixed_modes[key] is cached
    b = pts[::-1].copy()
    np.testing.assert_allclose(m.evaluate_sensor_response(0, [1, 2], [1.25, 0.8], 0, b),
                               exact(b, 1.25, 0.8), atol=1e-12)


def test_used_num_modes_truncation():
    def trunc(m):
        m.used_numModes = 1
        return m.evaluate_sensor_response(0, [1, 2], [1.25, 0.8], 0, np.array([0.5]))

    t, j = both(trunc)
    close(t, j)
    np.testing.assert_allclose(t, [0.25 * 1.25 * 0.8**2], atol=1e-12)


def test_derivatives():
    """d/dE (free dim), d/dx (the fixed dim, a DG field) and their sensor
    responses."""
    p, E = 1.5, 1.2
    xs = np.array([0.2, 0.5, 0.8])

    def derivs(m):
        m.create_interpolation_fcts([1, 2], 0)
        m.create_derivation_fct([1, 2], 0)
        dfs = m.mesh[2].attributes[0].derivationfct
        return (np.array([dfs[0](0.9), dfs[1](0.9)]),
                m.evaluate_derivative(0, [1, 2], [p, E], 0, d_dim=2)(xs),
                m.evaluate_derivative_sensor_response(0, [1, 2], [p, E], 0, 2, xs),
                m.evaluate_derivative(0, [1, 2], [p, E], 0, d_dim=0)(xs),
                m.evaluate_derivative_sensor_response(0, [1, 2], [p, E], 0, 0, xs))

    t, j = both(derivs)
    for a, b in zip(t, j):
        close(a, b)
    np.testing.assert_allclose(t[0], [1.8, 1.0], atol=1e-10)
    dE = (xs - xs**2) * p * 2 * E + xs
    dx = (1 - 2 * xs) * p * E**2 + E
    for got, want in zip(t[1:], (dE, dE, dx, dx)):
        np.testing.assert_allclose(got, want, atol=1e-12)


def test_reducers():
    def reduce(m):
        m.pos = 0.5
        return [getattr(m, r)(0, [1, 2], [1.0, 1.0], 0) for r in (
            "evaluate_max", "evaluate_min", "evaluate_max_abs", "evaluate_min_abs",
            "evaluate_abs_value")]

    t, j = both(reduce)
    close(t, j)
    dof_x = build_pgd(PORT).mesh[0].attributes[0].interpolationfct[0].function_space() \
        .tabulate_dof_coordinates()[:, 0]
    vals = exact(dof_x, 1.0, 1.0)
    np.testing.assert_allclose(t, [vals.max(), vals.min(), np.abs(vals).max(),
                                   np.abs(vals).min(), abs(exact(0.5, 1.0, 1.0))], atol=1e-10)


def test_save_modes_latex():
    tables = []
    for P in (PORT, JAXP):
        with tempfile.TemporaryDirectory() as d:
            build_pgd(P).save_modes_latex(d, 0)
            files = sorted(os.listdir(d))
            tables.append([np.loadtxt(os.path.join(d, f), delimiter=",") for f in files])
            assert len(files) == 3
    for a, b in zip(*tables):
        assert a.shape[1] == 3 and np.all(np.diff(a[:, 0]) >= 0)
        np.testing.assert_array_equal(a, b)


def test_reconstruct_tensor():
    t, j = both(lambda m: m.reconstruct_tensor(0))
    close(t, j)
    m = build_pgd(PORT)
    X, P_, E = np.meshgrid(m.mesh[0].dataX, m.mesh[1].dataX, m.mesh[2].dataX, indexing="ij")
    np.testing.assert_allclose(t, exact(X, P_, E), atol=1e-12)


@pytest.mark.parametrize("kind", ["linear", "nearest", "quadratic", "cubic"])
def test_interp1d_kinds(kind):
    from pgdrome_tpu.model import _Interp1D as J1
    from pgdrome_tpu_torch.model import _Interp1D as T1

    x = np.linspace(0.0, 1.0, 11)
    y = np.sin(2.0 * x) + x**3
    q = np.array([0.05, 0.33, 0.77, 1.0])
    np.testing.assert_array_equal(T1(x, y, kind=kind)(q), J1(x, y, kind=kind)(q))
    with pytest.raises(ValueError):
        T1(x, y, kind=kind)(1.5)


def test_interp1d_unknown_kind_raises():
    from pgdrome_tpu_torch.model import _Interp1D

    with pytest.raises((ValueError, NotImplementedError)):
        _Interp1D(np.linspace(0, 1, 5), np.zeros(5), kind="nope")


def test_interpolation_info_nodal():
    """interpolationInfo name 0: the free dims evaluated from nodal data
    by linear interpolation (an ndarray result)."""
    def nodal(m):
        for d in (1, 2):
            m.mesh[d].attributes[0].interpolationInfo = {"name": 0}
            m.mesh[d].attributes[0].interpolationfct = []
        return m.evaluate(0, [1, 2], [1.3, 0.9], 0)

    t, j = both(nodal)
    assert isinstance(t, np.ndarray)
    close(t, j)


def test_vector_attribute():
    """A vector P1 field on a rectangle: the component-major vertex data,
    and a pxdmf padded to 3 components beside an interval."""
    def vec(P):
        mesh2 = P.RectangleMesh(P.Point(0, 0), P.Point(1, 1), 3, 3)
        V2 = P.VectorFunctionSpace(mesh2, "P", 1)
        V1 = P.FunctionSpace(P.IntervalMesh(6, 0.0, 1.0), "P", 1)
        m2 = [P.interpolate(lambda p: np.stack([p[..., 0], 2.0 * p[..., 1]], axis=-1), V2)]
        m1 = [P.interpolate(lambda x: 1.0 + x, V1)]
        return P.PGD(name="Vec", n_modes=1, fmeshes=[mesh2, V1.mesh()], pgd_modes=[m2, m1],
                     name_coord=["X", "P"], modes_info=["U", "Node", "Vector"]), mesh2

    (t, mesh2), (j, _) = vec(PORT), vec(JAXP)
    np.testing.assert_array_equal(t.mesh[0].attributes[0].data[0],
                                  j.mesh[0].attributes[0].data[0])
    xy = mesh2.coordinates()
    np.testing.assert_allclose(t.mesh[0].attributes[0].data[0], np.stack(
        [xy[:, 0], 2 * xy[:, 1]], axis=1), atol=1e-14)
    close(t.evaluate_max_norm(0, [1], [0.5], 0), j.evaluate_max_norm(0, [1], [0.5], 0))


# ------------------------------------------------------------------ fem shims

@pytest.mark.parametrize("P", BOTH, ids=IDS)
def test_function_vector_view(P):
    V = P.FunctionSpace(P.IntervalMesh(4, 0.0, 1.0), "P", 1)
    f = P.interpolate(lambda x: x, V)
    g = f.copy(deepcopy=True)
    v = f.vector()
    assert len(v) == 5 and v.max() == 1.0 and v.min() == 0.0
    np.testing.assert_array_equal(v[:], np.linspace(0, 1, 5))
    v[0] = 3.0
    assert f.array[0] == 3.0 and g.array[0] == 0.0
    v.set_local(np.arange(5.0))
    v.axpy(2.0, g.vector())
    np.testing.assert_array_equal(v.get_local(), np.arange(5.0) + 2 * np.linspace(0, 1, 5))
    np.testing.assert_array_equal(np.asarray(v), f.array)
    bc = P.DirichletBC(V, 7.0)
    bc.apply(f.vector())
    assert f.array[0] == f.array[-1] == 7.0


def test_element_and_mesh_shims():
    for P in BOTH:
        mesh = P.RectangleMesh(P.Point(0, 0), P.Point(1, 1), 2, 2)
        V = P.VectorFunctionSpace(mesh, "P", 2)
        f = P.Function(V)
        e = f.ufl_element()
        assert (e.degree(), e.family(), str(e)) == (2, "P", "<vector element P2>")
        assert V.ufl_function_space() is V
        assert str(P.FunctionSpace(mesh, "DG", 0).ufl_element()) == "<element DG0>"
        assert mesh.topology().dim() == 2 and mesh.geometry().dim() == 2


def test_string_expression_and_assign():
    out = []
    for P in (PORT, JAXP):
        V = P.FunctionSpace(P.RectangleMesh(P.Point(0, 0), P.Point(1, 1), 3, 3), "P", 1)
        e = P.Expression("a * sin(pi * x[0]) * x[1] + b", degree=2, element=None, a=2.0, b=0.5)
        f1 = P.interpolate(e, V).array
        e.a = 3.0
        e.assign(b=-1.0)
        f2 = P.interpolate(e, V).array
        c = P.Expression("x[0] * x[0]")
        f3 = P.interpolate(c, P.FunctionSpace(P.IntervalMesh(4, 0.0, 1.0), "P", 1)).array
        out.append((f1, f2, f3))
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)
    V = PORT.FunctionSpace(PORT.RectangleMesh(PORT.Point(0, 0), PORT.Point(1, 1), 3, 3), "P", 1)
    xy = V.tabulate_dof_coordinates()
    np.testing.assert_allclose(out[0][1], 3.0 * np.sin(np.pi * xy[:, 0]) * xy[:, 1] - 1.0,
                               atol=1e-14)
    np.testing.assert_allclose(out[0][2], np.linspace(0, 1, 5) ** 2, atol=1e-14)


def test_constant_assign():
    from pgdrome_tpu_torch.fem.function import Constant

    c = Constant(2.0)
    c.assign(5.0)
    assert float(c) == 5.0 and c(np.zeros(3)).tolist() == [5.0, 5.0, 5.0]
