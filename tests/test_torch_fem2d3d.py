"""The port's 2D/3D FEM against the JAX package's, on the CPU.

Meshes (rectangles with all three diagonals, Kuhn boxes, unstructured
simplicial meshes), P1/P2 and DG spaces, scalar and vector: topology,
dofmaps, dof coordinates and quadrature equal to the bit (the numbering is
the same numpy code); mass, stiffness, advection, elasticity (2D and 3D),
vector mass and boundary loads to 1e-13; Dirichlet dofs and
``apply_system`` exactly; point values and gradients to 1e-13 (and the
torch path against numpy); ``gradient_function`` / ``derivative_function``
to 1e-12; ``assembly_device`` on crossed rectangles against
``assembly_jax`` and the host to 1e-13; and the 2D/3D builders
``transient_heat_2d`` (1e-13), ``parametric_elliptic_3d`` and
``elliptic3d_dense_verifier`` (1e-12) at toy size.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import sparse as sps

from pgdrome_tpu.fem import assembly as JA
from pgdrome_tpu.fem import assembly_jax as JD
from pgdrome_tpu.fem import bc as JB
from pgdrome_tpu.fem import derivative as JDer
from pgdrome_tpu.fem import function as JF
from pgdrome_tpu.fem.interpolate import eval_dofs_at_points as j_eval
from pgdrome_tpu.fem import mesh as JM
from pgdrome_tpu.fem import space as JS
from pgdrome_tpu.models import problems as JP
from pgdrome_tpu import separated as J

from pgdrome_tpu_torch.fem import assembly as TA
from pgdrome_tpu_torch.fem import assembly_device as TD
from pgdrome_tpu_torch.fem import bc as TB
from pgdrome_tpu_torch.fem import derivative as TDer
from pgdrome_tpu_torch.fem import function as TF
from pgdrome_tpu_torch.fem.interpolate import eval_dofs_at_points as t_eval
from pgdrome_tpu_torch.fem import mesh as TM
from pgdrome_tpu_torch.fem import space as TS
from pgdrome_tpu_torch.models import problems as TP
from pgdrome_tpu_torch import separated as S

BUILD = 1e-13    # host f64 assembly, point values
DERIV = 1e-12    # exact derivatives onto DG spaces, verifier errors


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite's workers share a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(a, b, tol):
    a = a.toarray() if sps.issparse(a) else np.asarray(a, dtype=np.float64)
    b = b.toarray() if sps.issparse(b) else np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape
    scale = max(float(np.abs(b).max()), 1e-300)
    assert float(np.abs(a - b).max()) <= tol * scale


def _rect(M, diagonal, nx=4, ny=3):
    return M.RectangleMesh(M.Point(0.0, -0.5), M.Point(2.0, 1.0), nx, ny, diagonal)


def _box(M, n=2):
    return M.BoxMesh(M.Point(0.0, 0.0, 0.0), M.Point(1.0, 2.0, 0.5), n, n + 1, n)


def _unstructured(M, tdim):
    # a jittered rectangle (box) mesh's arrays: not a structured mesh, so
    # the topological boundary and the bucketed locate are exercised
    base = _rect(JM, "crossed", 5, 4) if tdim == 2 else _box(JM, 2)
    coords = base.coordinates().copy()
    interior = np.ones(len(coords), bool)
    for a, (lo, hi) in enumerate(base.bounds):
        interior &= (coords[:, a] > lo + 1e-9) & (coords[:, a] < hi - 1e-9)
    coords[interior] += np.random.default_rng(3).uniform(-0.04, 0.04, (interior.sum(), tdim))
    return M.SimplicialMesh(coords, base.cells())


MESHES = {
    "right": lambda M: _rect(M, "right"),
    "left": lambda M: _rect(M, "left"),
    "crossed": lambda M: _rect(M, "crossed"),
    "box": _box,
    "tri_unstructured": lambda M: _unstructured(M, 2),
    "tet_unstructured": lambda M: _unstructured(M, 3),
}
# (mesh, family, degree, vector)
SPACES = [(m, "P", k, v) for m in MESHES for k in (1, 2) for v in (False, True)]
SPACES += [(m, "DG", k, False) for m in ("right", "crossed", "tri_unstructured")
           for k in (0, 1, 2)]
SPACES += [("box", "DG", 0, False), ("tet_unstructured", "DG", 0, False)]


def _space(M, S_, case):
    mesh, family, degree, vector = case
    m = MESHES[mesh](M)
    return (S_.VectorFunctionSpace(m, family, degree) if vector
            else S_.FunctionSpace(m, family, degree))


def _pair(case):
    return _space(JM, JS, case), _space(TM, TS, case)


def _id(case):
    return "-".join(str(c) for c in case)


@pytest.mark.parametrize("name", list(MESHES))
def test_meshes(name):
    jm, tm = MESHES[name](JM), MESHES[name](TM)
    np.testing.assert_array_equal(tm.coordinates(), jm.coordinates())
    np.testing.assert_array_equal(tm.cells(), jm.cells())
    assert (tm.topology_dim(), tm.geometry_dim()) == (jm.topology_dim(), jm.geometry_dim())
    if name != "box":  # the JAX BoxMesh has no hmin either
        assert tm.hmin() == jm.hmin()
    if "unstructured" in name:
        np.testing.assert_array_equal(tm.boundary_facets(), jm.boundary_facets())
        np.testing.assert_array_equal(tm.boundary_vertex_mask(), jm.boundary_vertex_mask())
        assert tm.bounds == jm.bounds
    else:
        assert tm.bounds == jm.bounds


@pytest.mark.parametrize("case", SPACES, ids=_id)
def test_dofmap_and_quadrature(case):
    jv, tv = _pair(case)
    assert (tv.ndofs, tv.dim(), tv.value_size) == (jv.ndofs, jv.dim(), jv.value_size)
    np.testing.assert_array_equal(tv.element_dofs, jv.element_dofs)
    np.testing.assert_array_equal(tv.tabulate_dof_coordinates(), jv.tabulate_dof_coordinates())
    for attr in ("q_points", "q_weights", "q_basis", "q_grads"):
        np.testing.assert_array_equal(getattr(tv, attr), getattr(jv, attr))
    if hasattr(jv, "edge_vertices"):
        np.testing.assert_array_equal(tv.edge_vertices, jv.edge_vertices)
    if case[3]:
        np.testing.assert_array_equal(tv.component_dofs(1), jv.component_dofs(1))


WEIGHTS = {
    "none": None,
    "const": 2.5,
    "callable": lambda x: 1.0 + x[..., 0] ** 2 + np.sin(x[..., 1]),
}
SCALAR = [c for c in SPACES if not c[3]]


@pytest.mark.parametrize("weight", list(WEIGHTS))
@pytest.mark.parametrize("case", SCALAR, ids=_id)
def test_scalar_operators(case, weight):
    jv, tv = _pair(case)
    w = WEIGHTS[weight]
    _close(TA.mass_matrix(tv, w), JA.mass_matrix(jv, w), BUILD)
    _close(TA.stiffness_matrix(tv, w), JA.stiffness_matrix(jv, w), BUILD)
    _close(TA.mass_matrix(tv, w, sparse=True), JA.mass_matrix(jv, w, sparse=True), BUILD)
    _close(TA.stiffness_matrix(tv, w, sparse=True), JA.stiffness_matrix(jv, w, sparse=True),
           BUILD)
    for direction in range(tv.mesh().geometry_dim()):
        _close(TA.advection_matrix(tv, w, direction), JA.advection_matrix(jv, w, direction),
               BUILD)
    g = lambda x: np.cos(x[..., 0]) * (1.0 + x[..., 1])  # noqa: E731
    _close(TA.load_vector(tv, g, w), JA.load_vector(jv, g, w), BUILD)
    _close(TA.assemble_vector(tv, 3.0), JA.assemble_vector(jv, 3.0), BUILD)


def test_function_weight_and_contractions():
    jv, tv = _pair(("crossed", "P", 2, False))
    arr = np.random.default_rng(1).uniform(1.0, 2.0, tv.dim())
    jw, tw = JF.Function(jv, arr), TF.Function(tv, arr)
    _close(TA.mass_matrix(tv, tw), JA.mass_matrix(jv, jw), BUILD)
    # a weight on another space of the same mesh is evaluated at the points
    jv1, tv1 = (S_.FunctionSpace(v.mesh(), "P", 1) for S_, v in ((JS, jv), (TS, tv)))
    arr1 = arr[: tv1.dim()]
    _close(TA.stiffness_matrix(tv, TF.Function(tv1, arr1)),
           JA.stiffness_matrix(jv, JF.Function(jv1, arr1)), BUILD)
    assert TA.gram(tw, TA.mass_matrix(tv), arr) == pytest.approx(
        JA.gram(jw, JA.mass_matrix(jv), arr), rel=BUILD)
    assert TA.norm(tw) == pytest.approx(JA.norm(jw), rel=BUILD)
    assert TA.inner_l2(tw, tw) == pytest.approx(JA.inner_l2(jw, jw), rel=BUILD)
    jvv, tvv = _pair(("right", "P", 2, True))
    vec = np.random.default_rng(2).normal(size=tvv.dim())
    assert TA.norm(TF.Function(tvv, vec)) == pytest.approx(
        JA.norm(JF.Function(jvv, vec)), rel=BUILD)
    with pytest.raises(ValueError):
        TA.mass_matrix(tvv)
    with pytest.raises(ValueError):
        TA.norm(vec)


C3 = np.array([[2.0, 0.7, 0.0], [0.7, 1.5, 0.1], [0.0, 0.1, 0.4]])
C6 = np.diag([2.0, 1.8, 1.6, 0.5, 0.4, 0.3]) + 0.2 * (np.eye(6, k=1) + np.eye(6, k=-1))


@pytest.mark.parametrize("case", [c for c in SPACES if c[3]], ids=_id)
def test_vector_operators(case):
    jv, tv = _pair(case)
    for sparse in (False, True):
        _close(TA.vector_mass_matrix(tv, sparse=sparse), JA.vector_mass_matrix(jv, sparse=sparse),
               BUILD)
        if tv.mesh().topology_dim() == 2:
            _close(TA.elasticity_matrix(tv, C3, sparse=sparse),
                   JA.elasticity_matrix(jv, C3, sparse=sparse), BUILD)
        else:
            _close(TA.elasticity_matrix_3d(tv, C6, sparse=sparse),
                   JA.elasticity_matrix_3d(jv, C6, sparse=sparse), BUILD)
    w = lambda x: 1.0 + x[..., 0]  # noqa: E731
    _close(TA.vector_mass_matrix(tv, w), JA.vector_mass_matrix(jv, w), BUILD)
    with pytest.raises(ValueError):
        (TA.elasticity_matrix_3d if tv.mesh().topology_dim() == 2 else TA.elasticity_matrix)(
            tv, C6)


@pytest.mark.parametrize("case", [("crossed", "P", 1, False), ("crossed", "P", 2, True),
                                  ("left", "P", 2, False), ("tri_unstructured", "P", 2, True)],
                         ids=_id)
def test_boundary_loads(case):
    jv, tv = _pair(case)
    g = JF.Expression((lambda p: np.sin(p[..., 0]), lambda p: -1.0 - p[..., 1]))
    gs = lambda p: 1.0 + p[..., 0] * p[..., 1]  # noqa: E731
    marker = lambda m: m[1] > 0.9  # noqa: E731 — the top edge
    cases = ((gs, None), (gs, marker)) + (((g, None), (g, marker)) if case[3] else ())
    for fn, mk in cases:
        tg = TF.Expression((lambda p: np.sin(p[..., 0]), lambda p: -1.0 - p[..., 1])) \
            if fn is g else fn
        _close(TA.boundary_load_vector(tv, tg, mk), JA.boundary_load_vector(jv, fn, mk), BUILD)


@pytest.mark.parametrize("case", [("crossed", "P", 2, False), ("right", "P", 1, True),
                                  ("box", "P", 2, False), ("tri_unstructured", "P", 2, False),
                                  ("tri_unstructured", "DG", 1, False),
                                  ("tet_unstructured", "P", 2, True),
                                  ("tet_unstructured", "DG", 0, False)],
                         ids=_id)
def test_dirichlet(case):
    jv, tv = _pair(case)
    np.testing.assert_array_equal(TB._on_boundary_mask(tv), JB._on_boundary_mask(jv))
    gdim = tv.mesh().geometry_dim()
    value = (lambda x: 1.0 + x[..., 0]) if not case[3] else tuple(range(1, gdim + 1))
    where = lambda x, onb: onb and x[0] < 1.0  # noqa: E731
    for kw in ({}, {"where": where}, {"where": lambda x: x[1] > 0.5}):
        jb, tb = JB.DirichletBC(jv, value, **kw), TB.DirichletBC(tv, value, **kw)
        np.testing.assert_array_equal(tb.dofs, jb.dofs)
        np.testing.assert_array_equal(tb.values, jb.values)
    if case[3]:
        for c in range(gdim):
            jb, tb = (B.DirichletBC(V, (0.0,) * gdim, where, component=c)
                      for B, V in ((JB, jv), (TB, tv)))
            np.testing.assert_array_equal(tb.dofs, jb.dofs)
    jb, tb = JB.DirichletBC(jv, value), TB.DirichletBC(tv, value)
    rng = np.random.default_rng(4)
    A = rng.normal(size=(tv.dim(), tv.dim()))
    b = rng.normal(size=tv.dim())
    for Am in (A, sps.csr_matrix(A)):
        (ta, tbv), (ja, jbv) = tb.apply_system(Am, b), jb.apply_system(Am, b)
        _close(ta, ja, 0.0)
        np.testing.assert_array_equal(tbv, jbv)
    x = rng.normal(size=tv.dim())
    np.testing.assert_array_equal(tb.apply(x.copy()), jb.apply(x.copy()))
    np.testing.assert_array_equal(tb.zero(x.copy()), jb.zero(x.copy()))
    f = TF.Function(tv, x)
    tb.apply(f)
    np.testing.assert_array_equal(f.array[tb.dofs], tb.values)
    assert not tb.homogenize().values.any()
    assert TB.combine_bcs(0) == [] and TB.combine_bcs(tb) == [tb]
    assert TB.combine_bcs([tb, tb]) == [tb, tb]


def _points(mesh, n, seed):
    """Points inside the mesh: its vertices, then cell interior points."""
    rng = np.random.default_rng(seed)
    verts = mesh.coordinates()[mesh.cells()]
    cells = rng.integers(0, len(verts), n)
    bary = rng.dirichlet(np.ones(verts.shape[1]), n)
    inner = np.einsum("nk,nkg->ng", bary, verts[cells])
    return np.concatenate([mesh.coordinates(), inner])


@pytest.mark.parametrize("case", SPACES, ids=_id)
def test_point_values_and_gradients(case):
    jv, tv = _pair(case)
    pts = _points(tv.mesh(), 40, 5)
    dofs = np.random.default_rng(6).normal(size=tv.dim())
    for derivative in (False, True):
        got = t_eval(tv, dofs, pts, derivative=derivative)
        want = j_eval(jv, dofs, pts, derivative=derivative)
        _close(got, want, BUILD)
        if "unstructured" not in case[0]:
            dev = t_eval(tv, torch.as_tensor(dofs), torch.as_tensor(pts),
                                         xp=torch, derivative=derivative)
            _close(dev.numpy(), want, BUILD)
    jf, tf = JF.Function(jv, dofs), TF.Function(tv, dofs)
    _close(tf(pts[:7]), jf(pts[:7]), BUILD)
    _close(tf.compute_vertex_values(), jf.compute_vertex_values(), BUILD)
    if case[3]:
        for a, b in zip(tf.split(), jf.split()):
            np.testing.assert_array_equal(a.array, b.array)
    with pytest.raises(ValueError):
        tf(pts[:1] + 1e3)


def test_outside_points_raise():
    tv = _space(TM, TS, ("tri_unstructured", "P", 1, False))
    hole = TM.SimplicialMesh(tv.mesh().coordinates(), tv.mesh().cells()[1:])
    p = tv.mesh().coordinates()[tv.mesh().cells()[0]].mean(axis=0)
    with pytest.raises(ValueError, match="outside the mesh"):
        t_eval(TS.FunctionSpace(hole, "P", 1), np.zeros(hole.num_vertices()),
                               p[None])


def test_expressions_and_interpolation():
    jv, tv = _pair(("crossed", "P", 2, True))
    comps = (lambda p: p[..., 0] * p[..., 1], lambda p: np.exp(-p[..., 0]))
    te, je = TF.Expression(comps), JF.Expression(comps)
    assert te.value_size == 2
    np.testing.assert_array_equal(TF.interpolate(te, tv).array, JF.interpolate(je, tv).array)
    np.testing.assert_array_equal(TF.Constant((1.0, 2.0)).values(), [1.0, 2.0])
    np.testing.assert_array_equal(TF.interpolate(TF.Constant((1.0, 2.0)), tv).array,
                                  JF.interpolate(JF.Constant((1.0, 2.0)), jv).array)
    js2, ts2 = (S_.FunctionSpace(v.mesh(), "P", 1) for S_, v in ((JS, jv), (TS, tv)))
    f = lambda p: np.sin(p[..., 0]) + p[..., 1]  # noqa: E731
    jf2 = JF.interpolate(f, JS.FunctionSpace(jv.mesh(), "P", 2))
    tf2 = TF.interpolate(f, TS.FunctionSpace(tv.mesh(), "P", 2))
    _close(TF.interpolate(tf2, ts2).array, JF.interpolate(jf2, js2).array, BUILD)


@pytest.mark.parametrize("case", [c for c in SPACES if c[1] == "P"], ids=_id)
def test_gradient_and_derivative_functions(case):
    jv, tv = _pair(case)
    dofs = np.random.default_rng(7).normal(size=tv.dim())
    jf, tf = JF.Function(jv, dofs), TF.Function(tv, dofs)
    if tv.mesh().topology_dim() == 3 and tv.degree == 2:
        with pytest.raises(NotImplementedError):  # DG1 on tets: neither package
            TDer.gradient_function(tf)
        return
    jg, tg = JDer.gradient_function(jf), TDer.gradient_function(tf)
    assert tg.function_space().value_size == jg.function_space().value_size
    np.testing.assert_array_equal(tg.function_space().element_dofs,
                                  jg.function_space().element_dofs)
    _close(tg.array, jg.array, DERIV)
    for direction in range(tv.mesh().geometry_dim() if not case[3] else 1):
        _close(TDer.derivative_function(tf, direction).array,
               JDer.derivative_function(jf, direction).array, DERIV)
    if not case[3]:
        with pytest.raises(ValueError):
            TDer.derivative_function(tf, 5)


def test_device_assembly_on_crossed_rectangles():
    # tests/unit/test_assembly_jax.py's crossed meshes, P1 and P2
    for nx, deg in ((4, 1), (3, 2)):
        jv = JS.FunctionSpace(JM.RectangleMesh(JM.Point(0, 0), JM.Point(1, 1), nx, nx,
                                               "crossed"), "P", deg)
        tv = TS.FunctionSpace(TM.RectangleMesh(TM.Point(0, 0), TM.Point(1, 1), nx, nx,
                                               "crossed"), "P", deg)
        tj = JD.AssemblyTables(jv, dtype=jnp.float64)
        tt = TD.AssemblyTables(tv, dtype=torch.float64, device="cpu")
        w = lambda x: 1.0 + 0.5 * np.sin(3.0 * x[..., 0]) * x[..., 1]  # noqa: E731
        wq = np.asarray(w(tv.q_points))
        wj, wt = jnp.asarray(wq), torch.as_tensor(wq)
        for fn in ("mass_matrix", "stiffness_matrix"):
            _close(getattr(TD, fn)(tt), getattr(JD, fn)(tj), BUILD)
            _close(getattr(TD, fn)(tt, wt), getattr(JD, fn)(tj, wj), BUILD)
        for direction in (0, 1):
            _close(TD.advection_matrix(tt, wt, direction),
                   JD.advection_matrix(tj, wj, direction), BUILD)
            _close(TD.advection_matrix(tt, wt, direction),
                   TA.advection_matrix(tv, w, direction), BUILD)
        _close(TD.mass_matrix(tt), TA.mass_matrix(tv), BUILD)
        _close(TD.stiffness_matrix(tt, wt), TA.stiffness_matrix(tv, weight=w), BUILD)
        _close(TD.load_vector(tt, wt), TA.load_vector(tv, w), BUILD)
        u = np.random.default_rng(8).normal(size=tv.dim())
        uj, ut = jnp.asarray(u), torch.as_tensor(u)
        _close(TD.mass_apply(tt, wt, ut), JD.mass_apply(tj, wj, uj), BUILD)
        _close(TD.stiffness_apply(tt, wt, ut), JD.stiffness_apply(tj, wj, uj), BUILD)


def _same_problem(t, j, tol):
    assert t.sizes == j.sizes and t.num_terms == j.num_terms and t.num_rhs == j.num_rhs
    for d in range(len(t.sizes)):
        _close(t.ops[d], j.ops[d], tol)
        _close(t.rhs[d], j.rhs[d], tol)
        _close(t.mass[d], j.mass[d], tol)
        np.testing.assert_array_equal(np.asarray(t.bc_dofs[d]), np.asarray(j.bc_dofs[d]))


def test_transient_heat_2d():
    (tp, tVs), (jp, jVs) = (P.transient_heat_2d(nx=4, ny=3, n_t=6) for P in (TP, JP))
    _same_problem(tp, jp, BUILD)
    np.testing.assert_array_equal(tVs[0].element_dofs, jVs[0].element_dofs)


@pytest.mark.parametrize("n, degree", [(3, 1), (2, 2)])
def test_parametric_elliptic_3d_and_verifier(n, degree):
    tp, tVs = TP.parametric_elliptic_3d(n=n, n_p=6, num_params=2, degree_x=degree)
    jp, jVs = JP.parametric_elliptic_3d(n=n, n_p=6, num_params=2, degree_x=degree)
    _same_problem(tp, jp, DERIV)
    kw = dict(n_max=6, tol=1e-12, tol_fp=1e-8, max_fp_it=60)
    jres = J.SeparatedPGD(jp, **kw).solve()
    tres = S.SeparatedPGD(tp, device="cpu", **kw).solve()
    np.testing.assert_allclose(tres.amplitudes, jres.amplitudes, rtol=1e-8)
    jver = JP.elliptic3d_dense_verifier(jVs, n_random=3, seeds=(7,))
    tver = TP.elliptic3d_dense_verifier(tVs, n_random=3, seeds=(7,))
    np.testing.assert_array_equal(tver.corners, jver.corners)
    # the JAX result through both verifiers: the same truths and errors
    jr = jver(jres)
    tr = tver(S.PGDResult(modes=[np.asarray(m) for m in jres.modes], n_modes=jres.n_modes,
                          amplitudes=jres.amplitudes, alpha=jres.alpha, fp_its=jres.fp_its))
    for key in ("corners", "interior", "max"):
        assert tr[key] == pytest.approx(jr[key], rel=DERIV, abs=1e-15)
    pts = tver.samples[7]
    _close(tver.sample_errors(tres, pts), jver.sample_errors(jres, pts), 1e-6)
