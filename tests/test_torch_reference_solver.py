"""The port's reference-parity solver (``PGDProblem``) against the JAX
package's, on the CPU, on reduced-width mirrors of the interval workflows of
``tests/integration``: test_laplace (FEM and FD callbacks),
test_laplace_fastpath, test_elastic (the truss), test_heat1d (FEM and
FD-upwind time, heating and cooling) and test_heat1d_dimless; and the
solver's options (the 'delta' stop, the 'l2' and 'no' normalisations, a
randomized start, ``seq_fp``, ``resume``, 'direct' dims, residual-form
Newton dims) on ``pgd_problem_from_separated`` and the truss.

Each workflow's callbacks are written once, over a namespace of one
package's modules (:func:`pkg`), and run through both packages, so the test
compares the frameworks, not two transcriptions.  Both layers are host
numpy in f64 over copies of the same FEM code: amplitudes, ``alpha``, the
fixed-point counts and errors, the modes and the model layer's outputs
(evaluate, sensors, derivatives, reducers, ``PGDErrorComputation``) agree
to 1e-12 relative.  test_laplace_fastpath's own check — the FD amplitudes
of ``PGDProblem`` against the device solver ``SeparatedPGD`` in f64 — is
held port against port at 1e-8.
"""

import importlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

PARITY = 1e-12   # host f64 against host f64 over the same numpy code
FASTPATH = 1e-8  # PGDProblem's FD amplitudes against SeparatedPGD (BASELINE.md)

_MODULES = {
    "mesh": "fem.mesh", "space": "fem.space", "function": "fem.function", "bc": "fem.bc",
    "assembly": "fem.assembly", "fd": "ops.fd", "solver": "solver", "model": "model",
    "problems": "models.problems", "separated": "separated",
}


def pkg(root):
    """The names a workflow uses, from package ``root`` (``pgdrome_tpu`` or
    ``pgdrome_tpu_torch``): the same relative modules in both, and ``io``."""
    m = {k: importlib.import_module(f"{root}.{v}") for k, v in _MODULES.items()}
    names = {}
    for mod, attrs in (
        ("mesh", "IntervalMesh RectangleMesh Point"),
        ("space", "FunctionSpace VectorFunctionSpace"),
        ("function", "Function Expression interpolate"),
        ("bc", "DirichletBC"),
        ("assembly", "mass_matrix stiffness_matrix load_vector advection_matrix gram "
                     "elasticity_matrix boundary_load_vector"),
        ("fd", "FD_matrices apply_matrix_bc apply_vector_bc"),
        ("solver", "PGDProblem"),
        ("model", "PGD PGDErrorComputation pgd_from_result"),
        ("problems", "poisson_xy elastic_truss pgd_problem_from_separated "
                     "parametric_elliptic_3d"),
        ("separated", "SeparatedProblem SeparatedPGD PGDResult precondition_dim0"),
    ):
        for a in attrs.split():
            names[a] = getattr(m[mod], a)
    return SimpleNamespace(root=root, io=importlib.import_module(f"{root}.io"), **names)


JAXP = pkg("pgdrome_tpu")
PORT = pkg("pgdrome_tpu_torch")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite's workers share a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def close(a, b, tol=PARITY):
    """max |a − b| ≤ tol · max |b| (elementwise shapes equal)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape
    assert np.max(np.abs(a - b), initial=0.0) <= tol * max(np.max(np.abs(b), initial=0.0),
                                                          1e-300)


def same_solve(p, q, tol=PARITY):
    """Two solved PGDProblems agree: the traces to ``tol`` relative (each
    entry), the fixed-point counts exactly, every mode to ``tol``."""
    assert p.PGD_modes == q.PGD_modes
    np.testing.assert_allclose(p.amplitude, q.amplitude, rtol=tol, atol=0)
    np.testing.assert_allclose(p.alpha, q.alpha, rtol=tol, atol=0)
    assert list(p.num_fp_it) == list(q.num_fp_it)
    assert len(p.err_fp_it) == len(q.err_fp_it)
    for e, f in zip(p.err_fp_it, q.err_fp_it):
        np.testing.assert_allclose(e, f, rtol=1e-9, atol=1e-15)
    for d in range(p.num_pgd_var):
        for fp, fq in zip(p.PGD_func[d], q.PGD_func[d]):
            close(fp.array, fq.array, tol)


# ------------------------------------------------ one callback pair, written once

def separated_callbacks(P, probs, terms, scales, lifts=(), fd_bc=None, direct=(),
                        residual_form=False):
    """``lhs_fct`` / ``rhs_fct`` of a separated operator Σ_t s_t ⊗_d A_td
    (``terms[t][d]``, dense or sparse) against the loads passed to the
    problem (``load[r][d]`` vectors) minus the lift ``Σ_t s_t ⊗_d A_td
    L_d`` of each lift (a per-dim list of Functions): the structure of
    every callback of the interval and 2D workflows.  The coordinate is
    read from ``typ`` (as the reference's callbacks do; the 'stiff' norming
    passes the last one with ``dim = num_pgd_var``).  ``fd_bc = (dim,
    idx)``: the FD dim whose rows and columns the callbacks constrain;
    ``direct``: dims returned as the diagonal of their operator (solved
    elementwise); ``residual_form``: return ``A @ u`` at the iterate ``u``
    (the Newton path)."""
    dim_of = {t: d for d, t in enumerate(probs)}
    nd = len(probs)

    def coef(Fs, others, t, d):
        c = scales[t]
        for j in range(nd):
            if j != d:
                c = c * P.gram(Fs[j], terms[t][j], others[j])
        return c

    def lhs(fct_F, var_F, Fs, meshes, dom, param, typ, dim):
        d = dim_of[typ]
        a = None
        for t in range(len(terms)):
            c = coef(Fs, Fs, t, d)
            a = c * terms[t][d] if a is None else a + c * terms[t][d]
        if fd_bc is not None and d == fd_bc[0]:
            a = P.apply_matrix_bc(a, fd_bc[1])
        if d in direct:
            return np.diag(a).copy()
        if residual_form and fct_F is not None:
            return a @ fct_F.array
        return a

    def rhs(fct_F, var_F, Fs, meshes, dom, param, load, PGD_func, typ, nE, dim):
        d = dim_of[typ]
        l = np.zeros(len(Fs[d].array))
        for g in load:
            c = 1.0
            for j in range(nd):
                if j != d:
                    c = c * (Fs[j].array @ g[j])
            l = l + c * g[d]
        subtract = list(lifts) + [[PGD_func[j][o] for j in range(nd)] for o in range(nE)]
        for L in subtract:
            for t in range(len(terms)):
                l = l - coef(Fs, L, t, d) * (terms[t][d] @ L[d].array)
        if fd_bc is not None and d == fd_bc[0]:
            l = P.apply_vector_bc(l, fd_bc[1])
        return l

    return lhs, rhs


def _spaces(P, elems, ords, ranges, family="CG"):
    return [P.FunctionSpace(P.IntervalMesh(ne, r[0], r[1]), family, o)
            for ne, o, r in zip(elems, ords, ranges)]


def _knobs(prob, **kw):
    prob.stop_fp = kw.get("stop_fp", "norm")
    prob.max_fp_it = kw.get("max_fp_it", 50)
    prob.tol_fp_it = kw.get("tol_fp_it", 1e-5)
    prob.norm_modes = kw.get("norm_modes", "stiff")
    if "PGD_tol" in kw:
        prob.PGD_tol = kw["PGD_tol"]
    return prob


# ----------------------------------------------------------------- test_laplace

LAPLACE_RANGES = [[0.0, 3.0], [0.0, 3.0], [0.0, 50.0], [10.0, 50.0]]


def laplace(P, variant, elem=(12, 8, 10, 8), nmax=5):
    """2D Poisson x⊗y⊗q⊗u0 with the lift u0·(1 − x/3) (test_laplace.py),
    FEM or FD callbacks."""
    k, lx = 0.5, 3.0
    vs = _spaces(P, elem, [1] * 4, LAPLACE_RANGES)
    lift = [P.interpolate(lambda x: 1.0 - x / 3.0, vs[0]),
            P.interpolate(lambda y: np.ones_like(y), vs[1]),
            P.interpolate(lambda q: np.ones_like(q), vs[2]),
            P.interpolate(lambda u: u, vs[3])]
    src = [P.interpolate(lambda x: np.where(x < lx / 2, 1.0, 0.0), vs[0]),
           P.interpolate(lambda y: np.ones_like(y), vs[1]),
           P.interpolate(lambda q: q, vs[2]),
           P.interpolate(lambda u: np.ones_like(u), vs[3])]
    fd_bc, MM = None, None
    if variant == "FEM":
        M = [P.mass_matrix(v) for v in vs]
        K = [P.stiffness_matrix(v) for v in vs]
        scales = [k, k]
    else:
        xs = [v.tabulate_dof_coordinates()[:, 0] for v in vs]
        FD = [P.FD_matrices(x) for x in xs]
        M = [f[0] for f in FD]
        K = [f[1] for f in FD]  # D2: the FD terms carry −k
        scales = [-k, -k]
        bc_idx = np.array([np.where(xs[0] == 0)[0], np.where(xs[0] == lx)[0]]).flatten()
        fd_bc, MM = (0, bc_idx), M
    terms = [[K[0], M[1], M[2], M[3]], [M[0], K[1], M[2], M[3]]]
    load = [[M[d] @ src[d].array for d in range(4)]]
    lhs, rhs = separated_callbacks(P, "rstu", terms, scales, lifts=[lift], fd_bc=fd_bc)

    def create_bc(Vs, dom, param):
        cond = P.DirichletBC(Vs[0], 0, lambda x, on_b: on_b and (
            abs(x) < 1e-6 or abs(x - lx) < 1e-6))
        return [cond, 0, 0, 0]

    prob = P.PGDProblem(
        name="test_x_y_q_u00", name_coord=["X", "Y", "q", "u0"],
        modes_info=["T", "Node", "Scalar"], Vs=vs, dom=0, bc_fct=create_bc, load=load,
        param={}, rhs_fct=rhs, lhs_fct=lhs, probs=["r", "s", "t", "u"],
        seq_fp=list(range(4)), PGD_nmax=nmax)
    if MM is not None:
        prob.MM = MM
    _knobs(prob)
    prob.solve_PGD(_problem="linear", solve_modes=[variant] * 4)
    return prob, lift


@pytest.mark.parametrize("variant", ["FEM", "FD"])
def test_laplace(variant):
    (pj, lj), (pt, lt) = laplace(JAXP, variant), laplace(PORT, variant)
    same_solve(pj, pt)
    # the homogenised problem is rank 1: both stop after one mode
    # (reference test_laplace.py:970-971)
    assert pj.PGD_modes == pt.PGD_modes == 1
    sj, st = pj.return_PGD(), pt.return_PGD()
    rng = np.random.default_rng(42)
    for _ in range(4):
        v = [r[0] + rng.random() * (r[1] - r[0]) for r in LAPLACE_RANGES[1:]]
        uj = sj.evaluate(0, [1, 2, 3], v, 0).compute_vertex_values()
        ut = st.evaluate(0, [1, 2, 3], v, 0).compute_vertex_values()
        close(ut, uj)
        # the lift is added outside (test_laplace.py:986-1010)
        lift_t = lt[0].compute_vertex_values() * lt[1](v[0]) * lt[2](v[1]) * lt[3](v[2])
        lift_j = lj[0].compute_vertex_values() * lj[1](v[0]) * lj[2](v[1]) * lj[3](v[2])
        close(ut + lift_t, uj + lift_j)


# --------------------------------------------------------- test_laplace_fastpath

def test_laplace_fastpath():
    """test_laplace_fastpath.py at its own reduced widths: the port's
    PGDProblem FD amplitudes against the port's SeparatedPGD in f64 (1e-8),
    and against the JAX package's PGDProblem (1e-12)."""
    elem = (30, 20, 50, 30)
    pj, _ = laplace(JAXP, "FD", elem=elem, nmax=7)
    pt, _ = laplace(PORT, "FD", elem=elem, nmax=7)
    same_solve(pj, pt)

    P, k = PORT, 0.5
    vs = _spaces(P, elem, [1] * 4, LAPLACE_RANGES)
    xs = [v.tabulate_dof_coordinates()[:, 0] for v in vs]
    (M_x, D2_x, _), (M_y, D2_y, _) = P.FD_matrices(xs[0]), P.FD_matrices(xs[1])
    M_q, M_u = P.FD_matrices(xs[2])[0], P.FD_matrices(xs[3])[0]
    BC_x = P.interpolate(lambda x: 1.0 - x / 3.0, vs[0]).array
    qx = P.interpolate(lambda x: np.where(x < 1.5, 1.0, 0.0), vs[0]).array
    ones = [np.ones(len(x)) for x in xs]
    sep = P.SeparatedProblem(
        ops=[np.stack([-k * D2_x, -k * M_x]), np.stack([M_y, D2_y]),
             np.stack([M_q, M_q]), np.stack([M_u, M_u])],
        rhs=[np.stack([M_x @ qx, k * (D2_x @ BC_x), k * (M_x @ BC_x)]),
             np.stack([M_y @ ones[1], M_y @ ones[1], D2_y @ ones[1]]),
             np.stack([M_q @ xs[2], M_q @ ones[2], M_q @ ones[2]]),
             np.stack([M_u @ ones[3], M_u @ xs[3], M_u @ xs[3]])],
        mass=[M_x, M_y, M_q, M_u],
        bc_dofs=[np.array([np.where(xs[0] == 0)[0][0], np.where(xs[0] == 3.0)[0][0]])]
        + [np.array([], dtype=np.int64)] * 3,
    )
    res = P.SeparatedPGD(sep, n_max=7, tol=1e-10, tol_fp=1e-5, dtype=np.float64,
                         device="cpu").solve()
    n = min(len(pt.amplitude), len(res.amplitudes))
    np.testing.assert_allclose(res.amplitudes[:n], pt.amplitude[:n], rtol=FASTPATH)
    assert res.n_modes == 1 or res.amplitudes[1] < 1e-8


# ------------------------------------------------------------------ test_elastic

TRUSS_RANGES = [[0, 1], [-1.0, 3.0], [0.2, 2.0]]


def truss(P, elems=(20, 2, 16), problem="linear", solve_modes=None, residual_form=False,
          direct=(), nmax=5, lumped_E=False, **knobs):
    """The 1D truss u(x, p, E) of test_elastic.py, P2 in every coordinate
    (``lumped_E``: a diagonal E operator, for a 'direct' E dim)."""
    vs = _spaces(P, elems, [2] * 3, TRUSS_RANGES, family="P")
    K_x = P.stiffness_matrix(vs[0])
    M_p = P.mass_matrix(vs[1])
    M_E_w = P.mass_matrix(vs[2], weight=lambda E: E)
    if lumped_E:
        M_E_w = np.diag(M_E_w.sum(axis=1))
    load = [[P.load_vector(vs[0], lambda x: np.ones_like(x)),
             P.load_vector(vs[1], lambda p: p),
             P.load_vector(vs[2], lambda E: np.ones_like(E))]]
    lhs, rhs = separated_callbacks(P, "rst", [[K_x, M_p, M_E_w]], [1.0], direct=direct,
                                   residual_form=residual_form)

    def create_bc(Vs, dom, param):
        return [[P.DirichletBC(Vs[0], 0.0, lambda x: x < 1e-5),
                 P.DirichletBC(Vs[0], 0.0, lambda x: x > 1.0 - 1e-5)], 0, 0]

    prob = P.PGDProblem(
        name="Uniaxial1D-PGD-XPE", name_coord=["X", "P", "E"],
        modes_info=["U_x", "Node", "Scalar"], Vs=vs, dom=0, bc_fct=create_bc, load=load,
        param={}, rhs_fct=rhs, lhs_fct=lhs, probs=["r", "s", "t"],
        seq_fp=knobs.pop("seq_fp", [0, 1, 2]), PGD_nmax=nmax, seed=knobs.pop("seed", None))
    _knobs(prob, **knobs)
    prob.solve_PGD(_problem=problem, solve_modes=solve_modes)
    return prob


class FOM:
    """The truss's analytic solution u = p/(2E)·(x − x²)."""

    def __init__(self, x):
        self.x = x

    def __call__(self, data):
        return data[0] / (2 * data[1]) * (self.x - self.x * self.x)


def test_elastic():
    pj, pt = truss(JAXP), truss(PORT)
    same_solve(pj, pt)
    sj, st = pj.return_PGD(), pt.return_PGD()
    x = st.mesh[0].fenics_mesh.coordinates()[:, 0]
    # sampled errors vs the analytic FOM, Latin hypercube seeded 3452
    ej = JAXP.PGDErrorComputation(fixed_dim=[0], n_samples=10, FOM_model=FOM(x),
                                  PGD_model=sj).evaluate_error()
    et = PORT.PGDErrorComputation(fixed_dim=[0], n_samples=10, FOM_model=FOM(x),
                                  PGD_model=st).evaluate_error()
    close(et[0], ej[0])
    assert et[1] < 1e-2
    # the point error at x = 0.5 (test_elastic.py's second check)
    data = [[2.0, 1.5], [1.0, 1.0]]
    pj_, pt_ = (P.PGDErrorComputation(fixed_dim=[0], FOM_model=FOM(np.array([0.5])),
                                      PGD_model=s, data_test=data, fixed_var=[0.5])
                for P, s in ((JAXP, sj), (PORT, st)))
    close(pt_.evaluate_error()[0], pj_.evaluate_error()[0])
    # sensors, derivatives and reducers of the solved model
    pts = np.array([0.1, 0.37, 0.5, 0.93])
    coord = [1.3, 0.7]
    close(st.evaluate_sensor_response(0, [1, 2], coord, 0, pts),
          sj.evaluate_sensor_response(0, [1, 2], coord, 0, pts))
    for d_dim in (2, 0):
        close(st.evaluate_derivative(0, [1, 2], coord, 0, d_dim).array,
              sj.evaluate_derivative(0, [1, 2], coord, 0, d_dim).array)
        close(st.evaluate_derivative_sensor_response(0, [1, 2], coord, 0, d_dim, pts),
              sj.evaluate_derivative_sensor_response(0, [1, 2], coord, 0, d_dim, pts))
    for red in ("evaluate_max", "evaluate_min", "evaluate_max_abs", "evaluate_min_abs"):
        close(getattr(st, red)(0, [1, 2], coord, 0), getattr(sj, red)(0, [1, 2], coord, 0))


@pytest.mark.parametrize("knobs", [
    dict(stop_fp="delta"),
    dict(norm_modes="l2"),
    dict(norm_modes="no"),
    dict(fp_init="randomized", seed=1234),
    dict(seq_fp=[2, 0, 1], max_fp_it=3),
], ids=["delta", "l2", "no", "randomized", "seq_fp"])
def test_solver_options(knobs):
    """The fixed point's stops, the three normalisations, a randomized start
    (the port's own RandomState against the JAX package's draws from numpy's
    global generator, seeded alike) and a custom sweep order, on the FEM
    heating problem (several modes)."""
    if knobs.get("fp_init") == "randomized":
        np.random.seed(knobs["seed"])
    pj, _ = heat1d(JAXP, "FEM", "heating", **knobs)
    pt, _ = heat1d(PORT, "FEM", "heating", **knobs)
    assert pt.PGD_modes > 1
    same_solve(pj, pt)


def test_direct_dim():
    """The E coordinate solved elementwise ('direct') on a lumped operator."""
    kw = dict(solve_modes=["FEM", "FEM", "direct"], direct=(2,), lumped_E=True)
    same_solve(truss(JAXP, **kw), truss(PORT, **kw))


def test_newton_residual_form():
    """Residual-form callbacks on the nonlinear path: Newton per dim (FD
    Jacobian), against the JAX package and against the linear solve."""
    kw = dict(elems=(8, 2, 6), problem="nonlinear", residual_form=True, nmax=2)
    pj, pt = truss(JAXP, **kw), truss(PORT, **kw)
    same_solve(pj, pt)
    lin = truss(PORT, elems=(8, 2, 6), nmax=2)
    np.testing.assert_allclose(pt.amplitude, lin.amplitude, rtol=1e-6)


def test_resume():
    """``solve_PGD(resume=True)`` continues from the modes it has: two
    modes, then two more, equal to four in one go."""
    runs = []
    for P in (JAXP, PORT):
        p, _ = heat1d(P, "FEM", "heating", nmax=2)
        p.PGD_nmax = 4
        p.solve_PGD(_problem="linear", solve_modes=["FEM"] * 3, resume=True)
        runs.append(p)
    same_solve(*runs)
    whole, _ = heat1d(PORT, "FEM", "heating", nmax=4)
    assert runs[1].PGD_modes == whole.PGD_modes == 4
    for d in range(3):
        for a, b in zip(runs[1].PGD_func[d], whole.PGD_func[d]):
            close(a.array, b.array)


# ------------------------------------------------------------------- test_heat1d

HEAT = {"rho": 1, "cp": 1, "k": 0.5, "Tamb": 25, "Q": 1, "af": 0.2, "ar": 0.2,
        "xc": 0.5}
HEAT_RANGES = [[0.0, 1.0], [0.0, 1.0], [0.5, 1.0]]
# test_heat1d_dimless.py: steel-like data scaled by x0, t0 and T0
DIMLESS = {"rho": 7100, "cp": 3100, "k": 100, "Q": 100, "Tamb": 25, "af": 0.002,
           "ar": 0.002, "xc": 0.05}
X0, T_0, TEMP0 = 0.1, 10.0, 500.0
DIMLESS_SCALE = {"a1": TEMP0 / T_0, "a2": TEMP0 / X0 ** 2, "b": 1.0, "x0": X0,
                 "T0": TEMP0, "ranges": [[0.0, 0.1 / X0], [0.0, 10 / T_0], [0.5, 1.0]]}


def heat1d(P, variant, case, elems=(15, 10, 10), nmax=5, p=HEAT, scale=None,
           seq_fp=(0, 1, 2), seed=None, **knobs):
    """1D transient heat X⊗T⊗Q (test_heat1d.py): FEM in time or FD-upwind
    time, a Goldak heating source or a cooling initial field; with
    ``scale`` the dimensionless equation a1·ρcp·∂T/∂t − a2·k·∂²T/∂x² = b·Q
    of test_heat1d_dimless.py."""
    sc = scale or {"a1": 1.0, "a2": 1.0, "b": 1.0, "x0": 1.0, "T0": 1.0,
                   "ranges": HEAT_RANGES}
    vs = _spaces(P, elems, [1] * 3, sc["ranges"])
    if case == "heating":
        ff = 6 * np.sqrt(3) / ((p["af"] + p["ar"]) * p["af"] ** 2 * np.pi ** 1.5)
        q = lambda x: ff * np.exp(-3 * (x * sc["x0"] - p["xc"]) ** 2  # noqa: E731
                                  / p["af"] ** 2)
        ic = [lambda x: np.ones_like(x), lambda t: p["Tamb"] / sc["T0"] * np.ones_like(t),
              lambda qq: np.ones_like(qq)]
    else:
        vf_a = 6 * np.sqrt(3) / (2 * p["af"] ** 3 * np.pi ** 1.5)
        q = lambda x: np.zeros_like(x)  # noqa: E731
        ic = [lambda x: vf_a * np.exp(-3 * (x - p["xc"]) ** 2 / p["af"] ** 2),
              lambda t: np.ones_like(t), lambda qq: qq]
    IC = [P.interpolate(f, v) for f, v in zip(ic, vs)]
    Q = [P.interpolate(q, vs[0]), P.interpolate(lambda t: np.ones_like(t), vs[1]),
         P.interpolate(lambda qq: qq * p["Q"], vs[2])]
    M_x, K_x, M_q = P.mass_matrix(vs[0]), P.stiffness_matrix(vs[0]), P.mass_matrix(vs[2])
    c1, c2 = sc["a1"] * p["rho"] * p["cp"], sc["a2"] * p["k"]
    fd_bc, MM = None, None
    if variant == "FEM":
        M_t, A_t = P.mass_matrix(vs[1]), P.advection_matrix(vs[1])
        modes = ["FEM", "FEM", "FEM"]
    else:
        t = vs[1].tabulate_dof_coordinates()[:, 0]
        M_t, _, A_t = P.FD_matrices(t)
        fd_bc, MM = (1, np.where(t == 0)[0]), [0, M_t, 0]
        modes = ["FEM", "FD", "FEM"]
    terms = [[M_x, A_t, M_q], [K_x, M_t, M_q]]
    load = [[sc["b"] * (M_x @ Q[0].array), M_t @ Q[1].array, M_q @ Q[2].array]]
    lhs, rhs = separated_callbacks(P, "rsw", terms, [c1, c2], lifts=[IC], fd_bc=fd_bc)

    def create_bc(Vs, dom, param):
        return [0, P.DirichletBC(Vs[1], 0, lambda t: t < 0.0 + 1e-5), 0]

    prob = P.PGDProblem(
        name="1DHeatEqu-PGD-XTQ", name_coord=["X", "T", "Q"],
        modes_info=["T", "Node", "Scalar"], Vs=vs, dom=0, bc_fct=create_bc, load=load,
        param={}, rhs_fct=rhs, lhs_fct=lhs, probs=["r", "s", "w"], seq_fp=list(seq_fp),
        PGD_nmax=nmax, seed=seed)
    if MM is not None:
        prob.MM = MM
    _knobs(prob, PGD_tol=1e-5 if scale is None else 1e-9, **knobs)
    prob.solve_PGD(_problem="linear", solve_modes=modes)
    return prob, IC


def _heat_views(prob, IC, t_fixed, x_fixed, q_fixed=1.0):
    """The space field at t_fixed and the time history at x_fixed, lifts
    added (test_heat1d.py)."""
    s = prob.return_PGD()
    u_x = s.evaluate(0, [1, 2], [t_fixed, q_fixed], 0).compute_vertex_values() + (
        IC[0].compute_vertex_values() * IC[1](t_fixed) * IC[2](q_fixed))
    u_t = s.evaluate(1, [0, 2], [x_fixed, q_fixed], 0).compute_vertex_values() + (
        IC[0](x_fixed) * IC[1].compute_vertex_values() * IC[2](q_fixed))
    return u_x, u_t


@pytest.mark.parametrize("variant,case", [("FEM", "heating"), ("FDtime", "heating"),
                                          ("FDtime", "cooling")])
def test_heat1d(variant, case):
    (pj, ij), (pt, it) = heat1d(JAXP, variant, case), heat1d(PORT, variant, case)
    same_solve(pj, pt)
    for a, b in zip(_heat_views(pt, it, 0.9, 0.5), _heat_views(pj, ij, 0.9, 0.5)):
        close(a, b)


def test_heat1d_dimless():
    """test_heat1d_dimless.py's scaled equation at 40 × 20 × 10 elements
    (the test's own: 500 × 100 × 10)."""
    kw = dict(elems=(40, 20, 10), p=DIMLESS, scale=DIMLESS_SCALE)
    (pj, ij), (pt, it) = (heat1d(P, "FDtime", "heating", **kw) for P in (JAXP, PORT))
    same_solve(pj, pt)
    for a, b in zip(_heat_views(pt, it, 0.9, 0.5), _heat_views(pj, ij, 0.9, 0.5)):
        close(a, b)


# ------------------------------------------------- pgd_problem_from_separated

def test_bridge_poisson_xy():
    """``poisson_xy`` through ``pgd_problem_from_separated`` in both
    packages, and the bridge against the device solver in f64."""
    probs = []
    for P in (JAXP, PORT):
        sep, Vs = P.poisson_xy(n_x=16, n_y=12)
        prob = P.pgd_problem_from_separated(sep, Vs)
        prob.PGD_nmax = 4
        prob.solve_PGD(_problem="linear")
        probs.append(prob)
    same_solve(*probs)
    res = PORT.SeparatedPGD(sep, n_max=4, tol=1e-10, tol_fp=1e-5, dtype=np.float64,
                            device="cpu").solve()
    n = min(probs[1].PGD_modes, res.n_modes)
    big = np.asarray(probs[1].amplitude[:n]) > 1e-8
    np.testing.assert_allclose(np.asarray(res.amplitudes[:n])[big],
                               np.asarray(probs[1].amplitude[:n])[big], rtol=FASTPATH)


@pytest.mark.parametrize("kind", ["tridiagonal", "zero_pivot", "wide"])
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_fd_solve(kind, sparse):
    """``FD_solve``: tridiagonal systems through the Thomas solve (sparse
    ones read off their three diagonals), a zero leading pivot through the
    pivoted LU, a wider band through the dense LU — equal across packages
    and to ``np.linalg.solve``."""
    from scipy import sparse as sps

    n = 9
    rng = np.random.default_rng(5)
    A = np.diag(4.0 + rng.random(n)) + np.diag(rng.random(n - 1), 1) + np.diag(
        rng.random(n - 1), -1)
    if kind == "zero_pivot":
        A[0, 0] = 0.0
    elif kind == "wide":
        A += np.diag(rng.random(n - 2), 2)
    b = rng.normal(size=n)
    xs = []
    for P in (JAXP, PORT):
        prob = P.PGDProblem(name_coord=["X"], Vs=_spaces(P, [n - 1], [1], [[0.0, 1.0]]))
        with np.errstate(divide="ignore", invalid="ignore"):  # the failed Thomas pass
            xs.append(prob.FD_solve(sps.coo_matrix(A) if sparse else A, b, 0).array)
    close(xs[1], xs[0])
    close(xs[1], np.linalg.solve(A, b), 1e-10)


@pytest.mark.parametrize("builder,kw", [
    ("elastic_truss", dict(n_x=9, n_p=2, n_E=5)),
    ("poisson_xy", dict(n_x=10, n_y=7, k=0.5)),
])
def test_builders(builder, kw):
    """The truss and 2D Poisson builders equal the JAX package's (the same
    numpy FEM code)."""
    (sj, Vj), (st, Vt) = (getattr(P, builder)(**kw) for P in (JAXP, PORT))
    for attr in ("ops", "rhs", "mass"):
        for a, b in zip(getattr(st, attr), getattr(sj, attr)):
            close(a, np.asarray(b), 1e-13)
    for a, b in zip(st.bc_dofs, sj.bc_dofs):
        np.testing.assert_array_equal(a, b)
    assert [V.dim() for V in Vt] == [V.dim() for V in Vj]
