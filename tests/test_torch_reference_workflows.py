"""The port's reference-parity layer against the JAX package's on the
workflows of ``tests/integration`` beyond the interval ones, on the CPU at
reduced widths: test_solver_problem and test_solver_problem_refscale (2D
plane-strain elasticity u((x, y), p, E, ν), vector P2 on a crossed mesh,
the linear and the nonlinear solve paths, ``PGDErrorComputation`` against a
full FEM), test_elliptic3d (a 3D-space vademecum through ``pgd_from_result``
and the HDF5 checkpoint) and test_unstructured_pgd (the foreign triangle
mesh fixture, a PGD solved on it); and ``Vademecum.to_pgd`` /
``TransientVademecum.to_pgd`` against the JAX package's bridge on the same
state.  The callbacks are written once (``separated_callbacks``) and run
through both packages; everything host f64 agrees to 1e-12 relative.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

from tests.test_torch_reference_solver import (
    JAXP,
    PORT,
    close,
    same_solve,
    separated_callbacks,
)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "unstructured_tri",
                       "Unstr_data.h5")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite's workers share a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------- test_solver_problem

L = [1000.0, 100.0]
NU1 = lambda nu: 1.0 / (2.0 * (1.0 + nu) * (1.0 - 2.0 * nu))  # noqa: E731
NU2 = lambda nu: 1.0 / (2.0 * (1.0 + nu))  # noqa: E731
C1 = np.array([[1.0, 1.0, 0.0], [1.0, 1.0, 0.0], [0.0, 0.0, 0.0]])
C2 = np.array([[1.0, -1.0, 0.0], [-1.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
E_0 = 30000.0
ELAS_RANGES = [[0.0, 2.0], [0.5, 1.5], [0.1, 0.4]]  # p, E, nu


def create_dom(Vs, param):
    """Facet-midpoint markers of the X mesh: 2 = the top's left half, 3 =
    its right half (test_solver_problem.py)."""
    return [{2: lambda m: abs(m[1] - L[1]) < 1e-9 and m[0] < 0.5 * L[0],
             3: lambda m: abs(m[1] - L[1]) < 1e-9 and m[0] > 0.5 * L[0]}, 0, 0, 0]


def _tractions(P):
    return (P.Expression((lambda p: 0.0 * p[..., 0], lambda p: -0.5 * np.ones_like(p[..., 0]))),
            P.Expression((lambda p: 0.0 * p[..., 0], lambda p: -1.5 * np.ones_like(p[..., 0]))))


def elasticity(P, mesh_x, elems=(2, 8, 8), problem="linear", settings=None, nmax=4):
    """The plane-strain PGD u((x, y), p, E, ν) of test_solver_problem.py on
    a crossed ``mesh_x`` (vector P2) and P1 parameter intervals."""
    Vx = P.VectorFunctionSpace(P.RectangleMesh(P.Point(0.0, 0.0), P.Point(*L), *mesh_x,
                                               "crossed"), "P", 2)
    vs = [Vx] + [P.FunctionSpace(P.IntervalMesh(ne, *r), "P", 1)
                 for ne, r in zip(elems, ELAS_RANGES)]
    K1 = P.elasticity_matrix(Vx, C1, sparse=True)
    K2 = P.elasticity_matrix(Vx, C2, sparse=True)
    M_p = P.mass_matrix(vs[1])
    M_E_w = P.mass_matrix(vs[2], weight=lambda E: E)
    terms = [[K1, M_p, M_E_w, P.mass_matrix(vs[3], weight=NU1)],
             [K2, M_p, M_E_w, P.mass_matrix(vs[3], weight=NU2)]]
    markers = create_dom(vs, {})[0]
    rest = [P.load_vector(vs[1], lambda p: p), P.load_vector(vs[2], lambda E: np.ones_like(E)),
            P.load_vector(vs[3], lambda n: np.ones_like(n))]
    load = [[P.boundary_load_vector(Vx, g, markers[m])] + rest
            for g, m in zip(_tractions(P), (2, 3))]
    lhs, rhs = separated_callbacks(P, "rstv", terms, [E_0, E_0])

    def create_bc(Vs, dom, param):
        return [[P.DirichletBC(Vs[0], (0.0, 0.0), lambda p: abs(p[0]) < 1e-9)], 0, 0, 0]

    prob = P.PGDProblem(
        name="PGD_xpEv", name_coord=["X", "P", "E", "nu"], modes_info=["U", "Node", "Vector"],
        Vs=vs, bc_fct=create_bc, load=load, param={}, dom_fct=create_dom, rhs_fct=rhs,
        lhs_fct=lhs, probs=["r", "s", "t", "v"], seq_fp=[0, 1, 2, 3], PGD_nmax=nmax)
    prob.max_fp_it = 50
    prob.stop_fp = "norm"
    prob.tol_fp_it = 1e-4
    prob.norm_modes = "stiff"
    prob.solve_PGD(_problem=problem, settings=settings or {})
    return prob, prob.return_PGD()


class FEMReference:
    """The full 2D elasticity solve at (p, E, ν) (test_solver_problem.py),
    its vertex values or the values at ``x_values``."""

    def __init__(self, P, Vx, x_values=()):
        self.P, self.Vx, self.x_values = P, Vx, list(x_values)
        self.K1 = P.elasticity_matrix(Vx, C1, sparse=True)
        self.K2 = P.elasticity_matrix(Vx, C2, sparse=True)
        markers = create_dom([Vx], {})[0]
        g1, g2 = _tractions(P)
        self.b = P.boundary_load_vector(Vx, g1, markers[2]) + P.boundary_load_vector(
            Vx, g2, markers[3])
        self.bc = P.DirichletBC(Vx, (0.0, 0.0), lambda p: abs(p[0]) < 1e-9)

    def __call__(self, values):
        from scipy.sparse import linalg as spla

        lam_p, lam_E, nu = values
        A = lam_E * E_0 * (NU1(nu) * self.K1 + NU2(nu) * self.K2)
        A, b = self.bc.apply_system(A, lam_p * self.b)
        uf = self.P.Function(self.Vx, spla.spsolve(A.tocsr(), b))
        if self.x_values:
            return np.stack([np.asarray(uf(np.asarray(x))) for x in self.x_values])
        return uf


@pytest.mark.parametrize("mesh_x", [(6, 2), (10, 2)], ids=["solver_problem", "refscale"])
def test_solver_problem(mesh_x):
    """Both packages, the linear and the nonlinear (Picard) paths: the
    traces and modes to 1e-12, linear against nonlinear under 1e-8
    (test_solver_problem.py:752), and ``PGDErrorComputation`` — a given
    sample, a point-restricted one and 10 Latin-hypercube samples — to
    1e-12, the given and the point-restricted samples equal to the manual
    errors to 8 decimals."""
    (lj, sj), (lt, st) = (elasticity(P, mesh_x) for P in (JAXP, PORT))
    same_solve(lj, lt)
    kw = dict(problem="nonlinear", settings={"relative_tolerance": 1e-8})
    (nj, _), (nt, _) = (elasticity(P, mesh_x, **kw) for P in (JAXP, PORT))
    same_solve(nj, nt)
    assert np.max(np.array(lt.amplitude) - np.array(nt.amplitude)) < 1e-8

    sample, x = [1.5, 0.75, 0.2], (L[0] / 2, L[1] / 2)
    errs = {}
    for P, s in ((JAXP, sj), (PORT, st)):
        ref = FEMReference(P, s.mesh[0].attributes[0].interpolationfct[0].function_space())
        u_pgd, u_ref = s.evaluate(0, [1, 2, 3], sample, 0), ref(sample)
        # two Functions are compared on their dofs
        manual = np.linalg.norm(u_pgd.array - u_ref.array) / np.linalg.norm(u_ref.array)
        e1 = P.PGDErrorComputation(fixed_dim=[0], data_test=[sample], FOM_model=ref,
                                   PGD_model=s)
        one = e1.evaluate_error()
        assert abs(one[2] - manual) < 1e-8
        ref.x_values = [x]
        e1.fixed_var = [x]
        point = e1.evaluate_error()
        ref.x_values = []
        u_x = np.asarray(u_pgd(np.asarray(x)))
        r_x = np.asarray(FEMReference(P, ref.Vx, [x])(sample))
        assert abs(point[2] - np.linalg.norm(u_x - r_x.ravel()) / np.linalg.norm(r_x)) < 1e-8
        lhs_samples = P.PGDErrorComputation(fixed_dim=[0], n_samples=10, FOM_model=ref,
                                            PGD_model=s).evaluate_error()
        errs[P.root] = (u_pgd.array, one[0], point[0], lhs_samples[0])
    for a, b in zip(errs["pgdrome_tpu_torch"], errs["pgdrome_tpu"]):
        close(a, b)


# ------------------------------------------------------------- test_elliptic3d

def _as_jax(res):
    """The port's PGDResult as the JAX package's, on host arrays."""
    return JAXP.PGDResult(modes=[m.numpy() for m in res.modes], n_modes=res.n_modes,
                          amplitudes=res.amplitudes, alpha=res.alpha, fp_its=res.fp_its,
                          normU0=res.normU0)


def _manual(Vs, res, sample):
    """The reconstruction at ``sample`` by hand: f64 factor products of the
    1D modes (numpy point evaluation) times the dim-0 modes."""
    from pgdrome_tpu_torch.fem.interpolate import eval_dofs_at_points
    from pgdrome_tpu_torch.separated import host_f64

    K = res.n_modes
    fac = np.ones(K)
    for j, p in enumerate(sample):
        m = host_f64(res.modes[1 + j])[:K]
        fac *= np.array([float(eval_dofs_at_points(Vs[1 + j], m[k], np.array([p]))[0])
                         for k in range(K)])
    return fac @ host_f64(res.modes[0])[:K]


@pytest.mark.parametrize("degree_x,n", [(1, 3), (2, 2)], ids=["P1", "P2"])
def test_elliptic3d(degree_x, n):
    """A 3D-space vademecum solved by the port's SeparatedPGD in f64 on the
    CPU, brought into both packages' PGD containers (evaluate to 1e-12 and
    against the reconstruction by hand), and its checkpoint written by each
    package and read by the other (BoxMesh, degree, modes and point values
    equal)."""
    from pgdrome_tpu_torch.fem.interpolate import eval_dofs_at_points as t_eval
    from pgdrome_tpu.fem.interpolate import eval_dofs_at_points as j_eval

    sep, Vs = PORT.parametric_elliptic_3d(n=n, n_p=8, num_params=2, degree_x=degree_x)
    res = PORT.SeparatedPGD(sep, n_max=5, tol=1e-12, tol_fp=1e-6, dtype=np.float64,
                            device="cpu").solve()
    _, Vj = JAXP.parametric_elliptic_3d(n=n, n_p=8, num_params=2, degree_x=degree_x)
    host = [m.numpy() for m in res.modes]
    pj = JAXP.pgd_from_result(_as_jax(res), Vj, name="heat3d")
    pt = PORT.pgd_from_result(res, Vs, name="heat3d")
    sample = [0.5, 0.3]
    ut = pt.evaluate(0, [1, 2], sample, 0).array
    close(ut, pj.evaluate(0, [1, 2], sample, 0).array)
    close(ut, _manual(Vs, res, sample))
    pts = np.array([[0.31, 0.42, 0.53]])
    for written, reader, ev in ((pt, JAXP, j_eval), (pj, PORT, t_eval)):
        with tempfile.TemporaryDirectory() as td:
            written.write_hdf5(td)
            Vr, fcts = reader.io.read_modes_hdf5(os.path.join(td, "PGD1_data.h5"))
            assert type(Vr.mesh()).__name__ == "BoxMesh" and Vr.degree == degree_x
            assert Vr.dim() == Vs[0].dim() and len(fcts) == res.n_modes
            close(fcts[1].array, host[0][1])
            close(ev(Vr, fcts[1].array, pts), t_eval(Vs[0], host[0][1], pts))


# -------------------------------------------------------- test_unstructured_pgd

def _foreign_problem(P, V):
    """test_unstructured_pgd.py's parametric diffusion on the loaded mesh
    (lumped parameter operators), in package ``P``."""
    Vp = P.FunctionSpace(P.IntervalMesh(8, 0.0, 1.0), "P", 1)

    def w(pts):
        return np.sin(np.pi * pts[..., 0]) ** 2 * np.sin(np.pi * pts[..., 1]) ** 2 / 2.0

    Mp = P.mass_matrix(Vp)
    sep = P.SeparatedProblem(
        ops=[np.stack([P.stiffness_matrix(V), P.stiffness_matrix(V, weight=w)]),
             np.stack([np.diag(Mp.sum(axis=1)),
                       np.diag(P.mass_matrix(Vp, weight=lambda p: p).sum(axis=1))])],
        rhs=[P.load_vector(V, lambda x: np.ones(x.shape[:-1]))[None, :],
             P.load_vector(Vp, lambda p: np.ones_like(p))[None, :]],
        mass=[P.mass_matrix(V), Mp],
        bc_dofs=[P.DirichletBC(V, 0.0).dofs, np.array([], dtype=np.int64)],
    )
    return sep, [V, Vp]


def test_unstructured_pgd():
    """The foreign fixture read by both packages (the same SimplicialMesh
    and modes), then the PGD on it: ``pgd_problem_from_separated`` in both
    packages (1e-12), the port's SeparatedPGD in f64 against the port's
    host solve (amplitudes above 1e-8 to 1e-8), and both PGD containers of
    the device result (evaluate and point sensors to 1e-12)."""
    (Vj, fj), (Vt, ft) = JAXP.io.read_modes_hdf5(FIXTURE), PORT.io.read_modes_hdf5(FIXTURE)
    assert type(Vt.mesh()).__name__ == "SimplicialMesh"
    assert Vt.mesh().num_vertices() == 58 and Vt.mesh().num_cells() == 90 and len(ft) == 2
    np.testing.assert_array_equal(Vt.mesh().coordinates(), Vj.mesh().coordinates())
    np.testing.assert_array_equal(Vt.mesh().cells(), Vj.mesh().cells())
    for a, b in zip(ft, fj):
        np.testing.assert_array_equal(a.array, b.array)

    probs = []
    for P, V in ((JAXP, Vj), (PORT, Vt)):
        sep, Vs = _foreign_problem(P, V)
        prob = P.pgd_problem_from_separated(sep, Vs, name="foreign")
        prob.PGD_nmax = 4
        prob.tol_fp_it = 1e-7
        prob.solve_PGD(_problem="linear")
        probs.append((prob, sep, Vs))
    same_solve(probs[0][0], probs[1][0])

    prob_t, sep_t, Vs_t = probs[1]
    res = PORT.SeparatedPGD(sep_t, n_max=4, tol=1e-12, tol_fp=1e-7, dtype=np.float64,
                            device="cpu").solve()
    n = min(prob_t.PGD_modes, res.n_modes)
    big = np.asarray(prob_t.amplitude[:n]) > 1e-8
    np.testing.assert_allclose(np.asarray(res.amplitudes[:n])[big],
                               np.asarray(prob_t.amplitude[:n])[big], rtol=1e-8)
    pj = JAXP.pgd_from_result(_as_jax(res), probs[0][2])
    pt = PORT.pgd_from_result(res, Vs_t)
    for p in (0.25, 0.75):
        close(pt.evaluate(0, [1], [p], 0).array, pj.evaluate(0, [1], [p], 0).array)
        close(pt.evaluate(0, [1], [p], 0).array, _manual(Vs_t, res, [p]))
        sens = np.array([[0.5, 0.5], [0.3, 0.7]])
        close(pt.evaluate_sensor_response(0, [1], [p], 0, sens),
              pj.evaluate_sensor_response(0, [1], [p], 0, sens))


# ------------------------------------------------------------------- to_pgd

def _random_result(P, sizes, K, seed):
    rng = np.random.default_rng(seed)
    return P.PGDResult(modes=[rng.standard_normal((K + 2, n)) for n in sizes], n_modes=K,
                       amplitudes=np.geomspace(1.0, 1e-6, K), alpha=rng.random(K),
                       fp_its=np.full(K, 3), normU0=2.5)


def _pgds_equal(pt, pj, coord, free, fixed=0, pts=None):
    assert pt.numModes == pj.numModes and len(pt.mesh) == len(pj.mesh)
    for mt, mj in zip(pt.mesh, pj.mesh):
        for ft, fj in zip(mt.attributes[0].interpolationfct, mj.attributes[0].interpolationfct):
            np.testing.assert_array_equal(ft.array, fj.array)
    close(pt.evaluate(fixed, free, coord, 0).array, pj.evaluate(fixed, free, coord, 0).array)
    if pts is not None:
        close(pt.evaluate_sensor_response(fixed, free, coord, 0, pts),
              pj.evaluate_sensor_response(fixed, free, coord, 0, pts))


def test_vademecum_to_pgd():
    """``Vademecum.to_pgd`` on the same f64 state as the JAX package's, with
    an energy-basis dim 0 (the transform is applied once, by the
    vademecum): the modes equal, evaluate and sensors to 1e-12, and the
    evaluation against the vademecum's own plain sweep."""
    import pgdrome_tpu.serving as JS
    from pgdrome_tpu_torch.serving import Vademecum

    sep_t, Vs_t = PORT.elastic_truss(n_x=12, n_p=2, n_E=6)
    sep_j, Vs_j = JAXP.elastic_truss(n_x=12, n_p=2, n_E=6)
    _, tf_t = PORT.precondition_dim0(sep_t, dtype=np.float64)
    _, tf_j = JAXP.precondition_dim0(sep_j, dtype=np.float64)
    sizes = [len(tf_t.interior)] + [V.dim() for V in Vs_t[1:]]
    res_t, res_j = _random_result(PORT, sizes, 4, 7), _random_result(JAXP, sizes, 4, 7)
    vt = Vademecum(Vs_t, res_t, dim0_transform=tf_t, dtype=torch.float64, device="cpu",
                   method="torch")
    vj = JS.Vademecum(Vs_j, res_j, dim0_transform=tf_j, dtype=np.float64)
    pt, pj = vt.to_pgd(name_coord=["X", "P", "E"]), vj.to_pgd(name_coord=["X", "P", "E"])
    coord = [1.1, 0.9]
    _pgds_equal(pt, pj, coord, [1, 2], pts=np.array([0.2, 0.5, 0.8]))
    served = vt.fields(np.array([coord])).numpy()[0]
    close(pt.evaluate(0, [1, 2], coord, 0).array, served)


def test_transient_vademecum_to_pgd():
    """``TransientVademecum.to_pgd`` keeps every original dim (x, t, p)
    separate, as the JAX package's does."""
    import pgdrome_tpu.serving as JS
    from pgdrome_tpu_torch.serving import TransientVademecum

    spaces = {}
    for P in (JAXP, PORT):
        spaces[P.root] = [P.FunctionSpace(P.IntervalMesh(n, 0.0, 1.0), "P", deg)
                          for n, deg in ((10, 2), (6, 1), (4, 1), (5, 2))]
    sizes = [V.dim() for V in spaces["pgdrome_tpu_torch"]]
    vt = TransientVademecum(spaces["pgdrome_tpu_torch"], _random_result(PORT, sizes, 3, 11),
                            field_dims=2, dtype=torch.float64, device="cpu", method="torch")
    vj = JS.TransientVademecum(spaces["pgdrome_tpu"], _random_result(JAXP, sizes, 3, 11),
                               field_dims=2, dtype=np.float64)
    pt, pj = vt.to_pgd(), vj.to_pgd()
    assert len(pt.mesh) == 4
    _pgds_equal(pt, pj, [0.4, 0.3, 0.6], [1, 2, 3], pts=np.array([0.1, 0.45]))
    _pgds_equal(pt, pj, [0.7, 0.3, 0.6], [0, 2, 3], fixed=1)


def measure_pair_gaps():
    """The JAX package's own pair — PGDProblem on the host against
    SeparatedPGD, both f64 on the CPU — on the two builds of
    ``chip_smoke.py``'s reference phase (the truss with the example's
    callbacks; bench.py's baseline loop for 3 modes at bench's widths),
    and the port's pair on the CPU beside it.  The port's pair on the card
    is held to 1e-8 or to twice the JAX pair's gap."""
    import importlib
    import json
    import time

    import chip_smoke as cs

    out = {}
    for root in ("pgdrome_tpu", "pgdrome_tpu_torch"):
        mods = [importlib.import_module(f"{root}.{m}") for m in (
            "fem.assembly", "fem.bc", "solver", "models.problems")]
        sep_mod = importlib.import_module(f"{root}.separated")
        extra = {} if root == "pgdrome_tpu" else {"device": "cpu"}

        prob, sep, _ = cs.truss_reference(*mods)
        t0 = time.perf_counter()
        prob.solve_PGD()
        t_host = time.perf_counter() - t0
        res = sep_mod.SeparatedPGD(sep, dtype=np.float64, **cs.TRUSS_SOLVE, **extra).solve()
        truss = cs.amplitude_gap(prob._normConv, cs.device_amplitudes(res))
        truss.update(host_modes=prob.PGD_modes, device_modes=int(res.n_modes),
                     host_amplitudes=list(prob._normConv),
                     device_amplitudes=cs.device_amplitudes(res), host_s=t_host)

        problems = mods[3]
        sep64, Vs = problems.parametric_elliptic(**cs.TRAIN_BUILD)
        bprob = problems.pgd_problem_from_separated(sep64, Vs)
        bprob.tol_fp_it = cs.BASELINE_SOLVE["tol_fp"]
        bprob.max_fp_it = cs.BASELINE_SOLVE["max_fp_it"]
        amps, secs = cs.bench_baseline(bprob, cs.BASELINE_MODES, cs.BASELINE_SOLVE["tol"])
        bres = sep_mod.SeparatedPGD(sep64, dtype=np.float64, **cs.BASELINE_SOLVE,
                                    **extra).solve()
        base = cs.amplitude_gap(amps, cs.device_amplitudes(bres))
        base.update(host_amplitudes=list(amps), device_amplitudes=cs.device_amplitudes(bres),
                    host_s_per_mode=secs)
        out[root] = {"truss": truss, "baseline": base}
        print(root, json.dumps(out[root]), flush=True)
    return out


if __name__ == "__main__":
    import json
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    torch.set_num_threads(4)
    print(json.dumps(measure_pair_gaps()))
