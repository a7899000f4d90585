"""The port's nonlinear family against the JAX package's, on the CPU.

``ops/solvers.py`` (host Newton and Picard, the device Newton),
``fem/assembly_device.py`` (against the JAX package's ``assembly_jax`` and
the host assembly), ``SeparatedPGD(solver="newton")`` and its separable
``nonlinear`` hook (Picard lag and Newton), the nonlinear builders, their
banded-Newton truth and dense verifier, ``residual_cascade``'s rhs options
and ``recipes.nonlinear_vademecum``.  Host builders agree to 1e-12/1e-13;
device math run in f64 on the CPU gives amplitudes equal to 1e-8 (the
repo's parity invariant).  Sizes are the JAX unit tests'.

Run as a script (JAX without x64, f32 as on a TPU), it serves
``NONLINEAR.json``'s state in f32 through both packages on the CPU and
prints each sweep's error against the Newton truth beside the f64
reconstruction's and the state's conditioning (``recipes.state_conditioning``):
the state trained in f32 on the CPU (~10 min; ``--rcond 1e-14`` through
the Galerkin update's truncated solve instead of dropping repeated modes),
or one from ``run_nonlinear_torch.py`` (``--state DIR/state.npz``):

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_nonlinear.py [--state PATH]
"""

import numpy as np

from types import SimpleNamespace

import jax.numpy as jnp
import pytest
import torch

from pgdrome_tpu.fem import assembly as JA
from pgdrome_tpu.fem import assembly_jax as JD
from pgdrome_tpu.fem.mesh import IntervalMesh as JMesh
from pgdrome_tpu.fem.space import FunctionSpace as JSpace
from pgdrome_tpu.models import problems as JP
from pgdrome_tpu.ops import solvers as JS
from pgdrome_tpu import recipes as JR
from pgdrome_tpu import separated as J

from pgdrome_tpu_torch.fem import assembly as TA
from pgdrome_tpu_torch.fem import assembly_device as TD
from pgdrome_tpu_torch.fem.mesh import IntervalMesh as TMesh
from pgdrome_tpu_torch.fem.space import FunctionSpace as TSpace
from pgdrome_tpu_torch.models import problems as TP
from pgdrome_tpu_torch.ops import solvers as TS
from pgdrome_tpu_torch import recipes as TR
from pgdrome_tpu_torch import separated as S

BUILD = 1e-13       # host f64 builders and assembly
NEWTON = 1e-12      # the host and device Newton / Picard solves
REL = 1e-8          # f64 device math across the packages (the parity invariant)
EPS = 2.0           # the nonlinear family's ε (NONLINEAR.json, the JAX unit tests)
F64 = dict(dtype=torch.float64, device="cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite's workers share a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(a, b, tol):
    a = S.host_f64(a)
    b = np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-300)


def _same_result(t, j, tol=REL):
    assert t.n_modes == j.n_modes
    np.testing.assert_allclose(np.asarray(t.amplitudes), np.asarray(j.amplitudes), rtol=tol)
    for tm, jm in zip(t.modes, j.modes):
        _close(S.host_f64(tm)[: t.n_modes], np.asarray(jm)[: j.n_modes], tol)


# ------------------------------------------------------------------ solvers

def _bratu(pkg):
    """−u'' + u³ = f with manufactured u = sin(πx) on P2 (the JAX unit test)."""
    Mesh, Space, A = (JMesh, JSpace, JA) if pkg == "jax" else (TMesh, TSpace, TA)
    V = Space(Mesh(40, 0.0, 1.0), "P", 2)
    f = A.load_vector(V, lambda s: np.pi ** 2 * np.sin(np.pi * s) + np.sin(np.pi * s) ** 3)
    return A.stiffness_matrix(V), A.mass_matrix(V), f, np.array([0, V.dim() - 1])


def test_host_newton_and_picard():
    Kj, Mj, fj, bc = _bratu("jax")
    Kt, Mt, ft, _ = _bratu("torch")
    _close(Kt, Kj, BUILD)
    _close(ft, fj, BUILD)
    uj, cj, ij = JS.newton_solve_np(lambda u: Kj @ u + Mj @ u ** 3 - fj, np.zeros(len(fj)),
                                    bc, np.zeros(2), atol=1e-12)
    ut, ct, it = TS.newton_solve_np(lambda u: Kt @ u + Mt @ u ** 3 - ft, np.zeros(len(ft)),
                                    bc, np.zeros(2), atol=1e-12)
    assert ct and cj and it == ij
    _close(ut, uj, NEWTON)

    rng = np.random.default_rng(0)
    A0, b = 2.0 * np.eye(12), rng.normal(size=12)

    def system(u):
        return A0 + 0.5 * np.diag(np.abs(u)), b

    uj, cj, ij = JS.picard_solve_np(system, np.zeros(12), atol=1e-14)
    ut, ct, it = TS.picard_solve_np(system, np.zeros(12), atol=1e-14)
    assert ct and cj and it == ij
    _close(ut, uj, NEWTON)
    np.testing.assert_array_equal(TS.solve_dense(A0, b), JS.solve_dense(A0, b))
    _close(TS.solve_dense(torch.as_tensor(A0), torch.as_tensor(b)), np.linalg.solve(A0, b),
           NEWTON)


@pytest.mark.parametrize("max_iter", [50, 3])
def test_device_newton(max_iter):
    """The masked fixed-count loop takes the JAX while-loop's steps: the
    same iterate, count and flag, converged or cut at ``max_iter``."""
    K, M, f, bc = _bratu("jax")
    uj, cj, ij = JS.newton_solve(
        lambda u: jnp.asarray(K) @ u + jnp.asarray(M) @ u ** 3 - jnp.asarray(f),
        jnp.zeros(len(f)), bc, np.zeros(2), atol=1e-12, max_iter=max_iter)
    Kt, Mt, ft = (torch.as_tensor(a) for a in (K, M, f))
    ut, ct, it = TS.newton_solve(lambda u: Kt @ u + Mt @ u ** 3 - ft,
                                 torch.zeros(len(f), dtype=torch.float64), bc, np.zeros(2),
                                 atol=1e-12, max_iter=max_iter)
    assert bool(ct) == bool(cj) and int(it) == int(ij)
    assert bool(ct) == (max_iter == 50)
    _close(ut, np.asarray(uj), NEWTON)


# ----------------------------------------------------------------- assembly

def _nonuniform(Mesh, Space, n=17, degree=2):
    pts = np.sort(np.concatenate([[0.0, 1.0],
                                  np.random.default_rng(5).uniform(0.02, 0.98, n - 1)]))
    return Space(Mesh.from_points(pts), "P", degree)


SPACES = {
    "p1": lambda Mesh, Space: Space(Mesh(13, 0.0, 2.0), "P", 1),
    "p2_nonuniform": _nonuniform,
}


@pytest.mark.parametrize("name", sorted(SPACES))
def test_device_assembly(name):
    Vj, Vt = SPACES[name](JMesh, JSpace), SPACES[name](TMesh, TSpace)
    tj, tt = JD.AssemblyTables(Vj, dtype=jnp.float64), TD.AssemblyTables(Vt, **F64)
    w = lambda x: 1.0 + 0.5 * np.sin(3.0 * x)  # noqa: E731
    wq = np.asarray(w(Vt.q_points[..., 0]))
    wj, wt = jnp.asarray(wq), torch.as_tensor(wq)
    for fn in ("mass_matrix", "stiffness_matrix", "advection_matrix"):
        _close(getattr(TD, fn)(tt), getattr(JD, fn)(tj), BUILD)
        _close(getattr(TD, fn)(tt, wt), getattr(JD, fn)(tj, wj), BUILD)
    _close(TD.mass_matrix(tt), TA.mass_matrix(Vt), BUILD)
    _close(TD.stiffness_matrix(tt, wt), TA.stiffness_matrix(Vt, weight=w), BUILD)
    _close(TD.load_vector(tt, wt), TA.load_vector(Vt, w), BUILD)
    _close(TD.load_vector(tt, wt), JD.load_vector(tj, wj), BUILD)
    u = np.random.default_rng(0).normal(size=Vt.dim())
    uj, ut = jnp.asarray(u), torch.as_tensor(u)
    _close(TD.at_quadrature(tt, ut), JD.at_quadrature(tj, uj), BUILD)
    _close(TD.mass_apply(tt, wt, ut), JD.mass_apply(tj, wj, uj), BUILD)
    _close(TD.stiffness_apply(tt, wt, ut), JD.stiffness_apply(tj, wj, uj), BUILD)
    _close(TD.stiffness_apply(tt, wt, ut), TD.stiffness_matrix(tt, wt) @ ut, 1e-12)
    # the quasi-linear hook: apply and weight functions
    aj, gj = JD.quasilinear_diffusion(Vj, lambda uq: EPS * uq ** 2, dtype=jnp.float64)
    at, gt = TD.quasilinear_diffusion(Vt, lambda uq: EPS * uq ** 2, **F64)
    _close(at(ut), aj(uj), BUILD)
    _close(gt(ut), gj(uj), BUILD)
    assert tt.qw.device.type == "cpu" and tt.qw.dtype == torch.float64


def test_assembly_tables_refuse_vectors():
    V = SPACES["p1"](TMesh, TSpace)
    V.value_size = 2
    with pytest.raises(ValueError, match="scalar spaces"):
        TD.AssemblyTables(V, device="cpu")


# ----------------------------------------------------------- newton solver

def test_newton_matches_lu_and_jax():
    """On a linear problem Newton stops at its warm start: the amplitudes
    of "lu", in both packages."""
    sj, _ = JP.parametric_elliptic(n_x=48, n_p=12, num_params=2)
    st, _ = TP.parametric_elliptic(n_x=48, n_p=12, num_params=2)
    kw = dict(n_max=3, tol=1e-12, tol_fp=1e-9, max_fp_it=60)
    lu = S.SeparatedPGD(st, solver="lu", device="cpu", **kw).solve()
    nt = S.SeparatedPGD(st, solver="newton", device="cpu", **kw).solve()
    nj = J.SeparatedPGD(sj, solver="newton", **kw).solve()
    _same_result(nt, nj)
    np.testing.assert_allclose(nt.amplitudes, lu.amplitudes, rtol=REL)
    fused_t = S.SeparatedPGD(st, solver="newton", device="cpu", **kw).solve_fused()
    fused_j = J.SeparatedPGD(sj, solver="newton", **kw).solve_fused()
    _same_result(fused_t, fused_j)
    with pytest.raises(ValueError, match="unknown solver"):
        S.SeparatedPGD(st, solver="cholesky", device="cpu")


def _cubic(pkg, eps):
    """−u'' + ε·u³ = f separated as x ⊗ p, lumped cubic weights: the
    separable rank-1 term N(u) = ⊗(M_L u³) (the JAX unit test's)."""
    P, A = (JP, JA) if pkg == "jax" else (TP, TA)
    sep, Vs = P.parametric_elliptic(n_x=32, n_p=8, num_params=1)
    Mx, Mp = (np.diag(A.mass_matrix(V).sum(axis=1)) for V in Vs)
    if pkg == "jax":
        Mx, Mp = jnp.asarray(Mx), jnp.asarray(Mp)
    else:
        Mx, Mp = torch.as_tensor(Mx), torch.as_tensor(Mp)
    nl = ((lambda u: eps * (Mx @ u ** 3), lambda F: F @ (eps * (Mx @ F ** 3))),
          (lambda u: Mp @ u ** 3, lambda F: F @ (Mp @ F ** 3)))
    return sep, nl


@pytest.mark.parametrize("solver,eps", [("newton", 5.0), ("lu", 1.0)])
def test_separable_nonlinear_hook(solver, eps):
    """Newton on the hook's residual, and the Picard lag of a linear
    solver, against the JAX package in f64."""
    sj, nlj = _cubic("jax", eps)
    st, nlt = _cubic("torch", eps)
    kw = dict(n_max=2, tol=1e-12, tol_fp=1e-10, max_fp_it=80, solver=solver)
    rj = J.SeparatedPGD(sj, nonlinear=nlj, **kw).solve()
    rt = S.SeparatedPGD(st, nonlinear=nlt, device="cpu", **kw).solve()
    _same_result(rt, rj)


# ------------------------------------------------------- builders and truth

def test_nonlinear_builders_and_truth():
    sj, Vj, mj = JP.nonlinear_elliptic(n_x=48, n_p=8, num_params=2)
    st, Vt, mt = TP.nonlinear_elliptic(n_x=48, n_p=8, num_params=2)
    for name in ("ops", "rhs", "mass"):
        for a, b in zip(getattr(st, name), getattr(sj, name)):
            _close(a, b, BUILD)
    _close(mt, mj, BUILD)
    fj = JP.nonlinear_elliptic_fom(Vj[0], 2, EPS, mj)
    ft = TP.nonlinear_elliptic_fom(Vt[0], 2, EPS, mt)
    p = np.array([0.3, 0.8])
    u = ft(p)
    _close(u, fj(p), 1e-12)
    # the truth solves the discrete equation
    kap = lambda x: 1.0 + sum(p[i] * np.sin((i + 1) * np.pi * x) ** 2 / 4.0  # noqa: E731
                              for i in range(2))
    b = TA.load_vector(Vt[0], lambda x: np.ones_like(x))
    r = TA.stiffness_matrix(Vt[0], weight=kap) @ u + EPS * mt * u ** 3 - b
    assert np.abs(r[1:-1]).max() < 1e-11 * np.abs(b).max() and u[0] == u[-1] == 0.0


# ------------------------------------------------------------------ recipes

@pytest.fixture(scope="module")
def solved():
    """``nonlinear_vademecum`` at the JAX unit test's size in f64, in both
    packages."""
    kw = dict(budgets=(20, 14), dtype=np.float64, rhs_bucket=128, n_outer=8)
    sj, Vj, mj = JP.nonlinear_elliptic(n_x=96, n_p=12, num_params=2)
    st, Vt, mt = TP.nonlinear_elliptic(n_x=96, n_p=12, num_params=2)
    rj, tfj, repj = JR.nonlinear_vademecum(sj, Vj, mj, EPS, **kw)
    rt, tft, rept = TR.nonlinear_vademecum(st, Vt, mt, EPS, device="cpu", **kw)
    return SimpleNamespace(sj=sj, Vj=Vj, mj=mj, rj=rj, tfj=tfj, repj=repj,
                           st=st, Vt=Vt, mt=mt, rt=rt, tft=tft, rept=rept)


def _gram_distance(a, b):
    """‖u_a − u_b‖ / ‖u_b‖ in product-space L2 of the (shared) basis."""
    def g(r1, r2):
        G = np.ones((r1.n_modes, r2.n_modes))
        for m1, m2 in zip(r1.modes, r2.modes):
            G = G * (S.host_f64(m1)[: r1.n_modes] @ S.host_f64(m2)[: r2.n_modes].T)
        return G.sum()

    return np.sqrt(max(g(a, a) - 2 * g(a, b) + g(b, b), 0.0) / g(b, b))


def test_nonlinear_vademecum_f64_parity(solved):
    hj, ht = solved.repj["history"], solved.rept["history"]
    assert len(ht) == len(hj) and solved.rept["outer_iterations"] == solved.repj[
        "outer_iterations"]
    for a, b in zip(ht, hj):
        assert (a["rank"], a["cube_terms"], a["rhs_comp"]) == (
            b["rank"], b["cube_terms"], b["rhs_comp"])
    # the JAX package's stop rule, named: this run stalls at outer 5
    last, prev = hj[-1]["rel_change"], hj[-2]["rel_change"]
    assert solved.rept["stop"] == ("converged" if last < 1e-8 else
                                   "stalled" if last > 0.5 * prev else "n_outer")
    np.testing.assert_allclose([h["rel_change"] for h in ht[1:3]],
                               [h["rel_change"] for h in hj[1:3]], rtol=1e-6)
    assert solved.rept["rank"] == solved.repj["rank"]
    assert _gram_distance(solved.rt, solved.rj) <= 1e-8
    kw = dict(n_random=6, seeds=(7, 101), n_edge=4)
    vt = TP.nonlinear_dense_verifier(solved.Vt, EPS, solved.mt, solved.tft, **kw)
    vj = JP.nonlinear_dense_verifier(solved.Vj, EPS, solved.mj, solved.tfj, **kw)
    et, ej = vt(solved.rt), vj(solved.rj)
    for k in ("corners", "interior", "max"):
        assert abs(et[k] - ej[k]) <= 1e-10
    assert et["max"] < 1e-6
    # the verifier's points and its truths
    np.testing.assert_array_equal(vt.corners, np.asarray(vj.corners))
    pts = np.concatenate(list(vt.samples.values()))
    assert len(pts) == 4 + 2 * (6 + 4)
    e3t, e3j = vt.sample_errors(solved.rt, pts[:3]), vj.sample_errors(solved.rj, pts[:3])
    assert np.abs(e3t - e3j).max() <= 1e-10


def test_residual_cascade_rhs_options(solved):
    """``rhs_comp_from`` engages the dd stacks from its stage on, as the
    JAX package's cascade does: the f64 results agree."""
    sj, _ = J.precondition_dim0(solved.sj, dtype=np.float64)
    st, _ = S.precondition_dim0(solved.st, dtype=np.float64)
    for opts in (dict(rhs_comp_from=2), dict(rhs_f64=True)):
        kw = dict(budgets=(6, 4), dtype=np.float64, **opts)
        _same_result(TR.residual_cascade(st, device="cpu", **kw),
                     JR.residual_cascade(sj, **kw))


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_drop_repeated_modes(kind):
    """A mode whose rank-1 term repeats an earlier one up to sign and scale
    (an f32 fixed point cycling at its floor) is dropped before the
    Galerkin update, whose Gram it would make singular; the others keep
    their order."""
    rng = np.random.default_rng(0)
    modes = [rng.normal(size=(8, n)).astype(np.float32) for n in (5, 4, 3)]
    for m in modes:
        m[4] = m[2]  # mode 4 repeats 2 bit for bit
    modes[0][5], modes[1][5], modes[2][5] = -modes[0][3], -2 * modes[1][3], modes[2][3]
    modes[1][6] = modes[1][1]    # a repeat in one dim only is a new mode
    wrap = torch.as_tensor if kind == "torch" else np.asarray
    res = S.PGDResult(modes=[wrap(m) for m in modes], n_modes=7,
                      amplitudes=np.arange(7.0), alpha=np.arange(7.0),
                      fp_its=np.arange(7), normU0=2.0)
    out, n = TR._drop_repeated_modes(res)
    keep = [0, 1, 2, 3, 6]
    assert n == 2 and out.n_modes == 5 and list(out.amplitudes) == keep
    for m, ref in zip(out.modes, modes):
        assert type(m) is type(res.modes[0]) and m.shape == ref.shape
        assert m.dtype == res.modes[0].dtype
        np.testing.assert_array_equal(S.host_f64(m)[:5], ref[keep])
        assert not S.host_f64(m)[5:7].any()
    same, n0 = TR._drop_repeated_modes(out)
    assert same is out and n0 == 0


def test_nonlinear_vademecum_f32_cpu(solved):
    """The f32 recipe with dd stacks from outer 3 (``rhs_comp_last``) on the
    CPU: under the recipe's 1e-6 bound against the Newton truth."""
    res, tf, rep = TR.nonlinear_vademecum(solved.st, solved.Vt, solved.mt, EPS,
                                          budgets=(20, 14), dtype=np.float32, rhs_bucket=128,
                                          n_outer=4, device="cpu")
    assert [h["rhs_comp"] for h in rep["history"]] == [False, False, True, True]
    assert rep["stop"] == "n_outer" and rep["outer_iterations"] == 4
    assert res.modes[0].dtype == torch.float32
    v = TP.nonlinear_dense_verifier(solved.Vt, EPS, solved.mt, tf, n_random=6,
                                    seeds=(7, 101), n_edge=4)(res)
    assert v["max"] < 1e-6


def test_state_conditioning(solved):
    """``recipes.state_conditioning`` on the f64 recipe's result (a sum
    without cancellation) and on the same result with a cancelling pair
    appended: its first term at 1e4 times its size, once with each sign."""
    res, tf = solved.rt, solved.tft
    pts = np.array([[0.3, 0.7], [0.55, 0.45], [0.8, 0.2]])
    c = TR.state_conditioning(res, solved.Vt, tf, pts)
    assert 1.0 <= c["cancellation_max"] < 2.0 and c["gram_cond"] < 1e8
    K = res.n_modes
    m = [S.host_f64(x)[:K] for x in res.modes]
    modes = [np.concatenate([m[0], 1e4 * m[0][:1], -1e4 * m[0][:1]])]
    modes += [np.concatenate([x, x[:1], x[:1]]) for x in m[1:]]
    pair = S.PGDResult(modes=[torch.as_tensor(x) for x in modes], n_modes=K + 2,
                       amplitudes=np.ones(K + 2), alpha=np.ones(K + 2),
                       fp_its=np.zeros(K + 2, dtype=int), normU0=1.0)
    cp = TR.state_conditioning(pair, solved.Vt, tf, pts)
    assert cp["cancellation_max"] > 1e4 and cp["gram_cond"] > 1e15
    assert cp["alpha_max"] > 1e3 * c["alpha_max"]


def served_f32_reference(state=None, rcond=None, threads=4):
    """``NONLINEAR.json``'s state served in f32 by both packages on the CPU,
    JAX without x64 as on a TPU: the port's plain f32 sweep, the JAX
    package's Pallas kernel (interpret mode) and its XLA sweep, each against
    the 76 banded-Newton truths beside the f64 reconstruction, with
    ``recipes.state_conditioning``.  ``state``: a ``state.npz`` of
    ``run_nonlinear_torch.py`` (e.g. from the card); without it the recipe
    trains in f32 on the CPU (~10 min), with ``rcond`` through the
    Galerkin update's SVD-truncated solve in place of dropping repeated
    modes."""
    import json

    from pgdrome_tpu.ops.pallas_kernels import make_fused_sweep
    from pgdrome_tpu.serving import Vademecum as JVd
    from pgdrome_tpu_torch.convert import load_state_npz
    from pgdrome_tpu_torch.serving import Vademecum as TVd

    torch.set_num_threads(threads)
    st, Vt, mt = TP.nonlinear_elliptic(n_x=1024, n_p=64, num_params=2)
    tf = TR._CubeRhs(st, mt, EPS, 40, 1e-10, 512).tf
    report = {"state": state, "rcond": rcond}
    if state is None:
        if rcond is not None:   # the valve: keep every mode, truncate the solve
            TR._drop_repeated_modes = lambda r: (r, 0)
            galerkin = TR.galerkin_update
            TR.galerkin_update = lambda p, r: galerkin(p, r, rcond=rcond)
        res, tf, rep = TR.nonlinear_vademecum(st, Vt, mt, EPS, budgets=(64, 48, 48),
                                              rhs_bucket=512, dtype=np.float32, device="cpu")
        report["recipe"] = {k: rep[k] for k in ("stop", "outer_iterations", "rank", "wall_s")}
    else:
        res = load_state_npz(state)
    ver = TP.nonlinear_dense_verifier(Vt, EPS, mt, tf, n_random=16, seeds=(7, 101, 1234),
                                      n_edge=8)
    pts = np.concatenate(list(ver.samples.values()))
    U = np.stack([ver.truth(p) for p in pts])

    def err(u):
        u = np.asarray(u, dtype=np.float64)
        return float((np.linalg.norm(u - U, axis=1) / np.linalg.norm(U, axis=1)).max())

    K = res.n_modes
    nodal = [tf.modes_to_full(S.host_f64(res.modes[0])[:K]).astype(np.float32)]
    nodal += [S.host_f64(m)[:K].astype(np.float32) for m in res.modes[1:]]
    _, Vj, _ = JP.nonlinear_elliptic(n_x=1024, n_p=64, num_params=2)
    rj = J.PGDResult(modes=nodal, n_modes=K, amplitudes=np.ones(K), alpha=np.ones(K),
                     fp_its=np.zeros(K, dtype=int), normU0=1.0)
    p32 = pts.astype(np.float32)
    report.update({
        "rank": K, "f64_reconstruction": ver(res)["max"],
        "port_plain_f32": err(TVd(Vt, res, dim0_transform=tf, method="torch",
                                  device="cpu").fields(pts).numpy()),
        "jax_pallas_interpret_f32": err(make_fused_sweep(
            Vj, [jnp.asarray(m) for m in nodal], K, block_b=128, block_n=2048)(p32)),
        "jax_xla_f32": err(JVd(Vj, rj, method="xla").fields(p32)),
        "conditioning": TR.state_conditioning(res, Vt, tf, pts)})
    for k in ("port_plain_f32", "jax_pallas_interpret_f32", "jax_xla_f32"):
        report[k + "_over_f64"] = report[k] / report["f64_reconstruction"]
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    import argparse

    import jax

    ap = argparse.ArgumentParser(description=served_f32_reference.__doc__)
    ap.add_argument("--state", default=None)
    ap.add_argument("--rcond", type=float, default=None)
    ap.add_argument("--threads", type=int, default=4)
    a = ap.parse_args()
    assert not jax.config.jax_enable_x64, "run without x64: f32 serving as on a TPU"
    served_f32_reference(a.state, a.rcond, a.threads)
