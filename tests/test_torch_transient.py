"""The port's transient family on intervals against the JAX package's, on
the CPU.

``ops/fd.py``, ``utils/separation.py``, ``separated.normal_equations`` /
``ne_dim_base``, the solver option of the minres recipe
(``renorm_sweep``, with the LU and Cholesky solves),
``recipes.two_stage_minres`` / ``adaptive_minres``, the transient model
problems, their space-time FOM and dense verifier,
``serving.TransientVademecum`` and the transient residual indicator and
certifier.  Host builders agree to 1e-13; device math run in f64 on the
CPU gives amplitudes equal to 1e-8 (the repo's parity invariant).

Run as a script, it computes the JAX package's figure at full size that
``chip_smoke.py``'s ``transient`` phase is held to, and with ``keep`` the
modes that each stage of that recipe keeps in each package, in f32, in
f32 with denormals flushed to zero (the port) and in f64 (~5 min):

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_transient.py [keep]
"""

import numpy as np

from types import SimpleNamespace

import pytest
import torch

from pgdrome_tpu import separated as J
from pgdrome_tpu.models import problems as JP
from pgdrome_tpu import recipes as JR

from pgdrome_tpu_torch import separated as S
from pgdrome_tpu_torch.models import problems as TP
from pgdrome_tpu_torch import recipes as TR

BUILD = 1e-13       # host f64 builders
REL = 1e-8          # f64 device math across the packages (the parity invariant)
HEAT = dict(n_x=24, n_t=16, n_P=4, n_v=5, source_rank=6, af=0.15)
COND = dict(n_x=12, n_t=8, n_p=6, num_params=2)


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


def _same_problem(t, j, tol=BUILD):
    for name in ("ops", "rhs", "mass"):
        for a, b in zip(getattr(t, name), getattr(j, name)):
            _close(a, b, tol)
    for a, b in zip(t.bc_dofs, j.bc_dofs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _same_result(t, j, tol=REL):
    assert t.n_modes == j.n_modes
    np.testing.assert_allclose(np.asarray(t.amplitudes), np.asarray(j.amplitudes), rtol=tol)
    for tm, jm in zip(t.modes, j.modes):
        _close(S.host_f64(tm)[: t.n_modes], np.asarray(jm)[: j.n_modes], tol)


@pytest.fixture(scope="module")
def heat():
    t = TP.moving_heat_source(**HEAT)
    j = JP.moving_heat_source(**HEAT)
    return SimpleNamespace(t=t, j=j)


@pytest.fixture(scope="module")
def cond():
    return SimpleNamespace(t=TP.transient_parametric_conductivity(**COND),
                           j=JP.transient_parametric_conductivity(**COND))


@pytest.mark.parametrize("grid", ["uniform", "graded"])
def test_fd_matrices(grid):
    from pgdrome_tpu.ops import fd as jfd

    from pgdrome_tpu_torch.ops import fd as tfd

    x = np.linspace(0.0, 1.0, 11)
    if grid == "graded":
        x = x ** 1.7
    for a, b in zip(tfd.FD_matrices(x), jfd.FD_matrices(x)):
        _close(a, b, BUILD)
    A = tfd.FD_matrices(x)[2]
    _close(tfd.apply_matrix_bc(A, [0, 3]), jfd.apply_matrix_bc(A, [0, 3]), BUILD)
    _close(tfd.apply_vector_bc(x, [1, 2], 0.5), jfd.apply_vector_bc(x, [1, 2], 0.5), BUILD)


def test_separation():
    from pgdrome_tpu.utils import separation as js

    from pgdrome_tpu_torch.utils import separation as ts

    rng = np.random.default_rng(4)
    vals = rng.normal(size=(7, 6, 5)) + np.einsum("i,j,k->ijk", *[rng.normal(size=n)
                                                                  for n in (7, 6, 5)])
    f, t1 = ts.separate_rank1(vals)
    jf, jt1 = js.separate_rank1(vals)
    _close(t1, jt1, BUILD)
    for a, b in zip(ts.separate(vals, 4), js.separate(vals, 4)):
        _close(a, b, BUILD)
    facs = ts.separate(vals, 4)
    assert abs(ts.separation_error(vals, facs) - js.separation_error(vals, facs)) <= BUILD
    grids = [np.linspace(0, 1, n) for n in (9, 8, 7)]
    fn = lambda x, t, v: np.exp(-((x - 0.2 - v * t) ** 2) / 0.05)  # noqa: E731
    for a, b in zip(ts.separate_function(fn, grids, 3), js.separate_function(fn, grids, 3)):
        _close(a, b, BUILD)
    for a, b in zip(ts.separate_hierarchical(vals, tol=1e-3, max_terms=9),
                    js.separate_hierarchical(vals, tol=1e-3, max_terms=9)):
        _close(a, b, BUILD)
    with pytest.raises(ValueError):
        ts.separate_hierarchical(vals[0])


@pytest.mark.parametrize("separation", ["greedy", "hierarchical"])
def test_moving_heat_source(separation):
    t = TP.moving_heat_source(**HEAT, separation=separation)
    j = JP.moving_heat_source(**HEAT, separation=separation)
    _same_problem(t[0], j[0])
    for a, b in zip(t[2], j[2]):
        _close(a, b, BUILD)
    assert abs(t[3] - j[3]) <= BUILD
    assert [V.dim() for V in t[1]] == [V.dim() for V in j[1]]


def test_conductivity_and_fom(cond):
    (ts, tV), (js, jV) = cond.t, cond.j
    _same_problem(ts, js)
    tf, jf = TP.transient_conductivity_fom(ts, tV), JP.transient_conductivity_fom(js, jV)
    grid = tV[2].tabulate_dof_coordinates()[:, 0]
    for p in ([0.0, 1.0], [grid[2], grid[3]], [0.37, 0.81]):
        u = tf(np.asarray(p))
        assert u.shape == (ts.sizes[0], ts.sizes[1])
        _close(u, jf(np.asarray(p)), BUILD)


def test_normal_equations_and_base(heat, cond):
    for t, j in ((heat.t[0], heat.j[0]), (cond.t[0], cond.j[0])):
        _same_problem(S.normal_equations(t), J.normal_equations(j))
        for d in range(t.num_dims):
            _close(S.ne_dim_base(t, d), J.ne_dim_base(j, d), BUILD)


@pytest.fixture(scope="module")
def ne_pc(heat):
    """The moving heat source's normal equations, preconditioned on
    dims 0 and 1 with the diag-sum bases, as the minres stage builds
    them, in both packages."""
    out = []
    for mod, sep in ((S, heat.t[0]), (J, heat.j[0])):
        ne = mod.normal_equations(sep)
        for d in (0, 1):
            ne, _ = mod.precondition_dim(ne, dim=d, dtype=np.float64,
                                         base=mod.ne_dim_base(sep, d))
        out.append(ne)
    return out


@pytest.mark.parametrize("opts", [
    dict(), dict(solver="chol"), dict(renorm_sweep=True), dict(renorm_sweep=True, solver="chol"),
], ids=["default", "chol", "renorm", "renorm_chol"])
def test_solver_options_f64_parity(ne_pc, opts):
    tne, jne = ne_pc
    kw = dict(n_max=4, tol=0.0, tol_fp=1e-6, dtype=np.float64, residual_check=False)
    kw.update(opts)
    j = J.SeparatedPGD(jne, **kw).solve_fused()
    t = S.SeparatedPGD(tne, device="cpu", **kw).solve_fused()
    np.testing.assert_array_equal(np.asarray(t.fp_its), np.asarray(j.fp_its))
    _same_result(t, j)
    np.testing.assert_allclose(np.asarray(t.alpha), np.asarray(j.alpha), rtol=REL)


def test_two_stage_minres(heat):
    kw = dict(n_stage1=6, n_stage2=4, dtype=np.float64, tol_fp=1e-6)
    t = TR.two_stage_minres(heat.t[0], device="cpu", **kw)
    j = JR.two_stage_minres(heat.j[0], **kw)
    assert t.n_modes == j.n_modes == 10
    _same_result(t, j)


@pytest.fixture(scope="module")
def adaptive(heat):
    kw = dict(bound=1e-12, n_stage1=4, stage_budget=3, max_stages=2, dtype=np.float64,
              tol_fp=1e-6)
    tv = TP.transient_dense_verifier(heat.t[0], heat.t[1], heat.t[2], af=HEAT["af"],
                                     n_random=2, seeds=(7,))
    jv = JP.transient_dense_verifier(heat.j[0], heat.j[1], heat.j[2], af=HEAT["af"],
                                     n_random=2, seeds=(7,))
    t = TR.adaptive_minres(heat.t[0], tv, device="cpu", **kw)
    j = JR.adaptive_minres(heat.j[0], jv, **kw)
    return SimpleNamespace(t=t, j=j, tv=tv, jv=jv)


def test_adaptive_minres(adaptive):
    (tb, th), (jb, jh) = adaptive.t, adaptive.j
    assert [h["rank"] for h in th] == [h["rank"] for h in jh] == [4, 7]
    for a, b in zip(th, jh):
        assert a.keys() == b.keys() and a["rhs_comp"] == b["rhs_comp"]
        for key in ("corners", "interior", "max"):
            np.testing.assert_allclose(a[key], b[key], rtol=REL)
    _same_result(tb, jb)


def test_transient_dense_verifier(adaptive):
    tb = adaptive.t[0]
    a, b = adaptive.tv(tb), adaptive.jv(tb)
    for key in ("corners", "interior", "max"):
        assert abs(a[key] - b[key]) <= 1e-12 * b[key]
    _close(a["worst_points"], b["worst_points"], BUILD)
    pairs = [(1, 2), (2, 3)]
    _close(adaptive.tv.sample_errors(tb, pairs), adaptive.jv.sample_errors(tb, pairs), 1e-12)
    assert adaptive.tv.corner_indices == adaptive.jv.corner_indices


def _jresult(res):
    return J.PGDResult(modes=[S.host_f64(m) for m in res.modes], n_modes=res.n_modes,
                       amplitudes=np.asarray(res.amplitudes), alpha=np.asarray(res.alpha),
                       fp_its=np.asarray(res.fp_its), normU0=res.normU0)


def test_transient_vademecum(heat, adaptive, tmp_path):
    from pgdrome_tpu.serving import TransientVademecum as JTV

    from pgdrome_tpu_torch.serving import TransientVademecum

    res = adaptive.t[0]
    Vs = heat.t[1]
    vd = TransientVademecum(Vs, res, dtype=torch.float64, method="torch", device="cpu")
    jvd = JTV(heat.j[1], _jresult(res), method="xla", dtype=np.float64)
    assert vd.field_shape == jvd.field_shape == (HEAT["n_x"] + 1, HEAT["n_t"] + 1)
    rng = np.random.default_rng(2)
    s = np.stack([rng.uniform(0.5, 1.0, 9), rng.uniform(0.5, 1.0, 9)], axis=1)
    _close(vd.fields(s), np.asarray(jvd.fields(s)), 1e-12)
    pts = np.array([[0.3, 0.5], [0.6, 0.9], [0.1, 1.0]])
    _close(vd.sensors(pts)(s), np.asarray(jvd.sensors(pts)(s)), 1e-12)
    _close(vd.sensors_jacobian(pts)(s), np.asarray(jvd.sensors_jacobian(pts)(s)), 1e-10)
    with pytest.raises(ValueError):
        vd.sensors(np.array([0.3, 0.5]))
    # the f32 field path: the plain sweep here, the field kernels on the card
    vd32 = TransientVademecum(Vs, res, device="cpu")
    ref = vd.fields(s)
    assert float((vd32.fields(s).double() - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    vd32.save(tmp_path / "tv.npz")
    with np.load(tmp_path / "tv.npz") as z:
        assert int(z["field_dims"]) == 2 and z["modes_0"].shape == (res.n_modes, HEAT["n_x"] + 1)
    back = TransientVademecum.load(tmp_path / "tv.npz", Vs, device="cpu")
    assert back.field_dims == 2 and torch.equal(back.fields(s), vd32.fields(s))
    # the kron-structured space-time Gram behind the aggregated Sobol' indices
    a, b = vd.sobol(), jvd.sobol()
    for key in ("variance", "first", "total"):
        _close(a[key], np.asarray(b[key]), 1e-10)
    sl = vd.fix_parameters({0: 0.75})
    _close(sl.fields(s[:, 1:]), vd.fields(np.stack([np.full(9, 0.75), s[:, 1]], 1)), 1e-12)
    dv = vd.derivative()
    assert dv.field_shape == (HEAT["n_x"], HEAT["n_t"] + 1)  # P1 → DG0: a value a cell


def test_transient_certifier(heat, adaptive):
    from pgdrome_tpu.parallel import certify as JC

    from pgdrome_tpu_torch.parallel import certify as TC

    res = adaptive.t[0]
    t_ind = TC.make_transient_residual_indicator(heat.t[0], heat.t[1], res, heat.t[2])
    j_ind = JC.make_transient_residual_indicator(heat.j[0], heat.j[1], _jresult(res),
                                                 heat.j[2])
    P_grid = heat.t[1][2].tabulate_dof_coordinates()[:, 0]
    v_grid = heat.t[1][3].tabulate_dof_coordinates()[:, 0]
    pairs = [(i, j) for i in range(len(P_grid)) for j in range(len(v_grid))]
    pts = np.array([[P_grid[i], v_grid[j]] for i, j in pairs])
    _close(t_ind(pts), np.asarray(j_ind(pts)), 1e-10)
    cert = TC.make_transient_certifier(heat.t[0], heat.t[1], res, heat.t[2])
    errs = adaptive.tv.sample_errors(res, pairs)
    # calibrated on the box's edge points, held at every grid point
    edge = np.array([i in (0, len(P_grid) - 1) or j in (0, len(v_grid) - 1)
                     for i, j in pairs])
    eta = cert.calibrate(pts[edge], errs[edge])
    assert eta > 0 and np.all(cert.bound(pts) >= errs)
    with pytest.raises(ValueError):
        TC.make_transient_residual_indicator(*_cond_args())


def _cond_args():
    sep, Vs = TP.transient_parametric_conductivity(**COND)
    res = S.PGDResult(modes=[np.zeros((1, n)) for n in sep.sizes], n_modes=1,
                      amplitudes=np.ones(1), alpha=np.ones(1), fp_its=np.zeros(1), normU0=1.0)
    return sep, Vs, res, [np.zeros((1, n)) for n in sep.sizes[:3]]


# the transient phase's configuration: TRANSIENT_GOAL.json's primal
TRANSIENT = dict(n_x=256, n_t=96, n_p=48, num_params=3)
TRANSIENT_STAGES = (96, 64)
TRANSIENT_SOLVE = dict(tol_fp=1e-7, max_fp_it=50)


def transient_reference():
    """The JAX package's f32 primal of the transient phase on this CPU:
    ``two_stage_minres(96, 64)`` on ``transient_parametric_conductivity(
    n_x=256, n_t=96, n_p=48, num_params=3)`` (TRANSIENT_GOAL.json's primal,
    rank 95 and field rel max 4.77e-4 there, a TPU run), its rank and the
    max relative space-time L2 error against the exact FOM over the 40
    verification points."""
    import time

    from pgdrome_tpu.models.problems import (
        transient_conductivity_fom,
        transient_parametric_conductivity,
    )
    from pgdrome_tpu.recipes import two_stage_minres
    from pgdrome_tpu.separated import evaluate_modes_1d

    from pgdrome_tpu_torch.recipes import transient_verification_set

    t0 = time.perf_counter()
    sep, Vs = transient_parametric_conductivity(**TRANSIENT)
    res = two_stage_minres(sep, n_stage1=TRANSIENT_STAGES[0], n_stage2=TRANSIENT_STAGES[1],
                           dtype=np.float32, **TRANSIENT_SOLVE)
    t_solve = time.perf_counter() - t0
    fom = transient_conductivity_fom(sep, Vs)
    pts = transient_verification_set(Vs[2].tabulate_dof_coordinates()[:, 0],
                                     TRANSIENT["num_params"])
    K = res.n_modes
    fu = np.ones((len(pts), K))
    for j in range(TRANSIENT["num_params"]):
        fu *= np.asarray(evaluate_modes_1d(Vs[2 + j], res.modes[2 + j], pts[:, j],
                                           xp=np))[:, :K]
    m0 = np.asarray(res.modes[0], np.float64)[:K]
    m1 = np.asarray(res.modes[1], np.float64)[:K]
    errs = []
    for s, p in enumerate(pts):
        u = fom(p)
        errs.append(float(np.linalg.norm(np.einsum("k,ki,kj->ij", fu[s], m0, m1) - u)
                          / np.linalg.norm(u)))
    return {"rank": int(K), "field_rel_max": max(errs), "field_rel_median": float(np.median(errs)),
            "solve_s": round(t_solve, 1), "n_points": len(pts)}


def minres_keep():
    """Stage 1 of the transient phase's ``two_stage_minres`` (96 modes) in
    both packages on this CPU: the modes each keeps (a mode of zero or NaN
    normU is dropped, and every later one repeats it) in f32, in f32 with
    denormals flushed to zero in the port (as XLA on a CPU, and a TPU,
    flush them), and in f64; the largest relative gap of the two f64
    runs' amplitudes over the modes the JAX package keeps in f32; and
    the modes stage 2 (64) keeps in f32 in each package, both fed the JAX
    package's f32 stage 1."""
    sep_j, _ = JP.transient_parametric_conductivity(**TRANSIENT)
    sep_t, _ = TP.transient_parametric_conductivity(**TRANSIENT)
    n1, fp = TRANSIENT_STAGES[0], TRANSIENT_SOLVE

    def both(dtype):
        j = JR._minres_stage(sep_j, n1, (0, 1), fp["tol_fp"], fp["max_fp_it"], dtype, None, False)
        t = TR._minres_stage(sep_t, n1, (0, 1), fp["tol_fp"], fp["max_fp_it"], dtype, False, "cpu")
        return j, t

    j32, t32 = both(np.float32)
    torch.set_flush_denormal(True)
    try:
        ftz = TR._minres_stage(sep_t, n1, (0, 1), fp["tol_fp"], fp["max_fp_it"], np.float32,
                               False, "cpu")
    finally:
        torch.set_flush_denormal(False)
    j64, t64 = both(np.float64)
    n = j32.n_modes
    gap = np.abs(np.asarray(t64.amplitudes)[:n] / np.asarray(j64.amplitudes)[:n] - 1).max()
    # stage 2 on the JAX package's f32 stage 1, in both packages
    j1 = S.PGDResult(modes=[np.asarray(m, np.float64) for m in j32.modes], n_modes=n,
                     amplitudes=np.asarray(j32.amplitudes), alpha=np.asarray(j32.alpha),
                     fp_its=np.asarray(j32.fp_its), normU0=float(j32.normU0))
    n2 = TRANSIENT_STAGES[1]
    j2 = JR._minres_stage(J.residual_problem(sep_j, j32)[0], n2, (0, 1), fp["tol_fp"],
                          fp["max_fp_it"], np.float32, None, False)
    t2 = TR._minres_stage(S.residual_problem(sep_t, j1)[0], n2, (0, 1), fp["tol_fp"],
                          fp["max_fp_it"], np.float32, False, "cpu")
    return {"stage1": {"of": n1, "f32": {"jax": j32.n_modes, "port": t32.n_modes},
                       "f32_port_denormals_flushed": ftz.n_modes,
                       "f64": {"jax": j64.n_modes, "port": t64.n_modes},
                       "f64_amplitude_gap_over_jax_f32_modes": float(gap)},
            "stage2_f32_on_jax_stage1": {"of": n2, "jax": j2.n_modes, "port": t2.n_modes}}


if __name__ == "__main__":
    import json
    import sys

    import jax

    jax.config.update("jax_enable_x64", True)
    print(json.dumps(minres_keep() if sys.argv[1:] == ["keep"] else transient_reference()))
