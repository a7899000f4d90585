"""The port's goal-oriented outputs (``pgdrome_tpu_torch/dual.py``, the
corrector methods of ``Vademecum``, ``recipes.goal_oriented_frontier``)
against the JAX package's, on the CPU.

At toy size (``parametric_elliptic(n_x=32, n_p=16, num_params=3)``) in
f64: a primal solved once by the port feeds both packages.
``point_functional``, ``collocation_weights``, ``adjoint_problem``, the
corrector's reduced tables and outputs (``qoi``,
``corrected(return_parts=True)``) agree to 1e-12 of their scale;
``guaranteed_output_bound`` multiplies two dd indicators evaluated from
f32 tables, held to 2e-6 (the dd indicator's tolerance) at grid points;
``goal_oriented_frontier`` (8-mode dual stages; the toy meets 1e-6 in
one) gives the same ranks and flags and its corrected errors and dual amplitudes to rtol 1e-8 (the
f64 fixed points' parity, as ``tests/test_torch_frontier.py``; errors
near 1e-8 to 1e-14 absolute, their f64 floor).  The
corrected sweep's double-f32 z_r·b part equals eager JAX
(``jax.disable_jit()``) bit for bit on the same factors, and the whole
f32 sweep stays within its f32 rounding bound of the host f64
corrector.

Run as a script, it computes the JAX package's figures at full size that
``chip_smoke.py``'s ``dual`` phase is held to:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_dual.py
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

TOL = 1e-12
DD_TOL = 2e-6       # dd indicators from f32 tables (tests/test_torch_certify.py)
RTOL = 1e-8         # f64 fixed points across the two packages
# f64 floor of a relative output error: s_corr and the FEM output each
# carry ~1e-15 of |s|, so errors near 1e-8 agree to ~1e-15 absolute
F64_FLOOR = 1e-14
SIZE = dict(n_x=32, n_p=16, num_params=3)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite's workers share a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(a, b, tol=TOL):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-300)


def _jresult(res):
    from pgdrome_tpu.separated import PGDResult as JResult

    return JResult(modes=[np.asarray(m) for m in res.modes], n_modes=res.n_modes,
                   amplitudes=np.asarray(res.amplitudes), alpha=np.asarray(res.alpha),
                   fp_its=np.asarray(res.fp_its), normU0=res.normU0)


def _host(res):
    """A port result with host f64 numpy modes."""
    from pgdrome_tpu_torch.separated import PGDResult, host_f64

    return PGDResult(modes=[host_f64(m) for m in res.modes], n_modes=res.n_modes,
                     amplitudes=np.asarray(res.amplitudes), alpha=np.asarray(res.alpha),
                     fp_its=np.asarray(res.fp_its), normU0=res.normU0)


@pytest.fixture(scope="module")
def toy():
    """Both packages' builds; a 12-mode f64 primal on the (8, 6) build and
    an 8-mode f64 dual for x0 = 0.5, solved once by the port."""
    from pgdrome_tpu.models.problems import parametric_elliptic as j_elliptic
    from pgdrome_tpu.separated import precondition_dim0 as j_pre

    from pgdrome_tpu_torch.dual import adjoint_problem, point_functional
    from pgdrome_tpu_torch.models.problems import parametric_elliptic
    from pgdrome_tpu_torch.separated import SeparatedPGD, precondition_dim0

    sep_b, _ = parametric_elliptic(**SIZE, degree_x=2, boundary_boost=(8.0, 6))
    sep2, Vs2 = parametric_elliptic(**SIZE, degree_x=2)
    pc_b, tf_u = precondition_dim0(sep_b, np.float64)
    res_u = _host(SeparatedPGD(pc_b, n_max=12, tol=0.0, tol_fp=1e-10, dtype=np.float64,
                               device="cpu").solve_fused())
    l = point_functional(Vs2[0], 0.5)
    adj_pc, tf_z = precondition_dim0(adjoint_problem(sep2, l), np.float64)
    res_z = _host(SeparatedPGD(adj_pc, n_max=8, tol=0.0, tol_fp=1e-10, dtype=np.float64,
                               device="cpu").solve_fused())
    jsep, jVs = j_elliptic(**SIZE, degree_x=2)
    jsep_b, _ = j_elliptic(**SIZE, degree_x=2, boundary_boost=(8.0, 6))
    _, jtf_u = j_pre(jsep_b, dtype=np.float64)
    from pgdrome_tpu.dual import adjoint_problem as j_adj
    from pgdrome_tpu.dual import point_functional as j_pf

    jl = j_pf(jVs[0], 0.5)
    _, jtf_z = j_pre(j_adj(jsep, jl), dtype=np.float64)
    grid = Vs2[1].tabulate_dof_coordinates()[:, 0]
    rng = np.random.default_rng(3)
    samples = np.concatenate([grid[rng.integers(1, len(grid) - 1, size=(20, 3))],
                              rng.uniform(grid[1], grid[-2], size=(20, 3))])
    return SimpleNamespace(sep=sep2, Vs=Vs2, pc_b=pc_b, tf_u=tf_u, res_u=res_u, l=l,
                           adj_pc=adj_pc, tf_z=tf_z, res_z=res_z, jsep=jsep, jVs=jVs,
                           jtf_u=jtf_u, jtf_z=jtf_z, jl=jl, samples=samples, grid=grid)


@pytest.mark.parametrize("x0", [0.0, 0.25, 0.5, 1.0 / 3.0, 0.97, 1.0])
@pytest.mark.parametrize("degree", [1, 2])
def test_point_functional(x0, degree):
    from pgdrome_tpu import FunctionSpace as JSpace
    from pgdrome_tpu import IntervalMesh as JMesh
    from pgdrome_tpu.dual import point_functional as j_pf

    from pgdrome_tpu_torch.dual import point_functional
    from pgdrome_tpu_torch.fem.mesh import IntervalMesh
    from pgdrome_tpu_torch.fem.space import FunctionSpace

    V = FunctionSpace(IntervalMesh(20, 0.0, 1.0), "P", degree)
    jV = JSpace(JMesh(20, 0.0, 1.0), "P", degree)
    _close(point_functional(V, x0), j_pf(jV, x0))
    with pytest.raises(ValueError):
        point_functional(V, 1.5)


def test_collocation_weights_and_adjoint(toy):
    from pgdrome_tpu.dual import adjoint_problem as j_adj
    from pgdrome_tpu.dual import collocation_weights as j_cw

    from pgdrome_tpu_torch.dual import adjoint_problem, collocation_weights

    for dim in range(1, 4):
        _close(collocation_weights(toy.sep, dim), j_cw(toy.jsep, dim))
    with pytest.raises(ValueError):
        collocation_weights(toy.sep, 0)  # the FEM stiffness is not diagonal
    a, ja = adjoint_problem(toy.sep, toy.l), j_adj(toy.jsep, toy.jl)
    for name in ("ops", "rhs", "mass"):
        for x, y in zip(getattr(a, name), getattr(ja, name)):
            _close(x, y)
    for x, y in zip(a.bc_dofs, ja.bc_dofs):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.fixture(scope="module")
def correctors(toy):
    from pgdrome_tpu.dual import DualCorrector as JDC

    from pgdrome_tpu_torch.dual import DualCorrector

    t = DualCorrector(toy.sep, toy.Vs, toy.l, toy.res_u, toy.tf_u, toy.res_z, toy.tf_z)
    j = JDC(toy.jsep, toy.jVs, toy.jl, _jresult(toy.res_u), toy.jtf_u, _jresult(toy.res_z),
            toy.jtf_z)
    return t, j


def test_corrector_tables(correctors):
    t, j = correctors
    for name in ("L", "C", "B"):
        _close(getattr(t, name), getattr(j, name))
    for a, b in zip(t._g_ops + t._g_rhs, j._g_ops + j._g_rhs):
        _close(a, b)


def test_corrector_outputs(toy, correctors):
    t, j = correctors
    _close(t.qoi(toy.samples), j.qoi(toy.samples))
    for a, b in zip(t.corrected(toy.samples, return_parts=True),
                    j.corrected(toy.samples, return_parts=True)):
        _close(a, b)
    with pytest.raises(ValueError):
        t.corrected(np.full((1, 3), 1.5))


def test_corrected_output_error_vs_fem(toy, correctors):
    # the exact-error identity: s − s_corr = (z − z_r)·r, so the corrected
    # outputs beat the plain ones against per-sample FEM
    from pgdrome_tpu_torch.models.problems import elliptic_fem_solver

    t, _ = correctors
    fem = elliptic_fem_solver(toy.Vs[0], 3)
    s_true = np.array([toy.l @ fem(p) for p in toy.samples])
    s_corr, s_plain, est = t.corrected(toy.samples, return_parts=True)
    e_corr = np.abs(s_corr - s_true).max()
    e_plain = np.abs(s_plain - s_true).max()
    assert e_corr < 0.1 * e_plain
    np.testing.assert_allclose(est, s_true - s_plain, rtol=0.5)


def test_guaranteed_output_bound(toy):
    from pgdrome_tpu.dual import guaranteed_output_bound as j_gob

    from pgdrome_tpu_torch.dual import guaranteed_output_bound
    from pgdrome_tpu_torch.models.problems import elliptic_fem_solver
    from pgdrome_tpu_torch.dual import DualCorrector

    b = guaranteed_output_bound(toy.sep, toy.Vs, toy.l, toy.res_u, toy.tf_u, toy.res_z,
                                toy.tf_z, chunk=4, device="cpu")
    # on grid points, where the f32 factor evaluation is exact in both
    # packages (off the grid the two einsum orders round the factors
    # apart, and the residuals, ~1e-9 of ‖b‖ here, amplify that); JAX
    # jitted (op by op it takes ~7 s a sample here), so its dd steps are
    # XLA's rewrites: within the dd indicator's tolerance, not bit for bit
    on_grid = toy.samples[:20]
    jb = j_gob(toy.jsep, toy.jVs, toy.jl, _jresult(toy.res_u), toy.jtf_u,
               _jresult(toy.res_z), toy.jtf_z, chunk=4)
    ref = np.asarray(jb(on_grid))
    _close(b.rhs_norm_primal, jb.rhs_norm_primal)
    _close(b.rhs_norm_dual, jb.rhs_norm_dual)
    assert np.all(np.abs(b(on_grid) - ref) <= DD_TOL * ref)
    out = b(toy.samples)
    # the primal residuals computed once serve every sensor's bound
    np.testing.assert_array_equal(
        b(toy.samples, primal_residuals=b.primal_indicator(toy.samples)), out)
    # the bound covers the corrected output's error against FEM
    dc = DualCorrector(toy.sep, toy.Vs, toy.l, toy.res_u, toy.tf_u, toy.res_z, toy.tf_z)
    fem = elliptic_fem_solver(toy.Vs[0], 3)
    err = np.abs(dc.corrected(toy.samples) - np.array([toy.l @ fem(p) for p in toy.samples]))
    assert np.all(out >= err)


def test_corrected_sweep_dd_part_bitwise():
    # z_r·b in double-f32 over the dual rank: the port's plain elementwise
    # torch equals the JAX package's dd functions run op by op
    import jax
    import jax.numpy as jnp
    from pgdrome_tpu.ops.ddf32 import dd_from_f64 as j_dd_from, dd_mul_f as j_mul
    from pgdrome_tpu.ops.ddf32 import dd_sum as j_sum

    from pgdrome_tpu_torch.dual import corrected_dd_zb
    from pgdrome_tpu_torch.ops.ddf32 import dd_from_f64

    rng = np.random.default_rng(5)
    B = rng.normal(size=(2, 37)) * np.logspace(0, -6, 37)
    fz = rng.normal(size=(11, 37)).astype(np.float32)
    bd = dd_from_f64(B)
    np.testing.assert_array_equal(bd, np.asarray(j_dd_from(B)))
    h, l = corrected_dd_zb(torch.as_tensor(bd[..., 0]), torch.as_tensor(bd[..., 1]),
                           torch.as_tensor(fz))
    with jax.disable_jit():
        jb = jnp.asarray(bd)
        ph, pl = j_mul(jb[:, None, :, 0], jb[:, None, :, 1], jnp.asarray(fz)[None, :, :])
        jh, jl = j_sum(ph, pl, axis=2)
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(l.numpy(), np.asarray(jl))


def test_corrected_sweep_f32(toy, correctors):
    # the f32 sweep (the card's path, here its plain version) within its
    # rounding bound of the host f64 corrector, and of the JAX package's
    # jitted f32 sweep within twice it
    from pgdrome_tpu.dual import make_corrected_sensor_fn as j_make

    from pgdrome_tpu_torch.dual import corrected_sweep_bound, make_corrected_sensor_fn

    t, j = correctors
    fn = make_corrected_sensor_fn(t, device="cpu")
    s_corr, s_plain = fn(toy.samples)
    assert s_corr.dtype == torch.float32 and s_corr.shape == (len(toy.samples),)
    ref, ref_plain, _ = t.corrected(toy.samples, return_parts=True)
    bound, _ = corrected_sweep_bound(t, toy.samples)
    assert np.all(np.abs(s_corr.double().numpy() - ref) <= bound)
    assert np.all(np.abs(s_plain.double().numpy() - ref_plain) <= bound)
    jc, _ = j_make(j, aot=False)(toy.samples)
    assert np.all(np.abs(s_corr.double().numpy() - np.asarray(jc, dtype=np.float64))
                  <= 2 * bound)


def test_vademecum_corrected_sensors(toy, correctors):
    from pgdrome_tpu_torch.dual import corrected_sweep_bound
    from pgdrome_tpu_torch.serving import Vademecum

    t, _ = correctors
    vd = Vademecum(toy.Vs, toy.res_u, dim0_transform=toy.tf_u, device="cpu")
    with pytest.raises(RuntimeError):
        vd.corrected_sensors(toy.samples)
    host, est = vd.attach_corrector(t, device=False).corrected_sensors(
        toy.samples, return_estimate=True)
    ref, ref_plain, _ = t.corrected(toy.samples, return_parts=True)
    np.testing.assert_array_equal(host, ref)
    np.testing.assert_array_equal(est, ref - ref_plain)
    dev = vd.attach_corrector(t).corrected_sensors(toy.samples)
    assert isinstance(dev, torch.Tensor) and dev.dtype == torch.float32
    bound, _ = corrected_sweep_bound(t, toy.samples)
    assert np.all(np.abs(dev.double().numpy() - ref) <= bound)
    with pytest.raises(ValueError):
        vd.corrected_sensors(np.full((1, 3), 1.5))


@pytest.fixture(scope="module")
def frontier_runs(toy):
    from pgdrome_tpu import recipes as JR

    from pgdrome_tpu_torch import recipes as TR

    # one dual stage (the toy dual meets 1e-6 at rank 8): the boosted,
    # seeded and compensated stages are adaptive_cascade's, held in
    # tests/test_torch_frontier.py; a second stage here would cost ~25 s
    kw = dict(n_x=32, n_p=16, dual_stage1=8, dual_budget=8, max_dual_stages=2,
              n_edge=8, n_random=8, seeds=(7,), dtype=np.float64)
    t = TR.goal_oriented_frontier(3, [0.5], toy.res_u, device="cpu", **kw)
    j = JR.goal_oriented_frontier(3, [0.5], _jresult(toy.res_u), **kw)
    return t, j


def test_goal_oriented_frontier(frontier_runs):
    (td, tr), (jd, jr) = frontier_runs
    assert tr.keys() == jr.keys()
    assert tr["n_samples"] == jr["n_samples"] and tr["n_corners"] == jr["n_corners"] == 8
    ts, js = tr["sensors"][0], jr["sensors"][0]
    assert ts.keys() == js.keys() and ts["dual_rank"] == js["dual_rank"] == 8
    assert len(ts["history"]) == 1 and ts["met_bound"] and js["met_bound"]
    for a, b in zip(ts["history"], js["history"]):
        assert a.keys() == b.keys()
        assert [a[f] for f in ("rank", "boosted", "seeded", "rhs_comp")] == [
            b[f] for f in ("rank", "boosted", "seeded", "rhs_comp")]
        for key in ("corners", "interior", "max"):
            np.testing.assert_allclose(a[key], b[key], rtol=RTOL, atol=F64_FLOOR)
    for key in ("corrected_rel_max", "plain_rel_max", "estimate_effectivity_median"):
        np.testing.assert_allclose(ts[key], js[key], rtol=RTOL, atol=F64_FLOOR)
    (tz, ttf), (jz, _) = td[0], jd[0]
    assert tz.n_modes == jz.n_modes
    np.testing.assert_allclose(np.asarray(tz.amplitudes), np.asarray(jz.amplitudes),
                               rtol=RTOL)


def test_goal_verification_set(toy):
    # drawn as the reference draws its set (same seeds, same order)
    from pgdrome_tpu_torch.recipes import goal_verification_set

    s, b = goal_verification_set(3, toy.grid, n_edge=8, n_random=8, seeds=(7, 101))
    assert s.shape == (8 + 2 * 16, 3) and b.sum() == 8 + 16
    s2, _ = goal_verification_set(10, toy.grid, n_corners=16, n_edge=0, n_random=0)
    assert s2.shape == (16, 10)


def test_load_dual_states(tmp_path, toy):
    from pgdrome_tpu_torch.convert import load_dual_states

    arrs = {f"m{d}": np.asarray(m) for d, m in enumerate(toy.res_z.modes)}
    np.savez(tmp_path / "dual_s0.npz", n_modes=toy.res_z.n_modes,
             amplitudes=toy.res_z.amplitudes, alpha=toy.res_z.alpha,
             fp_its=toy.res_z.fp_its, normU0=toy.res_z.normU0, **arrs)
    [(res_z, tf_z, l)] = load_dual_states([tmp_path / "dual_s0.npz"], toy.sep, toy.Vs[0], [0.5])
    _close(l, toy.l)
    assert res_z.n_modes == toy.res_z.n_modes
    _close(tf_z.modes_to_full(np.asarray(res_z.modes[0])[:8]),
           toy.tf_z.modes_to_full(np.asarray(toy.res_z.modes[0])[:8]))
    with pytest.raises(ValueError):
        load_dual_states([tmp_path / "dual_s0.npz"], toy.sep, toy.Vs[0], [0.5, 0.25])


# ------------------------------------------------------------ full size

def d10_dual_reference():
    """The JAX package's figures on the committed d=10 states, on this
    CPU: the primal (``states/frontier_d10_state.npz``, rank 2688)
    Galerkin-updated on the (8, 6) build as ``goal_oriented_frontier``
    does, the committed raw duals (rank 384) for x0 = 0.5 and 0.25, the
    host f64 ``corrected()`` outputs over the recipe's 1,360-point set
    (1,024 inset corners, then 64 interior and 48 edge points for each of
    the seeds 7, 101, 1234) against per-sample f64 FEM."""
    import time
    from pathlib import Path

    from pgdrome_tpu.dual import DualCorrector as JDC
    from pgdrome_tpu.dual import adjoint_problem as j_adj
    from pgdrome_tpu.dual import point_functional as j_pf
    from pgdrome_tpu.models.problems import elliptic_fem_solver as j_fem
    from pgdrome_tpu.models.problems import parametric_elliptic as j_elliptic
    from pgdrome_tpu.separated import PGDResult as JResult
    from pgdrome_tpu.separated import galerkin_update as j_gal
    from pgdrome_tpu.separated import precondition_dim0 as j_pre

    from pgdrome_tpu_torch.recipes import goal_verification_set

    root = Path(__file__).resolve().parent.parent
    t0 = time.perf_counter()

    def load(path):
        with np.load(path) as z:
            nd = sum(1 for k in z.files if k.startswith("m") and k[1:].isdigit())
            return JResult(modes=[z[f"m{d}"] for d in range(nd)], n_modes=int(z["n_modes"]),
                           amplitudes=z["amplitudes"], alpha=z["alpha"], fp_its=z["fp_its"],
                           normU0=float(z["normU0"]))

    sep_b, _ = j_elliptic(n_x=1024, n_p=128, num_params=10, degree_x=2,
                          boundary_boost=(8.0, 6))
    sep_pc, tf_u = j_pre(sep_b, dtype=np.float64)
    res_u = j_gal(sep_pc, load(root / "states" / "frontier_d10_state.npz"))
    print(f"galerkin_update: {time.perf_counter() - t0:.1f} s", flush=True)
    sep, Vs = j_elliptic(n_x=1024, n_p=128, num_params=10, degree_x=2)
    grid = Vs[1].tabulate_dof_coordinates()[:, 0]
    samples, is_boundary = goal_verification_set(10, grid)
    fem = j_fem(Vs[0], 10)
    U = np.stack([fem(p) for p in samples])
    out = {"n_samples": len(samples), "sensors": []}
    for j, x0 in enumerate((0.5, 0.25)):
        l = j_pf(Vs[0], x0)
        _, tf_z = j_pre(j_adj(sep, l), dtype=np.float64)
        res_z = load(root / "states" / f"frontier_dual_d10_s{j}.npz")
        dc = JDC(sep, Vs, l, res_u, tf_u, res_z, tf_z)
        s_corr, s_plain, est = dc.corrected(samples, return_parts=True)
        st = U @ l
        rel = np.abs(s_corr - st) / np.abs(st)
        out["sensors"].append({
            "x0": x0, "corrected_rel_max": float(rel.max()),
            "corrected_rel_median": float(np.median(rel)),
            "argmax": int(np.argmax(rel)),
            "plain_rel_max": float((np.abs(s_plain - st) / np.abs(st)).max()),
            "s_corr_16": [float(v) for v in s_corr[:: len(samples) // 16][:16]],
            "rel_16": [float(v) for v in rel[:: len(samples) // 16][:16]],
        })
        print(out["sensors"][-1], f"{time.perf_counter() - t0:.1f} s", flush=True)
    return out


if __name__ == "__main__":
    import json

    import jax

    jax.config.update("jax_enable_x64", True)
    print(json.dumps(d10_dual_reference()))
