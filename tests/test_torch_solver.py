"""The port's solver, host post-process and dense verifier against the JAX
package's, on the CPU.

Both packages get the same numpy inputs; the JAX side runs on the CPU with
x64 (as ``tests/conftest.py`` sets), the port with ``device="cpu"``.

Tolerances:
- f64 solves (``solve`` and ``solve_fused``, every linear solver, a
  non-symmetric operator, randomized and callable fixed-point inits):
  amplitudes, alpha and normU0 within 1e-8 relative, modes within 1e-8 of
  each buffer's max, ``n_modes`` and ``fp_its`` equal;
- the host f64 post-process on one fixed result: 1e-10 of each output's max;
- the dense verifier's errors: 1e-12;
- the committed d=5 state after ``galerkin_update`` verifies at the
  reference's 6.7265e-7 at the 32 inset corners (ROADMAP C, "record vs
  state"), and the update's modes are within 1e-10 of the JAX package's.
"""

import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pgdrome_tpu import separated as J
from pgdrome_tpu.models.problems import elliptic_dense_verifier as j_verifier
from pgdrome_tpu.models.problems import parametric_elliptic as j_elliptic

from pgdrome_tpu_torch import separated as S
from pgdrome_tpu_torch.convert import load_state_npz, result_from_numpy
from pgdrome_tpu_torch.models.problems import elliptic_dense_verifier as t_verifier
from pgdrome_tpu_torch.models.problems import parametric_elliptic as t_elliptic

ROOT = Path(__file__).resolve().parent.parent
STATE = ROOT / "states" / "frontier_d5_state.npz"
REL = 1e-8
POST = 1e-10
VER = 1e-12
TOY = dict(n_x=32, n_p=8, num_params=2, boundary_boost=(16.0, 6))


def _pair(**kw):
    """The same build and dim-0 transform in both packages."""
    js, jV = j_elliptic(**kw)
    ts, tV = t_elliptic(**kw)
    jpc, jtf = J.precondition_dim0(js, np.float64)
    tpc, ttf = S.precondition_dim0(ts, np.float64)
    return SimpleNamespace(jpc=jpc, jtf=jtf, jV=jV, tpc=tpc, ttf=ttf, tV=tV)


@pytest.fixture(scope="module")
def toy():
    return _pair(**TOY)


def _close(a, b, tol):
    a, b = S.host_f64(a), S.host_f64(np.asarray(b))
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-300)


def _same_result(t, j, tol=REL):
    assert t.n_modes == j.n_modes
    np.testing.assert_array_equal(np.asarray(t.fp_its), np.asarray(j.fp_its))
    np.testing.assert_allclose(t.amplitudes, np.asarray(j.amplitudes), rtol=tol)
    np.testing.assert_allclose(t.alpha, np.asarray(j.alpha), rtol=tol)
    assert abs(t.normU0 / j.normU0 - 1.0) <= tol
    for tm, jm in zip(t.modes, j.modes):
        _close(tm, jm, tol)


@pytest.mark.parametrize("entry", ["solve", "solve_fused"])
@pytest.mark.parametrize("solver", ["lu", "cg", "chol"])
def test_elliptic_f64_parity(toy, solver, entry):
    kw = dict(n_max=8, tol=1e-10, tol_fp=1e-7, solver=solver, dtype=np.float64)
    j = getattr(J.SeparatedPGD(toy.jpc, **kw), entry)()
    t = getattr(S.SeparatedPGD(toy.tpc, device="cpu", **kw), entry)()
    assert t.n_modes == 8 and isinstance(t.modes[0], torch.Tensor)
    assert t.modes[0].dtype == torch.float64
    _same_result(t, j)


def _nonsymmetric(seed=3):
    """A seeded random separated problem, T = 2: an SPD term and a
    non-symmetric one in every dim, R = 2, two Dirichlet dofs on dim 0."""
    rng = np.random.default_rng(seed)
    ops, rhs, mass = [], [], []
    for n in (9, 7, 6):
        B = rng.normal(size=(n, n)) / n
        spd = 2.0 * np.eye(n) + B @ B.T
        ops.append(np.stack([spd, 0.3 * rng.normal(size=(n, n)) / np.sqrt(n)]))
        rhs.append(rng.uniform(0.5, 1.5, size=(2, n)))
        mass.append(np.eye(n) + 0.5 * B @ B.T)
    assert not np.allclose(ops[0][1], ops[0][1].T)
    bc = [np.array([0, 8])] + [np.array([], dtype=np.int64)] * 2
    return (J.SeparatedProblem(ops=ops, rhs=rhs, mass=mass, bc_dofs=bc),
            S.SeparatedProblem(ops=ops, rhs=rhs, mass=mass, bc_dofs=bc))


@pytest.mark.parametrize("entry", ["solve", "solve_fused"])
def test_nonsymmetric_f64_parity(entry):
    # the previous-mode contraction takes F on the TEST index; the trial
    # index passes every symmetric case and fails this one
    jp, tp = _nonsymmetric()
    kw = dict(n_max=5, tol=0.0, tol_fp=1e-6, dtype=np.float64)
    j = getattr(J.SeparatedPGD(jp, **kw), entry)()
    t = getattr(S.SeparatedPGD(tp, device="cpu", **kw), entry)()
    assert t.n_modes == 5
    _same_result(t, j)
    assert float(S.host_f64(t.modes[0])[:, [0, 8]].max()) == 0.0  # Dirichlet rows


@pytest.mark.parametrize("entry", ["solve", "solve_fused"])
def test_nonsymmetric_normal_equations_f64_parity(entry):
    # the minres path: the normal equations of the non-symmetric problem
    # keep non-symmetric cross terms O_tᵀO_u per dim, solved by Cholesky
    # with mid-sweep renormalisation as the minres recipe runs them
    jp, tp = _nonsymmetric()
    jne, tne = J.normal_equations(jp), S.normal_equations(tp)
    assert not np.allclose(tne.ops[1][1], tne.ops[1][1].T)
    # tol_fp well above the relative 'norm' metric's f64 floor, √u64 ≈ 1.5e-8
    # (it cancels |F_new|² + |F_old|² − 2 F_new·F_old): at the floor the
    # two packages' last roundings decide when the fixed point stops
    kw = dict(n_max=4, tol=0.0, tol_fp=1e-6, dtype=np.float64, renorm_sweep=True,
              solver="chol", residual_check=False)
    j = getattr(J.SeparatedPGD(jne, **kw), entry)()
    t = getattr(S.SeparatedPGD(tne, device="cpu", **kw), entry)()
    assert t.n_modes == 4
    _same_result(t, j)


def _seeded_init(n, sizes):
    rng = np.random.default_rng(1000 + n)
    return tuple(rng.uniform(0.5, 1.0, size=s) for s in sizes)


@pytest.mark.parametrize("fp_init", ["randomized", _seeded_init], ids=["randomized", "callable"])
def test_fp_init_parity(toy, fp_init):
    kw = dict(n_max=3, tol=1e-13, tol_fp=1e-7, dtype=np.float64, fp_init=fp_init)
    _same_result(S.SeparatedPGD(toy.tpc, device="cpu", **kw).solve(),
                 J.SeparatedPGD(toy.jpc, **kw).solve())


def test_zero_residual_keep_mask(toy):
    # a zero rhs: every enrichment's residual is 0 < 1e-10, so the keep
    # mask drops each mode and the result is empty, as in the reference
    zero = lambda P, cls: cls(ops=P.ops, rhs=[0.0 * np.asarray(r) for r in P.rhs],  # noqa: E731
                              mass=P.mass, bc_dofs=P.bc_dofs)
    kw = dict(n_max=3, tol_fp=1e-7, dtype=np.float64)
    j = J.SeparatedPGD(zero(toy.jpc, J.SeparatedProblem), **kw).solve_fused()
    t = S.SeparatedPGD(zero(toy.tpc, S.SeparatedProblem), device="cpu", **kw).solve_fused()
    assert t.n_modes == j.n_modes == 0 and t.normU0 == j.normU0 == 1.0
    assert not any(bool(m.any()) for m in t.modes)


def test_rejects_bad_knobs(toy, monkeypatch):
    with pytest.raises(ValueError, match="solver"):
        S.SeparatedPGD(toy.tpc, solver="cholesky", device="cpu")
    with pytest.raises(ValueError, match="fp_init"):
        S.SeparatedPGD(toy.tpc, fp_init="random", device="cpu")
    with pytest.raises(ValueError, match="n_max"):
        S.SeparatedPGD(toy.tpc, n_max=2, device="cpu").solve_fused(3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        S.SeparatedPGD(toy.tpc)  # the default device is CUDA: no quiet CPU run


def test_dtype_is_explicit(toy):
    s = S.SeparatedPGD(toy.tpc, dtype=np.float32, device="cpu")
    assert {t.dtype for t in (*s.problem.ops, *s.problem.rhs, *s.problem.mass,
                              *s.problem.bc_masks)} == {torch.float32}
    assert all(m.dtype == torch.float32 for m in s.init_buffers())
    assert S.SeparatedPGD(toy.tpc, device="cpu").dtype == torch.float64


def test_import_sets_full_f32_matmul():
    # TF32 would cost the f32 enrichment about three digits on a GPU
    code = ("import json, torch, pgdrome_tpu_torch.separated, pgdrome_tpu_torch.recipes; "
            "print(json.dumps([torch.backends.cuda.matmul.allow_tf32, "
            "torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()]))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == [False, False, "highest"]


# ------------------------------------------------- host f64 post-process

@pytest.fixture(scope="module")
def fixed(toy):
    """One JAX f64 result (and a second, shorter one) and their port copies."""
    kw = dict(tol=0.0, tol_fp=1e-7, solver="lu", dtype=np.float64)
    j = J.SeparatedPGD(toy.jpc, n_max=8, **kw).solve_fused()
    j2 = J.PGDResult(modes=[np.asarray(m)[::-1].copy() for m in j.modes], n_modes=5,
                     amplitudes=np.asarray(j.amplitudes)[:5], alpha=np.asarray(j.alpha)[:5],
                     fp_its=np.asarray(j.fp_its)[:5], normU0=0.5)

    def port(r):
        return result_from_numpy(r.modes, r.n_modes, r.amplitudes, r.alpha, r.fp_its, r.normU0)

    return SimpleNamespace(j=j, t=port(j), j2=j2, t2=port(j2))


def _same_problem(t, j, tol=POST):
    for grp in ("ops", "rhs", "mass"):
        for a, b in zip(getattr(t, grp), getattr(j, grp)):
            _close(a, b, tol)
    for a, b in zip(t.bc_dofs, j.bc_dofs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_residual_problem(toy, fixed):
    jsep, js = J.residual_problem(toy.jpc, fixed.j)
    tsep, ts = S.residual_problem(toy.tpc, fixed.t)
    assert abs(ts / js - 1.0) <= POST
    assert tsep.num_rhs == toy.tpc.num_rhs + toy.tpc.num_terms * 8
    _same_problem(tsep, jsep)


def test_pad_rhs_bucket(toy, fixed):
    jsep = J.pad_rhs_bucket(J.residual_problem(toy.jpc, fixed.j)[0], 16)
    tsep = S.pad_rhs_bucket(S.residual_problem(toy.tpc, fixed.t)[0], 16)
    assert tsep.num_rhs == jsep.num_rhs == 32  # 1 + T·K = 25 rows, padded
    _same_problem(tsep, jsep)
    assert S.pad_rhs_bucket(tsep, 16) is tsep


def test_combine_results(fixed):
    j = J.combine_results(fixed.j, fixed.j2, 3.5e-3)
    t = S.combine_results(fixed.t, fixed.t2, 3.5e-3)
    assert t.n_modes == j.n_modes == 13 and t.normU0 == j.normU0
    assert isinstance(t.modes[0], torch.Tensor)  # the base's kind
    for a, b in zip(t.modes, j.modes):
        _close(a, b, POST)
    for key in ("amplitudes", "alpha", "fp_its"):
        _close(getattr(t, key), getattr(j, key), POST)


def test_compress_modes(toy, fixed):
    mass = [toy.tpc.mass[0]] + [toy.tpc.ops[j][0] for j in (1, 2)]
    j = J.compress_modes(fixed.j, mass, 5, n_iters=20)
    t = S.compress_modes(fixed.t, mass, 5, n_iters=20)
    assert t.n_modes == j.n_modes == 5
    for a, b in zip(t.modes, j.modes):
        _close(a, b, POST)
    with pytest.raises(ValueError, match="n_to"):
        S.compress_modes(fixed.t, mass, 8)


def test_galerkin_update(toy, fixed):
    j = J.galerkin_update(toy.jpc, fixed.j)
    t = S.galerkin_update(toy.tpc, fixed.t)
    assert t.modes[1] is fixed.t.modes[1]
    for a, b in zip(t.modes, j.modes):
        _close(a, b, POST)


# -------------------------------------------------------- dense verifier

@pytest.mark.parametrize("num_params,kw", [
    (2, dict(n_random=6, seeds=(7, 101), n_edge=3)),
    (3, dict(n_random=4, seeds=(5,), corner_cap=4, n_edge=2, rhs=True)),
    (3, dict(n_random=0, seeds=(11, 12), n_edge=4)),
], ids=["d2-edges", "d3-cap-rhs", "d3-edges-only"])
def test_dense_verifier(num_params, kw):
    kw = dict(kw)
    pair = _pair(n_x=24, n_p=8, num_params=num_params)
    rng = np.random.default_rng(num_params)
    if kw.pop("rhs", False):
        kw["rhs_vec"] = rng.uniform(0.0, 1.0, size=pair.tV[0].ndofs)
    n_int = len(pair.ttf.interior)
    modes = [rng.normal(size=(7, n_int))] + [
        rng.uniform(0.5, 1.5, size=(7, V.ndofs)) for V in pair.tV[1:]
    ]
    args = (modes, 6, np.ones(6), np.ones(6), np.zeros(6))
    jres = J.PGDResult(modes=modes, n_modes=6, amplitudes=args[2], alpha=args[3],
                       fp_its=args[4])
    tres = result_from_numpy(*args)
    jv = j_verifier(pair.jV, pair.jtf, **kw)
    tv = t_verifier(pair.tV, pair.ttf, **kw)
    a, b = jv(jres), tv(tres)
    assert set(a) == set(b)
    for key in ("corners", "interior", "max"):
        assert abs(a[key] - b[key]) <= VER * a[key]
    np.testing.assert_array_equal(b["worst_points"], a["worst_points"])
    _close(b["worst_errors"], a["worst_errors"], VER)
    np.testing.assert_array_equal(tv.corners, jv.corners)
    pts = rng.uniform(0.0, 1.0, size=(5, num_params))
    _close(tv.sample_errors(tres, pts), jv.sample_errors(jres, pts), VER)
    # the held-out set the port exposes is the one verify() ran over
    groups = [tv.sample_errors(tres, p).max() for p in tv.samples.values() if len(p)]
    assert abs(max(groups) - b["max"]) <= VER * b["max"]
    assert len(tv.samples) == 1 + len(kw["seeds"])


def test_d5_galerkin_gate():
    # full width, no solve: the committed rank-640 d=5 state on its
    # (8.0, 6)-boosted build, updated by both packages' galerkin_update
    sep, Vs = t_elliptic(n_x=1024, n_p=128, num_params=5, degree_x=2,
                         boundary_boost=(8.0, 6))
    pc, tf = S.precondition_dim0(sep, np.float64)
    del sep
    state = load_state_npz(STATE)
    t = S.galerkin_update(pc, state)
    with np.load(STATE) as z:
        jstate = J.PGDResult(modes=[z[f"m{d}"] for d in range(6)], n_modes=int(z["n_modes"]),
                             amplitudes=z["amplitudes"], alpha=z["alpha"],
                             fp_its=z["fp_its"], normU0=float(z["normU0"]))
    j = J.galerkin_update(J.SeparatedProblem(ops=pc.ops, rhs=pc.rhs, mass=pc.mass,
                                             bc_dofs=pc.bc_dofs), jstate)
    _close(t.modes[0], j.modes[0], POST)
    verify = t_verifier(Vs, tf, n_random=0, seeds=())
    err = verify.sample_errors(t, verify.corners)
    assert len(err) == 32
    assert abs(err.max() - 6.7265e-7) < 5e-12
