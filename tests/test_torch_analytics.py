"""The port's serving analytics against the JAX package's, on the CPU.

The same numpy-seeded f64 modes go to both packages' ``Vademecum`` (the
port's with ``dtype=torch.float64, device="cpu"``, the JAX one with
``dtype=np.float64``, x64 on): a P2 dim-0 space and three parameter dims
(P1 on [0, 1], P2 on [0, 1], P1 on [0.5, 2]), five of six buffered modes
served.

Tolerances (all relative to the largest reference value):

- derivative evaluation, ``errors``, ``fix_parameters``, the derivative
  vademecum and the Jacobian: 1e-12;
- the fit's p̂, resnorm and covariance: 1e-9, every start compared, and the
  same winning start;
- the MCMC chain fed JAX's own draws (``keys = split(key, n_steps)``, per
  step ``k1, k2 = split(k)``): 1e-12, with identical accept decisions;
- ``sample_posterior``'s pooled mean: within 4 Monte-Carlo standard errors
  (posterior std / √ESS of both runs, combined);
- ``design_sensors``: the same indices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgdrome_tpu.fem import derivative as JD
from pgdrome_tpu.fem.interpolate import eval_dofs_at_points as j_eval_dofs
from pgdrome_tpu.fem.function import Function as JFunction
from pgdrome_tpu.fem.mesh import IntervalMesh as JMesh
from pgdrome_tpu.fem.space import FunctionSpace as JSpace
from pgdrome_tpu.parallel import vademecum as JPV
from pgdrome_tpu.parallel.bayes import make_mcmc_fn as j_mcmc
from pgdrome_tpu.separated import PGDResult as JResult
from pgdrome_tpu.separated import evaluate_modes_1d as j_eval_modes
from pgdrome_tpu.serving import Vademecum as JVademecum

from pgdrome_tpu_torch.convert import result_from_numpy
from pgdrome_tpu_torch.fem import derivative as TD
from pgdrome_tpu_torch.fem.interpolate import eval_dofs_at_points as t_eval_dofs
from pgdrome_tpu_torch.fem.function import Function as TFunction
from pgdrome_tpu_torch.fem.mesh import IntervalMesh as TMesh
from pgdrome_tpu_torch.fem.space import FunctionSpace as TSpace
from pgdrome_tpu_torch.parallel import vademecum as TPV
from pgdrome_tpu_torch.parallel.bayes import make_mcmc_fn as t_mcmc
from pgdrome_tpu_torch.separated import evaluate_modes_1d as t_eval_modes
from pgdrome_tpu_torch.separated import make_evaluator
from pgdrome_tpu_torch.serving import Vademecum

EXACT = 1e-12
FIT_TOL = 1e-9
# (cells, degree, a, b) of dim 0 and the three parameter dims
DIMS = [(12, 2, 0.0, 1.0), (16, 1, 0.0, 1.0), (8, 2, 0.0, 1.0), (10, 1, 0.5, 2.0)]
N_MAX, N_MODES = 6, 5
PTS = np.array([0.0, 0.13, 0.25, 0.5, 0.77, 1.0])


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite's workers share a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(a, b, tol):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(np.abs(b).max(), 1e-300)
    assert np.abs(a - b).max() <= tol * scale, np.abs(a - b).max() / scale


def _spaces(dims=DIMS):
    js = [JSpace(JMesh(n, a, b), "P", k) for n, k, a, b in dims]
    ts = [TSpace(TMesh(n, a, b), "P", k) for n, k, a, b in dims]
    return js, ts


def _modes(ts, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(N_MAX, ts[0].ndofs))] + [
        rng.uniform(0.5, 1.5, size=(N_MAX, V.ndofs)) for V in ts[1:]]


def _pair(dims=DIMS, seed=0, dtype=torch.float64, method="torch"):
    js, ts = _spaces(dims)
    modes = _modes(ts, seed)
    traces = [np.arange(N_MAX, dtype=np.float64)] * 3
    jres = JResult(modes=modes, n_modes=N_MODES, amplitudes=traces[0], alpha=traces[1],
                   fp_its=traces[2], normU0=1.0)
    tres = result_from_numpy(modes, N_MODES, *traces)
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    return (JVademecum(js, jres, method="xla", dtype=np_dt),
            Vademecum(ts, tres, method=method, dtype=dtype, device="cpu"))


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _box_samples(B, seed, interior=False):
    """Samples in the parameter box; ``interior`` keeps them inside grid
    cells (a quarter cell from each node), else rows pin the box ends and
    grid nodes, where the derivative is one-sided."""
    rng = np.random.default_rng(seed)
    cols = []
    for n, _, a, b in DIMS[1:]:
        if interior:
            t = (rng.integers(0, n, size=B) + rng.uniform(0.25, 0.75, size=B)) / n
        else:
            t = rng.uniform(0, 1, size=B)
            t[:3] = [0.0, 1.0, 3.0 / n]
        cols.append(a + (b - a) * t)
    return np.stack(cols, axis=1)


# ---------------------------------------------------------------- fem

@pytest.mark.parametrize("degree", [1, 2])
def test_evaluate_modes_derivative(degree):
    (jV,), (tV,) = _spaces([(16, degree, 0.5, 2.0)])
    buf = np.random.default_rng(degree).normal(size=(N_MAX, tV.ndofs))
    x = np.concatenate([np.linspace(0.5, 2.0, 17), np.random.default_rng(9).uniform(0.5, 2.0, 40)])
    got = t_eval_modes(tV, torch.from_numpy(buf), torch.from_numpy(x), derivative=True)
    _close(got.numpy(), j_eval_modes(jV, buf, x, xp=np, derivative=True), EXACT)
    _close(got.numpy(), j_eval_modes(jV, jnp.asarray(buf), jnp.asarray(x), derivative=True),
           EXACT)
    # the values too (the derivative shares the locate)
    _close(t_eval_modes(tV, torch.from_numpy(buf), torch.from_numpy(x)).numpy(),
           j_eval_modes(jV, buf, x, xp=np), EXACT)


@pytest.mark.parametrize("family,degree", [("P", 1), ("P", 2), ("DG", 0), ("DG", 1)])
def test_spaces_and_point_derivatives(family, degree):
    jV = JSpace(JMesh(9, -1.0, 2.0), family, degree)
    tV = TSpace(TMesh(9, -1.0, 2.0), family, degree)
    assert tV.ndofs == jV.ndofs and tV.family == jV.family
    assert np.array_equal(tV.element_dofs, jV.element_dofs)
    assert np.array_equal(tV.dof_coords, jV.dof_coords)
    from pgdrome_tpu.fem.assembly import mass_matrix as j_mass
    from pgdrome_tpu_torch.fem.assembly import mass_matrix as t_mass

    _close(t_mass(tV), np.asarray(j_mass(jV).todense() if hasattr(j_mass(jV), "todense")
                                  else j_mass(jV)), EXACT)
    dofs = np.random.default_rng(3).normal(size=tV.ndofs)
    x = np.concatenate([np.linspace(-1.0, 2.0, 10), [0.123, 1.777]])
    for derivative in (False, True):
        want = j_eval_dofs(jV, dofs, x, derivative=derivative)
        _close(t_eval_dofs(tV, dofs, x, derivative=derivative), want, EXACT)
        got = t_eval_dofs(tV, torch.from_numpy(dofs), torch.from_numpy(x),
                                     xp=torch, derivative=derivative)
        _close(got.numpy(), want, EXACT)


@pytest.mark.parametrize("degree", [1, 2])
def test_derivative_function(degree):
    jV = JSpace(JMesh(11, 0.0, 3.0), "P", degree)
    tV = TSpace(TMesh(11, 0.0, 3.0), "P", degree)
    dofs = np.random.default_rng(degree).normal(size=tV.ndofs)
    jd = JD.derivative_function(JFunction(jV, dofs))
    td = TD.derivative_function(TFunction(tV, dofs))
    Vd = td.function_space()
    assert (Vd.family, Vd.degree) == ("DG", degree - 1)
    assert Vd is TD._dg_space(tV.mesh(), degree - 1)  # cached per mesh
    _close(td.array, jd.array, EXACT)


def test_make_evaluator(pair):
    _, tvd = pair
    rng = np.random.default_rng(4)
    fac = rng.normal(size=(7, N_MODES))
    got = make_evaluator(tvd._modes, tvd.n_modes)(fac)
    _close(got.numpy(), fac @ np.asarray(tvd._modes[0]), EXACT)
    # a padded buffer and wider factor rows: only the first n_modes enter
    padded = [np.vstack([np.asarray(m), np.full((2, m.shape[1]), 7.0)]) for m in tvd._modes]
    wide = np.hstack([fac, rng.normal(size=(7, 2))])
    got_p = make_evaluator([torch.from_numpy(m) for m in padded], tvd.n_modes)(wide)
    _close(got_p.numpy(), got.numpy(), EXACT)


# ------------------------------------------------- errors, Jacobian

def test_errors(pair):
    jvd, tvd = pair
    s = _box_samples(9, 1)
    fom = np.asarray(jvd.fields(jnp.asarray(s))) * (1 + 1e-3 * np.random.default_rng(2).normal(
        size=(9, tvd._modes[0].shape[1])))
    want = np.asarray(jvd.errors(jnp.asarray(s), fom))
    _close(tvd.errors(s, fom).numpy(), want, EXACT)
    ts = tvd.spaces
    _close(TPV.sweep_errors(ts, tvd._modes, tvd.n_modes, s, fom).numpy(), want, EXACT)


@pytest.mark.parametrize("interior", [True, False])
def test_sensors_jacobian(pair, interior):
    jvd, tvd = pair
    s = _box_samples(11, 5, interior=interior)
    jac = tvd.sensors_jacobian(PTS)
    assert tvd.sensors_jacobian(PTS) is jac and tvd.sensors(PTS) is not jac
    J = jac(s).numpy()
    assert J.shape == (11, len(PTS), 3)
    _close(J, np.asarray(jvd.sensors_jacobian(PTS)(jnp.asarray(s))), EXACT)
    if interior:  # central differences of the port's own sensor sweep
        h = 1e-7
        sens = tvd.sensors(PTS)
        for j in range(3):
            dp = np.zeros(3)
            dp[j] = h
            fd = (sens(s + dp) - sens(s - dp)).numpy() / (2 * h)
            np.testing.assert_allclose(J[:, :, j], fd, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------ the fit

def _observations(jvd, B, seed, noise=1e-4):
    rng = np.random.default_rng(seed)
    p_true = _box_samples(B, seed + 1, interior=True)
    clean = np.asarray(jvd.sensors(PTS)(jnp.asarray(p_true)))
    return p_true, clean + noise * np.abs(clean).mean() * rng.normal(size=clean.shape)


FIT_CASES = {
    "plain": {},
    "weighted_prior": dict(weights=np.linspace(0.5, 2.0, len(PTS)),
                           prior=(np.array([0.4, 0.6, 1.2]), np.array([0.3, 0.1, 0.2]))),
}


@pytest.mark.parametrize("case", sorted(FIT_CASES))
def test_fit_every_start(pair, case):
    jvd, tvd = pair
    kw = FIT_CASES[case]
    _, obs = _observations(jvd, 4, 10)
    p0 = _box_samples(4 * 3, 20)
    obs_t = np.repeat(obs, 3, axis=0)
    jfit = JPV.make_fit_fn(jvd.spaces, jvd._modes, N_MODES, PTS, n_iter=12, **kw)
    tfit = TPV.make_fit_fn(tvd.spaces, tvd._modes, N_MODES, PTS, n_iter=12, **kw)
    jp, jr = (np.asarray(a) for a in jfit(jnp.asarray(obs_t), jnp.asarray(p0)))
    tp, tr = (a.numpy() for a in tfit(obs_t, p0))
    _close(tp, jp, FIT_TOL)
    _close(tr, jr, FIT_TOL)


@pytest.mark.parametrize("case", sorted(FIT_CASES))
def test_fit_parameters(pair, case):
    jvd, tvd = pair
    kw = FIT_CASES[case]
    _, obs = _observations(jvd, 3, 30)
    if case == "plain":  # Latin-hypercube starts raced, and the covariance
        kw = dict(n_starts=4, seed=3, return_covariance=True)
    else:  # explicit starts
        kw = dict(kw, p0=_box_samples(3, 31))
    want = jvd.fit_parameters(PTS, obs, n_iter=8, **kw)
    got = tvd.fit_parameters(PTS, obs, n_iter=8, **kw)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _close(a, b, FIT_TOL)
    if case != "plain":
        with pytest.raises(ValueError):
            tvd.fit_parameters(PTS, obs, p0=kw["p0"][:2])


def test_fit_recovers_interior_parameters():
    # u(x; p, q) = x·p + x²·q is linear in (p, q): the fit recovers them
    Vx, Vp, Vq = (TSpace(TMesh(n, 0.0, 1.0), "P", k) for n, k in ((8, 2), (6, 1), (6, 1)))
    x, p, q = (V.dof_coords[:, 0] for V in (Vx, Vp, Vq))
    modes = [np.stack([x, x ** 2]), np.stack([p, np.ones_like(p)]),
             np.stack([np.ones_like(q), q])]
    vd = Vademecum([Vx, Vp, Vq], result_from_numpy(modes, 2, *[np.ones(2)] * 3),
                   dtype=torch.float64, device="cpu")
    p_true = np.array([[0.3, 0.7], [0.55, 0.2]])
    obs = vd.sensors(PTS)(p_true).numpy()
    p_hat, res = vd.fit_parameters(PTS, obs, n_iter=40)
    assert np.all(res < 1e-12)
    np.testing.assert_allclose(p_hat, p_true, atol=1e-9)


# --------------------------------------------------------- posterior

def _jax_draws(key, n_steps, C, d_p):
    """The normals and exponentials JAX's sampler draws from ``key``, drawn
    by the same compiled scan (XLA's fused transforms of the random bits
    differ from op-by-op ones in the last bits)."""
    def step(carry, k):
        k1, k2 = jax.random.split(k)
        return carry, (jax.random.normal(k1, (C, d_p), jnp.float64),
                       jax.random.exponential(k2, (C,), jnp.float64))

    _, (eps, e) = jax.jit(lambda key: jax.lax.scan(step, 0, jax.random.split(key, n_steps)))(key)
    return np.array(eps), np.array(e)


def test_mcmc_chain_with_jax_draws(pair):
    jvd, tvd = pair
    p_true, obs = _observations(jvd, 1, 50, noise=0.0)
    obs = obs[0]
    sig = np.full(len(PTS), 1e-2 * np.abs(obs).max())
    prior = (np.array([0.5, 0.5, 1.0]), 0.5)
    n_steps, C = 40, 6
    p0 = np.clip(p_true + 0.02 * np.random.default_rng(1).normal(size=(C, 3)),
                 [0.0, 0.0, 0.5], [1.0, 1.0, 2.0])
    chol = np.diag([0.03, 0.02, 0.05])
    key = jax.random.PRNGKey(7)
    jfn = j_mcmc(jvd.spaces, jvd._modes, N_MODES, PTS, n_steps=n_steps, prior=prior)
    jchain, jacc = jfn(jnp.asarray(obs), jnp.asarray(sig), jnp.asarray(p0), jnp.asarray(chol),
                       jnp.asarray(0.9), key)
    eps, e = _jax_draws(key, n_steps, C, 3)
    tfn = t_mcmc(tvd.spaces, tvd._modes, N_MODES, PTS, n_steps=n_steps, prior=prior)
    tchain, tacc = tfn(obs, sig, p0, chol, 0.9, eps=eps, e=e)
    jchain = np.asarray(jchain)
    assert np.array_equal(tacc.numpy(), np.asarray(jacc))
    moved = np.diff(np.concatenate([p0[None], jchain]), axis=0).any(-1)
    assert np.array_equal(np.diff(np.concatenate([p0[None], tchain.numpy()]), axis=0).any(-1),
                          moved)
    assert 0 < moved.sum() < moved.size  # some proposals rejected, some taken
    _close(tchain.numpy(), jchain, EXACT)
    # draws from a generator: reproducible from its seed
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    a, _ = tfn(obs, sig, p0, chol, 0.9, generator=g1)
    b, _ = tfn(obs, sig, p0, chol, 0.9, generator=g2)
    assert torch.equal(a, b)


def test_sample_posterior_and_design(pair):
    jvd, tvd = pair
    p_true, obs = _observations(jvd, 1, 60, noise=0.0)
    sig = 2e-3 * np.abs(obs).max()
    # the adaptation rounds and the main run take 60 steps each: one compiled
    # JAX sampler serves both
    kw = dict(n_samples=40, n_chains=32, n_adapt=1, adapt_steps=60, seed=4)
    jout = jvd.sample_posterior(PTS, obs[0], sig, **kw)
    tout = tvd.sample_posterior(PTS, obs[0], sig, **kw)
    _close(tout["p_map"], jout["p_map"], FIT_TOL)
    assert tout["chains"].shape == (40, 32, 3) and tout["samples"].shape == (1280, 3)
    assert 0.05 < tout["acceptance"] < 0.8
    sd = tout["samples"].std(axis=0)
    se = np.sqrt(sd ** 2 / tout["ess"] + jout["samples"].std(axis=0) ** 2 / jout["ess"])
    gap = np.abs(tout["samples"].mean(axis=0) - jout["samples"].mean(axis=0))
    assert np.all(gap <= 4 * se), (gap, se)

    cands = np.linspace(0.0, 1.0, 21)
    samples = _box_samples(5, 70)
    for n in (2, 5):
        ji, jp = jvd.design_sensors(cands, n, samples=samples)
        ti, tp = tvd.design_sensors(cands, n, samples=samples)
        assert np.array_equal(ti, np.asarray(ji)) and np.array_equal(tp, jp)
    assert np.array_equal(tvd.design_sensors(cands, 3)[0], jvd.design_sensors(cands, 3)[0])


# ------------------------------------------- slices and derivatives

@pytest.mark.parametrize("fixed", [{1: 0.37}, {0: 0.0, 2: 1.3}])
def test_fix_parameters(pair, fixed):
    jvd, tvd = pair
    jsub, tsub = jvd.fix_parameters(fixed), tvd.fix_parameters(fixed)
    free = [j for j in range(3) if j not in fixed]
    assert tsub.num_dims == 1 + len(free) and tsub.device == tvd.device
    s = _box_samples(13, 80)[:, free]
    _close(tsub.fields(s).numpy(), np.asarray(jsub.fields(jnp.asarray(s))), EXACT)
    _close(tsub.sensors(PTS)(s).numpy(), np.asarray(jsub.sensors(PTS)(jnp.asarray(s))), EXACT)
    # the full vademecum with the fixed values inserted
    full = np.empty((13, 3))
    full[:, free] = s
    for j, v in fixed.items():
        full[:, j] = v
    _close(tsub.fields(s).numpy(), tvd.fields(full).numpy(), EXACT)
    for bad in ({}, {0: 0.1, 1: 0.2, 2: 1.0}, {3: 0.5}, {2: 3.0}):
        with pytest.raises(ValueError):
            tvd.fix_parameters(bad)


def test_fix_parameters_kernel_wiring():
    # the f32 slice through the kernel's plain twin (the CPU's path) against
    # the f64 full vademecum: within f32 rounding
    jvd64, tvd64 = _pair()
    _, tvd32 = _pair(dtype=torch.float32, method="fused")
    sub = tvd32.fix_parameters({1: 0.25})
    from pgdrome_tpu_torch.ops.fused_sweep import FusedSweep

    assert isinstance(sub._sweep(), FusedSweep)
    s = _box_samples(17, 90)[:, [0, 2]]
    full = np.insert(s, 1, 0.25, axis=1)
    _close(sub.fields(s).double().numpy(), tvd64.fields(full).numpy(), 1e-6)


def test_derivative_vademecum(pair):
    jvd, tvd = pair
    jd, td = jvd.derivative(), tvd.derivative()
    V = td.spaces[0]
    assert (V.family, V.degree, V.ndofs) == ("DG", 1, 24)
    s = _box_samples(10, 100)
    _close(td.fields(s).numpy(), np.asarray(jd.fields(jnp.asarray(s))), EXACT)
    _close(td.sensors(PTS)(s).numpy(), np.asarray(jd.sensors(PTS)(jnp.asarray(s))), EXACT)
    # served d/dx equals the x-derivative of the served field at the points
    x = np.array([0.1, 0.4, 0.9])
    u = tvd.fields(s).numpy()
    dudx = np.stack([t_eval_dofs(tvd.spaces[0], row, x, derivative=True)
                     for row in u])
    _close(td.sensors(x)(s).numpy(), dudx, EXACT)


def fit_reference():
    """The fits on a CPU that ``chip_smoke.py``'s ``analytics`` gate is
    derived from: the committed d=5 vademecum, 16 sensors, 1024 interior
    parameter sets from ``default_rng(20261017)``, 8 Latin-hypercube
    starts — the phase's fit.  In f64 (its f32 modes in f64) the fit
    recovers the parameters; in f32, the phase's dtype in this machine's
    arithmetic, the gate's quantities at 30 iterations and at 1 (a fit cut
    short, which the gate must refuse): ν, the f32 residual at the truth
    (``n_iter=0``), and ‖p̂ − p‖₂ against 2ν / σ_min(J(p))."""
    from pathlib import Path

    from pgdrome_tpu_torch.convert import frontier_vademecum

    state = Path(__file__).resolve().parent.parent / "states" / "frontier_d5_state.npz"
    vd32 = frontier_vademecum(state, 5, device="cpu")
    vd = Vademecum(vd32.spaces, vd32.result, method="torch", dtype=torch.float64, device="cpu")
    pts = np.linspace(0.03, 0.97, 16)
    p_true = np.random.default_rng(20261017).uniform(0.1, 0.9, size=(1024, 5))
    obs = vd.sensors(pts)(p_true).numpy()
    p_hat, res = vd.fit_parameters(pts, obs, n_starts=8, seed=0, n_iter=30)
    err = np.abs(p_hat - p_true)
    print(f"f64 fit of 1024 observations x 8 starts: max |p̂ − p| {err.max():.3e}, median "
          f"{np.median(err):.3e}; resnorm max {res.max():.3e} (max |obs| "
          f"{np.abs(obs).max():.4e})")
    smin = np.linalg.svd(vd.sensors_jacobian(pts)(p_true).numpy(), compute_uv=False)[:, -1]
    nu = float(vd32.fit_parameters(pts, obs, p0=p_true, n_iter=0)[1].max())
    limit = 2.0 * nu / smin
    for n_iter in (30, 1):
        p32, r32 = vd32.fit_parameters(pts, obs, n_starts=8, seed=0, n_iter=n_iter)
        e2 = np.linalg.norm(p32 - p_true, axis=1)
        passes = bool(r32.max() <= nu and (e2 <= limit).all())
        print(f"f32 fit, {n_iter} iterations: max |p̂ − p| {np.abs(p32 - p_true).max():.3e}; "
              f"resnorm max {r32.max():.3e} (ν {nu:.3e}); ‖p̂ − p‖₂ / (2ν/σ_min) max "
              f"{(e2 / limit).max():.4f}, median {np.median(e2 / limit):.4f}; the gate "
              f"{'passes' if passes else 'refuses'}")


if __name__ == "__main__":
    fit_reference()
