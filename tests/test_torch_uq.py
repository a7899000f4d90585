"""The port's exact Sobol'/ANOVA machinery (``pgdrome_tpu_torch/uq.py`` and
the ``Vademecum`` methods on it) against the JAX package's, on the CPU.

Host numpy in f64 on both sides: the same numpy-seeded modes (a P2 dim-0
space, parameter dims P1 on [0, 1], P2 on [0, 1] and P1 on [0.5, 2]) go to
each package's ``factor_stats`` and ``Vademecum``; every index, variance,
mean, covariance, main effect and MCMC diagnostic agrees to 1e-12 of the
largest reference value.  One closed-form case (u = x·p + x²·q², additive)
holds the port to the analytic indices as well.
"""

import numpy as np
import pytest
import torch

from pgdrome_tpu import uq as JU
from pgdrome_tpu.fem.function import Function as JFunction
from pgdrome_tpu.fem.mesh import IntervalMesh as JMesh
from pgdrome_tpu.fem.space import FunctionSpace as JSpace
from pgdrome_tpu.separated import PGDResult as JResult
from pgdrome_tpu.serving import Vademecum as JVademecum

from pgdrome_tpu_torch import uq as TU
from pgdrome_tpu_torch.convert import result_from_numpy
from pgdrome_tpu_torch.fem.function import Function as TFunction
from pgdrome_tpu_torch.fem.mesh import IntervalMesh as TMesh
from pgdrome_tpu_torch.fem.space import FunctionSpace as TSpace
from pgdrome_tpu_torch.serving import Vademecum

EXACT = 1e-12
DIMS = [(10, 2, 0.0, 1.0), (12, 1, 0.0, 1.0), (6, 2, 0.0, 1.0), (8, 1, 0.5, 2.0)]
K = 5
PTS = np.array([0.1, 0.35, 0.6, 0.9])


def _close(a, b, tol=EXACT):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(np.abs(b).max(), 1e-300)
    assert np.abs(a - b).max() <= tol * scale, np.abs(a - b).max() / scale


def _dicts_close(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k])


@pytest.fixture(scope="module")
def pair():
    js = [JSpace(JMesh(n, a, b), "P", k) for n, k, a, b in DIMS]
    ts = [TSpace(TMesh(n, a, b), "P", k) for n, k, a, b in DIMS]
    rng = np.random.default_rng(11)
    modes = [rng.normal(size=(K, ts[0].ndofs))] + [
        rng.uniform(0.2, 1.8, size=(K, V.ndofs)) for V in ts[1:]]
    tr = [np.ones(K)] * 3
    jvd = JVademecum(js, JResult(modes=modes, n_modes=K, amplitudes=tr[0], alpha=tr[1],
                                 fp_its=tr[2], normU0=1.0), method="xla", dtype=np.float64)
    tvd = Vademecum(ts, result_from_numpy(modes, K, *tr), dtype=torch.float64, device="cpu")
    return js, ts, modes, jvd, tvd


def _densities(js, ts, which):
    """Per-parameter densities of each package: uniform (None), or a
    scalar, a callable and a fem Function on the factor space."""
    if which == "uniform":
        return None, None
    f = np.linspace(1.0, 2.0, ts[3].ndofs)
    return ([2.0, lambda x: 1.0 + x, JFunction(js[3], f)],
            [2.0, lambda x: 1.0 + x, TFunction(ts[3], f)])


@pytest.mark.parametrize("which", ["uniform", "weighted"])
def test_factor_stats_and_indices(pair, which):
    js, ts, modes, _, _ = pair
    jd, td = _densities(js, ts, which)
    jst = JU.factor_stats(js[1:], modes[1:], K, densities=jd)
    tst = TU.factor_stats(ts[1:], modes[1:], K, densities=td)
    for (jm, jG), (tm, tG) in zip(jst, tst):
        _close(tm, jm)
        _close(tG, jG)
    for g in ([], [0], [1, 2], [0, 1, 2]):
        _close(TU._mixed_product(tst, g), JU._mixed_product(jst, g))
    table = np.random.default_rng(1).normal(size=(K, 6))
    gram = table @ table.T
    for kw in (dict(table=table), dict(out_gram=gram)):
        _dicts_close(TU.sobol_from_stats(tst, second_order=True, **kw),
                     JU.sobol_from_stats(jst, second_order=True, **kw))
        for group in ([1], [0, 2], [0, 1, 2]):
            _dicts_close(TU.sobol_group(tst, group, **kw), JU.sobol_group(jst, group, **kw))
    for got, want in zip(TU.output_covariance(tst, table), JU.output_covariance(jst, table)):
        _close(got, want)
    F = np.random.default_rng(2).normal(size=(K, 7))
    for j in range(3):
        for got, want in zip(TU.main_effect(tst, j, F, table), JU.main_effect(jst, j, F, table)):
            _close(got, want)
    with pytest.raises(ValueError):
        TU.sobol_from_stats(tst)
    with pytest.raises(ValueError):
        TU.factor_stats(ts[1:], modes[1:], K, densities=[None])


def test_mcmc_diagnostics():
    rng = np.random.default_rng(3)
    walk = np.cumsum(rng.normal(size=(200, 4, 3)), axis=0) * [1.0, 0.1, 0.0]
    for chains in (rng.normal(size=(101, 8, 3)), walk, walk + rng.normal(size=walk.shape)):
        _close(TU.split_rhat(chains), JU.split_rhat(chains))
        _close(TU.effective_sample_size(chains), JU.effective_sample_size(chains))
    with pytest.raises(ValueError):
        TU.split_rhat(np.zeros((3, 2, 1)))


@pytest.mark.parametrize("second_order", [False, True])
def test_vademecum_sobol(pair, second_order):
    js, ts, _, jvd, tvd = pair
    jd, td = _densities(js, ts, "weighted")
    for dens in ((None, None), (jd, td)):
        _dicts_close(tvd.sobol(PTS, densities=dens[1], second_order=second_order),
                     jvd.sobol(PTS, densities=dens[0], second_order=second_order))
        _dicts_close(tvd.sobol(densities=dens[1], second_order=second_order),
                     jvd.sobol(densities=dens[0], second_order=second_order))
    _dicts_close(tvd.sobol_group([0, 2], PTS), jvd.sobol_group([0, 2], PTS))
    _dicts_close(tvd.sobol_group([1]), jvd.sobol_group([1]))
    for got, want in zip(tvd.output_covariance(PTS), jvd.output_covariance(PTS)):
        _close(got, want)
    v = np.linspace(0.5, 2.0, 9)
    for got, want in zip(tvd.main_effect(2, v, PTS), jvd.main_effect(2, v, PTS)):
        _close(got, want)
    with pytest.raises(ValueError):
        tvd.main_effect(3, v, PTS)


def test_additive_closed_form():
    # u(x, p, q) = x·p + x²·q² on [0, 1]³: V_p(x) = x²/12, V_q(x) = 4x⁴/45
    Vx, Vp, Vq = (TSpace(TMesh(n, 0.0, 1.0), "P", k) for n, k in ((8, 2), (6, 1), (6, 2)))
    x, p, q = (V.dof_coords[:, 0] for V in (Vx, Vp, Vq))
    modes = [np.stack([x, x ** 2]), np.stack([p, np.ones_like(p)]),
             np.stack([np.ones_like(q), q ** 2])]
    vd = Vademecum([Vx, Vp, Vq], result_from_numpy(modes, 2, *[np.ones(2)] * 3),
                   dtype=torch.float64, device="cpu")
    pts = np.array([0.3, 0.7, 1.0])
    out = vd.sobol(points=pts, second_order=True)
    v_p, v_q = pts ** 2 / 12, pts ** 4 * 4 / 45
    np.testing.assert_allclose(out["mean"], pts / 2 + pts ** 2 / 3, rtol=1e-12)
    np.testing.assert_allclose(out["variance"], v_p + v_q, rtol=1e-12)
    np.testing.assert_allclose(out["first"], out["total"], rtol=1e-10)
    np.testing.assert_allclose(out["first"][0], v_p / (v_p + v_q), rtol=1e-12)
    assert np.abs(out["second"]).max() < 1e-12
    mean, cov = vd.output_covariance(pts)
    np.testing.assert_allclose(np.diag(cov), out["variance"], rtol=1e-12)
    # the derivative vademecum composes: du/dx = p + 2x·q²
    d = vd.derivative().sobol(points=np.array([0.5]))
    np.testing.assert_allclose(d["variance"][0], 1 / 12 + 4 * 0.25 * 4 / 45, rtol=1e-10)
