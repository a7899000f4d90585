"""The port's anchored-ANOVA start against the JAX package's, on the CPU.

Host f64 in both packages: ``Dim0Transform.full_to_modes``,
``CollocationPointSolver.solve`` and ``anova_init`` (orders 1 and 2) at the
JAX test's own size (``tests/unit/test_anova.py``: ``n_x=48, n_p=12,
num_params=3``) agree to 1e-12, the reports key for key (but the seconds).
"""

import numpy as np
import pytest
import torch

from pgdrome_tpu import anova as JA
from pgdrome_tpu.models.problems import parametric_elliptic as j_elliptic
from pgdrome_tpu.separated import precondition_dim0 as j_pre

from pgdrome_tpu_torch import anova as TA
from pgdrome_tpu_torch.models.problems import elliptic_fem_solver
from pgdrome_tpu_torch.models.problems import parametric_elliptic as t_elliptic
from pgdrome_tpu_torch.separated import precondition_dim0 as t_pre

TOL = 1e-12
SIZE = dict(n_x=48, n_p=12, num_params=3, degree_x=2)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite's workers share a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def problems():
    jsep, _ = j_elliptic(**SIZE)
    tsep, tVs = t_elliptic(**SIZE)
    _, jtf = j_pre(jsep, dtype=np.float64)
    _, ttf = t_pre(tsep, np.float64)
    return jsep, jtf, tsep, ttf, tVs


def _close(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= TOL * max(np.abs(a).max(), 1e-300)


def test_full_to_modes(problems):
    _, jtf, _, ttf, tVs = problems
    rng = np.random.default_rng(0)
    X = np.zeros((4, tVs[0].dim()))
    X[:, ttf.interior] = rng.standard_normal((4, len(ttf.interior)))
    y = ttf.full_to_modes(X)
    _close(jtf.full_to_modes(X), y)
    _close(X, ttf.modes_to_full(y))
    _close(y, ttf.full_to_modes(torch.from_numpy(X)))  # tensors too


@pytest.mark.parametrize("idx", [(1, 3, 7), (5, 5, 5), (11, 1, 9), (0, 12, 6)])
def test_point_solver(problems, idx):
    jsep, _, tsep, _, tVs = problems
    u = TA.CollocationPointSolver(tsep).solve(idx)
    _close(JA.CollocationPointSolver(jsep).solve(idx), u)
    if 0 not in idx and 12 not in idx:
        # the exact per-point FEM solve at interior grid points
        grid = tVs[1].tabulate_dof_coordinates()[:, 0]
        ref = elliptic_fem_solver(tVs[0], 3)(grid[list(idx)])
        assert np.linalg.norm(u - ref) <= 1e-10 * np.linalg.norm(ref)


@pytest.mark.parametrize("order", [1, 2])
def test_anova_init(problems, order):
    jsep, jtf, tsep, ttf, _ = problems
    jres, jrep = JA.anova_init(jsep, order=order, tf=jtf)
    tres, trep = TA.anova_init(tsep, order=order, tf=ttf)
    assert tres.n_modes == jres.n_modes == trep["rank"]
    assert tres.n_modes == (13 if order == 1 else 34)
    for a, b in zip(jres.modes, tres.modes):
        _close(a, b)
    for key in ("amplitudes", "alpha", "fp_its"):
        np.testing.assert_array_equal(getattr(tres, key), np.asarray(getattr(jres, key)))
    assert trep.keys() == jrep.keys()
    for key in ("order", "anchor", "rank", "axis"):
        assert trep[key] == jrep[key]
    _close(jrep["norm_u0"], trep["norm_u0"])
    assert len(trep["pairs"]) == len(jrep["pairs"]) == (3 if order == 2 else 0)
    for a, b in zip(jrep["pairs"], trep["pairs"]):
        assert b.keys() == a.keys()
        assert {k: v for k, v in b.items() if k != "s"} == {
            k: v for k, v in a.items() if k != "s"}


def test_non_collocation_raises():
    sep, _ = t_elliptic(n_x=24, n_p=8, num_params=2, param_discretization="galerkin")
    with pytest.raises(ValueError, match="collocation"):
        TA.CollocationPointSolver(sep)
    with pytest.raises(ValueError, match="collocation"):
        TA.anova_init(sep, order=1)
