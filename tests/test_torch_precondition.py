"""The port's dim-0 energy-basis transform against the JAX package's.

``precondition_dim0`` / ``precondition_dim`` operators and ``modes_to_full``
must agree to 1e-12 relative to the largest entry, at toy size and on the
committed d=5 state (host only).
"""

from pathlib import Path

import numpy as np
import pytest

from pgdrome_tpu.models import problems as jp
from pgdrome_tpu import separated as js

from pgdrome_tpu_torch.models import problems as tp
from pgdrome_tpu_torch import separated as ts
from pgdrome_tpu_torch.convert import load_state_npz, frontier_build

TOL = 1e-12
STATE = Path(__file__).resolve().parent.parent / "states" / "frontier_d5_state.npz"


def _close(a, b, tol=TOL):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-300)


def _problems(n_x, degree_x, num_params=2):
    return (jp.parametric_elliptic(n_x=n_x, n_p=16, num_params=num_params, degree_x=degree_x),
            tp.parametric_elliptic(n_x=n_x, n_p=16, num_params=num_params, degree_x=degree_x))


# n_x=40 takes the banded Cholesky path, n_x=3 (P1) the dense one
@pytest.mark.parametrize("n_x,degree_x", [(40, 1), (40, 2), (3, 1)])
def test_precondition_dim0(n_x, degree_x):
    (jsep, _), (tsep, _) = _problems(n_x, degree_x)
    jnew, jtf = js.precondition_dim0(jsep, np.float64)
    tnew, ttf = ts.precondition_dim0(tsep, np.float64)
    assert (ttf.banded is None) == (jtf.banded is None)
    np.testing.assert_array_equal(ttf.interior, jtf.interior)
    for d in range(jsep.num_dims):
        _close(tnew.ops[d], jnew.ops[d])
        _close(tnew.rhs[d], jnew.rhs[d])
        _close(tnew.mass[d], jnew.mass[d])
        np.testing.assert_array_equal(tnew.bc_dofs[d], jnew.bc_dofs[d])
    modes = np.random.default_rng(n_x).normal(size=(7, len(jtf.interior)))
    _close(ttf.modes_to_full(modes), jtf.modes_to_full(modes))


@pytest.mark.parametrize("dim", [0, 1])
def test_precondition_dim_with_base(dim):
    (jsep, _), (tsep, _) = _problems(40, 2)
    base = np.asarray(jsep.mass[dim]) + np.asarray(jsep.ops[dim][0])
    jnew, jtf = js.precondition_dim(jsep, dim=dim, dtype=np.float64, base=base)
    tnew, ttf = ts.precondition_dim(tsep, dim=dim, dtype=np.float64, base=base)
    for d in range(jsep.num_dims):
        _close(tnew.ops[d], jnew.ops[d])
        _close(tnew.rhs[d], jnew.rhs[d])
    modes = np.random.default_rng(dim).normal(size=(4, len(jtf.interior)))
    _close(ttf.modes_to_full(modes), jtf.modes_to_full(modes))


def test_float32_output():
    (jsep, _), (tsep, _) = _problems(40, 2)
    jnew, _ = js.precondition_dim0(jsep)
    tnew, _ = ts.precondition_dim0(tsep)
    assert tnew.ops[0].dtype == np.float32
    np.testing.assert_array_equal(tnew.ops[0], jnew.ops[0])


@pytest.fixture(scope="module")
def frontier():
    sep, Vs = jp.parametric_elliptic(n_x=1024, n_p=128, num_params=5, degree_x=2)
    _, jtf = js.precondition_dim0(sep, np.float64)
    tV, ttf = frontier_build(5)
    return jtf, ttf, tV


def test_frontier_state_modes_to_full(frontier):
    jtf, ttf, tV = frontier
    res = load_state_npz(STATE)
    with np.load(STATE) as z:
        m0 = z["m0"][: int(z["n_modes"])]
        np.testing.assert_array_equal(res.modes[0].numpy(), z["m0"])
        for d in range(1, 6):
            np.testing.assert_array_equal(res.modes[d].numpy(), z[f"m{d}"])
        assert res.n_modes == int(z["n_modes"])
        np.testing.assert_array_equal(res.amplitudes, z["amplitudes"])
    assert tV[0].ndofs == 2049 and all(v.ndofs == 129 for v in tV[1:])
    _close(ttf.modes_to_full(m0), jtf.modes_to_full(m0))


def test_frontier_transform_factor(frontier):
    jtf, ttf, _ = frontier
    np.testing.assert_array_equal(ttf.interior, jtf.interior)
    for a, b in zip(ttf.banded, jtf.banded):
        _close(a, b)
