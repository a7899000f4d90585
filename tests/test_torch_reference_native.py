"""The port's native host helpers (``utils/native.py``) and ``PGDConfig``,
on the CPU: the twins of ``tests/unit/test_native.py``, each entry point
against the JAX package's on the same inputs (bit for bit: the same C++
source), the numpy fallbacks against the library, the library built from
``csrc/pgdrome_native.cpp`` into the port's own ``_build/``, and
``PGDConfig`` applied to a ``PGDProblem`` and passed to ``SeparatedPGD``.
"""

from pathlib import Path

import numpy as np
import pytest

from pgdrome_tpu.ops.fd import FD_matrices as j_fd
from pgdrome_tpu.utils import native as jn
from pgdrome_tpu.utils.pgd_config import PGDConfig as JConfig
from pgdrome_tpu_torch.ops.fd import FD_matrices as t_fd
from pgdrome_tpu_torch.utils import native as tn
from pgdrome_tpu_torch.utils.pgd_config import PGDConfig

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def fallback(monkeypatch):
    """The port's native module with its library switched off."""
    monkeypatch.setattr(tn, "_LIB", None)
    monkeypatch.setattr(tn, "_TRIED", True)
    return tn


def test_library_builds_in_port_build_dir():
    assert tn.available()
    path = tn._lib_path()
    assert path.parent == ROOT / "pgdrome_tpu_torch" / "_build" and path.exists()
    assert tn.SOURCE == ROOT / "csrc" / "pgdrome_native.cpp"
    assert tn._LIB._name == str(path)


def test_scatter_add_dense():
    rng = np.random.default_rng(0)
    n, nnz = 50, 400
    rows, cols = rng.integers(0, n, nnz), rng.integers(0, n, nnz)
    vals = rng.normal(size=nnz)
    A_t, A_j, A_np = np.zeros((n, n)), np.zeros((n, n)), np.zeros((n, n))
    tn.scatter_add_dense(A_t, rows, cols, vals)
    jn.scatter_add_dense(A_j, rows, cols, vals)
    np.add.at(A_np, (rows, cols), vals)
    np.testing.assert_array_equal(A_t, A_j)
    np.testing.assert_allclose(A_t, A_np, atol=1e-14)


def test_scatter_add_vector(fallback):
    rng = np.random.default_rng(1)
    idx, vals = rng.integers(0, 30, 100), rng.normal(size=100)
    b_j, b_fb = np.zeros(30), np.zeros(30)
    jn.scatter_add_vector(b_j, idx, vals)
    fallback.scatter_add_vector(b_fb, idx, vals)
    np.testing.assert_allclose(b_fb, b_j, atol=1e-14)


def test_scatter_add_vector_native():
    rng = np.random.default_rng(1)
    idx, vals = rng.integers(0, 30, 100), rng.normal(size=100)
    b_t, b_j = np.zeros(30), np.zeros(30)
    tn.scatter_add_vector(b_t, idx, vals)
    jn.scatter_add_vector(b_j, idx, vals)
    np.testing.assert_array_equal(b_t, b_j)


def _tridiag(n, seed):
    rng = np.random.default_rng(seed)
    d, dl, du = 4.0 + rng.random(n), rng.random(n), rng.random(n)
    A = np.diag(d) + np.diag(dl[1:], -1) + np.diag(du[:-1], 1)
    return dl, d, du, A, rng.normal(size=n)


def test_thomas():
    dl, d, du, A, b = _tridiag(40, 2)
    x = tn.thomas_solve(dl, d, du, b)
    np.testing.assert_array_equal(x, jn.thomas_solve(dl, d, du, b))
    np.testing.assert_allclose(A @ x, b, atol=1e-10)


def test_thomas_fallback(fallback):
    dl, d, du, A, b = _tridiag(40, 2)
    x = fallback.thomas_solve(dl, d, du, b)
    np.testing.assert_allclose(x, jn.thomas_solve(dl, d, du, b), rtol=1e-13, atol=1e-15)


def test_thomas_zero_pivot_falls_back():
    """A zero pivot makes the library refuse; the numpy recurrence then
    runs (and yields non-finite values, which FD_solve answers with a
    pivoted LU)."""
    d = np.array([0.0, 1.0, 1.0])
    with np.errstate(divide="ignore", invalid="ignore"):
        x = tn.thomas_solve(np.zeros(3), d, np.ones(3), np.ones(3))
    assert not np.all(np.isfinite(x))


def test_fd_matrices_match():
    x = np.sort(np.random.default_rng(3).random(25))
    for got in (tn.fd_matrices(x), t_fd(x)):
        for a, b in zip(got, jn.fd_matrices(x)):
            np.testing.assert_allclose(a, b, atol=1e-12)
    for a, b in zip(t_fd(x), j_fd(x)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_fd_matrices_fallback(fallback):
    x = np.sort(np.random.default_rng(4).random(12))
    for a, b in zip(fallback.fd_matrices(x), t_fd(x)):
        np.testing.assert_array_equal(a, b)


def test_native_switch(monkeypatch):
    """``PGDROME_NATIVE=0`` turns the library off."""
    monkeypatch.setattr(tn, "_LIB", None)
    monkeypatch.setattr(tn, "_TRIED", False)
    monkeypatch.setenv("PGDROME_NATIVE", "0")
    assert not tn.available()


def test_pgd_config():
    cfg = PGDConfig(PGD_nmax=7, tol_fp_it=1e-6, stop_fp="delta", solver="chol")
    assert cfg.to_dict() == JConfig(PGD_nmax=7, tol_fp_it=1e-6, stop_fp="delta",
                                    solver="chol").to_dict()
    assert cfg.separated_kwargs() == JConfig(**cfg.to_dict()).separated_kwargs()
    assert cfg.with_(PGD_tol=1e-3).PGD_tol == 1e-3 and cfg.PGD_tol == 1e-10

    from pgdrome_tpu_torch.models.problems import poisson_xy, pgd_problem_from_separated
    from pgdrome_tpu_torch.separated import SeparatedPGD

    sep, Vs = poisson_xy(n_x=8, n_y=6)
    prob = pgd_problem_from_separated(sep, Vs)
    cfg.apply(prob)
    assert (prob.PGD_nmax, prob.tol_fp_it, prob.stop_fp, prob.norm_modes) == (
        7, 1e-6, "delta", "stiff")
    solver = SeparatedPGD(sep, dtype=np.float64, device="cpu", **cfg.separated_kwargs())
    assert solver.n_max == 7
