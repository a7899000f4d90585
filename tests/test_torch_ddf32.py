"""The port's double-f32 arithmetic and compensated rhs paths against the
JAX package's, on the CPU.

- The 11 functions of ``ops/ddf32.py`` on seeded f32 inputs spread over
  10^±6 equal the JAX functions run op by op (``jax.disable_jit()``) bit
  for bit.  Jitted JAX is not the reference for bits: XLA:CPU rewrites the
  dd operations when it compiles them, so its ``lo`` words differ while
  ``hi + lo`` agrees to ≤ 1e-13·max|hi| (``dd_dot``, ``dd_contract``).
- The error-free transforms are exact in f64.
- ``_contract_rhs`` on a dd (R, n, 2) stack equals the JAX one bit for
  bit, with and without the cached per-dim weights.
- ``SeparatedPGD(rhs_comp=True)`` and ``(rhs_f64=True)`` on the cancelling
  problem of the JAX package's tests (``tests/unit/test_ddf32.py:130``,
  ``tests/unit/test_separated.py:468``), with their thresholds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgdrome_tpu import separated as J
from pgdrome_tpu.ops import ddf32 as JD

from pgdrome_tpu_torch import separated as S
from pgdrome_tpu_torch.models.problems import parametric_elliptic
from pgdrome_tpu_torch.ops import ddf32 as TD

N = 4096


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this file's torch work: the suite runs
    several workers on a few cores, where idle intra-op threads only spin
    (the port's toy frontier took 72 core-seconds on 8 threads, 18 on 1,
    for 12 and 20 s of wall time)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _f32(rng, shape):
    """Seeded f32 values of both signs, magnitudes spread over 10^±6."""
    return (rng.standard_normal(shape) * 10.0 ** rng.uniform(-6, 6, shape)).astype(np.float32)


def _dd(rng, shape):
    """A seeded dd pair (hi, lo) with |lo| ≤ ulp(hi)/2."""
    x = rng.standard_normal(shape) * 10.0 ** rng.uniform(-6, 6, shape)
    d = TD.dd_from_f64(x)
    return d[..., 0], d[..., 1]


def _args(name, rng):
    """Seeded numpy inputs of one dd function."""
    if name in ("two_sum", "two_prod"):
        return _f32(rng, N), _f32(rng, N)
    if name == "fast_two_sum":  # needs |a| >= |b|
        a, b = _f32(rng, N), _f32(rng, N)
        return np.where(np.abs(a) >= np.abs(b), a, b), np.where(np.abs(a) >= np.abs(b), b, a)
    if name == "_split":
        return (_f32(rng, N),)
    if name in ("dd_add", "dd_mul"):
        return _dd(rng, N) + _dd(rng, N)
    if name == "dd_mul_f":
        return _dd(rng, N) + (_f32(rng, N),)
    # one stack shape (R, n) = (40, 129) throughout: eager JAX compiles
    # each operation once per shape, so shared shapes keep the file fast
    if name == "dd_sum":
        return _dd(rng, (129, 40))
    if name == "dd_dot":
        return TD.dd_from_f64(rng.standard_normal((40, 129)) * 10.0 ** rng.integers(-5, 5, (40, 1))), \
            _f32(rng, 129)
    if name == "dd_contract":
        return _dd(rng, 40) + (TD.dd_from_f64(rng.standard_normal((40, 129))),)
    raise KeyError(name)


NAMES = ["two_sum", "fast_two_sum", "_split", "two_prod", "dd_add", "dd_mul", "dd_mul_f",
         "dd_sum", "dd_dot", "dd_contract"]


def _eager(fn, *args, **kw):
    with jax.disable_jit():
        out = fn(*(jnp.asarray(a) for a in args), **kw)
    return out if isinstance(out, tuple) else (out,)


def _port(fn, *args, **kw):
    out = fn(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args), **kw)
    return out if isinstance(out, tuple) else (out,)


def _bits_equal(jax_out, torch_out):
    assert len(jax_out) == len(torch_out)
    for a, b in zip(jax_out, torch_out):
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("name", NAMES)
def test_equals_eager_jax_bitwise(name):
    args = _args(name, np.random.default_rng(NAMES.index(name)))
    _bits_equal(_eager(getattr(JD, name), *args), _port(getattr(TD, name), *args))


def test_dd_from_f64_equals_reference():
    x = np.random.default_rng(11).standard_normal(1000) * 10.0 ** np.arange(-10, 10, 0.02)
    a, b = JD.dd_from_f64(x), TD.dd_from_f64(x)
    assert b.shape == (1000, 2) and b.dtype == np.float32
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("n", [1, 2, 7, 129, 2049])
def test_dd_sum_lengths(n):
    rng = np.random.default_rng(100 + n)
    h, l = _dd(rng, (n, 40))
    _bits_equal(_eager(JD.dd_sum, h, l), _port(TD.dd_sum, h, l))
    sh, sl = _port(TD.dd_sum, h, l)
    assert sh.shape == (40,)
    exact = h.astype(np.float64).sum(0) + l.astype(np.float64).sum(0)
    got = sh.numpy().astype(np.float64) + sl.numpy()
    assert np.abs(got - exact).max() <= 1e-13 * np.abs(h).max()


def test_error_free_identities_exact():
    rng = np.random.default_rng(12)
    a, b = (torch.from_numpy(_f32(rng, N)) for _ in range(2))
    a64, b64 = a.double(), b.double()
    s, e = TD.two_sum(a, b)
    assert torch.equal(s.double() + e.double(), a64 + b64)
    big = torch.where(a.abs() >= b.abs(), a, b)
    small = torch.where(a.abs() >= b.abs(), b, a)
    s, e = TD.fast_two_sum(big, small)
    assert torch.equal(s.double() + e.double(), big.double() + small.double())
    p, e = TD.two_prod(a, b)
    assert torch.equal(p.double() + e.double(), a64 * b64)
    hi, lo = TD._split(a)
    assert torch.equal(hi.double() + lo.double(), a64)


@pytest.mark.parametrize("name", ["dd_dot", "dd_contract"])
def test_matches_jitted_jax(name):
    args = _args(name, np.random.default_rng(NAMES.index(name)))
    jit = jax.jit(getattr(JD, name))(*(jnp.asarray(a) for a in args))
    jit = jit if isinstance(jit, tuple) else (jit, np.zeros_like(jit))
    port = _port(getattr(TD, name), *args)
    port = port if len(port) == 2 else (port[0], torch.zeros_like(port[0]))
    j = np.asarray(jit[0], np.float64) + np.asarray(jit[1], np.float64)
    t = port[0].numpy().astype(np.float64) + port[1].numpy()
    assert np.abs(j - t).max() <= 1e-13 * np.abs(np.asarray(jit[0])).max()


def test_dd_contract_cancellation():
    # coefficients ±C multiply identical rows that cancel to an O(1) load
    # (tests/unit/test_ddf32.py:102): dd recovers it, plain f32 does not
    g = np.random.default_rng(7).standard_normal(128)
    C = 1e5
    stack = np.stack([(1.0 + C) * g, -C * g, 0.5 * g])
    exact = np.ones(3) @ stack
    ch = torch.ones(3)
    b = TD.dd_contract(ch, torch.zeros_like(ch), torch.from_numpy(TD.dd_from_f64(stack)))
    plain = ch @ torch.from_numpy(stack.astype(np.float32))
    err_dd = np.abs(b.numpy().astype(np.float64) - exact).max()
    err_plain = np.abs(plain.numpy().astype(np.float64) - exact).max()
    assert err_dd < 1e-6 * np.abs(exact).max()
    assert err_plain > 50 * max(err_dd, 1e-300)


@pytest.mark.parametrize("k", [0, 2])
def test_contract_rhs_dd_bitwise(k):
    rng = np.random.default_rng(20 + k)
    sizes = (129, 17, 17)
    rhs = [TD.dd_from_f64(rng.standard_normal((40, n)) * 10.0 ** rng.integers(-4, 4, (40, 1)))
           for n in sizes]
    Fs = [_f32(rng, n) for n in sizes]
    with jax.disable_jit():
        ref = J._contract_rhs([jnp.asarray(r) for r in rhs], [jnp.asarray(f) for f in Fs], k, 3)
    trhs = [torch.from_numpy(r) for r in rhs]
    tFs = [torch.from_numpy(f) for f in Fs]
    weights = S._DDWeights(trhs)
    for w in (None, weights, weights):  # recomputed, then cached weights
        got = S._contract_rhs(trhs, tFs, k, 3, w)
        np.testing.assert_array_equal(np.asarray(ref).view(np.uint32), got.numpy().view(np.uint32))
    # an in-place write to a factor invalidates its cached weights
    j = 1
    tFs[j].mul_(0.5)
    with jax.disable_jit():
        ref2 = J._contract_rhs([jnp.asarray(r) for r in rhs],
                               [jnp.asarray(f.numpy()) for f in tFs], k, 3)
    got = S._contract_rhs(trhs, tFs, k, 3, weights)
    np.testing.assert_array_equal(np.asarray(ref2).view(np.uint32), got.numpy().view(np.uint32))


def test_contract_rhs_f64_stack():
    # an f64 stack contracts in f64 with f32 factors, as JAX promotes them
    rng = np.random.default_rng(30)
    rhs = [rng.standard_normal((40, n)) for n in (31, 9)]
    Fs = [_f32(rng, n) for n in (31, 9)]
    ref = np.asarray(J._contract_rhs([jnp.asarray(r) for r in rhs],
                                     [jnp.asarray(f) for f in Fs], 0, 2))
    got = S._contract_rhs([torch.from_numpy(r) for r in rhs], [torch.from_numpy(f) for f in Fs],
                          0, 2)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-13 * np.abs(ref).max())


# ------------------------------------------------ the compensated solves

def _cancelling_problem():
    """The rhs stack [(1+C) g; −C g] ⊗ [g1; g1] == g ⊗ g1 exactly, C = 3e5."""
    sep, _ = parametric_elliptic(n_x=32, n_p=8, num_params=1)
    sep_pc, _ = S.precondition_dim0(sep, np.float64)
    C = 3.0e5
    g0, g1 = (np.asarray(r, dtype=np.float64) for r in sep_pc.rhs)
    sep_c = S.SeparatedProblem(
        ops=list(sep_pc.ops), rhs=[np.concatenate([(1.0 + C) * g0, -C * g0]),
                                   np.concatenate([g1, g1])],
        mass=list(sep_pc.mass), bc_dofs=list(sep_pc.bc_dofs),
    )
    return sep_pc, sep_c


def _tensor(res):
    K = res.n_modes
    return np.einsum("ki,kj->ij", S.host_f64(res.modes[0])[:K], S.host_f64(res.modes[1])[:K])


@pytest.mark.parametrize("flag", ["rhs_comp", "rhs_f64"])
def test_cancelling_rhs_recovers_accuracy(flag):
    sep_pc, sep_c = _cancelling_problem()
    kw = dict(n_max=4, tol=0.0, tol_fp=1e-7, max_fp_it=40, residual_check=False,
              device="cpu")
    ref = S.SeparatedPGD(sep_pc, dtype=np.float64, **kw).solve_fused()
    mixed = S.SeparatedPGD(sep_c, dtype=np.float32, **{flag: True}, **kw)
    assert mixed.problem.ops[0].dtype == torch.float32
    if flag == "rhs_comp":
        assert mixed.problem.rhs[0].shape == (2, sep_c.rhs[0].shape[1], 2)
        assert mixed.problem.rhs[0].dtype == torch.float32
    else:
        assert mixed.problem.rhs[0].dtype == torch.float64
    mixed = mixed.solve_fused()
    plain = S.SeparatedPGD(sep_c, dtype=np.float32, **kw).solve_fused()
    t_ref = _tensor(ref)
    scale = np.abs(t_ref).max()
    err_mixed = np.abs(_tensor(mixed) - t_ref).max() / scale
    err_plain = np.abs(_tensor(plain) - t_ref).max() / scale
    assert err_mixed < 2e-6, err_mixed
    assert err_plain > 100 * err_mixed, (err_plain, err_mixed)


def test_rhs_comp_matches_plain_when_benign():
    sep, _ = parametric_elliptic(n_x=24, n_p=8, num_params=2)
    kw = dict(n_max=3, tol=0.0, tol_fp=1e-6, max_fp_it=30, residual_check=False,
              dtype=np.float32, device="cpu")
    a = S.SeparatedPGD(sep, rhs_comp=True, **kw).solve_fused()
    b = S.SeparatedPGD(sep, **kw).solve_fused()
    np.testing.assert_allclose(a.amplitudes, b.amplitudes, rtol=2e-4)


def test_rhs_comp_residual_check_path():
    # residual_norm runs the dd contraction too
    sep, _ = parametric_elliptic(n_x=16, n_p=6, num_params=2)
    res = S.SeparatedPGD(sep, rhs_comp=True, dtype=np.float32, n_max=2, tol=0.0,
                         tol_fp=1e-5, max_fp_it=10, device="cpu").solve()
    assert res.n_modes >= 1


def test_invalid_combinations():
    sep, _ = parametric_elliptic(n_x=16, n_p=6, num_params=2)
    with pytest.raises(ValueError, match="exclusive"):
        S.SeparatedPGD(sep, rhs_comp=True, rhs_f64=True, device="cpu")
    f32 = S.SeparatedProblem(ops=sep.ops, rhs=[r.astype(np.float32) for r in sep.rhs],
                             mass=sep.mass, bc_dofs=sep.bc_dofs)
    dev = sep.as_device(np.float64, "cpu")
    for flag in ("rhs_comp", "rhs_f64"):
        with pytest.raises(ValueError, match="HOST float64"):
            S.SeparatedPGD(f32, device="cpu", **{flag: True})
        with pytest.raises(ValueError, match="already device"):
            S.SeparatedPGD(dev, device="cpu", **{flag: True})
