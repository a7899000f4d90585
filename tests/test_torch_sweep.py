"""The fused sweep's plain PyTorch version and the port's sweep builders
against the JAX package, on the CPU.

The JAX kernel (``pgdrome_tpu/ops/pallas_kernels.py::make_fused_sweep``)
runs in Pallas interpret mode, as ``tests/unit/test_pallas_kernels.py``
runs it, at the same toy sizes (n_x=40, n_p=16, n_max ≤ 10).  Mode tables
and samples are made with numpy from fixed seeds and handed to both.

Tolerances: f32 results within 5e-7·max|ref| (the JAX kernel test's
figure; both sides round in f32, in different orders); the bf16 store
within 1.6e-2·max (bf16 keeps 8 bits); f64 paths to 1e-12·max.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pgdrome_tpu import IntervalMesh as JMesh, FunctionSpace as JSpace
from pgdrome_tpu.models.problems import parametric_elliptic as j_elliptic
from pgdrome_tpu.ops.pallas_kernels import make_fused_sweep as j_fused
from pgdrome_tpu.parallel import vademecum as jv
from pgdrome_tpu.separated import evaluate_modes_1d as j_eval_modes

from pgdrome_tpu_torch.fem.mesh import IntervalMesh as TMesh
from pgdrome_tpu_torch.fem.space import FunctionSpace as TSpace
from pgdrome_tpu_torch.models.problems import parametric_elliptic as t_elliptic
from pgdrome_tpu_torch.ops import fused_sweep as fs
from pgdrome_tpu_torch.parallel import vademecum as tv
from pgdrome_tpu_torch.separated import evaluate_modes_1d as t_eval_modes

F32_TOL = 5e-7
BF16_TOL = 1.6e-2
F64_TOL = 1e-12


def _close(a, b, tol):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * np.abs(b).max()


def _elliptic(num_params, n_max, seed, dtype=np.float32):
    """Both packages' spaces for parametric_elliptic(n_x=40, n_p=16) and
    one set of random mode tables, as numpy."""
    jV = j_elliptic(n_x=40, n_p=16, num_params=num_params)[1]
    tV = t_elliptic(n_x=40, n_p=16, num_params=num_params)[1]
    rng = np.random.default_rng(seed)
    modes = [rng.normal(size=(n_max, V.ndofs)).astype(dtype) for V in jV]
    return jV, tV, modes


def _samples(B, num_params, seed, lo=0.0, hi=1.0):
    s = np.random.default_rng(seed).uniform(lo, hi, size=(B, num_params)).astype(np.float32)
    s[0], s[1] = lo, hi  # both ends: the right end must land in the last cell
    return s


def _port(tV, modes, n_modes, **kw):
    return fs.make_fused_sweep(tV, [None if m is None else torch.as_tensor(m) for m in modes],
                               n_modes, device="cpu", **kw)


@pytest.mark.parametrize("num_params,n_max,n_modes,B", [
    (2, 10, 10, 73), (2, 10, 7, 64), (3, 6, 5, 50), (3, 10, 1, 9),
])
def test_fields_f32(num_params, n_max, n_modes, B):
    jV, tV, modes = _elliptic(num_params, n_max, seed=B)
    s = _samples(B, num_params, seed=B + 1)
    ref = np.asarray(j_fused(jV, [jnp.asarray(m) for m in modes], n_modes,
                             block_b=64, block_n=128)(s))
    out = _port(tV, modes, n_modes)(torch.as_tensor(s))
    assert out.dtype == torch.float32
    _close(out.numpy(), ref, F32_TOL)


@pytest.mark.parametrize("seed", [1, 2])
def test_bf16_store(seed):
    jV, tV, modes = _elliptic(2, 6, seed=seed)
    s = _samples(50, 2, seed=seed)
    ref = np.asarray(j_fused(jV, [jnp.asarray(m) for m in modes], 6,
                             block_b=64, block_n=128)(s), dtype=np.float64)
    out = _port(tV, modes, 6, out_dtype=torch.bfloat16)(torch.as_tensor(s))
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == ref.shape
    assert np.abs(out.double().numpy() - ref).max() < BF16_TOL * np.abs(ref).max()


@pytest.mark.parametrize("n_cells", [4, 8])
def test_p2_param_dims(n_cells):
    rng = np.random.default_rng(n_cells)
    jV = [JSpace(JMesh(16, 0.0, 1.0), "P", 1), JSpace(JMesh(n_cells, 0.0, 2.0), "P", 2)]
    tV = [TSpace(TMesh(16, 0.0, 1.0), "P", 1), TSpace(TMesh(n_cells, 0.0, 2.0), "P", 2)]
    modes = [rng.normal(size=(6, V.ndofs)).astype(np.float32) for V in jV]
    s = _samples(37, 1, seed=n_cells, lo=0.0, hi=2.0)
    ref = np.asarray(j_fused(jV, [jnp.asarray(m) for m in modes], 5,
                             block_b=64, block_n=128)(s))
    _close(_port(tV, modes, 5)(torch.as_tensor(s)).numpy(), ref, F32_TOL)


@pytest.mark.parametrize("num_params", [2, 3])
def test_sensor_table(num_params):
    jV, tV, modes = _elliptic(num_params, 8, seed=11)
    pts = np.array([0.05, 0.3, 0.5, 0.77, 1.0])
    s = _samples(40, num_params, seed=12)
    jfn = jv.make_sensor_sweep_fn(jV, [jnp.asarray(m) for m in modes], 7, pts, method="fused")
    tfn = tv.make_sensor_sweep_fn(tV, [torch.as_tensor(m) for m in modes], 7, pts,
                                  method="fused")
    assert isinstance(tfn, fs.FusedSweep)
    _close(tfn(torch.as_tensor(s)).numpy(), np.asarray(jfn(s)), F32_TOL)


@pytest.mark.parametrize("n_modes", [8, 5])
def test_identity_table_factors(n_modes):
    # the JAX factor wiring multiplies by an identity dim-0 table; the port
    # skips that product and returns the masked factors themselves
    jV, tV, modes = _elliptic(3, 8, seed=n_modes)
    s = _samples(30, 3, seed=n_modes)
    ref = np.asarray(j_fused(jV, [jnp.eye(8, dtype=jnp.float32)]
                             + [jnp.asarray(m) for m in modes[1:]], n_modes,
                             block_b=64, block_n=128)(s))
    out = _port(tV, [None] + modes[1:], n_modes)(torch.as_tensor(s))
    assert tuple(out.shape) == (30, 8)
    assert bool((out[:, n_modes:] == 0).all())
    _close(out.numpy(), ref, F32_TOL)


def test_samples_at_the_ends():
    jV, tV, modes = _elliptic(2, 6, seed=3)
    s = np.array([[0, 0], [1, 1], [0, 1], [1, 0], [0.5, 1], [1, 0.0625]], np.float32)
    ref = np.asarray(j_fused(jV, [jnp.asarray(m) for m in modes], 6,
                             block_b=64, block_n=128)(s))
    out = _port(tV, modes, 6)(torch.as_tensor(s)).numpy()
    _close(out, ref, F32_TOL)
    # at p = 1 the value is the last dof's mode value exactly (ξ = 1)
    f = modes[1][:, -1] * modes[2][:, -1]
    _close(out[1], f @ modes[0], F32_TOL)


@pytest.mark.parametrize("num_params,n_modes", [(2, 10), (3, 6)])
def test_f64_plain_paths(num_params, n_modes):
    jV, tV, modes = _elliptic(num_params, 10, seed=5, dtype=np.float64)
    s = np.random.default_rng(6).uniform(0, 1, size=(45, num_params))
    jm = [jnp.asarray(m) for m in modes]
    tm = [torch.as_tensor(m) for m in modes]
    fields = tv.make_sweep_fn(tV, tm, n_modes, method="auto")(torch.as_tensor(s))
    assert fields.dtype == torch.float64
    _close(fields.numpy(), np.asarray(jv.make_sweep_fn(jV, jm, n_modes)(jnp.asarray(s))),
           F64_TOL)
    pts = np.array([0.1, 0.45, 0.9])
    sens = tv.make_sensor_sweep_fn(tV, tm, n_modes, pts, method="auto")(torch.as_tensor(s))
    _close(sens.numpy(), np.asarray(
        jv.make_sensor_sweep_fn(jV, jm, n_modes, pts, method="xla")(jnp.asarray(s))), F64_TOL)
    w = np.ones(45)
    w[40:] = 0.0
    t1, t2 = tv.make_factor_moments_fn(tV, tm, n_modes)(torch.as_tensor(s), torch.as_tensor(w))
    j1, j2 = jv.make_factor_moments_fn(jV, jm, n_modes)(jnp.asarray(s), jnp.asarray(w))
    _close(t1.numpy(), np.asarray(j1), F64_TOL)
    _close(t2.numpy(), np.asarray(j2), F64_TOL)


def test_f32_plain_path_matches_xla():
    jV, tV, modes = _elliptic(2, 10, seed=8)
    s = _samples(33, 2, seed=9)
    ref = np.asarray(jv.make_sweep_fn(jV, [jnp.asarray(m) for m in modes], 9)(jnp.asarray(s)))
    fn = tv.make_sweep_fn(tV, [torch.as_tensor(m) for m in modes], 9, method="torch")
    out = fn(torch.as_tensor(s))
    assert out.dtype == torch.float32
    _close(out.numpy(), ref, F32_TOL)


@pytest.mark.parametrize("mesh", ["uniform", "graded"])
@pytest.mark.parametrize("degree", [1, 2])
def test_evaluate_modes_1d(mesh, degree):
    pts_mesh = np.linspace(0.0, 1.0, 9) if mesh == "uniform" else np.linspace(0, 1, 9) ** 2
    jV = JSpace(JMesh.from_points(pts_mesh), "P", degree)
    tV = TSpace(TMesh.from_points(pts_mesh), "P", degree)
    rng = np.random.default_rng(degree)
    buf = rng.normal(size=(4, jV.ndofs))
    x = np.concatenate([[0.0, 1.0], rng.uniform(0, 1, size=20)])
    ref = np.asarray(j_eval_modes(jV, jnp.asarray(buf), jnp.asarray(x)))
    _close(t_eval_modes(tV, torch.as_tensor(buf), torch.as_tensor(x)).numpy(), ref, F64_TOL)


def test_gate():
    jV, tV, modes = _elliptic(2, 4, seed=0)
    t32 = [torch.as_tensor(m) for m in modes]
    t64 = [m.double() for m in t32]
    # auto: plain path on the CPU and for f64; fused only when asked
    assert not isinstance(tv.make_sweep_fn(tV, t32, 4, method="auto"), fs.FusedSweep)
    assert isinstance(tv.make_sweep_fn(tV, t32, 4, method="fused"), fs.FusedSweep)
    with pytest.raises(ValueError, match="float32-only"):
        tv.make_sweep_fn(tV, t64, 4, method="fused")
    with pytest.raises(ValueError):
        tv.make_sweep_fn(tV, t32, 4, method="xla")
    graded = [tV[0]] + [TSpace(TMesh.from_points(np.linspace(0, 1, 17) ** 2), "P", 1)
                        for _ in range(2)]
    with pytest.raises(ValueError, match="uniform"):
        tv.make_sweep_fn(graded, t32, 4, method="fused")
    assert not isinstance(tv.make_sweep_fn(graded, t32, 4, method="auto"), fs.FusedSweep)


@pytest.mark.parametrize("K,NP,rpw", [
    (640, 5, 8), (640, 16, 8), (10, 2, 8), (1000, 5, 4),
    (1500, 5, 2), (2717, 10, 1), (3900, 3, 1),
])
def test_rows_per_warp(K, NP, rpw):
    assert fs.rows_per_warp(K, NP) == rpw
    assert fs._smem_bytes(K, rpw, NP) <= 232448
    if rpw < 8:  # the next larger block would not fit
        assert fs._smem_bytes(K, 2 * rpw, NP) > 232448


def test_too_many_modes_rejected():
    with pytest.raises(ValueError, match="shared memory"):
        fs.rows_per_warp(6000, 5)
