"""The port's ``Vademecum`` against the JAX package's, on the CPU.

Toy vademecums (random modes from a numpy seed on the parametric-elliptic
spaces, n_x=40, n_p=16) and the committed rank-640 d=5 state at full width
(B=64) are served by both; the JAX side runs ``method='xla'``.

Tolerances: the JAX package computes the sweep partly in f64 here (x64 is
on in the tests), the port in f32 throughout.  Toy fields and sensors agree
to 5e-7·max|ref|.  At K=640 the port's f32 sums are held to the rounding
bound γ_c·(|F|·|M0|), c = K + 4·NP roundings per output, computed in f64
from the same tables.  Moments agree to 1e-6·max|mean| (mean) and
1e-6·max(mean²) (variance, which cancels C − f̄f̄ᵀ in f64 on the host).

``save`` / ``load``: the port's ``.npz`` round trip serves the same fields
bit for bit; a JAX ``.h5`` snapshot (written by the JAX package through
h5py) loads into the port with the same modes, bit for bit, and both
packages' loaders validate meshes and degrees alike.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pgdrome_tpu.models.problems import parametric_elliptic as j_elliptic
from pgdrome_tpu.separated import PGDResult as JResult, precondition_dim0 as j_pre
from pgdrome_tpu.serving import Vademecum as JVademecum

from pgdrome_tpu_torch import config
from pgdrome_tpu_torch.convert import frontier_vademecum, result_from_numpy
from pgdrome_tpu_torch.models.problems import parametric_elliptic as t_elliptic
from pgdrome_tpu_torch.ops import fused_sweep as fs
from pgdrome_tpu_torch.parallel.vademecum import sensor_table
from pgdrome_tpu_torch.separated import precondition_dim0 as t_pre
from pgdrome_tpu_torch.serving import Vademecum

STATE = Path(__file__).resolve().parent.parent / "states" / "frontier_d5_state.npz"
F32_TOL = 5e-7
MOM_TOL = 1e-6
PTS = np.array([0.05, 0.2, 0.5, 0.71, 0.95])


def _close(a, b, tol):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * np.abs(b).max()


def _toy(num_params=2, n_max=8, n_modes=7, seed=0, transform=False):
    """Matching JAX and port vademecums (port on the CPU)."""
    js, jV = j_elliptic(n_x=40, n_p=16, num_params=num_params)
    ts, tV = t_elliptic(n_x=40, n_p=16, num_params=num_params)
    jtf = ttf = None
    if transform:
        jtf, ttf = j_pre(js, np.float64)[1], t_pre(ts, np.float64)[1]
    rng = np.random.default_rng(seed)
    n0 = len(jtf.interior) if transform else jV[0].ndofs
    modes = [rng.normal(size=(n_max, n0))] + [
        rng.uniform(0.5, 1.5, size=(n_max, V.ndofs)) for V in jV[1:]
    ]
    traces = [np.arange(n_max, dtype=np.float64)] * 3
    jres = JResult(modes=modes, n_modes=n_modes, amplitudes=traces[0], alpha=traces[1],
                   fp_its=traces[2], normU0=1.0)
    tres = result_from_numpy(modes, n_modes, *traces, normU0=1.0)
    return (JVademecum(jV, jres, dim0_transform=jtf, method="xla"),
            lambda method: Vademecum(tV, tres, dim0_transform=ttf, method=method,
                                     device="cpu"))


def _samples(B, num_params, seed):
    s = np.random.default_rng(seed).uniform(0, 1, size=(B, num_params)).astype(np.float32)
    s[0], s[-1] = 0.0, 1.0
    return s


@pytest.mark.parametrize("method", ["auto", "fused", "torch"])
@pytest.mark.parametrize("num_params,transform", [(2, False), (3, False), (2, True)])
def test_toy_fields_and_sensors(method, num_params, transform):
    jvd, make = _toy(num_params, transform=transform)
    tvd = make(method)
    s = _samples(41, num_params, seed=num_params)
    _close(tvd.fields(s).numpy(), np.asarray(jvd.fields(jnp.asarray(s))), F32_TOL)
    _close(tvd.sensors(PTS)(s).numpy(), np.asarray(jvd.sensors(PTS)(jnp.asarray(s))), F32_TOL)


@pytest.mark.parametrize("method", ["auto", "fused"])
@pytest.mark.parametrize("chunk", [8, 100])
def test_toy_moments(method, chunk):
    jvd, make = _toy(3, seed=4)
    tvd = make(method)
    s = _samples(37, 3, seed=5)
    jm, jv = jvd.moments(jnp.asarray(s), chunk=chunk)
    tm, tv = tvd.moments(s, chunk=chunk)
    scale = np.abs(np.asarray(jm)).max()
    assert np.abs(tm.numpy() - np.asarray(jm)).max() <= MOM_TOL * scale
    assert np.abs(tv.numpy() - np.asarray(jv)).max() <= MOM_TOL * scale ** 2
    jf, jc = jvd.factor_moments(jnp.asarray(s), chunk=chunk)
    tf, tc = tvd.factor_moments(s, chunk=chunk)
    _close(tf.numpy(), np.asarray(jf), MOM_TOL)
    _close(tc.numpy(), np.asarray(jc), MOM_TOL)


@pytest.mark.parametrize("method", ["auto", "fused"])
@pytest.mark.parametrize("B,chunk", [(50, 16), (64, 16), (10, 16), (33, 1)])
def test_stream_equals_one_shot(method, B, chunk):
    _, make = _toy(2, seed=6)
    tvd = make(method)
    s = _samples(B, 2, seed=B)
    got = tvd.fields_stream(s, chunk=chunk, depth=2)
    assert tuple(got.shape) == (B, tvd._modes[0].shape[1])
    # each chunk equals a one-shot sweep of the same (padded) chunk
    pad = (-B) % chunk if B > chunk else 0
    sp = np.concatenate([s, np.repeat(s[:1], pad, axis=0)])
    for lo in range(0, B, chunk):
        one = tvd.fields(sp[lo : lo + chunk])[: min(chunk, B - lo)]
        assert torch.equal(got[lo : lo + chunk], one)
    sens = tvd.sensors_stream(PTS, s, chunk=chunk, depth=3)
    assert tuple(sens.shape) == (B, len(PTS))
    blocks = tvd.fields_stream(s, consumer=lambda y: y.shape[0], chunk=chunk, depth=1)
    assert sum(blocks) == B


@pytest.mark.parametrize("out_dtype", [None, torch.bfloat16])
def test_stream_out_dtype(out_dtype):
    jvd, make = _toy(2, seed=7)
    tvd = make("fused")
    s = _samples(20, 2, seed=8)
    got = tvd.fields_stream(s, chunk=8, out_dtype=out_dtype)
    assert got.dtype == (out_dtype or torch.float32)
    ref = np.asarray(jvd.fields(jnp.asarray(s)))
    tol = F32_TOL if out_dtype is None else 1.6e-2
    _close(got.double().numpy(), ref, tol)


def test_empty_batch():
    _, make = _toy(2, seed=9)
    tvd = make("auto")
    empty = np.zeros((0, 2), np.float32)
    out = tvd.fields_stream(empty)
    assert tuple(out.shape) == (0, tvd._modes[0].shape[1])
    assert tuple(tvd.sensors_stream(PTS, empty).shape) == (0, len(PTS))
    assert tvd.fields_stream(empty, consumer=lambda y: y) == []
    assert tuple(tvd.fields(empty).shape) == (0, tvd._modes[0].shape[1])
    with pytest.raises(ValueError):
        tvd.factor_moments(empty)


def test_sensor_cache_is_bounded():
    _, make = _toy(2, seed=10)
    tvd = make("auto")
    for i in range(10):
        tvd.sensors(np.array([0.1 + 0.01 * i]))
    assert len(tvd._sensor_cache) == tvd._sensor_cache_max
    assert tvd.sensors(np.array([0.19])) is tvd.sensors(np.array([0.19]))


def test_no_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, make = _toy(2, seed=11)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Vademecum(make("auto").spaces, make("auto").result)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        frontier_vademecum(STATE, 5)
    with pytest.raises(RuntimeError):
        config.get_device()
    assert config.get_device("cpu") == torch.device("cpu")


def test_float64_serving():
    jvd, make = _toy(2, seed=12)
    tres = make("auto").result
    tvd = Vademecum(make("auto").spaces, tres, method="auto", dtype=torch.float64,
                    device="cpu")
    s = np.random.default_rng(13).uniform(0, 1, size=(9, 2))
    out = tvd.fields(s)
    assert out.dtype == torch.float64
    with pytest.raises(ValueError, match="float32-only"):
        Vademecum(tvd.spaces, tres, method="fused", dtype=torch.float64,
                  device="cpu").fields(s)


@pytest.fixture(scope="module")
def frontier():
    z = np.load(STATE)
    sep, Vs = j_elliptic(n_x=1024, n_p=128, num_params=5, degree_x=2)
    _, tf = j_pre(sep, np.float64)
    jres = JResult(modes=[z[f"m{d}"] for d in range(6)], n_modes=int(z["n_modes"]),
                   amplitudes=z["amplitudes"], alpha=z["alpha"], fp_its=z["fp_its"],
                   normU0=float(z["normU0"]))
    jvd = JVademecum(Vs, jres, dim0_transform=tf, method="xla")
    tvd = frontier_vademecum(STATE, 5, device="cpu")
    s = _samples(64, 5, seed=64)
    return jvd, tvd, s


def _gamma_bound(tvd, s, table):
    """γ_c·(|F|·|table|) in f64, c = K + 4·NP (P1 bases are ≥ 0, so |F| is
    the factor of the absolute parameter tables)."""
    grid = torch.as_tensor(fs.sweep_grid(tvd.spaces))
    tabs = fs.stack_tables([m.abs() for m in tvd._modes[1:]], "cpu").double()
    fabs = fs.fused_sweep_plain(torch.as_tensor(s), grid, tabs, None, tvd.n_modes)
    c = tvd.n_modes + 4 * (len(tvd.spaces) - 1)
    u = 2.0 ** -24
    return (c * u / (1 - c * u)) * (fabs @ table.abs().double())


@pytest.mark.parametrize("method", ["auto", "fused"])
def test_frontier_fields(frontier, method):
    jvd, tvd, s = frontier
    tvd = Vademecum(tvd.spaces, tvd.result, method=method, device="cpu")
    assert tvd.n_modes == 640 and tuple(tvd._modes[0].shape) == (640, 2049)
    ref = np.asarray(jvd.fields(jnp.asarray(s)))
    out = tvd.fields(s).double().numpy()
    assert np.all(np.abs(out - ref) <= _gamma_bound(tvd, s, tvd._modes[0]).numpy())


def test_frontier_sensors(frontier):
    jvd, tvd, s = frontier
    pts = np.linspace(0.05, 0.95, 8)
    ref = np.asarray(jvd.sensors(pts)(jnp.asarray(s)))
    out = tvd.sensors(pts)(s).double().numpy()
    table = torch.as_tensor(sensor_table(tvd.spaces[0], tvd._modes[0], pts))
    assert np.all(np.abs(out - ref) <= _gamma_bound(tvd, s, table).numpy())


def test_frontier_moments(frontier):
    jvd, tvd, s = frontier
    jm, jv = jvd.moments(jnp.asarray(s))
    tm, tv = tvd.moments(s)
    scale = np.abs(np.asarray(jm)).max()
    assert np.abs(tm.numpy() - np.asarray(jm)).max() <= MOM_TOL * scale
    assert np.abs(tv.numpy() - np.asarray(jv)).max() <= MOM_TOL * scale ** 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_save_load_round_trip(tmp_path, dtype):
    _, make = _toy(3, seed=14)
    tvd = Vademecum(make("auto").spaces, make("auto").result, dtype=dtype, device="cpu")
    path = tmp_path / "vd.npz"
    tvd.save(path)
    again = Vademecum.load(path, tvd.spaces, device="cpu")
    assert again.n_modes == tvd.n_modes and again._modes[0].dtype == dtype
    for a, b in zip(again._modes, tvd._modes):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(again.result.amplitudes, tvd.result.amplitudes)
    np.testing.assert_array_equal(again.result.alpha, tvd.result.alpha)
    s = _samples(23, 3, seed=15)
    assert torch.equal(again.fields(s), tvd.fields(s))
    # a derivative vademecum (DG1 dim 0) round-trips over its own spaces
    d = tvd.derivative()
    d.save(tmp_path / "d.npz")
    assert torch.equal(Vademecum.load(tmp_path / "d.npz", d.spaces, device="cpu").fields(s),
                       d.fields(s))
    with pytest.raises(ValueError, match="expected 4 spaces"):
        Vademecum.load(path, tvd.spaces[:3], device="cpu")
    _, other = t_elliptic(n_x=41, n_p=16, num_params=3)
    with pytest.raises(ValueError, match="mesh does not match"):
        Vademecum.load(path, other, device="cpu")


def test_load_jax_h5_snapshot(tmp_path):
    jvd, make = _toy(2, seed=16)
    path = tmp_path / "vd.h5"
    jvd.save(str(path))
    spaces = make("auto").spaces
    tvd = Vademecum.load(path, spaces, device="cpu")
    assert tvd.n_modes == jvd.n_modes and tvd._modes[0].dtype == torch.float32
    for a, b in zip(tvd._modes, jvd._modes):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    s = _samples(17, 2, seed=17)
    _close(tvd.fields(s).numpy(), np.asarray(jvd.fields(jnp.asarray(s))), F32_TOL)
    # both loaders refuse a wrong degree alike
    from pgdrome_tpu.fem.mesh import IntervalMesh as JMesh
    from pgdrome_tpu.fem.space import FunctionSpace as JSpace
    from pgdrome_tpu_torch.fem.mesh import IntervalMesh as TMesh
    from pgdrome_tpu_torch.fem.space import FunctionSpace as TSpace

    j_bad = [JSpace(JMesh(40, 0.0, 1.0), "P", 1)] + list(jvd.spaces[1:])
    t_bad = [TSpace(TMesh(40, 0.0, 1.0), "P", 1)] + list(spaces[1:])
    with pytest.raises(ValueError, match="degree mismatch"):
        JVademecum.load(str(path), j_bad)
    with pytest.raises(ValueError, match="degree mismatch"):
        Vademecum.load(path, t_bad, device="cpu")


def test_load_without_cuda_raises(tmp_path, monkeypatch):
    _, make = _toy(2, seed=19)
    tvd = make("auto")
    tvd.save(tmp_path / "vd.npz")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Vademecum.load(tmp_path / "vd.npz", tvd.spaces)
    assert Vademecum.load(tmp_path / "vd.npz", tvd.spaces, device="cpu").device.type == "cpu"


def test_h5_without_h5py_raises(tmp_path, monkeypatch):
    import sys

    _, make = _toy(2, seed=18)
    monkeypatch.setitem(sys.modules, "h5py", None)  # import h5py now fails
    with pytest.raises(ImportError, match="needs h5py"):
        Vademecum.load(tmp_path / "missing.h5", make("auto").spaces, device="cpu")
