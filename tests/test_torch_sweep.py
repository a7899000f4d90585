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


def _f32(bits):
    return np.asarray(bits, dtype=np.uint32).view(np.float32)


_SPLIT_VALUES = {
    "normal": lambda rng: rng.normal(size=4000).astype(np.float32)
    * np.float32(2.0) ** rng.integers(-60, 60, size=4000).astype(np.float32),
    # subnormal f32 bit patterns, both signs, and the smallest ones
    "subnormal": lambda rng: np.concatenate([
        _f32(rng.integers(1, 0x800000, size=2000)),
        -_f32(rng.integers(1, 0x800000, size=2000)),
        _f32([1, 2, 0x1000, 0x7FFFFF]),
    ]),
    # 0, ±0, ±max, values at and next to tf32 ties and at the binade edges
    "extremes": lambda rng: np.concatenate([
        np.array([0.0, -0.0, 1.0, -1.0], np.float32),
        _f32([0x7F7FFFFF, 0xFF7FFFFF, 0x7F7FF000, 0x7F7FE000, 0x00800000]),
        _f32(0x3F800000 + np.array([0x1000, 0x0FFF, 0x1001, 0x3000, 0x1FFF, 0x7FFFFF])),
        -_f32(0x3F800000 + np.array([0x1000, 0x3000])),
    ]),
}


@pytest.mark.parametrize("kind", sorted(_SPLIT_VALUES))
def test_split_tf32(kind):
    x = torch.as_tensor(_SPLIT_VALUES[kind](np.random.default_rng(len(kind))))
    hi, lo = fs.split_tf32(x)
    hb, lb = hi.view(torch.int32), lo.view(torch.int32)
    # both halves are tf32 numbers: the low 13 mantissa bits are zero
    assert bool(((hb & 0x1FFF) == 0).all()) and bool(((lb & 0x1FFF) == 0).all())
    assert bool(torch.isfinite(hi).all()) and bool(torch.isfinite(lo).all())
    # hi is x rounded to nearest — |x − hi| ≤ half a tf32 ulp of x — except
    # from the tie below f32's max up, where rounding would overflow and hi
    # truncates; the split loses at most 2⁻²²|x| beyond the tf32 subnormal
    # spacing 2⁻¹³⁶
    x64, hi64, lo64 = x.double(), hi.double(), lo.double()
    ulp_hi = torch.ldexp(torch.ones_like(x64), torch.frexp(x64)[1].clamp_min(-125) - 11)
    nearest = x64.abs() < float(_f32([0x7F7FF000])[0])
    assert bool(((x64 - hi64).abs() <= ulp_hi / 2)[nearest].all())
    assert bool(((x64 - hi64).abs() < ulp_hi).all())
    err = (x64 - hi64 - lo64).abs()
    assert bool((err <= 2.0 ** -22 * x64.abs() + 2.0 ** -137).all())
    if kind == "normal":
        assert bool((err <= 2.0 ** -22 * x64.abs()).all())
    # ties round away from zero, as cvt.rna.tf32.f32 does
    one_tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)], dtype=torch.float32)
    assert fs.split_tf32(one_tie)[0].tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)]


def test_split_tf32_non_finite():
    x = torch.tensor([float("inf"), float("-inf"), float("nan")])
    hi, lo = fs.split_tf32(x)
    assert hi[0] == float("inf") and hi[1] == float("-inf") and bool(torch.isnan(hi[2]))
    assert lo.tolist() == [0.0, 0.0, 0.0]


@pytest.mark.parametrize("K,n0,n_modes", [(13, 5, 9), (641, 40, 637)])
def test_split_table(K, n0, n_modes):
    rng = np.random.default_rng(K)
    m0 = rng.normal(size=(K, n0)).astype(np.float32)
    m0[n_modes:] = np.nan  # padded-buffer rows never reach the product
    hi, lo, head = fs.split_table(torch.as_tensor(m0), n_modes)
    Kp, H = fs.padded_k(K), fs.K_HEAD
    assert Kp % 8 == 0 and K <= Kp < K + 8
    assert hi.shape == lo.shape == (n0, Kp) and hi.is_contiguous() and lo.is_contiguous()
    assert bool((hi[:, n_modes:] == 0).all()) and bool((lo[:, n_modes:] == 0).all())
    # the head's rows go to the f32 table, whole; the split holds the rest
    assert bool((hi[:, :H] == 0).all()) and bool((lo[:, :H] == 0).all())
    ref_head = np.zeros((H, -(-n0 // 4) * 4), np.float32)
    ref_head[:min(H, n_modes), :n0] = m0[:min(H, n_modes)]
    assert head.shape == ref_head.shape and np.array_equal(head.numpy(), ref_head)
    rebuilt = hi.double() + lo.double()
    ref = torch.as_tensor(m0[:n_modes]).double().T
    assert bool(((rebuilt[:, H:n_modes] - ref[:, H:]).abs() <= 2.0 ** -22 * ref[:, H:].abs()).all())


def test_split_factors():
    # the factor kernel's split store: head columns whole with lo zero,
    # split_tf32 past them
    f = torch.as_tensor(np.random.default_rng(3).normal(size=(7, 40)).astype(np.float32))
    hi, lo = fs.split_factors(f)
    H = fs.K_HEAD
    th, tl = fs.split_tf32(f)
    assert torch.equal(hi[:, :H], f[:, :H]) and bool((lo[:, :H] == 0).all())
    assert torch.equal(hi[:, H:], th[:, H:]) and torch.equal(lo[:, H:], tl[:, H:])


@pytest.mark.parametrize("B,K,cap", [
    (1, 640, None), (524_288, 640, None), (4_194_309, 641, None), (1000, 6000, 1 << 20),
])
def test_row_chunks(B, K, cap, monkeypatch):
    if cap is not None:
        monkeypatch.setattr(fs, "SCRATCH_BYTES", cap)
    chunks = fs.row_chunks(B, K)
    limit = fs.SCRATCH_BYTES
    assert chunks[0][0] == 0 and chunks[-1][1] == B
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    assert all(r0 < r1 for r0, r1 in chunks)
    for r0, r1 in chunks[:-1]:
        assert (r1 - r0) % fs.GEMM_ROWS == 0
    rows = max(r1 - r0 for r0, r1 in chunks)
    assert rows * 8 * fs.padded_k(K) <= max(limit, fs.GEMM_ROWS * 8 * fs.padded_k(K))


def _emulate_3xtf32(fac, m0, n_modes, depth=32):
    """The GEMM's arithmetic with a round-to-nearest accumulator: per
    ``depth``-k chunk hi·lo + lo·hi + hi·hi summed exactly (f64 holds the
    tf32 products and their short sums), rounded to f32, and the chunks
    added in f32; then the head, k = K_HEAD − 1 down to 0, in f32 FMAs
    (the product exact in f64, one rounding to f32 per step)."""
    K = fac.shape[1]
    Kp = fs.padded_k(K)
    f = torch.zeros((fac.shape[0], Kp), dtype=torch.float32)
    f[:, :K] = fac
    fh, fl = (t.double() for t in fs.split_factors(f))
    th, tl, head = fs.split_table(m0, n_modes)
    th, tl = th.double(), tl.double()
    tot = torch.zeros((fac.shape[0], m0.shape[1]), dtype=torch.float32)
    for k0 in range(0, Kp, depth):
        k = slice(k0, k0 + depth)
        part = fh[:, k] @ tl[:, k].T + fl[:, k] @ th[:, k].T + fh[:, k] @ th[:, k].T
        tot += part.float()
    for k in range(min(fs.K_HEAD, Kp) - 1, -1, -1):
        prod = f[:, k, None].double() * head[k, None, :m0.shape[1]].double()
        tot = (prod + tot.double()).float()
    return tot


@pytest.mark.parametrize("seed,depth", [(1, 16), (2, 64)])
def test_3xtf32_emulation_d5_widths(seed, depth):
    # the d=5 state's widths: K = 640 modes, 2049 dofs, 5 P1 dims of 129 dofs
    tV = [TSpace(TMesh(2048, 0.0, 1.0), "P", 1)] + [
        TSpace(TMesh(128, 0.0, 1.0), "P", 1) for _ in range(5)]
    rng = np.random.default_rng(seed)
    modes = [rng.normal(size=(640, V.ndofs)).astype(np.float32) for V in tV]
    sweep = _port(tV, modes, 637)
    s = torch.as_tensor(_samples(24, 5, seed=seed))
    fac = fs.fused_sweep_plain(s, sweep.grid, sweep.tabs, None, 637)
    out = _emulate_3xtf32(fac, sweep.m0, 637, depth)
    ref = fs.fused_sweep_plain(s, sweep.grid, sweep.tabs.double(), sweep.m0.double(), 637)
    fabs = fs.fused_sweep_plain(s, sweep.grid, sweep.tabs.abs().double(), None, 637)
    c = 640 + 4 * 5
    u = 2.0 ** -24
    bound = c * u / (1 - c * u) * (fabs @ sweep.m0.double().abs())
    ratio = float(((out.double() - ref).abs() / bound).max())
    print(f"3xTF32 emulation, depth {depth}: max |err| / gamma_c bound = {ratio:.4f}")
    assert ratio <= 1.0


def test_large_k_accepted():
    # no shared-memory limit on K any more: K = 6000 plans, splits its
    # table and sweeps; held to the JAX kernel on the same inputs within
    # 2γ_c·|F||M0|, c = K + 4·NP (P1 bases are ≥ 0, so |F| is the factor
    # of |T|)
    K, n_modes = 6000, 5993
    assert len(fs.row_chunks(4_194_304, K)) >= 1
    jV = [JSpace(JMesh(20, 0.0, 1.0), "P", 1)] + [JSpace(JMesh(8, 0.0, 1.0), "P", 1)] * 2
    tV = [TSpace(TMesh(20, 0.0, 1.0), "P", 1)] + [TSpace(TMesh(8, 0.0, 1.0), "P", 1)] * 2
    rng = np.random.default_rng(6000)
    modes = [rng.normal(size=(K, V.ndofs)).astype(np.float32) for V in tV]
    sweep = _port(tV, modes, n_modes)
    assert fs.split_table(sweep.m0, n_modes)[0].shape == (21, 6000)
    s = _samples(5, 2, seed=7)
    out = sweep(torch.as_tensor(s)).double()
    ref = np.asarray(j_fused(jV, [jnp.asarray(m) for m in modes], n_modes,
                             block_b=64, block_n=128)(s), dtype=np.float64)
    fabs = fs.fused_sweep_plain(torch.as_tensor(s), sweep.grid, sweep.tabs.abs().double(),
                                None, n_modes)
    c = K + 4 * 2
    u = 2.0 ** -24
    bound = c * u / (1 - c * u) * (fabs @ sweep.m0.double().abs())
    assert out.shape == ref.shape == (5, 21)
    assert bool(((out - torch.as_tensor(ref)).abs() <= 2 * bound).all())


# the committed states' parameter widths: (NP, ndofp, K) of frontier_d5,
# frontier_anova_d5/d7/d10, frontier_d7 and frontier_d10 (5 P1 dims of 129
# dofs each; rank 189 to 2717), the dual states (6 dims), and the edges
_STATE_SHAPES = [(5, 129, 640), (5, 129, 189), (5, 129, 669), (5, 129, 2717),
                 (5, 129, 2304), (5, 129, 2688), (6, 129, 384)]


@pytest.mark.parametrize("NP,ndofp,K", _STATE_SHAPES)
@pytest.mark.parametrize("n0", [0, 1, 8, 32])
def test_factor_plan_state_shapes(NP, ndofp, K, n0):
    plan = fs.factor_plan(NP, ndofp, n0)
    step = fs.NARROW_PASS if n0 else fs.FACTOR_THREADS
    top = fs.narrow_rows_max(n0) if n0 else fs.TILE_ROWS_MAX
    widths = fs.NARROW_SLICE_WIDTHS if n0 else fs.SLICE_WIDTHS
    assert plan.route == "staged" and plan.ks in widths
    assert plan.smem == fs.factor_smem(NP, ndofp, plan.ks, plan.rows, n0) <= fs.SMEM_BYTES
    assert plan.rows % step == 0 and step <= plan.rows <= top <= fs.TILE_ROWS_MAX
    # the widest slice that fits a tile; the tallest tile at that slice
    wider = [ks for ks in widths if ks > plan.ks]
    assert all(fs.factor_smem(NP, ndofp, ks, step, n0) > fs.SMEM_BYTES for ks in wider)
    assert (plan.rows == top
            or fs.factor_smem(NP, ndofp, plan.ks, plan.rows + step, n0) > fs.SMEM_BYTES)
    # the sliced tables cover K, and a launch covers every sample row
    assert -(-K // plan.ks) * plan.ks >= K


def test_factor_plan_d5():
    # the d=5 state's plans, in full: F and its split at ks = 32 with two
    # table stages of 5·129·32·4 bytes and 2048 rows of samples; the fused
    # 8-point sensor product at ks = 32 too, its stages each with the
    # slice's split M0 (hi and lo, 32 × 8), 1536 rows (6 m16 tiles a warp:
    # 2048 do not fit) of located cells (8 bytes a row and dim), then the
    # barriers and the stages' counts
    assert fs.factor_plan(5, 129) == fs.FactorPlan("staged", 32, 2048,
                                                   2 * 5 * 129 * 32 * 4 + 2048 * 5 * 4)
    smem = 2 * (5 * 129 * 32 + 2 * 32 * 8) * 4 + 1536 * 5 * 8 + 32
    assert fs.factor_plan(5, 129, 8) == fs.FactorPlan("staged", 32, 1536, smem)
    # the vector sensors (16 columns: two n8 tiles, 1024 rows) and the
    # d=10 sensors (ks = 32 does not fit two stages of 10 dims)
    assert fs.factor_plan(3, 17, 16) == fs.FactorPlan(
        "staged", 32, 1024, 2 * (3 * 17 * 32 + 2 * 32 * 16) * 4 + 1024 * 3 * 8 + 32)
    assert fs.factor_plan(10, 129, 8) == fs.FactorPlan(
        "staged", 16, 768, 2 * (10 * 129 * 16 + 2 * 16 * 8) * 4 + 768 * 10 * 8 + 32)


@pytest.mark.parametrize("NP,ndofp,n0,route,ks", [
    (1, 2, 0, "staged", 32),         # the smallest tables
    (16, 129, 0, "staged", 8),       # NP = 16
    (16, 129, 32, "global", 32),     # NP = 16, the widest narrow output: no ks = 16 stages
    (16, 17, 32, "staged", 32),      # NP = 16 on P2 dims of 8 cells
    (16, 320, 0, "staged", 4),       # 5120 table rows: two ks = 4 stages still fit
    (16, 330, 0, "global", 32),      # 5280 rows: too wide for two stages
    (12, 601, 8, "global", 32),      # the GPU test's global-route shape
    (16, 5000, 32, "global", 32),
])
def test_factor_plan_edges(NP, ndofp, n0, route, ks):
    plan = fs.factor_plan(NP, ndofp, n0)
    assert (plan.route, plan.ks) == (route, ks)
    assert plan.smem == fs.factor_smem(NP, ndofp, ks, plan.rows, n0, route == "staged")
    assert plan.smem <= fs.SMEM_BYTES


def test_slice_layouts():
    rng = np.random.default_rng(3)
    NP, ndofp, K, ks = 3, 7, 37, 8
    tabs = torch.as_tensor(rng.normal(size=(NP, ndofp, K)).astype(np.float32))
    sl = fs.slice_tables(tabs, ks)
    assert sl.shape == (5, NP * ndofp, ks) and sl.is_contiguous()
    for q in range(5):
        for e in range(ks):
            k = q * ks + e
            col = sl[q, :, e].reshape(NP, ndofp)
            assert torch.equal(col, tabs[:, :, k] if k < K else torch.zeros(NP, ndofp))
    # the narrow product's M0 table: per 16-k group of each slice, the
    # split rows k ≥ K_HEAD transposed (n8, 16), hi then lo; then the head
    # rows in f32; rows past n_modes (NaN included) and the padding zero
    for n0, n8, ks_n in ((5, 8, 32), (12, 16, 16), (20, 32, 32)):
        m0 = rng.normal(size=(K, n0)).astype(np.float32)
        m0[30:] = np.nan  # rows past n_modes never reach the product
        buf = fs.narrow_table(torch.as_tensor(m0), 30, ks_n)
        n_sl = -(-K // ks_n)
        assert buf.is_contiguous() and buf.shape == (n_sl * 2 * ks_n * n8 + fs.K_HEAD * n8,)
        sl = buf[: n_sl * 2 * ks_n * n8].view(n_sl, 2, ks_n // 16, n8, 16)
        head = buf[n_sl * 2 * ks_n * n8:].view(fs.K_HEAD, n8)
        want = torch.zeros((n_sl * ks_n, n8))
        want[:30, :n0] = torch.as_tensor(m0[:30])
        assert torch.equal(head, want[: fs.K_HEAD])
        want[: fs.K_HEAD] = 0.0
        hi, lo = fs.split_tf32(want)
        for q in range(n_sl):
            for i in range(ks_n // 16):
                rows = slice(q * ks_n + 16 * i, q * ks_n + 16 * i + 16)
                assert torch.equal(sl[q, 0, i], hi[rows].T)
                assert torch.equal(sl[q, 1, i], lo[rows].T)


def _emulate_narrow(fac, m0, n_modes, ks, range_slices=None):
    """The fused narrow product's order of summation, on the table the
    kernel reads (:func:`fs.narrow_table`).  Over each k-range of
    ``range_slices`` slices (one range: all of them): the total starts as
    the head, k = K_HEAD − 1 down to 0, in f32 FMAs (emulated in f64: the
    product of two f32 numbers is exact there); then for each 16-k group
    the three tf32 passes hi·lo + lo·hi + hi·hi, summed exactly (f64 holds
    the tf32 products and their short sums) and rounded to f32, are added
    to the total in f32.  On more than one range the f32 partials are added
    in f64 and rounded once."""
    B, K = fac.shape
    n0 = m0.shape[1]
    n8 = 8 * fs.narrow_nt(n0)
    n_sl = -(-K // ks)
    buf = fs.narrow_table(m0, n_modes, ks)
    sl = buf[: n_sl * 2 * ks * n8].view(n_sl, 2, ks // 16, n8, 16).double()
    head = buf[n_sl * 2 * ks * n8:].view(fs.K_HEAD, n8).double()
    f = torch.zeros((B, n_sl * ks), dtype=torch.float32)
    f[:, :K] = fac
    f[:, n_modes:] = 0.0
    fh, fl = (t.double() for t in fs.split_tf32(f))
    n_active = -(-n_modes // ks)
    width = max(1, n_active if range_slices is None else range_slices)
    parts = []
    for q0 in range(0, max(n_active, 1), width):
        tot = torch.zeros((B, n8), dtype=torch.float32)
        if q0 == 0:
            for k in range(fs.K_HEAD - 1, -1, -1):
                tot = (f[:, k, None].double() * head[k] + tot.double()).float()
        for q in range(q0, min(q0 + width, n_active)):
            for i in range(ks // 16):
                c = slice(q * ks + 16 * i, q * ks + 16 * i + 16)
                bh, bl = sl[q, 0, i], sl[q, 1, i]  # (n8, 16): column n, k = 16i + 4t + e
                d = fh[:, c] @ bl.T + fl[:, c] @ bh.T + fh[:, c] @ bh.T
                tot = tot + d.float()
        parts.append(tot)
    out = parts[0]
    if len(parts) > 1:
        acc = parts[0].double()
        for p in parts[1:]:
            acc = acc + p.double()
        out = acc.float()
    return out[:, :n0]


# (dim-0 space, parameter dims, K, n_modes, sensor points, range slices):
# the d=5 state's widths (K = 640, 5 P1 dims of 129 dofs, 8 points, one
# k-range on a full card, and 20 ranges of one slice for a batch of few
# rows); the flagship's vector sensors (K = 32, 16 columns); the truss's
# (K = 1, two P2 dims: c = K + 8·NP; power-of-two cells, so the f32 locate
# is exact and the f64 reference sees the same cells); the d=10 widths
# (K = 2717, ks = 16,
# one range a 512-k chunk, and ranges of two slices for few rows)
_NARROW_CASES = {
    "d5": ((2048, 1), [(128, 1)] * 5, 640, 637, 8, None),
    "d5 ranges": ((2048, 1), [(128, 1)] * 5, 640, 637, 8, 1),
    "vector": ((64, 1), [(16, 1)] * 3, 32, 32, 16, None),
    "truss": ((32, 1), [(128, 2), (64, 2)], 1, 1, 8, None),
    "d10": ((256, 1), [(128, 1)] * 10, 2717, 2717, 8, 32),
    "d10 ranges": ((256, 1), [(128, 1)] * 10, 2717, 2717, 8, 2),
}


@pytest.mark.parametrize("case", list(_NARROW_CASES))
def test_narrow_emulation_d5_widths(case):
    # the kernel's order of summation at the served widths, held within
    # γ_c·|F||M0| of the JAX package's f64 sensor sweep on the same modes,
    # c = fs.sum_roundings(K) + 4·NP (8·NP on P2 dims, whose |F| takes |φ|)
    (nx, degx), dims, K, n_modes, n_pts, ranges = _NARROW_CASES[case]
    jV = [JSpace(JMesh(nx, 0.0, 1.0), "P", degx)] + [JSpace(JMesh(n, 0.0, 1.0), "P", d)
                                                     for n, d in dims]
    tV = [TSpace(TMesh(nx, 0.0, 1.0), "P", degx)] + [TSpace(TMesh(n, 0.0, 1.0), "P", d)
                                                     for n, d in dims]
    NP = len(dims)
    rng = np.random.default_rng(K + n_pts)
    modes = [rng.normal(size=(K, V.ndofs)).astype(np.float32) for V in tV]
    pts = np.array([0.05 + 0.9 * i / (n_pts - 1) for i in range(n_pts)])
    table = tv.sensor_table(tV[0], torch.as_tensor(modes[0]), pts)
    sweep = _port(tV, [table] + modes[1:], n_modes)
    s = torch.as_tensor(_samples(24, NP, seed=5))
    fac = fs.fused_sweep_plain(s, sweep.grid, sweep.tabs, None, n_modes)
    plan = fs.factor_plan(NP, sweep.tabs.shape[1], n_pts)
    out = _emulate_narrow(fac, sweep.m0, n_modes, plan.ks, ranges).double()
    jm = [jnp.asarray(m.astype(np.float64)) for m in modes]
    ref = torch.as_tensor(np.array(
        jv.make_sensor_sweep_fn(jV, jm, n_modes, pts, method="xla")(jnp.asarray(s.double()))))
    # |F| from the bases' absolute values (P2 bases change sign in a cell)
    grid = sweep.grid.double()
    t = (s.double() - grid[0]) * grid[1]
    cell = torch.minimum(torch.clamp(torch.floor(t), min=0.0), grid[2] - 1)
    xi = t - cell
    fabs = torch.ones((24, K), dtype=torch.float64)
    for j, (_, deg) in enumerate(dims):
        x = xi[:, j, None]
        basis = ((1 - x, x) if deg == 1 else
                 ((1 - x) * (1 - 2 * x), 4 * x * (1 - x), x * (2 * x - 1)))
        base = (deg * cell[:, j]).long()
        tab = torch.as_tensor(modes[j + 1]).double().abs().T
        fabs = fabs * sum(tab[base + l] * b.abs() for l, b in enumerate(basis))
    fabs[:, n_modes:] = 0.0
    c = fs.sum_roundings(K) + (8 if dims[0][1] == 2 else 4) * NP
    u = 2.0 ** -24
    bound = c * u / (1 - c * u) * (fabs @ torch.as_tensor(table).double().abs())
    ratio = float(((out - ref).abs() / bound).max())
    print(f"fused narrow emulation {case}, ks {plan.ks}: max |err| / gamma_c bound = "
          f"{ratio:.4f}")
    assert out.shape == (24, n_pts) and ratio <= 1.0


# ROADMAP C4: modes whose largest do not come first.  The elasticity
# flagship's shapes (K = 32 modes, 3 P1 dims of 17 dofs; its 2426-dof
# fields through the GEMM, its 16-column vector sensors through the narrow
# product), with modes made as the flagship's are: no cancellation in the
# sum (positive tables) and amplitudes falling by 10^-0.5 a mode.
_C4_ORDERS = {"trained": np.arange(32), "largest last": np.r_[8:32, 0:8],
              "shuffled": np.random.default_rng(32).permutation(32)}


@pytest.mark.parametrize("product", ["gemm", "narrow"])
@pytest.mark.parametrize("order", list(_C4_ORDERS))
@pytest.mark.parametrize("seed", [2, 3])
def test_head_modes_by_size(product, order, seed):
    # the kernels' arithmetic on the modes as a sweep binds them
    # (fs.head_order: the 8 largest first) serves within the flagship's
    # gate, 1.1x the plain f32 version's error against the f64 product of
    # the same tables (max rel-L2 over the samples).  Bound in their own
    # order, the 8 largest last take the GEMM past it (1.42-1.63x): the
    # head's f32 FMAs then sum small terms and the largest go through
    # 3xTF32.  The narrow product's 16 columns show it less and not at
    # every order (0.97-1.16x with the largest not first, the modes' own
    # order), so only the GEMM's is asserted
    K, NP = 32, 3
    n0 = 2426 if product == "gemm" else 16
    tV = [TSpace(TMesh(n0 - 1, 0.0, 1.0), "P", 1)] + [TSpace(TMesh(16, 0.0, 1.0), "P", 1)] * NP
    rng = np.random.default_rng(seed)
    modes = [rng.uniform(0.5, 1.5, size=(K, V.ndofs)).astype(np.float32) for V in tV]
    modes[0] = (modes[0] * 10.0 ** (-0.5 * np.arange(K))[:, None]).astype(np.float32)
    perm = _C4_ORDERS[order]
    sweep = _port(tV, [m[perm] for m in modes], K)
    s = torch.as_tensor(_samples(64, NP, seed=seed))
    bind = fs.head_order(sweep.tabs, sweep.m0, K)
    if order == "trained":
        assert bind is None
    else:
        assert sorted(perm[bind[: fs.K_HEAD].numpy()]) == list(range(fs.K_HEAD))
        assert sorted(bind.tolist()) == list(range(K))
    ref = fs.fused_sweep_plain(s, sweep.grid, sweep.tabs.double(), sweep.m0.double(), K)

    def err(out):
        return float(((out.double() - ref).norm(dim=1) / ref.norm(dim=1)).max())

    def kernel(tabs, m0):
        fac = fs.fused_sweep_plain(s, sweep.grid, tabs, None, K)
        if product == "gemm":
            return _emulate_3xtf32(fac, m0, K, fs.K_GROUP)
        return _emulate_narrow(fac, m0, K, fs.factor_plan(NP, 17, n0).ks)

    plain = err(fs.fused_sweep_plain(s, sweep.grid, sweep.tabs, sweep.m0, K))
    tabs, m0 = ((sweep.tabs, sweep.m0) if bind is None
                else (sweep.tabs[:, :, bind], sweep.m0[bind]))
    bound, unbound = err(kernel(tabs, m0)), err(kernel(sweep.tabs, sweep.m0))
    print(f"C4 {product} {order} seed {seed}: plain f32 {plain:.4e}, kernel as bound "
          f"{bound:.4e} ({bound / plain:.4f}x), in the modes' own order {unbound:.4e} "
          f"({unbound / plain:.4f}x)")
    assert bound <= 1.1 * plain
    if order == "largest last" and product == "gemm":
        assert unbound > 1.1 * plain


@pytest.mark.parametrize("K", [640, 1024, 1025, 2717])
def test_chunked_product(K):
    # up to SPLIT_K_MIN modes the product is one torch.matmul, bit for bit
    # (the order every wiring had before the chunked sum); above it 16-k
    # f32 products are added in f32 within a 512-k chunk and the chunks in
    # f64, within γ_c·|F||M0|, c = K_CHUNK + n_chunks + 1, of the f64 product
    rng = np.random.default_rng(K)
    fac = torch.as_tensor(rng.normal(size=(6, K)).astype(np.float32))
    m0 = torch.as_tensor(rng.normal(size=(K, 33)).astype(np.float32))
    out = fs.chunked_product(fac, m0)
    n_ch = fs.k_chunks(K)
    if K <= fs.SPLIT_K_MIN:
        assert n_ch == 1 and torch.equal(out, torch.matmul(fac, m0))
    else:
        assert n_ch == -(-K // fs.K_CHUNK)
        ref = torch.zeros((6, 33), dtype=torch.float64)
        for k0 in range(0, K, fs.K_CHUNK):
            tot = torch.zeros((6, 33))
            for g0 in range(k0, min(K, k0 + fs.K_CHUNK), fs.K_GROUP):
                tot += fac[:, g0:g0 + fs.K_GROUP] @ m0[g0:g0 + fs.K_GROUP]
            ref += tot.double()
        assert torch.equal(out, ref.float())
    c = min(K, fs.K_CHUNK) + n_ch + 1
    u = 2.0 ** -24
    bound = c * u / (1 - c * u) * (fac.double().abs() @ m0.double().abs())
    assert bool(((out.double() - fac.double() @ m0.double()).abs() <= bound).all())
    assert torch.equal(fs.chunked_product(fac.double(), m0.double()),
                       fac.double() @ m0.double())


# the inset corners (box_corners order) of the committed d=10 state where
# the plain f32 fields, summed over all K = 2717 modes in one f32 product,
# came above 9.5e-7 against FEM (two of them above 1e-6: 963 at 1.093e-6,
# 995 at 1.039e-6); the f64 product of the same f32 tables gives 8.88e-7
# at the worst corner
_D10_WORST = (475, 639, 703, 733, 799, 863, 963, 995, 1001, 1015)


def test_d10_served_fields_vs_fem():
    # the committed rank-2717 d=10 vademecum served by the plain f32 path
    # (16-k products summed in f32 within 512-k chunks, the chunks in f64)
    # under the 1e-6 FEM gate
    from pathlib import Path

    from pgdrome_tpu_torch.convert import frontier_build, load_state_npz
    from pgdrome_tpu_torch.models.problems import box_corners, elliptic_fem_solver
    from pgdrome_tpu_torch.serving import Vademecum

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        state = Path(__file__).resolve().parent.parent / "states" / "frontier_anova_d10_state.npz"
        Vs, tf = frontier_build(10)
        vd = Vademecum(Vs, load_state_npz(state), dim0_transform=tf, device="cpu")
        grid = Vs[1].tabulate_dof_coordinates()[:, 0]
        pts = box_corners(grid[1], grid[-2], 10, np.asarray(_D10_WORST))
        served = vd.fields(pts).double().numpy()
    finally:
        torch.set_num_threads(threads)
    fem = elliptic_fem_solver(Vs[0], 10)
    rel = [np.linalg.norm(x - u) / np.linalg.norm(u)
           for x, u in zip(served, (fem(p) for p in pts))]
    print(f"d=10 plain f32 fields at the {len(rel)} worst corners: max rel-L2 {max(rel):.6e}")
    assert max(rel) < 1e-6
