"""The sweep's CUDA kernels (the factor kernel with its fused narrow
product, the tensor-core GEMM) against their plain PyTorch version, on the
card; the solver on the card against the f64 CPU solve; the compensated
dd path on the card against the CPU, bit for bit.

These tests need an NVIDIA GPU with ``nvcc`` (sm_90a); without one they
skip.  They import no JAX, so they run on a machine that has only the
port's dependencies:

    python -m pytest tests/test_torch_gpu.py -q

Inputs are made with numpy from fixed seeds; tolerances are stated per test.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from pgdrome_tpu_torch.fem.mesh import IntervalMesh
from pgdrome_tpu_torch.fem.space import FunctionSpace
from pgdrome_tpu_torch.ops import fused_sweep as fs

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _case(deg_p, n_cells, K, n0, NP, seed):
    rng = np.random.default_rng(seed)
    Vx = FunctionSpace(IntervalMesh(max(n0 - 1, 1), 0.0, 1.0), "P", 1)
    Vp = [FunctionSpace(IntervalMesh(n_cells, 0.0, 2.0), "P", deg_p) for _ in range(NP)]
    m0 = rng.normal(size=(K, n0)).astype(np.float32)
    mp = [rng.normal(size=(K, V.ndofs)).astype(np.float32) for V in Vp]
    return [Vx] + Vp, [m0] + mp


def _run(cuda, spaces, modes, n_modes, samples, out_dtype=None, factors=False):
    m = [None] + modes[1:] if factors else modes
    kern = fs.make_fused_sweep(spaces, m, n_modes, out_dtype=out_dtype, device=cuda)
    plain = fs.make_fused_sweep(spaces, m, n_modes, out_dtype=out_dtype, device="cpu")
    out = kern(torch.as_tensor(samples, device=cuda))
    torch.cuda.synchronize()
    return out.cpu(), plain(torch.as_tensor(samples))


def _gamma_bound(spaces, modes, n_modes, samples, c, factors=False):
    """γ_c · |F|·|M0| in f64 (P1 bases are ≥ 0, so |F| is the factor of |T|;
    M0 rows at or past ``n_modes`` never contribute)."""
    grid = torch.as_tensor(fs.sweep_grid(spaces))
    tabs = fs.stack_tables([torch.as_tensor(np.abs(m)) for m in modes[1:]], "cpu").double()
    fabs = fs.fused_sweep_plain(torch.as_tensor(samples), grid, tabs, None, n_modes)
    u = 2.0 ** -24
    g = c * u / (1 - c * u)
    if factors:
        return g * fabs
    m0 = np.abs(modes[0]).astype(np.float64)
    m0[n_modes:] = 0.0
    return g * (fabs @ torch.as_tensor(m0))


@pytest.mark.parametrize("K,n0,NP,B,n_modes", [
    (10, 41, 2, 73, 7),       # toy sizes, ragged in every axis
    (33, 130, 3, 129, 33),    # one past a tile in K, n0 and rows
    (640, 2049, 5, 200, 640),  # the d=5 vademecum's widths
    (1000, 400, 3, 70, 1000),  # a last n0 tile wider than half a GEMM tile
    (2717, 300, 2, 20, 2700),  # the d=10 state's rank
    (641, 2049, 5, 300, 641),  # K not a multiple of 8; B not of 128
])
def test_fields_f32_matches_plain(cuda, K, n0, NP, B, n_modes):
    spaces, modes = _case(1, 16, K, n0, NP, seed=K + n0)
    samples = np.random.default_rng(1).uniform(0.0, 2.0, size=(B, NP)).astype(np.float32)
    samples[0] = 0.0
    samples[1] = 2.0  # right end: last cell, ξ = 1
    out, ref = _run(cuda, spaces, modes, n_modes, samples)
    assert out.shape == (B, n0) and out.dtype == torch.float32
    # both f32 results lie within γ_c·|F||M0| of the exact value, c = K + 4·NP
    bound = _gamma_bound(spaces, modes, n_modes, samples, K + 4 * NP)
    assert bool(((out.double() - ref.double()).abs() <= 2 * bound).all())


def test_bf16_store(cuda):
    spaces, modes = _case(1, 16, 10, 300, 2, seed=3)
    samples = np.random.default_rng(2).uniform(0.0, 2.0, size=(50, 2)).astype(np.float32)
    out, _ = _run(cuda, spaces, modes, 8, samples, out_dtype=torch.bfloat16)
    f32, _ = _run(cuda, spaces, modes, 8, samples)
    assert out.dtype == torch.bfloat16 and out.shape == f32.shape
    # the store narrows only: within bf16 quantization of the f32 kernel
    assert float((out.double() - f32.double()).abs().max()) < 1.6e-2 * float(f32.abs().max())


def test_p2_param_dims(cuda):
    spaces, modes = _case(2, 8, 12, 70, 2, seed=4)
    samples = np.random.default_rng(3).uniform(0.0, 2.0, size=(37, 2)).astype(np.float32)
    out, ref = _run(cuda, spaces, modes, 12, samples)
    # P2 weights can be negative; hold to the JAX test's 1e-5·max tolerance
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5 * float(ref.abs().max()))


@pytest.mark.parametrize("K,n0", [(40, 1), (40, 8), (40, 32), (640, 8), (640, 33)])
def test_narrow_outputs(cuda, K, n0):
    # outputs narrower than one 128-column group: the sensor wiring
    spaces, modes = _case(1, 16, K, n0, 3, seed=n0)
    samples = np.random.default_rng(4).uniform(0.0, 2.0, size=(131, 3)).astype(np.float32)
    fs.reset_launch_counts()
    out, ref = _run(cuda, spaces, modes, K - 3, samples)
    assert out.shape == (131, n0)
    wiring = "sensors" if n0 <= fs.SENSORS_MAX else "fields_f32"
    assert fs.LAUNCHES[wiring] == 1 and sum(fs.LAUNCHES.values()) == 1
    bound = _gamma_bound(spaces, modes, K - 3, samples, K + 12)
    assert bool(((out.double() - ref.double()).abs() <= 2 * bound).all())


def test_factors(cuda):
    spaces, modes = _case(1, 16, 50, 20, 4, seed=5)
    samples = np.random.default_rng(5).uniform(0.0, 2.0, size=(300, 4)).astype(np.float32)
    out, ref = _run(cuda, spaces, modes, 45, samples, factors=True)
    assert out.shape == (300, 50)
    assert bool((out[:, 45:] == 0).all())
    # the kernel rounds every operation as the plain version does: equal
    # bit for bit; the rounding bound is kept beside it
    assert torch.equal(out, ref)
    bound = _gamma_bound(spaces, modes, 45, samples, 16, factors=True)
    assert bool(((out.double() - ref.double()).abs() <= 2 * bound).all())


def test_empty_batch_and_counts(cuda):
    spaces, modes = _case(1, 16, 10, 41, 2, seed=6)
    kern = fs.make_fused_sweep(spaces, modes, 10, device=cuda)
    fs.reset_launch_counts()
    assert kern(torch.zeros((0, 2), device=cuda)).shape == (0, 41)
    assert fs.LAUNCHES["fields_f32"] == 0
    kern(torch.zeros((5, 2), device=cuda))
    assert fs.LAUNCHES["fields_f32"] == 1


def test_rejects_wrong_inputs(cuda):
    spaces, modes = _case(1, 16, 10, 41, 2, seed=7)
    kern = fs.make_fused_sweep(spaces, modes, 10, device=cuda)
    with pytest.raises(ValueError):  # wrong number of parameter dims
        fs.fused_sweep(torch.zeros((4, 3), device=cuda), kern.grid, kern.tabs, kern.m0, 10)
    with pytest.raises(TypeError):  # float64 samples
        fs.fused_sweep(torch.zeros((4, 2), device=cuda, dtype=torch.float64),
                       kern.grid, kern.tabs, kern.m0, 10)
    with pytest.raises(ValueError):  # n_modes beyond the tables
        fs.fused_sweep(torch.zeros((4, 2), device=cuda), kern.grid, kern.tabs, kern.m0, 11)


@pytest.mark.parametrize("K,n0,B", [
    (641, 2049, 1), (641, 1, 300), (641, 8, 129), (64, 2049, 257), (8, 33, 127),
])
def test_edge_shapes(cuda, K, n0, B):
    # one sample, one output column, K past a multiple of 8, ragged B
    spaces, modes = _case(1, 16, K, n0, 5, seed=K + n0 + B)
    samples = np.random.default_rng(B).uniform(0.0, 2.0, size=(B, 5)).astype(np.float32)
    fs.reset_launch_counts()
    out, ref = _run(cuda, spaces, modes, K - 1, samples)
    assert out.shape == (B, n0)
    narrow = n0 <= fs.SENSORS_MAX
    # the narrow product of so few rows splits k into ranges whose f32
    # partials the partial sum adds (ops/fused_sweep.py::factor_grid)
    assert fs.STAGE_LAUNCHES == {"factors_stage": 0 if narrow else 1,
                                 "sensor_fused": 1 if narrow else 0,
                                 "factors_global": 0, "gemm": 0 if narrow else 1,
                                 "partial_sum": 1 if narrow else 0}
    bound = _gamma_bound(spaces, modes, K - 1, samples, K + 20)
    assert bool(((out.double() - ref.double()).abs() <= 2 * bound).all())


@pytest.mark.parametrize("n0", [8, 300])
def test_nan_rows_past_n_modes(cuda, n0):
    # padded-buffer rows of M0 may hold anything; none reaches the output
    spaces, modes = _case(1, 16, 100, n0, 3, seed=n0)
    modes[0][90:] = np.nan
    samples = np.random.default_rng(9).uniform(0.0, 2.0, size=(200, 3)).astype(np.float32)
    out, ref = _run(cuda, spaces, modes, 90, samples)
    assert bool(torch.isfinite(out).all())
    bound = _gamma_bound(spaces, modes, 90, samples, 100 + 12)
    assert bool(((out.double() - ref.double()).abs() <= 2 * bound).all())


@pytest.mark.parametrize("K,NP,n_modes,B,n_cells", [
    (45, 4, 41, 333, 16),
    # few rows, many modes: the launch shortens its tiles and splits k
    # across blockIdx.y (ops/fused_sweep.py::factor_grid)
    (384, 10, 384, 1, 128), (384, 10, 381, 64, 128), (384, 10, 384, 1024, 128),
    (384, 10, 384, 1360, 128), (2717, 10, 2717, 1, 128), (2717, 10, 2714, 64, 128),
    (2717, 10, 2717, 1024, 128), (2717, 10, 2717, 1360, 128),
])
def test_split_store_matches_plain(cuda, K, NP, n_modes, B, n_cells):
    # stage 1's hi/lo store is the plain split_factors of its own f32
    # factors (the head whole, the rest split_tf32), bit for bit; the
    # padding columns past K are zero
    spaces, modes = _case(1, n_cells, K, 20, NP, seed=11 + K + B)
    kern = fs.make_fused_sweep(spaces, [None] + modes[1:], n_modes, device=cuda)
    s = torch.as_tensor(np.random.default_rng(10 + B).uniform(0.0, 2.0, size=(B, NP)),
                        dtype=torch.float32, device=cuda)
    f = torch.full((B, K), float("nan"), device=cuda)
    hi = torch.full((B, fs.padded_k(K)), float("nan"), device=cuda)
    lo = torch.full_like(hi, float("nan"))
    fs.factors_stage(s, kern.grid, kern.tabs, n_modes, f)
    fs.factors_stage(s, kern.grid, kern.tabs, n_modes, hi, lo)
    torch.cuda.synchronize()
    assert bool((f[:, n_modes:] == 0).all())
    assert bool((hi[:, K:] == 0).all()) and bool((lo[:, K:] == 0).all())
    ph, pl = fs.split_factors(f)
    assert torch.equal(hi[:, :K].view(torch.int32), ph.view(torch.int32))
    assert torch.equal(lo[:, :K].view(torch.int32), pl.view(torch.int32))
    assert torch.equal(f, fs.fused_sweep_plain(s, kern.grid, kern.tabs, None, n_modes))


def test_row_chunks_bitwise(cuda, monkeypatch):
    # a batch walked in several scratch chunks equals the one-chunk result
    spaces, modes = _case(1, 16, 64, 130, 2, seed=12)
    samples = np.random.default_rng(11).uniform(0.0, 2.0, size=(1000, 2)).astype(np.float32)
    kern = fs.make_fused_sweep(spaces, modes, 60, device=cuda)
    s = torch.as_tensor(samples, device=cuda)
    one = kern(s)
    monkeypatch.setattr(fs, "SCRATCH_BYTES", 256 * 8 * 64)
    assert len(fs.row_chunks(1000, 64)) == 4
    fs.reset_launch_counts()
    many = kern(s)
    torch.cuda.synchronize()
    assert fs.STAGE_LAUNCHES == {"factors_stage": 4, "sensor_fused": 0, "factors_global": 0,
                                 "gemm": 4, "partial_sum": 0}
    assert fs.LAUNCHES["fields_f32"] == 1
    assert torch.equal(one, many)


@pytest.mark.parametrize("n0", [8, 300])
def test_large_k(cuda, n0):
    # K = 6000: the factor stage and the GEMM have no limit on K but memory
    spaces, modes = _case(1, 16, 6000, n0, 2, seed=n0 + 6000)
    samples = np.random.default_rng(13).uniform(0.0, 2.0, size=(70, 2)).astype(np.float32)
    fs.reset_launch_counts()
    out, ref = _run(cuda, spaces, modes, 5993, samples)
    assert out.shape == (70, n0)
    narrow = n0 <= fs.SENSORS_MAX
    # past SPLIT_K_MIN either product is summed in 512-k chunks
    assert fs.STAGE_LAUNCHES == {"factors_stage": 0 if narrow else 1,
                                 "sensor_fused": 1 if narrow else 0,
                                 "factors_global": 0, "gemm": 0 if narrow else 1,
                                 "partial_sum": 1}
    bound = _gamma_bound(spaces, modes, 5993, samples, 6000 + 8)
    assert bool(((out.double() - ref.double()).abs() <= 2 * bound).all())


def test_served_d5_fields_vs_fem(cuda):
    # the committed rank-640 d=5 vademecum served through the kernels, held
    # to the FEM gate at the 32 inset corners of the parameter box.  The
    # sum over modes cancels heavily there, so a bias in the GEMM's
    # accumulation shows in this error before the elementwise γ bound sees
    # it (PERF.md 6.1: 32-k tensor-core accumulators give 1.02e-6)
    from pgdrome_tpu_torch.convert import frontier_vademecum
    from pgdrome_tpu_torch.models.problems import box_corners, elliptic_fem_solver

    state = Path(__file__).resolve().parent.parent / "states" / "frontier_d5_state.npz"
    vd = frontier_vademecum(state, 5, device=cuda)
    assert isinstance(vd._sweep(), fs.FusedSweep)
    grid_p = vd.spaces[1].tabulate_dof_coordinates()[:, 0]
    corners = box_corners(grid_p[1], grid_p[-2], 5)
    fem = elliptic_fem_solver(vd.spaces[0], 5)
    fs.reset_launch_counts()
    served = vd.fields(corners).double().cpu().numpy()
    assert fs.STAGE_LAUNCHES["gemm"] == 1
    rel = [np.linalg.norm(x - u) / np.linalg.norm(u)
           for x, u in zip(served, (fem(p) for p in corners))]
    assert len(rel) == 32 and max(rel) < 1e-6


def test_served_d10_fields_vs_fem(cuda):
    # the committed rank-2717 d=10 vademecum served through the kernels
    # under the 1e-6 FEM gate at all 1024 inset corners: the GEMM sums
    # 512-k chunks and the partials are added in f64 (one linear f32 sum
    # over all 170 16-k groups served 1.127e-6 here)
    from pgdrome_tpu_torch.convert import frontier_vademecum
    from pgdrome_tpu_torch.models.problems import box_corners, elliptic_fem_solver

    state = Path(__file__).resolve().parent.parent / "states" / "frontier_anova_d10_state.npz"
    vd = frontier_vademecum(state, 10, device=cuda)
    grid_p = vd.spaces[1].tabulate_dof_coordinates()[:, 0]
    corners = box_corners(grid_p[1], grid_p[-2], 10)
    fem = elliptic_fem_solver(vd.spaces[0], 10)
    fs.reset_launch_counts()
    served = vd.fields(corners).double().cpu().numpy()
    assert fs.STAGE_LAUNCHES["gemm"] == 1 and fs.STAGE_LAUNCHES["partial_sum"] == 1
    rel = [np.linalg.norm(x - u) / np.linalg.norm(u)
           for x, u in zip(served, (fem(p) for p in corners))]
    assert len(rel) == 1024 and max(rel) < 1e-6


@pytest.mark.parametrize("K", [1024, 1025, 2717])
def test_split_k(cuda, K):
    # up to SPLIT_K_MIN the GEMM runs as one chunk, bit for bit the direct
    # one-chunk launch (no partial buffer: the kernel's path before the
    # chunked sum); above it the output is the f64 sum of the kernel's own
    # 512-k partials, bit for bit; within 2γ_c|F||M0| of the plain
    # version, c = K (one chunk) or K_CHUNK + n_chunks, plus 4·NP
    spaces, modes = _case(1, 16, K, 300, 3, seed=K)
    samples = np.random.default_rng(K).uniform(0.0, 2.0, size=(200, 3)).astype(np.float32)
    sweep, s, ref = _plain_on_card(spaces, modes, K - 2, samples, cuda)
    fs.reset_launch_counts()
    out = sweep(s)
    torch.cuda.synchronize()
    n_ch = fs.k_chunks(fs.padded_k(K))
    assert fs.STAGE_LAUNCHES["partial_sum"] == (0 if n_ch == 1 else 1)
    hi = torch.empty((200, fs.padded_k(K)), device=cuda)
    lo = torch.empty_like(hi)
    # F in the sweep's binding of the modes (fs.head_order), as its table
    fs.factors_stage(s, sweep.grid, sweep.tabs, K - 2, hi, lo, sliced=sweep.sliced)
    part = torch.empty((n_ch, 200, 300), device=cuda)
    direct = torch.empty((200, 300), device=cuda)
    # the table's maps encoded for this call, not the sweep's cached ones
    fs.gemm_stage(hi, lo, *sweep.table, direct, part=None if n_ch == 1 else part)
    torch.cuda.synchronize()
    if n_ch == 1:
        assert torch.equal(out, direct)
    else:
        acc = part[0].double()
        for c in range(1, n_ch):  # chunk order, as the kernel adds them
            acc += part[c].double()
        assert torch.equal(out, acc.float())
    c = (K if n_ch == 1 else fs.K_CHUNK + n_ch) + 12
    bound = _gamma_bound(spaces, modes, K - 2, samples, c)
    assert bool(((out.double().cpu() - ref.double().cpu()).abs() <= 2 * bound).all())


@pytest.mark.parametrize("n0", [2048, 2049, 2426, 4913, 5184])
@pytest.mark.parametrize("K", [8, 30, 32, 640, 2717])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_gemm_epilogue(cuda, n0, K, out_dtype):
    # the persistent GEMM's shared-memory epilogue at the served widths:
    # 16-byte stores where rows are 16-byte multiples (f32, n0 % 4 == 0),
    # 8-byte ones where n0 is even, else 4-byte ones (and for bf16); 300
    # rows (not a multiple of 128) and one
    # row, both within 2γ_c|F||M0| of the plain version storing the same
    # dtype (c = the sum's roundings + 4·NP; a bf16 ulp more for bf16),
    # and the one row equal to row 0 of the batch (the same arithmetic)
    NP = 2
    spaces, modes = _case(1, 16, K, n0, NP, seed=K + n0)
    samples = np.random.default_rng(K * n0).uniform(0.0, 2.0, size=(300, NP)).astype(np.float32)
    sweep, s, ref = _plain_on_card(spaces, modes, K, samples, cuda, out_dtype)
    fs.reset_launch_counts()
    out = sweep(s)
    one = sweep(s[:1])
    torch.cuda.synchronize()
    assert fs.STAGE_LAUNCHES["gemm"] == 2 and out.dtype == out_dtype
    assert torch.equal(one, out[:1])
    bound = _gamma_bound(spaces, modes, K, samples, fs.sum_roundings(K) + 4 * NP)
    _hold_narrow(out.cpu(), ref.cpu(), bound, out_dtype == torch.bfloat16)


@pytest.mark.parametrize("K,n0,B", [(2717, 300, 20_000), (32, 2426, 40_000), (640, 2048, 9_000)])
def test_gemm_persistent_walk(cuda, K, n0, B):
    # thousands of work items a launch: each persistent block walks many
    # (m-tile, n-tile, k-chunk) items through one stage ring; the result is
    # within 2γ_c of the plain version and, row by row, bit for bit what a
    # launch of those rows alone gives
    NP = 3
    spaces, modes = _case(1, 16, K, n0, NP, seed=B)
    samples = np.random.default_rng(B).uniform(0.0, 2.0, size=(B, NP)).astype(np.float32)
    sweep, s, ref = _plain_on_card(spaces, modes, K, samples, cuda)
    out = sweep(s)
    tail = sweep(s[-333:])
    torch.cuda.synchronize()
    assert torch.equal(tail, out[-333:])
    bound = _gamma_bound(spaces, modes, K, samples, fs.sum_roundings(K) + 4 * NP)
    _hold_narrow(out.cpu(), ref.cpu(), bound, False)


def _plain_on_card(spaces, modes, n_modes, samples, cuda, out_dtype=None, factors=False):
    """The plain version on the card, on the same inputs as the kernel."""
    sweep = fs.make_fused_sweep(spaces, [None] + modes[1:] if factors else modes, n_modes,
                                out_dtype=out_dtype, device=cuda)
    s = torch.as_tensor(samples, device=cuda)
    return sweep, s, fs.fused_sweep_plain(s, sweep.grid, sweep.tabs, sweep.m0, n_modes,
                                          out_dtype)


@pytest.mark.parametrize("deg_p,n_cells,NP,K,n_modes,B", [
    (1, 128, 5, 640, 640, 5000),  # the d=5 widths, B past two 2048-row tiles
    (2, 8, 3, 77, 70, 777),       # P2 dims, K not a multiple of 4, n_modes < K
    (1, 8, 16, 130, 129, 300),    # NP = 16
    (2, 8, 16, 33, 33, 257),      # NP = 16 with P2 dims (a narrow slice)
    (1, 8, 2, 5, 0, 10),          # no mode at all
    # few rows, many modes (the d=10 and dual widths): shortened tiles and
    # k-ranges across blockIdx.y
    (1, 128, 10, 384, 384, 1), (1, 128, 10, 384, 380, 64), (1, 128, 10, 384, 384, 1024),
    (1, 128, 10, 384, 384, 1360), (1, 128, 10, 2717, 2717, 1), (1, 128, 10, 2717, 2713, 64),
    (1, 128, 10, 2717, 2717, 1024), (1, 128, 10, 2717, 2717, 1360),
])
def test_factors_bitwise(cuda, deg_p, n_cells, NP, K, n_modes, B):
    # every slice width the plan can take, the F store and its split,
    # equal bit for bit to the plain version on the card, on the grid the
    # batch gets (row tiles x k-ranges)
    spaces, modes = _case(deg_p, n_cells, K, 3, NP, seed=NP * K)
    samples = np.random.default_rng(B).uniform(0.0, 2.0, size=(B, NP)).astype(np.float32)
    samples[0], samples[min(1, B - 1)] = 0.0, 2.0
    sweep, s, ref = _plain_on_card(spaces, modes, n_modes, samples, cuda, factors=True)
    NPt, ndofp, _ = sweep.tabs.shape
    for ks in fs.SLICE_WIDTHS:
        rows = fs.FACTOR_THREADS
        plan = fs.FactorPlan("staged", ks, rows, fs.factor_smem(NPt, ndofp, ks, rows))
        if plan.smem > fs.SMEM_BYTES:
            continue
        f = torch.full((B, K), float("nan"), device=cuda)
        hi = torch.full((B, fs.padded_k(K)), float("nan"), device=cuda)
        lo = torch.full_like(hi, float("nan"))
        fs.factors_stage(s, sweep.grid, sweep.tabs, n_modes, f, plan=plan)
        fs.factors_stage(s, sweep.grid, sweep.tabs, n_modes, hi, lo, plan=plan)
        torch.cuda.synchronize()
        assert torch.equal(f, ref), ks
        ph, pl = fs.split_factors(ref)
        assert torch.equal(hi[:, :K].view(torch.int32), ph.view(torch.int32))
        assert torch.equal(lo[:, :K].view(torch.int32), pl.view(torch.int32))
        assert bool((hi[:, K:] == 0).all()) and bool((lo[:, K:] == 0).all())


def _hold_narrow(out, ref, bound, bf16):
    if bf16:
        big = torch.maximum(out.double().abs(), ref.double().abs())
        ulp = torch.ldexp(torch.ones_like(big), torch.frexp(big)[1] - 8)
        bound = 2 * bound + ulp
    else:
        bound = 2 * bound
    assert bool(((out.double() - ref.double()).abs() <= bound).all())


@pytest.mark.parametrize("NP,K,n_modes,B,n0,ks", [
    (5, 640, 637, 3001, 1, 32),   # the d=5 widths, ragged B
    (5, 640, 637, 3001, 8, 32),
    (5, 640, 637, 3001, 32, 32),
    # NP = 16 tables of 129 dofs fit no two ks = 16 stages: the global
    # route; K not a multiple of 4
    (16, 203, 200, 2049, 8, 32), (16, 203, 200, 2049, 32, 32),
    # the d=10 widths at few rows: k-ranges of a power of two of slices,
    # each its own f32 partial, added in f64 by the partial sum
    (10, 2717, 2717, 1024, 8, 16), (10, 2717, 2710, 64, 8, 16), (10, 384, 384, 1, 8, 16),
    (10, 384, 384, 1360, 32, 16),
    # a batch that fills the card (B None: one tile of the plan's rows an
    # SM, and 33 rows) past SPLIT_K_MIN: one k-range a K_CHUNK
    (10, 1100, 1100, None, 8, 16),
])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_sensor_fused(cuda, NP, K, n_modes, B, n0, ks, out_dtype):
    # the fused narrow product at the slice width its plan takes, held
    # within 2γ_c·|F||M0| of the plain version storing the same dtype (plus
    # one bf16 ulp for the two bf16 roundings), c = the sum's roundings
    # (fs.sum_roundings) + 4·NP; F reaches no HBM buffer.  Each case splits
    # k into ranges whose partials the partial sum adds: a batch of few
    # rows to fill the card, a full card's past SPLIT_K_MIN at one a K_CHUNK
    full = B is None
    if full:
        B = fs.sm_count(cuda) * fs.factor_plan(NP, 129, n0).rows + 33
    spaces, modes = _case(1, 128, K, n0, NP, seed=NP + n0)
    samples = np.random.default_rng(n0).uniform(0.0, 2.0, size=(B, NP)).astype(np.float32)
    samples[0], samples[min(1, B - 1)] = 0.0, 2.0
    sweep, s, ref = _plain_on_card(spaces, modes, n_modes, samples, cuda, out_dtype)
    route = "global" if NP == 16 else "staged"
    assert (sweep.plan.route, sweep.plan.ks) == (route, ks)
    fs.reset_launch_counts()
    out = sweep(s)
    torch.cuda.synchronize()
    g = sweep.last_plan["factor"][0]
    assert g["ranges"] > 1 and "partial_sum_blocks" in g
    assert (g["tiles"] >= fs.sm_count(cuda)) == full
    if full:
        rows = fs.wave_rows(sweep.plan.rows, B, fs.sm_count(cuda))
        assert (g["rows"], g["range_slices"]) == (rows, fs.K_CHUNK // ks)
    assert fs.STAGE_LAUNCHES == {"factors_stage": 0, "sensor_fused": int(route == "staged"),
                                 "factors_global": int(route == "global"), "gemm": 0,
                                 "partial_sum": 1}
    assert fs.LAUNCHES["sensors"] == 1 and out.dtype == out_dtype and out.shape == (B, n0)
    bound = _gamma_bound(spaces, modes, n_modes, samples, fs.sum_roundings(K) + 4 * NP)
    _hold_narrow(out.cpu(), ref.cpu(), bound, out_dtype == torch.bfloat16)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_sensor_fused_p2_permuted(cuda, out_dtype):
    # NP = 16 P2 dims (17 dofs: staged, ks = 32), 16 columns (two n8 tiles),
    # K = 1100 past SPLIT_K_MIN on a batch of few rows (k-ranges, f32
    # partials, the partial sum), modes scaled to decay as PGD amplitudes
    # do and permuted so the 8 largest come last (the head holds small
    # ones): within 2γ_c·|F||M0| of the plain version storing the same
    # dtype, |F| from |φ|, c = the sum's roundings + 8·NP
    NP, K, n0, B = 16, 1100, 16, 700
    spaces, modes = _case(2, 8, K, n0, NP, seed=1616)
    order = np.r_[8:K, 0:8]
    modes[0] = (modes[0] * (0.99 ** np.arange(K))[:, None])[order].astype(np.float32)
    modes[1:] = [m[order] for m in modes[1:]]
    samples = np.random.default_rng(16).uniform(0.0, 2.0, size=(B, NP)).astype(np.float32)
    samples[0], samples[1] = 0.0, 2.0
    sweep, s, ref = _plain_on_card(spaces, modes, K, samples, cuda, out_dtype)
    assert (sweep.plan.route, sweep.plan.ks) == ("staged", 32)
    fs.reset_launch_counts()
    out = sweep(s)
    torch.cuda.synchronize()
    assert sweep.last_plan["factor"][0]["ranges"] > 1
    assert fs.STAGE_LAUNCHES == {"factors_stage": 0, "sensor_fused": 1, "factors_global": 0,
                                 "gemm": 0, "partial_sum": 1}
    bound = torch.as_tensor(_abs_basis_bound(spaces, modes, K, samples,
                                             fs.sum_roundings(K) + 8 * NP))
    _hold_narrow(out.cpu(), ref.cpu(), bound, out_dtype == torch.bfloat16)


def test_global_route(cuda):
    # tables too wide for two shared-memory stages at ks = 4 take the
    # global-gather route, chosen by shape and counted under its own name,
    # in every mode: F (bit for bit), fields through the GEMM, sensors
    spaces, modes = _case(1, 600, 40, 8, 12, seed=21)
    samples = np.random.default_rng(21).uniform(0.0, 2.0, size=(700, 12)).astype(np.float32)
    sweep, s, ref = _plain_on_card(spaces, modes, 37, samples, cuda, factors=True)
    assert sweep.plan.route == "global"
    fs.reset_launch_counts()
    f = sweep(s)
    torch.cuda.synchronize()
    assert fs.STAGE_LAUNCHES["factors_global"] == 1 and torch.equal(f, ref)
    for n0 in (8, 300):
        spaces_n, modes_n = _case(1, 600, 40, n0, 12, seed=21)
        fs.reset_launch_counts()
        out, _ = _run(cuda, spaces_n, modes_n, 37, samples)
        assert fs.STAGE_LAUNCHES["factors_global"] == 1
        assert fs.STAGE_LAUNCHES["gemm"] == (0 if n0 <= fs.SENSORS_MAX else 1)
        assert fs.STAGE_LAUNCHES["factors_stage"] == fs.STAGE_LAUNCHES["sensor_fused"] == 0
        _, _, ref_n = _plain_on_card(spaces_n, modes_n, 37, samples, cuda)
        bound = _gamma_bound(spaces_n, modes_n, 37, samples, 40 + 48)
        _hold_narrow(out, ref_n.cpu(), bound, False)


def test_smem_formula(cuda):
    # the plan's shared-memory count is the kernel's own
    lib = fs._library()
    for NP, ndofp, ks, rows, n0, staged in [(5, 129, 32, 2048, 0, 1), (5, 129, 16, 1536, 8, 1),
                                            (16, 2049, 32, 512, 32, 0), (3, 9, 4, 1024, 1, 1)]:
        assert lib.pgd_factor_smem(NP, ndofp, ks, rows, n0, staged) == fs.factor_smem(
            NP, ndofp, ks, rows, n0, bool(staged))


# ------------------------------------------------------------- the solver

def _elliptic(num_params, **kw):
    from pgdrome_tpu_torch.models.problems import parametric_elliptic
    from pgdrome_tpu_torch.separated import precondition_dim0

    sep, Vs = parametric_elliptic(n_x=32, n_p=8, num_params=num_params, **kw)
    pc, tf = precondition_dim0(sep, np.float64)
    return sep, Vs, pc, tf


def _fields64(Vs, res, tf, samples):
    from pgdrome_tpu_torch.serving import Vademecum

    vd = Vademecum(Vs, res, dim0_transform=tf, method="torch", dtype=torch.float64,
                   device="cpu")
    return vd.fields(samples).numpy()


def test_f32_solve_matches_f64(cuda):
    # ROADMAP A5 gate (ii): an f32 solve on the card reconstructs within
    # 2.5e-7 of the port's f64 CPU solve (the CPU's own f32 solve measures
    # 4.3e-8), and TF32 stays off while it runs
    from pgdrome_tpu_torch.separated import SeparatedPGD

    _, Vs, pc, tf = _elliptic(1)
    kw = dict(n_max=12, tol=0.0, tol_fp=1e-7, max_fp_it=40, solver="cg", cg_iters=25,
              residual_check=False)
    r32 = SeparatedPGD(pc, dtype=np.float32, device=cuda, **kw).solve_fused()
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    assert r32.modes[0].is_cuda and r32.modes[0].dtype == torch.float32
    r64 = SeparatedPGD(pc, dtype=np.float64, device="cpu", **kw).solve_fused()
    assert r32.n_modes == r64.n_modes == 12
    samples = np.random.default_rng(0).uniform(0.0, 1.0, size=(64, 1))
    f64, f32 = (_fields64(Vs, r, tf, samples) for r in (r64, r32))
    err = np.linalg.norm(f32 - f64, axis=1) / np.linalg.norm(f64, axis=1)
    assert err.max() <= 2.5e-7


def test_zero_residual_keep_mask(cuda):
    # every enrichment of a zero rhs has residual 0 < 1e-10: the device
    # keep-mask drops each mode, no buffer changes, the result is empty
    from pgdrome_tpu_torch.separated import SeparatedPGD, SeparatedProblem

    _, _, pc, _ = _elliptic(2)
    zero = SeparatedProblem(ops=pc.ops, rhs=[0.0 * r for r in pc.rhs], mass=pc.mass,
                            bc_dofs=pc.bc_dofs)
    res = SeparatedPGD(zero, n_max=3, tol_fp=1e-7, dtype=np.float32,
                       device=cuda).solve_fused()
    assert res.n_modes == 0 and res.normU0 == 1.0 and len(res.amplitudes) == 0
    assert all(m.is_cuda and not bool(m.any()) for m in res.modes)


def test_two_stage_elliptic_served_by_kernel(cuda):
    # the recipe trained on the card (bucketed restarts), its vademecum
    # served through the fused field wiring and held within 2γ_c of the
    # plain version, c = K + 4·NP, and close to the f64 reconstruction
    from pgdrome_tpu_torch.recipes import two_stage_elliptic
    from pgdrome_tpu_torch.serving import Vademecum

    sep, Vs, _, _ = _elliptic(2, boundary_boost=(16.0, 6))
    res, tf = two_stage_elliptic(sep, n_stage1=10, n_stage2=6, n_deploy=8,
                                 extra_stages=(6,), rhs_bucket=16, device=cuda)
    assert res.n_modes == 8 and res.modes[1].is_cuda
    vd = Vademecum(Vs, res, dim0_transform=tf, method="fused", device=cuda)
    samples = np.random.default_rng(5).uniform(0.0, 1.0, size=(300, 2)).astype(np.float32)
    samples[0], samples[1] = 0.0, 1.0
    fs.reset_launch_counts()
    out = vd.fields(torch.as_tensor(samples, device=cuda))
    torch.cuda.synchronize()
    assert fs.LAUNCHES["fields_f32"] == 1 and fs.STAGE_LAUNCHES["gemm"] >= 1
    modes = [m.cpu().numpy() for m in vd._modes]
    plain = fs.make_fused_sweep(Vs, modes, vd.n_modes, device="cpu")(torch.as_tensor(samples))
    bound = _gamma_bound(Vs, modes, vd.n_modes, samples, 8 + 4 * 2)
    assert bool(((out.cpu().double() - plain.double()).abs() <= 2 * bound).all())
    f64 = _fields64(Vs, res, tf, samples.astype(np.float64))
    err = np.linalg.norm(out.cpu().double().numpy() - f64, axis=1) / np.linalg.norm(f64, axis=1)
    assert err.max() < 1e-6


# ----------------------------------------------- the compensated rhs path

def test_dd_functions_equal_cpu(cuda):
    # plain elementwise torch, one rounding a step: the card rounds every
    # step as the CPU does, so every dd function and the dd (R, n, 2)
    # contraction equal the CPU results bit for bit
    from pgdrome_tpu_torch.ops import ddf32 as TD
    from pgdrome_tpu_torch.separated import _DDWeights, _contract_rhs

    rng = np.random.default_rng(40)

    def f32(*shape):
        return (rng.standard_normal(shape) * 10.0 ** rng.uniform(-6, 6, shape)).astype(np.float32)

    def dd(*shape):
        d = TD.dd_from_f64(rng.standard_normal(shape) * 10.0 ** rng.uniform(-6, 6, shape))
        return d[..., 0], d[..., 1]

    n = 65_536
    stack = TD.dd_from_f64(rng.standard_normal((4096, 129)) * 10.0 ** rng.integers(-5, 5, (4096, 1)))
    cases = {
        "two_sum": (f32(n), f32(n)), "fast_two_sum": None, "_split": (f32(n),),
        "two_prod": (f32(n), f32(n)), "dd_add": dd(n) + dd(n), "dd_mul": dd(n) + dd(n),
        "dd_mul_f": dd(n) + (f32(n),), "dd_sum": dd(2049, 129), "dd_dot": (stack, f32(129)),
        "dd_contract": dd(4096) + (stack,),
    }
    a, b = f32(n), f32(n)
    cases["fast_two_sum"] = (np.where(np.abs(a) >= np.abs(b), a, b),
                             np.where(np.abs(a) >= np.abs(b), b, a))
    for name, args in cases.items():
        fn = getattr(TD, name)
        cpu = fn(*(torch.from_numpy(np.ascontiguousarray(x)) for x in args))
        gpu = fn(*(torch.from_numpy(np.ascontiguousarray(x)).to(cuda) for x in args))
        cpu, gpu = (o if isinstance(o, tuple) else (o,) for o in (cpu, gpu))
        for x, y in zip(cpu, gpu):
            assert torch.equal(x.view(torch.int32), y.cpu().view(torch.int32)), name
    rhs = [TD.dd_from_f64(rng.standard_normal((4096, m))) for m in (2047, 129, 129)]
    Fs = [f32(m) for m in (2047, 129, 129)]
    for k in range(3):
        cpu = _contract_rhs([torch.from_numpy(r) for r in rhs],
                            [torch.from_numpy(f) for f in Fs], k, 3)
        g_rhs = [torch.from_numpy(r).to(cuda) for r in rhs]
        gpu = _contract_rhs(g_rhs, [torch.from_numpy(f).to(cuda) for f in Fs], k, 3,
                            _DDWeights(g_rhs))
        assert gpu.is_cuda and torch.equal(cpu.view(torch.int32), gpu.cpu().view(torch.int32))


@pytest.mark.parametrize("flag", ["rhs_comp", "rhs_f64"])
def test_cancelling_rhs_solve_on_card(cuda, flag):
    # the cancelling problem of tests/unit/test_ddf32.py:130 solved in f32
    # on the card with its stack in dd or f64 there: within 2e-6 of the
    # f64 CPU solve, where the plain f32 contraction is > 100× further off
    from pgdrome_tpu_torch.separated import SeparatedPGD, SeparatedProblem

    _, _, pc, _ = _elliptic(1)
    C = 3.0e5
    g0, g1 = (np.asarray(r, dtype=np.float64) for r in pc.rhs)
    sep_c = SeparatedProblem(ops=list(pc.ops), rhs=[np.concatenate([(1.0 + C) * g0, -C * g0]),
                                                    np.concatenate([g1, g1])],
                             mass=list(pc.mass), bc_dofs=list(pc.bc_dofs))
    kw = dict(n_max=4, tol=0.0, tol_fp=1e-7, max_fp_it=40, residual_check=False)
    ref = SeparatedPGD(pc, dtype=np.float64, device="cpu", **kw).solve_fused()
    solver = SeparatedPGD(sep_c, dtype=np.float32, device=cuda, **{flag: True}, **kw)
    assert solver.problem.rhs[0].is_cuda
    assert solver.problem.rhs[0].dtype == (torch.float32 if flag == "rhs_comp" else torch.float64)
    mixed = solver.solve_fused()
    plain = SeparatedPGD(sep_c, dtype=np.float32, device=cuda, **kw).solve_fused()

    def tensor(res):
        K = res.n_modes
        return np.einsum("ki,kj->ij", res.modes[0][:K].double().cpu().numpy(),
                         res.modes[1][:K].double().cpu().numpy())

    t_ref = tensor(ref)
    scale = np.abs(t_ref).max()
    err_mixed = np.abs(tensor(mixed) - t_ref).max() / scale
    err_plain = np.abs(tensor(plain) - t_ref).max() / scale
    assert mixed.modes[0].is_cuda
    assert err_mixed < 2e-6, err_mixed
    assert err_plain > 100 * err_mixed, (err_plain, err_mixed)


# ------------------------------------ certification and the ANOVA start

def _certify_case():
    """A 12-mode f32 solve of the 3-parameter elliptic (host), and 24 of its
    parameter grid points (the f32 mode evaluation is exact there)."""
    from pgdrome_tpu_torch.separated import SeparatedPGD

    sep, Vs, pc, tf = _elliptic(3)
    res = SeparatedPGD(pc, n_max=12, tol=0.0, tol_fp=1e-8, residual_check=False,
                       dtype=np.float32, device="cpu").solve_fused()
    grid = Vs[1].tabulate_dof_coordinates()[:, 0]
    pts = grid[np.random.default_rng(9).integers(1, len(grid) - 1, size=(24, 3))]
    return sep, Vs, pc, tf, res, pts


def test_dd_indicator_and_screener_on_card(cuda):
    # the dd residual and rhs pairs on the card equal the CPU's bit for bit
    # (plain elementwise torch, one rounding a step); the final f32 norms
    # are sums in another order, within 1e-6; the f32 screener within 1e-4
    # relative or one f32 unit of the normalised ‖b(p)‖
    from pgdrome_tpu_torch.parallel.certify import make_residual_indicator, make_screener

    _, Vs, pc, _, res, pts = _certify_case()
    ind_cpu = make_residual_indicator(pc, Vs, res, device="cpu")
    ind_gpu = make_residual_indicator(pc, Vs, res, device=cuda)
    p32 = torch.as_tensor(pts, dtype=torch.float32)
    for a, b in zip(ind_cpu.dd_residual(p32), ind_gpu.dd_residual(p32.to(cuda))):
        assert b.is_cuda and torch.equal(a.view(torch.int32), b.cpu().view(torch.int32))
    v_cpu, v_gpu = ind_cpu(pts), ind_gpu(pts)
    assert np.all(np.abs(v_gpu - v_cpu) <= 1e-6 * v_cpu)
    s_cpu = make_screener(pc, Vs, n_modes_cap=16, device="cpu")(res, pts)
    s_gpu = make_screener(pc, Vs, n_modes_cap=16, device=cuda)(res, pts)
    assert np.all(np.abs(s_gpu - s_cpu) <= np.maximum(1e-4 * s_cpu, 2.0 ** -24))


def test_certifier_on_served_vademecum(cuda):
    # a certifier on the card attached to a vademecum served through the
    # field kernels: its residuals are the CPU certifier's (1e-6), its
    # bounds η·residual, and the guaranteed bound covers the f64 error
    from pgdrome_tpu_torch.models.problems import elliptic_dense_verifier
    from pgdrome_tpu_torch.parallel.certify import guaranteed_field_bound, make_certifier
    from pgdrome_tpu_torch.serving import Vademecum

    sep, Vs, pc, tf, res, pts = _certify_case()
    cert = make_certifier(pc, Vs, res, eta=1.5, device=cuda)
    cert.attach_guaranteed(guaranteed_field_bound(pc, Vs, res, nodal_tf=tf, device=cuda))
    vd = Vademecum(Vs, res, dim0_transform=tf, method="fused", device=cuda)
    assert vd.attach_certifier(cert) is vd
    ref = make_certifier(pc, Vs, res, device="cpu").residuals(pts)
    r = vd.residuals(pts)
    assert np.all(np.abs(r - ref) <= 1e-6 * ref)
    np.testing.assert_array_equal(vd.error_bound(pts), 1.5 * r)
    true = elliptic_dense_verifier(Vs, tf, n_random=1, seeds=(7,)).sample_errors(res, pts)
    assert np.all(cert.guaranteed_bound(pts) >= true)
    fs.reset_launch_counts()
    out = vd.fields(torch.as_tensor(pts, dtype=torch.float32, device=cuda))
    torch.cuda.synchronize()
    assert fs.LAUNCHES["fields_f32"] == 1 and fs.STAGE_LAUNCHES["gemm"] >= 1
    f64 = _fields64(Vs, res, tf, pts)
    err = np.linalg.norm(out.cpu().double().numpy() - f64, axis=1) / np.linalg.norm(f64, axis=1)
    assert err.max() < 1e-6


def test_anova_init_served_by_kernel(cuda):
    # the host f64 ANOVA start (modes as host arrays) served through the
    # field kernels: within 2γ_c of the plain version, c = K + 4·NP, and
    # close to its f64 reconstruction
    from pgdrome_tpu_torch.anova import anova_init
    from pgdrome_tpu_torch.serving import Vademecum

    sep, Vs, _, tf = _elliptic(3)
    res, rep = anova_init(sep, order=2, tf=tf)
    assert rep["rank"] == res.n_modes and isinstance(res.modes[0], np.ndarray)
    vd = Vademecum(Vs, res, dim0_transform=tf, method="fused", device=cuda)
    samples = np.random.default_rng(6).uniform(0.0, 1.0, size=(500, 3)).astype(np.float32)
    fs.reset_launch_counts()
    out = vd.fields(torch.as_tensor(samples, device=cuda))
    torch.cuda.synchronize()
    assert fs.LAUNCHES["fields_f32"] == 1 and fs.STAGE_LAUNCHES["gemm"] >= 1
    modes = [m.cpu().numpy() for m in vd._modes]
    plain = fs.make_fused_sweep(Vs, modes, vd.n_modes, device="cpu")(torch.as_tensor(samples))
    bound = _gamma_bound(Vs, modes, vd.n_modes, samples, vd.n_modes + 4 * 3)
    assert bool(((out.cpu().double() - plain.double()).abs() <= 2 * bound).all())
    f64 = _fields64(Vs, res, tf, samples.astype(np.float64))
    err = np.linalg.norm(out.cpu().double().numpy() - f64, axis=1) / np.linalg.norm(f64, axis=1)
    assert err.max() < 1e-6


def _d5_on_card(cuda):
    from pgdrome_tpu_torch.convert import frontier_vademecum

    state = Path(__file__).resolve().parent.parent / "states" / "frontier_d5_state.npz"
    return frontier_vademecum(state, 5, device=cuda)


@pytest.mark.parametrize("kind", ["fixed_np3", "derivative_dg1"])
def test_slice_and_derivative_served_by_kernel(cuda, kind):
    # the committed d=5 vademecum's fixed-parameter slice (NP = 3) and its
    # derivative vademecum (DG1 dim-0 table, n0 = 2048) through the field
    # kernels: within 2γ_c of the plain version on the same tables,
    # c = K + 4·NP
    vd = _d5_on_card(cuda)
    new = vd.fix_parameters({1: 40 / 128, 3: 88 / 128}) if kind == "fixed_np3" else vd.derivative()
    NP = len(new.spaces) - 1
    assert isinstance(new._sweep(), fs.FusedSweep)
    assert (NP, new._modes[0].shape[1]) == ((3, 2049) if kind == "fixed_np3" else (5, 2048))
    samples = np.random.default_rng(8).uniform(0.0, 1.0, size=(3000, NP)).astype(np.float32)
    samples[0], samples[1] = 0.0, 1.0
    fs.reset_launch_counts()
    out = new.fields(torch.as_tensor(samples, device=cuda))
    torch.cuda.synchronize()
    assert fs.LAUNCHES["fields_f32"] == 1 and fs.STAGE_LAUNCHES["gemm"] >= 1
    modes = [m.cpu().numpy() for m in new._modes]
    plain = fs.make_fused_sweep(new.spaces, modes, new.n_modes, device="cpu")(
        torch.as_tensor(samples))
    bound = _gamma_bound(new.spaces, modes, new.n_modes, samples, new.n_modes + 4 * NP)
    assert bool(((out.cpu().double() - plain.double()).abs() <= 2 * bound).all())


def test_save_load_on_card(cuda, tmp_path):
    from pgdrome_tpu_torch.serving import Vademecum

    vd = _d5_on_card(cuda)
    vd.save(tmp_path / "d5.npz")
    again = Vademecum.load(tmp_path / "d5.npz", vd.spaces, device=cuda)
    assert isinstance(again._sweep(), fs.FusedSweep) and again._modes[0].is_cuda
    s = torch.rand((4096, 5), generator=torch.Generator(device=cuda).manual_seed(3), device=cuda)
    assert torch.equal(again.fields(s), vd.fields(s))


def _linear_vademecum(dtype, device, method):
    """u(x; p, q) = x·p + x²·q, linear in the parameters."""
    from pgdrome_tpu_torch.convert import result_from_numpy
    from pgdrome_tpu_torch.serving import Vademecum

    Vx, Vp, Vq = (FunctionSpace(IntervalMesh(n, 0.0, 1.0), "P", k)
                  for n, k in ((8, 2), (16, 1), (16, 1)))
    x, p, q = (V.dof_coords[:, 0] for V in (Vx, Vp, Vq))
    modes = [np.stack([x, x ** 2]), np.stack([p, np.ones_like(p)]),
             np.stack([np.ones_like(q), q])]
    return Vademecum([Vx, Vp, Vq], result_from_numpy(modes, 2, *[np.ones(2)] * 3),
                     method=method, dtype=dtype, device=device)


def test_fit_and_mcmc_on_card_vs_f64(cuda):
    # the f32 fit and sampler on the card against the same calls in f64
    # with method='torch' on the CPU: p̂ within 1e-4 (f32 normal equations),
    # the chains fed the same draws take the same accept decisions and stay
    # within 1e-5
    from pgdrome_tpu_torch.parallel.bayes import make_mcmc_fn

    pts = np.array([0.2, 0.45, 0.7, 0.95])
    vd32 = _linear_vademecum(torch.float32, cuda, "auto")
    vd64 = _linear_vademecum(torch.float64, "cpu", "torch")
    p_true = np.array([[0.3, 0.7], [0.62, 0.18], [0.5, 0.5]])
    obs = vd64.sensors(pts)(p_true).numpy()
    p32, r32 = vd32.fit_parameters(pts, obs, n_iter=30)
    p64, r64 = vd64.fit_parameters(pts, obs, n_iter=30)
    np.testing.assert_allclose(p64, p_true, atol=1e-9)
    np.testing.assert_allclose(p32, p64, atol=1e-4)
    rng = np.random.default_rng(4)
    n_steps, C = 30, 8
    eps, e = rng.standard_normal((n_steps, C, 2)), rng.exponential(size=(n_steps, C))
    p0 = np.clip(p_true[0] + 0.02 * rng.standard_normal((C, 2)), 0.0, 1.0)
    args = (obs[0], np.full(4, 0.01), p0, np.diag([0.02, 0.02]), 1.0)
    c32, a32 = make_mcmc_fn(vd32.spaces, vd32._modes, 2, pts, n_steps=n_steps)(
        *args, eps=eps, e=e)
    c64, a64 = make_mcmc_fn(vd64.spaces, vd64._modes, 2, pts, n_steps=n_steps)(
        *args, eps=eps, e=e)
    assert c32.is_cuda and torch.equal(a32.cpu(), a64)
    assert 0 < int(a64.sum()) < n_steps * C
    np.testing.assert_allclose(c32.cpu().double().numpy(), c64.numpy(), atol=1e-5)


# ------------------------------------------- the nonlinear family, outputs

def _cubic_hooks(Vs, dtype, device, eps=5.0):
    """The separable cubic term ε·M_L u³ ⊗ M_L p³ of −u'' + ε·u³ = f, lumped
    masses, as ``SeparatedPGD(nonlinear=...)`` hooks on ``device``."""
    from pgdrome_tpu_torch.fem.assembly import mass_matrix

    Mx, Mp = (torch.as_tensor(np.diag(mass_matrix(V).sum(axis=1)), dtype=dtype, device=device)
              for V in Vs)
    return ((lambda u: eps * (Mx @ u ** 3), lambda F: F @ (eps * (Mx @ F ** 3))),
            (lambda u: Mp @ u ** 3, lambda F: F @ (Mp @ F ** 3)))


def test_newton_f32_on_card_vs_f64(cuda):
    # the Newton per-dim solves with a cubic hook, 30 sweeps a mode, f32 on
    # the card against f64 on the CPU: the reconstructions within 1e-4 (a
    # CPU's f32 run of the same solve gives 3.3e-5: the un-preconditioned
    # f32 per-dim systems)
    from pgdrome_tpu_torch.models.problems import parametric_elliptic
    from pgdrome_tpu_torch.separated import SeparatedPGD, host_f64

    sep, Vs = parametric_elliptic(n_x=32, n_p=8, num_params=1)
    kw = dict(n_max=3, tol=0.0, tol_fp=0.0, max_fp_it=30, solver="newton",
              residual_check=False)
    r32 = SeparatedPGD(sep, nonlinear=_cubic_hooks(Vs, torch.float32, cuda), dtype=np.float32,
                       device=cuda, **kw).solve()
    r64 = SeparatedPGD(sep, nonlinear=_cubic_hooks(Vs, torch.float64, "cpu"),
                       dtype=np.float64, device="cpu", **kw).solve()
    assert r32.modes[0].is_cuda and r32.n_modes == r64.n_modes == 3

    def full(r):
        return host_f64(r.modes[0])[: r.n_modes].T @ host_f64(r.modes[1])[: r.n_modes]

    assert np.abs(full(r32) - full(r64)).max() <= 1e-4 * np.abs(full(r64)).max()


def test_nonlinear_vademecum_served_by_kernel(cuda):
    # a toy nonlinear vademecum trained on the card (dd stacks from outer
    # 3), served through the field wiring within 2γ_c of the plain version
    # (c = K + 4·NP) and under 1e-6 of the Newton truth
    from pgdrome_tpu_torch.models.problems import nonlinear_dense_verifier, nonlinear_elliptic
    from pgdrome_tpu_torch.recipes import nonlinear_vademecum
    from pgdrome_tpu_torch.serving import Vademecum

    sep, Vs, ml = nonlinear_elliptic(n_x=32, n_p=8, num_params=2)
    res, tf, rep = nonlinear_vademecum(sep, Vs, ml, 2.0, budgets=(16, 8, 8), rhs_bucket=64,
                                       n_outer=4, device=cuda)
    assert res.modes[0].is_cuda and [h["rhs_comp"] for h in rep["history"]][2:] == [True] * (
        rep["outer_iterations"] - 2)
    vd = Vademecum(Vs, res, dim0_transform=tf, method="fused", device=cuda)
    ver = nonlinear_dense_verifier(Vs, 2.0, ml, tf, n_random=4, seeds=(7,), n_edge=2)
    samples = np.concatenate(list(ver.samples.values())).astype(np.float32)
    fs.reset_launch_counts()
    out = vd.fields(torch.as_tensor(samples, device=cuda))
    torch.cuda.synchronize()
    assert fs.LAUNCHES["fields_f32"] == 1 and fs.STAGE_LAUNCHES["gemm"] >= 1
    modes = [m.cpu().numpy() for m in vd._modes]
    plain = fs.make_fused_sweep(Vs, modes, vd.n_modes, device="cpu")(torch.as_tensor(samples))
    bound = _gamma_bound(Vs, modes, vd.n_modes, samples, vd.n_modes + 4 * 2)
    assert bool(((out.cpu().double() - plain.double()).abs() <= 2 * bound).all())
    u = np.stack([ver.truth(p) for p in samples.astype(np.float64)])
    err = np.linalg.norm(out.cpu().double().numpy() - u, axis=1) / np.linalg.norm(u, axis=1)
    assert ver(res)["max"] < 1e-6 and err.max() < 1e-6


def test_space_time_corrected_sweep_on_card(cuda):
    # the transient outputs: a space-time corrector (n_fixed = 2) of f64
    # primal and adjoint minres vademecums, its sweep on the card (both
    # factor products through the factor kernel) within its γ_c bound of
    # the host f64 corrector
    from pgdrome_tpu_torch.dual import (DualCorrector, adjoint_problem_nd,
                                        corrected_sweep_bound, make_corrected_sensor_fn)
    from pgdrome_tpu_torch.models.problems import transient_parametric_conductivity
    from pgdrome_tpu_torch.recipes import transient_verification_set, two_stage_minres

    sep, Vs = transient_parametric_conductivity(n_x=16, n_t=12, n_p=8, num_params=2)
    l_x = np.zeros(Vs[0].dim())
    l_x[Vs[0].dim() // 2] = 1.0
    l_t = np.zeros(Vs[1].dim())
    l_t[-1] = 1.0
    kw = dict(dtype=np.float64, device="cpu", tol_fp=1e-9)
    res_u = two_stage_minres(sep, 16, 8, **kw)
    res_z = two_stage_minres(adjoint_problem_nd(sep, [l_x, l_t], n_fixed=2), 12, 6, **kw)
    dc = DualCorrector(sep, Vs, None, res_u, None, res_z, None, n_fixed=2,
                       l_factors=[l_x, l_t])
    pts = transient_verification_set(Vs[2].tabulate_dof_coordinates()[:, 0], 2, n_random=30)
    fn = make_corrected_sensor_fn(dc, method="fused", device=cuda)
    assert all(isinstance(f, fs.FusedSweep) for f in fn.factor_sweeps)
    fs.reset_launch_counts()
    s32, _ = fn(pts)
    torch.cuda.synchronize()
    assert fs.LAUNCHES["factors"] == 2 and sum(fs.LAUNCHES.values()) == 2
    bound, _ = corrected_sweep_bound(dc, pts)
    assert bool((np.abs(s32.double().cpu().numpy() - dc.corrected(pts)) <= bound).all())


def _flagship_on_card(cuda):
    """A toy elasticity-ν flagship (vector P2, collocation) trained in f32
    on the card; power-of-two parameter spacings, so the f32 cell locate
    is exact and an f64 reference can be taken at the same samples."""
    from pgdrome_tpu_torch.models.problems import elasticity_vademecum
    from pgdrome_tpu_torch.separated import SeparatedPGD, precondition_dim
    from pgdrome_tpu_torch.serving import Vademecum

    sep, Vs, _ = elasticity_vademecum(nx=8, ny=3, n_p=8, n_E=8, n_nu=8,
                                      nu_range=(0.125, 0.375), degree=2,
                                      param_discretization="collocation")
    base = np.asarray(sep.ops[0][0]) + np.asarray(sep.ops[0][1])
    sep_pc, tf = precondition_dim(sep, dim=0, dtype=np.float64, base=base)
    res = SeparatedPGD(sep_pc, n_max=8, tol=0.0, tol_fp=1e-6, max_fp_it=30, solver="cg",
                       cg_iters=30, residual_check=False, dtype=np.float32,
                       device=cuda).solve_fused()
    vd = Vademecum(Vs, res, dim0_transform=tf, method="fused", device=cuda)
    rng = np.random.default_rng(21)
    lo = np.array([V.tabulate_dof_coordinates()[0, 0] for V in Vs[1:]])
    hi = np.array([V.tabulate_dof_coordinates()[-1, 0] for V in Vs[1:]])
    samples = (lo + (hi - lo) * rng.uniform(size=(600, 3))).astype(np.float32)
    samples[0], samples[1] = lo, hi
    return vd, res, tf, samples


def test_flagship_fields_and_vector_sensors_on_card(cuda):
    # the flagship's field wiring (n0 = 430) and its vector sensors (6
    # points x 2 components, the narrow product) within 2γ_c of the plain
    # version, c = K + 4·NP
    vd, _, _, samples = _flagship_on_card(cuda)
    pts = np.array([[100.0, 20.0], [300.0, 50.0], [500.0, 80.0], [700.0, 10.0],
                    [900.0, 60.0], [999.0, 99.0]])
    sens = vd.sensors(pts)
    fs.reset_launch_counts()
    out = vd.fields(torch.as_tensor(samples, device=cuda))
    resp = sens(torch.as_tensor(samples, device=cuda))
    torch.cuda.synchronize()
    assert fs.LAUNCHES["fields_f32"] == 1 and fs.LAUNCHES["sensors"] == 1
    assert fs.STAGE_LAUNCHES["sensor_fused"] == 1 and resp.shape == (600, 12)
    K = vd.n_modes
    for got, table in ((out, vd._modes[0]), (resp, sens.m0)):
        modes = [table.cpu().numpy()] + [m.cpu().numpy() for m in vd._modes[1:]]
        plain = fs.make_fused_sweep(vd.spaces, modes, K, device="cpu")(
            torch.as_tensor(samples))
        bound = _gamma_bound(vd.spaces, modes, K, samples, K + 4 * 3)
        assert bool(((got.cpu().double() - plain.double()).abs() <= 2 * bound).all())


def test_flagship_strain_on_card_vs_cpu_f64(cuda):
    # the strain vademecum (DG1, 3 Voigt components) served through the
    # field kernels against the strain vademecum of the same served modes
    # in f64 on the CPU: within 2γ_c of |F|·|T| (the f32 table adds one
    # rounding).  Not against the transform's f64 modes: differentiating
    # their f32 rounding is no rounding of the strain
    from pgdrome_tpu_torch.serving import Vademecum

    vd, _, _, samples = _flagship_on_card(cuda)
    strain = vd.strain()
    assert isinstance(strain._sweep(), fs.FusedSweep) and strain._modes[0].shape[1] == 96 * 9
    fs.reset_launch_counts()
    out = strain.fields(torch.as_tensor(samples, device=cuda))
    torch.cuda.synchronize()
    assert fs.LAUNCHES["fields_f32"] == 1
    vd64 = Vademecum(vd.spaces, vd.result, method="torch", dtype=torch.float64,
                     device="cpu").strain()
    ref = vd64.fields(samples.astype(np.float64))
    modes = [m.numpy() for m in vd64._modes]
    bound = _gamma_bound(vd64.spaces, modes, vd64.n_modes, samples, vd64.n_modes + 4 * 3)
    assert bool(((out.cpu().double() - ref).abs() <= 2 * bound).all())


def test_heat3d_sensors_on_card(cuda):
    # a 3D P2 space dim trained in f64 on the CPU, served in f32 on the
    # card: 3D-point sensors through the narrow product and fields through
    # the GEMM, each within 2γ_c of the plain version
    from pgdrome_tpu_torch.models.problems import parametric_elliptic_3d
    from pgdrome_tpu_torch.separated import SeparatedPGD
    from pgdrome_tpu_torch.serving import Vademecum

    sep, Vs = parametric_elliptic_3d(n=3, n_p=8, num_params=2, degree_x=2)
    res = SeparatedPGD(sep, n_max=12, tol=1e-12, tol_fp=1e-6, dtype=np.float64,
                       device="cpu").solve()
    vd = Vademecum(Vs, res, method="fused", device=cuda)
    pts = np.array([[0.5, 0.5, 0.5], [0.25, 0.5, 0.75], [0.1, 0.9, 0.3], [0.8, 0.2, 0.6]])
    samples = np.random.default_rng(22).uniform(0.0, 1.0, size=(500, 2)).astype(np.float32)
    samples[0], samples[1] = 0.0, 1.0
    sens = vd.sensors(pts)
    fs.reset_launch_counts()
    resp = sens(torch.as_tensor(samples, device=cuda))
    out = vd.fields(torch.as_tensor(samples, device=cuda))
    torch.cuda.synchronize()
    assert fs.LAUNCHES["sensors"] == 1 and fs.LAUNCHES["fields_f32"] == 1
    assert resp.shape == (500, 4) and out.shape == (500, Vs[0].dim())
    K = vd.n_modes
    for got, table in ((resp, sens.m0), (out, vd._modes[0])):
        modes = [table.cpu().numpy()] + [m.cpu().numpy() for m in vd._modes[1:]]
        plain = fs.make_fused_sweep(Vs, modes, K, device="cpu")(torch.as_tensor(samples))
        bound = _gamma_bound(Vs, modes, K, samples, K + 4 * 2)
        assert bool(((got.cpu().double() - plain.double()).abs() <= 2 * bound).all())


def _abs_basis_bound(spaces, modes, n_modes, samples, c):
    """γ_c · |F|·|M0| in f64 with |F| = Π_j Σ_l |φ_l| |T_jl| (P2 bases
    change sign inside a cell, so the factor of |T| is no bound there)."""
    grid = fs.sweep_grid(spaces).astype(np.float64)
    s = np.asarray(samples, dtype=np.float64)
    fac = np.ones((s.shape[0], modes[1].shape[0]))
    for j, m in enumerate(modes[1:]):
        t = (s[:, j] - grid[0, j]) * grid[1, j]
        cell = np.clip(np.floor(t), 0.0, grid[2, j] - 1.0)
        xi, deg = t - cell, int(grid[3, j])
        basis = ((1 - xi, xi) if deg == 1 else
                 ((1 - xi) * (1 - 2 * xi), 4 * xi * (1 - xi), xi * (2 * xi - 1)))
        base = (deg * cell).astype(np.int64)
        fac *= sum(np.abs(m[:, base + l].T) * np.abs(b)[:, None] for l, b in enumerate(basis))
    fac[:, n_modes:] = 0.0
    u = 2.0 ** -24
    return c * u / (1 - c * u) * (fac @ np.abs(modes[0]).astype(np.float64))


def test_truss_served_and_to_pgd_on_card(cuda):
    # the reference-style truss (P2 in every dim) solved in f64, served in
    # f32 on the card: fields through the GEMM and 8 sensors through the
    # narrow product, each within 2γ_c of the plain version (c = K + 8 a P2
    # dim); to_pgd evaluates the served modes as the f64 plain sweep does
    from pgdrome_tpu_torch.models.problems import elastic_truss
    from pgdrome_tpu_torch.separated import SeparatedPGD
    from pgdrome_tpu_torch.serving import Vademecum

    sep, Vs = elastic_truss()
    res = SeparatedPGD(sep, n_max=10, tol=1e-10, tol_fp=1e-5, dtype=np.float64,
                       device="cpu").solve()
    assert res.n_modes == 1
    vd = Vademecum(Vs, res, method="fused", device=cuda)
    rng = np.random.default_rng(23)
    samples = np.stack([rng.uniform(-1.0, 3.0, 700), rng.uniform(0.2, 2.0, 700)],
                       axis=1).astype(np.float32)
    samples[0], samples[1] = (-1.0, 0.2), (3.0, 2.0)
    pts = [0.05 + 0.9 * i / 7 for i in range(8)]
    sens = vd.sensors(pts)
    fs.reset_launch_counts()
    out = vd.fields(torch.as_tensor(samples, device=cuda))
    resp = sens(torch.as_tensor(samples, device=cuda))
    torch.cuda.synchronize()
    assert fs.LAUNCHES["fields_f32"] == 1 and fs.LAUNCHES["sensors"] == 1
    assert fs.STAGE_LAUNCHES["gemm"] >= 1 and fs.STAGE_LAUNCHES["sensor_fused"] == 1
    K = vd.n_modes
    for got, table in ((out, vd._modes[0]), (resp, sens.m0)):
        modes = [table.cpu().numpy()] + [m.cpu().numpy() for m in vd._modes[1:]]
        plain = fs.make_fused_sweep(Vs, modes, K, device="cpu")(torch.as_tensor(samples))
        bound = _abs_basis_bound(Vs, modes, K, samples, K + 8 * 2)
        assert bool(((got.cpu().double() - plain.double()).numpy() <= 2 * bound).all())
        assert bool(((plain.double() - got.cpu().double()).numpy() <= 2 * bound).all())
    pgd = vd.to_pgd()
    vd64 = Vademecum(Vs, vd.result, method="torch", dtype=torch.float64, device="cpu")
    s64 = samples[:16].astype(np.float64)
    ref = vd64.fields(s64).numpy()
    ref_s = vd64.sensors(pts)(s64).numpy()
    for b, p in enumerate(s64):
        u = pgd.evaluate(0, [1, 2], list(p), 0).array
        r = pgd.evaluate_sensor_response(0, [1, 2], list(p), 0, np.asarray(pts))
        assert np.abs(u - ref[b]).max() <= 1e-12 * np.abs(ref[b]).max()
        assert np.abs(r - ref_s[b]).max() <= 1e-12 * np.abs(ref_s[b]).max()


def test_native_available_on_card_machine(cuda):
    # the native host helpers build from csrc/pgdrome_native.cpp on the
    # card's machine and solve a tridiagonal system as scipy does
    from scipy.linalg import solve_banded

    from pgdrome_tpu_torch.utils import native

    assert native.available()
    rng = np.random.default_rng(24)
    n = 2049
    dl, du, d, b = rng.random(n), rng.random(n), 4.0 + rng.random(n), rng.standard_normal(n)
    ab = np.stack([np.concatenate([[0.0], du[:-1]]), d, np.concatenate([dl[1:], [0.0]])])
    ref = solve_banded((1, 1), ab, b)
    assert np.abs(native.thomas_solve(dl, d, du, b) - ref).max() <= 1e-12 * np.abs(ref).max()
