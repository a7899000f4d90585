"""The fused-sweep CUDA kernel against its plain PyTorch version, on the card.

These tests need an NVIDIA GPU with ``nvcc`` (sm_90a); without one they
skip.  They import no JAX, so they run on a machine that has only the
port's dependencies:

    python -m pytest tests/test_torch_gpu.py -q

Inputs are made with numpy from fixed seeds; tolerances are stated per test.
"""

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
    """γ_c · |F|·|M0| in f64 (P1 bases are ≥ 0, so |F| is the factor of |T|)."""
    grid = torch.as_tensor(fs.sweep_grid(spaces))
    tabs = fs.stack_tables([torch.as_tensor(np.abs(m)) for m in modes[1:]], "cpu").double()
    fabs = fs.fused_sweep_plain(torch.as_tensor(samples), grid, tabs, None, n_modes)
    u = 2.0 ** -24
    g = c * u / (1 - c * u)
    if factors:
        return g * fabs
    return g * (fabs @ torch.as_tensor(np.abs(modes[0])).double())


@pytest.mark.parametrize("K,n0,NP,B,n_modes", [
    (10, 41, 2, 73, 7),       # toy sizes, ragged in every axis
    (33, 130, 3, 129, 33),    # one past a tile in K, n0 and rows
    (640, 2049, 5, 200, 640),  # the d=5 vademecum's widths
    (1000, 400, 3, 70, 1000),  # 4 rows per warp; a last tile wider than 128
    (2717, 300, 2, 20, 2700),  # 1 row per warp (the d=10 state's rank)
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
