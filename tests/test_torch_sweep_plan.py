"""The factor kernel's launch grids (``ops/fused_sweep.py::factor_grid``),
on the CPU: pure functions of the launch's rows, the table shapes and the
card's SM count (an H100 SXM's 132 here), checked for every serving shape
the port takes to the card.

Each grid is ``tiles`` row tiles × ``ranges`` k-ranges of ``range_slices``
slices.  Held here: it covers every (sample row, k-slice) of the launch
exactly once; a narrow (sensor) k-range never crosses a K_CHUNK = 512-k
boundary, so the γ_c count of ``sum_roundings`` still over-counts its
roundings; the narrow partials fit ``SCRATCH_BYTES`` and the tile's shared
memory ``SMEM_BYTES``; a launch of at least one tile of ``factor_plan``'s
rows an SM keeps those rows in one k-range (the launch shape before the 2D
grid), but for a narrow product past SPLIT_K_MIN modes, which takes one
range a K_CHUNK; and a smaller one fills the card as far as its rows and
slices allow.  No JAX: the plain version's order does not change with the
grid (F's columns are disjoint, and the narrow ranges' partials are the
kernel's own business, held on the card under γ_c).
"""

import pytest
import torch

from pgdrome_tpu_torch.ops import fused_sweep as fs

# (NP, ndofp) of the served vademecums: d=5 and d=10 (P1, 129 dofs), the
# elasticity flagship (17), the 3D vademecum (25), the nonlinear (65) and
# transient (49) ones, and NP = 16
_TABLES = [(5, 129), (10, 129), (3, 17), (2, 25), (2, 65), (3, 49), (16, 129)]
_BATCHES = [1, 40, 64, 1024, 1360, 65_536, 524_288]
_KS = [30, 128, 384, 640, 2688, 2717]
H100_SMS = 132  # what ``fs.sm_count`` reads on an H100 SXM


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite's workers share a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _partition(n, step, parts):
    """The intervals [i·step, min(n, (i+1)·step)) for i < parts, and whether
    they partition [0, n) with none empty."""
    iv = [(i * step, min(n, (i + 1) * step)) for i in range(parts)]
    ok = iv[0][0] == 0 and iv[-1][1] == n and all(a < b for a, b in iv)
    ok = ok and all(iv[i][1] == iv[i + 1][0] for i in range(parts - 1))
    return iv, ok


@pytest.mark.parametrize("K", _KS)
@pytest.mark.parametrize("B", _BATCHES)
def test_factor_grid(B, K):
    for NP, ndofp in _TABLES:
        for n0 in (0, 8, 32):
            plan = fs.factor_plan(NP, ndofp, n0)
            # the slices each mode walks: F (K), its split (Kp), the narrow
            # product (n_modes = K here)
            walks = [-(-K // plan.ks)]
            if not n0:
                walks.append(-(-fs.padded_k(K) // plan.ks))
            for slices in walks:
                g = fs.factor_grid(plan, B, slices, n0, H100_SMS)
                one_pass = fs.NARROW_THREADS if n0 else fs.FACTOR_THREADS // (plan.ks // 4)
                assert g.rows % one_pass == 0 and one_pass <= g.rows <= plan.rows
                # every (row, slice) once: the row tiles and the k-ranges
                # each partition their axis
                _, rows_ok = _partition(B, g.rows, g.tiles)
                ranges, slices_ok = _partition(slices, g.range_slices, g.ranges)
                assert rows_ok and slices_ok, (NP, ndofp, n0, g)
                smem = fs.factor_smem(NP, ndofp, plan.ks, g.rows, n0, plan.route == "staged")
                assert smem <= plan.smem <= fs.SMEM_BYTES
                if -(-B // plan.rows) >= H100_SMS:
                    # a large batch keeps the plan's launch: one k-range, or
                    # a narrow product past SPLIT_K_MIN one range a K_CHUNK
                    width = (fs.K_CHUNK // plan.ks if n0 and slices * plan.ks > fs.SPLIT_K_MIN
                             else slices)
                    ranges = -(-slices // width)
                    assert g == fs.FactorGrid(plan.rows, slices if ranges == 1 else width,
                                              ranges, -(-B // plan.rows))
                else:
                    # as many blocks as the card has SMs, where the rows and
                    # slices allow that many; at most about two an SM more
                    most = -(-B // one_pass) * slices
                    assert g.blocks >= min(H100_SMS, most)
                    assert g.tiles <= 2 * H100_SMS or g.rows == one_pass
                if n0 and g.ranges > 1:
                    for a, b in _partition(slices, g.range_slices, g.ranges)[0]:
                        # never across a K_CHUNK boundary
                        assert (a * plan.ks) // fs.K_CHUNK == (b * plan.ks - 1) // fs.K_CHUNK
                    # one f32 partial a range: the scratch the wrapper takes
                    assert 4 * g.ranges * B * n0 <= fs.SCRATCH_BYTES
                    # an output's f32 roundings: a slice's FMA chain, the
                    # range's adds, the one rounding of the f64 sum — under
                    # the count the γ_c bounds take
                    assert plan.ks + g.range_slices + 1 <= fs.sum_roundings(K)


def test_factor_grid_served_shapes():
    # the launches of the wirings PERF.md's table times (each its own
    # batch): d=10 fields and sensors at 1,024 corners, the dual factors at
    # 1,360 samples, the dual rate loop, the posterior's 64 chains, the
    # flagship batch; the d=5 factors and sensors, whose launches keep the
    # plan; the d=5 fields' row chunks (and the slice's and the
    # derivative's, the same rows), each on the grid of its own rows
    def grid(plan, B, slices, n0=0):
        return fs.factor_grid(plan, B, slices, n0, H100_SMS)

    d10, d10n = fs.factor_plan(10, 129), fs.factor_plan(10, 129, 8)
    assert grid(d10, 1024, -(-fs.padded_k(2717) // 16)) == fs.FactorGrid(256, 3, 57, 4)
    assert grid(d10n, 1024, -(-2717 // 8), 8) == fs.FactorGrid(512, 2, 170, 2)
    assert grid(d10, 1360, 2688 // 16) == fs.FactorGrid(256, 4, 42, 6)
    assert grid(d10, 1360, 384 // 16) == fs.FactorGrid(256, 1, 24, 6)
    assert grid(d10, 65_536, 2688 // 16) == fs.FactorGrid(256, 84, 2, 256)
    # a full card past SPLIT_K_MIN: one narrow range a K_CHUNK (64 slices of 8)
    assert grid(d10n, 4_194_304, -(-2717 // 8), 8) == fs.FactorGrid(1024, 64, 6, 4096)
    d5, d5n = fs.factor_plan(5, 129), fs.factor_plan(5, 129, 8)
    assert grid(d5n, 64, 640 // 16, 8).ranges == 40
    assert grid(fs.factor_plan(3, 17), 262_144, 1) == fs.FactorGrid(1024, 1, 1, 256)
    for B, slices, plan, n0 in ((4_194_304, 20, d5, 0), (4_194_304, 40, d5n, 8)):
        g = grid(plan, B, slices, n0)
        assert (g.rows, g.ranges) == (plan.rows, 1)
    assert fs.row_chunks(524_288, 640, 2049) == [(0, 209_664), (209_664, 419_328),
                                                 (419_328, 524_288)]
    for plan in (d5, fs.factor_plan(3, 129)):
        assert grid(plan, 209_664, 20) == fs.FactorGrid(896, 10, 2, 234)
        assert grid(plan, 104_960, 20) == fs.FactorGrid(512, 10, 2, 205)
