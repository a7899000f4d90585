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
range a K_CHUNK, and a narrow product whose last wave would leave many SMs
idle, which takes shorter tiles (``wave_rows``); and a smaller one fills
the card as far as its rows and slices allow.  No JAX: the plain version's order does not change with the
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
                one_pass = fs.NARROW_PASS if n0 else fs.FACTOR_THREADS // (plan.ks // 4)
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
                    rows = fs.wave_rows(plan.rows, B, H100_SMS) if n0 else plan.rows
                    assert g == fs.FactorGrid(rows, slices if ranges == 1 else width,
                                              ranges, -(-B // rows))
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
                    # an output's f32 roundings: the head's FMAs, a 16-k
                    # group, one add a group of the range, the one rounding
                    # of the f64 sum — under the count the γ_c bounds take
                    assert (fs.narrow_roundings(plan.ks, g.range_slices, g.ranges)
                            <= fs.sum_roundings(K))


@pytest.mark.parametrize("top,B,rows", [
    (1536, 524_288, 1024),    # a d=5 sensor stream's chunk: 3 waves → 4 shorter
    (1536, 262_144, 1024),    # 171 tiles: 2 waves → 256 tiles in 2
    (1536, 4_194_304, 1536),  # 20.7 waves: the last one costs little
    (1536, 132 * 1536, 1536),  # whole waves
    (768, 4_194_304, 768),    # the d=10 sensors on a full card
    (1024, 262_144, 1024),    # the flagship's vector sensors: 256 tiles
    (2048, 270_369, 768),     # one tile an SM and 33 rows: 2 waves of 2048 → 3 of 768
])
def test_wave_rows(top, B, rows):
    # the narrow product's tile height on a full card: the plan's rows
    # unless a shorter one cuts the rows (and the per-tile cost) an SM
    # walks by more than 5 %, then the tallest of the shortest walks
    def walk(r):
        return -(-(-(-B // r)) // H100_SMS) * (r + fs.NARROW_TILE_COST)

    got = fs.wave_rows(top, B, H100_SMS)
    assert got == rows and got % fs.NARROW_PASS == 0 and 0 < got <= top
    heights = range(fs.NARROW_PASS, top + 1, fs.NARROW_PASS)
    least = min(walk(r) for r in heights)
    if got == top:
        assert least > 0.95 * walk(top)
    else:
        assert walk(got) == least <= 0.95 * walk(top)
        assert all(walk(r) > least for r in heights if r > got)


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
    assert grid(d10n, 1024, -(-2717 // 16), 8) == fs.FactorGrid(256, 2, 85, 4)
    assert grid(d10, 1360, 2688 // 16) == fs.FactorGrid(256, 4, 42, 6)
    assert grid(d10, 1360, 384 // 16) == fs.FactorGrid(256, 1, 24, 6)
    assert grid(d10, 65_536, 2688 // 16) == fs.FactorGrid(256, 84, 2, 256)
    # a full card past SPLIT_K_MIN: one narrow range a K_CHUNK (32 slices of 16)
    assert grid(d10n, 4_194_304, -(-2717 // 16), 8) == fs.FactorGrid(768, 32, 6, 5462)
    d5, d5n = fs.factor_plan(5, 129), fs.factor_plan(5, 129, 8)
    assert grid(d5n, 64, 640 // 32, 8) == fs.FactorGrid(256, 1, 20, 1)
    assert grid(fs.factor_plan(3, 17), 262_144, 1) == fs.FactorGrid(1024, 1, 1, 256)
    for B, slices, plan, n0 in ((4_194_304, 20, d5, 0), (4_194_304, 20, d5n, 8)):
        g = grid(plan, B, slices, n0)
        assert (g.rows, g.ranges) == (plan.rows, 1)
    assert fs.row_chunks(524_288, 640, 2049) == [(0, 209_664), (209_664, 419_328),
                                                 (419_328, 524_288)]
    for plan in (d5, fs.factor_plan(3, 129)):
        assert grid(plan, 209_664, 20) == fs.FactorGrid(896, 10, 2, 234)
        assert grid(plan, 104_960, 20) == fs.FactorGrid(512, 10, 2, 205)
