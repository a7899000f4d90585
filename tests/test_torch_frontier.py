"""The port's frontier drive against the JAX package's, on the CPU.

``highd_frontier(3, n_x=32, n_p=16)`` with 8-mode stages and
``max_stages=3`` in f64 in both packages (JAX with x64, as
``tests/conftest.py`` sets; the port with ``device="cpu"``).  The base
measure is boosted (1, 6) instead of the default (8, 6) so that the three
stages take all three kinds the d=5 run takes: plain f32-style, compensated,
then boosted, corner-seeded and compensated.  Ranks and the boosted /
seeded / rhs_comp flags are equal per stage; errors and the best result's
amplitudes agree to rtol 1e-8 (measured ~1e-10 and ~1e-15); the report,
the state npz and the artifact have the reference's keys.  The same drive
with the screened verification (``screen_from=3``) and from the
anchored-ANOVA start (``anova_order=2``) in both packages: FEM-measured
errors to 1e-8, the f32 screener's estimates to 1e-3; the screened
candidates drawn as the reference draws them; the committed ANOVA states
read by ``load_state_npz``.  The rest is the port alone:
``adaptive_cascade``'s decisions on scripted errors,
``corner_seeded_init``, a resumed leg, the setup cache.
"""

import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pgdrome_tpu import recipes as JR
from pgdrome_tpu.models.problems import corner_seeded_init as j_seeds
from pgdrome_tpu.utils import setup_cache as j_cache

from pgdrome_tpu_torch import recipes as TR
from pgdrome_tpu_torch import separated as S
from pgdrome_tpu_torch.convert import load_state_npz
from pgdrome_tpu_torch.models.problems import corner_seeded_init as t_seeds
from pgdrome_tpu_torch.models.problems import parametric_elliptic
from pgdrome_tpu_torch.utils import setup_cache as t_cache

RTOL = 1e-8
# f64 floor of a verified error: the reconstruction and the FEM solve each
# carry ~1e-15·|u|, so errors near 1e-7 (the ANOVA-started stages) agree
# to ~1e-15 absolute, not to 1e-8 of themselves
F64_FLOOR = 1e-14
TOY = dict(n_x=32, n_p=16, n_stage1=8, stage_budget=8, max_stages=3,
           dtype=np.float64, base_boost=(1.0, 6))
FLAGS = ("boosted", "seeded", "rhs_comp")


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


@pytest.fixture(scope="module")
def runs(tmp_path_factory, monkeypatch_module):
    monkeypatch_module.delenv("PGDROME_SETUP_CACHE", raising=False)
    d = tmp_path_factory.mktemp("frontier")
    out = {}
    for name, fn, kw in (("jax", JR.highd_frontier, {}),
                         ("torch", TR.highd_frontier, {"device": "cpu"})):
        best, rep = fn(3, state_path=str(d / f"{name}.npz"),
                       artifact_path=str(d / f"{name}.json"), **TOY, **kw)
        out[name] = SimpleNamespace(best=best, rep=rep, npz=d / f"{name}.npz",
                                    art=d / f"{name}.json")
    return SimpleNamespace(j=out["jax"], t=out["torch"], dir=d)


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_stages_ranks_and_flags(runs):
    jh, th = runs.j.rep["history"], runs.t.rep["history"]
    assert [h["rank"] for h in th] == [h["rank"] for h in jh] == [8.0, 16.0, 24.0]
    for a, b in zip(jh, th):
        assert [b[f] for f in FLAGS] == [a[f] for f in FLAGS]
    # the three kinds of stage of the d=5 drive
    assert [tuple(bool(h[f]) for f in FLAGS) for h in th] == [
        (False, False, False), (False, False, True), (True, True, True)]


def test_stage_errors(runs):
    for a, b in zip(runs.j.rep["history"], runs.t.rep["history"]):
        for key in ("corners", "interior", "max"):
            np.testing.assert_allclose(b[key], a[key], rtol=RTOL)
    for key in ("corners_fem_max", "interior_fem_max", "max"):
        np.testing.assert_allclose(runs.t.rep["verified"][key], runs.j.rep["verified"][key],
                                   rtol=RTOL)
    assert runs.t.rep["verified"]["corners_fem_n"] == runs.j.rep["verified"]["corners_fem_n"] == 8


def test_best_result(runs):
    j, t = runs.j.best, runs.t.best
    assert t.n_modes == j.n_modes == 24
    np.testing.assert_allclose(t.amplitudes, np.asarray(j.amplitudes), rtol=RTOL)
    np.testing.assert_array_equal(np.asarray(t.fp_its), np.asarray(j.fp_its))
    assert all(m.dtype == torch.float64 and m.device.type == "cpu" for m in t.modes)


def test_report_artifact_and_state(runs):
    assert runs.t.rep.keys() == runs.j.rep.keys()
    assert runs.t.rep["anova"] is None and runs.t.rep["screened_verification"] is False
    assert runs.t.rep["legs"] == 1
    for a, b in zip(runs.j.rep["history"], runs.t.rep["history"]):
        assert b.keys() == a.keys()
    with open(runs.t.art) as f, open(runs.j.art) as g:
        disk, ref = json.load(f), json.load(g)
    assert disk.keys() == ref.keys() and disk["verified"] == runs.t.rep["verified"]
    with np.load(runs.t.npz) as zt, np.load(runs.j.npz) as zj:
        assert sorted(zt.files) == sorted(zj.files)
        assert int(zt["stage"]) == 3 and int(zt["n_modes"]) == 24
        raw = {k: zt[k] for k in zt.files}
    loaded = load_state_npz(runs.t.npz)
    assert loaded.n_modes == 24 and len(loaded.modes) == 4
    for d, m in enumerate(loaded.modes):
        np.testing.assert_array_equal(m.numpy(), raw[f"m{d}"])


def test_resumed_leg_extends_artifact(runs, tmp_path):
    # a second leg from the checkpoint: stage 1 adopts it (no solve), the
    # artifact's history and wall time grow
    art = tmp_path / "leg.json"
    art.write_text(runs.t.art.read_text())
    init = load_state_npz(runs.t.npz)
    _, rep = TR.highd_frontier(3, **dict(TOY, max_stages=1), init_result=init,
                               artifact_path=str(art), device="cpu")
    assert rep["legs"] == 2 and rep["rank"] == 24
    assert len(rep["history"]) == 4 and rep["history"][-1]["leg"] == 2
    assert rep["wall_s"] >= runs.t.rep["wall_s"]
    assert json.loads(art.read_text())["legs"] == 2


SCREENED = dict(screen_from=3, screen_top_k=4, screener_cap=64, n_screen_edges=48)
# the screener's f32 estimates (η·residual) in both packages: true f32
# products summed in other orders, read through a ~1e-4 cancellation
EST_RTOL = 1e-3


@pytest.fixture(scope="module")
def branch_runs(monkeypatch_module):
    """``highd_frontier(3)`` at the toy size in both packages, once with the
    screened verification (``screen_from=3``) and once from the
    anchored-ANOVA start (``anova_order=2``)."""
    monkeypatch_module.delenv("PGDROME_SETUP_CACHE", raising=False)
    out = {}
    for name, kw in (("screened", SCREENED), ("anova", dict(anova_order=2))):
        out[name] = [fn(3, **TOY, **kw, **extra)
                     for fn, extra in ((JR.highd_frontier, {}),
                                       (TR.highd_frontier, {"device": "cpu"}))]
    return out


def test_screened_branch(branch_runs):
    (jb, jr), (tb, tr) = branch_runs["screened"]
    assert tr["screened_verification"] is jr["screened_verification"] is True
    assert tr.keys() == jr.keys() and tr["anova"] is None
    jh, th = jr["history"], tr["history"]
    assert [h["rank"] for h in th] == [h["rank"] for h in jh] == [8.0, 16.0, 24.0]
    for a, b in zip(jh, th):
        assert b.keys() == a.keys() and b["screened"] == a["screened"] == 1.0
        assert [b[f] for f in FLAGS] == [a[f] for f in FLAGS]
        for key in ("interior", "measured_max"):  # FEM-measured
            np.testing.assert_allclose(b[key], a[key], rtol=RTOL)
        for key in ("corners", "max", "eta", "estimated_max"):  # screener estimates
            np.testing.assert_allclose(b[key], a[key], rtol=EST_RTOL)
    jv, tv = jr["verified"], tr["verified"]
    assert tv.keys() == jv.keys()
    assert tv["corners_fem_n"] == jv["corners_fem_n"] == 8
    assert tv["edges_fem_n"] == jv["edges_fem_n"] == 4
    for key in ("corners_fem_max", "edges_fem_max", "interior_fem_max"):
        np.testing.assert_allclose(tv[key], jv[key], rtol=RTOL)
    for key in ("edges_rest_estimate", "max"):
        np.testing.assert_allclose(tv[key], jv[key], rtol=EST_RTOL)
    assert tb.n_modes == jb.n_modes == 24
    np.testing.assert_allclose(tb.amplitudes, np.asarray(jb.amplitudes), rtol=RTOL)


def test_d8_takes_screened_branch():
    # from 8 parameters on the recipe verifies by the screener by default
    # (it raised before the screener was ported): all 256 corners measured
    # at the end, the edge candidates screened and their worst measured
    _, rep = TR.highd_frontier(8, n_x=16, n_p=4, n_stage1=4, stage_budget=4, max_stages=1,
                               screener_cap=64, n_screen_edges=16, dtype=np.float64,
                               device="cpu")
    assert rep["screened_verification"] is True and rep["history"][0]["screened"] == 1.0
    v = rep["verified"]
    assert v["corners_fem_n"] == 256 and v["edges_fem_n"] == 16
    assert v["max"] == max(v["corners_fem_max"], v["edges_fem_max"], v["interior_fem_max"])


def test_screened_candidates_equal_reference():
    # the edge candidates and interior points of the reference's draw
    # (recipes.py:652-666 of the JAX package), in its order
    from pgdrome_tpu_torch.models.problems import elliptic_dense_verifier

    Vs = TR.frontier_spaces(3, n_x=32, n_p=16)
    grid = Vs[1].tabulate_dof_coordinates()[:, 0]
    lo, hi = grid[1], grid[-2]
    rng = np.random.default_rng(424242)
    edges = grid[rng.integers(1, len(grid) - 1, size=(48, 3))]
    for r in range(48):
        k = int(rng.integers(1, 3))
        dims = rng.choice(3, size=k, replace=False)
        edges[r, dims] = np.where(rng.integers(0, 2, size=k) == 0, lo, hi)
    interior = grid[rng.integers(1, len(grid) - 1, size=(32, 3))]
    (pc, tf), _ = TR.frontier_setup(3, (1.0, 6), n_x=32, n_p=16)
    sv = TR.screened_verification(pc, Vs, elliptic_dense_verifier(Vs, tf, corner_cap=2),
                                  max_rank=200, screener_cap=64, n_screen_edges=48,
                                  device="cpu")
    np.testing.assert_array_equal(sv.edge_cands, edges)
    np.testing.assert_array_equal(sv.interior, interior)
    assert sv.corners.shape == (8, 3) and sv.screen.n_modes_cap == 256


def test_anova_branch(branch_runs):
    (jb, jr), (tb, tr) = branch_runs["anova"]
    assert tr.keys() == jr.keys() and tr["screened_verification"] is False
    ja, ta = jr["anova"], tr["anova"]
    assert ta["rank"] == ja["rank"] == 35 and ta["anchor"] == ja["anchor"]
    for a, b in zip(ja["pairs"], ta["pairs"]):
        assert {k: v for k, v in b.items() if k != "s"} == {
            k: v for k, v in a.items() if k != "s"}
    jh, th = jr["history"], tr["history"]
    # stage 1 verifies the ANOVA start; the next stages enrich it
    assert [h["rank"] for h in th] == [h["rank"] for h in jh]
    assert th[0]["rank"] == 35.0 and len(th) >= 2
    for a, b in zip(jh, th):
        assert [b[f] for f in FLAGS] == [a[f] for f in FLAGS]
        for key in ("corners", "interior", "max"):
            np.testing.assert_allclose(b[key], a[key], rtol=RTOL, atol=F64_FLOOR)
    for key in ("corners_fem_max", "interior_fem_max", "max"):
        np.testing.assert_allclose(tr["verified"][key], jr["verified"][key], rtol=RTOL,
                                   atol=F64_FLOOR)
    assert tb.n_modes == jb.n_modes
    np.testing.assert_allclose(tb.amplitudes, np.asarray(jb.amplitudes), rtol=RTOL)


@pytest.mark.parametrize("name,num_params,rank", [
    ("frontier_anova_d5_state.npz", 5, 189), ("frontier_anova_d10_state.npz", 10, 2717)])
def test_anova_state_loader(name, num_params, rank):
    # the committed ANOVA-started states: the d=5 keys, dim-0 modes in the
    # energy basis (2047 interior dofs of the 2049-dof P2 space)
    path = Path(__file__).resolve().parent.parent / "states" / name
    res = load_state_npz(path)
    assert res.n_modes == rank and len(res.modes) == 1 + num_params
    assert tuple(res.modes[0].shape) == (rank, 2047)
    assert all(tuple(m.shape) == (rank, 129) for m in res.modes[1:])
    assert all(m.dtype == torch.float64 and bool(torch.isfinite(m).all())
               for m in res.modes)
    with np.load(path) as z:
        for d in range(1 + num_params):
            np.testing.assert_array_equal(res.modes[d].numpy(), z[f"m{d}"])
        np.testing.assert_array_equal(res.amplitudes, z["amplitudes"])
        assert res.normU0 == float(z["normU0"])


def test_anova_d5_state_served():
    # frontier_vademecum serves the committed ANOVA-started d=5 state (raw
    # combination, rank 189): its f64 fields within 1e-6 of per-sample FEM
    # at the 32 inset corners (7.71e-7 measured on a CPU)
    from pgdrome_tpu_torch.convert import frontier_vademecum
    from pgdrome_tpu_torch.models.problems import box_corners, elliptic_fem_solver

    path = Path(__file__).resolve().parent.parent / "states" / "frontier_anova_d5_state.npz"
    vd = frontier_vademecum(path, 5, device="cpu", dtype=torch.float64, method="torch")
    assert vd.n_modes == 189 and tuple(vd._modes[0].shape) == (189, 2049)
    grid = vd.spaces[1].tabulate_dof_coordinates()[:, 0]
    corners = box_corners(grid[1], grid[-2], 5)
    fem = elliptic_fem_solver(vd.spaces[0], 5)
    errs = [np.linalg.norm(u - ref) / np.linalg.norm(ref)
            for u, ref in zip(vd.fields(corners).numpy(), (fem(p) for p in corners))]
    assert len(errs) == 32 and max(errs) < 1e-6


def test_corner_seeded_init_equals_reference():
    corners = np.array([[0.1, 0.9, 0.1], [0.9, 0.9, 0.1]])
    sizes = (63, 17, 17, 17)
    for a, b in ((j_seeds(corners, 0.05, 0.95), t_seeds(corners, 0.05, 0.95)),
                 (j_seeds(corners, 0.0, 1.0, q=4, bg=0.1, seed=7),
                  t_seeds(corners, 0.0, 1.0, q=4, bg=0.1, seed=7))):
        for n in (0, 1, 5):
            for x, y in zip(a(n, sizes), b(n, sizes)):
                np.testing.assert_array_equal(x, y)


def test_adaptive_cascade_decisions():
    # scripted verifier errors drive the decisions: boost while corners
    # bind, dd below rhs_comp_below ("auto"), corner seeds on boosted
    # stages, stall after stall_stages, and the best result returned
    sep, _ = parametric_elliptic(n_x=16, n_p=6, num_params=2, degree_x=2)
    pc, _ = S.precondition_dim0(sep, np.float64)
    script = iter([(5e-4, 1e-4), (8e-6, 9e-6), (9e-6, 9e-6), (9e-6, 9e-6)])
    seen = []

    def verify(res):
        c, i = next(script)
        seen.append(res.n_modes)
        return {"corners": c, "interior": i, "worst_points": np.full((3, 2), 0.9),
                "worst_errors": np.array([1.0, 3.0, 2.0])}

    from pgdrome_tpu_torch.utils.profiling import StageMetrics

    metrics = StageMetrics("cpu")
    checkpoints = []
    best, hist = TR.adaptive_cascade(
        pc, verify, bound=1e-6, n_stage1=4, stage_budget=3, max_stages=6,
        boost_problem=pc, boost_margin=2.0, stall_stages=2, dtype=np.float32,
        corner_seed_range=(0.1, 0.9), seed_max_fp_it=5,
        checkpoint=lambda line, raw: checkpoints.append((line["stage"], raw.n_modes)),
        metrics=metrics, device="cpu")
    assert [h["rank"] for h in hist] == seen == [4, 7, 10, 13]
    assert [tuple(h[f] for f in FLAGS) for h in hist] == [
        (False, False, False), (True, True, False), (False, False, True),
        (False, False, True)]
    assert best.n_modes == 7  # the best stage, not the last
    assert checkpoints == [(1, 4), (2, 7), (3, 10), (4, 13)]
    assert [r["stage"] for r in metrics.rows] == [1, 2, 3, 4]
    assert len(metrics.rows[1]["fp_its"]) == 3 and "residual_s" in metrics.rows[1]
    assert all(r["verify_s"] >= 0 and r["galerkin_s"] >= 0 for r in metrics.rows)


def test_cached_setup_roundtrip(tmp_path):
    calls = []

    def build():
        calls.append(1)
        return S.precondition_dim0(parametric_elliptic(n_x=8, n_p=4, num_params=1)[0],
                                   np.float64)

    key = ["torch_probe5_build_v1", 8, 4, 1, (1.0, 6)]
    (a, tf_a), st1 = t_cache.cached_setup(build, key, (build,), cache_dir=str(tmp_path))
    (b, tf_b), st2 = t_cache.cached_setup(build, key, (build,), cache_dir=str(tmp_path))
    assert (st1, st2) == ("miss", "hit") and len(calls) == 1
    assert isinstance(b, S.SeparatedProblem) and isinstance(tf_b, S.Dim0Transform)
    for x, y in zip(a.ops + a.rhs, b.ops + b.rhs):
        np.testing.assert_array_equal(x, y)
    # the port never reads the JAX package's entries, even for equal key data
    assert t_cache._key(key, ()) != j_cache._key(key, ())
    assert t_cache.cached_setup(build, key, cache_dir=None)[1] == "off"
