"""The port's frontier drive against the JAX package's, on the CPU.

``highd_frontier(3, n_x=32, n_p=16)`` with 8-mode stages and
``max_stages=3`` in f64 in both packages (JAX with x64, as
``tests/conftest.py`` sets; the port with ``device="cpu"``).  The base
measure is boosted (1, 6) instead of the default (8, 6) so that the three
stages take all three kinds the d=5 run takes: plain f32-style, compensated,
then boosted, corner-seeded and compensated.  Ranks and the boosted /
seeded / rhs_comp flags are equal per stage; errors and the best result's
amplitudes agree to rtol 1e-8 (measured ~1e-10 and ~1e-15); the report,
the state npz and the artifact have the reference's keys.  The rest is the
port alone: ``adaptive_cascade``'s decisions on scripted errors,
``corner_seeded_init``, a resumed leg, the setup cache.
"""

import json
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


def test_screened_range_raises():
    with pytest.raises(ValueError, match="parallel/certify.py"):
        TR.highd_frontier(8, device="cpu")


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
