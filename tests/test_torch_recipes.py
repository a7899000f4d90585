"""The port's recipes against the JAX package's, on the CPU.

``two_stage_elliptic`` (a greedy stage, two f64 residual restarts,
compression and the Galerkin update) on the boosted toy
``parametric_elliptic(n_x=32, n_p=8, num_params=2)``, in f64 for both
packages: modes within 1e-8 of each buffer's max, fp sweeps equal.  In f32
the port's reconstruction is held to the JAX package's f64 one at the
verifier's samples within ``F32_REC`` = 4e-6 relative L2: the port's CPU
f32 run measures 2.13e-6 there.  The f32 greedy picks slightly different
modes, so the two rank-8 results differ by less than their own truncation
error (the f64 result is ~7e-6 off FEM on this set).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pgdrome_tpu import recipes as JR
from pgdrome_tpu import separated as J
from pgdrome_tpu.models.problems import parametric_elliptic as j_elliptic

from pgdrome_tpu_torch import recipes as TR
from pgdrome_tpu_torch import separated as S
from pgdrome_tpu_torch.convert import result_from_numpy
from pgdrome_tpu_torch.models.problems import elliptic_dense_verifier
from pgdrome_tpu_torch.models.problems import parametric_elliptic as t_elliptic
from pgdrome_tpu_torch.serving import Vademecum

REL = 1e-8
F32_REC = 4e-6
TOY = dict(n_x=32, n_p=8, num_params=2, boundary_boost=(16.0, 6))
RECIPE = dict(n_stage1=10, n_stage2=6, n_deploy=8, extra_stages=(6,))


def _close(a, b, tol):
    a, b = S.host_f64(a), S.host_f64(np.asarray(b))
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * np.abs(b).max()


@pytest.fixture(scope="module")
def toy():
    js, jV = j_elliptic(**TOY)
    ts, tV = t_elliptic(**TOY)
    jres, jtf = JR.two_stage_elliptic(js, dtype=np.float64, **RECIPE)
    return SimpleNamespace(js=js, ts=ts, tV=tV, jres=jres, jtf=jtf)


def _fields(spaces, res, tf, samples):
    """The f64 reconstruction of a result at the samples (port's plain path)."""
    vd = Vademecum(spaces, res, dim0_transform=tf, method="torch",
                   dtype=torch.float64, device="cpu")
    return vd.fields(samples).numpy()


def test_two_stage_elliptic_f64(toy):
    res, tf = TR.two_stage_elliptic(toy.ts, dtype=np.float64, device="cpu", **RECIPE)
    assert res.n_modes == toy.jres.n_modes == 8
    for a, b in zip(res.modes, toy.jres.modes):
        _close(a, b, REL)
    np.testing.assert_array_equal(np.asarray(res.fp_its), np.asarray(toy.jres.fp_its))
    np.testing.assert_array_equal(tf.interior, toy.jtf.interior)


def test_two_stage_elliptic_f32(toy):
    res, tf = TR.two_stage_elliptic(toy.ts, dtype=np.float32, device="cpu", **RECIPE)
    assert res.modes[1].dtype == torch.float32 and res.n_modes == 8
    samples = np.concatenate(list(
        elliptic_dense_verifier(toy.tV, tf, n_random=16, seeds=(7, 101), n_edge=4)
        .samples.values()))
    jres = toy.jres
    ref = _fields(toy.tV, result_from_numpy(jres.modes, jres.n_modes, jres.amplitudes,
                                            jres.alpha, jres.fp_its, jres.normU0),
                  tf, samples)
    got = _fields(toy.tV, res, tf, samples)
    err = np.linalg.norm(got - ref, axis=1) / np.linalg.norm(ref, axis=1)
    assert err.max() <= F32_REC


def test_residual_cascade_stage_problems():
    # a stage's residual taken against a harder boosted measure (same
    # operators per grid point, same transformed basis), bucketed rhs
    js, _ = j_elliptic(**TOY)
    ts, _ = t_elliptic(**TOY)
    jb, _ = j_elliptic(**dict(TOY, boundary_boost=(48.0, 6)))
    tb, _ = t_elliptic(**dict(TOY, boundary_boost=(48.0, 6)))
    jpc, jbpc = (J.precondition_dim0(p, np.float64)[0] for p in (js, jb))
    tpc, tbpc = (S.precondition_dim0(p, np.float64)[0] for p in (ts, tb))
    kw = dict(budgets=(4, 3), dtype=np.float64, solver="lu")
    j = JR.residual_cascade(jpc, stage_problems={2: jbpc}, **kw)
    t = TR.residual_cascade(tpc, stage_problems={2: tbpc}, device="cpu", **kw)
    assert t.n_modes == j.n_modes == 7
    for a, b in zip(t.modes, j.modes):
        _close(a, b, REL)
    tb16 = TR.residual_cascade(tpc, stage_problems={2: tbpc}, rhs_bucket=16,
                               device="cpu", **kw)
    # zero rows are inert: the bucketed stacks give the same modes
    np.testing.assert_array_equal(np.asarray(tb16.fp_its), np.asarray(t.fp_its))
    for a, b in zip(tb16.modes, t.modes):
        _close(a, b, 1e-12)


def test_to_nodal(toy):
    jpc, jtf = J.precondition_dim0(toy.js, np.float64)
    tpc, ttf = S.precondition_dim0(toy.ts, np.float64)
    r = toy.jres
    args = (r.modes, r.n_modes, r.amplitudes, r.alpha, r.fp_its, r.normU0)
    a = TR._to_nodal(result_from_numpy(*args), [ttf])
    b = JR._to_nodal(J.PGDResult([np.asarray(m) for m in r.modes], *args[1:]), [jtf])
    assert a.modes[0].shape == (np.asarray(r.modes[0]).shape[0], toy.tV[0].ndofs)
    for x, y in zip(a.modes, b.modes):
        _close(x, y, 1e-12)


def test_two_stage_elliptic_needs_cuda_by_default(toy, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TR.two_stage_elliptic(toy.ts, **RECIPE)
