"""The port's residual indicators and certificates against the JAX
package's, on the CPU (``pgdrome_tpu_torch/parallel/certify.py``).

One f32 result (the port's solver on ``parametric_elliptic(n_x=64, n_p=16,
num_params=3)``, precondition_dim0'd) goes as numpy arrays through both
packages; JAX runs op by op (``jax.disable_jit()``), as the dd parity of
``tests/test_torch_ddf32.py`` does.  Samples are parameter grid points,
where the f32 mode evaluation is exact in both.

- the dd indicator: within 2e-6 relative of eager JAX and of a direct f64
  numpy residual, in its three calling modes; chunking changes no bit;
- the f32 screener: within 1e-4 relative of the JAX screener, or one f32
  unit (2^-24) of the normalised ‖b(p)‖ where that is larger (both true
  f32, summed in another order: the residual is a ~1e-4 cancellation);
- ``screened_verify`` and ``Certifier`` on the same callables as the
  reference: equal dicts, η, calibration records, bounds and warnings;
- ``guaranteed_field_bound``: within 1e-6 relative, λ_min to 1e-12;
- ``validate_spd_family`` raises where the reference raises;
- ``Vademecum.attach_certifier`` wired as the reference's;
- ``Certifier.save`` / ``load``: the ``.npz`` round trip gives the same
  residuals and bounds bit for bit; an HDF5 snapshot written by the JAX
  package's ``Certifier.save`` loads into the port alike; wrong spaces are
  refused.

``PYTHONPATH=. python tests/test_torch_certify.py`` computes, with the JAX
package on the CPU, the d=10 reference figures that ``chip_smoke.py``'s
``certify`` phase holds the port to (the committed rank-2717 state, minutes
of host work and a few GB of memory).
"""

import warnings

import jax
import numpy as np
import pytest
import torch

from pgdrome_tpu import serving as JS
from pgdrome_tpu.parallel import certify as JC
from pgdrome_tpu.separated import PGDResult as JResult

from pgdrome_tpu_torch import serving as TS
from pgdrome_tpu_torch.models.problems import elliptic_dense_verifier, parametric_elliptic
from pgdrome_tpu_torch.parallel import certify as TC
from pgdrome_tpu_torch.separated import PGDResult, SeparatedPGD, SeparatedProblem
from pgdrome_tpu_torch.separated import evaluate_modes_1d, precondition_dim0

NP = 3
SIZE = dict(n_x=64, n_p=16, num_params=NP, degree_x=2)
DD_TOL = 2e-6      # dd indicator vs eager JAX and vs the f64 residual
SCREEN_TOL = 1e-4  # f32 screener vs the JAX screener, relative ...
U32 = 2.0 ** -24   # ... or one f32 unit of the normalised ‖b(p)‖, the larger
GB_TOL = 1e-6      # guaranteed bound vs JAX


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite's workers share a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def solved():
    sep, Vs = parametric_elliptic(**SIZE)
    sep_pc, tf = precondition_dim0(sep, np.float64)
    t = SeparatedPGD(sep_pc, n_max=12, tol=0.0, tol_fp=1e-8, residual_check=False,
                     dtype=np.float32, device="cpu").solve_fused()
    modes = [m.numpy() for m in t.modes]
    kw = dict(n_modes=t.n_modes, amplitudes=t.amplitudes, alpha=t.alpha, fp_its=t.fp_its,
              normU0=t.normU0)
    grid = Vs[1].tabulate_dof_coordinates()[:, 0]
    rng = np.random.default_rng(0)
    samples = grid[rng.integers(1, len(grid) - 1, size=(12, NP))]
    return dict(sep=sep, pc=sep_pc, tf=tf, Vs=Vs, t=PGDResult(modes=modes, **kw),
                j=JResult(modes=modes, **kw), grid=grid, samples=samples)


def _jax_spaces(Vs):
    from pgdrome_tpu.fem.mesh import IntervalMesh
    from pgdrome_tpu.fem.space import FunctionSpace

    return [FunctionSpace(IntervalMesh(SIZE["n_x"], 0.0, 1.0), "P", 2)] + [
        FunctionSpace(IntervalMesh(SIZE["n_p"], 0.0, 1.0), "P", 1) for _ in Vs[1:]]


@pytest.fixture(scope="module")
def jax_side(solved):
    from pgdrome_tpu.models.problems import parametric_elliptic as j_elliptic
    from pgdrome_tpu.separated import precondition_dim0 as j_pre

    sep, _ = j_elliptic(**SIZE)
    pc, tf = j_pre(sep, dtype=np.float64)
    return dict(sep=sep, pc=pc, tf=tf, Vs=_jax_spaces(solved["Vs"]))


def _direct_residuals(sep, Vs, tf, res, samples, energy):
    """f64 numpy ground truth: K(p), b(p) assembled per sample, the
    residual over interior dofs, in the energy norm ‖L⁻¹·‖ if asked."""
    K = res.n_modes
    full0 = tf.modes_to_full(res.modes[0][:K])
    ops0, mask = np.asarray(sep.ops[0]), np.asarray(sep.bc_masks[0])
    out = []
    for p in samples:
        theta, rho, w = np.ones(sep.num_terms), np.ones(sep.num_rhs), np.ones(K)
        for d in range(1, sep.num_dims):
            od = np.asarray(sep.ops[d])
            gi = np.argmin(np.abs(Vs[d].tabulate_dof_coordinates()[:, 0] - p[d - 1]))
            theta *= np.diagonal(od, axis1=1, axis2=2)[:, gi]
            rho *= np.asarray(sep.rhs[d])[:, gi]
            w *= evaluate_modes_1d(Vs[d], torch.from_numpy(res.modes[d].astype(np.float64)),
                                   torch.tensor([p[d - 1]])).numpy()[0, :K]
        b = rho @ np.asarray(sep.rhs[0])
        r = b - np.einsum("t,tij->ij", theta, ops0) @ (w @ full0)
        if energy:
            r = tf.apply_Linv(r[tf.interior][:, None])[:, 0]
            b = tf.apply_Linv(b[tf.interior][:, None])[:, 0]
        else:
            r, b = r * mask, b * mask
        out.append(np.linalg.norm(r) / np.linalg.norm(b))
    return np.asarray(out)


@pytest.mark.parametrize("mode", ["energy", "pc", "euclid"])
def test_dd_indicator(solved, jax_side, mode):
    s, j = solved, jax_side
    sep, jsep, tf, jtf, kw = s["sep"], j["sep"], s["tf"], j["tf"], {}
    if mode == "pc":
        sep, jsep, tf, jtf = s["pc"], j["pc"], None, None
    if mode == "euclid":
        kw = dict(precondition=False)
    vals = TC.make_residual_indicator(sep, s["Vs"], s["t"], tf=tf, device="cpu", **kw)(
        s["samples"])
    with jax.disable_jit():
        ref = JC.make_residual_indicator(jsep, j["Vs"], s["j"], tf=jtf, **kw)(s["samples"])
    direct = _direct_residuals(s["sep"], s["Vs"], s["tf"], s["t"], s["samples"],
                               energy=mode != "euclid")
    assert vals.dtype == np.float64 and vals.shape == (12,)
    assert np.all(np.abs(vals - ref) <= DD_TOL * ref)
    assert np.all(np.abs(vals - direct) <= DD_TOL * direct)


def test_dd_indicator_chunks_and_checks(solved):
    s = solved
    one = TC.make_residual_indicator(s["pc"], s["Vs"], s["t"], chunk=5, device="cpu")
    many = TC.make_residual_indicator(s["pc"], s["Vs"], s["t"], chunk=64, device="cpu")
    assert one.chunk == 5 and many.chunk == 64
    np.testing.assert_array_equal(one(s["samples"]), many(s["samples"]))
    with pytest.raises(ValueError, match="samples"):
        one(s["samples"][:, :1])
    sep_g, Vs_g = parametric_elliptic(n_x=32, n_p=8, num_params=2,
                                      param_discretization="galerkin")
    res = PGDResult(modes=[np.ones((1, n)) for n in sep_g.sizes], n_modes=1,
                    amplitudes=np.ones(1), alpha=np.ones(1), fp_its=np.ones(1))
    with pytest.raises(ValueError, match="collocation"):
        TC.make_residual_indicator(sep_g, Vs_g, res, device="cpu")


def test_screener(solved, jax_side):
    s, j = solved, jax_side
    vals = TC.make_screener(s["pc"], s["Vs"], n_modes_cap=16, chunk=8, device="cpu")(
        s["t"], s["samples"])
    with jax.disable_jit():
        ref = JC.make_screener(j["pc"], j["Vs"], n_modes_cap=16, chunk=8)(s["j"], s["samples"])
    dd = TC.make_residual_indicator(s["pc"], s["Vs"], s["t"], device="cpu")(s["samples"])
    assert np.all(np.abs(vals - ref) <= np.maximum(SCREEN_TOL * ref, U32))
    assert np.all(np.abs(vals - dd) <= 1e-2 * dd)  # the JAX test's f32 margin
    low = PGDResult(modes=s["t"].modes, n_modes=4, amplitudes=s["t"].amplitudes[:4],
                    alpha=s["t"].alpha[:4], fp_its=s["t"].fp_its[:4])
    screen = TC.make_screener(s["pc"], s["Vs"], n_modes_cap=16, device="cpu")
    assert screen(low, s["samples"]).max() > vals.max()  # zero-padded rows are inert
    with pytest.raises(ValueError, match="cap"):
        TC.make_screener(s["pc"], s["Vs"], n_modes_cap=8, device="cpu")(s["t"], s["samples"])


def test_screened_verify_equals_reference(solved):
    s = solved
    ver = elliptic_dense_verifier(s["Vs"], s["tf"], n_random=4, seeds=(7,))
    screen = TC.make_screener(s["pc"], s["Vs"], n_modes_cap=16, device="cpu")
    cands = np.concatenate([ver.corners, s["samples"]])
    interior = s["samples"][:4]
    outs = [fn(screen, ver.sample_errors, cands, top_k=5, interior_samples=interior,
               safety=1.5)(s["t"]) for fn in (JC.screened_verify, TC.screened_verify)]
    ref, out = outs
    assert out.keys() == ref.keys()
    for key in ref:
        np.testing.assert_array_equal(out[key], ref[key])
    true_max = ver.sample_errors(s["t"], cands).max()
    assert out["screened"] and out["corners"] >= 0.999 * true_max
    for fn in (JC.screened_verify, TC.screened_verify):
        with pytest.raises(ValueError, match="top_k"):
            fn(screen, ver.sample_errors, cands, top_k=0)


def test_certifier_behaves_as_reference(solved):
    # the same indicator callable in both classes: the same η, calibration
    # records, bounds and out-of-distribution warnings
    s = solved
    ind = TC.make_residual_indicator(s["pc"], s["Vs"], s["t"], device="cpu")
    ver = elliptic_dense_verifier(s["Vs"], s["tf"], n_random=4, seeds=(7,))
    cal = np.concatenate([ver.corners, s["samples"][:6]])
    true_cal = ver.sample_errors(s["t"], cal)
    held = s["samples"][6:]
    out_box = np.full((2, NP), s["grid"][-1])  # outside the calibration box
    certs = [cls(ind) for cls in (JC.Certifier, TC.Certifier)]
    for c in certs:
        with pytest.raises(RuntimeError, match="calibrate"):
            c.bound(held)
    etas = [c.calibrate(cal, true_cal, safety=2.0) for c in certs]
    assert etas[0] == etas[1] > 0
    j, t = certs
    np.testing.assert_array_equal(t.cal_box, j.cal_box)
    assert t.cal_res_range == j.cal_res_range and t.n_calibration == j.n_calibration == 14
    np.testing.assert_array_equal(t.bound(held), j.bound(held))
    assert np.all(t.bound(held) >= ver.sample_errors(s["t"], held))
    caught = []
    for c in certs:
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            c.bound(out_box)
        caught.append(sorted(str(x.message) for x in w))
    assert caught[0] == caught[1] and any("outside the calibration" in m for m in caught[1])
    with pytest.raises(ValueError, match="align"):
        t.calibrate(cal, true_cal[:3])
    with pytest.raises(RuntimeError, match="attach"):
        t.guaranteed_bound(held)


@pytest.fixture(scope="module")
def bounds(solved, jax_side):
    s, j = solved, jax_side
    t_nodal = TC.guaranteed_field_bound(s["sep"], s["Vs"], s["t"], tf=s["tf"], device="cpu")
    t_pc = TC.guaranteed_field_bound(s["pc"], s["Vs"], s["t"], nodal_tf=s["tf"], device="cpu")
    with jax.disable_jit():
        j_nodal = JC.guaranteed_field_bound(j["sep"], j["Vs"], s["j"], tf=j["tf"])
        j_pc = JC.guaranteed_field_bound(j["pc"], j["Vs"], s["j"], nodal_tf=j["tf"])
        ref = [j_nodal(s["samples"]), j_pc(s["samples"])]
    return (t_nodal, t_pc), (j_nodal, j_pc), ref


def test_guaranteed_field_bound(solved, bounds):
    s = solved
    (t_nodal, t_pc), (j_nodal, _), ref = bounds
    true = elliptic_dense_verifier(s["Vs"], s["tf"], n_random=1, seeds=(7,)).sample_errors(
        s["t"], s["samples"])
    for gb, r in zip((t_nodal, t_pc), ref):
        out = gb(s["samples"])
        assert out.keys() == r.keys() == {"abs_K0", "rel_energy", "abs_l2", "rel_l2"}
        for key in r:
            np.testing.assert_allclose(out[key], r[key], rtol=GB_TOL)
        assert np.all(out["rel_l2"] >= true)
        assert abs(gb.lam_min_lower - j_nodal.lam_min_lower) <= 1e-12 * j_nodal.lam_min_lower
        assert abs(gb.lam_min_estimate - j_nodal.lam_min_estimate) <= (
            1e-12 * j_nodal.lam_min_estimate)
        assert gb.lam_min_lower <= gb.lam_min_estimate and "rounding" in gb.caveat
    energy_only = TC.guaranteed_field_bound(s["pc"], s["Vs"], s["t"], device="cpu")
    assert set(energy_only(s["samples"])) == {"abs_K0", "rel_energy"}
    cert = TC.make_certifier(s["sep"], s["Vs"], s["t"], tf=s["tf"], device="cpu")
    cert.attach_guaranteed(t_nodal)
    np.testing.assert_array_equal(cert.guaranteed_bound(s["samples"]),
                                  t_nodal(s["samples"])["rel_l2"])
    with pytest.raises(KeyError):
        cert.guaranteed_bound(s["samples"], norm="nope")
    with pytest.raises(ValueError, match="≈ I"):
        TC.guaranteed_field_bound(s["sep"], s["Vs"], s["t"], device="cpu")


def test_guaranteed_field_bound_given_residuals(solved, bounds):
    # residuals already swept by the bound's own indicator give the same
    # bounds bit for bit, without a second dd sweep
    (t_nodal, _), _, _ = bounds
    samples = solved["samples"]
    again = t_nodal(samples, residuals=t_nodal.indicator(samples))
    for key, v in t_nodal(samples).items():
        np.testing.assert_array_equal(again[key], v)


def test_calibrate_given_residuals(solved, bounds):
    # the indicator's residuals handed to calibrate give the same η and
    # calibration record as calibrate's own sweep
    (t_nodal, _), _, _ = bounds
    samples = solved["samples"]
    errors = np.linspace(1e-7, 2e-7, len(samples))
    a, b = TC.Certifier(t_nodal.indicator), TC.Certifier(t_nodal.indicator)
    assert a.calibrate(samples, errors) == b.calibrate(
        samples, errors, residuals=t_nodal.indicator(samples))
    assert a.cal_res_range == b.cal_res_range and np.array_equal(a.cal_box, b.cal_box)


def _broken(sep, dim, how):
    ops = [np.array(o) for o in sep.ops]
    if how == "negative":
        np.fill_diagonal(ops[dim][1], -1.0)
    elif how == "base":
        np.fill_diagonal(ops[dim][0], 0.0)
    else:
        ops[dim][1, 0, 1] = 0.5
    return SeparatedProblem(ops=ops, rhs=list(sep.rhs), mass=list(sep.mass),
                            bc_dofs=list(sep.bc_dofs))


@pytest.mark.parametrize("how,match", [("negative", "negative"), ("base", "positive"),
                                       ("offdiag", "diagonal")])
def test_validate_spd_family_raises(how, match):
    from pgdrome_tpu.models.problems import parametric_elliptic as j_elliptic

    tsep, _ = parametric_elliptic(n_x=24, n_p=8, num_params=2)
    jsep, _ = j_elliptic(n_x=24, n_p=8, num_params=2)
    TC.validate_spd_family(tsep)
    JC.validate_spd_family(jsep)
    with pytest.raises(ValueError, match=match):
        JC.validate_spd_family(_broken(jsep, 2, how))
    with pytest.raises(ValueError, match=match):
        TC.validate_spd_family(_broken(tsep, 2, how))


def test_no_cuda_raises(solved, monkeypatch):
    # the device entry points run on CUDA unless asked for the CPU
    s = solved
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: TC.make_residual_indicator(s["pc"], s["Vs"], s["t"]),
                  lambda: TC.make_screener(s["pc"], s["Vs"], n_modes_cap=16),
                  lambda: TC.make_certifier(s["pc"], s["Vs"], s["t"]),
                  lambda: TC.guaranteed_field_bound(s["pc"], s["Vs"], s["t"], nodal_tf=s["tf"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()


def test_vademecum_attach_certifier(solved, jax_side):
    s = solved
    tvd = TS.Vademecum(s["Vs"], s["t"], dim0_transform=s["tf"], device="cpu")
    jvd = JS.Vademecum(jax_side["Vs"], s["j"], dim0_transform=jax_side["tf"])
    for vd in (jvd, tvd):
        for query in (vd.residuals, vd.error_bound):
            with pytest.raises(RuntimeError, match="certifier"):
                query(s["samples"])
    cert = TC.make_certifier(s["sep"], s["Vs"], s["t"], tf=s["tf"], eta=1.5, device="cpu")
    assert tvd.attach_certifier(cert) is tvd and jvd.attach_certifier(cert) is jvd
    res = cert.residuals(s["samples"])
    for vd in (jvd, tvd):
        np.testing.assert_array_equal(vd.residuals(s["samples"]), res)
        np.testing.assert_array_equal(vd.error_bound(s["samples"]), 1.5 * res)


def test_certifier_save_load(solved, jax_side, tmp_path, monkeypatch):
    s = solved
    ind = TC.make_residual_indicator(s["pc"], s["Vs"], s["t"], device="cpu")
    cert = TC.Certifier(ind)
    q = s["samples"]
    cert.calibrate(q, np.linspace(1e-6, 2e-6, len(q)))
    want_res, want_bound = cert.residuals(q), cert.bound(q)
    for path, spaces in ((tmp_path / "c.npz", s["Vs"]), (tmp_path / "bare.npz", None)):
        cert.save(path, spaces=spaces)
        again = TC.Certifier.load(path, s["Vs"], chunk=ind.chunk, device="cpu")
        assert (again.eta, again.safety, again.n_calibration, again.cal_res_range) == (
            cert.eta, cert.safety, cert.n_calibration, cert.cal_res_range)
        np.testing.assert_array_equal(again.cal_box, cert.cal_box)
        np.testing.assert_array_equal(again.residuals(q), want_res)
        np.testing.assert_array_equal(again.bound(q), want_bound)
    # the JAX package's HDF5 writer on the same tables
    h5 = tmp_path / "c.h5"
    JC.Certifier(ind, eta=cert.eta).save(str(h5), spaces=jax_side["Vs"])
    from_h5 = TC.Certifier.load(h5, s["Vs"], device="cpu")
    assert from_h5.eta == cert.eta and from_h5.cal_box is None
    np.testing.assert_array_equal(from_h5.residuals(q), want_res)
    uncal = TC.Certifier.load(tmp_path / "c.npz", s["Vs"], device="cpu")
    with pytest.raises(ValueError, match="expected"):
        TC.Certifier.load(tmp_path / "c.npz", s["Vs"][:-1], device="cpu")
    _, small = parametric_elliptic(n_x=64, n_p=8, num_params=NP, degree_x=2)
    with pytest.raises(ValueError, match="does not match"):
        TC.Certifier.load(tmp_path / "c.npz", small, device="cpu")
    with pytest.raises(ValueError, match="dofs"):
        TC.Certifier.load(tmp_path / "bare.npz", small, device="cpu")
    assert uncal.eta == cert.eta
    with pytest.raises(ValueError, match="no dd tables"):
        TC.Certifier(lambda x: x).save(tmp_path / "x.npz")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TC.Certifier.load(tmp_path / "c.npz", s["Vs"])


def d10_reference():
    """The JAX package's figures on the committed rank-2717 d=10 state
    (``states/frontier_anova_d10_state.npz``, its raw combination) on the
    base-boost (8, 6) build: per-sample f64 FEM errors at the 1024 inset
    corners, λ_min's lower bound and estimate, and at a 16-corner subset
    the dd indicator and ``guaranteed_field_bound(sep_pc, Vs, res, tf=None,
    nodal_tf=tf)`` (op by op, one sample a pass); over all 1024 corners
    the f32 screener's largest and median relative gap to the dd indicator
    and how many of the indicator's worst 16 its worst 32 hold.  Prints
    them as the constants of ``chip_smoke.py``."""
    import json
    import os

    from pgdrome_tpu.fem.mesh import IntervalMesh
    from pgdrome_tpu.fem.space import FunctionSpace
    from pgdrome_tpu.models.problems import box_corners
    from pgdrome_tpu.models.problems import elliptic_dense_verifier as j_verifier
    from pgdrome_tpu.models.problems import parametric_elliptic as j_elliptic
    from pgdrome_tpu.separated import precondition_dim0 as j_pre

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subset = (0, 1023) + tuple(range(68, 1020, 68))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sep, _ = j_elliptic(n_x=1024, n_p=128, num_params=10, degree_x=2,
                            boundary_boost=(8.0, 6))
    sep_pc, tf = j_pre(sep, dtype=np.float64)
    del sep
    Vs = [FunctionSpace(IntervalMesh(1024, 0.0, 1.0), "P", 2)] + [
        FunctionSpace(IntervalMesh(128, 0.0, 1.0), "P", 1) for _ in range(10)]
    with np.load(os.path.join(root, "states", "frontier_anova_d10_state.npz")) as z:
        res = JResult(modes=[z[f"m{d}"] for d in range(11)], n_modes=int(z["n_modes"]),
                      amplitudes=z["amplitudes"], alpha=z["alpha"], fp_its=z["fp_its"],
                      normU0=float(z["normU0"]))
    grid = Vs[1].tabulate_dof_coordinates()[:, 0]
    corners = box_corners(grid[1], grid[-2], 10)
    fem = j_verifier(Vs, tf, corner_cap=2).sample_errors(res, corners)
    with jax.disable_jit():
        dd = JC.make_residual_indicator(sep_pc, Vs, res, chunk=1)(corners[list(subset)])
        gb = JC.guaranteed_field_bound(sep_pc, Vs, res, tf=None, nodal_tf=tf, chunk=1)
        rel_l2 = gb(corners[list(subset)])["rel_l2"]
    # the f32 screener's noise over all corners, against the dd indicator
    # (the port's on the CPU: eager JAX would take hours for 1024 samples,
    # and the two agree to ~2e-7 where both ran)
    screen = JC.make_screener(sep_pc, Vs, n_modes_cap=3072, chunk=256)(res, corners)
    tsep = SeparatedProblem(ops=list(sep_pc.ops), rhs=list(sep_pc.rhs), mass=list(sep_pc.mass),
                            bc_dofs=list(sep_pc.bc_dofs))
    tres = PGDResult(modes=res.modes, n_modes=res.n_modes, amplitudes=res.amplitudes,
                     alpha=res.alpha, fp_its=res.fp_its)
    from pgdrome_tpu_torch.recipes import frontier_spaces

    dd_all = TC.make_residual_indicator(tsep, frontier_spaces(10), tres, device="cpu")(corners)
    gap = np.abs(screen / dd_all - 1)
    print(json.dumps({"subset": subset, "fem": [float(f"{e:.11e}") for e in fem],
                      "dd": dd.tolist(), "rel_l2": rel_l2.tolist(),
                      "screen_gap_max": float(gap.max()),
                      "screen_gap_median": float(np.median(gap)),
                      "screen_worst16_in_worst32": len(
                          set(np.argsort(dd_all)[-16:]) & set(np.argsort(screen)[-32:])),
                      "lam_min_lower": gb.lam_min_lower,
                      "lam_min_estimate": gb.lam_min_estimate}))


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    d10_reference()
