"""The port's elasticity-ν flagship against the JAX package's, on the CPU.

2D plane-strain elasticity u((x, y), λp, λE, ν) on a crossed vector P2
mesh, at the JAX unit tests' toy widths (``nx=8, ny=3, n_p=6, n_E=6,
n_nu=8``): ``elasticity_vademecum`` in all four forms (fixed ν and ν
separated, Galerkin and collocation) to 1e-13; the congruence
preconditioning with the SPD term sum ``K1 + K2`` (the dense Cholesky
branch in both packages) to 1e-12; an f64 ``solve()`` with the JAX
package's sweep counts, its first three amplitudes equal to 1e-8 and the
rest to the JAX package's own floor on this problem, 5e-8; the f32 two-stage recipe (16 → f64
residual restart → Galerkin) under 1e-4 of per-grid-point FEM, as
``tests/unit/test_elasticity_nu.py`` gates it; and a JAX-trained result
carried across with ``convert.result_from_numpy`` and served in f64 —
fields, vector sensors, the gradient and strain vademecums, the output
covariance and the whole-field Sobol' indices (the vector mass Gram) —
equal to the JAX package's to 1e-12.

The per-grid-point FEM truth lives here, as in
``examples/elasticity_nu_flagship.py`` (neither package ships one).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgdrome_tpu.models import problems as JP
from pgdrome_tpu import separated as J
from pgdrome_tpu.serving import Vademecum as JVademecum

from pgdrome_tpu_torch.convert import result_from_numpy
from pgdrome_tpu_torch.fem.assembly import elasticity_matrix
from pgdrome_tpu_torch.fem.derivative import gradient_function
from pgdrome_tpu_torch.fem.function import Function
from pgdrome_tpu_torch.models import problems as TP
from pgdrome_tpu_torch import separated as S
from pgdrome_tpu_torch.serving import Vademecum

BUILD = 1e-13    # host f64 builders
PREC = 1e-12     # the congruence transform; served f64 quantities
REL = 1e-8       # f64 device math across the packages (the parity invariant)
TOY = dict(nx=8, ny=3, n_p=6, n_E=6, n_nu=8, degree=2)
FORMS = [(n_nu, disc) for n_nu in (0, 8) for disc in ("galerkin", "collocation")]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite's workers share a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(a, b, tol):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(float(np.abs(b).max()), 1e-300)
    assert float(np.abs(a - b).max()) <= tol * scale, float(np.abs(a - b).max()) / scale


def _build(P, n_nu=8, disc="collocation"):
    return P.elasticity_vademecum(**dict(TOY, n_nu=n_nu), param_discretization=disc)


@pytest.fixture(scope="module")
def colloc():
    return _build(TP), _build(JP)


def test_plane_strain_tensor():
    for nu in (0.05, 0.2, 0.33, 0.45):
        _close(TP.plane_strain_C(nu), JP.plane_strain_C(nu), 0.0)
        _close(TP._nu_f1(nu) * TP._C1 + TP._nu_f2(nu) * TP._C2, TP.plane_strain_C(nu), BUILD)


@pytest.mark.parametrize("n_nu, disc", FORMS)
def test_builder_arrays(n_nu, disc):
    (tsep, tVs, (tC, tbL, tbR)), (jsep, jVs, (jC, jbL, jbR)) = (
        _build(P, n_nu, disc) for P in (TP, JP))
    assert tsep.sizes == jsep.sizes and tsep.num_terms == jsep.num_terms
    for d in range(tsep.num_dims):
        _close(tsep.ops[d], jsep.ops[d], BUILD)
        _close(tsep.rhs[d], jsep.rhs[d], BUILD)
        _close(tsep.mass[d], jsep.mass[d], BUILD)
        np.testing.assert_array_equal(np.asarray(tsep.bc_dofs[d]), np.asarray(jsep.bc_dofs[d]))
        np.testing.assert_array_equal(tVs[d].element_dofs, jVs[d].element_dofs)
    _close(tbL, jbL, BUILD)
    _close(tbR, jbR, BUILD)
    for a, b in zip(tC if n_nu else [tC], jC if n_nu else [jC]):
        _close(a, b, 0.0)
    with pytest.raises(ValueError):
        TP.elasticity_vademecum(**TOY, param_discretization="lumped")


def test_stiffness_separation(colloc):
    # f1(ν)·K1 + f2(ν)·K2 == K(C(ν)): the operator-level separation
    (sep, Vs, _), _ = colloc
    K1, K2 = (np.asarray(sep.ops[0][t]) / 30000.0 for t in (0, 1))
    nu = 0.275
    _close(TP._nu_f1(nu) * K1 + TP._nu_f2(nu) * K2,
           elasticity_matrix(Vs[0], TP.plane_strain_C(nu)), 1e-12)


def _precondition(pkg, sep):
    base = np.asarray(sep.ops[0][0]) + np.asarray(sep.ops[0][1])
    return pkg.precondition_dim(sep, dim=0, dtype=np.float64, base=base)


def test_precondition_with_term_sum(colloc):
    (tsep, _, _), (jsep, _, _) = colloc
    (tpc, ttf), (jpc, jtf) = _precondition(S, tsep), _precondition(J, jsep)
    # a 2D mesh's bandwidth sends both to the dense Cholesky branch
    assert ttf.banded is None and jtf.banded is None
    _close(ttf.dense_L, jtf.dense_L, PREC)
    np.testing.assert_array_equal(ttf.interior, jtf.interior)
    for d in range(tpc.num_dims):
        _close(tpc.ops[d], jpc.ops[d], PREC)
        _close(tpc.rhs[d], jpc.rhs[d], PREC)
        _close(tpc.mass[d], jpc.mass[d], PREC)
    y = np.random.default_rng(0).normal(size=(3, tpc.sizes[0]))
    _close(ttf.modes_to_full(y), jtf.modes_to_full(y), PREC)


# tol_fp above the 'norm' stop's f64 floor: the metric is absolute, and at
# this problem's scale (‖U‖² ~ 1e8 at the first sweep) its cancellation
# leaves ~1e-4 of noise, under which the sweep counts are noise (both
# packages stop at 0.0 somewhere); at 1e-2 they are equal
F64 = dict(n_max=6, tol=1e-12, tol_fp=1e-2, max_fp_it=100)
# the 4-dim alternating map is weakly contracting and amplifies each
# solve's rounding (cond(K) ~ 1e6 here): the JAX package's own two paths on
# this problem differ by 1.2e-8 to 1.4e-8 and its test holds them to 5e-8
# (tests/unit/test_elasticity_nu.py:96-122); across the packages the first
# three amplitudes differ by under 1e-9, modes 4-6 by 1e-9 to 1.4e-8
# (measured on a CPU)
DEEP = 5e-8


@pytest.fixture(scope="module")
def solved(colloc):
    (tsep, tVs, _), (jsep, jVs, _) = colloc
    jres = J.SeparatedPGD(jsep, **F64).solve()
    tres = S.SeparatedPGD(tsep, device="cpu", **F64).solve()
    return tres, jres


def test_f64_solve_amplitudes(solved):
    tres, jres = solved
    assert tres.n_modes == jres.n_modes == 6
    np.testing.assert_array_equal(np.asarray(tres.fp_its), np.asarray(jres.fp_its))
    np.testing.assert_allclose(tres.amplitudes[:3], jres.amplitudes[:3], rtol=REL)
    np.testing.assert_allclose(tres.amplitudes, jres.amplitudes, rtol=DEEP)
    np.testing.assert_allclose(tres.alpha, jres.alpha, rtol=DEEP)


def _grids(Vs):
    return [V.tabulate_dof_coordinates()[:, 0] for V in Vs[1:]]


def fem_truth(sep, Vs, bL, bR, idx):
    """Per-grid-point f64 FEM of the collocation flagship at grid indices
    (i_p, i_E, i_ν): on the grid the lumped weights cancel, so the truth is
    the fixed-(p, E, ν) plane-strain solve."""
    p, E, nu = (g[i] for g, i in zip(_grids(Vs), idx))
    K1, K2 = np.asarray(sep.ops[0][0]), np.asarray(sep.ops[0][1])
    mask = np.asarray(sep.bc_masks[0], dtype=np.float64)
    K = E * (TP._nu_f1(nu) * K1 + TP._nu_f2(nu) * K2)
    A = K * mask[:, None] * mask[None, :] + np.diag(1.0 - mask)
    return np.linalg.solve(A, p * (bL + bR) * mask)


def test_f32_two_stage_recipe_vs_fem(colloc):
    (sep, Vs, (_, bL, bR)), _ = colloc
    sep_pc, tf = _precondition(S, sep)
    kw = dict(tol=0.0, tol_fp=1e-6, max_fp_it=40, dtype=np.float32, solver="cg",
              cg_iters=30, residual_check=False, device="cpu")
    res = S.SeparatedPGD(sep_pc, n_max=8, **kw).solve_fused()
    assert res.modes[0].dtype == torch.float32
    sep_res, s_res = S.residual_problem(sep_pc, res)
    delta = S.SeparatedPGD(sep_res, n_max=6, **kw).solve_fused()
    res = S.galerkin_update(sep_pc, S.combine_results(res, delta, s_res))
    vd = Vademecum(Vs, res, dim0_transform=tf, method="torch", dtype=torch.float64,
                   device="cpu")
    grids = _grids(Vs)
    for idx in [(2, 1, 3), (4, 4, 5), (1, 5, 7)]:
        u_ref = fem_truth(sep, Vs, bL, bR, idx)
        u = vd.fields(np.array([[g[i] for g, i in zip(grids, idx)]]))[0].numpy()
        err = np.linalg.norm(u - u_ref) / np.linalg.norm(u_ref)
        assert err < 1e-4, (idx, err)


PTS = np.array([[100.0, 20.0], [450.0, 55.0], [800.0, 90.0], [999.0, 1.0]])


@pytest.fixture(scope="module")
def served(colloc, solved):
    (_, tVs, _), (_, jVs, _) = colloc
    _, jres = solved
    modes = [np.asarray(m) for m in jres.modes]
    tres = result_from_numpy(modes, jres.n_modes, jres.amplitudes, jres.alpha, jres.fp_its)
    jvd = JVademecum(jVs, jres, method="xla", dtype=np.float64)
    tvd = Vademecum(tVs, tres, method="torch", dtype=torch.float64, device="cpu")
    grids = _grids(tVs)
    rng = np.random.default_rng(11)
    samples = np.stack([rng.uniform(g[0], g[-1], 9) for g in grids], axis=1)
    samples[0] = [g[1] for g in grids]  # a grid point
    return jvd, tvd, samples


def test_served_fields_and_vector_sensors(served):
    jvd, tvd, s = served
    _close(tvd.fields(s).numpy(), np.asarray(jvd.fields(jnp.asarray(s))), PREC)
    got = tvd.sensors(PTS)(s).numpy()
    assert got.shape == (len(s), 2 * len(PTS))  # components fastest
    _close(got, np.asarray(jvd.sensors(PTS)(jnp.asarray(s))), PREC)


@pytest.mark.parametrize("kind", ["gradient", "strain", "derivative"])
def test_served_gradient_and_strain(served, kind):
    jvd, tvd, s = served
    tsub, jsub = getattr(tvd, kind)(), getattr(jvd, kind)()
    assert tsub.spaces[0].value_size == jsub.spaces[0].value_size
    np.testing.assert_array_equal(tsub.spaces[0].element_dofs, jsub.spaces[0].element_dofs)
    _close(tsub.fields(s).numpy(), np.asarray(jsub.fields(jnp.asarray(s))), PREC)
    _close(tsub.sensors(PTS)(s).numpy(), np.asarray(jsub.sensors(PTS)(jnp.asarray(s))), PREC)
    if kind == "strain":
        # the Voigt strain of the reconstruction at a sample: its f64
        # gradient's (u_x,x, u_y,y, u_x,y + u_y,x)
        u = Function(tvd.spaces[0], tvd.fields(s[:1])[0].numpy())
        g = gradient_function(u).array.reshape(-1, 4)
        eps = np.stack([g[:, 0], g[:, 3], g[:, 1] + g[:, 2]], axis=1).reshape(-1)
        _close(tsub.fields(s[:1])[0].numpy(), eps, PREC)


def test_served_covariance_and_field_sobol(served):
    jvd, tvd, _ = served
    for a, b in zip(tvd.output_covariance(PTS), jvd.output_covariance(PTS)):
        _close(a, b, PREC)
    t, j = tvd.sobol(), jvd.sobol()
    for key in ("mean", "variance", "first", "total"):
        _close(t[key], j[key], PREC)
    with pytest.raises(ValueError, match="2D vector"):
        tvd.strain().strain()  # a 3-component DG space
