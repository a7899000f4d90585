"""The port's transient outputs against the JAX package's, on the CPU.

``dual.adjoint_problem_nd`` (the space-time adjoint: transposed stacks,
functional factors masked at bc dofs, collocation weights on the
parameter dims), ``dual.rhs_parametric_qoi`` (the exact closed form of
parametric-rhs outputs: one transposed sparse solve a sensor) and
``recipes.transient_goal_oriented`` (adjoint minres cascades verified by
the space-time corrector) in f64.  Host builders agree to 1e-13 and the
closed form to 1e-12; the recipe takes the JAX package's decisions (dual
ranks, stage history) and its corrected errors, per-stage maxima and the
primal's field error agree to rtol 1e-5 (atol 1e-14, the f64 floor).  Not
1e-8: the minres stages solve the normal equations, whose squared
condition number carries the packages' f64 rounding differences into the
fixed points' iterates (their sweep counts part from the sixth dual mode
on even at ``tol_fp`` 1e-7); the measured relative gaps are 1.6e-7 (the
primal's field error) and up to 3.3e-6 (the per-stage maxima).

Run as a script, it recomputes ``TRANSIENT_QOI.json``'s measurement in
both packages on the CPU (``rhs_parametric_qoi`` on the 512 × 256 × 32 × 64
moving heat source, against the true-source space-time FOM) and prints
each package's ``rel_err_max`` beside the record's 2.12e-8 (~2 min):

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_transient_goal.py
"""

import numpy as np

import pytest
import torch

from pgdrome_tpu import dual as JD
from pgdrome_tpu import recipes as JR
from pgdrome_tpu.models import problems as JP

from pgdrome_tpu_torch import dual as TD
from pgdrome_tpu_torch import recipes as TR
from pgdrome_tpu_torch.models import problems as TP

BUILD = 1e-13       # host f64 builders
QOI = 1e-12         # the closed form's weights and outputs
RTOL = 1e-5         # the recipe's errors (corrected, per stage, primal field)
F64_FLOOR = 1e-14   # their absolute floor
HEAT = dict(n_x=24, n_t=16, n_P=4, n_v=5, source_rank=6, af=0.15)
COND = dict(n_x=12, n_t=8, n_p=6, num_params=2)
SENSORS = [(0.55, 0.8), (0.3, 0.5)]
GOAL = dict(n_x=32, n_t=16, n_p=10, num_params=2, bound=5e-7, primal_stages=(20, 12),
            dual_stage1=12, dual_budget=12, max_dual_stages=3, n_random=4, seeds=(7,),
            dtype=np.float64, tol_fp=1e-9)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite's workers share a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(a, b, tol):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-300)


def test_adjoint_problem_nd():
    sj, Vj = JP.transient_parametric_conductivity(**COND)
    st, Vt = TP.transient_parametric_conductivity(**COND)
    rng = np.random.default_rng(3)
    ls = [rng.normal(size=st.sizes[0]), rng.normal(size=st.sizes[1])]
    aj = JD.adjoint_problem_nd(sj, ls, n_fixed=2)
    at = TD.adjoint_problem_nd(st, ls, n_fixed=2)
    for name in ("ops", "rhs", "mass"):
        for a, b in zip(getattr(at, name), getattr(aj, name)):
            _close(a, b, BUILD)
    for a, b in zip(at.bc_dofs, aj.bc_dofs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # the functional is masked at the primal's constrained dofs (t = 0)
    assert (at.rhs[1][0][np.asarray(st.bc_dofs[1])] == 0).all()
    # the one-fixed-dim adjoint is the n_fixed = 1 case
    ej, _ = JP.parametric_elliptic(n_x=16, n_p=6, num_params=2)
    et, _ = TP.parametric_elliptic(n_x=16, n_p=6, num_params=2)
    l0 = rng.normal(size=et.sizes[0])
    for a, b in zip(TD.adjoint_problem(et, l0).rhs, JD.adjoint_problem(ej, l0).rhs):
        _close(a, b, BUILD)
    for bad, match in (
            (dict(l_factors=ls, n_fixed=4), "n_fixed must be in"),
            (dict(l_factors=ls[:1], n_fixed=2), "need 2 functional factors"),
            (dict(l_factors=[ls[0], ls[1][:-1]], n_fixed=2), r"l_factors\[1\] has shape")):
        with pytest.raises(ValueError, match=match):
            TD.adjoint_problem_nd(st, bad["l_factors"], n_fixed=bad["n_fixed"])
        with pytest.raises(ValueError, match=match):
            JD.adjoint_problem_nd(sj, bad["l_factors"], n_fixed=bad["n_fixed"])


@pytest.fixture(scope="module")
def heat():
    return TP.moving_heat_source(**HEAT), JP.moving_heat_source(**HEAT)


def test_rhs_parametric_qoi(heat):
    (st, Vt, _, _), (sj, Vj, _, _) = heat
    qt = TD.rhs_parametric_qoi(st, Vt, SENSORS)
    qj = JD.rhs_parametric_qoi(sj, Vj, SENSORS)
    _close(qt.weights, qj.weights, QOI)
    for zt, zj in zip(qt.adjoints, qj.adjoints):
        _close(zt, zj, QOI)
    P = Vt[2].tabulate_dof_coordinates()[:, 0]
    v = Vt[3].tabulate_dof_coordinates()[:, 0]
    rng = np.random.default_rng(5)
    samples = np.stack([rng.uniform(P[0], P[-1], 16), rng.uniform(v[0], v[-1], 16)], 1)
    samples[:2] = [[P[0], v[0]], [P[-1], v[-1]]]  # the box's ends
    _close(qt(samples), qj(samples), QOI)
    # the one-fixed-dim form reads the time dim as a parameter: its
    # operator is not the mass, so the problem is refused as in the JAX package
    for fn, s, V in ((TD.rhs_parametric_qoi, st, Vt), (JD.rhs_parametric_qoi, sj, Vj)):
        with pytest.raises(ValueError, match="is not the mass"):
            fn(s, V, [0.5], fixed_dims=(0,))
        with pytest.raises(ValueError, match="fixed_dims must be"):
            fn(s, V, SENSORS, fixed_dims=(1,))
        with pytest.raises(ValueError, match="one coordinate per fixed dim"):
            fn(s, V, [(0.5,)])
    with pytest.raises(ValueError, match="expected 2"):
        qt(samples[:, :1])
    with pytest.raises(ValueError, match="leave the parameter box"):
        qt(samples + [[P[-1], 0.0]])


def test_rhs_parametric_qoi_refuses_parametric_operators():
    st, Vt = TP.transient_parametric_conductivity(**COND)
    with pytest.raises(ValueError, match="parameter-dependent"):
        TD.rhs_parametric_qoi(st, Vt, SENSORS)


def test_transient_goal_oriented_f64_parity():
    dj, rj = JR.transient_goal_oriented([0.5, 0.25], **GOAL)
    dt, rt = TR.transient_goal_oriented([0.5, 0.25], device="cpu", **GOAL)

    def close(a, b):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=F64_FLOOR)

    assert rt["primal_rank"] == rj["primal_rank"] and rt["n_verify"] == rj["n_verify"]
    close(rt["primal_field_rel_max"], rj["primal_field_rel_max"])
    for t, j, zt, zj in zip(rt["sensors"], rj["sensors"], dt, dj):
        assert t["x0"] == j["x0"] and t["dual_rank"] == j["dual_rank"] == zt.n_modes
        assert [(h["stage"], h["rank"]) for h in t["history"]] == [
            (h["stage"], h["rank"]) for h in j["history"]]
        close([h["max"] for h in t["history"]], [h["max"] for h in j["history"]])
        for k in ("corrected_best", "corrected_last"):
            close(t[k], j[k])
        # the reference's duplicate of corrected_best is not carried
        assert "corrected_rel_max" not in t and j["corrected_rel_max"] == j["corrected_best"]
    close(rt["max_corrected"], rj["max_corrected"])


def qoi_reference():
    """``TRANSIENT_QOI.json``'s measurement in both packages (see the
    module docstring): the closed form against the true-source FOM at the
    4 box corners and 12 seeded grid points."""
    import json
    from pathlib import Path

    from scipy import sparse as sps
    from scipy.sparse import linalg as spla

    rec = json.loads((Path(__file__).resolve().parent.parent / "TRANSIENT_QOI.json").read_text())
    c = rec["config"]
    out = {"record_rel_err_max": rec["rel_err_max"]}
    for name, P_, D_ in (("jax", JP, JD), ("torch", TP, TD)):
        sep, Vs, _, sep_err = P_.moving_heat_source(
            n_x=c["n_x"], n_t=c["n_t"], n_P=c["n_P"], n_v=c["n_v"],
            source_rank=c["source_rank"], separation="hierarchical", separation_tol=c["sep_tol"])
        qoi = D_.rhs_parametric_qoi(sep, Vs, [tuple(s) for s in rec["sensors"]])
        nt = sep.sizes[1]
        ops0, ops1 = (np.asarray(sep.ops[d], dtype=np.float64) for d in (0, 1))
        A = sum(sps.kron(sps.csr_matrix(ops0[t]), sps.csr_matrix(ops1[t]))
                for t in range(ops0.shape[0])).tolil()
        ic = [ix * nt for ix in range(sep.sizes[0])]
        for rr in ic:
            A.rows[rr] = [rr]
            A.data[rr] = [1.0]
        lu = spla.splu(A.tocsr().tocsc())
        Mx, Mt = np.asarray(sep.mass[0]), np.asarray(sep.ops[1][1])
        x, tg, Pg, vg = (V.tabulate_dof_coordinates()[:, 0] for V in Vs)
        ls = [np.kron(D_.point_functional(Vs[0], a), D_.point_functional(Vs[1], b))
              for a, b in rec["sensors"]]
        rng = np.random.default_rng(0)
        rng.uniform(size=400_000)  # the script's serving batch comes first
        pairs = [(0, 0), (0, len(vg) - 1), (len(Pg) - 1, 0), (len(Pg) - 1, len(vg) - 1)]
        pairs += [(int(rng.integers(1, len(Pg) - 1)), int(rng.integers(1, len(vg) - 1)))
                  for _ in range(rec["n_verify"] - 4)]
        s = qoi(np.array([[Pg[i], vg[j]] for i, j in pairs]))
        s_true = np.zeros_like(s)
        for k, (ip, iv) in enumerate(pairs):
            g = np.exp(-((x[:, None] - 0.15 - vg[iv] * tg[None, :]) ** 2) / 0.08 ** 2)
            b = Pg[ip] * (Mx @ g @ Mt.T).ravel()
            b[ic] = 0.0
            u = lu.solve(b)
            s_true[k] = [l @ u for l in ls]
        rel = np.abs(s - s_true) / np.abs(s_true).max(axis=0)[None, :]
        out[name] = {"rel_err_max": float(rel.max()), "separation_floor": float(sep_err)}
    out["gap"] = abs(out["torch"]["rel_err_max"] - out["jax"]["rel_err_max"])
    return out


if __name__ == "__main__":
    import json

    import jax

    jax.config.update("jax_enable_x64", True)
    print(json.dumps(qoi_reference()))
