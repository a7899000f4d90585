"""End-to-end solver recipes (counterpart of ``pgdrome_tpu/recipes.py``:
``_to_nodal``, ``residual_cascade``, ``adaptive_cascade``,
``two_stage_elliptic``, ``two_stage_minres``, ``adaptive_minres``,
``highd_frontier``, ``goal_oriented_frontier``,
``transient_goal_oriented``, ``nonlinear_vademecum``).

:func:`two_stage_elliptic` is the north-star vademecum pipeline: an
energy-basis f32 greedy stage on the device, f64-exact residual restarts
formed on the host and re-solved on the device, CP-ALS compression to the
deployed rank and a Galerkin update, both in host f64.
:func:`adaptive_cascade` drives residual restarts until a verified bound
(boosted, corner-seeded and compensated stages where the errors ask for
them), and :func:`highd_frontier` packages it for the d-parameter elliptic
vademecum: dense FEM verification below 8 parameters, the residual
screener's (:func:`screened_verification`, :func:`screened_final`) from
8 on, and optionally the anchored-ANOVA start (:mod:`.anova`).
:func:`goal_oriented_frontier` certifies outputs with adjoint
vademecums (:mod:`.dual`); :func:`two_stage_minres` and
:func:`adaptive_minres` train the transient (non-symmetric) family on the
normal equations, and :func:`transient_goal_oriented` certifies its outputs
with backward-in-time adjoint cascades.  :func:`nonlinear_vademecum` solves
the cubic elliptic family by outer Picard iterations of linear cascades.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from pgdrome_tpu_torch.config import get_device, use_full_f32_matmul
from pgdrome_tpu_torch.separated import (
    PGDResult,
    SeparatedPGD,
    SeparatedProblem,
    combine_results,
    compress_modes,
    galerkin_update,
    host_f64,
    ne_dim_base,
    normal_equations,
    pad_rhs_bucket,
    precondition_dim,
    precondition_dim0,
    residual_problem,
)

use_full_f32_matmul()


def _to_nodal(res: PGDResult, transforms) -> PGDResult:
    """Back-transform each congruence-preconditioned dim to its nodal
    basis (host f64)."""
    modes = [host_f64(m) for m in res.modes]
    for tf in transforms:
        modes[tf.dim] = tf.modes_to_full(res.modes[tf.dim])
    return PGDResult(modes=modes, n_modes=res.n_modes,
                     amplitudes=res.amplitudes, alpha=res.alpha,
                     fp_its=res.fp_its, normU0=res.normU0)


def residual_cascade(problem_pc: SeparatedProblem, budgets,
                     tol_fp: float = 1e-7, solver: str = "cg",
                     cg_iters: int = 25, dtype=np.float32,
                     stage_problems=None, rhs_bucket: int | None = None,
                     rhs_f64: bool = False, rhs_comp: bool = False,
                     rhs_comp_from: int | None = None, device="cuda"):
    """Multi-stage floor-restarted greedy solve on an (already
    preconditioned) host problem: stage 1 solves ``budgets[0]`` modes
    (40 fp sweeps at ``tol_fp``); each further budget forms the f64-exact
    residual rhs on the host (:func:`residual_problem`) and re-solves it
    with the loose 8-sweep fixed point (``tol_fp`` 1e-5).  The restarts
    stack.

    ``stage_problems``: optional {stage index (2-based) → problem} whose
    residual a stage solves (late-stage corner boosting: same operators per
    grid point, so the solution is unchanged).  ``rhs_bucket``: pad each
    residual rhs stack with zero rows to a multiple of this
    (:func:`pad_rhs_bucket`), as ``bench.py`` does; None (the default)
    leaves the stacks as they are.  ``rhs_f64`` / ``rhs_comp``: every
    stage keeps its rhs stack in f64 / compensated double-f32 on the device
    (:class:`SeparatedPGD`); ``rhs_comp_from``: ``rhs_comp`` from this
    1-based stage on (the early stages are not cancellation-bound).
    Returns the combined (uncompressed) result in ``problem_pc``'s basis,
    its modes on ``device``."""
    def common(si):
        comp = rhs_comp or (rhs_comp_from is not None and si >= rhs_comp_from)
        return dict(tol=0.0, solver=solver, cg_iters=cg_iters, residual_check=False,
                    dtype=dtype, rhs_f64=rhs_f64, rhs_comp=comp, device=device)

    res = SeparatedPGD(problem_pc, n_max=budgets[0], tol_fp=tol_fp,
                       max_fp_it=40, **common(1)).solve_fused()
    for si, b in enumerate(budgets[1:], start=2):
        prob_s = (stage_problems or {}).get(si, problem_pc)
        sep_res, s_res = residual_problem(prob_s, res)
        if rhs_bucket:
            sep_res = pad_rhs_bucket(sep_res, rhs_bucket)
        delta = SeparatedPGD(sep_res, n_max=b, tol_fp=1e-5, max_fp_it=8,
                             **common(si)).solve_fused()
        res = combine_results(res, delta, s_res)
    return res


def adaptive_cascade(problem_pc: SeparatedProblem, verify, *,
                     bound: float = 1e-6, n_stage1: int = 128,
                     stage_budget: int = 128, max_stages: int = 12,
                     boost_problem: SeparatedProblem | None = None,
                     boost_margin: float = 2.0,
                     rhs_comp="auto", rhs_comp_below: float = 1e-5,
                     stall_stages: int = 3,
                     tol_fp: float = 1e-7, solver: str = "cg",
                     cg_iters: int = 25, dtype=np.float32, log=None,
                     init_result: PGDResult | None = None,
                     checkpoint=None,
                     corner_seed_range=None, seed_max_fp_it: int = 20,
                     seed_always: bool = False,
                     rhs_bucket: int | None = None,
                     minutes: float | None = None, metrics=None,
                     device="cuda"):
    """Error-driven residual cascade: solve until a verified bound, not a
    fixed stage list.

    * After every stage the Galerkin-updated result is verified through
      ``verify``; the cascade itself continues from the raw combination.
    * While the corners bind (corner error above ``bound`` and more than
      ``boost_margin`` × the interior error) and a ``boost_problem`` is
      given, the next stage's residual targets that corner-boosted
      measure, and reverts to the plain one as soon as the corners clear.
    * ``rhs_comp``: True/False forces the compensated double-f32 rhs
      contraction of the stages after the first; ``"auto"`` engages it
      once the error is below ``rhs_comp_below`` (and ``dtype`` is not
      f64).
    * ``corner_seed_range=(p_lo, p_hi)``: boosted stages (every stage with
      corners above ``bound`` when ``seed_always``) are corner-seeded —
      each new mode's fixed point starts at one of the verifier's
      ``worst_points``, re-ranked by ``worst_errors`` — and run through
      :meth:`SeparatedPGD.solve` with at most ``seed_max_fp_it`` sweeps.
    * Stops at ``bound``, at ``max_stages``, after ``minutes``, or when the
      best verified error has not improved for ``stall_stages`` stages.

    ``verify(result) -> float | {"corners", "interior", ...}`` (a float
    counts as both).  ``init_result``: a raw combination to continue from
    (stage 1 then only verifies it).  ``checkpoint(stage_dict,
    raw_result)`` runs after each stage's verification.  ``rhs_bucket``:
    pad each residual rhs stack with zero rows to a multiple of this.
    ``metrics``: a :class:`~pgdrome_tpu_torch.utils.profiling.StageMetrics`
    that receives each stage's residual-build, solve, Galerkin and
    verification seconds and its fp sweeps.  The solves run on
    ``device``.  Returns ``(best_result, history)``: the best
    Galerkin-updated result seen (not the last) and one dict per stage."""
    from pgdrome_tpu_torch.models.problems import corner_seeded_init
    from pgdrome_tpu_torch.utils.profiling import StageMetrics

    device = get_device(device)
    metrics = metrics if metrics is not None else StageMetrics(device)

    def common(comp):
        return dict(tol=0.0, solver=solver, cg_iters=cg_iters,
                    residual_check=False, dtype=dtype, rhs_comp=comp,
                    device=device)

    def _split(v):
        if isinstance(v, dict):
            return float(v["corners"]), float(v["interior"])
        return float(v), float(v)

    say = log or (lambda *a: None)
    history = []
    best_err, best_res, best_stage = np.inf, None, 0
    corners = interior = np.inf
    worst_pts = None
    res = None
    t_start = time.perf_counter()
    for si in range(1, max_stages + 1):
        if (
            minutes is not None
            and si > 1
            and time.perf_counter() - t_start > minutes * 60.0
        ):
            say(f"adaptive cascade: {minutes:.0f} min budget reached at "
                f"stage {si - 1}, best {best_err:.2e}")
            break
        t0 = time.perf_counter()
        row = metrics.stage(si)
        boosted = comp = seeded = False
        if si == 1:
            if init_result is not None:
                res = init_result
                row["fp_its"] = np.zeros(0, dtype=np.int64)
            else:
                with metrics.timed(row, "solve_s"):
                    res = SeparatedPGD(
                        problem_pc, n_max=n_stage1, tol_fp=tol_fp,
                        max_fp_it=40, **common(False)).solve_fused()
                row["fp_its"] = np.asarray(res.fp_its)
        else:
            boosted = (
                boost_problem is not None
                and corners > bound
                and corners > boost_margin * interior
            )
            prob_s = boost_problem if boosted else problem_pc
            if isinstance(rhs_comp, bool):
                comp = rhs_comp
            else:  # "auto": engage in the cancellation-bound region
                comp = (
                    max(corners, interior) < rhs_comp_below
                    and np.dtype(dtype) != np.float64
                )
            with metrics.timed(row, "residual_s"):
                sep_res, s_res = residual_problem(prob_s, res)
                if rhs_bucket:
                    sep_res = pad_rhs_bucket(sep_res, rhs_bucket)
            row["rhs_rows"] = sep_res.num_rhs
            seeded = (
                # seed_always: corner-seeded fixed points on the plain
                # measure while the remaining error is corner-localized
                (boosted or (seed_always and corners > bound))
                and corner_seed_range is not None
                and worst_pts is not None
                and len(worst_pts) > 0
            )
            with metrics.timed(row, "solve_s"):
                if seeded:
                    lo, hi = corner_seed_range
                    delta = SeparatedPGD(
                        sep_res, n_max=stage_budget, tol_fp=1e-5,
                        max_fp_it=seed_max_fp_it,
                        fp_init=corner_seeded_init(
                            np.asarray(worst_pts)[:stage_budget], lo, hi
                        ),
                        **common(comp),
                    ).solve()
                else:
                    delta = SeparatedPGD(
                        sep_res, n_max=stage_budget, tol_fp=1e-5,
                        max_fp_it=8, **common(comp),
                    ).solve_fused()
            row["fp_its"] = np.asarray(delta.fp_its)
            res = combine_results(res, delta, s_res)
        with metrics.timed(row, "galerkin_s"):
            res_g = galerkin_update(problem_pc, res)
        with metrics.timed(row, "verify_s"):
            v = verify(res_g)
        corners, interior = _split(v)
        if isinstance(v, dict) and "worst_points" in v:
            worst_pts = np.asarray(v["worst_points"])
            worst_errs = np.asarray(v.get("worst_errors", []))
            if worst_errs.shape[:1] == worst_pts.shape[:1]:
                worst_pts = worst_pts[np.argsort(worst_errs)[::-1]]
        mx = max(corners, interior)
        entry = {
            "stage": si, "rank": res.n_modes, "corners": corners,
            "interior": interior, "max": mx, "boosted": boosted,
            "seeded": seeded,
            "rhs_comp": comp, "stage_s": round(time.perf_counter() - t0, 2),
        }
        if isinstance(v, dict):
            # the audit trail of a screened verification, where present
            for audit_key in ("screened", "eta", "measured_max",
                              "estimated_max"):
                if audit_key in v:
                    entry[audit_key] = v[audit_key]
        history.append(entry)
        say(f"adaptive stage {si}: rank {res.n_modes} corners {corners:.2e} "
            f"interior {interior:.2e}"
            + (" [boost]" if boosted else "")
            + (" [seeded]" if seeded else "")
            + (" [dd]" if comp else ""))
        if checkpoint is not None:
            checkpoint(history[-1], res)
        if mx < best_err:
            best_err, best_res, best_stage = mx, res_g, si
        if mx < bound:
            break
        if si - best_stage >= stall_stages:
            say(f"adaptive cascade stalled: best {best_err:.2e} at stage "
                f"{best_stage}, no improvement for {stall_stages} stages")
            break
    return best_res, history


def two_stage_elliptic(sep: SeparatedProblem, n_stage1: int = 64,
                       n_stage2: int = 48, n_deploy: int | None = 50,
                       tol_fp: float = 1e-7, solver: str = "cg",
                       cg_iters: int = 25, dtype=np.float32,
                       extra_stages=(), stage_problems=None,
                       rhs_bucket: int | None = None, device="cuda"):
    """The elliptic vademecum pipeline (``bench.py``).

    sep: the host-f64 separated problem (the builders' convention); dim 0
    is congruence-preconditioned here.  Stages: f32 greedy (``n_stage1``)
    → f64-exact residual restart re-solved with ``n_stage2`` modes →
    further restarts (``extra_stages`` budgets) → CP-ALS compression to
    ``n_deploy`` in the boosted collocation metric (None/0 disables) →
    Galerkin update.  ``stage_problems`` and ``rhs_bucket`` as in
    :func:`residual_cascade` (stage problems in this recipe's transformed
    basis).  Returns ``(result, tf)``: the result's dim-0 modes are in the
    transformed basis (``Vademecum(..., dim0_transform=tf)`` takes them);
    its modes are tensors on ``device``."""
    device = get_device(device)  # raise before the host work, not after
    sep_pc, tf = precondition_dim(sep, dim=0, dtype=np.float64)
    res = residual_cascade(
        sep_pc, (n_stage1, n_stage2) + tuple(extra_stages), tol_fp=tol_fp,
        solver=solver, cg_iters=cg_iters, dtype=dtype,
        stage_problems=stage_problems, rhs_bucket=rhs_bucket, device=device,
    )
    if n_deploy and res.n_modes > n_deploy:
        mass_c = [sep_pc.mass[0]] + [
            sep_pc.ops[j][0] for j in range(1, sep_pc.num_dims)
        ]
        res = compress_modes(res, mass_c, n_deploy, n_iters=20)
    res = galerkin_update(sep_pc, res)
    return res, tf


def two_stage_minres(sep: SeparatedProblem, n_stage1: int = 128,
                     n_stage2: int = 64, precondition_dims=(0, 1),
                     tol_fp: float = 1e-6, max_fp_it: int = 50,
                     dtype=np.float32, extra_stages=(), rhs_comp: bool = False,
                     device="cuda"):
    """The transient (non-symmetric) minimal-residual pipeline.

    ``sep``: the host-f64 separated problem.  Greedy Galerkin has no
    minimisation principle on non-symmetric operators (upwind time), so
    each stage solves the normal equations in the f32-stable recipe
    (:func:`_minres_stage`: diag-sum congruence bases on
    ``precondition_dims``, mid-sweep Euclidean renormalisation, Cholesky
    solves) on ``device``, and an f64-exact residual re-solve restarts the
    f32 amplitude floor.  ``extra_stages``: further restart budgets (each
    f64 restart attacks the previous stage's own f32 floor).
    ``rhs_comp``: contract the residual stages' rhs stacks in
    double-f32 (their rescaled rows cancel in the load contraction);
    stage 1 stays plain.  Returns the combined, Galerkin-updated result in
    nodal bases for every dim."""
    device = get_device(device)
    res = _minres_stage(sep, n_stage1, precondition_dims, tol_fp, max_fp_it, dtype,
                        False, device)
    for b in (n_stage2,) + tuple(extra_stages):
        sep_res, s_res = residual_problem(sep, res)
        delta = _minres_stage(sep_res, b, precondition_dims, tol_fp, max_fp_it, dtype,
                              rhs_comp, device)
        res = combine_results(res, delta, s_res)
    return galerkin_update(sep, res)


def _minres_stage(problem, n_max, precondition_dims, tol_fp, max_fp_it, dtype, comp,
                  device):
    """One f32-stable minimal-residual stage: the normal equations, the
    diag-sum congruence bases (:func:`~pgdrome_tpu_torch.separated.ne_dim_base`)
    on ``precondition_dims``, mid-sweep renormalisation and Cholesky
    solves, the result mapped back to nodal bases."""
    ne = normal_equations(problem)
    tfs = []
    for d in precondition_dims:
        ne, tfd = precondition_dim(ne, dim=d, dtype=np.float64,
                                   base=ne_dim_base(problem, d))
        tfs.append(tfd)
    # the fixed-point cap, not tol_fp, sets the stage's time: the f32
    # relative stop's floor is above 1e-5
    s = SeparatedPGD(ne, n_max=n_max, tol=0.0, tol_fp=tol_fp, max_fp_it=max_fp_it,
                     solver="chol", residual_check=False, dtype=dtype,
                     renorm_sweep=True, rhs_comp=comp, device=device)
    return _to_nodal(s.solve_fused(), tfs)


def adaptive_minres(sep: SeparatedProblem, verify, *,
                    bound: float = 1e-6, n_stage1: int = 128,
                    stage_budget: int = 128, max_stages: int = 12,
                    precondition_dims=(0, 1),
                    rhs_comp="auto", rhs_comp_below: float = 1e-4,
                    stall_stages: int = 3, tol_fp: float = 1e-6,
                    max_fp_it: int = 50, dtype=np.float32,
                    rhs_bucket: int | None = None, log=None,
                    init_result: PGDResult | None = None,
                    checkpoint=None, device="cuda"):
    """Error-driven transient cascade: :func:`two_stage_minres`'s restart
    stacking continued until a verified bound (the minres counterpart of
    :func:`adaptive_cascade`).

    Restart stacking is the lever above ~1e-4; compensated dd rhs stages
    hurt there but are needed once the ~1.5e-6 rhs-cancellation floor
    appears, so ``rhs_comp="auto"`` engages dd only below
    ``rhs_comp_below`` (1e-4 here, not :func:`adaptive_cascade`'s 1e-5;
    True/False force it).  Each stage's Galerkin-updated span is verified
    (``verify``, e.g. :func:`~pgdrome_tpu_torch.models.problems.transient_dense_verifier`:
    true-source by default, so the bound includes the source-separation
    truncation); the cascade continues from the raw combination.
    ``verify`` / ``init_result`` / ``checkpoint`` / ``stall_stages`` as in
    :func:`adaptive_cascade`; the solves run on ``device``.  Returns
    ``(best_result, history)`` with nodal-basis results."""
    device = get_device(device)

    def _split(v):
        if isinstance(v, dict):
            return float(v["corners"]), float(v["interior"])
        return float(v), float(v)

    say = log or (lambda *a: None)
    history = []
    best_err, best_res, best_stage = np.inf, None, 0
    corners = interior = np.inf
    res = None
    for si in range(1, max_stages + 1):
        t0 = time.perf_counter()
        comp = False
        if si == 1:
            res = init_result if init_result is not None else _minres_stage(
                sep, n_stage1, precondition_dims, tol_fp, max_fp_it, dtype, False, device)
        else:
            if isinstance(rhs_comp, bool):
                comp = rhs_comp
            else:  # "auto": dd only in the cancellation-bound region
                comp = (max(corners, interior) < rhs_comp_below
                        and np.dtype(dtype) != np.float64)
            sep_res, s_res = residual_problem(sep, res)
            if rhs_bucket:
                sep_res = pad_rhs_bucket(sep_res, rhs_bucket)
            delta = _minres_stage(sep_res, stage_budget, precondition_dims, tol_fp,
                                  max_fp_it, dtype, comp, device)
            res = combine_results(res, delta, s_res)
        res_g = galerkin_update(sep, res)
        v = verify(res_g)
        corners, interior = _split(v)
        mx = max(corners, interior)
        entry = {"stage": si, "rank": res.n_modes, "corners": corners,
                 "interior": interior, "max": mx, "rhs_comp": comp,
                 "stage_s": round(time.perf_counter() - t0, 2)}
        if isinstance(v, dict):
            for audit_key in ("screened", "eta", "measured_max", "estimated_max"):
                if audit_key in v:
                    entry[audit_key] = v[audit_key]
        history.append(entry)
        say(f"adaptive minres stage {si}: rank {res.n_modes} corners {corners:.2e} "
            f"interior {interior:.2e}" + (" [dd]" if comp else ""))
        if checkpoint is not None:
            checkpoint(history[-1], res)
        if mx < best_err:
            best_err, best_res, best_stage = mx, res_g, si
        if mx < bound:
            break
        if si - best_stage >= stall_stages:
            say(f"adaptive minres stalled: best {best_err:.2e} at stage {best_stage}, "
                f"no improvement for {stall_stages} stages")
            break
    return best_res, history


def frontier_setup(num_params, boost, *, n_x=1024, n_p=128):
    """The frontier's host build on one boundary measure:
    ``parametric_elliptic(n_x, n_p, num_params, degree_x=2,
    boundary_boost=boost)`` preconditioned in host f64, through
    :func:`~pgdrome_tpu_torch.utils.setup_cache.cached_setup` (off unless
    ``$PGDROME_SETUP_CACHE`` is set).  Returns ``((sep_pc64, tf), status)``."""
    import warnings

    from pgdrome_tpu_torch.fem.assembly import load_vector, stiffness_matrix
    from pgdrome_tpu_torch.models.problems import parametric_elliptic
    from pgdrome_tpu_torch.utils.setup_cache import cached_setup

    def _build():
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*boundary_boost compounds.*")
            sep64, _ = parametric_elliptic(n_x=n_x, n_p=n_p, num_params=num_params,
                                           degree_x=2, boundary_boost=boost)
        return precondition_dim0(sep64, dtype=np.float64)

    return cached_setup(
        _build, key_data=["torch_probe5_build_v1", n_x, n_p, num_params, boost],
        code_objects=(parametric_elliptic, stiffness_matrix, load_vector),
    )


def frontier_anova_start(num_params, tf, *, order=2, n_x=1024, n_p=128, tol_pair=2e-7,
                         log=None):
    """The frontier's anchored-ANOVA start (:func:`highd_frontier`'s
    ``anova_order``): :func:`~pgdrome_tpu_torch.anova.anova_init` of the
    nodal build with its dim-0 factors in the basis of ``tf`` (the base
    build's transform), through
    :func:`~pgdrome_tpu_torch.utils.setup_cache.cached_setup` under its own
    key (off unless ``$PGDROME_SETUP_CACHE`` is set).  Returns
    ``((init_result, report), status)``."""
    from pgdrome_tpu_torch.anova import anova_init
    from pgdrome_tpu_torch.models.problems import parametric_elliptic
    from pgdrome_tpu_torch.utils.setup_cache import cached_setup

    def _build():
        sep_nodal, _ = parametric_elliptic(n_x=n_x, n_p=n_p, num_params=num_params, degree_x=2)
        return anova_init(sep_nodal, order=order, tf=tf, tol_pair=tol_pair, log=log)

    return cached_setup(
        _build, key_data=["torch_anova_init_v1", n_x, n_p, num_params, order, tol_pair],
        code_objects=(anova_init, parametric_elliptic))


def frontier_spaces(num_params, *, n_x=1024, n_p=128):
    """The frontier's spaces: P2 on ``n_x`` cells, then ``num_params`` P1
    parameter spaces on ``n_p`` cells, all on [0, 1]."""
    from pgdrome_tpu_torch.fem.mesh import IntervalMesh
    from pgdrome_tpu_torch.fem.space import FunctionSpace

    return [FunctionSpace(IntervalMesh(n_x, 0.0, 1.0), "P", 2)] + [
        FunctionSpace(IntervalMesh(n_p, 0.0, 1.0), "P", 1) for _ in range(num_params)]


def screened_verification(sep_base, Vs, verifier, *, max_rank, screen_top_k=32,
                          screener_cap=3072, n_screen_edges=2048, log=None,
                          device="cuda"):
    """The frontier's screened verification for high parameter counts
    (``highd_frontier`` from ``screen_from`` parameters on): the f32
    residual screener (:func:`~pgdrome_tpu_torch.parallel.certify.
    make_screener` on ``sep_base``, its mode cap the larger of
    ``screener_cap`` and ``max_rank`` rounded up to 128) ranks all 2^d
    inset corners plus ``n_screen_edges`` edge/face candidates, and
    :func:`~pgdrome_tpu_torch.parallel.certify.screened_verify` measures the
    worst ``screen_top_k`` with the dense ``verifier``'s FEM and 32 interior
    points always.  The edge candidates and the interior points are drawn
    from ``default_rng(424242)`` as the JAX package draws them, in the same
    order.  Returns a namespace: ``verify`` (for
    :func:`adaptive_cascade`), ``screen``, ``verifier``, ``corners``,
    ``edge_cands``, ``interior``, ``screen_top_k``."""
    from types import SimpleNamespace

    from pgdrome_tpu_torch.models.problems import box_corners
    from pgdrome_tpu_torch.parallel.certify import make_screener, screened_verify

    num_params = len(Vs) - 1
    grid = Vs[1].tabulate_dof_coordinates()[:, 0]
    lo, hi = grid[1], grid[-2]
    corners = box_corners(lo, hi, num_params)
    rng = np.random.default_rng(424242)
    edge_cands = grid[rng.integers(1, len(grid) - 1, size=(n_screen_edges, num_params))]
    for r in range(n_screen_edges):
        k = int(rng.integers(1, num_params))
        dims = rng.choice(num_params, size=k, replace=False)
        edge_cands[r, dims] = np.where(rng.integers(0, 2, size=k) == 0, lo, hi)
    interior = grid[rng.integers(1, len(grid) - 1, size=(32, num_params))]
    # the cap covers the deepest rank the run can reach: an overflow
    # would raise inside verify, mid-cascade
    cap = max(int(screener_cap), -(-int(max_rank) // 128) * 128)
    screen = make_screener(sep_base, Vs, n_modes_cap=cap, device=device)
    verify = screened_verify(
        screen, verifier.sample_errors, np.concatenate([corners, edge_cands]),
        top_k=screen_top_k, safety=1.5, interior_samples=interior, log=log,
    )
    return SimpleNamespace(verify=verify, screen=screen, verifier=verifier,
                           corners=corners, edge_cands=edge_cands, interior=interior,
                           screen_top_k=screen_top_k)


def screened_final(sv, best, final_fem_corners=1024):
    """The screened run's final confirmation of ``best``
    (:func:`screened_verification`'s namespace ``sv``): FEM at the
    ``final_fem_corners`` worst-screened corners and at the worst
    ``screen_top_k`` edge candidates, 1.5×-safety η estimates for the
    unmeasured rest of each, FEM at the 32 interior points.  Returns
    ``(final, measured)``: ``final`` the report's keys, its ``max`` over
    every measured maximum and estimate; ``measured`` the FEM-measured
    corner and edge points with their screen values and errors."""
    final = {}
    corners, edge_cands, top_k = sv.corners, sv.edge_cands, sv.screen_top_k
    rs = sv.screen(best, corners)
    k = min(final_fem_corners, len(corners))
    order = np.argsort(rs)
    worst = corners[order[-k:]]
    t0 = time.perf_counter()
    te = sv.verifier.sample_errors(best, worst)
    final["corners_fem_max"] = float(te.max())
    final["corners_fem_n"] = int(k)
    final["corners_fem_s"] = round(time.perf_counter() - t0, 1)
    if k < len(corners):
        eta = 1.5 * float((te / np.maximum(rs[order[-k:]], 1e-300)).max())
        final["corners_rest_estimate"] = float(eta * rs[order[:-k]].max())
    ev = sv.screen(best, edge_cands)
    e_order = np.argsort(ev)
    worst_e = edge_cands[e_order[-top_k:]]
    te_e = sv.verifier.sample_errors(best, worst_e)
    final["edges_fem_max"] = float(te_e.max())
    final["edges_fem_n"] = int(len(worst_e))
    if top_k < len(edge_cands):
        # the unmeasured edge candidates get an η estimate too: the f32
        # screener can under-rank a pocket
        eta_e = 1.5 * float((te_e / np.maximum(ev[e_order[-top_k:]], 1e-300)).max())
        final["edges_rest_estimate"] = float(eta_e * ev[e_order[:-top_k]].max())
    final["interior_fem_max"] = float(sv.verifier.sample_errors(best, sv.interior).max())
    final["max"] = max(final.get(key, 0.0) for key in (
        "corners_fem_max", "edges_fem_max", "interior_fem_max",
        "corners_rest_estimate", "edges_rest_estimate"))
    measured = {"corners": (worst, rs[order[-k:]], te),
                "edges": (worst_e, ev[e_order[-top_k:]], te_e)}
    return final, measured


def highd_frontier(num_params, *, bound=1e-6, n_x=1024, n_p=128,
                   n_stage1=128, stage_budget=128, max_stages=24,
                   minutes=None, base_boost=(8.0, 6),
                   window_boost=(16.0, 6), boost_margin=1.2, n_edge=16,
                   screen_from=8, screen_top_k=32, screener_cap=3072,
                   n_screen_edges=2048, final_fem_corners=1024,
                   state_path=None, init_result=None, dtype=np.float32,
                   log=None, artifact_path=None, anova_order=0,
                   anova_tol_pair=2e-7, seed_always=False, metrics=None,
                   device="cuda"):
    """The dimensionality-frontier drive: build the ``num_params``-parameter
    elliptic vademecum (``parametric_elliptic(n_x, n_p, num_params,
    degree_x=2)`` preconditioned in host f64, once on the ``base_boost``
    measure and once on the stronger ``window_boost`` one), run
    :func:`adaptive_cascade` with the frontier's discipline — corner-boosted
    and corner-seeded stages while the corners bind, compensated dd rhs
    stacks padded to 4096 rows from stage 2 on — and verify the best result
    against per-sample f64 FEM.

    * Verification below ``screen_from`` parameters: all 2^d inset
      corners, ``n_edge`` edge points and 16 interior points for each of 4
      seeds, every stage and at the end.  From ``screen_from`` on:
      :func:`screened_verification` each stage, and at the end
      :func:`screened_final` (FEM at the ``final_fem_corners``
      worst-screened corners and the worst ``screen_top_k`` edges, η
      estimates for the rest, all counted in the claimed max).
    * ``anova_order`` (1 or 2): start from the anchored-ANOVA surrogate
      (:func:`~pgdrome_tpu_torch.anova.anova_init` of the nodal build,
      ``anova_tol_pair``, dim-0 factors in the base build's basis, through
      the setup cache under its own key) instead of a stage-1 solve; stage
      1 then verifies it, and ``report["anova"]`` is its report.

    Returns ``(best_result, report)``; the report (the JAX package's keys)
    carries the verified maxima, the rank and the per-stage history, and
    is written as JSON to ``artifact_path``.  A run resumed through
    ``init_result`` extends that artifact's history and wall time.
    ``state_path``: after every stage the raw combination is saved there
    (``m0 … m{d}``, ``n_modes``, ``amplitudes``, ``alpha``, ``fp_its``,
    ``normU0``, ``stage``; :func:`~pgdrome_tpu_torch.convert.load_state_npz`
    reads it).  The host builds go through
    :func:`~pgdrome_tpu_torch.utils.setup_cache.cached_setup` (off unless
    ``$PGDROME_SETUP_CACHE`` is set).  ``metrics``: as in
    :func:`adaptive_cascade`."""
    from pgdrome_tpu_torch.models.problems import box_corners, elliptic_dense_verifier

    device = get_device(device)  # raise before the host builds, not after
    say = log or (lambda *a: None)
    t_run0 = time.perf_counter()

    builds = []
    for boost in (tuple(base_boost), tuple(window_boost)):
        build, status = frontier_setup(num_params, boost, n_x=n_x, n_p=n_p)
        say(f"setup cache {status} (boost {boost})")
        builds.append(build)
    (sep_base, tf), (sep_boost, _) = builds

    anova_report = None
    if anova_order and init_result is None:
        # the anchored-ANOVA start: the near-additive solution's axis and
        # pair structure built exactly, so the cascade enriches only the
        # interaction remainder
        (init_result, anova_report), status = frontier_anova_start(
            num_params, tf, order=anova_order, n_x=n_x, n_p=n_p, tol_pair=anova_tol_pair,
            log=say)
        say(f"anova init cache {status}: order {anova_order} "
            f"rank {init_result.n_modes}")

    Vs = frontier_spaces(num_params, n_x=n_x, n_p=n_p)
    grid = Vs[1].tabulate_dof_coordinates()[:, 0]
    lo, hi = grid[1], grid[-2]
    corners = box_corners(lo, hi, num_params)
    screened = num_params >= screen_from
    verifier = elliptic_dense_verifier(
        Vs, tf, n_random=16, seeds=(7, 101, 1234, 777),
        corner_cap=(2 if screened else None), n_edge=(0 if screened else n_edge),
    )
    verify = verifier
    if screened:
        start_rank = init_result.n_modes if init_result is not None else 0
        max_rank = (start_rank + (0 if start_rank else n_stage1)
                    + stage_budget * max_stages)
        sv = screened_verification(
            sep_base, Vs, verifier, max_rank=max_rank, screen_top_k=screen_top_k,
            screener_cap=screener_cap, n_screen_edges=n_screen_edges, log=say,
            device=device)
        verify = sv.verify

    def checkpoint(stage_line, raw):
        say(json.dumps({k: v for k, v in stage_line.items()
                        if not isinstance(v, np.ndarray)}))
        if state_path:
            arrs = {f"m{d}": host_f64(raw.modes[d])
                    for d in range(1 + num_params)}
            np.savez(state_path, n_modes=raw.n_modes,
                     amplitudes=np.asarray(raw.amplitudes),
                     alpha=np.asarray(raw.alpha),
                     fp_its=np.asarray(raw.fp_its),
                     normU0=raw.normU0,
                     stage=int(stage_line["stage"]), **arrs)

    best, history = adaptive_cascade(
        sep_base, verify, bound=bound, n_stage1=n_stage1,
        stage_budget=stage_budget, max_stages=max_stages,
        boost_problem=sep_boost, boost_margin=boost_margin,
        rhs_comp=True, dtype=dtype, log=say,
        init_result=init_result, checkpoint=checkpoint,
        corner_seed_range=(lo, hi), rhs_bucket=4096,
        seed_always=seed_always, minutes=minutes, metrics=metrics,
        device=device,
    )

    # final verification of the best result: measured, corner-inclusive
    if screened:
        final, _ = screened_final(sv, best, final_fem_corners)
    else:
        v = verifier(best)
        final = {
            "corners_fem_max": float(v["corners"]),
            "corners_fem_n": int(len(corners)),
            "interior_fem_max": float(v["interior"]),
        }
        final["max"] = max(final["corners_fem_max"], final["interior_fem_max"])

    # a resumed leg extends the prior artifact's history, so the written
    # JSON carries the whole error-vs-rank record
    prior_hist, prior_wall, leg = [], 0.0, 1
    if (artifact_path and init_result is not None
            and os.path.exists(artifact_path)):
        try:
            with open(artifact_path) as f:
                prev = json.load(f)
            prior_hist = prev.get("history", [])
            prior_wall = float(prev.get("wall_s", 0.0))
            leg = int(prev.get("legs", 1)) + 1
        except (OSError, ValueError):  # unreadable: start a fresh record
            pass

    report = {
        "num_params": int(num_params),
        "n_x": int(n_x), "n_p": int(n_p),
        "bound_target": float(bound),
        "rank": int(best.n_modes),
        "anova": anova_report,
        "verified": final,
        "screened_verification": bool(screened),
        "legs": leg,
        "history": prior_hist + [
            dict({k: (float(v)
                      if isinstance(v, (int, float, np.floating))
                      else v)
                  for k, v in h.items()
                  if not isinstance(v, np.ndarray)}, leg=leg)
            for h in history
        ],
        "wall_s": round(prior_wall + time.perf_counter() - t_run0, 1),
    }
    if artifact_path:
        with open(artifact_path, "w") as f:
            json.dump(report, f, indent=1)
    return best, report


def goal_oriented_frontier(num_params, sensors, primal_result, *,
                           bound=1e-6, n_x=1024, n_p=128,
                           dual_stage1=128, dual_budget=128,
                           max_dual_stages=8, minutes=None,
                           n_corners=0, n_edge=48, n_random=64,
                           seeds=(7, 101, 1234), dtype=np.float32,
                           state_prefix=None, log=None,
                           artifact_path=None, device="cuda"):
    """Goal-oriented output certification at the dimensionality frontier,
    the companion of :func:`highd_frontier` for outputs: per sensor, an
    adjoint-vademecum :func:`adaptive_cascade` whose per-stage error is the
    FEM-verified corrected-output error, so it stops as soon as the
    outputs clear ``bound``, boosts while the output corners bind and
    corner-seeds at the worst measured points.

    s_corr = l·u_r + z_r·r has error (z − z_r)·r (:mod:`~pgdrome_tpu_torch.dual`),
    so a modest dual on a rank-walled primal certifies outputs far below
    the field error.  ``primal_result``: the raw or Galerkin-updated
    frontier primal in the preconditioned dim-0 basis of the canonical
    (8, 6)-boosted build (a :func:`highd_frontier` state); it is
    Galerkin-updated on that build first.  ``sensors``: dim-0 sensor
    coordinates x0.  The FEM truth (all 2^d inset corners when
    ``n_corners=0``, else that many, plus per-seed interior and edge
    draws) is solved once and serves every sensor and stage.  The dual
    solves run on ``device``; ``state_prefix``: each sensor's raw dual is
    saved to ``{state_prefix}_s{j}.npz`` after every stage.

    Returns ``(duals, report)``: per sensor ``(res_z, tf_z)`` and the
    artifact dict (per-stage corrected-error history, estimate
    effectivity, timing), written as JSON to ``artifact_path``."""
    import warnings

    from pgdrome_tpu_torch.dual import DualCorrector, adjoint_problem, point_functional
    from pgdrome_tpu_torch.models.problems import (
        box_corners,
        elliptic_fem_solver,
        parametric_elliptic,
    )

    device = get_device(device)
    say = log or (lambda *a: None)
    t_run0 = time.perf_counter()
    d = num_params

    (sep_pc, tf_u), status = frontier_setup(d, (8.0, 6), n_x=n_x, n_p=n_p)
    say(f"setup cache {status} (boost (8.0, 6))")
    sep_plain, Vs = parametric_elliptic(n_x=n_x, n_p=n_p, num_params=d, degree_x=2)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*boundary_boost compounds.*")
        sep_b16, _ = parametric_elliptic(n_x=n_x, n_p=n_p, num_params=d, degree_x=2,
                                         boundary_boost=(16.0, 6))

    res_u = galerkin_update(sep_pc, primal_result)
    Vx = Vs[0]
    grid = Vs[1].tabulate_dof_coordinates()[:, 0]
    lo, hi = grid[1], grid[-2]

    # the shared verification set and its one FEM truth sweep
    samples, is_boundary = goal_verification_set(d, grid, n_corners=n_corners,
                                                 n_edge=n_edge, n_random=n_random,
                                                 seeds=seeds)
    fem_solve = elliptic_fem_solver(Vx, d)
    ls = [point_functional(Vx, x0) for x0 in sensors]
    t0 = time.perf_counter()
    s_true = np.zeros((len(samples), len(ls)))
    for si, p in enumerate(samples):
        u_t = fem_solve(p)
        for j, l in enumerate(ls):
            s_true[si, j] = l @ u_t
    out_floor = 1e-9 * max(np.abs(s_true).max(), 1e-300)
    for j, x0 in enumerate(sensors):
        if np.abs(s_true[:, j]).min() < out_floor:
            raise ValueError(
                f"sensor x0={x0} has (near-)zero true outputs on the verification set "
                "(e.g. a Dirichlet-boundary sensor): relative output errors are undefined"
            )
    n_corner_rows = int(min(2 ** d, n_corners) if n_corners else 2 ** d)
    say(f"fem truth: {len(samples)} samples ({n_corner_rows} corners) in "
        f"{time.perf_counter() - t0:.1f} s")

    report = {
        "num_params": d, "bound_target": float(bound),
        "primal_rank": int(res_u.n_modes), "n_samples": int(len(samples)),
        "n_corners": n_corner_rows, "seeds": list(seeds), "sensors": [],
    }
    # corner and edge rows count as corners, for the boost and the seeds
    b_rows = np.nonzero(is_boundary)[0]
    i_rows = np.nonzero(~is_boundary)[0]
    duals = []
    for j, x0 in enumerate(sensors):
        say(f"=== sensor x0={x0} ===")
        l = ls[j]
        st = s_true[:, j]
        adj_pc, tf_z = precondition_dim0(adjoint_problem(sep_plain, l), dtype=np.float64)
        adj_b_pc, _ = precondition_dim0(adjoint_problem(sep_b16, l), dtype=np.float64)
        last = {}
        corr_cache = {}

        def verify_outputs(res_zg, l=l, st=st, tf_z=tf_z, last=last, corr_cache=corr_cache):
            dc = DualCorrector(sep_plain, Vs, l, res_u, tf_u, res_zg, tf_z, cache=corr_cache)
            s_corr, s_plain, est = dc.corrected(samples, return_parts=True)
            rel = np.abs(s_corr - st) / np.abs(st)
            mc = float(rel[b_rows].max())
            mi = float(rel[i_rows].max()) if len(i_rows) else 0.0
            order = np.argsort(rel[b_rows])[::-1][:128]
            te = st - s_plain
            big = np.abs(te) > 1e-12 * np.abs(st).max()
            last.update(plain_rel_max=float((np.abs(s_plain - st) / np.abs(st)).max()),
                        eff_median=float(np.median(est[big] / te[big])))
            return {"corners": mc, "interior": mi, "max": max(mc, mi),
                    "worst_points": samples[b_rows][order],
                    "worst_errors": rel[b_rows][order]}

        def checkpoint(stage_line, raw, j=j):
            if not state_prefix:
                return
            arrs = {f"m{dd}": host_f64(raw.modes[dd]) for dd in range(1 + d)}
            np.savez(f"{state_prefix}_s{j}.npz", n_modes=raw.n_modes,
                     amplitudes=np.asarray(raw.amplitudes), alpha=np.asarray(raw.alpha),
                     fp_its=np.asarray(raw.fp_its), normU0=raw.normU0, **arrs)

        t0 = time.perf_counter()
        res_z, hist = adaptive_cascade(
            adj_pc, verify_outputs, bound=bound, n_stage1=dual_stage1,
            stage_budget=dual_budget, max_stages=max_dual_stages,
            boost_problem=adj_b_pc, boost_margin=1.2, rhs_comp=True, dtype=dtype,
            log=say, checkpoint=checkpoint, corner_seed_range=(lo, hi),
            rhs_bucket=4096, minutes=minutes, device=device)
        duals.append((res_z, tf_z))
        best = min(h["max"] for h in hist)
        sensor = {
            "x0": float(x0), "dual_rank": int(res_z.n_modes),
            "corrected_rel_max": float(best), "met_bound": bool(best < bound),
            "plain_rel_max": last.get("plain_rel_max"),
            "estimate_effectivity_median": last.get("eff_median"),
            "history": [{k: (float(v) if isinstance(v, (int, float, np.floating)) else v)
                         for k, v in h.items() if not isinstance(v, np.ndarray)}
                        for h in hist],
            "cascade_s": round(time.perf_counter() - t0, 1),
        }
        report["sensors"].append(sensor)
        say(json.dumps({k: sensor[k] for k in ("x0", "dual_rank", "corrected_rel_max",
                                               "met_bound")}))
        if artifact_path:
            with open(artifact_path, "w") as f:
                json.dump(report, f, indent=1)

    report["wall_s"] = round(time.perf_counter() - t_run0, 1)
    report["corrected_rel_max"] = max(s["corrected_rel_max"] for s in report["sensors"])
    if artifact_path:
        with open(artifact_path, "w") as f:
            json.dump(report, f, indent=1)
    return duals, report


def goal_verification_set(num_params, grid, *, n_corners=0, n_edge=48, n_random=64,
                          seeds=(7, 101, 1234)):
    """The output verification set of :func:`goal_oriented_frontier`, drawn
    as the JAX package draws it: the inset box corners (all 2^d when
    ``n_corners=0``, else the first and last and a seeded choice of the
    rest), then per seed ``n_random`` interior grid points and ``n_edge``
    points with a random subset of dims pinned to a face.  Returns
    ``(samples, is_boundary)``, the corner and edge rows marked."""
    d = num_params
    lo, hi = grid[1], grid[-2]
    n_c = 2 ** d
    idx = np.arange(n_c)
    if n_corners and n_c > n_corners:
        rng_c = np.random.default_rng(0)
        idx = np.concatenate([[0, n_c - 1],
                              rng_c.choice(n_c - 2, size=n_corners - 2, replace=False) + 1])
    from pgdrome_tpu_torch.models.problems import box_corners

    sets = [("corners", box_corners(lo, hi, d, idx))]
    for seed in seeds:
        rng = np.random.default_rng(seed)
        if n_random:
            sets.append((f"interior_{seed}",
                         grid[rng.integers(1, len(grid) - 1, size=(n_random, d))]))
        if n_edge:
            pts = grid[rng.integers(1, len(grid) - 1, size=(n_edge, d))]
            for r in range(n_edge):
                k = int(rng.integers(1, d)) if d > 1 else 1
                dims = rng.choice(d, size=k, replace=False)
                pts[r, dims] = np.where(rng.integers(0, 2, size=k) == 0, lo, hi)
            sets.append((f"edges_{seed}", pts))
    samples = np.concatenate([s for _, s in sets])
    is_boundary = np.concatenate([np.full(len(s), name == "corners" or name.startswith("edges"))
                                  for name, s in sets])
    return samples, is_boundary


def transient_verification_set(grid, num_params, *, n_random=16, seeds=(7, 101)):
    """The verification set of the JAX package's transient goal-oriented
    recipe (``transient_goal_oriented``): the parameter-box corners inset
    by one grid cell, then ``n_random`` random interior grid points per
    seed.  Returns (n, num_params) host f64 points."""
    from pgdrome_tpu_torch.models.problems import box_corners

    pts = [box_corners(grid[1], grid[-2], num_params)]
    for seed in seeds:
        rng = np.random.default_rng(seed)
        pts.append(grid[rng.integers(1, len(grid) - 1, size=(n_random, num_params))])
    return np.concatenate(pts)


def transient_goal_oriented(sensors_x, *, n_x=256, n_t=96, n_p=48, num_params=3,
                            bound=1e-6, primal_stages=(96, 64), dual_stage1=48,
                            dual_budget=48, max_dual_stages=6, n_random=16,
                            seeds=(7, 101), tol_fp=1e-7, max_fp_it=50,
                            dtype=np.float32, log=None, artifact_path=None,
                            device="cuda"):
    """Goal-oriented output certification for the operator-parametric
    transient family, the transient companion of :func:`goal_oriented_frontier`.

    :func:`~pgdrome_tpu_torch.models.problems.transient_parametric_conductivity`
    puts the parameters in the operator, so the exact closed form of
    :func:`~pgdrome_tpu_torch.dual.rhs_parametric_qoi` does not apply and
    the field goes through the f32 minres floor.  The primal is
    :func:`two_stage_minres` over ``primal_stages``; the truth is the exact
    space-time FOM at :func:`transient_verification_set`'s points; then per
    sensor (x0, final time) a backward-in-time adjoint minres cascade
    (:func:`~pgdrome_tpu_torch.dual.adjoint_problem_nd`: the upwind stencil
    transposes to downwind) runs until its corrected outputs are within
    ``bound`` of the FOM's, each stage verified by the space-time
    :class:`~pgdrome_tpu_torch.dual.DualCorrector` (``n_fixed=2``).  The
    solves run on ``device``.

    Returns ``(duals, report)``; the report carries per-sensor histories
    (``corrected_best`` the returned dual's error, ``corrected_last`` the
    last stage's) and the primal's field error for contrast, and is written
    to ``artifact_path`` when given."""
    from pgdrome_tpu_torch.models.problems import (transient_conductivity_fom,
                                                   transient_parametric_conductivity)
    from pgdrome_tpu_torch.separated import evaluate_modes_1d

    say = log or (lambda *a: None)
    device = get_device(device)
    t0_run = time.perf_counter()
    sep, Vs = transient_parametric_conductivity(n_x=n_x, n_t=n_t, n_p=n_p,
                                                num_params=num_params)
    fom = transient_conductivity_fom(sep, Vs)
    pts = transient_verification_set(Vs[2].tabulate_dof_coordinates()[:, 0], num_params,
                                      n_random=n_random, seeds=seeds)

    say(f"primal minres stages {primal_stages} ...")
    t0 = time.perf_counter()
    res_u = two_stage_minres(sep, n_stage1=primal_stages[0],
                             n_stage2=primal_stages[1] if len(primal_stages) > 1 else 0,
                             extra_stages=tuple(primal_stages[2:]), tol_fp=tol_fp,
                             max_fp_it=max_fp_it, dtype=dtype, device=device)
    t_primal = time.perf_counter() - t0

    # one space-time solve a point serves every sensor and every stage
    say(f"FOM truth sweep: {len(pts)} space-time solves ...")
    t0 = time.perf_counter()
    U_true = [fom(p) for p in pts]
    t_fom = time.perf_counter() - t0
    # the primal's field error, the floor the outputs must beat
    K = res_u.n_modes
    fu = np.ones((len(pts), K))
    for j in range(num_params):
        m = torch.as_tensor(res_u.modes[2 + j]).detach().cpu()
        fu *= host_f64(evaluate_modes_1d(Vs[2 + j], m, torch.as_tensor(pts[:, j])))[:, :K]
    m0, m1 = host_f64(res_u.modes[0])[:K], host_f64(res_u.modes[1])[:K]
    field_err = max(
        float(np.linalg.norm(np.einsum("k,ki,kj->ij", fu[s], m0, m1) - U_true[s])
              / np.linalg.norm(U_true[s])) for s in range(len(pts)))
    say(f"primal rank {K}: field err {field_err:.2e} ({t_primal:.1f}s solve, "
        f"{t_fom:.1f}s FOM truth)")

    duals, sensor_reports = _transient_sensor_duals(
        sep, Vs, res_u, pts, U_true, sensors_x, bound=bound, dual_stage1=dual_stage1,
        dual_budget=dual_budget, max_dual_stages=max_dual_stages, tol_fp=tol_fp,
        max_fp_it=max_fp_it, dtype=dtype, log=say, device=device)
    report = {
        "family": "transient_parametric_conductivity",
        "n_x": n_x, "n_t": n_t, "n_p": n_p, "num_params": num_params,
        "bound_target": float(bound),
        "primal_rank": int(K),
        "primal_field_rel_max": field_err,
        "n_verify": int(len(pts)),
        "sensors": sensor_reports,
        "max_corrected": max(s["corrected_best"] for s in sensor_reports),
        "wall_s": round(time.perf_counter() - t0_run, 1),
    }
    if artifact_path:
        with open(artifact_path, "w") as f:
            json.dump(report, f, indent=1)
    return duals, report


def _transient_sensor_duals(sep, Vs, res_u, pts, U_true, sensors_x, *, bound,
                            dual_stage1, dual_budget, max_dual_stages, tol_fp, max_fp_it,
                            dtype, log, device):
    """The per-sensor half of :func:`transient_goal_oriented` on a trained
    nodal primal ``res_u`` and its space-time FOM fields ``U_true`` (one
    (n_x, n_t) array a point of ``pts``): per sensor x0 an
    :func:`adaptive_minres` cascade on the adjoint of the point-at-final-
    time functional, verified by the corrected outputs' max error against
    the FOM relative to the outputs' scale.  Returns ``(duals,
    sensor_reports)``."""
    from pgdrome_tpu_torch.dual import DualCorrector, adjoint_problem_nd

    x_dofs = Vs[0].tabulate_dof_coordinates()[:, 0]
    l_t = np.zeros(Vs[1].dim())
    l_t[-1] = 1.0
    duals, reports = [], []
    for x0 in np.atleast_1d(sensors_x):
        ix0 = int(np.argmin(np.abs(x_dofs - x0)))
        l_x = np.zeros(Vs[0].dim())
        l_x[ix0] = 1.0
        s_true = np.array([U[ix0, -1] for U in U_true])
        s_scale = float(np.abs(s_true).max())
        adj = adjoint_problem_nd(sep, [l_x, l_t], n_fixed=2)
        cache, errs = {}, []

        def verify(res_zg, _cache=cache, _s_true=s_true, _l_x=l_x, _errs=errs,
                   _scale=s_scale):
            dc = DualCorrector(sep, Vs, None, res_u, None, res_zg, None, n_fixed=2,
                               l_factors=[_l_x, l_t], cache=_cache)
            err = float(np.abs(dc.corrected(pts) - _s_true).max() / _scale)
            _errs.append(err)
            return err

        t0 = time.perf_counter()
        res_z, hist = adaptive_minres(adj, verify, bound=bound, n_stage1=dual_stage1,
                                      stage_budget=dual_budget, max_stages=max_dual_stages,
                                      tol_fp=tol_fp, max_fp_it=max_fp_it, dtype=dtype,
                                      log=log, device=device)
        duals.append(res_z)
        reports.append({
            "x0": float(x_dofs[ix0]),
            "dual_rank": int(res_z.n_modes),
            # adaptive_minres returns the best stage: the headline error is
            # its; the last stage's stays as an audit field
            "corrected_best": float(min(errs) if errs else np.inf),
            "corrected_last": float(errs[-1] if errs else np.inf),
            "history": [{k: h[k] for k in ("stage", "rank", "max", "stage_s")}
                        for h in hist],
            "wall_s": round(time.perf_counter() - t0, 1),
        })
        log(f"sensor x0={x_dofs[ix0]:.3f}: corrected {reports[-1]['corrected_best']:.2e} "
            f"at dual rank {res_z.n_modes}")
    return duals, reports


class _CubeRhs:
    """The outer Picard's rhs for :func:`nonlinear_vademecum`: the
    preconditioned linear problem ``sep_pc`` (``tf`` its dim-0 transform)
    with the stack [b, −ε·M_L u³], u³ of an iterate compressed on the host
    in f64 (:meth:`problem`)."""

    def __init__(self, sep, ml, eps, cube_rank, cube_tol, rhs_bucket):
        self.num_params = sep.num_dims - 1
        if self.num_params not in (2, 3):
            raise ValueError("nonlinear_vademecum takes 2 or 3 parameters: the cube "
                             "tensor holds n_x·n_p^d entries")
        self.sep_pc, self.tf = precondition_dim0(sep, dtype=np.float64)
        self.ml, self.eps = np.asarray(ml, dtype=np.float64), eps
        self.cube_rank, self.rhs_bucket = cube_rank, rhs_bucket
        self.mask0 = host_f64(sep.bc_masks[0])
        # collocation weights (a boost ω included, so a re-weighted measure
        # keeps the per-grid-point cancellation for the cube rows too)
        self.w_p = [np.diagonal(host_f64(sep.ops[1 + j])[0]) for j in range(self.num_params)]
        self.base_rhs = [host_f64(r) for r in self.sep_pc.rhs]
        self.cut = cube_tol * max(float(np.linalg.norm(self.base_rhs[0][0])), 1.0)

    def terms(self, res):
        """CP factors ``(xs, ps)`` of u³ on the collocation grid: a randomized
        range finder on the x-unfolding (:mod:`.anova`'s scheme), then SVDs of
        each component's parameter tensor, truncated at ``cut``."""
        from pgdrome_tpu_torch.anova import _rand_range_svd

        K, n_par, cut = res.n_modes, self.num_params, self.cut
        full0 = self.tf.modes_to_full(host_f64(res.modes[0])[:K])
        Ps = [host_f64(res.modes[1 + j])[:K] for j in range(n_par)]
        if n_par == 2:
            U = np.einsum("kx,ka,kb->xab", full0, Ps[0], Ps[1])
        else:
            U = np.einsum("kx,ka,kb,kc->xabc", full0, Ps[0], Ps[1], Ps[2])
        X, s, Vt = _rand_range_svd((U ** 3).reshape(U.shape[0], -1).T, self.cube_rank)
        xs, ps = [], []
        shape_p = U.shape[1:]
        for r in range(int(np.sum(s > cut))):
            W = Vt[r].reshape(shape_p)
            if n_par == 2:
                Uw, sw, Vtw = np.linalg.svd(W, full_matrices=False)
                for q in range(sw.size):
                    if s[r] * sw[q] <= cut:
                        break
                    xs.append(X[:, r] * (s[r] * sw[q]))
                    ps.append([Uw[:, q], Vtw[q]])
            else:  # sequential SVD of the remaining unfolding
                Uw, sw, Vtw = np.linalg.svd(W.reshape(shape_p[0], -1), full_matrices=False)
                for q in range(sw.size):
                    if s[r] * sw[q] <= cut:
                        break
                    U2, s2, V2 = np.linalg.svd(Vtw[q].reshape(shape_p[1], shape_p[2]),
                                               full_matrices=False)
                    for m in range(s2.size):
                        if s[r] * sw[q] * s2[m] <= cut:
                            break
                        xs.append(X[:, r] * (s[r] * sw[q] * s2[m]))
                        ps.append([Uw[:, q], U2[:, m], V2[m]])
        return xs, ps

    def problem(self, res=None):
        """``(problem, n_cube)``: the host f64 problem of the outer iteration
        after ``res`` (the plain one before the first), its rhs stack padded
        to a multiple of ``rhs_bucket``, and its count of cube rows."""
        if res is None:
            return pad_rhs_bucket(self.sep_pc, self.rhs_bucket), 0
        xs, ps = self.terms(res)
        tf, n_par = self.tf, self.num_params
        rows0 = [self.base_rhs[0][0]]
        rows_p = [[self.base_rhs[1 + j][0]] for j in range(n_par)]
        for x, p in zip(xs, ps):
            v = (-self.eps * self.ml * x) * self.mask0
            rows0.append(tf.apply_Linv(v[tf.interior][:, None])[:, 0])
            for j in range(n_par):
                rows_p[j].append(self.w_p[j] * p[j])
        sp = self.sep_pc
        prob = SeparatedProblem(ops=list(sp.ops),
                                rhs=[np.stack(rows0)] + [np.stack(r) for r in rows_p],
                                mass=list(sp.mass), bc_dofs=list(sp.bc_dofs))
        return pad_rhs_bucket(prob, self.rhs_bucket), len(xs)


def _drop_repeated_modes(res, tol=1e-12):
    """``(result, n_dropped)``: ``res`` without the modes whose rank-1 term
    repeats an earlier one's up to sign and scale (product-space
    |cos| > 1 − ``tol``), the rest in order (buffers of the same kind,
    dtype and length).  An f32 fixed point at its amplitude floor can
    cycle: subtracting a mode of amplitude ~1e-9 leaves the f32 rhs as it
    was, and the next enrichments return the same terms again, their
    factors sign-flipped or rescaled.  Such a repeat adds nothing to the
    span, and kept, it makes the Galerkin Gram singular (the update's
    coefficients then reach 1e17 and cancel)."""
    K = res.n_modes
    cos = np.ones((K, K))
    for m in res.modes:
        u = host_f64(m)[:K]
        u = u / np.maximum(np.linalg.norm(u, axis=1, keepdims=True), 1e-300)
        cos = cos * (u @ u.T)
    keep = [i for i in range(K) if not (np.abs(cos[i, :i]) > 1.0 - tol).any()]
    n = len(keep)
    if n == K:
        return res, 0

    def pick(m):
        idx = torch.as_tensor(keep, device=m.device) if isinstance(m, torch.Tensor) else keep
        out = m.clone() if isinstance(m, torch.Tensor) else np.array(m)
        out[:n] = m[idx]
        out[n:K] = 0
        return out

    return PGDResult(modes=[pick(m) for m in res.modes], n_modes=n,
                     amplitudes=np.asarray(res.amplitudes)[keep],
                     alpha=np.asarray(res.alpha)[keep], fp_its=np.asarray(res.fp_its)[keep],
                     normU0=res.normU0), K - n


def _rel_change(res_a, res_b):
    """‖u_a − u_b‖ / ‖u_b‖ in product-space L2 by separated Grams."""
    def grams(r1, r2):
        G = np.ones((r1.n_modes, r2.n_modes))
        for m1, m2 in zip(r1.modes, r2.modes):
            G = G * (host_f64(m1)[: r1.n_modes] @ host_f64(m2)[: r2.n_modes].T)
        return G.sum()

    naa, nbb, nab = grams(res_a, res_a), grams(res_b, res_b), grams(res_a, res_b)
    return float(np.sqrt(max(naa - 2 * nab + nbb, 0.0)) / np.sqrt(max(nbb, 1e-300)))


def state_conditioning(res, spaces, tf, samples):
    """How a trained result's sum of rank-1 terms meets f32 serving, in
    host f64 at ``samples`` (B, d−1) (``tf``: the dim-0 transform or None):

    - ``cancellation_max`` / ``_median``: Σ_k |F_k(p)|·‖m0_k‖ / ‖u(p)‖ over
      the samples, 1 for a sum without cancellation; an f32 sum's error
      grows with it;
    - ``alpha_max``: the largest coefficient of a unit-norm term,
      Π_d ‖m_d[k]‖ (dim 0 nodal);
    - ``gram_cond``: the condition number of the unit-norm terms'
      product-space Gram (the Galerkin update's system, up to the metric)."""
    from pgdrome_tpu_torch.separated import evaluate_modes_1d

    K = res.n_modes
    m0 = host_f64(res.modes[0])[:K]
    units = [m0 if tf is None else tf.modes_to_full(m0)]
    units += [host_f64(m)[:K] for m in res.modes[1:]]
    F = np.ones((len(samples), K))
    for j, m in enumerate(units[1:]):
        F *= host_f64(evaluate_modes_1d(spaces[1 + j], torch.as_tensor(m),
                                        torch.as_tensor(np.asarray(samples)[:, j])))[:, :K]
    kappa = (np.abs(F) @ np.linalg.norm(units[0], axis=1)) / np.linalg.norm(F @ units[0], axis=1)
    alpha, G = np.ones(K), np.ones((K, K))
    for u in units:
        n = np.linalg.norm(u, axis=1)
        alpha *= n
        v = u / n[:, None]
        G *= v @ v.T
    return {"cancellation_max": float(kappa.max()),
            "cancellation_median": float(np.median(kappa)),
            "alpha_max": float(alpha.max()), "gram_cond": float(np.linalg.cond(G))}


def nonlinear_vademecum(sep, Vs, ml, eps, *, n_outer=12, picard_tol=1e-8, cube_rank=40,
                        cube_tol=1e-10, budgets=(64, 48, 48), rhs_bucket=512,
                        rhs_comp_last=True, tol_fp=1e-7, dtype=np.float32, log=None,
                        device="cuda"):
    """Nonlinear parametric vademecum by outer Picard on
    −∇·(κ(x; p)∇u) + ε·u³ = f (:func:`~pgdrome_tpu_torch.models.problems.nonlinear_elliptic`).

    Each outer iteration is linear separated algebra:

    1. evaluate the current iterate on the full collocation grid (host f64
       mode contraction);
    2. cube it pointwise and compress it (:class:`_CubeRhs`) to at most
       ``cube_rank`` rhs terms, truncated at ``cube_tol``·max(‖b‖, 1);
    3. re-solve the same preconditioned operators with the extended rhs
       stack [b, −ε·M_L u³] through :func:`residual_cascade` and a Galerkin
       update (the operator stacks never change).

    The loop stops when the iterate moves less than ``picard_tol`` in
    relative product-space L2 ("converged"), when after the second outer
    iteration it moved more than half as far as the one before
    ("stalled": the JAX package's rule, which a slowly converging iteration
    also trips), or after ``n_outer`` ("n_outer").  ``rhs_comp_last``:
    from the third outer iteration on, contract the rhs stacks in
    compensated double-f32 (the cube rows cancel against b near the fixed
    point; not in f64).  The solves run on ``device``.

    Returns ``(result_pc, tf, report)``; verify with
    :func:`~pgdrome_tpu_torch.models.problems.nonlinear_dense_verifier`.
    The report's ``"stop"`` names the rule that ended the loop, and each
    outer iteration's entry its fixed-point sweeps (``"fp_sweeps"``) and
    the modes dropped before its Galerkin update for repeating an earlier
    one up to sign and scale (``"repeated_modes"``,
    :func:`_drop_repeated_modes`)."""
    say = log or (lambda *a: None)
    device = get_device(device)
    t0_run = time.perf_counter()
    rhs = _CubeRhs(sep, ml, eps, cube_rank, cube_tol, rhs_bucket)
    res, history, stop = None, [], "n_outer"
    for it in range(n_outer):
        t0 = time.perf_counter()
        prob_it, n_cube = rhs.problem(res)
        comp = rhs_comp_last and it >= 2 and np.dtype(dtype) != np.float64
        new = residual_cascade(prob_it, budgets, tol_fp=tol_fp, dtype=dtype, rhs_comp=comp,
                               device=device)
        new, n_rep = _drop_repeated_modes(new)
        new = galerkin_update(prob_it, new)
        delta = _rel_change(new, res) if res is not None else np.inf
        history.append({"outer": it + 1, "rank": int(new.n_modes), "cube_terms": int(n_cube),
                        "rel_change": float(delta), "rhs_comp": bool(comp),
                        "fp_sweeps": int(np.sum(new.fp_its)), "repeated_modes": n_rep,
                        "outer_s": round(time.perf_counter() - t0, 2)})
        say(f"picard {it + 1}: rank {new.n_modes} cube {n_cube} moved {delta:.2e}"
            + (" [dd]" if comp else ""))
        prev = history[-2]["rel_change"] if len(history) > 1 else np.inf
        res = new
        if delta < picard_tol:
            stop = "converged"
            break
        if it >= 2 and delta > 0.5 * prev:
            # the contraction stopped being visible: the JAX package reads
            # this as the solve-noise floor, though a slow contraction
            # (rate above 1/2) trips it as well
            stop = "stalled"
            say(f"picard stalled at {delta:.2e}; stopping")
            break
    report = {"eps": float(eps), "num_params": rhs.num_params,
              "outer_iterations": len(history), "history": history, "stop": stop,
              "rank": int(res.n_modes), "wall_s": round(time.perf_counter() - t0_run, 1)}
    return res, rhs.tf, report
