"""End-to-end solver recipes (counterpart of ``pgdrome_tpu/recipes.py``:
``_to_nodal``, ``residual_cascade``, ``adaptive_cascade``,
``two_stage_elliptic``, ``highd_frontier``).

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
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from pgdrome_tpu_torch.config import get_device, use_full_f32_matmul
from pgdrome_tpu_torch.separated import (
    PGDResult,
    SeparatedPGD,
    SeparatedProblem,
    combine_results,
    compress_modes,
    galerkin_update,
    host_f64,
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
                     device="cuda"):
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
    leaves the stacks as they are.  Returns the combined (uncompressed)
    result in ``problem_pc``'s basis, its modes on ``device``."""
    common = dict(tol=0.0, solver=solver, cg_iters=cg_iters,
                  residual_check=False, dtype=dtype, device=device)
    res = SeparatedPGD(problem_pc, n_max=budgets[0], tol_fp=tol_fp,
                       max_fp_it=40, **common).solve_fused()
    for si, b in enumerate(budgets[1:], start=2):
        prob_s = (stage_problems or {}).get(si, problem_pc)
        sep_res, s_res = residual_problem(prob_s, res)
        if rhs_bucket:
            sep_res = pad_rhs_bucket(sep_res, rhs_bucket)
        delta = SeparatedPGD(sep_res, n_max=b, tol_fp=1e-5, max_fp_it=8,
                             **common).solve_fused()
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
        from pgdrome_tpu_torch.anova import anova_init
        from pgdrome_tpu_torch.models.problems import parametric_elliptic
        from pgdrome_tpu_torch.utils.setup_cache import cached_setup

        def _build_anova():
            sep_nodal, _ = parametric_elliptic(n_x=n_x, n_p=n_p, num_params=num_params,
                                               degree_x=2)
            return anova_init(sep_nodal, order=anova_order, tf=tf,
                              tol_pair=anova_tol_pair, log=say)

        (init_result, anova_report), status = cached_setup(
            _build_anova,
            key_data=["torch_anova_init_v1", n_x, n_p, num_params, anova_order,
                      anova_tol_pair],
            code_objects=(anova_init, parametric_elliptic),
        )
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
