"""End-to-end solver recipes (counterpart of ``pgdrome_tpu/recipes.py``:
``_to_nodal``, ``residual_cascade``, ``two_stage_elliptic``).

:func:`two_stage_elliptic` is the north-star vademecum pipeline: an
energy-basis f32 greedy stage on the device, f64-exact residual restarts
formed on the host and re-solved on the device, CP-ALS compression to the
deployed rank and a Galerkin update, both in host f64.
"""

from __future__ import annotations

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
