"""Frozen configuration of the PGD solvers (counterpart of
``pgdrome_tpu/utils/pgd_config.py``).

The reference configures a solve through constructor keywords and then
attribute mutation (``pgd_prob.stop_fp = 'norm'``); both styles work on
:class:`~pgdrome_tpu_torch.solver.PGDProblem`.  :class:`PGDConfig` is the
structured alternative, with the reference's names and defaults
(pgdrome/solver.py:96-134); :meth:`PGDConfig.separated_kwargs` maps it onto
:class:`~pgdrome_tpu_torch.separated.SeparatedPGD`'s keywords.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, replace


@dataclass(frozen=True)
class PGDConfig:
    # enrichment
    PGD_nmax: int = 20          # max enrichment steps
    PGD_tol: float = 1e-10      # relative-amplitude stop
    # fixed point
    max_fp_it: int = 50
    tol_fp_it: float = 1e-5
    tol_abs: float = 1e-6
    stop_fp: str = "norm"       # 'norm' | 'delta'
    fp_init: str = ""           # '' (ones) | 'randomized'
    norm_modes: str = "stiff"   # 'no' | 'l2' | 'stiff'
    # SeparatedPGD extras
    solver: str = "lu"          # per-dim dense solves: 'lu' | 'cg'
    cg_iters: int = 30
    residual_check: bool = True

    def apply(self, problem) -> None:
        """Set the knobs of a PGDProblem (the attribute-mutation idiom)."""
        problem.PGD_nmax = self.PGD_nmax
        problem.PGD_tol = self.PGD_tol
        problem.max_fp_it = self.max_fp_it
        problem.tol_fp_it = self.tol_fp_it
        problem.tol_abs = self.tol_abs
        problem.stop_fp = self.stop_fp
        problem.fp_init = self.fp_init
        problem.norm_modes = self.norm_modes

    def separated_kwargs(self) -> dict:
        """Keywords for ``SeparatedPGD(...)``."""
        return dict(
            n_max=self.PGD_nmax,
            tol=self.PGD_tol,
            tol_fp=self.tol_fp_it,
            max_fp_it=self.max_fp_it,
            solver=self.solver,
            cg_iters=self.cg_iters,
            residual_check=self.residual_check,
        )

    def with_(self, **kw) -> "PGDConfig":
        return replace(self, **kw)

    def to_dict(self) -> dict:
        return asdict(self)
