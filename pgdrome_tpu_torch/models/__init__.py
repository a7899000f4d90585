"""Model-problem families (counterpart of ``pgdrome_tpu/models``): the
parametric-elliptic vademecum that the committed states were trained on,
with its per-sample FEM truth model, the dense verifier built on it and
the corner seeds of the high-d cascades; and the transient family on
intervals (a moving heat source, an operator-parametric conductivity),
with their space-time FOM and dense verifier; the nonlinear (cubic)
elliptic family with its banded-Newton truth and dense verifier; 2D
transient heat; 2D plane-strain elasticity, with Poisson's ratio as a
separated coordinate (the flagship); and 3D parametric diffusion with its
dense verifier; the 2D Poisson and 1D truss problems of the reference's
tests, and the bridge of any separated problem to the reference-parity
``PGDProblem``."""

from pgdrome_tpu_torch.models.problems import (
    box_corners,
    parametric_elliptic,
    elliptic_fem_solver,
    elliptic_dense_verifier,
    corner_seeded_init,
    moving_heat_source,
    transient_parametric_conductivity,
    transient_conductivity_fom,
    transient_dense_verifier,
    nonlinear_elliptic,
    nonlinear_elliptic_fom,
    nonlinear_dense_verifier,
    transient_heat_2d,
    plane_strain_C,
    elasticity_vademecum,
    parametric_elliptic_3d,
    elliptic3d_dense_verifier,
    poisson_xy,
    elastic_truss,
    pgd_problem_from_separated,
)

__all__ = ["box_corners", "parametric_elliptic", "elliptic_fem_solver",
           "elliptic_dense_verifier", "corner_seeded_init", "moving_heat_source",
           "transient_parametric_conductivity", "transient_conductivity_fom",
           "transient_dense_verifier", "nonlinear_elliptic", "nonlinear_elliptic_fom",
           "nonlinear_dense_verifier", "transient_heat_2d", "plane_strain_C",
           "elasticity_vademecum", "parametric_elliptic_3d", "elliptic3d_dense_verifier",
           "poisson_xy", "elastic_truss", "pgd_problem_from_separated"]
