"""Model-problem families (counterpart of ``pgdrome_tpu/models``); so far
the parametric-elliptic vademecum that the committed states were trained
on, with its per-sample FEM truth model and the dense verifier built on
it."""

from pgdrome_tpu_torch.models.problems import (
    box_corners,
    parametric_elliptic,
    elliptic_fem_solver,
    elliptic_dense_verifier,
)

__all__ = ["box_corners", "parametric_elliptic", "elliptic_fem_solver",
           "elliptic_dense_verifier"]
