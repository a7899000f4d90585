"""Model-problem families (counterpart of ``pgdrome_tpu/models``); so far
the parametric-elliptic vademecum that the committed states were trained
on, with its per-sample FEM truth model, the dense verifier built on
it and the corner seeds of the high-d cascades."""

from pgdrome_tpu_torch.models.problems import (
    box_corners,
    parametric_elliptic,
    elliptic_fem_solver,
    elliptic_dense_verifier,
    corner_seeded_init,
)

__all__ = ["box_corners", "parametric_elliptic", "elliptic_fem_solver",
           "elliptic_dense_verifier", "corner_seeded_init"]
