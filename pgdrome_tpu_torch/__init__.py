"""pgdrome_tpu_torch — the PyTorch/CUDA port of :mod:`pgdrome_tpu`.

A package of its own beside the JAX one, with the same layout and names, so
each module here has its counterpart at the same relative path there.  It
imports ``torch``, ``numpy`` and ``scipy`` only: never ``jax``, never
``h5py`` and nothing of ``pgdrome_tpu``.

What it covers so far is the main path of the JAX package's bench, for
the parametric-elliptic family: the host f64 build (:mod:`.fem`,
:mod:`.models.problems`, :mod:`.separated`); training — the progressive
PGD enrichment on the device (:class:`.separated.SeparatedPGD`), f64
residual restarts, compression and the Galerkin update on the host, as
one recipe in :mod:`.recipes`; the error-driven cascade and the d-parameter
frontier drive (:func:`.recipes.adaptive_cascade`,
:func:`.recipes.highd_frontier`: corner-boosted and corner-seeded stages,
rhs stacks kept in f64 or compensated double-f32, :mod:`.ops.ddf32`; the
anchored-ANOVA start, :mod:`.anova`; the residual screener's verification
from 8 parameters on); dense verification against per-sample FEM
(:func:`.models.problems.elliptic_dense_verifier`); residual indicators,
calibrated and guaranteed error bounds (:mod:`.parallel.certify`); the weights brought
across from the JAX package's saved states (:mod:`.convert`); the
batched field / sensor / moment sweeps (:mod:`.parallel.vademecum`,
:mod:`.serving`) whose hot loop is one hand-written CUDA kernel
(:mod:`.ops.fused_sweep`, ``csrc/fused_sweep.cu``); and the rest of
serving: save/load, errors, the parameter Jacobian, calibration by a
batched Gauss–Newton fit or an MCMC posterior (:mod:`.parallel.bayes`),
exact Sobol' indices (:mod:`.uq`), fixed-parameter slices and derivative
fields (:mod:`.fem.derivative`); goal-oriented outputs (:mod:`.dual`),
on the transient family too (:func:`.recipes.transient_goal_oriented`);
and the nonlinear family (:func:`.recipes.nonlinear_vademecum`, the
Newton and Picard per-dim solves of :mod:`.ops.solvers`, device assembly in
:mod:`.fem.assembly_device`); and the 2D/3D FEM (rectangle, box and
unstructured simplicial meshes, P1/P2 and DG spaces, scalar and vector)
with its families: the plane-strain elasticity-ν flagship
(:func:`.models.problems.elasticity_vademecum`, its gradient and strain
vademecums), 3D parametric diffusion
(:func:`.models.problems.parametric_elliptic_3d` with its dense verifier)
and 2D transient heat; and the reference-parity layer, host numpy in
f64: :class:`.solver.PGDProblem` with its per-coordinate callbacks, the
:class:`.model.PGD` container, :class:`.model.PGDErrorComputation`,
pxdmf/HDF5 persistence (:mod:`.io`, which needs ``h5py`` when called),
:class:`.utils.pgd_config.PGDConfig` and the native host helpers
(:mod:`.utils.native`).

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without a CUDA device they raise.
"""

from pgdrome_tpu_torch import config as config
from pgdrome_tpu_torch.fem.mesh import BoxMesh, IntervalMesh, Point, RectangleMesh
from pgdrome_tpu_torch.fem.space import FunctionSpace, VectorFunctionSpace
from pgdrome_tpu_torch.fem.function import Function, Expression, Constant
from pgdrome_tpu_torch.fem.bc import DirichletBC
from pgdrome_tpu_torch.fem.assembly import (
    mass_matrix,
    stiffness_matrix,
    load_vector,
    gram,
)
from pgdrome_tpu_torch.ops.fd import FD_matrices
from pgdrome_tpu_torch.solver import PGDProblem
from pgdrome_tpu_torch.model import PGD, PGDMesh, PGDAttribute, PGDErrorComputation
from pgdrome_tpu_torch.utils.pgd_config import PGDConfig
from pgdrome_tpu_torch.separated import (
    SeparatedProblem,
    SeparatedPGD,
    PGDResult,
    Dim0Transform,
    precondition_dim0,
    precondition_dim,
    galerkin_update,
    compress_modes,
    residual_problem,
    combine_results,
)
from pgdrome_tpu_torch.models.problems import (
    corner_seeded_init,
    elasticity_vademecum,
    elliptic3d_dense_verifier,
    elliptic_dense_verifier,
    parametric_elliptic_3d,
    nonlinear_dense_verifier,
    nonlinear_elliptic,
)
from pgdrome_tpu_torch.anova import anova_init
from pgdrome_tpu_torch.recipes import (
    adaptive_cascade,
    highd_frontier,
    nonlinear_vademecum,
    residual_cascade,
    transient_goal_oriented,
    two_stage_elliptic,
)
from pgdrome_tpu_torch.serving import TransientVademecum, Vademecum
from pgdrome_tpu_torch.convert import (
    result_from_numpy,
    load_state_npz,
    frontier_vademecum,
)

__all__ = [
    "config",
    "IntervalMesh",
    "RectangleMesh",
    "BoxMesh",
    "Point",
    "FunctionSpace",
    "VectorFunctionSpace",
    "Function",
    "Expression",
    "Constant",
    "DirichletBC",
    "mass_matrix",
    "stiffness_matrix",
    "load_vector",
    "gram",
    "FD_matrices",
    "PGDProblem",
    "PGD",
    "PGDMesh",
    "PGDAttribute",
    "PGDErrorComputation",
    "PGDConfig",
    "SeparatedProblem",
    "SeparatedPGD",
    "PGDResult",
    "Dim0Transform",
    "precondition_dim0",
    "precondition_dim",
    "galerkin_update",
    "compress_modes",
    "residual_problem",
    "combine_results",
    "elliptic_dense_verifier",
    "elasticity_vademecum",
    "parametric_elliptic_3d",
    "elliptic3d_dense_verifier",
    "corner_seeded_init",
    "nonlinear_elliptic",
    "nonlinear_dense_verifier",
    "anova_init",
    "residual_cascade",
    "adaptive_cascade",
    "two_stage_elliptic",
    "highd_frontier",
    "transient_goal_oriented",
    "nonlinear_vademecum",
    "Vademecum",
    "TransientVademecum",
    "result_from_numpy",
    "load_state_npz",
    "frontier_vademecum",
]
