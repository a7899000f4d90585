"""FEM layer on 1D intervals: meshes, P1/P2 spaces, assembly, Dirichlet
dofs and point evaluation (counterpart of ``pgdrome_tpu/fem``).

Host numpy in f64, as in the JAX package; device copies are lazy ``torch``
tensors.  :mod:`.assembly_device` assembles on the device, for operators
that depend on the current iterate (the JAX package's ``assembly_jax``).
"""

from pgdrome_tpu_torch.fem.mesh import IntervalMesh
from pgdrome_tpu_torch.fem.space import FunctionSpace
from pgdrome_tpu_torch.fem.function import Function, Expression, Constant
from pgdrome_tpu_torch.fem.bc import DirichletBC

__all__ = [
    "IntervalMesh",
    "FunctionSpace",
    "Function",
    "Expression",
    "Constant",
    "DirichletBC",
]
