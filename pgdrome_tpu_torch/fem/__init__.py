"""FEM layer: meshes (intervals, rectangles, boxes, unstructured
simplices), P1/P2 and DG spaces, scalar and vector, assembly, Dirichlet
conditions and point evaluation (counterpart of ``pgdrome_tpu/fem``).

Host numpy in f64, as in the JAX package; device copies are lazy ``torch``
tensors.  :mod:`.assembly_device` assembles on the device, for operators
that depend on the current iterate (the JAX package's ``assembly_jax``).
The ``interpolate`` function stays in :mod:`.function`: exported here it
would shadow the :mod:`.interpolate` module.
"""

from pgdrome_tpu_torch.fem.mesh import (
    BoxMesh,
    IntervalMesh,
    Point,
    RectangleMesh,
    SimplicialMesh,
)
from pgdrome_tpu_torch.fem.space import FunctionSpace, VectorFunctionSpace
from pgdrome_tpu_torch.fem.function import Function, Expression, Constant
from pgdrome_tpu_torch.fem.bc import DirichletBC

__all__ = [
    "BoxMesh",
    "IntervalMesh",
    "RectangleMesh",
    "SimplicialMesh",
    "Point",
    "FunctionSpace",
    "VectorFunctionSpace",
    "Function",
    "Expression",
    "Constant",
    "DirichletBC",
]
