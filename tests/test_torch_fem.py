"""The port's host FEM build against the JAX package's, on the CPU.

Same meshes, weights and points go to both; host f64 arrays must agree to
1e-13 relative to their largest entry (the arithmetic is the same numpy
code, so in practice they are equal).
"""

import numpy as np
import pytest
import torch

import pgdrome_tpu.fem.assembly as ja
from pgdrome_tpu.fem.interpolate import eval_dofs_at_points as j_eval
from pgdrome_tpu.fem.bc import DirichletBC as JBC
from pgdrome_tpu.fem.mesh import IntervalMesh as JMesh
from pgdrome_tpu.fem.space import FunctionSpace as JSpace
from pgdrome_tpu.fem.function import Function as JFunction
from pgdrome_tpu.models import problems as jp

import pgdrome_tpu_torch.fem.assembly as ta
import pgdrome_tpu_torch.fem.interpolate as ti
from pgdrome_tpu_torch.fem.bc import DirichletBC as TBC
from pgdrome_tpu_torch.fem.mesh import IntervalMesh as TMesh
from pgdrome_tpu_torch.fem.space import FunctionSpace as TSpace
from pgdrome_tpu_torch.fem.function import Function as TFunction
from pgdrome_tpu_torch.models import problems as tp

TOL = 1e-13
SPACES = [(1, 7, 0.0, 1.0), (2, 7, 0.0, 1.0), (1, 16, -0.5, 2.0), (2, 40, 0.0, 1.0)]
WEIGHTS = {
    "none": None,
    "const": 2.5,
    "linear": lambda x: 1.0 + x,
    "sin2": lambda x: np.sin(2 * np.pi * x) ** 2 / 4,
}


def _close(a, b, tol=TOL):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape
    scale = max(np.abs(b).max(), 1e-300)
    assert np.abs(a - b).max() <= tol * scale


def _pair(deg, n, a, b):
    return JSpace(JMesh(n, a, b), "P", deg), TSpace(TMesh(n, a, b), "P", deg)


@pytest.mark.parametrize("space", SPACES)
def test_dofmap_and_coordinates(space):
    jv, tv = _pair(*space)
    assert tv.ndofs == jv.ndofs
    np.testing.assert_array_equal(tv.element_dofs, jv.element_dofs)
    _close(tv.tabulate_dof_coordinates(), jv.tabulate_dof_coordinates())


@pytest.mark.parametrize("weight", list(WEIGHTS))
@pytest.mark.parametrize("space", SPACES)
def test_mass_and_stiffness(space, weight):
    jv, tv = _pair(*space)
    w = WEIGHTS[weight]
    _close(ta.mass_matrix(tv, weight=w), ja.mass_matrix(jv, weight=w))
    _close(ta.stiffness_matrix(tv, weight=w), ja.stiffness_matrix(jv, weight=w))


@pytest.mark.parametrize("space", SPACES)
def test_load_vector(space):
    jv, tv = _pair(*space)
    g = lambda x: np.cos(3 * x) + x ** 2  # noqa: E731
    _close(ta.load_vector(tv, g), ja.load_vector(jv, g))
    _close(ta.load_vector(tv, g, weight=lambda x: 2.0 + x),
           ja.load_vector(jv, g, weight=lambda x: 2.0 + x))


@pytest.mark.parametrize("space", SPACES)
def test_function_weight(space):
    # a Function on the same space as the weight (quadrature-point branch)
    jv, tv = _pair(*space)
    dofs = np.random.default_rng(0).uniform(0.5, 1.5, size=jv.ndofs)
    _close(ta.mass_matrix(tv, weight=TFunction(tv, dofs)),
           ja.mass_matrix(jv, weight=JFunction(jv, dofs)))


@pytest.mark.parametrize("space", SPACES)
def test_dirichlet_dofs(space):
    jv, tv = _pair(*space)
    np.testing.assert_array_equal(TBC(tv, 0.0, lambda x, onb: onb).dofs,
                                  JBC(jv, 0.0, lambda x, onb: onb).dofs)
    mid = 0.5 * (space[2] + space[3])
    jb = JBC(jv, lambda x: 3.0 * x, lambda x: x < mid)
    tb = TBC(tv, lambda x: 3.0 * x, lambda x: x < mid)
    np.testing.assert_array_equal(tb.dofs, jb.dofs)
    _close(tb.values, jb.values)


@pytest.mark.parametrize("space", SPACES)
def test_point_evaluation(space):
    jv, tv = _pair(*space)
    rng = np.random.default_rng(1)
    dofs = rng.normal(size=jv.ndofs)
    pts = rng.uniform(space[2], space[3], size=57)
    pts[:2] = space[2], space[3]  # both ends of the mesh
    ref = j_eval(jv, dofs, pts)
    _close(ti.eval_dofs_at_points(tv, dofs, pts), ref)
    got = ti.eval_dofs_at_points(tv, torch.as_tensor(dofs), torch.as_tensor(pts), xp=torch)
    _close(got.numpy(), ref)
    _close(TFunction(tv, dofs)(pts), JFunction(jv, dofs)(pts))


@pytest.mark.parametrize("num_params", [2, 3])
@pytest.mark.parametrize("variant", ["collocation", "galerkin", "boost"])
def test_parametric_elliptic(num_params, variant):
    kw = {"param_discretization": "galerkin"} if variant == "galerkin" else {}
    if variant == "boost":
        kw = {"boundary_boost": 16.0}
    js, jV = jp.parametric_elliptic(n_x=40, n_p=16, num_params=num_params, **kw)
    ts, tV = tp.parametric_elliptic(n_x=40, n_p=16, num_params=num_params, **kw)
    assert [v.ndofs for v in tV] == [v.ndofs for v in jV]
    for d in range(1 + num_params):
        _close(ts.ops[d], js.ops[d])
        _close(ts.rhs[d], js.rhs[d])
        _close(ts.mass[d], js.mass[d])
        np.testing.assert_array_equal(ts.bc_dofs[d], js.bc_dofs[d])
        np.testing.assert_array_equal(ts.bc_masks[d], js.bc_masks[d])


@pytest.mark.parametrize("num_params", [2, 3, 5])
def test_box_corners(num_params):
    np.testing.assert_array_equal(tp.box_corners(0.1, 0.9, num_params),
                                  jp.box_corners(0.1, 0.9, num_params))
    idx = np.array([0, 3, 2 ** num_params - 1])
    np.testing.assert_array_equal(tp.box_corners(0.0, 1.0, num_params, idx),
                                  jp.box_corners(0.0, 1.0, num_params, idx))


@pytest.mark.parametrize("degree_x", [1, 2])
def test_fem_solver(degree_x):
    jV = jp.parametric_elliptic(n_x=40, n_p=4, num_params=3, degree_x=degree_x)[1]
    tV = tp.parametric_elliptic(n_x=40, n_p=4, num_params=3, degree_x=degree_x)[1]
    jsolve = jp.elliptic_fem_solver(jV[0], 3)
    tsolve = tp.elliptic_fem_solver(tV[0], 3)
    for p in np.random.default_rng(2).uniform(0, 1, size=(4, 3)):
        _close(tsolve(p), jsolve(p))


def test_rejects_unported_spaces():
    # DG0/DG1 are ported (the derivative vademecum's spaces); DG2, P3 and
    # unknown families are not
    with pytest.raises(ValueError):
        TSpace(TMesh(4, 0.0, 1.0), "Q", 1)
    with pytest.raises(NotImplementedError):
        TSpace(TMesh(4, 0.0, 1.0), "DG", 2)
    with pytest.raises(NotImplementedError):
        TSpace(TMesh(4, 0.0, 1.0), "P", 3)
