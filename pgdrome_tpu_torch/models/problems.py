"""Predefined separated model problems — the parametric-elliptic family
(counterpart of ``pgdrome_tpu/models/problems.py``: ``box_corners``,
``parametric_elliptic``, ``elliptic_fem_solver``).

Builders return a :class:`~pgdrome_tpu_torch.separated.SeparatedProblem`
of host arrays plus the per-dim function spaces.
"""

from __future__ import annotations

import warnings

import numpy as np

from pgdrome_tpu_torch.fem.mesh import IntervalMesh
from pgdrome_tpu_torch.fem.space import FunctionSpace
from pgdrome_tpu_torch.fem.bc import DirichletBC
from pgdrome_tpu_torch.fem.assembly import (
    mass_matrix,
    stiffness_matrix,
    load_vector,
)
from pgdrome_tpu_torch.separated import SeparatedProblem


def box_corners(lo, hi, num_params: int, idx=None):
    """All (or an ``idx``-selected subset of) the 2^d parameter-box corner
    points as a ``(len(idx), num_params)`` f64 array; corner ``c`` pins
    dim ``i`` at ``lo`` when bit ``i`` of ``c`` is 0, else ``hi``."""
    if idx is None:
        idx = np.arange(2 ** num_params)
    return np.array(
        [[lo if (c >> i) & 1 == 0 else hi for i in range(num_params)]
         for c in idx],
        dtype=np.float64,
    )


def _kappa_weight(i, num_params):
    return lambda x: np.sin((i + 1) * np.pi * x) ** 2 / (2 * num_params)


def parametric_elliptic(
    n_x: int = 1024,
    n_p: int = 64,
    num_params: int = 3,
    p_range=(0.0, 1.0),
    degree_x: int = 2,
    dtype=None,
    param_discretization: str = "collocation",
    boundary_boost=None,
):
    """Parametric elliptic vademecum: −∇·(κ ∇u) = f on [0,1], homogeneous
    Dirichlet, with affine separated diffusion

        κ(x; p1..pP) = 1 + Σ_i p_i · w_i(x),    w_i(x) = sin²(iπx)/(2P).

    Separated terms: K_base ⊗ M ⊗ … ⊗ M plus one K_{w_i} ⊗ … ⊗ M_{p·} ⊗ …
    per parameter.  ``param_discretization="collocation"`` (default) lumps
    the parameter operator masses, so the tensor system decouples per
    parameter grid point; ``"galerkin"`` keeps them consistent.
    ``boundary_boost`` (β or (β, q)) re-weights the collocation measure
    toward the parameter-box boundary by ω(p) = 1 + (β−1)·s^q.  See the JAX
    package's docstring for the measurements behind each choice."""
    if param_discretization not in ("collocation", "galerkin"):
        raise ValueError(
            f"unknown param_discretization {param_discretization!r}"
        )
    if boundary_boost is not None and param_discretization != "collocation":
        raise ValueError(
            "boundary_boost requires collocation: the diagonal weights "
            "cancel per grid point there (solution unchanged), but would "
            "bias a consistent-Galerkin discretization"
        )
    Vx = FunctionSpace(IntervalMesh(n_x, 0.0, 1.0), "P", degree_x)
    Vp = [
        FunctionSpace(IntervalMesh(n_p, p_range[0], p_range[1]), "P", 1)
        for _ in range(num_params)
    ]

    K0 = stiffness_matrix(Vx)
    Kw = [stiffness_matrix(Vx, weight=_kappa_weight(i, num_params))
          for i in range(num_params)]
    Mx = mass_matrix(Vx)
    Mp = [mass_matrix(v) for v in Vp]
    Mp_w = [mass_matrix(v, weight=lambda p: p) for v in Vp]
    Mp_op, Mp_w_op = Mp, Mp_w
    rhs_weight = [None] * num_params
    if param_discretization == "collocation":
        # row-sum lumping of the operator stacks only; the norm matrices
        # (`mass`) stay consistent
        Mp_op = [np.diag(m.sum(axis=1)) for m in Mp]
        Mp_w_op = [np.diag(m.sum(axis=1)) for m in Mp_w]
        if boundary_boost is not None:
            beta, q = (
                boundary_boost
                if isinstance(boundary_boost, (tuple, list))
                else (float(boundary_boost), 6)
            )
            # the boost compounds per dim: beta^d at a box corner
            if beta ** num_params > 1e7:
                warnings.warn(
                    f"boundary_boost compounds to beta^d = "
                    f"{beta ** num_params:.1e} at the parameter-box "
                    f"corners; f32 solves lose the interior below the "
                    f"corner noise floor. Scale beta to keep beta^d "
                    f"~ 4e3 (beta = {4096.0 ** (1.0 / num_params):.2f} "
                    f"for {num_params} params).",
                    stacklevel=2,
                )
            for j in range(num_params):
                pc = Vp[j].tabulate_dof_coordinates()[:, 0]
                mid = 0.5 * (pc.min() + pc.max())
                half = 0.5 * (pc.max() - pc.min())
                s = np.abs(pc - mid) / half
                om = 1.0 + (beta - 1.0) * s ** q
                Mp_op[j] = Mp_op[j] * om[:, None]  # diagonal: row scale
                Mp_w_op[j] = Mp_w_op[j] * om[:, None]
                rhs_weight[j] = om

    T = 1 + num_params
    ops = [np.stack([K0] + Kw)]
    for j in range(num_params):
        ops.append(np.stack(
            [Mp_w_op[j] if t == j + 1 else Mp_op[j] for t in range(T)]
        ))

    b_x = load_vector(Vx, lambda x: np.ones_like(x))
    rhs = [b_x[None, :]]
    for j, v in enumerate(Vp):
        bp = load_vector(v, lambda p: np.ones_like(p))
        if rhs_weight[j] is not None:
            bp = bp * rhs_weight[j]
        rhs.append(bp[None, :])

    bc_x = DirichletBC(Vx, 0.0, lambda x, onb: onb)
    bc_dofs = [bc_x.dofs] + [np.array([], dtype=np.int64)] * num_params
    mass = [Mx] + Mp

    dt = dtype or np.float64
    prob = SeparatedProblem(
        ops=[np.asarray(o, dtype=dt) for o in ops],
        rhs=[np.asarray(r, dtype=dt) for r in rhs],
        mass=[np.asarray(m, dtype=dt) for m in mass],
        bc_dofs=bc_dofs,
    )
    return prob, [Vx] + Vp


def elliptic_fem_solver(Vx, num_params, rhs_vec=None):
    """Per-sample banded f64 FEM solver for the :func:`parametric_elliptic`
    family: returns ``solve(p) -> u`` (full dof vector, homogeneous
    Dirichlet) against the builder's κ(x; p) — the truth model a served
    vademecum is held against."""
    from scipy.linalg import solve_banded

    if rhs_vec is None:
        b_full = load_vector(Vx, lambda x: np.ones_like(x))
    else:
        b_full = np.asarray(rhs_vec, dtype=np.float64)
    K_probe = stiffness_matrix(Vx)
    bw = max(
        k for k in range(K_probe.shape[0])
        if np.any(np.diagonal(K_probe, k) != 0.0)
    )

    def solve(p):
        kappa = lambda x: 1.0 + sum(  # noqa: E731
            p[i] * np.sin((i + 1) * np.pi * x) ** 2 / (2 * num_params)
            for i in range(num_params)
        )
        K = stiffness_matrix(Vx, weight=kappa)
        n = K.shape[0] - 2
        ab = np.zeros((2 * bw + 1, n))
        for k in range(-bw, bw + 1):
            d = np.diagonal(K, k)[1 : 1 + n - abs(k)]
            if k >= 0:
                ab[bw - k, k:] = d
            else:
                ab[bw - k, : n + k] = d
        u = np.zeros(K.shape[0])
        u[1:-1] = solve_banded((bw, bw), ab, b_full[1:-1])
        return u

    return solve
