"""Predefined separated model problems — the parametric-elliptic family,
its nonlinear (cubic) variant, the transient family on intervals, 2D
transient heat, 2D plane-strain elasticity (the ν-separated flagship) and
3D parametric diffusion (counterpart of
``pgdrome_tpu/models/problems.py``: ``box_corners``,
``parametric_elliptic``, ``elliptic_fem_solver``,
``elliptic_dense_verifier``, ``corner_seeded_init``,
``transient_heat_2d``, ``moving_heat_source``,
``transient_parametric_conductivity``, ``transient_conductivity_fom``,
``transient_dense_verifier``, ``plane_strain_C``,
``elasticity_vademecum``, ``parametric_elliptic_3d``,
``elliptic3d_dense_verifier``, ``nonlinear_elliptic``,
``nonlinear_elliptic_fom``, ``nonlinear_dense_verifier``, ``poisson_xy``,
``elastic_truss``, ``pgd_problem_from_separated``).

Builders return a :class:`~pgdrome_tpu_torch.separated.SeparatedProblem`
of host arrays plus the per-dim function spaces;
:func:`pgd_problem_from_separated` runs any separated problem through the
reference-parity :class:`~pgdrome_tpu_torch.solver.PGDProblem` (generic
callbacks over the term stacks): the cross-check of the device solver's
amplitudes, and the single-core host baseline of bench.py.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from pgdrome_tpu_torch.fem.mesh import BoxMesh, IntervalMesh, Point, RectangleMesh
from pgdrome_tpu_torch.fem.space import FunctionSpace, VectorFunctionSpace
from pgdrome_tpu_torch.fem.bc import DirichletBC
from pgdrome_tpu_torch.fem.assembly import (
    mass_matrix,
    stiffness_matrix,
    load_vector,
)
from pgdrome_tpu_torch.separated import SeparatedProblem, host_f64


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


def elliptic_dense_verifier(Vs, tf=None, n_random: int = 16,
                            seeds=(7, 101, 1234, 777),
                            corner_cap: int | None = None,
                            n_edge: int = 0, rhs_vec=None):
    """Dense held-out verifier for :func:`parametric_elliptic` results:
    returns ``verify(result) -> {"corners", "interior", "max",
    "worst_points", "worst_errors"}`` with the max relative L2 error vs a
    per-sample banded f64 FEM solve at the 2^d parameter-box corners (inset
    by one grid cell) plus ``n_random`` on-grid samples per seed, and
    ``n_edge`` edge/face samples per seed (a random 1..d−1 dims pinned at
    the box extremes; their errors count toward "corners").  The points are
    drawn as the JAX package draws them, in the same order.

    Vs: the builder's spaces; tf: the dim-0 transform when the result's
    space modes live in the ``precondition_dim0`` basis, else None.
    corner_cap: a fixed-seed corner subset plus both all-lo/all-hi
    extremes instead of all 2^d.  rhs_vec: verify against FEM solves of
    this fixed rhs instead of the unit load (adjoint vademecums).

    The result's modes may be tensors on any device or arrays; they are
    evaluated on the host in their own dtype, the reconstruction in f64.
    Beside the JAX package's attributes ``verify.sample_errors(result,
    points)`` and ``verify.corners``, ``verify.samples`` holds the
    held-out set: ``{"corners": (n_c, d)}`` and, per seed, its random and
    edge points concatenated, in draw order."""
    from pgdrome_tpu_torch.separated import evaluate_modes_1d, host_f64

    Vx = Vs[0]
    num_params = len(Vs) - 1
    fem_solve = elliptic_fem_solver(Vx, num_params, rhs_vec=rhs_vec)
    grid = Vs[1].tabulate_dof_coordinates()[:, 0]
    lo, hi = grid[1], grid[-2]
    n_c = 2 ** num_params
    idx = np.arange(n_c)
    if corner_cap and n_c > corner_cap:
        rng_c = np.random.default_rng(0)
        idx = np.concatenate(
            [[0, n_c - 1],
             rng_c.choice(n_c - 2, size=corner_cap - 2, replace=False) + 1]
        )
    corners = box_corners(lo, hi, num_params, idx)

    draws = []  # (seed, randoms or None, edges or None)
    for seed in seeds:
        rng = np.random.default_rng(seed)
        randoms = edges = None
        if n_random:
            randoms = grid[rng.integers(1, len(grid) - 1, size=(n_random, num_params))]
        if n_edge:
            edges = grid[rng.integers(1, len(grid) - 1, size=(n_edge, num_params))]
            for r in range(n_edge):
                k = int(rng.integers(1, num_params)) if num_params > 1 else 1
                dims = rng.choice(num_params, size=k, replace=False)
                edges[r, dims] = np.where(rng.integers(0, 2, size=k) == 0, lo, hi)
        draws.append((seed, randoms, edges))

    def _full0(res):
        m0 = res.modes[0]
        return host_f64(tf.modes_to_full(m0) if tf is not None else m0)

    def _errors(res, full0, samples):
        samples = np.asarray(samples, dtype=np.float64)
        fac = np.ones((len(samples), res.n_modes))
        for j in range(num_params):
            m = torch.as_tensor(res.modes[1 + j]).detach().cpu()
            vals = evaluate_modes_1d(Vs[1 + j], m, torch.as_tensor(samples[:, j]))
            fac *= host_f64(vals)[:, : res.n_modes]
        errs = []
        for p, f in zip(samples, fac):
            u_ref = fem_solve(p)
            u = f @ full0[: res.n_modes]
            errs.append(np.linalg.norm(u - u_ref) / np.linalg.norm(u_ref))
        return np.asarray(errs)

    def sample_errors(res, samples):
        """Per-sample relative L2 errors vs f64 FEM at arbitrary parameter
        points (the feedback channel for corner-seeded stages)."""
        return _errors(res, _full0(res), samples)

    def verify(res):
        full0 = _full0(res)
        b_pts = [corners]
        b_errs = [_errors(res, full0, corners)]
        mc = float(b_errs[0].max())
        mi = 0.0
        for _, randoms, edges in draws:
            if randoms is not None:
                mi = max(mi, float(_errors(res, full0, randoms).max()))
            if edges is not None:
                e = _errors(res, full0, edges)
                b_pts.append(edges)
                b_errs.append(e)
                mc = max(mc, float(e.max()))
        # worst boundary points, worst first
        bp = np.concatenate(b_pts)
        be = np.concatenate(b_errs)
        order = np.argsort(be)[::-1][:128]
        return {
            "corners": mc, "interior": mi, "max": max(mc, mi),
            "worst_points": bp[order], "worst_errors": be[order],
        }

    verify.sample_errors = sample_errors
    verify.corners = corners
    verify.samples = {"corners": corners}
    for seed, randoms, edges in draws:
        verify.samples[seed] = np.concatenate(
            [a for a in (randoms, edges) if a is not None]
            or [np.zeros((0, num_params))]
        )
    return verify


def corner_seeded_init(target_corners, p_lo, p_hi, q: int = 6,
                       bg: float = 0.02, seed: int = 500):
    """Fixed-point seed factory for corner-targeted enrichment stages
    (``SeparatedPGD(fp_init=...)``).

    An end-localized rank-1 target has ~(1/n_p)^(d-1) overlap with the
    default ones init, so at high d the alternating sweeps never find it.
    Mode ``n`` is seeded at ``target_corners[n % len(target_corners)]``:
    each parameter factor starts as an end bump (s^q toward that corner's
    side) over a small random background, the space factor random, all
    drawn from ``default_rng(seed + n)`` as the JAX package draws them.
    Feed the verifier's measured worst points, re-ranked every stage."""
    target_corners = np.asarray(target_corners, dtype=np.float64)
    mid = 0.5 * (p_lo + p_hi)

    def init(nmode, sizes):
        rng = np.random.default_rng(seed + nmode)
        c = target_corners[nmode % len(target_corners)]
        out = [rng.uniform(-1.0, 1.0, size=sizes[0])]
        for j in range(1, len(sizes)):
            s = np.linspace(-1.0, 1.0, sizes[j])
            side_hi = c[j - 1] > mid
            bump = np.clip(s if side_hi else -s, 0.0, None) ** q
            out.append(bump + bg * rng.uniform(-1.0, 1.0, size=sizes[j]))
        return tuple(out)

    return init


def poisson_xy(n_x: int = 60, n_y: int = 40, lx: float = 1.0, ly: float = 1.0,
               k: float = 1.0, dtype=None):
    """2D Poisson separated as x⊗y (two 1D P1 meshes): −kΔu = q with
    q = 1_{x<lx/2}, homogeneous Dirichlet at x ∈ {0, lx}
    (BASELINE.json config 1; the physics of reference test_laplace)."""
    Vx = FunctionSpace(IntervalMesh(n_x, 0.0, lx), "P", 1)
    Vy = FunctionSpace(IntervalMesh(n_y, 0.0, ly), "P", 1)
    Kx, Mx = stiffness_matrix(Vx), mass_matrix(Vx)
    Ky, My = stiffness_matrix(Vy), mass_matrix(Vy)

    ops = [np.stack([k * Kx, k * Mx]), np.stack([My, Ky])]
    qx = load_vector(Vx, lambda x: np.where(x < lx / 2, 1.0, 0.0))
    qy = load_vector(Vy, lambda y: np.ones_like(y))
    rhs = [qx[None, :], qy[None, :]]

    bc_x = DirichletBC(Vx, 0.0, lambda x, onb: onb)
    bc_dofs = [bc_x.dofs, np.array([], dtype=np.int64)]
    mass = [Mx, My]

    dt = dtype or np.float64
    prob = SeparatedProblem(
        ops=[np.asarray(o, dtype=dt) for o in ops],
        rhs=[np.asarray(r, dtype=dt) for r in rhs],
        mass=[np.asarray(m, dtype=dt) for m in mass],
        bc_dofs=bc_dofs,
    )
    return prob, [Vx, Vy]


def elastic_truss(n_x=113, n_p=2, n_E=100, ranges=((0, 1), (-1, 3), (0.2, 2)),
                  degree=2, dtype=None):
    """1D truss u(x, p, E): −(E u')' = p on x ∈ (0, 1), u = 0 at both ends,
    with the load p and the modulus E as coordinates (BASELINE.json config
    4 in 1D; the physics of reference test_elastic and of
    ``examples/reference_style_truss.py``).  Its exact discrete solution is
    rank 1 (K_x ⊗ M_p ⊗ M_E,w against a rank-1 load)."""
    Vx = FunctionSpace(IntervalMesh(n_x, *ranges[0]), "P", degree)
    Vp = FunctionSpace(IntervalMesh(n_p, *ranges[1]), "P", degree)
    VE = FunctionSpace(IntervalMesh(n_E, *ranges[2]), "P", degree)

    Kx = stiffness_matrix(Vx)
    Mp = mass_matrix(Vp)
    ME_w = mass_matrix(VE, weight=lambda E: E)

    ops = [Kx[None], Mp[None], ME_w[None]]
    bx = load_vector(Vx, lambda x: np.ones_like(x))
    bp = load_vector(Vp, lambda p: p)
    bE = load_vector(VE, lambda E: np.ones_like(E))
    rhs = [bx[None, :], bp[None, :], bE[None, :]]

    bc_x = DirichletBC(Vx, 0.0, lambda x, onb: onb)
    bc_dofs = [bc_x.dofs, np.array([], dtype=np.int64), np.array([], dtype=np.int64)]
    mass = [mass_matrix(Vx), Mp, mass_matrix(VE)]

    dt = dtype or np.float64
    prob = SeparatedProblem(
        ops=[np.asarray(o, dtype=dt) for o in ops],
        rhs=[np.asarray(r, dtype=dt) for r in rhs],
        mass=[np.asarray(m, dtype=dt) for m in mass],
        bc_dofs=bc_dofs,
    )
    return prob, [Vx, Vp, VE]


def pgd_problem_from_separated(sep: SeparatedProblem, Vs, name="separated"):
    """Run any separated problem through the reference-parity
    :class:`~pgdrome_tpu_torch.solver.PGDProblem` (generic callbacks over
    the term stacks, taken to host f64).  The cross-check of the device
    solver's amplitudes, and the single-core host baseline of bench.py."""
    from pgdrome_tpu_torch.solver import PGDProblem

    ops = [host_f64(o) for o in sep.ops]
    rhs = [host_f64(r) for r in sep.rhs]
    nd = sep.num_dims
    T = sep.num_terms

    def lhs_fct(fct_F, var_F, Fs, meshes, dom, param, typ, dim):
        if dim >= nd:  # 'stiff' norming evaluation on the last dim
            dim = nd - 1
        coef = np.ones(T)
        for j in range(nd):
            if j != dim:
                coef = coef * np.einsum("tij,i,j->t", ops[j], Fs[j].array, Fs[j].array)
        return np.einsum("t,tij->ij", coef, ops[dim])

    def rhs_fct(fct_F, var_F, Fs, meshes, dom, param, load, PGD_func, typ, n_enr, dim):
        rcoef = np.ones(sep.num_rhs)
        for j in range(nd):
            if j != dim:
                rcoef = rcoef * (rhs[j] @ Fs[j].array)
        b = rcoef @ rhs[dim]
        for o in range(n_enr):
            coef = np.ones(T)
            for j in range(nd):
                if j != dim:
                    coef = coef * np.einsum(
                        "tij,i,j->t", ops[j], Fs[j].array, PGD_func[j][o].array
                    )
            b = b - np.einsum("t,tij,j->i", coef, ops[dim], PGD_func[dim][o].array)
        return b

    def bc_fct(Vlist, dom, param):
        out = []
        for d in range(nd):
            if sep.bc_dofs[d] is not None and len(sep.bc_dofs[d]):
                bc = DirichletBC.__new__(DirichletBC)
                bc._V = Vlist[d]
                bc.component = None
                bc.dofs = np.asarray(sep.bc_dofs[d], dtype=np.int64)
                bc.values = np.zeros(len(bc.dofs))
                out.append(bc)
            else:
                out.append(0)
        return out

    return PGDProblem(
        name=name,
        name_coord=[f"D{i}" for i in range(nd)],
        modes_info=["U", "Node", "Scalar"],
        Vs=Vs,
        bc_fct=bc_fct,
        load=[None] * nd,
        param={},
        rhs_fct=rhs_fct,
        lhs_fct=lhs_fct,
        probs=list(range(nd)),
        seq_fp=list(range(nd)),
    )


def transient_heat_2d(nx: int = 12, ny: int = 12, n_t: int = 50, lx: float = 1.0,
                      ly: float = 1.0, lt: float = 1.0, rho_cp: float = 1.0,
                      k: float = 0.1, dtype=None):
    """Transient heat on a 2D crossed triangulation ⊗ 1D FD-upwind time:
    rho·cp ∂T/∂t − k ΔT = q(x, y), natural space conditions, T(t=0) = 0
    (constant ambient lifts drop out of the homogenised rhs since K·1 = 0
    and D1_up·1 = 0).  q is a Gaussian bump at the centre, constant in
    time.  Returns ``(problem, [V2, Vt])``."""
    from pgdrome_tpu_torch.ops.fd import FD_matrices

    V2 = FunctionSpace(RectangleMesh(Point(0, 0), Point(lx, ly), nx, ny, "crossed"), "P", 1)
    Vt = FunctionSpace(IntervalMesh(n_t, 0.0, lt), "P", 1)
    M2 = mass_matrix(V2)
    K2 = stiffness_matrix(V2)
    t_grid = Vt.tabulate_dof_coordinates()[:, 0]
    M_t, _, D1_up = FD_matrices(t_grid)
    ops = [np.stack([rho_cp * M2, k * K2]), np.stack([D1_up, M_t])]
    xc, yc, a = lx / 2, ly / 2, 0.15 * lx
    q2 = load_vector(
        V2, lambda p: np.exp(-(((p[..., 0] - xc) ** 2 + (p[..., 1] - yc) ** 2) / a ** 2)))
    rhs = [q2[None, :], (M_t @ np.ones(len(t_grid)))[None, :]]
    bc_dofs = [np.array([], dtype=np.int64), np.array([0], dtype=np.int64)]  # t = 0
    dt = dtype or np.float64
    prob = SeparatedProblem(
        ops=[np.asarray(o, dtype=dt) for o in ops],
        rhs=[np.asarray(r, dtype=dt) for r in rhs],
        mass=[np.asarray(m, dtype=dt) for m in (M2, M_t)],
        bc_dofs=bc_dofs,
    )
    return prob, [V2, Vt]


def moving_heat_source(
    n_x: int = 120,
    n_t: int = 80,
    n_P: int = 10,
    n_v: int = 16,
    v_range=(0.5, 1.0),
    P_range=(0.5, 1.0),
    af: float = 0.08,
    xc0: float = 0.15,
    rho_cp: float = 1.0,
    k: float = 0.05,
    source_rank: int = 40,
    separation: str = "greedy",
    separation_tol: float = 1e-5,
    dtype=None,
):
    """Moving heat-source welding/AM surrogate: space ⊗ time ⊗ power ⊗
    velocity.

        rho·cp ∂T/∂t − k ∂²T/∂x² = P · g(x − v·t),
        g = exp(−(x − xc0 − v·t)²/af²),  T(t=0) = 0 (lift external)

    The non-separable moving source is factorized into rank-1 (x,t,v)
    terms — ``separation='greedy'`` (ALS CP sweep, `source_rank` terms) or
    ``'hierarchical'`` (two-level SVD, far better accuracy per term for
    transport-like sources); the power dimension enters linearly.  Time
    uses FD upwind (backward-Euler equivalent, reference test_heat1D.py
    FDtime semantics).

    Returns (problem, spaces, source_factors, separation_rel_error)."""
    from pgdrome_tpu_torch.ops.fd import FD_matrices
    from pgdrome_tpu_torch.utils.separation import (
        separate,
        separate_hierarchical,
        separation_error,
    )

    Vx = FunctionSpace(IntervalMesh(n_x, 0.0, 1.0), "P", 1)
    Vt = FunctionSpace(IntervalMesh(n_t, 0.0, 1.0), "P", 1)
    VP = FunctionSpace(IntervalMesh(n_P, *P_range), "P", 1)
    Vv = FunctionSpace(IntervalMesh(n_v, *v_range), "P", 1)

    Mx, Kx = mass_matrix(Vx), stiffness_matrix(Vx)
    t_grid = Vt.tabulate_dof_coordinates()[:, 0]
    M_t, _, D1_up = FD_matrices(t_grid)
    MP = mass_matrix(VP)
    Mv = mass_matrix(Vv)

    ops = [
        np.stack([rho_cp * Mx, k * Kx]),
        np.stack([D1_up, M_t]),
        np.stack([MP, MP]),
        np.stack([Mv, Mv]),
    ]

    # separate g(x - v t) over the (x, t, v) tensor grid
    x_grid = Vx.tabulate_dof_coordinates()[:, 0]
    v_grid = Vv.tabulate_dof_coordinates()[:, 0]
    X, Tm, Vm = np.meshgrid(x_grid, t_grid, v_grid, indexing="ij")
    g = np.exp(-((X - xc0 - Vm * Tm) ** 2) / af**2)
    if separation == "hierarchical":
        # separation_tol bounds the per-level SVD truncation: the knob
        # that matters once the solver cascade passes the separation floor
        factors = separate_hierarchical(g, tol=separation_tol,
                                        max_terms=source_rank)
    else:
        factors = separate(g, source_rank, tol=1e-12)
    sep_err = separation_error(g, factors)
    R = factors[0].shape[0]

    bP = load_vector(VP, lambda P: P)  # power enters linearly
    rhs = [
        factors[0] @ Mx.T,           # (R, n_x): weak x factors  M_x g_r
        factors[1] @ M_t.T,          # (R, n_t): FD-time mass weighting
        np.tile(bP[None, :], (R, 1)),
        factors[2] @ Mv.T,
    ]

    bc_dofs = [
        np.array([], dtype=np.int64),
        np.array([0], dtype=np.int64),  # IC at t = 0
        np.array([], dtype=np.int64),
        np.array([], dtype=np.int64),
    ]
    mass = [Mx, M_t, MP, Mv]

    dt = dtype or np.float64
    prob = SeparatedProblem(
        ops=[np.asarray(o, dtype=dt) for o in ops],
        rhs=[np.asarray(r, dtype=dt) for r in rhs],
        mass=[np.asarray(m, dtype=dt) for m in mass],
        bc_dofs=bc_dofs,
    )
    return prob, [Vx, Vt, VP, Vv], factors, sep_err


def transient_parametric_conductivity(
    n_x: int = 128,
    n_t: int = 64,
    n_p: int = 32,
    num_params: int = 2,
    p_range=(0.0, 1.0),
    rho_cp: float = 1.0,
    lt: float = 1.0,
    dtype=None,
):
    """OPERATOR-parametric transient heat: dims x ⊗ t ⊗ p_1..p_P with

        rho·cp ∂u/∂t − ∇·(κ(x; p) ∇u) = q(x)·s(t),
        κ(x; p) = 1 + Σ_i p_i sin²(iπx)/(2P),  u(0)=u(1)=0,  u(t=0)=0

    — the transient family whose PARAMETERS sit in the operator (the
    elliptic vademecum's κ driven through an upwind time stencil), so an
    exact closed form of the outputs does not apply and they need the
    backward-in-time adjoint.  q = Gaussian bump, s = sin ramp
    (rank-1 separated source, EXACT — unlike :func:`moving_heat_source`
    the truth has no source-separation floor, so this isolates the
    operator-parametric question).

    Parameter dims are collocation-lumped: at every parameter grid
    point the tensor system IS the masked space-time FEM/FD system
    (same cancellation argument as :func:`parametric_elliptic`), which
    :func:`transient_conductivity_fom` solves exactly for truth.

    Returns ``(SeparatedProblem, [Vx, Vt, Vp...])``."""
    from pgdrome_tpu_torch.ops.fd import FD_matrices

    Vx = FunctionSpace(IntervalMesh(n_x, 0.0, 1.0), "P", 1)
    Vt = FunctionSpace(IntervalMesh(n_t, 0.0, lt), "P", 1)
    Vp = [
        FunctionSpace(IntervalMesh(n_p, p_range[0], p_range[1]), "P", 1)
        for _ in range(num_params)
    ]

    Mx = mass_matrix(Vx)
    K0 = stiffness_matrix(Vx)
    Kw = [
        stiffness_matrix(
            Vx,
            weight=(lambda i: (lambda x: np.sin((i + 1) * np.pi * x) ** 2
                               / (2 * num_params)))(i),
        )
        for i in range(num_params)
    ]
    t_grid = Vt.tabulate_dof_coordinates()[:, 0]
    M_t, _, D1_up = FD_matrices(t_grid)
    Mp = [mass_matrix(v) for v in Vp]
    Mp_w = [mass_matrix(v, weight=lambda p: p) for v in Vp]
    Mp_op = [np.diag(m.sum(axis=1)) for m in Mp]
    Mp_w_op = [np.diag(m.sum(axis=1)) for m in Mp_w]

    T = 2 + num_params
    ops = [
        np.stack([rho_cp * Mx, K0] + Kw),
        np.stack([D1_up] + [M_t] * (1 + num_params)),
    ]
    for j in range(num_params):
        mats = []
        for t in range(T):
            mats.append(Mp_w_op[j] if t == 2 + j else Mp_op[j])
        ops.append(np.stack(mats))

    xc, a = 0.4, 0.1
    q_x = load_vector(Vx, lambda x: np.exp(-((x - xc) ** 2) / a ** 2))
    q_t = M_t @ np.sin(np.pi * t_grid / lt)
    rhs = [q_x[None, :], q_t[None, :]] + [
        np.diag(Mp_op[j])[None, :] for j in range(num_params)
    ]

    bc_x = DirichletBC(Vx, 0.0, lambda x, onb: onb)
    bc_dofs = ([bc_x.dofs, np.array([0], dtype=np.int64)]
               + [np.array([], dtype=np.int64)] * num_params)
    mass = [Mx, M_t] + Mp

    dt = dtype or np.float64
    prob = SeparatedProblem(
        ops=[np.asarray(o, dtype=dt) for o in ops],
        rhs=[np.asarray(r, dtype=dt) for r in rhs],
        mass=[np.asarray(m, dtype=dt) for m in mass],
        bc_dofs=bc_dofs,
    )
    return prob, [Vx, Vt] + Vp


def transient_conductivity_fom(sep, Vs):
    """Exact f64 space-time FOM for
    :func:`transient_parametric_conductivity`: returns
    ``solve(p) -> (n_x, n_t)`` solving the MASKED kron system

        [Σ_t θ_t(p) A_t^x ⊗ A_t^τ]  (collocation weights cancel)

    by sparse LU — bit-consistent with what the separated solver's
    per-grid-point semantics converge to, so corrected-output errors
    measured against it are solver truth (the source is rank-1 exact;
    no separation floor).  θ read off the collocation diagonals by P1
    interpolation (exact at grid points)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    num_params = sep.num_dims - 2
    Ax = np.asarray(sep.ops[0], dtype=np.float64)
    At = np.asarray(sep.ops[1], dtype=np.float64)
    T = Ax.shape[0]
    mx = np.asarray(sep.bc_masks[0], dtype=np.float64)
    mt = np.asarray(sep.bc_masks[1], dtype=np.float64)
    m = (mx[:, None] * mt[None, :]).ravel()
    bx = np.asarray(sep.rhs[0], dtype=np.float64)[0]
    bt = np.asarray(sep.rhs[1], dtype=np.float64)[0]
    b = (np.outer(bx, bt).ravel()) * m
    grids = [Vs[2 + j].tabulate_dof_coordinates()[:, 0]
             for j in range(num_params)]
    w = [np.diagonal(np.asarray(sep.ops[2 + j], dtype=np.float64)[0])
         for j in range(num_params)]
    thetas = [
        np.diagonal(np.asarray(sep.ops[2 + j], dtype=np.float64),
                    axis1=1, axis2=2) / w[j][None, :]
        for j in range(num_params)
    ]
    kron_terms = [
        sp.kron(sp.csr_matrix(Ax[t] * mx[:, None] * mx[None, :]),
                sp.csr_matrix(At[t] * mt[:, None] * mt[None, :]),
                format="csr")
        for t in range(T)
    ]
    eye_bc = sp.diags(1.0 - m)

    def solve(p):
        th = np.ones(T)
        for j in range(num_params):
            for t in range(T):
                th[t] *= np.interp(p[j], grids[j], thetas[j][t])
        A = eye_bc.copy()
        for t in range(T):
            A = A + th[t] * kron_terms[t]
        u = spla.spsolve(A.tocsc(), b)
        return u.reshape(Ax.shape[1], At.shape[1])

    return solve


def transient_dense_verifier(sep, Vs, factors, *, af: float = 0.08,
                             xc0: float = 0.15, true_source: bool = True,
                             n_random: int = 6, seeds=(7, 101)):
    """Dense held-out verifier for :func:`moving_heat_source` results:
    the reference ``PGDErrorComputation`` discipline (model.py:1768-1825)
    for the TRANSIENT family, mirroring
    :func:`elliptic_dense_verifier`'s role for the elliptic one.

    Per sample (an on-grid ``(P, v)`` pair) the full-order model is the
    SPARSE SPACE-TIME solve  A u = b(P, v)  with the problem's own
    backward-Euler-equivalent operator
    ``A = Σ_t kron(ops[0][t], ops[1][t])`` (parameter-independent for
    this family — one LU factorization serves every sample) and the load
    built from the EXACT Gaussian ``P·g(x − xc0 − v·t)`` when
    ``true_source`` (default: measures the END-TO-END error including
    the source-separation truncation) or from the separated ``factors``
    otherwise (isolates the solver error from the separation floor).

    Returns ``verify(result) -> {"corners", "interior", "max",
    "worst_points", "worst_errors"}`` over the 4 parameter-box corners
    plus ``n_random`` random on-grid samples per seed, with
    ``verify.sample_errors(result, idx_pairs)`` as the per-point
    feedback channel (``idx_pairs``: integer ``(ip, iv)`` grid indices).
    Results must be NODAL-basis (the
    :func:`~pgdrome_tpu_torch.recipes.two_stage_minres` convention);
    ``worst_points`` are physical ``(P, v)`` values ranked worst-first,
    plug-compatible with the corner seeding of
    :func:`~pgdrome_tpu_torch.recipes.adaptive_cascade`.  Mode buffers may
    be host arrays or tensors."""
    from scipy import sparse as sps
    from scipy.sparse import linalg as spla

    if len(Vs) != 4:
        raise ValueError(
            "transient_dense_verifier covers the moving_heat_source "
            "family: spaces (x, t, P, v)"
        )
    nx, nt = sep.sizes[0], sep.sizes[1]
    # the per-sample operator drops the parameter mass factors, which is
    # only valid when they ARE the mass (pointwise coefficient 1)
    for d in (2, 3):
        od = np.asarray(sep.ops[d], dtype=np.float64)
        md = np.asarray(sep.mass[d], dtype=np.float64)
        for t in range(od.shape[0]):
            if not np.allclose(od[t], md, rtol=0.0,
                               atol=1e-12 * np.abs(md).max()):
                raise ValueError(
                    f"parameter dim {d} operator term {t} is not the "
                    "mass: the space-time FOM would need per-sample "
                    "operator coefficients"
                )
    ops0 = np.asarray(sep.ops[0], dtype=np.float64)
    ops1 = np.asarray(sep.ops[1], dtype=np.float64)
    A = sum(
        sps.kron(sps.csr_matrix(ops0[t]), sps.csr_matrix(ops1[t]))
        for t in range(ops0.shape[0])
    ).tolil()
    ic_rows = [ix * nt for ix in range(nx)]
    for rr in ic_rows:
        A.rows[rr] = [rr]
        A.data[rr] = [1.0]
    lu = spla.splu(A.tocsr().tocsc())

    Mx = np.asarray(sep.mass[0], dtype=np.float64)
    Mt = np.asarray(sep.ops[1][1], dtype=np.float64)
    MxF = np.asarray(factors[0], dtype=np.float64) @ Mx.T  # (R, nx)
    MtF = np.asarray(factors[1], dtype=np.float64) @ Mt.T  # (R, nt)
    x_grid = Vs[0].tabulate_dof_coordinates()[:, 0]
    t_grid = Vs[1].tabulate_dof_coordinates()[:, 0]
    P_grid = Vs[2].tabulate_dof_coordinates()[:, 0]
    v_grid = Vs[3].tabulate_dof_coordinates()[:, 0]

    def _errors(res, idx_pairs):
        K = res.n_modes
        m0 = host_f64(res.modes[0])[:K]
        m1 = host_f64(res.modes[1])[:K]
        errs = []
        for ip, iv in idx_pairs:
            P_val = P_grid[ip]
            if true_source:
                g = np.exp(
                    -((x_grid[:, None] - xc0 - v_grid[iv] * t_grid[None, :])
                      ** 2) / af ** 2
                )
                b = P_val * (Mx @ g @ Mt.T).ravel()
            else:
                w = P_val * np.asarray(factors[2], dtype=np.float64)[:, iv]
                b = np.einsum("r,ri,rj->ij", w, MxF, MtF).ravel()
            b[ic_rows] = 0.0
            u_fom = lu.solve(b).reshape(nx, nt)
            fac = host_f64(res.modes[2])[:K, ip] * host_f64(res.modes[3])[:K, iv]
            u = np.einsum("k,ki,kj->ij", fac, m0, m1)
            errs.append(np.linalg.norm(u - u_fom) / np.linalg.norm(u_fom))
        return np.asarray(errs)

    def sample_errors(res, idx_pairs):
        """Per-sample relative space-time L2 errors vs the sparse FOM at
        integer (ip, iv) grid-index pairs."""
        return _errors(res, np.asarray(idx_pairs, dtype=np.int64))

    n_P, n_v = len(P_grid), len(v_grid)
    corner_idx = [(0, 0), (0, n_v - 1), (n_P - 1, 0), (n_P - 1, n_v - 1)]

    def verify(res):
        ec = _errors(res, corner_idx)
        mc = float(ec.max())
        mi = 0.0
        for seed in seeds:
            rng = np.random.default_rng(seed)
            if n_random:
                idx = np.stack(
                    [rng.integers(1, n_P - 1, size=n_random),
                     rng.integers(1, n_v - 1, size=n_random)], axis=1
                )
                mi = max(mi, float(_errors(res, idx).max()))
        order = np.argsort(ec)[::-1]
        pts = np.array([[P_grid[i], v_grid[j]] for i, j in corner_idx])
        return {
            "corners": mc, "interior": mi, "max": max(mc, mi),
            "worst_points": pts[order], "worst_errors": ec[order],
        }

    verify.sample_errors = sample_errors
    verify.corner_indices = corner_idx
    return verify


def plane_strain_C(nu: float) -> np.ndarray:
    """Plane-strain elasticity tensor (Voigt 3×3) for unit E."""
    a = 1.0 / ((1 + nu) * (1 - 2 * nu))
    return a * np.array(
        [[1 - nu, nu, 0.0], [nu, 1 - nu, 0.0], [0.0, 0.0, (1 - 2 * nu) / 2]]
    )


# the ν-separated plane-strain tensor C(ν) = f1(ν)·C1 + f2(ν)·C2, with the
# rational coefficients f1, f2 below
_C1 = np.array([[1.0, 1.0, 0.0], [1.0, 1.0, 0.0], [0.0, 0.0, 0.0]])
_C2 = np.array([[1.0, -1.0, 0.0], [-1.0, 1.0, 0.0], [0.0, 0.0, 1.0]])


def _nu_f1(nu):
    return 1.0 / (2.0 * (1.0 + nu) * (1.0 - 2.0 * nu))


def _nu_f2(nu):
    return 1.0 / (2.0 * (1.0 + nu))


def elasticity_vademecum(nx: int = 40, ny: int = 8, n_p: int = 16, n_E: int = 16,
                         p_range=(0.0, 2.0), E_range=(0.5, 1.5), E_0: float = 30000.0,
                         nu: float = 0.2, L=(1000.0, 100.0), degree: int = 2,
                         n_nu: int = 0, nu_range=(0.1, 0.4),
                         param_discretization: str = "galerkin", dtype=None):
    """2D plane-strain elasticity vademecum on a vector P2 (``degree``)
    field over a crossed ``nx × ny`` mesh of ``L``:

        ∫ ε(v) : λE·E0·C(ν) : ε(u) dx = λp · ∫ g·v ds(top),

    clamped at x = 0, loaded downwards on the top edge (−0.5 left of the
    middle, −1.5 right of it).  ``n_nu == 0``: ν fixed, u((x, y), λp, λE),
    one elasticity term.  ``n_nu > 0``: Poisson's ratio is the fourth
    coordinate (the 4-dim flagship), C(ν) = f1(ν)·C1 + f2(ν)·C2 with the
    rational f1, f2 entering as collocation (diagonal) ν operators, so the
    converged vademecum equals fixed-ν FEM at the ν grid points.

    ``param_discretization``: ``"galerkin"`` (consistent P1 masses on the
    λp/λE dims; on-grid values carry the O(h²) projection bias) or
    ``"collocation"`` (pointwise-lumped λp/λE operators and loads: the
    converged vademecum equals per-sample FEM at every grid point).

    Returns ``(problem, [Vx, Vp, VE(, Vnu)], (C_or_(C1, C2), bL, bR))``."""
    from pgdrome_tpu_torch.fem.assembly import (
        boundary_load_vector,
        elasticity_matrix,
        vector_mass_matrix,
    )
    from pgdrome_tpu_torch.fem.function import Expression

    if param_discretization not in ("galerkin", "collocation"):
        raise ValueError(f"unknown param_discretization {param_discretization!r}")
    mesh_x = RectangleMesh(Point(0, 0), Point(L[0], L[1]), nx, ny, "crossed")
    Vx = VectorFunctionSpace(mesh_x, "P", degree)
    Vp = FunctionSpace(IntervalMesh(n_p, *p_range), "P", 1)
    VE = FunctionSpace(IntervalMesh(n_E, *E_range), "P", 1)

    Mp = mass_matrix(Vp)
    ME_w = mass_matrix(VE, weight=lambda E: E)
    if param_discretization == "collocation":
        # pointwise lumping: diagonal w_i·weight(x_i), so the plain weights
        # w_i cancel per grid point (row sums of the weighted consistent
        # mass would carry an endpoint bias at the box corners)
        Mp_op = np.diag(Mp.sum(axis=1))
        ME_w_op = np.diag(mass_matrix(VE).sum(axis=1) * VE.tabulate_dof_coordinates()[:, 0])
    else:
        Mp_op, ME_w_op = Mp, ME_w

    g1 = Expression((lambda p: 0.0 * p[..., 0], lambda p: -0.5 * np.ones_like(p[..., 0])))
    g2 = Expression((lambda p: 0.0 * p[..., 0], lambda p: -1.5 * np.ones_like(p[..., 0])))
    bL = boundary_load_vector(Vx, g1, lambda m: abs(m[1] - L[1]) < 1e-9 and m[0] < L[0] / 2)
    bR = boundary_load_vector(Vx, g2, lambda m: abs(m[1] - L[1]) < 1e-9 and m[0] > L[0] / 2)
    if param_discretization == "collocation":
        # the load lumped like the operators, or the weights would not
        # cancel at the corners
        bp = Mp.sum(axis=1) * Vp.tabulate_dof_coordinates()[:, 0]
    else:
        bp = load_vector(Vp, lambda p: p)
    bE = load_vector(VE, lambda E: np.ones_like(E))  # exact either way: the row sums

    bc_x = DirichletBC(Vx, (0.0, 0.0), lambda p: abs(p[0]) < 1e-9)
    no_bc = np.array([], dtype=np.int64)
    if n_nu:
        Vnu = FunctionSpace(IntervalMesh(n_nu, *nu_range), "P", 1)
        K1 = elasticity_matrix(Vx, _C1)
        K2 = elasticity_matrix(Vx, _C2)
        nu_pts = Vnu.tabulate_dof_coordinates()[:, 0]
        w_nu = mass_matrix(Vnu).sum(axis=1)  # lumped collocation weights
        ops = [E_0 * np.stack([K1, K2]), np.stack([Mp_op, Mp_op]),
               np.stack([ME_w_op, ME_w_op]),
               np.stack([np.diag(w_nu * _nu_f1(nu_pts)), np.diag(w_nu * _nu_f2(nu_pts))])]
        rhs = [np.stack([bL, bR]), np.stack([bp, bp]), np.stack([bE, bE]),
               np.stack([w_nu, w_nu])]  # the ones load in the collocation measure
        bc_dofs = [bc_x.dofs, no_bc, no_bc, no_bc]
        mass = [vector_mass_matrix(Vx), Mp, mass_matrix(VE), mass_matrix(Vnu)]
        spaces = [Vx, Vp, VE, Vnu]
        C_out = (_C1, _C2)
    else:
        C = plane_strain_C(nu)
        ops = [E_0 * elasticity_matrix(Vx, C)[None], Mp_op[None], ME_w_op[None]]
        rhs = [np.stack([bL, bR]), np.stack([bp, bp]), np.stack([bE, bE])]
        bc_dofs = [bc_x.dofs, no_bc, no_bc]
        mass = [vector_mass_matrix(Vx), Mp, mass_matrix(VE)]
        spaces = [Vx, Vp, VE]
        C_out = C
    dt = dtype or np.float64
    prob = SeparatedProblem(
        ops=[np.asarray(o, dtype=dt) for o in ops],
        rhs=[np.asarray(r, dtype=dt) for r in rhs],
        mass=[np.asarray(m, dtype=dt) for m in mass],
        bc_dofs=bc_dofs,
    )
    return prob, spaces, (C_out, bL, bR)


def _kappa_weight_3d(i: int, num_params: int):
    """Separated diffusion weight w_i(x, y, z) = sin²((i+1)πx)·sin²(πy)·
    sin²(πz)/(2P): κ = 1 + Σ p_i w_i ≥ 1/2 on the unit parameter box."""

    def w(pts):
        return (np.sin((i + 1) * np.pi * pts[..., 0]) ** 2
                * np.sin(np.pi * pts[..., 1]) ** 2
                * np.sin(np.pi * pts[..., 2]) ** 2 / (2 * num_params))

    return w


def parametric_elliptic_3d(n: int = 8, n_p: int = 32, num_params: int = 2,
                           p_range=(0.0, 1.0), dtype=None, degree_x: int = 1):
    """3D parametric diffusion vademecum: −∇·(κ∇u) = 1 on the unit cube
    (``BoxMesh`` Kuhn tets, P``degree_x``), homogeneous Dirichlet, with
    κ(x; p) = 1 + Σ_i p_i·w_i(x) (:func:`_kappa_weight_3d`).  The parameter
    dims use the collocation (lumped) discretization, so the converged
    vademecum equals per-grid-point FEM.  Returns ``(problem, [V_xyz,
    V_p1, ...])``."""
    Vx = FunctionSpace(BoxMesh(Point(0, 0, 0), Point(1, 1, 1), n, n, n), "P", degree_x)
    Vp = [FunctionSpace(IntervalMesh(n_p, p_range[0], p_range[1]), "P", 1)
          for _ in range(num_params)]
    K0 = stiffness_matrix(Vx)
    Kw = [stiffness_matrix(Vx, weight=_kappa_weight_3d(i, num_params))
          for i in range(num_params)]
    Mp = [mass_matrix(v) for v in Vp]
    # collocation lumping (exact for linear weights over P1 hats)
    Mp_op = [np.diag(m.sum(axis=1)) for m in Mp]
    Mp_w_op = [np.diag(mass_matrix(v, weight=lambda p: p).sum(axis=1)) for v in Vp]
    T = 1 + num_params
    ops = [np.stack([K0] + Kw)]
    for j in range(num_params):
        ops.append(np.stack([Mp_w_op[j] if t == j + 1 else Mp_op[j] for t in range(T)]))
    rhs = [load_vector(Vx, lambda x: np.ones(x.shape[:-1]))[None, :]]
    for v in Vp:
        rhs.append(load_vector(v, lambda p: np.ones_like(p))[None, :])
    bc_x = DirichletBC(Vx, 0.0, lambda x, onb: onb)
    dt = dtype or np.float64
    prob = SeparatedProblem(
        ops=[np.asarray(o, dtype=dt) for o in ops],
        rhs=[np.asarray(r, dtype=dt) for r in rhs],
        mass=[np.asarray(m, dtype=dt) for m in [mass_matrix(Vx)] + Mp],
        bc_dofs=[bc_x.dofs] + [np.array([], dtype=np.int64)] * num_params,
    )
    return prob, [Vx] + Vp


def elliptic3d_dense_verifier(Vs, tf=None, n_random: int = 8, seeds=(7, 101)):
    """Dense held-out verifier for :func:`parametric_elliptic_3d`: the max
    relative L2 error vs a per-sample f64 3D FEM solve (dense LU on the
    interior dofs) at the 2^d inset parameter-box corners plus
    ``n_random`` on-grid samples per seed.  Returns ``verify(result) ->
    {"corners", "interior", "max"}`` with ``verify.sample_errors(result,
    points)``, ``verify.corners`` and ``verify.samples`` (the corners and
    each seed's draws, as :func:`elliptic_dense_verifier` has them).  The
    result's modes may be tensors on any device or arrays; they are
    evaluated on the host in their own dtype, the reconstruction in f64."""
    from pgdrome_tpu_torch.separated import evaluate_modes_1d

    Vx = Vs[0]
    num_params = len(Vs) - 1
    b_full = load_vector(Vx, lambda x: np.ones(x.shape[:-1]))
    grid = Vs[1].tabulate_dof_coordinates()[:, 0]
    corners = box_corners(grid[1], grid[-2], num_params)
    free = np.setdiff1d(np.arange(Vx.dim()), DirichletBC(Vx, 0.0, lambda x, onb: onb).dofs)
    draws = {}
    for seed in seeds:
        rng = np.random.default_rng(seed)
        draws[seed] = grid[rng.integers(1, len(grid) - 1, size=(n_random, num_params))]

    def _errors(res, full0, samples):
        errs = []
        for p in np.asarray(samples, dtype=np.float64):
            def kappa(pts, p=p):
                return 1.0 + sum(p[i] * _kappa_weight_3d(i, num_params)(pts)
                                 for i in range(num_params))

            K = stiffness_matrix(Vx, weight=kappa)
            u_ref = np.zeros(Vx.dim())
            u_ref[free] = np.linalg.solve(K[np.ix_(free, free)], b_full[free])
            fac = np.ones(res.n_modes)
            for j in range(num_params):
                m = torch.as_tensor(res.modes[1 + j]).detach().cpu()
                vals = evaluate_modes_1d(Vs[1 + j], m, torch.tensor([p[j]], dtype=m.dtype))
                fac *= host_f64(vals)[0, : res.n_modes]
            u = fac @ full0[: res.n_modes]
            errs.append(np.linalg.norm(u - u_ref) / np.linalg.norm(u_ref))
        return np.asarray(errs)

    def _full0(res):
        m0 = res.modes[0]
        return host_f64(tf.modes_to_full(m0) if tf is not None else m0)

    def sample_errors(res, samples):
        return _errors(res, _full0(res), samples)

    def verify(res):
        full0 = _full0(res)
        mc = float(_errors(res, full0, corners).max())
        mi = max((float(_errors(res, full0, r).max()) for r in draws.values()), default=0.0)
        return {"corners": mc, "interior": mi, "max": max(mc, mi)}

    verify.sample_errors = sample_errors
    verify.corners = corners
    verify.samples = {"corners": corners, **draws}
    return verify


def nonlinear_elliptic(n_x: int = 1024, n_p: int = 64, num_params: int = 2,
                       p_range=(0.0, 1.0), boundary_boost=None, dtype=None):
    """Nonlinear parametric vademecum problem

        −∇·(κ(x; p) ∇u) + ε·u³ = f,   κ = 1 + Σ_i p_i sin²(iπx)/(2P)

    on [0, 1], homogeneous Dirichlet, the cubic term mass-lumped: at every
    parameter grid point the equation is the banded system
    K(p)u + ε·M_L u³ = b that :func:`nonlinear_elliptic_fom` solves by
    Newton for the truth.  ε is not built in: the same ε goes to the
    recipe (:func:`~pgdrome_tpu_torch.recipes.nonlinear_vademecum`), the
    truth solver and the verifier.

    Returns ``(sep_linear, Vs, ml)``: the linear part as a separated
    problem (the :func:`parametric_elliptic` family, P2 in space) and the
    lumped-mass diagonal ``ml`` of the cubic term."""
    sep, Vs = parametric_elliptic(n_x=n_x, n_p=n_p, num_params=num_params,
                                  p_range=p_range, degree_x=2, dtype=dtype,
                                  boundary_boost=boundary_boost)
    ml = mass_matrix(Vs[0]).sum(axis=1)  # lumped diagonal
    return sep, Vs, ml


def nonlinear_elliptic_fom(Vx, num_params, eps, ml):
    """Per-sample banded-Newton truth for :func:`nonlinear_elliptic`:
    ``solve(p) -> u`` of K(p)u + ε·M_L u³ = b, damped Newton on the
    interior dofs (the Jacobian K(p) + 3ε·diag(M_L u²) keeps the band, so
    a step is one banded f64 solve)."""
    from scipy.linalg import solve_banded

    b_full = load_vector(Vx, lambda x: np.ones_like(x))
    K_probe = stiffness_matrix(Vx)
    bw = max(k for k in range(K_probe.shape[0])
             if np.any(np.diagonal(K_probe, k) != 0.0))
    ml = np.asarray(ml, dtype=np.float64)

    def _banded(K):
        n = K.shape[0]
        ab = np.zeros((2 * bw + 1, n))
        for k in range(-bw, bw + 1):
            d = np.diagonal(K, k)
            if k >= 0:
                ab[bw - k, k:k + d.size] = d
            else:
                ab[bw - k, :d.size] = d
        return ab

    def solve(p, tol=1e-12, max_it=50):
        kappa = lambda x: 1.0 + sum(  # noqa: E731
            p[i] * np.sin((i + 1) * np.pi * x) ** 2 / (2 * num_params)
            for i in range(num_params))
        K = stiffness_matrix(Vx, weight=kappa)
        n = K.shape[0]
        i0, i1 = 1, n - 1  # the interval's Dirichlet ends
        Ki, bi, mli = K[i0:i1, i0:i1], b_full[i0:i1], ml[i0:i1]
        u = np.zeros(n - 2)
        for _ in range(max_it):
            r = Ki @ u + eps * mli * u ** 3 - bi
            J = Ki + np.diag(3.0 * eps * mli * u ** 2)
            du = solve_banded((bw, bw), _banded(J), -r)
            # damped: a full step can overshoot at a strong ε
            step = 1.0
            nr0 = np.linalg.norm(r)
            for _ in range(20):
                un = u + step * du
                if np.linalg.norm(Ki @ un + eps * mli * un ** 3 - bi) < nr0:
                    break
                step *= 0.5
            u = u + step * du
            if np.linalg.norm(step * du) <= tol * max(np.linalg.norm(u), 1.0):
                break
        out = np.zeros(n)
        out[i0:i1] = u
        return out

    return solve


def nonlinear_dense_verifier(Vs, eps, ml, tf=None, n_random: int = 16,
                             seeds=(7, 101, 1234), n_edge: int = 8):
    """Dense held-out verifier for :func:`nonlinear_elliptic` results, the
    nonlinear counterpart of :func:`elliptic_dense_verifier` (the truth is
    the per-sample banded Newton solve): ``verify(result) -> {"corners",
    "interior", "max"}`` over the 2^d inset box corners and, per seed,
    ``n_random`` random and ``n_edge`` edge grid points (the edges count
    toward "corners"), drawn as the JAX package draws them.  Beside
    ``verify.sample_errors(result, samples)`` and ``verify.corners``,
    ``verify.samples`` holds the set (``{"corners": ...}`` and per seed its
    random and edge points, in draw order) and ``verify.truth(p)`` the
    Newton truth at a point, each solved once and kept."""
    from pgdrome_tpu_torch.separated import evaluate_modes_1d

    Vx = Vs[0]
    num_params = len(Vs) - 1
    fem_solve = nonlinear_elliptic_fom(Vx, num_params, eps, ml)
    grid = Vs[1].tabulate_dof_coordinates()[:, 0]
    lo, hi = grid[1], grid[-2]
    corners = box_corners(lo, hi, num_params)
    truths = {}

    def truth(p):
        """The Newton truth at ``p``, solved once a point."""
        key = tuple(np.asarray(p, dtype=np.float64).tolist())
        if key not in truths:
            truths[key] = fem_solve(np.asarray(key))
        return truths[key]

    draws = []  # (seed, randoms or None, edges or None)
    for seed in seeds:
        rng = np.random.default_rng(seed)
        randoms = edges = None
        if n_random:
            randoms = grid[rng.integers(1, len(grid) - 1, size=(n_random, num_params))]
        if n_edge:
            edges = grid[rng.integers(1, len(grid) - 1, size=(n_edge, num_params))]
            for r in range(n_edge):
                k = int(rng.integers(1, num_params)) if num_params > 1 else 1
                dims = rng.choice(num_params, size=k, replace=False)
                edges[r, dims] = np.where(rng.integers(0, 2, size=k) == 0, lo, hi)
        draws.append((seed, randoms, edges))

    def _full0(res):
        m0 = res.modes[0]
        return host_f64(tf.modes_to_full(m0) if tf is not None else m0)

    def _errors(res, full0, samples):
        samples = np.asarray(samples, dtype=np.float64)
        fac = np.ones((len(samples), res.n_modes))
        for j in range(num_params):
            m = torch.as_tensor(res.modes[1 + j]).detach().cpu()
            vals = evaluate_modes_1d(Vs[1 + j], m, torch.as_tensor(samples[:, j]))
            fac *= host_f64(vals)[:, : res.n_modes]
        errs = []
        for p, f in zip(samples, fac):
            u_ref = truth(p)
            u = f @ full0[: res.n_modes]
            errs.append(np.linalg.norm(u - u_ref) / np.linalg.norm(u_ref))
        return np.asarray(errs)

    def sample_errors(res, samples):
        return _errors(res, _full0(res), samples)

    def verify(res):
        full0 = _full0(res)
        mc = float(_errors(res, full0, corners).max())
        mi = 0.0
        for _, randoms, edges in draws:
            if randoms is not None:
                mi = max(mi, float(_errors(res, full0, randoms).max()))
            if edges is not None:
                mc = max(mc, float(_errors(res, full0, edges).max()))
        return {"corners": mc, "interior": mi, "max": max(mc, mi)}

    verify.sample_errors = sample_errors
    verify.corners = corners
    verify.truth = truth
    verify.samples = {"corners": corners}
    for seed, randoms, edges in draws:
        verify.samples[seed] = np.concatenate(
            [a for a in (randoms, edges) if a is not None] or [np.zeros((0, num_params))])
    return verify
