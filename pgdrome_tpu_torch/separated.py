"""Progressive PGD on a separated-term IR (counterpart of
``pgdrome_tpu/separated.py``).

* :class:`SeparatedProblem` and :class:`PGDResult` are plain containers;
  :meth:`SeparatedProblem.as_device` casts a host problem to tensors of
  one dtype on one device.
* :func:`precondition_dim` / :func:`precondition_dim0` congruence-transform
  one dimension by the banded Cholesky factor of its first operator (host
  f64, scipy), and :class:`Dim0Transform` maps modes solved in that basis
  back to full dofs.
* :class:`SeparatedPGD` runs the enrichment on the device: the alternating
  fixed point of :func:`make_enrich_step` (per-dim Gram contractions and a
  solve: LU, fixed-iteration CG, Cholesky or Newton, with an optional
  separable nonlinear term), the reference's
  'norm' stop and 'stiff' normalisation, host-looped (:meth:`solve`) or
  with a fixed budget and a device keep-mask (:meth:`solve_fused`).  The
  rhs stacks may stay in f64 or in compensated double-f32 on the device
  (``rhs_f64`` / ``rhs_comp``, :func:`_contract_rhs`).  Eager
  PyTorch has no compiled program to share between problems, so the
  problem's own tensors are the step's data (the JAX package's
  ``_ProblemArrays`` / ``problem_data`` have no counterpart).  The fixed
  point's stop is one host sync per sweep; nothing else in a sweep syncs.
* The host f64 post-process: :func:`residual_problem` (the f64-exact
  residual restart), :func:`pad_rhs_bucket`, :func:`combine_results`,
  :func:`compress_modes` (CP-ALS) and :func:`galerkin_update`.  Each takes
  modes as tensors (any device) or arrays and returns them in the kind
  and dtype it was given.
* :func:`evaluate_modes_1d` evaluates all buffered modes of a 1D space at
  a batch of points.  Only the gather form is carried over: the JAX
  package's two-hot matmul form exists to dodge slow TPU gathers
  (``pgdrome_tpu/separated.py:1826-1832``) and has no reason on a GPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import math

import numpy as np
import torch

from pgdrome_tpu_torch.config import get_device, use_full_f32_matmul
from pgdrome_tpu_torch.ops import ddf32
from pgdrome_tpu_torch.ops.solvers import newton_solve

# every einsum/matmul of the enrichment must be true f32 (TF32 would cost
# about three digits and floor the greedy far above the 1e-6 gate)
use_full_f32_matmul()


def host_f64(a) -> np.ndarray:
    """A tensor (any device) or array as a host float64 array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().double().numpy()
    return np.asarray(a, dtype=np.float64)


def _like(buf: np.ndarray, ref):
    """Host f64 ``buf`` in the kind and dtype of ``ref``: a tensor on
    ``ref``'s device, or a host array."""
    if isinstance(ref, torch.Tensor):
        return torch.as_tensor(buf).to(dtype=ref.dtype).to(ref.device)
    return buf.astype(np.asarray(ref).dtype, copy=False)


def _torch_dtype(dtype):
    """The torch dtype of a numpy or torch dtype (None stays None)."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype=dtype)).dtype


@dataclass
class SeparatedProblem:
    """Separated weak form: Σ_t ⊗_d O_td (lhs) and Σ_r ⊗_d g_rd (rhs).

    ops:   per dim, stacked lhs operators (T, n_d, n_d)
    rhs:   per dim, stacked rhs vectors (R, n_d)  (lift terms included)
    mass:  per dim, consistent mass matrix (n_d, n_d) for norms
    bc_dofs: per dim, constrained dof indices (possibly empty) — homogenized
    """

    ops: Sequence[np.ndarray]
    rhs: Sequence[np.ndarray]
    mass: Sequence[np.ndarray]
    bc_dofs: Sequence[np.ndarray]

    def __post_init__(self):
        self.num_dims = len(self.ops)
        self.num_terms = self.ops[0].shape[0]
        self.num_rhs = self.rhs[0].shape[0]
        self.sizes = tuple(o.shape[1] for o in self.ops)
        # bc masks: 1 interior, 0 constrained; host arrays for host
        # problems, tensors on the ops' device for device problems
        self.bc_masks = []
        for d in range(self.num_dims):
            o = self.ops[d]
            if isinstance(o, torch.Tensor):
                m = torch.ones(self.sizes[d], dtype=o.dtype, device=o.device)
            else:
                m = np.ones(self.sizes[d], dtype=np.asarray(o).dtype)
            if self.bc_dofs[d] is not None and len(self.bc_dofs[d]):
                m[np.asarray(self.bc_dofs[d])] = 0.0
            self.bc_masks.append(m)

    def as_device(self, dtype=None, device="cuda", rhs=None) -> "SeparatedProblem":
        """Copy with every array a tensor of ``dtype`` (numpy or torch;
        None keeps each array's own) on ``device``.  Host arrays are cast
        on the host, then copied once: build and precondition in host f64
        and cast here — casting the raw ill-conditioned operators to f32
        costs cond(K)·eps, casting the preconditioned ones is benign.
        ``rhs``: host stacks uploaded in their own dtype in place of the
        problem's (the f64 or dd stacks of ``SeparatedPGD(rhs_f64=...,
        rhs_comp=...)``); the problem's own stacks are then not copied."""
        dev = get_device(device)
        dt = _torch_dtype(dtype)

        def put(a, dt=dt):
            t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
            return t.to(dtype=dt or t.dtype).to(dev).contiguous()

        if rhs is None:
            rhs = [put(r) for r in self.rhs]
        else:
            rhs = [put(r, None) for r in rhs]
        return SeparatedProblem(
            ops=[put(o) for o in self.ops], rhs=rhs,
            mass=[put(m) for m in self.mass], bc_dofs=list(self.bc_dofs),
        )


@dataclass
class PGDResult:
    modes: list  # per dim (n_max, n_d) padded buffers (tensors or arrays)
    n_modes: int
    amplitudes: np.ndarray  # relConv per enrichment (trimmed)
    alpha: np.ndarray
    fp_its: np.ndarray
    normU0: float = 1.0  # absolute normU of the first mode (resume scale)


@dataclass
class Dim0Transform:
    """Back-transform data from :func:`precondition_dim`: full-dof mode
    reconstruction is ``u = scatter(Linv.T @ y)``.

    Holds the Cholesky factor data (banded ``Lb``/``Ub`` storage, or a dense
    ``L``); ``apply_Linv`` / ``apply_LinvT`` map an (n_int, m) block through
    L⁻¹ / L⁻ᵀ by triangular solves, never an explicit inverse.  ``dim``
    records which dimension the transform applies to."""

    interior: np.ndarray  # interior dof indices into the full dof vector
    n_full: int
    dim: int = 0
    # exactly one of the two factor representations is set:
    banded: tuple | None = None  # (Lb, Ub): lower/upper banded storage
    dense_L: np.ndarray | None = None

    def apply_Linv(self, B):
        """L⁻¹ @ B for an (n_int, m) block."""
        from scipy.linalg import solve_banded, solve_triangular

        if self.banded is not None:
            Lb, _ = self.banded
            return solve_banded((Lb.shape[0] - 1, 0), Lb, B)
        return solve_triangular(self.dense_L, B, lower=True)

    def apply_LinvT(self, B):
        """L⁻ᵀ @ B for an (n_int, m) block."""
        from scipy.linalg import solve_banded, solve_triangular

        if self.banded is not None:
            _, Ub = self.banded
            return solve_banded((0, Ub.shape[0] - 1), Ub, B)
        return solve_triangular(self.dense_L.T, B, lower=False)

    def modes_to_full(self, modes0):
        """(n_max, n_int) transformed modes (a tensor or an array) →
        (n_max, n_full) host f64 dof modes."""
        y = host_f64(modes0)
        u_int = self.apply_LinvT(y.T).T  # rows: Linv.T @ y_k
        out = np.zeros((y.shape[0], self.n_full), dtype=u_int.dtype)
        out[:, self.interior] = u_int
        return out

    def full_to_modes(self, modes_full):
        """(n_max, n_full) nodal dof modes (a tensor or an array) →
        (n_max, n_int) host f64 transformed modes, ``y = Lᵀ u_int``: the
        exact inverse of :meth:`modes_to_full` for modes supported on the
        interior dofs, by a banded (or dense) multiply, never a triangular
        solve.  Brings externally built modes (the anchored-ANOVA start,
        :mod:`~pgdrome_tpu_torch.anova`) into a preconditioned cascade's
        basis."""
        u = host_f64(modes_full)[:, self.interior].T
        if self.banded is not None:
            _, Ub = self.banded  # Lᵀ in scipy's upper-banded layout
            ku = Ub.shape[0] - 1
            n = u.shape[0]
            y = np.zeros_like(u)
            for mo in range(ku + 1):
                y[: n - mo] += Ub[ku - mo, mo:n][:, None] * u[mo:n]
            return y.T
        return (self.dense_L.T @ u).T


def precondition_dim0(sep: SeparatedProblem, dtype=None):
    """:func:`precondition_dim` on dimension 0 (the usual space dim)."""
    return precondition_dim(sep, dim=0, dtype=dtype)


def precondition_dim(sep: SeparatedProblem, dim: int = 0, dtype=None,
                     base=None):
    """Congruence-transform dimension ``dim`` by the Cholesky factor of its
    first operator (or of ``base``), so its transformed stack is
    ``[I, G_1, ...]`` with condition number O(1) — every f32 device solve
    in that basis is backward-stable.  Dirichlet dofs of ``dim`` are
    eliminated by restriction.  Host f64 throughout; returns
    ``(problem, Dim0Transform)`` with the problem's arrays cast to
    ``dtype`` (float32 by default)."""
    dt = dtype or np.float32
    from scipy.linalg import cholesky, cholesky_banded

    n0 = sep.sizes[dim]
    interior = np.setdiff1d(
        np.arange(n0), np.asarray(sep.bc_dofs[dim], dtype=np.int64)
    )
    ii = np.ix_(interior, interior)

    ops0 = [np.asarray(o, dtype=np.float64) for o in sep.ops[dim]]
    K = (np.asarray(base, dtype=np.float64)[ii] if base is not None
         else ops0[0][ii])
    n = len(interior)

    # FEM stiffness on a 1D mesh is banded (P1: tri-, P2: penta-diagonal):
    # banded Cholesky is O(n·b²) and each L⁻¹ application O(n·b) a column
    nz_i, nz_j = np.nonzero(K)
    bw = int(np.max(np.abs(nz_i - nz_j))) if nz_i.size else 0
    if (bw + 1) * 8 <= n:
        ab = np.zeros((bw + 1, n))
        for k in range(bw + 1):
            ab[k, : n - k] = np.diagonal(K, -k)
        Lb = cholesky_banded(ab, lower=True)  # Lb[k, j] = L[j+k, j]
        # upper-banded storage of L.T for the back-transform solves
        Ub = np.zeros_like(Lb)
        for k in range(bw + 1):
            Ub[bw - k, k:] = Lb[k, : n - k]
        tf = Dim0Transform(
            interior=interior, n_full=n0, dim=dim, banded=(Lb, Ub)
        )
    else:
        L = cholesky(K, lower=True)
        tf = Dim0Transform(interior=interior, n_full=n0, dim=dim, dense_L=L)
    apply_Linv = tf.apply_Linv

    if base is None:
        new_ops0 = [np.eye(n)]  # Linv O_0 LinvT is exactly I by construction
        rest = range(1, len(ops0))
    else:
        new_ops0 = []
        rest = range(len(ops0))
    for t in rest:
        X = apply_Linv(ops0[t][ii])  # Linv @ A
        new_ops0.append(apply_Linv(X.T).T)  # (Linv @ A) @ Linv.T
    new_rhs0 = apply_Linv(
        np.asarray(sep.rhs[dim], dtype=np.float64)[:, interior].T
    ).T
    Xm = apply_Linv(np.asarray(sep.mass[dim], dtype=np.float64)[ii])
    new_mass0 = apply_Linv(Xm.T).T

    new_ops = [np.asarray(o, dtype=dt) for o in sep.ops]
    new_rhs = [np.asarray(r, dtype=dt) for r in sep.rhs]
    new_mass = [np.asarray(m, dtype=dt) for m in sep.mass]
    new_bc = list(sep.bc_dofs)
    new_ops[dim] = np.stack([a.astype(dt, copy=False) for a in new_ops0])
    new_rhs[dim] = new_rhs0.astype(dt, copy=False)
    new_mass[dim] = new_mass0.astype(dt, copy=False)
    new_bc[dim] = np.array([], dtype=np.int64)
    new = SeparatedProblem(ops=new_ops, rhs=new_rhs, mass=new_mass,
                           bc_dofs=new_bc)
    return new, tf


# --------------------------------------------------------------------- core

def _term_weights(A_d, F_d):
    """w_t = F_dᵀ O_td F_d for all terms (T,)."""
    return torch.matmul(A_d, F_d) @ F_d


def _rhs_weights(R_d, F_d):
    """c_r = F_d · g_rd for all rhs terms (R,), in the stack's dtype."""
    return R_d @ F_d.to(R_d.dtype)


class _DDWeights:
    """``dd_dot(rhs[j], F_j)`` of each dim's dd stack, computed once per
    factor and reused until the factor changes: a sweep updates one factor
    per dim solve, so each dim's weights are computed once per sweep, not
    once per other dim.  A factor is the same while it is the same tensor
    at the same version: an in-place write bumps ``_version`` and so
    recomputes.  The same operations on the same inputs as a
    recomputation, so the results are equal bit for bit."""

    def __init__(self, rhs):
        self.rhs = rhs
        self.key = [None] * len(rhs)
        self.w = [None] * len(rhs)

    def __call__(self, j, F):
        key = self.key[j]
        if key is None or key[0] is not F or key[1] != F._version:
            self.w[j] = ddf32.dd_dot(self.rhs[j], F)
            self.key[j] = (F, F._version)
        return self.w[j]


def _contract_rhs(rhs, Fs, k, nd, dd_weights=None):
    """Per-dim rhs assembly b_i = Σ_r (Π_{j≠k} F_j·g_rj) g_rki in the
    stack's own precision: plain (R, n) stacks contract in their dtype
    (f32 or f64), dd (R, n, 2) stacks (``rhs_comp``) through the
    compensated :mod:`.ops.ddf32` path.  The caller casts the result to
    the factors' dtype.  ``dd_weights``: a :class:`_DDWeights` of the dd
    stacks (None recomputes each dim's weights)."""
    if rhs[k].ndim == 3:
        dd_weights = dd_weights or _DDWeights(rhs)
        rh = torch.ones(rhs[0].shape[0], dtype=rhs[k].dtype, device=rhs[k].device)
        rl = torch.zeros_like(rh)
        for j in range(nd):
            if j != k:
                wh, wl = dd_weights(j, Fs[j])
                rh, rl = ddf32.dd_mul(rh, rl, wh, wl)
        return ddf32.dd_contract(rh, rl, rhs[k])
    rcoef = torch.ones(rhs[0].shape[0], dtype=rhs[0].dtype, device=rhs[0].device)
    for j in range(nd):
        if j != k:
            rcoef = rcoef * _rhs_weights(rhs[j], Fs[j])
    return rcoef @ rhs[k]


def _apply_bc_system(A, b, mask):
    """Homogeneous Dirichlet: zero rows/cols, 1 on diag, zero rhs entries.
    ``A`` is the caller's fresh assembly and is overwritten."""
    A.mul_(mask[:, None]).mul_(mask[None, :])
    A.diagonal().add_(1.0 - mask)
    return A, b * mask


def _cg_solve(A, b, iters):
    """Fixed-iteration CG (SPD A), scale-normalised (Â = A/s_A,
    b̂ = b/‖b‖) so every internal quantity is O(1): late PGD modes have
    tiny right-hand sides whose squared norms would otherwise underflow in
    f32.  For the energy-basis systems cond(A) = O(1), so ~20 iterations
    reach f32 accuracy.  The guards are ``torch.where`` on 0-d tensors:
    nothing here waits for the device."""
    s_A = A.diagonal().abs().mean() + 1e-30
    nb = torch.sqrt(b @ b)
    safe_nb = torch.where(nb > 0, nb, 1.0)
    Ah = A / s_A
    bh = b / safe_nb
    x = torch.zeros_like(bh)
    r, p = bh, bh
    rs = bh @ bh
    for _ in range(iters):
        Ap = Ah @ p
        pAp = p @ Ap
        alpha = torch.where(pAp > 0, rs / (pAp + 1e-30), 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = r @ r
        beta = torch.where(rs > 0, rs_new / (rs + 1e-30), 0.0)
        p = r + beta * p
        rs = rs_new
    return x * (nb / s_A)


def _chol_solve(A, b):
    """Exact SPD solve by Cholesky and two triangular solves,
    scale-normalised like :func:`_cg_solve`."""
    s_A = A.diagonal().abs().mean() + 1e-30
    nb = torch.sqrt(b @ b)
    safe_nb = torch.where(nb > 0, nb, 1.0)
    # no error check (it would wait for the device): a failed factorisation
    # gives NaN, as the JAX package's does
    L, info = torch.linalg.cholesky_ex(A / s_A)
    L = torch.where(info == 0, L, torch.nan)
    y = torch.linalg.solve_triangular(L, (b / safe_nb)[:, None], upper=False)
    x = torch.linalg.solve_triangular(L.T, y, upper=True)[:, 0]
    return x * (nb / s_A)


def _previous_modes(problem, k, Fs, modes, mode_mask):
    """Σ_t O_tk W_t with W = Σ_m (Π_{j≠k} F_jᵀ O_tj G_jm) G_km: the
    previous modes' share of dim k's rhs.  F on the TEST index
    (``F_j @ O_tj``): the trial index would transpose non-symmetric
    operators (e.g. an upwind time stencil) and corrupt the rhs."""
    P = mode_mask[:, None].expand(-1, problem.num_terms)
    for j in range(problem.num_dims):
        if j != k:
            FAj = torch.matmul(Fs[j], problem.ops[j])  # (T, n_j)
            P = P * (modes[j] @ FAj.T)  # (M, T)
    W = P.T @ modes[k]  # (T, n_k)
    return torch.bmm(problem.ops[k], W[:, :, None]).sum(0)[:, 0]


def _solve_dim(problem, k, Fs, modes, mode_mask, solver="lu", cg_iters=30,
               dd_weights=None, nonlinear=None, newton_max_it=25):
    """One alternating-direction solve for dim k given the current factors
    ``Fs`` and the padded previous-mode buffers.

    ``solver="newton"`` solves the dim's system by Newton on its residual
    (:func:`~pgdrome_tpu_torch.ops.solvers.newton_solve`, at most
    ``newton_max_it`` masked steps) from the linear solve as the warm
    start: for a linear problem it stops at once, and the amplitudes are
    those of ``"lu"``.

    ``nonlinear``: an optional separable nonlinear term N(u) = ⊗_d N_d,
    one ``(apply_fn, weight_fn)`` pair a dim: ``apply_fn(u)`` the dim's
    nonlinear operator on the factor being solved (e.g. ``lambda u: M @
    u**3``), ``weight_fn(F)`` its scalar weight when the dim is not, with
    ``weight_d(F) = F · apply_d(F)`` (scalar prefactors in both).  The
    dim-k residual gains (Π_{j≠k} weight_j(F_j)) · N_k(u).  With a linear
    solver the term is lagged at the incoming factor and moved to the rhs
    (Picard: the fixed point itself iterates it); with ``"newton"`` it is
    solved for."""
    nd = problem.num_dims
    coef = torch.ones(problem.num_terms, dtype=Fs[k].dtype, device=Fs[k].device)
    for j in range(nd):
        if j != k:
            coef = coef * _term_weights(problem.ops[j], Fs[j])
    A_k = torch.tensordot(coef, problem.ops[k], dims=1)  # Σ_t coef_t O_tk
    # the loads in the stack's precision, cast to the factors' dtype
    # BEFORE the previous modes are subtracted (f64 or dd stacks resolve
    # the cascade's cancellation; the O(1) load then casts losslessly)
    b = (_contract_rhs(problem.rhs, Fs, k, nd, dd_weights).to(Fs[k].dtype)
         - _previous_modes(problem, k, Fs, modes, mode_mask))
    A_k, b = _apply_bc_system(A_k, b, problem.bc_masks[k])
    if nonlinear is not None:
        mask = problem.bc_masks[k]
        theta = torch.ones((), dtype=Fs[k].dtype, device=Fs[k].device)
        for j in range(nd):
            if j != k:
                theta = theta * nonlinear[j][1](Fs[j])
        if solver != "newton":
            b = b - theta * (mask * nonlinear[k][0](Fs[k]))
    if solver == "newton":
        if nonlinear is not None:
            apply_k = nonlinear[k][0]

            def residual(u):
                # the bc rows of (A_k, b) are identity and zero: mask the
                # nonlinear rows to match
                return A_k @ u - b + theta * (mask * apply_k(u))
        else:

            def residual(u):
                return A_k @ u - b

        u0 = torch.linalg.solve_ex(A_k, b)[0]
        return newton_solve(residual, u0, max_iter=newton_max_it)[0]
    if solver == "cg":
        return _cg_solve(A_k, b, cg_iters)
    if solver == "chol":
        return _chol_solve(A_k, b)
    # unchecked, as the JAX package's: a singular system gives inf/NaN (the
    # caller's stall handling sees it), and no check waits for the device
    return torch.linalg.solve_ex(A_k, b)[0]


def _norm_d(problem, d, v):
    return torch.sqrt(torch.abs(_inner_d(problem, d, v, v)))


def _inner_d(problem, d, u, v):
    return u @ (problem.mass[d] @ v)


def make_enrich_step(problem: SeparatedProblem, max_fp_it=50, tol_fp=1e-5,
                     solver="lu", cg_iters=30, residual_check=True, renorm_sweep=False,
                     nonlinear=None, newton_max_it=25):
    """The enrichment step on a device problem: ``enrich(modes, n_modes,
    init=None) → (new_modes, normU, alpha, fp_its, res)`` — the reference's
    FP_solve with the 'norm' stop and 'stiff' normalisation
    (solver.py:306-506).  ``new_modes`` are fresh buffers with the new mode
    at row ``n_modes``; ``normU``, ``alpha`` and ``res`` are 0-d tensors on
    the device, ``fp_its`` a Python int.  ``init``: optional per-dim
    fixed-point seeds (masked and normalised like the ones init).

    ``renorm_sweep``: after each per-dim solve but the last, scale the
    factor to unit Euclidean norm (and start from unit-norm factors), so
    every Gram coefficient stays O(1) — in f32 the minres transient's mode
    is ~1e-6 of its rhs, and its unnormalised Grams fall below the noise
    floor; the 'norm' stop is then relative to the iterate's norm.
    ``nonlinear``, ``newton_max_it``: see :func:`_solve_dim`."""
    nd = problem.num_dims
    P = problem

    def normalise(d, f):
        return f / (torch.linalg.norm(f) if renorm_sweep else _norm_d(P, d, f))

    def init_modes():
        Fs = []
        for d in range(nd):
            f = torch.ones(P.sizes[d], dtype=P.ops[d].dtype, device=P.ops[d].device)
            Fs.append(normalise(d, f * P.bc_masks[d]))
        return Fs

    def residual_norm(Fs, modes, mode_mask, dd_weights):
        # reference residual check (solver.py:345-395): per-dim rhs with
        # the init modes, bc entries zeroed, res = sqrt(Σ_d ||b_d||²)
        res = 0.0
        for d in range(nd):
            b = (_contract_rhs(P.rhs, Fs, d, nd, dd_weights).to(Fs[d].dtype)
                 - _previous_modes(P, d, Fs, modes, mode_mask))
            b = b * P.bc_masks[d]
            res = res + b @ b
        return torch.sqrt(res)

    def fp_sweep(Fs, modes, mode_mask, dd_weights):
        Fs = list(Fs)
        for k in range(nd):
            Fs[k] = _solve_dim(P, k, Fs, modes, mode_mask, solver=solver,
                               cg_iters=cg_iters, dd_weights=dd_weights,
                               nonlinear=nonlinear, newton_max_it=newton_max_it)
            if renorm_sweep and k < nd - 1:
                # Euclidean on purpose: the Gram coefficients are plain
                # products with the O(1) operators, while a transformed
                # mass can carry the congruence scale
                nrm = torch.sqrt(Fs[k] @ Fs[k])
                Fs[k] = Fs[k] / torch.where(nrm > 0, nrm, 1.0)
        return Fs

    def stop_error(Fs_new, Fs):
        # 'norm' stop (solver.py:812-871): product inner products
        newnew = newold = oldold = 1.0
        for d in range(nd):
            newnew = newnew * _inner_d(P, d, Fs_new[d], Fs_new[d])
            newold = newold * _inner_d(P, d, Fs_new[d], Fs[d])
            oldold = oldold * _inner_d(P, d, Fs[d], Fs[d])
        err = torch.sqrt(torch.abs(newnew + oldold - 2 * newold))
        if renorm_sweep:
            # unit-Euclidean factors on congruence-scaled masses make the
            # absolute metric meaningless: relative to the iterate's norm
            err = err / torch.sqrt(torch.clamp(newnew, min=1e-30))
        return err

    def enrich(modes, n_modes, init=None):
        dt, dev = P.ops[0].dtype, P.ops[0].device
        mode_mask = (torch.arange(modes[0].shape[0], device=dev) < n_modes).to(dt)
        if init is None:
            Fs = init_modes()
        else:
            Fs = [normalise(d, torch.as_tensor(np.asarray(init[d])).to(dtype=dt).to(dev)
                            * P.bc_masks[d]) for d in range(nd)]
        dd_weights = _DDWeights(P.rhs) if P.rhs[0].ndim == 3 else None
        if residual_check:
            res = residual_norm(Fs, modes, mode_mask, dd_weights)
        else:
            # skip the residual; its semantics only matter for degenerate
            # zero-residual problems (solver.py:391-395)
            res = torch.ones((), dtype=dt, device=dev)

        err, fp_its = math.inf, 0
        while err >= tol_fp and fp_its < max_fp_it:  # NaN stops, as in JAX
            Fs_new = fp_sweep(Fs, modes, mode_mask, dd_weights)
            err_t = stop_error(Fs_new, Fs)
            Fs = Fs_new
            fp_its += 1
            err = err_t.item()  # the sync

        norm_Fs = torch.stack([_norm_d(P, d, Fs[d]) for d in range(nd)])
        normU = torch.prod(norm_Fs)
        # 'stiff' (solver.py:413-456): the full lhs Gram on L2-normalised
        # factors; it redistributes scale only (Π_d F_d is invariant)
        Fn = [Fs[d] / norm_Fs[d] for d in range(nd)]
        wprod = torch.ones(P.num_terms, dtype=dt, device=dev)
        for d in range(nd):
            wprod = wprod * _term_weights(P.ops[d], Fn[d])
        norm_fac = torch.sqrt(torch.abs(wprod.sum())) ** (1.0 / nd)
        alpha = normU * norm_fac ** nd
        # a vanishing mode must not poison the buffers with NaN (0/0)
        scale = torch.where(norm_fac > 0, alpha ** (1.0 / nd) / norm_fac, 0.0)
        row = torch.full((1,), n_modes, device=dev)  # no host copy, no sync
        new_modes = tuple(
            modes[d].index_copy(0, row, (Fn[d] * scale)[None]) for d in range(nd)
        )
        return new_modes, normU, alpha, fp_its, res

    return enrich


class SeparatedPGD:
    """Progressive PGD driver over a :class:`SeparatedProblem`.

    ``solve()`` keeps the enrichment loop on the host, matching the
    reference's control flow: residual check → fixed point → 'stiff'
    norming → amplitude convergence (solver.py:306-506).
    ``solve_fused()`` runs a fixed budget of enrichments with the keep
    decision on the device and truncates at ``tol`` on the host.

    ``solver``: the per-dim linear solve — ``"lu"`` (unchecked
    ``torch.linalg.solve_ex``), ``"cg"`` (fixed-iteration scale-normalised
    CG, for energy-preconditioned systems), ``"chol"`` (exact SPD
    Cholesky) or ``"newton"`` (Newton on the dim's residual, at most
    ``newton_max_it`` steps).  ``nonlinear``: a separable nonlinear term,
    one ``(apply_fn, weight_fn)`` pair a dim on the device (see
    :func:`_solve_dim`): lagged (Picard) with a linear solver, solved for
    with ``"newton"``.  ``dtype``: the device dtype (numpy or torch; None keeps the
    problem's).  ``fp_init``: ``"ones"``, ``"randomized"`` (the reference's
    get_Fsinit, seeded per mode) or ``fn(mode, sizes) → per-dim vectors``.
    A mode whose fixed point collapses (normU → 0/NaN) is retried
    ``stall_retries`` times from a randomized init.  ``renorm_sweep``: the
    fixed point's mid-sweep renormalisation (:func:`make_enrich_step`).
    ``device``: CUDA by
    default; without it this raises unless ``device="cpu"`` is asked for.

    ``rhs_f64`` / ``rhs_comp`` (exclusive; both need the host f64 problem):
    keep the rhs stacks in f64, or as double-f32 pairs (R, n, 2)
    contracted by :mod:`.ops.ddf32`, on the device, while everything else
    runs in ``dtype``.  Residual-cascade stages ship rows of magnitude ~1/s
    that cancel to O(1) in the load contraction; plain f32 floors deep
    cascades at ~1.5e-6 there.  The H100 has f64 units, so ``rhs_f64``
    runs on the card (the JAX package needs an x64 host backend for it)."""

    def __init__(self, problem: SeparatedProblem, n_max: int = 20,
                 tol: float = 1e-10, tol_fp: float = 1e-5, max_fp_it: int = 50,
                 dtype=None, solver: str = "lu", cg_iters: int = 30,
                 residual_check: bool = True, fp_init="ones",
                 stall_retries: int = 1, rhs_f64: bool = False,
                 rhs_comp: bool = False, renorm_sweep: bool = False,
                 nonlinear=None, newton_max_it: int = 25, device="cuda"):
        if solver not in ("lu", "cg", "chol", "newton"):
            raise ValueError(
                f"unknown solver {solver!r}: expected 'lu', 'cg', 'chol' or 'newton'"
            )
        if not callable(fp_init) and fp_init not in ("ones", "randomized"):
            raise ValueError(
                f"unknown fp_init {fp_init!r}: expected 'ones', 'randomized' "
                "or a callable"
            )
        if rhs_comp and rhs_f64:
            raise ValueError("rhs_comp and rhs_f64 are exclusive")
        rhs0 = problem.rhs[0]
        if (rhs_comp or rhs_f64) and not (
            isinstance(rhs0, np.ndarray) and rhs0.dtype == np.float64
        ):
            # a stack already cast to f32 has no low parts left to keep:
            # the flag would silently do nothing
            raise ValueError(
                "rhs_f64/rhs_comp need the HOST float64 problem (builders' "
                "convention) — this problem's rhs is already "
                f"{'device' if not isinstance(rhs0, np.ndarray) else str(rhs0.dtype)}"
            )
        self.device = get_device(device)
        if rhs_comp:
            # split from the host f64 stack before any cast
            rhs = [ddf32.dd_from_f64(r) for r in problem.rhs]
        elif rhs_f64:
            rhs = list(problem.rhs)
        else:
            rhs = None
        self.problem = problem.as_device(dtype, self.device, rhs=rhs)
        self.dtype = self.problem.ops[0].dtype
        self.n_max = n_max
        self.tol = tol
        self._fp_init = fp_init
        self._stall_retries = stall_retries
        self._enrich = make_enrich_step(
            self.problem, max_fp_it=max_fp_it, tol_fp=tol_fp, solver=solver,
            cg_iters=cg_iters, residual_check=residual_check, renorm_sweep=renorm_sweep,
            nonlinear=nonlinear, newton_max_it=newton_max_it,
        )

    def _random_init(self, n, attempt):
        rng = np.random.default_rng(3452 + 7919 * n + attempt)
        np_dt = torch.empty(0, dtype=self.dtype).numpy().dtype
        return tuple(
            rng.uniform(-1.0, 1.0, size=s).astype(np_dt) for s in self.problem.sizes
        )

    def init_buffers(self):
        return tuple(
            torch.zeros((self.n_max, n), dtype=self.dtype, device=self.device)
            for n in self.problem.sizes
        )

    def solve(self, verbose: bool = False) -> PGDResult:
        """Progressive enrichment, one mode per host iteration; stops at
        ``n_max`` modes, a residual under 1e-10, a mode that stays stalled
        after its retries, or a relative amplitude under ``tol``.  Per-mode
        wall times land in ``self.metrics``."""
        from pgdrome_tpu_torch.utils.profiling import EnrichmentMetrics

        modes = self.init_buffers()
        normConv, alphas, fps = [], [], []
        n = 0
        self.metrics = EnrichmentMetrics(self.device)
        while n < self.n_max:
            attempt = 0
            while True:
                if callable(self._fp_init) and attempt == 0:
                    init = self._fp_init(n, self.problem.sizes)
                elif self._fp_init == "randomized" or attempt > 0:
                    init = self._random_init(n, attempt)
                else:
                    init = None
                with self.metrics.step():
                    modes_new, normU, alpha, fp_its, res = self._enrich(modes, n, init=init)
                res, normU = float(res), float(normU)
                stalled = not np.isfinite(normU) or normU <= 0
                if not stalled or attempt >= self._stall_retries:
                    break
                attempt += 1
                if verbose:
                    print(f"mode {n} stalled: randomized retry {attempt}")
            if res < 1e-10:
                if verbose:
                    print(f"residual {res:.3e} < 1e-10 at mode {n}: stop")
                break
            if stalled:
                if verbose:
                    print(f"mode {n} hit the fp noise floor: stop")
                break
            modes = modes_new
            normConv.append(normU)
            alphas.append(float(alpha))
            fps.append(fp_its)
            n += 1
            rel = normConv[-1] / normConv[0]
            self.metrics.record(mode=n - 1, amplitude=rel, fp_its=fp_its)
            if verbose:
                print(f"mode {n}: relConv={rel:.3e} fp_its={fp_its}")
            if rel < self.tol:
                break
        rel = np.asarray(normConv) / (normConv[0] if normConv else 1.0)
        return PGDResult(
            modes=list(modes), n_modes=n, amplitudes=rel,
            alpha=np.asarray(alphas), fp_its=np.asarray(fps),
            normU0=float(normConv[0]) if normConv else 1.0,
        )

    def solve_fused(self, n_enrich: int | None = None) -> PGDResult:
        """A fixed budget of ``n_enrich`` (default ``n_max``) enrichments,
        the JAX package's one-program loop as a Python loop over modes.  A
        mode is kept on the device — no host round trip — when its residual
        is ≥ 1e-10 and its normU finite and positive; a dropped mode leaves
        its buffers and a zero normU.  Amplitude convergence is evaluated on
        the host afterwards: trailing modes past ``tol`` are truncated."""
        n_enrich = n_enrich or self.n_max
        if n_enrich > self.n_max:
            raise ValueError(f"n_enrich={n_enrich} exceeds the buffers' n_max={self.n_max}")
        modes = self.init_buffers()
        normUs = torch.zeros(n_enrich, dtype=self.dtype, device=self.device)
        alphas = torch.zeros_like(normUs)
        fps = np.zeros(n_enrich, dtype=np.int32)
        for i in range(n_enrich):
            modes_new, normU, alpha, fps[i], res = self._enrich(modes, i)
            keep = (res >= 1e-10) & torch.isfinite(normU) & (normU > 0)
            modes = tuple(torch.where(keep, mn, mo) for mn, mo in zip(modes_new, modes))
            normUs[i] = torch.where(keep, normU, 0.0)
            alphas[i] = torch.where(keep, alpha, 0.0)
        normUs = normUs.cpu().numpy()
        nrun = int((normUs > 0).sum())
        rel = normUs[:nrun] / (normUs[0] if nrun else 1.0)
        below = np.where(rel < self.tol)[0]
        n = int(below[0]) + 1 if len(below) else nrun
        return PGDResult(
            modes=list(modes), n_modes=n, amplitudes=rel[:n],
            alpha=alphas.cpu().numpy()[:n], fp_its=fps[:n],
            normU0=float(normUs[0]) if nrun else 1.0,
        )


# ------------------------------------------------- minimal residual

def normal_equations(sep: SeparatedProblem) -> SeparatedProblem:
    """Minimal-residual PGD: the normal equations AᵀA u = Aᵀf of a host
    problem, in host f64.

    Greedy Galerkin PGD has no minimisation principle for non-symmetric
    operators (upwind time, advection) and can converge slowly or stall;
    on AᵀA it minimises the true residual monotonically.  The separated
    structure stays: T lhs terms become T² (O_tdᵀ O_t'd per dim), R rhs
    terms T·R (O_tdᵀ g_rd).  Condition numbers square — precondition
    (:func:`precondition_dim` with :func:`ne_dim_base`) for f32 runs.
    Dirichlet dofs are homogenised: constrained rows and columns are
    zeroed first, so AᵀA is the masked system's."""
    ops = [host_f64(o) for o in sep.ops]
    rhs = [host_f64(r) for r in sep.rhs]
    T, R = sep.num_terms, sep.num_rhs
    new_ops, new_rhs = [], []
    for d in range(sep.num_dims):
        m = host_f64(sep.bc_masks[d])
        O = ops[d] * m[None, :, None] * m[None, None, :]
        g = rhs[d] * m[None, :]
        new_ops.append(np.einsum("tik,uij->tukj", O, O).reshape(T * T, O.shape[1], O.shape[2]))
        new_rhs.append(np.einsum("tik,ri->trk", O, g).reshape(T * R, O.shape[1]))
    return SeparatedProblem(ops=new_ops, rhs=new_rhs, mass=[host_f64(m) for m in sep.mass],
                            bc_dofs=list(sep.bc_dofs))


def ne_dim_base(sep: SeparatedProblem, dim: int) -> np.ndarray:
    """The SPD congruence base Σ_t O_tdᵀ O_td (bc-masked) for
    preconditioning dim ``dim`` of a :func:`normal_equations` problem: by
    Cauchy–Schwarz it bounds every cross term O_tᵀO_u, so
    :func:`precondition_dim` with it makes the per-dim systems uniformly
    well conditioned (the stack's first entry alone can be the weakest
    term, e.g. mass² for the heat operator).  ``sep``: the problem before
    the transform."""
    m = host_f64(sep.bc_masks[dim])
    B = np.zeros((sep.sizes[dim], sep.sizes[dim]))
    for t in range(sep.num_terms):
        O = host_f64(sep.ops[dim][t]) * m[:, None] * m[None, :]
        B += O.T @ O
    return B


# ------------------------------------------------- host f64 post-process

def galerkin_update(problem: SeparatedProblem, result: PGDResult,
                    rcond: float | None = None) -> PGDResult:
    """Galerkin update ("PGD with update"): re-solve the coefficients of the
    computed rank-1 terms by projecting the full problem onto their span,

        Σ_j ⟨⊗F^i, A ⊗F^j⟩ α_j = ⟨⊗F^i, f⟩,

    with separated contractions in host f64, and fold α into the dim-0
    modes.  ``rcond``: solve the K×K system by SVD-truncated least squares
    instead (a safety valve for singular Grams; measured worse on the
    5-parameter cascade, see the JAX package)."""
    K = result.n_modes
    nd = problem.num_dims
    ops = [host_f64(o) for o in problem.ops]
    rhs = [host_f64(r) for r in problem.rhs]
    modes = [host_f64(m)[:K] for m in result.modes]

    # G[i,j] = Σ_t Π_d (F_d^i · O_td · F_d^j), as batched matmuls
    G = np.ones((ops[0].shape[0], K, K))
    for d in range(nd):
        tmp = np.matmul(modes[d][None, :, :], ops[d])  # (T, K, n_d)
        G = G * np.matmul(tmp, modes[d].T[None, :, :])  # (T, K, K)
    Gmat = G.sum(axis=0)

    # b[i] = Σ_r Π_d (F_d^i · g_rd)
    B = np.ones((rhs[0].shape[0], K))
    for d in range(nd):
        B = B * (rhs[d] @ modes[d].T)
    bvec = B.sum(axis=0)

    if rcond is None:
        alpha = np.linalg.solve(Gmat, bvec)
    else:
        alpha = np.linalg.lstsq(Gmat, bvec, rcond=rcond)[0]
    new_modes0 = host_f64(result.modes[0]).copy()
    new_modes0[:K] = alpha[:, None] * modes[0]
    return PGDResult(
        modes=[_like(new_modes0, result.modes[0])] + list(result.modes[1:]),
        n_modes=K, amplitudes=result.amplitudes, alpha=result.alpha,
        fp_its=result.fp_its, normU0=result.normU0,
    )


def compress_modes(result: PGDResult, mass, n_to: int, n_iters: int = 40,
                   tol: float = 1e-12) -> PGDResult:
    """PGD compression: replace the rank-K greedy separated solution by the
    optimal rank-R (R < K) one, by CP-ALS in the mass-weighted inner
    product (host f64).  Greedy enrichment is not rank-optimal, so a few
    extra greedy modes compressed back beat the greedy rank-R solve.
    ``mass``: per-dim mass matrices of the inner product.  Each ALS
    half-step solves (⊙_{d≠j} B_d M_d B_dᵀ) B_j = (⊙_{d≠j} B_d M_d A_dᵀ) A_j."""
    K = result.n_modes
    if not (0 < n_to < K):
        raise ValueError(f"n_to must be in (0, {K}); got {n_to}")
    nd = len(result.modes)
    A = [host_f64(m)[:K] for m in result.modes]
    M = [host_f64(m) for m in mass]
    MA = [M[d] @ A[d].T for d in range(nd)]  # (n_d, K)

    # init with the first n_to greedy modes (they are roughly ordered)
    B = [A[d][:n_to].copy() for d in range(nd)]
    MB = [M[d] @ B[d].T for d in range(nd)]  # (n_d, R)

    # ||T||^2 is constant: Hadamard product of per-dim A-Grams
    GA = np.ones((K, K))
    for d in range(nd):
        GA = GA * (A[d] @ MA[d])
    normT2 = GA.sum()

    prev_err2 = np.inf
    for _ in range(n_iters):
        for j in range(nd):
            G = np.ones((n_to, n_to))
            H = np.ones((n_to, K))
            for d in range(nd):
                if d != j:
                    G = G * (B[d] @ MB[d])
                    H = H * (B[d] @ MA[d])
            # regularise: ALS factors can become collinear mid-iteration
            G = G + 1e-14 * np.trace(G) / n_to * np.eye(n_to)
            B[j] = np.linalg.solve(G, H @ A[j])
            MB[j] = M[j] @ B[j].T
        GS = np.ones((n_to, n_to))
        TS = np.ones((n_to, K))
        for d in range(nd):
            GS = GS * (B[d] @ MB[d])
            TS = TS * (B[d] @ MA[d])
        err2 = normT2 - 2.0 * TS.sum() + GS.sum()
        if abs(prev_err2 - err2) <= tol * abs(normT2):
            break
        prev_err2 = err2

    buf_n = result.modes[0].shape[0]
    new_modes = []
    for d in range(nd):
        buf = np.zeros((buf_n, B[d].shape[1]), dtype=np.float64)
        buf[:n_to] = B[d]
        new_modes.append(_like(buf, result.modes[0]))
    return PGDResult(
        modes=new_modes, n_modes=n_to,
        amplitudes=np.asarray(result.amplitudes)[:n_to],
        alpha=np.asarray(result.alpha)[:n_to],
        fp_its=np.asarray(result.fp_its)[:n_to], normU0=result.normU0,
    )


def residual_problem(sep: SeparatedProblem, result: PGDResult):
    """Floor restart: the separated problem of the correction δ* with
    A (s·δ*) = f − A u_K, rescaled to O(1).  The residual rhs is formed once
    on the host in f64 (exact), so solving it in f32 restarts the f32
    amplitude floor at the residual's scale; deploy u = u_K + s·δ*
    (:func:`combine_results`).  Each lhs term t × mode k adds a rank-1 rhs
    term −⊗_d (O_td u_kd), so the rhs stack has R + T·K rows; the operators
    are unchanged.  Returns ``(sep_res, s)``, s = ‖f − A u_K‖₂ by
    separated Gram algebra (no full tensor)."""
    K = result.n_modes
    nd = sep.num_dims
    ops = [host_f64(o) for o in sep.ops]
    modes = [host_f64(m)[:K] for m in result.modes]
    T = sep.num_terms

    new_rhs = []
    for d in range(nd):
        # the residual of the MASKED (homogenised) system: mask the modes,
        # the rhs and the output rows, not the O(T·n²) operator stack
        m = host_f64(sep.bc_masks[d])
        rhs_m = host_f64(sep.rhs[d]) * m[None, :]
        W = np.matmul(ops[d], (modes[d] * m[None, :]).T)  # (T, n, K)
        W = W * m[None, :, None]
        W = W.transpose(0, 2, 1).reshape(T * K, ops[d].shape[1])  # (T·K, n)
        if d == 0:
            W = -W  # the minus sign of f − A·u_K, folded into dim 0
        new_rhs.append(np.concatenate([rhs_m, W], axis=0))

    # s = ‖r‖: Σ_{a,b} Π_d (g_ad · g_bd) via per-dim Grams
    G = np.ones((new_rhs[0].shape[0],) * 2)
    for d in range(nd):
        G = G * (new_rhs[d] @ new_rhs[d].T)
    s = float(np.sqrt(max(G.sum(), 0.0)))
    if s > 0:
        new_rhs[0] = new_rhs[0] / s

    sep_res = SeparatedProblem(
        ops=ops, rhs=new_rhs, mass=[host_f64(m) for m in sep.mass],
        bc_dofs=list(sep.bc_dofs),
    )
    return sep_res, s


def pad_rhs_bucket(sep: SeparatedProblem, bucket: int) -> SeparatedProblem:
    """Pad every dim's rhs stack of a host problem with zero rows up to a
    ``bucket`` multiple.  Zero rows add nothing to the load contractions or
    to normU0; they keep the stack's shape fixed across cascade stages
    (each :func:`residual_problem` restart grows it by T·K rows)."""
    R = sep.rhs[0].shape[0]
    Rpad = int(-(-R // bucket) * bucket)
    if Rpad == R:
        return sep
    rhs = [
        np.concatenate([r, np.zeros((Rpad - R, r.shape[1]), dtype=r.dtype)])
        for r in (np.asarray(r) for r in sep.rhs)
    ]
    return SeparatedProblem(
        ops=list(sep.ops), rhs=rhs, mass=list(sep.mass),
        bc_dofs=[np.flatnonzero(np.asarray(m) == 0.0) for m in sep.bc_masks],
    )


def combine_results(base: PGDResult, delta: PGDResult, scale: float) -> PGDResult:
    """Concatenate a base PGD and a rescaled correction PGD:
    u = u_base + scale·u_delta (the deployment step of
    :func:`residual_problem`).  The scale folds into the dim-0 factors;
    the modes come back in the base's kind and dtype."""
    K1, K2 = base.n_modes, delta.n_modes
    new_modes = []
    for d in range(len(base.modes)):
        b = host_f64(base.modes[d])[:K1]
        e = host_f64(delta.modes[d])[:K2]
        if d == 0:
            e = e * scale
        new_modes.append(_like(np.concatenate([b, e], axis=0), base.modes[0]))
    return PGDResult(
        modes=new_modes,
        n_modes=K1 + K2,
        amplitudes=np.concatenate(
            [np.asarray(base.amplitudes)[:K1],
             np.asarray(delta.amplitudes)[:K2]
             * (scale * delta.normU0 / base.normU0 if base.normU0 else 1.0)]
        ),
        alpha=np.concatenate(
            [np.asarray(base.alpha)[:K1], np.asarray(delta.alpha)[:K2]]
        ),
        fp_its=np.concatenate(
            [np.asarray(base.fp_its)[:K1], np.asarray(delta.fp_its)[:K2]]
        ),
        normU0=base.normU0,
    )


def make_evaluator(result_modes, n_modes):
    """Rank-1 reconstruction over the first (fixed) dimension for a batch
    of parameter factor rows: ``reconstruct(free_factors (B, ≥ n_modes)) →
    (B, n0)``, the first ``n_modes`` entries of each row (the product over
    the free dims of each mode's values) times the first ``n_modes`` dim-0
    modes; the buffer's padding past ``n_modes`` never enters."""
    n = int(n_modes)
    modes0 = result_modes[0][:n]  # (n_modes, n0)

    def reconstruct(free_factors):
        f = torch.as_tensor(free_factors).to(modes0.device, modes0.dtype)
        return f[..., :n] @ modes0

    return reconstruct


def evaluate_modes_1d(V, modes_buf: torch.Tensor, points: torch.Tensor,
                      derivative: bool = False):
    """Evaluate all buffered modes of a 1D space at a batch of points:
    (npoints,) → (npoints, n_max), computed in ``modes_buf``'s dtype on its
    device.  Cell locate by binary search over the vertices (any grid),
    then the 2–3 dof rows of each point's cell gathered and weighted by
    the Lagrange basis.  ``derivative=True`` evaluates d(mode)/dp instead:
    the reference-basis derivative over the cell width, one-sided at cell
    boundaries (a grid node takes the cell on its right, the right end the
    last cell) — the factor derivative of the parameter Jacobian."""
    from pgdrome_tpu_torch.fem.interpolate import (
        _cell_widths,
        _dshape_1d_x,
        _locate_1d,
        _shape_1d_x,
    )

    pts = torch.as_tensor(points).to(device=modes_buf.device,
                                      dtype=modes_buf.dtype)
    cell, xi = _locate_1d(V.mesh(), pts, torch)
    if derivative:
        h = _cell_widths(V.mesh(), cell, xi, torch)
        basis = _dshape_1d_x(V.degree, xi, torch) / h[..., None]
    else:
        basis = _shape_1d_x(V.degree, xi, torch)  # (B, nl)
    local = V.element_dofs_device(modes_buf.device)[cell]  # (B, nl)
    gathered = modes_buf.T[local]  # (B, nl, n_max)
    return torch.einsum("bl,bln->bn", basis, gathered)
