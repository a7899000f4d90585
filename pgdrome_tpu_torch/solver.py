"""Progressive PGD solver on the host: the enrichment loop and the
alternating-directions fixed point (counterpart of ``pgdrome_tpu/solver.py``).

Reference parity: pgdrome/solver.py (PGDProblem, solve_PGD at solver.py:306,
FP_solve at solver.py:508, get_Fsinit at solver.py:158, direct_solve/FD_solve
at solver.py:909-943).  The algorithm's semantics — the residual check, the
three normalisations ('no'/'stiff'/'l2'), the 'norm' and 'delta' fixed-point
stops, the amplitude bookkeeping — are the reference's, so FD amplitudes
match it to 1e-8 relative (BASELINE.md).  Host numpy in f64, as in the JAX
package; the device solver is :class:`~pgdrome_tpu_torch.separated.SeparatedPGD`.

Callback contract (in place of the reference's UFL forms):

``lhs_fct(fct_F, var_F, Fs, meshes, dom, param, typ, dim)`` returns
  * a dense or scipy-sparse ``(n, n)`` matrix for 'FEM' and 'FD' dims
    (operators are assembled once with :mod:`pgdrome_tpu_torch.fem.assembly`;
    Gram scalars are ``gram(F, Op, F)`` contractions),
  * a scalar for 'direct' dims,
  * or, in the nonlinear path, a length-n residual vector (the form
    evaluated at ``fct_F``).

``rhs_fct(fct_F, var_F, Fs, meshes, dom, param, load, PGD_func, typ, n_enr,
dim)`` returns a length-n vector (a scalar for 'direct').

In the linear path ``fct_F``/``var_F`` are ``None`` (the matrix IS the
operator on the trial function); in the nonlinear path ``fct_F`` is a
:class:`Function` holding the current iterate, and the residual is
``lhs(u) @ u − rhs(u)`` when the callback returns a matrix, or
``lhs(u) − rhs(u)`` when it returns a vector.  Boundary conditions: 'FEM'
dims get the bc elimination applied by the solver; 'FD' dims apply theirs
inside the callbacks (as reference test_laplace.py:398-401 does).

``fp_init = "randomized"`` draws from the problem's own
``numpy.random.RandomState`` (``PGDProblem(seed=...)``), not from numpy's
global generator; seeded alike, both draw the same numbers.
"""

from __future__ import annotations

import logging

import numpy as np

from pgdrome_tpu_torch.fem.function import Function
from pgdrome_tpu_torch.fem.assembly import mass_matrix, vector_mass_matrix
from pgdrome_tpu_torch.fem.bc import combine_bcs
from pgdrome_tpu_torch.ops.solvers import solve_dense, newton_solve_np, picard_solve_np
from pgdrome_tpu_torch.model import PGD


class PGDProblem:
    def __init__(
        self,
        name=None,
        name_coord=[],
        modes_info=[],
        Vs=[],
        dom_fct=None,
        bc_fct=None,
        load=[],
        param=None,
        rhs_fct=None,
        lhs_fct=None,
        probs=[],
        seq_fp=[],
        PGD_nmax=20,
        PGD_tol=1e-10,
        num_elem=[],
        order=[],
        ranges=[],
        dims=[],
        *args,
        seed=None,
        **kwargs,
    ):
        """Problem definition + solver state.

        Constructor arguments and post-construction knobs mirror the
        reference (solver.py:12-134); extra kwargs are swallowed for
        compatibility (the reference does the same, e.g. ``dom=0`` in
        test_elastic.py:248).  ``seed`` seeds the generator of
        ``fp_init = "randomized"`` (None: fresh entropy).
        """
        self.logger = logging.getLogger(__name__ + "." + self.__class__.__name__)
        self.name = name
        self.name_coord = name_coord
        self.modes_info = modes_info
        self.num_pgd_var = len(self.name_coord)

        self.V = [0] * self.num_pgd_var
        self.meshes = [0] * self.num_pgd_var
        if Vs != []:
            self.V = Vs
        for idx, vv in enumerate(self.V):
            self.meshes[idx] = 0 if vv == 0 else vv.mesh()

        self.dom_fct = dom_fct
        self.bc_fct = bc_fct
        self.load = load
        self.param = param
        self.rhs_fct = rhs_fct
        self.lhs_fct = lhs_fct
        self.prob = probs
        self.seq_fp = list(seq_fp) if len(seq_fp) else list(range(self.num_pgd_var))
        self.PGD_nmax = PGD_nmax
        self.PGD_tol = PGD_tol

        self.num_elem = num_elem
        self.order = order
        self.ranges = ranges
        self.dims = dims

        # computed by class functions
        self.PGD_func = []
        self.alpha = []
        self.amplitude = []
        self.num_fp_it = []
        self.err_fp_it = []
        self.PGD_modes = None

        # solver knobs (post-construction mutation is the documented idiom,
        # reference SURVEY.md §5 "Config / flag system")
        self.max_fp_it = 50
        self.tol_fp_it = 1e-5
        self.tol_abs = 1e-6
        self.stop_fp = "norm"
        self.fp_init = ""
        self.norm_modes = "stiff"

        self.simulation_info = (
            "PGD solver option: PGD_nmax %s / PGD tolerance %s and max FP "
            "iterations %s and FP tolerance %s; \n"
            % (self.PGD_nmax, self.PGD_tol, self.max_fp_it, self.tol_fp_it)
        )

        self.solve_mode = {"FEM": "FEM", "direct": "direct", "FD": "FD"}
        self.MM = []  # per-dim mass matrices for FD norms
        self._mass_cache = {}
        self.rng = np.random.RandomState(seed)

    # ------------------------------------------------------------ properties
    @property
    def dom(self):
        """Subdomain data from the user factory (recomputed per access,
        reference solver.py:136-145)."""
        if self.dom_fct:
            return self.dom_fct(self.V, self.param)
        return 0

    @property
    def bc(self):
        """Boundary conditions from the user factory (solver.py:147-156)."""
        dom_tmp = self.dom
        return self.bc_fct(self.V, dom_tmp, self.param)

    # ------------------------------------------------------------- internals
    def _mass(self, dim):
        """Consistent mass matrix of V[dim] (for dolfin.norm-parity L2);
        scipy-sparse above a size threshold."""
        if dim not in self._mass_cache:
            V = self.V[dim]
            sparse = V.dim() > 2000
            self._mass_cache[dim] = (
                vector_mass_matrix(V, sparse=sparse)
                if V.value_size > 1
                else mass_matrix(V, sparse=sparse)
            )
        return self._mass_cache[dim]

    def _norm(self, arr, dim, solve_modes):
        """Per-dim L2 norm: FD dims use user-provided MM (solver.py:747-752),
        otherwise the consistent FE mass matrix."""
        arr = np.asarray(arr)
        if solve_modes is not None and solve_modes[dim] == self.solve_mode["FD"]:
            M = np.asarray(self.MM[dim])
        else:
            M = self._mass(dim)
        return float(np.sqrt(np.abs(arr @ (M @ arr))))

    def _inner(self, a, b, dim, solve_modes):
        if solve_modes is not None and solve_modes[dim] == self.solve_mode["FD"]:
            M = np.asarray(self.MM[dim])
        else:
            M = self._mass(dim)
        return float(np.asarray(a) @ (M @ np.asarray(b)))

    # ---------------------------------------------------------------- init
    def get_Fsinit(self, V, bc=None, solve_modes=None):
        """Initialize one mode set to normalized ones with bcs applied
        (reference solver.py:158-304; 'randomized' option included)."""
        Fs_init = [None] * len(V)
        if not bc:
            bc = [0] * len(V)

        for dim in range(len(V)):
            Vd = V[dim]
            f = Function(Vd, np.ones(Vd.dim()))

            for b in combine_bcs(bc[dim]):
                b.apply(f)

            if self.fp_init.lower() == "randomized":
                idx = np.where(f.array != 0)[0]
                f.array[idx] = self.rng.rand(len(idx))

            n = self._norm(f.array, dim, solve_modes)
            f.array /= n
            Fs_init[dim] = f

        return Fs_init

    # --------------------------------------------------------------- solve
    def solve_PGD(self, _problem="nonlinear", solve_modes=None, settings=None,
                  resume=False):
        """Progressive enrichment loop (reference solver.py:306-506).

        With ``resume=True`` enrichment continues from the modes already in
        ``self.PGD_func`` instead of restarting — PGD is progressive, so
        previous modes are the full solver state (an extension over the
        reference, which always restarts; SURVEY.md §5)."""
        settings = settings or {}
        if resume and self.PGD_func and len(self.PGD_func[0]):
            n_enr = len(self.PGD_func[0]) - 1
            normConv = list(self._normConv)
            relConv = list(self.amplitude)
        else:
            n_enr = -1
            normConv, relConv = [], []
        while n_enr < self.PGD_nmax - 1:
            n_enr += 1
            if n_enr == 0 and not resume:
                self.PGD_func = [list() for _ in range(self.num_pgd_var)]
                normConv, relConv = [], []

            self.logger.info("enrichment step %s", n_enr)
            bcs = self.bc
            Fs_init = self.get_Fsinit(self.V, bcs, solve_modes)
            norm_Fs = np.ones(self.num_pgd_var)
            for i in range(self.num_pgd_var):
                norm_Fs[i] = self._norm(Fs_init[i].array, i, None)
            delta = np.ones(self.num_pgd_var)

            # residual check with init modes (solver.py:345-395)
            res = []
            for dim in range(self.num_pgd_var):
                if solve_modes is None or solve_modes[dim] == self.solve_mode["FEM"]:
                    ll = self.rhs_fct(
                        None,
                        None,
                        Fs_init,
                        self.meshes,
                        self.dom,
                        self.param,
                        self.load,
                        self.PGD_func,
                        self.prob[dim],
                        n_enr,
                        dim,
                    )
                    ll = np.array(ll, dtype=np.float64)
                    for b in combine_bcs(bcs[dim]):
                        ll = b.apply(ll)
                else:
                    ll = self.rhs_fct(
                        Fs_init[dim],
                        Fs_init[dim],
                        Fs_init,
                        self.meshes,
                        self.dom,
                        self.param,
                        self.load,
                        self.PGD_func,
                        self.prob[dim],
                        n_enr,
                        dim,
                    )
                    ll = np.asarray(ll, dtype=np.float64)
                res.append(float(np.sum(ll * ll)))
            res_error = float(np.sqrt(np.sum(res)))
            self.simulation_info += f"-- residuum norm: {res_error} --\n"
            if res_error < 1e-10:
                self.logger.info(
                    "Residuum error %s smaller 1e-10 in enrichment step %s STOP",
                    res_error,
                    n_enr,
                )
                self.simulation_info += (
                    f"<<<before enrichment step {n_enr} residuum norm smaller "
                    f"1e-10: {res_error} STOP >>>\n"
                )
                break

            # fixed-point iteration
            Fs, norm_Fs = self.FP_solve(
                Fs_init, norm_Fs, delta, n_enr, _problem, solve_modes, settings
            )

            # normalization and mode append (solver.py:404-470)
            normU = float(np.prod(norm_Fs))
            if self.norm_modes.lower() == "no":
                for dim in range(self.num_pgd_var):
                    self.PGD_func[dim].append(Fs[dim])
                self.alpha.append(1.0)

            elif self.norm_modes.lower() == "stiff":
                Fs_normalized = [f.copy() for f in Fs]
                for dim in range(self.num_pgd_var):
                    Fs_normalized[dim].array /= norm_Fs[dim]

                fct_F = Fs_normalized[-1]
                var_F = Fs_normalized[-1]
                a = self.lhs_fct(
                    fct_F,
                    var_F,
                    Fs_normalized,
                    self.meshes,
                    self.dom,
                    self.param,
                    self.prob[-1],
                    self.num_pgd_var,
                )
                if np.isscalar(a) or np.ndim(a) == 0:
                    norm_aux = float(a)
                elif np.ndim(a) == 2:
                    norm_aux = float(var_F.array @ (a @ fct_F.array))
                else:  # residual vector (form evaluated at fct_F)
                    norm_aux = float(var_F.array @ np.asarray(a))
                norm_fac = np.sqrt(np.absolute(norm_aux)) ** (1.0 / self.num_pgd_var)
                self.alpha.append(float(np.prod(norm_Fs)) * norm_fac ** self.num_pgd_var)

                for dim in range(self.num_pgd_var):
                    Fs_normalized[dim].array *= (
                        self.alpha[-1] ** (1.0 / self.num_pgd_var) / norm_fac
                    )
                    self.PGD_func[dim].append(Fs_normalized[dim])

            elif self.norm_modes.lower() == "l2":
                self.alpha.append(normU)
                norm_all = float(np.prod(norm_Fs)) ** (1.0 / self.num_pgd_var)
                for dim in range(self.num_pgd_var):
                    fac = norm_all / norm_Fs[dim]
                    tmp = Function(self.V[dim], fac * Fs[dim].array)
                    self.PGD_func[dim].append(tmp)
            else:
                raise ValueError(f"unknown norm_modes '{self.norm_modes}'")

            # convergence on relative amplitude (solver.py:475-493)
            normConv.append(normU)
            relConv.append(normU / normConv[0])
            self.logger.info(
                "PGD modes updated: normU=%s; relNorm=%s; tol=%s; res_error=%s",
                normU,
                relConv[n_enr],
                self.PGD_tol,
                res_error,
            )
            if relConv[n_enr] < self.PGD_tol:
                self.logger.info(
                    "Convergence reached (relative %s), enriched basis number %s",
                    relConv[n_enr],
                    n_enr,
                )
                break

        self.amplitude = relConv
        self._normConv = normConv
        self.PGD_modes = len(self.PGD_func[0])
        return self

    # ------------------------------------------------------------ FP solve
    def FP_solve(self, Fs_init, norm_Fs, delta, n_enr, _problem, solve_modes, settings):
        """Alternating-directions fixed point (reference solver.py:508-881)."""
        Fs = list(Fs_init)
        Fs_init = list(Fs_init)
        bcs = self.bc

        for fpi in range(self.max_fp_it):
            for seq in range(len(self.seq_fp)):
                dim = self.seq_fp[seq]
                mode = (
                    self.solve_mode["FEM"]
                    if solve_modes is None
                    else solve_modes[dim]
                )
                bc_list = combine_bcs(bcs[dim])

                if mode == self.solve_mode["FEM"]:
                    fct_F = self._solve_fem(
                        dim, Fs, n_enr, _problem, bc_list, settings
                    )
                elif mode == self.solve_mode["direct"]:
                    a, l = self._call_lhs_rhs(dim, Fs, n_enr, None, None)
                    fct_F = self.direct_solve(a, l, dim)
                elif mode == self.solve_mode["FD"]:
                    a, l = self._call_lhs_rhs(dim, Fs, n_enr, None, None)
                    fct_F = self.FD_solve(a, l, dim)
                else:
                    raise ValueError(f"solver '{mode}' doesn't exist")

                Fs[dim] = fct_F
                norm_Fs[dim] = self._norm(fct_F.array, dim, solve_modes)

            # stopping criterion (solver.py:763-871)
            if self.stop_fp.lower() == "delta":
                for dim in range(self.num_pgd_var):
                    dd = np.abs(Fs[dim].array - Fs_init[dim].array)
                    max_index = int(np.argmax(dd))
                    ref = abs(float(Fs[dim].array[max_index]))
                    delta[dim] = dd.max() if ref < 1e-8 else dd.max() / ref
                not_conv = len(np.where(delta > self.tol_fp_it)[0]) > 0
                if not_conv and fpi < self.max_fp_it - 1:
                    Fs_init = list(Fs)
                elif not_conv:
                    self.simulation_info += (
                        f"<<<enrichment step {n_enr} fixed point iteration NOT "
                        f"converged in {fpi + 1} / delta: {delta} >>>\n"
                    )
                    self.num_fp_it.append(fpi + 1)
                    self.err_fp_it.append(np.array(delta))
                    break
                else:
                    self.simulation_info += (
                        f"enrichment step {n_enr} fixed point iteration "
                        f"converged in {fpi + 1} / delta: {delta} \n"
                    )
                    self.num_fp_it.append(fpi + 1)
                    self.err_fp_it.append(np.array(delta))
                    break
            elif self.stop_fp.lower() == "norm":
                newnew, newold, oldold = 1.0, 1.0, 1.0
                for d in range(self.num_pgd_var):
                    newnew *= self._inner(Fs[d].array, Fs[d].array, d, solve_modes)
                    newold *= self._inner(Fs[d].array, Fs_init[d].array, d, solve_modes)
                    oldold *= self._inner(
                        Fs_init[d].array, Fs_init[d].array, d, solve_modes
                    )
                max_error = float(np.sqrt(np.abs(newnew + oldold - 2 * newold)))
                if max_error < self.tol_fp_it:
                    self.simulation_info += (
                        f"enrichment step {n_enr} fixed point iteration "
                        f"converged in {fpi + 1} / error: {max_error:8.6e} \n"
                    )
                    self.num_fp_it.append(fpi + 1)
                    self.err_fp_it.append(max_error)
                    break
                elif fpi < self.max_fp_it - 1:
                    Fs_init = list(Fs)
                else:
                    self.simulation_info += (
                        f"<<<enrichment step {n_enr} fixed point iteration NOT "
                        f"converged in {fpi + 1} / error: {max_error:8.6e} >>>\n"
                    )
                    self.num_fp_it.append(fpi + 1)
                    self.err_fp_it.append(max_error)
                    break
            else:
                raise ValueError(
                    f'stopping criterion not defined {self.stop_fp} '
                    '(self.stop_fp = "delta" or "norm")'
                )

        return Fs, norm_Fs

    # -------------------------------------------------------- dim subsolves
    def _call_lhs_rhs(self, dim, Fs, n_enr, fct_F, var_F):
        a = self.lhs_fct(
            fct_F, var_F, Fs, self.meshes, self.dom, self.param, self.prob[dim], dim
        )
        l = self.rhs_fct(
            fct_F,
            var_F,
            Fs,
            self.meshes,
            self.dom,
            self.param,
            self.load,
            self.PGD_func,
            self.prob[dim],
            n_enr,
            dim,
        )
        return a, l

    def _solve_fem(self, dim, Fs, n_enr, _problem, bc_list, settings):
        V = self.V[dim]
        if _problem.lower() == "linear":
            from scipy import sparse as sps
            from scipy.sparse import linalg as spla

            A, b = self._call_lhs_rhs(dim, Fs, n_enr, None, None)
            b = np.asarray(b)
            for bc in bc_list:
                A, b = bc.apply_system(A, b)
            if sps.issparse(A):
                return Function(V, spla.spsolve(A.tocsr(), b))
            return Function(V, solve_dense(np.asarray(A), b))

        if _problem.lower() == "nonlinear":
            atol = settings.get("absolute_tolerance", 1e-12)
            rtol = settings.get("relative_tolerance", 1e-10)
            maxit = settings.get("maximum_iterations", 50)

            def as_fn(u):
                uf = Function.__new__(Function)
                uf._V = V
                uf.name = "u"
                uf.array = u
                return uf

            probe_a, _ = self._call_lhs_rhs(dim, Fs, n_enr, as_fn(np.zeros(V.dim())), None)
            if np.ndim(probe_a) == 2:
                # quasi-linear A(u) u = b(u): Picard (one step for linear
                # problems, matching the reference's Newton there)
                def system(u):
                    return self._call_lhs_rhs(dim, Fs, n_enr, as_fn(u), None)

                u, converged, _ = picard_solve_np(
                    system,
                    np.zeros(V.dim()),
                    bcs=bc_list,
                    atol=atol,
                    rtol=rtol,
                    max_iter=maxit,
                )
            else:
                # residual-form callbacks: r(u) = lhs(u) − rhs(u), Newton
                def residual(u):
                    a, l = self._call_lhs_rhs(dim, Fs, n_enr, as_fn(u), None)
                    return np.asarray(a) - np.asarray(l)

                bc_dofs = (
                    np.concatenate([bc.dofs for bc in bc_list]) if bc_list else None
                )
                bc_vals = (
                    np.concatenate([bc.values for bc in bc_list]) if bc_list else None
                )
                u, converged, _ = newton_solve_np(
                    residual,
                    np.zeros(V.dim()),
                    bc_dofs,
                    bc_vals,
                    atol=atol,
                    rtol=rtol,
                    max_iter=maxit,
                )
            if not converged:
                self.logger.warning(
                    "nonlinear solve did not converge for dim %s (enrichment %s)",
                    dim,
                    n_enr,
                )
            return Function(V, u)

        raise ValueError(f"unknown _problem '{_problem}'")

    # --------------------------------------------------------------- output
    def return_PGD(self):
        """Package the solution into a :class:`PGD` container
        (reference solver.py:883-907)."""
        solution = PGD(
            name=self.name,
            n_modes=self.PGD_modes,
            fmeshes=self.meshes,
            pgd_modes=self.PGD_func,
            name_coord=self.name_coord,
            modes_info=self.modes_info,
            verbose=False,
            spaces=self.V,
        )
        solution.problem = self
        solution.print_info()
        return solution

    # ------------------------------------------------------- simple solvers
    def direct_solve(self, a, b, dim):
        """Elementwise b/a into a Function (reference solver.py:909-925)."""
        fct_F = Function(self.V[dim])
        vec = np.asarray(b, dtype=np.float64) / a
        fct_F.array = np.broadcast_to(vec, (self.V[dim].dim(),)).astype(np.float64).copy()
        return fct_F

    def FD_solve(self, A, B, dim):
        """Direct solve of the FD system (reference solver.py:927-943,
        scipy spsolve).  The FD_matrices systems (M, D2, D1_up combos) are
        tridiagonal by construction — those route through the native C++
        Thomas solver (utils.native, O(n) vs the dense LU's O(n³));
        anything wider falls back to dense LU."""
        B = np.asarray(B, dtype=np.float64)
        fct_F = Function(self.V[dim])

        if hasattr(A, "tocoo"):
            # SPARSE input: detect tridiagonality on the sparse structure
            # and extract the three diagonals directly — never densify
            # (A.toarray() would be an O(n²) copy in every fixed-point
            # iteration)
            coo = A.tocoo()
            n = coo.shape[0]
            off = coo.col - coo.row
            if n >= 3 and coo.shape[0] == coo.shape[1] and np.all(np.abs(off) <= 1):
                from pgdrome_tpu_torch.utils.native import thomas_solve

                d = np.zeros(n)
                dl = np.zeros(n)  # dl[i] = A[i, i-1]
                du = np.zeros(n)  # du[i] = A[i, i+1]
                # duplicate (row, col) entries sum, matching coo→csr semantics
                np.add.at(d, coo.row[off == 0], coo.data[off == 0])
                np.add.at(dl, coo.row[off == -1], coo.data[off == -1])
                np.add.at(du, coo.row[off == 1], coo.data[off == 1])
                x = thomas_solve(dl, d, du, B)
                if np.all(np.isfinite(x)):
                    fct_F.array = x
                    return fct_F
                # unpivoted Thomas hit a zero/tiny pivot — go straight to
                # the pivoted dense LU (re-running Thomas on the densified
                # but numerically identical diagonals cannot succeed)
                fct_F.array = np.asarray(solve_dense(coo.toarray(), B))
                return fct_F
            # non-tridiagonal sparse input: pivoted dense LU, matching
            # the robustness of the reference's spsolve
            A = coo.toarray()

        A = np.asarray(A, dtype=np.float64)
        n = A.shape[0]
        # tridiagonality check WITHOUT materializing n² triu/tril copies:
        # the matrix is tridiagonal iff its nonzero count matches its
        # three diagonals' nonzero count
        tri_nnz = (
            np.count_nonzero(np.diagonal(A))
            + np.count_nonzero(np.diagonal(A, 1))
            + np.count_nonzero(np.diagonal(A, -1))
        )
        if n >= 3 and np.count_nonzero(A) == tri_nnz:
            from pgdrome_tpu_torch.utils.native import thomas_solve

            dl = np.concatenate([[0.0], np.diagonal(A, -1)])
            du = np.concatenate([np.diagonal(A, 1), [0.0]])
            x = thomas_solve(dl, np.diagonal(A).copy(), du, B)
            if np.all(np.isfinite(x)):
                fct_F.array = x
                return fct_F
            # unpivoted Thomas hit a zero/tiny pivot (indefinite FP
            # combos can do this) — fall through to the pivoted dense LU
        fct_F.array = np.asarray(solve_dense(A, B))
        return fct_F
