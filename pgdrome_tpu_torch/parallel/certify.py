"""A-posteriori error indicators and certificates for served vademecums
(counterpart of ``pgdrome_tpu/parallel/certify.py``; ``Certifier.save``
writes ``.npz``, ``load`` also reads the JAX package's HDF5 snapshots).

The per-sample algebraic residual of the separated weak form,

    r(p) = b(p) − K(p)·u_N(p),   K(p) = Σ_t θ_t(p) K_t,   b(p) = Σ_r ρ_r(p) b_r,

batched over samples on the device with no per-sample FEM assembly.  With
collocation parameter dims the operator stacks are diagonal, so θ_t(p) and
ρ_r(p) are interpolated tables, and the relative indicator ‖r‖/‖b(p)‖ is
invariant to boundary-boosted measures.

* :func:`make_residual_indicator` — the certification-grade indicator.
  Its tables G = K_t·u_m and B are built once in host f64 (with the
  energy-norm L⁻¹ folded in) and stored as double-f32 pairs; the
  contraction runs in compensated double-f32 (:mod:`..ops.ddf32`, plain
  elementwise ``torch``, one rounding a step, so the card's dd values
  equal the CPU's bit for bit).
* :class:`Certifier` — the indicator with an effectivity η calibrated on
  FEM-verified samples (``bound = η·residual``), an out-of-distribution
  warning, and an attached :func:`guaranteed_field_bound`.
* :func:`make_screener` / :func:`screened_verify` — the f32 residual
  screener that ranks candidate points every stage of a high-d cascade so
  only the worst few need FEM (``recipes.highd_frontier`` from 8 params).
* :func:`validate_spd_family` / :func:`guaranteed_field_bound` — the
  zero-calibration A(p) ⪰ K0 field-error bound.
* :func:`make_transient_residual_indicator` /
  :func:`make_transient_certifier` — the moving-heat-source family's
  space-time residual, a host f64 quadratic form.

Host samples come in as (B, num_params) arrays; every result is a host
float64 array.  The device work runs on ``device`` (CUDA by default,
``"cpu"`` when asked for).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from pgdrome_tpu_torch.config import get_device, use_full_f32_matmul
from pgdrome_tpu_torch.ops.ddf32 import dd_add, dd_from_f64, dd_mul, dd_mul_f, dd_sum
from pgdrome_tpu_torch.separated import evaluate_modes_1d, host_f64

# the screener's contraction must be true f32: TF32's ~1e-3 relative noise
# is the size of the whole residual signal it ranks
use_full_f32_matmul()

__all__ = [
    "make_residual_indicator",
    "make_certifier",
    "Certifier",
    "make_screener",
    "screened_verify",
    "validate_spd_family",
    "guaranteed_field_bound",
    "make_transient_residual_indicator",
    "make_transient_certifier",
]

# the dd indicator keeps about this many (chunk, T·M, n0) f32 arrays alive
# at once (the dd product's temporaries and the first fold of its sum)
_DD_LIVE_ARRAYS = 12


def _chunked_dispatch(call, samples, chunk, num_params, device):
    """Run ``call`` over a host sample batch in ``chunk``-row blocks on
    ``device``; samples are cast to f32 on the host (the bodies compute in
    f32).  Eager PyTorch reuses no compiled program, so the last block is
    not padded.  Returns a host (B,) float64 array."""
    samples = host_f64(samples)
    if samples.ndim != 2 or samples.shape[1] != num_params:
        raise ValueError(
            f"samples must be (B, {num_params}), got {samples.shape}"
        )
    out = np.empty(samples.shape[0], dtype=np.float64)
    for s in range(0, samples.shape[0], chunk):
        blk = torch.from_numpy(samples[s : s + chunk].astype(np.float32)).to(device)
        out[s : s + blk.shape[0]] = call(blk).double().cpu().numpy()
    return out


def _param_tables(sep):
    """Per-parameter-dim diagonal operator tables (T, n_d) and rhs tables
    (R, n_d), host f64; raises when a parameter operator is not diagonal
    (a Galerkin parameter discretization has no per-sample pointwise
    semantics)."""
    diag_tabs, rhs_tabs = [], []
    for d in range(1, sep.num_dims):
        od = host_f64(sep.ops[d])
        diags = np.stack([np.diag(od[t]) for t in range(od.shape[0])])
        dense = np.zeros_like(od)
        for t in range(od.shape[0]):
            np.fill_diagonal(dense[t], diags[t])
        if not np.allclose(od, dense, rtol=0.0, atol=1e-12 * np.abs(od).max()):
            raise ValueError(
                f"parameter dim {d} operators are not diagonal: residual "
                "certification requires collocation-discretized parameter "
                "dims (models.problems param_discretization='collocation')"
            )
        diag_tabs.append(diags)
        rhs_tabs.append(host_f64(sep.rhs[d]))
    return diag_tabs, rhs_tabs


def make_residual_indicator(sep, spaces, result, tf=None, chunk=None,
                            precondition=True, device="cuda"):
    """A batched per-sample relative-residual indicator.

    sep: the host f64 problem in the nodal basis with ``tf`` the
    Dim0Transform of a preconditioned-basis result, or the preconditioned
    problem (``precondition_dim0``) with ``tf=None``; spaces: its per-dim
    function spaces; result: the PGDResult (modes as tensors or arrays).

    Returns ``indicator(samples) -> (B,) float64`` with ``samples`` (B,
    num_params): ‖b(p) − K(p)u_N(p)‖ / ‖b(p)‖ over the interior dim-0
    dofs, contracted in compensated double-f32 on ``device``.  With
    ``tf`` and ``precondition`` (the default) the norm is the energy norm
    ‖L⁻¹·‖ (L Lᵀ the dim-0 Cholesky held by ``tf``), folded into the host
    tables; the preconditioned problem with ``tf=None`` gives the same
    indicator directly.  The tables G[t, m] = K_t·u_m (interior rows) and
    B are built in host f64 by dense BLAS products and split into dd pairs.
    ``chunk``: samples per device pass (default: as many as keep the dd
    product's temporaries within a quarter of the card's memory, 512 MB on
    the CPU, at most 512)."""
    device = get_device(device)  # raise before the host tables, not after
    nd = sep.num_dims
    T = sep.num_terms
    R = sep.num_rhs
    M = int(result.n_modes)
    if nd < 2:
        raise ValueError("need at least one parameter dim")

    mask0 = host_f64(sep.bc_masks[0])
    m0 = host_f64(result.modes[0])[:M]
    full0 = tf.modes_to_full(m0) if tf is not None else m0
    if full0.shape[1] != sep.sizes[0]:
        raise ValueError(
            f"dim-0 modes have {full0.shape[1]} dofs but the problem has "
            f"{sep.sizes[0]} — pass tf= for preconditioned-basis results"
        )
    n_x = sep.sizes[0]

    diag_tabs, rhs_tabs = _param_tables(sep)

    # G[t, m] = K_t u_m on interior rows: a dense f64 product (the
    # preconditioned stacks are dense; a banded nodal stack costs the same
    # on a multi-core BLAS)
    ops0 = host_f64(sep.ops[0])
    G = np.matmul(full0[None, :, :], ops0.transpose(0, 2, 1))  # (T, M, n)
    G = (G * mask0).reshape(T * M, n_x)
    B0 = host_f64(sep.rhs[0]) * mask0
    if tf is not None and precondition:
        # energy norm: L⁻¹ applied to the interior rows of every table
        G = tf.apply_Linv(G[:, tf.interior].T).T
        B0 = tf.apply_Linv(B0[:, tf.interior].T).T
    # per-dim factor tables: modes (M) ++ operator diagonals (T) ++ rhs (R),
    # one buffer so each dim costs one interpolation
    bufs = [
        np.concatenate(
            [host_f64(result.modes[d])[:M], diag_tabs[d - 1], rhs_tabs[d - 1]],
            axis=0,
        ).astype(np.float32)
        for d in range(1, nd)
    ]
    return _indicator_from_dd(
        spaces, dd_from_f64(G), dd_from_f64(B0), bufs, M, T, R, chunk,
        device=device,
    )


def _dd_prod(vals_list):
    """Compensated product across parameter dims of plain-f32 factor
    batches [(C, K), ...] → dd pair ((C, K), (C, K))."""
    h = vals_list[0]
    l = torch.zeros_like(h)
    for v in vals_list[1:]:
        h, l = dd_mul_f(h, l, v)
    return h, l


def _indicator_from_dd(spaces, G_dd_host, B_dd_host, bufs_host, M, T, R,
                       chunk=None, device="cuda"):
    """The indicator from prebuilt dd tables: ``G_dd_host`` (T·M, n, 2),
    ``B_dd_host`` (R, n, 2), ``bufs_host`` per parameter dim (M+T+R, n_d)
    f32.  The tables are uploaded once, each dd word as a contiguous
    tensor.  ``indicator.dd_residual(pts)`` returns the dd residual and rhs
    pairs of an f32 sample block on the device, before the norms."""
    device = get_device(device)
    nd = len(bufs_host) + 1
    G_h, G_l = (torch.from_numpy(np.ascontiguousarray(G_dd_host[..., i])).to(device)
                for i in (0, 1))
    B_h, B_l = (torch.from_numpy(np.ascontiguousarray(B_dd_host[..., i])).to(device)
                for i in (0, 1))
    bufs = [torch.from_numpy(np.asarray(b, dtype=np.float32)).to(device)
            for b in bufs_host]

    if chunk is None:
        n_tab = G_dd_host.shape[1]
        per_sample = _DD_LIVE_ARRAYS * 4 * max(T * M, 1) * n_tab
        budget = (torch.cuda.get_device_properties(device).total_memory // 4
                  if device.type == "cuda" else 512 * 2**20)
        chunk = max(1, min(512, budget // per_sample))
    chunk = int(chunk)

    def dd_residual(pts):
        w_vals, t_vals, r_vals = [], [], []
        for d in range(1, nd):
            vals = evaluate_modes_1d(spaces[d], bufs[d - 1], pts[:, d - 1])
            w_vals.append(vals[:, :M])
            t_vals.append(vals[:, M : M + T])
            r_vals.append(vals[:, M + T :])
        wh, wl = _dd_prod(w_vals)  # (C, M) mode weights
        th, tl = _dd_prod(t_vals)  # (C, T) operator coefficients
        rh, rl = _dd_prod(r_vals)  # (C, R) rhs coefficients
        # per-sample scale: at high d the common measure factor ∏_d(w·ω)
        # reaches ~1e-20, whose square underflows f32 in the norms; the
        # relative indicator is invariant to a common coefficient scale
        s = 1.0 / torch.clamp(rh.abs().amax(dim=1, keepdim=True), min=1e-37)
        th, tl = dd_mul_f(th, tl, s)
        rh, rl = dd_mul_f(rh, rl, s)
        # c[t, m] = θ_t · w_m (dd outer product), flattened to (C, T·M)
        ch, cl = dd_mul(th[:, :, None], tl[:, :, None], wh[:, None, :], wl[:, None, :])
        ch = ch.reshape(ch.shape[0], T * M)
        cl = cl.reshape(cl.shape[0], T * M)
        kh, kl = dd_mul(ch[:, :, None], cl[:, :, None], G_h[None], G_l[None])
        kh, kl = dd_sum(kh, kl, axis=1)  # (C, n)
        bh, bl = dd_mul(rh[:, :, None], rl[:, :, None], B_h[None], B_l[None])
        bh, bl = dd_sum(bh, bl, axis=1)  # (C, n)
        resh, resl = dd_add(bh, bl, -kh, -kl)
        return resh, resl, bh, bl

    def body(pts):
        resh, resl, bh, bl = dd_residual(pts)
        rv = resh + resl
        bv = bh + bl
        return torch.sqrt((rv * rv).sum(dim=1)) / torch.sqrt((bv * bv).sum(dim=1))

    def indicator(samples):
        return _chunked_dispatch(body, samples, chunk, nd - 1, device)

    indicator.chunk = chunk
    indicator.n_modes = M
    indicator.dd_residual = dd_residual
    # the host tables, for Certifier.save
    indicator._tables = (G_dd_host, B_dd_host, bufs_host, M, T, R)
    return indicator


class Certifier:
    """Residual indicator + empirically calibrated effectivity::

        cert = make_certifier(sep, Vs, res, tf=tf)
        cert.calibrate(cal_samples, verify.sample_errors(res, cal_samples))
        bounds = cert.bound(query_samples)   # η·residual

    ``bound`` certifies (with the recorded safety margin) as long as the
    calibration set is representative — include the parameter-box corners,
    where PGD errors peak."""

    def __init__(self, indicator, eta=None, safety=None):
        self._indicator = indicator
        self.eta = eta
        self.safety = safety
        self.n_calibration = 0
        # what calibrate() saw, for bound()'s out-of-distribution warning
        self.cal_box = None  # (2, d): per-axis [min; max] of the samples
        self.cal_res_range = None  # (res_min, res_max)
        self._guaranteed = None  # attach_guaranteed()

    def residuals(self, samples):
        """Relative algebraic residuals, (B,) float64."""
        return self._indicator(samples)

    def calibrate(self, samples, true_errors, safety=1.5, residuals=None):
        """Fit η = safety · max(true_err / residual) over the calibration
        pairs and return it; ``true_errors`` are per-sample relative
        errors against a trusted solve (e.g. ``elliptic_dense_verifier``'s
        ``sample_errors``); ``residuals``: :meth:`residuals` of ``samples``
        when already computed (the sweep is then not run again).  Records
        the calibration box and residual range for :meth:`bound`'s
        out-of-distribution warning."""
        res = self.residuals(samples) if residuals is None else host_f64(residuals)
        true_errors = np.asarray(true_errors, dtype=np.float64)
        if true_errors.shape != res.shape:
            raise ValueError("true_errors must align with samples")
        ratio = true_errors / np.maximum(res, 1e-300)
        self.eta = float(safety * ratio.max())
        self.safety = float(safety)
        self.n_calibration = int(res.shape[0])
        pts = host_f64(samples)
        if pts.ndim == 2:
            self.cal_box = np.stack([pts.min(axis=0), pts.max(axis=0)])
        self.cal_res_range = (float(res.min()), float(res.max()))
        return self.eta

    def _check_in_distribution(self, samples, res):
        """Warn when queries leave the calibrated distribution: outside the
        calibration parameter box, or with residuals beyond 10× the
        calibrated residual range (η is a fit; there it extrapolates)."""
        pts = host_f64(samples)
        if self.cal_box is not None and pts.ndim == 2 and (
            pts.shape[1] == self.cal_box.shape[1]
        ):
            tol = 1e-12 * np.maximum(1.0, np.abs(self.cal_box).max(axis=0))
            n_out = int(np.sum(
                np.any(pts < self.cal_box[0] - tol, axis=1)
                | np.any(pts > self.cal_box[1] + tol, axis=1)
            ))
            if n_out:
                warnings.warn(
                    f"Certifier.bound: {n_out} quer"
                    f"{'y lies' if n_out == 1 else 'ies lie'} outside the "
                    "calibration parameter box — the certified bound is an "
                    "extrapolation there (re-calibrate on a covering set)",
                    stacklevel=3,
                )
        if self.cal_res_range is not None and res.size:
            lo, hi = self.cal_res_range
            n_far = int(np.sum((res > 10.0 * hi) | (res < 0.1 * lo)))
            if n_far:
                warnings.warn(
                    f"Certifier.bound: {n_far} residual(s) fall outside "
                    f"10x the calibrated residual range [{lo:.3e}, "
                    f"{hi:.3e}] — the effectivity fit does not cover them",
                    stacklevel=3,
                )

    def bound(self, samples):
        """Calibrated error bound η·residual, (B,) float64; warns for
        queries outside the calibration distribution."""
        if self.eta is None:
            raise RuntimeError("call calibrate() first (or set eta=)")
        res = self.residuals(samples)
        self._check_in_distribution(samples, res)
        return self.eta * res

    def attach_guaranteed(self, gbound):
        """Attach a :func:`guaranteed_field_bound` so this certifier serves
        the zero-calibration bound beside the calibrated one."""
        self._guaranteed = gbound
        return self

    def guaranteed_bound(self, samples, norm: str = "rel_l2"):
        """The attached guaranteed per-sample bound; ``norm`` picks the
        component (``rel_l2`` by default, or ``rel_energy`` / ``abs_K0`` /
        ``abs_l2``)."""
        gb = self._guaranteed
        if gb is None:
            raise RuntimeError(
                "no guaranteed bound attached — build one with "
                "guaranteed_field_bound(...) and attach_guaranteed()"
            )
        out = gb(samples)
        if norm not in out:
            raise KeyError(
                f"{norm!r} unavailable (got {sorted(out)}) — Euclidean "
                "components need a Dim0Transform (tf/nodal_tf)"
            )
        return out[norm]

    def save(self, filepath, spaces=None):
        """Single-file ``.npz`` snapshot of the dd residual tables and the
        calibration, so a deployed vademecum serves certified bounds
        without the operator stacks: ``M``, ``T``, ``R``, ``num_dims``,
        ``n_calibration``, ``G_dd``, ``B_dd``, ``buf_{d}`` (d ≥ 1) and, where
        set, ``eta``, ``safety``, ``cal_box`` and ``cal_res_range`` — the
        keys of the JAX package's HDF5 snapshot.  ``spaces`` adds each
        dim's mesh coordinates and degree (``coords_{d}``, ``degree_{d}``)
        for :meth:`load` to validate.  The attached guaranteed bound is not
        saved."""
        tables = getattr(self._indicator, "_tables", None)
        if tables is None:
            raise ValueError("this certifier's indicator carries no dd tables: "
                             "build it with make_residual_indicator")
        G_dd, B_dd, bufs, M, T, R = tables
        arrays = {"M": np.int64(M), "T": np.int64(T), "R": np.int64(R),
                  "num_dims": np.int64(len(bufs) + 1),
                  "n_calibration": np.int64(self.n_calibration),
                  "G_dd": np.asarray(G_dd), "B_dd": np.asarray(B_dd)}
        for d, b in enumerate(bufs):
            arrays[f"buf_{d + 1}"] = np.asarray(b)
        for key in ("eta", "safety", "cal_box", "cal_res_range"):
            if getattr(self, key) is not None:
                arrays[key] = np.asarray(getattr(self, key), dtype=np.float64)
        for d, V in enumerate(spaces or ()):
            arrays[f"coords_{d}"] = V.mesh().coordinates()
            arrays[f"degree_{d}"] = np.int64(V.degree)
        with open(filepath, "wb") as f:  # a file object keeps the exact name
            np.savez(f, **arrays)

    @classmethod
    def load(cls, filepath, spaces, chunk=None, device="cuda"):
        """Rebuild from :meth:`save`, or from the JAX package's HDF5
        snapshot (a ``.h5`` / ``.hdf5`` path, through ``h5py``), validated
        against ``spaces``: the parameter tables' dof counts always, the
        meshes and degrees where the snapshot holds them.  The indicator
        runs on ``device`` with ``chunk`` samples a pass (default as
        :func:`make_residual_indicator`'s)."""
        from pgdrome_tpu_torch.convert import read_snapshot

        z = read_snapshot(filepath, spaces, kind="certifier")
        nd = int(z["num_dims"])
        bufs = [np.asarray(z[f"buf_{d}"]) for d in range(1, nd)]
        # the parameter tables are interpolated through spaces[d]'s dofmap:
        # a size mismatch would gather garbage
        for d in range(1, nd):
            if bufs[d - 1].shape[1] != spaces[d].dim():
                raise ValueError(
                    f"space {d} has {spaces[d].dim()} dofs but the saved certifier "
                    f"tables have {bufs[d - 1].shape[1]} — wrong parameter space "
                    "for this snapshot")
        ind = _indicator_from_dd(spaces, np.asarray(z["G_dd"]), np.asarray(z["B_dd"]), bufs,
                                 int(z["M"]), int(z["T"]), int(z["R"]), chunk, device=device)
        out = cls(ind, eta=float(z["eta"]) if "eta" in z else None,
                  safety=float(z["safety"]) if "safety" in z else None)
        out.n_calibration = int(z["n_calibration"])
        out.cal_box = np.asarray(z["cal_box"]) if "cal_box" in z else None
        if "cal_res_range" in z:
            out.cal_res_range = tuple(float(v) for v in np.asarray(z["cal_res_range"]))
        return out


def make_screener(sep, spaces, n_modes_cap, chunk=2048, device="cuda"):
    """Per-stage residual screener for adaptive cascades: rank candidate
    points by their f32 residual so only the worst few need FEM
    (:func:`screened_verify`).

    Unlike :func:`make_residual_indicator`: the G = K_t·u_m tables are
    built on the device in true f32 from operator stacks uploaded once;
    dim-0 modes are zero-padded to ``n_modes_cap`` (zero rows are inert)
    so every stage of a growing cascade has the same shapes; the
    contraction is a true-f32 matmul, whose ~cancellation·2⁻²⁴ noise
    ranks errors in the 1e-3..1e-6 band (certify with the dd indicator).

    sep: the host f64 preconditioned problem the modes were solved in.
    Returns ``screen(result, samples) -> (B,)``; a result with more modes
    than the cap raises."""
    device = get_device(device)
    nd = sep.num_dims
    T = sep.num_terms
    cap = int(n_modes_cap)
    if nd < 2:
        raise ValueError("need at least one parameter dim")
    diag_tabs, rhs_tabs = _param_tables(sep)

    def put(a):
        return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(device)

    mask0 = host_f64(sep.bc_masks[0])
    ops0 = put(host_f64(sep.ops[0]))
    mask_dev = put(mask0)
    B0 = put(host_f64(sep.rhs[0]) * mask0)
    stat_bufs = [put(np.concatenate([diag_tabs[d - 1], rhs_tabs[d - 1]], axis=0))
                 for d in range(1, nd)]

    def screen_body(pts, G, mode_bufs):
        w = th = rh = None
        for d in range(1, nd):
            mv = evaluate_modes_1d(spaces[d], mode_bufs[d - 1], pts[:, d - 1])
            sv = evaluate_modes_1d(spaces[d], stat_bufs[d - 1], pts[:, d - 1])
            w = mv if w is None else w * mv
            th = sv[:, :T] if th is None else th * sv[:, :T]
            rh = sv[:, T:] if rh is None else rh * sv[:, T:]
        # the dd body's per-sample scale: ∏_d(w·ω) (~1e-20 at d=10)
        # squared underflows f32
        s = 1.0 / torch.clamp(rh.abs().amax(dim=1, keepdim=True), min=1e-37)
        th = th * s
        rh = rh * s
        C = (th[:, :, None] * w[:, None, :]).reshape(pts.shape[0], T * cap)
        bvec = rh @ B0
        r = bvec - C @ G
        return torch.sqrt((r * r).sum(dim=1)) / torch.sqrt((bvec * bvec).sum(dim=1))

    def screen(result, samples):
        M = int(result.n_modes)
        if M > cap:
            raise ValueError(f"result has {M} modes > n_modes_cap {cap}")
        m0 = host_f64(result.modes[0])[:M]
        if m0.shape[1] != sep.sizes[0]:
            raise ValueError(
                f"dim-0 modes have {m0.shape[1]} dofs, problem has "
                f"{sep.sizes[0]} — the screener needs the pc problem the "
                "modes were solved in"
            )
        full0 = np.zeros((cap, sep.sizes[0]), dtype=np.float32)
        full0[:M] = m0
        G = torch.einsum("tij,mj->tmi", ops0, put(full0))
        G = (G * mask_dev).reshape(T * cap, -1)
        mode_bufs = []
        for d in range(1, nd):
            buf = np.zeros((cap, sep.sizes[d]), dtype=np.float32)
            buf[:M] = host_f64(result.modes[d])[:M]
            mode_bufs.append(put(buf))
        return _chunked_dispatch(lambda pts: screen_body(pts, G, mode_bufs),
                                 samples, chunk, nd - 1, device)

    screen.n_modes_cap = cap
    return screen


def screened_verify(screen, sample_errors, corners, *, top_k=16,
                    interior_samples=None, safety=2.0, log=None):
    """An ``adaptive_cascade`` ``verify(result)`` that FEM-verifies only
    the ``top_k`` worst-screened candidates.

    Per call: screen all ``corners``, FEM-verify the ``top_k`` worst via
    ``sample_errors(result, pts)``, fit the stage effectivity
    η = safety·max(true/residual) on those pairs, and report the
    unmeasured candidates at their estimate η·residual.  ``corners`` in the
    returned dict is max(measured, estimated); ``eta``, ``measured_max``
    and ``estimated_max`` keep it auditable, ``worst_points`` /
    ``worst_errors`` (measured, worst first) feed corner-seeded stages.
    ``interior_samples`` are always FEM-verified."""
    corners = np.asarray(corners, dtype=np.float64)
    say = log or (lambda *a: None)
    if top_k < 1:
        # order[-0:] would select every corner, and η needs measured pairs
        raise ValueError("top_k must be >= 1 (eta needs measured pairs)")

    def verify(result):
        rs = screen(result, corners)
        order = np.argsort(rs)
        k = min(top_k, len(order))
        worst = order[len(order) - k:]
        rest = order[: len(order) - k]
        te = np.asarray(sample_errors(result, corners[worst]))
        eta = float(safety * (te / np.maximum(rs[worst], 1e-300)).max())
        est_max = float(eta * rs[rest].max()) if len(rest) else 0.0
        measured_max = float(te.max())
        corners_val = max(measured_max, est_max)
        interior_val = 0.0
        if interior_samples is not None:
            interior_val = float(
                np.asarray(sample_errors(result, interior_samples)).max()
            )
        say(
            f"screened verify: measured {measured_max:.3e} (top {len(worst)}"
            f" of {len(corners)}), estimated rest {est_max:.3e} "
            f"(eta {eta:.2f}), interior {interior_val:.3e}"
        )
        rank = np.argsort(te)[::-1]
        return {
            "corners": corners_val,
            "interior": interior_val,
            "max": max(corners_val, interior_val),
            "eta": eta,
            "measured_max": measured_max,
            "estimated_max": est_max,
            "screened": True,
            "worst_points": corners[worst][rank],
            "worst_errors": te[rank],
        }

    return verify


def make_certifier(sep, spaces, result, tf=None, chunk=None, eta=None,
                   device="cuda"):
    """:func:`make_residual_indicator` wrapped in a :class:`Certifier`."""
    return Certifier(
        make_residual_indicator(sep, spaces, result, tf=tf, chunk=chunk,
                                device=device),
        eta=eta,
    )


# ------------------------------------------------- guaranteed (rigorous)

def validate_spd_family(sep):
    """Check the checkable hypotheses of the A(p) ⪰ K0 bounds on a
    collocation problem: every parameter dim's operator stack is diagonal,
    its base-term diagonal (the measure weight) is positive, and every
    term's θ_0-normalised coefficient θ_t(p) = Π_d diag_td/diag_0d is ≥ 0
    at every grid point.  That dim-0 term 0 is the SPD K0 and the other
    K_t are PSD is structural for the stiffness builders and not
    re-checkable from the parameter tables.  Raises ValueError."""
    for j in range(1, sep.num_dims):
        od = host_f64(sep.ops[j])
        off = od - od * np.eye(od.shape[1])[None]
        if np.abs(off).max() > 1e-12 * max(np.abs(od).max(), 1.0):
            raise ValueError(
                f"dim {j} operator stack is not collocation-diagonal — "
                "affine coefficients θ_t(p) cannot be read off a "
                "consistent-Galerkin parameter discretization"
            )
        w = np.diagonal(od[0]).astype(np.float64)
        if np.any(w <= 0):
            raise ValueError(f"dim {j} base-term diagonal is not positive")
        g = np.diagonal(od, axis1=1, axis2=2) / w[None, :]
        if g.min() < -1e-12:
            raise ValueError(
                f"dim {j} has negative operator coefficients "
                f"(min {g.min():.2e}) — A(p) ⪰ K0 does not hold and "
                "the guaranteed bound is invalid"
            )


GUARANTEE_CAVEAT = (
    "the bound multiplies the residual norm ||L^-1 r(p)|| as the dd-f32 "
    "indicator evaluates it on the device, from coefficient and factor "
    "tables rounded to f32; the rounding of that evaluation (the tables' "
    "f32 rounding, amplified by the residual's cancellation, the dd steps "
    "and the final f32 norm) is not accounted for in the bound"
)


def guaranteed_field_bound(sep, spaces, result, tf=None, *, nodal_tf=None,
                           chunk=None, device="cuda"):
    """Zero-calibration per-sample field-error bound.

    For the affine SPD family A(p) = K0 + Σ_t θ_t(p) K_t with θ_0 ≡ 1,
    θ_t ≥ 0 and K_t PSD (:func:`validate_spd_family`), A(p) ⪰ K0, so with
    e = u − u_r and r(p) = b(p) − A(p)u_r:

        ‖e‖_{K0} ≤ ‖e‖_{A(p)} = ‖r(p)‖_{A(p)⁻¹} ≤ ‖r(p)‖_{K0⁻¹} = ‖L⁻¹r(p)‖₂

    (K0 = L Lᵀ), and ‖L⁻¹r‖/‖L⁻¹b‖ is what the energy-norm dd indicator
    computes.  Euclidean: ‖e‖₂ ≤ ‖e‖_{K0}/√λ_min with the lower bound
    λ_min(K0) ≥ 1/‖K0⁻¹‖_∞ (exact row sums of L⁻ᵀL⁻¹; a Rayleigh estimate
    is kept beside it).  Relative bounds divide by ‖u_r(p)‖ less the bound
    itself (‖u‖ ≥ ‖u_r‖ − ‖e‖).

    Caveat: the bound multiplies the residual norm as the dd-f32 indicator
    evaluates it on the device, from f32 coefficient and factor tables, and
    does not account for that evaluation's rounding; "guaranteed" holds up
    to that evaluation error (``bound.caveat`` says so in the report).

    Arguments as :func:`make_residual_indicator`: ``sep`` nodal with
    ``tf``, or ``sep`` the preconditioned stacks with ``tf=None`` (dim-0
    term 0 must then be ≈ I) and ``nodal_tf`` for the Euclidean
    conversion (without it only the energy-norm bounds are given).

    Returns ``bound(samples, residuals=None) -> dict`` of per-sample host
    f64 arrays: ``abs_K0``, ``rel_energy`` and, when convertible,
    ``abs_l2`` and ``rel_l2`` (``inf`` where the denominator guard fails);
    ``residuals``: ``bound.indicator(samples)`` when already computed (the
    dd sweep is then not run again).  Attributes: ``lam_min_lower``,
    ``lam_min_estimate``, ``indicator``, ``caveat``."""
    device = get_device(device)
    validate_spd_family(sep)
    conv_tf = tf if tf is not None else nodal_tf
    mask0 = host_f64(sep.bc_masks[0])
    if tf is None:
        I0 = host_f64(sep.ops[0][0])
        I_ref = np.diag(mask0) + np.diag(1.0 - mask0)
        if np.abs(I0 - I_ref).max() > 1e-8:
            raise ValueError(
                "preconditioned-basis mode (tf=None) needs dim-0 term 0 "
                "≈ I (precondition_dim0 stacks) for A(p) ⪰ I to hold"
            )

    ind = make_residual_indicator(sep, spaces, result, tf=tf, chunk=chunk,
                                  device=device)
    M = int(result.n_modes)
    m0 = host_f64(result.modes[0])[:M]
    num_params = sep.num_dims - 1

    # ‖L⁻¹b(p)‖ through the (R, R) Gram of the preconditioned masked rhs
    B0 = host_f64(sep.rhs[0]) * mask0
    B0p = tf.apply_Linv(B0[:, tf.interior].T).T if tf is not None else B0
    Gb = B0p @ B0p.T
    diag_tabs, rhs_tabs = _param_tables(sep)
    # the collocation measure scales A(p) and b(p) by the common factor
    # c0(p) = Π_d w_d(p_d); the bound holds for the c0-normalised system
    # (θ_0 ≡ 1), so the absolute residual is ‖L⁻¹b(p)‖/c0(p) × rel
    base_tabs = [diag_tabs[d][:1] for d in range(num_params)]

    # ‖u_r(p)‖ Grams: the modes live in the preconditioned basis, so mᵀm
    # is the K0-energy Gram; Euclidean needs the nodal reconstruction
    Gu_K0 = m0 @ m0.T
    full0 = conv_tf.modes_to_full(m0) if conv_tf is not None else None
    Gu_l2 = full0 @ full0.T if full0 is not None else None

    lam_min_lower = lam_min_est = None
    if conv_tf is not None:
        n_int = len(conv_tf.interior)
        Kinv = conv_tf.apply_LinvT(conv_tf.apply_Linv(np.eye(n_int)))
        lam_min_lower = 1.0 / float(np.abs(Kinv).sum(axis=1).max())
        v = np.ones(n_int)
        for _ in range(80):
            v = conv_tf.apply_LinvT(conv_tf.apply_Linv(v))
            v /= np.linalg.norm(v)
        mu = float(v @ conv_tf.apply_LinvT(conv_tf.apply_Linv(v)))
        lam_min_est = 1.0 / mu

    mode_tabs = [host_f64(result.modes[1 + d])[:M] for d in range(num_params)]

    def _factor_products(samples, tabs):
        out = None
        for d in range(num_params):
            vals = evaluate_modes_1d(spaces[1 + d], torch.from_numpy(tabs[d]),
                                     torch.from_numpy(samples[:, d])).numpy()
            out = vals if out is None else out * vals
        return out

    def _gram_norm(f, G):
        """√(fᵀ G f) per row of f."""
        return np.sqrt(np.maximum(((f @ G) * f).sum(axis=1), 0.0))

    def bound(samples, residuals=None):
        samples = host_f64(samples)
        rel = ind(samples) if residuals is None else host_f64(residuals)
        nb = _gram_norm(_factor_products(samples, rhs_tabs), Gb)
        c0 = _factor_products(samples, base_tabs)[:, 0]
        abs_K0 = rel * nb / c0
        fu = _factor_products(samples, mode_tabs)
        den = _gram_norm(fu, Gu_K0) - abs_K0
        rel_energy = np.where(den > 0.0, abs_K0 / np.maximum(den, 1e-300), np.inf)
        out = {"abs_K0": abs_K0, "rel_energy": rel_energy}
        if lam_min_lower is not None:
            abs_l2 = abs_K0 / np.sqrt(lam_min_lower)
            den2 = _gram_norm(fu, Gu_l2) - abs_l2
            out["abs_l2"] = abs_l2
            out["rel_l2"] = np.where(den2 > 0.0, abs_l2 / np.maximum(den2, 1e-300),
                                     np.inf)
        return out

    bound.lam_min_lower = lam_min_lower
    bound.lam_min_estimate = lam_min_est
    bound.indicator = ind
    bound.caveat = GUARANTEE_CAVEAT
    return bound


# ------------------------------------------------- transient (space-time)

def make_transient_residual_indicator(sep, spaces, result, factors):
    """Per-sample relative residual of the transient moving-heat-source
    family (dims (x, t, P, v) with a parameter-independent space-time
    operator and a P-linear separated source) — the certification
    counterpart of ``transient_dense_verifier``, on the host in f64.

    Per sample the full-order system is A u = b(P, v) with A = Σ_t
    kron(ops0_t, ops1_t) and the initial-condition rows pinned to the
    identity (the verifier's FOM).  The served solution is Σ_k w_k(P, v)
    X_k ⊗ T_k, so the residual is a sum of rank-1 space-time terms
    (source, A·u with the IC rows masked, the IC rows), and its norm is
    the quadratic form ‖r‖² = zᵀQz, Q = (S_x S_xᵀ) ∘ (S_t S_tᵀ) built
    once: no space-time vector per sample.  The form cancels from ‖b‖²
    down to ‖r‖², so f64 rounding floors the relative residual at about
    √(K_tot·1e-16); below it the indicator saturates (it only ever
    overestimates).

    Returns ``indicator(samples (B, 2) = (P, v)) → (B,) float64``; its
    ``_tables`` is None (:meth:`Certifier.save` does not cover this
    family)."""
    if sep.num_dims != 4:
        raise ValueError("make_transient_residual_indicator covers the moving_heat_source "
                         "family: dims (x, t, P, v)")
    for d in (2, 3):
        od, md = host_f64(sep.ops[d]), host_f64(sep.mass[d])
        for t in range(od.shape[0]):
            if not np.allclose(od[t], md, rtol=0.0, atol=1e-12 * np.abs(md).max()):
                raise ValueError(
                    f"parameter dim {d} operator term {t} is not the mass: the per-sample "
                    "space-time system would need per-sample operator coefficients"
                )
    M = int(result.n_modes)
    ops0, ops1 = host_f64(sep.ops[0]), host_f64(sep.ops[1])  # (T, nx, nx), (T, nt, nt)
    T = ops0.shape[0]
    X = host_f64(result.modes[0])[:M]
    Tm = host_f64(result.modes[1])[:M]
    Mx = host_f64(sep.mass[0])
    Mt = ops1[1]  # the family's time mass (as the verifier takes it)
    Fx, Ft, Fv = (np.asarray(f, dtype=np.float64) for f in factors[:3])
    R = Fx.shape[0]

    # rank-1 space and time vector stacks, blocks [A terms | IC | rhs]
    SA_blocks, SB_blocks = [], []
    for t in range(T):
        SA_blocks.append(X @ ops0[t].T)
        bt = Tm @ ops1[t].T
        bt[:, 0] = 0.0  # the IC rows are masked out of A·u
        SB_blocks.append(bt)
    SA_blocks.append(X)  # the IC identity rows: u(x, t=0)
    e0 = np.zeros((M, Tm.shape[1]))
    e0[:, 0] = Tm[:, 0]
    SB_blocks.append(e0)
    SA_blocks.append(Fx @ Mx.T)  # the source (Mx F_r) ⊗ (Mt G_r)
    br = Ft @ Mt.T
    br[:, 0] = 0.0  # the FOM zeroes the rhs IC rows
    SB_blocks.append(br)
    SA, SB = np.concatenate(SA_blocks), np.concatenate(SB_blocks)
    Q = (SA @ SA.T) * (SB @ SB.T)
    K_tot = Q.shape[0]
    Q_rr = Q[K_tot - R:, K_tot - R:]
    VP, Vv = spaces[2], spaces[3]
    mP = torch.from_numpy(host_f64(result.modes[2])[:M])
    mv = torch.from_numpy(host_f64(result.modes[3])[:M])
    tFv = torch.from_numpy(Fv)

    def indicator(samples):
        samples = np.asarray(samples, dtype=np.float64)
        if samples.ndim != 2 or samples.shape[1] != 2:
            raise ValueError(f"samples must be (B, 2) = (P, v), got {samples.shape}")
        P_val, v_val = torch.from_numpy(samples[:, 0]), torch.from_numpy(samples[:, 1])
        w = (evaluate_modes_1d(VP, mP, P_val) * evaluate_modes_1d(Vv, mv, v_val)).numpy()
        rho = samples[:, :1] * evaluate_modes_1d(Vv, tFv, v_val).numpy()  # (B, R)
        z = np.concatenate([np.tile(-w, (1, T)), -w, rho], axis=1)  # (B, K_tot)
        r2 = np.einsum("bi,bi->b", z @ Q, z)
        b2 = np.einsum("bi,bi->b", rho @ Q_rr, rho)
        # clip at the form's own f64 rounding, never negative or NaN
        floor = K_tot * 1e-16 * np.abs(b2)
        return np.sqrt(np.maximum(r2, floor) / b2)

    indicator.n_modes = M
    indicator.chunk = None
    indicator._tables = None
    return indicator


def make_transient_certifier(sep, spaces, result, factors, eta=None):
    """:func:`make_transient_residual_indicator` in a :class:`Certifier`;
    calibrate it on FOM-verified pairs (``transient_dense_verifier(...)
    .sample_errors`` takes integer grid-index pairs: the certifier takes
    the physical (P, v))."""
    return Certifier(make_transient_residual_indicator(sep, spaces, result, factors),
                     eta=eta)
