"""Deployment container for trained PGD vademecums (counterpart of
``pgdrome_tpu/serving.py``: ``_stream_pipeline`` and the serving methods of
``Vademecum``).

The serving workload is huge parameter batches against one fixed trained
decomposition, so the container holds the trained modes on the device
(full dofs, trimmed to the mode count) with the batch paths built on them:

* :meth:`Vademecum.fields` / :meth:`Vademecum.fields_stream` — full-field
  reconstruction, one-shot or chunked and pipelined;
* :meth:`Vademecum.sensors` / :meth:`Vademecum.sensors_stream` — responses
  at fixed points (the dim-0 modes tabled there once, small LRU cache);
* :meth:`Vademecum.factor_moments` / :meth:`Vademecum.moments` — streaming
  Monte-Carlo mean and variance fields, reduced on the device to K-sized
  factor moments and finished on the host in f64;
* :meth:`Vademecum.residuals` / :meth:`Vademecum.error_bound` — certified
  error queries through an attached
  :class:`~pgdrome_tpu_torch.parallel.certify.Certifier`;
* :meth:`Vademecum.corrected_sensors` — goal-oriented (dual-corrected)
  outputs through an attached :class:`~pgdrome_tpu_torch.dual.DualCorrector`;
* :meth:`Vademecum.errors` — relative L2 errors against FOM fields;
* :meth:`Vademecum.sensors_jacobian` — analytic parameter sensitivities
  at sensor points;
* :meth:`Vademecum.fit_parameters` / :meth:`Vademecum.sample_posterior`
  / :meth:`Vademecum.design_sensors` — calibration from sensor data
  (batched Gauss–Newton, a random-walk Metropolis posterior) and
  D-optimal sensor placement;
* :meth:`Vademecum.sobol`, :meth:`Vademecum.sobol_group`,
  :meth:`Vademecum.output_covariance`, :meth:`Vademecum.main_effect` —
  exact variance-based sensitivity through the separated structure
  (:mod:`pgdrome_tpu_torch.uq`, host f64);
* :meth:`Vademecum.fix_parameters` and :meth:`Vademecum.derivative` — new
  vademecums serving a fixed-parameter slice or the d/dx field;
* :meth:`Vademecum.save` / :meth:`Vademecum.load` — a single-file ``.npz``
  snapshot (``load`` also reads the JAX package's HDF5 snapshots);
* :meth:`Vademecum.to_pgd` — the reference-style
  :class:`~pgdrome_tpu_torch.model.PGD` container of the same modes.

:class:`TransientVademecum` serves space-time results: its field dims are
kron-flattened into one dim-0 table, so the same paths (and kernels) serve
(x, t) fields and space-time sensors.

Energy-basis solves (``precondition_dim0``) pass their transform once at
construction.  Sweeps return tensors on the vademecum's device; the host
analytics (fit, posterior, Sobol', design) return numpy arrays.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from pgdrome_tpu_torch.config import get_device, use_full_f32_matmul
from pgdrome_tpu_torch.parallel.vademecum import param_box, parse_prior
from pgdrome_tpu_torch.separated import PGDResult, host_f64

use_full_f32_matmul()

_NP_TO_TORCH = {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64}


def _stream_pipeline(fn, samples, chunk, depth, consumer, device):
    """Chunked dispatch behind fields_stream / sensors_stream: ``depth``
    chunks in flight, drained BEFORE the next dispatch (the output is
    allocated at dispatch, so dispatch-then-drain would hold depth+1 live
    blocks — which OOMed the reference at bench scale).  The tail chunk is
    padded with the first sample, so every dispatch has one shape, and
    trimmed on output.  ``consumer=None`` collects the result in one host
    tensor (pinned, on the card), allocated once while the first chunk
    computes: each block is copied into its rows on a copy stream that
    waits for the block's event, and the compute stream waits for the copy
    before it reuses the block's memory, so the copy overlaps the next
    chunk's kernels and the host waits once, at the end.  The result is
    that pinned tensor: the host pool reuses its memory once the caller
    drops it, and a call made while earlier results live pins a fresh block
    (PERF.md 6.1 has both rates).  An empty batch gives an empty result."""
    if chunk < 1 or depth < 1:
        raise ValueError("chunk and depth must be positive")
    samples = torch.as_tensor(samples).to(device)
    B = samples.shape[0]
    collect = consumer is None
    if B == 0:
        if collect:
            y0 = fn(samples.new_zeros((1,) + tuple(samples.shape[1:])))
            return torch.empty((0,) + tuple(y0.shape[1:]), dtype=y0.dtype)
        return []
    on_cuda = device.type == "cuda"
    copy_stream = torch.cuda.Stream(device) if collect and on_cuda else None
    host = None  # the collected result
    filled = 0

    def collect_block(y, done):
        nonlocal filled
        rows = host[filled : filled + y.shape[0]]
        if on_cuda:
            copy_stream.wait_event(done)
            with torch.cuda.stream(copy_stream):
                rows.copy_(y, non_blocking=True)
            # the block's memory goes back to the compute stream's pool:
            # whatever reuses it runs after the copy
            torch.cuda.current_stream(device).wait_stream(copy_stream)
        else:
            rows.copy_(y)
        filled += y.shape[0]

    pad = (-B) % chunk if B > chunk else 0
    if pad:
        samples = torch.cat([samples, samples[:1].expand(pad, -1)])
    results = []
    pending = []  # (device block, valid rows, done event)

    def drain():
        y, valid, done = pending.pop(0)
        y = y[:valid] if valid < y.shape[0] else y
        if collect:
            collect_block(y, done)
            return
        if done is not None:
            done.synchronize()
        results.append(consumer(y))

    for start in range(0, samples.shape[0], chunk):
        if len(pending) >= depth:
            drain()
        y = fn(samples[start : start + chunk])
        done = None
        if on_cuda:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(device))
        if collect and host is None:  # while the first chunk computes
            host = torch.empty((B,) + tuple(y.shape[1:]), dtype=y.dtype, pin_memory=on_cuda)
        pending.append((y, min(chunk, B - start), done))
        del y
    while pending:
        drain()
    if collect:
        if on_cuda:
            copy_stream.synchronize()
        return host
    return results


def _prior_key(prior, d_p):
    """The cache-key bytes of a ``(p_prior, gamma)`` prior (b"" for none)."""
    return b"" if prior is None else b"".join(a.tobytes() for a in parse_prior(prior, d_p))


class Vademecum:
    """A trained PGD decomposition packaged for batch serving.

    spaces: per-dim function spaces; result: PGDResult (modes as tensors
    or arrays); dim0_transform: the Dim0Transform when the solve ran in the
    energy basis (modes are mapped back to full dofs here, once).
    method: sweep path, 'auto' | 'fused' | 'torch'
    (:mod:`pgdrome_tpu_torch.parallel.vademecum`).  dtype: serving dtype
    (float32 — the kernel path — or float64).  device: 'cuda' by default;
    without CUDA this raises unless ``device='cpu'`` is asked for."""

    def __init__(self, spaces, result, dim0_transform=None, method="auto",
                 dtype=torch.float32, device="cuda"):
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"dtype must be float32 or float64, got {dtype}")
        self.device = get_device(device)
        self.spaces = list(spaces)
        self.n_modes = int(result.n_modes)
        self._method = method
        dim0 = host_f64(result.modes[0])[: self.n_modes]
        if dim0_transform is not None:
            dim0 = dim0_transform.modes_to_full(dim0)
        host = [dim0] + [host_f64(m)[: self.n_modes] for m in result.modes[1:]]
        # host f64 → dtype on the host, then one copy to the device
        self._modes = [torch.as_tensor(m).to(dtype).to(self.device).contiguous()
                       for m in host]
        self.result = PGDResult(
            modes=self._modes, n_modes=self.n_modes,
            amplitudes=np.asarray(result.amplitudes)[: self.n_modes],
            alpha=np.asarray(result.alpha)[: self.n_modes],
            fp_its=np.asarray(result.fp_its)[: self.n_modes],
            normU0=result.normU0,
        )
        self._sweeps = {}  # out_dtype → sweep
        # small LRU: each entry holds a sweep + tabled modes; an unbounded
        # dict would grow in a server querying many distinct point sets
        self._sensor_cache = OrderedDict()
        self._sensor_cache_max = 8
        self._moments_fn = None
        self._certifier = None
        self._corrector = self._corrector_fn = None

    @property
    def num_dims(self):
        return len(self._modes)

    def _cached(self, key, build):
        """The LRU entry ``key`` of :attr:`_sensor_cache`, built by
        ``build()`` on a miss."""
        fn = self._sensor_cache.get(key)
        if fn is None:
            fn = build()
            self._sensor_cache[key] = fn
            while len(self._sensor_cache) > self._sensor_cache_max:
                self._sensor_cache.popitem(last=False)
        else:
            self._sensor_cache.move_to_end(key)
        return fn

    def _derived(self, spaces, modes):
        """A new vademecum over ``spaces`` with ``modes`` (full dofs,
        trimmed) and this one's traces, method, dtype and device."""
        res = PGDResult(modes=modes, n_modes=self.n_modes,
                        amplitudes=self.result.amplitudes, alpha=self.result.alpha,
                        fp_its=self.result.fp_its, normU0=self.result.normU0)
        return Vademecum(spaces, res, method=self._method, dtype=self._modes[0].dtype,
                         device=self.device)

    def _sweep(self, out_dtype=None):
        from pgdrome_tpu_torch.parallel.vademecum import make_sweep_fn

        fn = self._sweeps.get(out_dtype)
        if fn is None:
            fn = make_sweep_fn(self.spaces, self._modes, self.n_modes,
                               method=self._method, out_dtype=out_dtype)
            self._sweeps[out_dtype] = fn
        return fn

    def fields(self, samples):
        """Full-field reconstruction u(·; p) for a sample batch:
        (B, d−1) → (B, n0) on the device."""
        return self._sweep()(samples)

    def fields_stream(self, samples, consumer=None, chunk=524_288, depth=2,
                      out_dtype=None):
        """Chunked, pipelined field sweep for batches too large to hold on
        the device at once: ``chunk``-sized dispatches, ``depth`` of them in
        flight.  Each finished (chunk_i, n0) device block is handed to
        ``consumer`` (reduce it or copy what you need — the block is
        dropped right after the call); ``consumer=None`` collects the blocks
        in one host tensor and returns it (a CPU tensor, pinned on the
        card).
        ``out_dtype=torch.bfloat16`` narrows the stored fields; compute
        stays float32.  Returns the list of consumer results otherwise."""
        return _stream_pipeline(self._sweep(out_dtype), samples, chunk, depth,
                                consumer, self.device)

    def sensors(self, points):
        """The sensor sweep for a fixed point set: returns
        fn(samples (B, d−1)) → (B, n_pts).  Keyed by the point bytes."""
        from pgdrome_tpu_torch.parallel.vademecum import make_sensor_sweep_fn

        pts = np.asarray(points, dtype=np.float64)
        return self._cached((pts.tobytes(), pts.shape), lambda: make_sensor_sweep_fn(
            self.spaces, self._modes, self.n_modes, pts, method=self._method))

    def sensors_jacobian(self, points):
        """The parameter-sensitivity sweep for a fixed point set: returns
        fn(samples (B, d−1)) → (B, n_pts, d−1), ∂(response)/∂p_j in column
        j — analytic through the rank-1 structure, one differentiated
        factor per column
        (:func:`~pgdrome_tpu_torch.parallel.vademecum.make_sensor_jacobian_fn`).
        Cached beside :meth:`sensors`, in the same LRU."""
        from pgdrome_tpu_torch.parallel.vademecum import make_sensor_jacobian_fn

        pts = np.asarray(points, dtype=np.float64)
        return self._cached(("jac", pts.tobytes(), pts.shape), lambda: make_sensor_jacobian_fn(
            self.spaces, self._modes, self.n_modes, pts))

    def sensors_stream(self, points, samples, consumer=None,
                       chunk=524_288, depth=2):
        """Chunked, pipelined sensor sweep — :meth:`fields_stream` for
        :meth:`sensors`.  A chunk's result copy to the host takes about
        half its kernel's time, so chunks of 524,288 hide all copies but
        the last under the next chunk's kernel: on an H100 (700 W) the
        d=5 vademecum's 4,194,304 samples × 8 points stream in 5.3–5.6 ms,
        against 7.4–7.7 ms as one 8,388,608-sample chunk (kernel, then
        copy) and 4.9 ms one-shot into device memory."""
        return _stream_pipeline(self.sensors(points), samples, chunk, depth,
                                consumer, self.device)

    def factor_moments(self, samples, chunk=8_388_608, depth=2):
        """First and second raw moments of the mode-product factor vector
        over the sample batch: ``(fbar (K,), C (K, K))`` as host float64
        tensors, fbar = E[fac], C = E[fac facᵀ].

        Chunked like :meth:`sensors_stream`, reduced on the device in the
        serving dtype and accumulated across chunks on the host in f64.
        The tail chunk is padded and masked with a 0/1 weight row."""
        from pgdrome_tpu_torch.parallel.vademecum import make_factor_moments_fn

        if self._moments_fn is None:
            self._moments_fn = make_factor_moments_fn(
                self.spaces, self._modes, self.n_modes, method=self._method
            )
        fn = self._moments_fn
        samples = torch.as_tensor(samples).to(self.device)
        B = int(samples.shape[0])
        if B == 0:
            raise ValueError("factor_moments needs at least one sample")
        if chunk < 1 or depth < 1:
            raise ValueError("chunk and depth must be positive")
        chunk = min(chunk, B)
        pad = (-B) % chunk
        if pad:
            samples = torch.cat([samples, samples[:1].expand(pad, -1)])
        dt = self._modes[1].dtype
        n_max = int(self._modes[1].shape[0])
        s1 = torch.zeros(n_max, dtype=torch.float64)
        s2 = torch.zeros((n_max, n_max), dtype=torch.float64)
        pending = []

        def drain():
            y1, y2 = pending.pop(0)
            s1.add_(y1.double().cpu())  # .cpu() waits for this chunk
            s2.add_(y2.double().cpu())

        for start in range(0, int(samples.shape[0]), chunk):
            if len(pending) >= depth:
                drain()
            valid = min(chunk, B - start)
            w = (torch.arange(chunk, device=self.device) < valid).to(dt)
            pending.append(fn(samples[start : start + chunk], w))
        while pending:
            drain()
        return s1 / B, s2 / B

    def moments(self, samples, chunk=8_388_608, depth=2):
        """Monte-Carlo mean and variance fields over the sample batch:
        ``(mean (n0,), var (n0,))`` as host float64 tensors.

        Exact through the separated structure: mean = f̄ᵀM₀ and
        var_i = (M₀ᵀ Cov M₀)_ii, with only the K / K² factor moments
        accumulated on the device (:meth:`factor_moments`) and the
        field-sized products done once on the host in f64."""
        fbar, C = self.factor_moments(samples, chunk=chunk, depth=depth)
        M0 = self._modes[0].detach().cpu().double()  # (n_max, n0)
        mean = fbar @ M0
        cov = C - torch.outer(fbar, fbar)
        var = torch.einsum("ki,ki->i", cov @ M0, M0)
        return mean, torch.clamp(var, min=0.0)

    def attach_certifier(self, certifier):
        """Attach a :class:`~pgdrome_tpu_torch.parallel.certify.Certifier`
        so :meth:`residuals` / :meth:`error_bound` serve certified error
        queries beside the fields; returns the vademecum."""
        self._certifier = certifier
        return self

    def attach_corrector(self, corrector, device=True):
        """Attach a :class:`~pgdrome_tpu_torch.dual.DualCorrector` (one
        output functional) so :meth:`corrected_sensors` serves
        goal-oriented corrected outputs beside the plain sensors.
        ``device=True`` builds the sweep on the vademecum's device
        (:func:`~pgdrome_tpu_torch.dual.make_corrected_sensor_fn`: the
        factors through the sweep's factor kernel, z_r·b in double-f32);
        ``device=False`` keeps the host f64 corrector (certification
        grade).  Not saved by :meth:`save` (the corrector holds the
        operator stacks); attach it again after :meth:`load`.  Returns the
        vademecum."""
        self._corrector = corrector
        self._corrector_fn = None
        if device:
            from pgdrome_tpu_torch.dual import make_corrected_sensor_fn

            self._corrector_fn = make_corrected_sensor_fn(corrector, method=self._method,
                                                          device=self.device)
        return self

    def corrected_sensors(self, samples, return_estimate=False):
        """Dual-corrected outputs s_corr(p) of the attached corrector's
        functional, (B,): float32 tensors on the device from the device
        sweep, host float64 arrays from the host corrector.
        ``return_estimate`` also returns the output error estimate
        s_corr − s_plain (effectivity ≈ 1 once the dual converges)."""
        dc = self._corrector
        if dc is None:
            raise RuntimeError(
                "no corrector attached — build one with dual.DualCorrector(sep, spaces, l, "
                "res_u, tf_u, res_z, tf_z) and attach_corrector(...)"
            )
        if self._corrector_fn is not None:
            # the host corrector's guard: outside the box the θ tables
            # clamp while the mode factors extrapolate
            dc.check_in_box(torch.as_tensor(samples).detach().cpu().numpy())
            s_corr, s_plain = self._corrector_fn(samples)
        else:
            s_corr, s_plain, _ = dc.corrected(samples, return_parts=True)
        if return_estimate:
            return s_corr, s_corr - s_plain
        return s_corr

    def _require_certifier(self):
        if self._certifier is None:
            raise RuntimeError(
                "no certifier attached — build one with "
                "parallel.certify.make_certifier(sep, spaces, result, tf=tf) "
                "and attach_certifier(...)"
            )
        return self._certifier

    def residuals(self, samples):
        """Per-sample relative algebraic residuals, host (B,) float64 (an
        attached certifier required)."""
        return self._require_certifier().residuals(samples)

    def error_bound(self, samples):
        """Calibrated per-sample error bounds η·residual, host (B,) float64
        (an attached, calibrated certifier required)."""
        return self._require_certifier().bound(samples)

    # ------------------------------------------------------------- errors

    def errors(self, samples, fom_fields):
        """Relative L2 errors ‖u − fom‖/‖fom‖ of the served fields against
        precomputed FOM fields, (B,) float64 on the vademecum's device.
        The fields come from this vademecum's own sweep (its ``method``:
        the field kernel on the card)."""
        from pgdrome_tpu_torch.parallel.vademecum import rel_l2_errors

        return rel_l2_errors(self.fields(samples), fom_fields)

    # -------------------------------------------------------- calibration

    def fit_parameters(self, points, observations, p0=None, n_starts=8,
                       seed=0, n_iter=30, damping=1e-9, weights=None,
                       prior=None, return_covariance=False):
        """Identify the parameters behind observed sensor values: batched,
        box-projected, damped Gauss–Newton on ‖W(sensor(p) − obs)‖²
        (+ ‖Γ(p − p_prior)‖²) with the analytic Jacobian
        (:func:`~pgdrome_tpu_torch.parallel.vademecum.make_fit_fn`); every
        (observation × start) problem advances in the same batched steps.

        points: sensor locations (as for :meth:`sensors`); observations:
        (B, n_out), cast to the serving dtype; p0: optional explicit starts
        (B, d_p) — otherwise ``n_starts`` Latin-hypercube starts per
        observation (``scipy.stats.qmc``, ``seed``), shrunk 2 % off the box
        edges, are raced and the lowest regularised cost wins (the
        least-squares landscape of a many-mode vademecum is multimodal).
        ``weights``: (n_out,) per-observation weights; ``prior=(p_prior,
        gamma)``: Tikhonov pull toward p_prior.

        Returns host arrays ``(p_hat (B, d_p), resnorm (B,))`` in the
        serving dtype; with ``return_covariance=True`` also the linearised
        posterior covariance ``cov (B, d_p, d_p)`` = σ̂²(JᵀJ [+ Γ²])⁻¹ at
        p_hat, σ̂² = resnorm²/(n_out − d_p) (needs n_out > d_p)."""
        from scipy.stats import qmc

        from pgdrome_tpu_torch.parallel.vademecum import make_fit_fn

        d_p = self.num_dims - 1
        pp, g2 = parse_prior(prior, d_p) if prior is not None else (None, None)
        pts = self._fit_points(points)
        key = ("fit", pts.tobytes(), pts.shape, int(n_iter), float(damping),
               (np.asarray(weights, np.float64).tobytes() if weights is not None else b""),
               _prior_key(prior, d_p))
        fn = self._cached(key, lambda: make_fit_fn(
            self.spaces, self._modes, self.n_modes, pts, table=self._fit_table(pts),
            n_iter=n_iter, damping=damping, weights=weights, prior=prior))
        obs = torch.as_tensor(observations, dtype=self._modes[0].dtype, device=self.device)
        if obs.ndim != 2:
            raise ValueError(f"observations must be (B, n_out), got {tuple(obs.shape)}")
        B = int(obs.shape[0])
        lo, hi = param_box(self.spaces)
        if p0 is not None:
            p0 = torch.as_tensor(p0)
            if tuple(p0.shape) != (B, d_p):
                raise ValueError(f"p0 must be ({B}, {d_p}), got {tuple(p0.shape)}")
            p_hat, res = (a.cpu().numpy() for a in fn(obs, p0))
        else:
            S = int(n_starts)
            starts = qmc.LatinHypercube(d=d_p, seed=seed).random(S)
            # 2 % off the box edges: the clip boundary is a fixed point of
            # the projected steps, edge starts waste their run there
            starts = lo + (0.02 + 0.96 * starts) * (hi - lo)
            p_all, r_all = fn(obs.repeat_interleave(S, dim=0), np.tile(starts, (B, 1)))
            p_all = p_all.cpu().numpy().reshape(B, S, d_p)
            r_all = r_all.cpu().numpy().reshape(B, S)
            # the winner by the objective each start minimised: with a prior,
            # starts at near-equal data residual differ in the prior's term
            cost_all = r_all ** 2
            if prior is not None:
                cost_all = cost_all + np.sum(g2 * (p_all - pp) ** 2, axis=-1)
            best = np.argmin(cost_all, axis=1)
            idx = np.arange(B)
            p_hat, res = p_all[idx, best], r_all[idx, best]
        if not return_covariance:
            return p_hat, res
        n_out = int(obs.shape[1])
        if n_out <= d_p:
            raise ValueError(f"return_covariance needs n_out > d_p "
                             f"({n_out} sensors for {d_p} parameters)")
        J = host_f64(self.sensors_jacobian(points)(p_hat))  # (B, n_out, d_p)
        if weights is not None:
            # resnorm is the weighted norm; weight J to match
            J = J * np.asarray(weights, np.float64).reshape(-1)[None, :, None]
        JtJ = np.einsum("bod,boe->bde", J, J)
        if prior is not None:
            # the regularised objective's curvature: without the prior's
            # precision a set well-posed only through it is near-singular
            JtJ = JtJ + np.diag(g2)[None]
        sigma2 = res.astype(np.float64) ** 2 / (n_out - d_p)
        return p_hat, res, sigma2[:, None, None] * np.linalg.inv(JtJ)

    def sample_posterior(self, points, observation, sigma, n_samples=1000,
                         n_chains=64, burn=0.5, n_adapt=4, adapt_steps=150,
                         seed=0, prior=None, target_accept=0.3):
        """Sample the Bayesian posterior of the parameters given one observed
        sensor vector: batched random-walk Metropolis over the vademecum
        (:func:`~pgdrome_tpu_torch.parallel.bayes.make_mcmc_fn`), all
        ``n_chains`` chains advancing together.

        Model: obs = sensor(p) + N(0, diag(σ²)), p uniform on the parameter
        box, optionally × the Gaussian ``prior=(p_prior, gamma)`` of
        :meth:`fit_parameters` (whose optimum is this posterior's mode).
        ``sigma``: scalar or (n_out,).

        Pipeline: (1) the MAP by :meth:`fit_parameters` and the Laplace
        proposal shape (JᵀΣ⁻¹J + Γ²)⁻¹, capped at the box scale; (2)
        ``n_adapt`` rounds of ``adapt_steps`` steps tune the global step
        scale to ``target_accept`` and re-estimate the shape from the pooled
        walkers; (3) the main run, its first ``burn`` fraction discarded.
        Adaptation stops before the kept samples, so they are one Markov
        chain.  The host numpy generator ``default_rng(seed)`` draws the
        chain starts and seeds each run's ``torch.Generator`` on the
        vademecum's device.

        Returns a dict: ``samples (n_samples·n_chains, d_p)``, ``chains
        (n_samples, n_chains, d_p)``, ``acceptance``, ``r_hat (d_p,)`` and
        ``ess (d_p,)`` (:func:`~pgdrome_tpu_torch.uq.split_rhat`,
        :func:`~pgdrome_tpu_torch.uq.effective_sample_size` — check r_hat ≤
        1.05 before trusting intervals), ``p_map``, ``proposal_scale`` and
        ``proposal_chol``.  Accuracy follows the serving dtype."""
        from pgdrome_tpu_torch.parallel.bayes import make_mcmc_fn
        from pgdrome_tpu_torch.uq import effective_sample_size, split_rhat

        if n_chains < 2:
            raise ValueError("n_chains must be >= 2 (R-hat needs them)")
        if n_samples < 4:
            raise ValueError("n_samples must be >= 4")
        obs = np.asarray(observation, np.float64).reshape(-1)
        n_out = obs.shape[0]
        d_p = self.num_dims - 1
        sig = np.broadcast_to(np.asarray(sigma, np.float64).reshape(-1), (n_out,)).copy()
        if np.any(sig <= 0):
            raise ValueError("sigma must be positive")
        lo, hi = param_box(self.spaces)
        rng = np.random.default_rng(seed)

        # --- MAP + Laplace proposal shape --------------------------------
        p_map, _ = self.fit_parameters(points, obs[None], weights=1.0 / sig,
                                       prior=prior, n_starts=8, seed=seed)
        p_map = np.asarray(p_map, np.float64)[0]
        J = host_f64(self.sensors_jacobian(points)(p_map[None]))[0]  # (n_out, d_p)
        Jw = J / sig[:, None]
        H = Jw.T @ Jw
        if prior is not None:
            H = H + np.diag(parse_prior(prior, d_p)[1])
        # Laplace covariance; a box-scaled diagonal where the information
        # matrix is (near-)singular
        jitter = 1e-12 * max(np.trace(H) / d_p, 1e-300)
        try:
            cov0 = np.linalg.inv(H + jitter * np.eye(d_p))
        except np.linalg.LinAlgError:
            cov0 = np.diag(((hi - lo) / 20.0) ** 2)
        if not np.all(np.isfinite(cov0)):
            cov0 = np.diag(((hi - lo) / 20.0) ** 2)
        # cap the proposal at the box scale: a flat likelihood direction
        # must not fling every proposal out of the box
        box_var = ((hi - lo) / 2.0) ** 2
        s = np.sqrt(np.minimum(np.diag(cov0), box_var) / np.maximum(np.diag(cov0), 1e-300))
        cov0 = cov0 * np.outer(s, s)

        def _chol(C):
            C = 0.5 * (C + C.T)
            eps = 1e-12 * max(np.trace(C) / d_p, 1e-300)
            for _ in range(8):
                try:
                    return np.linalg.cholesky(C + eps * np.eye(d_p))
                except np.linalg.LinAlgError:
                    eps *= 100.0
            return np.diag(np.sqrt(np.maximum(np.diag(C), 1e-300)))

        chol = _chol(cov0)
        scale = 2.38 / np.sqrt(d_p)

        # --- chain starts: MAP + proposal-shaped scatter, kept in the box --
        starts = p_map[None, :] + rng.standard_normal((int(n_chains), d_p)) @ chol.T
        margin = 1e-6 * (hi - lo)
        state = np.clip(starts, lo + margin, hi - margin)
        pts = self._fit_points(points)
        prior_key = _prior_key(prior, d_p)

        def run(steps, state):
            fn = self._cached(("mcmc", pts.tobytes(), pts.shape, int(steps), prior_key),
                              lambda: make_mcmc_fn(self.spaces, self._modes, self.n_modes, pts,
                                                   table=self._fit_table(pts),
                                                   n_steps=int(steps), prior=prior))
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(rng.integers(0, 2**31 - 1)))
            chain, n_acc = fn(obs, sig, state, chol, scale, generator=gen)
            return host_f64(chain), float(n_acc.double().mean()) / steps

        # --- adaptation: tune the scale to target_accept, re-estimate the
        # proposal shape from the pooled walkers ---------------------------
        for _ in range(int(n_adapt)):
            chain, acc = run(adapt_steps, state)
            state = chain[-1]
            scale *= float(np.exp(1.5 * (acc - target_accept)))
            scale = float(np.clip(scale, 1e-4, 1e2))
            cov_emp = np.cov(chain[adapt_steps // 2:].reshape(-1, d_p).T).reshape(d_p, d_p)
            if np.all(np.isfinite(cov_emp)) and np.trace(cov_emp) > 0:
                chol = _chol(cov_emp)

        # --- main run -----------------------------------------------------
        n_burn = int(np.ceil(float(burn) * n_samples))
        n_total = int(n_samples) + n_burn
        chain, acc = run(n_total, state)
        kept = chain[n_burn:]
        return {
            "samples": kept.reshape(-1, d_p),
            "chains": kept,
            "acceptance": acc,
            "r_hat": split_rhat(kept),
            "ess": effective_sample_size(kept),
            "p_map": p_map,
            "proposal_scale": scale,
            "proposal_chol": chol,
        }

    def design_sensors(self, candidates, k, samples=None):
        """D-optimal sensor placement: greedily pick ``k`` of the
        ``candidates`` (as for :meth:`sensors`) maximising det(JᵀJ) of the
        resulting calibration problem, J the analytic sensitivities averaged
        (in the Gram) over ``samples`` (default: the box centre).  Greedy
        with the information-matrix update det(M + A_c) = det(M)·det(I +
        M⁻¹A_c), M started at ε·I.  Returns ``(indices (k,), points (k,
        …))``."""
        cands = np.asarray(candidates, np.float64)
        n_cand = cands.shape[0]
        k = int(k)
        if not 1 <= k <= n_cand:
            raise ValueError(f"k must be in 1..{n_cand}, got {k}")
        d_p = self.num_dims - 1
        if samples is None:
            lo, hi = param_box(self.spaces)
            samples = (0.5 * (lo + hi))[None, :]
        J = host_f64(self.sensors_jacobian(candidates)(np.asarray(samples, np.float64)))
        vs = max(1, J.shape[1] // n_cand)  # outputs per point
        # per-candidate information atoms, sample-averaged
        A = np.einsum("sod,soe->ode", J, J) / J.shape[0]
        A = A.reshape(n_cand, vs, d_p, d_p).sum(axis=1)
        chosen = []
        eps = 1e-12 * (np.trace(A, axis1=1, axis2=2).max() + 1e-300)
        M = np.eye(d_p) * eps
        avail = np.ones(n_cand, dtype=bool)
        for _ in range(k):
            gain = np.linalg.det(np.eye(d_p)[None]
                                 + np.einsum("de,cef->cdf", np.linalg.inv(M), A))
            gain[~avail] = -np.inf
            c = int(np.argmax(gain))
            chosen.append(c)
            avail[c] = False
            M = M + A[c]
        idx = np.asarray(chosen)
        return idx, cands[idx]

    def _fit_points(self, points):
        """The calibration paths' sensor points as a host f64 array."""
        return np.asarray(points, dtype=np.float64)

    def _fit_table(self, points):
        """The calibration paths' (n_max, n_pts) output table at
        ``points``; None lets make_fit_fn and make_mcmc_fn evaluate the dim-0 modes there
        (:class:`TransientVademecum` gives its space-time table)."""
        return None

    # ---------------------------------------------------------- slicing

    def _fixed_weights(self, fixed):
        """Validate ``fixed`` {parameter index → value} and return it with
        the (n_modes,) host f64 product of the fixed factors' values."""
        from pgdrome_tpu_torch.separated import evaluate_modes_1d

        d_p = self.num_dims - 1
        fixed = {int(j): float(v) for j, v in dict(fixed).items()}
        if not fixed:
            raise ValueError("fixed must name at least one parameter dim")
        if not all(0 <= j < d_p for j in fixed):
            raise ValueError(f"parameter indices must be in 0..{d_p - 1}")
        if len(fixed) >= d_p:
            raise ValueError("at least one parameter dim must stay free (to evaluate "
                             "at a single full parameter point, use fields/sensors)")
        lo, hi = param_box(self.spaces)
        w = np.ones(self.n_modes, np.float64)
        for j, v in fixed.items():
            V = self.spaces[1 + j]
            if not lo[j] <= v <= hi[j]:
                raise ValueError(f"fixed value {v} for parameter {j} is outside its "
                                 f"box [{lo[j]}, {hi[j]}]")
            vals = evaluate_modes_1d(V, torch.from_numpy(host_f64(self._modes[1 + j])),
                                     torch.tensor([v], dtype=torch.float64))
            w *= vals.numpy().reshape(-1)
        return fixed, w

    def fix_parameters(self, fixed):
        """Partial evaluation: fold the fixed parameter dims into the dim-0
        modes and return a lower-dimensional vademecum over the remaining
        parameters, u(·; p_free | p_fixed) — exact, it is the evaluation of
        the separated factors.  ``fixed``: {parameter index (0-based) →
        value in its box}; at least one parameter stays free.  Every
        serving path of the result runs at full rate (its fields through
        the field kernel with one parameter dim fewer per fixed one)."""
        fixed, w = self._fixed_weights(fixed)
        keep = [j for j in range(self.num_dims - 1) if j not in fixed]
        dt = self._modes[0].dtype
        new0 = torch.from_numpy(host_f64(self._modes[0]) * w[:, None]).to(dt)
        return self._derived([self.spaces[0]] + [self.spaces[1 + j] for j in keep],
                             [new0] + [self._modes[1 + j] for j in keep])

    # ------------------------------------------------------------ Sobol'

    def sobol(self, points=None, densities=None, second_order=False):
        """Exact Sobol' indices of the served solution, closed-form through
        the separated structure (:mod:`pgdrome_tpu_torch.uq`): no sampling,
        no FOM solves.

        points: sensor points → per-output indices ``(d_p, n_out)`` with the
        per-output mean and variance; None → generalised indices of the
        whole field (variance integrated against the dim-0 mass measure
        over the domain volume): scalar variance and indices, and the mean
        field.  densities: optional per-parameter unnormalised densities
        (None = uniform; scalar / callable / fem Function), parameters
        independent.  Returns ``{'mean', 'variance', 'first' (d_p, …),
        'total' (d_p, …)}``, with ``second_order`` also ``'second' (d_p,
        d_p, …)``.  Host f64."""
        from pgdrome_tpu_torch.uq import sobol_from_stats

        stats = self._factor_stats(densities)
        if points is not None:
            return sobol_from_stats(stats, table=self._sobol_table(points),
                                    second_order=second_order)
        out = sobol_from_stats(stats, out_gram=self._output_gram(),
                               second_order=second_order)
        fbar = np.ones(self.n_modes)
        for m, _ in stats:
            fbar *= m
        out["mean"] = fbar @ host_f64(self._modes[0])
        return out

    def sobol_group(self, group, points=None, densities=None):
        """Closed and total Sobol' indices of a group of parameters
        (0-based), :func:`pgdrome_tpu_torch.uq.sobol_group`; the points and
        densities of :meth:`sobol`.  Returns ``{'variance', 'closed',
        'total'}``."""
        from pgdrome_tpu_torch.uq import sobol_group

        stats = self._factor_stats(densities)
        if points is not None:
            return sobol_group(stats, group, table=self._sobol_table(points))
        return sobol_group(stats, group, out_gram=self._output_gram())

    def output_covariance(self, points, densities=None):
        """Exact mean and covariance matrix of the sensor responses under
        the parameter measure, ``(mean (n_out,), cov (n_out, n_out))``
        (:func:`pgdrome_tpu_torch.uq.output_covariance`); its diagonal is
        :meth:`sobol`'s per-output variance."""
        from pgdrome_tpu_torch.uq import output_covariance

        return output_covariance(self._factor_stats(densities), self._sobol_table(points))

    def main_effect(self, j, values, points, densities=None):
        """Closed-form main-effect curve of parameter ``j`` at the sensor
        ``points``: ``(mean (n_out,), effect (n_values, n_out))`` with
        effect[v] = E[u | p_j = values[v]] − E[u]
        (:func:`pgdrome_tpu_torch.uq.main_effect`)."""
        from pgdrome_tpu_torch.separated import evaluate_modes_1d
        from pgdrome_tpu_torch.uq import main_effect

        stats = self._factor_stats(densities)
        j = int(j)
        if not 0 <= j < len(stats):
            raise ValueError(f"j must be in 0..{len(stats) - 1}")
        vals = evaluate_modes_1d(self.spaces[1 + j],
                                 torch.from_numpy(host_f64(self._modes[1 + j])),
                                 torch.as_tensor(np.asarray(values, np.float64)))
        return main_effect(stats, j, vals.numpy().T, self._sobol_table(points))

    def _factor_stats(self, densities=None):
        from pgdrome_tpu_torch.uq import factor_stats

        return factor_stats(self.spaces[1:], [host_f64(m) for m in self._modes[1:]],
                            self.n_modes, densities=densities)

    def _sobol_table(self, points):
        """(R, n_out) f64 dim-0 mode values at the sensor points."""
        from pgdrome_tpu_torch.parallel.vademecum import sensor_table

        return sensor_table(self.spaces[0], torch.from_numpy(host_f64(self._modes[0])),
                            np.asarray(points, dtype=np.float64))

    def _output_gram(self):
        """(R, R) f64 Gram of the dim-0 modes under the spatial mass
        measure (the block mass of a vector space) over the domain volume:
        the aggregated variance is the spatial mean of the pointwise
        variance.  The mass matrix is assembled and applied sparse."""
        from pgdrome_tpu_torch.fem.assembly import mass_matrix, vector_mass_matrix

        V0 = self.spaces[0]
        W = (vector_mass_matrix(V0, sparse=True) if V0.value_size > 1
             else mass_matrix(V0, sparse=True))
        U = host_f64(self._modes[0])
        return U @ (W @ U.T) / float(np.sum(V0.q_weights))

    # -------------------------------------------------------- derivatives

    def _dim0_mode_map(self, map_fn):
        """A new vademecum with every dim-0 mode replaced by
        ``map_fn(Function) -> Function`` (applied once per mode); all its
        serving paths serve the mapped quantity at full sweep rate."""
        from pgdrome_tpu_torch.fem.function import Function

        V0 = self.spaces[0]
        modes0 = host_f64(self._modes[0])
        dfs = [map_fn(Function(V0, modes0[k])) for k in range(modes0.shape[0])]
        dmodes = np.stack([np.asarray(f.array) for f in dfs])
        return self._derived([dfs[0].function_space()] + self.spaces[1:],
                             [dmodes] + list(self._modes[1:]))

    def derivative(self, direction: int = 0):
        """The derivative vademecum: a new container over the DG(degree−1)
        space with every dim-0 mode replaced by its exact derivative
        (:func:`pgdrome_tpu_torch.fem.derivative.derivative_function`,
        once per mode), so fields, sensors, streams and moments serve the
        derivative field at full sweep rate.  1D and 2D/3D scalar dim-0
        spaces: ∂/∂x_direction (scalar DG fields); a vector dim-0 space
        (the elasticity flagship): the full ∇u tensor, fields (B,
        n_scalar_dofs·vs·gdim) with ∂u_i/∂x_j at ``i·gdim + j`` — see
        :meth:`strain` for its symmetric part."""
        from pgdrome_tpu_torch.fem.derivative import derivative_function

        return self._dim0_mode_map(lambda f: derivative_function(f, direction=direction))

    def gradient(self):
        """The ∇u vademecum: a 2D/3D scalar dim-0 space gives DG gdim-vector
        fields, a vector one the ∇u tensor (as :meth:`derivative`)."""
        from pgdrome_tpu_torch.fem.derivative import gradient_function

        return self._dim0_mode_map(gradient_function)

    def strain(self):
        """The ε(u) = sym(∇u) vademecum of a 2D vector dim-0 space
        (elasticity): Voigt components (ε_xx, ε_yy, γ_xy = 2ε_xy) per DG
        dof.  Strain is parameter-independent and linear in the modes, so
        it is exact per-mode preprocessing and serves at full sweep rate;
        stress needs the material law's parameter dependence (ν is a swept
        coordinate of the flagship), so it is left to the caller."""
        from pgdrome_tpu_torch.fem.derivative import _dg_space, gradient_function
        from pgdrome_tpu_torch.fem.function import Function

        V0 = self.spaces[0]
        if V0.value_size != 2 or V0.mesh().topology_dim() != 2:
            raise ValueError("strain() needs a 2D vector dim-0 space")

        def to_strain(f):
            G = gradient_function(f)  # 4 components: ux,x ux,y uy,x uy,y
            Vg = G.function_space()
            g = np.asarray(G.array).reshape(-1, 4)
            eps = np.stack([g[:, 0], g[:, 3], g[:, 1] + g[:, 2]], axis=1)
            return Function(_dg_space(Vg.mesh(), Vg.degree, dim=3), eps.reshape(-1))

        return self._dim0_mode_map(to_strain)

    def to_pgd(self, name="vademecum", name_coord=None):
        """The reference-style :class:`~pgdrome_tpu_torch.model.PGD`
        container of this decomposition (the model layer: evaluate,
        reducers, derivatives, pxdmf/HDF5 export), on host f64 copies of
        the served modes.  They are full dofs already, so no transform is
        applied again."""
        from pgdrome_tpu_torch.model import pgd_from_result

        return pgd_from_result(self.result, self.spaces, name=name, name_coord=name_coord)

    # -------------------------------------------------------- persistence

    def save(self, filepath):
        """Single-file ``.npz`` snapshot of the deployed decomposition:
        ``n_modes``, ``num_dims``, ``amplitudes``, ``alpha`` and per dim d
        ``modes_{d}`` (full dofs, serving dtype), ``coords_{d}`` (the mesh
        vertices, for validation at :meth:`load`) and ``degree_{d}`` — the
        keys of the JAX package's HDF5 snapshot.  An attached certifier is
        not saved (see :meth:`Certifier.save
        <pgdrome_tpu_torch.parallel.certify.Certifier.save>`)."""
        arrays = {"n_modes": np.int64(self.n_modes), "num_dims": np.int64(self.num_dims),
                  "amplitudes": np.asarray(self.result.amplitudes),
                  "alpha": np.asarray(self.result.alpha)}
        for d, (V, m) in enumerate(zip(self.spaces, self._modes)):
            arrays[f"modes_{d}"] = m.detach().cpu().numpy()
            arrays[f"coords_{d}"] = V.mesh().coordinates()
            arrays[f"degree_{d}"] = np.int64(V.degree)
        with open(filepath, "wb") as f:  # a file object keeps the exact name
            np.savez(f, **arrays)

    @classmethod
    def load(cls, filepath, spaces, method="auto", device="cuda"):
        """Rebuild from :meth:`save`, or from the JAX package's HDF5
        snapshot (a ``.h5`` / ``.hdf5`` path, read through ``h5py``:
        :func:`pgdrome_tpu_torch.convert.read_h5_snapshot`).  ``spaces``
        must match the saved meshes and degrees.  The serving dtype is the
        saved modes'."""
        from pgdrome_tpu_torch.convert import read_snapshot

        z = read_snapshot(filepath, spaces)
        nd = int(z["num_dims"])
        modes = [np.asarray(z[f"modes_{d}"]) for d in range(nd)]
        n_modes = int(z["n_modes"])
        res = PGDResult(modes=[torch.from_numpy(m) for m in modes], n_modes=n_modes,
                        amplitudes=np.asarray(z["amplitudes"]), alpha=np.asarray(z["alpha"]),
                        fp_its=np.zeros(n_modes, dtype=np.int64), normU0=1.0)
        return cls(spaces, res, method=method, dtype=_NP_TO_TORCH[modes[0].dtype],
                   device=device)


class TransientVademecum(Vademecum):
    """:class:`Vademecum` for space-time results: the first ``field_dims``
    dims (e.g. (x, t)) are field dims, the rest parameters.

    The field dims' modes are kron-flattened once, in the serving dtype
    (as the JAX package flattens them), into one (K, n0·n1) dim-0 table, so every batch path serves space-time
    quantities unchanged — on the card through the same field kernels:

    * :meth:`fields` / :meth:`fields_stream` / :meth:`moments` return
      (B, n0·n1); ``.reshape(B, *vd.field_shape)`` recovers the (x, t) grid;
    * :meth:`sensors` / :meth:`sensors_stream` / :meth:`sensors_jacobian`
      and the calibration paths take (n_pts, field_dims) space-time points,
      their table the product of the per-field-dim mode values;
    * :meth:`errors` compares against FOM fields flattened the same way.

    :meth:`save` stores the original per-dim modes and ``field_dims``
    (the flatten is redone at :meth:`load`); :meth:`derivative`
    differentiates the space dim."""

    def __init__(self, spaces, result, field_dims: int = 2, dim0_transform=None,
                 method="auto", dtype=torch.float32, device="cuda"):
        if not 2 <= field_dims < len(spaces):
            raise ValueError(f"field_dims must be in [2, num_dims); got {field_dims} "
                             f"for {len(spaces)} dims")
        K = int(result.n_modes)
        np_dt = np.float32 if dtype == torch.float32 else np.float64
        fmods = []
        for d in range(field_dims):
            m = host_f64(result.modes[d])[:K]
            if d == 0 and dim0_transform is not None:
                m = dim0_transform.modes_to_full(m)
            fmods.append(m.astype(np_dt))
        flat = fmods[0]
        for d in range(1, field_dims):
            flat = (flat[:, :, None] * fmods[d][:, None, :]).reshape(K, -1)
        flat_res = PGDResult(
            modes=[flat] + [host_f64(m)[:K] for m in result.modes[field_dims:]],
            n_modes=K, amplitudes=np.asarray(result.amplitudes)[:K],
            alpha=np.asarray(result.alpha)[:K], fp_its=np.asarray(result.fp_its)[:K],
            normU0=result.normU0,
        )
        # the parameter machinery reads spaces[1:], aligned with the
        # flattened modes; spaces[0] stays the space dim's (bookkeeping,
        # never point-evaluated here)
        super().__init__([spaces[0]] + list(spaces[field_dims:]), flat_res,
                         method=method, dtype=dtype, device=device)
        self.field_dims = int(field_dims)
        self.field_spaces = list(spaces[:field_dims])
        self.field_shape = tuple(m.shape[1] for m in fmods)
        self._field_modes = fmods
        self._all_spaces = list(spaces)

    def _st_table(self, pts):
        """(K, n_pts) f64 product of the field dims' mode values at
        space-time points (n_pts, field_dims)."""
        from pgdrome_tpu_torch.fem.interpolate import eval_dofs_at_points

        K = self.n_modes
        table = np.ones((K, pts.shape[0]), dtype=np.float64)
        for d, (V, m) in enumerate(zip(self.field_spaces, self._field_modes)):
            table *= np.stack([np.asarray(eval_dofs_at_points(V, m[k], pts[:, d]))
                               for k in range(K)]).reshape(K, -1)
        return table

    def _st_points(self, points):
        pts = np.asarray(points, dtype=np.float64)
        if pts.ndim != 2 or pts.shape[1] != self.field_dims:
            raise ValueError(f"space-time sensor points must be (n_pts, {self.field_dims}), "
                             f"got {pts.shape}")
        return pts

    def _sobol_table(self, points):
        return self._st_table(self._st_points(points))

    def _fit_points(self, points):
        return self._st_points(points)

    def _fit_table(self, points):
        return self._st_table(self._st_points(points))

    def _output_gram(self):
        """Kron-structured space-time mass Gram of the flattened field
        modes over the space-time volume, applied axis by axis (never the
        n0·n1 × n0·n1 kron)."""
        from pgdrome_tpu_torch.fem.assembly import mass_matrix

        U = host_f64(self._modes[0]).reshape(self.n_modes, *self.field_shape)
        T = U
        vol = 1.0
        for d, V in enumerate(self.field_spaces):
            T = np.moveaxis(np.tensordot(T, mass_matrix(V), axes=([d + 1], [0])), -1, d + 1)
            vol *= float(np.sum(V.q_weights))
        return np.tensordot(T.reshape(self.n_modes, -1), U.reshape(self.n_modes, -1),
                            axes=([1], [1])) / vol

    def sensors(self, points):
        """The sensor sweep at fixed space-time points (n_pts,
        field_dims): fn(samples (B, d_p)) → (B, n_pts)."""
        from pgdrome_tpu_torch.parallel.vademecum import make_sensor_sweep_fn

        pts = self._st_points(points)
        return self._cached(("st", pts.tobytes(), pts.shape), lambda: make_sensor_sweep_fn(
            self.spaces, self._modes, self.n_modes, pts, method=self._method,
            table=self._st_table(pts)))

    def sensors_jacobian(self, points):
        """Parameter sensitivities at fixed space-time points:
        fn(samples) → (B, n_pts, d_p)."""
        from pgdrome_tpu_torch.parallel.vademecum import make_sensor_jacobian_fn

        pts = self._st_points(points)
        return self._cached(("st-jac", pts.tobytes(), pts.shape),
                            lambda: make_sensor_jacobian_fn(self.spaces, self._modes,
                                                            self.n_modes, pts,
                                                            table=self._st_table(pts)))

    def _with_modes(self, spaces, modes):
        """A transient vademecum over ``spaces`` (field dims first) with
        per-dim ``modes``, this one's traces, method, dtype and device."""
        res = PGDResult(modes=modes, n_modes=self.n_modes,
                        amplitudes=self.result.amplitudes, alpha=self.result.alpha,
                        fp_its=self.result.fp_its, normU0=self.result.normU0)
        return TransientVademecum(spaces, res, field_dims=self.field_dims,
                                  method=self._method, dtype=self._modes[0].dtype,
                                  device=self.device)

    def derivative(self, direction: int = 0):
        """The du/dx transient vademecum: the space dim's modes replaced
        by their exact DG(degree−1) derivatives; time and parameters
        unchanged."""
        from pgdrome_tpu_torch.fem.derivative import derivative_function
        from pgdrome_tpu_torch.fem.function import Function

        V0 = self._all_spaces[0]
        m0 = host_f64(self._field_modes[0])
        dfs = [derivative_function(Function(V0, m0[k]), direction=direction)
               for k in range(self.n_modes)]
        dmodes = np.stack([np.asarray(f.array) for f in dfs])
        return self._with_modes([dfs[0].function_space()] + self._all_spaces[1:],
                                [dmodes] + [host_f64(m) for m in self._field_modes[1:]]
                                + [host_f64(m) for m in self._modes[1:]])

    def fix_parameters(self, fixed):
        """Partial evaluation over the parameter dims (0-based among the
        parameters); the field dims stay.  The fixed factors' values fold
        into the second field dim's modes (exact: any one dim can carry
        the per-mode weights)."""
        fixed, w = self._fixed_weights(fixed)
        keep = [j for j in range(self.num_dims - 1) if j not in fixed]
        fmods = [host_f64(m) for m in self._field_modes]
        fmods[1] = fmods[1] * w[:, None]
        return self._with_modes(self.field_spaces + [self.spaces[1 + j] for j in keep],
                                fmods + [host_f64(self._modes[1 + j]) for j in keep])

    def to_pgd(self, name="vademecum", name_coord=None):
        """The reference-style :class:`~pgdrome_tpu_torch.model.PGD`
        container of the unflattened decomposition: every original dim kept
        separate, field dims first."""
        from pgdrome_tpu_torch.model import pgd_from_result

        res = PGDResult(
            modes=list(self._field_modes) + list(self._modes[1:]), n_modes=self.n_modes,
            amplitudes=np.asarray(self.result.amplitudes), alpha=np.asarray(self.result.alpha),
            fp_its=np.asarray(self.result.fp_its), normU0=self.result.normU0,
        )
        return pgd_from_result(res, self._all_spaces, name=name, name_coord=name_coord)

    def save(self, filepath):
        """Single-file ``.npz`` snapshot of the original per-dim modes
        (field dims first) in :meth:`Vademecum.save`'s keys plus
        ``field_dims``; the flatten is redone at :meth:`load`."""
        all_modes = list(self._field_modes) + [m.detach().cpu().numpy()
                                               for m in self._modes[1:]]
        arrays = {"n_modes": np.int64(self.n_modes), "num_dims": np.int64(len(all_modes)),
                  "field_dims": np.int64(self.field_dims),
                  "amplitudes": np.asarray(self.result.amplitudes),
                  "alpha": np.asarray(self.result.alpha)}
        for d, (V, m) in enumerate(zip(self._all_spaces, all_modes)):
            arrays[f"modes_{d}"] = np.asarray(m)
            arrays[f"coords_{d}"] = V.mesh().coordinates()
            arrays[f"degree_{d}"] = np.int64(V.degree)
        with open(filepath, "wb") as f:
            np.savez(f, **arrays)

    @classmethod
    def load(cls, filepath, spaces, method="auto", device="cuda"):
        """Rebuild from :meth:`save` (or the JAX package's HDF5 snapshot of
        a transient vademecum); ``spaces`` is the full per-dim list, field
        dims first, checked against the saved meshes and degrees."""
        from pgdrome_tpu_torch.convert import read_snapshot

        z = read_snapshot(filepath, spaces)
        nd = int(z["num_dims"])
        modes = [np.asarray(z[f"modes_{d}"]) for d in range(nd)]
        n_modes = int(z["n_modes"])
        res = PGDResult(modes=modes, n_modes=n_modes,
                        amplitudes=np.asarray(z["amplitudes"]), alpha=np.asarray(z["alpha"]),
                        fp_its=np.zeros(n_modes, dtype=np.int64), normU0=1.0)
        return cls(spaces, res, field_dims=int(z.get("field_dims", 2)), method=method,
                   dtype=_NP_TO_TORCH[modes[0].dtype], device=device)
