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
  :class:`~pgdrome_tpu_torch.parallel.certify.Certifier`.

Energy-basis solves (``precondition_dim0``) pass their transform once at
construction.  HDF5 ``save``/``load`` are not ported yet.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from pgdrome_tpu_torch.config import get_device, use_full_f32_matmul
from pgdrome_tpu_torch.separated import PGDResult, host_f64

use_full_f32_matmul()


def _to_host(y, copy_stream):
    """Copy a finished device block into pinned host memory on
    ``copy_stream``, so the copy overlaps the next chunk's compute."""
    host = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
    with torch.cuda.stream(copy_stream):
        host.copy_(y, non_blocking=True)
    copy_stream.synchronize()
    return host


def _stream_pipeline(fn, samples, chunk, depth, consumer, device):
    """Chunked dispatch behind fields_stream / sensors_stream: ``depth``
    chunks in flight, drained BEFORE the next dispatch (the output is
    allocated at dispatch, so dispatch-then-drain would hold depth+1 live
    blocks — which OOMed the reference at bench scale).  The tail chunk is
    padded with the first sample, so every dispatch has one shape, and
    trimmed on output.  ``consumer=None`` collects the blocks in pinned
    host memory and returns their concatenation as a CPU tensor; an empty
    batch gives an empty result."""
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
    if collect:
        blocks = []
        copy_stream = torch.cuda.Stream(device) if on_cuda else None

        def consumer(y):
            blocks.append(_to_host(y, copy_stream) if on_cuda else y.clone())

    pad = (-B) % chunk if B > chunk else 0
    if pad:
        samples = torch.cat([samples, samples[:1].expand(pad, -1)])
    results = []
    pending = []  # (device block, valid rows, done event)

    def drain():
        y, valid, done = pending.pop(0)
        if done is not None:
            done.synchronize()
        results.append(consumer(y[:valid] if valid < y.shape[0] else y))

    for start in range(0, samples.shape[0], chunk):
        if len(pending) >= depth:
            drain()
        y = fn(samples[start : start + chunk])
        done = None
        if on_cuda:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(device))
        pending.append((y, min(chunk, B - start), done))
        del y
    while pending:
        drain()
    if collect:
        return torch.cat(blocks, dim=0)
    return results


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
        in host memory and returns their concatenation (a CPU tensor).
        ``out_dtype=torch.bfloat16`` narrows the stored fields; compute
        stays float32.  Returns the list of consumer results otherwise."""
        return _stream_pipeline(self._sweep(out_dtype), samples, chunk, depth,
                                consumer, self.device)

    def sensors(self, points):
        """The sensor sweep for a fixed point set: returns
        fn(samples (B, d−1)) → (B, n_pts).  Keyed by the point bytes."""
        from pgdrome_tpu_torch.parallel.vademecum import make_sensor_sweep_fn

        pts = np.asarray(points, dtype=np.float64)
        key = (pts.tobytes(), pts.shape)
        fn = self._sensor_cache.get(key)
        if fn is None:
            fn = make_sensor_sweep_fn(self.spaces, self._modes, self.n_modes,
                                      pts, method=self._method)
            self._sensor_cache[key] = fn
            while len(self._sensor_cache) > self._sensor_cache_max:
                self._sensor_cache.popitem(last=False)
        else:
            self._sensor_cache.move_to_end(key)
        return fn

    def sensors_stream(self, points, samples, consumer=None,
                       chunk=8_388_608, depth=2):
        """Chunked, pipelined sensor sweep — :meth:`fields_stream` for
        :meth:`sensors` (the outputs are small, so the chunks are large)."""
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
