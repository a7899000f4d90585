"""Per-enrichment metrics (counterpart of
``pgdrome_tpu/utils/profiling.py::EnrichmentMetrics``) and, for the
port's cascades, a per-stage time split (:class:`StageMetrics`).

PyTorch returns before the device finishes, so on a CUDA device each
step's wall time ends at a device synchronise: it is the time of the work,
not of its enqueue."""

from __future__ import annotations

import contextlib
import time

import torch


class EnrichmentMetrics:
    """Structured per-enrichment metrics collector::

        m = EnrichmentMetrics(device)
        with m.step():
            ...one enrichment...
        m.record(mode=k, amplitude=a, fp_its=n)
        m.summary()
    """

    def __init__(self, device="cpu"):
        self.device = torch.device(device)
        self.rows = []
        self._last_dt = None

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._last_dt = time.perf_counter() - t0

    def record(self, **kw):
        kw.setdefault("wall_s", self._last_dt)
        self.rows.append(kw)

    def summary(self) -> dict:
        if not self.rows:
            return {}
        total = sum(r["wall_s"] or 0.0 for r in self.rows)
        return {
            "enrichments": len(self.rows),
            "total_wall_s": total,
            "modes_per_s": len(self.rows) / total if total else None,
            "mean_fp_its": (
                sum(r.get("fp_its", 0) for r in self.rows) / len(self.rows)
            ),
            "final_amplitude": self.rows[-1].get("amplitude"),
        }


class StageMetrics:
    """Per-stage time split of a residual cascade
    (``recipes.adaptive_cascade(metrics=...)``)::

        m = StageMetrics(device)
        row = m.stage(si)
        with m.timed(row, "solve_s"):
            ...
        m.rows  # [{"stage": 1, "solve_s": ..., "fp_its": [...]}, ...]

    Each timed part ends at a device synchronise on a CUDA device, so it
    is the time of the work, not of its enqueue."""

    def __init__(self, device="cpu"):
        self.device = torch.device(device)
        self.rows = []

    def stage(self, si) -> dict:
        self.rows.append({"stage": si})
        return self.rows[-1]

    @contextlib.contextmanager
    def timed(self, row, key):
        t0 = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        row[key] = time.perf_counter() - t0
