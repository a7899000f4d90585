#!/usr/bin/env python3
"""Where the port's eager analytics loops spend their time, on the card.

    python3 scripts/profile_analytics_torch.py [--steps 200]

Loads the committed rank-640 d=5 vademecum on the CUDA device (f32) and,
under ``torch.profiler`` (CPU and CUDA activities), runs the Gauss–Newton
fit of ``chip_smoke.py``'s ``analytics`` phase (16 sensors, 30 iterations,
8 starts) for 1,024 observations and for one, and ``--steps`` steps of the
64-chain random-walk Metropolis sampler.  For each it prints the wall
seconds (ending in a synchronise), the device time summed over kernels,
the kernel launches, and the ten operators with the most host time.  Exits
non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200, help="sampler steps profiled")
    args = ap.parse_args()
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_analytics_torch: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from pgdrome_tpu_torch.convert import frontier_vademecum
    from pgdrome_tpu_torch.parallel.bayes import make_mcmc_fn

    dev = torch.device("cuda")
    vd = frontier_vademecum(ROOT / "states" / "frontier_d5_state.npz", 5, device=dev)
    pts = np.linspace(0.03, 0.97, 16)
    p_true = np.random.default_rng(20261017).uniform(0.1, 0.9, size=(1024, 5))
    obs = vd.sensors(pts)(p_true).double().cpu().numpy()
    mcmc = make_mcmc_fn(vd.spaces, vd._modes, vd.n_modes, pts, n_steps=args.steps)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    sig = np.full(16, 1e-3 * np.abs(obs[0]).max())
    p0 = np.clip(p_true[0] + 0.01 * np.random.default_rng(1).normal(size=(64, 5)), 0, 1)
    runs = {
        "fit 1024 x 8": lambda: vd.fit_parameters(pts, obs, seed=0, n_iter=30),
        "fit 1 x 8": lambda: vd.fit_parameters(pts, obs[:1], seed=0, n_iter=30),
        f"sampler {args.steps} steps x 64 chains": lambda: mcmc(
            obs[0], sig, p0, np.diag([0.01] * 5), 1.0, generator=gen),
    }
    print(f"card: {torch.cuda.get_device_name(0)}")
    for name, fn in runs.items():
        fn()  # warm-up: builds, caches, allocator
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = prof.key_averages()
        device_us = sum(getattr(e, "self_device_time_total", None)
                        or getattr(e, "self_cuda_time_total", 0) for e in events)
        launches = sum(e.count for e in events if e.key in ("cudaLaunchKernel",
                                                            "cuLaunchKernel",
                                                            "cudaLaunchKernelExC"))
        print(f"{name}: wall {wall:.4f} s, device {device_us / 1e6:.4f} s over kernels, "
              f"{launches} kernel launches ({wall / max(launches, 1) * 1e6:.1f} µs of wall "
              "each)")
        print(events.table(sort_by="self_cpu_time_total", row_limit=10, max_name_column_width=48))
    return 0


if __name__ == "__main__":
    sys.exit(main())
