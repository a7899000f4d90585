#!/usr/bin/env python3
"""Train the nonlinear vademecum of ``NONLINEAR.json`` with the PyTorch/CUDA
port alone (``pgdrome_tpu_torch.recipes.nonlinear_vademecum``), verify it
against the banded-Newton truth and write its report and state.

    python3 run_nonlinear_torch.py --out DIR [--n-x 1024 --n-p 64]

The problem is ``nonlinear_elliptic(n_x=1024, n_p=64, 2 params)`` at ε = 2,
solved by outer Picard of f32 residual cascades of 64 + 48 + 48 modes
(rhs stacks bucketed to 512 rows, dd stacks from the third outer
iteration), and verified by ``nonlinear_dense_verifier`` (the 4 inset
corners and, for each of 3 seeds, 16 random and 8 edge points).

It runs on the CUDA device (``--device cpu`` for a CPU run, f32 as on the
card).  It writes under ``--out`` (made if missing): ``artifact.json`` (the
recipe's report, the verified maxima, the served fields' error against the
truth and the state's conditioning) and ``state.npz`` (the trained result:
``m0`` in the dim-0 preconditioned basis, ``m1``, ``m2``, as
``convert.load_state_npz`` reads it).  ``tests/test_torch_nonlinear.py
--state DIR/state.npz`` serves that state through the JAX package's f32
paths on a CPU.  It prints the card's name and power limit beside the
result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def log(*a):
    print(*a, flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True, help="directory for the outputs")
    ap.add_argument("--n-x", type=int, default=1024)
    ap.add_argument("--n-p", type=int, default=64)
    ap.add_argument("--eps", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    from pgdrome_tpu_torch.models.problems import nonlinear_dense_verifier, nonlinear_elliptic
    from pgdrome_tpu_torch.recipes import nonlinear_vademecum, state_conditioning
    from pgdrome_tpu_torch.separated import host_f64
    from pgdrome_tpu_torch.serving import Vademecum

    device = torch.device(args.device)
    card = "cpu"
    if device.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]
    log(f"device: {card}; torch {torch.__version__}, cuda {torch.version.cuda}")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    sep, Vs, ml = nonlinear_elliptic(n_x=args.n_x, n_p=args.n_p, num_params=2)
    t0 = time.perf_counter()
    res, tf, report = nonlinear_vademecum(sep, Vs, ml, args.eps, budgets=(64, 48, 48),
                                          rhs_bucket=512, dtype=np.float32, log=log,
                                          device=device)
    report["solve_s"] = round(time.perf_counter() - t0, 1)
    t0 = time.perf_counter()
    ver = nonlinear_dense_verifier(Vs, args.eps, ml, tf, n_random=16, seeds=(7, 101, 1234),
                                   n_edge=8)
    report["verified"] = ver(res)
    report["verify_s"] = round(time.perf_counter() - t0, 1)
    pts = np.concatenate(list(ver.samples.values()))
    served = Vademecum(Vs, res, dim0_transform=tf, device=device).fields(pts)
    truth = np.stack([ver.truth(p) for p in pts])
    report["served_f32_max"] = float(
        (np.linalg.norm(host_f64(served) - truth, axis=1) / np.linalg.norm(truth, axis=1)).max())
    report["conditioning"] = state_conditioning(res, Vs, tf, pts)
    report["device"] = card
    K = res.n_modes
    np.savez(out / "state.npz", **{f"m{d}": host_f64(m)[:K].astype(np.float32)
                                   for d, m in enumerate(res.modes)},
             n_modes=K, amplitudes=np.asarray(res.amplitudes), alpha=np.asarray(res.alpha),
             fp_its=np.asarray(res.fp_its), normU0=res.normU0)
    (out / "artifact.json").write_text(json.dumps(report, indent=1))
    v = report["verified"]
    log(f"nonlinear: stop {report['stop']!r} after {report['outer_iterations']} outer "
        f"iterations, rank {K}, {report['solve_s']} s; verified max {v['max']:.6e} (corners "
        f"{v['corners']:.6e}, interior {v['interior']:.6e}); served f32 "
        f"{report['served_f32_max']:.6e}; conditioning {json.dumps(report['conditioning'])}; "
        f"on {card}")
    return 0 if v["max"] < 1e-6 else 1


if __name__ == "__main__":
    sys.exit(main())
