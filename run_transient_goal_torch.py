#!/usr/bin/env python3
"""Certify the transient conductivity family's point outputs with the
PyTorch/CUDA port alone (``pgdrome_tpu_torch.recipes.transient_goal_oriented``
at ``TRANSIENT_GOAL.json``'s widths and depth) and write its report.

    python3 run_transient_goal_torch.py --out DIR [--x0 0.5 ...]

The primal is ``two_stage_minres(96, 64)`` of
``transient_parametric_conductivity(n_x=256, n_t=96, n_p=48, 3 params)`` in
f32 on the card; the truth is the exact space-time FOM at the 40 points of
``transient_verification_set``; per sensor (x0, final time) an adjoint
minres cascade of 48-mode stages (at most 6) runs until the corrected
outputs are within ``--bound`` (1e-6) of the FOM's, relative to the
outputs' scale.  It exits 1 when a sensor misses the bound.

It runs on the CUDA device (``--device cpu`` with ``--n-x``/``--n-t``/``--n-p``
cut down for a rehearsal).  It writes ``artifact.json`` (the recipe's
report: primal rank and field error, per sensor the dual rank, the best and
last corrected errors and each stage's rank, error and seconds) under
``--out`` (made if missing) and prints the card's name and power limit
beside the result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def log(*a):
    print(*a, flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True, help="directory for the outputs")
    ap.add_argument("--x0", type=float, nargs="+", default=[0.5], help="sensor positions")
    ap.add_argument("--bound", type=float, default=1e-6)
    ap.add_argument("--n-x", type=int, default=256)
    ap.add_argument("--n-t", type=int, default=96)
    ap.add_argument("--n-p", type=int, default=48)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    from pgdrome_tpu_torch.recipes import transient_goal_oriented

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
    _, report = transient_goal_oriented(
        args.x0, n_x=args.n_x, n_t=args.n_t, n_p=args.n_p, num_params=3, bound=args.bound,
        primal_stages=(96, 64), dual_stage1=48, dual_budget=48, max_dual_stages=6,
        n_random=16, seeds=(7, 101), tol_fp=1e-7, max_fp_it=50, dtype=np.float32, log=log,
        artifact_path=str(out / "artifact.json"), device=device)
    for s in report["sensors"]:
        log(f"x0 = {s['x0']}: dual rank {s['dual_rank']}, corrected best "
            f"{s['corrected_best']:.6e}, last {s['corrected_last']:.6e}; stages "
            + "; ".join(f"{h['stage']}: rank {h['rank']} max {h['max']:.3e} ({h['stage_s']} s)"
                        for h in s["history"]) + f"; {s['wall_s']} s")
    log(f"primal rank {report['primal_rank']}, field rel max "
        f"{report['primal_field_rel_max']:.6e}; max corrected {report['max_corrected']:.6e} "
        f"(bound {args.bound:g}); {report['wall_s']} s on {card}")
    return 0 if report["max_corrected"] < args.bound else 1


if __name__ == "__main__":
    sys.exit(main())
