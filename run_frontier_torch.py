#!/usr/bin/env python3
"""Train the d=5 frontier vademecum with the PyTorch/CUDA port alone
(``pgdrome_tpu_torch.recipes.highd_frontier(5)`` to its 1e-6 bound) and
write its verified artifact.

    python3 run_frontier_torch.py --out DIR [--minutes 40] [--resume]
        [--anova 2 --budget 96] [--max-stages N]

``--anova 2`` starts from the anchored-ANOVA surrogate (mean, axes and
pairs; ``pgdrome_tpu_torch/anova.py``), as ``scripts/run_frontier.py
--anova`` does for the JAX package; ``--budget`` sets the modes a stage
(128 by default; the JAX package's ANOVA d=5 record ran 96);
``--max-stages`` ends the run after that many stages, bound met or not.

It runs on the CUDA device (``--device cpu`` with ``--n-x``/``--n-p`` cut
down for a rehearsal).  It writes, under ``--out`` (made if missing):
``artifact.json`` (the report of ``highd_frontier``: verified maxima,
rank, per-stage history, wall time; a resumed leg extends it),
``state.npz`` (the raw combination after the last stage, the resume
point) and ``stages.json`` (each stage's residual-build, solve, Galerkin
and verification seconds and fp sweeps).
``--resume`` continues from ``state.npz`` when it exists.  It prints the
card's name and power limit beside the result.
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
    ap.add_argument("--minutes", type=float, default=None)
    ap.add_argument("--n-x", type=int, default=1024)
    ap.add_argument("--n-p", type=int, default=128)
    ap.add_argument("--out", required=True, help="directory for the outputs")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--anova", type=int, default=0,
                    help="anchored-ANOVA start order (0 = off, 2 = mean + axes + pairs)")
    ap.add_argument("--budget", type=int, default=128, help="modes a stage")
    ap.add_argument("--max-stages", type=int, default=24, help="stages at most")
    args = ap.parse_args()

    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    from pgdrome_tpu_torch.convert import load_state_npz
    from pgdrome_tpu_torch.recipes import highd_frontier
    from pgdrome_tpu_torch.utils.profiling import StageMetrics

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
    state, artifact = out / "state.npz", out / "artifact.json"
    init = None
    if args.resume and state.exists():
        init = load_state_npz(state)
        log(f"resumed rank {init.n_modes} from {state}")

    metrics = StageMetrics(device)
    t0 = time.perf_counter()
    best, report = highd_frontier(
        5, n_x=args.n_x, n_p=args.n_p, minutes=args.minutes,
        stage_budget=args.budget, anova_order=args.anova, max_stages=args.max_stages,
        state_path=str(state), init_result=init, artifact_path=str(artifact),
        log=log, metrics=metrics, device=device,
    )
    wall = time.perf_counter() - t0
    stages = [{k: (np.asarray(v).tolist() if k == "fp_its" else v) for k, v in row.items()}
              for row in metrics.rows]
    (out / "stages.json").write_text(json.dumps(stages, indent=1))
    log(json.dumps({"device": card, "rank": report["rank"],
                    "verified_max": report["verified"]["max"],
                    "stages": len(report["history"]), "legs": report["legs"],
                    "leg_wall_s": round(wall, 1), "wall_s": report["wall_s"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
