"""Time the port's sweep wirings, their host/device split and the stream
pipeline's collect path on one NVIDIA GPU, for the copy of the port found
under ``--root`` (so two versions can be compared on one card, in
turns: A, B, B, A).

    python3 scripts/sweep_ab_torch.py --root . --label change --out ab/change.json

Tables and samples are made from a seed at the shapes of ``chip_smoke.py``'s
wirings (the committed d=5 and d=10 vademecums, the dual factors, the
elasticity flagship, its strain, the 3D vademecum, the small trained
results); the times do not depend on the values.  Each wiring's device time
is the mean of CUDA-event-timed launches after a warm-up.  The small-batch
wirings also get a ``torch.profiler`` split (CPU + CUDA activities): host
time a call (the enqueue, no synchronise), wall time a call (synchronised),
the device's busy time a call and its idle share.  So does the f64 sum of
the d=10 field GEMM's six k-chunk partials (1,024 × 2049), on seeded
partials.  The stream section runs
``serving._stream_pipeline`` as ``sensors_stream`` (4,194,304 samples in
chunks of 524,288, 8 points, the collect path) and ``fields_stream`` (a consumer, 4 chunks of
524,288 less 4,321) run it, timed on the host clock, three calls each, and
prints the host operations that took the most time in one profiled call.
Needs CUDA; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=".", help="the tree whose pgdrome_tpu_torch is timed")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--out", default=None, help="JSON file for the results")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--served", default=None,
                    help="also serve the committed d=5 and d=10 states (this states "
                         "directory) at their inset corners: the f32 fields go to .npy files "
                         "beside --out, and the d=5 FEM max is printed")
    args = ap.parse_args()
    # chip_smoke.py's timing helpers from this checkout; the port from --root
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        sys.exit(2)
    from chip_smoke import cuda_ms, host_split, stream_split
    from pgdrome_tpu_torch import serving
    from pgdrome_tpu_torch.ops import fused_sweep as fs

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"[{args.label}] {fs.__file__} on {card}", flush=True)
    t0 = time.perf_counter()
    info = fs.build()
    print(f"[{args.label}] nvcc {info.seconds:.1f} s ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    res = {"label": args.label, "card": card, "wirings": {}, "stream": {}}

    def sweep(NP, ndofp, K, n0, out_dtype=None):
        grid = torch.tensor([[0.0] * NP, [float(ndofp - 1)] * NP, [float(ndofp - 1)] * NP,
                             [1.0] * NP], device=dev)
        tabs = torch.randn((NP, ndofp, K), generator=gen, device=dev) * 0.5 + 1.0
        m0 = None if n0 == 0 else torch.randn((K, n0), generator=gen, device=dev)
        return fs.FusedSweep(grid, tabs, m0, K, out_dtype)

    def samples(B, NP):
        return torch.rand((B, NP), generator=gen, device=dev)

    def stages(sw, s, n0):
        B, K = s.shape[0], int(sw.tabs.shape[2])
        chunks = fs.row_chunks(B, K, n0)
        hi = torch.empty((chunks[0][1], fs.padded_k(K)), device=dev)
        lo = torch.empty_like(hi)
        dst = torch.empty((B, n0), device=dev)
        gkw = {"maps": sw.gemm_maps()} if hasattr(sw, "gemm_maps") else {}

        def st1():
            for r0, r1 in chunks:
                fs.factors_stage(s[r0:r1], sw.grid, sw.tabs, sw.n_modes, hi[: r1 - r0],
                                 lo[: r1 - r0], plan=sw.plan, sliced=sw.sliced)

        def st2():
            for r0, r1 in chunks:
                fs.gemm_stage(hi[: r1 - r0], lo[: r1 - r0], *sw.table, dst[r0:r1], **gkw)

        return {"factor_ms": cuda_ms(st1, 5), "gemm_ms": cuda_ms(st2, 5)}

    # name: (NP, ndofp, K, n0, B, timed reps, small batch)
    wirings = {
        "d5 fields f32": (5, 129, 640, 2049, 524_288, 3, False),
        "d5 sensors": (5, 129, 640, 8, 4_194_304, 3, False),
        "d5 factors": (5, 129, 640, 0, 4_194_304, 3, False),
        "slice fields (NP=3)": (3, 129, 640, 2049, 524_288, 3, False),
        "derivative fields (n0=2048)": (5, 129, 640, 2048, 524_288, 3, False),
        "d10 fields": (10, 129, 2717, 2049, 1024, 20, True),
        "d10 sensors": (10, 129, 2717, 8, 1024, 20, True),
        "dual primal factors": (10, 129, 2688, 0, 1360, 20, True),
        "dual dual factors": (10, 129, 384, 0, 1360, 20, True),
        "dual rate factors": (10, 129, 2688, 0, 65_536, 10, False),
        "sensors, 64 rows (a chain batch)": (5, 129, 640, 8, 64, 50, True),
        "flagship batch": (3, 17, 32, 2426, 262_144, 10, False),
        "flagship strain": (3, 17, 32, 5184, 65_536, 10, False),
        "3D fields": (2, 25, 30, 4913, 65_536, 10, False),
        "frontier fields": (5, 129, 128, 2049, 160, 50, True),
        "nonlinear fields": (2, 65, 145, 2049, 76, 50, True),
        "transient fields": (3, 49, 160, 24_929, 40, 50, True),
    }
    for name, (NP, ndofp, K, n0, B, reps, small) in wirings.items():
        sw = sweep(NP, ndofp, K, n0)
        s = samples(B, NP)
        row = {"shape": [NP, ndofp, K, n0, B], "ms": cuda_ms(lambda: sw(s), reps)}
        if n0 > 0:
            F = fs.FusedSweep(sw.grid, sw.tabs, None, K)(s)
            row["library_ms"] = cuda_ms(lambda: torch.matmul(F, sw.m0), reps)
            del F
        if n0 > fs.SENSORS_MAX:
            row.update(stages(sw, s, n0))
        if small:
            row.update(host_split(lambda: sw(s)))
        if getattr(sw, "last_plan", None) is not None:
            row["launched"] = sw.last_plan
        res["wirings"][name] = row
        print(f"[{args.label}] {name}: {json.dumps(row)}", flush=True)
        del sw, s
        torch.cuda.empty_cache()

    part = torch.rand((6, 1024, 2049), generator=gen, device=dev)
    out_p = torch.empty((1024, 2049), device=dev)
    row = {"ms": cuda_ms(lambda: fs.partial_sum(part, out_p), 20),
           **host_split(lambda: fs.partial_sum(part, out_p))}
    res["wirings"]["partial sum, 6 x 1024 x 2049"] = row
    print(f"[{args.label}] partial sum: {json.dumps(row)}", flush=True)
    del part, out_p

    # ---------------------------------------------------------- the streams
    sw_s = sweep(5, 129, 640, 8)
    s_big = samples(4_194_304, 5)
    t = time.perf_counter()
    one = sw_s(s_big)
    torch.cuda.synchronize()
    first_one_shot = time.perf_counter() - t
    one_shot = []
    for _ in range(3):
        t = time.perf_counter()
        one = sw_s(s_big)
        torch.cuda.synchronize()
        one_shot.append(4_194_304 / (time.perf_counter() - t))
    stream = []
    for _ in range(3):
        t = time.perf_counter()
        got = serving._stream_pipeline(sw_s, s_big, 524_288, 2, None, dev)
        stream.append(4_194_304 / (time.perf_counter() - t))
        assert torch.equal(got, one.cpu()) and not got.is_cuda
        del got
    res["stream"]["sensors"] = {
        "one_shot_first_s": first_one_shot, "one_shot_per_s": one_shot, "stream_per_s": stream,
        **stream_split(lambda: serving._stream_pipeline(sw_s, s_big, 524_288, 2, None, dev))}
    print(f"[{args.label}] stream sensors: {json.dumps(res['stream']['sensors'])}", flush=True)
    del one, s_big, sw_s
    torch.cuda.empty_cache()

    sw_f = sweep(5, 129, 640, 2049)
    B_stream = 4 * 524_288 - 4321
    s_stream = samples(B_stream, 5)
    kept = []

    def keep_ends(y):
        kept.append(y.shape[0])

    rates = []
    for _ in range(3):
        t = time.perf_counter()
        serving._stream_pipeline(sw_f, s_stream, 524_288, 2, keep_ends, dev)
        torch.cuda.synchronize()
        rates.append(B_stream / (time.perf_counter() - t))
    res["stream"]["fields"] = {"stream_per_s": rates, **stream_split(
        lambda: serving._stream_pipeline(sw_f, s_stream, 524_288, 2, keep_ends, dev))}
    print(f"[{args.label}] stream fields: {json.dumps(res['stream']['fields'])}", flush=True)
    if args.served:
        import numpy as np

        from pgdrome_tpu_torch.convert import frontier_vademecum
        from pgdrome_tpu_torch.models.problems import box_corners, elliptic_fem_solver

        for d, name in ((5, "frontier_d5_state.npz"), (10, "frontier_anova_d10_state.npz")):
            vd = frontier_vademecum(Path(args.served) / name, d, device=dev)
            grid_p = vd.spaces[1].tabulate_dof_coordinates()[:, 0]
            corners = box_corners(grid_p[1], grid_p[-2], d)
            served = vd.fields(corners).cpu().numpy()
            np.save(Path(args.out).with_name(f"{Path(args.out).stem}_d{d}.npy"), served)
            if d == 5:
                fem = elliptic_fem_solver(vd.spaces[0], d)
                rel = max(float(np.linalg.norm(x - u) / np.linalg.norm(u))
                          for x, u in zip(served.astype(np.float64), (fem(p) for p in corners)))
                res["served_d5_fem_max"] = rel
                print(f"[{args.label}] served d=5 fields vs FEM at the 32 inset corners: "
                      f"max rel-L2 {rel:.6e}", flush=True)
            del vd
            torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
