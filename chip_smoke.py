#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (``pgdrome_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

It builds the sweep's kernels (the factor kernel, with its fused narrow
product, and the tensor-core GEMM) from ``pgdrome_tpu_torch/csrc`` with nvcc,
loads the committed rank-640 d=5 vademecum (``states/frontier_d5_state.npz``)
onto the card at full width, and serves it through the port's entry points:
fields (f32, streamed, bf16 store), sensors and Monte-Carlo moments, and
takes one moment call apart on the device and host clocks.  It then holds
every kernel wiring against the plain PyTorch version on the same inputs
(the factors bit for bit), the served fields against per-sample FEM at
the 32 inset parameter-box corners.  Last, phase ``train`` trains the bench
vademecum with the port alone (``bench.py:806-881`` at its own widths: a
64-mode f32 greedy stage on the card, two f64 residual restarts of 48
modes, compression to rank 50 and a Galerkin update on the host), holds
it under 1e-6 against per-sample FEM over 8 corners + 3 × (64 random +
16 edge) samples, and serves those samples through the field kernels.
Phase ``frontier`` trains the d=5 vademecum with the port's
``highd_frontier(5)`` at full width (2047 × 129^5, T = 6), cut to 3 of its
stages: a plain f32 stage, a boosted, corner-seeded stage with the
compensated dd rhs, a dd stage.  It checks each stage's flags and its
verified error against the JAX record (``FRONTIER_d5.json``), holds the dd
contraction on the card against the CPU bit for bit, reloads the
checkpoint exactly, and serves the result through the field kernels.  It
prints the measurements: one line per phase, a ``{"kernels": [...]}`` line
and, last, ``{"ok": true, "device": {...}}``.

Any failed check raises (non-zero exit, no result line); a watchdog turns a
hang into a traceback and a non-zero exit.  Without a CUDA device, or run
outside a checkout of the repository, it exits non-zero at once.
"""

from __future__ import annotations

import faulthandler
import json
import re
import subprocess
import sys
import time
from pathlib import Path

WATCHDOG_S = 1000  # the whole run, build included; targets are far below
ROOT = Path(__file__).resolve().parent
STATE = ROOT / "states" / "frontier_d5_state.npz"
NUM_PARAMS = 5
SEED = 20261017
B_FIELDS = 524_288           # one field chunk (4.3 GB of f32 output)
B_BIG = 4 * 1_048_576        # sensor / moment batches
N_STREAM_CHUNKS = 4
N_PTS = 8
U32 = 2.0 ** -24             # unit roundoff of float32
FEM_BOUND = 1e-6             # served fields vs FEM at the inset corners
F64_BOUND = 7.0e-7           # plain f64 reconstruction there (6.93e-7 measured on a CPU)
BF16_REL = 1.6e-2            # bf16 store vs f32, relative to max |f32|
# moments: the kernel and plain paths share every reduction (f32 GEMMs over
# 1M-sample chunks, f64 across chunks) and differ only in the rounding of
# each f32 factor.  The variance is E[u²] − mean² in both, which cancels
# about three digits here (E[u²] / var ≈ 1500), so its gap is held against
# the scale of E[u²], not of var.  Both limits are about ten times the gaps
# measured on an H100 (1.0e-8 and 1.5e-8); no bound is derived for the
# library's reduction order.
MEAN_REL = 1e-6              # |Δmean| ≤ MEAN_REL · max|mean|
VAR_REL = 1e-5               # |Δvar| ≤ VAR_REL · max(var + mean²)
MOMENT_REPS = 5              # timed passes of the moment split
# the train phase: the bench vademecum of bench.py:806-881 at its own widths
TRAIN_BUILD = dict(n_x=1024, n_p=128, num_params=3, degree_x=2, boundary_boost=(16.0, 6))
TRAIN_BUDGETS = (64, 48, 48)  # stage 1, then two f64 residual restarts
TRAIN_DEPLOY = 50            # compressed rank
RHS_BUCKET = 512             # the restarts' rhs stacks, padded as bench.py pads them
VERIFY = dict(n_random=64, seeds=(7, 101, 1234), n_edge=16)  # bench.py:215-272's set
REF_FEM = 7.882e-7           # the JAX reference's max on that set (BENCH_r05.json, a TPU run)
# the frontier phase: highd_frontier(5) at full width, cut to 3 of its stages
FRONTIER = dict(max_stages=3, base_boost=(8.0, 6), window_boost=(16.0, 6))
# the JAX record (FRONTIER_d5.json, a TPU run): verified max and the stage
# flags (boosted, seeded, rhs_comp) at ranks 128, 256, 384
FRONTIER_REF = {128: 4.465731509726485e-05, 256: 7.022583271541588e-06,
                384: 3.7580391580915298e-06}
FRONTIER_FLAGS = [(False, False, False), (True, True, True), (False, False, True)]
# served f32 fields vs the f64 reconstruction's verified max: the d=5 state
# served at K = 640 sits 1.3e-7 (19 %) above its f64 reconstruction at the
# corners (PERF.md §6.1); at rank 384 and ~4e-6 that is a few per cent
FRONTIER_SERVE_SLACK = 1.1

# published dense peaks (NVIDIA data sheets, without sparsity):
# (f32 CUDA-core FLOP/s, TF32 tensor-core FLOP/s, HBM B/s)
PEAKS = {"PCIe": (51e12, 378e12, 2.0e12), "NVL": (60e12, 417.5e12, 3.9e12),
         "SXM": (67e12, 495e12, 3.35e12)}


def say(*args):
    print(*args, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


class Phase:
    """Times a phase (ends with a device synchronise) and prints it."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch

        if exc[0] is None:
            torch.cuda.synchronize()
        self.seconds = time.perf_counter() - self.t0
        say(f"phase {self.name}: {self.seconds:.3f} s"
            + ("" if exc[0] is None else " (failed)"))
        return False


def cuda_ms(fn, reps):
    """Mean device time of ``fn()`` over ``reps`` runs after one warm-up."""
    import torch

    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def nvidia_smi_line():
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def clocks():
    """SM clock, power draw and temperature now (a timing's conditions)."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def make_samples(torch, B, gen, device):
    """B uniform samples on [0, 1]^NP, with rows pinned at exactly 0 and 1
    per dim and in all dims (the right end must land in the last cell with
    ξ = 1, pgdrome_tpu/ops/pallas_kernels.py:120-122) and at grid nodes."""
    s = torch.rand((B, NUM_PARAMS), generator=gen, device=device)
    s[0] = 0.0
    s[1] = 1.0
    for j in range(NUM_PARAMS):
        s[2 + j, j] = 0.0
        s[2 + NUM_PARAMS + j, j] = 1.0
        s[2 + 2 * NUM_PARAMS + j, j] = 64.0 / 128.0
    return s


def moment_split(torch, fs, vd, samples):
    """One ``vd.moments(samples)`` call taken apart (serving.py
    ``factor_moments`` and ``moments``, one chunk): building the moment
    function (its first call) on the host clock; the factor kernel,
    ``fac * w``, ``fac.sum(0)`` and ``fac.T @ fac`` on CUDA events (the
    last pass); and on the host clock, over ``MOMENT_REPS`` passes after
    one warm-up, the device work waited for, the copies to the host (f64
    cast included), the host f64 finish and the whole pass, each pass
    followed by a whole warm ``vd.moments`` call so both see the same
    host.  Host times as median, min and max, in ms."""
    from pgdrome_tpu_torch.parallel.vademecum import make_factor_moments_fn

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    make_factor_moments_fn(vd.spaces, vd._modes, vd.n_modes, method=vd._method)
    torch.cuda.synchronize()
    split = {"build_host_ms": (time.perf_counter() - t0) * 1e3,
             "host_threads": torch.get_num_threads(), "reps": MOMENT_REPS}
    sweep = fs.make_fused_sweep(vd.spaces, [None] + list(vd._modes[1:]), vd.n_modes)
    B = int(samples.shape[0])
    parts = ("factor_kernel", "fac_times_w", "fac_sum", "fac_gram")
    host = {k: [] for k in ("device_host", "copies_host", "host_finish", "pass_host",
                            "whole_call_host")}
    for rep in range(MOMENT_REPS + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(parts) + 1)]
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        ev[0].record()
        w = (torch.arange(B, device=samples.device) < B).to(torch.float32)
        fac = sweep(samples)
        ev[1].record()
        fac = fac * w[:, None]
        ev[2].record()
        y1 = fac.sum(0)
        ev[3].record()
        y2 = fac.T @ fac
        ev[4].record()
        torch.cuda.synchronize()
        h1 = time.perf_counter()
        s1, s2 = y1.double().cpu() / B, y2.double().cpu() / B
        h2 = time.perf_counter()
        M0 = vd._modes[0].detach().cpu().double()
        mean = s1 @ M0
        cov = s2 - torch.outer(s1, s1)
        var = torch.clamp(torch.einsum("ki,ki->i", cov @ M0, M0), min=0.0)
        h3 = time.perf_counter()
        del fac, w, y2, mean, var
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vd.moments(samples)
        h4 = time.perf_counter()
        if rep == 0:
            continue
        for key, ms in (("device_host", h1 - h0), ("copies_host", h2 - h1),
                        ("host_finish", h3 - h2), ("pass_host", h3 - h0),
                        ("whole_call_host", h4 - t0)):
            host[key].append(ms * 1e3)
    for i, name in enumerate(parts):
        split[f"{name}_ms"] = ev[i].elapsed_time(ev[i + 1])
    for key, v in host.items():
        v = sorted(v)
        split[f"{key}_ms"] = {"median": v[len(v) // 2], "min": v[0], "max": v[-1]}
    return split


def main() -> int:
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "pgdrome_tpu_torch" / "csrc" / "fused_sweep.cu").is_file() or not STATE.is_file():
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    t_start = time.perf_counter()
    dev = torch.device("cuda")

    # ------------------------------------------------------------- device
    with Phase("device"):
        card = nvidia_smi_line()
        name = torch.cuda.get_device_name(0)
        say(f"card: {card}")
        say(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
            f"cuda {torch.version.cuda}, devices {torch.cuda.device_count()}")
        kind = next((k for k in ("PCIe", "NVL") if k in name), "SXM")
        peak_flops, peak_tf32, peak_bw = PEAKS[kind]
        say(f"peaks for the roofline ({kind} data sheet): "
            f"{peak_flops / 1e12:g} TFLOP/s f32, {peak_tf32 / 1e12:g} TFLOP/s tf32 "
            f"tensor, {peak_bw / 1e12:g} TB/s")

    from pgdrome_tpu_torch.ops import fused_sweep as fs

    # -------------------------------------------------------------- build
    with Phase("build"):
        info = fs.build(force=True)
        say("nvcc: " + " ".join(info.command))
        say(f"nvcc seconds: {info.seconds:.2f}")
        kernel_name = "?"
        for line in info.log.splitlines():
            if "Compiling entry function" in line:
                mangled = line.split("'")[1]
                factors = re.search(r"sweep_factors_kernelILi(\d+)ELi(\d)ELb(\d)E", mangled)
                if factors:
                    ks, mode, staged = factors.groups()
                    kernel_name = (f"sweep_factors_kernel<ks={ks}, "
                                   f"{('F', 'split', 'narrow')[int(mode)]}, "
                                   f"{'staged' if staged == '1' else 'global'}>")
                else:
                    kernel_name = "sweep_gemm_kernel<" + (
                        "bf16>" if "bfloat16" in mangled else "f32>")
            elif "registers" in line or "spill" in line:
                say(f"  ptxas {kernel_name}: {line.strip().removeprefix('ptxas info    : ')}")
        lib = fs._library()
        say(f"  sweep_gemm_kernel: {lib.pgd_sweep_gemm_smem()} bytes of dynamic shared memory")

    from pgdrome_tpu_torch.convert import frontier_vademecum
    from pgdrome_tpu_torch.models.problems import box_corners, elliptic_fem_solver
    from pgdrome_tpu_torch.serving import Vademecum

    # --------------------------------------------------------------- load
    with Phase("load"):
        vd = frontier_vademecum(STATE, NUM_PARAMS)  # device cuda, method auto
        K, n0 = (int(x) for x in vd._modes[0].shape)
        say(f"vademecum: rank {vd.n_modes}, K={K}, n0={n0}, "
            f"param dofs {[int(m.shape[1]) for m in vd._modes[1:]]}")
        check(vd.n_modes == 640 and n0 == 2049, "d=5 state shape")
        fused = vd._sweep()
        check(isinstance(fused, fs.FusedSweep), "method='auto' took the kernel")

    # ---------------------------------------------------------- FEM truth
    with Phase("fem_truth"):
        grid_p = vd.spaces[1].tabulate_dof_coordinates()[:, 0]
        corners = box_corners(grid_p[1], grid_p[-2], NUM_PARAMS)
        fem = elliptic_fem_solver(vd.spaces[0], NUM_PARAMS)
        u_fem = [fem(p) for p in corners]
        served = vd.fields(corners).double().cpu().numpy()
        vd64 = frontier_vademecum(STATE, NUM_PARAMS, dtype=torch.float64, method="torch")
        plain64 = vd64.fields(corners).cpu().numpy()
        del vd64

        def rel(a, u):
            return max(float(((x - y) ** 2).sum() ** 0.5 / (y ** 2).sum() ** 0.5)
                       for x, y in zip(a, u))

        e_kernel, e_f64 = rel(served, u_fem), rel(plain64, u_fem)
        # the state is verified at the inset corners; at the box faces it is
        # far off by its training, not by serving — printed, not a gate
        faces = box_corners(0.0, 1.0, NUM_PARAMS)
        e_faces = rel(vd.fields(faces).double().cpu().numpy(), [fem(p) for p in faces])
        say(f"fem: kernel f32 max rel-L2 at the box faces p in {{0, 1}}: {e_faces:.6e}")
        say(f"fem: kernel f32 max rel-L2 {e_kernel:.6e} (bound {FEM_BOUND:g}), "
            f"plain f64 {e_f64:.6e} (bound {F64_BOUND:g}) over {len(corners)} corners")
        check(e_kernel < FEM_BOUND, "kernel-served fields vs FEM")
        check(e_f64 <= F64_BOUND, "plain f64 reconstruction vs FEM")

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    s_fields = make_samples(torch, B_FIELDS, gen, dev)
    B_stream = N_STREAM_CHUNKS * B_FIELDS - 4321  # ragged tail
    s_stream = make_samples(torch, B_stream, gen, dev)
    s_big = make_samples(torch, B_BIG, gen, dev)
    pts = [0.05 + 0.9 * i / (N_PTS - 1) for i in range(N_PTS)]
    n_chunks = -(-B_stream // B_FIELDS)
    rates = {}

    # --------------------------------------------- serve: the main path
    with Phase("serve"):
        torch.cuda.synchronize()
        fs.reset_launch_counts()

        t0 = time.perf_counter()
        out = vd.fields(s_fields)
        torch.cuda.synchronize()
        rates["fields/s one-shot"] = B_FIELDS / (time.perf_counter() - t0)

        kept = {}

        def keep_ends(y):
            i = len(kept.setdefault("seen", []))
            kept["seen"].append(y.shape[0])
            if i in (0, n_chunks - 1):
                kept[i] = y.clone()

        t0 = time.perf_counter()
        vd.fields_stream(s_stream, consumer=keep_ends, chunk=B_FIELDS, depth=2)
        torch.cuda.synchronize()
        rates["fields/s stream f32"] = B_stream / (time.perf_counter() - t0)

        bf16_blocks = []
        t0 = time.perf_counter()
        vd.fields_stream(s_fields, consumer=lambda y: bf16_blocks.append(y.clone()),
                         chunk=B_FIELDS, depth=2, out_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        rates["fields/s stream bf16"] = B_FIELDS / (time.perf_counter() - t0)

        t0 = time.perf_counter()
        resp = vd.sensors(pts)(s_big)
        torch.cuda.synchronize()
        rates["sensor samples/s one-shot"] = B_BIG / (time.perf_counter() - t0)
        t0 = time.perf_counter()
        resp_stream = vd.sensors_stream(pts, s_big)
        rates["sensor samples/s stream"] = B_BIG / (time.perf_counter() - t0)

        t0 = time.perf_counter()
        mean, var = vd.moments(s_big)
        rates["moment samples/s"] = B_BIG / (time.perf_counter() - t0)
        torch.cuda.synchronize()
        launches = dict(fs.LAUNCHES)
        stage_launches = dict(fs.STAGE_LAUNCHES)
        say(f"launches on the main path: {json.dumps(launches)}")
        say(f"kernel launches on the main path: {json.dumps(stage_launches)}")
        for k, v in rates.items():
            say(f"rate {k}: {v:.6g}")
        say(f"rate sensor responses/s (samples x {N_PTS} points): "
            f"{rates['sensor samples/s one-shot'] * N_PTS:.6g}")
        check(all(v > 0 for v in launches.values()), "every wiring launched on the main path")
        # each field call walks its batch in the wrapper's row chunks and
        # launches the factor kernel and the GEMM once per chunk (the streams
        # pad every dispatch to a full chunk); each sensor call is one launch
        # of the fused narrow product; the factor wiring one of the factor
        # kernel; no table here is wide enough for the global route
        calls = [B_FIELDS] * (1 + len(kept["seen"]) + 1)
        expected_gemm = sum(len(fs.row_chunks(n, K)) for n in calls)
        say(f"GEMM launches expected from {len(calls)} field calls: {expected_gemm}")
        check(stage_launches["gemm"] == expected_gemm,
              "every field call ran the tensor-core GEMM on every row chunk")
        check(stage_launches["factors_stage"] == stage_launches["gemm"] + launches["factors"],
              "one factor-kernel launch per GEMM launch, plus the factor wiring's")
        check(stage_launches["sensor_fused"] == launches["sensors"] == 2,
              "each sensor call ran the fused narrow product once")
        check(stage_launches["factors_global"] == 0, "the d=5 tables take the staged route")
        check(kept["seen"][-1] == B_stream - (n_chunks - 1) * B_FIELDS, "stream tail trimmed")
        split = moment_split(torch, fs, vd, s_big)
        say(f"moment split: {json.dumps(split)}")

    grid, tabs, m0 = fused.grid, fused.tabs, fused.m0
    check(all(int(d) == 1 for d in grid[3].tolist()), "P1 parameter dims")
    NP = tabs.shape[0]
    ndofp = tabs.shape[1]
    # rounding count of one output (see PERF.md): per dim ≤ 1 in the basis,
    # 2 in Σ_l φ_l T_l and 1 in the product, plus K in the k-sum
    c_fields = K + 4 * NP
    c_factors = 4 * NP
    gamma = lambda c: c * U32 / (1 - c * U32)  # noqa: E731
    kernels = []

    def bf16_ulp(x):
        """The spacing of bfloat16 numbers (8 significant bits) at |x|; the
        smallest subnormal's at 0."""
        e = torch.frexp(x)[1]
        return torch.where(x == 0, torch.full_like(x, 2.0 ** -133),
                           torch.ldexp(torch.ones_like(x), e - 8))

    def hold(kernel_out, samples, table, c, rows=65_536, out_dtype=None, sw=None):
        """Max |kernel − plain| (the plain version storing ``out_dtype``) and
        |kernel − plain f64| against the γ_c bound on |F|·|table| (with
        φ ≥ 0 for P1, |F| is the plain factor of |T|), on the tables of the
        sweep ``sw`` (default: the d=5 field sweep).  A bf16 store adds
        half a bf16 ulp per rounded value.  Chunked over rows to bound
        memory."""
        sw = sw or fused
        grid, tabs, n_modes = sw.grid, sw.tabs, sw.n_modes
        tabs_abs64 = tabs.abs().double()
        worst = {"vs_plain": 0.0, "vs_f64": 0.0, "ratio": 0.0}
        t64 = None if table is None else table.double()
        for r0 in range(0, samples.shape[0], rows):
            s = samples[r0 : r0 + rows]
            k_out = kernel_out[r0 : r0 + rows].double()
            fabs = fs.fused_sweep_plain(s, grid, tabs_abs64, None, n_modes)
            if t64 is None:
                ref64 = fs.fused_sweep_plain(s, grid, tabs.double(), None, n_modes)
                plain32 = fs.fused_sweep_plain(s, grid, tabs, None, n_modes)
                # the factor kernel rounds every operation as the plain
                # version does
                check(torch.equal(kernel_out[r0 : r0 + rows], plain32),
                      "factors equal the plain f32 factors bit for bit")
                plain = plain32.double()
                del plain32
                bound = gamma(c) * fabs
            else:
                ref64 = fs.fused_sweep_plain(s, grid, tabs.double(), t64, n_modes)
                plain = fs.fused_sweep_plain(s, grid, tabs, table, n_modes,
                                             out_dtype).double()
                bound = gamma(c) * (fabs @ t64.abs())
            # plain f32 is within the same γ-bound of the exact value, so the
            # two f32 results are within twice it of each other
            bound64, bound_plain = bound, 2 * bound
            if out_dtype == torch.bfloat16:
                bound64 = bound + bf16_ulp(k_out) / 2
                bound_plain = 2 * bound + bf16_ulp(torch.maximum(k_out.abs(), plain.abs()))
            e64 = (k_out - ref64).abs()
            e_plain = (k_out - plain).abs()
            check(bool((e64 <= bound64).all()), "kernel within its bound of the f64 plain version")
            check(bool((e_plain <= bound_plain).all()),
                  "kernel within twice its bound of the plain version")
            worst["vs_plain"] = max(worst["vs_plain"], float(e_plain.max()))
            worst["vs_f64"] = max(worst["vs_f64"], float(e64.max()))
            worst["ratio"] = max(worst["ratio"], float((e64 / bound64.clamp_min(1e-300)).max()))
        return worst

    def roofline(B, n_out, out_bytes, product, sw=None):
        """Least time for a wiring: each input read once, each output written
        once, over HBM's rate; against the factor FLOPs over the f32 peak
        plus the product's over the TF32 tensor peak (each FLOP counted
        once, not per tf32 pass), whatever unit a kernel runs the product
        on.  ``bound_fp32_ms`` prices every FLOP at the f32 CUDA-core peak
        (the bound of the earlier FP32-pipe kernel, and the price of the
        fused sensor product on the CUDA cores), kept beside it.  Shapes
        from the sweep ``sw`` (default: the d=5 field sweep)."""
        NP, ndofp, K = (sw or fused).tabs.shape
        fac_flops = B * K * 2 * 2 * NP  # P1: 2 mul + 1 add + 1 product mul per dim
        mm_flops = 2 * B * K * n_out if product else 0
        nbytes = (B * NP * 4 + NP * ndofp * K * 4 + 4 * 4 * NP
                  + (K * n_out * 4 if product else 0) + B * n_out * out_bytes)
        t_bytes = nbytes / peak_bw * 1e3
        t_ops = (mm_flops / peak_tf32 + fac_flops / peak_flops) * 1e3
        t_fp32 = (mm_flops + fac_flops) / peak_flops * 1e3
        return {"bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "bound_fp32_ms": max(t_fp32, t_bytes), "flops": fac_flops + mm_flops,
                "bytes": nbytes}

    def stage1_bound(B, sw=None):
        """Least time of a field wiring's factor kernel alone: its inputs read
        once and its split F halves written once over HBM's rate, against
        its factor FLOPs over the f32 peak.  Shapes from the sweep ``sw``
        (default: the d=5 field sweep)."""
        NP_, ndofp_, K_ = (sw or fused).tabs.shape
        nbytes = B * NP_ * 4 + NP_ * ndofp_ * K_ * 4 + 2 * B * fs.padded_k(K_) * 4
        return max(nbytes / peak_bw, B * K_ * 4 * NP_ / peak_flops) * 1e3

    def stage_ms(samples, sweep, n_out, out_dtype=torch.float32):
        """Device time of the two kernels of a field wiring over the
        wrapper's row chunks, timed apart: all factor-kernel launches, then
        all GEMM launches, beside stage 1's own bound (its F halves written
        once).  The GEMM rereads the last chunk's factors (its time does not
        depend on their values)."""
        B = samples.shape[0]
        chunks = fs.row_chunks(B, K)
        hi = torch.empty((chunks[0][1], fs.padded_k(K)), device=dev)
        lo = torch.empty_like(hi)
        dst = torch.empty((B, n_out), dtype=out_dtype, device=dev)

        def stage1():
            for r0, r1 in chunks:
                fs.factors_stage(samples[r0:r1], grid, tabs, vd.n_modes, hi[: r1 - r0],
                                 lo[: r1 - r0], plan=sweep.plan, sliced=sweep.sliced)

        def stage2():
            for r0, r1 in chunks:
                fs.gemm_stage(hi[: r1 - r0], lo[: r1 - r0], *sweep.table, dst[r0:r1])

        return {"factor_stage_ms": cuda_ms(stage1, 3), "gemm_ms": cuda_ms(stage2, 3),
                "factor_stage_bound_ms": stage1_bound(B), "row_chunks": len(chunks)}

    def kernel_of(sweep, mode):
        p = sweep.plan
        return f"sweep_factors_kernel<ks={p.ks}, {mode}, {p.route}> ({p.rows} rows a block)"

    def entry(name, kernel, wiring, kernel_out_shape, launches_n, worst, ms, plain_ms, lib_ms,
              bound, c, **extra):
        kernels.append({
            "name": name, "kernel": kernel, "route": "cuda",
            "source": "pgdrome_tpu_torch/csrc/fused_sweep.cu",
            "replaces": "pgdrome_tpu/ops/pallas_kernels.py:44",
            "wiring": wiring, "shape": list(kernel_out_shape),
            "launches": launches_n, "max_abs_err": worst["vs_plain"],
            "max_abs_err_vs_f64": worst["vs_f64"], "err_over_bound": worst["ratio"],
            "gamma_c": c, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound["bound_ms"],
            "bound_by": bound["bound_by"], "library_ms": lib_ms,
            "bound_fp32_ms": bound["bound_fp32_ms"], "share": bound["bound_ms"] / ms,
            "flops": bound["flops"], "bytes": bound["bytes"], "clocks_after": clocks(),
            **extra,
        })
        say(f"kernel {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, library "
            f"{'null' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
            f"{bound['bound_ms']:.4f} ms by {bound['bound_by']}, f32-pipe bound "
            f"{bound['bound_fp32_ms']:.4f} ms), max|err| vs plain {worst['vs_plain']:.3e}, "
            f"vs f64 {worst['vs_f64']} ({worst['ratio']:.3f} of its bound)"
            + "".join(f", {k} {v}" for k, v in extra.items())
            + f", clocks after (sm, power, temperature): {kernels[-1]['clocks_after']}")

    # ------------------------------------------------------------- fields
    with Phase("check_fields"):
        w_f32 = hold(out, s_fields, m0, c_fields)
        for i, lo in ((0, 0), (n_chunks - 1, (n_chunks - 1) * B_FIELDS)):
            one_shot = vd.fields(s_stream[lo : lo + B_FIELDS])
            check(torch.equal(kept[i], one_shot), f"stream chunk {i} equals one-shot fields bit for bit")
            del one_shot
        del kept
        bf = bf16_blocks.pop()
        check(bf.dtype == torch.bfloat16 and bf.shape == out.shape, "bf16 block shape")
        bf_err = float((bf.double() - out.double()).abs().max())
        out_max = float(out.abs().max())
        say(f"bf16 store: max|bf16 − f32 kernel| {bf_err:.4e} "
            f"(bound {BF16_REL:g} · {out_max:.4e})")
        check(bf_err < BF16_REL * out_max, "bf16 store within its quantization")
        w_bf16 = hold(bf, s_fields, m0, c_fields, out_dtype=torch.bfloat16)
        del bf
        fac_fields = fs.fused_sweep(s_fields, grid, tabs, None, vd.n_modes)
        # the GEMM's operand: the split store is split_tf32 of the plain
        # factors, bit for bit
        rows_split = 65_536
        hi = torch.empty((rows_split, fs.padded_k(K)), device=dev)
        lo = torch.empty_like(hi)
        fs.factors_stage(s_fields[:rows_split], grid, tabs, vd.n_modes, hi, lo,
                         plan=fused.plan, sliced=fused.sliced)
        p_hi, p_lo = fs.split_tf32(fs.fused_sweep_plain(s_fields[:rows_split], grid, tabs,
                                                        None, vd.n_modes))
        check(torch.equal(hi[:, :K].view(torch.int32), p_hi.view(torch.int32))
              and torch.equal(lo[:, :K].view(torch.int32), p_lo.view(torch.int32))
              and not bool(hi[:, K:].any()) and not bool(lo[:, K:].any()),
              "split factor store equals split_tf32 of the plain factors bit for bit")
        del hi, lo, p_hi, p_lo
        ms_f32 = cuda_ms(lambda: fused(s_fields), 3)
        stages_f32 = stage_ms(s_fields, fused, n0)
        fused_bf16 = vd._sweep(torch.bfloat16)
        ms_bf16 = cuda_ms(lambda: fused_bf16(s_fields), 3)
        stages_bf16 = stage_ms(s_fields, fused, n0, torch.bfloat16)
        plain_f32 = cuda_ms(lambda: fs.fused_sweep_plain(s_fields, grid, tabs, m0, vd.n_modes), 2)
        plain_bf16 = cuda_ms(lambda: fs.fused_sweep_plain(s_fields, grid, tabs, m0, vd.n_modes,
                                                          torch.bfloat16), 2)
        lib = cuda_ms(lambda: torch.matmul(fac_fields, m0), 3)
        del fac_fields
        field_kernels = kernel_of(fused, "split") + " + sweep_gemm_kernel"
        entry("fused_sweep_fields_f32", field_kernels + "<f32>",
              "parallel/vademecum.py::make_sweep_fn", out.shape,
              launches["fields_f32"], w_f32, ms_f32, plain_f32, lib,
              roofline(B_FIELDS, n0, 4, True), c_fields, stages=stages_f32)
        entry("fused_sweep_fields_bf16", field_kernels + "<bf16>",
              "parallel/vademecum.py::make_sweep_fn(out_dtype=bf16)",
              out.shape, launches["fields_bf16"], w_bf16, ms_bf16, plain_bf16, lib,
              roofline(B_FIELDS, n0, 2, True), c_fields, stages=stages_bf16)
        del out

    # ------------------------------------------------------------ sensors
    with Phase("check_sensors"):
        table = vd.sensors(pts).m0
        check(table.shape == (K, N_PTS), "sensor table shape")
        w_sens = hold(resp, s_big, table, c_fields, rows=524_288)
        check(torch.equal(resp_stream, resp.cpu()), "sensors_stream equals one-shot sensors")
        sensor_sweep = vd.sensors(pts)
        ms_sens = cuda_ms(lambda: sensor_sweep(s_big), 3)
        # the fused launch alone, into a preallocated output
        dst = torch.empty((B_BIG, N_PTS), device=dev)
        stages_sens = {"sensor_fused_ms": cuda_ms(lambda: fs._launch_factors(
            s_big, grid, tabs, vd.n_modes, sensor_sweep.plan, sensor_sweep.sliced, dst,
            m0_slices=sensor_sweep.m0_slices), 3)}
        del dst
        plain_sens = cuda_ms(lambda: fs.fused_sweep_plain(s_big, grid, tabs, table, vd.n_modes), 1)
        factor_sweep = fs.FusedSweep(grid, tabs, None, vd.n_modes)
        fac_big = factor_sweep(s_big)
        lib_sens = cuda_ms(lambda: torch.matmul(fac_big, table), 3)
        entry("fused_sweep_sensors", kernel_of(sensor_sweep, "narrow"),
              "parallel/vademecum.py::make_sensor_sweep_fn",
              resp.shape, launches["sensors"], w_sens, ms_sens, plain_sens, lib_sens,
              roofline(B_BIG, N_PTS, 4, True), c_fields, stages=stages_sens)
        del resp, resp_stream

    # ------------------------------------------------------------ moments
    with Phase("check_moments"):
        w_fac = hold(fac_big, s_big, None, c_factors, rows=524_288)
        del fac_big
        torch.cuda.empty_cache()
        ms_fac = cuda_ms(lambda: factor_sweep(s_big), 3)
        plain_fac = cuda_ms(lambda: fs.fused_sweep_plain(s_big, grid, tabs, None, vd.n_modes), 1)
        entry("fused_sweep_factors", kernel_of(factor_sweep, "F"),
              "parallel/vademecum.py::make_factor_moments_fn",
              (B_BIG, K), launches["factors"], w_fac, ms_fac, plain_fac, None,
              roofline(B_BIG, K, 4, False), c_factors)
        torch.cuda.empty_cache()
        vd_plain = Vademecum(vd.spaces, vd.result, method="torch")
        mean_p, var_p = vd_plain.moments(s_big, chunk=1_048_576)
        d_mean = float((mean - mean_p).abs().max())
        d_var = float((var - var_p).abs().max())
        m_max = float(mean_p.abs().max())
        m2_max = float((var_p + mean_p ** 2).max())  # E[u²]
        var_max = float(var_p.max())
        say(f"moments: max|Δmean| {d_mean:.4e} (bound {MEAN_REL:g} · {m_max:.4e}), "
            f"max|Δvar| {d_var:.4e} (bound {VAR_REL:g} · max E[u²] {m2_max:.4e}), "
            f"max var {var_max:.4e}, max|Δvar| / max var {d_var / var_max:.4e}")
        check(bool(torch.isfinite(mean).all() and torch.isfinite(var).all()), "finite moments")
        check(d_mean <= MEAN_REL * m_max, "kernel-path mean vs plain-path mean")
        check(d_var <= VAR_REL * m2_max, "kernel-path variance vs plain-path variance")

    # -------------------------------------------------------------- train
    # the training half of the main path: the port alone trains the bench
    # vademecum (host f64 build, f32 enrichment on the card, two f64
    # residual restarts, host compression and Galerkin update), verifies it
    # densely against per-sample FEM, then serves it through the kernel
    with Phase("train"):
        import numpy as np

        from pgdrome_tpu_torch.models.problems import (elliptic_dense_verifier,
                                                       parametric_elliptic)
        from pgdrome_tpu_torch.separated import (PGDResult, SeparatedPGD, combine_results,
                                                 compress_modes, galerkin_update,
                                                 pad_rhs_bucket, precondition_dim0,
                                                 residual_problem)

        torch.cuda.synchronize()
        fs.reset_launch_counts()
        t0 = time.perf_counter()
        sep64, Vs = parametric_elliptic(**TRAIN_BUILD)
        sep_pc, tf = precondition_dim0(sep64, np.float64)
        del sep64
        say(f"train build: {time.perf_counter() - t0:.3f} s (host f64), sizes "
            f"{list(sep_pc.sizes)}, T={sep_pc.num_terms}")
        check(tuple(sep_pc.sizes) == (2047, 129, 129, 129) and sep_pc.num_terms == 4,
              "bench widths")
        res = None
        for si, budget in enumerate(TRAIN_BUDGETS, start=1):
            t0 = time.perf_counter()
            if res is None:
                prob, s_res, fp_kw = sep_pc, None, dict(tol_fp=1e-7, max_fp_it=40)
            else:
                prob, s_res = residual_problem(sep_pc, res)
                prob = pad_rhs_bucket(prob, RHS_BUCKET)
                fp_kw = dict(tol_fp=1e-5, max_fp_it=8)
            t_resid = time.perf_counter() - t0
            t0 = time.perf_counter()
            solver = SeparatedPGD(prob, n_max=budget, tol=0.0, solver="cg", cg_iters=25,
                                  residual_check=False, dtype=np.float32, device=dev, **fp_kw)
            torch.cuda.synchronize()
            t_upload = time.perf_counter() - t0
            t0 = time.perf_counter()
            delta = solver.solve_fused()
            torch.cuda.synchronize()
            t_solve = time.perf_counter() - t0
            del solver
            fp = np.asarray(delta.fp_its)
            say(f"train stage {si}: {t_solve:.3f} s solve ({t_upload:.3f} s upload, "
                f"{t_resid:.3f} s residual build), {delta.n_modes} modes, rhs rows "
                f"{prob.num_rhs}, fp sweeps mean {fp.mean():.2f} max {fp.max()} total "
                f"{fp.sum()}, {fp.sum() / t_solve:.1f} fp sweeps/s, "
                f"{t_solve / fp.sum() * 1e3:.2f} ms/sweep, final rel amplitude "
                f"{delta.amplitudes[-1]:.3e}" + ("" if s_res is None else f", s_res {s_res:.6e}"))
            check(delta.n_modes == budget and np.isfinite(delta.amplitudes).all(),
                  f"stage {si} kept its {budget} modes")
            check(delta.modes[0].is_cuda and delta.modes[0].dtype == torch.float32,
                  "the enrichment ran in f32 on the card")
            res = delta if res is None else combine_results(res, delta, s_res)
        t0 = time.perf_counter()
        n_solved = res.n_modes
        mass_c = [sep_pc.mass[0]] + [sep_pc.ops[j][0] for j in range(1, sep_pc.num_dims)]
        res = compress_modes(res, mass_c, TRAIN_DEPLOY, n_iters=20)
        res = galerkin_update(sep_pc, res)
        say(f"train post-process (compress {n_solved} -> {res.n_modes}, Galerkin): "
            f"{time.perf_counter() - t0:.3f} s")
        check(n_solved == sum(TRAIN_BUDGETS) and res.n_modes == TRAIN_DEPLOY, "trained ranks")

        t0 = time.perf_counter()
        verify = elliptic_dense_verifier(Vs, tf, **VERIFY)
        v = verify(res)
        t_verify = time.perf_counter() - t0
        per = {str(k): float(verify.sample_errors(res, p).max())
               for k, p in verify.samples.items()}
        pts_t = np.concatenate(list(verify.samples.values()))
        say(f"train verify: {t_verify:.3f} s, f64 reconstruction max rel-L2 vs FEM "
            f"{v['max']:.6e} (corners+edges {v['corners']:.6e}, interior "
            f"{v['interior']:.6e}; bound {FEM_BOUND:g}) over {len(pts_t)} samples; "
            f"per group {json.dumps(per)}; the JAX reference {REF_FEM:g} (TPU)")
        check(len(pts_t) == 8 + 3 * 80, "the verification set")
        check(abs(max(per.values()) - v["max"]) <= 1e-12 * v["max"], "per-group maxima")
        check(v["max"] < FEM_BOUND, "trained f64 reconstruction vs FEM")

        vd_t = Vademecum(Vs, res, dim0_transform=tf, method="fused", device=dev)
        fused_t = vd_t._sweep()
        check(isinstance(fused_t, fs.FusedSweep), "the trained vademecum took the kernel")
        s_train = torch.as_tensor(pts_t, dtype=torch.float32, device=dev)
        served_t = vd_t.fields(s_train)
        torch.cuda.synchronize()
        launches_t = dict(fs.LAUNCHES)
        stage_launches_t = dict(fs.STAGE_LAUNCHES)
        say(f"launches on the train path: {json.dumps(launches_t)}; kernels "
            f"{json.dumps(stage_launches_t)}")
        check(launches_t["fields_f32"] == 1 and stage_launches_t["gemm"] >= 1
              and stage_launches_t["factors_stage"] == stage_launches_t["gemm"],
              "the trained vademecum's fields ran the field wiring's kernels")
        fem_t = elliptic_fem_solver(Vs[0], TRAIN_BUILD["num_params"])
        u_t = np.stack([fem_t(p) for p in pts_t])

        def rel_rows(fields, u):
            """Max relative L2 error of (B, n0) fields against FEM rows."""
            f = fields.double().cpu().numpy()
            return float((np.linalg.norm(f - u, axis=1) / np.linalg.norm(u, axis=1)).max())

        e_served = rel_rows(served_t, u_t)
        g, tb, m0_t, n_t = fused_t.grid, fused_t.tabs, fused_t.m0, fused_t.n_modes
        c_t = int(tb.shape[2]) + 4 * int(tb.shape[0])
        w_t = hold(served_t, s_train, m0_t, c_t, sw=fused_t)
        # where the served fields' gap to the f64 reconstruction comes from:
        # the f32 tables alone (their exact product) and the plain f32 path
        e_tables = rel_rows(fs.fused_sweep_plain(s_train, g, tb.double(), m0_t.double(), n_t),
                            u_t)
        e_plain = rel_rows(fs.fused_sweep_plain(s_train, g, tb, m0_t, n_t), u_t)
        say(f"train served: kernel f32 fields max rel-L2 vs FEM {e_served:.6e} "
            f"(bound {FEM_BOUND:g}); f64 product of the f32 tables {e_tables:.6e}, "
            f"plain f32 {e_plain:.6e}, f64 reconstruction {v['max']:.6e}")
        check(e_served < FEM_BOUND, "kernel-served trained fields vs FEM")
        ms_t = cuda_ms(lambda: fused_t(s_train), 20)
        plain_t = cuda_ms(lambda: fs.fused_sweep_plain(s_train, g, tb, m0_t, n_t), 20)
        fac_t = fs.fused_sweep(s_train, g, tb, None, n_t)
        lib_t = cuda_ms(lambda: torch.matmul(fac_t, m0_t), 20)
        entry("fused_sweep_fields_f32_trained",
              kernel_of(fused_t, "split") + " + sweep_gemm_kernel<f32>",
              "parallel/vademecum.py::make_sweep_fn (trained rank-50 bench vademecum)",
              served_t.shape, launches_t["fields_f32"], w_t, ms_t, plain_t, lib_t,
              roofline(len(pts_t), int(m0_t.shape[1]), 4, True, sw=fused_t), c_t,
              factor_stage_bound_ms=stage1_bound(len(pts_t), fused_t))

    # ----------------------------------------------------------- frontier
    # the frontier's training path: the port's highd_frontier(5) trains the
    # d=5 vademecum (plain f32, boosted corner-seeded dd, plain dd stages),
    # verifies it per stage against per-sample f64 FEM, and the best result
    # is served through the field kernels
    with Phase("frontier"):
        import os
        import tempfile

        from pgdrome_tpu_torch.convert import load_state_npz
        from pgdrome_tpu_torch.ops import ddf32
        from pgdrome_tpu_torch.recipes import frontier_setup, frontier_spaces, highd_frontier
        from pgdrome_tpu_torch.separated import _contract_rhs, _DDWeights, host_f64
        from pgdrome_tpu_torch.utils.profiling import StageMetrics

        # the phase's builds and the recipe's share one setup cache in the
        # phase's temp dir: the phase builds (misses), the recipe loads (hits)
        with tempfile.TemporaryDirectory() as tmp:
            cache_env = os.environ.get("PGDROME_SETUP_CACHE")
            os.environ["PGDROME_SETUP_CACHE"] = str(Path(tmp) / "setup_cache")
            try:
                t0 = time.perf_counter()
                builds = []
                for boost in (FRONTIER["base_boost"], FRONTIER["window_boost"]):
                    build, status = frontier_setup(NUM_PARAMS, boost)
                    check(status == "miss", f"the phase's build (boost {boost}) fills the cache")
                    builds.append(build)
                (sep_base, tf_f), (sep_boost, _) = builds
                Vs_f = frontier_spaces(NUM_PARAMS)
                say(f"frontier build: {time.perf_counter() - t0:.3f} s (host f64, both "
                    f"measures, stored in the setup cache), sizes {list(sep_base.sizes)}, "
                    f"T={sep_base.num_terms}, R={sep_base.num_rhs}")
                check(tuple(sep_base.sizes) == (2047,) + (129,) * NUM_PARAMS
                      and sep_base.num_terms == NUM_PARAMS + 1
                      and sep_boost.sizes == sep_base.sizes,
                      "the d=5 frontier build: 2047 x 129^5, T = 6")

                torch.cuda.synchronize()
                fs.reset_launch_counts()
                metrics = StageMetrics(dev)
                lines = []

                def log_f(*a):
                    lines.append(" ".join(map(str, a)))
                    say(*a)

                state_npz = Path(tmp) / "frontier_d5_torch_state.npz"
                t0 = time.perf_counter()
                best, report = highd_frontier(
                    NUM_PARAMS, max_stages=FRONTIER["max_stages"], state_path=str(state_npz),
                    artifact_path=str(Path(tmp) / "frontier_d5_torch.json"), log=log_f,
                    metrics=metrics, device=dev)
                t_frontier = time.perf_counter() - t0
                check(sum(ln.startswith("setup cache hit") for ln in lines) == 2,
                      "the recipe loaded both builds from the phase's setup cache")
                raw = load_state_npz(state_npz)
                with np.load(state_npz) as z:
                    raw_arrays = {k: z[k] for k in z.files}
            finally:
                if cache_env is None:
                    os.environ.pop("PGDROME_SETUP_CACHE", None)
                else:
                    os.environ["PGDROME_SETUP_CACHE"] = cache_env
        hist = report["history"]
        say(f"frontier: {t_frontier:.3f} s for {len(hist)} stages, rank {report['rank']}, "
            f"verified max {report['verified']['max']:.6e} "
            f"(corners {report['verified']['corners_fem_max']:.6e} over "
            f"{report['verified']['corners_fem_n']}, interior "
            f"{report['verified']['interior_fem_max']:.6e}); the JAX record at these ranks "
            f"(TPU): {json.dumps(FRONTIER_REF)}")
        flags = [tuple(bool(h[f]) for f in ("boosted", "seeded", "rhs_comp")) for h in hist]
        for h, row, fl in zip(hist, metrics.rows, flags):
            fp = np.asarray(row["fp_its"])
            say(f"frontier stage {int(h['stage'])}: rank {int(h['rank'])}, corners "
                f"{h['corners']:.6e}, interior {h['interior']:.6e}, (boosted, seeded, rhs_comp) "
                f"{fl}, stage {h['stage_s']:.2f} s, solve {row['solve_s']:.3f} s, fp sweeps "
                f"mean {fp.mean():.2f} max {fp.max()} total {fp.sum()}, "
                f"{fp.sum() / row['solve_s']:.1f} fp sweeps/s, "
                f"{row['solve_s'] / fp.sum() * 1e3:.2f} ms/sweep, residual build "
                f"{row.get('residual_s', 0.0):.3f} s (rhs rows {row.get('rhs_rows', sep_base.num_rhs)}), "
                f"Galerkin {row['galerkin_s']:.3f} s, verification {row['verify_s']:.3f} s")
        ranks = [int(h["rank"]) for h in hist]
        check(ranks == [128 * (i + 1) for i in range(FRONTIER["max_stages"])],
              "frontier ranks 128 / 256 / 384")
        check(flags[:2] == FRONTIER_FLAGS[:2], "stage 1 plain f32, stage 2 boosted, seeded, dd")
        c2, i2 = hist[1]["corners"], hist[1]["interior"]
        boost3 = c2 > 1e-6 and c2 > 1.2 * i2
        say(f"frontier stage 3 flags {flags[2]}: the recipe's rule on stage 2's errors gives "
            f"{(boost3, boost3, True)}; the JAX record's {FRONTIER_FLAGS[2]}: "
            f"{'equal' if flags[2] == FRONTIER_FLAGS[2] else 'different'}")
        check(flags[2] == (boost3, boost3, True), "stage 3 flags follow the recipe's rule")
        maxes = [h["max"] for h in hist]
        for r, m in zip(ranks, maxes):
            check(m <= 2 * FRONTIER_REF[r], f"rank {r}: verified max within 2x the JAX record")
        check(all(b < a for a, b in zip(maxes, maxes[1:])), "the verified max falls every stage")
        check(report["verified"]["max"] == maxes[-1] and best.n_modes == ranks[-1],
              "the best result is the last stage's")

        # the checkpoint holds the raw combination: its Galerkin update on the
        # base measure is the returned best result, bit for bit
        check(raw.n_modes == best.n_modes and int(raw_arrays["stage"]) == len(hist),
              "checkpoint rank and stage")
        for d, m in enumerate(raw.modes):
            check(np.array_equal(m.numpy(), raw_arrays[f"m{d}"]), "load_state_npz reads the npz")
        again = galerkin_update(sep_base, raw)  # f64 host modes; best's are f32
        check(all(np.array_equal(host_f64(a)[: best.n_modes].astype(np.float32),
                                 b[: best.n_modes].cpu().numpy())
                  for a, b in zip(again.modes, best.modes)),
              "the checkpoint reloads the raw combination exactly")
        say("frontier checkpoint: reloads exactly (its Galerkin update equals the best "
            "result bit for bit)")

        # the dd contraction on the card against the CPU, on the stage-2
        # residual stack (stage 1's modes lead the raw combination)
        n1 = int(hist[0]["rank"])
        stage1 = PGDResult(modes=[m[:n1] for m in raw.modes], n_modes=n1,
                           amplitudes=raw.amplitudes[:n1], alpha=raw.alpha[:n1],
                           fp_its=raw.fp_its[:n1], normU0=raw.normU0)
        sep_res, _ = residual_problem(sep_boost, stage1)
        sep_res = pad_rhs_bucket(sep_res, 4096)
        check(sep_res.num_rhs == 4096, "the stage-2 stack is one 4096-row bucket")
        rng_f = np.random.default_rng(SEED)
        Fs = [rng_f.uniform(-1.0, 1.0, size=n).astype(np.float32) for n in sep_res.sizes]
        dd_cpu = [torch.from_numpy(ddf32.dd_from_f64(r)) for r in sep_res.rhs]
        dd_gpu = [r.to(dev) for r in dd_cpu]
        F_cpu = [torch.from_numpy(f) for f in Fs]
        F_gpu = [f.to(dev) for f in F_cpu]
        r64 = [torch.from_numpy(np.asarray(r, dtype=np.float64)) for r in sep_res.rhs]
        r32 = [r.float() for r in r64]
        w_gpu, w_cpu = _DDWeights(dd_gpu), _DDWeights(dd_cpu)
        errs = []
        for k in range(len(Fs)):
            b_gpu = _contract_rhs(dd_gpu, F_gpu, k, len(Fs), w_gpu)
            b_cpu = _contract_rhs(dd_cpu, F_cpu, k, len(Fs), w_cpu)
            check(b_gpu.is_cuda and torch.equal(b_gpu.cpu().view(torch.int32),
                                                 b_cpu.view(torch.int32)),
                  f"dim {k}: the dd contraction on the card equals the CPU's bit for bit")
            b64 = _contract_rhs(r64, F_cpu, k, len(Fs))
            b32 = _contract_rhs(r32, F_cpu, k, len(Fs))
            n64 = float(b64.norm())
            errs.append((float((b_cpu.double() - b64).norm()) / n64,
                         float((b32.double() - b64).norm()) / n64))
        say(f"frontier dd contraction (4096 x {list(sep_res.sizes)} stage-2 stack, seeded "
            f"factors): card equals CPU bit for bit in all {len(Fs)} dims; rel-L2 vs f64 per "
            f"dim, dd {[f'{e[0]:.3e}' for e in errs]}, plain f32 {[f'{e[1]:.3e}' for e in errs]}")
        del dd_cpu, dd_gpu, r64, r32, w_gpu, w_cpu

        # the best result served through the field wiring
        verify_f = elliptic_dense_verifier(Vs_f, tf_f, n_random=16, seeds=(7, 101, 1234, 777),
                                           n_edge=16)
        pts_f = np.concatenate(list(verify_f.samples.values()))
        check(len(pts_f) == 32 + 4 * 32, "the 32 inset corners and the verifier's samples")
        vd_f = Vademecum(Vs_f, best, dim0_transform=tf_f, method="fused", device=dev)
        fused_f = vd_f._sweep()
        check(isinstance(fused_f, fs.FusedSweep), "the frontier vademecum took the kernel")
        s_f = torch.as_tensor(pts_f, dtype=torch.float32, device=dev)
        served_f = vd_f.fields(s_f)
        torch.cuda.synchronize()
        launches_f = dict(fs.LAUNCHES)
        stage_launches_f = dict(fs.STAGE_LAUNCHES)
        say(f"launches on the frontier path: {json.dumps(launches_f)}; kernels "
            f"{json.dumps(stage_launches_f)}")
        check(launches_f["fields_f32"] == 1 and stage_launches_f["gemm"] >= 1
              and stage_launches_f["factors_stage"] == stage_launches_f["gemm"],
              "the frontier vademecum's fields ran the field wiring's kernels")
        fem_f = elliptic_fem_solver(Vs_f[0], NUM_PARAMS)
        u_f = np.stack([fem_f(p) for p in pts_f])
        e_served_f = rel_rows(served_f, u_f)
        v_max = report["verified"]["max"]
        g, tb, m0_f, n_f = fused_f.grid, fused_f.tabs, fused_f.m0, fused_f.n_modes
        c_f = int(tb.shape[2]) + 4 * int(tb.shape[0])
        w_f = hold(served_f, s_f, m0_f, c_f, sw=fused_f)
        say(f"frontier served: kernel f32 fields max rel-L2 vs FEM {e_served_f:.6e} over "
            f"{len(pts_f)} samples, the f64 reconstruction's verified max {v_max:.6e}, gap "
            f"{e_served_f - v_max:+.3e} (bound {FRONTIER_SERVE_SLACK:g} x verified)")
        check(e_served_f <= FRONTIER_SERVE_SLACK * v_max, "kernel-served frontier fields vs FEM")
        ms_f = cuda_ms(lambda: fused_f(s_f), 20)
        plain_f = cuda_ms(lambda: fs.fused_sweep_plain(s_f, g, tb, m0_f, n_f), 20)
        fac_f = fs.fused_sweep(s_f, g, tb, None, n_f)
        lib_f = cuda_ms(lambda: torch.matmul(fac_f, m0_f), 20)
        entry("fused_sweep_fields_f32_frontier",
              kernel_of(fused_f, "split") + " + sweep_gemm_kernel<f32>",
              "parallel/vademecum.py::make_sweep_fn (frontier-trained rank-384 d=5 vademecum)",
              served_f.shape, launches_f["fields_f32"], w_f, ms_f, plain_f, lib_f,
              roofline(len(pts_f), int(m0_f.shape[1]), 4, True, sw=fused_f), c_f,
              factor_stage_bound_ms=stage1_bound(len(pts_f), fused_f))

    say(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    say(f"wall seconds: {time.perf_counter() - t_start:.1f}")
    say(card)  # name and power limit, as nvidia-smi gives them
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                            "count": torch.cuda.device_count()}}))
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
