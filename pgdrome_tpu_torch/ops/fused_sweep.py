"""Fused vademecum sweep: a hand-written CUDA kernel for Hopper and its plain
PyTorch version (counterpart of ``pgdrome_tpu/ops/pallas_kernels.py``).

For samples s (B, NP), uniform P1/P2 parameter grids with mode tables
T_j (K, ndof_j) and a dim-0 table M0 (K, n0):

    F[b, k]   = [k < n_modes] · Π_j Σ_l φ_l(ξ_bj) T_j[k, deg_j·c_bj + l]
    out[b, :] = Σ_k F[b, k] M0[k, :]

with the cell located arithmetically, ``t = (s − x0)/h``,
``c = clip(floor t, 0, ncell − 1)``, ``ξ = t − c`` — the TPU kernel's
arithmetic, in float32.  ``M0=None`` asks for the masked factors F
themselves, (B, K): the factor wiring behind ``moments``, which on the TPU
multiplied by an identity table.

The kernel (``csrc/fused_sweep.cu``; design and bound in its header) is
built with ``nvcc`` into a plain C shared library at first use and called
through ``ctypes`` on PyTorch's current stream.  :func:`fused_sweep` takes
the plain version only for tensors on the CPU; a CUDA tensor always goes to
the kernel, and a build or launch failure raises.  Each launch adds one to
its entry in :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from pgdrome_tpu_torch.config import use_full_f32_matmul

use_full_f32_matmul()

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "fused_sweep.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
BUILD_TIMEOUT_S = 600

# launches per kernel wiring; incremented only where a kernel is launched
LAUNCHES = {"fields_f32": 0, "fields_bf16": 0, "sensors": 0, "factors": 0}

# launches with outputs up to this wide count as the sensor wiring
SENSORS_MAX = 32
_MAX_SMEM = 232448  # bytes of shared memory a block may use on sm_90
_TILE_K = 16  # K is padded to a multiple of this (kTileK)
_STEP_WORDS = 4096  # words of one staged M0 tile (kTileK * kTileN)
_MAX_NP = 16


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ------------------------------------------------------------------- build

def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put the CUDA toolkit on PATH or set CUDA_HOME")
    return str(path)


@dataclass
class BuildInfo:
    path: Path
    command: list
    seconds: float
    log: str


_LIB = None
_LAST_BUILD: BuildInfo | None = None


def build(force: bool = False) -> BuildInfo:
    """Compile ``csrc/fused_sweep.cu`` into ``_build/`` (named by a hash of
    the source and flags, so an edit never loads a stale library).  With
    ``force`` the compiler runs even if that library exists."""
    global _LAST_BUILD
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libfused_sweep_{digest}.so"
    if out.exists() and not force:
        _LAST_BUILD = BuildInfo(out, [], 0.0, "")
        return _LAST_BUILD
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=BUILD_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        raise RuntimeError(f"nvcc timed out after {BUILD_TIMEOUT_S} s") from e
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
    os.replace(tmp, out)
    _LAST_BUILD = BuildInfo(out, cmd, seconds, log)
    return _LAST_BUILD


def _library():
    """The loaded kernel library (built on first use)."""
    global _LIB
    if _LIB is None:
        info = _LAST_BUILD if _LAST_BUILD is not None else build()
        lib = ctypes.CDLL(str(info.path))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.pgd_sweep_tile.argtypes = [p, p, p, p, p, ll, i, i, i, i, i, i, i, p]
        lib.pgd_sweep_tile.restype = i
        lib.pgd_sweep_factors.argtypes = [p, p, p, p, ll, i, i, i, i, p]
        lib.pgd_sweep_factors.restype = i
        lib.pgd_error_string.argtypes = [i]
        lib.pgd_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


# ---------------------------------------------------------- sweep operands

def sweep_grid(spaces) -> np.ndarray:
    """(4, NP) float32 rows x0, 1/h, ncell, degree of the parameter spaces
    ``spaces[1:]``.  Raises ValueError unless every one is a uniform 1D
    grid of degree 1 or 2 — the kernel's constraints (the cell and its
    first dof are found by arithmetic)."""
    x0s, inv_hs, ncells, degs = [], [], [], []
    for V in spaces[1:]:
        verts = V.mesh().coordinates()[:, 0]
        dv = verts[1:] - verts[:-1]
        if not (abs(dv - dv[0]) <= 1e-12 * abs(dv[0])).all():
            raise ValueError("fused sweep needs uniform parameter grids")
        if V.degree not in (1, 2):
            raise ValueError("fused sweep supports P1/P2 parameter dims")
        x0s.append(float(verts[0]))
        inv_hs.append(float(1.0 / dv[0]))
        ncells.append(float(len(verts) - 1))
        degs.append(float(V.degree))
    if not 1 <= len(degs) <= _MAX_NP:
        raise ValueError(f"fused sweep takes 1..{_MAX_NP} parameter dims")
    return np.asarray([x0s, inv_hs, ncells, degs], dtype=np.float32)


def stack_tables(param_modes, device) -> torch.Tensor:
    """(NP, ndofp, K) float32: each parameter dim's (K, ndof) modes,
    transposed so a dof row is contiguous over k, zero-padded to the
    largest ndof."""
    K = int(param_modes[0].shape[0])
    ndofp = max(int(m.shape[1]) for m in param_modes)
    tabs = torch.zeros((len(param_modes), ndofp, K), dtype=torch.float32,
                       device=device)
    for j, m in enumerate(param_modes):
        tabs[j, : m.shape[1], :] = torch.as_tensor(m).to(device, torch.float32).T
    return tabs


def _smem_bytes(K: int, rpw: int, NP: int) -> int:
    """Shared memory of a tile block (layout in the .cu header)."""
    Kp = -(-K // _TILE_K) * _TILE_K
    rows = 8 * rpw
    words = Kp * (rows + 4) + 2 * _STEP_WORDS + rows * NP * 4 + 4 * _MAX_NP
    return 4 * words


def rows_per_warp(K: int, NP: int) -> int:
    """Largest rows-per-warp (8, 4, 2, 1) whose block fits in shared memory."""
    for rpw in (8, 4, 2, 1):
        if _smem_bytes(K, rpw, NP) <= _MAX_SMEM:
            return rpw
    raise ValueError(f"K={K} modes do not fit the fused sweep's shared memory")


# ------------------------------------------------------------ plain version

def fused_sweep_plain(samples, grid, tabs, m0, n_modes, out_dtype=None):
    """The same function in plain PyTorch (gather, basis, product,
    ``torch.matmul`` in full f32): the CPU path, and what the kernel is
    held against on the card.  Arguments as :func:`fused_sweep`; it
    computes in the dtype of ``tabs``."""
    dt = tabs.dtype
    s = samples.to(dt)
    g = grid.to(s.device)
    B, NP = s.shape
    K = tabs.shape[2]
    fac = torch.ones((B, K), dtype=dt, device=s.device)
    for j in range(NP):
        x0, inv_h = g[0, j].to(dt), g[1, j].to(dt)
        ncell, deg = float(g[2, j]), int(g[3, j])
        t = (s[:, j] - x0) * inv_h
        c = torch.clamp(torch.floor(t), 0.0, ncell - 1.0)
        xi = t - c
        base = (deg * torch.nan_to_num(c, nan=0.0)).long()
        if deg == 1:
            basis = (1.0 - xi, xi)
        else:
            basis = ((1.0 - xi) * (1.0 - 2.0 * xi), 4.0 * xi * (1.0 - xi),
                     xi * (2.0 * xi - 1.0))
        # Σ_l φ_l T[base + l] in l order, with in-place products so a
        # (B, K) sweep holds three (B, K) buffers at most
        vals = tabs[j][base].mul_(basis[0][:, None])
        for l in range(1, len(basis)):
            vals.add_(tabs[j][base + l].mul_(basis[l][:, None]))
        fac.mul_(vals)
        del vals
    fac[:, n_modes:] = 0.0
    if m0 is None:
        return fac
    m0 = m0.to(dt).clone()
    m0[n_modes:] = 0.0  # padded rows never contribute
    out = torch.matmul(fac, m0)
    return out if out_dtype is None else out.to(out_dtype)


# ------------------------------------------------------------------ wrapper

def _check(t, name, device, ndim, dtype=torch.float32):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def fused_sweep(samples, grid, tabs, m0, n_modes, out_dtype=None):
    """Run the fused sweep.

    samples (B, NP) float32; grid (4, NP) float32 from :func:`sweep_grid`;
    tabs (NP, ndofp, K) float32 from :func:`stack_tables`; m0 (K, n0)
    float32, or None for the factors (B, K); ``out_dtype`` float32 (None)
    or bfloat16 — compute stays true f32, only the store narrows.

    A CPU ``samples`` takes :func:`fused_sweep_plain`; a CUDA one launches
    the kernel (building it at first use) and raises on any failure."""
    if out_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if m0 is None and out_dtype not in (None, torch.float32):
        raise ValueError("the factor output is float32")
    dev = samples.device
    if dev.type == "cpu":
        return fused_sweep_plain(samples, grid, tabs, m0, n_modes, out_dtype)
    if dev.type != "cuda":
        raise ValueError(f"fused sweep runs on cuda or cpu, not {dev}")
    _check(samples, "samples", dev, 2)
    _check(grid, "grid", dev, 2)
    _check(tabs, "tabs", dev, 3)
    B, NP = samples.shape
    _, ndofp, K = tabs.shape
    if grid.shape != (4, NP) or tabs.shape[0] != NP:
        raise ValueError(
            f"grid {tuple(grid.shape)} / tabs {tuple(tabs.shape)} do not "
            f"match {NP} parameter dims"
        )
    if not 0 <= int(n_modes) <= K:
        raise ValueError(f"n_modes={n_modes} outside [0, {K}]")
    lib = _library()
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    if m0 is None:
        out = torch.empty((B, K), dtype=torch.float32, device=dev)
        if B == 0:
            return out
        with torch.cuda.device(dev):
            rc = lib.pgd_sweep_factors(
                samples.data_ptr(), grid.data_ptr(), tabs.data_ptr(),
                out.data_ptr(), B, NP, ndofp, K, int(n_modes), stream,
            )
        wiring = "factors"
    else:
        _check(m0, "m0", dev, 2)
        if m0.shape[0] != K:
            raise ValueError(f"m0 has {m0.shape[0]} rows, tables have K={K}")
        n0 = int(m0.shape[1])
        bf16 = out_dtype == torch.bfloat16
        out = torch.empty((B, n0), dtype=torch.bfloat16 if bf16 else torch.float32,
                          device=dev)
        if B == 0:
            return out
        with torch.cuda.device(dev):
            rc = lib.pgd_sweep_tile(
                samples.data_ptr(), grid.data_ptr(), tabs.data_ptr(), m0.data_ptr(),
                out.data_ptr(), B, NP, ndofp, K, int(n_modes), n0, int(bf16),
                rows_per_warp(K, NP), stream,
            )
        if n0 <= SENSORS_MAX:
            wiring = "sensors"
        else:
            wiring = "fields_bf16" if bf16 else "fields_f32"
    if rc != 0:
        msg = lib.pgd_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"fused sweep ({wiring}) launch failed: CUDA error {rc}: {msg}")
    LAUNCHES[wiring] += 1
    return out


class FusedSweep:
    """A fused sweep bound to one vademecum's tables on one device:
    ``sweep(samples (B, NP)) → (B, n0)`` (or the factors (B, K) when built
    with no dim-0 table)."""

    def __init__(self, grid, tabs, m0, n_modes, out_dtype=None):
        self.grid, self.tabs, self.m0 = grid, tabs, m0
        self.n_modes = int(n_modes)
        self.out_dtype = out_dtype

    def __call__(self, samples):
        s = torch.as_tensor(samples).to(self.tabs.device, torch.float32).contiguous()
        return fused_sweep(s, self.grid, self.tabs, self.m0, self.n_modes,
                           self.out_dtype)


def make_fused_sweep(spaces, modes, n_modes, out_dtype=None, device=None):
    """Bind the fused sweep to a vademecum: ``modes[0]`` (K, n0) is the
    dim-0 table (modes, a sensor point table, or None for the factors),
    ``modes[1:]`` the (K, ndof_j) parameter modes.  Tables go to ``device``
    (default: that of ``modes[1]``) as float32.  Raises ValueError on
    non-uniform grids or degrees outside {1, 2}, as the TPU kernel does."""
    grid = sweep_grid(spaces)
    param = list(modes[1:])
    device = torch.device(device) if device is not None else torch.as_tensor(param[0]).device
    tabs = stack_tables(param, device)
    m0 = None
    if modes[0] is not None:
        m0 = torch.as_tensor(modes[0]).to(device, torch.float32).contiguous()
    return FusedSweep(torch.as_tensor(grid, device=device), tabs, m0, n_modes,
                      out_dtype)
