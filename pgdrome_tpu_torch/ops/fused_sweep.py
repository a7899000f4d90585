"""Vademecum sweep: hand-written CUDA kernels for Hopper and their plain
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

On the card (``csrc/fused_sweep.cu``; design and bounds in its header)
the factor kernel reads the tables by k-slices staged in shared memory
(:func:`slice_tables`; tile, slice width and route from
:func:`factor_plan`; a batch of few rows gets shorter tiles and k-ranges
across the grid's second axis, :func:`factor_grid`) and computes F in the
plain version's rounding, bit for bit.  Outputs of at most
:data:`SENSORS_MAX` columns (sensors) go to the fused narrow product, a
kernel of its own that computes F's tensor-core fragments in registers
and multiplies them by the slice of a split, permuted M0 table
(:func:`narrow_table`): F never leaves the chip.  Wider outputs
(fields) take two kernels: the factor kernel writes F, split into tf32
hi/lo halves, into a scratch buffer whose rows are K rounded up to a
multiple of 8, and a TMA + wgmma GEMM multiplies it by the split,
transposed, masked M0 table in three tf32 passes; the first
:data:`K_HEAD` modes skip the tensor cores (F's columns kept whole, their
table rows zero) and are added in f32 FMAs by the GEMM's epilogue from an
f32 head table (:func:`split_factors`, :func:`split_table`).  Both
products bind the modes with the K_HEAD largest first
(:func:`head_order`).  The GEMM's
blocks are persistent and store through shared memory; the table's tensor
maps are encoded once per sweep (:func:`table_maps`).  The wrapper walks
the batch in row chunks so the scratch stays under :data:`SCRATCH_BYTES`.
Above K = :data:`SPLIT_K_MIN` both products sum over k in chunks of
:data:`K_CHUNK`: each chunk's f32 partial goes to a scratch buffer and a
third kernel adds the partials in f64 (:func:`chunked_product` is the
plain version of that order).
The kernels are built with ``nvcc`` into a plain C shared library at first
use and called through ``ctypes`` on PyTorch's current stream.
:func:`fused_sweep` takes the plain version only for tensors on the CPU; a
CUDA tensor always goes to the kernels, and a build or launch failure
raises.  Each wiring call adds one to its entry in :data:`LAUNCHES`, each
kernel launch one to its entry in :data:`STAGE_LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import functools
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

# calls per sweep wiring; incremented only where the kernels are launched
LAUNCHES = {"fields_f32": 0, "fields_bf16": 0, "sensors": 0, "factors": 0}
# launches per kernel route: the staged factor kernel writing F or its
# split (factors_stage), the staged fused narrow product (sensor_fused),
# the factor kernel on the global route, any mode (factors_global),
# the tensor-core GEMM (gemm), and the f64 sum of k-chunk partials
# (partial_sum)
STAGE_LAUNCHES = {"factors_stage": 0, "sensor_fused": 0, "factors_global": 0, "gemm": 0,
                  "partial_sum": 0}

# outputs up to this wide are the fused narrow product (the sensor wiring)
SENSORS_MAX = 32
# bytes of F scratch (both tf32 halves) one row chunk may hold
SCRATCH_BYTES = 1 << 30
GEMM_ROWS = 128  # output rows of one GEMM block; chunks are multiples of it
# the f32 sum over k: up to SPLIT_K_MIN modes in one running sum (the
# kernels' order before the chunked sum, kept bit for bit), above it in
# K_CHUNK-long f32 partials added in f64 (csrc/fused_sweep.cu's header)
SPLIT_K_MIN = 1024
K_CHUNK = 512
K_GROUP = 16  # k per fresh tensor-core accumulator (the kernel's kGroupK)
K_HEAD = 8  # leading modes summed in f32 FMAs by the GEMM's epilogue (kHead)
K_ALIGN = 8  # F and table rows are padded to a multiple of this (TMA, k8 steps)
_MAX_NP = 16

# the factor kernel's tiling (csrc/fused_sweep.cu, stage 1)
FACTOR_THREADS = 1024  # a block writing F or its split
SLICE_WIDTHS = (32, 16, 8, 4)  # k-slice widths, widest first
TILE_ROWS_MAX = 2048  # sample rows per block
SMEM_BYTES = 232448 - 1024  # dynamic shared memory a block may take
# the narrow product's (sweep_narrow_kernel): 16 warps, each one m16 tile
# of rows a pass, holding at most NARROW_TILES m16 x n8 accumulator tiles
NARROW_THREADS = 512
NARROW_PASS = 16 * NARROW_THREADS // 32  # rows of one pass: 256
NARROW_TILES = 8
NARROW_SLICE_WIDTHS = (32, 16)  # two 16-k groups a slice, or one
NARROW_TAIL = 32  # bytes of stage barriers and counts past the located cells
# a narrow tile's cost past its rows (its table slices, its locates), in
# rows: 69 from the d=5 sensors at ks = 32 on an H100, 1024-row tiles
# against 1536-row ones (4.95 against 4.77 ms, PERF.md 6.1)
NARROW_TILE_COST = 64


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, STAGE_LAUNCHES):
        for k in counts:
            counts[k] = 0


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
        lib.pgd_sweep_factors.argtypes = [p, p, p, p, p, p, p, ll, i, i, i, i, i, i, i, i, i,
                                          i, i, p]
        lib.pgd_sweep_factors.restype = i
        lib.pgd_factor_smem.argtypes = [i, i, i, i, i, i]
        lib.pgd_factor_smem.restype = ll
        lib.pgd_sweep_gemm.argtypes = [p, p, p, p, p, ll, i, i, i, i, p, p]
        lib.pgd_sweep_gemm.restype = i
        lib.pgd_gemm_table_maps.argtypes = [p, p, p, i, i, p]
        lib.pgd_gemm_table_maps.restype = i
        lib.pgd_gemm_maps_bytes.argtypes = []
        lib.pgd_gemm_maps_bytes.restype = i
        lib.pgd_partial_sum.argtypes = [p, p, i, ll, i, p, p]
        lib.pgd_partial_sum.restype = i
        lib.pgd_sm_count.argtypes = []
        lib.pgd_sm_count.restype = i
        lib.pgd_sweep_gemm_smem.argtypes = []
        lib.pgd_sweep_gemm_smem.restype = i
        lib.pgd_error_string.argtypes = [i]
        lib.pgd_error_string.restype = ctypes.c_char_p
        lib.pgd_k_head.argtypes = []
        lib.pgd_k_head.restype = i
        if lib.pgd_k_head() != K_HEAD:
            raise RuntimeError(f"kernel head width {lib.pgd_k_head()} != K_HEAD {K_HEAD}")
        _LIB = lib
    return _LIB


_SM_COUNTS = {}


def sm_count(device) -> int:
    """The streaming multiprocessors of a CUDA ``device``, as the kernel
    library reads them (``pgd_sm_count``): the count the factor kernel's
    grid (:func:`factor_grid`), the persistent GEMM and the partial sum
    fill."""
    dev = torch.device(device)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _SM_COUNTS:
        lib = _library()
        with torch.cuda.device(idx):
            n = lib.pgd_sm_count()
        if n <= 0:
            _raise_on(-n, lib, "SM count")
        _SM_COUNTS[idx] = n
    return _SM_COUNTS[idx]


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


def padded_k(K: int) -> int:
    """Row length of the F scratch and the M0 table: K rounded up to a
    multiple of :data:`K_ALIGN`."""
    return -(-int(K) // K_ALIGN) * K_ALIGN


def split_tf32(x: torch.Tensor):
    """Split float32 ``x`` into tf32 halves ``(hi, lo)``: hi rounds x to 10
    stored mantissa bits (nearest, ties away from zero — the integer form
    of ``cvt.rna.tf32.f32``), lo rounds x − hi the same way, so
    |x − hi − lo| ≤ 2⁻²²|x| for normal x.  A value that would round to
    infinity is truncated instead; non-finite x gives (x, 0).  Bit for bit
    what the kernel's stage 1 stores."""
    if x.dtype != torch.float32:
        raise TypeError(f"split_tf32 takes float32, got {x.dtype}")

    def rn(v):
        u = v.view(torch.int32)
        h = (u + 0x1000) & -0x2000  # & 0xffffe000; the sign bit stays
        inf = (h & 0x7F800000) == 0x7F800000
        return torch.where(inf, u & -0x2000, h).view(torch.float32)

    finite = torch.isfinite(x)
    xf = torch.where(finite, x, torch.zeros_like(x))
    hi = rn(xf)
    lo = rn(xf - hi)
    return torch.where(finite, hi, x), lo


def split_factors(f: torch.Tensor):
    """The factor kernel's split store of float32 F (rows, Kp): columns
    k ≥ :data:`K_HEAD` split by :func:`split_tf32`, the head columns kept
    whole in hi with lo zero (the GEMM's epilogue sums them in f32 FMAs).
    Returns (hi, lo)."""
    hi, lo = split_tf32(f)
    hi[:, :K_HEAD] = f[:, :K_HEAD]
    lo[:, :K_HEAD] = 0.0
    return hi, lo


def split_table(m0: torch.Tensor, n_modes: int):
    """The GEMM's M0 operands.  M0 (K, n0) with rows k ≥ ``n_modes`` taken
    as zero (whatever M0 holds there, NaN included): its rows
    k ≥ :data:`K_HEAD`, transposed to (n0, Kp) and split by
    :func:`split_tf32`, the head and the padding k ≥ K zero; and its first
    K_HEAD rows in f32, (K_HEAD, n0 rounded up to 4), zero past K and n0.
    Returns (hi, lo, head)."""
    K, n0 = m0.shape
    keep = torch.arange(K, device=m0.device) < int(n_modes)
    m = torch.where(keep[:, None], m0.to(torch.float32), 0.0)
    t = torch.zeros((n0, padded_k(K)), dtype=torch.float32, device=m0.device)
    t[:, K_HEAD:K] = m[K_HEAD:].T
    hi, lo = split_tf32(t)
    head = torch.zeros((K_HEAD, _round4(n0)), dtype=torch.float32, device=m0.device)
    head[:min(K, K_HEAD), :n0] = m[:K_HEAD]
    return hi.contiguous(), lo.contiguous(), head


def head_order(tabs: torch.Tensor, m0: torch.Tensor, n_modes: int):
    """The order in which the kernels bind a sweep's modes, or None where
    it is the modes' own: the :data:`K_HEAD` largest of the first
    ``n_modes`` first, then the rest, each part in its own order; modes
    k ≥ ``n_modes`` keep their places.  A mode's size is max|M0[k, :]| ·
    Π_j max|T_j[:, k]|, a bound on its term in any output (up to a factor
    that P2 bases share across modes).  The head's terms are summed in
    f32 FMAs and the rest in 3xTF32, so the largest terms must be the
    head's whatever order the modes come in (ROADMAP C4)."""
    K, n = tabs.shape[2], int(n_modes)
    if n <= K_HEAD:
        return None
    mag = (m0[:n].abs().amax(1).double()
           * tabs[:, :, :n].abs().amax(1).double().prod(0))
    head = torch.zeros(K, dtype=torch.bool, device=tabs.device)
    head[torch.sort(mag, descending=True, stable=True).indices[:K_HEAD]] = True
    if bool(head[:K_HEAD].all()):
        return None
    k = torch.arange(K, device=tabs.device)
    return torch.cat([k[head], k[~head]])


def k_chunks(K: int) -> int:
    """How many k-chunks a product over K modes is summed in: 1 up to
    :data:`SPLIT_K_MIN`, else ceil(K / :data:`K_CHUNK`)."""
    return 1 if int(K) <= SPLIT_K_MIN else -(-int(K) // K_CHUNK)


def sum_roundings(K: int) -> int:
    """The f32 roundings an output's sum over K modes goes through, as the
    γ_c bounds count them: K in one running sum, else :data:`K_CHUNK`
    within a chunk plus one per chunk (the f64 additions and the final
    rounding to f32).  A generous count for both products' order: the GEMM
    and the narrow product sum :data:`K_HEAD` head terms in FMAs, a
    :data:`K_GROUP`-deep tensor-core group, and one rounding a group into
    the chunk's total (:func:`narrow_roundings`)."""
    n_ch = k_chunks(K)
    return int(K) if n_ch == 1 else K_CHUNK + n_ch


def narrow_roundings(ks: int, range_slices: int, ranges: int) -> int:
    """The f32 roundings of one narrow-product output on a launch of
    ``ranges`` k-ranges of ``range_slices`` slices of ``ks``: the head's
    FMAs, one group's 16 products, one addition a group of the range, and
    (on more than one range) the one rounding of the f64 sum."""
    return K_HEAD + K_GROUP + range_slices * ks // K_GROUP + (1 if ranges > 1 else 0)


def chunked_product(fac, m0):
    """fac (B, K) · m0 (K, n0) in the kernels' summation order: one
    ``torch.matmul`` when K ≤ :data:`SPLIT_K_MIN` or the operands are not
    float32; else, per :data:`K_CHUNK` of k, f32 ``torch.matmul`` products
    of :data:`K_GROUP` k each (the GEMM's fresh accumulators) added in f32
    in k order, and the chunk partials added in f64 in chunk order and
    rounded once to f32.  Each output then goes through at most
    K_CHUNK / K_GROUP + K_GROUP + n_chunks f32 roundings, not K.  (One f32
    ``torch.matmul`` per 512-k chunk is not enough on an H100: cuBLAS's
    order served the d=10 fields at 1.208e-6 against FEM, the grouped sum
    at 9.02e-7.)"""
    K = fac.shape[-1]
    if fac.dtype != torch.float32 or k_chunks(K) == 1:
        return torch.matmul(fac, m0)
    acc = None
    for k0 in range(0, K, K_CHUNK):
        tot = None
        for g0 in range(k0, min(K, k0 + K_CHUNK), K_GROUP):
            p = torch.matmul(fac[..., g0:g0 + K_GROUP], m0[g0:g0 + K_GROUP])
            tot = p if tot is None else tot.add_(p)
        acc = tot.double() if acc is None else acc.add_(tot.double())
    return acc.to(torch.float32)


def row_chunks(B: int, K: int, n0: int = 0):
    """The wrapper's walk over a batch: (start, stop) row ranges covering
    [0, B) in order, each a multiple of :data:`GEMM_ROWS` rows (but the
    last) whose F scratch, 8·Kp bytes a row, and (above
    :data:`SPLIT_K_MIN`) the f32 partials of its ``n0`` outputs,
    4·n_chunks·n0 bytes a row, fit :data:`SCRATCH_BYTES` (one 128-row tile
    at least)."""
    kp = padded_k(K)
    n_ch = k_chunks(kp)
    per_row = 8 * kp + (4 * n_ch * int(n0) if n_ch > 1 else 0)
    rows = max(GEMM_ROWS, SCRATCH_BYTES // per_row // GEMM_ROWS * GEMM_ROWS)
    return [(r0, min(B, r0 + rows)) for r0 in range(0, int(B), rows)]


def _round4(n: int) -> int:
    return -(-int(n) // 4) * 4


def narrow_nt(n0: int) -> int:
    """n8 column tiles of a narrow output ``n0`` wide (the kernel's
    ``narrow_nt``): 1 up to 8 columns, 2 up to 16, else 4."""
    return 1 if n0 <= 8 else 2 if n0 <= 16 else 4


def narrow_rows_max(n0: int) -> int:
    """The tallest tile of the narrow product at width ``n0``: one pass a
    warp's accumulator tile, :data:`NARROW_TILES` // narrow_nt(n0) passes."""
    return NARROW_PASS * (NARROW_TILES // narrow_nt(n0))


def factor_smem(NP: int, ndofp: int, ks: int, rows: int, n0: int = 0,
                staged: bool = True) -> int:
    """Dynamic shared memory of a factor-kernel launch, in bytes — the
    kernel's ``factor_smem``: two table stages of NP·ndofp·ks floats when
    staged, then the tile's ``rows`` × NP samples.  For the narrow product
    (n0 > 0) each stage also holds the slice's split M0 (2·ks·8·narrow_nt(n0)
    floats), and the samples' place is taken by their located cells (the
    first dof and ξ of each (row, dim), 8 bytes) and :data:`NARROW_TAIL`
    bytes of barriers and counts."""
    stage = NP * ndofp * ks + (2 * ks * 8 * narrow_nt(n0) if n0 > 0 else 0)
    per_rows = 8 * rows * NP + NARROW_TAIL if n0 > 0 else 4 * _round4(rows * NP)
    return 4 * (2 * stage if staged else 0) + per_rows


@dataclass(frozen=True)
class FactorPlan:
    """How the factor kernel walks a sweep: ``route`` "staged" (tables
    through shared memory) or "global" (gathers from L2), slice width
    ``ks``, sample rows per block ``rows``, dynamic shared memory ``smem``."""
    route: str
    ks: int
    rows: int
    smem: int


def factor_plan(NP: int, ndofp: int, n0: int = 0) -> FactorPlan:
    """The factor kernel's tiling for NP tables of ndofp rows (n0 > 0: the
    fused narrow product of that width), chosen by shape alone.

    The widest slice whose two stages leave room, in
    :data:`SMEM_BYTES`, for a tile of one pass at least (a row per thread;
    :data:`NARROW_PASS` rows for the narrow product), with the tallest such
    tile (up to :data:`TILE_ROWS_MAX`, or :func:`narrow_rows_max`, in steps
    of one pass); else, for tables too wide for two stages even at the
    narrowest slice (ks = 4; 16 for the narrow product), the global route
    at ks = 32.  Wide slices come first: they share each locate among more
    columns, and on an H100 they beat tall tiles (PERF.md 6.1); the narrow
    product's two 16-k groups a slice also read its 128-byte table rows
    without bank conflicts."""
    step = NARROW_PASS if n0 > 0 else FACTOR_THREADS
    top = narrow_rows_max(n0) if n0 > 0 else TILE_ROWS_MAX

    def tallest(ks, staged):
        rows = top
        while rows >= step and factor_smem(NP, ndofp, ks, rows, n0, staged) > SMEM_BYTES:
            rows -= step
        return rows

    for ks in NARROW_SLICE_WIDTHS if n0 > 0 else SLICE_WIDTHS:
        rows = tallest(ks, True)
        if rows >= step:
            return FactorPlan("staged", ks, rows, factor_smem(NP, ndofp, ks, rows, n0))
    rows = tallest(32, False)
    if rows < step:
        raise ValueError(f"no factor-kernel tile fits {NP} dims of {ndofp} dofs, n0={n0}")
    return FactorPlan("global", 32, rows, factor_smem(NP, ndofp, 32, rows, n0, False))


@dataclass(frozen=True)
class FactorGrid:
    """One factor-kernel launch: ``tiles`` row tiles of ``rows`` sample rows
    (blockIdx.x) × ``ranges`` k-ranges of ``range_slices`` slices each
    (blockIdx.y)."""
    rows: int
    range_slices: int
    ranges: int
    tiles: int

    @property
    def blocks(self) -> int:
        return self.tiles * self.ranges


def wave_rows(top: int, B: int, n_sm: int) -> int:
    """The narrow product's tile height for ``B`` ≥ ``n_sm``·``top`` rows.
    One block an SM walks ceil(tiles / n_sm) tiles, each costing its rows
    and :data:`NARROW_TILE_COST` more.  ``top`` (the plan's rows) unless a
    shorter multiple of :data:`NARROW_PASS` cuts that walk by more than
    5 %, then the tallest of the shortest walks: for a launch whose last
    wave leaves many SMs idle, as a stream's 524,288-row chunk in 1536-row
    tiles (2.6 waves: 3 × 1600 against 4 × 1088 in 1024-row tiles)."""

    def walk(rows):
        return -(-(-(-B // rows)) // n_sm) * (rows + NARROW_TILE_COST)

    best = top
    for rows in range(top - NARROW_PASS, 0, -NARROW_PASS):
        if walk(rows) < walk(best):
            best = rows
    return best if walk(best) <= 0.95 * walk(top) else top


@functools.lru_cache(maxsize=512)
def factor_grid(plan: FactorPlan, B: int, slices: int, n0: int, n_sm: int) -> FactorGrid:
    """The grid of one factor-kernel launch over ``B`` rows that walks
    ``slices`` k-slices of ``plan.ks`` (n0 > 0: the fused narrow product of
    that width) on a card of ``n_sm`` SMs (:func:`sm_count`), chosen from
    these alone.  A call's row chunks each take the grid of their own rows.

    A launch of at least ``n_sm`` tiles of ``plan.rows`` keeps the plan's
    rows (the narrow product: :func:`wave_rows`).  A smaller one would
    leave SMs idle, so its tiles shorten (down to
    one pass of the block's threads: 1024 / (ks / 4) rows, or
    :data:`NARROW_PASS` for the narrow product) towards two blocks an SM, and, if that is not enough,
    the slices split into k-ranges across blockIdx.y until there are about
    2·n_sm blocks.  F and its split keep one range on a full card.  The
    narrow product does too up to :data:`SPLIT_K_MIN` modes; past it, or
    when it splits, its ranges are a power of two of slices no longer than
    a :data:`K_CHUNK`, so none crosses a chunk boundary: each writes its
    own f32 partial and :func:`partial_sum` adds them."""
    B, slices = int(B), max(1, int(slices))
    ks = plan.ks
    tiles = -(-B // plan.rows)
    if tiles >= n_sm or B == 0:
        rows = wave_rows(plan.rows, B, n_sm) if n0 > 0 and B else plan.rows
        tiles = -(-B // rows)
        width = K_CHUNK // ks if n0 > 0 and slices * ks > SPLIT_K_MIN else slices
    else:
        one_pass = NARROW_PASS if n0 > 0 else FACTOR_THREADS // (ks // 4)
        want = -(-B // (2 * n_sm))  # rows a tile for two blocks an SM
        rows = min(plan.rows, max(one_pass, -(-want // one_pass) * one_pass))
        tiles = -(-B // rows)
        width = -(-slices // max(1, -(-2 * n_sm // tiles)))
        if n0 > 0:
            width = min(width, K_CHUNK // ks)
            width = 1 << (width.bit_length() - 1)  # a power of two: divides the chunk
    ranges = -(-slices // width)
    return FactorGrid(rows, slices if ranges == 1 else width, ranges, tiles)


def slice_tables(tabs: torch.Tensor, ks: int) -> torch.Tensor:
    """The factor kernel's table layout: (NP, ndofp, K) cut into k-slices,
    (ceil(K/ks), NP·ndofp, ks), zero past K, so one slice of every table
    is one contiguous block (one bulk copy)."""
    NP, ndofp, K = tabs.shape
    n_sl = -(-K // ks)
    t = torch.zeros((NP * ndofp, n_sl * ks), dtype=torch.float32, device=tabs.device)
    t[:, :K] = tabs.reshape(NP * ndofp, K)
    return t.view(NP * ndofp, n_sl, ks).transpose(0, 1).contiguous()


def narrow_table(m0: torch.Tensor, n_modes: int, ks: int) -> torch.Tensor:
    """The fused narrow product's M0 table, one flat float32 buffer.  M0
    (K, n0 ≤ :data:`SENSORS_MAX`), rows k ≥ ``n_modes`` (NaN included)
    taken as zero, padded to n8 = 8·:func:`narrow_nt` columns: for each of
    the ceil(K/ks) k-slices, its rows k ≥ :data:`K_HEAD` split by
    :func:`split_tf32`, hi then lo, each (ks/16 groups, n8, 16) — group i's
    16 rows transposed, so the kernel's lane (g, t) reads rows 16i + 4t ..
    +3 of column g as one float4, the k order of its A fragments — the head
    rows and the padding zero; then the head, M0's first K_HEAD rows in f32,
    (K_HEAD, n8)."""
    K, n0 = m0.shape
    n8 = 8 * narrow_nt(n0)
    n_sl = -(-K // ks)
    keep = torch.arange(K, device=m0.device) < int(n_modes)
    m = torch.zeros((n_sl * ks, n8), dtype=torch.float32, device=m0.device)
    m[:K, :n0] = torch.where(keep[:, None], m0.to(torch.float32), 0.0)
    head = m[:K_HEAD].clone()
    m[:K_HEAD] = 0.0
    hi, lo = split_tf32(m)
    # (slice, group, 16 rows, n8) → (slice, hi/lo, group, n8, 16)
    parts = [t.view(n_sl, ks // 16, 16, n8).transpose(2, 3) for t in (hi, lo)]
    sliced = torch.stack(parts, dim=1).contiguous()
    return torch.cat([sliced.reshape(-1), head.reshape(-1)])


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
    out = chunked_product(fac, m0)
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


def _raise_on(rc, lib, what):
    if rc != 0:
        msg = lib.pgd_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}: {msg}")


def _stream(dev):
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _launch_factors(samples, grid, tabs, n_modes, plan, sliced, out, out_lo=None,
                    m0_slices=None):
    """One factor-kernel launch over checked operands: F, its split or
    (``m0_slices``) the fused narrow product into ``out``, on the grid
    :func:`factor_grid` gives these samples — the narrow product, on more
    than one k-range, summed in one f32 partial a range that
    :func:`partial_sum` adds.  Returns the launch's grid (a dict, with the
    partial sum's blocks where it ran)."""
    dev = samples.device
    B, NP = samples.shape
    _, ndofp, K = tabs.shape
    ld = int(out.shape[1])
    narrow = m0_slices is not None
    slices = -(-int(n_modes) // plan.ks) if narrow else -(-ld // plan.ks)
    g = factor_grid(plan, B, slices, ld if narrow else 0, sm_count(dev))
    part = None
    if narrow and g.ranges > 1:
        part = torch.empty((g.ranges, B, ld), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.pgd_sweep_factors(
            samples.data_ptr(), grid.data_ptr(), sliced.data_ptr(),
            None if m0_slices is None else m0_slices.data_ptr(), out.data_ptr(),
            None if out_lo is None else out_lo.data_ptr(),
            None if part is None else part.data_ptr(), B, NP, ndofp, K, int(n_modes),
            ld, plan.ks, g.rows, int(plan.route == "staged"),
            int(out.dtype == torch.bfloat16), g.range_slices, g.ranges, _stream(dev),
        )
    _raise_on(rc, lib, "sweep factor kernel")
    key = ("factors_global" if plan.route == "global"
           else "sensor_fused" if narrow else "factors_stage")
    STAGE_LAUNCHES[key] += 1
    launched = {"rows": g.rows, "tiles": g.tiles, "ranges": g.ranges,
                "range_slices": g.range_slices, "blocks": g.blocks}
    if part is not None:
        launched["partial_sum_blocks"] = partial_sum(part, out)
    return launched


def partial_sum(part, out):
    """The f64 sum of k-chunk partials on the card: ``out`` (…) =
    Σ_c ``part``[c] in chunk order, rounded once to f32 (and to bf16 for a
    bfloat16 ``out``); ``part`` (n_chunks, …) float32.  Returns the blocks
    launched."""
    dev = out.device
    _check(part, "part", dev, part.dim())
    _check(out, "out", dev, out.dim(), out.dtype)
    if part.shape[1:] != out.shape:
        raise ValueError(f"partials {tuple(part.shape)} do not fit out {tuple(out.shape)}")
    lib = _library()
    blocks = ctypes.c_int(0)
    with torch.cuda.device(dev):
        rc = lib.pgd_partial_sum(part.data_ptr(), out.data_ptr(), int(part.shape[0]),
                                 out.numel(), int(out.dtype == torch.bfloat16),
                                 ctypes.byref(blocks), _stream(dev))
    _raise_on(rc, lib, "partial sum")
    STAGE_LAUNCHES["partial_sum"] += 1
    return blocks.value


def factors_stage(samples, grid, tabs, n_modes, out, out_lo=None, plan=None, sliced=None):
    """The factor kernel on the card: the masked factors of ``samples``
    (B, NP) into ``out`` (B, K), columns k ≥ ``n_modes`` zero — or, with
    ``out_lo``, their split (:func:`split_factors`) into ``out`` and
    ``out_lo`` (B, ldf), ldf ≥ K and a multiple of 4, the padding zero.
    ``samples``, ``grid`` and ``tabs`` as :func:`fused_sweep` takes them;
    ``plan`` and ``sliced`` (:func:`factor_plan`, :func:`slice_tables`)
    are made from ``tabs`` when not given.  Returns the launch's grid
    (:func:`factor_grid`).  B ≥ 1."""
    dev = samples.device
    B = samples.shape[0]
    NP, ndofp, K = tabs.shape
    for name, t in (("out", out), ("out_lo", out_lo)):
        if t is not None:
            _check(t, name, dev, 2)
            if t.shape[0] != B or t.shape[1] < K or (out_lo is None and t.shape[1] != K):
                raise ValueError(f"{name} {tuple(t.shape)} does not fit ({B}, {K}) factors")
    if out_lo is not None and (out_lo.shape != out.shape or out.shape[1] % 4):
        raise ValueError("out and out_lo must share a shape whose rows are a multiple of 4")
    plan = plan or factor_plan(NP, ndofp)
    sliced = slice_tables(tabs, plan.ks) if sliced is None else sliced
    return _launch_factors(samples, grid, tabs, n_modes, plan, sliced, out, out_lo)


def table_maps(t_hi, t_lo, head):
    """The GEMM's tensor maps of a split M0 table (:func:`split_table`),
    encoded once: a host buffer that :func:`gemm_stage` takes as ``maps``
    for as long as the three tensors live."""
    dev = t_hi.device
    for name, t in (("t_hi", t_hi), ("t_lo", t_lo), ("head", head)):
        _check(t, name, dev, 2)
    n0, Kp = t_hi.shape
    if t_lo.shape != t_hi.shape or head.shape != (K_HEAD, _round4(n0)) or Kp % K_ALIGN:
        raise ValueError(f"table {tuple(t_hi.shape)} / head {tuple(head.shape)} do not match")
    lib = _library()
    buf = ctypes.create_string_buffer(lib.pgd_gemm_maps_bytes())
    with torch.cuda.device(dev):
        rc = lib.pgd_gemm_table_maps(t_hi.data_ptr(), t_lo.data_ptr(), head.data_ptr(), Kp, n0,
                                     buf)
    _raise_on(rc, lib, "GEMM table map")
    return buf


def gemm_stage(f_hi, f_lo, t_hi, t_lo, head, out, maps=None, part=None):
    """Stage 2 on the card: ``out`` (rows, n0) = F · M0, from the split
    factors ``f_hi``/``f_lo`` (rows, Kp) of :func:`split_factors` and the
    table ``t_hi``/``t_lo`` (n0, Kp), ``head`` (K_HEAD, round4(n0)) of
    :func:`split_table` (``maps``: their :func:`table_maps`, encoded here
    when not given): three tf32 passes over k ≥ :data:`K_HEAD`, then the
    head in f32 FMAs; ``out`` float32 or bfloat16 (the store rounds).
    Above :data:`SPLIT_K_MIN` the GEMM writes one f32 partial per
    :data:`K_CHUNK` of k into a scratch buffer and :func:`partial_sum`
    adds them; a caller's ``part`` (n_chunks, rows, n0) float32 takes the
    partials instead, and ``out`` is then left as it was.  Returns the
    launch's work items and blocks (:func:`_launch_gemm`).  rows ≥ 1."""
    dev = out.device
    for name, t in (("f_hi", f_hi), ("f_lo", f_lo), ("t_hi", t_hi), ("t_lo", t_lo),
                    ("head", head)):
        _check(t, name, dev, 2)
    _check(out, "out", dev, 2, out.dtype)
    rows, Kp = f_hi.shape
    n0 = t_hi.shape[0]
    if (f_lo.shape != f_hi.shape or t_hi.shape != (n0, Kp) or t_lo.shape != t_hi.shape
            or out.shape != (rows, n0) or head.shape != (K_HEAD, _round4(n0))):
        raise ValueError(
            f"GEMM shapes do not match: F {tuple(f_hi.shape)}, table "
            f"{tuple(t_hi.shape)}, head {tuple(head.shape)}, out {tuple(out.shape)}"
        )
    if out.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"out must be float32 or bfloat16, got {out.dtype}")
    if Kp % K_ALIGN:
        raise ValueError(f"Kp={Kp} must be a multiple of {K_ALIGN}")
    n_ch = k_chunks(Kp)
    if part is not None:
        _check(part, "part", dev, 3)
        if n_ch == 1 or part.shape != (n_ch, rows, n0):
            raise ValueError(f"partials {tuple(part.shape)} do not fit {n_ch} chunks of "
                             f"({rows}, {n0})")
    return _launch_gemm(f_hi, f_lo, table_maps(t_hi, t_lo, head) if maps is None else maps,
                        out, part)


def _launch_gemm(f_hi, f_lo, maps, out, part=None):
    """One GEMM launch over checked operands (:func:`gemm_stage`), then,
    above :data:`SPLIT_K_MIN` with no caller's ``part``, the partial sum.
    Returns what was launched: the work items and persistent blocks, and
    the partial sum's blocks where it ran."""
    dev = out.device
    rows, Kp = f_hi.shape
    n0 = out.shape[1]
    keep = part is not None
    if not keep and k_chunks(Kp) > 1:
        part = torch.empty((k_chunks(Kp), rows, n0), dtype=torch.float32, device=dev)
    lib = _library()
    grid = (ctypes.c_longlong * 2)()
    with torch.cuda.device(dev):
        rc = lib.pgd_sweep_gemm(
            f_hi.data_ptr(), f_lo.data_ptr(), maps, out.data_ptr(),
            None if part is None else part.data_ptr(), rows, Kp, n0, K_CHUNK,
            int(out.dtype == torch.bfloat16), grid, _stream(dev),
        )
    _raise_on(rc, lib, "sweep GEMM")
    STAGE_LAUNCHES["gemm"] += 1
    launched = {"items": grid[0], "blocks": grid[1]}
    if part is not None and not keep:
        launched["partial_sum_blocks"] = partial_sum(part, out)
    return launched


def _check_tables(grid, tabs, n_modes):
    """The checks a bound CUDA sweep makes of its grid and tables."""
    dev = tabs.device
    _check(grid, "grid", dev, 2)
    _check(tabs, "tabs", dev, 3)
    NP, ndofp, K = tabs.shape
    if grid.shape != (4, NP) or not 1 <= NP <= _MAX_NP:
        raise ValueError(f"grid {tuple(grid.shape)} / tabs {tuple(tabs.shape)} do not "
                         f"match 1..{_MAX_NP} parameter dims")
    if ndofp < 2:
        raise ValueError(f"tables hold {ndofp} dofs per dim, need at least 2")
    if not 0 <= int(n_modes) <= K:
        raise ValueError(f"n_modes={n_modes} outside [0, {K}]")


def _check_operands(samples, grid, tabs, n_modes):
    """The checks :func:`fused_sweep` makes of a CUDA call's operands."""
    if samples.device.type != "cuda":
        raise ValueError(f"fused sweep runs on cuda or cpu, not {samples.device}")
    _check(samples, "samples", tabs.device, 2)
    if samples.shape[1] != tabs.shape[0]:
        raise ValueError(f"samples have {samples.shape[1]} parameter dims, "
                         f"tables {tabs.shape[0]}")
    _check_tables(grid, tabs, n_modes)


def _gemm_product(sweep, samples, bf16):
    """Fields on the card: over :func:`row_chunks` of the batch, the split
    factors of each chunk into one scratch pair, then the GEMM into the
    chunk's rows of the (B, n0) output.  Records each launch's grid in
    ``sweep.last_plan``."""
    dev = samples.device
    B, K = samples.shape[0], sweep.tabs.shape[2]
    t_hi, t_lo, head = sweep.table
    out = torch.empty((B, t_hi.shape[0]), dtype=torch.bfloat16 if bf16 else torch.float32,
                      device=dev)
    chunks = row_chunks(B, K, t_hi.shape[0])
    f_hi = torch.empty((chunks[0][1], padded_k(K)), dtype=torch.float32, device=dev)
    f_lo = torch.empty_like(f_hi)
    maps = sweep.gemm_maps()
    plan = sweep.last_plan = {"factor": [], "gemm": []}
    for r0, r1 in chunks:
        n = r1 - r0
        # one chunk takes the whole tensors: a view costs host time a call
        s_c, hi, lo, o = ((samples, f_hi, f_lo, out) if n == B else
                          (samples[r0:r1], f_hi[:n], f_lo[:n], out[r0:r1]))
        plan["factor"].append(_launch_factors(s_c, sweep.grid, sweep.tabs, sweep.n_modes,
                                              sweep.plan, sweep.sliced, hi, lo))
        plan["gemm"].append(_launch_gemm(hi, lo, maps, o))
    return out


def fused_sweep(samples, grid, tabs, m0, n_modes, out_dtype=None):
    """Run the sweep.

    samples (B, NP) float32; grid (4, NP) float32 from :func:`sweep_grid`;
    tabs (NP, ndofp, K) float32 from :func:`stack_tables`; m0 (K, n0)
    float32, or None for the factors (B, K); ``out_dtype`` float32 (None)
    or bfloat16 — only the store narrows.

    A CPU ``samples`` takes :func:`fused_sweep_plain`; a CUDA one launches
    the kernels (building them at first use) and raises on any failure.
    Binds the tables per call: :class:`FusedSweep` binds them once."""
    _check_dtype(m0, out_dtype)
    if samples.device.type == "cpu":
        return fused_sweep_plain(samples, grid, tabs, m0, n_modes, out_dtype)
    _check_operands(samples, grid, tabs, n_modes)
    return FusedSweep(grid, tabs, m0, n_modes, out_dtype)._run(samples)


def _check_dtype(m0, out_dtype):
    if out_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if m0 is None and out_dtype not in (None, torch.float32):
        raise ValueError("the factor output is float32")


class FusedSweep:
    """A sweep bound to one vademecum's tables on one device:
    ``sweep(samples (B, NP)) → (B, n0)`` (or the factors (B, K) when built
    with no dim-0 table).  On the card the factor kernel's plan and sliced
    tables are made once, here, with the sliced M0 of a narrow product
    (n0 ≤ :data:`SENSORS_MAX`) or the GEMM's split M0 table of a wider one,
    the modes in ``order`` (:func:`head_order`; None: their own), which
    the kernels' F columns follow; ``tabs`` and ``m0`` themselves, in
    their own order, serve the plain version on the CPU.  ``launches``
    counts this sweep's wiring calls that launched, as :data:`LAUNCHES`
    does across sweeps; ``last_plan`` holds what the last call that
    launched ran: each factor launch's grid and each GEMM launch's work
    items and blocks."""

    def __init__(self, grid, tabs, m0, n_modes, out_dtype=None):
        _check_dtype(m0, out_dtype)
        self.grid, self.tabs, self.m0 = grid, tabs, m0
        self.n_modes = int(n_modes)
        self.out_dtype = out_dtype
        self.launches = 0
        self.last_plan = None
        self.plan = self.sliced = self.m0_slices = self.table = self._maps = None
        self.order = None
        if tabs.device.type != "cuda":
            return
        _check_tables(grid, tabs, n_modes)
        NP, ndofp, K = tabs.shape
        n0 = 0
        if m0 is not None:
            _check(m0, "m0", tabs.device, 2)
            if m0.shape[0] != K:
                raise ValueError(f"m0 has {m0.shape[0]} rows, tables have K={K}")
            n0 = int(m0.shape[1])
        narrow = 0 < n0 <= SENSORS_MAX
        self.plan = factor_plan(NP, ndofp, n0 if narrow else 0)
        if m0 is not None:
            self.order = head_order(tabs, m0, self.n_modes)
            if self.order is not None:
                tabs, m0 = tabs[:, :, self.order], m0[self.order]
        self.sliced = slice_tables(tabs, self.plan.ks)
        if narrow:
            self.m0_slices = narrow_table(m0, self.n_modes, self.plan.ks)
        elif m0 is not None:
            self.table = split_table(m0, self.n_modes)

    def gemm_maps(self):
        """The GEMM's tensor maps of this sweep's table, encoded at the first
        field call (:func:`table_maps`)."""
        if self._maps is None:
            self._maps = table_maps(*self.table)
        return self._maps

    def __call__(self, samples):
        s = torch.as_tensor(samples).to(self.tabs.device, torch.float32).contiguous()
        if self.plan is None:
            return fused_sweep_plain(s, self.grid, self.tabs, self.m0, self.n_modes,
                                     self.out_dtype)
        _check_operands(s, self.grid, self.tabs, self.n_modes)
        return self._run(s)

    def _run(self, s):
        """The kernels on checked CUDA samples; each wiring call that
        launches counts in :data:`LAUNCHES`."""
        B = s.shape[0]
        bf16 = self.out_dtype == torch.bfloat16
        if self.m0 is None:
            out = torch.empty((B, self.tabs.shape[2]), dtype=torch.float32, device=s.device)
            wiring = "factors"
        elif self.m0_slices is not None:
            out = torch.empty((B, self.m0.shape[1]),
                              dtype=torch.bfloat16 if bf16 else torch.float32, device=s.device)
            wiring = "sensors"
        else:
            if B == 0:
                return torch.empty((0, self.m0.shape[1]),
                                   dtype=torch.bfloat16 if bf16 else torch.float32,
                                   device=s.device)
            out = _gemm_product(self, s, bf16)
            LAUNCHES["fields_bf16" if bf16 else "fields_f32"] += 1
            self.launches += 1
            return out
        if B:
            self.last_plan = {"factor": [_launch_factors(
                s, self.grid, self.tabs, self.n_modes, self.plan, self.sliced, out,
                m0_slices=self.m0_slices)]}
            LAUNCHES[wiring] += 1
            self.launches += 1
        return out


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
