"""ctypes bindings for the native host helpers of ``csrc/pgdrome_native.cpp``
(counterpart of ``pgdrome_tpu/utils/native.py``).

Host work the reference leaves to DOLFIN's C++ core: a dense and a vector
scatter-add, the tridiagonal (Thomas) solve of the FD dims, and the
non-uniform FD operator builder.  The library is compiled from the shared
source at the root of the repository with ``g++ -O3 -fPIC -shared
-std=c++17`` on first use, into the port's git-ignored ``_build/`` (named by
a hash of the source and flags, so an edit never loads a stale library).
Every entry point has a numpy fallback, so nothing breaks without a
compiler; ``PGDROME_NATIVE=0`` turns the library off.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent  # pgdrome_tpu_torch/
SOURCE = _PKG.parent / "csrc" / "pgdrome_native.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_LIB = None
_TRIED = False


def _lib_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libpgdrome_native_{digest[:16]}.so"


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("PGDROME_NATIVE", "1") == "0" or not SOURCE.is_file():
        return None
    path = _lib_path()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # a per-process temporary name, renamed into place: concurrent
        # first uses never load a half-written library
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        try:
            subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, path)
        except (OSError, subprocess.SubprocessError):  # no g++, or the build failed
            tmp.unlink(missing_ok=True)
            return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None

    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.scatter_add_dense.argtypes = [f64p, ctypes.c_int64, i64p, i64p, f64p, ctypes.c_int64]
    lib.scatter_add_vector.argtypes = [f64p, i64p, f64p, ctypes.c_int64]
    lib.thomas_solve.argtypes = [f64p, f64p, f64p, f64p, f64p, ctypes.c_int64]
    lib.thomas_solve.restype = ctypes.c_int
    lib.fd_matrices.argtypes = [f64p, ctypes.c_int64, f64p, f64p, f64p]
    _LIB = lib
    return lib


def available() -> bool:
    """Whether the native library is loaded (built on first call)."""
    return _load() is not None


def scatter_add_dense(A: np.ndarray, rows, cols, vals) -> np.ndarray:
    """A[rows, cols] += vals (in place).  Native when available."""
    lib = _load()
    rows = np.ascontiguousarray(rows, dtype=np.int64).ravel()
    cols = np.ascontiguousarray(cols, dtype=np.int64).ravel()
    vals = np.ascontiguousarray(vals, dtype=np.float64).ravel()
    if lib is not None and A.flags["C_CONTIGUOUS"] and A.dtype == np.float64:
        lib.scatter_add_dense(A, A.shape[0], rows, cols, vals, len(vals))
        return A
    np.add.at(A, (rows, cols), vals)
    return A


def scatter_add_vector(b: np.ndarray, idx, vals) -> np.ndarray:
    """b[idx] += vals (in place).  Native when available."""
    lib = _load()
    idx = np.ascontiguousarray(idx, dtype=np.int64).ravel()
    vals = np.ascontiguousarray(vals, dtype=np.float64).ravel()
    if lib is not None and b.flags["C_CONTIGUOUS"] and b.dtype == np.float64:
        lib.scatter_add_vector(b, idx, vals, len(vals))
        return b
    np.add.at(b, idx, vals)
    return b


def thomas_solve(dl, d, du, b) -> np.ndarray:
    """Tridiagonal solve on the host: ``dl[i] = A[i, i−1]``, ``d`` the
    diagonal, ``du[i] = A[i, i+1]``.  Native Thomas when available, else
    the same recurrence in numpy."""
    dl = np.ascontiguousarray(dl, dtype=np.float64)
    d = np.ascontiguousarray(d, dtype=np.float64)
    du = np.ascontiguousarray(du, dtype=np.float64)
    b = np.ascontiguousarray(b, dtype=np.float64)
    n = len(d)
    lib = _load()
    if lib is not None:
        x = np.empty(n, dtype=np.float64)
        if lib.thomas_solve(dl, d, du, b, x, n) == 0:
            return x
    cp = np.empty(n)
    dp = np.empty(n)
    cp[0] = du[0] / d[0]
    dp[0] = b[0] / d[0]
    for i in range(1, n):
        m = d[i] - dl[i] * cp[i - 1]
        cp[i] = du[i] / m
        dp[i] = (b[i] - dl[i] * dp[i - 1]) / m
    x = np.empty(n)
    x[-1] = dp[-1]
    for i in range(n - 2, -1, -1):
        x[i] = dp[i] - cp[i] * x[i + 1]
    return x


def fd_matrices(xg) -> tuple:
    """(M, D2, D1_up) on the grid ``xg``, natively (the semantics of
    :func:`pgdrome_tpu_torch.ops.fd.FD_matrices`, its fallback)."""
    xg = np.ascontiguousarray(xg, dtype=np.float64).ravel()
    n = len(xg)
    lib = _load()
    if lib is None:
        from pgdrome_tpu_torch.ops.fd import FD_matrices

        return FD_matrices(xg)
    M = np.empty((n, n))
    D2 = np.empty((n, n))
    D1 = np.empty((n, n))
    lib.fd_matrices(xg, n, M, D2, D1)
    return M, D2, D1
