"""ctypes loader for the native presolve scans, `csrc/presolve_kernels.cpp`.

Counterpart of the presolve half of `pips_ipmpp_tpu/native/__init__.py`
(its MPS reader waits for the port's MPS I/O).  The first call builds the
source with g++ and the JAX package's flags (without `-fopenmp` where the
compiler has no OpenMP runtime) into `build/` beside this file, as
`libpips_native_<hash>.so`, named by the content hash of the source, the
flags and the host CPU's feature flags, and loads it.  Every wrapper has
the JAX package's pure-Python formulation as its plain version: the
presolve passes use the library when it loads and that formulation
otherwise (`get_lib()` is None).  `build()` raises on a failed build;
`get_lib()` keeps the error in `build_error` and returns None.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_HERE = Path(__file__).resolve().parent
_SOURCE = _HERE / "csrc" / "presolve_kernels.cpp"
_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
          "-fopenmp", "-shared")
# a compiler without OpenMP's runtime builds the source serially: its one
# parallel loop (drop_tiny_impact) sums an integer count, so the results
# are the same
_SERIAL_FLAGS = tuple(f for f in _FLAGS if f != "-fopenmp")
BUILD_DIR = _HERE / "build"
ABI_VERSION = 2
build_error: Optional[str] = None


def _cpu_features() -> bytes:
    """The host CPU's feature flags: `-march=native` builds for them, so a
    library built on another CPU is not reused."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((ln for ln in f if ln.startswith(b"flags")), b"")
    except OSError:
        return b""


def library_path(flags=_FLAGS) -> Path:
    h = hashlib.sha256(_SOURCE.read_bytes())
    h.update(" ".join(flags).encode())
    h.update(_cpu_features())
    return BUILD_DIR / f"libpips_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless the one for this source exists: with
    the JAX package's flags, or without OpenMP where the compiler lacks
    its runtime."""
    for flags in (_FLAGS, _SERIAL_FLAGS):
        if library_path(flags).exists():
            return library_path(flags)
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native presolve scans need "
                           "a C++ compiler")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    errors = []
    for flags in (_FLAGS, _SERIAL_FLAGS):
        out = library_path(flags)
        tmp = BUILD_DIR / f"{out.stem}.{os.getpid()}.so.tmp"
        cmd = [cxx, *flags, "-o", str(tmp), str(_SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
        if proc.returncode == 0:
            os.replace(tmp, out)
            return out
        tmp.unlink(missing_ok=True)
        errors.append(f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    raise RuntimeError("g++ failed:\n" + "\n".join(errors))


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.pips_native_abi_version.restype = ctypes.c_int32
    if lib.pips_native_abi_version() != ABI_VERSION:
        raise RuntimeError(f"{lib._name}: ABI version "
                           f"{lib.pips_native_abi_version()}, expected "
                           f"{ABI_VERSION}")
    i64 = ctypes.c_int64
    f64 = ctypes.c_double
    p_f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.row_support_stats.argtypes = [p_f64, i64, i64, f64, p_i32, p_i64,
                                      p_f64]
    lib.drop_tiny_entries.restype = i64
    lib.drop_tiny_entries.argtypes = [p_f64, i64, i64, f64, f64]
    lib.drop_tiny_impact.restype = i64
    lib.drop_tiny_impact.argtypes = [p_f64, i64, i64, i64, p_f64, i64,
                                     f64, f64, f64]
    lib.detect_parallel_rows.restype = i64
    lib.detect_parallel_rows.argtypes = [p_f64, i64, i64, f64, p_i64, p_i64,
                                         p_f64, i64]
    lib.row_activity_bounds.argtypes = [p_f64, i64, i64, p_f64, p_f64,
                                        p_f64, p_f64]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library (built if needed), or None if it cannot be; a
    failure is not retried in this process."""
    global build_error
    if build_error is not None:
        return None
    try:
        return _load()
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        build_error = str(e)
        return None


def available() -> bool:
    return get_lib() is not None


# ---------------- typed wrappers (numpy in/out) ----------------

def row_support_stats(M: np.ndarray, tol: float = 0.0):
    """(nnz [int32], single_col [int64, -1 if not singleton], absmax)."""
    lib = get_lib()
    M = np.ascontiguousarray(M, np.float64)
    rows, cols = M.shape
    nnz = np.zeros(rows, np.int32)
    single = np.zeros(rows, np.int64)
    mx = np.zeros(rows, np.float64)
    if lib is None:
        a = np.abs(M)
        nz = a > tol
        nnz[:] = nz.sum(axis=1)
        mx[:] = a.max(axis=1) if cols else 0.0
        single[:] = -1
        srows = np.nonzero(nnz == 1)[0]
        for r in srows:
            single[r] = int(np.nonzero(nz[r])[0][0])
        return nnz, single, mx
    lib.row_support_stats(M, rows, cols, tol, nnz, single, mx)
    return nnz, single, mx


def drop_tiny_entries(M: np.ndarray, abs_tol: float, rel_tol: float) -> int:
    """In-place; returns dropped count. M must be float64 C-contiguous."""
    assert M.dtype == np.float64 and M.flags.c_contiguous
    lib = get_lib()
    if M.size == 0:
        return 0
    rows = M.shape[0]
    cols = int(np.prod(M.shape[1:]))
    if lib is None:
        flat = M.reshape(rows, cols)
        rowmax = np.max(np.abs(flat), axis=1, keepdims=True)
        mask = (np.abs(flat) > 0) & ((np.abs(flat) < abs_tol)
                                     | (np.abs(flat) < rel_tol * rowmax))
        flat[mask] = 0.0
        return int(mask.sum())
    return int(lib.drop_tiny_entries(M.reshape(rows, cols), rows, cols,
                                     abs_tol, rel_tol))


def drop_tiny_impact(M: np.ndarray, col_range: np.ndarray, feastol: float,
                     abs_tol: float, rel_tol: float) -> Optional[int]:
    """In-place impact-aware tiny-entry drop over M [rows, cols],
    [batch, rows, cols] (col_range [cols] shared) or [batch, rows, cols]
    with col_range [batch, cols].  Returns dropped count, or None when
    the native library is unavailable (caller falls back to numpy)."""
    lib = get_lib()
    if lib is None or M.size == 0:
        return None if lib is None else 0
    assert M.dtype == np.float64 and M.flags.c_contiguous
    cr = np.ascontiguousarray(col_range, np.float64)
    if M.ndim == 2:
        batch, rows, cols = 1, M.shape[0], M.shape[1]
        rb = 0
    else:
        batch, rows, cols = M.shape
        rb = 1 if cr.ndim == 2 else 0
    if cr.shape[-1] != cols:
        return None
    return int(lib.drop_tiny_impact(M.reshape(batch * rows, cols),
                                    batch, rows, cols, cr.reshape(-1),
                                    rb, feastol, abs_tol, rel_tol))


def detect_parallel_rows(M: np.ndarray, tol: float = 1e-12):
    """Exact parallel rows: (kept_idx, dup_idx, factors) with
    row[dup] = factor * row[kept]."""
    lib = get_lib()
    M = np.ascontiguousarray(M, np.float64)
    rows, cols = M.shape
    cap = max(rows, 1)
    kept = np.zeros(cap, np.int64)
    dup = np.zeros(cap, np.int64)
    fct = np.zeros(cap, np.float64)
    if lib is None:
        # group by the row normalised by its leading entry
        found = 0
        groups: dict = {}
        lead = np.zeros(rows)
        for r in range(rows):
            nz = np.nonzero(M[r])[0]
            if nz.size == 0:
                continue
            lead[r] = M[r, nz[0]]
            key = tuple(np.round(M[r] / lead[r], 12))
            groups.setdefault(key, []).append(r)
        for g in groups.values():
            for d in g[1:]:
                kept[found] = g[0]
                dup[found] = d
                fct[found] = lead[d] / lead[g[0]]
                found += 1
        return kept[:found], dup[:found], fct[:found]
    n = lib.detect_parallel_rows(M, rows, cols, tol, kept, dup, fct, cap)
    return kept[:n], dup[:n], fct[:n]


def row_activity_bounds(M: np.ndarray, lo: np.ndarray, up: np.ndarray):
    """Inf-aware per-row activity (min, max) given variable bounds."""
    lib = get_lib()
    M = np.ascontiguousarray(M, np.float64)
    lo = np.ascontiguousarray(lo, np.float64)
    up = np.ascontiguousarray(up, np.float64)
    rows = M.shape[0]
    mn = np.zeros(rows)
    mx = np.zeros(rows)
    if lib is None:
        with np.errstate(invalid="ignore"):
            cmin = np.where(M > 0, M * lo[None, :], M * up[None, :])
            cmax = np.where(M > 0, M * up[None, :], M * lo[None, :])
            mn[:] = np.where(M != 0, cmin, 0.0).sum(axis=1)
            mx[:] = np.where(M != 0, cmax, 0.0).sum(axis=1)
        return mn, mx
    lib.row_activity_bounds(M, rows, M.shape[1], lo, up, mn, mx)
    return mn, mx
