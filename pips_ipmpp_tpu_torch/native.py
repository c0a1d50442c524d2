"""ctypes loader for the native host code: the presolve scans,
`csrc/presolve_kernels.cpp`, and the MPS reader, `csrc/mps_reader.cpp`.

Counterpart of `pips_ipmpp_tpu/native/__init__.py`.  The first call
builds both sources into one library with g++ and the JAX package's
flags (without `-fopenmp` where the compiler has no OpenMP runtime) into
`build/` beside this file, as `libpips_native_<hash>.so`, named by the
content hash of the sources, the flags and the host CPU's feature flags,
and loads it.  Every presolve wrapper has the JAX package's pure-Python
formulation as its plain version, which the presolve passes take only on
a host without a C++ compiler (`get_lib()` is None, `build_error` says
why).  A source that fails to compile, or a library that fails to load,
raises from every wrapper, the presolve passes' too: a fault in one
source does not quietly move the other's passes to their plain versions.
`mps_parse` has no plain version: it raises with `build_error` where
there is no compiler (`io/mps.py` runs its Python parser only when
asked, `native=False`).  `build()` raises whatever fails.
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
_SOURCES = (_HERE / "csrc" / "presolve_kernels.cpp",
            _HERE / "csrc" / "mps_reader.cpp")
_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
          "-fopenmp", "-shared")
# a compiler without OpenMP's runtime builds the source serially: its one
# parallel loop (drop_tiny_impact) sums an integer count, so the results
# are the same
_SERIAL_FLAGS = tuple(f for f in _FLAGS if f != "-fopenmp")
BUILD_DIR = _HERE / "build"
ABI_VERSION = 3
build_error: Optional[str] = None


class CompilerMissing(RuntimeError):
    """No C++ compiler on the host: the presolve passes take their plain
    versions."""


def _cpu_features() -> bytes:
    """The host CPU's feature flags: `-march=native` builds for them, so a
    library built on another CPU is not reused."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((ln for ln in f if ln.startswith(b"flags")), b"")
    except OSError:
        return b""


def library_path(flags=_FLAGS) -> Path:
    h = hashlib.sha256()
    for src in _SOURCES:
        h.update(src.read_bytes())
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
        raise CompilerMissing("g++ not found: the native presolve scans "
                              "and the MPS reader need a C++ compiler")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    errors = []
    for flags in (_FLAGS, _SERIAL_FLAGS):
        out = library_path(flags)
        tmp = BUILD_DIR / f"{out.stem}.{os.getpid()}.so.tmp"
        cmd = [cxx, *flags, "-o", str(tmp), *map(str, _SOURCES)]
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

    vp = ctypes.c_void_p
    cp = ctypes.c_char_p
    p_i8 = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    p_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.mps_open.restype = vp
    lib.mps_open.argtypes = [cp, ctypes.c_int32]
    lib.mps_error.restype = cp
    lib.mps_error.argtypes = [vp]
    for fn in ("mps_n_rows", "mps_n_cols", "mps_nnz", "mps_n_free_rows",
               "mps_n_bad_ranges"):
        getattr(lib, fn).restype = i64
        getattr(lib, fn).argtypes = [vp]
    lib.mps_maximize.restype = ctypes.c_int32
    lib.mps_maximize.argtypes = [vp]
    lib.mps_obj_constant.restype = f64
    lib.mps_obj_constant.argtypes = [vp]
    lib.mps_fill.argtypes = [vp, p_i8, p_f64, p_u8, p_f64, p_i64, p_i64,
                             p_f64, p_f64, p_f64, p_f64]
    for fn in ("mps_row_name", "mps_col_name", "mps_free_row_name"):
        getattr(lib, fn).restype = cp
        getattr(lib, fn).argtypes = [vp, i64]
    lib.mps_problem_name.restype = cp
    lib.mps_problem_name.argtypes = [vp]
    lib.mps_close.argtypes = [vp]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library (built if needed), or None on a host without a
    C++ compiler (not retried in this process); a failed build or load
    raises."""
    global build_error
    if build_error is not None:
        return None
    try:
        return _load()
    except CompilerMissing as e:
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


def mps_parse(path: str, fixed: bool = False) -> dict:
    """Native MPS parse -> dict of arrays (the JAX package's
    `native.mps_parse`).  Raises RuntimeError with `build_error` when the
    library cannot be built, and ValueError on a malformed file (as the
    Python parser does)."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"native MPS reader unavailable: {build_error}")
    h = lib.mps_open(path.encode(), 1 if fixed else 0)
    if not h:
        raise ValueError(f"MPS parse failed: {path}")
    try:
        err = lib.mps_error(h)
        if err:
            raise ValueError(f"MPS parse failed: {err.decode()}")
        m = lib.mps_n_rows(h)
        n = lib.mps_n_cols(h)
        nnz = lib.mps_nnz(h)
        row_types = np.zeros(max(m, 1), np.int8)
        rhs = np.zeros(max(m, 1), np.float64)
        has_rng = np.zeros(max(m, 1), np.uint8)
        rng = np.zeros(max(m, 1), np.float64)
        coo_r = np.zeros(max(nnz, 1), np.int64)
        coo_c = np.zeros(max(nnz, 1), np.int64)
        coo_v = np.zeros(max(nnz, 1), np.float64)
        obj = np.zeros(max(n, 1), np.float64)
        lo = np.zeros(max(n, 1), np.float64)
        up = np.zeros(max(n, 1), np.float64)
        lib.mps_fill(h, row_types, rhs, has_rng, rng, coo_r, coo_c, coo_v,
                     obj, lo, up)
        return dict(
            name=lib.mps_problem_name(h).decode(),
            maximize=bool(lib.mps_maximize(h)),
            obj_constant=float(lib.mps_obj_constant(h)),
            row_types=row_types[:m], rhs=rhs[:m],
            has_rng=has_rng[:m].astype(bool), rng=rng[:m],
            coo_r=coo_r[:nnz], coo_c=coo_c[:nnz], coo_v=coo_v[:nnz],
            obj=obj[:n], lo=lo[:n], up=up[:n],
            row_names=[lib.mps_row_name(h, i).decode() for i in range(m)],
            objective_row=lib.mps_row_name(h, m).decode(),
            col_names=[lib.mps_col_name(h, j).decode() for j in range(n)],
            free_rows=sorted(
                lib.mps_free_row_name(h, i).decode()
                for i in range(lib.mps_n_free_rows(h))),
            n_bad_ranges=int(lib.mps_n_bad_ranges(h)),
        )
    finally:
        lib.mps_close(h)
