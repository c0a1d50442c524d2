"""Build the package's CUDA kernels at first use and load them with ctypes.

The sources under `csrc/` have plain C interfaces (the header
`ffma_tile.cuh` holds the FFMA tiles two of them share): the three
ported kernels, `potf2.cu` (the card's f64 root Cholesky in LAPACK's
order), and `graph_while.cu`, the conditional graph nodes of the fused
loop (`ipm/control.py`).  One `nvcc` per
source, all started together, compiles them for Hopper (`sm_90a`); one
more links the objects into a shared library named by the content hash of
the sources and the header, `build/libpips_kernels_<hash>.so` beside this
file, with the compilers' register and shared-memory report (`-Xptxas -v`)
beside it as `.log`.  A build or load failure raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_HERE = Path(__file__).resolve().parent
_SOURCES = tuple(_HERE / "csrc" / name for name in
                 ("ldl_inverse.cu", "ell_spmm.cu", "sweep_inverse.cu",
                  "potf2.cu", "graph_while.cu"))
_HEADERS = (_HERE / "csrc" / "ffma_tile.cuh",)
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_DIR = _HERE / "build"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit to build")


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _SOURCES + _HEADERS:
        h.update(src.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return BUILD_DIR / f"libpips_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless the library for these sources exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _SOURCES]
    procs = []
    for src, obj in zip(_SOURCES, objs):
        cmd = [nvcc, *_FLAGS, "-c", "-o", str(obj), str(src)]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True)))
    # wait for every compile before judging any, so none is left running
    log = [(cmd, proc.communicate()[0], proc.returncode)
           for cmd, proc in procs]
    for cmd, text, rc in log:
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n"
                               f"{text}")
    tmp = BUILD_DIR / f"{tag}.so.tmp"
    cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    for obj in objs:
        obj.unlink()
    out.with_suffix(".log").write_text(
        "\n".join(f"$ {' '.join(cmd)}\n{text}" for cmd, text, _ in log))
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed, then load the library and declare its functions."""
    lib = ctypes.CDLL(str(build()))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    signatures = {
        "ldl_inverse_f32": [vp, vp, vp, vp, ci, ci, vp],
        "ldl_inverse_nb": [ci],
        "ldl_inverse_launches": [ci],
        "ell_spmm_f32": [vp] * 10 + [ci] * 5 + [vp],
        "ell_spmm_f64": [vp] * 10 + [ci] * 5 + [vp],
        "sweep_inverse_f32": [vp, vp, vp, vp, ci, ci, vp],
        "sweep_inverse_launches": [ci],
        "sweep_inverse_workspace": [ci],
        "potf2_f64": [vp, vp, vp, vp, ci, ci, vp],
        "potf2_launches": [ci],
        "potf2_nb": [],
        "graph_cond_prepare": [],
        "graph_cond_begin": [vp, vp, vp, ci, ci, ctypes.c_void_p],
        "graph_cond_end": [vp, ctypes.c_ulonglong, vp, ci, vp],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ci
    return lib
