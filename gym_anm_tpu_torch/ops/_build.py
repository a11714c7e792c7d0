"""Build and load the port's CUDA kernels.

The sources are ``gym_anm_tpu_torch/csrc/*.cu`` (and any ``*.cuh`` they
include).  At first use, ``nvcc`` compiles them for Hopper (``sm_90a``) into
one shared library with a plain C interface under ``build/kernels/`` at the
repository root; the file name carries a hash of the sources and flags, so
an edited source is rebuilt and an unchanged one is loaded as is.  The
library is loaded with ``ctypes``.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
# --fmad=false: no multiply-add contraction, so each kernel operation
# rounds like the plain PyTorch version's separate elementwise ops and the
# two agree to the last bits on the same schedule.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib = None


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in _sources():
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / ("gym_anm_kernels_%s.so" % h.hexdigest()[:16])


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.access(nvcc, os.X_OK):
        raise RuntimeError("nvcc not found (looked on PATH and in /usr/local/cuda/bin)")
    return nvcc


def build() -> tuple[Path, str]:
    """Compile the sources if their library is missing.

    Returns ``(path, log)``; ``log`` is nvcc's output (``-Xptxas -v``
    reports registers, shared memory and spills per kernel), empty when the
    library was already built."""
    out = library_path()
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name("%s.%d.tmp" % (out.name, os.getpid()))
    cus = [str(f) for f in _sources() if f.suffix == ".cu"]
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *cus]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError("nvcc failed (%d): %s\n%s%s" % (res.returncode, " ".join(cmd), res.stdout, res.stderr))
    os.replace(tmp, out)
    return out, res.stdout + res.stderr


def load_library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use), with its C
    functions' argument and result types declared."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.tree_nr_scratch_planes.argtypes = []
            lib.tree_nr_scratch_planes.restype = ci
            lib.tree_nr_solve_f32.argtypes = [
                vp, vp, vp, vp, vp, vp,  # p, q, ycols, levels, run_ptr, runs
                ci, ci, ci, cf, ci,  # S, n_levels, B, x_tol, max_iter
                vp, vp, vp, vp, vp,  # scratch, v_re, v_im, diff, n_iter
                vp,  # stream
            ]
            lib.tree_nr_solve_f32.restype = ci
            _lib = lib
    return _lib
