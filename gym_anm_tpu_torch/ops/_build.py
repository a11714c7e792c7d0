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

# The fields of a team kernel's launch geometry, in the order its C
# function (tree_nr_geometry, nr_dense_geometry, step_fused_geometry,
# step_fused_tree_geometry) writes them.
GEOMETRY_FIELDS = ("threads_per_lane", "lanes_per_block", "threads_per_block", "smem_bytes_per_block", "blocks_per_sm")

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
    """Compile the sources, all in one ``nvcc`` call, if their library is
    missing.

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


def _check_step_layout(lib):
    """The fused-transition kernel's table and size slots must be those the
    wrapper packs (``step_cuda.FLOAT_TABLES``, ``INT_TABLES``, ``DIMS``,
    ``TREE_TABLES``, ``TREE_DIMS``)."""
    from .step_cuda import DIMS, FLOAT_TABLES, INT_TABLES, TREE_DIMS, TREE_TABLES

    sizes = [ctypes.c_int() for _ in range(5)]
    lib.step_fused_sizes(*(ctypes.byref(s) for s in sizes))
    if [s.value for s in sizes] != [len(FLOAT_TABLES), len(INT_TABLES), len(DIMS), len(TREE_TABLES), len(TREE_DIMS)]:
        raise RuntimeError("the fused-transition kernel's table layout differs from the wrapper's")


def load_library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use), with its C
    functions' argument and result types declared."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.tree_nr_solve_f32.argtypes = [
                vp, vp, vp, vp,  # p, q, th_w, vm_w (both null: cold start)
                vp, vp, vp, vp,  # ycols, par, children, levels
                ci, ci, ci, ci, cf, ci,  # S, maxC, n_levels, B, x_tol, max_iter
                vp, vp, vp, vp,  # v_re, v_im, diff, n_iter
                vp,  # counts [2]
                vp,  # stream
            ]
            lib.tree_nr_solve_f32.restype = ci
            lib.tree_nr_geometry.argtypes = [ci, ci, ci, ctypes.POINTER(ci)]  # S, maxC, n_levels, out[5]
            lib.tree_nr_geometry.restype = ci
            lib.nr_dense_solve_f32.argtypes = [
                vp, vp, vp, vp, vp,  # Y_re, Y_im, J0inv, p, q
                vp, vp,  # th_w, vm_w (both null: cold start)
                ci, ci, cf, ci, ci, ci,  # n, B, x_tol, max_iter, chord_iters, pivot
                vp, vp, vp, vp,  # v_re, v_im, diff, n_iter
                vp,  # stream
            ]
            lib.nr_dense_solve_f32.restype = ci
            lib.nr_dense_geometry.argtypes = [ci, ci, ctypes.POINTER(ci)]  # n, chord_iters, out[5]
            lib.nr_dense_geometry.restype = ci
            lib.step_fused_sizes.argtypes = [ctypes.POINTER(ci)] * 5
            lib.step_fused_sizes.restype = ci
            _check_step_layout(lib)
            lib.step_fused_f32.argtypes = [
                # host arrays: float-table pointers, int-table pointers, sizes
                ctypes.POINTER(vp), ctypes.POINTER(vp), ctypes.POINTER(ci),
                cf, cf,  # delta_t, delta_t * lamb
                vp, vp, ci,  # lanes_in, lanes_out, B
                cf, ci, ci, ci,  # x_tol, max_iter, chord_iters, pivot
                vp,  # counts [2]
                vp,  # stream
            ]
            lib.step_fused_f32.restype = ci
            lib.step_fused_geometry.argtypes = [ctypes.POINTER(ci), ci, ctypes.POINTER(ci)]  # dims, chord_iters, out[5]
            lib.step_fused_geometry.restype = ci
            lib.step_fused_tree_f32.argtypes = [
                # host arrays: float-table, int-table pointers, sizes, schedule pointers, schedule sizes
                ctypes.POINTER(vp), ctypes.POINTER(vp), ctypes.POINTER(ci), ctypes.POINTER(vp), ctypes.POINTER(ci),
                cf, cf,  # delta_t, delta_t * lamb
                vp, vp, ci,  # lanes_in, lanes_out, B
                cf, ci,  # x_tol, max_iter
                vp,  # counts [2]
                vp,  # stream
            ]
            lib.step_fused_tree_f32.restype = ci
            # dims, schedule sizes, out[5]
            lib.step_fused_tree_geometry.argtypes = [ctypes.POINTER(ci), ctypes.POINTER(ci), ctypes.POINTER(ci)]
            lib.step_fused_tree_geometry.restype = ci
            _lib = lib
    return _lib


def read_geometry(fn, *args) -> dict:
    """Call a kernel's geometry function (``fn(*args, out)``) and name its
    fields (:data:`GEOMETRY_FIELDS`); raises if the card refuses it."""
    out = (ctypes.c_int * len(GEOMETRY_FIELDS))()
    rc = fn(*args, out)
    if rc != 0:
        raise RuntimeError("launch geometry refused: CUDA error %d" % rc)
    return dict(zip(GEOMETRY_FIELDS, out))
