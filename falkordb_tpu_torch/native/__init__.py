"""Native (C++) runtime components, loaded via ctypes.

The reference's runtime core is native (Rust + C GraphBLAS); here the
CUDA kernels under falkordb_tpu_torch/csrc are the device compute path
(built and bound by native/cuda.py), and this module supplies native
implementations of the host-side hot spots around them: fast CSR
construction (radix sort + indptr assembly), the commit-path / bulk-load
bottleneck, and the direction-optimizing single-source BFS that algo.BFS
takes first (bfsnative.cpp).  Compiled lazily with g++ -O3 on first use;
without a toolchain CSR builds fall back to numpy and algo.BFS to its
kernel (K8), as in falkordb_tpu."""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_lock = threading.Lock()
_libs: dict = {}  # stem -> CDLL | None (None = tried and failed)


def _compile_load(stem, extra_flags=()):
    """Lazily g++-compile <stem>.cpp to _<stem>.so and dlopen it.
    Returns None (cached) when no toolchain / compile failure."""
    if stem in _libs:
        return _libs[stem]
    with _lock:
        if stem in _libs:
            return _libs[stem]
        so = os.path.join(_HERE, f"_{stem}.so")
        src = os.path.join(_HERE, f"{stem}.cpp")
        try:
            if (not os.path.exists(so)
                    or os.path.getmtime(so) < os.path.getmtime(src)):
                # build beside, then rename: a process that loads the
                # library meanwhile never sees a half-written file
                tmp = f"{so}.{os.getpid()}.tmp"
                subprocess.run(
                    ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                     *extra_flags, "-o", tmp, src],
                    check=True, capture_output=True, timeout=120)
                os.replace(tmp, so)
            _libs[stem] = ctypes.CDLL(so)
        except Exception:  # noqa: BLE001 — no toolchain → numpy fallback
            _libs[stem] = None
    return _libs[stem]


def _load():
    lib = _compile_load("csrbuild")
    if lib is not None and not hasattr(lib, "_sig_done"):
        lib.build_csr_i32.restype = ctypes.c_int
        lib.build_csr_i32.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
        ]
        lib._sig_done = True
    return lib


def available() -> bool:
    return _load() is not None


def build_csr_native(rows: np.ndarray, cols: np.ndarray, vals, n_rows: int):
    """Sort (rows, cols[, vals]) by (row, col) and build indptr.
    Returns (rows_i32, cols_i32, vals_i32|None, indptr_i32) or None if the
    native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    nnz = len(rows)
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    rows_out = np.empty(nnz, dtype=np.int32)
    cols_out = np.empty(nnz, dtype=np.int32)
    indptr = np.empty(n_rows + 1, dtype=np.int32)
    if vals is not None:
        vals = np.ascontiguousarray(vals, dtype=np.int32)
        vals_out = np.empty(nnz, dtype=np.int32)
        vp = vals.ctypes.data_as(ctypes.c_void_p)
        vop = vals_out.ctypes.data_as(ctypes.c_void_p)
    else:
        vals_out = None
        vp = None
        vop = None
    rc = lib.build_csr_i32(
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        vp, nnz, n_rows,
        rows_out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        cols_out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        vop,
        indptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc != 0:
        return None
    return rows_out, cols_out, vals_out, indptr


def _load_bfs():
    lib = _compile_load("bfsnative", extra_flags=("-fopenmp",))
    if lib is None:
        # some toolchains lack libgomp; retry serial (drop the cached miss)
        with _lock:
            _libs.pop("bfsnative", None)
        lib = _compile_load("bfsnative")
    if lib is not None and not hasattr(lib, "_sig_done"):
        lib.bfs_single_diropt.restype = ctypes.c_int64
        lib.bfs_single_diropt.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib._sig_done = True
    return lib


def bfs_available() -> bool:
    return _load_bfs() is not None


def bfs_single_native(fwd_indptr, fwd_cols, rev_indptr, rev_cols, root,
                      alpha=15, beta=24):
    """Direction-optimizing single-source BFS (bfsnative.cpp).

    Returns (depth int32[n] with -1 unreached, n_levels) or None when the
    native library is unavailable."""
    lib = _load_bfs()
    if lib is None:
        return None
    fwd_indptr = np.ascontiguousarray(fwd_indptr, dtype=np.int64)
    rev_indptr = np.ascontiguousarray(rev_indptr, dtype=np.int64)
    fwd_cols = np.ascontiguousarray(fwd_cols, dtype=np.int32)
    rev_cols = np.ascontiguousarray(rev_cols, dtype=np.int32)
    n = len(fwd_indptr) - 1
    depth = np.empty(n, dtype=np.int32)
    levels = lib.bfs_single_diropt(
        fwd_indptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        fwd_cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        rev_indptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        rev_cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n, int(root), int(alpha), int(beta),
        depth.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if levels < 0:
        return None
    return depth, int(levels)
