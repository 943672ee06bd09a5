"""Single-source BFS levels (kernel K4) — the shortestPath workhorse.

falkordb_tpu runs this as a jitted while_loop (algos/bfs.py:_bfs_jit): one
gather of the frontier per edge of the transpose CSR and a sorted segment
max per destination, each level, until no node is new or `max_depth` is
reached.  Here CUDA tensors launch csrc/bfs_levels.cu, a pull kernel per
level driven by a host loop, and CPU tensors run `bfs_levels_plain`.

The parents variant, the multi-source and packed families and the
direction-optimising host BFS wait for ROADMAP.md module 7."""

from __future__ import annotations

import ctypes

import torch

from falkordb_tpu_torch.native import cuda as _cuda
from falkordb_tpu_torch.sparse.csr import CSR

UNREACHED = 2**30


def bfs_levels(at_csr: CSR, src: int, max_depth=None) -> torch.Tensor:
    """BFS levels from src, as an (n,) int32 tensor on the CSR's device:
    0 at src, the hop count at each reached node and UNREACHED elsewhere.
    `at_csr` must be the TRANSPOSE adjacency (rows = destinations).  The
    first level always runs, even with max_depth 0; src < 0 reaches
    nothing."""
    n = at_csr.n_rows
    dev = at_csr.device
    if src < 0:
        return torch.full((n,), UNREACHED, dtype=torch.int32, device=dev)
    if not _cuda.on_cuda(at_csr.indptr, at_csr.cols, at_csr.nnz):
        return bfs_levels_plain(at_csr.indptr, at_csr.rows, at_csr.cols,
                                at_csr.nnz, n, src, max_depth)
    _cuda.check_input("bfs_levels", "indptr", at_csr.indptr, torch.int32,
                      n + 1)
    _cuda.check_input("bfs_levels", "cols", at_csr.cols, torch.int32)
    levels = torch.empty(n, dtype=torch.int32, device=dev)
    flag = torch.empty(1, dtype=torch.int32, device=dev)
    n_levels = ctypes.c_int64(0)
    p = _cuda.ptr
    rc = _cuda.lib().fk_bfs_levels(
        p(at_csr.indptr), p(at_csr.cols), p(at_csr.nnz), n, int(src),
        -1 if max_depth is None else max(int(max_depth), 0), p(levels),
        p(flag), ctypes.byref(n_levels), _cuda.stream_ptr(levels))
    _cuda.check(rc, "bfs_levels")
    _cuda.count_launch("bfs_levels")
    return levels


def bfs_levels_plain(indptr, rows, cols, nnz, n: int, src: int,
                     max_depth=None) -> torch.Tensor:
    """Plain PyTorch version of `bfs_levels`: falkordb_tpu's level loop
    (gather the frontier per edge, mark each unreached destination of a
    frontier edge) with the same stopping rule."""
    dev = cols.device
    valid = torch.arange(cols.shape[0], device=dev) < nnz
    src_of = cols.to(torch.int64).clamp(0, max(n - 1, 0))
    dst_of = rows.to(torch.int64)
    levels = torch.full((n,), UNREACHED, dtype=torch.int32, device=dev)
    frontier = torch.zeros(n, dtype=torch.bool, device=dev)
    if src < n:  # an id past the end reaches nothing, as in a dropped scatter
        levels[src] = 0
        frontier[src] = True
    depth = 0
    while True:
        hit = valid & frontier[src_of]
        nxt = torch.zeros(n, dtype=torch.bool, device=dev)
        nxt[dst_of[hit]] = True
        nxt &= levels == UNREACHED
        levels[nxt] = depth + 1
        depth += 1
        if not bool(nxt.any()):
            break
        if max_depth is not None and depth >= max_depth:
            break
        frontier = nxt
    return levels
