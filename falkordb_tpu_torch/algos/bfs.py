"""Single-source BFS: levels (kernel K4) — the shortestPath workhorse —
and levels with parents (kernel K8) — algo.BFS's device path.

falkordb_tpu runs these as jitted while_loops (algos/bfs.py:_bfs_jit and
_bfs_parents_jit): one gather of the frontier per edge of the transpose CSR
and a sorted segment max (levels) or min (parents) per destination, each
level, until no node is new.  Here CUDA tensors launch csrc/bfs_levels.cu
and csrc/bfs_parents.cu, a pull kernel per level driven by a host loop, and
CPU tensors run `bfs_levels_plain` and `bfs_parents_plain`.

The multi-source and packed families wait for ROADMAP.md modules 7-8; the
direction-optimising host BFS is native/bfsnative.cpp."""

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


def bfs_levels_parents(a_csr_or_at, src: int, max_depth=None):
    """Levels and parents from src, each an (n,) int32 tensor on the CSR's
    device.  Takes the FORWARD CSR (and builds its transpose) or, given
    anything else, the transpose itself.  The parent of a node is the least
    id among its in-neighbours one level up; parents[src] = src and -1
    where unreached; levels are UNREACHED there.  The BFS runs to the
    fixpoint; max_depth then masks deeper levels and leaves parents as they
    are."""
    at = a_csr_or_at.transpose_host() if isinstance(a_csr_or_at, CSR) \
        else a_csr_or_at
    n, dev = at.n_rows, at.device
    if src < 0:
        return (torch.full((n,), UNREACHED, dtype=torch.int32, device=dev),
                torch.full((n,), -1, dtype=torch.int32, device=dev))
    levels, parents = bfs_parents(at, src)
    if max_depth is not None:
        levels = torch.where(levels > max_depth,
                             torch.full_like(levels, UNREACHED), levels)
    return levels, parents


def bfs_parents(at_csr: CSR, src: int):
    """(levels, parents) from 0 <= src over the TRANSPOSE adjacency, to the
    fixpoint."""
    n = at_csr.n_rows
    dev = at_csr.device
    if not _cuda.on_cuda(at_csr.indptr, at_csr.cols, at_csr.nnz):
        return bfs_parents_plain(at_csr.indptr, at_csr.rows, at_csr.cols,
                                 at_csr.nnz, n, src)
    _cuda.check_input("bfs_parents", "indptr", at_csr.indptr, torch.int32,
                      n + 1)
    _cuda.check_input("bfs_parents", "cols", at_csr.cols, torch.int32)
    levels = torch.empty(n, dtype=torch.int32, device=dev)
    parents = torch.empty(n, dtype=torch.int32, device=dev)
    flag = torch.empty(1, dtype=torch.int32, device=dev)
    n_levels = ctypes.c_int64(0)
    p = _cuda.ptr
    rc = _cuda.lib().fk_bfs_parents(
        p(at_csr.indptr), p(at_csr.cols), p(at_csr.nnz), n, int(src),
        p(levels), p(parents), p(flag), ctypes.byref(n_levels),
        _cuda.stream_ptr(levels))
    _cuda.check(rc, "bfs_parents")
    _cuda.count_launch("bfs_parents")
    return levels, parents


def bfs_parents_plain(indptr, rows, cols, nnz, n: int, src: int):
    """Plain PyTorch version of `bfs_parents`: the reference's level step
    (frontier gather per edge, least frontier source per destination)."""
    dev = cols.device
    valid = torch.arange(cols.shape[0], device=dev) < nnz
    cols64 = cols.to(torch.int64)
    src_of = cols64.clamp(0, max(n - 1, 0))
    dst_of = rows.to(torch.int64)
    big = torch.full((), UNREACHED, dtype=torch.int64, device=dev)
    levels = torch.full((n,), UNREACHED, dtype=torch.int32, device=dev)
    parents = torch.full((n,), -1, dtype=torch.int32, device=dev)
    frontier = torch.zeros(n, dtype=torch.bool, device=dev)
    if src < n:  # an id past the end sets nothing, as a dropped scatter
        levels[src] = 0
        parents[src] = src
        frontier[src] = True
    depth = 0
    while True:
        cand = torch.where(valid & frontier[src_of], cols64, big)
        best = torch.full((n,), UNREACHED, dtype=torch.int64,
                          device=dev).scatter_reduce_(0, dst_of, cand, "amin")
        fresh = (best < UNREACHED) & (levels == UNREACHED)
        levels[fresh] = depth + 1
        parents[fresh] = best[fresh].to(torch.int32)
        depth += 1
        if not bool(fresh.any()):
            return levels, parents
        frontier = fresh
