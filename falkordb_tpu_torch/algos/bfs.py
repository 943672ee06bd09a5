"""BFS on the card: single-source levels (kernel K4), the shortestPath
workhorse; levels with parents (K8), algo.BFS's device path; k-lane
multi-source levels over the transpose CSR (K16), behind harmonic
centrality and bench_port.py's stepped mode; and the blocked-ELL
bit-packed family (K9, K10, K17, K12), behind bench_port.py's packed mode.

falkordb_tpu runs these as jitted functions (algos/bfs.py: _bfs_jit,
_bfs_parents_jit, _bfs_multi_jit and _bfs_level_step, the ELL level
functions); here CUDA tensors launch the hand-written kernels under csrc/
(bfs_levels.cu, bfs_parents.cu, multi_bfs.cu, packed_levels.cu, and
bfs_packed.py's K9, K10 and K12), each level driven by a host loop that
reads one flag, and CPU tensors run the plain versions beside the wrappers
(`*_plain`).  The gated batched BFS is bfs_packed.py; the
direction-optimising host BFS is native/bfsnative.cpp."""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from falkordb_tpu_torch.algos.bfs_packed import (
    PackedChunk, chunk_reach, packed_counts, packed_epilogue, sparse_reach,
)
from falkordb_tpu_torch.native import cuda as _cuda
from falkordb_tpu_torch.sparse.csr import CSR
from falkordb_tpu_torch.sparse.ell import as_tensor, ell_device

UNREACHED = 2**30
UNREACHED8 = 127  # the int8 levels' UNREACHED (bfs_multi_ell_sorted)
# K16 hands rows with more in-edges than this to its block-per-row kernel
WIDE_ROW = 1024


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


# -- k-lane multi-source BFS over the transpose CSR (K16) -----------------------


def _roots(sources, n: int, dev):
    """(rows, lanes) int64 of the roots that the reference's scatter keeps:
    negative ids count from the end, ids past either end set nothing."""
    s = torch.as_tensor(np.asarray(sources, dtype=np.int64).reshape(-1),
                        device=dev)
    lanes = torch.arange(s.numel(), device=dev)
    s = torch.where(s < 0, s + n, s)
    keep = (s >= 0) & (s < n)
    return s[keep], lanes[keep]


@dataclasses.dataclass
class MultiBfsState:
    """The state of a k-lane BFS between levels.  On the card (K16):
    `frontier`, `spare` and `visited` are (n, ceil(k/32)) int32 words, lane
    l being bit l % 32 of word l // 32, and `levels` (or None) is (n, k)
    int32; `hsum`, when kept, (n, ceil(k/32)) float64 sums of 1/level per
    word (harmonic centrality).  On the CPU (the plain version) `frontier`
    is the reference's (n, k) int8 frontier and `levels` (n, k) int32.
    `lanes()` gives the frontier in the reference's layout either way."""
    k: int
    frontier: torch.Tensor
    levels: torch.Tensor | None
    spare: torch.Tensor | None = None
    visited: torch.Tensor | None = None
    hsum: torch.Tensor | None = None
    flag: torch.Tensor | None = None
    wide: torch.Tensor | None = None  # rows of > WIDE_ROW edges (card only)
    depth: int = 0  # levels run since the roots were set
    alive: bool = True  # the last level found a fresh lane

    def lanes(self) -> torch.Tensor:
        """The frontier as (n, k) int8 lanes, 1 where a lane is fresh."""
        if self.visited is None:
            return self.frontier
        shifts = torch.arange(32, dtype=torch.int32,
                              device=self.frontier.device)
        bits = (self.frontier[:, :, None] >> shifts) & 1
        return bits.reshape(self.frontier.shape[0], -1)[:, :self.k].to(
            torch.int8)


def _pack_lanes(bits: torch.Tensor) -> torch.Tensor:
    """(n, k) bool lanes as (n, ceil(k/32)) int32 words, K16's layout."""
    n, k = bits.shape
    kw = (k + 31) // 32
    b = torch.zeros((n, kw * 32), dtype=torch.int64, device=bits.device)
    b[:, :k] = bits.to(torch.int64)
    w = (b.view(n, kw, 32) << torch.arange(32, device=bits.device)).sum(2)
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


def multi_bfs_state(at_csr: CSR, k: int, levels: bool = True,
                    hsum: bool = False) -> MultiBfsState:
    """An empty k-lane state on the CSR's device; the first
    `multi_bfs_level` call sets its roots.  hsum (the card only) keeps
    harmonic sums instead of, or beside, the levels."""
    n, dev = at_csr.n_rows, at_csr.device
    if dev.type == "cpu":
        return _plain_state(n, k, dev)
    kw = (k + 31) // 32
    i32 = dict(dtype=torch.int32, device=dev)
    return MultiBfsState(
        k, torch.empty((n, kw), **i32),
        torch.empty((n, k), **i32) if levels else None,
        spare=torch.empty((n, kw), **i32), visited=torch.empty((n, kw), **i32),
        hsum=torch.zeros((n, kw), dtype=torch.float64, device=dev)
        if hsum else None, flag=torch.empty(1, **i32))


def wide_rows(at_csr: CSR) -> torch.Tensor:
    """(rows,) int32 ids of the rows with more than WIDE_ROW edges before
    nnz, on the CSR's device."""
    ip = at_csr.indptr.to(torch.int64)
    deg = ip[1:].clamp(max=at_csr.nnz.to(torch.int64)) - ip[:-1]
    return torch.nonzero(deg > WIDE_ROW).flatten().to(torch.int32)


def multi_bfs_state_at(at_csr: CSR, levels: torch.Tensor,
                       frontier: torch.Tensor, depth: int) -> MultiBfsState:
    """A k-lane state on the CSR's device after `depth` levels, from the
    reference's layout: (n, k) int32 levels and (n, k) int8 frontier (both
    copied); the next `multi_bfs_level` call runs level depth + 1."""
    n, k = levels.shape
    if at_csr.device.type == "cpu":
        return MultiBfsState(k, frontier.clone(), levels.clone(), depth=depth)
    st = multi_bfs_state(at_csr, k)
    st.frontier.copy_(_pack_lanes(frontier > 0))
    st.visited.copy_(_pack_lanes(levels != UNREACHED))
    st.levels.copy_(levels)
    st.wide = wide_rows(at_csr)
    st.depth = depth
    return st


def multi_bfs_level(at_csr: CSR, st: MultiBfsState, max_depth=None,
                    steps: int | None = 1, seeds=None) -> MultiBfsState:
    """K16: run up to `steps` levels (None: to the end) of the k-lane BFS
    over the TRANSPOSE adjacency, each level OR-ing the in-neighbours'
    frontier lanes and giving each fresh lane depth + 1.  It stops at the
    first level with no fresh lane, or once the depth reaches max_depth (the
    first level always runs).  `seeds` ((k,) ids) first resets the state to
    those roots, in the same launch."""
    n = at_csr.n_rows
    if not _cuda.on_cuda(at_csr.indptr, at_csr.cols, at_csr.nnz, st.frontier):
        return _multi_bfs_plain_levels(at_csr, st, max_depth, steps, seeds)
    _cuda.check_input("multi_bfs", "indptr", at_csr.indptr, torch.int32,
                      n + 1)
    _cuda.check_input("multi_bfs", "cols", at_csr.cols, torch.int32)
    srcs = None
    if seeds is not None:
        srcs = torch.as_tensor(seeds, dtype=torch.int32,
                               device=st.frontier.device).contiguous()
        _cuda.check_input("multi_bfs", "seeds", srcs, torch.int32, st.k)
        st.depth = 0
    n_levels, alive = ctypes.c_int64(0), ctypes.c_int32(0)
    p = _cuda.ptr
    if st.wide is None:
        st.wide = wide_rows(at_csr)
    rc = _cuda.lib().fk_multi_bfs(
        p(at_csr.indptr), p(at_csr.cols), p(at_csr.nnz), n, st.k, p(st.wide),
        st.wide.numel(), WIDE_ROW, p(srcs),
        p(st.frontier), p(st.spare), p(st.visited), p(st.levels), p(st.hsum),
        st.depth, -1 if steps is None else steps,
        -1 if max_depth is None else max(int(max_depth), 0), p(st.flag),
        ctypes.byref(n_levels), ctypes.byref(alive),
        _cuda.stream_ptr(st.frontier))
    _cuda.check(rc, "multi_bfs")
    _cuda.count_launch("multi_bfs")
    if n_levels.value % 2:  # the buffers swap each level
        st.frontier, st.spare = st.spare, st.frontier
    st.depth += n_levels.value
    st.alive = bool(alive.value)
    return st


def _plain_state(n, k, dev):
    return MultiBfsState(k, torch.zeros((n, k), dtype=torch.int8, device=dev),
                         torch.full((n, k), UNREACHED, dtype=torch.int32,
                                    device=dev))


def _multi_bfs_plain_levels(at, st, max_depth, steps, seeds):
    n = at.n_rows
    if seeds is not None:
        st.frontier.zero_()
        st.levels.fill_(UNREACHED)
        rows, lanes = _roots(seeds, n, st.frontier.device)
        st.frontier[rows, lanes] = 1
        st.levels[rows, lanes] = 0
        st.depth = 0
    run = 0
    while True:
        st.levels, st.frontier, any_fresh = multi_bfs_level_plain(
            at.rows, at.cols, at.nnz, n, st.frontier, st.levels, st.depth)
        st.depth += 1
        run += 1
        st.alive = bool(any_fresh)
        if not st.alive or (max_depth is not None and st.depth >= max_depth) \
                or (steps is not None and run >= steps):
            return st


def multi_bfs_level_plain(rows, cols, nnz, n: int, frontier, levels,
                          depth: int, block_elems: int = 1 << 26):
    """Plain PyTorch version of one K16 level: falkordb_tpu's
    `_bfs_level_step` on the reference's layout.  Gathers the (n, k) int8
    frontier rows by cols (clipped to [0, n-1]) for the edges before nnz,
    takes the segment max per destination row (as a count of hits, in edge
    blocks of about `block_elems` lanes) and returns (levels, next frontier
    (n, k) int8, any fresh lane as a bool tensor)."""
    dev = cols.device
    k = frontier.shape[1]
    hits = torch.zeros((n, k), dtype=torch.int32, device=dev)
    m = min(int(nnz), cols.shape[0]) if n else 0
    step = max(1, block_elems // max(k, 1))
    for lo in range(0, m, step):
        hi = min(lo + step, m)
        C = frontier[cols[lo:hi].to(torch.int64).clamp(0, n - 1)]
        hits.index_add_(0, rows[lo:hi].to(torch.int64), C.to(torch.int32))
    fresh = (hits > 0) & (levels == UNREACHED)
    levels = torch.where(fresh, torch.full_like(levels, depth + 1), levels)
    return levels, fresh.to(torch.int8), fresh.any()


def bfs_multi_plain(at_csr: CSR, sources, max_depth=None) -> torch.Tensor:
    """Plain PyTorch version of bfs_multi on the CSR's device: the
    reference's level loop on its (n, k) int8 frontier."""
    srcs = np.asarray(sources, dtype=np.int32).reshape(-1)
    st = _plain_state(at_csr.n_rows, len(srcs), at_csr.device)
    return _multi_bfs_plain_levels(at_csr, st, max_depth, None, srcs).levels


def bfs_multi(at_csr: CSR, sources, max_depth=None) -> torch.Tensor:
    """Batched BFS from `sources` (node ids, one lane each) over the
    TRANSPOSE CSR: (n, k) int32 levels on the CSR's device, 0 at each
    lane's root and UNREACHED where a lane does not reach.  One K16 call
    runs every level."""
    srcs = np.asarray(sources, dtype=np.int32).reshape(-1)
    st = multi_bfs_state(at_csr, len(srcs))
    return multi_bfs_level(at_csr, st, max_depth, steps=None,
                           seeds=srcs).levels


def bfs_multi_stepped(at_csr: CSR, sources, max_depth=None) -> torch.Tensor:
    """bfs_multi with the level loop on the host, one K16 call a level, as
    falkordb_tpu's bfs_multi_stepped; the same levels."""
    srcs = np.asarray(sources, dtype=np.int32).reshape(-1)
    st = multi_bfs_state(at_csr, len(srcs))
    multi_bfs_level(at_csr, st, max_depth, seeds=srcs)
    while st.alive and (max_depth is None or st.depth < max_depth):
        multi_bfs_level(at_csr, st, max_depth)
    return st.levels


# -- the blocked-ELL bit-packed family (K9, K10, K17, K12) ------------------------
#
# Frontier, visited and reach are (n+1, W) int32 words, 32 lanes a word; row
# n is the all-zero row that the sentinel column n gathers.  One level is
# reach = OR of the in-neighbours' frontier words (K9, per bucket), fresh =
# reach & ~visited, visited |= fresh, frontier = fresh (K10, with no chunk
# to gate), then, for the forms that keep per-lane levels, the fresh bits
# into levels (K17).  reach is zeroed once a call: each level rewrites
# every row a bucket covers, and the others stay 0.


def packed_init(n: int, sources, dev, levels_dtype=None):
    """falkordb_tpu's `_packed_init` on `dev`: W words a row, visited and
    frontier (n+1, W) int32 with each lane's root bit (frontier row n
    zero), and levels (n, k) of `levels_dtype` (None: none) at UNREACHED but
    0 at the roots.  Roots must lie in [0, n)."""
    k = len(sources)
    W = (k + 31) // 32
    srcs = np.asarray([int(s) for s in sources], dtype=np.int64)
    if k and not ((srcs >= 0) & (srcs < n)).all():
        raise ValueError(f"BFS roots must lie in [0, {n})")
    lanes = np.arange(k)
    idx = srcs * W + lanes // 32
    masks = np.left_shift(np.uint32(1), (lanes % 32).astype(np.uint32))
    words, inv = np.unique(idx, return_inverse=True)
    ored = np.zeros(len(words), np.uint32)
    np.bitwise_or.at(ored, inv, masks)  # lanes of one word own distinct bits
    visited = torch.zeros((n + 1) * W, dtype=torch.int32, device=dev)
    visited[torch.from_numpy(words).to(dev)] = torch.from_numpy(
        ored.view(np.int32)).to(dev)
    visited = visited.view(n + 1, W)
    frontier = visited.clone()
    levels = None
    if levels_dtype is not None:
        unreached = UNREACHED8 if levels_dtype == torch.int8 else UNREACHED
        levels = torch.full((n, k), unreached, dtype=levels_dtype, device=dev)
        levels[torch.from_numpy(srcs).to(dev),
               torch.from_numpy(lanes).to(dev)] = 0
    return W, visited, frontier, levels


def ell_reach_parts(ell, dev, by_range: bool):
    """Each bucket's reach task for K9, colsT (w, rows) transposed once: a
    PackedChunk (range form, sorted ELL) or (node_ids, colsT) (ids form)."""
    parts = []
    for b in ell.buckets:
        colsT = as_tensor(b.cols, dev).t().contiguous()
        if by_range:
            parts.append(PackedChunk(int(b.row_offset), colsT.shape[1],
                                     colsT.shape[0], colsT, False))
        else:
            parts.append((as_tensor(b.node_ids, dev).to(torch.int32),
                          colsT))
    return parts


def _ell_level(parts, frontier, visited, reach, levels, depth) -> bool:
    """One level of the ELL family in place; True when a lane is still
    alive (reads K10's flag: the level's one sync)."""
    for part in parts:
        if isinstance(part, PackedChunk):
            chunk_reach(part, frontier, reach)
        else:
            sparse_reach(part[0], part[1], frontier, reach)
    no_chunks = torch.empty((0, 2), dtype=torch.int64, device=visited.device)
    flags = packed_epilogue(reach, visited, frontier, no_chunks)
    if levels is not None:
        packed_levels(frontier, levels, depth)
    return bool(flags[0])


def bfs_multi_ell(ell, sources, max_depth=None) -> torch.Tensor:
    """Batched BFS over a BlockedEll TRANSPOSE adjacency (any bucket order;
    32 lanes a word) with a host level loop: (n, k) int32 levels, UNREACHED
    where not found.  Runs where the buckets lie (the card for numpy
    buckets)."""
    dev = ell_device(ell)
    n = ell.n
    _W, visited, frontier, levels = packed_init(n, sources, dev,
                                                 torch.int32)
    parts = ell_reach_parts(ell, dev, by_range=False)
    reach = torch.zeros_like(visited)
    depth = 0
    while True:
        alive = _ell_level(parts, frontier, visited, reach, levels, depth)
        depth += 1
        if not alive or (max_depth is not None and depth >= max_depth):
            return levels


def bfs_multi_ell_sorted(ell, sources, fused=True, max_depth=None):
    """Batched BFS over a SORTED BlockedEll transpose (32 lanes a word).
    Returns (visited (n+1, W) int32, levels (n, k) int8, 127 = unreached).
    fused=True is the reference's one-dispatch form: at most `max_depth or
    64` levels; fused=False its host-stepped form, cut at max_depth only.
    Both read one flag a level here."""
    dev = ell_device(ell)
    _W, visited, frontier, levels = packed_init(ell.n, sources, dev,
                                                 torch.int8)
    parts = ell_reach_parts(ell, dev, by_range=True)
    reach = torch.zeros_like(visited)
    cap = (max_depth or 64) if fused else max_depth
    depth = 0
    while True:
        alive = _ell_level(parts, frontier, visited, reach, levels, depth)
        depth += 1
        if not alive or (cap is not None and depth >= cap):
            return visited, levels


class PackedBfsResult:
    """Packed multi-source BFS output: the visited words and the fresh
    words of each level.  Levels unpack lazily per lane (2048 lanes of
    (n,) levels would be GBs; a query wants one lane).  Unlike the
    reference's (max_levels, n, W) buffer, `hist` keeps one (n, W) row per
    level that found a fresh lane, which is every level but the last."""

    def __init__(self, visited, hist, nlevels, sources):
        self.visited = visited  # (n+1, W) int32 packed
        self.hist = hist  # [(n, W) int32]: hist[d] holds depth d + 1
        self.nlevels = nlevels
        self.sources = list(sources)

    def levels_for_lane(self, lane: int) -> torch.Tensor:
        """(n,) int32 levels for one source (UNREACHED where not found)."""
        word, bit = lane // 32, lane % 32
        n = self.visited.shape[0] - 1
        lv = torch.zeros(n, dtype=torch.int32, device=self.visited.device)
        for d, h in enumerate(self.hist, 1):  # a bit flips in one level
            lv += ((h[:, word] >> bit) & 1) * d
        lv[lv == 0] = UNREACHED
        lv[int(self.sources[lane])] = 0  # the root is visited at init
        return lv

    def reached_counts(self) -> torch.Tensor:
        """(k,) number of reached nodes per lane (popcount of visited)."""
        return self.weighted_counts(None)

    def weighted_counts(self, weights) -> torch.Tensor:
        """(k,) float32 sum of `weights` over each lane's reached nodes
        (None = count; outdeg gives Graph500 traversed edges): K12."""
        if weights is not None:
            weights = as_tensor(np.asarray(weights, np.float32)
                                if not isinstance(weights, torch.Tensor)
                                else weights, self.visited.device)
            weights = weights.to(torch.float32).contiguous()
        return packed_counts(self.visited, len(self.sources), weights)


def bfs_multi_ell_packed(ell, sources, max_levels=16,
                         fused=True) -> PackedBfsResult:
    """2048-lane-class batched BFS over a SORTED BlockedEll transpose,
    everything packed.  fused=True runs levels in runs of up to
    `max_levels`, continuing while a run ends at its cap with a live
    frontier (the reference's dispatches); fused=False steps level by
    level.  Either way it stops at the first level with no fresh lane."""
    dev = ell_device(ell)
    n = ell.n
    _W, visited, frontier, _ = packed_init(n, sources, dev)
    parts = ell_reach_parts(ell, dev, by_range=True)
    reach = torch.zeros_like(visited)
    hist = []
    total = 0
    while True:
        d = 0
        while True:
            alive = _ell_level(parts, frontier, visited, reach, None, d)
            d += 1
            if alive:
                hist.append(frontier[:n].clone())
            if not alive or (fused and d >= max_levels):
                break
        total += d
        if not alive or d < max_levels:
            return PackedBfsResult(visited, hist, total, sources)


def packed_levels(fresh: torch.Tensor, levels: torch.Tensor,
                  depth: int) -> torch.Tensor:
    """K17: levels[v, l] = depth + 1 where bit l of fresh[v] (32 lanes an
    int32 word) is set and levels[v, l] is UNREACHED (2^30 in int32 levels,
    127 in int8 ones, whose depth + 1 wraps), for v < n = levels.shape[0];
    in place."""
    if not _cuda.on_cuda(fresh, levels):
        return packed_levels_plain(fresh, levels, depth)
    n, k = levels.shape
    if (fresh.dtype != torch.int32 or fresh.dim() != 2
            or not fresh.is_contiguous() or fresh.shape[0] < n
            or k > 32 * fresh.shape[1]):
        raise ValueError(f"packed_levels: fresh must be a contiguous (>= {n}, "
                         f">= {-(-k // 32)}) int32 tensor, got {fresh.dtype} "
                         f"{tuple(fresh.shape)}")
    if levels.dtype not in (torch.int8, torch.int32) or \
            not levels.is_contiguous():
        raise ValueError(f"packed_levels: levels must be a contiguous int8 or "
                         f"int32 (n, k) tensor, got {levels.dtype}")
    rc = _cuda.lib().fk_packed_levels(
        _cuda.ptr(fresh), n, fresh.shape[1], _cuda.ptr(levels), k,
        levels.element_size(), int(depth), _cuda.stream_ptr(levels))
    _cuda.check(rc, "packed_levels")
    _cuda.count_launch("packed_levels")
    return levels


def _level_value(dtype, depth: int) -> int:
    if dtype == torch.int8:  # int8(depth) + 1 in int8 arithmetic
        v = (depth + 1) & 0xFF
        return v - 256 if v >= 128 else v
    return depth + 1


def packed_levels_plain(fresh, levels, depth: int,
                        block_elems: int = 1 << 26) -> torch.Tensor:
    """Plain PyTorch version of K17: falkordb_tpu's shift-and-mask unpack
    (`_unpack_bits`) and masked level update, in row blocks of about
    `block_elems` lanes so that the unpacked bits stay small."""
    n, k = levels.shape
    W = fresh.shape[1]
    unreached = UNREACHED8 if levels.dtype == torch.int8 else UNREACHED
    value = _level_value(levels.dtype, depth)
    shifts = torch.arange(32, dtype=torch.int32, device=fresh.device)
    step = max(1, block_elems // max(32 * W, 1))
    for lo in range(0, n, step):
        words = fresh[lo: min(lo + step, n)]
        bits = ((words[:, :, None] >> shifts) & 1).reshape(-1, W * 32)[:, :k]
        blk = levels[lo: lo + step]
        blk[(bits > 0) & (blk == unreached)] = value
    return levels
