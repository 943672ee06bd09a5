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
reads one flag (K4, K8 and K16: one cooperative launch a call, every level
on the card), and CPU tensors run the plain versions beside the wrappers
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


def bfs_levels(at_csr: CSR, src: int, max_depth=None) -> torch.Tensor:
    """BFS levels from src, as an (n,) int32 tensor on the CSR's device:
    0 at src, the hop count at each reached node and UNREACHED elsewhere.
    `at_csr` must be the TRANSPOSE adjacency (rows = destinations).  The
    first level always runs, even with max_depth 0; src < 0 reaches
    nothing.  CUDA tensors run csrc/bfs_levels.cu in one cooperative launch
    a call over `levels_plan(at_csr)`, on the lean launch path, with nothing
    read back; CPU tensors the plain version."""
    n = at_csr.n_rows
    indptr, cols, nnz = at_csr.indptr, at_csr.cols, at_csr.nnz
    if src < 0:
        return torch.full((n,), UNREACHED, dtype=torch.int32,
                          device=at_csr.device)
    if not _cuda.on_card(cols, indptr, nnz):
        return bfs_levels_plain(indptr, at_csr.rows, cols, nnz, n, src,
                                max_depth)
    _check_transpose("bfs_levels", at_csr)
    levels = torch.empty(n, dtype=torch.int32, device=cols.device)
    if n == 0:
        return levels
    dev = cols.get_device()
    plan = levels_plan(at_csr)
    ctl, _ = _cuda.control("bfs_levels", dev, "fk_bfs_levels_control_bytes")
    pull_edges = plan.edges // PULL_SHARE if PULL_SHARE > 0 else 1 << 62
    _BFS_LEVELS.launch(
        dev, n, int(src), -1 if max_depth is None else max(int(max_depth), 0),
        pull_edges, plan.fwd_ptr.data_ptr(), plan.fwd_dst.data_ptr(),
        indptr.data_ptr(), cols.data_ptr(), plan.nnz,
        plan.pull_rows.data_ptr(), plan.n_pull, plan.queue.data_ptr(),
        plan.queue.shape[0], levels.data_ptr(), ctl)
    return levels


def _check_transpose(kernel: str, at: CSR) -> None:
    """Raise unless the transpose's indptr, cols and nnz are what K4 and K8
    take: contiguous int32, n + 1 offsets, one count."""
    n, indptr, cols, nnz = at.n_rows, at.indptr, at.cols, at.nnz
    for name, t, size in (("indptr", indptr, n + 1), ("cols", cols, None)):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous() \
                or (size is not None and t.numel() != size):
            raise _cuda.input_error(kernel, name, t, torch.int32, size)
    if nnz.dtype != torch.int32 or nnz.numel() != 1:
        raise _cuda.input_error(kernel, "nnz", nnz, torch.int32, 1, None)


# -- K4's plan: every entry grouped by clipped source ---------------------------
#
# csrc/bfs_levels.cu pushes a level from the frontier's out-edges, queued as
# runs of at most PART_EDGES (as K8), and pulls a level whose frontier has
# more than 1/PULL_SHARE of the entries as out-edges: each unreached row
# with an entry scans its in-row up to the first frontier column.
# PULL_SHARE = 0 pushes every level.
PULL_SHARE = 16


@dataclasses.dataclass(eq=False)
class LevelsPlan:
    """K4's plan of one transpose on its device (`levels_plan_tensors`) and
    the queue a call fills."""
    fwd_ptr: torch.Tensor  # (n + 1,) int32
    fwd_dst: torch.Tensor  # (edges,) int32, one word at least
    pull_rows: torch.Tensor  # (n_pull,) int32, one word at least
    queue: torch.Tensor  # (qcap, 2) int32 runs of fwd_dst
    nnz: int
    edges: int
    n_pull: int


def levels_plan_tensors(indptr: torch.Tensor, cols: torch.Tensor, nnz: int,
                        n: int):
    """K4's plan of a transpose CSR of n rows, on the tensors' device:
    (fwd_ptr, fwd_dst, pull_rows, qcap).  Every entry before nnz (its row
    span cut at nnz) grouped by clipped source, in entry order: source u's
    destinations (the entries' rows) are fwd_dst[fwd_ptr[u]:fwd_ptr[u +
    1]], a column at or above UNREACHED included (the reference clips it to
    n - 1, unlike K8's plan).  pull_rows: the rows with such an entry, the
    only ones a level can claim; qcap: the queue's runs a call can need at
    most (each of those rows and src, their out-edges in runs of
    PART_EDGES)."""
    dev = cols.device
    ip = indptr.to(torch.int64).clamp(max=nnz)
    lo, hi = (int(ip[0]), int(ip[-1])) if n else (0, 0)
    deg = ip[1:] - ip[:-1]
    row_of = torch.repeat_interleave(
        torch.arange(n, dtype=torch.int32, device=dev), deg,
        output_size=hi - lo)
    u = cols[lo:hi].to(torch.int64).clamp(0, max(n - 1, 0))
    order = torch.sort(u, stable=True).indices
    fwd_ptr = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    fwd_ptr[1:] = torch.cumsum(torch.bincount(u, minlength=n), 0)
    pull_rows = torch.nonzero(deg > 0).flatten().to(torch.int32)
    qcap = pull_rows.numel() + 1 + -(-(hi - lo) // PART_EDGES)
    return fwd_ptr, row_of[order], pull_rows, qcap


def levels_plan(at: CSR) -> LevelsPlan:
    """K4's plan of the transpose `at`, made once on its device and cached
    on it."""
    hit = at.__dict__.get("_levels_plan")
    if hit is None:
        nnz = int(at.nnz)
        fwd_ptr, fwd_dst, pull_rows, qcap = levels_plan_tensors(
            at.indptr, at.cols, nnz, at.n_rows)
        edges, n_pull = fwd_dst.numel(), pull_rows.numel()

        def word(t):  # one word at least, for a valid pointer
            return t if t.numel() else torch.zeros(1, dtype=t.dtype,
                                                   device=t.device)

        hit = at.__dict__["_levels_plan"] = LevelsPlan(
            fwd_ptr, word(fwd_dst), word(pull_rows),
            torch.empty(qcap, 2, dtype=torch.int32, device=at.device),
            nnz, edges, n_pull)
    return hit


_BFS_LEVELS = _cuda.Entry("fk_bfs_levels", "bfs_levels")


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
    device.  Takes the FORWARD CSR (and its transpose, `CSR.transpose()`:
    made once and cached on it) or, given anything else, the transpose
    itself.  The parent of a node is the least id among its in-neighbours
    one level up; parents[src] = src and -1 where unreached; levels are
    UNREACHED there.  The BFS runs to the fixpoint; max_depth then masks
    deeper levels and leaves parents as they are."""
    at = a_csr_or_at.transpose() if isinstance(a_csr_or_at, CSR) \
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


# -- K8's plan: the transpose's entries grouped by source -----------------------
#
# csrc/bfs_parents.cu pushes every level from the frontier's out-edges, queued
# as runs of at most PART_EDGES (a hub's edges spread over many warps); each
# edge that reaches a node claimed in the level offers its column as the
# node's parent by an atomic min.
PART_EDGES = 256  # csrc/bfs_parents.cu kPart


def parents_plan_arrays(indptr: np.ndarray, cols: np.ndarray, nnz: int,
                        n: int):
    """K8's plan of a transpose CSR of n rows (host arrays): (fwd_ptr,
    fwd_dst, fwd_col, qcap, ncap).  The entries before nnz whose column is a
    candidate (below UNREACHED) grouped by clipped source, in entry order:
    source u's destinations (the entries' rows) are fwd_dst[fwd_ptr[u]:
    fwd_ptr[u + 1]] and fwd_col the same entries' columns.  qcap: the
    queue's runs a call can need at most (each node that can be reached,
    its out-edges in runs of PART_EDGES); ncap: the nodes that can be
    claimed at most (the rows with an entry)."""
    ip = np.minimum(indptr.astype(np.int64), nnz)
    lo, hi = (int(ip[0]), int(ip[-1])) if n else (0, 0)
    c = cols[lo:hi]
    row_of = np.repeat(np.arange(n, dtype=np.int32), np.diff(ip))
    keep = c.astype(np.int64) < UNREACHED
    u = np.clip(c[keep], 0, max(n - 1, 0))
    order = np.argsort(u, kind="stable")
    fwd_ptr = np.zeros(n + 1, np.int32)
    np.cumsum(np.bincount(u, minlength=n), out=fwd_ptr[1:])
    ncap = max(int(np.count_nonzero(np.diff(ip))), 1)
    qcap = ncap + 1 + -(-len(order) // PART_EDGES)
    return (fwd_ptr, row_of[keep][order], c[keep][order].astype(np.int32),
            qcap, ncap)


@dataclasses.dataclass(eq=False)
class ParentsPlan:
    """K8's plan of one transpose on its device (`parents_plan_arrays`) and
    the queue and node list a call fills (each call sets its counts up
    itself)."""
    fwd_ptr: torch.Tensor
    fwd_dst: torch.Tensor
    fwd_col: torch.Tensor
    queue: torch.Tensor  # (qcap, 2) int32 runs of fwd_dst
    nodes: torch.Tensor  # (ncap,) int32


def parents_plan(at: CSR) -> ParentsPlan:
    """K8's plan of the transpose `at`, made once and cached on it."""
    hit = at.__dict__.get("_parents_plan")
    if hit is None:
        indptr, cols, _ = at.host_view()
        fwd_ptr, fwd_dst, fwd_col, qcap, ncap = parents_plan_arrays(
            indptr, cols, int(at.nnz), at.n_rows)
        dev = at.device

        def up(a):  # one word at least, for a valid pointer
            return torch.from_numpy(a if len(a) else np.zeros(1, a.dtype)) \
                .to(dev)

        hit = at.__dict__["_parents_plan"] = ParentsPlan(
            up(fwd_ptr), up(fwd_dst), up(fwd_col),
            torch.empty(qcap, 2, dtype=torch.int32, device=dev),
            torch.empty(ncap, dtype=torch.int32, device=dev))
    return hit


_BFS_PARENTS = _cuda.Entry("fk_bfs_parents", "bfs_parents")


def bfs_parents(at_csr: CSR, src: int):
    """(levels, parents) from 0 <= src over the TRANSPOSE adjacency, to the
    fixpoint."""
    if not _cuda.on_card(at_csr.cols, at_csr.indptr, at_csr.nnz):
        return bfs_parents_plain(at_csr.indptr, at_csr.rows, at_csr.cols,
                                 at_csr.nnz, at_csr.n_rows, src)
    return bfs_parents_run(at_csr, src)[:2]


def bfs_parents_run(at_csr: CSR, src: int):
    """`bfs_parents` and the levels it ran (the last one found nothing):
    (levels, parents, n_levels).  CUDA tensors run csrc/bfs_parents.cu in
    one cooperative launch a call over `parents_plan(at_csr)`, on the lean
    launch path; CPU tensors the plain version."""
    n = at_csr.n_rows
    indptr, cols, nnz = at_csr.indptr, at_csr.cols, at_csr.nnz
    if not _cuda.on_card(cols, indptr, nnz):
        levels, parents = bfs_parents_plain(indptr, at_csr.rows, cols, nnz,
                                            n, src)
        reached = levels[levels != UNREACHED]
        return levels, parents, int(reached.max()) + 1 if reached.numel() \
            else 1
    _check_transpose("bfs_parents", at_csr)
    out = torch.empty(2 * n, dtype=torch.int32, device=cols.device)
    levels, parents = out[:n], out[n:]
    if n == 0:
        return levels, parents, 0
    dev = cols.get_device()
    plan = parents_plan(at_csr)
    ctl, staging = _cuda.control("bfs_parents", dev,
                                 "fk_bfs_parents_control_bytes")
    count = ctypes.c_int64(0)
    _BFS_PARENTS.launch(dev, n, int(src), plan.fwd_ptr.data_ptr(),
                        plan.fwd_dst.data_ptr(), plan.fwd_col.data_ptr(),
                        plan.queue.data_ptr(), plan.queue.shape[0],
                        plan.nodes.data_ptr(), plan.nodes.numel(),
                        levels.data_ptr(), parents.data_ptr(), ctl, staging,
                        ctypes.byref(count))
    return levels, parents, int(count.value)


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
#
# csrc/multi_bfs.cu runs a whole call in one cooperative launch over the plan
# below: warp tiles of whole rows, a row weighing max(in-edges before nnz,
# ROW_WEIGHT) and belonging to the tile of its first unit counted in steps
# of TILE_EDGES (so a tile holds at most 32 rows and 2 * TILE_EDGES - 1
# edges: a warp's item, a lane a row when it settles); rows of more than
# HUB_ROW edges go in segments of SEG_EDGES edges.  FRONTIER_MAP keeps the
# frontier's row map in each block's shared memory where it fits (Person /
# KNOWS; not RMAT-22); tests turn it off to run the path RMAT-22 takes.
TILE_EDGES = 256
ROW_WEIGHT = 8
HUB_ROW = 256
SEG_EDGES = 512
FRONTIER_MAP = True


def _roots(sources, n: int, dev):
    """(rows, lanes) int64 of the roots that the reference's scatter keeps:
    negative ids count from the end, ids past either end set nothing."""
    s = torch.as_tensor(np.asarray(sources, dtype=np.int64).reshape(-1),
                        device=dev)
    lanes = torch.arange(s.numel(), device=dev)
    s = torch.where(s < 0, s + n, s)
    keep = (s >= 0) & (s < n)
    return s[keep], lanes[keep]


def lane_words(k: int) -> int:
    """K16's words a node for k lanes: ceil(k / 32) rounded up to 1, 2, 4
    or a multiple of 8 (a node's words are one vector load)."""
    kw = -(-k // 32)
    return kw if kw <= 2 else 4 if kw <= 4 else -(-kw // 8) * 8


@dataclasses.dataclass
class MultiBfsState:
    """The state of a k-lane BFS between levels.  On the card (K16):
    `frontier`, `spare` and `visited` are (n, lane_words(k)) int32 words,
    lane l being bit l % 32 of word l // 32 (the words past ceil(k/32)
    zero), `levels` (or None) is (n, k) int32, `hsum`, when kept, the (n,)
    float64 sums of 1/level over the lanes (harmonic centrality), and
    `scratch` the launch's frontier maps and hub words.  On the CPU (the
    plain version) `frontier` is the reference's (n, k) int8 frontier and
    `levels` (n, k) int32.  `lanes()` gives the frontier in the reference's
    layout either way."""
    k: int
    frontier: torch.Tensor
    levels: torch.Tensor | None
    spare: torch.Tensor | None = None
    visited: torch.Tensor | None = None
    hsum: torch.Tensor | None = None
    scratch: torch.Tensor | None = None
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


def _pack_lanes(bits: torch.Tensor, words: int | None = None) -> torch.Tensor:
    """(n, k) bool lanes as (n, words) int32 words (ceil(k/32) by
    default), K16's layout."""
    n, k = bits.shape
    kw = words or (k + 31) // 32
    b = torch.zeros((n, kw * 32), dtype=torch.int64, device=bits.device)
    b[:, :k] = bits.to(torch.int64)
    w = (b.view(n, kw, 32) << torch.arange(32, device=bits.device)).sum(2)
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


def multi_bfs_state(at_csr: CSR, k: int, levels: bool = True,
                    hsum: bool = False) -> MultiBfsState:
    """An empty k-lane state on the CSR's device; the first
    `multi_bfs_level` or `multi_bfs_sums` call sets its roots.  hsum keeps
    harmonic sums (zero), instead of or beside the levels."""
    n, dev = at_csr.n_rows, at_csr.device
    sums = torch.zeros(n, dtype=torch.float64, device=dev) if hsum else None
    if dev.type == "cpu":
        st = _plain_state(n, k, dev)
        st.hsum = sums
        return st
    kw = lane_words(k)
    i32 = dict(dtype=torch.int32, device=dev)
    return MultiBfsState(
        k, torch.empty((n, kw), **i32),
        torch.empty((n, k), **i32) if levels else None,
        spare=torch.empty((n, kw), **i32), visited=torch.empty((n, kw), **i32),
        hsum=sums)


def multi_bfs_state_at(at_csr: CSR, levels: torch.Tensor,
                       frontier: torch.Tensor, depth: int) -> MultiBfsState:
    """A k-lane state on the CSR's device after `depth` levels, from the
    reference's layout: (n, k) int32 levels and (n, k) int8 frontier (both
    copied); the next `multi_bfs_level` call runs level depth + 1."""
    n, k = levels.shape
    if at_csr.device.type == "cpu":
        return MultiBfsState(k, frontier.clone(), levels.clone(), depth=depth)
    st = multi_bfs_state(at_csr, k)
    st.frontier.copy_(_pack_lanes(frontier > 0, lane_words(k)))
    st.visited.copy_(_pack_lanes(levels != UNREACHED, lane_words(k)))
    st.levels.copy_(levels)
    st.depth = depth
    return st


def plan_arrays(ip: np.ndarray):
    """K16's cut of the rows of a transpose CSR whose indptr, clamped at
    nnz, is `ip` (int64): (tiles (n_tiles, 4) int32 (r0, r1, ip[r0],
    ip[r1]), runs [r0, r1) of whole rows of at most HUB_ROW edges, in
    order; segs (n_segs, 4) int32 (row, lo, hi, hub), each wider row's
    edges in runs of at most SEG_EDGES, in order; hub_segs (n_hubs,) int32,
    each hub's segments)."""
    if 32 * ROW_WEIGHT > TILE_EDGES or HUB_ROW > TILE_EDGES:
        raise ValueError("a tile would exceed the kernel's 32 rows")
    deg = ip[1:] - ip[:-1]
    hub = deg > HUB_ROW
    weight = np.where(hub, 0, np.maximum(deg, ROW_WEIGHT))
    tile = (np.cumsum(weight) - weight) // TILE_EDGES
    rows = np.nonzero(~hub)[0]
    cut = np.ones(len(rows), dtype=bool)
    cut[1:] = (tile[rows[1:]] != tile[rows[:-1]]) | (rows[1:] != rows[:-1] + 1)
    first = np.nonzero(cut)[0]
    r0 = rows[first]
    r1 = np.append(rows[first[1:] - 1], rows[-1:]) + 1
    tiles = np.stack([r0, r1, ip[r0], ip[r1]], axis=1).astype(np.int32)
    hubs = np.nonzero(hub)[0]
    count = -(-deg[hubs] // SEG_EDGES)
    start = np.zeros(len(hubs) + 1, dtype=np.int64)
    np.cumsum(count, out=start[1:])
    h = np.repeat(np.arange(len(hubs)), count)
    lo = ip[hubs[h]] + (np.arange(start[-1]) - start[h]) * SEG_EDGES
    hi = np.minimum(lo + SEG_EDGES, ip[hubs[h] + 1])
    segs = np.stack([hubs[h], lo, hi, h], axis=1).astype(np.int32)
    return tiles.reshape(-1, 4), segs.reshape(-1, 4), count.astype(np.int32)


@dataclasses.dataclass(eq=False)
class MultiBfsPlan:
    """K16's plan of one transpose CSR on its device (`plan_arrays`)."""
    tiles: torch.Tensor
    segs: torch.Tensor
    hub_segs: torch.Tensor

    @property
    def n_hubs(self) -> int:
        return self.hub_segs.numel()


def multi_bfs_plan(at: CSR) -> MultiBfsPlan:
    """K16's plan of `at`, made once and cached on the snapshot."""
    hit = at.__dict__.get("_multi_bfs_plan")
    if hit is None:
        ip = np.minimum(at.host_view()[0].astype(np.int64), int(at.nnz))
        dev = at.device
        hit = MultiBfsPlan(*(torch.from_numpy(a).to(dev)
                             for a in plan_arrays(ip)))
        at.__dict__["_multi_bfs_plan"] = hit
    return hit


_MULTI_BFS = _cuda.Entry("fk_multi_bfs", "multi_bfs")


def _launch(at: CSR, st: MultiBfsState, max_depth, steps, seeds,
            read: bool):
    """One K16 launch on the card (the lean launch path): with `seeds` the
    state is first reset to those roots.  Returns (levels run, alive) when
    `read`, else None, reading nothing back."""
    n, k = at.n_rows, st.k
    indptr, cols, nnz = at.indptr, at.cols, at.nnz
    for name, t, size in (("indptr", indptr, n + 1), ("cols", cols, None)):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous() \
                or (size is not None and t.numel() != size):
            raise _cuda.input_error("multi_bfs", name, t, torch.int32, size)
    if nnz.dtype != torch.int32 or nnz.numel() != 1:
        raise _cuda.input_error("multi_bfs", "nnz", nnz, torch.int32, 1, None)
    srcs = None
    if seeds is not None:
        srcs = seeds if isinstance(seeds, torch.Tensor) else \
            torch.as_tensor(np.asarray(seeds, dtype=np.int32).reshape(-1))
        if srcs.device != indptr.device:
            srcs = srcs.to(indptr.device)
        if srcs.dtype != torch.int32 or srcs.dim() != 1 or \
                not srcs.is_contiguous() or srcs.numel() != k:
            raise _cuda.input_error("multi_bfs", "seeds", srcs, torch.int32, k)
        st.depth = 0
    if n == 0 or k == 0:  # a level that finds nothing, as the plain loop
        return (1, 0) if read else None
    plan = multi_bfs_plan(at)
    kw = st.frontier.shape[1]
    mw = -(-n // 128) * 4  # map words: a bit a row, 16-byte rows
    if st.scratch is None:
        st.scratch = torch.empty(3 * mw + plan.n_hubs * (kw + 1),
                                 dtype=torch.int32, device=indptr.device)
    dev = indptr.get_device()
    ctl, staging = _cuda.control("multi_bfs", dev,
                                 "fk_multi_bfs_control_bytes")
    p = _cuda.ptr
    n_levels, alive = ctypes.c_int64(0), ctypes.c_int32(0)
    _MULTI_BFS.launch(
        dev, indptr.data_ptr(), cols.data_ptr(), nnz.data_ptr(), n, k, kw,
        plan.tiles.data_ptr(), plan.tiles.shape[0], plan.segs.data_ptr(),
        plan.segs.shape[0], plan.hub_segs.data_ptr(), plan.n_hubs, p(srcs),
        st.frontier.data_ptr(), st.spare.data_ptr(), st.visited.data_ptr(),
        p(st.levels), p(st.hsum), st.scratch.data_ptr(), mw,
        int(FRONTIER_MAP), st.depth,
        -1 if steps is None else steps,
        -1 if max_depth is None else max(int(max_depth), 0), ctl,
        staging if read else None,
        ctypes.byref(n_levels) if read else None,
        ctypes.byref(alive) if read else None)
    return (n_levels.value, alive.value) if read else None


def multi_bfs_level(at_csr: CSR, st: MultiBfsState, max_depth=None,
                    steps: int | None = 1, seeds=None) -> MultiBfsState:
    """K16: run up to `steps` levels (None: to the end) of the k-lane BFS
    over the TRANSPOSE adjacency, each level OR-ing the in-neighbours'
    frontier lanes and giving each fresh lane depth + 1.  It stops at the
    first level with no fresh lane, or once the depth reaches max_depth (the
    first level always runs).  `seeds` ((k,) ids) first resets the state to
    those roots, in the same launch; the host reads the levels run and the
    alive flag once, after it."""
    if not _cuda.on_card(at_csr.indptr, at_csr.cols, at_csr.nnz,
                         st.frontier):
        return _multi_bfs_plain_levels(at_csr, st, max_depth, steps, seeds)
    n_levels, alive = _launch(at_csr, st, max_depth, steps, seeds, True)
    if n_levels % 2:  # the buffers swap each level
        st.frontier, st.spare = st.spare, st.frontier
    st.depth += n_levels
    st.alive = bool(alive)
    return st


def multi_bfs_sums(at_csr: CSR, st: MultiBfsState, seeds) -> MultiBfsState:
    """K16's harmonic-sums form: a BFS from `seeds` ((k,) ids, one lane
    each, the state reset to them) to the fixpoint over the TRANSPOSE
    adjacency, adding for each node the fresh lanes' 1/level to st.hsum.
    On the card it is one launch that reads nothing back, so calls queue
    behind one another; st.depth and st.alive are then not kept, and the
    frontier words are scratch."""
    if not _cuda.on_card(at_csr.indptr, at_csr.cols, at_csr.nnz,
                         st.frontier):
        st.hsum += multi_bfs_sums_plain(at_csr, seeds)
        return st
    if st.hsum is None or st.levels is not None:
        raise ValueError("multi_bfs_sums: the state must keep harmonic sums "
                         "and no levels (multi_bfs_state(..., levels=False, "
                         "hsum=True))")
    _launch(at_csr, st, None, None, seeds, False)
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
    if isinstance(sources, torch.Tensor):
        sources = sources.cpu()
    srcs = np.asarray(sources, dtype=np.int32).reshape(-1)
    st = _plain_state(at_csr.n_rows, len(srcs), at_csr.device)
    return _multi_bfs_plain_levels(at_csr, st, max_depth, None, srcs).levels


def multi_bfs_sums_plain(at_csr: CSR, sources) -> torch.Tensor:
    """Plain PyTorch version of K16's harmonic-sums form for one batch, on
    the CSR's device: (n,) float64, each node's sum over the lanes of
    1/level where the lane reached it at level > 0 (falkordb_tpu's
    harmonic_centrality batch: `bfs_multi`, then the masked reciprocal
    summed over the lanes)."""
    levels = bfs_multi_plain(at_csr, sources)
    mask = (levels > 0) & (levels < UNREACHED)
    return torch.where(mask, 1.0 / levels.clamp(min=1).double(),
                       torch.zeros((), dtype=torch.float64,
                                   device=levels.device)).sum(1)


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


_PACKED_LEVELS = _cuda.Entry("fk_packed_levels", "packed_levels")


def packed_levels(fresh: torch.Tensor, levels: torch.Tensor,
                  depth: int) -> torch.Tensor:
    """K17: levels[v, l] = depth + 1 where bit l of fresh[v] (32 lanes an
    int32 word) is set and levels[v, l] is UNREACHED (2^30 in int32 levels,
    127 in int8 ones, whose depth + 1 wraps), for v < n = levels.shape[0];
    in place."""
    if not _cuda.on_card(fresh, levels):
        return packed_levels_plain(fresh, levels, depth)
    if levels.dim() != 2 or levels.dtype not in (torch.int8, torch.int32) \
            or not levels.is_contiguous():
        raise ValueError(f"packed_levels: levels must be a contiguous int8 or "
                         f"int32 (n, k) tensor, got {levels.dtype} "
                         f"{tuple(levels.shape)}")
    n, k = levels.shape
    if (fresh.dtype != torch.int32 or fresh.dim() != 2
            or not fresh.is_contiguous() or fresh.shape[0] < n
            or k > 32 * fresh.shape[1]):
        raise ValueError(f"packed_levels: fresh must be a contiguous (>= {n}, "
                         f">= {-(-k // 32)}) int32 tensor, got {fresh.dtype} "
                         f"{tuple(fresh.shape)}")
    if n and k:
        _PACKED_LEVELS.launch(levels.get_device(), fresh.data_ptr(), n,
                              fresh.shape[1], levels.data_ptr(), k,
                              levels.element_size(), int(depth))
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
