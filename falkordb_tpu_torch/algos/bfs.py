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
    PackedChunk, nonzero_rows, or_reduce, packed_counts,
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


# -- the blocked-ELL bit-packed family (the fused level, K17, K12) -------------------
#
# Frontier and visited are (n+1, W) int32 words, 32 lanes a word; row n is
# the all-zero row that the sentinel column n gathers.  One level is fresh
# = (OR of the in-neighbours' frontier words) & ~visited, visited |= fresh,
# the next frontier = fresh, in one launch over a plan cut once an ELL form
# (`ell_level_plan`, `ell_level`), then, for the forms that keep per-lane
# levels, the fresh bits into levels (K17).  `EllBfs` drives the levels.


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
    """Each bucket as a reach task of K9's single-part body and of K18,
    colsT (w, rows) transposed: a PackedChunk (range form, sorted ELL) or
    (node_ids, colsT) (ids form)."""
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


ELL_SEGMENT = 2048  # columns a warp item gathers at most: wider rows are cut
ELL_STOP_SHARE = 32  # rows missing at most 1/32 of the real lanes vote to
#                      stop early (votes at 1/8, or always, were slower)
_ELL_PART_WORDS = 16  # csrc/ell_level.cu `Part`
ELL_CTL = 8  # int64 words of a control slot (csrc/ell_level.cu `kCtl`)
_ELL_LEVEL = _cuda.Entry("fk_ell_level", "ell_level")


@dataclasses.dataclass(eq=False)
class EllPlan:
    """The fused level's plan over one ELL form.  `parts`: (cols, rows,
    row_offset, ids) a bucket, cols its (rows, w) int32 columns as the
    bucket holds them, ids None for a range (nodes row_offset..) or the
    rows' nodes as int32 (a node that a later row also names set to -1:
    dropped, so the last row naming it wins, as the reference's scatter of
    one bucket after another leaves it); `tail` the first row of the
    uncovered tail where the ranges cover rows 0..tail-1 exactly, else
    None; `table` their (parts, 16) int64 `Part` rows where the buckets
    lie, hub parts first; `items` the warp items (a row, or a segment of
    at most ELL_SEGMENT columns of a wider row); `hub_rows` the rows cut
    into segments."""
    n: int
    parts: list
    tail: int | None
    table: torch.Tensor | None = None
    items: int = 0
    hub_rows: int = 0
    scratch: dict = dataclasses.field(default_factory=dict)

    def hub_scratch(self, row_bytes: int, dev):
        """(accumulator rows, tickets) for rows of row_bytes, zero at first
        use: every launch leaves them zero."""
        hit = self.scratch.get(row_bytes)
        if hit is None:
            hit = self.scratch[row_bytes] = (
                torch.zeros(max(self.hub_rows, 1) * -(-row_bytes // 8) + 2,
                            dtype=torch.int64, device=dev),
                torch.zeros(max(self.hub_rows, 1), dtype=torch.int32,
                            device=dev))
        return hit


def _last_rows(parts, n):
    """The parts' ids with every node that a later row names again set to
    -1 (and nothing else changed)."""
    ids = torch.cat([p[3].to(torch.int64) for p in parts])
    pos = torch.arange(ids.numel(), device=ids.device)
    ok = (ids >= 0) & (ids < n)
    last = torch.full((max(n, 1),), -1, dtype=torch.int64, device=ids.device)
    last.scatter_reduce_(0, ids[ok], pos[ok], "amax")
    drop = ok & (last[ids.clamp(0, max(n - 1, 0))] != pos)
    if not bool(drop.any()):
        return parts
    ids = torch.where(drop, -1, ids).to(torch.int32)
    out, lo = [], 0
    for cols, rows, off, _ids in parts:
        out.append((cols, rows, off, ids[lo: lo + rows].contiguous()))
        lo += rows
    return out


def ell_level_plan(ell, dev=None, by_range: bool = True) -> EllPlan:
    """The fused level's plan of `ell` on `dev` (default where its buckets
    lie), by range (a sorted ELL: bucket b holds nodes row_offset..) or by
    the buckets' node ids; cut once and cached on the ELL form."""
    dev = ell_device(ell) if dev is None else torch.device(dev)
    key = (str(dev), bool(by_range))
    plans = ell.__dict__.setdefault("level_plans", {})
    if key in plans:
        return plans[key]
    n = ell.n
    parts = []
    for b in ell.buckets:
        cols = as_tensor(b.cols, dev)
        if cols.dtype != torch.int32:
            cols = cols.to(torch.int32)
        cols = cols.contiguous()
        rows = cols.shape[0]
        if rows == 0:
            continue
        if by_range:
            off = int(b.row_offset)
            if off < 0 or off + rows > n:
                raise ValueError(f"ell_level_plan: a bucket's rows {off}.."
                                 f"{off + rows} are no range of 0..{n}: the "
                                 "range form needs a sorted ELL")
            parts.append((cols, rows, off, None))
        else:
            ids = as_tensor(b.node_ids, dev).to(torch.int32).contiguous()
            parts.append((cols, rows, 0, ids))
    tail = None
    if by_range:
        spans = sorted((off, off + rows) for _c, rows, off, _i in parts)
        if any(a[1] > b[0] for a, b in zip(spans, spans[1:])):
            raise ValueError("ell_level_plan: the buckets' row ranges "
                             "overlap")
        if all(lo == (spans[i - 1][1] if i else 0)
               for i, (lo, _hi) in enumerate(spans)):
            tail = spans[-1][1] if spans else 0
    elif parts:
        parts = _last_rows(parts, n)
    plan = EllPlan(n, parts, tail)
    table, item, hub = [], 0, 0
    for hubs in (True, False):  # hub parts first: they start early
        for cols, rows, off, ids in parts:
            width = cols.shape[1]
            spr = max(1, -(-width // ELL_SEGMENT))
            if (spr > 1) != hubs:
                continue
            table.append([cols.data_ptr(), 0 if ids is None
                          else ids.data_ptr(), rows, off, width, spr,
                          -(-width // spr), item, hub if spr > 1 else -1]
                         + [0] * (_ELL_PART_WORDS - 9))
            item += rows * spr
            hub += rows if spr > 1 else 0
    if item >= 1 << 30:
        raise ValueError(f"ell_level_plan: {item} items, past 2^30")
    plan.table = torch.tensor(table, dtype=torch.int64,
                              device=dev).reshape(-1, _ELL_PART_WORDS)
    plan.items, plan.hub_rows = item, hub
    plans[key] = plan
    return plan


def ell_bitmap_pays(rows: int, n: int) -> bool:
    """Whether a level should test the nonzero-row bitmap of its frontier
    (`rows` nonzero rows of n) before gathering a column: while under 1/8
    of the rows are nonzero.  At RMAT-22 from 2048 roots the test took
    1.3 -> 5.9 ms off a level at 0.05% nonzero rows and 3.0 -> 6.1 at
    1.3%, was even at 17%, and cost 1-4% at 39-48%, where few columns
    name a zero row (`bench_port_compare.py --rows family`)."""
    return 8 * rows < n


def _lane_words(W: int, lanes: int, dev) -> torch.Tensor:
    """(W,) int32: the real lanes' bits of each word."""
    bits = torch.arange(32 * W, device=dev).view(W, 32) < lanes
    words = (bits.to(torch.int64) << torch.arange(32, device=dev)).sum(1)
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32)


def alive_fits(W: int) -> bool:
    """Whether rows of W int32 words fit the kernel's live-lane ring (32
    units of 8 bytes, or of 4 where W is odd)."""
    return W <= (64 if W % 2 == 0 else 32)


def _check_level(plan, frontier, visited, out, nz_out, nonzero, known, ctl,
                 depth, alive):
    n = plan.n
    for name, t in (("frontier", frontier), ("visited", visited),
                    ("out", out)):
        if t.dtype != torch.int32 or t.dim() != 2 or not t.is_contiguous() \
                or t.shape[0] != n + 1 or t.shape != frontier.shape:
            raise ValueError(f"ell_level: {name} must be a contiguous "
                             f"(n+1, W) int32 tensor like frontier, n = {n}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    words = -(-(n + 1) // 32)
    for name, t in (("nz_out", nz_out), ("nonzero", nonzero)):
        _cuda.check_input("ell_level", name, t, torch.int32, words)
    if ctl.dtype != torch.int64 or tuple(ctl.shape) != (2, ELL_CTL) or \
            not ctl.is_contiguous():
        raise _cuda.input_error("ell_level", "ctl", ctl, torch.int64,
                                2 * ELL_CTL, 2)
    if (out.numel() and out.data_ptr() == frontier.data_ptr()) or (
            nonzero is not None and nonzero.data_ptr() == nz_out.data_ptr()):
        raise ValueError("ell_level: out and its bitmap must be other buffers "
                         "than the frontier and its bitmap")
    if not known and plan.tail is None:
        raise ValueError("ell_level: a fresh out buffer (known=False) needs "
                         "a plan whose ranges cover rows 0..tail-1")
    if depth < 0:
        raise ValueError(f"ell_level: depth must be >= 0, got {depth}")
    if alive is not None:
        W = frontier.shape[1]
        if not alive_fits(W) or alive.dtype != torch.int32 or \
                tuple(alive.shape) != (3, W) or not alive.is_contiguous():
            raise ValueError(f"ell_level: alive must be a contiguous (3, W) "
                             f"int32 tensor with W = {W} words of at most 32 "
                             f"units, got {alive.dtype} {tuple(alive.shape)}")
    if plan.parts and plan.table.device != frontier.device:
        raise ValueError(f"ell_level: the plan lies on {plan.table.device}, "
                         f"the state on {frontier.device}")


def ell_level(plan: EllPlan, frontier, visited, out, nz_out, nonzero=None,
              known: bool = True, ctl=None, depth: int = 0,
              lanes: int | None = None, alive=None,
              count: bool = False) -> torch.Tensor:
    """One level of the ELL family in one launch (csrc/ell_level.cu): for
    each node d that a row of the plan names, fresh = (OR of frontier over
    the row's columns, clipped to [0, n]) & ~visited[d], visited[d] |=
    fresh, out[d] = fresh; out's other rows, row n included, zero.  `lanes`
    (default every bit of a row) are the real lanes: the others stay 0.
    nz_out is out's nonzero-row bitmap, kept: with `known`, it describes
    out's old rows on entry, which keep their bits only where it says they
    are zero; without, out is a fresh buffer.  `nonzero`, the frontier's
    bitmap, lets the kernel skip columns whose row is zero.  `alive`, a
    (3, W) int32 ring (`alive_fits(W)`), narrows the lanes a row can gain
    to the frontier's, alive[(depth + 2) % 3] (the OR of its rows); the
    level writes the OR of its fresh rows into alive[depth % 3] (zero
    before) and zeroes alive[(depth + 1) % 3].  The level's counts are
    added to ctl[depth % 2] (2 x ELL_CTL int64, zero before: the level
    before, of the other parity, leaves it so) and the other row is
    zeroed: [rows gaining bits, named rows with no lane left, and with
    `count` the column indices read, the rows gathered, the units loaded].
    A row whose need holds at most 1/ELL_STOP_SHARE of the real lanes
    stops once its OR covers it.  Returns ctl."""
    n = plan.n
    W = frontier.shape[1] if frontier.dim() == 2 else 0
    if lanes is None:
        lanes = 32 * W
    if ctl is None:
        ctl = torch.zeros((2, ELL_CTL), dtype=torch.int64,
                          device=frontier.device)
    if not _cuda.on_card(frontier, visited, out, nz_out, nonzero, ctl, alive):
        return ell_level_plain(plan, frontier, visited, out, nz_out, nonzero,
                               known, ctl, depth, lanes, alive)
    _check_level(plan, frontier, visited, out, nz_out, nonzero, known, ctl,
                 depth, alive)
    R = 4 * W
    hub, tickets = plan.hub_scratch(R, frontier.device)
    _ELL_LEVEL.launch(
        frontier.get_device(),
        plan.table.data_ptr() if plan.parts else None, len(plan.parts),
        plan.items, frontier.data_ptr(), visited.data_ptr(), out.data_ptr(),
        None if nonzero is None else nonzero.data_ptr(), nz_out.data_ptr(),
        int(known), n, R, min(int(lanes), 32 * W),
        n + 1 if known else plan.tail, hub.data_ptr(), tickets.data_ptr(),
        ctl.data_ptr(), None if alive is None else alive.data_ptr(),
        int(depth), ELL_STOP_SHARE, int(count))
    return ctl


def _or_rows(frontier, cols, n, block_elems=1 << 24):
    """(rows, W): the OR of frontier over each row of cols (clipped to
    [0, n]), in row blocks of about `block_elems` gathered words."""
    rows, w = cols.shape
    W = frontier.shape[1]
    acc = torch.zeros((rows, W), dtype=frontier.dtype, device=frontier.device)
    step = max(1, block_elems // max(w * W, 1))
    for lo in range(0, rows, step):
        c = cols[lo: lo + step].to(torch.int64).clamp_(0, n)
        acc[lo: lo + step] = or_reduce(frontier[c], 1)
    return acc


def ell_level_plain(plan: EllPlan, frontier, visited, out, nz_out,
                    nonzero=None, known: bool = True, ctl=None,
                    depth: int = 0, lanes: int | None = None, alive=None):
    """Plain PyTorch version of `ell_level`: falkordb_tpu's per-bucket reach
    (`_ell_reach`, or the ids form's scatter of one bucket after another)
    and epilogue (the lanes narrowed by `alive` as in `ell_level`), then
    out's nonzero-row bitmap into nz_out, the live-lane ring and the
    level's first two counts into ctl[depth % 2] (the kernel's walk counts,
    words 2-4, stay 0).  `nonzero` and `known` change no bit."""
    n = plan.n
    W = frontier.shape[1]
    if lanes is None:
        lanes = 32 * W
    if ctl is None:
        ctl = torch.zeros((2, ELL_CTL), dtype=torch.int64,
                          device=frontier.device)
    reach = torch.zeros_like(frontier)
    named = torch.zeros(n + 1, dtype=torch.bool, device=frontier.device)
    for cols, rows, off, ids in plan.parts:
        acc = _or_rows(frontier, cols, n)
        if ids is None:
            reach[off: off + rows] = acc
            named[off: off + rows] = True
        else:  # a node outside 0..n-1 gains nothing, as in the kernel
            ids = ids.to(torch.int64)
            keep = (ids >= 0) & (ids < n)
            reach[ids[keep]] = acc[keep]
            named[ids[keep]] = True
    real = _lane_words(W, lanes, frontier.device)
    if alive is not None:
        real = real & alive[(depth + 2) % 3]
    fresh = reach[:n] & ~visited[:n] & real
    full = int((named[:n] & ((visited[:n] | ~real) == -1).all(1)).sum())
    visited[:n] |= fresh
    out[:n] = fresh
    out[n] = 0
    nz_out.copy_(nonzero_rows(out))
    counts = torch.zeros(ELL_CTL, dtype=torch.int64, device=ctl.device)
    counts[0] = int((fresh != 0).any(1).sum())
    counts[1] = full
    ctl[depth % 2] += counts
    ctl[(depth + 1) % 2] = 0
    if alive is not None:
        alive[depth % 3] = or_reduce(fresh, 0)
        alive[(depth + 1) % 3] = 0
    return ctl


def roots_bitmap(n: int, sources, dev) -> torch.Tensor:
    """The nonzero-row bitmap of the roots' frontier: bit s (bit s % 32 of
    int32 word s // 32) of each root s; ceil((n+1) / 32) words."""
    words = np.zeros(-(-(n + 1) // 32), np.uint32)
    s = np.unique(np.asarray([int(x) for x in sources], np.int64))
    np.bitwise_or.at(words, s >> 5,
                     np.left_shift(np.uint32(1), (s & 31).astype(np.uint32)))
    return torch.from_numpy(words.view(np.int32)).to(dev)


class EllBfs:
    """One multi-source BFS over a blocked-ELL transpose (32 lanes a word),
    a level a `step`: one `ell_level` launch over the form's cached plan,
    K17 for the forms that keep per-lane levels, and one read of the
    level's counts.  The frontier is double-buffered: a level reads one
    buffer and writes the other, whose rows the kernel rewrites only where
    its bitmap (`nz_spare`, kept by the kernel) says they hold bits; after
    the first level the roots' buffer is cleared of its roots and takes
    the next level's fresh words.  With `history` each level writes a new
    buffer instead (every covered row written, the rest zeroed in the same
    launch), kept in `hist` as the level's fresh words while the level
    finds a fresh lane."""

    def __init__(self, ell, sources, by_range: bool, levels_dtype=None,
                 history: bool = False):
        dev = ell_device(ell)
        n = ell.n
        self.plan = ell_level_plan(ell, dev, by_range)
        self.k = len(sources)
        _W, self.visited, self.frontier, self.levels = packed_init(
            n, sources, dev, levels_dtype)
        self.sources = np.asarray([int(s) for s in sources], np.int64)
        self.nz = roots_bitmap(n, self.sources, dev)
        self.nz_spare = torch.zeros_like(self.nz)
        W = self.visited.shape[1]
        self.alive = None  # the live-lane ring: row 2 the roots' lanes
        if alive_fits(W):
            self.alive = torch.zeros((3, W), dtype=torch.int32, device=dev)
            self.alive[2] = _lane_words(W, self.k, dev)
        self.spare = None if history else torch.zeros_like(self.visited)
        self.hist = [] if history else None
        self.ctl = torch.zeros((2, ELL_CTL), dtype=torch.int64, device=dev)
        self.depth = 0
        self.rows = len(np.unique(self.sources))  # the frontier's nonzero
        self._out = None

    def bitmap_choice(self) -> bool:
        return ell_bitmap_pays(self.rows, self.plan.n)

    def launch(self, bitmap: bool | None = None, count: bool = False) -> None:
        """Launch the level (the nonzero-row test as `bitmap_choice` says,
        or forced on or off; with `count` the kernel's walk counts too);
        `finish` completes it."""
        if bitmap is None:
            bitmap = self.bitmap_choice()
        history = self.hist is not None
        out = torch.empty_like(self.visited) if history else self.spare
        self._out = out
        ell_level(self.plan, self.frontier, self.visited, out, self.nz_spare,
                  self.nz if bitmap else None, not history, self.ctl,
                  self.depth, self.k, self.alive, count)

    def finish(self) -> bool:
        """K17 into the levels (where kept), the level's one read, the
        buffers swapped; True while the level found a fresh lane."""
        out, n = self._out, self.plan.n
        if self.levels is not None:
            packed_levels(out, self.levels, self.depth)
        rows = int(self.ctl[self.depth & 1, 0])
        if self.depth == 0:
            self.nz.zero_()  # the roots' bitmap becomes the next out's
            if self.hist is None:  # the roots' buffer takes level 2
                self.frontier[torch.from_numpy(self.sources).to(
                    self.frontier.device)] = 0
        if self.hist is None:
            self.spare = self.frontier
        elif rows:
            self.hist.append(out[:n])
        self.frontier, self._out = out, None
        self.nz, self.nz_spare = self.nz_spare, self.nz
        self.depth += 1
        self.rows = rows
        return rows > 0

    def step(self, bitmap: bool | None = None) -> bool:
        self.launch(bitmap)
        return self.finish()


def bfs_multi_ell(ell, sources, max_depth=None) -> torch.Tensor:
    """Batched BFS over a BlockedEll TRANSPOSE adjacency (any bucket order;
    32 lanes a word) with a host level loop: (n, k) int32 levels, UNREACHED
    where not found.  Runs where the buckets lie (the card for numpy
    buckets)."""
    run = EllBfs(ell, sources, by_range=False, levels_dtype=torch.int32)
    while True:
        alive = run.step()
        if not alive or (max_depth is not None and run.depth >= max_depth):
            return run.levels


def bfs_multi_ell_sorted(ell, sources, fused=True, max_depth=None):
    """Batched BFS over a SORTED BlockedEll transpose (32 lanes a word).
    Returns (visited (n+1, W) int32, levels (n, k) int8, 127 = unreached).
    fused=True is the reference's one-dispatch form: at most `max_depth or
    64` levels; fused=False its host-stepped form, cut at max_depth only.
    Both read one count a level here."""
    run = EllBfs(ell, sources, by_range=True, levels_dtype=torch.int8)
    cap = (max_depth or 64) if fused else max_depth
    while True:
        alive = run.step()
        if not alive or (cap is not None and run.depth >= cap):
            return run.visited, run.levels


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
    level.  Either way it stops at the first level with no fresh lane.
    Each level's fresh words are the buffer its launch wrote (no copy)."""
    run = EllBfs(ell, sources, by_range=True, history=True)
    total = 0
    while True:
        d = 0
        while True:
            alive = run.step()
            d += 1
            if not alive or (fused and d >= max_levels):
                break
        total += d
        if not alive or d < max_levels:
            return PackedBfsResult(run.visited, run.hist, total, sources)


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
    if not k:  # no lane: nothing to set (and no bits to unpack)
        return levels
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
