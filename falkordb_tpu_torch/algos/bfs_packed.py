"""Gated bit-packed multi-source BFS: the batched BFS behind bench_port.py.

k BFS lanes run together.  Each node's state is one packed row of W words
(int8, int16 or int32; lane l is bit l % bits of word l // bits, so on a
little-endian card bit l of the row's byte string), kept in three (n+1, W)
arrays: visited, frontier and reach, whose extra row n is all zero and is
what the sentinel column n gathers.  One level is

    reach[v] = OR over the in-neighbours u of v of frontier[u]       (K9)
    fresh = reach & ~visited; visited |= fresh; frontier = fresh       (K10)

over a degree-sorted blocked-ELL transpose split into row chunks
(`build_packed_ell`).  A chunk whose rows are visited in every lane still
alive can produce no fresh bit, so it is skipped from the next level on
(chunk gating); the level's flags (any lane alive, per-chunk saturation)
come from the same pass as the epilogue.  K9 runs a level in one launch
from a plan cut once (`chunk_plan`), reading those flags on the card, and,
once most chunks are gated (`bitmap_pays`), gathers only the frontier rows
that are nonzero, by a bitmap of one bit a node that K10 writes beside the
frontier.
Level 1 is seeded from the roots' out-neighbour lists (K11), and the first
device level can gather only the out-edges of the level-1 union
(`build_sparse_level`, the mini-ELL).  The Graph500 kernel-2 edge count
reads the packed visited bits afterwards (K12).

falkordb_tpu (algos/bfs_packed.py) runs these as jitted functions; here CUDA
tensors launch the hand-written kernels under csrc/ (packed_reach.cu,
packed_epilogue.cu, packed_seed.cu, packed_counts.cu) and CPU tensors run
the plain PyTorch versions beside their wrappers (`*_plain`).  The state is
updated in place (the reference donates its buffers instead).  A skipped
chunk leaves stale rows in reach; they are harmless because every epilogue
leaves reach a subset of visited, so `reach & ~visited` is zero there.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from falkordb_tpu_torch.native import cuda as _cuda
from falkordb_tpu_torch.sparse.ell import (
    as_tensor, deliver, fill_rows, work_device,
)

# plain-loop width bound: buckets with w <= VW gather one column per step;
# wider buckets reshape to virtual rows of VW columns
VW = 16

_DTYPES = {np.dtype(np.int8): torch.int8, np.dtype(np.int16): torch.int16,
           np.dtype(np.int32): torch.int32}


@dataclasses.dataclass
class PackedChunk:
    row_offset: int  # first node id covered
    rows: int  # real rows covered
    width: int  # ELL width of the source bucket
    colsT: object  # (VW, rows*width//VW) or (w, rows) int32, transposed
    virtual: bool  # True: colsT is (VW, rows*width//VW), reduce after


@dataclasses.dataclass
class PackedEll:
    n: int
    chunks: list
    padded_edges: int
    # K9's level plan over the chunks (`chunk_plan`), cut at first use
    plan: object = dataclasses.field(default=None, compare=False, repr=False)


def build_packed_ell(ell, chunk_edges: int = 4 << 20,
                     device=None) -> PackedEll:
    """Split a sorted BlockedEll into gate-able row chunks with transposed
    column storage (contiguous per-column slices).  Computes where the
    buckets lie unless `device` is given; device=None (or the JAX package's
    False) gives numpy colsT, True the card."""
    chunks = []
    padded = 0
    for b in ell.buckets:
        dev = work_device(device, b.cols)
        cols = as_tensor(b.cols, dev)
        r, w = cols.shape
        if w > VW and w % VW:
            # pad the width to a VW multiple with the sentinel (it gathers
            # the all-zero row n) so the bucket takes the virtual-row path
            wp = -(-w // VW) * VW
            cols = torch.cat([cols, torch.full((r, wp - w), ell.n,
                                               dtype=torch.int32, device=dev)],
                             dim=1)
            w = wp
        rows_per_chunk = max(1, chunk_edges // max(w, 1))
        for lo in range(0, r, rows_per_chunk):
            hi = min(lo + rows_per_chunk, r)
            sub = cols[lo:hi]
            rr = hi - lo
            virtual = w > VW
            if virtual:  # virtual rows: (rr, w) -> (rr*w/VW, VW) -> transpose
                sub = sub.reshape(rr * (w // VW), VW)
            colsT = sub.t().contiguous()
            chunks.append(PackedChunk(b.row_offset + lo, rr, w,
                                      deliver(colsT, device), virtual))
            padded += rr * w
    return PackedEll(ell.n, chunks, padded)


def packed_to(pe: PackedEll, device) -> PackedEll:
    """The same chunks with colsT as tensors on `device` (an upload)."""
    dev = torch.device(device)
    return PackedEll(pe.n, [dataclasses.replace(c, colsT=as_tensor(c.colsT,
                                                                   dev))
                            for c in pe.chunks], pe.padded_edges)


def save_packed_ell(pe: PackedEll, path: str) -> None:
    """Persist a PackedEll to one uncompressed npz in falkordb_tpu's layout
    (either package loads what the other saved)."""
    arrs = {"meta": np.array(
        [[c.row_offset, c.rows, c.width, int(c.virtual)] for c in pe.chunks],
        dtype=np.int64).reshape(len(pe.chunks), 4),
        "n": np.array([pe.n, pe.padded_edges], dtype=np.int64)}
    for i, c in enumerate(pe.chunks):
        arrs[f"c{i}"] = (c.colsT.cpu().numpy()
                         if isinstance(c.colsT, torch.Tensor)
                         else np.asarray(c.colsT))
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrs)
    os.replace(tmp, path)


def load_packed_ell(path: str, device=None) -> PackedEll:
    d = np.load(path)
    meta = d["meta"]
    n, padded = (int(x) for x in d["n"])
    chunks = [PackedChunk(int(off), int(rows), int(w),
                          d[f"c{i}"] if device is None
                          else as_tensor(d[f"c{i}"], torch.device(device)),
                          bool(virt))
              for i, (off, rows, w, virt) in enumerate(meta)]
    return PackedEll(n, chunks, padded)


def build_seed_arrays(sources, fwd_indptr, fwd_cols, word_bits, W):
    """Host: flat `(row*W + word, bitmask)` scatter pairs for the level-0
    roots and (when a forward CSR is given) their level-1 out-neighbours.
    Per-lane neighbour lists are deduplicated, so within one flat index the
    contributing lanes own distinct bits and a scatter-OR (or ADD) is exact."""
    k = len(sources)
    root_idx = np.empty(k, np.int64)
    root_msk = np.empty(k, np.uint32)
    nbr_idx_parts, nbr_msk_parts = [], []
    for lane, r in enumerate(np.asarray(sources)):
        word, bit = lane // word_bits, lane % word_bits
        m = np.uint32(1 << bit)
        root_idx[lane] = int(r) * W + word
        root_msk[lane] = m
        if fwd_indptr is not None:
            s, e = int(fwd_indptr[r]), int(fwd_indptr[r + 1])
            d = np.unique(np.asarray(fwd_cols[s:e])).astype(np.int64)
            nbr_idx_parts.append(d * W + word)
            nbr_msk_parts.append(np.full(len(d), m, np.uint32))
    if fwd_indptr is None:
        return root_idx, root_msk, None, None
    return (root_idx, root_msk,
            np.concatenate(nbr_idx_parts) if nbr_idx_parts
            else np.empty(0, np.int64),
            np.concatenate(nbr_msk_parts) if nbr_msk_parts
            else np.empty(0, np.uint32))


def build_sparse_level(fwd_indptr, fwd_cols, sources_union, n,
                       widths=(2, 4, 8, 16, 32, 64, 128, 256, 512, 1024,
                               2048, 4096, 8192, 16384, 32768, 65536,
                               131072), device=None):
    """Mini transpose-ELL of the edges leaving `sources_union` (the level-2
    shortcut: at the first device level only the level-1 union has nonzero
    frontier rows, so only its out-edges can reach anything).

    Returns [(node_ids, colsT, width, virtual)] per bucket, colsT (w, rows)
    for w <= VW else (VW, rows*w//VW).  The edges are grouped by target in
    (target, source) order, the order of falkordb_tpu's native CSR build
    (native/csrbuild.cpp sorts by row << 32 | col), so the buckets equal the
    reference's.  device=None gives numpy."""
    dev = work_device(device, fwd_indptr, fwd_cols)
    su = torch.unique(as_tensor(sources_union, dev).to(torch.int64))
    fip = as_tensor(fwd_indptr, dev).to(torch.int64)
    fcols = as_tensor(fwd_cols, dev)
    deg = fip[su + 1] - fip[su]
    total = int(deg.sum())
    if total == 0:
        return []
    seg = torch.cumsum(deg, 0) - deg
    within = (torch.arange(total, device=dev)
              - torch.repeat_interleave(seg, deg, output_size=total))
    pos = torch.repeat_interleave(fip[su], deg, output_size=total) + within
    u = torch.repeat_interleave(su, deg, output_size=total)  # row to gather
    v = fcols[pos].to(torch.int64)  # reach row to write
    order = torch.sort((v << 32) | u, stable=True).indices
    cols_s = u[order].to(torch.int32)
    tdeg = torch.bincount(v, minlength=n)
    targets = torch.nonzero(tdeg).flatten()
    td = tdeg[targets]
    starts = torch.cumsum(td, 0) - td
    maxd = int(td.max())
    ws = [w for w in widths if w < maxd] + [maxd]
    out = []
    lo = 0
    for w in ws:
        sel = torch.nonzero((td > lo) & (td <= w)).flatten()
        lo = w
        if sel.numel() == 0:
            continue
        rows = sel.numel()
        wp = w if w <= VW else -(-w // VW) * VW
        mat = fill_rows(cols_s, starts[sel], td[sel], wp, n)
        virtual = wp > VW
        if virtual:
            mat = mat.reshape(rows * (wp // VW), VW)
        out.append((deliver(targets[sel].to(torch.int32), device),
                    deliver(mat.t().contiguous(), device), wp, virtual))
    return out


# -- kernels: wrappers and plain versions --------------------------------------


def or_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Bitwise OR of x along `dim` (torch has no OR reduction): halving
    steps, log2 of the length of them."""
    x = x.movedim(dim, 0)
    if x.shape[0] == 0:
        return torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        y = x[:h] | x[h:2 * h]
        if x.shape[0] % 2:
            y[0] |= x[2 * h]
        x = y
    return x[0]


def _check_state(kernel: str, *named) -> None:
    for name, t in named:
        if (t.dtype not in (torch.int8, torch.int16, torch.int32)
                or t.dim() != 2 or not t.is_contiguous()):
            raise ValueError(f"{kernel}: {name} must be a contiguous (n+1, W) "
                             f"tensor of int8, int16 or int32, got {t.dtype} "
                             f"{tuple(t.shape)}")
    first = named[0][1]
    for name, t in named[1:]:
        if t.shape != first.shape or t.dtype != first.dtype:
            raise ValueError(f"{kernel}: {name} is {t.dtype} "
                             f"{tuple(t.shape)}, {named[0][0]} "
                             f"{first.dtype} {tuple(first.shape)}")


def _row_bytes(t: torch.Tensor) -> int:
    return t.shape[1] * t.element_size()


# warps one launch of K9 keeps in flight (132 SMs x 16 blocks x 8 warps):
# fewer real rows than this split their columns into segments
REACH_TASKS = 132 * 16 * 8
MIN_SEGMENT = 64  # columns a warp gathers at least, when rows are split


def chunk_reach(chunk: PackedChunk, frontier: torch.Tensor,
                reach: torch.Tensor) -> torch.Tensor:
    """K9, chunk form (the single-part kernel; the ELL family's calls):
    reach[row_offset + r] = OR of frontier over row r's ELL columns, for
    the chunk's rows; other rows of reach keep their bits."""
    return _reach(chunk.colsT, chunk.rows, frontier, reach, chunk.row_offset,
                  None, "packed_chunk_reach")


def sparse_reach(ids: torch.Tensor, colsT: torch.Tensor,
                 frontier: torch.Tensor, reach: torch.Tensor) -> torch.Tensor:
    """K9, mini-ELL form (the single-part kernel): reach[ids[r]] = OR of
    frontier over row r's ELL columns (the ids of one bucket are distinct;
    ids outside 0..n are dropped)."""
    return _reach(colsT, ids.numel(), frontier, reach, 0, ids,
                  "packed_sparse_reach")


def _check_colsT(name, colsT, rows):
    if (colsT.dtype != torch.int32 or colsT.dim() != 2
            or not colsT.is_contiguous() or rows <= 0
            or colsT.shape[1] % rows):
        raise ValueError(f"{name}: colsT must be a contiguous (w, rows) or "
                         f"(VW, rows*w/VW) int32 tensor, got {colsT.dtype} "
                         f"{tuple(colsT.shape)} for {rows} rows")


def _check_nonzero(name, nonzero, frontier):
    _cuda.check_input(name, "nonzero", nonzero, torch.int32,
                      -(-frontier.shape[0] // 32))


def _reach(colsT, rows, frontier, reach, row_offset, ids, name):
    if not _cuda.on_cuda(colsT, frontier, reach, ids):
        return reach_plain(colsT, rows, frontier, reach, row_offset, ids)
    _check_state(name, ("frontier", frontier), ("reach", reach))
    _check_colsT(name, colsT, rows)
    _cuda.check_input(name, "ids", ids, torch.int32, rows)
    n = frontier.shape[0] - 1
    if ids is None and not 0 <= row_offset <= row_offset + rows <= n:
        raise ValueError(f"{name}: rows {row_offset}..{row_offset + rows} "
                         f"outside 0..{n}")
    rv = colsT.shape[1]
    vpr = rv // rows
    width = colsT.shape[0] * vpr
    spr = 1
    if rows < REACH_TASKS:
        spr = max(1, min(-(-width // MIN_SEGMENT), -(-REACH_TASKS // rows)))
    seg = -(-width // spr)
    spr = -(-width // seg)
    p = _cuda.ptr
    rc = _cuda.lib().fk_packed_reach(
        p(colsT), rv, vpr, width, rows, p(frontier), n, _row_bytes(frontier),
        p(reach), row_offset, p(ids), spr, seg, _cuda.stream_ptr(reach))
    _cuda.check(rc, name)
    _cuda.count_launch(name)
    return reach


def reach_plain(colsT, rows: int, frontier, reach, row_offset: int = 0,
                ids=None):
    """Plain PyTorch version of K9: falkordb_tpu's `_gather_or` (one gather
    of frontier rows per column slice, OR-accumulated; indices clipped to
    [0, n]) and, for virtual rows, an OR over each real row's virtual rows;
    then the rows are written into reach (by range, or by id)."""
    last = frontier.shape[0] - 1
    acc = None
    for j in range(colsT.shape[0]):
        g = frontier[colsT[j].to(torch.int64).clamp_(0, last)]
        acc = g if acc is None else acc.bitwise_or_(g)
    if acc.shape[0] != rows:
        acc = or_reduce(acc.view(rows, acc.shape[0] // rows, -1), 1)
    if ids is None:
        reach[row_offset: row_offset + rows] = acc
    else:  # a row whose id lies outside 0..n is dropped, as in the kernel
        ids = ids.to(torch.int64)
        keep = (ids >= 0) & (ids <= last)
        reach[ids[keep]] = acc[keep]
    return reach


# K9's level form: columns a warp task gathers at most (wider rows are cut
# into segments that combine through an accumulator row)
LEVEL_SEGMENT = 2048
_PART_WORDS = 16  # csrc/packed_reach.cu `Part`


def bitmap_pays(active) -> bool:
    """Whether a chunk level should test the nonzero-row bitmap: once fewer
    than half the chunks are active.  While most are, the frontier is dense
    (at RMAT-22 and RMAT-24 0.11-0.12 of the gathered rows are zero) and
    the test, a random word a column, costs more than the gathers it saves
    (5-8%); once gating has set most chunks aside, 0.42-1.0 of the rows
    left are zero and it saves 11-54%.  Measured level by level at both
    scales with the bitmap forced on and off (`bench_port_compare.py
    --rows reach`).  The mini-ELL level (0.19-0.20 zero, its padding)
    takes no bitmap: 3% slower with it."""
    return 2 * int(np.count_nonzero(active)) < len(active)


@dataclasses.dataclass
class ReachPlan:
    """K9's plan for one launch over a level's chunks or mini-ELL buckets:
    `parts` (colsT, rows, row_offset, ids, gate) each, gate the index of
    the part's saturation flag in K10's flags (1 + chunk) or -1; on the
    card `table`, their (parts, 16) int64 `Part` rows (hub parts first),
    `tasks` the warp tasks (32 rows of a narrow part, or a row's segment),
    `hub_rows` the rows cut into segments; the accumulator rows and
    tickets of those, per row width, in `scratch`."""
    parts: list
    name: str
    table: torch.Tensor | None = None  # (parts, 16) int64
    tasks: int = 0
    hub_rows: int = 0
    scratch: dict = dataclasses.field(default_factory=dict)

    def hub_scratch(self, row_bytes: int, dev):
        """(accumulator rows, tickets) for rows of row_bytes, zero at first
        use: every launch leaves them zero."""
        hit = self.scratch.get(row_bytes)
        if hit is None:
            hit = self.scratch[row_bytes] = (
                torch.zeros(max(self.hub_rows, 1) * row_bytes + 16,
                            dtype=torch.uint8, device=dev),
                torch.zeros(max(self.hub_rows, 1), dtype=torch.int32,
                            device=dev))
        return hit


def reach_plan(parts, name: str = "packed_chunk_reach") -> ReachPlan:
    """The level plan of `parts`, (colsT, rows, row_offset, ids, gate)
    each: rows wider than LEVEL_SEGMENT columns cut into segments, and the
    `Part` table written once where the parts lie."""
    plan = ReachPlan(list(parts), name)
    if not plan.parts:
        return plan
    dev = plan.parts[0][0].device
    rows_of = []
    for colsT, rows, off, ids, gate in plan.parts:
        _check_colsT(name, colsT, rows)
        _cuda.check_input(name, "ids", ids, torch.int32, rows)
        vpr = colsT.shape[1] // rows
        width = colsT.shape[0] * vpr
        tiled = vpr == 1 and width <= VW  # narrow: 32 rows a task
        spr = 1 if tiled else max(1, -(-width // LEVEL_SEGMENT))
        seg = -(-width // spr)
        rows_of.append((colsT, ids, rows, off, gate, vpr, width, spr, seg,
                        tiled))
    table, task, hub = [], 0, 0
    for hubs in (True, False):  # hub parts first: they start early
        for colsT, ids, rows, off, gate, vpr, width, spr, seg, tiled in \
                rows_of:
            if (spr > 1) != hubs:
                continue
            table.append([colsT.data_ptr(), 0 if ids is None
                          else ids.data_ptr(), colsT.shape[1], rows, off,
                          task, hub if spr > 1 else -1, gate, vpr, width,
                          spr, seg, int(tiled)] + [0] * (_PART_WORDS - 13))
            task += -(-rows // 32) if tiled else rows * spr
            hub += rows if spr > 1 else 0
    plan.table = torch.tensor(table, dtype=torch.int64, device=dev)
    plan.tasks, plan.hub_rows = task, hub
    return plan


def chunk_plan(pe: PackedEll) -> ReachPlan:
    """The level plan of every chunk of pe, each gated by its flag, cached
    on pe."""
    if pe.plan is None:
        pe.plan = reach_plan([(c.colsT, c.rows, c.row_offset, None, 1 + i)
                              for i, c in enumerate(pe.chunks)])
    return pe.plan


def sparse_plan(buckets) -> ReachPlan:
    """The level plan of the mini-ELL buckets, [(ids, colsT)] on one
    device: one launch for the first device level."""
    return reach_plan([(colsT, ids.numel(), 0, ids, -1)
                       for ids, colsT in buckets], "packed_sparse_reach")


_LEVEL = {name: _cuda.Entry("fk_packed_reach_level", name)
          for name in ("packed_chunk_reach", "packed_sparse_reach")}


def level_reach(plan: ReachPlan, frontier, reach, nonzero=None,
                flags=None) -> torch.Tensor:
    """K9 over a whole level in one launch: reach_plain over every part of
    the plan whose gate flag (K10's flags of the last level, None for
    none) is not set, the hub rows in segments.  `nonzero` (the bitmap of
    nonzero frontier rows) lets it skip the zero rows."""
    if not plan.parts:
        return reach
    if not _cuda.on_cuda(plan.parts[0][0], frontier, reach, nonzero, flags):
        return level_reach_plain(plan, frontier, reach, flags)
    _check_state(plan.name, ("frontier", frontier), ("reach", reach))
    _check_nonzero(plan.name, nonzero, frontier)
    if flags is not None and (flags.dim() != 1 or not flags.is_contiguous()
                              or flags.element_size() != 1):
        raise ValueError(f"{plan.name}: flags must be K10's contiguous bool "
                         f"flags, got {flags.dtype} {tuple(flags.shape)}")
    n = frontier.shape[0] - 1
    R = _row_bytes(frontier)
    for colsT, rows, off, ids, _g in plan.parts:
        if ids is None and not 0 <= off <= off + rows <= n:
            raise ValueError(f"{plan.name}: rows {off}..{off + rows} "
                             f"outside 0..{n}")
    dev = reach.get_device()
    hub, tickets = plan.hub_scratch(R, reach.device)
    _LEVEL[plan.name].launch(
        dev, plan.table.data_ptr(), plan.table.shape[0], plan.tasks,
        None if flags is None else flags.data_ptr(), frontier.data_ptr(), n,
        R, reach.data_ptr(), None if nonzero is None else nonzero.data_ptr(),
        hub.data_ptr(), tickets.data_ptr())
    return reach


def level_reach_plain(plan: ReachPlan, frontier, reach, flags=None):
    """Plain PyTorch version of K9's level form: reach_plain over each part
    whose gate flag is not set (a zero frontier row adds nothing, so the
    bitmap of nonzero rows changes no bit)."""
    for colsT, rows, off, ids, gate in plan.parts:
        if flags is not None and gate >= 0 and bool(flags[gate]):
            continue
        reach_plain(colsT, rows, frontier, reach, off, ids)
    return reach


def nonzero_rows(state: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the bitmap that K10 writes: bit r
    (bit r % 32 of int32 word r // 32) set where row r of the (n+1, W)
    state is nonzero; ceil((n+1) / 32) words."""
    rows = state.shape[0]
    nz = (state != 0).any(1).to(torch.int64)
    nz = torch.cat([nz, nz.new_zeros(-rows % 32)]).view(-1, 32)
    words = (nz << torch.arange(32, device=state.device)).sum(1)
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32)


def chunk_bounds(pe: PackedEll, device) -> torch.Tensor:
    """(chunks, 2) int64 (row_offset, rows) of each chunk, for K10."""
    return torch.tensor([[c.row_offset, c.rows] for c in pe.chunks],
                        dtype=torch.int64, device=device).reshape(-1, 2)


def packed_epilogue(reach, visited, frontier, bounds,
                    corrected: bool = True, nonzero=None) -> torch.Tensor:
    """K10: fresh = reach & ~visited; visited |= fresh; frontier = fresh
    (rows < n, in place) and frontier[n] = 0.  Returns the level's flags, a
    (1 + chunks,) bool tensor: [any lane alive, chunk 0 saturated, ...].
    A chunk is saturated when every bit of its visited rows is set, or
    (corrected=True, the host-driven form) set in every lane still alive,
    alive being the OR of the rows of fresh.  `nonzero`, when given, gets
    `nonzero_rows(frontier)`: K9's bitmap for the next level."""
    if not _cuda.on_cuda(reach, visited, frontier, bounds, nonzero):
        return packed_epilogue_plain(reach, visited, frontier, bounds,
                                     corrected, nonzero)
    _check_state("packed_epilogue", ("reach", reach), ("visited", visited),
                 ("frontier", frontier))
    _check_nonzero("packed_epilogue", nonzero, frontier)
    if bounds.dtype != torch.int64 or bounds.dim() != 2 or \
            bounds.shape[1] != 2 or not bounds.is_contiguous():
        raise ValueError("packed_epilogue: bounds must be a contiguous "
                         "(chunks, 2) int64 tensor")
    n = visited.shape[0] - 1
    R = _row_bytes(visited)
    wpr = -(-R // 4)  # 32-bit words of a row in the flag scratch
    nchunks = bounds.shape[0]
    dev = visited.device
    scratch = torch.empty(wpr * (1 + nchunks), dtype=torch.int32, device=dev)
    flags = torch.empty(1 + nchunks, dtype=torch.uint8, device=dev)
    p = _cuda.ptr
    rc = _cuda.lib().fk_packed_epilogue(
        p(reach), p(visited), p(frontier), n, R, p(bounds), nchunks,
        p(scratch), wpr, int(corrected), p(flags), p(nonzero),
        _cuda.stream_ptr(visited))
    _cuda.check(rc, "packed_epilogue")
    _cuda.count_launch("packed_epilogue")
    return flags.view(torch.bool)


def packed_epilogue_plain(reach, visited, frontier, bounds,
                          corrected: bool = True,
                          nonzero=None) -> torch.Tensor:
    """Plain PyTorch version of K10: falkordb_tpu's `_epilogue_jit` then
    `_flags_jit` (corrected) or `_make_step`'s flags (not corrected)."""
    n = visited.shape[0] - 1
    fresh = reach[:n] & ~visited[:n]
    visited[:n] |= fresh
    frontier[:n] = fresh
    frontier[n] = 0
    if nonzero is not None:
        nonzero.copy_(nonzero_rows(frontier))
    alive = or_reduce(fresh, 0)
    cov = ~alive if corrected else torch.zeros_like(alive)
    flags = [bool((alive != 0).any())]
    for off, rows in bounds.tolist():
        flags.append(bool(((visited[off: off + rows] | cov) == -1).all()))
    return torch.tensor(flags, dtype=torch.bool, device=visited.device)


def _signed(m: torch.Tensor, bits: int, dtype) -> torch.Tensor:
    """Unsigned masks (int64 holding uint values) as `bits`-wide signed
    words with the same bit pattern."""
    m = m & ((1 << bits) - 1)
    return torch.where(m >= 1 << (bits - 1), m - (1 << bits), m).to(dtype)


def packed_seed(n: int, W: int, dtype, padmask: int, level1: bool, ri, rm,
                ni=None, nm=None):
    """K11: the (n+1, W) visited and frontier arrays from flat
    (row*W + word, mask) scatter pairs (int64 tensors; masks hold uint32
    values).  The neighbour pairs are OR'd into both; with level1, the root
    bits are then OR'd into visited and cleared from frontier; without it,
    (ni, nm) default to the roots and visited = frontier = root bits.
    `padmask` is OR'd into every row's last word of visited, and row n of
    both is zero.  Pairs outside the arrays are dropped."""
    if ni is None:
        ni, nm = ri, rm
    if not _cuda.on_cuda(ri, rm, ni, nm):
        return packed_seed_plain(n, W, dtype, padmask, level1, ri, rm, ni, nm)
    for name, t in (("ri", ri), ("rm", rm), ("ni", ni), ("nm", nm)):
        _cuda.check_input("packed_seed", name, t, torch.int64)
    if ri.numel() != rm.numel() or ni.numel() != nm.numel():
        raise ValueError("packed_seed: index and mask lengths differ")
    dev = ri.device
    visited = torch.empty((n + 1, W), dtype=dtype, device=dev)
    frontier = torch.empty((n + 1, W), dtype=dtype, device=dev)
    p = _cuda.ptr
    rc = _cuda.lib().fk_packed_seed(
        p(visited), p(frontier), n, W, visited.element_size(), p(ri), p(rm),
        ri.numel(), p(ni), p(nm), ni.numel(), int(padmask), int(level1),
        _cuda.stream_ptr(visited))
    _cuda.check(rc, "packed_seed")
    _cuda.count_launch("packed_seed")
    return visited, frontier


def packed_seed_plain(n, W, dtype, padmask, level1, ri, rm, ni, nm):
    """Plain PyTorch version of K11: falkordb_tpu's `_seed_jit` (a
    scatter-ADD of the neighbour masks, exact as an OR on deduplicated
    lists, then point read-modify-writes of the root bits)."""
    bits = torch.empty((), dtype=dtype).element_size() * 8
    total = (n + 1) * W
    dev = ri.device

    def ok(i, m):
        keep = (i >= 0) & (i < total)
        return i[keep], _signed(m[keep], bits, dtype)

    i1, m1 = ok(ni, nm)
    v1 = torch.zeros(total, dtype=dtype, device=dev).index_add_(0, i1, m1)
    if level1:
        i0, m0 = ok(ri, rm)
        base = v1[i0]
        visited = v1.clone()
        visited[i0] = base | m0
        frontier = v1
        frontier[i0] = base & ~m0
    else:
        visited, frontier = v1, v1.clone()
    visited = visited.view(n + 1, W)
    frontier = frontier.view(n + 1, W)
    if padmask:
        visited[:, W - 1] |= _signed(torch.tensor(padmask), bits, dtype)
    visited[n] = 0
    frontier[n] = 0
    return visited, frontier


def packed_counts(visited: torch.Tensor, k: int,
                  weights: torch.Tensor | None = None) -> torch.Tensor:
    """K12: counts[l] = sum over v < n of weights[v] * bit l of visited[v]
    (weights 1 when None), for the first k lanes, as float32 (the
    reference's dtype) from float64 sums."""
    if not _cuda.on_cuda(visited, weights):
        return packed_counts_plain(visited, k, weights)
    _check_state("packed_counts", ("visited", visited))
    n = visited.shape[0] - 1
    _cuda.check_input("packed_counts", "weights", weights, torch.float32, n)
    R = _row_bytes(visited)
    if not 0 <= k <= 8 * R:
        raise ValueError(f"packed_counts: {k} lanes in rows of {R} bytes")
    acc = torch.empty(k, dtype=torch.float64, device=visited.device)
    out = torch.empty(k, dtype=torch.float32, device=visited.device)
    p = _cuda.ptr
    rc = _cuda.lib().fk_packed_counts(p(visited), n, R, k, p(weights), p(acc),
                                      p(out), _cuda.stream_ptr(visited))
    _cuda.check(rc, "packed_counts")
    _cuda.count_launch("packed_counts")
    return out


def packed_counts_plain(visited, k: int, weights=None) -> torch.Tensor:
    """Plain PyTorch version of K12: falkordb_tpu's `weighted_counts`
    unpacking (shift and mask, 32 lanes at a time) with a float64 product
    in place of its float32 einsum."""
    n, W = visited.shape[0] - 1, visited.shape[1]
    bits = visited.element_size() * 8
    shifts = torch.arange(bits, device=visited.device)
    w64 = None if weights is None else weights.to(torch.float64)
    outs = []
    for lo in range(0, W, max(1, 32 // bits)):
        x = visited[:n, lo: lo + max(1, 32 // bits)].to(torch.int64) & (
            (1 << bits) - 1)
        b = ((x[:, :, None] >> shifts) & 1).reshape(n, -1).to(torch.float64)
        outs.append(b.sum(0) if w64 is None else w64 @ b)
    return torch.cat(outs)[:k].to(torch.float32)


# -- the BFS ----------------------------------------------------------------------


class GatedBfsResult:
    def __init__(self, visited, nlevels, sources, word_bits,
                 level_chunks=None):
        self.visited = visited  # (n+1, W) packed words, on the device
        self.nlevels = nlevels
        self.sources = list(sources)
        self.word_bits = word_bits
        # gathers each device level ran: chunks, or "sparse:<buckets>"
        self.level_chunks = level_chunks or []

    def weighted_counts(self, weights) -> torch.Tensor:
        """(k,) float32 per-lane sum of weights over reached nodes
        (Graph500 kernel-2 edge counting; K12)."""
        if weights is not None:
            if not isinstance(weights, torch.Tensor):
                weights = torch.from_numpy(np.asarray(weights, np.float32))
            weights = weights.to(self.visited.device,
                                 torch.float32).contiguous()
        return packed_counts(self.visited, len(self.sources), weights)


def _run_device(packed, device) -> torch.device:
    if device is not None:
        return torch.device(device)
    if packed.chunks and isinstance(packed.chunks[0].colsT, torch.Tensor):
        return packed.chunks[0].colsT.device
    return torch.device("cuda")


def _gated(sources, pe, fwd_indptr, fwd_cols, word_dtype, max_levels,
           seed_arrays, sparse_first, corrected, device):
    dt = np.dtype(word_dtype)
    tdt = _DTYPES[dt]
    bits = dt.itemsize * 8
    k = len(sources)
    W = (k + bits - 1) // bits
    n = pe.n
    dev = _run_device(pe, device)
    # pre-saturate the padding lanes so chunk gating's all-bits test stays
    # exact
    pad = W * bits - k
    padmask = 0
    for b in range(bits - pad, bits):
        padmask |= 1 << b
    level1 = fwd_indptr is not None
    if seed_arrays is None:
        seed_arrays = build_seed_arrays(sources, fwd_indptr, fwd_cols, bits,
                                        W)
    ri, rm, ni, nm = (None if a is None else as_tensor(
        np.asarray(a).astype(np.int64) if not isinstance(a, torch.Tensor)
        else a, dev).to(torch.int64) for a in seed_arrays)
    levels = 1 if level1 else 0
    # bit r set where frontier row r is nonzero (K10 writes it each level):
    # K9 gathers only those rows where bitmap_pays, never at the first
    # device level (the mini-ELL names only level-1 rows; every chunk runs)
    nonzero = torch.empty(-(-(n + 1) // 32), dtype=torch.int32, device=dev)
    visited, frontier = packed_seed(n, W, tdt, padmask, level1, ri, rm, ni,
                                    nm)
    reach = torch.zeros((n + 1, W), dtype=tdt, device=dev)
    if any(not isinstance(c.colsT, torch.Tensor) or c.colsT.device != dev
           for c in pe.chunks):
        pe = packed_to(pe, dev)
    bounds = chunk_bounds(pe, dev)
    plan = chunk_plan(pe)
    first = sparse_first
    if first is not None and not isinstance(first, ReachPlan):
        first = sparse_plan([(as_tensor(ids, dev), as_tensor(colsT, dev))
                             for ids, colsT, _w, _v in first])
    active = np.ones(len(pe.chunks), dtype=bool)
    flags_dev = None  # the last level's flags, on the device
    level_chunks = []
    while levels < max_levels:
        if first is not None:
            level_reach(first, frontier, reach)
            level_chunks.append(f"sparse:{len(first.parts)}")
            first = None
        else:  # one launch: the saturated chunks skipped on the card
            level_reach(plan, frontier, reach,
                        nonzero if bitmap_pays(active) else None, flags_dev)
            level_chunks.append(int(active.sum()))
        flags_dev = packed_epilogue(reach, visited, frontier, bounds,
                                    corrected, nonzero)
        # the flags' copy to the host is the level's only sync
        flags = flags_dev.cpu().numpy()
        levels += 1
        if not flags[0]:
            break
        active = ~flags[1:]
    return GatedBfsResult(visited, levels, sources, bits, level_chunks)


def bfs_multi_gated_hostdriven(sources, packed, fwd_indptr=None,
                               fwd_cols=None, word_dtype=np.int16,
                               max_levels=64, seed_arrays=None,
                               sparse_first=None, device=None):
    """Gated packed BFS with host-driven per-chunk dispatch: per level, K9
    over every active chunk (or, at the first device level, over the
    `sparse_first` mini-ELL buckets of build_sparse_level), then K10, whose
    flags the host reads to stop or to gate chunks (saturation corrected
    for finished lanes).  `sparse_first` needs level-1 seeding (fwd_indptr,
    or level-1 seed_arrays); a caller that runs it more than once passes
    its `sparse_plan`, cut once on the run's device.  Runs where the
    chunks' colsT lie, or on `device` (the card when the chunks are
    numpy)."""
    return _gated(sources, packed, fwd_indptr, fwd_cols, word_dtype,
                  max_levels, seed_arrays, sparse_first, True, device)


def bfs_multi_gated(ell, sources, fwd_indptr=None, fwd_cols=None,
                    word_dtype=np.int16, max_levels=64,
                    chunk_edges: int = 4 << 20, packed=None,
                    seed_arrays=None, device=None):
    """Gated packed BFS over a SORTED BlockedEll transpose adjacency: the
    reference's monolithic level (`_make_step`), here K9 per active chunk
    and K10, with its saturation test uncorrected for finished lanes.
    `packed` skips the chunk build (`ell` may then be None); `seed_arrays`
    skips build_seed_arrays (fwd_indptr non-None iff they carry level-1
    neighbours).  Returns GatedBfsResult."""
    if packed is None:
        packed = build_packed_ell(ell, chunk_edges,
                                  device="cuda" if device is None else device)
    return _gated(sources, packed, fwd_indptr, fwd_cols, word_dtype,
                  max_levels, seed_arrays, None, False, device)
