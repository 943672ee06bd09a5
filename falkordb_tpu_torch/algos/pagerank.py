"""PageRank (LAGr_PageRank replacement) — power iteration (kernel K5).

r <- (1-d)/n + d * (A^T D^-1 r + dangling/n), a row-wise sum over the
transpose CSR per step, to the tolerance.  falkordb_tpu runs this as a
jitted while_loop (algos/pagerank.py:_pagerank_jit); here CUDA tensors
launch csrc/pagerank.cu, one persistent cooperative launch a call that runs
every step over the tiles and tasks of `pagerank_plan` (cut once a
transpose CSR and cached on it) and stops on the card, and CPU tensors run
`pagerank_plain`.

The blocked-ELL variant (pagerank_ell, which no procedure calls) steps over
the buckets of a transpose ELL: CUDA tensors launch csrc/ell_pagerank.cu
(kernel K18: every bucket's row sums in one launch, from `ell_rows_plan`)
once a step, and the host reads the step's L1 change, as the reference
does; CPU tensors run `ell_pagerank_step_plain`."""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from falkordb_tpu_torch.algos.bfs import ell_reach_parts
from falkordb_tpu_torch.native import cuda as _cuda
from falkordb_tpu_torch.sparse.csr import CSR
from falkordb_tpu_torch.sparse.ell import as_tensor, ell_device

# blocks of a pass over the nodes, at most: csrc/pagerank.cu sizes its grid
# to the length of the per-block scratch it is given
MAX_BLOCKS = 132 * 16
# K5's plan: a tile's rows start within TILE_ITEMS merge-path items (a row
# is its entries plus its end), so a tile holds at most TILE_ITEMS +
# LONG_ROW items (csrc/pagerank.cu kTileCap); rows wider than LONG_ROW go
# in tasks of at most TASK_EDGES entries
TILE_ITEMS = 2048
LONG_ROW = 2048
TILE_CAP = 4097
TASK_EDGES = 4096


def plan_arrays(ip: np.ndarray):
    """K5's cut of the rows of a transpose CSR whose indptr, clamped at nnz,
    is `ip` (int64): (tiles (n_tiles, 4) int32 (r0, r1, ip[r0], ip[r1]),
    runs [r0, r1) of whole rows of at most LONG_ROW entries, in order, a row
    in the tile of its first merge-path item counted in steps of
    TILE_ITEMS; tasks (n_tasks, 6) int64 (row, lo, hi, long row, first
    task, task count), each wider row's entries in runs of at most
    TASK_EDGES, in order; the number of wider rows)."""
    if TILE_ITEMS + LONG_ROW > TILE_CAP:
        raise ValueError("TILE_ITEMS + LONG_ROW exceeds the kernel's tile "
                         f"of {TILE_CAP} items")
    deg = ip[1:] - ip[:-1]
    long = deg > LONG_ROW
    items = np.where(long, 0, deg + 1)
    tile = (np.cumsum(items) - items) // TILE_ITEMS
    rows = np.nonzero(~long)[0]
    cut = np.ones(len(rows), dtype=bool)
    cut[1:] = (tile[rows[1:]] != tile[rows[:-1]]) | (rows[1:] != rows[:-1] + 1)
    first = np.nonzero(cut)[0]
    r0 = rows[first]
    r1 = np.append(rows[first[1:] - 1], rows[-1:]) + 1
    tiles = np.stack([r0, r1, ip[r0], ip[r1]], axis=1).astype(np.int32)
    wide = np.nonzero(long)[0]
    count = -(-deg[wide] // TASK_EDGES)
    start = np.zeros(len(wide) + 1, dtype=np.int64)
    np.cumsum(count, out=start[1:])
    li = np.repeat(np.arange(len(wide)), count)
    lo = ip[wide[li]] + (np.arange(start[-1]) - start[li]) * TASK_EDGES
    hi = np.minimum(lo + TASK_EDGES, ip[wide[li] + 1])
    tasks = np.stack([wide[li], lo, hi, li, start[li], count[li]],
                     axis=1).astype(np.int64).reshape(-1, 6)
    return tiles, tasks, len(wide)


@dataclasses.dataclass(eq=False)
class PagerankPlan:
    """K5's plan of one transpose CSR on its device (`plan_arrays`), with
    the long rows' task counters (zero between calls: a row's last task
    resets its own)."""
    tiles: torch.Tensor
    tasks: torch.Tensor
    n_long: int
    counters: torch.Tensor


def pagerank_plan(at: CSR) -> PagerankPlan:
    """K5's plan of `at`, made once and cached on the snapshot."""
    hit = at.__dict__.get("_pagerank_plan")
    if hit is None:
        ip = np.minimum(at.host_view()[0].astype(np.int64), int(at.nnz))
        tiles, tasks, n_long = plan_arrays(ip)
        dev = at.device
        hit = PagerankPlan(torch.from_numpy(tiles).to(dev),
                           torch.from_numpy(tasks).to(dev), n_long,
                           torch.zeros(max(n_long, 1), dtype=torch.int32,
                                       device=dev))
        at.__dict__["_pagerank_plan"] = hit
    return hit


_PAGERANK = _cuda.Entry("fk_pagerank", "pagerank")


def pagerank(a_csr: CSR, damping=0.85, tol=1e-4, max_iters=100):
    """PageRank scores of the FORWARD adjacency `a_csr`, as an (n,) float32
    tensor on its device."""
    at = a_csr.transpose_host()
    if at.n_rows == 0:
        return torch.zeros(0, dtype=torch.float32, device=at.device)
    return pagerank_transposed(at, damping, tol, max_iters)[0]


@functools.lru_cache(maxsize=64)
def _scalars(n: int, damping, tol):
    """The float32 constants of the reference: r0 = 1/n (rounded from a
    double), d, tol and (1 - d)/n computed in float32."""
    d = np.float32(damping)
    base = (np.float32(1.0) - d) / np.float32(n)
    return np.float32(1.0 / n), d, np.float32(tol), np.float32(base)


def pagerank_transposed(at: CSR, damping=0.85, tol=1e-4, max_iters=100):
    """Power iteration over the TRANSPOSE adjacency (rows = destinations).
    Returns (r (n,) float32, steps run, the last step's L1 change) with the
    reference's stopping rule: the first step always runs, then it stops at
    L1 <= tol or after max_iters steps."""
    n = at.n_rows
    indptr, cols, nnz = at.indptr, at.cols, at.nnz
    if not _cuda.on_card(indptr, cols, nnz):
        return pagerank_plain(indptr, at.rows, cols, nnz, n, damping, tol,
                              max_iters)
    for name, t, size in (("indptr", indptr, n + 1), ("cols", cols, None)):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous() \
                or (size is not None and t.numel() != size):
            raise _cuda.input_error("pagerank", name, t, torch.int32, size)
    if nnz.dtype != torch.int32 or nnz.numel() != 1:
        raise _cuda.input_error("pagerank", "nnz", nnz, torch.int32, 1, None)
    dev = indptr.get_device()
    f32 = dict(dtype=torch.float32, device=indptr.device)
    if n == 0:
        return torch.empty(0, **f32), 0, 0.0
    plan = pagerank_plan(at)
    r0, d, tol32, base = _scalars(n, damping, tol)
    ctl, staging = _cuda.control("pagerank", dev,
                                 "fk_pagerank_control_bytes")
    r_a, r_b = torch.empty(n, **f32), torch.empty(n, **f32)
    n_tasks = plan.tasks.shape[0]
    scratch = torch.empty(4 * n + 4 * (MAX_BLOCKS + plan.n_long) + n_tasks,
                          **f32)
    iters, err, in_b = ctypes.c_int64(0), ctypes.c_float(0), ctypes.c_int32(0)
    _PAGERANK.launch(
        dev, indptr.data_ptr(), cols.data_ptr(), nnz.data_ptr(), n,
        float(d), float(tol32), int(max_iters), float(r0), float(base),
        plan.tiles.data_ptr(), plan.tiles.shape[0], plan.tasks.data_ptr(),
        n_tasks, plan.n_long, plan.counters.data_ptr(), r_a.data_ptr(),
        r_b.data_ptr(), scratch.data_ptr(), MAX_BLOCKS, ctl, staging,
        ctypes.byref(iters), ctypes.byref(err), ctypes.byref(in_b))
    return (r_b if in_b.value else r_a), int(iters.value), float(err.value)


def pagerank_plain(indptr, rows, cols, nnz, n: int, damping=0.85, tol=1e-4,
                   max_iters=100):
    """Plain PyTorch version of `pagerank_transposed`: the reference's loop
    step by step, in float32."""
    dev = cols.device
    r0, d, tol32, base = _scalars(max(n, 1), damping, tol)
    valid = torch.arange(cols.shape[0], device=dev) < nnz
    src_of = cols.to(torch.int64).clamp(0, max(n - 1, 0))
    dst_of = rows.to(torch.int64)
    ones = valid.to(torch.float32)
    outdeg = torch.zeros(n, dtype=torch.float32, device=dev).index_add_(
        0, src_of, ones)
    inv_out = torch.where(outdeg > 0, 1.0 / outdeg,
                          torch.zeros_like(outdeg))
    dangling_mask = (outdeg == 0).to(torch.float32)
    n_t = torch.full((1,), float(n), dtype=torch.float32, device=dev)
    d_t = torch.tensor(d, device=dev)
    base_t = torch.tensor(base, device=dev)
    r = torch.full((n,), float(r0), dtype=torch.float32, device=dev)
    it, err = 0, 0.0
    while it < max_iters and (it == 0 or err > tol32):
        gath = torch.where(valid, (r * inv_out)[src_of],
                           torch.zeros((), dtype=torch.float32, device=dev))
        acc = torch.zeros(n, dtype=torch.float32, device=dev).index_add_(
            0, dst_of, gath)
        dangling = (r * dangling_mask).sum(0, keepdim=True) / n_t
        r_new = base_t + d_t * (acc + dangling)
        err = np.float32((r_new - r).abs().sum().item())
        r = r_new
        it += 1
    return r, it, float(err)


# -- the blocked-ELL form (K18) ------------------------------------------------

# K18's row sums (csrc/ell_pagerank.cu holds no shapes of its own): a lane
# walks at most _ROWS_RUN columns of a segment (more when a row would
# otherwise have more than _ROWS_MAX_SEGS segments); at most _ROWS_BUCKETS
# buckets a launch (the kernel's kMaxBuckets, its parameter struct).
_ROWS_RUN = 256
_ROWS_MAX_SEGS = 1024
_ROWS_BUCKETS = 64


@dataclasses.dataclass(frozen=True)
class RowsPlan:
    """K18's cut of a call's buckets: `launches`, one a kernel launch, each
    (bucket indices, (nb, 8) int64 fields [rows, w, shift, seg, nseg,
    item0, part0, cnt0] a bucket, warps); `partials` float32 and `counters`
    int32 words of scratch for the rows of several segments."""
    launches: tuple
    partials: int
    counters: int


@functools.lru_cache(maxsize=64)
def ell_rows_plan(shapes: tuple) -> RowsPlan:
    """The plan of K18's `rows` kernel for buckets of (rows, w) `shapes`,
    made from the shapes alone.  A bucket's rows go in tiles of RL = 2**shift
    consecutive rows (32, or the rows rounded up to a power of two when
    fewer) and its columns in nseg segments of seg columns (seg a multiple
    of CL = 32 / RL: _ROWS_RUN columns a lane, at most _ROWS_MAX_SEGS
    segments a row); a warp takes one (tile, segment), item item0 + tile *
    nseg + segment, its lane rl + RL * cl row rl of the tile and columns
    c0 + cl, c0 + cl + CL, ... of the segment.  Buckets go widest first and
    at most _ROWS_BUCKETS a launch.  Rows of several segments leave a
    partial a (row, segment) at part0 + (tile * nseg + segment) * RL + rl,
    and count their tile's finished segments at cnt0 + tile."""
    order = sorted((b for b, (r, w) in enumerate(shapes) if r > 0 and w > 0),
                   key=lambda b: -shapes[b][1])
    launches, part0, cnt0 = [], 0, 0
    for lo in range(0, len(order), _ROWS_BUCKETS):
        idx = order[lo:lo + _ROWS_BUCKETS]
        fields = np.zeros((len(idx), 8), dtype=np.int64)
        item0 = 0
        for f, b in zip(fields, idx):
            rows, w = shapes[b]
            shift = max(min(rows, 32) - 1, 0).bit_length()
            cl = 32 >> shift
            seg = max(_ROWS_RUN * cl, -(-w // (_ROWS_MAX_SEGS * cl)) * cl)
            seg = min(seg, w)
            nseg = -(-w // seg)
            tiles = -(-rows // (1 << shift))
            f[:] = (rows, w, shift, seg, nseg, item0, part0, cnt0)
            item0 += tiles * nseg
            if nseg > 1:
                part0 += tiles * nseg << shift
                cnt0 += tiles
        launches.append((tuple(idx), fields, item0))
    return RowsPlan(tuple(launches), part0, cnt0)


def rows_plan(parts) -> RowsPlan:
    """`ell_rows_plan` of the (node_ids, colsT (w, rows)) buckets `parts`."""
    return ell_rows_plan(tuple((int(c.shape[1]), int(c.shape[0]))
                               for _, c in parts))


def ell_rows(kernel: str, parts, plan: RowsPlan, contrib, n: int,
             buf) -> None:
    """K18's row sums on the card, `plan` = rows_plan(parts): buf[:n]
    viewed as float32 gets, at each row's node, the sum of
    contrib[clip(colsT[j, i], 0, n)] over its columns up to its first
    sentinel n (contrib (n + 1,) float32 with contrib[n] = 0), every bucket
    in one launch (a launch per _ROWS_BUCKETS).  buf (n + plan.counters,)
    int32 comes zeroed: nodes no bucket covers keep 0, and the counters
    start at 0."""
    if buf.numel() < n + plan.counters:
        raise ValueError(f"{kernel}: scratch of {buf.numel()} words, the "
                         f"plan needs {n + plan.counters}")
    partial = torch.empty(max(plan.partials, 1), dtype=torch.float32,
                          device=buf.device)
    lib, p, s = _cuda.lib(), _cuda.ptr, _cuda.stream_ptr(buf)
    for idx, fields, items in plan.launches:
        table = np.empty((len(idx), 10), dtype=np.int64)
        table[:, 0] = [parts[b][1].data_ptr() for b in idx]
        table[:, 1] = [parts[b][0].data_ptr() for b in idx]
        table[:, 2:] = fields
        _cuda.check(lib.fk_ell_rows(
            table.ctypes.data, len(idx), items, p(contrib), n, p(buf),
            p(partial), p(buf[n:]), s), kernel)


def ell_pagerank_step(parts, r, inv_out, dangling_mask, damping):
    """K18: one step r' = (1-d)/n + d * (ELL row sums of r * inv_out + the
    dangling mass sum(r * dangling_mask) / n), float32, over the transpose
    ELL's buckets as bfs.ell_reach_parts(ell, dev, by_range=False) gives
    them: (node_ids (rows,), colsT (w, rows)) int32 each.  Each row of colsT
    holds its columns first and then only the sentinel n (left-aligned, as
    every ELL builder of the port writes it): the kernel stops at a row's
    first sentinel.  Returns (r', the L1 change sum|r' - r| as a (1,)
    tensor on the device)."""
    n = r.shape[0]
    if not _cuda.on_cuda(r, inv_out, dangling_mask,
                         *(t for part in parts for t in part)):
        r_new = ell_pagerank_step_plain(parts, r, inv_out, dangling_mask,
                                        damping)
        return r_new, (r_new - r).abs().sum(0, keepdim=True)
    for name, t in (("r", r), ("inv_out", inv_out),
                    ("dangling_mask", dangling_mask)):
        _cuda.check_input("ell_pagerank", name, t, torch.float32, n)
    for ids, colsT in parts:
        if colsT.dtype != torch.int32 or colsT.dim() != 2 or \
                not colsT.is_contiguous():
            raise ValueError(f"ell_pagerank: colsT must be a contiguous (w, "
                             f"rows) int32 tensor, got {colsT.dtype} "
                             f"{tuple(colsT.shape)}")
        _cuda.check_input("ell_pagerank", "node_ids", ids, torch.int32,
                          colsT.shape[1])
    _r0, d, _tol, base = _scalars(n, damping, 0.0)
    f32 = dict(dtype=torch.float32, device=r.device)
    contrib, r_new = torch.empty(n + 1, **f32), torch.empty(n, **f32)
    plan = rows_plan(parts)
    buf = torch.empty(n + plan.counters, dtype=torch.int32,
                      device=r.device)  # acc, then the rows' counters
    partial, scalars = torch.empty(MAX_BLOCKS, **f32), torch.empty(2, **f32)
    lib, p, s = _cuda.lib(), _cuda.ptr, _cuda.stream_ptr(r)
    _cuda.check(lib.fk_ell_pagerank_prep(
        p(r), p(inv_out), p(dangling_mask), n, p(contrib), p(buf),
        buf.numel(), p(partial), partial.numel(), p(scalars), s),
        "ell_pagerank")
    ell_rows("ell_pagerank", parts, plan, contrib, n, buf)
    acc = buf[:n]
    _cuda.check(lib.fk_ell_pagerank_update(
        p(r), p(acc), n, float(d), float(base), p(r_new), p(partial),
        partial.numel(), p(scalars), s), "ell_pagerank")
    _cuda.count_launch("ell_pagerank")
    return r_new, scalars[1:]


def ell_pagerank_step_plain(parts, r, inv_out, dangling_mask, damping):
    """Plain PyTorch version of K18's step: falkordb_tpu's
    `_step_ell_pagerank` (gather by the clipped cols, sum over the width,
    set by node id; uncovered nodes sum to 0)."""
    n = r.shape[0]
    dev = r.device
    _r0, d, _tol, base = _scalars(max(n, 1), damping, 0.0)
    contrib = torch.cat([r * inv_out, torch.zeros(1, dtype=torch.float32,
                                                  device=dev)])
    acc = torch.zeros(n + 1, dtype=torch.float32, device=dev)
    for ids, colsT in parts:
        acc[ids.to(torch.int64)] = contrib[colsT.to(torch.int64).clamp(
            0, n)].sum(0)
    n_t = torch.full((1,), float(n), dtype=torch.float32, device=dev)
    dangling = (r * dangling_mask).sum(0, keepdim=True) / n_t
    return torch.tensor(base, device=dev) + torch.tensor(d, device=dev) * (
        acc[:n] + dangling)


def pagerank_ell(ell, outdeg, damping=0.85, tol=1e-4, max_iters=100):
    """PageRank over the blocked-ELL TRANSPOSE adjacency `ell` (rows =
    destinations, neighbour lists = sources), `outdeg` the ORIGINAL graph's
    (n,) out-degrees: (n,) float32 scores.  Runs where the buckets lie (the
    card for numpy buckets)."""
    return pagerank_ell_run(ell, outdeg, damping, tol, max_iters)[0]


def pagerank_ell_run(ell, outdeg, damping=0.85, tol=1e-4, max_iters=100):
    """pagerank_ell with its steps and last L1 change: (r, steps, l1).  The
    reference's loop: at most max_iters steps, stopping after the first
    whose L1 change, read on the host, is <= tol."""
    dev = ell_device(ell)
    n = ell.n
    parts = ell_reach_parts(ell, dev, by_range=False)
    od = as_tensor(np.asarray(outdeg, dtype=np.float32)
                   if not isinstance(outdeg, torch.Tensor) else outdeg,
                   dev).to(torch.float32)
    inv_out = torch.where(od > 0, 1.0 / od.clamp(min=1),
                          torch.zeros((), dtype=torch.float32, device=dev))
    dmask = (od == 0).to(torch.float32)
    r0, *_ = _scalars(max(n, 1), damping, tol)
    r = torch.full((n,), float(r0), dtype=torch.float32, device=dev)
    steps, err = 0, 0.0
    for _ in range(max_iters):
        r2, l1 = ell_pagerank_step(parts, r, inv_out, dmask, damping)
        err = float(l1)  # the host read of each step
        r = r2
        steps += 1
        if err <= tol:
            break
    return r, steps, err
