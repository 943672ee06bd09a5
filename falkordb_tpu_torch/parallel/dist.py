"""Edge-partitioned graph algorithms over a device mesh (parallel/mesh.py).

A port of falkordb_tpu/parallel/dist.py.  The edge list is cut into equal
static shards (sorted by dst within a shard, so each shard's reduce is a
sorted segment reduce); node vectors (frontier, rank, distance, labels) are
replicated in the 1D layout, or block-sharded over an (R, C) mesh in the 2D
one.  Each step is, at every shard, K24 (the gather and segment reduce of
its edges, parallel/shard_ops.py), then a collective of parallel/mesh.py,
then K26 (the vector update) or, for the bit-packed frontier, K25.  The
host sharding (numpy), the host loops and each driver's stopping rule are
the reference's:

- dist_bfs keeps levels < max_levels (it stops before recording the level
  it has just found), dist_bfs_fused and the bitmap drivers <= max_levels;
- dist_bfs_2d pads its levels with -2 and returns levels[:n];
- dist_pagerank stops at a float32 L1 change <= tol; the fused and 2D
  PageRanks run a fixed count.

The reference runs each fused driver's loop inside one XLA program; here a
fused driver is a host loop that reads one device flag a level, as the
single-card kernels do.  A replicated value is computed once per distinct
device and shared by the shards there.  The 1D host-driven and fused
drivers return a tensor on the first shard's device; the bitmap and 2D
drivers return host levels[:n] (numpy), as the reference's do.
Each full driver takes `stats`, a dict that gets its steps (levels or
iterations run) and its host sharding seconds when given."""

from __future__ import annotations

import time

import numpy as np
import torch

from falkordb_tpu_torch.parallel import mesh as M
from falkordb_tpu_torch.parallel import shard_ops as K
from falkordb_tpu_torch.parallel.mesh import Mesh

def _visible_cuda() -> list:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible: pass the mesh's "
                           "devices")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(devices=None, axis="e") -> Mesh:
    """A 1D mesh over `devices` (default: every visible CUDA device)."""
    devices = list(devices) if devices is not None else _visible_cuda()
    return Mesh(devices, (axis,))


def _stable_argsort(keys):
    """np.argsort(keys, kind="stable") (the same permutation: a stable sort
    has one), by torch's multi-threaded sort on the host: numpy's takes
    seconds at tens of millions of edges."""
    keys = np.ascontiguousarray(keys)
    return torch.sort(torch.from_numpy(keys), stable=True).indices.numpy()


def _take(a, order):
    """a[order], by torch's multi-threaded gather on the host."""
    return torch.from_numpy(np.ascontiguousarray(a))[
        torch.from_numpy(order)].numpy()


def shard_edges_1d(src, dst, w, n_devices, sort_by="dst"):
    """Partition an edge list into n_devices equal static shards.

    Edges are sorted by dst and dealt round-robin-contiguously so each
    shard's segment-reduce stays sorted; shards are padded to equal length
    with (-1) sentinels (masked in-kernel)."""
    src = np.asarray(src, dtype=np.int32)
    dst = np.asarray(dst, dtype=np.int32)
    m = len(src)
    order = _stable_argsort(dst if sort_by == "dst" else src)
    src, dst = _take(src, order), _take(dst, order)
    if w is not None:
        w = _take(np.asarray(w, dtype=np.float32), order)
    per = -(-m // n_devices)
    cap = per * n_devices
    ps = np.full(cap, 0, dtype=np.int32)
    # pad with the max dst so the tail shard stays sorted for the
    # indices_are_sorted segment reduces (masked to the identity anyway)
    pad_dst = int(dst[-1]) if m and sort_by == "dst" else 0
    pd = np.full(cap, pad_dst, dtype=np.int32)
    pv = np.ones(cap, dtype=np.float32)
    mask = np.zeros(cap, dtype=np.int32)
    ps[:m] = src
    pd[:m] = dst
    mask[:m] = 1
    if w is not None:
        pv[:m] = w
    return (ps.reshape(n_devices, per), pd.reshape(n_devices, per),
            pv.reshape(n_devices, per), mask.reshape(n_devices, per))


class _Plans:
    """K24's segment plan of each shard's dst, found once a sharding."""

    def __init__(self):
        self._held = {}

    def __call__(self, dst, nseg):
        key = (id(dst), nseg)
        hit = self._held.get(key)
        if hit is None or hit[0] is not dst:
            hit = (dst, K.segment_plan(dst, nseg))
            self._held[key] = hit
        return hit[1]


def _reduce(mesh, plans, form, nseg, srcs, dsts, masks, x, ws=None,
            xs=None):
    """K24 at every shard: a list of partials of nseg segments."""
    return M.per_shard(
        mesh, lambda s, d, m, xx, w, sc: K.shard_reduce(
            form, s, d, m, xx, nseg, w=w, xs=sc, plan=plans(d, nseg)),
        srcs, dsts, masks, x, ws, xs)


def _shard_1d(mesh, src_ids, dst_ids, w, stats):
    t0 = time.perf_counter()
    ps, pd, pv, mask = shard_edges_1d(src_ids, dst_ids, w,
                                      mesh.devices.size)
    out = tuple(M.scatter_rows(mesh, a) for a in (ps, pd, pv, mask))
    if stats is not None:
        stats["shard_s"] = time.perf_counter() - t0
    return out


def _done(stats, steps):
    if stats is not None:
        stats["steps"] = steps


def _source_vectors(n, source):
    levels = np.where(np.arange(n) == source, 0, -1).astype(np.int32)
    frontier = (np.arange(n) == source).astype(np.int32)
    return levels, frontier


# ------------------------------------------------------------ 1D steps


def _bfs_level(mesh, n, plans, srcs, dsts, masks, frontier, levels, depth,
               with_levels=True):
    part = _reduce(mesh, plans, "or", n, srcs, dsts, masks, frontier)
    reach = M.psum(part, mesh, mesh.axis_names[0])
    return M.unzip(M.per_device(
        mesh, lambda r, lv: K.bfs_update(r, lv, depth, with_levels),
        reach, levels))


def dist_bfs_level(mesh, n):
    """A one-level BFS step over the mesh: step(srcs, dsts, masks, frontier,
    levels) over lists of shard tensors returns (fresh, fresh), fresh the
    replicated int32 0/1 vector of newly reached nodes."""
    plans = _Plans()

    def step(srcs, dsts, masks, frontier, levels):
        fresh, _, _ = _bfs_level(mesh, n, plans, srcs, dsts, masks,
                                 frontier, levels, 0, with_levels=False)
        return fresh, fresh

    return step


def _pagerank_step(mesh, n, damping, plans, srcs, dsts, ws, masks, rank,
                   inv_out, dangling, l1=False, comm=True):
    part = _reduce(mesh, plans, "sum", n, srcs, dsts, masks, rank, ws,
                   inv_out)
    acc = M.psum(part, mesh, mesh.axis_names[0]) if comm else part

    def update(a, r, dm):
        return K.pagerank_update(a, r, K.dot_sum(r, dm), n, damping, l1=l1)

    # without the collective every shard holds a rank of its own
    each = M.per_device if comm else M.per_shard
    return M.unzip(each(mesh, update, acc, rank, dangling))


def dist_pagerank_step(mesh, n, damping=0.85):
    """One PageRank iteration over the mesh (rank replicated, edges
    sharded): step(srcs, dsts, ws, masks, rank, inv_out, dangling_mask)
    returns the new rank.  inv_out must be precomputed per node."""
    plans = _Plans()

    def step(srcs, dsts, ws, masks, rank, inv_out, dangling_mask):
        return _pagerank_step(mesh, n, damping, plans, srcs, dsts, ws, masks,
                              rank, inv_out, dangling_mask)[0]

    return step


def _min_step(mesh, n, plans, form, srcs, dsts, masks, x, ws=None):
    part = _reduce(mesh, plans, form, n, srcs, dsts, masks, x, ws)
    best = M.pmin(part, mesh, mesh.axis_names[0])
    return M.unzip(M.per_device(mesh, K.min_update, x, best))


def dist_sssp_step(mesh, n):
    """One min-plus SSSP relaxation over the mesh: step(srcs, dsts, ws,
    masks, dist) returns the new replicated dist (pmin across shards)."""
    plans = _Plans()

    def step(srcs, dsts, ws, masks, dist):
        return _min_step(mesh, n, plans, "minplus", srcs, dsts, masks, dist,
                         ws)[0]

    return step


# ------------------------------------------------------------ full drivers


def dist_bfs(mesh, src_ids, dst_ids, w, n, source, max_levels=None,
             stats=None):
    """Full distributed BFS; host-driven level loop.  Keeps levels
    < max_levels: the loop stops before recording the level it found."""
    ps, pd, _pv, mask = _shard_1d(mesh, src_ids, dst_ids, w, stats)
    plans = _Plans()
    lv0, f0 = _source_vectors(n, source)
    levels, frontier = M.replicate(mesh, lv0), M.replicate(mesh, f0)
    depth = 0
    while True:
        depth += 1
        fresh, nxt, count = _bfs_level(mesh, n, plans, ps, pd, mask,
                                       frontier, levels, depth)
        nnew = int(count[0].item())
        if nnew == 0 or (max_levels and depth >= max_levels):
            break
        levels, frontier = nxt, fresh
    _done(stats, depth)
    return levels[0]


def dist_sssp(mesh, src_ids, dst_ids, w, n, source, max_iters=None,
              stats=None):
    """Distributed Bellman-Ford SSSP; the host checks the fixpoint."""
    ps, pd, pv, mask = _shard_1d(mesh, src_ids, dst_ids, w, stats)
    plans = _Plans()
    d0 = np.full(n, np.inf, dtype=np.float32)
    d0[source] = 0.0
    dist = M.replicate(mesh, d0)
    it = 0
    while True:
        new, changed = _min_step(mesh, n, plans, "minplus", ps, pd, mask,
                                 dist, pv)
        it += 1
        dist = new
        if not int(changed[0].item()) or (max_iters and it >= max_iters):
            _done(stats, it)
            return dist[0]


def _symmetric(src_ids, dst_ids):
    s = np.concatenate([np.asarray(src_ids), np.asarray(dst_ids)])
    d = np.concatenate([np.asarray(dst_ids), np.asarray(src_ids)])
    return s, d


def dist_wcc(mesh, src_ids, dst_ids, n, max_iters=None, stats=None):
    """Distributed weakly connected components: min-label propagation over
    the symmetrised edge list."""
    ps, pd, _pv, mask = _shard_1d(mesh, *_symmetric(src_ids, dst_ids), None,
                                  stats)
    plans = _Plans()
    labels = M.replicate(mesh, np.arange(n, dtype=np.int32))
    it = 0
    while True:
        new, changed = _min_step(mesh, n, plans, "min", ps, pd, mask, labels)
        it += 1
        labels = new
        if not int(changed[0].item()) or (max_iters and it >= max_iters):
            _done(stats, it)
            return labels[0]


def _pagerank_vectors(src_ids, n):
    outdeg = np.bincount(np.asarray(src_ids, dtype=np.int64), minlength=n)
    inv_out = np.where(outdeg > 0, 1.0 / np.maximum(outdeg, 1), 0.0).astype(
        np.float32)
    dangling = (outdeg == 0).astype(np.float32)
    return inv_out, dangling


def dist_pagerank(mesh, src_ids, dst_ids, n, iters=100, damping=0.85,
                  tol=1e-4, stats=None):
    """PageRank over the mesh, stopping after the step whose float32 L1
    change is <= tol (or after iters steps)."""
    ps, pd, pv, mask = _shard_1d(mesh, src_ids, dst_ids, None, stats)
    plans = _Plans()
    inv_out, dangling = _pagerank_vectors(src_ids, n)
    r = M.replicate(mesh, np.full(n, 1.0 / n, dtype=np.float32))
    inv_out, dangling = M.replicate(mesh, inv_out), M.replicate(mesh,
                                                                dangling)
    steps = 0
    for _ in range(iters):
        new, l1 = _pagerank_step(mesh, n, damping, plans, ps, pd, pv, mask, r,
                                 inv_out, dangling, l1=tol is not None)
        steps += 1
        done = tol is not None and float(l1[0].item()) <= tol
        r = new
        if done:
            break
    _done(stats, steps)
    return r[0]


# ------------------------------------------------------- fused level loops


def dist_bfs_fused(mesh, src_ids, dst_ids, n, source, max_levels=None,
                   stats=None):
    """1D BFS with the fused driver's rule: a level runs while the frontier
    is not empty and fewer than max_levels (default n) have run, so levels
    <= max_levels are kept."""
    ps, pd, _pv, mask = _shard_1d(mesh, src_ids, dst_ids, None, stats)
    plans = _Plans()
    lv0, f0 = _source_vectors(n, source)
    levels, frontier = M.replicate(mesh, lv0), M.replicate(mesh, f0)
    cap = max_levels if max_levels else n
    d, alive = 0, bool(f0.any())
    while alive and d < cap:
        frontier, levels, count = _bfs_level(mesh, n, plans, ps, pd, mask,
                                             frontier, levels, d + 1)
        d += 1
        alive = int(count[0].item()) > 0
    _done(stats, d)
    return levels[0]


def _pack_host(bits):
    fb = np.asarray(bits, dtype=np.uint32)
    return np.bitwise_or.reduce(
        fb.reshape(-1, 32) << np.arange(32, dtype=np.uint32),
        axis=1).astype(np.uint32)


def dist_bfs_fused_bitmap(mesh, src_ids, dst_ids, n, source,
                          max_levels=None, stats=None):
    """1D BFS with the bit-packed frontier exchange: pack the shard's
    partial (K25), all_to_all the word blocks, OR each shard's blocks (K25),
    all_gather the merged blocks, then K25's level epilogue.  Returns host
    levels[:n]."""
    nd = mesh.devices.size
    axis = mesh.axis_names[0]
    ncap = -(-n // (32 * nd)) * (32 * nd)
    ps, pd, _pv, mask = _shard_1d(mesh, src_ids, dst_ids, None, stats)
    plans = _Plans()
    cap = max_levels if max_levels else n
    levels = np.full(ncap, -1, dtype=np.int32)
    levels[source] = 0
    fb = np.zeros(ncap, dtype=np.uint32)
    fb[source] = 1
    fwords = _pack_host(fb)
    fw, lv = M.replicate(mesh, fwords), M.replicate(mesh, levels)
    d, alive = 0, bool(fwords.any())
    while alive and d < cap:
        f = M.per_device(mesh, K.unpack_bits, fw)
        part = _reduce(mesh, plans, "or", ncap, ps, pd, mask, f)
        got = M.all_to_all(M.per_shard(mesh, K.pack_bits, part), mesh, axis)
        mine = M.per_shard(mesh, lambda g: K.or_fold(g, nd), got)
        reach = M.all_gather(mine, mesh, axis)
        fw, lv, anyf = M.unzip(M.per_device(
            mesh, lambda r, x, dd=d: K.bits_epilogue(r, x, dd), reach, lv))
        d += 1
        alive = bool(anyf[0].item())
    _done(stats, d)
    return lv[0].cpu().numpy()[:n]


def dist_pagerank_fused(mesh, src_ids, dst_ids, n, iters=20, damping=0.85,
                        no_comm=False, stats=None):
    """1D PageRank, a fixed number of steps.  no_comm=True leaves out the
    collective (each shard keeps its own partial rank, so the result is
    WRONG by design: the zero-collective timing control) and returns the
    psum of the shards' rank sums broadcast to (n,)."""
    ps, pd, pv, mask = _shard_1d(mesh, src_ids, dst_ids, None, stats)
    plans = _Plans()
    inv_out, dangling = _pagerank_vectors(src_ids, n)
    r = M.replicate(mesh, np.full(n, 1.0 / n, dtype=np.float32))
    inv_out, dangling = M.replicate(mesh, inv_out), M.replicate(mesh,
                                                                dangling)
    for _ in range(iters):
        r, _ = _pagerank_step(mesh, n, damping, plans, ps, pd, pv, mask, r,
                              inv_out, dangling, comm=not no_comm)
    _done(stats, iters)
    if no_comm:
        tot = M.psum(M.per_shard(mesh, K.dot_sum, r), mesh,
                     mesh.axis_names[0])
        return tot[0].expand(n).clone()
    return r[0]


def dist_sssp_fused(mesh, src_ids, dst_ids, w, n, source, max_iters=None,
                    stats=None):
    """1D min-plus SSSP with the fused driver's rule: steps run while one
    changed a distance and fewer than max_iters (default n) have run."""
    ps, pd, pv, mask = _shard_1d(mesh, src_ids, dst_ids, w, stats)
    plans = _Plans()
    d0 = np.full(n, np.inf, dtype=np.float32)
    d0[source] = 0.0
    dist = M.replicate(mesh, d0)
    cap = max_iters if max_iters else n
    changed, it = True, 0
    while changed and it < cap:
        dist, ch = _min_step(mesh, n, plans, "minplus", ps, pd, mask, dist,
                             pv)
        changed = bool(ch[0].item())
        it += 1
    _done(stats, it)
    return dist[0]


def dist_wcc_fused(mesh, src_ids, dst_ids, n, max_iters=None,
                   stats=None):
    """1D WCC with the fused driver's rule (as dist_sssp_fused)."""
    ps, pd, _pv, mask = _shard_1d(mesh, *_symmetric(src_ids, dst_ids), None,
                                  stats)
    plans = _Plans()
    labels = M.replicate(mesh, np.arange(n, dtype=np.int32))
    cap = max_iters if max_iters else n
    changed, it = True, 0
    while changed and it < cap:
        labels, ch = _min_step(mesh, n, plans, "min", ps, pd, mask, labels)
        changed = bool(ch[0].item())
        it += 1
    _done(stats, it)
    return labels[0]


# ------------------------------------------------------- 2D edge partition
#
# Device (i, j) of an (R x C) mesh owns the edges whose dst block lies in
# row i and whose src block lies in column j; node block b (of `chunk`
# nodes) lives on device (b // C, b % C), shard b in row-major order.  A
# level all-gathers the column's frontier blocks along 'r', reduces the
# shard's edges into the row's dst range (K24), and combines along 'c'.


def make_mesh_2d(devices=None, rows=None, axes=("r", "c")) -> Mesh:
    devices = list(devices if devices is not None else _visible_cuda())
    nd = len(devices)
    if rows is None:
        rows = int(np.sqrt(nd))
        while nd % rows:
            rows -= 1
    grid = np.empty(nd, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(rows, nd // rows), axes)


def shard_edges_2d(src, dst, n, mesh, w=None, align=1, stats=None):
    """Partition edges onto the (R x C) mesh with pre-localized indices:
    (src_local, dst_local, mask[, w]), each a list of R*C per-shard tensors
    in row-major order on the shards' devices, plus chunk.  src_local
    indexes the row-'r' all-gather of column j's frontier blocks;
    dst_local row i's contiguous dst range, sorted, padded with C*chunk - 1.
    `align` rounds chunk up (32 for the bit-packed exchange).
    stats["shard_s"] gets the seconds."""
    t0 = time.perf_counter()
    R, C = mesh.devices.shape
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    chunk = -(-n // (R * C))
    chunk = -(-chunk // align) * align
    b_src, b_dst = src // chunk, dst // chunk
    dev_j = b_src % C
    dev_i = b_dst // C
    src_local_all = (b_src // C) * chunk + src % chunk
    per = 0
    blocks = {}
    for i in range(R):
        for j in range(C):
            sel = np.nonzero((dev_i == i) & (dev_j == j))[0]
            d_loc = dst[sel] - i * C * chunk
            s_loc = src_local_all[sel]
            order = _stable_argsort(d_loc)
            wv = None if w is None else np.asarray(w, np.float32)[sel][order]
            blocks[i, j] = (s_loc[order], d_loc[order], wv)
            per = max(per, len(sel), 1)
    ps = np.zeros((R, C, per), dtype=np.int32)
    # pad dst_local with the max segment id so the sorted-reduce invariant
    # holds past the real edges (their masked contribution is the identity)
    pd = np.full((R, C, per), C * chunk - 1, dtype=np.int32)
    mask = np.zeros((R, C, per), dtype=np.int32)
    pw = np.zeros((R, C, per), dtype=np.float32) if w is not None else None
    for (i, j), (s, d, wv) in blocks.items():
        k = len(s)
        ps[i, j, :k] = s
        pd[i, j, :k] = d
        mask[i, j, :k] = 1
        if pw is not None:
            pw[i, j, :k] = wv
    arrays = (ps, pd, mask) + ((pw,) if pw is not None else ())
    out = tuple(M.scatter_rows(mesh, a) for a in arrays) + (chunk,)
    if stats is not None:
        stats["shard_s"] = time.perf_counter() - t0
    return out


def _blocks(mesh, vec, chunk):
    R, C = mesh.devices.shape
    return M.scatter_rows(mesh, np.asarray(vec).reshape(R, C, chunk))


def _gather_host(parts, n):
    return torch.cat([p.cpu() for p in parts]).numpy()[:n]


def _total(mesh, flags) -> int:
    return int(M.psum(flags, mesh, ("r", "c"))[0].item())


def dist_bfs_2d(mesh, src_ids, dst_ids, n, source, max_levels=None,
                stats=None):
    """BFS over the 2D edge partition (dense int32 frontier blocks): per
    level an all_gather along 'r', K24 into the row's dst range, a psum
    along 'c', the shard's own block of it, K26.  Keeps levels <
    max_levels, as dist_bfs; returns host levels[:n]."""
    R, C = mesh.devices.shape
    ps, pd, mask, chunk = shard_edges_2d(src_ids, dst_ids, n, mesh,
                                         stats=stats)
    ncap = chunk * R * C
    plans = _Plans()
    levels = np.full(ncap, -2, dtype=np.int32)
    levels[:n] = -1
    levels[source] = 0
    frontier = np.zeros(ncap, dtype=np.int32)
    frontier[source] = 1
    levels_d, frontier_d = _blocks(mesh, levels, chunk), _blocks(
        mesh, frontier, chunk)
    depth = 0
    while True:
        col = M.all_gather(frontier_d, mesh, "r")
        part = _reduce(mesh, plans, "or", C * chunk, ps, pd, mask, col)
        row = M.psum(part, mesh, "c")
        my = [row[k][(k % C) * chunk:(k % C + 1) * chunk]
              for k in range(R * C)]
        depth += 1
        fresh, nxt, count = M.unzip(M.per_shard(
            mesh, lambda r, lv, dd=depth: K.bfs_update(r, lv, dd), my,
            levels_d))
        nnew = _total(mesh, count)
        if nnew == 0 or (max_levels and depth >= max_levels):
            break
        levels_d, frontier_d = nxt, fresh
    _done(stats, depth)
    return _gather_host(levels_d, n)


def dist_bfs_2d_bitmap(mesh, src_ids, dst_ids, n, source, max_levels=None,
                       stats=None):
    """2D BFS with the bit-packed exchange: all_gather of the column's
    frontier words along 'r', K25 unpack, K24, K25 pack, all_to_all along
    'c', K25's OR fold and epilogue; a level runs while some shard found a
    node and fewer than max_levels (default n) have run.  Returns host
    levels[:n]."""
    R, C = mesh.devices.shape
    ps, pd, mask, chunk = shard_edges_2d(src_ids, dst_ids, n, mesh, align=32,
                                         stats=stats)
    ncap = chunk * R * C
    W = chunk // 32
    plans = _Plans()
    cap = max_levels if max_levels else n
    levels = np.full(ncap, -1, dtype=np.int32)
    levels[source] = 0
    fb = np.zeros(ncap, dtype=np.uint32)
    fb[source] = 1
    fbits, lv = _blocks(mesh, _pack_host(fb), W), _blocks(mesh, levels, chunk)
    d, alive = 0, True
    while alive and d < cap:
        col = M.per_shard(mesh, K.unpack_bits, M.all_gather(fbits, mesh, "r"))
        part = _reduce(mesh, plans, "or", C * chunk, ps, pd, mask, col)
        got = M.all_to_all(M.per_shard(mesh, K.pack_bits, part), mesh, "c")
        reach = M.per_shard(mesh, lambda g: K.or_fold(g, C), got)
        fbits, lv, anyf = M.unzip(M.per_shard(
            mesh, lambda r, x, dd=d: K.bits_epilogue(r, x, dd), reach, lv))
        d += 1
        alive = _total(mesh, anyf) > 0
    _done(stats, d)
    return _gather_host(lv, n)


def dist_pagerank_2d(mesh, src_ids, dst_ids, n, iters=20, damping=0.85,
                     stats=None):
    """2D PageRank, a fixed number of steps: rank block-sharded; per step
    an all_gather along 'r', K24, a psum_scatter along 'c', the dangling
    psum over the mesh and K26 with the `val` mask.  Returns host
    rank[:n]."""
    R, C = mesh.devices.shape
    ps, pd, mask, chunk = shard_edges_2d(src_ids, dst_ids, n, mesh,
                                         stats=stats)
    ncap = chunk * R * C
    plans = _Plans()
    outdeg = np.bincount(np.asarray(src_ids, dtype=np.int64), minlength=n)
    inv_out = np.zeros(ncap, np.float32)
    inv_out[:n] = np.where(outdeg > 0, 1.0 / np.maximum(outdeg, 1), 0.0)
    dangling = np.zeros(ncap, np.float32)
    dangling[:n] = (outdeg == 0)
    valid = np.zeros(ncap, np.float32)
    valid[:n] = 1.0
    r = _blocks(mesh, valid / n, chunk)
    inv_o, dang, val = (_blocks(mesh, a, chunk)
                        for a in (inv_out, dangling, valid))
    col_inv = M.all_gather(inv_o, mesh, "r")
    for _ in range(iters):
        col = M.all_gather(r, mesh, "r")
        part = _reduce(mesh, plans, "sum", C * chunk, ps, pd, mask, col,
                       xs=col_inv)
        acc = M.psum_scatter(part, mesh, "c")
        dtot = M.psum(M.per_shard(mesh, K.dot_sum, r, dang), mesh, ("r", "c"))
        r, _ = M.unzip(M.per_shard(
            mesh, lambda a, x, ds, v: K.pagerank_update(a, x, ds, n, damping,
                                                        val=v),
            acc, r, dtot, val))
    _done(stats, iters)
    return _gather_host(r, n)


def dist_sssp_2d(mesh, src_ids, dst_ids, w, n, source, max_iters=None,
                 stats=None):
    """2D min-plus SSSP: dist block-sharded; per step an all_gather along
    'r', K24, an all_to_all along 'c' and K26's min over the C blocks; the
    changed flags are summed over the mesh.  Returns host dist[:n]."""
    R, C = mesh.devices.shape
    ps, pd, mask, pw, chunk = shard_edges_2d(src_ids, dst_ids, n, mesh, w=w,
                                             stats=stats)
    ncap = chunk * R * C
    plans = _Plans()
    cap = max_iters if max_iters else n
    d0 = np.full(ncap, np.inf, dtype=np.float32)
    d0[source] = 0.0
    dist = _blocks(mesh, d0, chunk)
    changed, it = True, 0
    while changed and it < cap:
        col = M.all_gather(dist, mesh, "r")
        part = _reduce(mesh, plans, "minplus", C * chunk, ps, pd, mask, col,
                       pw)
        got = M.all_to_all(part, mesh, "c")
        dist, ch = M.unzip(M.per_shard(mesh, K.min_update, dist, got))
        changed = _total(mesh, ch) > 0
        it += 1
    _done(stats, it)
    return _gather_host(dist, n)


def comm_bytes_per_iter(kind, layout, n, mesh_shape):
    """Analytic per-device collective bytes per iteration (ring model) for
    the scaling artifact's comm-volume breakdown."""
    if layout == "1d":
        nd = int(np.prod(mesh_shape))
        itm = 4  # int32 frontier / f32 rank
        return 2 * itm * n * (nd - 1) // max(nd, 1)
    if layout == "1dbm":  # bit-packed OR reduce-scatter (a2a) + tiled AG
        nd = int(np.prod(mesh_shape))
        return 2 * (n // 8) * (nd - 1) // max(nd, 1)
    R, C = mesh_shape
    chunk = -(-n // (R * C))
    if kind == "bfs":  # bitmap AG + bitmap A2A
        return (R - 1) * chunk // 8 + (C - 1) * chunk // 8
    # f32 AG along r + f32 reduce-scatter/all_to_all along c
    return (R - 1) * chunk * 4 + (C - 1) * chunk * 4
