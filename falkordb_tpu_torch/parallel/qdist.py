"""Device-sharded MATCH traversal: the query path on the mesh.

A port of falkordb_tpu/parallel/qdist.py.  The snapshot's global edge table
(src, dst, type, alive, eid) is cut into equal static shards over the
mesh's 'e' axis, one on each shard's device, and cached on the snapshot
(fork() drops the cache; in-place writes invalidate it through
GraphStore._invalidate's prefix pop under "e_deleted:").  A frontier of
batch source nodes is deduped, sorted, padded to a power of two with 2^31-1
and replicated; each shard scans its edges with K23 (csrc/shard_expand.cu)
and compacts the hits into a frame of fixed capacity, with the full hit
count, so the host retries with a doubled capacity on overflow.  The host
joins the (unique source, dst, eid) hits back to batch rows; duplicate
source bindings keep their multiplicity.

Each orientation of an undirected pattern is its own frame, and the
reversed one drops self-loops, so a loop binds once, as on the CSR path
(Traverse._matrices' drop_self).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from falkordb_tpu_torch.native import cuda as _cuda
from falkordb_tpu_torch.parallel.mesh import replicate
from falkordb_tpu_torch.parallel.router import maybe_mesh

_SENTINEL = np.int32(2**31 - 1)

# below this edge count a single card wins (per-call overhead and the
# replicated frontier exchange dominate); "force" routes regardless
DEFAULT_MIN_EDGES = 200_000
_TILE = 2048  # K23's edges a block (csrc/shard_expand.cu kTile)


def min_frontier():
    """Frontier size below which the local CSR path beats the mesh scan
    (the shard scan costs O(m/p) whatever the frontier).  Set per query
    with FALKOR_DIST_MIN_FRONTIER; "force" mode ignores it."""
    return int(os.environ.get("FALKOR_DIST_MIN_FRONTIER", "4096"))


def frontier_gate(n_frontier: int) -> bool:
    """True when the mesh route should run for this frontier."""
    if os.environ.get("FALKOR_DIST_QUERY", "auto") == "force":
        return True
    return n_frontier >= min_frontier()


def maybe_query_mesh(g):
    """The mesh for MATCH-path expansion, or None.

    FALKOR_DIST_QUERY: "0" off, "force" always, "auto" (default) routes
    when the store's mesh has two or more devices (parallel/router.py) and
    the graph is large enough for the scan to pay for the exchange."""
    mode = os.environ.get("FALKOR_DIST_QUERY", "auto")
    if mode == "0":
        return None
    mesh = maybe_mesh(g.device)
    if mesh is None or "e" not in mesh.axis_names:
        return None
    if mode == "force":
        return mesh
    return mesh if g.edge_max >= DEFAULT_MIN_EDGES else None


def edge_table(g, mesh):
    """The snapshot's sharded global edge table: per shard (es, ed, et,
    alive, eid) on its device, cached per mesh."""
    nd = mesh.devices.size
    # keyed under e_deleted: every edge mutation (create, delete, recycle)
    # invalidates that array, so the prefix pop catches them all
    key = "e_deleted:dist:" + ",".join(map(str, mesh.flat))
    cached = g._dev.get(key)
    if cached is not None:
        return cached
    m = int(g.edge_max)
    per = -(-max(m, 1) // nd)
    cap = per * nd
    es = np.zeros(cap, np.int32)
    ed = np.zeros(cap, np.int32)
    et = np.full(cap, -1, np.int32)
    alive = np.zeros(cap, bool)
    if m:
        es[:m] = g.e_src[:m]
        ed[:m] = g.e_dst[:m]
        et[:m] = g.e_type[:m]
        alive[:m] = ~g.e_deleted[:m]
    eid = np.arange(cap, dtype=np.int32)
    tbl = [tuple(torch.from_numpy(a[k * per:(k + 1) * per]).to(d)
                 for a in (es, ed, et, alive, eid))
           for k, d in enumerate(mesh.flat)]
    g._dev[key] = tbl
    return tbl


def shard_expand(es, ed, et, alive, eid, uniq, tlut, *, cap, endpoint,
                 drop_self=False):
    """One shard's edge scan (K23): for orientation 0 (key es: out), 1
    (key ed: in), or both from one scan (endpoint 2, the reversed one
    dropping self-loops), a frame (uid, dst, eid, vmask, cnt): the hits in
    edge order, uid the hit's index in uniq, -1 past the count, cnt the
    full hit count (one int32).  Returns a list of one or two frames."""
    if not _cuda.on_cuda(es, ed, et, alive, eid, uniq, tlut):
        return shard_expand_plain(es, ed, et, alive, eid, uniq, tlut,
                                  cap=cap, endpoint=endpoint,
                                  drop_self=drop_self)
    per = es.numel()
    for name, t, dt in (("es", es, torch.int32), ("ed", ed, torch.int32),
                        ("et", et, torch.int32), ("alive", alive, torch.bool),
                        ("eid", eid, torch.int32)):
        _cuda.check_input("shard_expand", name, t, dt, per)
    _cuda.check_input("shard_expand", "uniq", uniq, torch.int32)
    _cuda.check_input("shard_expand", "tlut", tlut, torch.bool)
    if uniq.numel() == 0 or tlut.numel() == 0:
        raise ValueError("shard_expand: empty frontier or type LUT")
    dev = es.device
    n_orient = 2 if endpoint == 2 else 1
    ntiles = -(-per // _TILE)
    counts = torch.empty((n_orient, ntiles), dtype=torch.int64, device=dev)
    p = _cuda.ptr
    table = (p(es), p(ed), p(et), p(alive), p(eid), per, p(uniq),
             uniq.numel(), p(tlut), tlut.numel(), endpoint, int(drop_self))
    with torch.cuda.device(dev):
        lib = _cuda.lib()
        _cuda.check(lib.fk_shard_expand_count(*table, p(counts),
                                              _cuda.stream_ptr(es)),
                    "shard_expand")
        _cuda.count_launch("shard_expand")
        # the exclusive scan of the tile counts between the two passes
        offs = torch.cumsum(counts, dim=1) - counts
        frames = [(torch.empty(cap, dtype=torch.int32, device=dev),
                   torch.empty(cap, dtype=torch.int32, device=dev),
                   torch.empty(cap, dtype=torch.int32, device=dev),
                   torch.empty(cap, dtype=torch.bool, device=dev),
                   torch.empty(1, dtype=torch.int32, device=dev))
                  for _ in range(n_orient)]
        second = frames[-1]
        _cuda.check(lib.fk_shard_expand_write(
            *table, p(counts), p(offs), cap, *map(p, frames[0]),
            *map(p, second), _cuda.stream_ptr(es)), "shard_expand")
        _cuda.count_launch("shard_expand")
    return frames


def shard_expand_plain(es, ed, et, alive, eid, uniq, tlut, *, cap, endpoint,
                       drop_self=False):
    """Plain PyTorch version of `shard_expand` (the reference's orient:
    searchsorted, clip, compare, LUT, nonzero to cap)."""
    def orient(ep, drop):
        key = es if ep == 0 else ed
        pos = torch.searchsorted(uniq, key).clamp(0, uniq.numel() - 1)
        hit = (uniq[pos] == key) & alive & (et >= 0)
        hit &= tlut[et.to(torch.int64).clamp(0, tlut.numel() - 1)]
        if drop:
            hit &= es != ed
        idx = torch.nonzero(hit)[:, 0]
        cnt = idx.numel()
        take = idx[:cap]
        k = take.numel()
        other = ed if ep == 0 else es
        frame = []
        for src in (pos.to(torch.int32), other, eid):
            out = torch.full((cap,), -1, dtype=torch.int32, device=es.device)
            out[:k] = src[take]
            frame.append(out)
        vmask = torch.zeros(cap, dtype=torch.bool, device=es.device)
        vmask[:k] = True
        cnt_t = torch.tensor([cnt], dtype=torch.int32, device=es.device)
        return tuple(frame) + (vmask, cnt_t)

    if endpoint != 2:
        return [orient(endpoint, drop_self)]
    return [orient(0, False), orient(1, True)]


def _type_lut(g, tids):
    n = max(len(g.schema.reltypes), 1)
    lut = np.zeros(n, bool)
    if tids is None:
        lut[:] = True
    else:
        for t in tids:
            if 0 <= t < n:
                lut[t] = True
    return lut


def expand_rows(g, mesh, srcs, valid, tids, direction):
    """Distributed one-hop expansion of a batch frontier.

    srcs: int64 node ids per batch row; valid: bool per row; tids: list of
    relationship type ids or None (all).  Returns (row, dst, eid) int64
    arrays, one entry per (batch row, matching live edge, orientation):
    exactly the multiset the CSR path emits, ordered by (row, eid).
    """
    valid_rows = np.nonzero(np.asarray(valid, bool)
                            & (srcs >= 0))[0]
    if len(valid_rows) == 0:
        z = np.zeros(0, np.int64)
        return z, z, z
    keys = srcs[valid_rows].astype(np.int64)
    perm = np.argsort(keys, kind="stable")
    sorted_keys = keys[perm]
    uniq = np.unique(sorted_keys).astype(np.int32)
    bpad = 1
    while bpad < len(uniq):
        bpad *= 2
    uniq_pad = np.full(bpad, _SENTINEL, np.int32)
    uniq_pad[: len(uniq)] = uniq
    tlut = _type_lut(g, tids)
    tbl = edge_table(g, mesh)
    # 'both' runs both orientations from a single shard scan (endpoint=2;
    # the reversed orientation drops self-loops so a loop binds once)
    endpoint = {"out": 0, "in": 1, "both": 2}[direction]

    starts = np.searchsorted(sorted_keys, uniq, side="left")
    ends = np.searchsorted(sorted_keys, uniq, side="right")
    counts = (ends - starts).astype(np.int64)

    uniq_d = replicate(mesh, uniq_pad)
    tlut_d = replicate(mesh, tlut)
    cap = 2048
    while True:
        per_shard = [shard_expand(*tbl[k], uniq_d[k], tlut_d[k], cap=cap,
                                  endpoint=endpoint)
                     for k in range(len(tbl))]
        mx = max(int(f[4].item()) for fr in per_shard for f in fr)
        if mx <= cap:
            break
        while cap < mx:
            cap *= 2
    rows_all, dsts_all, eids_all = [], [], []
    # the reference's frames: each orientation over the shards in order
    for o in range(len(per_shard[0])):
        frame = [torch.cat([fr[o][i].cpu() for fr in per_shard]).numpy()
                 for i in range(4)]
        uid, dst, eid, vm = frame
        u = uid[vm].astype(np.int64)
        d = dst[vm].astype(np.int64)
        e = eid[vm].astype(np.int64)
        if len(u) == 0:
            continue
        # join matched unique sources back to their batch rows
        rep = counts[u]
        total = int(rep.sum())
        if total == 0:
            continue
        base = np.repeat(starts[u], rep)
        csum = np.cumsum(rep) - rep
        offs = np.arange(total, dtype=np.int64) - np.repeat(csum, rep)
        rows_all.append(valid_rows[perm[base + offs]])
        dsts_all.append(np.repeat(d, rep))
        eids_all.append(np.repeat(e, rep))
    if not rows_all:
        z = np.zeros(0, np.int64)
        return z, z, z
    row = np.concatenate(rows_all)
    dst = np.concatenate(dsts_all)
    eid = np.concatenate(eids_all)
    # deterministic frame order: (row, eid)
    order = np.lexsort((eid, row))
    return row[order], dst[order], eid[order]
