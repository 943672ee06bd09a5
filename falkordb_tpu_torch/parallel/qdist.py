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

import dataclasses
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
_TILE = 4096  # K23's edges a tile (csrc/shard_expand.cu kTile)


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


_MAP = _cuda.Entry("fk_shard_map", "shard_expand")
_SCAN = _cuda.Entry("fk_shard_scan", "shard_expand")
_CONTROL: dict = {}  # CUDA device index -> K23's control area there


@dataclasses.dataclass
class FrontierMap:
    """K23's frontier bitmap on one card (csrc/shard_expand.cu `Map`):
    `words` (nwords, 2) int32, word w holding the bits of ids lo + 32w ..
    lo + 32w + 31 and the index of its first frontier entry (0 for a word
    with none); `nbits` the span; `sentinel_uid` the index of the first
    2^31-1 padding entry (-1 without one).  span / 4 bytes of memory."""
    words: torch.Tensor | None
    lo: int
    nbits: int
    sentinel_uid: int


def frontier_map(uniq, nreal=None, lo=None, hi=None) -> FrontierMap:
    """The bitmap of the sorted distinct frontier `uniq` (a CUDA tensor,
    padded with 2^31-1), built by one launch of K23's map kernel.  nreal,
    lo and hi (the real entries, the first and last id) come from the
    caller where it knows them, else from one read of uniq."""
    if nreal is None:
        h = uniq.cpu().numpy()
        nreal = int(np.searchsorted(h, _SENTINEL))
        lo = int(h[0]) if nreal else 0
        hi = int(h[nreal - 1]) if nreal else -1
    if not uniq.is_cuda:
        return frontier_map_plain(uniq, nreal, lo, hi)
    fmap = FrontierMap(None, lo, hi - lo + 1 if nreal else 0,
                       nreal if nreal < uniq.numel() else -1)
    nwords = -(-fmap.nbits // 32)
    if nwords:
        fmap.words = torch.empty((nwords, 2), dtype=torch.int32,
                                 device=uniq.device)
        _MAP.launch(uniq.get_device(), uniq.data_ptr(), nreal, lo, nwords,
                    fmap.words.data_ptr())
    return fmap


def frontier_map_plain(uniq, nreal, lo, hi) -> FrontierMap:
    """Plain PyTorch version of K23's map kernel: the bits of each word
    (scatter of the real entries) and the index of its first entry
    (searchsorted; 0 for a word with none)."""
    nbits = hi - lo + 1 if nreal else 0
    nwords = -(-nbits // 32)
    sentinel = nreal if nreal < uniq.numel() else -1
    if not nwords:
        return FrontierMap(None, lo, 0, sentinel)
    d = uniq[:nreal].to(torch.int64) - lo
    bits = torch.zeros(nwords, dtype=torch.int64, device=uniq.device)
    bits.index_add_(0, d >> 5, torch.ones_like(d) << (d & 31))
    bits = torch.where(bits >= 1 << 31, bits - (1 << 32), bits)
    first = torch.searchsorted(
        d, torch.arange(nwords, device=uniq.device) * 32)
    first = torch.where(bits != 0, first, torch.zeros_like(first))
    words = torch.stack([bits, first], 1).to(torch.int32)
    return FrontierMap(words, lo, nbits, sentinel)


def _control(dev: int, ntiles: int) -> int:
    """The address of K23's control area on CUDA device `dev` (two counters
    and a status word a tile, for at least `ntiles` tiles), zeroed at its
    allocation: every launch leaves it zero again.  Launches share it in
    stream order, one stream a card."""
    t = _CONTROL.get(dev)
    if t is None or t.numel() < 2 + ntiles:
        t = _CONTROL[dev] = torch.zeros(2 + ntiles, dtype=torch.int64,
                                        device=torch.device("cuda", dev))
    return t.data_ptr()


def _scan(es, ed, et, alive, eid, fmap, tlut, cap, endpoint, drop_self,
          cnt=None):
    """One launch of K23's scan over a shard on the card.  Returns the
    frames' storage: rows (n_orient, cap, 3) int32 (uid, other endpoint,
    edge id), vmask (n_orient, cap) bool and cnt (n_orient,) int32 (or
    written into the given one)."""
    per = es.numel()
    for name, t, dt in (("es", es, torch.int32), ("ed", ed, torch.int32),
                        ("et", et, torch.int32), ("alive", alive, torch.bool),
                        ("eid", eid, torch.int32)):
        if t.dtype != dt or t.dim() != 1 or t.numel() != per or \
                not t.is_contiguous():
            raise _cuda.input_error("shard_expand", name, t, dt, per)
    if tlut.dtype != torch.bool or tlut.dim() != 1 or \
            not tlut.is_contiguous() or tlut.numel() == 0:
        raise ValueError("shard_expand: tlut must be a non-empty contiguous "
                         "1-d bool tensor")
    if endpoint not in (0, 1, 2):
        raise ValueError(f"shard_expand: endpoint {endpoint}")
    dev = es.get_device()
    n_orient = 2 if endpoint == 2 else 1
    rows = torch.empty((n_orient, cap, 3), dtype=torch.int32,
                       device=es.device)
    vmask = torch.empty((n_orient, cap), dtype=torch.bool, device=es.device)
    if cnt is None:
        cnt = torch.empty(n_orient, dtype=torch.int32, device=es.device)
    r0 = rows.data_ptr()
    v0 = vmask.data_ptr()
    words = fmap.words
    _SCAN.launch(dev, es.data_ptr(), ed.data_ptr(), et.data_ptr(),
                 alive.data_ptr(), eid.data_ptr(), per,
                 None if words is None else words.data_ptr(),
                 0 if words is None else words.shape[0], fmap.lo, fmap.nbits,
                 fmap.sentinel_uid, tlut.data_ptr(), tlut.numel(), endpoint,
                 int(drop_self), r0, v0, r0 + 12 * cap * (n_orient - 1),
                 v0 + cap * (n_orient - 1), cnt.data_ptr(), cap,
                 _control(dev, -(-per // _TILE)))
    return rows, vmask, cnt


def shard_expand(es, ed, et, alive, eid, uniq, tlut, *, cap, endpoint,
                 drop_self=False, fmap=None):
    """One shard's edge scan (K23): for orientation 0 (key es: out), 1
    (key ed: in), or both from one scan (endpoint 2, the reversed one
    dropping self-loops), a frame (uid, dst, eid, vmask, cnt): the hits in
    edge order, uid the hit's index in uniq, -1 past the count, cnt the
    full hit count (one int32).  Returns a list of one or two frames.
    uniq is sorted and distinct but for its 2^31-1 padding; on the card
    `fmap` is its `frontier_map` (built here, with one read of uniq, when
    not given)."""
    if not _cuda.on_card(es, ed, et, alive, eid, uniq, tlut):
        return shard_expand_plain(es, ed, et, alive, eid, uniq, tlut,
                                  cap=cap, endpoint=endpoint,
                                  drop_self=drop_self)
    if uniq.dtype != torch.int32 or uniq.dim() != 1 or uniq.numel() == 0 \
            or not uniq.is_contiguous():
        raise ValueError("shard_expand: uniq must be a non-empty contiguous "
                         "1-d int32 tensor")
    if fmap is None:
        fmap = frontier_map(uniq)
    rows, vmask, cnt = _scan(es, ed, et, alive, eid, fmap, tlut, cap,
                             endpoint, drop_self)
    return [(rows[o, :, 0], rows[o, :, 1], rows[o, :, 2], vmask[o],
             cnt[o:o + 1]) for o in range(rows.shape[0])]


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
    if tbl[0][0].is_cuda:
        hits = _card_hits(tbl, uniq_d, tlut_d, len(uniq), int(uniq[0]),
                          int(uniq[-1]), cap, endpoint)
    else:
        while True:
            per_shard = [shard_expand(*tbl[k], uniq_d[k], tlut_d[k], cap=cap,
                                      endpoint=endpoint)
                         for k in range(len(tbl))]
            mx = max(int(f[4].item()) for fr in per_shard for f in fr)
            if mx <= cap:
                break
            while cap < mx:
                cap *= 2
        hits = [[tuple(f[i][f[3]].numpy() for i in range(3)) for f in fr]
                for fr in per_shard]
    rows_all, dsts_all, eids_all = [], [], []
    # the reference's frames: each orientation over the shards in order
    for o in range(len(hits[0])):
        u, d, e = (np.concatenate([h[o][i] for h in hits]).astype(np.int64)
                   for i in range(3))
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


def _card_hits(tbl, uniq_d, tlut_d, nreal, lo, hi, cap, endpoint):
    """expand_rows' shard scans on the card: one frontier map a card, one
    K23 launch a shard (again with a doubled cap while a count passes it),
    one read of every count a card, then each shard's hits with one copy
    an orientation into pinned host memory and one synchronisation a
    card.  Returns, per shard and orientation, the hits'
    (uid, other endpoint, edge id) int32 arrays."""
    devs = [t[0].device for t in tbl]
    maps = {}
    for k, d in enumerate(devs):
        if d not in maps:
            maps[d] = frontier_map(uniq_d[k], nreal, lo, hi)
    n_orient = 2 if endpoint == 2 else 1
    on = {d: [k for k in range(len(tbl)) if devs[k] == d] for d in maps}
    while True:
        counts = {d: torch.empty((len(ks), n_orient), dtype=torch.int32,
                                 device=d) for d, ks in on.items()}
        out = [None] * len(tbl)
        for d, ks in on.items():
            for i, k in enumerate(ks):
                out[k] = _scan(*tbl[k], maps[d], tlut_d[k], cap, endpoint,
                               False, counts[d][i])
        cnt = np.zeros((len(tbl), n_orient), np.int64)
        for d, ks in on.items():
            cnt[ks] = counts[d].cpu().numpy()
        mx = int(cnt.max())
        if mx <= cap:
            break
        while cap < mx:
            cap *= 2
    host = torch.empty((int(cnt.sum()), 3), dtype=torch.int32,
                       pin_memory=True)
    spans, at = [], 0
    for k in range(len(tbl)):
        for o in range(n_orient):
            m = int(cnt[k, o])
            host[at:at + m].copy_(out[k][0][o, :m], non_blocking=True)
            spans.append((at, at + m))
            at += m
    for d in maps:
        torch.cuda.current_stream(d).synchronize()
    h = host.numpy()
    return [[tuple(h[a:b, i] for i in range(3))
             for a, b in spans[k * n_orient:(k + 1) * n_orient]]
            for k in range(len(tbl))]
