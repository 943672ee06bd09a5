"""algo.SPpaths / algo.SSpaths — weighted path enumeration
(reference: algo_procedures.rs:1830-2400, Rust Dijkstra over matrices).

Uniform-cost search enumerating paths in (weight, cost, length) order with
maxLen / maxCost / pathCount bounds; single-pair (SPpaths) or single-source
(SSpaths)."""

from __future__ import annotations

import heapq

import numpy as np

from falkordb_tpu_torch.runtime.value import PathVal


def _edge_values(store, eids, prop):
    if prop is None:
        return np.ones(len(eids), dtype=np.float64)
    aid = store.schema.attr_id(prop)
    out = np.ones(len(eids), dtype=np.float64)
    if aid is not None:
        col = store.edge_attrs.columns.get(aid)
        if col is not None:
            for i, e in enumerate(eids):
                v = col.data[e]
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    out[i] = float(v)
    return out


def _neighbors_fn(store, rel_types, direction):
    ne = store.edge_max
    live = ~store.e_deleted[:ne] & (store.e_type[:ne] >= 0)
    if rel_types:
        tids = {store.schema.reltype_id(t) for t in rel_types} - {None}
        sel = np.zeros(ne, dtype=bool)
        for t in tids:
            sel |= store.e_type[:ne] == t
        live &= sel
    eids = np.nonzero(live)[0]
    src = store.e_src[:ne][eids]
    dst = store.e_dst[:ne][eids]
    adj: dict[int, list] = {}
    if direction in ("outgoing", "both"):
        for k in range(len(eids)):
            adj.setdefault(int(src[k]), []).append((int(dst[k]), int(eids[k])))
    if direction in ("incoming", "both"):
        for k in range(len(eids)):
            adj.setdefault(int(dst[k]), []).append((int(src[k]), int(eids[k])))
    return adj, eids


def weighted_paths(store, source, target=None, rel_types=None,
                   direction="outgoing", max_len=None, weight_prop=None,
                   cost_prop=None, max_cost=None, path_count=1):
    """Yields (node_path, edge_path, weight, cost) ordered by (weight,
    cost, len).  path_count semantics follow the reference: for SPpaths
    k paths per target; 0 = one minimal path; large = all within bounds."""
    adj, all_eids = _neighbors_fn(store, rel_types, direction)
    wmap = {}
    cmap = {}
    ws = _edge_values(store, all_eids, weight_prop)
    cs = _edge_values(store, all_eids, cost_prop)
    for i, e in enumerate(all_eids):
        wmap[int(e)] = ws[i]
        cmap[int(e)] = cs[i]
    max_len = max_len if max_len else 2**31
    counts: dict[int, int] = {}
    want = path_count if path_count and path_count > 0 else 1
    # uniform-cost search over PATHS (edge-unique trails)
    heap = [(0.0, 0.0, 0, (source,), ())]
    seq = 0
    results = []
    while heap:
        w, c, ln, npath, epath = heapq.heappop(heap)
        node = npath[-1]
        if node != source or ln > 0:
            if target is None or node == target:
                got = counts.get(node, 0)
                if got < want and (target is None or node == target):
                    if target is not None or node != source:
                        counts[node] = got + 1
                        results.append((npath, epath, w, c))
                        if target is not None and counts.get(target, 0) >= want:
                            break
        if ln >= max_len:
            continue
        for (nxt, eid) in adj.get(node, ()):
            if eid in epath:
                continue
            nc = c + cmap[eid]
            if max_cost is not None and nc > max_cost:
                continue
            heapq.heappush(heap, (w + wmap[eid], nc, ln + 1,
                                  npath + (nxt,), epath + (eid,)))
    return results


def paths_to_values(rt, results):
    for (npath, epath, w, c) in results:
        nodes = [rt.ctx.node_value(x) for x in npath]
        edges = [rt.ctx.edge_value(e) for e in epath]
        yield {"path": PathVal(nodes, edges), "pathWeight": float(w),
               "pathCost": float(c)}
