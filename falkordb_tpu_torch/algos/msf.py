"""Minimum spanning forest (LAGraph_msf role) — Borůvka with vectorized
cheapest-edge selection + union-find contraction (host; per-round argmin is
numpy-vectorized)."""

from __future__ import annotations

import numpy as np


def msf(comp):
    """comp: CompactGraph with keep_eids + weights.  Returns [(eid, w)]."""
    # symmetrize: cheapest-edge-per-component must see every incident edge
    # regardless of stored direction
    src = np.concatenate([comp.src, comp.dst])
    dst = np.concatenate([comp.dst, comp.src])
    w0 = comp.weights if comp.weights is not None else np.ones(
        len(comp.src), dtype=np.float32)
    w = np.concatenate([w0, w0])
    eids = np.concatenate([comp.eids, comp.eids])
    n = len(comp.ids)
    if n == 0 or len(src) == 0:
        return []
    parent = np.arange(n)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    chosen: dict[int, float] = {}
    while True:
        roots_s = np.fromiter((find(s) for s in src), dtype=np.int64,
                              count=len(src))
        roots_d = np.fromiter((find(d) for d in dst), dtype=np.int64,
                              count=len(dst))
        cross = roots_s != roots_d
        if not cross.any():
            break
        idx = np.nonzero(cross)[0]
        # cheapest outgoing edge per component (ties → lower edge id)
        order = np.lexsort((eids[idx], w[idx], roots_s[idx]))
        oi = idx[order]
        rs = roots_s[oi]
        first = np.ones(len(rs), dtype=bool)
        first[1:] = rs[1:] != rs[:-1]
        picks = oi[first]
        merged_any = False
        for k in picks:
            a, b = find(src[k]), find(dst[k])
            if a != b:
                parent[a] = b
                e = int(eids[k])
                if e not in chosen:
                    chosen[e] = float(w[k])
                merged_any = True
        if not merged_any:
            break
    return sorted(chosen.items())
