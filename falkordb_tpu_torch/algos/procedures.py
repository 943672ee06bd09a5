"""algo.* procedure registrations (reference: algo_procedures.rs:40-52).

Each builds a compacted adjacency snapshot on the graph's device
(build_compact_adj role, algo_procedures.rs doc:54-61) and dispatches to the
algorithms in falkordb_tpu_torch.algos.*: PageRank (kernel K5), WCC and
SSSP (K6), betweenness (K7), BFS with parents (K8) and harmonic centrality
(K16) on the card; label propagation, MSF, maxFlow and the path
enumerations on the host, as in falkordb_tpu.  With a mesh of two or more
devices (parallel/router.py), algo.pageRank, WCC, SSSP and bfs take the
edge-sharded drivers of parallel/dist.py (K24-K26) instead, as falkordb_tpu
does.  Names, yields, row order and configuration keys are falkordb_tpu's."""

from __future__ import annotations

import numpy as np

from falkordb_tpu_torch.runtime.procedures import proc
from falkordb_tpu_torch.algos.common import compact_adjacency


def _config(cfg):
    cfg = cfg or {}
    if not isinstance(cfg, dict):
        raise ValueError("algorithm configuration must be a map")
    return cfg


def _maybe_mesh(comp, device):
    """Route through the device mesh when the store's mesh has two or more
    devices and the compacted snapshot has edges (parallel/router.py)."""
    if comp.src is None or len(comp.src) == 0:
        return None
    from falkordb_tpu_torch.parallel.router import maybe_mesh

    return maybe_mesh(device)


def _native_bfs_levels(comp, csrc):
    """Run the native direction-optimizing BFS over a compact snapshot.
    Returns int32 levels (-1 unreached) or None when the native library is
    unavailable (callers fall back to the device kernel)."""
    import os

    if os.environ.get("FALKOR_NO_NATIVE_BFS"):
        return None
    from falkordb_tpu_torch.native import bfs_single_native

    n = len(comp.ids)
    src = np.asarray(comp.src)
    dst = np.asarray(comp.dst)

    def _csr(s, d):
        order = np.argsort(s, kind="stable")
        indptr = np.concatenate(
            [[0], np.bincount(s, minlength=n).cumsum()]).astype(np.int64)
        return indptr, d[order].astype(np.int32)

    fip, fcols = _csr(src, dst)
    rip, rcols = _csr(dst, src)
    res = bfs_single_native(fip, fcols, rip, rcols, csrc)
    if res is None:
        return None
    return res[0]


@proc("algo.bfs", ["nodes", "edges"])
def algo_bfs(rt, source, max_depth=None, reltype=None):
    from falkordb_tpu_torch.algos.bfs import bfs_levels_parents

    g = rt.store
    src = source.id if hasattr(source, "id") else int(source)
    comp = compact_adjacency(g, None, [reltype] if reltype else None,
                             directed=True)
    if comp is None:
        return
    csrc = comp.remap.get(src, -1)
    mesh = _maybe_mesh(comp, g.device)
    if mesh is not None and csrc >= 0:
        from falkordb_tpu_torch.parallel.dist import dist_bfs

        levels = dist_bfs(
            mesh, comp.src, comp.dst, None, len(comp.ids), csrc,
            max_levels=int(max_depth) if max_depth else None).cpu().numpy()
        levels = np.where(levels < 0, 2**30, levels)
    elif csrc >= 0 and (nat := _native_bfs_levels(comp, csrc)) is not None:
        # single-source latency path, as in falkordb_tpu: the native
        # direction-optimizing host BFS (native/bfsnative.cpp); the kernel
        # path (K8) runs when FALKOR_NO_NATIVE_BFS is set or it is missing
        levels = nat
        if max_depth:
            levels = np.where(levels > int(max_depth), 2**30, levels)
        levels = np.where(levels < 0, 2**30, levels)
    else:
        levels, _parents = bfs_levels_parents(
            comp.csr, csrc,
            max_depth=int(max_depth) if max_depth else None)
        levels = levels.cpu().numpy()
    order = np.argsort(levels, kind="stable")
    nodes, edges = [], []
    for ci in order:
        if levels[ci] < 0 or levels[ci] >= 2**30:
            continue
        nid = int(comp.ids[ci])
        nodes.append(rt.ctx.node_value(nid))
    yield {"nodes": nodes, "edges": []}


@proc("algo.pagerank", ["node", "score"])
def algo_pagerank(rt, label=None, relationship=None):
    from falkordb_tpu_torch.algos.pagerank import pagerank

    g = rt.store
    comp = compact_adjacency(g, label, [relationship] if relationship else None,
                             directed=True)
    if comp is None:
        return
    mesh = _maybe_mesh(comp, g.device)
    if mesh is not None:
        from falkordb_tpu_torch.parallel.dist import dist_pagerank

        scores = dist_pagerank(mesh, comp.src, comp.dst,
                               len(comp.ids)).cpu().numpy()
    else:
        scores = pagerank(comp.csr).cpu().numpy()
    order = np.argsort(-scores, kind="stable")
    for ci in order:
        yield {"node": rt.ctx.node_value(int(comp.ids[ci])),
               "score": float(scores[ci])}


@proc("algo.wcc", ["node", "componentId"])
def algo_wcc(rt, cfg=None):
    from falkordb_tpu_torch.algos.wcc import wcc

    cfg = _config(cfg)
    g = rt.store
    comp = compact_adjacency(g, _first(cfg.get("nodeLabels")),
                             cfg.get("relationshipTypes"), directed=False)
    if comp is None:
        return
    mesh = _maybe_mesh(comp, g.device)
    if mesh is not None:
        from falkordb_tpu_torch.parallel.dist import dist_wcc

        labels = dist_wcc(mesh, comp.src, comp.dst,
                          len(comp.ids)).cpu().numpy()
    else:
        labels = wcc(comp.csr).cpu().numpy()
    for ci in range(len(comp.ids)):
        yield {"node": rt.ctx.node_value(int(comp.ids[ci])),
               "componentId": int(labels[ci])}


def _first(x):
    if isinstance(x, list):
        return x[0] if x else None
    return x


@proc("algo.sssp", ["node", "distance"])
def algo_sssp(rt, cfg=None):
    from falkordb_tpu_torch.algos.sssp import sssp

    cfg = _config(cfg)
    g = rt.store
    source = cfg.get("sourceNode")
    if source is None:
        raise ValueError("SSSP requires sourceNode")
    src = source.id if hasattr(source, "id") else int(source)
    weight = cfg.get("weightAttribute")
    comp = compact_adjacency(g, None, cfg.get("relationshipTypes"),
                             directed=True, weight_attr=weight)
    if comp is None:
        return
    csrc = comp.remap.get(src, -1)
    mesh = _maybe_mesh(comp, g.device)
    if mesh is not None and csrc >= 0:
        from falkordb_tpu_torch.parallel.dist import dist_sssp

        w = (comp.weights if comp.weights is not None
             else np.ones(len(comp.src), np.float32))
        dist = dist_sssp(mesh, comp.src, comp.dst, w, len(comp.ids),
                         csrc).cpu().numpy()
    else:
        dist = sssp(comp.csr, csrc).cpu().numpy()
    for ci in range(len(comp.ids)):
        if np.isfinite(dist[ci]):
            yield {"node": rt.ctx.node_value(int(comp.ids[ci])),
                   "distance": float(dist[ci])}


@proc("algo.betweenness", ["node", "score"])
def algo_betweenness(rt, cfg=None):
    from falkordb_tpu_torch.algos.betweenness import betweenness

    cfg = _config(cfg)
    g = rt.store
    comp = compact_adjacency(g, _first(cfg.get("nodeLabels")),
                             cfg.get("relationshipTypes"), directed=True)
    if comp is None:
        return
    sampling = cfg.get("samplingSize")
    scores = np.asarray(betweenness(
        comp.csr, sampling_size=int(sampling) if sampling else None,
        seed=int(cfg.get("samplingSeed", 0)) or 0))
    order = np.argsort(-scores, kind="stable")
    for ci in order:
        yield {"node": rt.ctx.node_value(int(comp.ids[ci])),
               "score": float(scores[ci])}


@proc("algo.labelpropagation", ["node", "communityId"])
def algo_cdlp(rt, cfg=None):
    from falkordb_tpu_torch.algos.cdlp import cdlp

    cfg = _config(cfg)
    g = rt.store
    comp = compact_adjacency(g, _first(cfg.get("nodeLabels")),
                             cfg.get("relationshipTypes"), directed=False)
    if comp is None:
        return
    labels = np.asarray(cdlp(comp.csr,
                             max_iters=int(cfg.get("maxIterations", 10))))
    for ci in range(len(comp.ids)):
        yield {"node": rt.ctx.node_value(int(comp.ids[ci])),
               "communityId": int(labels[ci])}


@proc("algo.mst", ["edge", "weight"])
@proc("algo.msf", ["edge", "weight"])
def algo_msf(rt, cfg=None):
    from falkordb_tpu_torch.algos.msf import msf

    cfg = _config(cfg)
    g = rt.store
    weight = cfg.get("weightAttribute", "weight")
    comp = compact_adjacency(g, _first(cfg.get("nodeLabels")),
                             cfg.get("relationshipTypes"), directed=False,
                             weight_attr=weight, keep_eids=True)
    if comp is None:
        return
    for eid, w in msf(comp):
        yield {"edge": rt.ctx.edge_value(int(eid)), "weight": float(w)}


@proc("algo.harmoniccentrality", ["node", "score"])
def algo_harmonic(rt, cfg=None):
    from falkordb_tpu_torch.algos.harmonic import harmonic_centrality

    cfg = _config(cfg)
    g = rt.store
    comp = compact_adjacency(g, _first(cfg.get("nodeLabels")),
                             cfg.get("relationshipTypes"), directed=True)
    if comp is None:
        return
    scores = harmonic_centrality(comp.csr).cpu().numpy()
    for ci in range(len(comp.ids)):
        yield {"node": rt.ctx.node_value(int(comp.ids[ci])),
               "score": float(scores[ci])}


def _path_cfg(rt, cfg, need_target):
    cfg = _config(cfg)
    src = cfg.get("sourceNode")
    if src is None:
        raise ValueError("sourceNode is required")
    source = src.id if hasattr(src, "id") else int(src)
    target = None
    if need_target:
        tgt = cfg.get("targetNode")
        if tgt is None:
            raise ValueError("targetNode is required")
        target = tgt.id if hasattr(tgt, "id") else int(tgt)
    return dict(
        source=source, target=target,
        rel_types=cfg.get("relTypes") or None,
        direction=cfg.get("relDirection", "outgoing"),
        max_len=cfg.get("maxLen"),
        weight_prop=cfg.get("weightProp"),
        cost_prop=cfg.get("costProp"),
        max_cost=cfg.get("maxCost"),
        path_count=int(cfg.get("pathCount", 1)),
    )


@proc("algo.sppaths", ["path", "pathWeight", "pathCost"])
def algo_sppaths(rt, cfg=None):
    from falkordb_tpu_torch.algos.sppaths import paths_to_values, weighted_paths

    kw = _path_cfg(rt, cfg, need_target=True)
    yield from paths_to_values(rt, weighted_paths(rt.store, **kw))


@proc("algo.sspaths", ["path", "pathWeight", "pathCost"])
def algo_sspaths(rt, cfg=None):
    from falkordb_tpu_torch.algos.sppaths import paths_to_values, weighted_paths

    kw = _path_cfg(rt, cfg, need_target=False)
    yield from paths_to_values(rt, weighted_paths(rt.store, **kw))


@proc("algo.maxflow", ["flow"])
def algo_maxflow(rt, source, sink, cfg=None):
    from falkordb_tpu_torch.algos.maxflow import maxflow

    cfg = _config(cfg)
    g = rt.store
    s = source.id if hasattr(source, "id") else int(source)
    t = sink.id if hasattr(sink, "id") else int(sink)
    cap_attr = cfg.get("capacityAttribute", "capacity")
    comp = compact_adjacency(g, None, cfg.get("relationshipTypes"),
                             directed=True, weight_attr=cap_attr)
    if comp is None or s not in comp.remap or t not in comp.remap:
        yield {"flow": 0.0}
        return
    yield {"flow": float(maxflow(comp.csr, comp.remap[s], comp.remap[t]))}
