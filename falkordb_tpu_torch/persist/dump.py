"""GRAPH.DUMP / GRAPH.RESTORE — single-graph binary payloads.

The reference restores dump payloads via GRAPH.RESTORE
(src/commands/restore.rs); here the payload is the checkpoint directory
format tar-packed in memory."""

from __future__ import annotations

import io
import os
import tarfile
import tempfile


def dump_graph(core) -> bytes:
    from falkordb_tpu_torch.persist.checkpoint import save_graph

    with tempfile.TemporaryDirectory() as td:
        gdir = os.path.join(td, "g")
        save_graph(core, gdir)
        buf = io.BytesIO()
        with tarfile.open(fileobj=buf, mode="w:gz") as tar:
            for fn in sorted(os.listdir(gdir)):
                tar.add(os.path.join(gdir, fn), arcname=fn)
        return buf.getvalue()


def restore_graph(core, payload: bytes) -> None:
    from falkordb_tpu_torch.persist.checkpoint import load_graph

    with tempfile.TemporaryDirectory() as td:
        buf = io.BytesIO(payload)
        with tarfile.open(fileobj=buf, mode="r:gz") as tar:
            tar.extractall(td, filter="data")
        load_graph(core, td)


# ---------------------------------------------------------------------------
# Virtual-key chunked serialization — the reference shards one big graph
# into <=VKEY_MAX_ENTITY_COUNT-entity virtual keys for incremental RDB
# encoding (src/redis_type.rs:289-360, create_virtual_keys:338).  Here each
# vkey is a self-describing pickle chunk; decode accumulates chunks in any
# order and `finalize` rebuilds adjacency from the edge table (the
# GRAPH.DEBUG AUX START/END protocol, src/commands/debug.rs).
# ---------------------------------------------------------------------------

import pickle


def dump_graph_vkeys(core, max_entities: int = 100_000) -> list:
    """Returns [(vkey_name, payload_bytes), ...].  Chunk 0 carries schema/
    counters/indexes/constraints; node chunks carry [lo,hi) slices of the
    node pool (existence, label masks, attr columns); edge chunks carry
    [lo,hi) slices of the edge table."""
    g = core.store
    g.flush(force=True)
    chunks = []

    meta = {
        "kind": "meta",
        "schema": {
            "labels": g.schema.labels.names,
            "reltypes": g.schema.reltypes.names,
            "attrs": g.schema.attrs.names,
            "schema_version": g.schema.version,
        },
        "counters": {
            "node_cap": g.node_cap, "node_max": g.node_max,
            "edge_cap": g.edge_cap, "edge_max": g.edge_max,
            "node_free": g.node_free, "edge_free": g.edge_free,
            "counts": g._counts, "label_counts": g.label_counts,
            "type_counts": g.type_counts, "version": g.version,
        },
        "indexes": [
            {"kind": d.kind, "entity": d.entity, "label": d.label,
             "props": list(d.props), "options": d.options}
            for d in core.indexes.values()
        ],
        "constraints": core.constraints,
        "label_ids": sorted(g.label_masks),
        "node_attr_ids": sorted(g.node_attrs.columns),
        "edge_attr_ids": sorted(g.edge_attrs.columns),
    }
    chunks.append((f"{{{core.name}}}_vkey_meta", pickle.dumps(meta)))

    for lo in range(0, max(g.node_max, 1), max_entities):
        hi = min(lo + max_entities, g.node_max)
        if hi <= lo:
            break
        chunk = {
            "kind": "nodes", "lo": lo, "hi": hi,
            "exists": g.node_exists[lo:hi],
            "labels": {lid: m[lo:hi] for lid, m in g.label_masks.items()},
            "attrs": {aid: col.data[lo:hi]
                      for aid, col in g.node_attrs.columns.items()},
        }
        chunks.append((f"{{{core.name}}}_vkey_n{lo}", pickle.dumps(chunk)))
    for lo in range(0, max(g.edge_max, 1), max_entities):
        hi = min(lo + max_entities, g.edge_max)
        if hi <= lo:
            break
        chunk = {
            "kind": "edges", "lo": lo, "hi": hi,
            "src": g.e_src[lo:hi], "dst": g.e_dst[lo:hi],
            "type": g.e_type[lo:hi], "deleted": g.e_deleted[lo:hi],
            "attrs": {aid: col.data[lo:hi]
                      for aid, col in g.edge_attrs.columns.items()},
        }
        chunks.append((f"{{{core.name}}}_vkey_e{lo}", pickle.dumps(chunk)))
    return chunks


def restore_graph_vkeys(core, payloads) -> None:
    """Rebuild a graph from dump_graph_vkeys chunks (any order)."""
    import numpy as np

    from falkordb_tpu_torch.graph.attrstore import Column
    from falkordb_tpu_torch.index.manager import IndexDef, build_index
    from falkordb_tpu_torch.persist.checkpoint import _Unpickler
    from falkordb_tpu_torch.sparse.delta import DeltaMatrix

    meta = None
    node_chunks, edge_chunks = [], []
    for payload in payloads:
        c = _Unpickler(io.BytesIO(payload)).load()
        if c["kind"] == "meta":
            meta = c
        elif c["kind"] == "nodes":
            node_chunks.append(c)
        else:
            edge_chunks.append(c)
    if meta is None:
        raise ValueError("vkey restore: missing meta chunk")
    g = core.store
    sc = g.schema
    for n in meta["schema"]["labels"]:
        sc.labels.get_or_add(n)
    for n in meta["schema"]["reltypes"]:
        sc.reltypes.get_or_add(n)
    for n in meta["schema"]["attrs"]:
        sc.attrs.get_or_add(n)
    sc.version = meta["schema"]["schema_version"]
    cnt = meta["counters"]
    g.node_cap, g.node_max = cnt["node_cap"], cnt["node_max"]
    g.edge_cap, g.edge_max = cnt["edge_cap"], cnt["edge_max"]
    g.node_free = list(cnt["node_free"])
    g.edge_free = list(cnt["edge_free"])
    g._counts = dict(cnt["counts"])
    g.label_counts = {int(k): v for k, v in cnt["label_counts"].items()}
    g.type_counts = {int(k): v for k, v in cnt["type_counts"].items()}
    g.version = cnt["version"]
    g.node_exists = np.zeros(g.node_cap, dtype=bool)
    g.label_masks = {lid: np.zeros(g.node_cap, dtype=bool)
                     for lid in meta["label_ids"]}
    g.node_attrs.cap = g.node_cap
    for aid in meta["node_attr_ids"]:
        g.node_attrs.columns[aid] = Column(g.node_cap)
    g.e_src = np.zeros(g.edge_cap, dtype=np.int64)
    g.e_dst = np.zeros(g.edge_cap, dtype=np.int64)
    g.e_type = np.full(g.edge_cap, -1, dtype=np.int32)
    g.e_deleted = np.zeros(g.edge_cap, dtype=bool)
    g.edge_attrs.cap = g.edge_cap
    for aid in meta["edge_attr_ids"]:
        g.edge_attrs.columns[aid] = Column(g.edge_cap)
    for c in node_chunks:
        lo, hi = c["lo"], c["hi"]
        g.node_exists[lo:hi] = c["exists"]
        for lid, m in c["labels"].items():
            g.label_masks[lid][lo:hi] = m
        for aid, data in c["attrs"].items():
            g.node_attrs.columns[aid].data[lo:hi] = data
    for c in edge_chunks:
        lo, hi = c["lo"], c["hi"]
        g.e_src[lo:hi] = c["src"]
        g.e_dst[lo:hi] = c["dst"]
        g.e_type[lo:hi] = c["type"]
        g.e_deleted[lo:hi] = c["deleted"]
        for aid, data in c["attrs"].items():
            g.edge_attrs.columns[aid].data[lo:hi] = data
    # rebuild adjacency from the edge table (alive edges per type)
    alive = ~g.e_deleted[: g.edge_max] & (g.e_type[: g.edge_max] >= 0)
    eids = np.nonzero(alive)[0]
    for tid in np.unique(g.e_type[eids]) if len(eids) else []:
        sel = eids[g.e_type[eids] == tid]
        d = DeltaMatrix((g.node_cap, g.node_cap))
        d.add_edges(g.e_src[sel], g.e_dst[sel], sel)
        g.adj[int(tid)] = d
    g.flush(force=True)
    g._dev.clear()
    g._adj_in_cache.clear()
    core.constraints = list(meta.get("constraints", []))
    from falkordb_tpu_torch.index.constraints import resume_scans

    resume_scans(core)  # finish any mid-construction scans
    for ix in meta.get("indexes", []):
        d = IndexDef(ix["kind"], ix["entity"], ix["label"],
                     tuple(ix["props"]), ix.get("options") or {})
        core.indexes[d.key] = d
        build_index(g, d)
