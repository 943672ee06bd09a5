"""Directory checkpoint format (the reference's RDB v19 serializer role,
src/serializers/encoder/mod.rs:59).

Layout per database:
  <path>/manifest.json            — version, graph list
  <path>/<graph>/meta.json        — schema, counters, indexes, constraints
  <path>/<graph>/arrays.npz       — node/edge pools + adjacency COO
  <path>/<graph>/attrs.pkl        — attribute columns (arbitrary values)

Adjacency is stored as flushed COO (the GxB container unload analogue);
rebuild on load regenerates CSR + caches.
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np

FORMAT_VERSION = 1


def save_db(db, path: str) -> None:
    os.makedirs(path, exist_ok=True)
    names = []
    for name, core in db._graphs.items():
        names.append(name)
        save_graph(core, os.path.join(path, _safe(name)))
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump({"version": FORMAT_VERSION, "graphs": names,
                   "config": vars(db.config),
                   # UDF libraries ride the manifest (the RDB AUX role,
                   # src/redis_type.rs:24-30)
                   "udfs": [{"name": l.name, "code": l.code}
                            for l in db.udfs.libs.values()]}, f)


def load_db(path: str, device=None):
    from falkordb_tpu_torch.api import FalkorDB

    with open(os.path.join(path, "manifest.json")) as f:
        man = json.load(f)
    db = FalkorDB(config=man.get("config") or None, device=device)
    for u in man.get("udfs", []):
        db.udfs.load(u["name"], u["code"])
    for name in man["graphs"]:
        core = db._get_or_create(name)
        load_graph(core, os.path.join(path, _safe(name)))
    return db


def _safe(name: str) -> str:
    return "".join(c if c.isalnum() or c in "-_." else "_" for c in name)


def save_graph(core, gdir: str) -> None:
    os.makedirs(gdir, exist_ok=True)
    g = core.store
    g.flush(force=True)
    # big graphs are encoded as virtual-key chunks so each write unit stays
    # <= VKEY_MAX_ENTITY_COUNT entities (src/redis_type.rs:316-338)
    if g.node_max + g.edge_max > core.config.vkey_max_entity_count:
        from falkordb_tpu_torch.persist.dump import dump_graph_vkeys

        vdir = os.path.join(gdir, "vkeys")
        os.makedirs(vdir, exist_ok=True)
        chunks = dump_graph_vkeys(core, core.config.vkey_max_entity_count)
        for i, (_, payload) in enumerate(chunks):
            with open(os.path.join(vdir, f"{i:06d}.bin"), "wb") as f:
                f.write(payload)
        with open(os.path.join(gdir, "meta.json"), "w") as f:
            json.dump({"version": FORMAT_VERSION, "vkeys": len(chunks)}, f)
        return
    # adjacency → flushed COO per type
    adj = {}
    for t, d in g.adj.items():
        r, c, v = d.base.to_numpy_coo()
        adj[str(t)] = (r, c, v)
    arrays = {
        "node_exists": g.node_exists,
        "e_src": g.e_src, "e_dst": g.e_dst, "e_type": g.e_type,
        "e_deleted": g.e_deleted,
    }
    for lid, m in g.label_masks.items():
        arrays[f"label_{lid}"] = m
    for t, (r, c, v) in adj.items():
        arrays[f"adj_{t}_r"] = r
        arrays[f"adj_{t}_c"] = c
        arrays[f"adj_{t}_v"] = v
    np.savez_compressed(os.path.join(gdir, "arrays.npz"), **arrays)
    meta = {
        "version": FORMAT_VERSION,
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
    }
    with open(os.path.join(gdir, "meta.json"), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(gdir, "attrs.pkl"), "wb") as f:
        pickle.dump({
            "node": {aid: col.data for aid, col in g.node_attrs.columns.items()},
            "edge": {aid: col.data for aid, col in g.edge_attrs.columns.items()},
        }, f)


def load_graph(core, gdir: str) -> None:
    from falkordb_tpu_torch.graph.attrstore import Column
    from falkordb_tpu_torch.index.manager import IndexDef, build_index
    from falkordb_tpu_torch.sparse.delta import DeltaMatrix
    from falkordb_tpu_torch.sparse.csr import CSR, bucket_cap

    with open(os.path.join(gdir, "meta.json")) as f:
        meta = json.load(f)
    if "vkeys" in meta:
        from falkordb_tpu_torch.persist.dump import restore_graph_vkeys

        vdir = os.path.join(gdir, "vkeys")
        payloads = []
        for i in range(meta["vkeys"]):
            with open(os.path.join(vdir, f"{i:06d}.bin"), "rb") as f:
                payloads.append(f.read())
        restore_graph_vkeys(core, payloads)
        return
    arrays = np.load(os.path.join(gdir, "arrays.npz"), allow_pickle=False)
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
    g.node_cap = cnt["node_cap"]
    g.node_max = cnt["node_max"]
    g.edge_cap = cnt["edge_cap"]
    g.edge_max = cnt["edge_max"]
    g.node_free = list(cnt["node_free"])
    g.edge_free = list(cnt["edge_free"])
    g._counts = dict(cnt["counts"])
    g.label_counts = {int(k): v for k, v in cnt["label_counts"].items()}
    g.type_counts = {int(k): v for k, v in cnt["type_counts"].items()}
    g.version = cnt["version"]
    g.node_exists = arrays["node_exists"]
    g.e_src = arrays["e_src"]
    g.e_dst = arrays["e_dst"]
    g.e_type = arrays["e_type"]
    g.e_deleted = arrays["e_deleted"]
    for key in arrays.files:
        if key.startswith("label_"):
            g.label_masks[int(key[6:])] = arrays[key]
    types = {int(k[4:-2]) for k in arrays.files if k.startswith("adj_")
             and k.endswith("_r")}
    for t in types:
        r = arrays[f"adj_{t}_r"]
        c = arrays[f"adj_{t}_c"]
        v = arrays[f"adj_{t}_v"]
        d = DeltaMatrix((g.node_cap, g.node_cap))
        d.base = CSR.from_coo_numpy(r, c, v, shape=(g.node_cap, g.node_cap),
                                    cap=bucket_cap(len(r)), dedup=False)
        d.base.to(g.device)  # place the adjacency on the store's device now
        g.adj[t] = d
    with open(os.path.join(gdir, "attrs.pkl"), "rb") as f:
        attrs = pickle.load(f)
    g.node_attrs.cap = g.node_cap
    g.edge_attrs.cap = g.edge_cap
    for aid, data in attrs["node"].items():
        col = Column(g.node_cap)
        col.data[: len(data)] = data
        g.node_attrs.columns[int(aid)] = col
    for aid, data in attrs["edge"].items():
        col = Column(g.edge_cap)
        col.data[: len(data)] = data
        g.edge_attrs.columns[int(aid)] = col
    core.constraints = meta.get("constraints", [])
    from falkordb_tpu_torch.index.constraints import resume_scans

    resume_scans(core)  # finish any mid-construction scans
    for ix in meta.get("indexes", []):
        d = IndexDef(ix["kind"], ix["entity"], ix["label"],
                     tuple(ix["props"]), ix.get("options") or {})
        core.indexes[d.key] = d
        build_index(g, d)
