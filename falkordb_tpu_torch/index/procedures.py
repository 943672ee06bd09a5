"""Index procedures (reference: runtime/functions/procedures.rs
db.idx.* entries)."""

from __future__ import annotations

import numpy as np

from falkordb_tpu_torch.index.manager import IndexDef, build_index
from falkordb_tpu_torch.runtime.procedures import proc
from falkordb_tpu_torch.runtime.value import VectorF32


@proc("db.idx.fulltext.createnodeindex", [])
def ft_create(rt, label_or_cfg, *props):
    indexes = rt.indexes
    if isinstance(label_or_cfg, dict):
        label = label_or_cfg.get("label")
        options = {k: v for k, v in label_or_cfg.items() if k != "label"}
    else:
        label = label_or_cfg
        options = {}
    d = IndexDef("fulltext", "node", label, tuple(props), options)
    if d.key in indexes:
        raise ValueError("index already exists")
    indexes[d.key] = d
    store = rt.store
    for p in props:
        store.schema.attr_id(p, create=True)
    build_index(rt.store, d)
    rt.stats["indices_created"] += 1
    return iter(())


@proc("db.idx.fulltext.drop", [])
def ft_drop(rt, label):
    indexes = rt.indexes
    for k in list(indexes):
        if k[0] == "fulltext" and k[2] == label:
            del indexes[k]
            rt.stats["indices_deleted"] += 1
            return iter(())
    raise ValueError("no such index")


@proc("db.idx.fulltext.querynodes", ["node", "score"])
def ft_query_nodes(rt, label, query):
    d = None
    for k, v in rt.indexes.items():
        if v.kind == "fulltext" and v.entity == "node" and v.label == label:
            d = v
            break
    if d is None or d.impl is None:
        raise ValueError(f"no fulltext index on label {label!r}")
    for doc, score in d.impl.query(query):
        yield {"node": rt.ctx.node_value(doc), "score": score}


@proc("db.idx.fulltext.queryrelationships", ["relationship", "score"])
def ft_query_rels(rt, label, query):
    d = None
    for k, v in rt.indexes.items():
        if v.kind == "fulltext" and v.entity == "edge" and v.label == label:
            d = v
            break
    if d is None or d.impl is None:
        raise ValueError(f"no fulltext index on type {label!r}")
    for doc, score in d.impl.query(query):
        yield {"relationship": rt.ctx.edge_value(doc), "score": score}


@proc("db.idx.vector.querynodes", ["node", "score"])
def vec_query_nodes(rt, label, prop, k, qvec):
    d = None
    for key, v in rt.indexes.items():
        if (v.kind == "vector" and v.entity == "node" and v.label == label
                and v.props and v.props[0] == prop):
            d = v
            break
    if d is None or d.impl is None:
        raise ValueError(f"no vector index on {label}.{prop}")
    q = qvec.data if isinstance(qvec, VectorF32) else np.asarray(qvec)
    for ent, score in d.impl.query(q, int(k)):
        yield {"node": rt.ctx.node_value(ent), "score": score}


@proc("db.idx.vector.queryrelationships", ["relationship", "score"])
def vec_query_rels(rt, label, prop, k, qvec):
    d = None
    for key, v in rt.indexes.items():
        if (v.kind == "vector" and v.entity == "edge" and v.label == label
                and v.props and v.props[0] == prop):
            d = v
            break
    if d is None or d.impl is None:
        raise ValueError(f"no vector index on {label}.{prop}")
    q = qvec.data if isinstance(qvec, VectorF32) else np.asarray(qvec)
    for ent, score in d.impl.query(q, int(k)):
        yield {"relationship": rt.ctx.edge_value(ent), "score": score}


@proc("db.indexes", ["label", "properties", "types", "entitytype"])
def db_indexes(rt):
    for d in rt.indexes.values():
        yield {
            "label": d.label,
            "properties": list(d.props),
            "types": d.kind.upper(),
            "entitytype": "NODE" if d.entity == "node" else "RELATIONSHIP",
        }


@proc("db.constraints", ["type", "label", "properties", "entitytype", "status"])
def db_constraints(rt):
    for c in getattr(rt, "constraints", []):
        yield {
            "type": c["type"], "label": c["label"],
            "properties": c["properties"], "entitytype": c["entity"],
            "status": c.get("status", "OPERATIONAL"),
        }
