"""Bulk loading — vectorized creation bypassing the per-row query path
(reference: GRAPH.BULK, src/commands/bulk_insert.rs + flush_for_bulk,
graph.rs:2087).

`bulk_insert` takes columnar node/edge frames and applies them with numpy
fancy assignment + one DeltaMatrix append per relationship type."""

from __future__ import annotations

import numpy as np


def bulk_create_nodes(store, labels: list[str], count: int,
                      props: dict[str, list] | None = None) -> np.ndarray:
    """Create `count` nodes all carrying `labels`; props maps attr name →
    list of values (None entries skipped).  Returns assigned node ids."""
    ids = np.empty(count, dtype=np.int64)
    # consume free list first, then a contiguous fresh range
    nfree = min(len(store.node_free), count)
    for i in range(nfree):
        ids[i] = store.node_free.pop()
    fresh = count - nfree
    if fresh:
        start = store.node_max
        store.node_max += fresh
        store._ensure_node_cap(store.node_max)
        ids[nfree:] = np.arange(start, start + fresh)
    store._own("node_exists")
    store.node_exists[ids] = True
    store._counts["nodes"] += count
    for label in labels:
        lid = store.schema.label_id(label, create=True)
        m = store._own_label(lid)
        if len(m) < store.node_cap:
            from falkordb_tpu_torch.graph.store import _grow_to

            m = _grow_to(m, store.node_cap, False)
            store.label_masks[lid] = m
        m[ids] = True
        store.label_counts[lid] = store.label_counts.get(lid, 0) + count
        store._invalidate(f"label:{lid}")
    if props:
        for name, values in props.items():
            aid = store.schema.attr_id(name, create=True)
            col = store.node_attrs._own(aid)
            col.grow(store.node_cap)
            col.set_many(ids, values)
    store._invalidate("node_exists")
    return ids


def bulk_create_edges(store, src: np.ndarray, dst: np.ndarray, reltype: str,
                      props: dict[str, list] | None = None) -> np.ndarray:
    """Create len(src) edges of one type; returns assigned edge ids."""
    from falkordb_tpu_torch.sparse.delta import DeltaMatrix

    count = len(src)
    ids = np.empty(count, dtype=np.int64)
    nfree = min(len(store.edge_free), count)
    for i in range(nfree):
        ids[i] = store.edge_free.pop()
    fresh = count - nfree
    if fresh:
        start = store.edge_max
        store.edge_max += fresh
        store._ensure_edge_cap(store.edge_max)
        ids[nfree:] = np.arange(start, start + fresh)
    tid = store.schema.reltype_id(reltype, create=True)
    for name in ("e_src", "e_dst", "e_type", "e_deleted"):
        store._own(name)
    store.e_src[ids] = src
    store.e_dst[ids] = dst
    store.e_type[ids] = tid
    store.e_deleted[ids] = False
    d = store.adj.get(tid)
    if d is None:
        d = DeltaMatrix((store.node_cap, store.node_cap))
        store.adj[tid] = d
    d.add_edges(src, dst, ids)
    if props:
        for name, values in props.items():
            aid = store.schema.attr_id(name, create=True)
            col = store.edge_attrs._own(aid)
            col.grow(store.edge_cap)
            col.set_many(ids, values)
    store._counts["edges"] += count
    store.type_counts[tid] = store.type_counts.get(tid, 0) + count
    store._adj_in_cache.pop(tid, None)
    store._invalidate("e_deleted", "e_src", "e_dst", "e_type")
    return ids


def bulk_insert(core, nodes=None, edges=None) -> dict:
    """Transactional bulk insert on a GraphCore.

    nodes: list of (labels, count, props) groups or
           (labels, [prop_dict, ...]) — both supported
    edges: list of (reltype, src_ids, dst_ids, props)
    Returns stats + per-group id arrays."""
    with core._write_lock:
        store = core.store.fork()
        out_nodes = []
        out_edges = []
        stats = {"nodes_created": 0, "relationships_created": 0}
        for group in nodes or []:
            if len(group) == 2:
                labels, dicts = group
                keys = sorted({k for d in dicts for k in d})
                props = {k: [d.get(k) for d in dicts] for k in keys}
                count = len(dicts)
            else:
                labels, count, props = group
            ids = bulk_create_nodes(store, list(labels), count, props)
            stats["nodes_created"] += count
            out_nodes.append(ids)
        for (reltype, src, dst, props) in edges or []:
            ids = bulk_create_edges(store, np.asarray(src, dtype=np.int64),
                                    np.asarray(dst, dtype=np.int64),
                                    reltype, props)
            stats["relationships_created"] += len(ids)
            out_edges.append(ids)
        store.flush(force=True)  # flush_for_bulk (graph.rs:2087)
        core.store = store
        core._reindex(None)
    return {"stats": stats, "node_ids": out_nodes, "edge_ids": out_edges}


# --------------------------------------------------------------------------
# BI_* binary token codec — the wire format the reference's Python bulk
# loader emits and src/commands/bulk_insert.rs consumes.
#
# Token layout:
#   header:  labels cstring (colon-separated) | u32 prop_count |
#            prop_count × name cstring
#   node record:  prop_count typed values
#   edge record:  u64 src node id | u64 dst node id | prop_count typed values
#   typed value:  u8 marker then BI_NULL | BI_BOOL u8 | BI_DOUBLE f64 |
#                 BI_STRING cstring | BI_LONG i64 | BI_ARRAY i64 len + items
# All integers native-endian (the loader runs on the same host class).
# --------------------------------------------------------------------------

import struct

BI_NULL, BI_BOOL, BI_DOUBLE, BI_STRING, BI_LONG, BI_ARRAY = range(6)


class BulkFormatError(ValueError):
    pass


def _read_cstring(data: bytes, idx: int) -> tuple[str, int]:
    end = data.find(b"\0", idx)
    if end < 0:
        raise BulkFormatError("unterminated string in bulk data")
    return data[idx:end].decode("utf-8"), end + 1


def _read_value(data: bytes, idx: int, depth: int = 0):
    if idx >= len(data):
        raise BulkFormatError("unexpected end of bulk data reading type")
    if depth > 64:
        # bounded recursion (the reference uses an explicit work stack for
        # the same attacker-supplied-depth reason)
        raise BulkFormatError("bulk array nesting too deep")
    t = data[idx]
    idx += 1
    if t == BI_NULL:
        return None, idx
    if t == BI_BOOL:
        return data[idx] != 0, idx + 1
    if t == BI_DOUBLE:
        return struct.unpack_from("=d", data, idx)[0], idx + 8
    if t == BI_LONG:
        return struct.unpack_from("=q", data, idx)[0], idx + 8
    if t == BI_STRING:
        return _read_cstring(data, idx)
    if t == BI_ARRAY:
        (ln,) = struct.unpack_from("=q", data, idx)
        idx += 8
        if ln < 0 or ln > len(data) - idx:
            raise BulkFormatError(f"bad bulk array length {ln}")
        out = []
        for _ in range(ln):
            v, idx = _read_value(data, idx, depth + 1)
            out.append(v)
        return out, idx
    raise BulkFormatError(f"unknown bulk property type: {t}")


def _read_header(data: bytes, idx: int) -> tuple[list[str], list[str], int]:
    names, idx = _read_cstring(data, idx)
    if idx + 4 > len(data):
        raise BulkFormatError("unexpected end of bulk data reading u32")
    (nprops,) = struct.unpack_from("=I", data, idx)
    idx += 4
    props = []
    for _ in range(nprops):
        p, idx = _read_cstring(data, idx)
        props.append(p)
    return names.split(":"), props, idx


def decode_node_token(data: bytes):
    """→ (labels, [prop_dict, ...])."""
    labels, prop_names, idx = _read_header(data, 0)
    dicts = []
    while idx < len(data):
        d = {}
        for name in prop_names:
            v, idx = _read_value(data, idx)
            if v is not None:
                d[name] = v
        dicts.append(d)
    return labels, dicts


def decode_edge_token(data: bytes):
    """→ (reltype, srcs, dsts, [prop_dict, ...])."""
    types, prop_names, idx = _read_header(data, 0)
    if len(types) != 1:
        raise BulkFormatError(
            f"edges must have exactly one type, got {len(types)}")
    srcs, dsts, dicts = [], [], []
    while idx < len(data):
        if idx + 16 > len(data):
            raise BulkFormatError("unexpected end of bulk data reading edge")
        s, d = struct.unpack_from("=QQ", data, idx)
        idx += 16
        srcs.append(s)
        dsts.append(d)
        pd = {}
        for name in prop_names:
            v, idx = _read_value(data, idx)
            if v is not None:
                pd[name] = v
        dicts.append(pd)
    return types[0], srcs, dsts, dicts


def _write_value(buf: bytearray, v):
    if v is None:
        buf.append(BI_NULL)
    elif isinstance(v, bool):
        buf.append(BI_BOOL)
        buf.append(1 if v else 0)
    elif isinstance(v, int):
        buf.append(BI_LONG)
        buf += struct.pack("=q", v)
    elif isinstance(v, float):
        buf.append(BI_DOUBLE)
        buf += struct.pack("=d", v)
    elif isinstance(v, str):
        buf.append(BI_STRING)
        buf += v.encode("utf-8") + b"\0"
    elif isinstance(v, (list, tuple)):
        buf.append(BI_ARRAY)
        buf += struct.pack("=q", len(v))
        for x in v:
            _write_value(buf, x)
    else:
        raise BulkFormatError(f"unencodable bulk value {type(v).__name__}")


def encode_node_token(labels: list[str], prop_names: list[str],
                      rows: list[list]) -> bytes:
    """Loader-side encoder (mirrors the reference bulk loader's output;
    used by clients and the round-trip tests)."""
    buf = bytearray()
    buf += ":".join(labels).encode("utf-8") + b"\0"
    buf += struct.pack("=I", len(prop_names))
    for p in prop_names:
        buf += p.encode("utf-8") + b"\0"
    for row in rows:
        for v in row:
            _write_value(buf, v)
    return bytes(buf)


def encode_edge_token(reltype: str, prop_names: list[str],
                      rows: list[tuple]) -> bytes:
    """rows: (src, dst, *props)."""
    buf = bytearray()
    buf += reltype.encode("utf-8") + b"\0"
    buf += struct.pack("=I", len(prop_names))
    for p in prop_names:
        buf += p.encode("utf-8") + b"\0"
    for row in rows:
        buf += struct.pack("=QQ", int(row[0]), int(row[1]))
        for v in row[2:]:
            _write_value(buf, v)
    return bytes(buf)


def bulk_insert_binary(core, node_tokens: list[bytes],
                       edge_tokens: list[bytes],
                       node_count: int | None = None,
                       edge_count: int | None = None) -> dict:
    """GRAPH.BULK binary path: decode BI_* tokens, then run the same
    vectorized insert.  Edge src/dst reference nodes by 0-based insertion
    order across the whole bulk (the reference reserves ids up front —
    reserve order IS record order)."""
    nodes = []
    total_nodes = 0
    for tok in node_tokens:
        labels, dicts = decode_node_token(tok)
        total_nodes += len(dicts)
        nodes.append((labels, dicts))
    if node_count is not None and total_nodes != node_count:
        raise BulkFormatError(
            f"advertised {node_count} nodes, tokens carry {total_nodes}")
    edges = []
    total_edges = 0
    for tok in edge_tokens:
        reltype, srcs, dsts, dicts = decode_edge_token(tok)
        total_edges += len(srcs)
        keys = sorted({k for d in dicts for k in d})
        props = {k: [d.get(k) for d in dicts] for k in keys} if keys else None
        edges.append((reltype, srcs, dsts, props))
    if edge_count is not None and total_edges != edge_count:
        raise BulkFormatError(
            f"advertised {edge_count} edges, tokens carry {total_edges}")
    out = bulk_insert(core, nodes=nodes, edges=[])
    # remap record-order indices to the actually assigned node ids
    id_map = np.concatenate([np.asarray(ids) for ids in out["node_ids"]]) \
        if out["node_ids"] else np.zeros(0, np.int64)
    with core._write_lock:
        store = core.store.fork()
        for reltype, srcs, dsts, props in edges:
            s = np.asarray(srcs, dtype=np.int64)
            d = np.asarray(dsts, dtype=np.int64)
            if len(id_map) and ((s >= len(id_map)).any()
                                or (d >= len(id_map)).any()):
                raise BulkFormatError("edge references unknown node id")
            if len(id_map):
                s = id_map[s]
                d = id_map[d]
            ids = bulk_create_edges(store, s, d, reltype, props)
            out["stats"]["relationships_created"] += len(ids)
            out["edge_ids"].append(ids)
        store.flush(force=True)
        core.store = store
        core._reindex(None)
    return out
