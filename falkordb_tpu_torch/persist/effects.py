"""Binary effects log — replication format.

The reference replicates writes either as verbatim query replay or as a
compact binary opcode buffer (pending.rs:1629 EFFECTS_VERSION=2, opcodes
EFFECT_UPDATE_NODE..EFFECT_DROP_INDEX; replica applier
src/commands/effect.rs).  This module defines our effects codec: an opcode
stream of concrete mutations recorded during write execution, applied
deterministically on replicas.

Wire layout: [MAGIC u32][VERSION u16][count u32] then per-effect:
[opcode u8][payload...].  Values use tag-prefixed encoding (the BI_* typed
marker idea, bulk_insert.rs:21-26)."""

from __future__ import annotations

import struct

import numpy as np

MAGIC = 0x46504744  # 'FPGD'
VERSION = 1

OP_CREATE_NODE = 1
OP_CREATE_EDGE = 2
OP_DELETE_NODE = 3
OP_DELETE_EDGE = 4
OP_SET_ATTR = 5
OP_ADD_LABELS = 6
OP_REMOVE_LABELS = 7

V_NULL, V_BOOL, V_INT, V_DOUBLE, V_STRING, V_ARRAY, V_MAP, V_VECF32, V_POINT = range(9)


def _enc_value(out: bytearray, v):
    from falkordb_tpu_torch.runtime.value import PointVal, VectorF32

    if v is None:
        out.append(V_NULL)
    elif isinstance(v, bool):
        out.append(V_BOOL)
        out.append(1 if v else 0)
    elif isinstance(v, (int, np.integer)):
        out.append(V_INT)
        out.extend(struct.pack("<q", int(v)))
    elif isinstance(v, (float, np.floating)):
        out.append(V_DOUBLE)
        out.extend(struct.pack("<d", float(v)))
    elif isinstance(v, str):
        b = v.encode()
        out.append(V_STRING)
        out.extend(struct.pack("<I", len(b)))
        out.extend(b)
    elif isinstance(v, (list, tuple)):
        out.append(V_ARRAY)
        out.extend(struct.pack("<I", len(v)))
        for x in v:
            _enc_value(out, x)
    elif isinstance(v, dict):
        out.append(V_MAP)
        out.extend(struct.pack("<I", len(v)))
        for k, x in v.items():
            kb = str(k).encode()
            out.extend(struct.pack("<I", len(kb)))
            out.extend(kb)
            _enc_value(out, x)
    elif isinstance(v, VectorF32):
        out.append(V_VECF32)
        data = np.asarray(v.data, dtype="<f4").tobytes()
        out.extend(struct.pack("<I", v.data.shape[0]))
        out.extend(data)
    elif isinstance(v, PointVal):
        out.append(V_POINT)
        out.extend(struct.pack("<dd", v.latitude, v.longitude))
    else:
        raise TypeError(f"cannot encode effect value {type(v).__name__}")


def _dec_value(buf: memoryview, pos: int):
    from falkordb_tpu_torch.runtime.value import PointVal, VectorF32

    tag = buf[pos]
    pos += 1
    if tag == V_NULL:
        return None, pos
    if tag == V_BOOL:
        return bool(buf[pos]), pos + 1
    if tag == V_INT:
        return struct.unpack_from("<q", buf, pos)[0], pos + 8
    if tag == V_DOUBLE:
        return struct.unpack_from("<d", buf, pos)[0], pos + 8
    if tag == V_STRING:
        n = struct.unpack_from("<I", buf, pos)[0]
        pos += 4
        return bytes(buf[pos : pos + n]).decode(), pos + n
    if tag == V_ARRAY:
        n = struct.unpack_from("<I", buf, pos)[0]
        pos += 4
        out = []
        for _ in range(n):
            v, pos = _dec_value(buf, pos)
            out.append(v)
        return out, pos
    if tag == V_MAP:
        n = struct.unpack_from("<I", buf, pos)[0]
        pos += 4
        out = {}
        for _ in range(n):
            kn = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
            k = bytes(buf[pos : pos + kn]).decode()
            pos += kn
            v, pos = _dec_value(buf, pos)
            out[k] = v
        return out, pos
    if tag == V_VECF32:
        n = struct.unpack_from("<I", buf, pos)[0]
        pos += 4
        arr = np.frombuffer(buf[pos : pos + 4 * n], dtype="<f4").copy()
        return VectorF32(arr), pos + 4 * n
    if tag == V_POINT:
        lat, lon = struct.unpack_from("<dd", buf, pos)
        return PointVal(lat, lon), pos + 16
    raise ValueError(f"bad value tag {tag}")


def _enc_str(out, s: str):
    b = s.encode()
    out.extend(struct.pack("<I", len(b)))
    out.extend(b)


def _dec_str(buf, pos):
    n = struct.unpack_from("<I", buf, pos)[0]
    pos += 4
    return bytes(buf[pos : pos + n]).decode(), pos + n


def encode_effects(effects: list[tuple]) -> bytes:
    out = bytearray()
    out.extend(struct.pack("<IHI", MAGIC, VERSION, len(effects)))
    for eff in effects:
        op = eff[0]
        out.append(op)
        if op == OP_CREATE_NODE:
            _, nid, labels, attrs = eff
            out.extend(struct.pack("<q", nid))
            out.extend(struct.pack("<I", len(labels)))
            for l in labels:
                _enc_str(out, l)
            _enc_value(out, attrs)
        elif op == OP_CREATE_EDGE:
            _, eid, src, dst, rtype, attrs = eff
            out.extend(struct.pack("<qqq", eid, src, dst))
            _enc_str(out, rtype)
            _enc_value(out, attrs)
        elif op in (OP_DELETE_NODE, OP_DELETE_EDGE):
            out.extend(struct.pack("<q", eff[1]))
        elif op == OP_SET_ATTR:
            _, kind, ent, attr, value = eff
            out.append(0 if kind == "node" else 1)
            out.extend(struct.pack("<q", ent))
            _enc_str(out, attr)
            _enc_value(out, value)
        elif op in (OP_ADD_LABELS, OP_REMOVE_LABELS):
            _, nid, labels = eff
            out.extend(struct.pack("<q", nid))
            out.extend(struct.pack("<I", len(labels)))
            for l in labels:
                _enc_str(out, l)
        else:
            raise ValueError(f"unknown effect opcode {op}")
    return bytes(out)


def decode_effects(data: bytes) -> list[tuple]:
    buf = memoryview(data)
    magic, version, count = struct.unpack_from("<IHI", buf, 0)
    if magic != MAGIC:
        raise ValueError("bad effects magic")
    if version != VERSION:
        raise ValueError(f"unsupported effects version {version}")
    pos = 10
    out = []
    for _ in range(count):
        op = buf[pos]
        pos += 1
        if op == OP_CREATE_NODE:
            nid = struct.unpack_from("<q", buf, pos)[0]
            pos += 8
            nl = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
            labels = []
            for _ in range(nl):
                l, pos = _dec_str(buf, pos)
                labels.append(l)
            attrs, pos = _dec_value(buf, pos)
            out.append((op, nid, labels, attrs))
        elif op == OP_CREATE_EDGE:
            eid, src, dst = struct.unpack_from("<qqq", buf, pos)
            pos += 24
            rtype, pos = _dec_str(buf, pos)
            attrs, pos = _dec_value(buf, pos)
            out.append((op, eid, src, dst, rtype, attrs))
        elif op in (OP_DELETE_NODE, OP_DELETE_EDGE):
            ent = struct.unpack_from("<q", buf, pos)[0]
            pos += 8
            out.append((op, ent))
        elif op == OP_SET_ATTR:
            kind = "node" if buf[pos] == 0 else "edge"
            pos += 1
            ent = struct.unpack_from("<q", buf, pos)[0]
            pos += 8
            attr, pos = _dec_str(buf, pos)
            value, pos = _dec_value(buf, pos)
            out.append((op, kind, ent, attr, value))
        elif op in (OP_ADD_LABELS, OP_REMOVE_LABELS):
            nid = struct.unpack_from("<q", buf, pos)[0]
            pos += 8
            nl = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
            labels = []
            for _ in range(nl):
                l, pos = _dec_str(buf, pos)
                labels.append(l)
            out.append((op, nid, labels))
        else:
            raise ValueError(f"unknown effect opcode {op}")
    return out


def apply_effects(store, effects: list[tuple]) -> dict:
    """Replay decoded effects onto a GraphStore (replica side,
    src/commands/effect.rs).  Entity ids are authoritative — the replica
    reserves the exact ids the primary assigned."""
    from falkordb_tpu_torch.graph.attrstore import ABSENT

    stats = {"nodes_created": 0, "relationships_created": 0,
             "nodes_deleted": 0, "relationships_deleted": 0,
             "properties_set": 0, "labels_added": 0, "labels_removed": 0}
    for eff in effects:
        op = eff[0]
        if op == OP_CREATE_NODE:
            _, nid, labels, attrs = eff
            _create_node_with_id(store, nid, labels, attrs)
            stats["nodes_created"] += 1
        elif op == OP_CREATE_EDGE:
            _, eid, src, dst, rtype, attrs = eff
            _create_edge_with_id(store, eid, src, dst, rtype, attrs)
            stats["relationships_created"] += 1
        elif op == OP_DELETE_NODE:
            if store.delete_node(eff[1]):
                stats["nodes_deleted"] += 1
        elif op == OP_DELETE_EDGE:
            if store.delete_edge(eff[1]):
                stats["relationships_deleted"] += 1
        elif op == OP_SET_ATTR:
            _, kind, ent, attr, value = eff
            attrs_store = store.node_attrs if kind == "node" else store.edge_attrs
            aid = store.schema.attr_id(attr, create=True)
            attrs_store.set(ent, aid, ABSENT if value is None else value)
            stats["properties_set"] += 1
        elif op == OP_ADD_LABELS:
            _, nid, labels = eff
            for l in labels:
                if store.add_label(nid, store.schema.label_id(l, create=True)):
                    stats["labels_added"] += 1
        elif op == OP_REMOVE_LABELS:
            _, nid, labels = eff
            for l in labels:
                lid = store.schema.label_id(l)
                if lid is not None and store.remove_label(nid, lid):
                    stats["labels_removed"] += 1
    store.flush(force=True)
    return stats


def _create_node_with_id(store, nid, labels, attrs):
    store._ensure_node_cap(nid + 1)
    if nid in store.node_free:
        store.node_free.remove(nid)
    if nid >= store.node_max:
        for fill in range(store.node_max, nid):
            store.node_free.append(fill)
        store.node_max = nid + 1
    store._own("node_exists")
    store.node_exists[nid] = True
    store._counts["nodes"] += 1
    for l in labels:
        store.add_label(nid, store.schema.label_id(l, create=True))
    for k, v in (attrs or {}).items():
        store.node_attrs.set(nid, store.schema.attr_id(k, create=True), v)
    store._invalidate("node_exists")


def _create_edge_with_id(store, eid, src, dst, rtype, attrs):
    from falkordb_tpu_torch.sparse.delta import DeltaMatrix

    store._ensure_edge_cap(eid + 1)
    if eid in store.edge_free:
        store.edge_free.remove(eid)
    if eid >= store.edge_max:
        for fill in range(store.edge_max, eid):
            store.edge_free.append(fill)
        store.edge_max = eid + 1
    tid = store.schema.reltype_id(rtype, create=True)
    for name in ("e_src", "e_dst", "e_type", "e_deleted"):
        store._own(name)
    store.e_src[eid] = src
    store.e_dst[eid] = dst
    store.e_type[eid] = tid
    store.e_deleted[eid] = False
    d = store.adj.get(tid)
    if d is None:
        d = DeltaMatrix((store.node_cap, store.node_cap))
        store.adj[tid] = d
    d.add_edges([src], [dst], [eid])
    for k, v in (attrs or {}).items():
        store.edge_attrs.set(eid, store.schema.attr_id(k, create=True), v)
    store._counts["edges"] += 1
    store.type_counts[tid] = store.type_counts.get(tid, 0) + 1
    store._adj_in_cache.pop(tid, None)
    store._invalidate("e_deleted", "e_src", "e_dst", "e_type")
