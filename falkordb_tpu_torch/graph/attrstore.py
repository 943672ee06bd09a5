"""Columnar attribute store with copy-on-write columns.

The reference packs per-entity attribute sets into radix-directory blocks
(graph/src/graph/attribute_store.rs, doc:18-67).  The TPU-first redesign is
**column-oriented**: one column per attribute id, so

  * numeric predicate filters gather a single contiguous column onto the
    device (the vectorized.rs fast path becomes a real SIMD/VPU path),
  * index builds are column scans,
  * MVCC copy-on-write happens at column granularity (the block-COW idea,
    one level coarser).

Each column is a numpy object array (Cypher properties are dynamically
typed) plus a lazily-built numeric mirror (float64 + validity) for device
filtering.  Missing is represented by the sentinel `ABSENT` (not None:
Cypher NULL is a storable-adjacent concept we keep distinct from missing).
"""

from __future__ import annotations

import numpy as np

class _Absent:
    """Singleton 'no entry' sentinel; survives pickling with identity."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __reduce__(self):
        return (_Absent, ())

    def __repr__(self):
        return "<ABSENT>"


ABSENT = _Absent()  # property missing (GraphBLAS "no entry")


class Column:
    __slots__ = ("data", "_mirror", "_version")

    def __init__(self, cap: int):
        self.data = np.full(cap, ABSENT, dtype=object)
        self._mirror = None  # (tag, vals, valid, is_int) | False (=mixed)
        self._version = 0

    def copy(self) -> "Column":
        c = Column.__new__(Column)
        c.data = self.data.copy()
        c._mirror = None
        c._version = self._version
        return c

    def grow(self, cap: int) -> None:
        if cap <= len(self.data):
            return
        nd = np.full(cap, ABSENT, dtype=object)
        nd[: len(self.data)] = self.data
        self.data = nd
        if self._mirror:
            tag, vals, valid, is_int = self._mirror
            nv = np.zeros(cap, dtype=vals.dtype)
            nv[: len(vals)] = vals
            nvalid = np.zeros(cap, dtype=bool)
            nvalid[: len(valid)] = valid
            self._mirror = (tag, nv, nvalid, is_int)

    def set(self, idx, value) -> None:
        self.data[idx] = value
        self._version += 1
        # incremental mirror maintenance: O(1) per write instead of a full
        # O(n) rebuild per commit (the reference updates RediSearch docs
        # incrementally, graph/src/graph/graph.rs:337-420)
        m = self._mirror
        if m is None or m is False:
            return
        tag, vals, valid, numk = m
        if value is ABSENT or value is None:
            valid[idx] = False
            return
        if tag == "num" and isinstance(value, (int, float, np.integer,
                                               np.floating)) \
                and not isinstance(value, bool):
            f = float(value)
            intlike = isinstance(value, (int, np.integer))
            if (f != f) or (intlike and not (-(2**53) < value < 2**53)):
                self._mirror = False
                return
            vals[idx] = f
            valid[idx] = True
            nk = "int" if intlike else "float"
            if numk is None:
                self._mirror = (tag, vals, valid, nk)
            elif numk != nk:
                self._mirror = (tag, vals, valid, "mixed")
            return
        if tag == "str" and isinstance(value, str):
            vals[idx] = value
            valid[idx] = True
            return
        if tag == "bool" and isinstance(value, (bool, np.bool_)):
            vals[idx] = 1 if value else 0
            valid[idx] = True
            return
        if numk is None and tag == "num" and not valid.any():
            # empty placeholder mirror: retype to the first real value
            self._mirror = None
            self._mirror = self._build_mirror()
            return
        self._mirror = False  # column became type-mixed

    def set_many(self, ids, values) -> None:
        """Vectorized bulk write (GRAPH.BULK path): one object fancy
        assign instead of per-row set(); the typed mirror is rebuilt
        lazily on the next filter.  None entries are skipped (absent)."""
        ids = np.asarray(ids)
        vals = np.empty(len(ids), dtype=object)
        vals[:] = list(values)
        mask = np.fromiter((v is not None for v in vals), bool, len(vals))
        self.data[ids[mask]] = vals[mask]
        self._version += 1
        self._mirror = None

    def get(self, idx):
        return self.data[idx]

    def typed_mirror(self):
        """Homogeneous typed mirror (tag, vals, valid, numk) or None.

        tag 'num': vals float64, numk 'int'|'float'|'mixed'|None (exactness
        of reconstruction: 'int' columns round-trip via int(v));
        tag 'str': vals object strings; tag 'bool': vals uint8.
        valid[i] False = ABSENT/None.  None when the column mixes type
        classes — the per-row object path handles those."""
        if self._mirror is None:
            self._mirror = self._build_mirror()
        return self._mirror or None

    def _build_mirror(self):
        n = len(self.data)
        tag = None
        saw_int = saw_float = False
        for v in self.data:
            if v is ABSENT or v is None:
                continue
            if isinstance(v, (bool, np.bool_)):
                t = "bool"
            elif isinstance(v, (int, np.integer)):
                t = "num"
                saw_int = True
                if not (-(2**53) < v < 2**53):
                    return False
            elif isinstance(v, (float, np.floating)):
                t = "num"
                saw_float = True
                if v != v:
                    return False
            elif isinstance(v, str):
                t = "str"
            else:
                return False
            if tag is None:
                tag = t
            elif tag != t:
                return False
        if tag is None:
            tag = "num"  # empty column: any typed read sees all-invalid
        numk = ("mixed" if saw_int and saw_float else
                "int" if saw_int else "float" if saw_float else None)
        valid = np.array([v is not ABSENT and v is not None
                          for v in self.data], dtype=bool)
        if tag == "num":
            vals = np.zeros(n, dtype=np.float64)
            idx = np.nonzero(valid)[0]
            for i in idx:
                vals[i] = self.data[i]
        elif tag == "str":
            vals = np.empty(n, dtype=object)
            vals.fill("")
            for i in np.nonzero(valid)[0]:
                vals[i] = self.data[i]
        else:
            vals = np.zeros(n, dtype=np.uint8)
            for i in np.nonzero(valid)[0]:
                vals[i] = 1 if self.data[i] else 0
        return (tag, vals, valid, numk)


class AttributeStore:
    """attr_id → Column, with COW fork for MVCC snapshots.

    `dirty` journals entity ids touched since fork() — consumed by the
    incremental index maintainer (index/manager.py refresh_indexes; the
    reference's per-commit RediSearch doc updates, graph.rs:337-420)."""

    def __init__(self, cap: int = 0):
        self.cap = cap
        self.columns: dict[int, Column] = {}
        self._owned: set[int] = set()  # columns private to this fork
        self.dirty: set[int] = set()
        # which attr ids each dirty entity touched — lets the index
        # maintainer skip entities whose changed attrs aren't indexed
        self.dirty_aids: dict[int, set[int]] = {}

    def fork(self) -> "AttributeStore":
        s = AttributeStore.__new__(AttributeStore)
        s.cap = self.cap
        s.columns = dict(self.columns)  # share column objects
        s._owned = set()
        s.dirty = set()
        s.dirty_aids = {}
        return s

    def _own(self, attr_id: int) -> Column:
        col = self.columns.get(attr_id)
        if col is None:
            col = Column(self.cap)
            self.columns[attr_id] = col
            self._owned.add(attr_id)
        elif attr_id not in self._owned:
            col = col.copy()
            self.columns[attr_id] = col
            self._owned.add(attr_id)
        return col

    def grow(self, cap: int) -> None:
        if cap <= self.cap:
            return
        self.cap = cap
        for aid in list(self.columns):
            col = self._own(aid)
            col.grow(cap)

    def set(self, entity_id: int, attr_id: int, value) -> bool:
        """Returns True if this stored/changed a value; value ABSENT deletes."""
        col = self._own(attr_id)
        old = col.get(entity_id)
        if value is ABSENT and old is ABSENT:
            return False
        col.set(entity_id, value)
        self.dirty.add(int(entity_id))
        self.dirty_aids.setdefault(int(entity_id), set()).add(int(attr_id))
        return True

    def get(self, entity_id: int, attr_id: int):
        col = self.columns.get(attr_id)
        if col is None:
            return ABSENT
        return col.get(entity_id)

    def get_all(self, entity_id: int) -> dict[int, object]:
        out = {}
        for aid, col in self.columns.items():
            v = col.get(entity_id)
            if v is not ABSENT:
                out[aid] = v
        return out

    def clear_entity(self, entity_id: int) -> int:
        """Remove all attributes of an entity (on delete); returns count."""
        n = 0
        for aid, col in list(self.columns.items()):
            if col.get(entity_id) is not ABSENT:
                self._own(aid).set(entity_id, ABSENT)
                n += 1
        if n:
            self.dirty.add(int(entity_id))
            self.dirty_aids.pop(int(entity_id), None)  # all-attrs change
        return n

    def memory_bytes(self) -> int:
        return sum(c.data.nbytes for c in self.columns.values())
