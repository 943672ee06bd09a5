"""Columnar row frames flowing between operators.

The reference's Batch (graph/src/runtime/batch.rs): typed columns indexed by
variable slot, BATCH_SIZE-row chunks, selection by index vectors.  Node and
edge references stay as int64 id arrays until materialization; -1 is the
null reference (OPTIONAL MATCH misses)."""

from __future__ import annotations

import numpy as np

BATCH_SIZE = 1024

NULL_ID = -1


def _deep_size(v, depth: int = 0) -> int:
    """Rough recursive byte size of a Cypher value (bounded depth)."""
    if v is None or isinstance(v, (bool, int, float)):
        return 16
    if isinstance(v, str):
        return 56 + len(v)
    if depth >= 4:
        return 64
    if isinstance(v, (list, tuple)):
        return 56 + sum(_deep_size(x, depth + 1) for x in v[:64]) * \
            max(1, len(v) // max(1, min(len(v), 64)))
    if isinstance(v, dict):
        return 64 + sum(56 + len(str(k)) + _deep_size(x, depth + 1)
                        for k, x in list(v.items())[:32])
    props = getattr(v, "properties", None)
    if props is not None:  # NodeVal / EdgeVal / PathVal
        return 96 + _deep_size(props, depth + 1)
    return 64


class Column:
    __slots__ = ("kind", "ids", "data", "_tv")

    def __init__(self, kind: str, ids: np.ndarray | None = None,
                 data: np.ndarray | None = None):
        self.kind = kind  # 'node' | 'edge' | 'value'
        self.ids = ids  # int64 entity ids (node/edge kinds)
        self.data = data  # object values ('value' kind)
        self._tv = None  # cached typed view (runtime/vectorized.py)

    @staticmethod
    def nodes(ids) -> "Column":
        return Column("node", ids=np.asarray(ids, dtype=np.int64))

    @staticmethod
    def edges(ids) -> "Column":
        return Column("edge", ids=np.asarray(ids, dtype=np.int64))

    @staticmethod
    def values(data) -> "Column":
        arr = np.empty(len(data), dtype=object)
        try:
            arr[:] = data  # C-speed fill for scalar elements
        except ValueError:  # rectangular nested sequences: elementwise
            for i, v in enumerate(data):
                arr[i] = v
        return Column("value", data=arr)

    @staticmethod
    def from_object_array(arr: np.ndarray) -> "Column":
        return Column("value", data=arr)

    def __len__(self):
        return len(self.ids) if self.ids is not None else len(self.data)

    def nbytes(self) -> int:
        """Heap footprint estimate for QUERY_MEM_CAPACITY accounting (the
        reference counts real allocations via a TLS allocator; here entity
        columns cost their id array and value columns a sampled deep size
        extrapolated across the column)."""
        if self.ids is not None:
            return 8 * len(self.ids)
        n = len(self.data)
        if n == 0:
            return 0
        step = max(1, n // 8)
        sample = [self.data[i] for i in range(0, n, step)][:8]
        per = sum(_deep_size(v) for v in sample) / len(sample)
        return int(per * n)

    def entity_ids(self) -> np.ndarray:
        """int64 entity ids with NULL_ID for nulls.  Value columns holding
        entity objects (OPTIONAL MATCH nulls flowing through coalesce/
        projections) convert element-wise; traversing FROM a null emits no
        rows (TCK Match3 [28]), a non-entity value is a type error."""
        if self.ids is not None:
            return self.ids
        from falkordb_tpu_torch.runtime.value import EdgeVal, NodeVal

        out = np.full(len(self.data), NULL_ID, dtype=np.int64)
        for i, v in enumerate(self.data):
            if v is None:
                continue
            if isinstance(v, (NodeVal, EdgeVal)):
                out[i] = v.id
            else:
                raise TypeError(
                    f"expected a node or relationship, got "
                    f"{type(v).__name__}")
        return out

    def take(self, idx) -> "Column":
        if self.kind == "value":
            out = Column("value", data=self.data[idx])
            tv = self._tv
            if tv is not None and tv is not False and tv.vals is not None:
                # slice the cached typed view along with the data so
                # downstream sorts/groupers skip the re-typify scan
                out._tv = tv.__class__(
                    tv.kind, tv.vals[idx], tv.null[idx],
                    is_int=tv.is_int, num_mixed=tv.num_mixed,
                    orig=tv.orig[idx] if tv.orig is not None else None)
            return out
        return Column(self.kind, ids=self.ids[idx])

    @staticmethod
    def concat(cols: list["Column"]) -> "Column":
        kinds = {c.kind for c in cols}
        if kinds == {"value"} or len(kinds) > 1:
            # mixed kinds force materialization upstream; here all same
            out = Column("value",
                         data=np.concatenate([c.data for c in cols]))
            tvs = [c._tv if c.kind == "value" else None for c in cols]
            t0 = tvs[0]
            if t0 is not None and t0 is not False \
                    and t0.vals is not None and not t0.num_mixed and all(
                        t is not None and t is not False
                        and t.vals is not None and t.kind == t0.kind
                        and t.is_int == t0.is_int and not t.num_mixed
                        for t in tvs):
                has_orig = all(t.orig is not None for t in tvs)
                out._tv = t0.__class__(
                    t0.kind, np.concatenate([t.vals for t in tvs]),
                    np.concatenate([t.null for t in tvs]),
                    is_int=t0.is_int,
                    orig=np.concatenate([t.orig for t in tvs])
                    if has_orig else None)
            return out
        return Column(cols[0].kind, ids=np.concatenate([c.ids for c in cols]))


class Batch:
    """A frame of `n` rows with columns keyed by variable slot.

    `_aux` holds name-keyed helper columns for comprehension/reduce local
    variables (never crosses operator boundaries)."""

    __slots__ = ("n", "cols", "_aux")

    def __init__(self, n: int, cols: dict[int, Column] | None = None):
        self.n = n
        self.cols = cols or {}
        self._aux = None

    def with_col(self, slot: int, col: Column) -> "Batch":
        cols = dict(self.cols)
        cols[slot] = col
        return Batch(self.n, cols)

    def take(self, idx) -> "Batch":
        idx = np.asarray(idx)
        return Batch(len(idx), {s: c.take(idx) for s, c in self.cols.items()})

    @staticmethod
    def unit() -> "Batch":
        """The single-empty-row seed frame (for RETURN 1, CREATE ...)."""
        return Batch(1, {})

    @staticmethod
    def concat(batches: list["Batch"]) -> "Batch":
        if not batches:
            return Batch(0, {})
        slots = set()
        for b in batches:
            slots.update(b.cols)
        cols = {}
        for s in slots:
            parts = []
            for b in batches:
                c = b.cols.get(s)
                if c is None:
                    c = Column.values([None] * b.n)
                parts.append(c)
            kinds = {p.kind for p in parts}
            if len(kinds) > 1:
                ent = (kinds - {"value"}).pop()
                if len(kinds - {"value"}) == 1 and all(
                    p.kind != "value" or all(v is None for v in p.data)
                    for p in parts
                ):
                    # entity column + all-null value parts (OPTIONAL/UNION
                    # misses): keep the id representation, null = -1
                    ids = np.concatenate([
                        p.ids if p.kind != "value"
                        else np.full(len(p.data), NULL_ID, dtype=np.int64)
                        for p in parts
                    ])
                    cols[s] = Column(ent, ids=ids)
                else:
                    raise TypeError(
                        f"cannot concat mixed column kinds {kinds} for slot {s}; "
                        "materialize to values first"
                    )
            else:
                cols[s] = Column.concat(parts)
        return Batch(sum(b.n for b in batches), cols)
