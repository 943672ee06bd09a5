"""Index manager: DDL, incremental maintenance, background population.

The reference's indexer (graph/src/index/indexer.rs:19-37) keeps lock-free
snapshots of the index map, populates new indexes in background batches of
10,000 with a cursor (graph/src/graph/graph.rs:337-420), and updates
documents incrementally on every commit.  Here:

  * `refresh_indexes` consumes the write fork's dirty-entity journal
    (GraphStore.dirty_entities) and applies per-index deltas —
    O(changed · log n) per commit instead of O(index);
  * a full rebuild happens only when provenance is unknown (fresh
    load/restore) or the delta is a large fraction of the graph;
  * CREATE INDEX populates synchronously by default; with config
    `delay_indexing` on, population runs on a background thread in
    BATCH_SIZE-id chunks with an UnderConstruction → Operational
    lifecycle — the planner uses only Operational indexes, and commits
    that land mid-population journal into `pending_dirty`, replayed
    before the flip."""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

import numpy as np

BATCH_SIZE = 10_000  # background population chunk (graph.rs BATCH_SIZE)

UNDER_CONSTRUCTION = "under construction"
OPERATIONAL = "operational"
FAILED = "failed"


@dataclass
class IndexDef:
    kind: str  # 'range' | 'fulltext' | 'vector'
    entity: str  # 'node' | 'edge'
    label: str
    props: tuple
    options: dict = field(default_factory=dict)
    impl: object = None
    status: str = OPERATIONAL
    pending_dirty: set = field(default_factory=set)
    _lock: threading.Lock = field(default_factory=threading.Lock)

    @property
    def key(self):
        return (self.kind, self.entity, self.label, self.props)


def apply_ddl(core, kind: str, clause, rt):
    if kind == "create_index":
        props = tuple(clause.props)
        d = IndexDef(clause.kind, clause.entity, clause.label, props)
        if d.key in core.indexes:
            if clause.if_not_exists:
                return
            raise ValueError(
                f"index on {clause.label}({', '.join(props)}) already exists")
        if clause.options is not None:
            from falkordb_tpu_torch.runtime.eval import evaluate
            from falkordb_tpu_torch.runtime.batch import Batch

            opts = rt.ctx.materialize(
                evaluate(clause.options, Batch.unit(), rt.ctx))[0]
            if isinstance(opts, dict):
                d.options = opts
        core.indexes[d.key] = d
        rt.stats["indices_created"] += 1
        if getattr(core.config, "delay_indexing", False):
            d.status = UNDER_CONSTRUCTION
            # build from the creating tx's snapshot; commits that land
            # mid-population journal into pending_dirty and are replayed
            t = threading.Thread(target=_populate_background,
                                 args=(core, d, rt.store), daemon=True)
            t.start()
        else:
            build_index(rt.store, d)
    elif kind == "drop_index":
        props = tuple(clause.props)
        for k in list(core.indexes):
            if k[1:] == (clause.entity, clause.label, props):
                del core.indexes[k]
                rt.stats["indices_deleted"] += 1
                return
        raise ValueError("no such index")


def build_index(store, d: IndexDef):
    if d.kind == "range":
        from falkordb_tpu_torch.index.range_index import RangeIndex

        d.impl = RangeIndex.build(store, d)
    elif d.kind == "vector":
        raise NotImplementedError(
            "vector indexes are not ported to falkordb_tpu_torch yet "
            "(ROADMAP.md module 4)")
    elif d.kind == "fulltext":
        from falkordb_tpu_torch.index.fulltext import FulltextIndex

        d.impl = FulltextIndex.build(store, d)
    d.status = OPERATIONAL


def _populate_background(core, d: IndexDef, store):
    """Batched background population: build from a snapshot in id chunks,
    then replay commits that happened meanwhile, then flip Operational."""
    try:
        from falkordb_tpu_torch.index.range_index import RangeIndex

        if d.kind != "range":
            build_index(store, d)
        else:
            ix = RangeIndex(d.props, d.entity, d.label)
            ids = RangeIndex._live_ids(store, d)
            for lo in range(0, len(ids), BATCH_SIZE):
                ix.populate(store, d, ids[lo: lo + BATCH_SIZE])
            d.impl = ix
        # replay writes that committed during population
        with d._lock:
            dirty = d.pending_dirty
            d.pending_dirty = set()
        if -1 in dirty or (dirty and not hasattr(d.impl, "update")):
            build_index(core.store, d)  # unknown provenance → full rebuild
        elif dirty:
            d.impl.update(core.store, d, dirty)
        d.status = OPERATIONAL
    except Exception:  # noqa: BLE001 — surfaced via status
        d.status = FAILED


# fraction of the graph changed above which rebuilding wins over per-id
# retract+insert
_REBUILD_FRACTION = 0.5


def refresh_indexes(core, store=None):
    """Post-commit maintenance.  `store` is the just-committed snapshot."""
    store = store if store is not None else core.store
    if not core.indexes:
        _clear_journal(store)
        return
    tracked = getattr(store, "dirty_tracked", False)
    dirty = {"node": store.dirty_entities("node") if tracked else None,
             "edge": store.dirty_entities("edge") if tracked else None}
    for d in core.indexes.values():
        ids = dirty[d.entity]
        if ids:
            ids = _relevant_ids(store, d, ids)
        if d.status == UNDER_CONSTRUCTION:
            # journal for the background populator's replay
            with d._lock:
                d.pending_dirty.update(ids if ids is not None else ())
                if ids is None:
                    d.pending_dirty.add(-1)  # force post-populate rebuild
            continue
        if ids is not None and not ids:
            continue  # nothing relevant changed
        total = (store.node_count if d.entity == "node"
                 else store.edge_count) or 1
        if (ids is not None and hasattr(d.impl, "update")
                and len(ids) < max(1024, _REBUILD_FRACTION * total)):
            d.impl.update(store, d, ids)
        else:
            build_index(store, d)
    _clear_journal(store)


def _relevant_ids(store, d: IndexDef, ids):
    """Drop entities whose only changes are to attributes this index
    doesn't cover (SET p.x on a non-indexed x used to retract+reinsert
    every indexed prop of the node).  Structural changes (labels,
    liveness) and unknown-provenance attr changes always stay."""
    structural = (store.dirty_nodes if d.entity == "node"
                  else store.dirty_edges)
    attrs = store.node_attrs if d.entity == "node" else store.edge_attrs
    aids = {store.schema.attr_id(p) for p in d.props} - {None}
    by_ent = attrs.dirty_aids
    keep = {e for e in ids
            if e in structural
            or (by_ent.get(e) is None and e in attrs.dirty)
            or (by_ent.get(e) is not None and by_ent[e] & aids)}
    return keep


def _clear_journal(store):
    if getattr(store, "dirty_tracked", False):
        store.dirty_nodes.clear()
        store.dirty_edges.clear()
        store.node_attrs.dirty.clear()
        store.edge_attrs.dirty.clear()
        store.node_attrs.dirty_aids.clear()
        store.edge_attrs.dirty_aids.clear()
