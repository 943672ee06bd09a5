"""GraphStore — the property-graph container.

Re-designs the reference's Graph struct (graph/src/graph/graph.rs:258-320)
for the sparse layer:

  * per-relationship-type adjacency is a DeltaMatrix whose CSR values are
    edge ids; duplicate (src,dst) rows give exact multi-edge semantics with
    no Tensor/multi-edge-matrix machinery (tensor.rs:33-150);
  * the reverse direction is a cached transpose CSR per type (the `mt` role);
  * labels are bitmap vectors (the diagonal label matrices of graph.rs:15-47
    collapse to masks, which is what they are used as);
  * the dense edge table (src/dst/type columns) is the reference's
    edge_endpoints reverse index (graph.rs:291-299), generalised;
  * deletions are tombstone bitmaps consumed as device edge masks — the
    delta-minus layer at edge granularity;
  * MVCC: `fork()` gives a snapshot sharing all arrays; mutations copy-on-
    write at array granularity (mvcc_graph.rs:68 collapses to this).

Capacity grows in NODE_CREATION_BUFFER chunks (src/module_init.rs:350-356).

Every store lives on one torch device (`device`), which forks inherit:
the device views below are cached tensors there, built from the host
arrays that stay the source of truth.
"""

from __future__ import annotations

import numpy as np
import torch

from falkordb_tpu_torch.graph.attrstore import AttributeStore, ABSENT
from falkordb_tpu_torch.graph.schema import Schema
from falkordb_tpu_torch.sparse.csr import CSR
from falkordb_tpu_torch.sparse.delta import DeltaMatrix

NODE_CREATION_BUFFER = 16_384


def _grow_to(arr: np.ndarray, cap: int, fill=0) -> np.ndarray:
    if len(arr) >= cap:
        return arr
    out = np.full(cap, fill, dtype=arr.dtype)
    out[: len(arr)] = arr
    return out


class GraphStore:
    def __init__(self, device):
        self.device = torch.device(device)
        self.schema = Schema()
        self.version = 0

        # node pool
        self.node_cap = 0
        self.node_exists = np.zeros(0, dtype=bool)
        self.node_free: list[int] = []
        self.node_max = 0  # 1 + highest id ever used
        self.label_masks: dict[int, np.ndarray] = {}  # label_id -> bool[cap]
        self.node_attrs = AttributeStore(0)

        # edge pool (columnar edge table)
        self.edge_cap = 0
        self.e_src = np.zeros(0, dtype=np.int64)
        self.e_dst = np.zeros(0, dtype=np.int64)
        self.e_type = np.full(0, -1, dtype=np.int32)
        self.e_deleted = np.zeros(0, dtype=bool)
        self.edge_free: list[int] = []
        self.edge_max = 0
        self.edge_attrs = AttributeStore(0)

        # adjacency per relationship type
        self.adj: dict[int, DeltaMatrix] = {}

        # device caches (invalidated on mutation)
        self._dev: dict = {}
        self._adj_in_cache: dict[int, tuple[int, CSR]] = {}
        # single-slot compact-adjacency cache (algos/common.py): repeated
        # point lookups (shortestPath per query) skip the O(E) rebuild
        self._compact_cache: dict = {}
        self._owned: set[str] = set()  # COW ownership of array fields
        self._counts = {"nodes": 0, "edges": 0}
        self.label_counts: dict[int, int] = {}
        self.type_counts: dict[int, int] = {}
        # write journal for incremental index maintenance: entity ids whose
        # labels/liveness changed since fork() (attr changes journal in the
        # AttributeStores).  dirty_tracked False = provenance unknown (fresh
        # load/restore) → indexes must full-rebuild once.
        self.dirty_nodes: set[int] = set()
        self.dirty_edges: set[int] = set()
        self.dirty_tracked = False

    # ------------------------------------------------------------------ MVCC

    _ARRAYS = ("node_exists", "e_src", "e_dst", "e_type", "e_deleted")

    def fork(self) -> "GraphStore":
        """Snapshot for a new write version.  Shares arrays; first mutation
        of each array/column copies it."""
        g = GraphStore.__new__(GraphStore)
        g.device = self.device
        g.schema = self.schema.copy()
        g.version = self.version + 1
        g.node_cap = self.node_cap
        g.node_exists = self.node_exists
        g.node_free = list(self.node_free)
        g.node_max = self.node_max
        g.label_masks = dict(self.label_masks)
        g.node_attrs = self.node_attrs.fork()
        g.edge_cap = self.edge_cap
        g.e_src = self.e_src
        g.e_dst = self.e_dst
        g.e_type = self.e_type
        g.e_deleted = self.e_deleted
        g.edge_free = list(self.edge_free)
        g.edge_max = self.edge_max
        g.edge_attrs = self.edge_attrs.fork()
        g.adj = {t: d.snapshot() for t, d in self.adj.items()}
        g._dev = {}
        g._adj_in_cache = dict(self._adj_in_cache)
        g._compact_cache = {}
        g._owned = set()
        g._counts = dict(self._counts)
        g.label_counts = dict(self.label_counts)
        g.type_counts = dict(self.type_counts)
        g.dirty_nodes = set()
        g.dirty_edges = set()
        g.dirty_tracked = True
        return g

    def dirty_entities(self, entity: str) -> set[int]:
        """Union of journaled structural + attribute changes since fork()."""
        if entity == "node":
            return self.dirty_nodes | self.node_attrs.dirty
        return self.dirty_edges | self.edge_attrs.dirty

    def _own(self, name: str) -> None:
        if name not in self._owned:
            setattr(self, name, getattr(self, name).copy())
            self._owned.add(name)

    def _own_label(self, lid: int) -> np.ndarray:
        key = f"label:{lid}"
        if key not in self._owned:
            m = self.label_masks.get(lid)
            self.label_masks[lid] = (
                m.copy() if m is not None else np.zeros(self.node_cap, dtype=bool)
            )
            self._owned.add(key)
        return self.label_masks[lid]

    def _invalidate(self, *keys: str) -> None:
        self._compact_cache.clear()
        for k in keys:
            self._dev.pop(k, None)
            # derived caches register under "<array>:<suffix>" (e.g. the
            # sharded query-path edge table, parallel/qdist.py)
            pref = k + ":"
            for dk in [d for d in self._dev if d.startswith(pref)]:
                self._dev.pop(dk, None)

    # ------------------------------------------------------------- capacity

    def _ensure_node_cap(self, need: int) -> None:
        if need <= self.node_cap:
            return
        cap = self.node_cap
        while cap < need:
            cap += NODE_CREATION_BUFFER
        self.node_cap = cap
        self._own("node_exists")
        self.node_exists = _grow_to(self.node_exists, cap, False)
        for lid in list(self.label_masks):
            m = self._own_label(lid)
            self.label_masks[lid] = _grow_to(m, cap, False)
        self.node_attrs.grow(cap)
        for d in self.adj.values():
            d.resize((cap, cap))
        self._adj_in_cache.clear()
        self._dev.clear()
        self._compact_cache.clear()

    def _ensure_edge_cap(self, need: int) -> None:
        if need <= self.edge_cap:
            return
        cap = self.edge_cap
        while cap < need:
            cap += NODE_CREATION_BUFFER
        self.edge_cap = cap
        for name, fill in (("e_src", 0), ("e_dst", 0), ("e_type", -1),
                           ("e_deleted", False)):
            self._own(name)
            setattr(self, name, _grow_to(getattr(self, name), cap, fill))
        self.edge_attrs.grow(cap)
        self._invalidate("e_deleted", "e_src", "e_dst", "e_type")

    # ------------------------------------------------------------- mutation

    def new_node_id(self) -> int:
        if self.node_free:
            return self.node_free.pop()
        nid = self.node_max
        self.node_max += 1
        self._ensure_node_cap(self.node_max)
        return nid

    def create_node(self, label_ids, attrs: dict[int, object]) -> int:
        nid = self.new_node_id()
        self._own("node_exists")
        self.node_exists[nid] = True
        self._counts["nodes"] += 1
        for lid in label_ids:
            self.add_label(nid, lid)
        for aid, v in attrs.items():
            self.node_attrs.set(nid, aid, v)
        self._invalidate("node_exists")
        self.dirty_nodes.add(nid)
        return nid

    def add_label(self, nid: int, lid: int) -> bool:
        m = self._own_label(lid)
        if len(m) < self.node_cap:
            m = _grow_to(m, self.node_cap, False)
            self.label_masks[lid] = m
        if m[nid]:
            return False
        m[nid] = True
        self.label_counts[lid] = self.label_counts.get(lid, 0) + 1
        self._invalidate(f"label:{lid}")
        self.dirty_nodes.add(int(nid))
        return True

    def remove_label(self, nid: int, lid: int) -> bool:
        m = self.label_masks.get(lid)
        if m is None or nid >= len(m) or not m[nid]:
            return False
        m = self._own_label(lid)
        m[nid] = False
        self.label_counts[lid] = self.label_counts.get(lid, 1) - 1
        self._invalidate(f"label:{lid}")
        self.dirty_nodes.add(int(nid))
        return True

    def create_edge(self, src: int, dst: int, type_id: int,
                    attrs: dict[int, object]) -> int:
        if self.edge_free:
            eid = self.edge_free.pop()
        else:
            eid = self.edge_max
            self.edge_max += 1
            self._ensure_edge_cap(self.edge_max)
        for name in ("e_src", "e_dst", "e_type", "e_deleted"):
            self._own(name)
        self.e_src[eid] = src
        self.e_dst[eid] = dst
        self.e_type[eid] = type_id
        self.e_deleted[eid] = False
        d = self.adj.get(type_id)
        if d is None:
            d = DeltaMatrix((self.node_cap, self.node_cap))
            self.adj[type_id] = d
        d.add_edges([src], [dst], [eid])
        for aid, v in attrs.items():
            self.edge_attrs.set(eid, aid, v)
        self._counts["edges"] += 1
        self.type_counts[type_id] = self.type_counts.get(type_id, 0) + 1
        self._adj_in_cache.pop(type_id, None)
        self._invalidate("e_deleted", "e_src", "e_dst", "e_type")
        self.dirty_edges.add(eid)
        return eid

    def delete_edge(self, eid: int) -> bool:
        if eid >= self.edge_cap or self.e_deleted[eid] or self.e_type[eid] < 0:
            return False
        self._own("e_deleted")
        self.e_deleted[eid] = True
        t = int(self.e_type[eid])
        self.adj[t].note_deletions(1)
        self.edge_attrs.clear_entity(eid)
        self.edge_free.append(eid)
        self._counts["edges"] -= 1
        self.type_counts[t] = self.type_counts.get(t, 1) - 1
        self._invalidate("e_deleted")
        self.dirty_edges.add(int(eid))
        return True

    def node_edges(self, nid: int) -> np.ndarray:
        """All live edge ids touching nid (for DETACH DELETE)."""
        live = ~self.e_deleted[: self.edge_max] & (self.e_type[: self.edge_max] >= 0)
        touch = (self.e_src[: self.edge_max] == nid) | (self.e_dst[: self.edge_max] == nid)
        return np.nonzero(live & touch)[0]

    def nodes_edges(self, nids) -> np.ndarray:
        """Live edge ids touching ANY node in nids — one edge-array pass
        (a per-node scan made DETACH DELETE of k nodes O(k*m); LDBC's
        500-person delete cycle was 97% this)."""
        nids = np.asarray(list(nids), dtype=np.int64)
        live = ~self.e_deleted[: self.edge_max] & (
            self.e_type[: self.edge_max] >= 0)
        touch = np.isin(self.e_src[: self.edge_max], nids) \
            | np.isin(self.e_dst[: self.edge_max], nids)
        return np.nonzero(live & touch)[0]

    def delete_node(self, nid: int) -> bool:
        if nid >= self.node_cap or not self.node_exists[nid]:
            return False
        self._own("node_exists")
        self.node_exists[nid] = False
        for lid, m in list(self.label_masks.items()):
            if nid < len(m) and m[nid]:
                self.remove_label(nid, lid)
        self.node_attrs.clear_entity(nid)
        self.node_free.append(nid)
        self._counts["nodes"] -= 1
        self._invalidate("node_exists")
        self.dirty_nodes.add(int(nid))
        return True

    def flush(self, force: bool = False) -> None:
        """Merge pending adjacency deltas / drop tombstones (GrB_wait role,
        matrix.rs:621).  Called between query batches, before algorithms,
        and before serialization."""
        deleted = np.nonzero(self.e_deleted[: self.edge_max])[0].astype(np.int32)
        for t, d in self.adj.items():
            if d.flush(deleted_eids=deleted if len(deleted) else None, force=force):
                self._adj_in_cache.pop(t, None)

    # --------------------------------------------------------------- reads

    @property
    def node_count(self) -> int:
        return self._counts["nodes"]

    @property
    def edge_count(self) -> int:
        return self._counts["edges"]

    def node_labels_of(self, nid: int) -> list[int]:
        return [lid for lid, m in self.label_masks.items()
                if nid < len(m) and m[nid]]

    def edge_endpoints(self, eid: int) -> tuple[int, int, int]:
        return int(self.e_src[eid]), int(self.e_dst[eid]), int(self.e_type[eid])

    def adj_out(self, type_id: int) -> DeltaMatrix | None:
        return self.adj.get(type_id)

    def adj_in_csr(self, type_id: int) -> CSR | None:
        """Reverse-direction CSR (base+pending merged, transposed), cached
        per type keyed on the delta's content."""
        d = self.adj.get(type_id)
        if d is None:
            return None
        key = (id(d.base), d.nnz_upper_bound)
        hit = self._adj_in_cache.get(type_id)
        if hit is not None and hit[0] == key:
            return hit[1]
        r, c, v = d.base.to_numpy_coo()
        if d.dp is not None:
            r2, c2, v2 = d.dp.to_numpy_coo()
            r = np.concatenate([r, r2]); c = np.concatenate([c, c2])
            v = np.concatenate([v, v2])
        T = CSR.from_coo_numpy(c, r, v, shape=(d.shape[1], d.shape[0]), dedup=False)
        self._adj_in_cache[type_id] = (key, T)
        return T

    # --------------------------------------------------------- device views

    def host_edge_alive(self) -> np.ndarray:
        """Per-edge liveness mask on the host (the delta-minus mask the
        operators read); cached beside its device copy and invalidated with
        it (the "e_deleted:" prefix)."""
        v = self._dev.get("e_deleted:host")
        if v is None:
            v = np.ones(max(self.edge_cap, 1), dtype=bool)
            v[: self.edge_max] = ~self.e_deleted[: self.edge_max]
            self._dev["e_deleted:host"] = v
        return v

    def dev_edge_alive(self) -> torch.Tensor:
        """Per-edge liveness mask as a tensor on the store's device."""
        v = self._dev.get("e_deleted")
        if v is None:
            v = torch.from_numpy(self.host_edge_alive().copy()).to(
                self.device)
            self._dev["e_deleted"] = v
        return v

    def dev_label_mask(self, lid: int) -> torch.Tensor:
        key = f"label:{lid}"
        v = self._dev.get(key)
        if v is None:
            m = self.label_masks.get(lid)
            if m is None:
                m = np.zeros(self.node_cap, dtype=bool)
            m = _grow_to(m, self.node_cap, False)
            v = torch.from_numpy(m.copy()).to(self.device)
            self._dev[key] = v
        return v

    def dev_node_exists(self) -> torch.Tensor:
        v = self._dev.get("node_exists")
        if v is None:
            v = torch.from_numpy(self.node_exists.copy()).to(self.device)
            self._dev["node_exists"] = v
        return v

    def memory_usage(self) -> dict:
        adj_bytes = 0
        for d in self.adj.values():
            adj_bytes += d.base.rows.nbytes + d.base.cols.nbytes
            adj_bytes += d.base.indptr.nbytes
            if d.base.vals is not None:
                adj_bytes += d.base.vals.nbytes
        return {
            "nodes": self.node_count,
            "edges": self.edge_count,
            "node_attr_bytes": self.node_attrs.memory_bytes(),
            "edge_attr_bytes": self.edge_attrs.memory_bytes(),
            "adjacency_bytes": int(adj_bytes),
            "edge_table_bytes": int(self.e_src.nbytes * 3 + self.e_deleted.nbytes),
        }
