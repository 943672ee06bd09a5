"""Batch operators (the reference's 42 BatchOps, graph/src/runtime/ops/).

Each operator is a pull-based generator over columnar Batches.  Traversal
expansion lowers to the `expand` kernel (sparse/ops.py, K1) on the store's
device — the replacement for cond_traverse.rs's frontier delta_lmxm path —
with label post-filters as host mask gathers.  Large grouped aggregates
reduce with the group-partials kernel (K2) and ORDER BY <key> LIMIT k with
the top-k kernel (K3), both defined below beside their plain PyTorch
versions.  Scalar paths (string predicates, per-row merge logic) stay
host-side."""

from __future__ import annotations

import math
import time
from typing import Iterator, Optional

import numpy as np
import torch

from falkordb_tpu_torch.graph.attrstore import ABSENT
from falkordb_tpu_torch.lang import ast as A
from falkordb_tpu_torch.runtime.batch import BATCH_SIZE, Batch, Column, NULL_ID
from falkordb_tpu_torch.runtime.eval import (
    EvalContext, EvalError, evaluate, evaluate_predicate,
)
from falkordb_tpu_torch.runtime.value import (
    EdgeVal, NodeVal, PathVal, equals, order_key, truthy,
)
from falkordb_tpu_torch.native import cuda as _cuda
from falkordb_tpu_torch.sparse.csr import host_tensor
from falkordb_tpu_torch.sparse.ops import expand as csr_expand


def _device_agg_min() -> int:
    """Row threshold above which group partials run as device segment ops
    (FALKOR_DEVICE_AGG_MIN; small batches lose to dispatch overhead)."""
    import os

    return int(os.environ.get("FALKOR_DEVICE_AGG_MIN", 65536))


def _device_expand_min() -> int:
    """Total-out-edge threshold above which traversal expansion runs the
    device CSR kernel (FALKOR_DEVICE_EXPAND_MIN); smaller frontiers use
    the host ragged gather — per-batch dispatch dominates below this."""
    import os

    return int(os.environ.get("FALKOR_DEVICE_EXPAND_MIN", 262144))


def _device_agg_block() -> int:
    """Super-batch size the vectorized Aggregate concatenates streamed
    batches into (FALKOR_DEVICE_AGG_BLOCK)."""
    import os

    return int(os.environ.get("FALKOR_DEVICE_AGG_BLOCK", 131072))


# mesh-routed traverses buffer their child stream (one shard-scan kernel
# per hop) only up to this many rows; beyond it they fall back to the
# memory-bounded per-batch dispatch
_DIST_BUFFER_ROWS = 1 << 20

# local traverses coalesce their input stream into blocks of this many
# rows: per-block numpy setup (clip/repeat/cumsum/take) was the dominant
# cost of full-scan expansions streamed as 1K batches (SF1 agg: 1680
# blocks x 12 array ops)
_EXPAND_BLOCK_ROWS = 1 << 16


def _coalesce_batches(source, rt=None, rows=_EXPAND_BLOCK_ROWS):
    buf, n = [], 0
    for b in source:
        if not b.n:
            continue
        if rt is not None:  # the buffer is real memory: budget it
            rt.charge_batch(b)
        buf.append(b)
        n += b.n
        if n >= rows:
            yield buf[0] if len(buf) == 1 else Batch.concat(buf)
            buf, n = [], 0
    if buf:
        yield buf[0] if len(buf) == 1 else Batch.concat(buf)


def _device_expand(g, csr, srcs, valid, out_cap):
    """csr_expand on the store's device (the CSR's cached copy there);
    returns host arrays (row, dst, eid, ok)."""
    dev = csr.to(g.device)
    row, dst, eid, ok, _ = csr_expand(
        dev.indptr, dev.cols, dev.vals,
        host_tensor(srcs.astype(np.int32), g.device),
        host_tensor(valid, g.device),
        out_cap=out_cap)
    return (row.cpu().numpy(), dst.cpu().numpy(), eid.cpu().numpy(),
            ok.cpu().numpy())


class QueryTimeout(RuntimeError):
    pass


class QueryMemExceeded(RuntimeError):
    pass


class Runtime:
    """Per-query execution context (the reference's Runtime,
    graph/src/runtime/runtime.rs:122)."""

    def __init__(self, store, params=None, deadline=None, write=False):
        self.store = store
        self.params = params or {}
        self.ctx = EvalContext(store, self.params)
        self.ctx.pattern_exists = self._pattern_exists
        self.ctx.pattern_collect = self._pattern_collect
        self.ctx.shortest_path_value = self.shortest_path_value
        self.stats = {
            "nodes_created": 0, "nodes_deleted": 0,
            "relationships_created": 0, "relationships_deleted": 0,
            "properties_set": 0, "properties_removed": 0,
            "labels_added": 0, "labels_removed": 0,
            "indices_created": 0, "indices_deleted": 0,
        }
        self.deadline = deadline
        self.write = write
        self._exists_plans: dict[int, object] = {}
        self.profile_data: dict[int, dict] = {}
        # binary-replication effect capture (pending.rs effects buffer)
        self.effects: list = []
        self.record_effects = False
        # whole-query graph-diff side-effect accounting (TCK semantics:
        # counters reflect the state DIFF of the query, so CREATE+DELETE
        # of the same entity nets to zero and double-SETs of one property
        # count once — the reference diffs in pending.rs the same way)
        self._created_nodes: set = set()
        self._deleted_nodes: set = set()
        self._created_edges: set = set()
        self._deleted_edges: set = set()
        self._prop_old: dict = {}  # (kind, ent, aid) -> first old value

    # order-aware netting: CREATE followed by DELETE of the same entity
    # nets to zero (TCK Delete4 [3]), but DELETE followed by CREATE that
    # recycles the freed id counts BOTH ways (TCK Merge5 [20]) — a plain
    # set difference would net recycled ids incorrectly.

    def note_node_created(self, nid):
        if nid in self._deleted_nodes:
            self._deleted_nodes.discard(nid)
            self.stats["nodes_deleted"] += 1  # prior entity's delete final
            self._prop_old = {k: v for k, v in self._prop_old.items()
                              if k[:2] != ("node", nid)}
        self._created_nodes.add(nid)

    def note_node_deleted(self, nid):
        if nid in self._created_nodes:
            self._created_nodes.discard(nid)
        else:
            self._deleted_nodes.add(nid)

    def note_edge_created(self, eid):
        if eid in self._deleted_edges:
            self._deleted_edges.discard(eid)
            self.stats["relationships_deleted"] += 1
            self._prop_old = {k: v for k, v in self._prop_old.items()
                              if k[:2] != ("edge", eid)}
        self._created_edges.add(eid)

    def note_edge_deleted(self, eid):
        if eid in self._created_edges:
            self._created_edges.discard(eid)
        else:
            self._deleted_edges.add(eid)

    def note_prop_write(self, kind, ent, aid, old):
        self._prop_old.setdefault((kind, ent, aid), old)

    def finalize_stats(self):
        """Fold the tracked write diff into the public counters (called
        once after the plan ran, before the stats are surfaced)."""
        st = self.stats
        st["nodes_created"] += len(self._created_nodes)
        st["nodes_deleted"] += len(self._deleted_nodes)
        st["relationships_created"] += len(self._created_edges)
        st["relationships_deleted"] += len(self._deleted_edges)
        g = self.store
        for (kind, ent, aid), old in self._prop_old.items():
            if kind == "node":
                if ent in self._deleted_nodes or not (
                        ent < g.node_cap and g.node_exists[ent]):
                    continue  # props vanish with the entity, not counted
                new = g.node_attrs.get(ent, aid)
            else:
                if ent in self._deleted_edges or (
                        ent < len(g.e_deleted) and g.e_deleted[ent]):
                    continue
                new = g.edge_attrs.get(ent, aid)
            if old is ABSENT:
                if new is not ABSENT:
                    st["properties_set"] += 1
            elif new is ABSENT:
                st["properties_removed"] += 1
            elif not _prop_eq(old, new):
                st["properties_set"] += 1
                st["properties_removed"] += 1

    def check_timeout(self):
        if self.deadline is not None and time.monotonic() > self.deadline:
            raise QueryTimeout("query timed out")

    # -- per-query memory budget (QUERY_MEM_CAPACITY; the reference tracks
    # allocations with a TLS counting allocator, src/allocator.rs, and
    # aborts at runtime.rs:462 — here materializing operators charge their
    # buffered bytes against the budget)
    mem_capacity = 0  # bytes; 0 = unlimited
    mem_used = 0

    def charge_mem(self, nbytes: int):
        if not self.mem_capacity:
            return
        self.mem_used += int(nbytes)
        if self.mem_used > self.mem_capacity:
            raise QueryMemExceeded(
                "Query's mem consumption exceeded capacity")

    def charge_batch(self, batch):
        if not self.mem_capacity:
            return
        self.charge_mem(sum(c.nbytes() for c in batch.cols.values()))

    def _pattern_exists(self, e, batch):
        """EXISTS((n)-[:R]->(m)) predicate — per-row semi-apply."""
        plan = self._exists_plans.get(id(e))
        if plan is None:
            from falkordb_tpu_torch.lang.planner import plan_pattern_predicate

            plan = plan_pattern_predicate(e, self)
            self._exists_plans[id(e)] = plan
        return plan(batch, self)

    def _pattern_collect(self, e, batch):
        """Pattern comprehension — per-row collected projections."""
        plan = self._exists_plans.get(id(e))
        if plan is None:
            from falkordb_tpu_torch.lang.planner import plan_pattern_comprehension

            plan = plan_pattern_comprehension(e, self)
            self._exists_plans[id(e)] = plan
        return plan(batch, self)

    def shortest_path_value(self, src_id, dst_id, types, direction,
                            min_hops, max_hops, all_paths):
        """shortestPath()/allShortestPaths() in EXPRESSION position
        (the reference's eval_shortest_path,
        graph/src/runtime/eval.rs:1292: bound endpoints -> Path | Null).
        Shares the ShortestPath operator's BFS + backtrack machinery,
        with the compact adjacency cached per (types, direction)."""
        reverse = direction == "in"
        if reverse:  # normalize: BFS dst->src over out-edges, reverse paths
            src_id, dst_id, direction = dst_id, src_id, "out"
        if (min_hops or 0) == 0 and src_id == dst_id:
            return [PathVal([self.ctx.node_value(src_id)], [])] \
                if all_paths else PathVal([self.ctx.node_value(src_id)], [])
        empty = [] if all_paths else None
        from falkordb_tpu_torch.algos.common import compact_adjacency

        comp = compact_adjacency(  # snapshot-cached (algos/common.py)
            self.store, None, list(types) or None,
            directed=(direction != "both"), keep_eids=True)
        if comp is None or src_id not in comp.remap \
                or dst_id not in comp.remap:
            return empty
        from falkordb_tpu_torch.algos.bfs import bfs_levels

        pair_edges, levels_cache = _sp_caches(comp, direction)
        cs, ct = comp.remap[src_id], comp.remap[dst_id]
        lkey = (cs, max_hops)
        if lkey not in levels_cache:
            levels_cache[lkey] = bfs_levels(comp.at, cs,
                                            max_hops).cpu().numpy()
        levels = levels_cache[lkey]
        lv = int(levels[ct])
        if lv <= 0 or lv >= 2**30 or lv < (min_hops or 0) \
                or (max_hops is not None and lv > max_hops):
            return empty
        shim = ShortestPath(None, 0, 0, 0, types, direction, max_hops,
                            all_paths, reverse=reverse)
        ip_t, cols_t, _ = comp.at.host_view()
        paths = shim._backtrack(ct, cs, levels, ip_t, cols_t,
                                pair_edges, comp, self)
        return paths if all_paths else (paths[0] if paths else None)


class Op:
    name = "Op"

    def __init__(self, child: Optional["Op"] = None):
        self.child = child
        self.rows_out = 0
        self.time_s = 0.0
        self.vec_rows = 0  # rows handled by the typed/vectorized fast path
        self.dev_rows = 0  # rows reduced/sorted by the K2/K3 kernel path

    def run(self, rt: Runtime) -> Iterator[Batch]:
        raise NotImplementedError

    def profiled(self, rt: Runtime) -> Iterator[Batch]:
        for b in self.run(rt):
            self.rows_out += b.n
            yield b

    def describe(self) -> str:
        return self.name

    def tree_lines(self, depth=0) -> list[str]:
        lines = [("    " * depth) + self.describe()]
        for c in self.children():
            lines.extend(c.tree_lines(depth + 1))
        return lines

    def children(self):
        return [self.child] if self.child is not None else []


class UnitRow(Op):
    name = "UnitRow"

    def run(self, rt):
        yield Batch.unit()


class Eager(Op):
    """Clause barrier: materialize every upstream batch before yielding.
    openCypher clause semantics make each clause operate on the COMPLETE
    output of the previous one — a MATCH planned after a write clause must
    observe all of that clause's effects (TCK Create3 [3]:
    MATCH-CREATE-WITH-MATCH-CREATE creates 2+8 nodes)."""

    name = "Eager"

    def describe(self):
        return "Eager"

    def run(self, rt):
        batches = []
        for b in self.child.run(rt):
            rt.charge_batch(b)
            batches.append(b)
        yield from batches


class AllNodeScan(Op):
    name = "AllNodeScan"

    def __init__(self, slot: int, alias: str, child=None):
        super().__init__(child or UnitRow())
        self.slot = slot
        self.alias = alias

    def describe(self):
        return f"All Node Scan | ({self.alias})"

    def run(self, rt):
        g = rt.store
        ids = None
        for lhs in self.child.run(rt):
            rt.check_timeout()
            if ids is None:
                # snapshot AFTER the first upstream batch arrived: an
                # Eager barrier upstream guarantees prior write clauses
                # fully applied by now (TCK Create3 [3])
                ids = np.nonzero(
                    g.node_exists[: g.node_max])[0].astype(np.int64)
            for lo in range(0, len(ids), BATCH_SIZE):
                chunk = ids[lo : lo + BATCH_SIZE]
                for li in range(lhs.n):
                    out = lhs.take(np.full(len(chunk), li, dtype=np.int64))
                    yield out.with_col(self.slot, Column.nodes(chunk))


class LabelScan(Op):
    name = "NodeByLabelScan"

    def __init__(self, slot: int, alias: str, label: str, child=None):
        super().__init__(child or UnitRow())
        self.slot = slot
        self.alias = alias
        self.label = label

    def describe(self):
        return f"Node By Label Scan | ({self.alias}:{self.label})"

    def run(self, rt):
        g = rt.store
        ids = None
        for lhs in self.child.run(rt):
            rt.check_timeout()
            if ids is None:
                lid = g.schema.label_id(self.label)
                mask = g.label_masks.get(lid) if lid is not None else None
                if mask is None:
                    return
                ids = np.nonzero(mask[: g.node_max])[0].astype(np.int64)
            for lo in range(0, len(ids), BATCH_SIZE):
                chunk = ids[lo : lo + BATCH_SIZE]
                for li in range(lhs.n):
                    out = lhs.take(np.zeros(len(chunk), dtype=np.int64) + li)
                    yield out.with_col(self.slot, Column.nodes(chunk))


class NodeByIdSeek(Op):
    name = "NodeByIdSeek"

    def __init__(self, slot: int, alias: str, id_expr, child=None):
        super().__init__(child or UnitRow())
        self.slot = slot
        self.alias = alias
        self.id_expr = id_expr

    def describe(self):
        return f"Node By Id Seek | ({self.alias})"

    def run(self, rt):
        g = rt.store
        for lhs in self.child.run(rt):
            ids = rt.ctx.materialize(evaluate(self.id_expr, lhs, rt.ctx))
            rows, nids = [], []
            for i, v in enumerate(ids):
                vs = v if isinstance(v, (list, tuple)) else [v]
                for x in vs:
                    if isinstance(x, (int, np.integer)) and 0 <= x < g.node_max \
                            and g.node_exists[int(x)]:
                        rows.append(i)
                        nids.append(int(x))
            if rows:
                out = lhs.take(np.asarray(rows))
                yield out.with_col(self.slot, Column.nodes(nids))


class IndexScan(Op):
    """Range-index scan replacing Label Scan + Filter — incl. composite
    multi-property seeks and distance() geo ranges (the reference's
    utilize_index pass target, planner/optimizer/utilize_index.rs)."""

    name = "NodeByIndexScan"

    def __init__(self, slot, alias, label, bounds_map, entity="node",
                 child=None, residuals=None):
        """bounds_map: prop -> ('range', lo, lo_inc, hi, hi_inc)
                             | ('geo', center_expr, radius_expr)
                             | ('in_expr', list_expr)
        with bound exprs evaluated per driving row.  `residuals` holds the
        consumed WHERE conjuncts: when a runtime bound value has a type the
        sorted fields cannot serve exactly (bool, nested list, null bound),
        the scan falls back to label scan + residual predicate for that
        driving row — index use never changes results."""
        super().__init__(child or UnitRow())
        self.slot = slot
        self.alias = alias
        self.label = label
        self.bounds_map = bounds_map
        self.residuals = residuals or []

    def describe(self):
        props = ", ".join(self.bounds_map)
        return (f"Node By Index Scan | ({self.alias}:{self.label}) "
                f"[{props}]")

    def run(self, rt):
        indexes = getattr(rt, "indexes", {})
        impl = None
        want = set(self.bounds_map)
        for d in indexes.values():
            if (d.kind == "range" and d.entity == "node"
                    and d.label == self.label and d.props
                    and getattr(d, "status", "operational") == "operational"
                    and want <= set(d.props)):
                impl = d.impl
                break
        if impl is None:
            raise EvalError(
                f"no operational range index covering {self.label}"
                f"({', '.join(want)})")
        for lhs in self.child.run(rt):
            rt.check_timeout()
            for i in range(lhs.n):
                row = lhs.take(np.asarray([i]))
                spec = self._row_spec(row, rt)
                if spec is None:
                    ids = self._fallback_ids(row, rt)
                elif spec == "empty":
                    continue
                else:
                    ids = impl.seek(spec)
                for lo_i in range(0, len(ids), BATCH_SIZE):
                    chunk = ids[lo_i : lo_i + BATCH_SIZE]
                    out = row.take(np.zeros(len(chunk), dtype=np.int64))
                    yield out.with_col(self.slot, Column.nodes(chunk))

    _OK_SCALAR = (int, float, str)

    def _row_spec(self, row, rt):
        """Evaluate bound exprs for one driving row.  Returns the seek
        spec, 'empty' (a null bound: predicate can never be true), or None
        (un-servable type → fallback)."""
        from falkordb_tpu_torch.runtime.value import PointVal

        spec = {}
        for prop, b in self.bounds_map.items():
            if b[0] == "geo":
                center = _bound_value(b[1], row, rt)
                radius = _bound_value(b[2], row, rt)
                if center is None or radius is None:
                    return "empty"
                if not isinstance(center, PointVal) or isinstance(
                        radius, (bool, str)):
                    return None
                spec[prop] = ("geo", center, float(radius))
            elif b[0] == "in_expr":
                vals = _bound_value(b[1], row, rt)
                if vals is None:
                    return "empty"
                if not isinstance(vals, (list, tuple)):
                    return None
                for v in vals:
                    if isinstance(v, bool) or (
                            v is not None and not isinstance(
                                v, self._OK_SCALAR + (PointVal,))):
                        return None  # bool/list/map member → fallback
                spec[prop] = ("in", vals)
            else:
                _, lo, lo_inc, hi, hi_inc = b
                lov = _bound_value(lo, row, rt)
                hiv = _bound_value(hi, row, rt)
                if (lo is not None and lov is None) or (
                        hi is not None and hiv is None):
                    return "empty"  # null bound: comparison is never true
                for v in (lov, hiv):
                    if v is not None and (isinstance(v, bool)
                                          or not isinstance(
                                              v, self._OK_SCALAR
                                              + (PointVal,))):
                        return None
                if (isinstance(lov, str)) != (isinstance(hiv, str)) and \
                        lov is not None and hiv is not None:
                    return "empty"  # cross-type range never matches
                spec[prop] = ("range", lov, lo_inc, hiv, hi_inc)
        return spec

    def _fallback_ids(self, row, rt):
        """Exact fallback: label scan + residual predicates for this row."""
        g = rt.store
        lid = g.schema.label_id(self.label)
        if lid is None:
            return np.zeros(0, np.int64)
        mask = g.label_masks.get(lid)
        if mask is None:
            return np.zeros(0, np.int64)
        ids = np.nonzero(mask[: g.node_max])[0].astype(np.int64)
        if not len(ids) or not self.residuals:
            return ids
        big = row.take(np.zeros(len(ids), dtype=np.int64))
        big = big.with_col(self.slot, Column.nodes(ids))
        keep = np.ones(len(ids), dtype=bool)
        for c in self.residuals:
            keep &= evaluate_predicate(c, big, rt.ctx)
        return ids[keep]


def _bound_value(b, row, rt):
    if b is None:
        return None
    from falkordb_tpu_torch.lang import ast as A

    if isinstance(b, A.Expr):
        return rt.ctx.materialize(evaluate(b, row, rt.ctx))[0]
    return b


class CountOnly(Op):
    """O(1) COUNT(*) from graph metadata (reduce_count pass,
    planner/optimizer/reduce_count.rs)."""

    name = "Count"

    def __init__(self, slot, label=None):
        super().__init__(None)
        self.slot = slot
        self.label = label

    def describe(self):
        return "Results | count from metadata"

    def run(self, rt):
        g = rt.store
        if self.label is None:
            n = g.node_count
        else:
            lid = g.schema.label_id(self.label)
            n = g.label_counts.get(lid, 0) if lid is not None else 0
        yield Batch(1, {self.slot: Column.values([n])})


def _gather_label_mask(rt, nids: np.ndarray, labels: list[str]) -> np.ndarray:
    """Device label-bitmap gather for dst post-filtering."""
    g = rt.store
    keep = np.ones(len(nids), dtype=bool)
    for lname in labels:
        lid = g.schema.label_id(lname)
        if lid is None:
            return np.zeros(len(nids), dtype=bool)
        m = g.label_masks.get(lid)
        if m is None:
            return np.zeros(len(nids), dtype=bool)
        keep &= m[np.clip(nids, 0, len(m) - 1)] & (nids >= 0)
    return keep


class Traverse(Op):
    """Single-hop conditional traverse (ops/cond_traverse.rs:439) via the
    batched CSR expand kernel over base ∪ dp with tombstone edge masks."""

    name = "ConditionalTraverse"

    def __init__(self, child, src_slot, dst_slot, edge_slot, types,
                 direction, dst_labels, src_alias="", dst_alias=""):
        super().__init__(child)
        self.src_slot = src_slot
        self.dst_slot = dst_slot
        self.edge_slot = edge_slot
        self.types = types
        self.direction = direction
        self.dst_labels = dst_labels
        self.src_alias = src_alias
        self.dst_alias = dst_alias
        # fuse_anonymous_traverse: extra hops executed as a chained
        # structural product F·A1·A2·… (fuse_anonymous_traverse.rs;
        # cond_traverse.rs:110-143).  Each hop: (types, direction,
        # dst_labels).  Chained hops bind nothing — distinct endpoint
        # pairs only (FalkorDB's algebraic collapse over anonymous
        # intermediates).
        self.chain: list = []
        # fuse_optional_traverse: input rows with no expansion re-emit
        # once with NULL dst/edge instead of routing through the general
        # OptionalMatch apply machinery (fuse_optional_traverse.rs).
        self.optional = False

    def describe(self):
        def arrow(types, direction):
            t = "|".join(types) if types else ""
            return {"out": f"-[:{t}]->", "in": f"<-[:{t}]-",
                    "both": f"-[:{t}]-"}[direction]

        s = ("Optional " if self.optional else "") + \
            f"Conditional Traverse | ({self.src_alias})" + \
            arrow(self.types, self.direction)
        for types, direction, _ in self.chain:
            s += "()" + arrow(types, direction)
        return s + f"({self.dst_alias})"

    def _type_ids(self, g, types=None):
        types = self.types if types is None else types
        if types:
            out = []
            for t in types:
                tid = g.schema.reltype_id(t)
                # dedupe: [:T|:T] matches each edge once (TCK Match3 [8])
                if tid is not None and tid not in out:
                    out.append(tid)
            return out
        return sorted(g.adj.keys())

    def _matrices(self, g, tid, direction=None):
        """(CSR, reversed?, drop_self_loops?) triples to expand for one
        relationship type.  An undirected pattern enumerates every
        relationship in both orientations, but a self-loop's orientations
        are the SAME binding — the reversed matrix skips loops so they
        match exactly once (TCK Match2 [3])."""
        direction = self.direction if direction is None else direction
        mats = []
        if direction in ("out", "both"):
            d = g.adj_out(tid)
            if d is not None:
                if int(d.base.nnz):
                    mats.append((d.base, False, False))
                if d.dp is not None:
                    mats.append((d.dp, False, False))
        if direction in ("in", "both"):
            T = g.adj_in_csr(tid)
            if T is not None and int(T.nnz):
                mats.append((T, True, direction == "both"))
        return mats

    def run(self, rt):
        from falkordb_tpu_torch.parallel.qdist import maybe_query_mesh

        g = rt.store
        alive = g.host_edge_alive()
        tids = self._type_ids(g)
        qmesh = maybe_query_mesh(g) if not self.chain else None
        source = self.child.run(rt)
        if qmesh is not None:
            from falkordb_tpu_torch.parallel.qdist import frontier_gate

            # mesh route: each kernel invocation scans the FULL edge
            # shards regardless of frontier size, so per-streamed-batch
            # dispatch multiplies the scan cost — buffer the child (up
            # to a bounded row cap: streaming semantics must survive
            # huge intermediates) and expand the whole frontier in ONE
            # kernel per hop (the r4 one-hop 6.9x sharded/local ratio
            # was mostly repeated scans)
            batches, total, overflow = [], 0, False
            for b in source:
                rt.check_timeout()
                if not b.n:
                    continue
                rt.charge_batch(b)
                batches.append(b)
                total += b.n
                if total >= _DIST_BUFFER_ROWS:
                    overflow = True
                    break
            if not batches:
                return
            if overflow:
                # too large to hold: keep the pre-buffer streaming form
                # (one dist dispatch per batch — memory-bounded)
                def _stream():
                    yield from batches
                    yield from source

                for lhs in _stream():
                    rt.check_timeout()
                    if not lhs.n:
                        continue
                    srcs = lhs.cols[self.src_slot].entity_ids()
                    valid = srcs != NULL_ID
                    hit = (np.zeros(lhs.n, dtype=bool)
                           if self.optional else None)
                    yield from self._run_dist(rt, lhs, srcs, valid,
                                              qmesh, hit)
                    yield from self._emit_missed(lhs, hit)
                return
            lhs = batches[0] if len(batches) == 1 else Batch.concat(batches)
            srcs = lhs.cols[self.src_slot].entity_ids()
            valid = srcs != NULL_ID
            if frontier_gate(int(valid.sum())):
                hit = np.zeros(lhs.n, dtype=bool) if self.optional else None
                yield from self._run_dist(rt, lhs, srcs, valid, qmesh, hit)
                yield from self._emit_missed(lhs, hit)
                return
            # small frontier: the local CSR path wins — feed it the
            # buffered batches
            source = iter(batches)
        for lhs in _coalesce_batches(source, rt):
            rt.check_timeout()
            if lhs.n == 0:
                continue
            src_col = lhs.cols[self.src_slot]
            srcs = src_col.entity_ids()
            valid = srcs != NULL_ID
            hit = np.zeros(lhs.n, dtype=bool) if self.optional else None
            if self.chain:
                yield from self._run_fused(rt, lhs, srcs, valid, alive, hit)
            else:
                frames = []
                for tid in tids:
                    for csr, rev, drop_self in self._matrices(g, tid):
                        frames.extend(self._expand_one(rt, lhs, csr, srcs,
                                                       valid, alive, rev,
                                                       hit, drop_self))
                for f in frames:
                    yield f
            yield from self._emit_missed(lhs, hit)

    def _emit_missed(self, lhs, hit):
        """OPTIONAL rows with no expansion get null dst/edge columns."""
        if hit is None or hit.all():
            return
        missed = np.nonzero(~hit)[0]
        out = lhs.take(missed)
        out = out.with_col(self.dst_slot,
                           Column.values([None] * len(missed)))
        if self.edge_slot is not None:
            out = out.with_col(self.edge_slot,
                               Column.values([None] * len(missed)))
        yield out

    def _run_dist(self, rt, lhs, srcs, valid, mesh, hit):
        """Mesh-routed expansion: the edge-shard membership scan runs
        at every shard of the mesh (K23, parallel/qdist.py); row join and
        label post-filter stay host-side.  Emits the same frame multiset
        as the CSR path."""
        from falkordb_tpu_torch.parallel import qdist

        g = rt.store
        tids = ([t for t in (g.schema.reltype_id(x) for x in
                             dict.fromkeys(self.types)) if t is not None]
                if self.types else None)
        row, dst, eid = qdist.expand_rows(g, mesh, srcs, valid, tids,
                                          self.direction)
        if self.dst_labels and len(row):
            keep = _gather_label_mask(rt, dst, self.dst_labels)
            row, dst, eid = row[keep], dst[keep], eid[keep]
        if hit is not None and len(row):
            hit[row] = True
        self.vec_rows += len(row)
        for lo in range(0, len(row), BATCH_SIZE):
            sel = slice(lo, lo + BATCH_SIZE)
            out = lhs.take(row[sel])
            out = out.with_col(self.dst_slot, Column.nodes(dst[sel]))
            if self.edge_slot is not None:
                out = out.with_col(self.edge_slot, Column.edges(eid[sel]))
            yield out

    def _expand_pairs(self, rt, g, srcs, valid, types, direction, alive,
                      dst_labels):
        """(row_idx, dst, eid) triples for one hop over all matching
        matrices — EVERY edge binding, multiplicity preserved (anonymous
        elements still distinguish matches: openCypher counts bindings of
        all pattern elements, so parallel edges and shared intermediates
        each contribute a row; r4 fix — the old distinct-(row,dst) product
        under-counted MATCH (a)-->()-->(c) paths)."""
        rows_all, dsts_all, eids_all = [], [], []
        for tid in self._type_ids(g, types):
            for csr, rev, _drop in self._matrices(g, tid, direction):
                ip, cols_h, vals_h = csr.host_view()
                clip = np.clip(srcs, 0, csr.n_rows - 1)
                deg = (ip[clip + 1] - ip[clip]) * valid
                total = int(deg.sum())
                if total == 0:
                    continue
                if total + len(srcs) < _device_expand_min():
                    rep = np.repeat(np.arange(len(srcs)), deg)
                    seg = np.cumsum(deg) - deg
                    within = np.arange(total) - np.repeat(seg, deg)
                    pos = np.repeat(ip[clip], deg) + within
                    row = rep
                    dst = cols_h[pos].astype(np.int64)
                    eid = (vals_h[pos] if vals_h is not None
                           else pos).astype(np.int64)
                    keep = alive[np.clip(eid, 0, len(alive) - 1)]
                else:
                    out_cap = 1024
                    while out_cap < total:
                        out_cap *= 2
                    row, dst, eid, ok = _device_expand(g, csr, srcs, valid,
                                                       out_cap)
                    dst = dst.astype(np.int64)
                    eid = eid.astype(np.int64)
                    keep = ok & alive[np.clip(eid, 0, len(alive) - 1)]
                if dst_labels:
                    keep &= _gather_label_mask(rt, dst, dst_labels)
                rows_all.append(row[keep])
                dsts_all.append(dst[keep])
                eids_all.append(eid[keep])
        if not rows_all:
            return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                    np.zeros(0, np.int64))
        return (np.concatenate(rows_all), np.concatenate(dsts_all),
                np.concatenate(eids_all))

    def _run_fused(self, rt, lhs, srcs, valid, alive, hit=None):
        """Chained expansion (F·A1·A2·…) preserving path multiplicity AND
        relationship uniqueness: each hop keeps every (path, edge)
        continuation and drops only reuse of an edge already on the
        path's trail (the Cypher per-pattern edge-uniqueness rule —
        matters for undirected hops and cyclic chains)."""
        g = rt.store
        row, dst, eid = self._expand_pairs(rt, g, srcs, valid, self.types,
                                           self.direction, alive,
                                           self.dst_labels)
        trail = [eid]
        for types, direction, dst_labels in self.chain:
            if len(row) == 0:
                return
            rt.check_timeout()
            r2, d2, e2 = self._expand_pairs(
                rt, g, dst.astype(np.int64),
                np.ones(len(dst), dtype=bool), types, direction, alive,
                dst_labels)
            keep = np.ones(len(r2), dtype=bool)
            for t in trail:
                keep &= t[r2] != e2
            r2, d2, e2 = r2[keep], d2[keep], e2[keep]
            row, dst = row[r2], d2
            trail = [t[r2] for t in trail] + [e2]
            rt.charge_mem(len(row) * 8 * (len(trail) + 2))
        if hit is not None and len(row):
            hit[row] = True
        for lo in range(0, len(row), BATCH_SIZE):
            sel = slice(lo, lo + BATCH_SIZE)
            out = lhs.take(row[sel])
            out = out.with_col(self.dst_slot,
                               Column.nodes(dst[sel].astype(np.int64)))
            yield out

    def _expand_one(self, rt, lhs, csr, srcs, valid, alive, rev, hit=None,
                    drop_self=False):
        out_cap = 1024
        # host-side degree estimate to right-size the bucket
        ip, cols_h, vals_h = csr.host_view()
        clip = np.clip(srcs, 0, csr.n_rows - 1)
        deg = (ip[clip + 1] - ip[clip]) * valid
        total = int(deg.sum())
        if total + len(srcs) < _device_expand_min():
            # host ragged gather: below the threshold the per-batch
            # device dispatch (upload + launches + download) costs more
            # than the expansion itself
            if total == 0:
                return []
            rep = np.repeat(np.arange(len(srcs)), deg)
            seg = np.cumsum(deg) - deg
            within = np.arange(total) - np.repeat(seg, deg)
            pos = np.repeat(ip[clip], deg) + within
            row = rep
            dst = cols_h[pos].astype(np.int64)
            eid = (vals_h[pos] if vals_h is not None else pos).astype(
                np.int64)
            keep = alive[np.clip(eid, 0, len(alive) - 1)]
            return self._expand_tail(rt, lhs, srcs, row, dst, eid, keep,
                                     hit, drop_self)
        while out_cap < total:
            out_cap *= 2
        row, dst, eid, ok = _device_expand(rt.store, csr, srcs, valid,
                                           out_cap)
        keep = ok & alive[np.clip(eid, 0, len(alive) - 1)]
        return self._expand_tail(rt, lhs, srcs, row, dst, eid, keep,
                                 hit, drop_self)

    def _expand_tail(self, rt, lhs, srcs, row, dst, eid, keep, hit,
                     drop_self):
        results = []
        if drop_self:
            keep &= dst != srcs[np.clip(row, 0, len(srcs) - 1)]
        if self.dst_labels:
            keep &= _gather_label_mask(rt, dst, self.dst_labels)
        idx = np.nonzero(keep)[0]
        if hit is not None and len(idx):
            hit[row[idx]] = True
        # fat output batches: downstream per-batch overhead dominates at
        # 1K rows for expansion-heavy pipelines (two_hop and friends)
        chunk = BATCH_SIZE * 16
        for lo in range(0, len(idx), chunk):
            sel = idx[lo : lo + chunk]
            out = lhs.take(row[sel])
            out = out.with_col(self.dst_slot, Column.nodes(dst[sel].astype(np.int64)))
            if self.edge_slot is not None:
                out = out.with_col(self.edge_slot,
                                   Column.edges(eid[sel].astype(np.int64)))
            results.append(out)
        return results


class ExpandInto(Op):
    """Both endpoints bound: check edge existence / bind edges
    (ops/expand_into.rs)."""

    name = "ExpandInto"

    def __init__(self, child, src_slot, dst_slot, edge_slot, types, direction):
        super().__init__(child)
        self.src_slot = src_slot
        self.dst_slot = dst_slot
        self.edge_slot = edge_slot
        self.types = types
        self.direction = direction

    def describe(self):
        return "Expand Into"

    _INDEX_MIN_ROWS = 8  # below this, per-row scans beat the sort build

    def run(self, rt):
        g = rt.store
        live = ~g.e_deleted[: g.edge_max]
        tids = None
        if self.types:
            tids = {g.schema.reltype_id(t) for t in self.types} - {None}
        pair_idx = None

        def get_pair_index():
            # sorted (src,dst)->eids lookup, built once per execution —
            # the per-row whole-edge-array scan is O(m) PER ROW and
            # dominated LDBC ic_fof (NOT (p)-[:KNOWS]-(fof) over 1M edges).
            # Cached on the snapshot (cleared by _invalidate) so repeat
            # point queries skip the O(m log m) sort too.
            nonlocal pair_idx
            if pair_idx is None:
                both = self.direction == "both"
                cache = getattr(g, "_compact_cache", None)
                ck = ("pair_idx", frozenset(tids) if tids is not None
                      else None, both)
                if cache is not None and ck in cache:
                    pair_idx = cache[ck]
                    return pair_idx
                sel = live.copy()
                if tids is not None:
                    tm = np.zeros(g.edge_max, dtype=bool)
                    for t in tids:
                        tm |= g.e_type[: g.edge_max] == t
                    sel &= tm
                es = g.e_src[: g.edge_max][sel]
                ed = g.e_dst[: g.edge_max][sel]
                ee = np.nonzero(sel)[0]
                pair_idx = _PairEdgeIndex(es, ed, ee, g.node_max + 1,
                                          both=both)
                if cache is not None and len(ee) <= 8_000_000:
                    cache[ck] = pair_idx
            return pair_idx

        for lhs in self.child.run(rt):
            rt.check_timeout()
            rows, eids = [], []
            s_ids = lhs.cols[self.src_slot].entity_ids()
            d_ids = lhs.cols[self.dst_slot].entity_ids()
            if lhs.n >= self._INDEX_MIN_ROWS:
                idx = get_pair_index()
                for i in range(lhs.n):
                    s, d = int(s_ids[i]), int(d_ids[i])
                    if s == NULL_ID or d == NULL_ID:
                        continue
                    key = (d, s) if self.direction == "in" else (s, d)
                    cand = np.sort(idx.get(key))
                    if self.direction == "both" and s == d and len(cand):
                        cand = np.unique(cand)  # self-loop listed twice
                    for e in cand:
                        rows.append(i)
                        eids.append(int(e))
                        if self.edge_slot is None:
                            break
                if rows:
                    out = lhs.take(np.asarray(rows))
                    if self.edge_slot is not None:
                        out = out.with_col(self.edge_slot, Column.edges(eids))
                    yield out
                continue
            for i in range(lhs.n):
                s, d = int(s_ids[i]), int(d_ids[i])
                if s == NULL_ID or d == NULL_ID:
                    continue
                cand = np.nonzero(
                    live
                    & (
                        ((g.e_src[: g.edge_max] == s) & (g.e_dst[: g.edge_max] == d))
                        if self.direction == "out" else
                        ((g.e_src[: g.edge_max] == d) & (g.e_dst[: g.edge_max] == s))
                        if self.direction == "in" else
                        (((g.e_src[: g.edge_max] == s) & (g.e_dst[: g.edge_max] == d))
                         | ((g.e_src[: g.edge_max] == d) & (g.e_dst[: g.edge_max] == s)))
                    )
                )[0]
                for e in cand:
                    if tids is not None and int(g.e_type[e]) not in tids:
                        continue
                    if self.edge_slot is None:
                        rows.append(i)
                        eids.append(int(e))
                        break
                    rows.append(i)
                    eids.append(int(e))
            if rows:
                out = lhs.take(np.asarray(rows))
                if self.edge_slot is not None:
                    out = out.with_col(self.edge_slot, Column.edges(eids))
                yield out


class VarLenTraverse(Op):
    """Variable-length traverse with per-path edge uniqueness (trail
    semantics) via batched level expansion (ops/cond_var_len_traverse.rs
    doc:1-80 — lazy suspension-safe emission).

    Each depth level expands the WHOLE partial-path frontier through the
    batched CSR `expand` kernel (one device call per adjacency matrix, not
    per node); only the trail state (edge-id tuple per partial path) is
    host-side.  Levels >= min_hops stream out in BATCH_SIZE chunks as they
    are produced, and each level's frontier is charged against the query
    memory capacity — unbounded trail blow-ups fail with the mem guard
    instead of exhausting host memory."""

    name = "CondVarLenTraverse"

    def __init__(self, child, src_slot, dst_slot, edge_slot, types, direction,
                 min_hops, max_hops, dst_labels, path_slot=None,
                 reverse_trail=False):
        super().__init__(child)
        self.src_slot = src_slot
        self.dst_slot = dst_slot
        self.edge_slot = edge_slot  # collects list of edges when named
        self.types = types
        self.direction = direction
        self.min_hops = min_hops if min_hops is not None else 1
        self.max_hops = max_hops  # None = unbounded
        self.dst_labels = dst_labels
        self.path_slot = path_slot
        # traversal ran right-to-left relative to the declared pattern:
        # bound edge lists present in PATH order (TCK Path2 [2])
        self.reverse_trail = reverse_trail

    def describe(self):
        return (f"Conditional Variable Length Traverse | "
                f"*{self.min_hops}..{self.max_hops or ''}")

    def _matrices(self, g):
        """(CSR, reversed?, drop_self_loops?) across matching relationship
        types.  Undirected expansion must not emit a self-loop twice (its
        two orientations are the same binding — TCK Match3 [11])."""
        tids = ([t for t in dict.fromkeys(
            g.schema.reltype_id(x) for x in self.types)
                 if t is not None] if self.types else sorted(g.adj.keys()))
        mats = []
        for tid in tids:
            if self.direction in ("out", "both"):
                d = g.adj_out(tid)
                if d is not None:
                    if int(d.base.nnz):
                        mats.append((d.base, False, False))
                    if d.dp is not None:
                        mats.append((d.dp, False, False))
            if self.direction in ("in", "both"):
                T = g.adj_in_csr(tid)
                if T is not None and int(T.nnz):
                    mats.append((T, True, self.direction == "both"))
        return mats

    def _expand_level(self, rt, mats, nodes, alive, qmesh=None):
        """One batched expand of the whole frontier: (j, dst, eid) arrays
        over every adjacency matrix (device kernel; no per-node Python)."""
        if qmesh is not None:
            from falkordb_tpu_torch.parallel import qdist

            g = rt.store
            tids = ([t for t in (g.schema.reltype_id(x) for x in
                                 dict.fromkeys(self.types))
                     if t is not None] if self.types else None)
            return qdist.expand_rows(g, qmesh, nodes.astype(np.int64),
                                     nodes >= 0, tids, self.direction)
        srcs = nodes.astype(np.int32)
        valid = nodes >= 0
        js, ds, es = [], [], []
        for csr, _rev, drop_self in mats:
            ip, cols_h, vals_h = csr.host_view()
            clip = np.clip(srcs, 0, csr.n_rows - 1)
            deg = (ip[clip + 1] - ip[clip]) * valid
            total = int(deg.sum())
            if total + len(srcs) < _device_expand_min():
                # host ragged gather — a var-len level over a small
                # frontier must not pay per-level device dispatch
                if total == 0:
                    continue
                row = np.repeat(np.arange(len(srcs)), deg)
                seg = np.cumsum(deg) - deg
                within = np.arange(total) - np.repeat(seg, deg)
                pos = np.repeat(ip[clip], deg) + within
                dst = cols_h[pos].astype(np.int64)
                eid = (vals_h[pos] if vals_h is not None
                       else pos).astype(np.int64)
                keep = alive[np.clip(eid, 0, len(alive) - 1)]
            else:
                out_cap = 1024
                while out_cap < total:
                    out_cap *= 2
                row, dst, eid, ok = _device_expand(rt.store, csr, srcs,
                                                   valid, out_cap)
                keep = ok & alive[np.clip(eid, 0, len(alive) - 1)]
            if drop_self:
                keep &= dst != srcs[np.clip(row, 0, len(srcs) - 1)]
            js.append(row[keep])
            ds.append(dst[keep])
            es.append(eid[keep])
        if not js:
            return (np.zeros(0, np.int64),) * 3
        return (np.concatenate(js), np.concatenate(ds), np.concatenate(es))

    def _emit(self, rt, lhs, rows, dsts, paths):
        """Stream one level's matches out in BATCH_SIZE chunks.  `paths`
        is the (n, depth) trail matrix; rows materialize to Python edge
        values only here, for the rows actually emitted."""
        order = np.argsort(rows, kind="stable")
        rows = rows[order]
        dsts = dsts[order]
        paths = paths[order]
        src_ids = lhs.cols[self.src_slot].entity_ids()
        for lo in range(0, len(rows), BATCH_SIZE):
            sel = slice(lo, lo + BATCH_SIZE)
            out = lhs.take(rows[sel])
            out = out.with_col(self.dst_slot, Column.nodes(dsts[sel]))
            if self.edge_slot is not None:
                vals = [[rt.ctx.edge_value(e) for e in
                         (reversed(p) if self.reverse_trail else p)]
                        for p in paths[sel]]
                out = out.with_col(self.edge_slot, Column.values(vals))
            if self.path_slot is not None:
                out = out.with_col(
                    self.path_slot,
                    Column.values([
                        _build_path(rt, int(src_ids[r]), list(p))
                        for r, p in zip(rows[sel], paths[sel])
                    ]),
                )
            yield out

    def run(self, rt):
        from falkordb_tpu_torch.parallel.qdist import maybe_query_mesh

        g = rt.store
        alive = g.host_edge_alive()
        qmesh = maybe_query_mesh(g)
        max_h = self.max_hops if self.max_hops is not None else g.node_max + 1
        state = {"qmesh": qmesh}

        def input_batches():
            if qmesh is None:
                yield from self.child.run(rt)
                return
            # mesh route: one buffered frontier -> one shard-scan kernel
            # per LEVEL for the whole input instead of per streamed batch
            # (bounded: a huge intermediate keeps the streaming form)
            from falkordb_tpu_torch.parallel.qdist import frontier_gate

            src = self.child.run(rt)
            buf, total = [], 0
            for b in src:
                rt.check_timeout()
                if b.n:
                    rt.charge_batch(b)
                    buf.append(b)
                    total += b.n
                    if total >= _DIST_BUFFER_ROWS:
                        yield from buf
                        yield from src
                        return
            if not buf:
                return
            big = buf[0] if len(buf) == 1 else Batch.concat(buf)
            nf = int((np.asarray(big.cols[self.src_slot].entity_ids())
                      != NULL_ID).sum())
            if not frontier_gate(nf):
                state["qmesh"] = None  # point query: local CSR path wins
            yield big

        mats_cache = None
        for lhs in input_batches():
            qmesh = state["qmesh"]
            if qmesh is None:
                if mats_cache is None:
                    mats_cache = self._matrices(g)  # nnz fetches: once
                mats = mats_cache
            else:
                mats = []
            rt.check_timeout()
            src_ids = np.asarray(lhs.cols[self.src_slot].entity_ids(),
                                 dtype=np.int64)
            start = np.nonzero(src_ids != NULL_ID)[0]
            if self.min_hops == 0 and len(start):
                sdst = src_ids[start]
                keep = (np.ones(len(start), bool) if not self.dst_labels else
                        _gather_label_mask(rt, sdst, self.dst_labels))
                if keep.any():
                    yield from self._emit(
                        rt, lhs, start[keep], sdst[keep],
                        np.empty((int(keep.sum()), 0), dtype=np.int64))
            # frontier of partial paths, fully columnar: input row, current
            # node, and the edge trail as an (n_frontier, depth) int64
            # matrix — no per-row Python tuples
            cur_rows = start
            cur_nodes = src_ids[start]
            trail = np.empty((len(start), 0), dtype=np.int64)
            depth = 0
            while len(cur_rows) and depth < max_h:
                rt.check_timeout()
                depth += 1
                j, dst, eid = self._expand_level(rt, mats, cur_nodes, alive,
                                                 qmesh)
                # trail semantics: drop expansions reusing an edge already
                # on their own partial path — one vectorized matrix
                # compare per level instead of a per-expansion Python
                # membership test (cond_var_len_traverse.rs:1-80 role)
                if trail.shape[1]:
                    fresh = ~(trail[j] == eid[:, None]).any(axis=1)
                    j, dst, eid = j[fresh], dst[fresh], eid[fresh]
                trail = np.concatenate([trail[j], eid[:, None]], axis=1)
                cur_rows = cur_rows[j]
                cur_nodes = dst
                # each level's frontier is real memory: trail matrix + ids
                rt.charge_mem(len(cur_rows) * (48 + 8 * depth))
                if depth >= self.min_hops and len(cur_rows):
                    keep = (np.ones(len(cur_rows), bool)
                            if not self.dst_labels else
                            _gather_label_mask(rt, cur_nodes,
                                               self.dst_labels))
                    if keep.any():
                        yield from self._emit(
                            rt, lhs, cur_rows[keep], cur_nodes[keep],
                            trail[keep])


def _build_path(rt, src, eids):
    g = rt.store
    nodes = [rt.ctx.node_value(src)]
    edges = []
    cur = src
    for e in eids:
        s, d, t = g.edge_endpoints(e)
        nxt = d if s == cur else s
        edges.append(rt.ctx.edge_value(e))
        nodes.append(rt.ctx.node_value(nxt))
        cur = nxt
    return PathVal(nodes, edges)


class _PairEdgeIndex:
    """(src, dst) -> edge-id list over compact node ids, backed by a
    sorted compound-key array (vectorized build; O(log m) lookups).
    Matches the dict-of-lists contract ShortestPath._backtrack uses."""

    def __init__(self, src, dst, eids, n, both=False):
        s = np.asarray(src, np.int64)
        d = np.asarray(dst, np.int64)
        e = np.asarray(eids, np.int64)
        if both:
            s, d = np.concatenate([s, d]), np.concatenate([d, s])
            e = np.concatenate([e, e])
        keys = s * n + d
        order = np.argsort(keys, kind="stable")
        self._keys = keys[order]
        self._eids = e[order]
        self._n = n

    def get(self, sd, default=()):
        k = sd[0] * self._n + sd[1]
        lo = np.searchsorted(self._keys, k, "left")
        hi = np.searchsorted(self._keys, k, "right")
        return self._eids[lo:hi] if hi > lo else default


def _sp_caches(comp, direction):
    """Per-CompactGraph shortest-path helpers: the pair-edge index and a
    bounded per-source BFS-levels cache (comp itself is cached on the
    store snapshot, so these persist across point queries)."""
    attr = "_sp_pair_both" if direction == "both" else "_sp_pair"
    pe = getattr(comp, attr, None)
    if pe is None:
        pe = _PairEdgeIndex(comp.src, comp.dst, comp.eids, len(comp.ids),
                            both=(direction == "both"))
        setattr(comp, attr, pe)
    lc = getattr(comp, "_sp_levels", None)
    if lc is None or len(lc) > 64:  # bound: n-sized arrays per source
        lc = {}
        comp._sp_levels = lc
    return pe, lc


class ShortestPath(Op):
    """shortestPath / allShortestPaths patterns (ops/all_shortest_paths.rs:
    BFS + predecessor DAG + DFS backtrack).  The per-source BFS runs the
    jitted device kernel; path reconstruction is host-side."""

    name = "AllShortestPaths"

    def __init__(self, child, src_slot, dst_slot, path_slot, types, direction,
                 max_hops, all_paths, reverse=False):
        super().__init__(child)
        # incoming patterns are normalized by the planner: BFS runs
        # dst->src over out-edges and the emitted paths are reversed
        if direction == "in":
            src_slot, dst_slot = dst_slot, src_slot
            direction, reverse = "out", not reverse
        self.src_slot = src_slot
        self.dst_slot = dst_slot
        self.path_slot = path_slot
        self.types = types
        self.direction = direction
        self.max_hops = max_hops
        self.all_paths = all_paths
        self.reverse = reverse

    def describe(self):
        return ("All Shortest Paths" if self.all_paths else "Shortest Path")

    def _build_adj(self, rt):
        from falkordb_tpu_torch.algos.common import compact_adjacency

        g = rt.store
        return compact_adjacency(
            g, None, self.types or None,
            directed=(self.direction != "both"), keep_eids=True)

    def run(self, rt):
        from falkordb_tpu_torch.algos.bfs import bfs_levels

        comp = self._build_adj(rt)
        if comp is None:
            return
        g = rt.store
        n = len(comp.ids)
        # predecessor lookup: edges grouped by dst (use transpose COO)
        at = comp.at
        ipT, colsT, _ = at.host_view()
        # (compact_src, compact_dst) -> eids: sorted compound keys +
        # searchsorted slices — one vectorized sort instead of a
        # per-edge Python dict build.  Cached on the (snapshot-cached)
        # CompactGraph so repeat point queries skip the sort too.
        pair_edges, levels_cache = _sp_caches(comp, self.direction)
        for b in self.child.run(rt):
            rt.check_timeout()
            out_rows, out_paths, out_dsts = [], [], []
            src_ids = b.cols[self.src_slot].entity_ids()
            dst_ids = (b.cols[self.dst_slot].ids
                       if self.dst_slot in b.cols
                       and b.cols[self.dst_slot].kind == "node" else None)
            for i in range(b.n):
                s = int(src_ids[i])
                if s == NULL_ID or s not in comp.remap:
                    continue
                cs = comp.remap[s]
                lkey = (cs, self.max_hops)
                if lkey not in levels_cache:
                    # bound the level sweep by the pattern's hop cap — on a
                    # ring an unbounded BFS runs to the full diameter
                    levels_cache[lkey] = bfs_levels(
                        at, cs, self.max_hops).cpu().numpy()
                levels = levels_cache[lkey]
                targets = ([int(dst_ids[i])] if dst_ids is not None
                           else [int(comp.ids[c]) for c in range(n)
                                 if 0 < levels[c] < 2**30])
                for t in targets:
                    if t not in comp.remap:
                        continue
                    ct = comp.remap[t]
                    lv = int(levels[ct])
                    if lv <= 0 or lv >= 2**30:
                        continue
                    if self.max_hops is not None and lv > self.max_hops:
                        continue
                    paths = self._backtrack(ct, cs, levels, ipT, colsT,
                                            pair_edges, comp, rt)
                    if not self.all_paths:
                        paths = paths[:1]
                    for pth in paths:
                        out_rows.append(i)
                        out_dsts.append(t)
                        out_paths.append(pth)
            if out_rows:
                out = b.take(np.asarray(out_rows))
                if self.dst_slot is not None and dst_ids is None:
                    out = out.with_col(self.dst_slot, Column.nodes(out_dsts))
                out = out.with_col(self.path_slot, Column.values(out_paths))
                yield out

    def _backtrack(self, ct, cs, levels, ipT, colsT, pair_edges, comp, rt):
        """DFS from target back to source over the BFS-level DAG; returns
        PathVals (source→target order)."""
        results = []
        # stack entries: (cnode, [edge ids so far (reversed)], [nodes...])
        stack = [(ct, [], [ct])]
        while stack:
            node, epath, npath = stack.pop()
            if node == cs:
                nodes = [rt.ctx.node_value(int(comp.ids[c]))
                         for c in reversed(npath)]
                edges = [rt.ctx.edge_value(e) for e in reversed(epath)]
                results.append(PathVal(nodes, edges))
                if not self.all_paths and results:
                    break
                continue
            lv = levels[node]
            for p in range(int(ipT[node]), int(ipT[node + 1])):
                pred = int(colsT[p])
                if levels[pred] == lv - 1:
                    for eid in pair_edges.get((pred, node), []):
                        stack.append((pred, epath + [eid], npath + [pred]))
        if getattr(self, "reverse", False):
            results = [PathVal(p.nodes[::-1], p.edges[::-1])
                       for p in results]
        return results


class Filter(Op):
    name = "Filter"

    def __init__(self, child, expr):
        super().__init__(child)
        self.expr = expr

    def describe(self):
        return "Filter"

    def run(self, rt):
        from falkordb_tpu_torch.runtime.vectorized import predicate_mask

        for b in self.child.run(rt):
            rt.check_timeout()
            # typed columnar fast path (vectorized.rs:1-34 role): whole-batch
            # array predicate, no per-row Python
            keep = predicate_mask(self.expr, b, rt.ctx)
            if keep is not None:
                self.vec_rows += b.n
            else:
                keep = evaluate_predicate(self.expr, b, rt.ctx)
            idx = np.nonzero(keep)[0]
            if len(idx):
                yield b.take(idx)


class Project(Op):
    name = "Project"

    def __init__(self, child, items, passthrough=False):
        """items: list of (expr, out_slot, alias).  With passthrough, the
        input columns ride along physically (slots are globally unique) so a
        downstream Sort can reference pre-projection variables — scoping
        rules are enforced at bind time, not by dropping data."""
        super().__init__(child)
        self.items = items
        self.passthrough = passthrough

    def describe(self):
        return "Project"

    def run(self, rt):
        for b in self.child.run(rt):
            rt.check_timeout()
            cols = dict(b.cols) if self.passthrough else {}
            for expr, slot, _ in self.items:
                cols[slot] = evaluate(expr, b, rt.ctx)
            yield Batch(b.n, cols)


class Unwind(Op):
    name = "Unwind"

    def __init__(self, child, expr, slot):
        super().__init__(child)
        self.expr = expr
        self.slot = slot

    def describe(self):
        return "Unwind"

    def run(self, rt):
        for b in self.child.run(rt):
            rt.check_timeout()
            vals = rt.ctx.materialize(evaluate(self.expr, b, rt.ctx))
            rows, items = [], []
            for i in range(b.n):
                v = vals[i]
                if v is None:
                    continue
                seq = v if isinstance(v, (list, tuple)) else [v]
                for item in seq:
                    rows.append(i)
                    items.append(item)
            for lo in range(0, len(rows), BATCH_SIZE):
                sel = slice(lo, lo + BATCH_SIZE)
                out = b.take(np.asarray(rows[sel]))
                yield out.with_col(self.slot, Column.values(items[sel]))


# -- K2: group partials ------------------------------------------------------

_PARTIAL_OPS = {"count": 0, "sum": 1, "min": 2, "max": 3}


def group_partials(codes, vals, mask, u: int, op: str):
    """Per-group partials of one aggregate (kernel K2, csrc/group_partials.cu;
    replaces falkordb_tpu's jitted segment reduces in
    Aggregate._device_partials).

    codes (n,) int32 group codes in [0, u); vals (n,) float64 or None for
    op "count"; mask (n,) bool rows that count, or None for every row
    (count(*)).  Returns (cnt (u,) int64, acc (u,) float64 or None): the
    live rows per group and their sum / min / max.  Groups with no live row
    read 0, +inf (min) and -inf (max).  CPU tensors run
    `group_partials_plain`; CUDA tensors launch the kernel."""
    if op not in _PARTIAL_OPS:
        raise ValueError(f"group_partials: unknown op {op!r}")
    if op != "count" and vals is None:
        raise ValueError(f"group_partials: op {op!r} needs vals")
    if not _cuda.on_cuda(codes, vals, mask):
        return group_partials_plain(codes, vals, mask, u, op)
    n = codes.numel()
    for name, t, dtype in (("codes", codes, torch.int32),
                           ("vals", vals, torch.float64),
                           ("mask", mask, torch.bool)):
        _cuda.check_input("group_partials", name, t, dtype, n)
    dev = codes.device
    cnt = torch.empty(u, dtype=torch.int64, device=dev)
    acc = (None if op == "count"
           else torch.empty(u, dtype=torch.float64, device=dev))
    p = _cuda.ptr
    rc = _cuda.lib().fk_group_partials(
        p(codes), p(vals), p(mask), n, u, _PARTIAL_OPS[op], p(cnt), p(acc),
        _cuda.stream_ptr(codes))
    _cuda.check(rc, "group_partials")
    _cuda.count_launch("group_partials")
    return cnt, acc


def group_partials_plain(codes, vals, mask, u: int, op: str):
    """Plain PyTorch version of `group_partials`: index_add_ and
    scatter_reduce_ on identity-filled outputs."""
    dev = codes.device
    c = codes.to(torch.int64)
    live = (c >= 0) & (c < u)  # out-of-range codes drop, as in a segment op
    if mask is not None:
        live &= mask
    c = c[live]
    cnt = torch.zeros(u, dtype=torch.int64, device=dev).index_add_(
        0, c, torch.ones_like(c))
    if op == "count":
        return cnt, None
    v = vals[live].to(torch.float64)
    if op == "sum":
        acc = torch.zeros(u, dtype=torch.float64, device=dev).index_add_(
            0, c, v)
    else:
        acc = torch.full((u,), math.inf if op == "min" else -math.inf,
                         dtype=torch.float64, device=dev).scatter_reduce_(
            0, c, v, "amin" if op == "min" else "amax")
    return cnt, acc


class Aggregate(Op):
    name = "Aggregate"

    def __init__(self, child, group_items, agg_items):
        """group_items: [(expr, out_slot, alias)];
        agg_items: [(fn_name, distinct, arg_expr|None, extra_args, out_slot)]"""
        super().__init__(child)
        self.group_items = group_items
        self.agg_items = agg_items

    def describe(self):
        return "Aggregate"

    _VEC_AGGS = {"count", "sum", "avg", "min", "max", "stdev", "stdevp"}
    _DEVICE_AGGS = {"count", "sum", "avg", "min", "max"}

    def _vec_batch(self, b, rt, groups, order) -> bool:
        """Vectorized per-batch partial aggregation (the ops/aggregate.rs
        batched grouping path): group codes + bincount/ufunc.at partials,
        merged into the object-keyed group table at GROUP granularity.
        Returns False when a column fails to typify (per-row path runs)."""
        from falkordb_tpu_torch.runtime import vectorized as V

        ctx = rt.ctx
        gtvs = []
        for e, _, _ in self.group_items:
            tv = V.eval_typed(e, b, ctx)
            if tv is None:
                return False
            gtvs.append(tv)
        atvs = []
        for fn, distinct, arg, extra, _ in self.agg_items:
            if arg is None:
                atvs.append(None)
                continue
            tv = V.eval_typed(arg, b, ctx)
            if tv is None:
                return False
            if fn in ("sum", "avg", "min", "max", "stdev", "stdevp") and \
                    tv.kind not in (V.NUM, V.NULLK):
                return False
            if fn in ("min", "max", "sum") and tv.kind == V.NUM \
                    and tv.num_mixed:
                # min/max must return the ORIGINAL value type; sum of an
                # all-int GROUP within a mixed column stays int per-row
                return False
            atvs.append(tv)
        codes, first = V.group_codes(gtvs, b.n)
        if b.n == 0:
            return True
        u = len(first)
        parts = None
        if b.n >= _device_agg_min() and all(
                fn in self._DEVICE_AGGS and (
                    tv is None or fn == "count" or
                    (tv.kind == V.NUM and tv.vals is not None))
                for (fn, _, _, _, _), tv in zip(self.agg_items, atvs)):
            parts = self._device_partials(codes, u, atvs, b.n,
                                          rt.store.device)
            if parts is not None:
                self.dev_rows += b.n
        if parts is None:
            parts = self._host_partials(codes, u, atvs)
        # group representatives (first occurrence) → object keys
        for g in range(u):
            row = int(first[g])
            gvals = [self._tv_value(tv, row, ctx) for tv in gtvs]
            key = tuple(_hashable(v) for v in gvals)
            st = groups.get(key)
            if st is None:
                st = (gvals, [_agg_new(fn, d)
                              for fn, d, _, _, _ in self.agg_items])
                groups[key] = st
                order.append(key)
                rt.charge_mem(128 + 64 * len(self.agg_items))
            for j, p in enumerate(parts):
                self._merge_partial(st[1][j], p, g)
        return True

    def _vec_oneshot(self, b, rt):
        """Whole-input vectorized aggregation: group codes + numpy
        finalization straight to output batches — no per-group python
        state.  Returns None (caller falls back) when any key/agg fails
        to typify or a key is an entity column."""
        from falkordb_tpu_torch.runtime import vectorized as V

        ctx = rt.ctx
        gtvs = []
        for e, _, _ in self.group_items:
            tv = V.eval_typed(e, b, ctx)
            if tv is None or tv.kind in (V.NODE, V.EDGE):
                return None
            gtvs.append(tv)
        atvs = []
        for fn, distinct, arg, extra, _ in self.agg_items:
            if arg is None:
                atvs.append(None)
                continue
            tv = V.eval_typed(arg, b, ctx)
            if tv is None:
                return None
            if fn in ("sum", "avg", "min", "max", "stdev", "stdevp",
                      "percentiledisc", "percentilecont") and \
                    tv.kind not in (V.NUM, V.NULLK):
                return None
            if fn in ("min", "max", "sum", "percentiledisc") \
                    and tv.kind == V.NUM and tv.num_mixed:
                return None
            if distinct and tv.kind not in (V.NUM, V.STR, V.BOOL, V.NULLK):
                return None
            if fn == "collect" and tv.kind in (V.NODE, V.EDGE):
                return None  # entity lists need per-row materialization
            atvs.append(tv)
        if b.n == 0:
            return []
        codes, first = V.group_codes(gtvs, b.n)
        u = len(first)

        # group-key value lists (exact reps via orig when present)
        key_lists = []
        for tv in gtvs:
            if tv.kind == V.NULLK:
                key_lists.append([None] * u)
                continue
            if tv.orig is not None:
                vals = tv.orig[first].tolist() if isinstance(
                    tv.orig, np.ndarray) else [tv.orig[i] for i in first]
            elif tv.kind == V.NUM:
                f = tv.vals[first]
                vals = f.astype(np.int64).tolist() if tv.is_int \
                    else f.tolist()
            elif tv.kind == V.BOOL:
                vals = tv.vals[first].astype(bool).tolist()
            else:
                vals = tv.vals[first].tolist()
            if tv.null.any():
                nn = tv.null[first]
                vals = [None if nn[i] else vals[i] for i in range(u)]
            key_lists.append(vals)

        agg_lists = []
        for (fn, distinct, arg, extra, _), tv in zip(self.agg_items, atvs):
            if arg is None:
                agg_lists.append(np.bincount(codes, minlength=u).tolist())
                continue
            mask = ~tv.null
            mcodes = codes[mask]
            cnt = np.bincount(mcodes, minlength=u)
            if fn == "count" and distinct:
                agg_lists.append(
                    _distinct_counts(codes, tv, u, b.n).tolist())
                continue
            if fn == "count":
                agg_lists.append(cnt.tolist())
                continue
            if fn == "collect":
                # group-sorted slices: ONE stable argsort + searchsorted
                # replaces the per-row python append (collect drops nulls;
                # input order within each group is preserved)
                if tv.kind == V.NULLK or tv.vals is None:
                    agg_lists.append([[] for _ in range(u)])
                    continue
                gorder = np.argsort(mcodes, kind="stable")
                bounds = np.searchsorted(mcodes[gorder],
                                         np.arange(u + 1))
                midx = np.nonzero(mask)[0][gorder]
                if tv.orig is not None:
                    flat = tv.orig[midx].tolist() if isinstance(
                        tv.orig, np.ndarray) else [tv.orig[i] for i in midx]
                elif tv.kind == V.NUM:
                    vv = tv.vals[midx]
                    flat = vv.astype(np.int64).tolist() if tv.is_int \
                        else vv.tolist()
                elif tv.kind == V.BOOL:
                    flat = tv.vals[midx].astype(bool).tolist()
                else:  # STR
                    flat = tv.vals[midx].tolist()
                agg_lists.append([flat[bounds[i]:bounds[i + 1]]
                                  for i in range(u)])
                continue
            if fn in ("percentiledisc", "percentilecont"):
                p = 0.5
                lit = extra[0].value if isinstance(extra[0], A.Lit) else None
                if isinstance(lit, (int, float)) and not isinstance(
                        lit, bool) and 0.0 <= lit <= 1.0:
                    # valid literal percentile (the common case): skip the
                    # per-row validation loop; invalid/dynamic values keep
                    # the row loop's exact error semantics
                    if mask.any():
                        p = lit
                else:
                    pv = ctx.materialize(evaluate(extra[0], b, ctx))
                    for i in np.nonzero(mask)[0]:
                        q = pv[i]
                        if isinstance(q, bool) or not isinstance(
                                q, (int, float)) or not (0.0 <= q <= 1.0):
                            raise EvalError(
                                f"percentile must be a number in [0, 1], "
                                f"got {q!r}")
                        p = q
                mv = tv.vals[mask] if tv.vals is not None else \
                    np.zeros(0, np.float64)
                ordv = np.lexsort((mv, mcodes))
                sc, sv = mcodes[ordv], mv[ordv]
                bounds = np.searchsorted(sc, np.arange(u + 1))
                vals = []
                for i in range(u):
                    seg = sv[bounds[i]: bounds[i + 1]]
                    if len(seg) == 0:
                        vals.append(None)
                    elif fn == "percentiledisc":
                        idx = max(0, min(len(seg) - 1,
                                         math.ceil(p * len(seg)) - 1))
                        vals.append(int(seg[idx]) if tv.is_int
                                    else float(seg[idx]))
                    else:
                        pos = p * (len(seg) - 1)
                        lo = int(pos)
                        hi = min(lo + 1, len(seg) - 1)
                        frac = pos - lo
                        vals.append(float(seg[lo] * (1 - frac)
                                          + seg[hi] * frac))
                agg_lists.append(vals)
                continue
            mv = tv.vals[mask] if tv.vals is not None else \
                np.zeros(0, np.float64)
            if fn in ("sum", "avg"):
                s = np.bincount(mcodes, minlength=u, weights=mv)
                if fn == "sum":
                    agg_lists.append(s.tolist())  # empty group -> 0.0
                else:
                    a = (s / np.maximum(cnt, 1)).tolist()
                    agg_lists.append([None if cnt[i] == 0 else a[i]
                                      for i in range(u)])
            elif fn in ("min", "max"):
                ext = np.full(u, np.inf if fn == "min" else -np.inf)
                if len(mv):
                    ufn = np.minimum if fn == "min" else np.maximum
                    ufn.at(ext, mcodes, mv)
                if tv.is_int:
                    vals = [None if cnt[i] == 0 else int(ext[i])
                            for i in range(u)]
                else:
                    vals = [None if cnt[i] == 0 else float(ext[i])
                            for i in range(u)]
                agg_lists.append(vals)
            else:  # stdev / stdevp
                s = np.bincount(mcodes, minlength=u, weights=mv)
                sq = np.bincount(mcodes, minlength=u, weights=mv * mv)
                n_ = np.maximum(cnt, 1)
                m2 = np.maximum(0.0, sq - s * s / n_)
                denom = np.maximum(cnt - 1, 1) if fn == "stdev" else n_
                sd = np.sqrt(m2 / denom).tolist()
                agg_lists.append([0.0 if cnt[i] < 2 else sd[i]
                                  for i in range(u)])
        rt.charge_mem(64 * u * (len(key_lists) + len(agg_lists)))

        out = []
        for lo in range(0, u, BATCH_SIZE):
            hi = min(lo + BATCH_SIZE, u)
            cols = {}
            for (e, slot, _), vals in zip(self.group_items, key_lists):
                cols[slot] = _typed_values_col(vals[lo:hi])
            for (fn, _, _, _, slot), vals in zip(self.agg_items, agg_lists):
                cols[slot] = _typed_values_col(vals[lo:hi])
            out.append(Batch(hi - lo, cols))
        return out

    def _device_partials(self, codes, u, atvs, n, device):
        """Per-group partials with the group-partials kernel (K2) on the
        store's device — ONE launch per aggregate over the whole
        super-batch (SURVEY §7.4 device aggregation; reference CPU
        analogue ops/aggregate.rs)."""
        codes_t = host_tensor(codes.astype(np.int32), device)
        parts = []
        for (fn, _, arg, _, _), tv in zip(self.agg_items, atvs):
            if arg is None:  # count(*): every row counts
                cnt, _ = group_partials(codes_t, None, None, u, "count")
                parts.append(("count", cnt.cpu().numpy()))
                continue
            mask_t = host_tensor(~tv.null, device)
            if fn == "count":
                cnt, _ = group_partials(codes_t, None, mask_t, u, "count")
                parts.append(("count", cnt.cpu().numpy()))
                continue
            op = "sum" if fn in ("sum", "avg") else fn
            cnt, acc = group_partials(
                codes_t, host_tensor(tv.vals.astype(np.float64), device),
                mask_t, u, op)
            parts.append((op, cnt.cpu().numpy(), acc.cpu().numpy(),
                          tv.is_int))
        return parts

    def _host_partials(self, codes, u, atvs):
        # per-group partials
        parts = []
        for (fn, _, arg, _, _), tv in zip(self.agg_items, atvs):
            if arg is None:  # count(*)
                parts.append(("count", np.bincount(codes, minlength=u)))
                continue
            mask = ~tv.null
            mcodes = codes[mask]
            cnt = np.bincount(mcodes, minlength=u)
            if fn == "count":
                parts.append(("count", cnt))
            elif fn in ("sum", "avg"):
                s = np.bincount(mcodes, minlength=u,
                                weights=tv.vals[mask]) if tv.vals is not None \
                    else np.zeros(u)
                parts.append(("sum", cnt, s, tv.is_int))
            elif fn in ("stdev", "stdevp"):
                if tv.vals is not None:
                    mv = tv.vals[mask]
                    s = np.bincount(mcodes, minlength=u, weights=mv)
                    sq = np.bincount(mcodes, minlength=u, weights=mv * mv)
                else:
                    s = sq = np.zeros(u)
                parts.append(("stdev", cnt, s, sq))
            else:  # min / max
                ext = np.full(u, np.inf if fn == "min" else -np.inf)
                if tv.vals is not None and mask.any():
                    ufn = np.minimum if fn == "min" else np.maximum
                    ufn.at(ext, mcodes, tv.vals[mask])
                parts.append((fn, cnt, ext, tv.is_int))
        return parts

    @staticmethod
    def _tv_value(tv, row, ctx):
        from falkordb_tpu_torch.runtime import vectorized as V

        if tv.kind == V.NULLK or tv.null[row]:
            return None
        if tv.orig is not None:
            return tv.orig[row]
        v = tv.vals[row]
        if tv.kind == V.NUM:
            return int(v) if tv.is_int else float(v)
        if tv.kind == V.STR:
            return str(v)
        if tv.kind == V.BOOL:
            return bool(v)
        if tv.kind == V.NODE:
            return ctx.node_value(int(v))
        return ctx.edge_value(int(v))

    @staticmethod
    def _merge_partial(st, p, g):
        kind = p[0]
        if kind == "count":
            st["count"] += int(p[1][g])
            return
        cnt = int(p[1][g])
        if cnt == 0:
            return
        st["count"] += cnt
        if kind == "sum":
            # sum()/avg() accumulate and report in double precision
            # (TCK Set6/Remove3: sum over integers returns 20.0)
            st["sum"] += float(p[2][g])
        elif kind == "min":
            v = int(p[2][g]) if p[3] else float(p[2][g])
            if st["min"] is None or order_key(v) < order_key(st["min"]):
                st["min"] = v
        elif kind == "max":
            v = int(p[2][g]) if p[3] else float(p[2][g])
            if st["max"] is None or order_key(v) > order_key(st["max"]):
                st["max"] = v
        elif kind == "stdev":
            # Chan's parallel variance combine: partial (n2, mean2, m2_2)
            # folds into the running Welford state exactly like a batch
            n2 = cnt
            s, sq = float(p[2][g]), float(p[3][g])
            mean2 = s / n2
            m2_2 = max(0.0, sq - s * s / n2)
            n1 = st.get("count_", 0)
            if n1 == 0:
                st["count_"], st["mean"], st["m2"] = n2, mean2, m2_2
            else:
                tot = n1 + n2
                delta = mean2 - st["mean"]
                st["mean"] += delta * n2 / tot
                st["m2"] += m2_2 + delta * delta * n1 * n2 / tot
                st["count_"] = tot

    def run(self, rt):
        groups: dict = {}
        order: list = []
        vec_ok = all(fn in self._VEC_AGGS and not distinct and not extra
                     for fn, distinct, _, extra, _ in self.agg_items)
        # the one-shot path additionally covers count(DISTINCT x) and the
        # percentiles (they need the whole input at once anyway)
        oneshot_ok = all(
            (fn in self._VEC_AGGS and not distinct and not extra)
            or (fn == "count" and distinct and arg is not None and not extra)
            or (fn == "collect" and not distinct and arg is not None
                and not extra)
            or (fn in ("percentiledisc", "percentilecont")
                and not distinct and len(extra) == 1)
            for fn, distinct, arg, extra, _ in self.agg_items)
        # super-batching: the vectorized path concatenates streamed
        # 1K-row batches into device-sized blocks so the group reduce can
        # run as ONE segment op per aggregate (SURVEY §7.4: aggregation on
        # device; reference analogue ops/aggregate.rs batched grouping)
        block = _device_agg_block() if (vec_ok or oneshot_ok) else 0
        buf: list = []
        buf_n = 0

        def consume(b):
            nonlocal buf, buf_n
            if vec_ok and self._vec_batch(b, rt, groups, order):
                self.vec_rows += b.n
                return
            self._row_batch(b, rt, groups, order)

        # one-shot path: when the whole input fits one super-batch AND
        # every key/agg typifies, the per-GROUP python merge (the u-sized
        # loop + state dicts) is skipped entirely — codes/partials go
        # straight to output columns.  High-cardinality GROUP BY (u ~ n)
        # is otherwise python-bound (LDBC agg_posts_per_creator: one dict
        # merge per group).
        oneshot_max = int(__import__("os").environ.get(
            "FALKOR_AGG_ONESHOT_MAX", 4 << 20))
        overflowed = not oneshot_ok
        for b in self.child.run(rt):
            rt.check_timeout()
            if block and b.n:
                buf.append(b)
                buf_n += b.n
                rt.charge_batch(b)
                if buf_n >= (oneshot_max if not overflowed else block):
                    overflowed = True
                    consume(buf[0] if len(buf) == 1 else Batch.concat(buf))
                    buf, buf_n = [], 0
                continue
            if b.n or not vec_ok:
                overflowed = True
                consume(b)
        if buf:
            big = buf[0] if len(buf) == 1 else Batch.concat(buf)
            if not overflowed and not groups:
                out = self._vec_oneshot(big, rt)
                if out is not None:
                    self.vec_rows += big.n
                    yield from out
                    return
            consume(big)
        yield from self._finalize(rt, groups, order)

    def _row_batch(self, b, rt, groups, order):
        gcols = [rt.ctx.materialize(evaluate(e, b, rt.ctx))
                 for e, _, _ in self.group_items]
        acols = []
        for fn, distinct, arg, extra, _ in self.agg_items:
            if arg is None:
                acols.append(None)
            else:
                acols.append(rt.ctx.materialize(evaluate(arg, b, rt.ctx)))
        ecols = []
        for fn, distinct, arg, extra, _ in self.agg_items:
            ecols.append([
                rt.ctx.materialize(evaluate(x, b, rt.ctx)) for x in extra
            ])
        for i in range(b.n):
            key = tuple(_hashable(g[i]) for g in gcols)
            st = groups.get(key)
            if st is None:
                st = ([g[i] for g in gcols],
                      [_agg_new(fn, d) for fn, d, _, _, _ in self.agg_items])
                groups[key] = st
                order.append(key)
                rt.charge_mem(128 + 64 * len(self.agg_items))
            for j, (fn, distinct, arg, extra, _) in enumerate(self.agg_items):
                v = acols[j][i] if acols[j] is not None else None
                ev = [c[i] for c in ecols[j]]
                _agg_step(st[1][j], fn, v, ev, arg is not None)

    def _finalize(self, rt, groups, order):
        if not self.group_items and not groups:
            # global aggregation over zero rows still yields one row
            key = ()
            groups[key] = ([], [_agg_new(fn, d)
                                for fn, d, _, _, _ in self.agg_items])
            order.append(key)
        out_rows = []
        for key in order:
            gvals, states = groups[key]
            row = {}
            for (e, slot, _), v in zip(self.group_items, gvals):
                row[slot] = v
            for (fn, _, _, _, slot), st in zip(self.agg_items, states):
                row[slot] = _agg_final(st, fn)
            out_rows.append(row)
        for lo in range(0, len(out_rows), BATCH_SIZE):
            chunk = out_rows[lo : lo + BATCH_SIZE]
            cols = {}
            slots = set()
            for r in chunk:
                slots.update(r)
            for s in slots:
                cols[s] = Column.values([r.get(s) for r in chunk])
            yield Batch(len(chunk), cols)


def _hashable(v):
    try:
        hash(v)
        return v
    except TypeError:
        if isinstance(v, list):
            return ("__list__",) + tuple(_hashable(x) for x in v)
        if isinstance(v, dict):
            return ("__map__",) + tuple(sorted(
                (k, _hashable(x)) for k, x in v.items()))
        return str(v)


def _typed_values_col(vals) -> Column:
    """Column.values + a cheap exact typed view (one C-speed type scan),
    so downstream ORDER BY/DISTINCT skip the per-element re-typify walk
    on aggregate outputs (LDBC agg_posts_per_creator: 2x 295K-element
    isinstance scans were half the query)."""
    from falkordb_tpu_torch.runtime import vectorized as V

    col = Column.values(vals)
    if len(vals) >= 32:
        tv = V.fast_items_tv(vals)
        if tv is not None:
            col._tv = tv
    return col


def _distinct_counts(codes, tv, u, n):
    """Per-group count of distinct non-null typed values (one sort over
    (group, value) pairs — the one-shot path's count(DISTINCT x))."""
    from falkordb_tpu_torch.runtime import vectorized as V

    if tv.kind == V.NULLK:
        return np.zeros(u, dtype=np.int64)
    if tv.kind == V.NUM:
        v = np.where(tv.vals == 0.0, 0.0, tv.vals)  # -0.0 == +0.0
        bits = v.view(np.int64).copy()
    elif tv.kind == V.STR:
        _, bits = np.unique(tv.vals.astype(str), return_inverse=True)
        bits = bits.astype(np.int64)
    else:  # BOOL
        bits = tv.vals.astype(np.int64)
    mask = ~tv.null
    c, v = codes[mask], bits[mask]
    if len(c) == 0:
        return np.zeros(u, dtype=np.int64)
    # typed lexsort + adjacent-dedup (void-record unique sorts with the
    # generic comparator — 100x slower; same fix as group_codes r4)
    order = np.lexsort((v, c))
    sc, sv = c[order], v[order]
    newgrp = np.empty(len(sc), dtype=bool)
    newgrp[0] = True
    newgrp[1:] = (sc[1:] != sc[:-1]) | (sv[1:] != sv[:-1])
    return np.bincount(sc[newgrp], minlength=u)


def _agg_new(fn, distinct):
    return {"fn": fn, "distinct": distinct, "seen": set() if distinct else None,
            "count": 0, "sum": 0, "vals": [], "min": None, "max": None,
            "m2": 0.0, "mean": 0.0}


def _agg_step(st, fn, v, extra, has_arg):
    if fn == "count" and not has_arg:
        st["count"] += 1
        return
    if v is None:
        return
    if st["distinct"]:
        h = _hashable(v)
        if h in st["seen"]:
            return
        st["seen"].add(h)
    st["count"] += 1
    if fn == "sum":
        st["sum"] += v
    elif fn == "avg":
        st["sum"] += v
    elif fn in ("stdev", "stdevp"):
        st["count_"] = st.get("count_", 0) + 1
        d = v - st["mean"]
        st["mean"] += d / st["count_"]
        st["m2"] += d * (v - st["mean"])
    elif fn == "min":
        if st["min"] is None or (order_key(v) < order_key(st["min"])):
            st["min"] = v
    elif fn == "max":
        if st["max"] is None or (order_key(v) > order_key(st["max"])):
            st["max"] = v
    elif fn == "collect":
        st["vals"].append(v)
    elif fn in ("percentiledisc", "percentilecont"):
        st["vals"].append(v)
        if extra:
            p = extra[0]
            # percentile must be a number in [0, 1] (TCK Aggregation6
            # [3]-[5]: InvalidArgumentValue at runtime)
            if isinstance(p, bool) or not isinstance(p, (int, float)) or \
                    not (0.0 <= p <= 1.0):
                raise EvalError(
                    f"percentile must be a number in [0, 1], got {p!r}")
            st["pct"] = p


def _agg_final(st, fn):
    if fn == "count":
        return st["count"]
    if fn == "sum":
        # double-precision result for numeric sums (durations keep type)
        return float(st["sum"]) if isinstance(st["sum"], int) else st["sum"]
    if fn == "avg":
        return st["sum"] / st["count"] if st["count"] else None
    if fn == "min":
        return st["min"]
    if fn == "max":
        return st["max"]
    if fn == "collect":
        return st["vals"]
    if fn in ("stdev", "stdevp"):
        n = st.get("count_", 0)
        if n < 2:
            return 0.0
        denom = (n - 1) if fn == "stdev" else n
        return (st["m2"] / denom) ** 0.5
    if fn in ("percentiledisc", "percentilecont"):
        vals = sorted(st["vals"])
        if not vals:
            return None
        p = st.get("pct", 0.5)
        if fn == "percentiledisc":
            import math as _m
            idx = max(0, min(len(vals) - 1, _m.ceil(p * len(vals)) - 1))
            return vals[idx]
        pos = p * (len(vals) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(vals) - 1)
        frac = pos - lo
        return vals[lo] * (1 - frac) + vals[hi] * frac
    raise EvalError(f"unknown aggregate {fn}")


# -- K3: top-k ---------------------------------------------------------------

TOPK_MAX_K = 4096  # the largest LIMIT the device path takes


def topk_smallest(c, k: int):
    """Indices of the k smallest entries of c, smallest first, ties to the
    lower index (kernel K3, csrc/topk.cu; replaces falkordb_tpu's
    lax.top_k(-c, k) in Sort._device_topk).

    c (n,) float64 without NaN (±inf allowed), 1 <= k <= min(n, 4096).
    Returns (k,) int64.  -0.0 and +0.0 compare equal, as in a lexsort.
    CPU tensors run `topk_smallest_plain`; CUDA tensors launch the
    kernel."""
    n = c.numel()
    if not 1 <= k <= min(n, TOPK_MAX_K):
        raise ValueError(f"topk_smallest: k={k} outside [1, min(n={n}, "
                         f"{TOPK_MAX_K})]")
    if not _cuda.on_cuda(c):
        return topk_smallest_plain(c, k)
    _cuda.check_input("topk_smallest", "c", c, torch.float64, n)
    scratch = torch.empty(topk_scratch_bytes(n, k), dtype=torch.uint8,
                          device=c.device)
    out = torch.empty(k, dtype=torch.int64, device=c.device)
    p = _cuda.ptr
    rc = _cuda.lib().fk_topk(p(c), n, k, p(scratch), scratch.numel(), p(out),
                             _cuda.stream_ptr(c))
    _cuda.check(rc, "topk")
    _cuda.count_launch("topk")
    return out


def topk_scratch_bytes(n: int, k: int) -> int:
    """Bytes of K3's scratch (csrc/topk.cu): the select's state and six
    2048-bin histograms, two int64 counts and offsets per 4096 keys, and
    the k survivors' (key, index) pairs."""
    return 256 + 6 * 2048 * 4 + 32 * -(-n // 4096) + 16 * k


def topk_smallest_plain(c, k: int):
    """Plain PyTorch version of `topk_smallest`: a stable sort."""
    return torch.sort(c, stable=True).indices[:k]


class Sort(Op):
    name = "Sort"

    def __init__(self, child, keys, limit=None):
        super().__init__(child)
        self.keys = keys  # [(expr, asc)]
        self.limit = limit  # top-k aware (ops/sort.rs)

    def describe(self):
        return "Sort" + (f" (top {self.limit})" if self.limit else "")

    def _vec_sort(self, all_b, rt):
        """lexsort over typed key columns (None → per-row order_key path).
        Stable, so equal keys keep input order like the fallback."""
        from falkordb_tpu_torch.runtime import vectorized as V

        tvs = []
        for e, _ in self.keys:
            tv = V.eval_typed(e, all_b, rt.ctx)
            if tv is None:
                return None
            tvs.append(tv)
        sig = V.sort_keys(tvs, [asc for _, asc in self.keys])
        if sig is None:
            return None
        self.vec_rows += all_b.n
        if not sig:
            return np.arange(all_b.n)
        idx = self._device_topk(sig, all_b.n, rt.store.device)
        if idx is not None:
            return idx
        return np.lexsort(sig[::-1])  # lexsort: LAST array is primary

    def _device_topk(self, sig, n, device):
        """ORDER BY <single numeric key> LIMIT k with the top-k kernel (K3)
        on the store's device (SURVEY §7.4; the reference's heap-based
        top-k, ops/sort.rs).  Its ties break on the lower index, matching
        stable lexsort."""
        if (self.limit is None or not (0 < self.limit <= TOPK_MAX_K)
                or n < _device_agg_min() or len(sig) != 2):
            return None
        nullr, v = sig  # null-rank major, value minor (sort_keys layout)
        if not np.isfinite(v).all():
            return None  # ±inf/NaN collide with the null encoding
        # single combined key: nulls sort after (asc) / before (desc) all
        # finite values — sign of the null rank carries the direction
        c = np.where(nullr != 0.0, np.copysign(np.inf, nullr), v)
        k = min(self.limit, n)
        idx = topk_smallest(host_tensor(c.astype(np.float64), device), k)
        self.dev_rows += n
        return idx.cpu().numpy()

    def run(self, rt):
        batches = []
        for b in self.child.run(rt):
            rt.charge_batch(b)  # sort buffers its whole input
            batches.append(b)
        if not batches:
            return
        all_b = Batch.concat(batches)
        idx = self._vec_sort(all_b, rt)
        if idx is None:
            keycols = [rt.ctx.materialize(evaluate(e, all_b, rt.ctx))
                       for e, _ in self.keys]
            idx = list(range(all_b.n))

            def key_of(i):
                ks = []
                for (e, asc), col in zip(self.keys, keycols):
                    k = order_key(col[i])
                    ks.append(k if asc else _Rev(k))
                return tuple(ks)

            idx.sort(key=key_of)
        if self.limit is not None:
            idx = idx[: self.limit]
        out = all_b.take(np.asarray(idx, dtype=np.int64))
        for lo in range(0, out.n, BATCH_SIZE):
            yield out.take(np.arange(lo, min(lo + BATCH_SIZE, out.n)))


class _Rev:
    __slots__ = ("k",)

    def __init__(self, k):
        self.k = k

    def __lt__(self, other):
        return other.k < self.k

    def __eq__(self, other):
        return other.k == self.k


class Skip(Op):
    name = "Skip"

    def __init__(self, child, expr):
        super().__init__(child)
        self.expr = expr

    def run(self, rt):
        n = _int_of(self.expr, rt)
        skipped = 0
        for b in self.child.run(rt):
            if skipped + b.n <= n:
                skipped += b.n
                continue
            start = max(0, n - skipped)
            skipped += b.n
            if start:
                yield b.take(np.arange(start, b.n))
            else:
                yield b


class Limit(Op):
    name = "Limit"

    def __init__(self, child, expr):
        super().__init__(child)
        self.expr = expr

    def run(self, rt):
        n = _int_of(self.expr, rt)
        left = n
        if left <= 0:
            return
        for b in self.child.run(rt):
            if b.n <= left:
                yield b
                left -= b.n
            else:
                yield b.take(np.arange(left))
                left = 0
            if left == 0:
                return


def _int_of(expr, rt):
    from falkordb_tpu_torch.runtime.eval import evaluate as _ev

    v = rt.ctx.materialize(_ev(expr, Batch.unit(), rt.ctx))[0]
    if not isinstance(v, (int, np.integer)) or isinstance(v, bool) or v < 0:
        raise EvalError("SKIP/LIMIT must be a non-negative integer")
    return int(v)


class Distinct(Op):
    name = "Distinct"

    def __init__(self, child, slots):
        super().__init__(child)
        self.slots = slots

    def _vec_keep(self, b, seen):
        """Vectorized per-batch dedup: group codes collapse the batch to its
        unique rows; only those touch the Python `seen` set."""
        from falkordb_tpu_torch.runtime import vectorized as V

        slots = [s for s in self.slots if s in b.cols]
        tvs = []
        for s in slots:
            tv = V.typed_view_of_column(b.cols[s])
            if tv is None:
                return None
            tvs.append(tv)
        codes, first = V.group_codes(tvs)
        keep = []
        for row in first:
            i = int(row)
            key = tuple(
                (s, _hashable(b.cols[s].data[i])
                 if b.cols[s].kind == "value" else int(b.cols[s].ids[i]))
                for s in slots)
            if key not in seen:
                seen.add(key)
                keep.append(i)
        keep.sort()
        return keep

    def run(self, rt):
        seen = set()
        for b in self.child.run(rt):
            rt.check_timeout()
            keep = self._vec_keep(b, seen)
            if keep is not None:
                self.vec_rows += b.n
            else:
                keep = []
                mats = {s: (b.cols[s].ids if b.cols[s].kind != "value"
                            else b.cols[s].data)
                        for s in self.slots if s in b.cols}
                for i in range(b.n):
                    key = tuple(
                        (s, _hashable(mats[s][i]) if b.cols[s].kind == "value"
                         else int(mats[s][i]))
                        for s in self.slots if s in b.cols
                    )
                    if key not in seen:
                        seen.add(key)
                        keep.append(i)
            if keep:
                yield b.take(np.asarray(keep))


class CartesianProduct(Op):
    name = "CartesianProduct"

    def __init__(self, left, right):
        super().__init__(left)
        self.right = right

    def children(self):
        return [self.child, self.right]

    def describe(self):
        return "Cartesian Product"

    def run(self, rt):
        rights = list(self.right.run(rt))
        if not rights:
            return
        rb = Batch.concat(rights)
        for lb in self.child.run(rt):
            rt.check_timeout()
            for li in range(lb.n):
                lrow = lb.take(np.full(rb.n, li, dtype=np.int64))
                merged = dict(rb.cols)
                merged.update(lrow.cols)
                yield Batch(rb.n, merged)


class ValueHashJoin(Op):
    """Hash join on expression equality (ops/value_hash_join.rs)."""

    name = "ValueHashJoin"

    def __init__(self, left, right, left_expr, right_expr):
        super().__init__(left)
        self.right = right
        self.left_expr = left_expr
        self.right_expr = right_expr

    def children(self):
        return [self.child, self.right]

    def describe(self):
        return "Value Hash Join"

    def run(self, rt):
        table: dict = {}
        rights = list(self.right.run(rt))
        if not rights:
            return
        rb = Batch.concat(rights)
        rkeys = rt.ctx.materialize(evaluate(self.right_expr, rb, rt.ctx))
        for i in range(rb.n):
            if rkeys[i] is None:
                continue
            table.setdefault(_hashable(rkeys[i]), []).append(i)
        for lb in self.child.run(rt):
            rt.check_timeout()
            lkeys = rt.ctx.materialize(evaluate(self.left_expr, lb, rt.ctx))
            lrows, rrows = [], []
            for i in range(lb.n):
                if lkeys[i] is None:
                    continue
                for j in table.get(_hashable(lkeys[i]), ()):
                    lrows.append(i)
                    rrows.append(j)
            if not lrows:
                continue
            lpart = lb.take(np.asarray(lrows))
            rpart = rb.take(np.asarray(rrows))
            merged = dict(rpart.cols)
            merged.update(lpart.cols)
            yield Batch(len(lrows), merged)


class Apply(Op):
    """Per-row nested subplan execution; used for OPTIONAL MATCH (general
    case), CALL {} subqueries, and MERGE lookups (ops/apply.rs)."""

    name = "Apply"

    def __init__(self, child, subplan_factory, optional=False,
                 null_slots=None):
        super().__init__(child)
        self.subplan_factory = subplan_factory
        self.optional = optional
        self.null_slots = null_slots or []

    def describe(self):
        return "Apply" + (" (optional)" if self.optional else "")

    def run(self, rt):
        for b in self.child.run(rt):
            rt.check_timeout()
            outs = []
            for i in range(b.n):
                row = b.take(np.asarray([i]))
                sub = self.subplan_factory(row)
                got = False
                for sb in sub.run(rt):
                    if sb.n:
                        got = True
                        outs.append(sb)
                if not got and self.optional:
                    r = row
                    for s in self.null_slots:
                        r = r.with_col(s, Column.values([None]))
                    outs.append(r)
            for o in outs:
                yield o


class SemiApply(Op):
    name = "SemiApply"

    def __init__(self, child, subplan_factory, anti=False):
        super().__init__(child)
        self.subplan_factory = subplan_factory
        self.anti = anti

    def describe(self):
        return ("Anti " if self.anti else "") + "Semi Apply"

    def run(self, rt):
        for b in self.child.run(rt):
            keep = []
            for i in range(b.n):
                row = b.take(np.asarray([i]))
                sub = self.subplan_factory(row)
                found = False
                for sb in sub.run(rt):
                    if sb.n:
                        found = True
                        break
                if found != self.anti:
                    keep.append(i)
            if keep:
                yield b.take(np.asarray(keep))


class BoundRows(Op):
    """Seed operator that replays a fixed batch (Apply's inner source)."""

    name = "Argument"

    def __init__(self, batch):
        super().__init__(None)
        self.batch = batch

    def run(self, rt):
        yield self.batch


# ------------------------------------------------------------------ mutations


class CreateOp(Op):
    name = "Create"

    def __init__(self, child, paths):
        super().__init__(child)
        self.paths = paths  # bound PatternPaths with slot annotations

    def describe(self):
        return "Create"

    def run(self, rt):
        g = rt.store
        for b in self.child.run(rt):
            rt.check_timeout()
            new_cols = {s: list(c.ids) if c.kind != "value" else None
                        for s, c in b.cols.items()}
            created_nodes: dict[int, list] = {}
            created_edges: dict[int, list] = {}
            for i in range(b.n):
                row = b.take(np.asarray([i]))
                for path in self.paths:
                    self._create_path(rt, g, path, row, i, b, created_nodes,
                                      created_edges)
            out = b
            for slot, ids in created_nodes.items():
                out = out.with_col(slot, Column.nodes(ids))
            for slot, ids in created_edges.items():
                out = out.with_col(slot, Column.edges(ids))
            yield out

    def _create_path(self, rt, g, path, row, i, b, created_nodes, created_edges):
        prev_node = None
        prev_rel = None
        node_ids = []
        for el in path.elements:
            if isinstance(el, A.NodePattern):
                slot = el._slot
                bound_nid = None
                if el._bound and slot in b.cols:
                    col = b.cols[slot]
                    if col.kind == "node":
                        bound_nid = int(col.ids[i])
                    elif col.kind == "value":
                        # node bound through a value projection, e.g.
                        # WITH nodeList[i] AS n1 CREATE (n1)-[:T]->(n2)
                        # (TCK Match4 [4])
                        v = col.data[i]
                        if isinstance(v, NodeVal):
                            bound_nid = v.id
                        elif v is None:
                            bound_nid = NULL_ID
                        else:
                            raise EvalError(
                                "CREATE endpoint must be a node")
                if bound_nid is not None:
                    nid = bound_nid
                    if nid == NULL_ID:
                        raise EvalError("cannot create relationship to null node")
                elif slot in created_nodes and created_nodes[slot][i] != NULL_ID:
                    # same var reused across paths within this CREATE row
                    nid = created_nodes[slot][i]
                else:
                    attrs = _eval_props(rt, el.props, row)
                    # labels added counts NAMES new to the graph (TCK diff)
                    n_new_labels = sum(1 for l in el.labels
                                       if g.schema.label_id(l) is None)
                    lids = [g.schema.label_id(l, create=True) for l in el.labels]
                    nid = g.create_node(lids, attrs)
                    if rt.record_effects:
                        from falkordb_tpu_torch.persist.effects import OP_CREATE_NODE
                        rt.effects.append((OP_CREATE_NODE, nid, list(el.labels),
                                           {g.schema.attrs.name(a): v
                                            for a, v in attrs.items()}))
                    rt.note_node_created(nid)
                    rt.stats["labels_added"] += n_new_labels
                    for aid in attrs:
                        rt.note_prop_write("node", nid, aid, ABSENT)
                    if slot is not None:
                        created_nodes.setdefault(slot, [NULL_ID] * b.n)[i] = nid
                node_ids.append(nid)
                if prev_rel is not None:
                    rel, src_id = prev_rel
                    s, d = (src_id, nid) if rel.direction != "in" else (nid, src_id)
                    attrs = _eval_props(rt, rel.props, row)
                    tid = g.schema.reltype_id(rel.types[0], create=True)
                    eid = g.create_edge(s, d, tid, attrs)
                    if rt.record_effects:
                        from falkordb_tpu_torch.persist.effects import OP_CREATE_EDGE
                        rt.effects.append((OP_CREATE_EDGE, eid, s, d,
                                           rel.types[0],
                                           {g.schema.attrs.name(a): v
                                            for a, v in attrs.items()}))
                    rt.note_edge_created(eid)
                    for aid in attrs:
                        rt.note_prop_write("edge", eid, aid, ABSENT)
                    if rel._slot is not None:
                        created_edges.setdefault(rel._slot, [NULL_ID] * b.n)[i] = eid
                    prev_rel = None
                prev_node = nid
            else:
                if not el.types or len(el.types) != 1:
                    raise EvalError("CREATE requires exactly one relationship type")
                if el.direction == "both":
                    raise EvalError("CREATE requires a directed relationship")
                prev_rel = (el, prev_node)


def _eval_props(rt, props_expr, row) -> dict[int, object]:
    if props_expr is None:
        return {}
    vals = rt.ctx.materialize(evaluate(props_expr, row, rt.ctx))[0]
    if vals is None:
        return {}
    if not isinstance(vals, dict):
        raise EvalError("properties must be a map")
    g = rt.store
    out = {}
    for k, v in vals.items():
        if v is None:
            continue
        out[g.schema.attr_id(k, create=True)] = _to_storable(v)
    return out


def _to_storable(v):
    import datetime as _dt

    from falkordb_tpu_torch.runtime.value import VectorF32, PointVal

    if isinstance(v, (bool, int, float, str, PointVal, VectorF32)):
        return v
    # temporal properties (TCK Temporal5: dates/times are storable values;
    # reference Value::Datetime/Date/Time/Duration, runtime/value.rs:180)
    if isinstance(v, (_dt.date, _dt.datetime, _dt.time, _dt.timedelta)):
        return v
    if isinstance(v, (list, tuple)):
        return [_to_storable(x) for x in v]
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    raise EvalError(f"cannot store value of type {type(v).__name__}")


def _prop_eq(a, b):
    """Strict stored-value equality (type-sensitive: 42 != 42.0) for
    graph-state-diff side-effect accounting."""
    if type(a) is not type(b):
        return False
    try:
        if isinstance(a, np.ndarray):
            return a.shape == b.shape and bool((a == b).all())
        if isinstance(a, list):
            return len(a) == len(b) and all(_prop_eq(x, y)
                                            for x, y in zip(a, b))
        return bool(a == b)
    except Exception:
        return False


class DeleteOp(Op):
    name = "Delete"

    def __init__(self, child, exprs, detach):
        super().__init__(child)
        self.exprs = exprs
        self.detach = detach

    def describe(self):
        return "Delete"

    def run(self, rt):
        g = rt.store
        for b in self.child.run(rt):
            rt.check_timeout()
            # collect all targets of this batch first, then delete edges
            # before nodes: a node is deletable when every one of its
            # relationships dies in the same DELETE (TCK Delete5 [7]:
            # DELETE path1, path2 where the paths cover each other's edges)
            edge_ids: list[int] = []
            node_ids: list[int] = []
            for e in self.exprs:
                col = evaluate(e, b, rt.ctx)
                if col.kind == "node":
                    node_ids.extend(int(nid) for nid in col.ids)
                elif col.kind == "edge":
                    edge_ids.extend(int(eid) for eid in col.ids
                                    if eid != NULL_ID)
                else:
                    for v in col.data:
                        if v is None:
                            continue
                        if isinstance(v, NodeVal):
                            node_ids.append(v.id)
                        elif isinstance(v, EdgeVal):
                            edge_ids.append(v.id)
                        elif isinstance(v, PathVal):
                            edge_ids.extend(ev.id for ev in v.edges)
                            node_ids.extend(nv.id for nv in v.nodes)
                        else:
                            raise EvalError(
                                "DELETE expects nodes/relationships/paths")
            for eid in edge_ids:
                if g.delete_edge(eid):
                    rt.note_edge_deleted(eid)
                    if rt.record_effects:
                        from falkordb_tpu_torch.persist.effects import OP_DELETE_EDGE
                        rt.effects.append((OP_DELETE_EDGE, eid))
            live_nids = [nid for nid in dict.fromkeys(node_ids)
                         if nid != NULL_ID and nid < g.node_cap
                         and g.node_exists[nid]]
            if len(live_nids) > 1:
                # batched incident-edge sweep: ONE edge-array pass for
                # the whole delete set instead of O(m) per node
                edges = g.nodes_edges(live_nids)
                if len(edges) and not self.detach:
                    raise EvalError("cannot delete node with "
                                    "relationships; use DETACH DELETE")
                for eid in edges:
                    if g.delete_edge(int(eid)):
                        rt.note_edge_deleted(int(eid))
                        if rt.record_effects:
                            from falkordb_tpu_torch.persist.effects import \
                                OP_DELETE_EDGE
                            rt.effects.append((OP_DELETE_EDGE, int(eid)))
                for nid in live_nids:
                    if g.delete_node(nid):
                        rt.note_node_deleted(nid)
                        if rt.record_effects:
                            from falkordb_tpu_torch.persist.effects import \
                                OP_DELETE_NODE
                            rt.effects.append((OP_DELETE_NODE, nid))
            else:
                for nid in live_nids:
                    self._delete_node(rt, g, nid)
            yield b

    def _delete_node(self, rt, g, nid):
        if nid == NULL_ID or not (nid < g.node_cap and g.node_exists[nid]):
            return
        edges = g.node_edges(nid)
        if len(edges) and not self.detach:
            raise EvalError(
                "cannot delete node with relationships; use DETACH DELETE")
        for eid in edges:
            if g.delete_edge(int(eid)):
                rt.note_edge_deleted(int(eid))
                if rt.record_effects:
                    from falkordb_tpu_torch.persist.effects import OP_DELETE_EDGE
                    rt.effects.append((OP_DELETE_EDGE, int(eid)))
        if g.delete_node(nid):
            rt.note_node_deleted(nid)
            if rt.record_effects:
                from falkordb_tpu_torch.persist.effects import OP_DELETE_NODE
                rt.effects.append((OP_DELETE_NODE, nid))


class SetOp(Op):
    name = "Update"

    def __init__(self, child, items):
        super().__init__(child)
        self.items = items

    def describe(self):
        return "Update"

    def run(self, rt):
        g = rt.store
        for b in self.child.run(rt):
            rt.check_timeout()
            for item in self.items:
                if item.op == "label":
                    col = evaluate(item.target, b, rt.ctx)
                    for lab in item.labels:
                        # `labels added` counts label NAMES new to the
                        # graph, not node-label assignments (TCK
                        # graph-state-diff semantics; the reference's
                        # labels_added does the same)
                        is_new = g.schema.label_id(lab) is None
                        lid = g.schema.label_id(lab, create=True)
                        added_any = False
                        for _, _, nid in self._iter_entities(col, rt):
                            if g.add_label(int(nid), lid):
                                added_any = True
                                if rt.record_effects:
                                    from falkordb_tpu_torch.persist.effects import OP_ADD_LABELS
                                    rt.effects.append((OP_ADD_LABELS, int(nid), [lab]))
                        if is_new and added_any:
                            rt.stats["labels_added"] += 1
                elif item.op == "remove_label":
                    col = evaluate(item.target, b, rt.ctx)
                    for lab in item.labels:
                        lid = g.schema.label_id(lab)
                        if lid is None:
                            continue
                        had = g.label_counts.get(lid, 0) > 0
                        for _, _, nid in self._iter_entities(col, rt):
                            if g.remove_label(int(nid), lid):
                                if rt.record_effects:
                                    from falkordb_tpu_torch.persist.effects import OP_REMOVE_LABELS
                                    rt.effects.append((OP_REMOVE_LABELS, int(nid), [lab]))
                        # a label NAME is removed when its last carrier
                        # loses it (graph-state diff)
                        if had and g.label_counts.get(lid, 0) == 0:
                            rt.stats["labels_removed"] += 1
                elif item.op == "remove_prop":
                    self._set_prop(rt, g, item.target, b, None, remove=True)
                elif item.op in ("=", "+="):
                    if isinstance(item.target, A.Prop):
                        vals = rt.ctx.materialize(
                            evaluate(item.value, b, rt.ctx))
                        self._set_prop(rt, g, item.target, b, vals)
                    else:
                        # whole-entity SET n = {...} / n += {...}
                        col = evaluate(item.target, b, rt.ctx)
                        vals = rt.ctx.materialize(
                            evaluate(item.value, b, rt.ctx))
                        self._set_entity(rt, g, col, vals, item.op)
            yield b

    def _attr_store_for(self, g, col):
        return g.node_attrs if col.kind == "node" else g.edge_attrs

    @staticmethod
    def _iter_entities(col, rt):
        """(row, kind, entity_id) for each non-null target row.  Nulls are
        skipped silently — `OPTIONAL MATCH ... SET n.x = 1` with unmatched n
        is a no-op (TCK Set1 [8]/Remove1 [5]); a non-entity value errors."""
        if col.kind in ("node", "edge"):
            for i, ent in enumerate(col.ids):
                if ent != NULL_ID:
                    yield i, col.kind, int(ent)
            return
        data = rt.ctx.materialize(col)
        for i, v in enumerate(data):
            if v is None:
                continue
            if isinstance(v, NodeVal):
                yield i, "node", v.id
            elif isinstance(v, EdgeVal):
                yield i, "edge", v.id
            else:
                raise EvalError("SET target must be a node or relationship")

    def _set_prop(self, rt, g, target, b, vals, remove=False):
        col = evaluate(target.obj, b, rt.ctx)
        aid = g.schema.attr_id(target.key, create=True)
        for i, kind, ent in self._iter_entities(col, rt):
            store = g.node_attrs if kind == "node" else g.edge_attrs
            if remove or vals[i] is None:
                old = store.get(int(ent), aid)
                if store.set(int(ent), aid, ABSENT):
                    # removal via REMOVE or SET x = null; final counters
                    # come from the whole-query diff (finalize_stats)
                    rt.note_prop_write(kind, int(ent), aid, old)
                    if rt.record_effects:
                        from falkordb_tpu_torch.persist.effects import OP_SET_ATTR
                        rt.effects.append((OP_SET_ATTR, kind, int(ent),
                                           target.key, None))
            else:
                sv = _to_storable(vals[i])
                old = store.get(int(ent), aid)
                if old is not ABSENT and _prop_eq(old, sv):
                    continue  # graph state unchanged: no counters/effects
                store.set(int(ent), aid, sv)
                rt.note_prop_write(kind, int(ent), aid, old)
                if rt.record_effects:
                    from falkordb_tpu_torch.persist.effects import OP_SET_ATTR
                    rt.effects.append((OP_SET_ATTR, kind, int(ent),
                                       target.key, sv))
        g._invalidate()

    def _set_entity(self, rt, g, col, vals, op):
        for i, kind, ent in self._iter_entities(col, rt):
            store = g.node_attrs if kind == "node" else g.edge_attrs
            m = vals[i]
            if m is None:
                continue
            if isinstance(m, (NodeVal, EdgeVal)):
                m = m.properties
            if not isinstance(m, dict):
                raise EvalError("SET n = value expects a map")
            if op == "=":
                for aid, old in store.get_all(int(ent)).items():
                    rt.note_prop_write(kind, int(ent), aid, old)
                store.clear_entity(int(ent))
            for k, v in m.items():
                aid = g.schema.attr_id(k, create=True)
                old = store.get(int(ent), aid)
                if v is None:
                    if store.set(int(ent), aid, ABSENT):
                        rt.note_prop_write(kind, int(ent), aid, old)
                else:
                    store.set(int(ent), aid, _to_storable(v))
                    rt.note_prop_write(kind, int(ent), aid, old)


class MergeOp(Op):
    """MERGE: per-row match-or-create (ops/merge.rs)."""

    name = "Merge"

    def __init__(self, child, match_factory, create_op_factory,
                 on_create_items, on_match_items, merge_slots,
                 null_check=None):
        super().__init__(child)
        self.match_factory = match_factory
        self.create_op_factory = create_op_factory
        self.on_create_items = on_create_items
        self.on_match_items = on_match_items
        self.merge_slots = merge_slots
        self.null_check = null_check

    def describe(self):
        return "Merge"

    def run(self, rt):
        for b in self.child.run(rt):
            rt.check_timeout()
            for i in range(b.n):
                row = b.take(np.asarray([i]))
                if self.null_check is not None:
                    self.null_check(row, rt)
                sub = self.match_factory(row)
                matched = [sb for sb in sub.run(rt) if sb.n]
                if matched:
                    for m in matched:
                        if self.on_match_items:
                            for out in SetOp(BoundRows(m),
                                             self.on_match_items).run(rt):
                                yield out
                        else:
                            yield m
                else:
                    creator = self.create_op_factory(row)
                    for cb in creator.run(rt):
                        if self.on_create_items:
                            for out in SetOp(BoundRows(cb),
                                             self.on_create_items).run(rt):
                                yield out
                        else:
                            yield cb


class Foreach(Op):
    name = "Foreach"

    def __init__(self, child, var_slot, source_expr, update_factory):
        super().__init__(child)
        self.var_slot = var_slot
        self.source_expr = source_expr
        self.update_factory = update_factory

    def describe(self):
        return "Foreach"

    def run(self, rt):
        for b in self.child.run(rt):
            rt.check_timeout()
            vals = rt.ctx.materialize(evaluate(self.source_expr, b, rt.ctx))
            for i in range(b.n):
                lst = vals[i]
                if lst is None:
                    continue
                if not isinstance(lst, (list, tuple)):
                    raise EvalError("FOREACH expects a list")
                for item in lst:
                    row = b.take(np.asarray([i]))
                    row = row.with_col(self.var_slot, Column.values([item]))
                    sub = self.update_factory(row)
                    for _ in sub.run(rt):
                        pass
            yield b


class ProcedureCall(Op):
    name = "ProcedureCall"

    def __init__(self, child, proc, args, yield_slots):
        super().__init__(child)
        self.proc = proc
        self.args = args
        self.yield_slots = yield_slots  # [(yield_name, slot)]

    def describe(self):
        return f"ProcedureCall | {self.proc}"

    def run(self, rt):
        from falkordb_tpu_torch.runtime.procedures import PROCEDURES

        proc = PROCEDURES.get(self.proc)
        if proc is None:
            raise EvalError(f"unknown procedure {self.proc}")
        for b in self.child.run(rt):
            rt.check_timeout()
            for i in range(b.n):
                row = b.take(np.asarray([i]))
                argvals = [rt.ctx.materialize(evaluate(a, row, rt.ctx))[0]
                           for a in self.args]
                rows = []
                for rec in proc(rt, *argvals):
                    rows.append(rec)
                    if len(rows) >= BATCH_SIZE:
                        yield self._emit(row, rows)
                        rows = []
                if rows:
                    yield self._emit(row, rows)

    def _emit(self, row, rows):
        n = len(rows)
        out = row.take(np.zeros(n, dtype=np.int64))
        for name, slot in self.yield_slots:
            out = out.with_col(slot, Column.values([r.get(name) for r in rows]))
        return out


class PathBuild(Op):
    """Materialize named paths p = (...) after pattern ops ran
    (ops/path_builder.rs)."""

    name = "PathBuild"

    def __init__(self, child, path_slot, element_slots):
        super().__init__(child)
        self.path_slot = path_slot
        self.element_slots = element_slots  # [(kind, slot)] alternating

    def run(self, rt):
        for b in self.child.run(rt):
            vals = []
            for i in range(b.n):
                nodes, edges = [], []
                prev_node = None
                for kind, slot in self.element_slots:
                    col = b.cols.get(slot)
                    if col is None:
                        nodes = None
                        break
                    if kind == "node":
                        v = (rt.ctx.node_value(int(col.ids[i]))
                             if col.kind == "node"
                             else col.data[i])
                        nodes.append(v)
                        prev_node = v
                    else:
                        if col.kind == "edge":
                            edges.append(rt.ctx.edge_value(int(col.ids[i])))
                        else:
                            ev = col.data[i]
                            if isinstance(ev, list):
                                edges.extend(ev)
                            elif ev is not None:
                                edges.append(ev)
                if nodes is None or any(v is None for v in nodes):
                    vals.append(None)
                else:
                    vals.append(_assemble_path(nodes, edges, rt.ctx))
            yield b.with_col(self.path_slot, Column.values(vals))


def _assemble_path(nodes, edges, ctx):
    # re-walk edge endpoints so var-len segments expand node chains correctly
    if not edges:
        # zero-length paths have exactly ONE node: (a)-[*0..]->(b) binds a
        # and b to the same node, but both pattern elements contribute a
        # slot (TCK Quantifier3 [8]: tail(nodes(p)) of a *0 match is [])
        return PathVal(nodes[:1], [])
    full_nodes = [nodes[0]]
    cur = nodes[0].id
    for e in edges:
        nxt = e.dst_node if e.src_node == cur else e.src_node
        # materialize through the context: interior var-len nodes carry
        # labels/properties too (TCK Quantifier1 [8] inspects them)
        full_nodes.append(ctx.node_value(nxt))
        cur = nxt
    # prefer already-materialized node values where we have them
    by_id = {n.id: n for n in nodes if n is not None}
    full_nodes = [by_id.get(n.id, n) for n in full_nodes]
    return PathVal(full_nodes, edges)


class Results(Op):
    """Root emitter: fixes output column order (batched_result_emitter.rs)."""

    name = "Results"

    def __init__(self, child, columns):
        super().__init__(child)
        self.columns = columns  # [(slot, name)]

    def describe(self):
        return "Results"

    def run(self, rt):
        for b in self.child.run(rt):
            yield b
