"""GraphCore — per-graph query execution engine.

The reference's graph_core.rs re-imagined without Redis: reads run on the
current immutable GraphStore snapshot; writes fork the store, run, and
commit by pointer swap (MVCC collapses to functional snapshots,
mvcc_graph.rs:68→fork()).  Plan cache keyed by query text, invalidated on
schema version change (graph.rs:1095)."""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from falkordb_tpu_torch.api import QueryResult
from falkordb_tpu_torch.graph import GraphStore
from falkordb_tpu_torch.lang import parse
from falkordb_tpu_torch.lang.planner import PlannedQuery, plan_query, PlanError
from falkordb_tpu_torch.runtime.batch import Batch, NULL_ID
from falkordb_tpu_torch.runtime.ops import Runtime, QueryTimeout


@dataclass
class GlobalConfig:
    """Module configuration (src/config.rs:44-83 equivalents)."""

    cache_size: int = 25
    timeout_default_ms: int = 0
    timeout_max_ms: int = 0
    resultset_size: int = -1  # -1 = unlimited
    query_mem_capacity: int = 0
    delta_max_pending_changes: int = 10_000
    node_creation_buffer: int = 16_384
    effects_threshold_us: int = 300
    slowlog_max_entries: int = 10
    slowlog_min_latency_ms: float = 10.0
    vkey_max_entity_count: int = 100_000
    max_info_queries: int = 1_000
    telemetry_max_entries: int = 1_024
    max_queued_queries: int = 2**32 - 1  # write backpressure (config.rs:69)
    thread_count: int = 8  # server worker pool size (config.rs THREAD_COUNT)
    delay_indexing: bool = False  # background index population (config.rs)
    udf_timeout_ms: int = 3_000  # per-UDF-call wall budget (js_context.rs)


# functions whose value depends on when/where the query runs: such writes
# MUST replicate as concrete effects, never by replay (graph_core.rs:1465)
_NONDET_FNS = frozenset({
    "rand", "randomuuid", "timestamp", "datetime", "localdatetime",
    "date", "time", "localtime",
})


def _query_is_nondeterministic(text: str) -> bool:
    """Lexer-token scan (no false hits inside string literals)."""
    from falkordb_tpu_torch.lang.lexer import tokenize

    try:
        toks = tokenize(text)
    except Exception:  # noqa: BLE001 — parse errors surface later
        return False
    return any(
        t.kind in ("ident", "kw")
        and str(t.value).lower() in _NONDET_FNS
        and i + 1 < len(toks) and toks[i + 1].is_punct("(")
        for i, t in enumerate(toks))


class SlowLog:
    """Top-N slowest queries (src/slow_log.rs)."""

    def __init__(self, config: GlobalConfig):
        self.config = config
        self._entries: dict = {}

    def record(self, cmd: str, query: str, ms: float):
        if ms < self.config.slowlog_min_latency_ms:
            return
        key = (cmd, query)
        prev = self._entries.get(key)
        if prev is None or prev[1] < ms:
            self._entries[key] = (time.time(), ms)
        if len(self._entries) > self.config.slowlog_max_entries:
            victim = min(self._entries, key=lambda k: self._entries[k][1])
            del self._entries[victim]

    def entries(self):
        return sorted(
            ({"timestamp": t, "command": c, "query": q, "took_ms": ms}
             for (c, q), (t, ms) in self._entries.items()),
            key=lambda e: -e["took_ms"],
        )

    def reset(self):
        self._entries.clear()


class PlanCache:
    """LRU plan cache keyed on (query, schema_version) (graph.rs:1095)."""

    def __init__(self, cap: int):
        self.cap = cap
        self._lru: OrderedDict = OrderedDict()
        self._lock = threading.Lock()  # concurrent readers share this cache
        self.hits = 0
        self.misses = 0

    def get(self, key):
        with self._lock:
            v = self._lru.get(key)
            if v is not None:
                self._lru.move_to_end(key)
                self.hits += 1
            else:
                self.misses += 1
            return v

    def put(self, key, value):
        with self._lock:
            self._lru[key] = value
            self._lru.move_to_end(key)
            while len(self._lru) > self.cap:
                self._lru.popitem(last=False)

    def clear(self):
        with self._lock:
            self._lru.clear()


class GraphCore:
    def __init__(self, name: str, config: Optional[GlobalConfig] = None,
                 udfs=None, device=None):
        from falkordb_tpu_torch.api import resolve_device

        self.name = name
        self.config = config or GlobalConfig()
        self.udfs = udfs
        self.store = GraphStore(resolve_device(device))
        self.slowlog = SlowLog(self.config)
        self.plan_cache = PlanCache(self.config.cache_size)
        self.indexes = {}  # managed by falkordb_tpu_torch.index
        self.constraints: list = []
        self._write_lock = threading.Lock()
        self._pending_lock = threading.Lock()  # guards _write_pending
        self._write_pending = 0
        self.telemetry: list = []
        # replication consumers: handler(kind, payload) fed either binary
        # effect buffers or verbatim (text, params) pairs
        # (REPLICATION_CONSUMERS gate, src/graph_core.rs:360)
        self.replicas: list = []
        # append-only write log for crash recovery (AOF role); set via
        # attach_aof
        self.aof = None
        # GRAPH.INFO running-query registry (src/telemetry.rs registries)
        self._running: dict[int, dict] = {}
        self._running_lock = threading.Lock()
        self._query_seq = 0
        # ensure algorithm + index procedures are registered
        import falkordb_tpu_torch.algos.procedures  # noqa: F401
        import falkordb_tpu_torch.index.procedures  # noqa: F401

    # ------------------------------------------------------------------ query

    def _udf_lookup(self, name: str) -> bool:
        return (self.udfs is not None
                and self.udfs.lookup(name) is not None)

    def _plan(self, text: str) -> tuple:
        """Returns (ast, planned, utilized_cache)."""
        key = (text, self.store.schema.version,
               tuple(sorted(self.indexes.keys())),
               self.udfs.version if self.udfs is not None else 0)
        hit = self.plan_cache.get(key)
        if hit is not None:
            return hit[0], hit[1], True
        ast = parse(text)
        planned = plan_query(ast, indexes=self.indexes,
                             udf_lookup=self._udf_lookup,
                             stats=self._label_stats())
        planned.nondeterministic = _query_is_nondeterministic(text)
        self.plan_cache.put(key, (ast, planned))
        return ast, planned, False

    def _label_stats(self):
        """{label: (count, id)} snapshot for the reorder_labels pass."""
        st = self.store
        return {name: (st.label_counts.get(lid, 0), lid)
                for name, lid in st.schema.labels.ids.items()}

    def explain(self, text: str, params=None) -> str:
        _, planned, _ = self._plan(text)
        return planned.explain()

    def _instrumented_plan(self, text: str):
        """Fresh (uncached) plan with per-operator row/time counters wired
        in — PROFILE and GRAPH.RECORD run on this (profile_data capture,
        runtime.rs Runtime.profile_data)."""
        ast = parse(text)
        planned = plan_query(ast, indexes=self.indexes,
                             udf_lookup=self._udf_lookup,
                             stats=self._label_stats())
        node = planned
        while node is not None:
            for op, _ in _walk(node.root, 0):
                _instrument_op(op)
            node = node.union_next
        return ast, planned

    def query(self, text: str, params=None, timeout: Optional[int] = None,
              read_only: bool = False, profile: bool = False) -> QueryResult:
        t0 = time.monotonic()
        utilized_cache = False
        if profile:
            ast, planned = self._instrumented_plan(text)
        else:
            ast, planned, utilized_cache = self._plan(text)
        if ast.explain:
            return QueryResult(["plan"], [[l] for l in
                                          planned.explain().split("\n")], {})
        if ast.profile and not profile:
            profile = True
            ast, planned = self._instrumented_plan(text)
        all_params = dict(ast.params)
        if params:
            all_params.update(params)
        if planned.is_write and read_only:
            raise PlanError("graph.RO_QUERY is to be executed only on "
                            "read-only queries")
        deadline = None
        tmo = timeout if timeout is not None else self.config.timeout_default_ms
        if self.config.timeout_max_ms and (
                not tmo or tmo > self.config.timeout_max_ms):
            tmo = self.config.timeout_max_ms
        if tmo:
            deadline = time.monotonic() + tmo / 1000.0
        with self._running_lock:
            self._query_seq += 1
            qid = self._query_seq
            self._running[qid] = {
                "query": text, "stage": "executing",
                "received_at": time.time(), "write": planned.is_write,
            }
        try:
            return self._query_inner(planned, all_params, deadline, text,
                                     t0, profile, utilized_cache)
        except QueryTimeout:
            self._telemetry_add(text, (time.monotonic() - t0) * 1000.0,
                                planned.is_write, utilized_cache,
                                timed_out=True)
            raise
        finally:
            with self._running_lock:
                self._running.pop(qid, None)

    def _telemetry_add(self, text, ms, write, utilized_cache,
                       timed_out=False):
        """Per-query telemetry entry (src/telemetry.rs TelemetryEntry —
        the stream-XADD flusher collapses to a bounded in-process buffer;
        the server surfaces it as XRANGE telemetry{graph})."""
        self.telemetry.append({
            "received_at": time.time(),
            "query": text,
            "wait_duration_ms": 0.0,  # no queueing: writers lock inline
            "execution_duration_ms": ms,
            "report_duration_ms": 0.0,
            "utilized_cache": utilized_cache,
            "write": write,
            "timed_out": timed_out,
        })
        if len(self.telemetry) > self.config.telemetry_max_entries:
            del self.telemetry[: -self.config.telemetry_max_entries]

    def running_queries(self) -> list:
        with self._running_lock:
            return [dict(v) for v in self._running.values()]

    def _query_inner(self, planned, all_params, deadline, text, t0, profile,
                     utilized_cache=False):
        if planned.is_write:
            # MAX_QUEUED_QUERIES backpressure: writers line up on the
            # per-graph write lock; past the cap the query is rejected
            # rather than queued (src/graph_core.rs:863-883)
            with self._pending_lock:
                if self._write_pending >= self.config.max_queued_queries:
                    raise RuntimeError("Max pending queries exceeded")
                self._write_pending += 1
            try:
                return self._write_locked(planned, all_params, deadline,
                                          text, t0, profile, utilized_cache)
            finally:
                with self._pending_lock:
                    self._write_pending -= 1
        return self._read_path(planned, all_params, deadline, text, t0,
                               profile, utilized_cache)

    def _write_locked(self, planned, all_params, deadline, text, t0, profile,
                      utilized_cache):
        with self._write_lock:  # single writer per graph
            new_store = self.store.fork()
            rt = Runtime(new_store, all_params, deadline, write=True)
            rt.mem_capacity = self.config.query_mem_capacity
            rt.record_effects = bool(self.replicas) or self.aof is not None
            rt.ctx.udfs = self.udfs
            rt.indexes = self.indexes
            rt.constraints = self.constraints
            rt.core = self
            rows = self._execute(planned, rt)
            rt.finalize_stats()  # whole-query diff -> public counters
            self._apply_ddl(planned, rt)
            from falkordb_tpu_torch.index.constraints import enforce_after_write

            enforce_after_write(self, new_store)  # abort on violation
            new_store.flush()  # merge deltas between query batches
            self.store = new_store  # commit: atomic pointer swap
            self._reindex(rt)
            if rt.effects and (self.replicas or self.aof is not None):
                from falkordb_tpu_torch.persist.effects import encode_effects

                blob = encode_effects(rt.effects)
                elapsed_us = (time.monotonic() - t0) * 1e6
                use_effects = self._should_use_effects(planned, elapsed_us)
                for handler in self.replicas:
                    if use_effects:
                        handler("effects", blob)
                    else:
                        # payload carries the blob too so effects-only
                        # consumers never lose a verbatim-chosen write
                        handler("query", (text, all_params, blob))
                if self.aof is not None:
                    if use_effects:
                        self.aof.append_effects(blob)
                    else:
                        self.aof.append_query(text, all_params)
        return self._finish(planned, rt, rows, text, t0, utilized_cache,
                            profile)

    def _should_use_effects(self, planned, elapsed_us: float) -> bool:
        """Replication strategy choice (graph_core.rs:1465
        should_use_effects): nondeterministic writes MUST ship concrete
        effects; otherwise effects pay off once the query ran longer than
        effects_threshold_us (replaying it on every replica would cost more
        than shipping the mutations).  threshold <= 0 = effects always."""
        if getattr(planned, "nondeterministic", False):
            return True
        thr = self.config.effects_threshold_us
        if thr <= 0:
            return True
        return elapsed_us >= thr

    def _read_path(self, planned, all_params, deadline, text, t0, profile,
                   utilized_cache):
        rt = Runtime(self.store, all_params, deadline, write=False)
        rt.mem_capacity = self.config.query_mem_capacity
        rt.ctx.udfs = self.udfs
        rt.indexes = self.indexes
        rt.constraints = self.constraints
        rt.core = self
        rows = self._execute(planned, rt)
        return self._finish(planned, rt, rows, text, t0, utilized_cache,
                            profile)

    def _finish(self, planned, rt, rows, text, t0, utilized_cache, profile):
        ms = (time.monotonic() - t0) * 1000.0
        rt.stats["run_time_ms"] = ms
        self.slowlog.record("GRAPH.QUERY", text, ms)
        self._telemetry_add(text, ms, planned.is_write, utilized_cache)
        header = [name for _, name in planned.columns]
        prof = None
        if profile:
            prof = self._profile_text(planned)
        result = QueryResult(header, rows, rt.stats, prof)
        result.cached = utilized_cache
        return result

    def _execute(self, planned: PlannedQuery, rt: Runtime) -> list:
        rows = self._run_plan(planned, rt)
        limit = self.config.resultset_size
        if limit is not None and limit >= 0:
            rows = rows[:limit]
        return rows

    def _run_plan(self, planned: PlannedQuery, rt: Runtime) -> list:
        out: list = []
        node = planned
        seen = None
        while node is not None:
            rows = self._materialize_rows(node, rt)
            out.extend(rows)
            if node.union_next is not None and not node.union_all:
                seen = seen if seen is not None else set()
            node = node.union_next
        if seen is not None or (planned.union_next and not planned.union_all):
            # UNION (not ALL) dedups across branches
            dedup = []
            seen = set()
            from falkordb_tpu_torch.runtime.ops import _hashable

            for r in out:
                k = tuple(_hashable(v) for v in r)
                if k not in seen:
                    seen.add(k)
                    dedup.append(r)
            out = dedup
        return out

    def _materialize_rows(self, planned: PlannedQuery, rt: Runtime) -> list:
        rows: list = []
        root = planned.root
        if root is None:
            return rows
        for batch in root.run(rt):
            if not planned.columns:
                continue
            cols = []
            for slot, _ in planned.columns:
                col = batch.cols.get(slot)
                if col is None:
                    cols.append([None] * batch.n)
                else:
                    cols.append(rt.ctx.materialize(col))
            for i in range(batch.n):
                rows.append([c[i] for c in cols])
            rt.charge_mem(64 * batch.n * max(len(planned.columns), 1))
        return rows

    def _apply_ddl(self, planned: PlannedQuery, rt: Runtime):
        from falkordb_tpu_torch.index.manager import apply_ddl

        for kind, clause in planned.ddl:
            apply_ddl(self, kind, clause, rt)

    def _reindex(self, rt: Runtime):
        from falkordb_tpu_torch.index.manager import refresh_indexes

        refresh_indexes(self)

    def _profile_text(self, planned) -> str:
        lines = []
        node = planned
        while node is not None:
            for op, depth in _walk(node.root, 0):
                vec = (f", Vectorized rows: {op.vec_rows}"
                       if getattr(op, "vec_rows", 0) else "")
                vec += (f", Device rows: {op.dev_rows}"
                        if getattr(op, "dev_rows", 0) else "")
                lines.append("    " * depth + f"{op.describe()} | "
                             f"Records produced: {op.rows_out}, "
                             f"Execution time: {op.time_s * 1000:.6f} ms"
                             f"{vec}")
            node = node.union_next
        return "\n".join(lines)

    def record(self, text: str, params=None) -> list:
        """GRAPH.RECORD — operator-level execution trace
        (src/commands/record.rs:275): per operator, the rows it emitted."""
        ast, planned = self._instrumented_plan(text)
        if planned.is_write:
            raise PlanError("GRAPH.RECORD is read-only")
        node = planned
        captures: dict = {}
        while node is not None:
            for op, _ in _walk(node.root, 0):
                captures[id(op)] = []
                orig = op.run

                def run(rt, _orig=orig, _op=op):
                    for b in _orig(rt):
                        captures[id(_op)].append(b)
                        yield b

                op.run = run
            node = node.union_next
        rt = Runtime(self.store, params or {})
        rt.ctx.udfs = self.udfs
        rt.indexes = self.indexes
        self._run_plan(planned, rt)
        trace = []
        node = planned
        while node is not None:
            for op, depth in _walk(node.root, 0):
                batches = captures[id(op)]
                sample = []
                for b in batches[:1]:
                    for slot in sorted(b.cols)[:4]:
                        col = b.cols[slot]
                        vals = rt.ctx.materialize(col)[:5]
                        sample.append([slot, [repr(v) for v in vals]])
                trace.append({
                    "operator": op.describe(), "depth": depth,
                    "records": sum(b.n for b in batches),
                    "sample": sample,
                })
            node = node.union_next
        return trace

    # ------------------------------------------------------------------ admin

    def add_replica(self, consumer) -> None:
        """Register a replication consumer.  Accepts:

        * another GraphCore — receives effects via apply_effects_blob and
          verbatim queries via query() (full strategy support);
        * handler(kind, payload) — kind 'effects' (bytes) or 'query'
          ((text, params));
        * legacy callable(bytes) — effects buffers only; verbatim-chosen
          writes fall back to the recorded effects blob."""
        if isinstance(consumer, GraphCore):
            core = consumer

            def handler(kind, payload, _core=core):
                if kind == "effects":
                    _core.apply_effects_blob(payload)
                else:
                    _core.query(payload[0], params=payload[1])

            self.replicas.append(handler)
            return
        import inspect

        try:
            nargs = len(inspect.signature(consumer).parameters)
        except (TypeError, ValueError):
            nargs = 1
        if nargs >= 2:
            self.replicas.append(consumer)
        else:
            # effects-only consumer: always feed it the effects buffer
            # (verbatim payloads carry the blob at index 2)
            self.replicas.append(
                lambda kind, payload, _c=consumer:
                _c(payload if kind == "effects" else payload[2]))

    def attach_aof(self, log) -> None:
        """Attach an EffectsLog (persist/aof.py); every committed write
        appends one record for checkpoint+replay crash recovery."""
        self.aof = log

    def apply_effects_blob(self, blob: bytes) -> dict:
        """Replica-side applier (src/commands/effect.rs)."""
        from falkordb_tpu_torch.persist.effects import apply_effects, decode_effects

        effects = decode_effects(blob)
        with self._write_lock:
            new_store = self.store.fork()
            stats = apply_effects(new_store, effects)
            self.store = new_store
        self._reindex(None)
        return stats

    def copy_as(self, new_name: str) -> "GraphCore":
        g = GraphCore(new_name, self.config, udfs=self.udfs,
                      device=self.store.device)
        g.store = self.store.fork()
        g.constraints = [dict(c) for c in self.constraints]
        return g

    def memory_usage(self) -> dict:
        m = self.store.memory_usage()
        m["plan_cache_entries"] = len(self.plan_cache._lru)
        return m

    def list_constraints(self):
        return list(self.constraints)

    def create_constraint(self, ctype, entity, label, properties):
        from falkordb_tpu_torch.index.constraints import create_constraint

        return create_constraint(self, ctype, entity, label, properties)

    def drop_constraint(self, ctype, entity, label, properties):
        from falkordb_tpu_torch.index.constraints import drop_constraint

        return drop_constraint(self, ctype, entity, label, properties)


def _walk(op, depth):
    if op is None:
        return
    yield op, depth
    for c in op.children():
        yield from _walk(c, depth + 1)


def _instrument_op(op):
    """Wrap an operator instance's run() with row/time counters."""
    if getattr(op, "_instrumented", False):
        return
    op._instrumented = True
    op.rows_out = 0
    op.time_s = 0.0
    op.vec_rows = 0
    op.dev_rows = 0
    orig = op.run

    def run(rt, _orig=orig, _op=op):
        t0 = time.monotonic()
        it = _orig(rt)
        while True:
            t1 = time.monotonic()
            try:
                b = next(it)
            except StopIteration:
                _op.time_s += time.monotonic() - t1
                return
            _op.time_s += time.monotonic() - t1
            _op.rows_out += b.n
            yield b

    op.run = run
