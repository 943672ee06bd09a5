"""Expression evaluator over columnar batches.

The reference's ExprEval (graph/src/runtime/eval.rs): here expressions
evaluate column-at-a-time over object arrays, with vectorized fast paths for
entity property access (a single attr-column fancy-index) and numeric
comparisons.  Scalar-per-row fallback is plain Python — correctness first,
the hot predicates lower to numpy/device ops."""

from __future__ import annotations

import math
import re
from typing import Any

import numpy as np

from falkordb_tpu_torch.graph.attrstore import ABSENT
from falkordb_tpu_torch.lang import ast as A
from falkordb_tpu_torch.runtime.batch import Batch, Column, NULL_ID
from falkordb_tpu_torch.runtime.value import (
    EdgeVal, NodeVal, PathVal, and3, compare, equals, not3, or3, order_key,
    truthy, xor3,
)


class EvalError(ValueError):
    pass


def _from_udf(v):
    """Normalize UDF return values to Cypher values."""
    if isinstance(v, tuple):
        return [_from_udf(x) for x in v]
    if isinstance(v, list):
        return [_from_udf(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _from_udf(x) for k, x in v.items()}
    if isinstance(v, (set, frozenset)):
        return sorted(_from_udf(x) for x in v)
    return v


AGG_FNS = {
    "count", "sum", "avg", "min", "max", "collect", "stdev", "stdevp",
    "percentiledisc", "percentilecont",
}


def contains_aggregate(e) -> bool:
    if isinstance(e, A.CountStar):
        return True
    if isinstance(e, A.FnCall):
        if e.name in AGG_FNS:
            return True
        return any(contains_aggregate(a) for a in e.args)
    if isinstance(e, A.Binary):
        return contains_aggregate(e.left) or contains_aggregate(e.right)
    if isinstance(e, A.Unary):
        return contains_aggregate(e.operand)
    if isinstance(e, A.IsNull):
        return contains_aggregate(e.operand)
    if isinstance(e, A.ListLit):
        return any(contains_aggregate(x) for x in e.items)
    if isinstance(e, A.MapLit):
        return any(contains_aggregate(v) for _, v in e.items)
    if isinstance(e, A.Case):
        parts = [e.operand] if e.operand else []
        for w, t in e.whens:
            parts += [w, t]
        if e.default:
            parts.append(e.default)
        return any(contains_aggregate(p) for p in parts if p is not None)
    if isinstance(e, (A.Prop, A.DynProp)):
        return contains_aggregate(e.obj) if isinstance(e, A.Prop) else (
            contains_aggregate(e.obj) or contains_aggregate(e.key))
    if isinstance(e, (A.ListComp, A.Quantifier)):
        # aggregates may feed a comprehension SOURCE ([x IN collect(n) | …],
        # TCK List12); the body is per-element and cannot aggregate
        return contains_aggregate(e.source)
    if isinstance(e, A.Reduce):
        return contains_aggregate(e.source) or contains_aggregate(e.init)
    if isinstance(e, A.Slice):
        return any(contains_aggregate(x) for x in
                   (e.obj, e.lo, e.hi) if x is not None)
    return False


class EvalContext:
    def __init__(self, store, params=None, functions=None):
        self.store = store
        self.params = params or {}
        from falkordb_tpu_torch.runtime.functions import FUNCTIONS

        self.functions = functions or FUNCTIONS

    # -- entity materialization ------------------------------------------------

    def node_value(self, nid: int) -> NodeVal | None:
        if nid == NULL_ID:
            return None
        g = self.store
        labels = [g.schema.labels.name(l) for l in g.node_labels_of(nid)]
        props = {g.schema.attrs.name(a): v
                 for a, v in g.node_attrs.get_all(nid).items()}
        return NodeVal(int(nid), labels, props)

    def edge_value(self, eid: int) -> EdgeVal | None:
        if eid == NULL_ID:
            return None
        g = self.store
        s, d, t = g.edge_endpoints(eid)
        props = {g.schema.attrs.name(a): v
                 for a, v in g.edge_attrs.get_all(eid).items()}
        return EdgeVal(int(eid), g.schema.reltypes.name(t), s, d, props)

    def materialize(self, col: Column) -> np.ndarray:
        """Column → object array of Cypher values."""
        if col.kind == "value":
            return col.data
        out = np.empty(len(col), dtype=object)
        if col.kind == "node":
            for i, nid in enumerate(col.ids):
                out[i] = self.node_value(int(nid))
        else:
            for i, eid in enumerate(col.ids):
                out[i] = self.edge_value(int(eid))
        return out

    # -- property access fast path --------------------------------------------

    def prop_of_column(self, col: Column, key: str) -> np.ndarray:
        g = self.store
        aid = g.schema.attr_id(key)
        n = len(col)
        out = np.empty(n, dtype=object)
        if col.kind in ("node", "edge"):
            store = g.node_attrs if col.kind == "node" else g.edge_attrs
            if aid is None:
                out.fill(None)
                return out
            ac = store.columns.get(aid)
            if ac is None:
                out.fill(None)
                return out
            ids = col.ids
            ok = ids != NULL_ID
            vals = ac.data[np.clip(ids, 0, len(ac.data) - 1)]
            for i in range(n):
                v = vals[i] if ok[i] else None
                out[i] = None if v is ABSENT or not ok[i] else v
            return out
        # value column: maps / nodes / edges mixed.  Entity values read
        # the LIVE store: a collected NodeVal's property snapshot goes
        # stale when a later clause SETs the property (TCK List12 [1]);
        # deleted entities fall back to their snapshot.
        node_attrs, edge_attrs = g.node_attrs, g.edge_attrs
        for i, v in enumerate(col.data):
            if isinstance(v, NodeVal) and v.id < g.node_cap \
                    and g.node_exists[v.id]:
                pv = node_attrs.get(v.id, aid) if aid is not None else ABSENT
                out[i] = None if pv is ABSENT else pv
            elif isinstance(v, EdgeVal) and v.id < len(g.e_deleted) \
                    and not g.e_deleted[v.id]:
                pv = edge_attrs.get(v.id, aid) if aid is not None else ABSENT
                out[i] = None if pv is ABSENT else pv
            else:
                out[i] = _prop_of_value(v, key)
        return out


def _prop_of_value(v, key):
    import datetime as _dt

    if v is None:
        return None
    if isinstance(v, dict):
        return v.get(key)
    if isinstance(v, (NodeVal, EdgeVal)):
        return v.properties.get(key)
    if isinstance(v, PathVal):
        return None
    if isinstance(v, (_dt.date, _dt.datetime, _dt.time, _dt.timedelta)):
        return _temporal_accessor(v, key)
    raise EvalError(f"type mismatch: cannot access property {key!r} on "
                    f"{type(v).__name__}")


def _temporal_accessor(v, key):
    """Temporal component accessors (TCK Temporal5; the reference's
    Value::Datetime component access, graph/src/runtime/value.rs)."""
    import datetime as _dt

    if isinstance(v, _dt.timedelta):
        from .temporal import duration_components
        comps = duration_components(v)
        if key in comps:
            return comps[key]
        # sub-second totals aren't in the reference's component set but
        # are harmless precision extensions over its i64 encoding
        total = v.total_seconds()
        extra = {
            "milliseconds": int(total * 1e3),
            "microseconds": int(total * 1e6),
            "nanoseconds": int(total * 1e9),
        }
        if key in extra:
            return extra[key]
        raise EvalError(f"unknown duration component {key!r}")
    has_date = isinstance(v, (_dt.date, _dt.datetime)) and not isinstance(
        v, _dt.time)
    has_time = isinstance(v, (_dt.datetime, _dt.time))
    if has_date:
        d = v.date() if isinstance(v, _dt.datetime) else v
        iso = d.isocalendar()
        if key == "year":
            return d.year
        if key == "quarter":
            return (d.month - 1) // 3 + 1
        if key == "month":
            return d.month
        if key == "week":
            return iso[1]
        if key == "weekYear":
            return iso[0]
        if key == "day":
            return d.day
        if key == "ordinalDay":
            return d.timetuple().tm_yday
        if key == "weekDay" or key == "dayOfWeek":
            return iso[2]
        if key == "dayOfQuarter":
            qstart = _dt.date(d.year, 3 * ((d.month - 1) // 3) + 1, 1)
            return (d - qstart).days + 1
    if has_time:
        t = v.timetz() if isinstance(v, _dt.datetime) else v
        if key == "hour":
            return t.hour
        if key == "minute":
            return t.minute
        if key == "second":
            return t.second
        if key == "millisecond":
            return t.microsecond // 1000
        if key == "microsecond":
            return t.microsecond
        if key == "nanosecond":
            return t.microsecond * 1000
        if key == "timezone" and t.tzinfo is not None:
            return str(t.tzinfo)
    if isinstance(v, _dt.datetime):
        if key == "epochSeconds":
            return int(v.timestamp())
        if key == "epochMillis":
            return int(v.timestamp() * 1000)
    raise EvalError(f"unknown temporal component {key!r}")


# ------------------------------------------------------------------- evaluate


_VEC_EVAL_MIN = 32  # below this the typed-view setup costs more than it saves


def evaluate(e, batch: Batch, ctx: EvalContext) -> Column:
    """Evaluate e for every row of batch → Column of length batch.n."""
    if batch.n >= _VEC_EVAL_MIN and isinstance(e, (A.Binary, A.FnCall,
                                                   A.Prop)):
        # columnar fast path: one numpy program instead of a per-row tree
        # walk (vectorized.py; falls back silently on anything untyped)
        from falkordb_tpu_torch.runtime import vectorized as V

        tv = V.eval_typed(e, batch, ctx)
        if tv is not None:
            col = V.tv_to_column(tv)
            if col is not None:
                return col
    if isinstance(e, A.Lit):
        arr = np.empty(batch.n, dtype=object)
        arr.fill(None)
        if e.value is not None:
            for i in range(batch.n):
                arr[i] = e.value
        return Column("value", data=arr)
    if isinstance(e, A.Param):
        if e.name not in ctx.params:
            raise EvalError(f"missing parameter ${e.name}")
        v = ctx.params[e.name]
        arr = np.empty(batch.n, dtype=object)
        for i in range(batch.n):
            arr[i] = v
        return Column("value", data=arr)
    if isinstance(e, A.Var):
        col = _lookup_var(e, batch, ctx)
        return col
    if isinstance(e, A.Prop):
        obj = evaluate(e.obj, batch, ctx)
        return Column("value", data=ctx.prop_of_column(obj, e.key))
    if isinstance(e, A.DynProp):
        obj = ctx.materialize(evaluate(e.obj, batch, ctx))
        key = ctx.materialize(evaluate(e.key, batch, ctx))
        out = np.empty(batch.n, dtype=object)
        for i in range(batch.n):
            o, k = obj[i], key[i]
            if o is None or k is None:
                out[i] = None
            elif isinstance(o, (list, tuple)):
                if not isinstance(k, (int, np.integer)) or isinstance(k, bool):
                    raise EvalError("list index must be an integer")
                idx = int(k)
                if idx < 0:
                    idx += len(o)
                out[i] = o[idx] if 0 <= idx < len(o) else None
            elif isinstance(o, (dict, NodeVal, EdgeVal)):
                # maps are keyed by strings: indexing with any other type
                # is a runtime TypeError (TCK Map2 [6]/[7])
                if not isinstance(k, str):
                    raise EvalError(
                        f"type mismatch: map access with a "
                        f"{type(k).__name__} key (expected a string)")
                out[i] = _prop_of_value(o, k)
            else:
                raise EvalError(f"cannot index {type(o).__name__}")
        return Column("value", data=out)
    if isinstance(e, A.Slice):
        obj = ctx.materialize(evaluate(e.obj, batch, ctx))
        lo = ctx.materialize(evaluate(e.lo, batch, ctx)) if e.lo else None
        hi = ctx.materialize(evaluate(e.hi, batch, ctx)) if e.hi else None
        out = np.empty(batch.n, dtype=object)
        for i in range(batch.n):
            o = obj[i]
            if o is None:
                out[i] = None
                continue
            l = lo[i] if lo is not None else None
            h = hi[i] if hi is not None else None
            if (lo is not None and l is None) or (hi is not None and h is None):
                out[i] = None
                continue
            out[i] = list(o[slice(None if l is None else int(l),
                                  None if h is None else int(h))])
        return Column("value", data=out)
    if isinstance(e, A.ListLit):
        parts = [ctx.materialize(evaluate(x, batch, ctx)) for x in e.items]
        out = np.empty(batch.n, dtype=object)
        for i in range(batch.n):
            out[i] = [p[i] for p in parts]
        return Column("value", data=out)
    if isinstance(e, A.MapLit):
        keys = [k for k, _ in e.items]
        parts = [ctx.materialize(evaluate(v, batch, ctx)) for _, v in e.items]
        out = np.empty(batch.n, dtype=object)
        for i in range(batch.n):
            out[i] = {k: p[i] for k, p in zip(keys, parts)}
        return Column("value", data=out)
    if isinstance(e, A.Unary):
        v = ctx.materialize(evaluate(e.operand, batch, ctx))
        out = np.empty(batch.n, dtype=object)
        if e.op == "NOT":
            for i in range(batch.n):
                out[i] = not3(truthy(v[i]))
        elif e.op == "-":
            for i in range(batch.n):
                x = v[i]
                if x is None:
                    out[i] = None
                elif isinstance(x, (int, float)) and not isinstance(x, bool):
                    out[i] = -x
                else:
                    raise EvalError(f"cannot negate {type(x).__name__}")
        else:
            raise EvalError(e.op)
        return Column("value", data=out)
    if isinstance(e, A.Binary):
        return _eval_binary(e, batch, ctx)
    if isinstance(e, A.IsNull):
        v = evaluate(e.operand, batch, ctx)
        if v.kind != "value":
            isnull = v.ids == NULL_ID
            out = np.empty(batch.n, dtype=object)
            for i in range(batch.n):
                out[i] = bool(isnull[i]) != e.negated
            return Column("value", data=out)
        out = np.empty(batch.n, dtype=object)
        for i in range(batch.n):
            out[i] = (v.data[i] is None) != e.negated
        return Column("value", data=out)
    if isinstance(e, A.CountStar):
        raise EvalError("count(*) outside aggregation context")
    if isinstance(e, A.FnCall):
        if e.name in AGG_FNS:
            raise EvalError(f"aggregate {e.name}() outside aggregation context")
        fn = ctx.functions.get(e.name)
        is_udf = False
        if fn is None:
            udfs = getattr(ctx, "udfs", None)
            if udfs is not None:
                fn = udfs.lookup(e.orig or e.name)
                is_udf = fn is not None
        if fn is None:
            raise EvalError(f"unknown function {e.orig or e.name}()")
        args = [ctx.materialize(evaluate(a, batch, ctx)) for a in e.args]
        out = np.empty(batch.n, dtype=object)
        for i in range(batch.n):
            row_args = [a[i] for a in args]
            if is_udf:
                try:
                    out[i] = _from_udf(udfs.call(fn, row_args))
                except Exception as ex:  # noqa: BLE001
                    raise EvalError(f"UDF {e.orig}() failed: {ex}")
            else:
                out[i] = fn(ctx, *row_args)
        return Column("value", data=out)
    if isinstance(e, A.Case):
        return _eval_case(e, batch, ctx)
    if isinstance(e, A.ListComp):
        # batched: flatten every row's items into ONE item-batch and
        # evaluate where/projection once over it (was a per-item
        # sub-batch + eval — 3 evals per ITEM instead of 3 total)
        src = ctx.materialize(evaluate(e.source, batch, ctx))
        out = np.empty(batch.n, dtype=object)
        lists = []
        for i in range(batch.n):
            s = src[i]
            if s is None:
                out[i] = None
                lists.append(())
                continue
            if not isinstance(s, (list, tuple)):
                raise EvalError("list comprehension source must be a list")
            out[i] = []
            lists.append(s)
        lens = np.fromiter((len(s) for s in lists), np.int64, batch.n)
        rows = np.repeat(np.arange(batch.n), lens)
        items = [x for s in lists for x in s]
        if len(items) == 0:
            return Column("value", data=out)
        if e.where is not None:
            sub = _item_batch(batch, rows, e.var, items, ctx)
            wcol = evaluate(e.where, sub, ctx)
            tvw = getattr(wcol, "_tv", None)
            if tvw is not None and tvw is not False \
                    and getattr(tvw, "kind", None) == "bool":
                keep = (tvw.vals == 1) & ~tvw.null
            else:
                wv = ctx.materialize(wcol)
                keep = np.fromiter((truthy(w) is True for w in wv), bool,
                                   len(items))
            rows = rows[keep]
            arr = np.empty(len(items), dtype=object)
            arr[:] = items
            items = arr[keep].tolist()
        if e.projection is not None and len(items):
            # projection runs only over items that passed the filter
            # (an error in a filtered-out item must not surface)
            sub = _item_batch(batch, rows, e.var, items, ctx)
            pv = ctx.materialize(evaluate(e.projection, sub, ctx))
            items = list(pv)
        if len(rows) and batch.n == 1:
            out[0] = items  # single outer row: no regroup needed
        elif len(rows):
            # rows is sorted ascending: slice per outer row
            counts = np.bincount(rows, minlength=batch.n)
            offs = np.concatenate([[0], np.cumsum(counts)])
            for i in range(batch.n):
                if out[i] is not None and counts[i]:
                    out[i] = items[offs[i]:offs[i + 1]]
        return Column("value", data=out)
    if isinstance(e, A.Quantifier):
        src = ctx.materialize(evaluate(e.source, batch, ctx))
        out = np.empty(batch.n, dtype=object)
        lists = []
        for i in range(batch.n):
            s = src[i]
            if s is None:
                out[i] = None
                lists.append(())
            else:
                lists.append(s)
        lens = np.fromiter((len(s) for s in lists), np.int64, batch.n)
        rows = np.repeat(np.arange(batch.n), lens)
        items = [x for s in lists for x in s]
        if len(items) and e.where is not None:
            sub = _item_batch(batch, rows, e.var, items, ctx)
            wv = ctx.materialize(evaluate(e.where, sub, ctx))
            tri = [truthy(w) for w in wv]
        else:
            tri = [True] * len(items)
        trues_a = np.bincount(rows[[t is True for t in tri]]
                              if len(items) else [], minlength=batch.n)
        falses_a = np.bincount(rows[[t is False for t in tri]]
                               if len(items) else [], minlength=batch.n)
        nulls_a = np.bincount(rows[[t is None for t in tri]]
                              if len(items) else [], minlength=batch.n)
        for i in range(batch.n):
            if src[i] is None:
                continue
            trues = int(trues_a[i])
            anynull = nulls_a[i] > 0
            if e.kind == "any":
                out[i] = True if trues > 0 else (None if anynull else False)
            elif e.kind == "all":
                out[i] = (False if falses_a[i] > 0
                          else (None if anynull else True))
            elif e.kind == "none":
                out[i] = False if trues > 0 else (None if anynull else True)
            else:  # single: 3VL — >=2 trues is certainly false even
                # with nulls present (TCK Quantifier2 [10])
                if trues >= 2:
                    out[i] = False
                elif anynull:
                    out[i] = None
                else:
                    out[i] = trues == 1
        return Column("value", data=out)
    if isinstance(e, A.Reduce):
        src = ctx.materialize(evaluate(e.source, batch, ctx))
        init = ctx.materialize(evaluate(e.init, batch, ctx))
        fast = _reduce_sum_fast(e, src, init, batch, ctx)
        if fast is not None:
            return fast
        out = np.empty(batch.n, dtype=object)
        for i in range(batch.n):
            s = src[i]
            if s is None:
                out[i] = None
                continue
            acc = init[i]
            for item in s:
                sub = _single_row_with(batch, i, e.var, item, ctx,
                                       extra={e.acc: acc})
                acc = ctx.materialize(evaluate(e.step, sub, ctx))[0]
            out[i] = acc
        return Column("value", data=out)
    if isinstance(e, A.PatternComp):
        if not hasattr(ctx, "pattern_collect"):
            raise EvalError("pattern comprehensions not available here")
        return Column("value", data=ctx.pattern_collect(e, batch))
    if isinstance(e, A.ExistsExpr):
        if e.prop is not None:
            v = ctx.materialize(evaluate(e.prop, batch, ctx))
            out = np.empty(batch.n, dtype=object)
            for i in range(batch.n):
                out[i] = v[i] is not None
            return Column("value", data=out)
        # pattern-exists: delegated to the operator layer via ctx hook
        if not hasattr(ctx, "pattern_exists"):
            raise EvalError("pattern predicates not available in this context")
        return Column("value", data=ctx.pattern_exists(e, batch))
    if isinstance(e, A.ShortestPathExpr):
        return _eval_shortest_path_expr(e, batch, ctx)
    raise EvalError(f"cannot evaluate {type(e).__name__}")


def _eval_shortest_path_expr(e, batch, ctx):
    """shortestPath((a)-[*]->(b)) in expression position (the reference's
    eval_shortest_path, graph/src/runtime/eval.rs:1292): both endpoints
    must be bound node variables; returns Path | Null per row
    (allShortestPaths: List of Paths)."""
    sp = getattr(ctx, "shortest_path_value", None)
    if sp is None:
        raise EvalError("shortestPath not available in this context")
    els = e.pattern.elements
    if len(els) != 3 or not isinstance(els[1], A.RelPattern):
        raise EvalError("shortestPath expects a single relationship pattern")
    a, rel, b = els
    sv = getattr(e, "_src_var", None)
    dv = getattr(e, "_dst_var", None)
    if sv is None or dv is None:
        raise EvalError("A shortestPath requires bound nodes")
    src = ctx.materialize(evaluate(sv, batch, ctx))
    dst = ctx.materialize(evaluate(dv, batch, ctx))
    out = np.empty(batch.n, dtype=object)
    for i in range(batch.n):
        s, d = src[i], dst[i]
        if s is None or d is None:
            out[i] = None
            continue
        if not isinstance(s, NodeVal) or not isinstance(d, NodeVal):
            raise EvalError("A shortestPath requires bound nodes")
        mn = rel.min_hops if (rel.varlen and rel.min_hops is not None) else 1
        out[i] = sp(s.id, d.id, rel.types, rel.direction, mn,
                    rel.max_hops if rel.varlen else 1,
                    all_paths=bool(e.all_paths))
    return Column("value", data=out)


def _refs_var(e, name) -> bool:
    """Conservative: does any Var named `name` appear in e?  (Shadowing
    overapproximates — a shadowed reuse just skips the fast path.)"""
    import dataclasses as _dc

    if isinstance(e, A.Var):
        return e.name == name
    if isinstance(e, (list, tuple)):
        return any(_refs_var(x, name) for x in e)
    if _dc.is_dataclass(e) and not isinstance(e, type):
        return any(_refs_var(getattr(e, f.name), name)
                   for f in _dc.fields(e))
    return False


def _reduce_sum_fast(e: A.Reduce, src, init, batch: Batch, ctx):
    """reduce(acc = <int>, x IN <ints> | acc + rhs) as one vectorized
    segment sum — exact for integers under the 2^53 guard; anything else
    (floats: fold order changes rounding; strings/lists: concat) falls
    back to the per-item loop."""
    step = e.step
    rhs = None
    if isinstance(step, A.Binary) and step.op == "+":
        if isinstance(step.left, A.Var) and step.left.name == e.acc \
                and not _refs_var(step.right, e.acc):
            rhs = step.right
        elif isinstance(step.right, A.Var) and step.right.name == e.acc \
                and not _refs_var(step.left, e.acc):
            rhs = step.left
    if rhs is None or batch.n == 0:
        return None
    for v in init:
        if v is not None and (isinstance(v, bool)
                              or not isinstance(v, (int, np.integer))):
            return None
    lists = []
    for s_ in src:
        if s_ is None:
            lists.append(())
        elif isinstance(s_, (list, tuple)):
            lists.append(s_)
        else:
            return None
    lens = np.fromiter((len(s_) for s_ in lists), np.int64, batch.n)
    rows = np.repeat(np.arange(batch.n), lens)
    items = [x for s_ in lists for x in s_]
    if items:
        from falkordb_tpu_torch.runtime import vectorized as V

        sub = _item_batch(batch, rows, e.var, items, ctx)
        col = evaluate(rhs, sub, ctx)
        tv = V.typed_view_of_column(col)  # reuses col._tv when fast-pathed
        if tv is None or tv.kind not in (V.NUM, V.NULLK) or \
                (tv.kind == V.NUM and not tv.is_int):
            return None
        if tv.kind == V.NULLK:
            sums = np.zeros(batch.n)
            nulls = np.bincount(rows, minlength=batch.n) > 0
        else:
            if float(np.bincount(rows, weights=np.abs(tv.vals),
                                 minlength=batch.n).max()) >= 2**53:
                return None
            sums = np.bincount(rows, weights=tv.vals, minlength=batch.n)
            nulls = np.bincount(rows[tv.null], minlength=batch.n) > 0
    else:
        sums = np.zeros(batch.n)
        nulls = np.zeros(batch.n, dtype=bool)
    out = np.empty(batch.n, dtype=object)
    for i in range(batch.n):
        if src[i] is None or init[i] is None or nulls[i]:
            out[i] = None
        else:
            out[i] = int(init[i]) + int(sums[i])
    return Column("value", data=out)


def _lookup_var(e: A.Var, batch: Batch, ctx) -> Column:
    slot = getattr(e, "slot", None)
    if slot is None or slot not in batch.cols:
        # late-bound names (list-comprehension vars injected via _aux)
        aux = getattr(batch, "_aux", None)
        if aux is not None and e.name in aux:
            return aux[e.name]
        raise EvalError(f"undefined variable {e.name!r}")
    return batch.cols[slot]


def _item_batch(batch: Batch, row_idx, var: str, items, ctx):
    """One sub-batch carrying every (row, item) pair of a comprehension:
    outer columns replicate via take(row_idx); the loop variable rides as
    an aux column.  The batched analogue of _single_row_with."""
    idx = np.asarray(row_idx, dtype=np.int64)
    sub = batch.take(idx)
    aux = dict(getattr(batch, "_aux_template", {}) or {})
    parent_aux = getattr(batch, "_aux", None)
    if parent_aux:
        aux.update({k: v.take(idx) for k, v in parent_aux.items()})
    col = Column.values(list(items))
    if len(idx) >= _VEC_EVAL_MIN:
        # pre-typed loop column: one C-speed type scan here replaces the
        # per-element isinstance walk typed_view_of_column would do
        from falkordb_tpu_torch.runtime import vectorized as V

        tv = V.fast_items_tv(items if isinstance(items, list)
                             else list(items))
        if tv is not None:
            col._tv = tv
    aux[var] = col
    sub._aux = aux
    return sub


def _single_row_with(batch: Batch, i: int, var: str, value, ctx, extra=None):
    idx = np.asarray([i])
    sub = batch.take(idx)
    aux = dict(getattr(batch, "_aux_template", {}) or {})
    parent_aux = getattr(batch, "_aux", None)
    if parent_aux:
        aux.update({k: v.take(idx) for k, v in parent_aux.items()})
    aux[var] = Column.values([value])
    if extra:
        for k, v in extra.items():
            aux[k] = Column.values([v])
    sub._aux = aux
    return sub


def _eval_case(e: A.Case, batch, ctx) -> Column:
    out = np.empty(batch.n, dtype=object)
    if e.operand is not None:
        op = ctx.materialize(evaluate(e.operand, batch, ctx))
    whens = [(ctx.materialize(evaluate(w, batch, ctx)),
              ctx.materialize(evaluate(t, batch, ctx))) for w, t in e.whens]
    default = (ctx.materialize(evaluate(e.default, batch, ctx))
               if e.default is not None else None)
    for i in range(batch.n):
        res = default[i] if default is not None else None
        for wv, tv in whens:
            if e.operand is not None:
                hit = equals(op[i], wv[i]) is True
            else:
                hit = truthy(wv[i]) is True
            if hit:
                res = tv[i]
                break
        out[i] = res
    return Column("value", data=out)


_NUM = (int, float)


def _eval_binary(e: A.Binary, batch, ctx) -> Column:
    op = e.op
    if op in ("AND", "OR", "XOR"):
        l = ctx.materialize(evaluate(e.left, batch, ctx))
        r = ctx.materialize(evaluate(e.right, batch, ctx))
        f = {"AND": and3, "OR": or3, "XOR": xor3}[op]
        out = np.empty(batch.n, dtype=object)
        for i in range(batch.n):
            out[i] = f(truthy(l[i]), truthy(r[i]))
        return Column("value", data=out)
    lcol = evaluate(e.left, batch, ctx)
    rcol = evaluate(e.right, batch, ctx)
    if op == "=" and lcol.kind != "value" and rcol.kind != "value":
        out = np.empty(batch.n, dtype=object)
        eq = lcol.ids == rcol.ids
        for i in range(batch.n):
            if lcol.ids[i] == NULL_ID or rcol.ids[i] == NULL_ID:
                out[i] = None
            else:
                out[i] = bool(eq[i]) and lcol.kind == rcol.kind
        return Column("value", data=out)
    l = ctx.materialize(lcol)
    r = ctx.materialize(rcol)
    out = np.empty(batch.n, dtype=object)
    if op == "=":
        for i in range(batch.n):
            out[i] = equals(l[i], r[i])
    elif op == "<>":
        for i in range(batch.n):
            v = equals(l[i], r[i])
            out[i] = None if v is None else not v
    elif op in ("<", "<=", ">", ">="):
        for i in range(batch.n):
            c = compare(l[i], r[i])
            if c is None:
                out[i] = None
            else:
                out[i] = {"<": c < 0, "<=": c <= 0, ">": c > 0, ">=": c >= 0}[op]
    elif op == "+":
        for i in range(batch.n):
            out[i] = _plus(l[i], r[i])
    elif op == "-":
        for i in range(batch.n):
            out[i] = _arith(l[i], r[i], op)
    elif op in ("*", "/", "%", "^"):
        for i in range(batch.n):
            out[i] = _arith(l[i], r[i], op)
    elif op == "IN":
        for i in range(batch.n):
            if r[i] is None:
                out[i] = None
                continue
            if not isinstance(r[i], (list, tuple)):
                raise EvalError("IN expects a list")
            if l[i] is None:
                out[i] = None if len(r[i]) else False
                continue
            found = False
            saw_null = False
            for item in r[i]:
                v = equals(l[i], item)
                if v is True:
                    found = True
                    break
                if v is None:
                    saw_null = True
            out[i] = True if found else (None if saw_null else False)
    elif op in ("STARTS", "ENDS", "CONTAINS"):
        for i in range(batch.n):
            a, b = l[i], r[i]
            if a is None or b is None:
                out[i] = None
            elif not isinstance(a, str) or not isinstance(b, str):
                out[i] = None
            else:
                out[i] = (a.startswith(b) if op == "STARTS"
                          else a.endswith(b) if op == "ENDS" else b in a)
    elif op == "=~":
        for i in range(batch.n):
            a, b = l[i], r[i]
            if a is None or b is None:
                out[i] = None
            else:
                out[i] = re.fullmatch(b, a) is not None
    else:
        raise EvalError(f"unknown operator {op}")
    return Column("value", data=out)


def _plus(a, b):
    if a is None or b is None:
        return None
    if isinstance(a, (list, tuple)):
        return list(a) + (list(b) if isinstance(b, (list, tuple)) else [b])
    if isinstance(b, (list, tuple)):
        return [a] + list(b)
    if isinstance(a, str) or isinstance(b, str):
        if isinstance(a, str) and isinstance(b, str):
            return a + b
        if isinstance(a, str) and isinstance(b, _NUM) and not isinstance(b, bool):
            return a + _num_str(b)
        if isinstance(b, str) and isinstance(a, _NUM) and not isinstance(a, bool):
            return _num_str(a) + b
        raise EvalError("type mismatch in +")
    if isinstance(a, bool) or isinstance(b, bool):
        raise EvalError("cannot add booleans")
    if isinstance(a, _NUM) and isinstance(b, _NUM):
        return a + b
    import datetime as _dt

    from . import temporal as _tp
    if isinstance(a, _dt.timedelta) and isinstance(b, _dt.timedelta):
        return _tp.duration_add(a, b)
    # Date/Datetime/Time + Duration, either order
    # (value.rs:1022-1034; note datetime IS a date subclass)
    for x, dur in ((a, b), (b, a)):
        if not isinstance(dur, _dt.timedelta) or isinstance(x, _dt.timedelta):
            continue
        if isinstance(x, (_dt.date, _dt.datetime)):
            return _tp.date_add_duration(x, dur)
        if isinstance(x, _dt.time):
            return _tp.time_add_duration(x, dur)
    raise EvalError(f"cannot add {type(a).__name__} and {type(b).__name__}")


def _num_str(x):
    if isinstance(x, float):
        return repr(x)
    return str(x)


def _arith(a, b, op):
    if a is None or b is None:
        return None
    if isinstance(a, bool) or isinstance(b, bool) or not (
        isinstance(a, _NUM) and isinstance(b, _NUM)
    ):
        if op == "-":
            import datetime as _dt

            from . import temporal as _tp
            # Duration - Duration, temporal - Duration (value.rs Sub arms;
            # Duration - temporal is an explicit type error there)
            if isinstance(a, _dt.timedelta) and isinstance(b, _dt.timedelta):
                return _tp.duration_add(a, b, sign=-1)
            if isinstance(b, _dt.timedelta):
                if isinstance(a, (_dt.date, _dt.datetime)):
                    return _tp.date_add_duration(a, b, subtract=True)
                if isinstance(a, _dt.time):
                    return _tp.time_add_duration(a, b, subtract=True)
            if isinstance(a, _dt.timedelta) and isinstance(
                    b, (_dt.date, _dt.datetime, _dt.time)):
                raise EvalError(
                    "cannot subtract a temporal value from a duration")
        raise EvalError(f"type mismatch in {op}")
    if op == "-":
        return a - b
    if op == "*":
        return a * b
    if op == "/":
        if b == 0:
            if isinstance(a, int) and isinstance(b, int):
                raise EvalError("division by zero")
            return math.inf if a > 0 else (-math.inf if a < 0 else math.nan)
        if isinstance(a, int) and isinstance(b, int):
            q = a // b
            if q < 0 and a != q * b:
                q += 1  # truncate toward zero (Cypher integer division)
            return q
        return a / b
    if op == "%":
        if b == 0:
            raise EvalError("division by zero")
        r = math.fmod(a, b)
        if isinstance(a, int) and isinstance(b, int):
            return int(r)
        return r
    if op == "^":
        return float(a) ** float(b)
    raise EvalError(op)


def evaluate_predicate(e, batch: Batch, ctx) -> np.ndarray:
    """WHERE semantics: keep rows where predicate is exactly True."""
    col = evaluate(e, batch, ctx)
    tv = getattr(col, "_tv", None)
    if tv is not None and tv is not False and \
            getattr(tv, "kind", None) == "bool":
        return (tv.vals == 1) & ~tv.null
    arr = col.data if col.kind == "value" else None
    out = np.zeros(batch.n, dtype=bool)
    if arr is None:
        raise EvalError("predicate must be boolean")
    for i in range(batch.n):
        out[i] = truthy(arr[i]) is True
    return out
