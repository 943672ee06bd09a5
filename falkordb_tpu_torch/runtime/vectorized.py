"""Vectorized (columnar) expression + operator fast paths.

The reference evaluates hot predicates over typed columns with tight
auto-vectorized loops (graph/src/runtime/vectorized.rs:1-34) and runs
grouping/aggregation over 1024-row batches (ops/aggregate.rs).  Here the
same role is played by numpy array programs over *typed views* of columns:
一 pass classifies a column as homogeneous numeric / string / bool / entity
(+ null mask), after which predicates, group codes, and aggregations are
single array expressions — no per-row Python.

Anything outside the typed fast set (mixed-type columns, lists, maps,
distinct aggregates, NaN group keys) falls back to the object-array path in
eval.py/ops.py, which remains the semantics oracle.

Three-valued logic is carried as (vals uint8 {0,1}, null bool[]) pairs.
"""

from __future__ import annotations

import numpy as np

from falkordb_tpu_torch.graph.attrstore import ABSENT
from falkordb_tpu_torch.lang import ast as A
from falkordb_tpu_torch.runtime.batch import Batch, Column, NULL_ID

# typed-view kinds
NUM = "num"
STR = "str"
BOOL = "bool"
NODE = "node"
EDGE = "edge"
NULLK = "null"  # literal NULL — coerces to any kind


class TV:
    """Typed view of one column: homogeneous values + null mask.

    kind NUM:  vals float64 (ints exactly representable; `is_int` set when
               every non-null source value was an integer; `num_mixed` when
               ints AND floats coexist — reconstruction is then inexact and
               type-preserving consumers must use `orig` or fall back)
    kind STR:  vals object array of str ('' at nulls)
    kind BOOL: vals uint8 {0,1}
    kind NODE/EDGE: vals int64 entity ids
    kind NULLK: all-null (vals unused)
    `orig`, when set, is the object array of source values (exact reps).
    """

    __slots__ = ("kind", "vals", "null", "is_int", "num_mixed", "orig")

    def __init__(self, kind, vals, null, is_int=False, num_mixed=False,
                 orig=None):
        self.kind = kind
        self.vals = vals
        self.null = null
        self.is_int = is_int
        self.num_mixed = num_mixed
        self.orig = orig


def _all_null(n):
    return TV(NULLK, None, np.ones(n, dtype=bool))


# --------------------------------------------------------------- typed views


def typed_view_of_object(arr: np.ndarray) -> TV | None:
    """Classify an object array; None when not homogeneous (mixed types,
    lists, maps, entities-as-values, NaN present)."""
    n = len(arr)
    null = np.array([v is None for v in arr], dtype=bool)
    if null.all():
        return _all_null(n)
    kind = None
    saw_int = saw_float = False
    for v in arr:
        if v is None:
            continue
        if isinstance(v, bool) or isinstance(v, np.bool_):
            k = BOOL
        elif isinstance(v, (int, np.integer)):
            k = NUM
            saw_int = True
        elif isinstance(v, (float, np.floating)):
            k = NUM
            saw_float = True
            if v != v:  # NaN diverges from per-row group/equality semantics
                return None
        elif isinstance(v, str):
            k = STR
        else:
            return None
        if kind is None:
            kind = k
        elif kind != k:
            return None
    if kind == NUM:
        is_int = saw_int and not saw_float
        vals = np.zeros(n, dtype=np.float64)
        for i, v in enumerate(arr):
            if v is not None:
                if is_int and not (-(2**53) < v < 2**53):
                    return None  # int exceeds exact float64 range
                vals[i] = v
        return TV(NUM, vals, null, is_int=is_int,
                  num_mixed=saw_int and saw_float, orig=arr)
    if kind == STR:
        vals = np.empty(n, dtype=object)
        for i, v in enumerate(arr):
            vals[i] = v if v is not None else ""
        return TV(STR, vals, null, orig=arr)
    if kind == BOOL:
        vals = np.zeros(n, dtype=np.uint8)
        for i, v in enumerate(arr):
            if v:
                vals[i] = 1
        return TV(BOOL, vals, null, orig=arr)
    return None


def fast_items_tv(items) -> TV | None:
    """Exact typed view of a flat Python list in one C-speed pass:
    set(map(type, items)) distinguishes bool/int/float/str precisely
    (bool is its own type, so no silent int coercion), avoiding the
    per-element isinstance walk on the comprehension hot path."""
    n = len(items)
    if n == 0:
        return None
    kinds = set(map(type, items))
    none = np.zeros(n, dtype=bool)
    if kinds == {int}:
        try:
            vals = np.fromiter(items, np.float64, n)
        except OverflowError:  # int beyond float64 range: object path
            return None
        if np.abs(vals).max() >= 2**53:
            return None
        return TV(NUM, vals, none, is_int=True)
    if kinds == {float}:
        vals = np.fromiter(items, np.float64, n)
        if np.isnan(vals).any():
            return None
        return TV(NUM, vals, none)
    if kinds == {bool}:
        return TV(BOOL, np.fromiter(items, np.uint8, n), none)
    if kinds == {str}:
        arr = np.empty(n, dtype=object)
        arr[:] = items
        return TV(STR, arr, none, orig=arr)
    return None


def typed_view_of_column(col: Column) -> TV | None:
    """Batch Column → TV (cached on the Column object)."""
    if col.kind in ("node", "edge"):
        ids = np.asarray(col.ids, dtype=np.int64)
        return TV(NODE if col.kind == "node" else EDGE, ids, ids == NULL_ID)
    cached = getattr(col, "_tv", None)
    if cached is not None:
        return cached if cached is not False else None
    tv = typed_view_of_object(col.data)
    try:
        col._tv = tv if tv is not None else False
    except AttributeError:
        pass
    return tv


def _prop_tv(store, ent_kind: str, ids: np.ndarray, key: str) -> TV | None:
    """Vectorized property gather: entity ids → TV of prop values, using the
    attribute store's typed mirrors (attrstore.Column.typed_mirror)."""
    aid = store.schema.attr_id(key)
    n = len(ids)
    if aid is None:
        return _all_null(n)
    attrs = store.node_attrs if ent_kind == "node" else store.edge_attrs
    ac = attrs.columns.get(aid)
    if ac is None:
        return _all_null(n)
    mirror = ac.typed_mirror()
    if mirror is None:
        return None
    tag, vals, valid, numk = mirror
    ok = ids != NULL_ID
    safe = np.clip(ids, 0, len(vals) - 1)
    g = vals[safe]
    null = ~(valid[safe] & ok)
    if tag == NUM:
        g = np.where(null, 0.0, g)
        orig = None
        if numk == "mixed":  # exact reps needed for type-preserving reads
            orig = ac.data[safe]
        return TV(NUM, g, null, is_int=(numk == "int"),
                  num_mixed=(numk == "mixed"), orig=orig)
    if tag == STR:
        out = np.empty(n, dtype=object)
        for i in range(n):  # small: only replaces nulls; g is object array
            out[i] = "" if null[i] else g[i]
        return TV(STR, out, null)
    if tag == BOOL:
        return TV(BOOL, np.where(null, 0, g).astype(np.uint8), null)
    return None


# ------------------------------------------------------------ typed evaluate


_CMP = {"<", "<=", ">", ">=", "=", "<>"}
_BOOLOPS = {"AND", "OR", "XOR"}


def eval_typed(e, batch: Batch, ctx) -> TV | None:
    """Evaluate an expression to a TV when every leaf is typed; None means
    'use the object-array evaluator'."""
    n = batch.n
    if isinstance(e, A.Lit):
        return _lit_tv(e.value, n)
    if isinstance(e, A.Param):
        if e.name not in ctx.params:
            return None
        return _lit_tv(ctx.params[e.name], n)
    if isinstance(e, A.Var):
        slot = getattr(e, "slot", None)
        if slot is None or slot not in batch.cols:
            # late-bound comprehension vars ride as aux columns
            aux = getattr(batch, "_aux", None)
            if aux is not None and e.name in aux:
                return typed_view_of_column(aux[e.name])
            return None
        return typed_view_of_column(batch.cols[slot])
    if isinstance(e, A.Prop) and isinstance(e.obj, A.Var):
        slot = getattr(e.obj, "slot", None)
        if slot is not None and slot in batch.cols:
            col = batch.cols[slot]
            if col.kind in ("node", "edge"):
                return _prop_tv(ctx.store, col.kind,
                                np.asarray(col.ids, np.int64), e.key)
        return None
    if isinstance(e, A.IsNull):
        v = eval_typed(e.operand, batch, ctx)
        if v is None:
            return None
        res = (~v.null) if e.negated else v.null.copy()
        return TV(BOOL, res.astype(np.uint8), np.zeros(n, dtype=bool))
    if isinstance(e, A.Unary):
        v = eval_typed(e.operand, batch, ctx)
        if v is None:
            return None
        if e.op == "NOT" and v.kind in (BOOL, NULLK):
            if v.kind == NULLK:
                return v
            return TV(BOOL, 1 - v.vals, v.null)
        if e.op == "-" and v.kind == NUM:
            return TV(NUM, -v.vals, v.null, is_int=v.is_int)
        return None
    if isinstance(e, A.Binary):
        return _binary_tv(e, batch, ctx)
    if isinstance(e, A.FnCall):
        return _call_tv(e, batch, ctx)
    return None


# numeric builtins with exact vectorized equivalents (runtime/functions.py
# is the semantics oracle: nulls propagate, non-numbers defer to it)
def _vec_num_fn(name, vals, is_int):
    if name == "abs":
        return np.abs(vals), is_int
    if name == "ceil":
        return np.ceil(vals), False
    if name == "floor":
        return np.floor(vals), False
    if name == "round":  # reference: floor(x + 0.5) as float
        return np.floor(vals + 0.5), False
    if name == "sign":
        return np.sign(vals), True
    if name == "sqrt":  # <0 → nan (not a domain error)
        with np.errstate(invalid="ignore"):
            return np.where(vals >= 0, np.sqrt(np.abs(vals)), np.nan), False
    if name == "log":
        with np.errstate(invalid="ignore", divide="ignore"):
            return np.where(vals > 0, np.log(np.abs(vals) + (vals <= 0)),
                            np.nan), False
    if name == "log10":
        with np.errstate(invalid="ignore", divide="ignore"):
            return np.where(vals > 0, np.log10(np.abs(vals) + (vals <= 0)),
                            np.nan), False
    if name in ("sin", "cos", "tan", "atan", "degrees", "radians"):
        f = {"sin": np.sin, "cos": np.cos, "tan": np.tan, "atan": np.arctan,
             "degrees": np.degrees, "radians": np.radians}[name]
        return f(vals), False
    if name == "tofloat":
        return vals.copy(), False
    if name == "tointeger":  # float → truncate toward zero; int passthrough
        v = np.trunc(vals)
        if np.any(~np.isfinite(v)):
            return None, None  # nan/inf → null per row; defer
        return v, True
    return None, None


_VEC_FNS = frozenset((
    "abs", "ceil", "floor", "round", "sign", "sqrt", "log", "log10",
    "sin", "cos", "tan", "atan", "degrees", "radians", "tofloat",
    "tointeger", "type",
))


def _tointeger_num_tv(v: TV) -> TV | None:
    """Numeric toInteger over an ALREADY-evaluated TV (the string fast
    path evaluated the argument once; falling through to the generic
    branch would evaluate it again)."""
    if v.kind == NULLK:
        return v
    if v.kind != NUM:
        return None
    with np.errstate(invalid="ignore", over="ignore"):
        vals, is_int = _vec_num_fn("tointeger", v.vals, v.is_int)
    if vals is None:
        return None
    if is_int and v.num_mixed:
        return None  # exactness depends on per-element source types
    if is_int and np.any(np.abs(vals[~v.null]) >= 2**53):
        return None
    return TV(NUM, vals, v.null.copy(), is_int=bool(is_int))


def _call_tv(e, batch, ctx) -> TV | None:
    name = e.name
    if name == "coalesce":
        # per-row first non-null across args; kinds only have to agree on
        # rows actually filled.  All args evaluate (no early exit) so an
        # arg that fails to typify still routes to the object oracle.
        out = None
        for a in e.args:
            tv = eval_typed(a, batch, ctx)
            if tv is None:
                return None
            if tv.kind == NULLK:
                continue
            if tv.num_mixed:
                return None
            if out is None:
                out = TV(tv.kind, tv.vals.copy(), tv.null.copy(),
                         is_int=tv.is_int)
                continue
            fill = out.null & ~tv.null
            if not fill.any():
                continue
            if tv.kind != out.kind or (
                    out.kind == NUM and out.is_int != tv.is_int):
                return None
            out.vals[fill] = tv.vals[fill]
            out.null &= ~fill
        return out if out is not None else _all_null(batch.n)
    if name == "tostring" and len(e.args) == 1:
        v = eval_typed(e.args[0], batch, ctx)
        if v is None or v.kind == NULLK:
            return v
        if v.kind == NUM and v.is_int and not v.num_mixed:
            # C-speed int formatting (np U-cast); numpy.str_ IS a str.
            # Null rows may carry NaN (e.g. int division by a null) —
            # substitute before the cast so it can't warn
            vals = v.vals
            if v.null.any():
                vals = np.where(v.null, 0.0, vals)
            sa = vals.astype(np.int64).astype("U21").astype(object)
            if v.null.any():
                sa[v.null] = ""
            return TV(STR, sa, v.null.copy())
        if v.kind == STR:
            return v
        return None
    if name == "tointeger" and len(e.args) == 1:
        v = eval_typed(e.args[0], batch, ctx)
        if v is None:
            return None
        if v.kind == STR:
            # strict numpy integer parse; ANY non-plain-int string
            # (floats, exponents, junk) falls back to the object oracle
            u = v.vals.astype(str)  # fresh array (dtype change copies)
            if v.null.any():
                u[v.null] = "0"
            try:
                iv = u.astype(np.int64)
            except (ValueError, OverflowError):
                return None
            # NOTE np.abs(INT64_MIN) wraps negative: check both bounds
            if len(iv) and (int(iv.max()) >= 2**53
                            or int(iv.min()) <= -(2**53)):
                return None
            return TV(NUM, iv.astype(np.float64), v.null.copy(),
                      is_int=True)
        return _tointeger_num_tv(v)
    if name == "haslabels" and len(e.args) == 2 \
            and isinstance(e.args[1], A.Lit):
        # planner label filter (_label_filter): vectorized bitmask probe
        # instead of per-row NodeVal materialization + list scan
        v = eval_typed(e.args[0], batch, ctx)
        if v is None or v.kind != NODE:
            return None
        g = ctx.store
        ids = v.vals
        ok = np.ones(len(ids), dtype=bool)
        safe = np.clip(ids, 0, max(g.node_cap - 1, 0))
        for lname in e.args[1].value:
            lid = g.schema.label_id(lname)
            m = g.label_masks.get(lid) if lid is not None else None
            if m is None:
                ok[:] = False
                break
            ok &= m[safe]
        return TV(BOOL, (ok & ~v.null).astype(np.uint8), v.null.copy())
    if name not in _VEC_FNS or len(e.args) != 1:
        return None
    if name == "type":
        v = eval_typed(e.args[0], batch, ctx)
        if v is None or v.kind not in (EDGE, NULLK):
            return None
        if v.kind == NULLK:
            return v
        g = ctx.store
        ids = v.vals
        safe = np.clip(ids, 0, len(g.e_type) - 1)
        tids = g.e_type[safe]
        out = np.empty(len(ids), dtype=object)
        names = {int(t): g.schema.reltypes.name(int(t))
                 for t in np.unique(tids)}
        for i, t in enumerate(tids):  # few distinct types; dict lookup
            out[i] = names[int(t)] if not v.null[i] else ""
        return TV(STR, out, v.null.copy())
    v = eval_typed(e.args[0], batch, ctx)
    if v is None:
        return None
    if v.kind == NULLK:
        return v
    if v.kind != NUM:
        return None  # object path raises the right type error
    with np.errstate(invalid="ignore", over="ignore"):
        vals, is_int = _vec_num_fn(name, v.vals, v.is_int)
    if vals is None:
        return None
    if is_int and v.num_mixed and name in ("abs", "tointeger"):
        return None  # exactness depends on per-element source types
    if is_int and np.any(np.abs(vals[~v.null]) >= 2**53):
        return None
    return TV(NUM, vals, v.null.copy(), is_int=bool(is_int))


def tv_to_column(tv: TV) -> Column | None:
    """TV → object-array Column (the typed fast path's exit back into the
    object pipeline).  None when reconstruction would lose type fidelity
    (mixed int/float numerics)."""
    n = len(tv.null)
    if tv.kind == NULLK:
        out = np.empty(n, dtype=object)
        out.fill(None)
        return Column("value", data=out)
    if tv.kind in (NODE, EDGE):
        return None  # callers keep entity columns in id form
    if tv.kind == NUM and tv.num_mixed:
        return None
    out = np.empty(n, dtype=object)
    if tv.kind == NUM:
        if tv.is_int:
            out[:] = tv.vals.astype(np.int64).tolist()
        else:
            out[:] = tv.vals.tolist()
    elif tv.kind == BOOL:
        out[:] = tv.vals.astype(bool).tolist()
    else:  # STR
        out[:] = tv.vals
    if tv.null.any():
        out[tv.null] = None
    col = Column("value", data=out)
    try:
        col._tv = tv
    except AttributeError:
        pass
    return col


def _lit_tv(v, n) -> TV | None:
    null = np.zeros(n, dtype=bool)
    if v is None:
        return _all_null(n)
    if isinstance(v, bool):
        return TV(BOOL, np.full(n, 1 if v else 0, dtype=np.uint8), null)
    if isinstance(v, (int, np.integer)):
        if not (-(2**53) < v < 2**53):
            return None
        return TV(NUM, np.full(n, float(v)), null, is_int=True)
    if isinstance(v, (float, np.floating)):
        if v != v:
            return None
        return TV(NUM, np.full(n, float(v)), null)
    if isinstance(v, str):
        vals = np.empty(n, dtype=object)
        vals.fill(v)
        return TV(STR, vals, null)
    return None


def _binary_tv(e, batch, ctx) -> TV | None:
    op = e.op
    if op in _BOOLOPS:
        l = eval_typed(e.left, batch, ctx)
        if l is None:
            return None
        r = eval_typed(e.right, batch, ctx)
        if r is None:
            return None
        return _bool3_combine(op, l, r, batch.n)
    if op in _CMP or op in ("+", "-", "*", "/", "%", "^", "IN", "STARTS",
                            "ENDS", "CONTAINS"):
        l = eval_typed(e.left, batch, ctx)
        if l is None:
            return None
        if op == "IN":
            return _in_tv(l, e.right, batch, ctx)
        r = eval_typed(e.right, batch, ctx)
        if r is None:
            return None
        if op in _CMP:
            return _cmp_tv(op, l, r, batch.n)
        if op in ("+", "-", "*", "/", "%", "^"):
            return _arith_tv(op, l, r)
        return _substr_tv(op, l, r, batch.n)
    return None


def _bool3_combine(op, l, r, n) -> TV | None:
    for v in (l, r):
        if v.kind not in (BOOL, NULLK):
            return None
    lv = np.zeros(n, np.uint8) if l.kind == NULLK else l.vals
    rv = np.zeros(n, np.uint8) if r.kind == NULLK else r.vals
    lt = lv.astype(bool) & ~l.null
    lf = ~lv.astype(bool) & ~l.null
    rt = rv.astype(bool) & ~r.null
    rf = ~rv.astype(bool) & ~r.null
    if op == "AND":  # Kleene: F dominates, then null
        out_t = lt & rt
        null = ~(lf | rf) & (l.null | r.null)
    elif op == "OR":
        out_t = lt | rt
        null = ~(lt | rt) & (l.null | r.null)
    else:  # XOR: null-propagating
        null = l.null | r.null
        out_t = (lt ^ rt) & ~null
    return TV(BOOL, out_t.astype(np.uint8), null)


def _cmp_tv(op, l, r, n) -> TV | None:
    null = l.null | r.null
    lk = l.kind if l.kind != NULLK else r.kind
    rk = r.kind if r.kind != NULLK else l.kind
    if lk == NULLK:  # both null literals
        return _all_null(n)
    if lk != rk or lk in (NODE, EDGE) and op not in ("=", "<>"):
        if op in ("=", "<>"):
            # cross-type equality is plain False (value.py equals)
            if NULLK in (l.kind, r.kind):
                return _all_null(n)
            res = np.zeros(n, dtype=bool) if op == "=" else \
                np.ones(n, dtype=bool)
            return TV(BOOL, res.astype(np.uint8), null)
        # cross-type ordering → null
        return _all_null(n)
    if l.kind == NULLK or r.kind == NULLK:
        return _all_null(n)
    a, b = l.vals, r.vals
    if op == "=":
        res = a == b
    elif op == "<>":
        res = a != b
    elif op == "<":
        res = a < b
    elif op == "<=":
        res = a <= b
    elif op == ">":
        res = a > b
    else:
        res = a >= b
    return TV(BOOL, np.asarray(res, dtype=bool).astype(np.uint8), null)


def _arith_tv(op, l, r) -> TV | None:
    if l.kind == NULLK or r.kind == NULLK:
        return _all_null(len(l.null))
    if l.kind != NUM or r.kind != NUM:
        return None
    null = l.null | r.null
    both_int = l.is_int and r.is_int
    if op == "+":
        v = l.vals + r.vals
    elif op == "-":
        v = l.vals - r.vals
    elif op == "*":
        v = l.vals * r.vals
    elif op in ("/", "%"):
        # any zero divisor defers to the object path (int/int raises;
        # float semantics return inf/nan for / but raise for %)
        if bool(np.any((r.vals == 0.0) & ~null)):
            return None
        # null rows may still hold 0 divisors — silence their lane only
        # (the non-null zero-divisor case deferred above)
        with np.errstate(divide="ignore", invalid="ignore"):
            if op == "/":
                q = l.vals / r.vals
                # Cypher integer division truncates toward zero; within
                # the ±2^53 guard float division cannot round across the
                # integer being truncated to, so trunc is exact
                v = np.trunc(q) if both_int else q
            else:
                v = np.fmod(l.vals, r.vals)  # C-style, matches math.fmod
    else:  # ^ — always float; negative base with fractional exponent
        # diverges from float.__pow__ (which raises) → defer
        frac = r.vals != np.trunc(r.vals)
        if bool(np.any((l.vals < 0) & frac & ~null)):
            return None
        with np.errstate(invalid="ignore", over="ignore",
                         divide="ignore"):
            v = np.power(l.vals, r.vals)
        return TV(NUM, v, null)
    is_int = both_int
    if is_int and np.any(np.abs(v) >= 2**53):
        return None  # would lose exactness; defer to bigint path
    return TV(NUM, v, null, is_int=is_int,
              num_mixed=l.num_mixed or r.num_mixed)


def _in_tv(l, right_expr, batch, ctx) -> TV | None:
    if not isinstance(right_expr, (A.Lit, A.Param)):
        if not isinstance(right_expr, A.ListLit):
            return None
        items = []
        for it in right_expr.items:
            if not isinstance(it, A.Lit):
                return None
            items.append(it.value)
    else:
        items = right_expr.value if isinstance(right_expr, A.Lit) else \
            ctx.params.get(right_expr.name)
    if not isinstance(items, (list, tuple)):
        return None
    if any(v is None for v in items):
        return None  # null-in-list semantics → fallback
    n = batch.n
    if l.kind == NULLK:
        if len(items) == 0:
            return TV(BOOL, np.zeros(n, np.uint8), np.zeros(n, dtype=bool))
        return _all_null(n)
    if l.kind == NUM:
        nums = [v for v in items
                if isinstance(v, (int, float)) and not isinstance(v, bool)
                and v == v]
        res = np.isin(l.vals, np.asarray(nums, dtype=np.float64)) \
            if nums else np.zeros(n, dtype=bool)
    elif l.kind == STR:
        strs = set(v for v in items if isinstance(v, str))
        res = np.array([s in strs for s in l.vals], dtype=bool)
    else:
        return None
    return TV(BOOL, res.astype(np.uint8), l.null.copy())


def _substr_tv(op, l, r, n) -> TV | None:
    if l.kind == NULLK or r.kind == NULLK:
        return _all_null(n)
    if l.kind != STR or r.kind != STR:
        return _all_null(n)  # non-string operand → null (eval.py:501-510)
    f = {"STARTS": str.startswith, "ENDS": str.endswith,
         "CONTAINS": str.__contains__}[op]
    ufn = np.frompyfunc(f, 2, 1)
    res = ufn(l.vals, r.vals).astype(bool)
    return TV(BOOL, res.astype(np.uint8), l.null | r.null)


def predicate_mask(e, batch: Batch, ctx) -> np.ndarray | None:
    """WHERE fast path: boolean keep-mask (True only where predicate is
    exactly true); None → use evaluate_predicate."""
    tv = eval_typed(e, batch, ctx)
    if tv is None:
        return None
    if tv.kind == NULLK:
        return np.zeros(batch.n, dtype=bool)
    if tv.kind != BOOL:
        return None
    return tv.vals.astype(bool) & ~tv.null


# -------------------------------------------------------------- group codes


def group_codes(tvs: list[TV], n: int | None = None):
    """Row-wise group codes from typed key columns.

    Returns (codes int64[n], uniq_rows int64[g] indices of first occurrence
    per group, in first-seen order).  Codes index into first-seen order."""
    if n is None:
        n = len(tvs[0].null) if tvs else 0
    mats = []
    for tv in tvs:
        if tv.kind == NUM:
            if tv.is_int:
                # integer VALUES (not float bit patterns): keeps the
                # value range bounded so the single-key path below can
                # group via a presence table instead of a sort
                bits = tv.vals.astype(np.int64)
            else:
                v = np.where(tv.vals == 0.0, 0.0, tv.vals)  # -0.0 → +0.0
                bits = v.view(np.int64).copy()
        elif tv.kind == STR:
            _, inv = np.unique(tv.vals.astype(str), return_inverse=True)
            bits = inv.astype(np.int64)
        elif tv.kind == BOOL:
            bits = tv.vals.astype(np.int64)
        elif tv.kind in (NODE, EDGE):
            bits = tv.vals.astype(np.int64)
        else:  # NULLK
            bits = np.zeros(n, dtype=np.int64)
        bits = np.where(tv.null, np.int64(-(2**62)), bits)
        mats.append(bits)
        if tv.null.any():
            # the sentinel collides with a legitimate bit pattern (e.g.
            # float -2.0 views as -(2^62)); a null column disambiguates —
            # but only when nulls actually occur
            mats.append(tv.null.astype(np.int64))
    if not mats:
        # no group keys: one global group (first row is the representative)
        return (np.zeros(n, dtype=np.int64),
                np.zeros(1 if n else 0, np.int64))
    if len(mats) == 1:
        m0 = mats[0]
        lo = int(m0.min()) if len(m0) else 0
        hi = int(m0.max()) if len(m0) else 0
        span = hi - lo + 1
        if 0 < span <= max(4 * n, 1 << 22):
            # bounded integer range: O(n + span) presence-table grouping
            # replaces np.unique's argsort (LDBC agg at SF1: 1.7M-key
            # sort was ~30% of the query)
            off = m0 - lo
            present = np.zeros(span, dtype=bool)
            present[off] = True
            rank = np.cumsum(present) - 1
            inv = rank[off]
            u = int(present.sum())
            first = np.full(u, len(m0), dtype=np.int64)
            np.minimum.at(first, inv, np.arange(len(m0)))
        else:
            # single int64 key: C-typed unique beats the record-array
            # sort 5x
            _, first, inv = np.unique(m0, return_index=True,
                                      return_inverse=True)
    else:
        # multi-key: lexsort int64 columns (still far cheaper than the
        # void-record comparison sort); stable → order[boundary] is the
        # first occurrence per group
        order = np.lexsort(mats[::-1])
        neq = np.zeros(n, dtype=bool)
        neq[0] = n > 0
        for m in mats:
            ms = m[order]
            neq[1:] |= ms[1:] != ms[:-1]
        gid_sorted = np.cumsum(neq) - 1
        inv = np.empty(n, dtype=np.int64)
        inv[order] = gid_sorted
        first = order[neq]
    # group ids must index in first-seen order; remap
    order2 = np.argsort(first, kind="stable")
    rank = np.empty_like(order2)
    rank[order2] = np.arange(len(order2))
    return rank[inv], first[order2]


def sort_keys(tvs: list[TV], ascs: list[bool]) -> list[np.ndarray] | None:
    """Arrays for np.lexsort implementing ORDER BY total order
    (value.py order_key: values first, null last in ASC; DESC reverses).
    Returned most-significant-first; pass reversed to np.lexsort."""
    keys = []
    for tv, asc in zip(tvs, ascs):
        if tv.kind == NUM:
            v = tv.vals.copy()
        elif tv.kind == STR:
            _, inv = np.unique(tv.vals.astype(str), return_inverse=True)
            v = inv.astype(np.float64)  # codes are order-isomorphic
        elif tv.kind == BOOL:
            v = tv.vals.astype(np.float64)
        elif tv.kind in (NODE, EDGE):
            v = tv.vals.astype(np.float64)
        elif tv.kind == NULLK:
            v = np.zeros(len(tv.null))
        else:
            return None
        v = np.where(tv.null, 0.0, v)  # nulls tie on value; rank decides
        nullr = tv.null.astype(np.float64)
        if not asc:
            v = -v
            nullr = -nullr
        keys.append(nullr)  # major within the key: null rank
        keys.append(v)
    return keys
