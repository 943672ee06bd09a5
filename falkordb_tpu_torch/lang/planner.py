"""Binder + planner: AST → operator tree.

Combines the reference's binder (graph/src/planner/binder.rs — name
resolution, scoping across WITH/RETURN, validation) and planner
(graph/src/planner/mod.rs — IR construction) into one pass producing
runtime operators directly.  Scan selection and traverse chaining follow
the reference's select_scan_node / fuse strategy in spirit.
"""

from __future__ import annotations

import contextvars
import dataclasses
from typing import Callable, Optional

import numpy as np

from falkordb_tpu_torch.lang import ast as A
from falkordb_tpu_torch.runtime import ops as O
from falkordb_tpu_torch.runtime.batch import Batch, Column
from falkordb_tpu_torch.runtime.eval import contains_aggregate, AGG_FNS


class PlanError(ValueError):
    pass


class Scope:
    """name → slot map; WITH/RETURN open fresh scopes."""

    def __init__(self, counter):
        self.vars: dict[str, int] = {}
        self.kinds: dict[int, str] = {}  # slot -> 'node'|'edge'|'value'|'path'
        self._counter = counter

    def fresh(self) -> int:
        s = self._counter[0]
        self._counter[0] += 1
        return s

    def get(self, name) -> Optional[int]:
        return self.vars.get(name)

    def declare(self, name, kind="value") -> int:
        s = self.fresh()
        self.vars[name] = s
        self.kinds[s] = kind
        return s

    def child(self) -> "Scope":
        return Scope(self._counter)


# ---------------------------------------------------------------- expression
# binding: annotate Var nodes with slots


def bind_expr(e, scope: Scope):
    if isinstance(e, A.Var):
        if e.name.startswith("_slot") and getattr(e, "slot", None) is not None:
            return  # synthetic slot var injected by aggregate extraction
        slot = scope.get(e.name)
        if slot is None:
            raise PlanError(f"'{e.name}' not defined")
        e.slot = slot
        return
    if isinstance(e, A.Prop) and isinstance(e.obj, A.Var):
        bind_expr(e.obj, scope)
        slot = getattr(e.obj, "slot", None)
        # TCK MatchWhere1 [14]: paths have no properties — compile error
        if slot is not None and scope.kinds.get(slot) == "path":
            raise PlanError("type mismatch: expected Node or Relationship "
                            "but was Path")
        return
    if isinstance(e, A.FnCall) and e.args and isinstance(e.args[0], A.Var):
        for f in dataclasses.fields(e):
            _bind_value(getattr(e, f.name), scope, e)
        # argument-kind type errors at compile time (TCK Graph4 [7],
        # Path3 [2]/[3], List6 [5]: TypeError "at any time" must fire
        # even when the MATCH is empty)
        slot = getattr(e.args[0], "slot", None)
        kind = scope.kinds.get(slot) if slot is not None else None
        bad = {"type": ("node", "path"), "labels": ("edge", "path"),
               "length": ("node", "edge"), "size": ("path",),
               "nodes": ("node", "edge"), "relationships": ("node", "edge")}
        if kind in bad.get(e.name, ()):
            raise PlanError(f"type mismatch: {e.orig or e.name}() cannot "
                            f"take a {kind} argument")
        return
    if isinstance(e, (A.ListComp, A.Quantifier, A.Reduce)) or (
            isinstance(e, A.ExistsExpr) and e.pattern is not None):
        _bind_value(e, scope, None)
        return
    if isinstance(e, A.PatternComp):
        e._outer_vars = dict(scope.vars)
        e._counter = scope._counter
        return
    if isinstance(e, A.ShortestPathExpr):
        # expression position (eval.rs:1292): both endpoints must already
        # be bound node variables; resolve their slots now
        els = e.pattern.elements
        if len(els) != 3 or not isinstance(els[1], A.RelPattern):
            raise PlanError(
                "shortestPath expects a single relationship pattern")
        for el, attr in ((els[0], "_src_var"), (els[2], "_dst_var")):
            if not el.var or scope.get(el.var) is None:
                raise PlanError("A shortestPath requires bound nodes")
            v = A.Var(el.var)
            v.slot = scope.get(el.var)
            setattr(e, attr, v)
        return
    for f in dataclasses.fields(e) if dataclasses.is_dataclass(e) else []:
        v = getattr(e, f.name)
        _bind_value(v, scope, e)


def _bind_value(v, scope, parent):
    if isinstance(v, A.Expr):
        if isinstance(v, (A.ListComp, A.Quantifier)):
            # TCK List12 [7]: aggregations are invalid inside list
            # comprehensions
            if isinstance(v, A.ListComp) and (
                    (v.projection is not None
                     and contains_aggregate(v.projection))
                    or (v.where is not None
                        and contains_aggregate(v.where))):
                raise PlanError(
                    "invalid use of aggregating function in a list "
                    "comprehension")
            _bind_value(v.source, scope, v)
            inner = scope.child()
            inner.vars = dict(scope.vars)
            # comprehension variable resolves through batch._aux by name
            if v.var in inner.vars:
                del inner.vars[v.var]
            if isinstance(v, A.ListComp):
                if v.where is not None:
                    _bind_comp_body(v.where, inner, v.var)
                if v.projection is not None:
                    _bind_comp_body(v.projection, inner, v.var)
            else:
                if v.where is not None:
                    _bind_comp_body(v.where, inner, v.var)
            return
        if isinstance(v, A.Reduce):
            _bind_value(v.source, scope, v)
            _bind_value(v.init, scope, v)
            inner = scope.child()
            inner.vars = dict(scope.vars)
            for nm in (v.var, v.acc):
                if nm in inner.vars:
                    del inner.vars[nm]
            _bind_comp_body(v.step, inner, v.var, v.acc)
            return
        if isinstance(v, A.ExistsExpr) and v.pattern is not None:
            _bind_pattern_expr(v, scope)
            return
        if isinstance(v, A.PatternComp):
            v._outer_vars = dict(scope.vars)
            v._counter = scope._counter
            return
        bind_expr(v, scope)
        return
    if isinstance(v, list):
        for x in v:
            _bind_value(x, scope, parent)
        return
    if isinstance(v, tuple):
        for x in v:
            _bind_value(x, scope, parent)
        return


def _bind_comp_body(e, scope, *local_names):
    """Bind an expression where `local_names` resolve via batch._aux."""
    if isinstance(e, A.Var):
        if e.name in local_names or scope.get(e.name) is None:
            e.slot = None  # force aux lookup
            if e.name not in local_names and scope.get(e.name) is None:
                raise PlanError(f"'{e.name}' not defined")
        else:
            e.slot = scope.get(e.name)
        return
    if isinstance(e, (A.ListComp, A.Quantifier)):
        # nested comprehension: its variable joins the outer locals
        _bind_comp_body(e.source, scope, *local_names)
        inner = local_names + (e.var,)
        if e.where is not None:
            _bind_comp_body(e.where, scope, *inner)
        if isinstance(e, A.ListComp) and e.projection is not None:
            _bind_comp_body(e.projection, scope, *inner)
        return
    if isinstance(e, A.Reduce):
        _bind_comp_body(e.source, scope, *local_names)
        _bind_comp_body(e.init, scope, *local_names)
        _bind_comp_body(e.step, scope, *(local_names + (e.var, e.acc)))
        return
    if dataclasses.is_dataclass(e):
        for f in dataclasses.fields(e):
            v = getattr(e, f.name)
            if isinstance(v, A.Expr):
                _bind_comp_body(v, scope, *local_names)
            elif isinstance(v, (list, tuple)):
                for x in v:
                    if isinstance(x, A.Expr):
                        _bind_comp_body(x, scope, *local_names)
                    elif isinstance(x, tuple):
                        for y in x:
                            if isinstance(y, A.Expr):
                                _bind_comp_body(y, scope, *local_names)


def _bind_pattern_expr(v: A.ExistsExpr, scope: Scope):
    """EXISTS((n)-[:R]->(m)): bind shared vars to outer slots; free vars are
    existential.  Stash the scope snapshot for lazy planning."""
    v._outer_vars = dict(scope.vars)
    v._counter = scope._counter
    if v.where is not None:
        pass  # bound at plan time with inner scope


# ------------------------------------------------------------------ patterns


def _annotate_path(path: A.PatternPath, scope: Scope):
    """Assign slots to pattern elements; mark pre-bound ones."""
    seen_edge_vars: set = set()
    for el in path.elements:
        if not isinstance(el, A.NodePattern) and el.var is not None:
            # SyntaxError RelationshipUniquenessViolation (TCK Match3
            # [29]): a relationship variable cannot repeat within one
            # pattern path — it could never match (edge uniqueness)
            if el.var in seen_edge_vars:
                raise PlanError(
                    f"cannot use the same relationship variable "
                    f"{el.var!r} for multiple relationships")
            seen_edge_vars.add(el.var)
    for el in path.elements:
        if isinstance(el, A.NodePattern):
            if el.var is not None:
                slot = scope.get(el.var)
                if slot is not None:
                    # VariableTypeConflict (TCK Match1 [8]/[10]): a name
                    # bound to a relationship or a path cannot re-bind as
                    # a node in a later pattern element
                    if scope.kinds.get(slot) in ("edge", "path", "varlen"):
                        raise PlanError(
                            f"variable {el.var!r} already bound to a "
                            f"{scope.kinds.get(slot)}")
                    el._slot = slot
                    el._bound = True
                else:
                    el._slot = scope.declare(el.var, "node")
                    el._bound = False
            else:
                el._slot = scope.fresh()
                el._bound = False
        else:
            if el.var is not None:
                slot = scope.get(el.var)
                if slot is not None:
                    if scope.kinds.get(slot) in ("node", "path"):
                        raise PlanError(
                            f"variable {el.var!r} already bound to a "
                            f"{scope.kinds.get(slot)}")
                    el._slot = slot
                    el._bound = True
                else:
                    el._slot = scope.declare(
                        el.var, "varlen" if el.varlen else "edge")
                    el._bound = False
            else:
                el._slot = None if not el.varlen else None
                el._bound = False
    if path.var is not None:
        slot = scope.get(path.var)
        if slot is not None:
            raise PlanError(f"variable {path.var!r} already bound")
        path._slot = scope.declare(path.var, "path")
    else:
        path._slot = None


def _plan_path_ops(path: A.PatternPath, root: O.Op, scope: Scope,
                   known_bound: set[int], start_filters=None) -> O.Op:
    """Chain scan/traverse ops for one pattern path.  `start_filters` are
    conjuncts over ONLY the start slot (e.g. hoisted inline props that no
    index could serve) — applied immediately after the start binds, so a
    var-len/multi-hop chain never expands the unfiltered scan (r5 find:
    the deferred filter ran MATCH (a:N {id:7})-[:E*1..2]->(b) from every
    node)."""
    els = path.elements
    if path.shortest is not None:
        return _plan_shortest(path, root, scope, known_bound)
    if path._slot is not None:
        # named paths need every element addressable — give anonymous
        # var-len edges a slot so their edge lists materialize for
        # PathBuild (TCK Path3 [1]: p = (a)-[*0..1]->(b))
        for el in els:
            if not isinstance(el, A.NodePattern) and el._slot is None:
                el._slot = scope.fresh()
    # pick start: bound node > labeled node > any (select_scan_node)
    start_el = _choose_start(path, known_bound)
    start_idx = els.index(start_el) if start_el is not None else 0
    op = root
    start = els[start_idx]
    post_filters: list = []
    if start._slot not in known_bound:
        if start.labels:
            ordered = _order_labels(start.labels)
            op = O.LabelScan(start._slot, start.var or "", ordered[0], op)
            for extra in ordered[1:]:
                op = _mk_filter(op, _label_filter(start, [extra]))
        else:
            op = O.AllNodeScan(start._slot, start.var or "", op)
        known_bound.add(start._slot)
    else:
        if start.labels:
            op = _mk_filter(op, _label_filter(start, start.labels))
    if start.props is not None and not getattr(start, "_props_hoisted",
                                               False):
        # anchor filters apply BEFORE the chain: deferring them ran
        # var-len/multi-hop traversals from every scanned node and
        # filtered at the end (r5 find: MATCH (a:N {id:7})-[:E*1..2]->(b)
        # expanded the whole graph)
        op = _mk_filter(op, _props_filter(start))
    for f in (start_filters or ()):
        op = _mk_filter(op, f)
    # expand right then left of start
    can_fuse = path._slot is None
    op = self_expand = _expand_chain(op, els, start_idx, +1, scope,
                                     known_bound, post_filters, can_fuse)
    op = _expand_chain(op, els, start_idx, -1, scope, known_bound,
                       post_filters, can_fuse)
    for f in post_filters:
        op = _mk_filter(op, f)
    post_filters.clear()
    if path._slot is not None:
        element_slots = []
        for el in els:
            kind = "node" if isinstance(el, A.NodePattern) else "edge"
            slot = el._slot
            if slot is None:
                raise PlanError("named paths require addressable elements")
            element_slots.append((kind, slot))
        op = O.PathBuild(op, path._slot, element_slots)
    return op


def _expand_chain(op, els, start_idx, step, scope, known_bound, post_filters,
                  can_fuse=False):
    i = start_idx
    prev = None          # Traverse created by the previous iteration
    prev_rel = None      # its rel AST element (chain-head candidate)
    prev_edge_anon = False
    while 0 <= i + 2 * step < len(els):
        rel = els[i + step]
        node = els[i + 2 * step]
        # direction relative to walk orientation
        direction = rel.direction
        if step < 0:
            direction = {"out": "in", "in": "out", "both": "both"}[direction]
        src = els[i]
        if rel._slot is None and (not rel.varlen or rel.props is not None):
            rel._slot = scope.fresh()
        dst_bound = node._slot in known_bound
        edge_anon = (rel.var is None and rel.props is None
                     and not rel._bound and not rel.varlen)
        # fuse_anonymous_traverse: ()-[]->()-[]->() with an anonymous,
        # prop-less intermediate node and anonymous edges collapses into
        # the previous Traverse as an algebraic chain (F·A1·A2·…).
        if (can_fuse and not rel.varlen and not dst_bound
                and op is prev and isinstance(op, O.Traverse)
                and prev_edge_anon and edge_anon
                and op.dst_slot == src._slot
                and src.var is None and src.props is None):
            op.chain.append((rel.types, direction, node.labels))
            op.dst_slot = node._slot
            op.dst_alias = node.var or ""
            rel._fused = True  # edge slot never bound (algebraic chain)
            if prev_rel is not None:
                # chain mode emits distinct endpoint pairs only: the HEAD
                # edge's slot is never materialized either, so the
                # uniqueness filter must not address it
                prev_rel._fused = True
            known_bound.add(node._slot)
            if node.props is not None:
                post_filters.append(_props_filter(node))
            i += 2 * step
            continue
        if rel.varlen:
            target_slot = node._slot if not dst_bound else scope.fresh()
            op = O.VarLenTraverse(
                op, src._slot, target_slot, rel._slot, rel.types, direction,
                rel.min_hops, rel.max_hops,
                node.labels if not dst_bound else [],
                reverse_trail=(step < 0),
            )
            if dst_bound:
                post_filters.append(_slot_eq(target_slot, node._slot))
                if node.labels:
                    # bound dst keeps its inline label predicate (TCK
                    # MatchWhere4 [2]: WHERE ... OR (a)-[:T*]->(b:Missing))
                    post_filters.append(_label_filter(node, node.labels))
        elif dst_bound and not rel._bound:
            op = O.ExpandInto(op, src._slot, node._slot, rel._slot,
                              rel.types, direction)
            if node.labels:
                post_filters.append(_label_filter(node, node.labels))
        else:
            target_slot = node._slot
            op = O.Traverse(
                op, src._slot, target_slot, rel._slot, rel.types, direction,
                node.labels, src.var or "", node.var or "",
            )
        if rel._bound and not rel.varlen:
            pass  # shared edge var: equality enforced below
        if not dst_bound:
            known_bound.add(node._slot)
        if rel.props is not None:
            if rel.varlen:
                # absorb_edge_filters_into_vlt semantics: every edge on the
                # path must satisfy the inline props (all() quantifier over
                # the collected edge list)
                post_filters.append(_varlen_props_filter(rel))
            else:
                post_filters.append(_rel_props_filter(rel))
        if node.props is not None and not dst_bound:
            post_filters.append(_props_filter(node))
        elif node.props is not None and dst_bound:
            post_filters.append(_props_filter(node))
        prev = op if isinstance(op, O.Traverse) else None
        prev_rel = rel if prev is not None else None
        prev_edge_anon = edge_anon
        i += 2 * step
    return op


def _label_filter(node, labels):
    v = A.Var(node.var or f"_anon{node._slot}")
    v.slot = node._slot
    return A.FnCall("haslabels", [v, A.Lit(list(labels))])


def _slot_eq(slot_a, slot_b):
    va = A.Var("_a")
    va.slot = slot_a
    vb = A.Var("_b")
    vb.slot = slot_b
    return A.Binary("=", va, vb)


def _props_filter(el):
    v = A.Var(el.var or "_anon")
    v.slot = el._slot
    return _props_filter_on(v, el.props)


def _rel_props_filter(el):
    v = A.Var(el.var or "_anon")
    v.slot = el._slot
    return _props_filter_on(v, el.props)


def _varlen_props_filter(el):
    """Var-length inline props: all edges on the trail must match."""
    lst = A.Var(el.var or f"_vlt{el._slot}")
    lst.slot = el._slot
    edge = A.Var("_vlt_edge")
    where = _props_filter_on(edge, el.props)
    q = A.Quantifier("all", "_vlt_edge", lst, where)
    # pre-bind: the quantifier body resolves _vlt_edge via batch aux
    _mark_aux_var(where, "_vlt_edge")
    return q


def _mark_aux_var(e, name):
    if isinstance(e, A.Var):
        if e.name == name:
            e.slot = None
        return
    if dataclasses.is_dataclass(e):
        for f in dataclasses.fields(e):
            v = getattr(e, f.name)
            if isinstance(v, A.Expr):
                _mark_aux_var(v, name)
            elif isinstance(v, (list, tuple)):
                for x in v:
                    if isinstance(x, A.Expr):
                        _mark_aux_var(x, name)


def _props_filter_on(var, props):
    if isinstance(props, A.Param):
        # {$param} — runtime map equality on all keys
        return A.FnCall("_propsmatch", [var, props])
    if not isinstance(props, A.MapLit):
        raise PlanError("inline properties must be a map")
    cond = None
    for k, ve in props.items:
        c = A.Binary("=", A.Prop(var, k), ve)
        cond = c if cond is None else A.Binary("AND", cond, c)
    return cond if cond is not None else A.Lit(True)


# ------------------------------------------------------------------- planner


class PlannedQuery:
    def __init__(self, root, columns, is_write, union_next=None,
                 union_all=False, ddl=None):
        self.root = root
        self.columns = columns  # [(slot, name)]
        self.is_write = is_write
        self.union_next = union_next
        self.union_all = union_all
        self.ddl = ddl  # list of (kind, clause) DDL side-effects

    def explain(self) -> str:
        lines = ["Results"] if self.columns else []
        if self.root is not None:
            lines = self.root.tree_lines()
        return "\n".join(lines)


WRITE_CLAUSES = (A.CreateClause, A.MergeClause, A.DeleteClause, A.SetClause,
                 A.RemoveClause, A.ForeachClause, A.CreateIndexClause,
                 A.DropIndexClause)


def is_write_query(q: A.Query) -> bool:
    def _w(qq):
        for c in qq.clauses:
            if isinstance(c, WRITE_CLAUSES):
                return True
            if isinstance(c, A.CallSubquery) and _w(c.query):
                return True
            if isinstance(c, A.CallClause) and c.proc.startswith(
                    ("db.idx", "db.create", "udf.")):
                return True
        if qq.union_with is not None:
            return _w(qq.union_with)
        return False
    return _w(q)


_PLAN_STATS: "contextvars.ContextVar" = contextvars.ContextVar(
    "falkor_plan_stats", default=None)


def _order_labels(labels):
    """reorder_labels pass (reference: planner/optimizer/reorder_labels.rs
    — stable sort of a multi-label NodeByLabelScan's labels by schema
    label id, unknown labels last).  TPU-native extension: when label
    statistics are available the primary sort key is label CARDINALITY,
    so the scan runs over the cheapest label and the remaining labels
    become mask filters.  Label intersection is commutative, so a stale
    count snapshot can only affect speed, never results."""
    if len(labels) < 2:
        return list(labels)
    stats = _PLAN_STATS.get()

    def key(pair):
        i, lbl = pair
        if stats is None:
            return (0, 1 << 60, i)
        cnt, lid = stats.get(lbl, (float("inf"), 1 << 60))
        return (cnt, lid, i)

    return [lbl for _, lbl in sorted(enumerate(labels), key=key)]


def plan_query(q: A.Query, indexes=None, udf_lookup=None,
               stats=None) -> PlannedQuery:
    """stats: optional {label_name: (node_count, label_id)} snapshot used
    by the reorder_labels pass (plan-cache note: counts are not part of
    the cache key — reordering is a cost choice, not a semantic one)."""
    counter = [0]
    _validate_union_chain(q)
    _validate_functions(q, udf_lookup)
    tok = _PLAN_STATS.set(stats)
    try:
        return _plan_one(q, Scope(counter), counter, indexes)
    finally:
        _PLAN_STATS.reset(tok)


def _validate_union_chain(q: A.Query):
    """SyntaxError InvalidClauseComposition: UNION and UNION ALL cannot be
    combined in one query (TCK Union3 [1]/[2])."""
    flags = []
    node = q
    while node.union_with is not None:
        flags.append(bool(node.union_all))
        node = node.union_with
    if len(set(flags)) > 1:
        raise PlanError("cannot combine UNION and UNION ALL")


def _walk_ast(v, fn):
    if isinstance(v, A.Expr) or dataclasses.is_dataclass(v):
        if isinstance(v, A.Expr):
            fn(v)
        if dataclasses.is_dataclass(v):
            for f in dataclasses.fields(v):
                _walk_ast(getattr(v, f.name), fn)
    elif isinstance(v, (list, tuple)):
        for x in v:
            _walk_ast(x, fn)


def _validate_functions(q: A.Query, udf_lookup=None):
    """SyntaxError UnknownFunction at compile time (TCK Return2 [18]) —
    the reference resolves function names during binding
    (graph/src/planner/binder.rs)."""
    from falkordb_tpu_torch.runtime.functions import FUNCTIONS

    def check(e):
        if isinstance(e, A.FnCall):
            name = e.name
            if (name not in FUNCTIONS and name not in AGG_FNS
                    and not (udf_lookup is not None
                             and udf_lookup(e.orig or name))):
                raise PlanError(f"unknown function {e.orig or name}()")

    node = q
    while node is not None:
        for cl in node.clauses:
            _walk_ast(cl, check)
        node = node.union_with


def _reduce_count(q: A.Query, scope) -> PlannedQuery | None:
    """reduce_count pass: MATCH (n[:L]) RETURN count(*|n) → O(1) metadata."""
    if len(q.clauses) != 2 or q.union_with is not None:
        return None
    m, r = q.clauses
    if not (isinstance(m, A.MatchClause) and isinstance(r, A.ReturnClause)):
        return None
    if m.optional or m.where is not None or len(m.paths) != 1:
        return None
    path = m.paths[0]
    if len(path.elements) != 1 or path.var is not None:
        return None
    node = path.elements[0]
    if node.props is not None or len(node.labels) > 1:
        return None
    if r.star or len(r.items) != 1 or r.distinct or r.order_by or r.skip or r.limit:
        return None
    e = r.items[0].expr
    is_count = isinstance(e, A.CountStar) or (
        isinstance(e, A.FnCall) and e.name == "count" and not e.distinct
        and len(e.args) == 1 and isinstance(e.args[0], A.Var)
        and e.args[0].name == node.var)
    if not is_count:
        return None
    slot = scope.fresh()
    name = _proj_name(r.items[0])
    op = O.CountOnly(slot, node.labels[0] if node.labels else None)
    return PlannedQuery(O.Results(op, [(slot, name)]), [(slot, name)], False)


def _collect_exprs(v, out):
    if isinstance(v, A.Expr):
        out.append(v)
    elif isinstance(v, (list, tuple)):
        for x in v:
            _collect_exprs(x, out)
    elif isinstance(v, dict):
        for x in v.values():
            _collect_exprs(x, out)


def _has_lazy_pattern(e):
    """Expressions planned lazily against outer names (pattern
    comprehensions, EXISTS patterns) hide their slot usage."""
    if isinstance(e, A.PatternComp) or (
            isinstance(e, A.ExistsExpr) and e.pattern is not None):
        return True
    if dataclasses.is_dataclass(e):
        for f in dataclasses.fields(e):
            v = getattr(e, f.name)
            for x in (v if isinstance(v, (list, tuple)) else [v]):
                if isinstance(x, tuple):
                    if any(isinstance(y, A.Expr) and _has_lazy_pattern(y)
                           for y in x):
                        return True
                elif isinstance(x, A.Expr) and _has_lazy_pattern(x):
                    return True
    return False


def _reduce_var_len_path(root, columns):
    """reduce_var_len_path: clear CondVarLenTraverse's edge-list slot when
    no downstream operator consumes the alias, skipping per-row path
    materialization (reduce_var_len_path.rs).  Bails on any factory-bearing
    operator (Apply/Merge/Foreach/OptionalMatch/subquery) or lazily-planned
    pattern expression — their sub-plans are opaque to this analysis."""
    ops, stack = [], [root]
    while stack:
        op = stack.pop()
        ops.append(op)
        stack.extend(op.children())
    vlts = [op for op in ops if isinstance(op, O.VarLenTraverse)
            and op.edge_slot is not None]
    if not vlts:
        return
    used = {s for s, _ in columns}
    exprs: list = []
    for op in ops:
        for v in op.__dict__.values():
            if callable(v):
                return
            _collect_exprs(v, exprs)
    for e in exprs:
        if _has_lazy_pattern(e):
            return
        _slots_of(e, used)
    for op in ops:
        if isinstance(op, O.Distinct):
            used.update(op.slots)
        elif isinstance(op, O.PathBuild):
            used.update(s for _, s in op.element_slots)
        elif isinstance(op, (O.Traverse, O.VarLenTraverse, O.ExpandInto,
                             O.ShortestPath)):
            used.add(op.src_slot)
            if isinstance(op, (O.ExpandInto, O.ShortestPath)):
                used.add(op.dst_slot)
    for op in vlts:
        if op.edge_slot not in used:
            op.edge_slot = None


def _plan_one(q: A.Query, scope: Scope, counter, indexes=None) -> PlannedQuery:
    fast = _reduce_count(q, scope)
    if fast is not None:
        return fast
    root: O.Op = O.UnitRow()
    columns: list = []
    ddl: list = []
    is_write = is_write_query(q)
    saw_write = False
    for ci, clause in enumerate(q.clauses):
        if isinstance(clause, A.MatchClause) and saw_write:
            # clause barrier: this MATCH must see the completed effects
            # of earlier write clauses (TCK Create3 [3])
            root = O.Eager(root)
            saw_write = False
        if isinstance(clause, WRITE_CLAUSES):
            saw_write = True
        root, columns = _plan_clause(clause, root, scope, columns, ddl,
                                     indexes)
    if not columns and q.clauses and isinstance(q.clauses[-1], A.CallClause):
        # a terminal CALL with no RETURN emits its yields as the result set
        columns = list(getattr(q.clauses[-1], "_yield_cols", []))
    union_next = None
    if q.union_with is not None:
        nxt = _plan_one(q.union_with, Scope(counter).child(), counter, indexes)
        if [n for _, n in nxt.columns] != [n for _, n in columns]:
            raise PlanError("UNION branches must have identical column names")
        union_next = nxt
    _reduce_var_len_path(root, columns)
    return PlannedQuery(root, columns, is_write, union_next, q.union_all, ddl)


def _plan_clause(clause, root, scope, columns, ddl, indexes=None):
    if isinstance(clause, A.MatchClause):
        return _plan_match(clause, root, scope, indexes), columns
    if isinstance(clause, A.CreateClause):
        for path in clause.paths:
            _annotate_path(path, scope)
            _validate_create_path(path, scope)
        for path in clause.paths:
            bind_create_exprs(path, scope)
        return O.CreateOp(root, clause.paths), columns
    if isinstance(clause, A.MergeClause):
        return _plan_merge(clause, root, scope), columns
    if isinstance(clause, A.DeleteClause):
        for e in clause.exprs:
            bind_expr(e, scope)
        for de in clause.exprs:
            # SyntaxError InvalidDelete (TCK Delete1 [8]): DELETE n:Label
            # parses as a label predicate — not a deletable expression
            if isinstance(de, A.FnCall) and de.name == "haslabels":
                raise PlanError("DELETE cannot delete labels (use REMOVE)")
        return O.DeleteOp(root, clause.exprs, clause.detach), columns
    if isinstance(clause, A.SetClause):
        def _no_patterns(v):
            if isinstance(v, A.ExistsExpr) and v.pattern is not None:
                # SyntaxError UnexpectedSyntax (TCK Pattern1 [24]):
                # patterns are not value expressions in SET
                raise PlanError("pattern expressions cannot be used as "
                                "values in SET")
        for it in clause.items:
            if it.value is not None:
                _walk_ast(it.value, _no_patterns)
        for item in clause.items:
            bind_expr(item.target, scope)
            if item.value is not None:
                bind_expr(item.value, scope)
        return O.SetOp(root, clause.items), columns
    if isinstance(clause, A.RemoveClause):
        for item in clause.items:
            bind_expr(item.target, scope)
        return O.SetOp(root, clause.items), columns
    if isinstance(clause, (A.WithClause, A.ReturnClause)):
        return _plan_projection(clause, root, scope, columns)
    if isinstance(clause, A.UnwindClause):
        bind_expr(clause.expr, scope)
        slot = scope.declare(clause.alias, "value")
        return O.Unwind(root, clause.expr, slot), columns
    if isinstance(clause, A.CallClause):
        return _plan_call(clause, root, scope, ddl), columns
    if isinstance(clause, A.CallSubquery):
        return _plan_call_subquery(clause, root, scope), columns
    if isinstance(clause, A.ForeachClause):
        return _plan_foreach(clause, root, scope), columns
    if isinstance(clause, A.LoadCsvClause):
        bind_expr(clause.url, scope)
        if clause.field_terminator is not None:
            bind_expr(clause.field_terminator, scope)
        slot = scope.declare(clause.alias, "value")
        from falkordb_tpu_torch.runtime.load_csv import LoadCsv

        return LoadCsv(root, clause.url, slot, clause.with_headers,
                       clause.field_terminator), columns
    if isinstance(clause, A.CreateIndexClause):
        ddl.append(("create_index", clause))
        return root, columns
    if isinstance(clause, A.DropIndexClause):
        ddl.append(("drop_index", clause))
        return root, columns
    raise PlanError(f"cannot plan {type(clause).__name__}")


def _validate_create_path(path, scope):
    for el in path.elements:
        if isinstance(el, A.RelPattern):
            if el._bound:
                raise PlanError("cannot CREATE a bound relationship")
            if el.varlen:
                raise PlanError("cannot CREATE variable-length relationships")
            if not el.types:
                raise PlanError("CREATE requires a relationship type")
        else:
            if el._bound and el.props is not None:
                raise PlanError("cannot CREATE a bound node with properties")
            if el._bound and len(path.elements) == 1:
                # SyntaxError VariableAlreadyBound (TCK Create1 [13]): a
                # bound variable may only appear in CREATE as the endpoint
                # of a new relationship
                raise PlanError(
                    f"variable {el.var!r} already bound; CREATE of a bound "
                    "node is only valid inside a relationship pattern")


def bind_create_exprs(path, scope):
    for el in path.elements:
        if el.props is not None:
            bind_expr(el.props, scope)


def _conjuncts(e):
    """Split an expression on top-level ANDs (push_filters_down prep)."""
    if isinstance(e, A.Binary) and e.op == "AND":
        return _conjuncts(e.left) + _conjuncts(e.right)
    return [e]


def _slots_of(e, out=None):
    out = out if out is not None else set()
    if isinstance(e, A.Var):
        s = getattr(e, "slot", None)
        if s is not None:
            out.add(s)
        return out
    if isinstance(e, A.ShortestPathExpr):
        # expression-position shortestPath depends on BOTH endpoint vars
        # (bound as synthetic _src_var/_dst_var, not dataclass fields —
        # the generic field walk would report zero deps and the filter
        # would push below the scans that bind them)
        for attr in ("_src_var", "_dst_var"):
            v = getattr(e, attr, None)
            s = getattr(v, "slot", None) if v is not None else None
            if s is not None:
                out.add(s)
        return out
    if isinstance(e, (A.ExistsExpr, A.PatternComp)) and \
            getattr(e, "pattern", None) is not None:
        # a pattern predicate depends on every outer variable its pattern
        # names — without this the filter pushes below the op that binds
        # them (TCK Pattern1 [12]: MATCH (n), (m) WHERE (n)-[]->(m))
        outer = getattr(e, "_outer_vars", {})
        for el in e.pattern.elements:
            name = getattr(el, "var", None)
            if name and name in outer:
                out.add(outer[name])
        return out
    if dataclasses.is_dataclass(e):
        for f in dataclasses.fields(e):
            v = getattr(e, f.name)
            if isinstance(v, A.Expr):
                _slots_of(v, out)
            elif isinstance(v, (list, tuple)):
                for x in v:
                    if isinstance(x, A.Expr):
                        _slots_of(x, out)
                    elif isinstance(x, tuple):
                        for y in x:
                            if isinstance(y, A.Expr):
                                _slots_of(y, out)
    return out


def _const_of(e):
    """Literal/param-free constant value of an expression, or raise
    (ExprEval::constant, planner/optimizer constant folding)."""
    if isinstance(e, A.Lit):
        return e.value
    if isinstance(e, A.Unary) and e.op == "-":
        return -_const_of(e.operand)
    if isinstance(e, A.Unary) and e.op == "NOT":
        v = _const_of(e.operand)
        if v is None:
            return None
        if isinstance(v, bool):
            return not v
    if isinstance(e, A.Binary):
        lv = _const_of(e.left)
        rv = _const_of(e.right)
        num = (int, float)
        if e.op in ("+", "-", "*") and isinstance(lv, num) and \
                isinstance(rv, num) and not isinstance(lv, bool) and \
                not isinstance(rv, bool):
            return {"+": lv + rv, "-": lv - rv, "*": lv * rv}[e.op]
        if e.op in ("=", "<>", "<", "<=", ">", ">=") and \
                type(lv) is type(rv) and isinstance(lv, (num, str)) and \
                not isinstance(lv, bool):
            import operator as _op
            f = {"=": _op.eq, "<>": _op.ne, "<": _op.lt, "<=": _op.le,
                 ">": _op.gt, ">=": _op.ge}[e.op]
            return f(lv, rv)
        if e.op in ("AND", "OR") and isinstance(lv, bool) and \
                isinstance(rv, bool):
            return (lv and rv) if e.op == "AND" else (lv or rv)
    raise ValueError("not constant")


def _mk_filter(op, e):
    """eliminate_true_filters: drop plan-time constant-true predicates and
    AND-conjuncts (eliminate_true_filters.rs docs: the AND-identity `true`
    placeholders left by pattern-predicate extraction)."""
    if contains_aggregate(e):
        # SyntaxError InvalidAggregation (TCK MatchWhere1 [15]):
        # aggregations are not allowed in WHERE
        raise PlanError("invalid use of aggregating function in WHERE")
    parts = []
    for c in _conjuncts(e):
        try:
            if _const_of(c) is True:
                continue
        except ValueError:
            pass
        parts.append(c)
    if not parts:
        return op
    out = parts[0]
    for c in parts[1:]:
        out = A.Binary("AND", out, c)
    return O.Filter(op, out)


def _try_id_seek(conjuncts, start, scope):
    """utilize_node_by_id: id(n) = X / id(n) IN [...] → NodeByIdSeek."""
    for i, c in enumerate(conjuncts):
        if not isinstance(c, A.Binary) or c.op not in ("=", "IN"):
            continue
        for lhs, rhs in ((c.left, c.right), (c.right, c.left)):
            if (isinstance(lhs, A.FnCall) and lhs.name == "id"
                    and len(lhs.args) == 1
                    and isinstance(lhs.args[0], A.Var)
                    and getattr(lhs.args[0], "slot", None) == start._slot
                    and not _slots_of(rhs)):
                del conjuncts[i]
                return rhs
    return None


def _prop_of_start(expr_side, start, prop):
    return (isinstance(expr_side, A.Prop)
            and isinstance(expr_side.obj, A.Var)
            and getattr(expr_side.obj, "slot", None) == start._slot
            and expr_side.key == prop)


def _match_prop_conjunct(c, start, prop, known=frozenset()):
    """(spec_update, kind) when conjunct c constrains start.prop against an
    expression whose variables are all bound UPSTREAM of the scan (the
    IndexScan evaluates bound exprs per driving row, so UNWIND/WITH-bound
    values qualify, not just constants).  Covers =, range ops, IN lists,
    and distance(n.p, <point>) < r geo ranges
    (utilize_index.rs: composite + IN + geo rewrites)."""
    if not isinstance(c, A.Binary):
        return None
    if c.op in ("=", "<", "<=", ">", ">="):
        sides = ((c.left, c.right, c.op),
                 (c.right, c.left, {"<": ">", "<=": ">=", ">": "<",
                                    ">=": "<=", "=": "="}[c.op]))
        for expr_side, const_side, op in sides:
            if _prop_of_start(expr_side, start, prop) \
                    and _slots_of(const_side) <= known:
                return (op, const_side)
            # distance(n.prop, <point>) < r  → geo range
            if (op in ("<", "<=") and isinstance(expr_side, A.FnCall)
                    and expr_side.name == "distance"
                    and len(expr_side.args) == 2
                    and _slots_of(const_side) <= known):
                a, b = expr_side.args
                for p_side, c_side in ((a, b), (b, a)):
                    if _prop_of_start(p_side, start, prop) \
                            and _slots_of(c_side) <= known:
                        return ("geo", (c_side, const_side))
        return None
    if c.op == "IN":
        if _prop_of_start(c.left, start, prop) \
                and _slots_of(c.right) <= known:
            return ("in", c.right)
    return None


def _try_index_bounds(conjuncts, start, indexes, known=frozenset()):
    """utilize_index: prop predicates vs constants + matching range index →
    bounds_map {prop: spec} for IndexScan.  Consumes matched conjuncts.
    Prefers the index binding the most properties (composite indexes)."""
    if not start.labels or not indexes:
        return None
    cands = [d for d in indexes.values()
             if d.kind == "range" and d.entity == "node"
             and d.label == start.labels[0]
             and getattr(d, "status", "operational") == "operational"]
    best = None
    for d in cands:
        bounds_map = {}
        consume = set()  # conjuncts the scan fully implements
        matched = set()  # all matched (geo stays as a residual filter)
        for prop in d.props:
            lo = hi = None
            lo_inc = hi_inc = True
            spec = None
            for i, c in enumerate(conjuncts):
                if i in matched:
                    continue
                m = _match_prop_conjunct(c, start, prop, known)
                if m is None:
                    continue
                kind, payload = m
                if kind == "geo":
                    # padded-superset prefilter; exact boundary semantics
                    # come from the residual distance() filter
                    spec = ("geo", payload[0], payload[1])
                    matched.add(i)
                    break
                if kind == "in":
                    spec = ("in_expr", payload)
                    matched.add(i)
                    consume.add(i)
                    break
                if kind == "=":
                    lo = hi = payload
                    lo_inc = hi_inc = True
                elif kind in (">", ">="):
                    lo, lo_inc = payload, kind == ">="
                else:
                    hi, hi_inc = payload, kind == "<="
                matched.add(i)
                consume.add(i)
            if spec is None and (lo is not None or hi is not None):
                spec = ("range", lo, lo_inc, hi, hi_inc)
            if spec is not None:
                bounds_map[prop] = spec
        if bounds_map and (best is None or len(bounds_map) > len(best[0])):
            best = (bounds_map, consume)
    if best is None:
        return None
    bounds_map, consume = best
    residuals = [conjuncts[i] for i in sorted(consume)]
    for i in sorted(consume, reverse=True):
        del conjuncts[i]
    return bounds_map, residuals


def _plan_match(clause: A.MatchClause, root, scope, indexes=None):
    if clause.optional:
        return _plan_optional_match(clause, root, scope)
    known = {s for s in scope.vars.values()}
    # pre-annotate all paths so cross-path shared vars bind consistently
    for path in clause.paths:
        _annotate_path(path, scope)
        for el in path.elements:
            # a bare parameter as the whole predicate map is a compile
            # error in MATCH (TCK Match1 [6]/Match2 [8]); inline property
            # VALUES may still be parameters
            if isinstance(el.props, A.Param):
                raise PlanError(
                    "parameters cannot be used as a whole-entity predicate "
                    "in MATCH")
    _ensure_varlen_slots(clause.paths, scope)
    conjuncts = []
    if clause.where is not None:
        bind_expr(clause.where, scope)
        conjuncts = _conjuncts(clause.where)
    op = root
    first_path = True
    for path in clause.paths:
        for el in path.elements:
            if el.props is not None:
                bind_expr(el.props, scope)
        # replace_cartesian_with_hash_join: a disjoint path joined to the
        # accumulated plan by an equality conjunct becomes a hash join
        if not first_path:
            path_slots = {el._slot for el in path.elements
                          if el._slot is not None}
            if not (path_slots & known):
                hj = _find_join_conjunct(conjuncts, known, path_slots)
                if hj is not None:
                    left_expr, right_expr, ci = hj
                    del conjuncts[ci]
                    right_known = set()
                    right_op = _plan_path_ops(path, O.UnitRow(), scope,
                                              right_known)
                    ready_r = [c for c in conjuncts
                               if _slots_of(c) <= right_known]
                    for c in ready_r:
                        right_op = _mk_filter(right_op, c)
                    conjuncts = [c for c in conjuncts if c not in ready_r]
                    op = O.ValueHashJoin(op, right_op, left_expr, right_expr)
                    known |= right_known
                    ready = [c for c in conjuncts if _slots_of(c) <= known]
                    for c in ready:
                        op = _mk_filter(op, c)
                    conjuncts = [c for c in conjuncts if c not in ready]
                    continue
        first_path = False
        # scan-replacement passes (only when this path introduces its start)
        start_override = None
        start = _choose_start(path, known)
        if (start is not None and start._slot not in known
                and isinstance(start.props, A.MapLit)):
            # hoist inline props {k: v, ...} into WHERE conjuncts so the
            # id-seek / index passes see them (the reference folds inline
            # props into filters during binding, utilize_index.rs)
            hoisted = _props_filter(start)
            conjuncts.extend(_conjuncts(hoisted))
            start._props_hoisted = True
        if start is not None and start._slot not in known:
            id_expr = _try_id_seek(conjuncts, start, scope)
            if id_expr is not None:
                start_override = O.NodeByIdSeek(start._slot, start.var or "",
                                                id_expr, op)
                if start.labels:
                    conjuncts.append(_label_filter(start, start.labels))
            else:
                ix = _try_index_bounds(conjuncts, start, indexes or {},
                        frozenset(known))
                if ix is not None:
                    bounds_map, residuals = ix
                    start_override = O.IndexScan(
                        start._slot, start.var or "", start.labels[0],
                        bounds_map, residuals=residuals, child=op)
        sf = []
        if start is not None and path.shortest is None:
            sf = [c for c in conjuncts
                  if _slots_of(c) == {start._slot}
                  and not (isinstance(c, A.Lit) and c.value is True)]
            conjuncts = [c for c in conjuncts if c not in sf]
        if start_override is not None:
            known.add(start._slot)
            op = _plan_path_ops(path, start_override, scope, known,
                                start_filters=sf)
        else:
            op = _plan_path_ops(path, op, scope, known, start_filters=sf)
        # push_filters_down: attach every conjunct whose vars are now bound
        ready = [c for c in conjuncts if _slots_of(c) <= known]
        for c in ready:
            if isinstance(c, A.Lit) and c.value is True:
                continue  # eliminate_true_filters
            op = _mk_filter(op, c)
        conjuncts = [c for c in conjuncts if c not in ready]
    for c in conjuncts:
        op = _mk_filter(op, c)
    uniq = _rel_uniqueness_filter(clause.paths)
    if uniq is not None:
        op = _mk_filter(op, uniq)
    return op


def _plan_shortest(path, root, scope, known_bound):
    """shortestPath((a)-[:T*..k]->(b)) — endpoints must resolve; free
    endpoints get scans planned first."""
    els = path.elements
    if len(els) != 3 or not isinstance(els[1], A.RelPattern):
        raise PlanError("shortestPath expects a single relationship pattern")
    a, rel, b = els
    if not rel.varlen:
        raise PlanError("shortestPath requires a variable-length pattern")
    op = root
    for el in (a, b):
        if el._slot not in known_bound:
            if el.labels:
                ordered = _order_labels(el.labels)
                op = O.LabelScan(el._slot, el.var or "", ordered[0], op)
                for extra in ordered[1:]:
                    op = O.Filter(op, _label_filter(el, [extra]))
            else:
                op = O.AllNodeScan(el._slot, el.var or "", op)
            known_bound.add(el._slot)
            if el.props is not None:
                op = O.Filter(op, _props_filter(el))
    path_slot = path._slot if path._slot is not None else scope.fresh()
    op = O.ShortestPath(op, a._slot, b._slot, path_slot, rel.types,
                        rel.direction, rel.max_hops,
                        all_paths=(path.shortest == "all"))
    return op


def _ensure_varlen_slots(paths, scope):
    """Relationship uniqueness needs every rel addressable: when one MATCH
    binds >= 2 relationship elements, anonymous var-len rels get a slot so
    their edge lists materialize for the _reldistinct predicate (TCK
    Match5 [26]: (a)<-[:L]-()-[:L*3]->(c) must not reuse the fixed edge
    inside the var-len part)."""
    rels = [el for path in paths if path.shortest is None
            for el in path.elements if not isinstance(el, A.NodePattern)]
    if len(rels) < 2:
        return
    for el in rels:
        if el.varlen and el._slot is None:
            el._slot = scope.fresh()


def _rel_uniqueness_filter(paths):
    """openCypher relationship isomorphism (TCK Match3 [15]/[16]): all
    relationships bound within ONE match pattern are pairwise distinct.
    Emits an internal `_reldistinct(...)` predicate over every addressable
    edge slot (fixed edges and var-len edge lists); a single var-len slot
    alone needs nothing (trail semantics already apply within it).
    Edges absorbed into fused anonymous chains have no bound slot and are
    skipped — fusing only triggers for anonymous prop-less chains.
    The reference enforces this structurally during traversal
    (graph/src/runtime/ops/cond_traverse.rs edge-uniqueness mask)."""
    by_slot = {}
    n_varlen = 0
    for path in paths:
        if path.shortest is not None:
            continue
        for el in path.elements:
            if isinstance(el, A.NodePattern):
                continue
            if getattr(el, "_fused", False) or el._slot is None:
                continue
            if el._slot in by_slot:
                continue  # same rel var reused: one arg (self-equal)
            v = A.Var(el.var or f"_anonrel{el._slot}")
            v.slot = el._slot
            by_slot[el._slot] = v
            if el.varlen:
                n_varlen += 1
    if len(by_slot) < 2:
        return None
    return A.FnCall("_reldistinct", list(by_slot.values()))


def _find_join_conjunct(conjuncts, left_slots, right_slots):
    """Find `exprL = exprR` where exprL touches only already-bound slots and
    exprR only the new disjoint path's slots (either orientation)."""
    for i, c in enumerate(conjuncts):
        if not isinstance(c, A.Binary) or c.op != "=":
            continue
        ls = _slots_of(c.left)
        rs = _slots_of(c.right)
        if not ls or not rs:
            continue
        if ls <= left_slots and rs <= right_slots:
            return c.left, c.right, i
        if rs <= left_slots and ls <= right_slots:
            return c.right, c.left, i
    return None


def _choose_start(path, known):
    els = path.elements
    for el in els:
        if isinstance(el, A.NodePattern) and el._slot in known:
            return el
    # labeled + inline props beats plain labeled: the equality lowers to
    # an index seek / selective filter, so the chain walks outward from
    # ~1 row instead of a whole label scan (reference select_scan_node's
    # filter-aware scoring; LDBC is7 anchored at (:Person {id}) mid-chain)
    for el in els:
        if isinstance(el, A.NodePattern) and el.labels and el.props:
            return el
    for el in els:
        if isinstance(el, A.NodePattern) and el.labels:
            return el
    for el in els:
        if isinstance(el, A.NodePattern):
            return el
    return None


def _try_fuse_optional(clause, root, scope, pre_slots):
    """fuse_optional_traverse: OPTIONAL MATCH of one single-hop pattern
    from a bound endpoint (all optional vars introduced by the traverse)
    becomes an optional Conditional Traverse that null-pads missed rows
    (fuse_optional_traverse.rs plan shapes)."""
    if clause.where is not None or len(clause.paths) != 1:
        return None
    path = clause.paths[0]
    if path.var is not None or path.shortest is not None:
        return None
    if len(path.elements) != 3:
        return None
    a, rel, b = path.elements
    if rel.varlen or rel._bound or rel.props is not None:
        return None
    a_bound = a._slot in pre_slots
    b_bound = b._slot in pre_slots
    if a_bound == b_bound:   # exactly one bound endpoint
        return None
    src, dst = (a, b) if a_bound else (b, a)
    direction = rel.direction if a_bound else \
        {"out": "in", "in": "out", "both": "both"}[rel.direction]
    # every optional var must be introduced by the traverse itself:
    # bound-side labels/props or unbound-side props need filters → general
    if src.labels or src.props is not None or dst.props is not None:
        return None
    if rel._slot is None:
        rel._slot = scope.fresh()
    op = O.Traverse(root, src._slot, dst._slot, rel._slot, rel.types,
                    direction, dst.labels, src.var or "", dst.var or "")
    op.optional = True
    return op


def _plan_optional_match(clause: A.MatchClause, root, scope):
    pre_slots = set(scope.vars.values())
    for path in clause.paths:
        _annotate_path(path, scope)
    fused = _try_fuse_optional(clause, root, scope, pre_slots)
    if fused is not None:
        return fused
    _ensure_varlen_slots(clause.paths, scope)
    new_slots = [s for s in scope.vars.values() if s not in pre_slots]
    anon_new: list[int] = []
    for path in clause.paths:
        for el in path.elements:
            if el.props is not None:
                bind_expr(el.props, scope)
            if el._slot is not None and el._slot not in pre_slots and \
                    el._slot not in new_slots:
                anon_new.append(el._slot)
    if clause.where is not None:
        bind_expr(clause.where, scope)

    paths = clause.paths
    where = clause.where

    def factory(row_op_source):
        known = set(pre_slots)
        op = row_op_source
        for path in paths:
            op = _plan_path_ops_rebind(path, op, known)
        uniq = _rel_uniqueness_filter(paths)
        if uniq is not None:
            op = _mk_filter(op, uniq)
        if where is not None:
            op = _mk_filter(op, where)
        return op

    return _ApplyOptional(root, factory, new_slots + anon_new)


def _plan_path_ops_rebind(path, op, known):
    """Re-plan a pre-annotated path from a new source (slots already fixed)."""

    class _NoNewScope:
        def fresh(self):
            # anonymous equality slots for rebinding; far below the hidden
            # ROWID slots (-2/-3) so they can never collide
            _plan_path_ops_rebind._extra -= 1
            return _plan_path_ops_rebind._extra

    if not hasattr(_plan_path_ops_rebind, "_extra"):
        _plan_path_ops_rebind._extra = -1000
    return _plan_path_ops(path, op, _NoNewScope(), known)


class _ApplyOptional(O.Op):
    """Vectorized OPTIONAL MATCH: run the pattern seeded by the incoming
    batch with a hidden row-id column; rows with no expansion re-emit with
    nulls (fuse_optional_traverse / Apply in the reference)."""

    name = "OptionalMatch"
    ROWID = -2

    def __init__(self, child, factory, null_slots):
        super().__init__(child)
        self.factory = factory
        self.null_slots = null_slots

    def describe(self):
        return "Optional Match"

    def run(self, rt):
        for b in self.child.run(rt):
            rt.check_timeout()
            seeded = b.with_col(self.ROWID, Column.values(list(range(b.n))))
            sub = self.factory(O.BoundRows(seeded))
            seen = set()
            for sb in sub.run(rt):
                if sb.n == 0:
                    continue
                for v in sb.cols[self.ROWID].data:
                    seen.add(v)
                cols = {s: c for s, c in sb.cols.items() if s != self.ROWID}
                yield O.Batch(sb.n, cols)
            missing = [i for i in range(b.n) if i not in seen]
            if missing:
                out = b.take(np.asarray(missing))
                for s in self.null_slots:
                    out = out.with_col(s, Column.values([None] * len(missing)))
                yield out


def _plan_merge(clause: A.MergeClause, root, scope):
    path = clause.path
    for el in path.elements:
        if isinstance(el, A.RelPattern):
            if el.varlen:
                raise PlanError(
                    "MERGE does not support variable-length patterns")
            if not el.types:
                raise PlanError("MERGE requires a relationship type")
    pre_slots = set(scope.vars.values())
    _annotate_path(path, scope)
    for el in path.elements:
        # SyntaxError VariableAlreadyBound (TCK Merge5 [22]): a bound
        # variable cannot carry new label/property predicates in MERGE
        if (isinstance(el, A.NodePattern) and getattr(el, "_bound", False)
                and (el.labels or el.props is not None)):
            raise PlanError(
                f"variable {el.var!r} is already bound and cannot take "
                f"new predicates in MERGE")
    if path._slot is not None:
        # MERGE p = (...): every element needs a slot so both the match
        # and the create branch can materialize p (TCK Merge1 [13],
        # Merge5 [10])
        for el in path.elements:
            if el._slot is None:
                el._slot = scope.fresh()
    for el in path.elements:
        if el.props is not None:
            bind_expr(el.props, scope)
    for items in (clause.on_create, clause.on_match):
        for item in items:
            bind_expr(item.target, scope)
            if item.value is not None:
                bind_expr(item.value, scope)
    merge_slots = [el._slot for el in path.elements if el._slot is not None]

    # undirected MERGE matches either direction but CREATES outgoing
    # (TCK Merge5 [11]-[13]; reference ops/merge.rs normalizes the same way)
    import copy as _copy

    create_path = path
    if any(isinstance(el, A.RelPattern) and el.direction == "both"
           for el in path.elements):
        create_path = _copy.deepcopy(path)
        for el in create_path.elements:
            if isinstance(el, A.RelPattern) and el.direction == "both":
                el.direction = "out"

    def match_factory(row):
        known = set(pre_slots)
        return _plan_path_ops_rebind(path, O.BoundRows(row), known)

    def create_factory(row):
        op = O.CreateOp(O.BoundRows(row), [create_path])
        if path._slot is not None:
            element_slots = [("node" if isinstance(el, A.NodePattern)
                              else "edge", el._slot)
                             for el in create_path.elements]
            op = O.PathBuild(op, path._slot, element_slots)
        return op

    props_exprs = [el.props for el in path.elements if el.props is not None]

    def null_check(row, rt):
        # SemanticError at runtime (TCK Merge1 [17], Merge5 [29]):
        # merging with a null property value can never match
        from falkordb_tpu_torch.runtime.eval import evaluate, EvalError

        for pe_ in props_exprs:
            vals = rt.ctx.materialize(evaluate(pe_, row, rt.ctx))[0]
            if isinstance(vals, dict) and any(v is None
                                              for v in vals.values()):
                raise EvalError("cannot merge using null property value")

    return O.MergeOp(root, match_factory, create_factory, clause.on_create,
                     clause.on_match, merge_slots,
                     null_check=null_check if props_exprs else None)


def _plan_foreach(clause: A.ForeachClause, root, scope):
    bind_expr(clause.source, scope)
    # FOREACH updates see the outer scope plus the loop variable, and the
    # loop variable does NOT leak past the FOREACH.  The inner scope is a
    # SNAPSHOT copy: the per-row factory re-binds at runtime, and by then
    # later clauses (RETURN/WITH) may have rewritten the live scope's
    # bindings — the snapshot pins the bindings as of this clause.
    inner = scope.child()
    inner.vars = dict(scope.vars)
    inner.kinds = dict(scope.kinds)
    slot = inner.declare(clause.var, "value")
    sub_clauses = clause.updates

    def factory(row):
        op = O.BoundRows(row)
        cols: list = []
        ddl: list = []
        for c in sub_clauses:
            op, cols = _plan_clause(c, op, inner, cols, ddl)  # foreach: no index passes
        return op

    # plan once against a dummy to bind expressions/slots deterministically
    _ = factory(Batch.unit())
    return O.Foreach(root, slot, clause.source, factory)


def _plan_call(clause: A.CallClause, root, scope, ddl):
    from falkordb_tpu_torch.runtime.procedures import PROCEDURES

    proc = PROCEDURES.get(clause.proc)
    if proc is None:
        raise PlanError(f"unknown procedure {clause.proc!r}")
    for a in clause.args:
        bind_expr(a, scope)
    yields = clause.yields
    if not yields:
        yields = [(y, None) for y in proc.yields]
    yield_slots = []
    clause._yield_cols = []
    for name, alias in yields:
        if name not in proc.yields:
            raise PlanError(f"procedure {clause.proc} does not yield {name!r}")
        slot = scope.declare(alias or name, "value")
        yield_slots.append((name, slot))
        clause._yield_cols.append((slot, alias or name))
    op = O.ProcedureCall(root, clause.proc, clause.args, yield_slots)
    if clause.where is not None:
        bind_expr(clause.where, scope)
        op = _mk_filter(op, clause.where)
    return op


def _plan_call_subquery(clause: A.CallSubquery, root, scope):
    inner_q = clause.query
    inner_scope = scope.child()
    inner_scope.vars = dict(scope.vars)  # import all (simple-scope model)
    counter = scope._counter
    planned = _plan_one(inner_q, inner_scope, counter)
    for slot, name in planned.columns:
        if name in scope.vars and scope.vars[name] != slot:
            raise PlanError(f"CALL {{}} returns already-bound variable {name!r}")
        scope.vars[name] = slot
        scope.kinds[slot] = "value"

    def factory(row):
        return _replace_source(planned.root, O.BoundRows(row))

    return O.Apply(root, factory)


def _replace_source(op, new_source):
    """Clone-with-new-leaf: swap the UnitRow seed for a BoundRows seed."""
    import copy

    def rec(o):
        if isinstance(o, O.UnitRow):
            return new_source
        c = copy.copy(o)
        if o.child is not None:
            c.child = rec(o.child)
        if hasattr(o, "right"):
            c.right = rec(o.right)
        return c

    return rec(op)


def _plan_projection(clause, root, scope, columns):
    is_return = isinstance(clause, A.ReturnClause)
    items = list(clause.items)
    if not is_return:
        # SyntaxError NoExpressionAlias (TCK With4 [5]): every non-variable
        # WITH item needs an AS alias
        for p in items:
            if p.alias is None and not isinstance(p.expr, A.Var):
                raise PlanError("expression in WITH must be aliased (use AS)")
    # SyntaxError ColumnNameConflict (TCK Return4 [10], With4 [4])
    seen_names: dict = {}
    for p in items:
        name = _proj_name(p)
        other = seen_names.get(name)
        if other is not None and (p.alias or other.alias):
            raise PlanError(f"multiple result columns with the same name "
                            f"{name!r}")
        seen_names[name] = p
    if clause.star:
        if is_return and not scope.vars:
            # SyntaxError NoVariablesInScope (TCK Return7 [2])
            raise PlanError("RETURN * is not allowed when there are no "
                            "variables in scope")
        # RETURN * lists variables in alphabetical order (TCK
        # clauses/create/Create5 [5], unwind/Unwind1 [13], with/With1 [2])
        items = [A.Projection(A.Var(n), n) for n in sorted(scope.vars)]
        items.extend(clause.items)
    new_scope_vars: dict[str, int] = {}
    has_agg = any(contains_aggregate(p.expr) for p in items)
    out_cols: list = []
    op = root
    import copy as _copy

    orig_exprs = [_copy.deepcopy(p.expr) for p in items]  # ORDER BY matching

    if has_agg:
        group_items, agg_items = [], []
        post_items = [None] * len(items)
        ord_groups = []  # [(orig grouping expr, AGGREGATE-level slot)]
        # pass 1: non-aggregate projections become the Aggregate's group
        # columns; collected before aggregate-containing projections so
        # the latter can reference them (openCypher: their non-aggregate
        # parts must be grouping keys — TCK Match4 [4]:
        # WITH a, b, [a] + collect(n) + [b] AS nodeList)
        for j, p in enumerate(items):
            if contains_aggregate(p.expr):
                continue
            name = _proj_name(p)
            bind_expr(p.expr, scope)
            slot = scope.fresh()
            group_items.append((p.expr, slot, name))
            post_items[j] = (_slot_var(slot), name)
            ord_groups.append((orig_exprs[j], slot))
        for j, p in enumerate(items):
            if post_items[j] is not None:
                continue
            name = _proj_name(p)
            expr2, extracted = _extract_aggs(p.expr, scope)
            agg_items.extend(extracted)
            # non-aggregate subexpressions equal to a grouping expression
            # read the group column (source slots are gone post-Aggregate)
            expr2 = _rewrite_order_key(expr2, ord_groups, {})
            post_items[j] = (expr2, name)
        op = O.Aggregate(op, group_items, agg_items)
        proj_items = []
        for expr2, name in post_items:
            slot = scope.fresh()
            proj_items.append((expr2, slot, name))
            new_scope_vars[name] = slot
            out_cols.append((slot, name))
        op = O.Project(op, proj_items)
    else:
        proj_items = []
        for p in items:
            name = _proj_name(p)
            bind_expr(p.expr, scope)
            slot = scope.fresh()
            proj_items.append((p.expr, slot, name))
            new_scope_vars[name] = slot
            out_cols.append((slot, name))
        op = O.Project(op, proj_items, passthrough=True)

    # ORDER BY sees both projected aliases and (non-aggregated) source vars
    new_scope = scope.child()
    new_scope.vars = new_scope_vars
    if clause.order_by:
        sort_scope = new_scope
        if not has_agg:
            sort_scope = scope.child()
            sort_scope.vars = {**scope.vars, **new_scope_vars}
        keys = []
        for e, asc in clause.order_by:
            # an ORDER BY key that syntactically equals a projected item
            # sorts on that output column (aggregation-safe)
            matched = None
            for j, oe in enumerate(orig_exprs):
                if e == oe:
                    matched = _slot_var(out_cols[j][0])
                    break
            if matched is not None:
                keys.append((matched, asc))
                continue
            if has_agg and contains_aggregate(e):
                # ORDER BY item mixing aggregation with grouping keys /
                # aliases / constants (TCK ReturnOrderBy6 [1]-[3],
                # WithOrderBy4 [16]-[18]): rewrite grouping-expr and alias
                # references to their projected slots, extract the
                # aggregates into extra Aggregate outputs, and sort on a
                # hidden projected column
                e2 = _copy.deepcopy(e)
                # aliases resolve to the post_items' AGGREGATE-level
                # expressions (the hidden column evaluates inside Project,
                # before projected slots exist)
                aliases = {name: expr2 for expr2, name in post_items}
                e2 = _rewrite_order_key(e2, ord_groups, aliases)
                e3, extracted = _extract_aggs(e2, scope)
                agg_items.extend(extracted)
                hslot = scope.fresh()
                proj_items.append((e3, hslot, f"_ord{hslot}"))
                keys.append((_slot_var(hslot), asc))
                continue
            if has_agg:
                # non-aggregate ORDER BY key referencing pre-aggregation
                # vars: legal iff every such part is a grouping expression
                # (TCK WithOrderBy2 [23]: ORDER BY a.name + 'C' where
                # a.name is a grouping key) — rewrite to group slots,
                # project a hidden column, sort on it
                try:
                    e_alias = _copy.deepcopy(e)
                    bind_expr(e_alias, sort_scope)
                    keys.append((e_alias, asc))
                    continue
                except PlanError:
                    pass
                aliases = {name: expr2 for expr2, name in post_items}
                e2 = _rewrite_order_key(_copy.deepcopy(e), ord_groups,
                                        aliases)
                e3, extracted = _extract_aggs(e2, scope)
                agg_items.extend(extracted)
                empty = scope.child()
                empty.vars = {}
                bind_expr(e3, empty)  # leftover raw vars -> PlanError
                hslot = scope.fresh()
                proj_items.append((e3, hslot, f"_ord{hslot}"))
                keys.append((_slot_var(hslot), asc))
                continue
            bind_expr(e, sort_scope)
            keys.append((e, asc))
        op = O.Sort(op, keys, limit=_sort_keep(clause))
    if clause.distinct:
        op = O.Distinct(op, [s for s, _ in out_cols])
    if clause.skip is not None:
        bind_expr(clause.skip, new_scope)
        op = O.Skip(op, clause.skip)
    if clause.limit is not None:
        bind_expr(clause.limit, new_scope)
        op = O.Limit(op, clause.limit)
    if not is_return and clause.where is not None:
        # WITH ... WHERE may reference pre-projection variables too (TCK
        # Comparison2 [3]: WITH types[i] AS lhs ... WHERE i <> j); the
        # non-aggregating Project passes source slots through
        where_scope = new_scope
        if not has_agg:
            where_scope = scope.child()
            where_scope.vars = {**scope.vars, **new_scope_vars}
        bind_expr(clause.where, where_scope)
        op = _mk_filter(op, clause.where)

    scope.vars.clear()
    scope.vars.update(new_scope_vars)
    if is_return:
        return O.Results(op, out_cols), out_cols
    return op, columns


def _sort_keep(clause):
    """Rows the Sort must keep when literal SKIP/LIMIT follow it and no
    DISTINCT sits between (the reference's top-k sort, ops/sort.rs), so
    that Sort can take its top-k path; None keeps every row.  falkordb_tpu
    never passes this, which leaves its device top-k unreached."""
    def lit(e):
        return (isinstance(e, A.Lit) and type(e.value) is int
                and e.value >= 0)

    if clause.distinct or not lit(clause.limit) or (
            clause.skip is not None and not lit(clause.skip)):
        return None
    return clause.limit.value + (clause.skip.value if clause.skip else 0)


import copy as _copy


def _rewrite_order_key(e, groups, aliases):
    """Replace subexpressions equal to a grouping item's original
    expression, or bare alias Vars, with their post-projection slot vars
    (openCypher: non-aggregate parts of an aggregating ORDER BY item must
    be grouping keys, aliases, or constants)."""
    for oe, slot in groups:
        if e == oe:
            return _slot_var(slot)
    if isinstance(e, A.Var) and e.name in aliases:
        return _copy.deepcopy(aliases[e.name])
    if dataclasses.is_dataclass(e) and isinstance(e, A.Expr):
        for f in dataclasses.fields(e):
            v = getattr(e, f.name)
            if isinstance(v, A.Expr):
                setattr(e, f.name, _rewrite_order_key(v, groups, aliases))
            elif isinstance(v, list):
                setattr(e, f.name, [
                    _rewrite_order_key(i, groups, aliases)
                    if isinstance(i, A.Expr)
                    else tuple(_rewrite_order_key(j, groups, aliases)
                               if isinstance(j, A.Expr) else j for j in i)
                    if isinstance(i, tuple) else i
                    for i in v
                ])
    return e


def _slot_var(slot):
    v = A.Var(f"_slot{slot}")
    v.slot = slot
    return v


def _proj_name(p) -> str:
    """Column header: alias > verbatim source text > regenerated form
    (TCK headers are the verbatim projection expression)."""
    return p.alias or getattr(p, "text", None) or _expr_name(p.expr)


def _expr_name(e) -> str:
    if isinstance(e, A.Var):
        return e.name
    if isinstance(e, A.Prop):
        return f"{_expr_name(e.obj)}.{e.key}"
    if isinstance(e, A.CountStar):
        return "count(*)"
    if isinstance(e, A.FnCall):
        # column headers keep the source-case function name (TCK:
        # `toInteger(weight)`, not `tointeger(weight)`)
        return (f"{e.orig or e.name}"
                f"({', '.join(_expr_name(a) for a in e.args)})")
    if isinstance(e, A.Lit):
        return repr(e.value)
    if isinstance(e, A.Binary):
        return f"{_expr_name(e.left)} {e.op} {_expr_name(e.right)}"
    return type(e).__name__.lower()


def _extract_aggs(e, scope):
    """Replace aggregate calls inside e with fresh slot vars; return
    (rewritten_expr, [(fn, distinct, arg, extra, slot)])."""
    out = []

    def rec(x):
        if isinstance(x, A.CountStar):
            slot = scope.fresh()
            out.append(("count", False, None, [], slot))
            return _slot_var(slot)
        if isinstance(x, A.FnCall) and x.name in AGG_FNS:
            slot = scope.fresh()
            arg = x.args[0] if x.args else None
            extra = x.args[1:]
            if arg is not None:
                bind_expr(arg, scope)
            for ex in extra:
                bind_expr(ex, scope)
            fn = "count" if x.name == "count" else x.name
            out.append((fn, x.distinct, arg, list(extra), slot))
            return _slot_var(slot)
        if dataclasses.is_dataclass(x) and isinstance(x, A.Expr):
            for f in dataclasses.fields(x):
                v = getattr(x, f.name)
                if isinstance(v, A.Expr):
                    setattr(x, f.name, rec(v))
                elif isinstance(v, list):
                    # descend through tuple lists too — MapLit items are
                    # (key, expr) pairs, Case whens are (cond, then) pairs
                    # (TCK Delete5 [5]-[7], Return4 [9]: aggregates inside
                    # nested map/list literals)
                    setattr(x, f.name, [
                        rec(i) if isinstance(i, A.Expr)
                        else tuple(rec(j) if isinstance(j, A.Expr) else j
                                   for j in i) if isinstance(i, tuple)
                        else i
                        for i in v
                    ])
            return x
        return x

    e2 = rec(e)
    # bind remaining non-aggregate parts
    if isinstance(e2, A.Expr):
        try:
            bind_expr(e2, scope)
        except PlanError:
            raise
    return e2, out


def plan_pattern_comprehension(e, rt):
    """[(a)-[:R]->(b) WHERE p | proj] — per-row collect of projections."""
    outer_vars = getattr(e, "_outer_vars", {})
    counter = getattr(e, "_counter", [20_000])
    scope = Scope(counter)
    scope.vars = dict(outer_vars)
    pre = set(scope.vars.values())
    _annotate_path(e.pattern, scope)
    for el in e.pattern.elements:
        if el.props is not None:
            bind_expr(el.props, scope)
    if e.where is not None:
        bind_expr(e.where, scope)
    bind_expr(e.projection, scope)
    path = e.pattern
    where = e.where
    proj = e.projection
    ROWID = -4

    def collect(batch, rt):
        from falkordb_tpu_torch.runtime.batch import Column
        from falkordb_tpu_torch.runtime.eval import evaluate
        import numpy as np

        seeded = batch.with_col(ROWID, Column.values(list(range(batch.n))))
        known = set(pre)
        op = _plan_path_ops_rebind(path, O.BoundRows(seeded), known)
        if where is not None:
            op = _mk_filter(op, where)
        out = [[] for _ in range(batch.n)]
        for sb in op.run(rt):
            vals = rt.ctx.materialize(evaluate(proj, sb, rt.ctx))
            rowids = sb.cols[ROWID].data
            for i in range(sb.n):
                out[rowids[i]].append(vals[i])
        arr = np.empty(batch.n, dtype=object)
        for i in range(batch.n):
            arr[i] = out[i]
        return arr

    return collect


# ----------------------------------------------------- pattern predicates


def plan_pattern_predicate(e: A.ExistsExpr, rt):
    """EXISTS(pattern) — returns fn(batch, rt) → object bool array."""
    outer_vars = getattr(e, "_outer_vars", {})
    counter = getattr(e, "_counter", [10_000])
    scope = Scope(counter)
    scope.vars = dict(outer_vars)
    pre = set(scope.vars.values())
    _annotate_path(e.pattern, scope)
    for el in e.pattern.elements:
        if el.props is not None:
            bind_expr(el.props, scope)
    if e.where is not None:
        bind_expr(e.where, scope)
    path = e.pattern
    where = e.where
    ROWID = -3

    def check(batch, rt):
        seeded = batch.with_col(ROWID, Column.values(list(range(batch.n))))
        known = set(pre)
        op = _plan_path_ops_rebind(path, O.BoundRows(seeded), known)
        if where is not None:
            op = _mk_filter(op, where)
        seen = set()
        for sb in op.run(rt):
            for v in sb.cols[ROWID].data:
                seen.add(v)
        arr = np.empty(batch.n, dtype=object)
        for i in range(batch.n):
            arr[i] = i in seen
        return arr

    return check
