"""AST node definitions (the reference's RawQueryIR, graph/src/parser/ast.rs)."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional


# ---------------------------------------------------------------- expressions


@dataclasses.dataclass
class Expr:
    pass


@dataclasses.dataclass
class Lit(Expr):
    value: Any  # int | float | str | bool | None


@dataclasses.dataclass
class Param(Expr):
    name: str


@dataclasses.dataclass
class Var(Expr):
    name: str


@dataclasses.dataclass
class Prop(Expr):
    obj: Expr
    key: str


@dataclasses.dataclass
class DynProp(Expr):
    obj: Expr
    key: Expr  # obj[key]


@dataclasses.dataclass
class Slice(Expr):
    obj: Expr
    lo: Optional[Expr]
    hi: Optional[Expr]


@dataclasses.dataclass
class ListLit(Expr):
    items: list[Expr]


@dataclasses.dataclass
class MapLit(Expr):
    items: list[tuple[str, Expr]]


@dataclasses.dataclass
class Unary(Expr):
    op: str  # '-', '+', 'NOT'
    operand: Expr


@dataclasses.dataclass
class Binary(Expr):
    op: str  # + - * / % ^ = <> < <= > >= AND OR XOR IN STARTS ENDS CONTAINS =~
    left: Expr
    right: Expr


@dataclasses.dataclass
class IsNull(Expr):
    operand: Expr
    negated: bool


@dataclasses.dataclass
class FnCall(Expr):
    name: str  # lowercased, may be dotted (vec.cosineDistance)
    args: list[Expr]
    distinct: bool = False
    orig: str = None  # original-case name (UDF lookup is case-sensitive)


@dataclasses.dataclass
class CountStar(Expr):
    pass


@dataclasses.dataclass
class Case(Expr):
    operand: Optional[Expr]  # simple CASE when not None
    whens: list[tuple[Expr, Expr]]
    default: Optional[Expr]


@dataclasses.dataclass
class ListComp(Expr):
    var: str
    source: Expr
    where: Optional[Expr]
    projection: Optional[Expr]


@dataclasses.dataclass
class PatternComp(Expr):
    """[pattern WHERE p | e] — pattern comprehension."""
    pattern: "PatternPath"
    where: Optional[Expr]
    projection: Expr


@dataclasses.dataclass
class Quantifier(Expr):
    kind: str  # 'any' | 'all' | 'none' | 'single'
    var: str
    source: Expr
    where: Optional[Expr]


@dataclasses.dataclass
class Reduce(Expr):
    acc: str
    init: Expr
    var: str
    source: Expr
    step: Expr


@dataclasses.dataclass
class ExistsExpr(Expr):
    """EXISTS(prop) / EXISTS { pattern } / exists(pattern)."""
    pattern: Optional["PatternPath"]
    prop: Optional[Expr]
    where: Optional[Expr] = None


@dataclasses.dataclass
class ShortestPathExpr(Expr):
    pattern: "PatternPath"
    all_paths: bool


# ------------------------------------------------------------------- patterns


@dataclasses.dataclass
class NodePattern:
    var: Optional[str]
    labels: list[str]
    props: Optional[Expr]  # MapLit or Param


@dataclasses.dataclass
class RelPattern:
    var: Optional[str]
    types: list[str]
    props: Optional[Expr]
    direction: str  # 'out' | 'in' | 'both'
    min_hops: Optional[int] = None  # var-length when min/max set
    max_hops: Optional[int] = None
    varlen: bool = False


@dataclasses.dataclass
class PatternPath:
    var: Optional[str]  # p = (...)-[...]->(...)
    elements: list  # alternating NodePattern / RelPattern
    shortest: Optional[str] = None  # None | 'single' | 'all'


# -------------------------------------------------------------------- clauses


@dataclasses.dataclass
class Clause:
    pass


@dataclasses.dataclass
class MatchClause(Clause):
    paths: list[PatternPath]
    optional: bool
    where: Optional[Expr]


@dataclasses.dataclass
class CreateClause(Clause):
    paths: list[PatternPath]


@dataclasses.dataclass
class MergeClause(Clause):
    path: PatternPath
    on_create: list[tuple]  # SetItems
    on_match: list[tuple]


@dataclasses.dataclass
class DeleteClause(Clause):
    exprs: list[Expr]
    detach: bool


@dataclasses.dataclass
class SetItem:
    target: Expr  # Prop | Var
    op: str  # '=' | '+=' | 'label'
    value: Optional[Expr]
    labels: list[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class SetClause(Clause):
    items: list[SetItem]


@dataclasses.dataclass
class RemoveClause(Clause):
    items: list[SetItem]  # op 'remove_prop' | 'remove_label'


@dataclasses.dataclass
class Projection:
    expr: Expr
    alias: Optional[str]
    text: Optional[str] = None  # verbatim source of expr (column header)


@dataclasses.dataclass
class WithClause(Clause):
    distinct: bool
    items: list[Projection]
    star: bool
    order_by: list[tuple[Expr, bool]]  # (expr, ascending)
    skip: Optional[Expr]
    limit: Optional[Expr]
    where: Optional[Expr]


@dataclasses.dataclass
class ReturnClause(Clause):
    distinct: bool
    items: list[Projection]
    star: bool
    order_by: list[tuple[Expr, bool]]
    skip: Optional[Expr]
    limit: Optional[Expr]


@dataclasses.dataclass
class UnwindClause(Clause):
    expr: Expr
    alias: str


@dataclasses.dataclass
class CallClause(Clause):
    proc: str
    args: list[Expr]
    yields: list[tuple[str, Optional[str]]]  # (name, alias)
    where: Optional[Expr] = None


@dataclasses.dataclass
class CallSubquery(Clause):
    query: "Query"


@dataclasses.dataclass
class ForeachClause(Clause):
    var: str
    source: Expr
    updates: list[Clause]


@dataclasses.dataclass
class LoadCsvClause(Clause):
    url: Expr
    alias: str
    with_headers: bool
    field_terminator: Optional[Expr] = None  # FIELDTERMINATOR <expr>


@dataclasses.dataclass
class CreateIndexClause(Clause):
    kind: str  # 'range' | 'fulltext' | 'vector'
    entity: str  # 'node' | 'edge'
    label: str
    props: list[str]
    options: Optional[Expr] = None
    if_not_exists: bool = False


@dataclasses.dataclass
class DropIndexClause(Clause):
    entity: str
    label: str
    props: list[str]


@dataclasses.dataclass
class Query:
    clauses: list[Clause]
    union_with: Optional["Query"] = None
    union_all: bool = False
    params: dict[str, Any] = dataclasses.field(default_factory=dict)
    explain: bool = False
    profile: bool = False
