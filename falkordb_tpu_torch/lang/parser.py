"""openCypher recursive-descent parser.

Grammar semantics follow the reference's hand-written parser
(graph/src/parser/cypher.rs:37-60): UNION [ALL], OPTIONAL MATCH,
CALL {subquery}, CALL procedure [YIELD], LOAD CSV, FOREACH,
MERGE ON CREATE/ON MATCH, var-length `*min..max` patterns, `CYPHER k=v`
prefix, CREATE/DROP INDEX, constraints.  Implementation is new.
"""

from __future__ import annotations

from falkordb_tpu_torch.lang import ast as A
from falkordb_tpu_torch.lang.lexer import Token, tokenize


class ParseError(ValueError):
    pass


class Parser:
    def __init__(self, toks: list[Token], text: str = ""):
        self.toks = toks
        self.i = 0
        self.text = text

    # -- cursor ----------------------------------------------------------------

    @property
    def cur(self) -> Token:
        return self.toks[self.i]

    def peek(self, k: int = 1) -> Token:
        j = min(self.i + k, len(self.toks) - 1)
        return self.toks[j]

    def advance(self) -> Token:
        t = self.toks[self.i]
        if t.kind != "eof":
            self.i += 1
        return t

    def error(self, msg: str):
        t = self.cur
        raise ParseError(f"{msg} (near position {t.pos}: {t.kind} {t.value!r})")

    def expect_punct(self, p: str) -> Token:
        if not self.cur.is_punct(p):
            self.error(f"expected {p!r}")
        return self.advance()

    def expect_kw(self, kw: str) -> Token:
        if not self.cur.is_kw(kw):
            self.error(f"expected {kw}")
        return self.advance()

    def accept_punct(self, p: str) -> bool:
        if self.cur.is_punct(p):
            self.advance()
            return True
        return False

    def accept_kw(self, *kws) -> bool:
        if self.cur.is_kw(*kws):
            self.advance()
            return True
        return False

    def ident_or_kw(self) -> str:
        """Identifiers may collide with non-reserved keywords (count, any...)."""
        t = self.cur
        if t.kind == "ident":
            return self.advance().value
        if t.kind == "kw":
            t = self.advance()
            # keep the source spelling — labels/props may collide with
            # keywords (:End vs CASE..END; TCK Create2 [11])
            return t.orig if t.orig is not None else t.value.lower()
        self.error("expected identifier")

    # -- entry -----------------------------------------------------------------

    def parse_query(self) -> A.Query:
        explain = profile = False
        params: dict = {}
        if self.cur.is_kw("CYPHER"):
            self.advance()
            while self.cur.kind in ("ident", "kw") and self.peek().is_punct("="):
                name = self.ident_or_kw()
                self.expect_punct("=")
                params[name] = _const_value(self.parse_expr())
        if self.accept_kw("EXPLAIN"):
            explain = True
        if self.accept_kw("PROFILE"):
            profile = True
        q = self._parse_single_query()
        q.params = params
        q.explain = explain
        q.profile = profile
        node = q
        while self.cur.is_kw("UNION"):
            self.advance()
            union_all = self.accept_kw("ALL")
            nxt = self._parse_single_query()
            node.union_with = nxt
            node.union_all = union_all
            node = nxt
        self.accept_punct(";")
        if self.cur.kind != "eof":
            self.error("unexpected trailing input")
        return q

    def _parse_single_query(self) -> A.Query:
        clauses: list[A.Clause] = []
        while True:
            c = self.parse_clause()
            if c is None:
                break
            clauses.append(c)
            if self.cur.kind == "eof" or self.cur.is_kw("UNION") or self.cur.is_punct(";", "}"):
                break
        if not clauses:
            self.error("empty query")
        return A.Query(clauses)

    # -- clauses ---------------------------------------------------------------

    def parse_clause(self):
        t = self.cur
        if t.is_kw("MATCH") or (t.is_kw("OPTIONAL") and self.peek().is_kw("MATCH")):
            return self.parse_match()
        if t.is_kw("CREATE"):
            nxt = self.peek()
            if nxt.is_kw("INDEX", "RANGE", "FULLTEXT", "VECTOR", "CONSTRAINT"):
                return self.parse_create_index_or_constraint()
            return self.parse_create()
        if t.is_kw("DROP"):
            return self.parse_drop()
        if t.is_kw("MERGE"):
            return self.parse_merge()
        if t.is_kw("DELETE") or (t.is_kw("DETACH") and self.peek().is_kw("DELETE")):
            return self.parse_delete()
        if t.is_kw("SET"):
            return self.parse_set()
        if t.is_kw("REMOVE"):
            return self.parse_remove()
        if t.is_kw("WITH"):
            return self.parse_with()
        if t.is_kw("RETURN"):
            return self.parse_return()
        if t.is_kw("UNWIND"):
            return self.parse_unwind()
        if t.is_kw("CALL"):
            return self.parse_call()
        if t.is_kw("FOREACH"):
            return self.parse_foreach()
        if t.is_kw("LOAD"):
            return self.parse_load_csv()
        return None

    def parse_match(self) -> A.MatchClause:
        optional = self.accept_kw("OPTIONAL")
        self.expect_kw("MATCH")
        paths = [self.parse_pattern_path()]
        while self.accept_punct(","):
            paths.append(self.parse_pattern_path())
        where = None
        if self.accept_kw("WHERE"):
            where = self.parse_expr()
        return A.MatchClause(paths, optional, where)

    def parse_create(self) -> A.CreateClause:
        self.expect_kw("CREATE")
        paths = [self.parse_pattern_path()]
        while self.accept_punct(","):
            paths.append(self.parse_pattern_path())
        return A.CreateClause(paths)

    def parse_merge(self) -> A.MergeClause:
        self.expect_kw("MERGE")
        path = self.parse_pattern_path()
        on_create: list = []
        on_match: list = []
        while self.cur.is_kw("ON"):
            self.advance()
            if self.accept_kw("CREATE"):
                self.expect_kw("SET")
                on_create.extend(self.parse_set_items())
            elif self.accept_kw("MATCH"):
                self.expect_kw("SET")
                on_match.extend(self.parse_set_items())
            else:
                self.error("expected CREATE or MATCH after ON")
        return A.MergeClause(path, on_create, on_match)

    def parse_delete(self) -> A.DeleteClause:
        detach = self.accept_kw("DETACH")
        self.expect_kw("DELETE")
        exprs = [self.parse_expr()]
        while self.accept_punct(","):
            exprs.append(self.parse_expr())
        return A.DeleteClause(exprs, detach)

    def parse_set(self) -> A.SetClause:
        self.expect_kw("SET")
        return A.SetClause(self.parse_set_items())

    def parse_set_items(self) -> list[A.SetItem]:
        items = [self.parse_set_item()]
        while self.accept_punct(","):
            items.append(self.parse_set_item())
        return items

    def parse_set_item(self) -> A.SetItem:
        # n.prop = e | n += map | n = map | n:Label1:Label2
        if self.cur.kind in ("ident", "kw") and self.peek().is_punct(":"):
            var = self.ident_or_kw()
            labels = []
            while self.accept_punct(":"):
                labels.append(self.ident_or_kw())
            return A.SetItem(A.Var(var), "label", None, labels)
        target = self.parse_expr_atom_postfix()
        if self.accept_punct("+="):
            return A.SetItem(target, "+=", self.parse_expr())
        self.expect_punct("=")
        return A.SetItem(target, "=", self.parse_expr())

    def parse_remove(self) -> A.RemoveClause:
        self.expect_kw("REMOVE")
        items = []
        while True:
            if self.cur.kind in ("ident", "kw") and self.peek().is_punct(":"):
                var = self.ident_or_kw()
                labels = []
                while self.accept_punct(":"):
                    labels.append(self.ident_or_kw())
                items.append(A.SetItem(A.Var(var), "remove_label", None, labels))
            else:
                target = self.parse_expr_atom_postfix()
                if not isinstance(target, A.Prop):
                    self.error("REMOVE expects n.prop or n:Label")
                items.append(A.SetItem(target, "remove_prop", None))
            if not self.accept_punct(","):
                break
        return A.RemoveClause(items)

    def _parse_projection_body(self):
        distinct = self.accept_kw("DISTINCT")
        star = False
        items: list[A.Projection] = []
        if self.cur.is_punct("*"):
            self.advance()
            star = True
            while self.accept_punct(","):
                items.append(self._parse_projection_item())
        else:
            items.append(self._parse_projection_item())
            while self.accept_punct(","):
                items.append(self._parse_projection_item())
        order_by: list = []
        if self.cur.is_kw("ORDER"):
            self.advance()
            self.expect_kw("BY")
            while True:
                e = self.parse_expr()
                asc = True
                if self.accept_kw("DESC", "DESCENDING"):
                    asc = False
                else:
                    self.accept_kw("ASC", "ASCENDING")
                order_by.append((e, asc))
                if not self.accept_punct(","):
                    break
        skip = self.parse_expr() if self.accept_kw("SKIP") else None
        limit = self.parse_expr() if self.accept_kw("LIMIT") else None
        return distinct, items, star, order_by, skip, limit

    def _parse_projection_item(self) -> A.Projection:
        start = self.cur.pos
        e = self.parse_expr()
        # verbatim source text of the expression = the column header when
        # no alias is given (TCK: `cOuNt( * )`, `n.missing IS NULL`, ...)
        end = self.cur.pos if self.cur.kind != "eof" else len(self.text)
        text = self.text[start:end].strip() if self.text else None
        alias = None
        if self.accept_kw("AS"):
            alias = self.ident_or_kw()
        return A.Projection(e, alias, text)

    def parse_with(self) -> A.WithClause:
        self.expect_kw("WITH")
        distinct, items, star, order_by, skip, limit = self._parse_projection_body()
        where = self.parse_expr() if self.accept_kw("WHERE") else None
        return A.WithClause(distinct, items, star, order_by, skip, limit, where)

    def parse_return(self) -> A.ReturnClause:
        self.expect_kw("RETURN")
        distinct, items, star, order_by, skip, limit = self._parse_projection_body()
        return A.ReturnClause(distinct, items, star, order_by, skip, limit)

    def parse_unwind(self) -> A.UnwindClause:
        self.expect_kw("UNWIND")
        e = self.parse_expr()
        self.expect_kw("AS")
        return A.UnwindClause(e, self.ident_or_kw())

    def parse_call(self):
        self.expect_kw("CALL")
        if self.cur.is_punct("{"):
            self.advance()
            inner = self._parse_single_query()
            self.expect_punct("}")
            return A.CallSubquery(inner)
        name_parts = [self.ident_or_kw()]
        while self.accept_punct("."):
            name_parts.append(self.ident_or_kw())
        proc = ".".join(name_parts).lower()  # procedures match case-insensitively
        args: list = []
        if self.accept_punct("("):
            if not self.cur.is_punct(")"):
                args.append(self.parse_expr())
                while self.accept_punct(","):
                    args.append(self.parse_expr())
            self.expect_punct(")")
        yields: list = []
        where = None
        if self.accept_kw("YIELD"):
            while True:
                y = self.ident_or_kw()
                alias = self.ident_or_kw() if self.accept_kw("AS") else None
                yields.append((y, alias))
                if not self.accept_punct(","):
                    break
            if self.accept_kw("WHERE"):
                where = self.parse_expr()
        return A.CallClause(proc, args, yields, where)

    def parse_foreach(self) -> A.ForeachClause:
        self.expect_kw("FOREACH")
        self.expect_punct("(")
        var = self.ident_or_kw()
        self.expect_kw("IN")
        source = self.parse_expr()
        self.expect_punct("|")
        updates = []
        while not self.cur.is_punct(")"):
            c = self.parse_clause()
            if c is None:
                self.error("expected update clause in FOREACH")
            updates.append(c)
        self.expect_punct(")")
        return A.ForeachClause(var, source, updates)

    def parse_load_csv(self) -> A.LoadCsvClause:
        self.expect_kw("LOAD")
        self.expect_kw("CSV")
        with_headers = False
        if self.accept_kw("WITH"):
            self.expect_kw("HEADERS")
            with_headers = True
        self.expect_kw("FROM")
        url = self.parse_expr()
        self.expect_kw("AS")
        alias = self.ident_or_kw()
        term = None
        if self.accept_kw("FIELDTERMINATOR"):
            term = self.parse_expr()
        return A.LoadCsvClause(url, alias, with_headers, term)

    # -- DDL -------------------------------------------------------------------

    def parse_create_index_or_constraint(self):
        self.expect_kw("CREATE")
        kind = "range"
        if self.accept_kw("CONSTRAINT"):
            self.error("use GRAPH.CONSTRAINT / db API for constraints")
        if self.accept_kw("VECTOR"):
            kind = "vector"
        elif self.accept_kw("FULLTEXT"):
            kind = "fulltext"
        else:
            self.accept_kw("RANGE")
        self.expect_kw("INDEX")
        if_not_exists = False
        if self.cur.kind == "ident" and self.cur.value.upper() == "IF":
            self.advance()
            if not (self.accept_kw("NOT") and self.accept_kw("EXISTS")):
                self.error("expected IF NOT EXISTS")
            if_not_exists = True
        self.expect_kw("FOR")
        entity, label, var = self._parse_index_target()
        self.expect_kw("ON")
        props = []
        if self.accept_punct("("):
            while True:
                v = self.ident_or_kw()
                self.expect_punct(".")
                props.append(self.ident_or_kw())
                if not self.accept_punct(","):
                    break
            self.expect_punct(")")
        else:
            self.expect_punct(".")
            props.append(self.ident_or_kw())
        options = None
        if self.cur.is_kw("USING") or (
            self.cur.kind == "ident" and self.cur.value.upper() == "OPTIONS"
        ):
            self.advance()
            options = self.parse_expr()
        return A.CreateIndexClause(kind, entity, label, props, options, if_not_exists)

    def _parse_index_target(self):
        self.expect_punct("(")
        if self.cur.is_punct(")"):  # FOR ()-[r:T]-() edge index
            self.advance()
            self.expect_punct("-")
            self.expect_punct("[")
            var = None
            if self.cur.kind in ("ident", "kw"):
                var = self.ident_or_kw()
            self.expect_punct(":")
            label = self.ident_or_kw()
            self.expect_punct("]")
            self.expect_punct("-")
            self.expect_punct("(")
            self.expect_punct(")")
            return "edge", label, var
        var = None
        if self.cur.kind in ("ident", "kw"):
            var = self.ident_or_kw()
        self.expect_punct(":")
        label = self.ident_or_kw()
        self.expect_punct(")")
        return "node", label, var

    def parse_drop(self):
        self.expect_kw("DROP")
        self.expect_kw("INDEX")
        self.expect_kw("FOR")
        entity, label, _ = self._parse_index_target()
        self.expect_kw("ON")
        props = []
        if self.accept_punct("("):
            while True:
                self.ident_or_kw()
                self.expect_punct(".")
                props.append(self.ident_or_kw())
                if not self.accept_punct(","):
                    break
            self.expect_punct(")")
        else:
            self.expect_punct(".")
            props.append(self.ident_or_kw())
        return A.DropIndexClause(entity, label, props)

    # -- patterns --------------------------------------------------------------

    def parse_pattern_path(self) -> A.PatternPath:
        var = None
        if self.cur.kind == "ident" and self.peek().is_punct("="):
            var = self.advance().value
            self.advance()  # =
        shortest = None
        if self.cur.is_kw("SHORTESTPATH", "ALLSHORTESTPATHS") or (
            self.cur.kind == "ident"
            and self.cur.value.lower() in ("shortestpath", "allshortestpaths")
        ):
            name = (self.cur.value or "").lower() if self.cur.kind == "ident" else self.cur.value.lower()
            shortest = "all" if name == "allshortestpaths" else "single"
            self.advance()
            self.expect_punct("(")
            inner = self.parse_pattern_path()
            self.expect_punct(")")
            inner.var = var
            inner.shortest = shortest
            return inner
        elements = [self.parse_node_pattern()]
        while self.cur.is_punct("-", "<-"):
            rel = self.parse_rel_pattern()
            node = self.parse_node_pattern()
            elements.append(rel)
            elements.append(node)
        return A.PatternPath(var, elements, shortest)

    def parse_node_pattern(self) -> A.NodePattern:
        self.expect_punct("(")
        var = None
        labels: list[str] = []
        props = None
        if self.cur.kind in ("ident", "kw"):
            var = self.ident_or_kw()
        while self.accept_punct(":"):
            labels.append(self.ident_or_kw())
        if self.cur.is_punct("{") or self.cur.is_punct("$"):
            props = self.parse_expr()
        self.expect_punct(")")
        return A.NodePattern(var, labels, props)

    def parse_rel_pattern(self) -> A.RelPattern:
        direction = "both"
        if self.accept_punct("<-"):
            direction = "in"
        else:
            self.expect_punct("-")
        var = None
        types: list[str] = []
        props = None
        min_hops = max_hops = None
        varlen = False
        if self.accept_punct("["):
            if self.cur.kind == "ident" and not self.peek().is_punct("("):
                var = self.advance().value
            elif self.cur.kind == "kw" and self.cur.value not in ("IN",) and (
                self.peek().is_punct(":", "]", "*", "{")
            ):
                var = self.advance().value.lower()
            if self.accept_punct(":"):
                types.append(self.ident_or_kw())
                while self.accept_punct("|"):
                    self.accept_punct(":")
                    types.append(self.ident_or_kw())
            if self.accept_punct("*"):
                varlen = True
                min_hops, max_hops = 1, None
                if self.cur.kind == "int":
                    min_hops = self.advance().value
                    max_hops = min_hops
                if self.accept_punct(".."):
                    max_hops = None
                    if self.cur.kind == "int":
                        max_hops = self.advance().value
            if self.cur.is_punct("{") or self.cur.is_punct("$"):
                props = self.parse_expr()
            self.expect_punct("]")
        if self.accept_punct("->"):
            # <-[..]-> arrows on both ends = undirected (TCK Match3 [19]:
            # (a)-->(x)<-->(b) matches either direction)
            direction = "both" if direction == "in" else "out"
        else:
            self.expect_punct("-")
        return A.RelPattern(var, types, props, direction, min_hops, max_hops, varlen)

    # -- expressions -----------------------------------------------------------

    def parse_expr(self) -> A.Expr:
        return self.parse_or()

    def parse_or(self) -> A.Expr:
        left = self.parse_xor()
        while self.cur.is_kw("OR"):
            self.advance()
            left = A.Binary("OR", left, self.parse_xor())
        return left

    def parse_xor(self) -> A.Expr:
        left = self.parse_and()
        while self.cur.is_kw("XOR"):
            self.advance()
            left = A.Binary("XOR", left, self.parse_and())
        return left

    def parse_and(self) -> A.Expr:
        left = self.parse_not()
        while self.cur.is_kw("AND"):
            self.advance()
            left = A.Binary("AND", left, self.parse_not())
        return left

    def parse_not(self) -> A.Expr:
        if self.accept_kw("NOT"):
            return A.Unary("NOT", self.parse_not())
        return self.parse_comparison()

    _CMP = ("=", "<>", "<", "<=", ">", ">=")

    def parse_comparison(self) -> A.Expr:
        # comparison operands are string/list/null-predicate expressions:
        # `false = true IS NULL` parses as `false = (true IS NULL)` and
        # `a = b IN c` as `a = (b IN c)` (openCypher grammar
        # StringListNullPredicateExpression; TCK Precedence1/3/4)
        left = self.parse_predicates()
        conds = []
        node = left
        while self.cur.kind == "punct" and self.cur.value in self._CMP:
            op = self.advance().value
            right = self.parse_predicates()
            conds.append(A.Binary(op, node, right))
            node = right
        if not conds:
            return left
        out = conds[0]
        for c in conds[1:]:
            # chained comparison: a < b < c == (a < b) AND (b < c)
            out = A.Binary("AND", out, c)
        return out

    def parse_predicates(self) -> A.Expr:
        """Postfix IS [NOT] NULL / IN / STARTS WITH / ENDS WITH / CONTAINS
        / =~ — bind tighter than comparisons, chain left-to-right."""
        node = self.parse_addsub()
        while True:
            t = self.cur
            if t.is_kw("IS"):
                self.advance()
                negated = self.accept_kw("NOT")
                self.expect_kw("NULL")
                node = A.IsNull(node, negated)
                continue
            if t.is_kw("IN"):
                self.advance()
                node = A.Binary("IN", node, self.parse_addsub())
                continue
            if t.is_kw("STARTS"):
                self.advance()
                self.expect_kw("WITH")
                node = A.Binary("STARTS", node, self.parse_addsub())
                continue
            if t.is_kw("ENDS"):
                self.advance()
                self.expect_kw("WITH")
                node = A.Binary("ENDS", node, self.parse_addsub())
                continue
            if t.is_kw("CONTAINS"):
                self.advance()
                node = A.Binary("CONTAINS", node, self.parse_addsub())
                continue
            if t.is_punct("=~"):
                self.advance()
                node = A.Binary("=~", node, self.parse_addsub())
                continue
            return node

    def parse_addsub(self) -> A.Expr:
        left = self.parse_muldiv()
        while self.cur.is_punct("+", "-"):
            op = self.advance().value
            left = A.Binary(op, left, self.parse_muldiv())
        return left

    def parse_muldiv(self) -> A.Expr:
        left = self.parse_pow()
        while self.cur.is_punct("*", "/", "%"):
            op = self.advance().value
            left = A.Binary(op, left, self.parse_pow())
        return left

    def parse_pow(self) -> A.Expr:
        left = self.parse_unary()
        while self.cur.is_punct("^"):
            # LEFT-associative in openCypher: 4^6^3 = (4^6)^3
            # (TCK Precedence2 [2]/[3])
            self.advance()
            left = A.Binary("^", left, self.parse_unary())
        return left

    _INT64_MAX = 2**63 - 1

    def parse_unary(self) -> A.Expr:
        if self.cur.is_punct("-"):
            self.advance()
            if self.cur.kind == "int":
                # fold the sign so the exact int64 minimum is expressible
                # (TCK Literals2 [9]/[10]: range-check at compile time)
                v = self.cur.value
                if v > 2**63:
                    raise ParseError("integer literal out of range")
                self.advance()
                return A.Lit(-v)
            return A.Unary("-", self.parse_unary())
        if self.cur.is_punct("+"):
            self.advance()
            return self.parse_unary()
        return self.parse_expr_atom_postfix()

    def parse_expr_atom_postfix(self) -> A.Expr:
        e = self.parse_atom()
        while True:
            if self.cur.is_punct("."):
                self.advance()
                e = A.Prop(e, self.ident_or_kw())
                # function-style method call sugar not supported
                continue
            if self.cur.is_punct("["):
                self.advance()
                lo = None
                if not self.cur.is_punct(".."):
                    lo = self.parse_expr()
                if self.accept_punct(".."):
                    hi = None
                    if not self.cur.is_punct("]"):
                        hi = self.parse_expr()
                    e = A.Slice(e, lo, hi)
                else:
                    e = A.DynProp(e, lo)
                self.expect_punct("]")
                continue
            # inline label predicate: n:Person (expression context)
            if (
                self.cur.is_punct(":")
                and isinstance(e, A.Var)
                and self.peek().kind in ("ident", "kw")
            ):
                labels = []
                while self.accept_punct(":"):
                    labels.append(self.ident_or_kw())
                e = A.FnCall("haslabels", [e, A.Lit(labels)])
                continue
            break
        return e

    def parse_atom(self) -> A.Expr:
        t = self.cur
        if t.kind == "int" or t.kind == "float" or t.kind == "string":
            if t.kind == "int" and t.value > self._INT64_MAX:
                raise ParseError("integer literal out of range")
            self.advance()
            return A.Lit(t.value)
        if t.is_kw("TRUE"):
            self.advance()
            return A.Lit(True)
        if t.is_kw("FALSE"):
            self.advance()
            return A.Lit(False)
        if t.is_kw("NULL"):
            self.advance()
            return A.Lit(None)
        if t.is_punct("$"):
            self.advance()
            if self.cur.kind == "int":
                return A.Param(str(self.advance().value))
            return A.Param(self.ident_or_kw())
        if t.is_punct("("):
            # parenthesised expr OR a bare pattern expression (n)-[:T]->(m)
            save = self.i
            try:
                self.advance()
                e = self.parse_expr()
                self.expect_punct(")")
            except ParseError:
                self.i = save
                return self._parse_pattern_expr()
            if self.cur.is_punct("-", "<-") and isinstance(e, A.Var):
                self.i = save
                return self._parse_pattern_expr()
            return e
        if t.is_punct("["):
            return self.parse_list_or_comprehension()
        if t.is_punct("{"):
            return self.parse_map()
        if t.is_kw("COUNT") and self.peek().is_punct("("):
            if self.peek(2).is_punct("*"):
                self.advance(); self.advance(); self.advance()
                self.expect_punct(")")
                return A.CountStar()
            return self.parse_fncall()
        if t.is_kw("CASE"):
            return self.parse_case()
        if t.is_kw("EXISTS"):
            return self.parse_exists()
        if t.is_kw("REDUCE"):
            return self.parse_reduce()
        if t.is_kw("ANY", "ALL", "NONE", "SINGLE") and self.peek().is_punct("("):
            return self.parse_quantifier()
        if t.is_kw("SHORTESTPATH", "ALLSHORTESTPATHS"):
            all_paths = t.value == "ALLSHORTESTPATHS"
            self.advance()
            self.expect_punct("(")
            pat = self.parse_pattern_path()
            self.expect_punct(")")
            return A.ShortestPathExpr(pat, all_paths)
        if t.kind in ("ident", "kw"):
            # function call (possibly dotted) or variable
            if self.peek().is_punct("(") :
                return self.parse_fncall()
            if self.peek().is_punct(".") :
                # could be pkg.fn( — lookahead for dotted call
                save = self.i
                parts = [self.ident_or_kw()]
                while self.cur.is_punct(".") and self.peek().kind in ("ident", "kw") and self.peek(2).is_punct("(", "."):
                    self.advance()
                    parts.append(self.ident_or_kw())
                if self.cur.is_punct("(") and len(parts) > 1:
                    return self.parse_fncall_named(".".join(parts))
                self.i = save
            name = self.ident_or_kw()
            return A.Var(name)
        self.error("expected expression")

    def _parse_pattern_expr(self) -> A.Expr:
        pat = self.parse_pattern_path()
        return A.ExistsExpr(pattern=pat, prop=None)

    def parse_fncall(self) -> A.Expr:
        parts = [self.ident_or_kw()]
        while self.accept_punct("."):
            parts.append(self.ident_or_kw())
        return self.parse_fncall_named(".".join(parts))

    def parse_fncall_named(self, name: str) -> A.Expr:
        self.expect_punct("(")
        distinct = self.accept_kw("DISTINCT")
        args: list = []
        if not self.cur.is_punct(")"):
            if self.cur.is_punct("*") and name.lower() == "count":
                self.advance()
                self.expect_punct(")")
                return A.CountStar()
            args.append(self.parse_expr())
            while self.accept_punct(","):
                args.append(self.parse_expr())
        self.expect_punct(")")
        return A.FnCall(name.lower(), args, distinct, orig=name)

    def parse_list_or_comprehension(self) -> A.Expr:
        self.expect_punct("[")
        if self.cur.is_punct("]"):
            self.advance()
            return A.ListLit([])
        # pattern comprehension: [(a)-[:R]->(b) WHERE p | e], optionally
        # path-binding: [p = (n)-->() | p] (TCK Pattern2 [1]-[11])
        if self.cur.is_punct("(") or (
                self.cur.kind == "ident" and self.peek().is_punct("=")
                and self.peek(2).is_punct("(")):
            save = self.i
            try:
                pat = self.parse_pattern_path()
                if len(pat.elements) >= 3:
                    where = self.parse_expr() if self.accept_kw("WHERE") else None
                    self.expect_punct("|")
                    proj = self.parse_expr()
                    self.expect_punct("]")
                    return A.PatternComp(pat, where, proj)
                self.i = save
            except ParseError:
                self.i = save
        # lookahead for comprehension: ident IN
        if self.cur.kind == "ident" and self.peek().is_kw("IN"):
            var = self.advance().value
            self.advance()  # IN
            source = self.parse_expr()
            where = None
            proj = None
            if self.accept_kw("WHERE"):
                where = self.parse_expr()
            if self.accept_punct("|"):
                proj = self.parse_expr()
            self.expect_punct("]")
            return A.ListComp(var, source, where, proj)
        items = [self.parse_expr()]
        while self.accept_punct(","):
            items.append(self.parse_expr())
        self.expect_punct("]")
        return A.ListLit(items)

    def parse_map(self) -> A.Expr:
        self.expect_punct("{")
        items: list[tuple[str, A.Expr]] = []
        if not self.cur.is_punct("}"):
            while True:
                key = self.ident_or_kw() if self.cur.kind != "string" else self.advance().value
                self.expect_punct(":")
                items.append((key, self.parse_expr()))
                if not self.accept_punct(","):
                    break
        self.expect_punct("}")
        return A.MapLit(items)

    def parse_case(self) -> A.Expr:
        self.expect_kw("CASE")
        operand = None
        if not self.cur.is_kw("WHEN"):
            operand = self.parse_expr()
        whens = []
        while self.accept_kw("WHEN"):
            cond = self.parse_expr()
            self.expect_kw("THEN")
            whens.append((cond, self.parse_expr()))
        default = None
        if self.accept_kw("ELSE"):
            default = self.parse_expr()
        self.expect_kw("END")
        return A.Case(operand, whens, default)

    def parse_exists(self) -> A.Expr:
        self.expect_kw("EXISTS")
        if self.cur.is_punct("{"):
            self.advance()
            self.accept_kw("MATCH")
            pat = self.parse_pattern_path()
            where = self.parse_expr() if self.accept_kw("WHERE") else None
            self.expect_punct("}")
            return A.ExistsExpr(pattern=pat, prop=None, where=where)
        self.expect_punct("(")
        if self.cur.is_punct("("):
            pat = self.parse_pattern_path()
            self.expect_punct(")")
            return A.ExistsExpr(pattern=pat, prop=None)
        e = self.parse_expr()
        self.expect_punct(")")
        if isinstance(e, A.ExistsExpr):
            return e
        return A.ExistsExpr(pattern=None, prop=e)

    def parse_reduce(self) -> A.Expr:
        self.expect_kw("REDUCE")
        self.expect_punct("(")
        acc = self.ident_or_kw()
        self.expect_punct("=")
        init = self.parse_expr()
        self.expect_punct(",")
        var = self.ident_or_kw()
        self.expect_kw("IN")
        source = self.parse_expr()
        self.expect_punct("|")
        step = self.parse_expr()
        self.expect_punct(")")
        return A.Reduce(acc, init, var, source, step)

    def parse_quantifier(self) -> A.Expr:
        kind = self.advance().value.lower()
        self.expect_punct("(")
        var = self.ident_or_kw()
        self.expect_kw("IN")
        source = self.parse_expr()
        where = None
        if self.accept_kw("WHERE"):
            where = self.parse_expr()
        self.expect_punct(")")
        return A.Quantifier(kind, var, source, where)


def _const_value(e: A.Expr):
    if isinstance(e, A.Lit):
        return e.value
    if isinstance(e, A.Unary) and e.op == "-":
        v = _const_value(e.operand)
        return -v
    if isinstance(e, A.ListLit):
        return [_const_value(x) for x in e.items]
    if isinstance(e, A.MapLit):
        return {k: _const_value(v) for k, v in e.items}
    raise ParseError("CYPHER parameter values must be literals")


def parse(text: str) -> A.Query:
    try:
        return Parser(tokenize(text), text).parse_query()
    except RecursionError:
        raise ParseError("expression too deeply nested")
