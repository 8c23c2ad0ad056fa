"""SQL parser: text -> logical plans, trimmed to the single-device
aggregate, join and subquery slices.

Hand-written tokenizer, recursive-descent expression parser and
statement builder for SELECT [DISTINCT] ... FROM <relations> [WHERE]
[GROUP BY] [HAVING] [ORDER BY] [LIMIT [OFFSET]] with comparisons,
BETWEEN, [NOT] IN (list | subquery), [NOT] LIKE, [NOT] EXISTS, scalar
subqueries, IS [NOT] NULL, arithmetic, CASE, CAST, substring, extract,
coalesce, date literals, day/week/month/year intervals and the
count/sum/avg/min/max aggregates (count/sum/avg also DISTINCT). The
FROM clause takes tables and derived tables ``( SELECT ... ) [AS]
alias`` with aliases, comma joins and ``[INNER|CROSS|LEFT [OUTER]|RIGHT
[OUTER]|FULL [OUTER]|LEFT SEMI|LEFT ANTI] JOIN ... ON/USING``. A
subquery resolves names it cannot find in its own FROM clause against
the enclosing query's (``OuterRef``); ``parse_sql`` hands the plan to
``plan/subquery.py``, which rewrites every subquery into joins. Window
functions, grouping sets, LATERAL VIEW and set operations raise
``NotImplementedError``; other constructs are parse errors. The
reference parses with an ANTLR grammar (reference:
sql/catalyst/src/main/antlr4/.../SqlBaseParser.g4:1 +
parser/AstBuilder.scala); name resolution happens during parsing
against the FROM clause's scope, folding the Analyzer's resolution tier
(reference: analysis/Analyzer.scala:188) into plan construction.
"""

from __future__ import annotations

import datetime
import re
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from spark_tpu_torch import types as T
from spark_tpu_torch.expr import expressions as E
from spark_tpu_torch.plan import logical as L
from spark_tpu_torch.plan.optimizer import combine_conjuncts, split_conjuncts
from spark_tpu_torch.plan.subquery import rewrite_subqueries
from spark_tpu_torch.sql.ddl import parse_type

# ---- tokenizer --------------------------------------------------------------

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+|--[^\n]*|/\*.*?\*/)
  | (?P<num>\d+\.\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?|\d+(?:[eE][+-]?\d+)?)
  | (?P<str>'(?:[^']|'')*')
  | (?P<qid>"[^"]*"|`[^`]*`)
  | (?P<op><>|!=|>=|<=|[=<>+\-*/%(),.;])
  | (?P<id>[A-Za-z_][A-Za-z_0-9]*)
""", re.VERBOSE | re.DOTALL)


@dataclass
class Token:
    kind: str  # 'num' | 'str' | 'id' | 'qid' | 'op' | 'eof'
    value: str
    pos: int

    @property
    def upper(self) -> str:
        return self.value.upper()


def tokenize(text: str) -> List[Token]:
    out: List[Token] = []
    pos = 0
    n = len(text)
    while pos < n:
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            raise SQLParseError(
                f"unexpected character {text[pos]!r} at {pos}: "
                f"...{text[max(0, pos - 20):pos + 20]}...")
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        val = m.group()
        if kind == "qid":
            val = val[1:-1]
        out.append(Token(kind, val, m.start()))
    out.append(Token("eof", "", n))
    return out


class SQLParseError(ValueError):
    pass


_RESERVED_STOP = {
    "FROM", "WHERE", "GROUP", "HAVING", "ORDER", "LIMIT", "OFFSET", "ON",
    "JOIN", "INNER", "LEFT", "RIGHT", "FULL", "CROSS", "OUTER", "UNION",
    "INTERSECT", "EXCEPT", "AS", "AND", "OR", "NOT", "BY", "ASC", "DESC",
    "THEN", "WHEN", "ELSE", "END", "USING", "SEMI", "ANTI", "NULLS",
    "LATERAL",
}


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} are not ported yet (ROADMAP queue A)")


# ---- name resolution scope --------------------------------------------------


class Scope:
    """FROM-clause namespace: per-alias source->output column mapping.

    Join output names deduplicate with '#2' suffixes (logical.Join.schema
    semantics); the scope tracks, for every relation in the FROM clause,
    what each of its columns is called in the joined output, so
    ``alias.col`` and bare ``col`` resolve to output Col names. A
    subquery's scope carries the enclosing query's (``outer``): a name
    found only there is a correlated reference, typed by that scope's
    ``schema`` (its FROM clause's plan schema)."""

    def __init__(self, outer: Optional["Scope"] = None):
        self.entries: List[Tuple[Optional[str], List[Tuple[str, str]]]] = []
        self.outer = outer
        self.schema = None

    def add_relation(self, alias: Optional[str],
                     src_names: Sequence[str]) -> List[str]:
        """Register a relation; returns the OUTPUT names its columns get
        after join-dedup against everything already in scope."""
        seen = {out for _, cols in self.entries for _, out in cols}
        mapping = []
        for n in src_names:
            out = n
            while out in seen:
                out = out + "#2"
            seen.add(out)
            mapping.append((n, out))
        self.entries.append((alias.lower() if alias else None, mapping))
        return [out for _, out in mapping]

    def resolve(self, qualifier: Optional[str], name: str) -> Optional[str]:
        name_l = name.lower()
        if qualifier is not None:
            q = qualifier.lower()
            for alias, cols in self.entries:
                if alias == q:
                    for src, out in cols:
                        if src.lower() == name_l:
                            return out
            return None
        hits = [out for _, cols in self.entries for src, out in cols
                if src.lower() == name_l]
        if len(hits) > 1:
            raise SQLParseError(f"ambiguous column reference {name!r}")
        return hits[0] if hits else None

    def all_output_names(self) -> List[str]:
        return [out for _, cols in self.entries for _, out in cols]

    def relation_outputs(self, alias: str) -> Optional[List[str]]:
        q = alias.lower()
        for a, cols in self.entries:
            if a == q:
                return [out for _, out in cols]
        return None


# ---- expression parser -------------------------------------------------------

Resolver = Callable[[Optional[str], str], E.Expression]


class _Tokens:
    """Token cursor shared by the expression and statement parsers."""

    def __init__(self, tokens: List[Token], pos: int = 0):
        self.toks = tokens
        self.pos = pos

    def peek(self, ahead: int = 0) -> Token:
        return self.toks[min(self.pos + ahead, len(self.toks) - 1)]

    def next(self) -> Token:  # noqa: A003
        t = self.toks[self.pos]
        self.pos += 1
        return t

    def accept(self, *values: str) -> Optional[Token]:
        t = self.peek()
        if t.kind in ("id", "op") and t.upper in values:
            return self.next()
        return None

    def expect(self, value: str) -> Token:
        t = self.next()
        if t.upper != value:
            raise SQLParseError(
                f"expected {value!r}, found {t.value!r} at {t.pos}")
        return t

    def at_keyword(self, *values: str) -> bool:
        t = self.peek()
        return t.kind == "id" and t.upper in values


class _ExprParser:
    def __init__(self, cur: _Tokens, resolver: Resolver,
                 subquery: Optional[Callable[[], L.LogicalPlan]] = None):
        self.resolve = resolver
        # parses ``SELECT ...`` at the cursor (after a '('); None where
        # no subquery may appear
        self.subquery = subquery
        # the cursor's own methods: statement and expression parsers
        # advance one shared position
        self.peek, self.next = cur.peek, cur.next
        self.accept, self.expect = cur.accept, cur.expect
        self.at_keyword = cur.at_keyword

    def parse(self) -> E.Expression:
        return self.parse_or()

    def parse_or(self) -> E.Expression:
        left = self.parse_and()
        while self.accept("OR"):
            left = E.Or(left, self.parse_and())
        return left

    def parse_and(self) -> E.Expression:
        left = self.parse_not()
        while self.accept("AND"):
            left = E.And(left, self.parse_not())
        return left

    def parse_not(self) -> E.Expression:
        if self.accept("NOT"):
            inner = self.parse_not()
            if isinstance(inner, E.Exists):
                return E.Exists(inner.plan, not inner.negated)
            return E.Not(inner)
        return self.parse_predicate()

    def _parse_subquery(self) -> L.LogicalPlan:
        if self.subquery is None:
            raise SQLParseError(
                f"subquery not allowed here (at {self.peek().pos})")
        return self.subquery()

    def parse_predicate(self) -> E.Expression:
        if self.at_keyword("EXISTS"):
            self.next()
            self.expect("(")
            plan = self._parse_subquery()
            self.expect(")")
            return E.Exists(plan)
        left = self.parse_additive()
        negated = bool(self.accept("NOT"))
        t = self.peek()
        if t.kind == "op" and t.value in ("=", "==", "<>", "!=", "<", "<=",
                                          ">", ">=") and not negated:
            op = self.next().value
            op = {"=": "==", "<>": "!="}.get(op, op)
            right = self.parse_additive()
            return E.Cmp(op, left, right)
        if self.accept("BETWEEN"):
            lo = self.parse_additive()
            self.expect("AND")
            hi = self.parse_additive()
            e: E.Expression = E.And(E.Cmp(">=", left, lo),
                                    E.Cmp("<=", left, hi))
            return E.Not(e) if negated else e
        if self.accept("IN"):
            self.expect("(")
            if self.at_keyword("SELECT", "WITH"):
                plan = self._parse_subquery()
                self.expect(")")
                return E.InSubquery(left, plan, negated)
            values = [self._literal_value(self.parse_additive())]
            while self.accept(","):
                values.append(self._literal_value(self.parse_additive()))
            self.expect(")")
            e = E.In(left, tuple(values))
            return E.Not(e) if negated else e
        if self.accept("LIKE"):
            pat = self.next()
            if pat.kind != "str":
                raise SQLParseError(
                    f"LIKE needs a string pattern at {pat.pos}")
            e = E.Like(left, _unquote(pat.value))
            return E.Not(e) if negated else e
        if self.accept("IS"):
            neg2 = bool(self.accept("NOT"))
            self.expect("NULL")
            e = E.IsNull(left)
            return E.Not(e) if (neg2 != negated) else e
        if negated:
            raise SQLParseError(
                f"dangling NOT before {self.peek().value!r}")
        return left

    def parse_additive(self) -> E.Expression:
        left = self.parse_multiplicative()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("+", "-"):
                self.next()
                right = self.parse_multiplicative()
                left = self._date_arith(t.value, left, right)
            else:
                return left

    def _date_arith(self, op: str, left: E.Expression,
                    right: E.Expression) -> E.Expression:
        """Fold interval literals into date arithmetic at parse time."""
        if isinstance(right, _Interval):
            if right.months:
                months = right.months if op == "+" else -right.months
                base = E.AddMonths(left, months)
            else:
                base = left
            if right.days:
                base = E.Arith(op, base, E.Literal(right.days))
            return base
        if isinstance(left, _Interval):
            raise SQLParseError("interval must be the right operand")
        return E.Arith(op, left, right)

    def parse_multiplicative(self) -> E.Expression:
        left = self.parse_unary()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("*", "/", "%"):
                self.next()
                left = E.Arith(t.value, left, self.parse_unary())
            else:
                return left

    def parse_unary(self) -> E.Expression:
        t = self.peek()
        if t.kind == "op" and t.value == "-":
            self.next()
            return E.Neg(self.parse_unary())
        if t.kind == "op" and t.value == "+":
            self.next()
            return self.parse_unary()
        return self.parse_primary()

    def parse_primary(self) -> E.Expression:
        t = self.next()
        if t.kind == "num":
            text = t.value
            if "." in text or "e" in text.lower():
                return E.Literal(float(text))
            return E.Literal(int(text))
        if t.kind == "str":
            return E.Literal(_unquote(t.value))
        if t.kind == "op" and t.value == "(":
            if self.at_keyword("SELECT", "WITH"):
                plan = self._parse_subquery()
                self.expect(")")
                return E.ScalarSubquery(plan)
            e = self.parse()
            if self.accept(","):
                items = [e, self.parse()]
                while self.accept(","):
                    items.append(self.parse())
                self.expect(")")
                return E.TupleExpr(tuple(items))
            self.expect(")")
            return e
        if t.kind in ("id", "qid"):
            return self._parse_identifier(t)
        raise SQLParseError(f"unexpected token {t.value!r} at {t.pos}")

    def _parse_identifier(self, t: Token) -> E.Expression:
        u = t.upper if t.kind == "id" else None
        if u == "NULL":
            return E.Literal(None, T.BOOLEAN)
        if u == "TRUE":
            return E.Literal(True)
        if u == "FALSE":
            return E.Literal(False)
        if u == "DATE" and self.peek().kind == "str":
            s = _unquote(self.next().value)
            return E.Literal(datetime.date.fromisoformat(s))
        if u == "INTERVAL":
            return self._parse_interval()
        if u == "CASE":
            return self._parse_case()
        if u == "EXTRACT":
            self.expect("(")
            part = self.next().value.lower()
            self.expect("FROM")
            e = self.parse()
            self.expect(")")
            return E.ExtractDatePart(part, e)
        if u == "CAST":
            self.expect("(")
            e = self.parse()
            self.expect("AS")
            type_toks = []
            depth = 0
            while True:
                nt = self.peek()
                if nt.kind == "op" and nt.value == "(":
                    depth += 1
                if nt.kind == "op" and nt.value == ")":
                    if depth == 0:
                        break
                    depth -= 1
                type_toks.append(self.next().value)
            self.expect(")")
            return E.Cast(e, parse_type(" ".join(type_toks)))
        nxt = self.peek()
        if nxt.kind == "op" and nxt.value == "(":
            return self._parse_function(t)
        # [qualifier .] column
        if nxt.kind == "op" and nxt.value == "." and \
                self.peek(1).kind in ("id", "qid"):
            self.next()
            col = self.next()
            return self.resolve(t.value, col.value)
        return self.resolve(None, t.value)

    def _parse_interval(self) -> "_Interval":
        t = self.next()
        if t.kind == "str":
            qty = int(_unquote(t.value))
        elif t.kind == "num":
            qty = int(t.value)
        else:
            raise SQLParseError(f"bad interval quantity at {t.pos}")
        unit = self.next().upper.rstrip("S")
        if unit == "YEAR":
            return _Interval(months=12 * qty)
        if unit == "MONTH":
            return _Interval(months=qty)
        if unit == "DAY":
            return _Interval(days=qty)
        if unit == "WEEK":
            return _Interval(days=7 * qty)
        raise SQLParseError(f"unsupported interval unit {unit!r}")

    def _parse_case(self) -> E.Expression:
        branches = []
        operand = None
        if not self.at_keyword("WHEN"):
            operand = self.parse()
        while self.accept("WHEN"):
            cond = self.parse()
            if operand is not None:
                cond = E.Cmp("==", operand, cond)
            self.expect("THEN")
            branches.append((cond, self.parse()))
        else_v = None
        if self.accept("ELSE"):
            else_v = self.parse()
        self.expect("END")
        return E.Case(tuple(branches), else_v)

    _AGG_FNS = {"SUM": E.Sum, "AVG": E.Avg, "MIN": E.Min, "MAX": E.Max,
                "COUNT": E.Count}
    _WINDOW_FNS = {"ROW_NUMBER", "RANK", "DENSE_RANK", "NTILE", "LAG",
                   "LEAD"}

    def _parse_function(self, name_tok: Token) -> E.Expression:
        name = name_tok.upper
        if name in self._WINDOW_FNS:
            raise _not_ported("window functions")
        self.expect("(")
        e = self._parse_function_args(name, name_tok)
        if self.at_keyword("OVER"):
            raise _not_ported("window functions")
        return e

    def _parse_function_args(self, name: str,
                             name_tok: Token) -> E.Expression:
        if name in self._AGG_FNS:
            if name == "COUNT" and self.accept("*"):
                self.expect(")")
                return E.Count(None)
            distinct = bool(self.accept("DISTINCT"))
            e = self.parse()
            self.expect(")")
            if name in ("MIN", "MAX"):
                return self._AGG_FNS[name](e)
            return self._AGG_FNS[name](e, distinct=distinct)
        if name in ("SUBSTRING", "SUBSTR"):
            e = self.parse()
            if self.accept("FROM"):
                pos = self._int_literal()
                self.expect("FOR")
                length = self._int_literal()
            else:
                self.expect(",")
                pos = self._int_literal()
                # substr(s, pos): to the end of the string
                length = self._int_literal() if self.accept(",") else 1 << 30
            self.expect(")")
            return E.Substring(e, pos, length)
        if name == "COALESCE":
            args = [self.parse()]
            while self.accept(","):
                args.append(self.parse())
            self.expect(")")
            return E.Coalesce(tuple(args))
        if name in ("YEAR", "MONTH", "DAY", "DAYOFMONTH"):
            e = self.parse()
            self.expect(")")
            return E.ExtractDatePart({"DAYOFMONTH": "day"}.get(
                name, name.lower()), e)
        raise SQLParseError(f"unknown function {name_tok.value!r} "
                            f"at {name_tok.pos}")

    def _int_literal(self) -> int:
        e = self.parse_unary()
        if isinstance(e, E.Literal) and isinstance(e.value, int):
            return e.value
        if isinstance(e, E.Neg) and isinstance(e.child, E.Literal):
            return -e.child.value
        raise SQLParseError("expected integer literal")

    @staticmethod
    def _literal_value(e: E.Expression):
        if isinstance(e, E.Literal):
            return e.value
        if isinstance(e, E.Neg) and isinstance(e.child, E.Literal):
            return -e.child.value
        raise SQLParseError("IN list supports literals only")


@dataclass(eq=False, frozen=True)
class _Interval(E.Expression):
    months: int = 0
    days: int = 0


def _unquote(s: str) -> str:
    return s[1:-1].replace("''", "'")


# ---- statement parser -------------------------------------------------------


class _StmtParser(_Tokens):
    """Parses one SELECT statement; ``catalog`` resolves table names. A
    subquery's parser starts at ``pos`` with the enclosing query's scope
    as ``outer``, so inner lookups that miss resolve there as
    ``OuterRef``."""

    def __init__(self, tokens: List[Token], catalog, pos: int = 0,
                 outer: Optional[Scope] = None):
        super().__init__(tokens, pos)
        self.catalog = catalog
        self.outer = outer
        # the FROM scope of the SELECT being parsed: the outer scope of a
        # subquery in its expressions
        self._current_scope: Optional[Scope] = None

    def _expr(self, resolver: Resolver) -> E.Expression:
        return _ExprParser(self, resolver,
                           self._parse_subquery_in_expr).parse()

    def _parse_subquery(self, outer: Optional[Scope]) -> L.LogicalPlan:
        sub = _StmtParser(self.toks, self.catalog, self.pos, outer)
        plan = sub.parse_query()
        self.pos = sub.pos
        return plan

    def _parse_subquery_in_expr(self) -> L.LogicalPlan:
        """``SELECT ...`` inside an expression: the current query's scope
        becomes the subquery's outer scope."""
        return self._parse_subquery(self._current_scope)

    # -- resolvers ------------------------------------------------------------

    @staticmethod
    def _make_resolver(scope: Scope) -> Resolver:
        def resolve(qual: Optional[str], name: str) -> E.Expression:
            out = scope.resolve(qual, name)
            if out is not None:
                return E.Col(out)
            if scope.outer is not None:
                out = scope.outer.resolve(qual, name)
                if out is not None:
                    schema = scope.outer.schema
                    dtype = (schema.field(out).dtype
                             if schema is not None and out in schema
                             else None)
                    return E.OuterRef(out, dtype)
            raise SQLParseError(
                f"cannot resolve column {qual + '.' if qual else ''}{name}")

        return resolve

    # -- FROM clause ----------------------------------------------------------

    def _parse_relation_primary(self) -> Tuple[L.LogicalPlan, str]:
        """table [[AS] alias] | ( subquery ) [[AS] alias] — returns
        (plan, alias)."""
        if self.accept("("):
            # a derived table sees the enclosing query's outer scope, not
            # its sibling FROM items
            plan = self._parse_subquery(self.outer)
            self.expect(")")
            return plan, self._parse_alias()
        t = self.next()
        if t.kind not in ("id", "qid"):
            raise SQLParseError(f"expected table name at {t.pos}")
        plan = self.catalog.lookup(t.value)
        alias = self._parse_alias() or t.value
        return plan, alias

    def _parse_from(self) -> Tuple[L.LogicalPlan, Scope]:
        scope = Scope(self.outer)
        plan, alias = self._parse_relation_primary()
        scope.add_relation(alias, plan.schema.names)
        while True:
            if self.accept(","):
                rplan, ralias = self._parse_relation_primary()
                scope.add_relation(ralias, rplan.schema.names)
                plan = L.Join(plan, rplan, "cross", (), ())
                continue
            if self.peek(0).upper == "LATERAL" \
                    and self.peek(1).upper == "VIEW":
                raise _not_ported("LATERAL VIEW generators")
            how = self._peek_join_type()
            if how is None:
                break
            rplan, ralias = self._parse_relation_primary()
            right_src = rplan.schema.names
            # output names the right side will take post-dedup
            out_names = scope.add_relation(ralias, right_src)
            right_sub = {out: src for out, src in zip(out_names, right_src)}
            if self.accept("ON"):
                cond = self._expr(self._make_resolver(scope))
                plan = self._build_join(plan, rplan, how, cond, right_sub)
            elif self.accept("USING"):
                self.expect("(")
                cols = [self.next().value]
                while self.accept(","):
                    cols.append(self.next().value)
                self.expect(")")
                lk = tuple(E.Col(c) for c in cols)
                plan = L.Join(plan, rplan, how, lk, lk)
            else:
                if how != "cross":
                    raise SQLParseError("JOIN requires ON or USING")
                plan = L.Join(plan, rplan, "cross", (), ())
        return plan, scope

    _JOIN_TYPES = (
        (("CROSS", "JOIN"), "cross"),
        (("INNER", "JOIN"), "inner"),
        (("LEFT", "SEMI", "JOIN"), "left_semi"),
        (("LEFT", "ANTI", "JOIN"), "left_anti"),
        (("LEFT", "OUTER", "JOIN"), "left"),
        (("LEFT", "JOIN"), "left"),
        (("RIGHT", "OUTER", "JOIN"), "right"),
        (("RIGHT", "JOIN"), "right"),
        (("FULL", "OUTER", "JOIN"), "full"),
        (("FULL", "JOIN"), "full"),
        (("JOIN",), "inner"),
    )

    def _peek_join_type(self) -> Optional[str]:
        for words, how in self._JOIN_TYPES:
            if all(self.peek(i).upper == w for i, w in enumerate(words)):
                for _ in words:
                    self.next()
                return how
        return None

    def _build_join(self, left: L.LogicalPlan, right: L.LogicalPlan,
                    how: str, cond: E.Expression,
                    right_out_to_src: Dict[str, str]) -> L.LogicalPlan:
        """Split an ON condition into equi keys + residual. The condition
        references OUTPUT names; keys must be rewritten to each side's
        SOURCE names (the engines evaluate keys on child pipes)."""
        left_out = set(left.schema.names)
        right_out = set(right_out_to_src)

        def to_src(e: E.Expression) -> E.Expression:
            def fn(x):
                if isinstance(x, E.Col) and x.col_name in right_out_to_src:
                    return E.Col(right_out_to_src[x.col_name])
                return x

            return E.transform_expr(e, fn)

        lkeys: List[E.Expression] = []
        rkeys: List[E.Expression] = []
        residual: List[E.Expression] = []
        for c in split_conjuncts(cond):
            if isinstance(c, E.Cmp) and c.op == "==":
                lr, rr = c.left.references(), c.right.references()
                if lr and lr <= left_out and rr and rr <= right_out:
                    lkeys.append(c.left)
                    rkeys.append(to_src(c.right))
                    continue
                if rr and rr <= left_out and lr and lr <= right_out:
                    lkeys.append(c.right)
                    rkeys.append(to_src(c.left))
                    continue
            residual.append(c)
        res = combine_conjuncts(residual) if residual else None
        return L.Join(left, right, how, tuple(lkeys), tuple(rkeys), res)

    def _parse_alias(self) -> Optional[str]:
        if self.accept("AS"):
            return self.next().value
        t = self.peek()
        if t.kind in ("id", "qid") and (t.kind == "qid"
                                        or t.upper not in _RESERVED_STOP):
            return self.next().value
        return None

    # -- SELECT ----------------------------------------------------------------

    def parse_query(self) -> L.LogicalPlan:
        """query := select_core [ORDER BY ...] [LIMIT n [OFFSET m]]"""
        plan = self.parse_select_core()
        if self.at_keyword("UNION", "INTERSECT", "EXCEPT"):
            raise _not_ported("set operations")
        return self._parse_order_limit(plan)

    def _parse_order_limit(self, plan: L.LogicalPlan) -> L.LogicalPlan:
        if self.at_keyword("ORDER"):
            self.next()
            self.expect("BY")
            out_names = set(plan.schema.names)
            # ORDER BY may reference projection INPUT columns that the
            # select list dropped (reference: Analyzer
            # ResolveSortReferences — the sort sees a widened Project,
            # then the extra columns are projected away again)
            hidden: set = set()
            child_names = (set(plan.child.schema.names)
                           if isinstance(plan, L.Project) else set())

            def resolve(qual, name):
                # ORDER BY resolves against the select OUTPUT (a
                # qualifier is dropped), then against the projection's
                # input columns
                if name in out_names:
                    return E.Col(name)
                for n in out_names:  # case-insensitive fallback
                    if n.lower() == name.lower():
                        return E.Col(n)
                for n in child_names:
                    if n.lower() == name.lower():
                        hidden.add(n)
                        return E.Col(n)
                raise SQLParseError(
                    f"ORDER BY column "
                    f"{(qual + '.' if qual else '') + name!r} is not in "
                    f"the select list output {sorted(out_names)}")

            orders = []
            while True:
                e = self._expr(resolve)
                asc = True
                if self.accept("DESC"):
                    asc = False
                elif self.accept("ASC"):
                    pass
                nulls_first = None
                if self.accept("NULLS"):
                    nf = self.next().upper
                    nulls_first = nf == "FIRST"
                orders.append(E.SortOrder(e, asc, nulls_first))
                if not self.accept(","):
                    break
            if hidden:
                visible = tuple(plan.schema.names)
                widened = L.Project(
                    tuple(plan.exprs)
                    + tuple(E.Col(n) for n in sorted(hidden)
                            if n not in out_names),
                    plan.child)
                plan = L.Project(tuple(E.Col(n) for n in visible),
                                 L.Sort(tuple(orders), widened))
            else:
                plan = L.Sort(tuple(orders), plan)
        if self.at_keyword("LIMIT"):
            self.next()
            n = int(self.next().value)
            offset = 0
            if self.at_keyword("OFFSET"):
                self.next()
                offset = int(self.next().value)
            plan = L.Limit(n, plan, offset=offset)
        return plan

    def parse_select_core(self) -> L.LogicalPlan:
        self.expect("SELECT")
        distinct = bool(self.accept("DISTINCT"))
        self.accept("ALL")

        # select list is parsed AFTER from (resolution needs the
        # relation), so remember its token span and skip ahead to FROM
        select_start = self.pos
        depth = 0
        while True:
            t = self.peek()
            if t.kind == "eof":
                break
            if t.kind == "op" and t.value == "(":
                depth += 1
            elif t.kind == "op" and t.value == ")":
                if depth == 0:
                    break
                depth -= 1
            elif depth == 0 and t.kind == "id" and t.upper == "FROM":
                break
            self.next()
        select_end = self.pos

        self.expect("FROM")
        plan, scope = self._parse_from()
        scope.schema = plan.schema
        self._current_scope = scope
        resolver = self._make_resolver(scope)

        if self.accept("WHERE"):
            plan = L.Filter(self._expr(resolver), plan)

        # parse the saved select list now
        saved = self.pos
        self.pos = select_start
        select_exprs = self._parse_select_list(select_end, scope, resolver)
        self.pos = saved

        group_exprs: List[E.Expression] = []
        if self.at_keyword("GROUP"):
            self.next()
            self.expect("BY")
            if self.at_keyword("ROLLUP", "CUBE") \
                    or self.peek(0).upper == "GROUPING" \
                    and self.peek(1).upper == "SETS":
                raise _not_ported("grouping sets (ROLLUP, CUBE, GROUPING "
                                  "SETS)")
            gresolver = self._group_resolver(resolver, select_exprs)
            while True:
                group_exprs.append(E.strip_alias(self._expr(gresolver)))
                if not self.accept(","):
                    break
        having = None
        if self.accept("HAVING"):
            having = self._expr(resolver)

        if group_exprs or having is not None \
                or any(E.contains_aggregate(e) for e in select_exprs):
            outputs = list(select_exprs)
            having_cond = None
            if having is not None:
                hidden, having_cond = self._pull_having_aggs(having)
                outputs += hidden
            plan = L.Aggregate(tuple(group_exprs), tuple(outputs), plan)
            if having_cond is not None:
                plan = L.Project(tuple(E.Col(e.name) for e in select_exprs),
                                 L.Filter(having_cond, plan))
        else:
            plan = L.Project(tuple(select_exprs), plan)
        if distinct:
            plan = L.Distinct(plan)
        return plan

    @staticmethod
    def _pull_having_aggs(having: E.Expression):
        """Pull aggregate calls out of a HAVING predicate as hidden
        outputs ``__h{i}``, so the predicate becomes an ordinary Filter
        above the Aggregate (where the subquery rewrite reaches it); the
        hidden columns are projected away after it."""
        hidden: List[E.Alias] = []
        seen: Dict[tuple, str] = {}

        def pull(e: E.Expression) -> E.Expression:
            if isinstance(e, E.AggregateExpression):
                sk = E.expr_key(e)
                if sk not in seen:
                    seen[sk] = f"__h{len(hidden)}"
                    hidden.append(E.Alias(e, seen[sk]))
                return E.Col(seen[sk])
            return e

        return hidden, E.transform_expr(having, pull)

    def _group_resolver(self, resolver: Resolver,
                        select_exprs: List[E.Expression]) -> Resolver:
        """GROUP BY may name a select alias (GROUP BY revenue)."""
        by_alias = {e.name: E.strip_alias(e) for e in select_exprs
                    if isinstance(e, E.Alias)}

        def resolve(qual, name):
            try:
                return resolver(qual, name)
            except SQLParseError:
                if qual is None and name in by_alias:
                    return by_alias[name]
                raise

        return resolve

    def _parse_select_list(self, end: int, scope: Scope,
                           resolver: Resolver) -> List[E.Expression]:
        exprs: List[E.Expression] = []
        while self.pos < end:
            t = self.peek()
            if t.kind == "op" and t.value == "*":
                self.next()
                exprs.extend(E.Col(n) for n in scope.all_output_names())
            elif t.kind in ("id", "qid") and self.peek(1).value == "." \
                    and self.peek(2).value == "*":
                rel_outs = scope.relation_outputs(t.value)
                if rel_outs is None:
                    raise SQLParseError(f"unknown relation {t.value!r}")
                self.next()
                self.next()
                self.next()
                exprs.extend(E.Col(n) for n in rel_outs)
            else:
                e = self._expr(resolver)
                if self.pos < end and self.accept("AS"):
                    e = E.Alias(e, self.next().value)
                elif self.pos < end and self.peek().kind in ("id", "qid") \
                        and self.peek().upper not in _RESERVED_STOP:
                    e = E.Alias(e, self.next().value)
                exprs.append(e)
            if self.pos < end:
                if not self.accept(","):
                    raise SQLParseError(
                        f"expected ',' in select list at "
                        f"{self.peek().pos}: {self.peek().value!r}")
        return exprs


# ---- public entry point -------------------------------------------------------


def parse_sql(query: str, catalog) -> L.LogicalPlan:
    """Parse one SELECT statement against ``catalog``'s temp views, with
    every subquery rewritten into joins (``plan/subquery.py``)."""
    p = _StmtParser(tokenize(query), catalog)
    plan = p.parse_query()
    t = p.peek()
    if not (t.kind == "eof" or (t.kind == "op" and t.value == ";")):
        raise SQLParseError(f"trailing input at {t.pos}: {t.value!r}")
    return rewrite_subqueries(plan)
