"""SQL parser: text -> logical plans, trimmed to the single-table
aggregate slice.

Hand-written tokenizer, recursive-descent expression parser and
statement builder for SELECT [DISTINCT] ... FROM <table> [WHERE]
[GROUP BY] [ORDER BY] [LIMIT [OFFSET]] with comparisons, BETWEEN,
IS [NOT] NULL, arithmetic, CAST, date and day-interval literals and the
count/sum/avg/min/max aggregates. Joins, subqueries, set operations,
HAVING and DISTINCT aggregates raise ``NotImplementedError``; other
constructs are parse errors. The reference parses with an ANTLR grammar
(reference: sql/catalyst/src/main/antlr4/.../SqlBaseParser.g4:1 +
parser/AstBuilder.scala); name resolution happens during parsing
against the FROM relation, folding the Analyzer's resolution tier
(reference: analysis/Analyzer.scala:188) into plan construction.
"""

from __future__ import annotations

import datetime
import re
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

from spark_tpu_torch import types as T
from spark_tpu_torch.expr import expressions as E
from spark_tpu_torch.plan import logical as L
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
    "FROM", "WHERE", "GROUP", "HAVING", "ORDER", "LIMIT", "OFFSET", "JOIN",
    "INNER", "LEFT", "RIGHT", "FULL", "CROSS", "UNION", "INTERSECT",
    "EXCEPT", "AS", "AND", "OR", "NOT", "BY", "ASC", "DESC", "NULLS",
}

_JOIN_WORDS = {"JOIN", "INNER", "LEFT", "RIGHT", "FULL", "CROSS"}


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} are not ported yet (ROADMAP queue A)")


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
    def __init__(self, cur: _Tokens, resolver: Resolver):
        self.resolve = resolver
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
            return E.Not(self.parse_not())
        return self.parse_predicate()

    def parse_predicate(self) -> E.Expression:
        if self.at_keyword("EXISTS"):
            raise _not_ported("subqueries")
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
        if self.at_keyword("IN", "LIKE"):
            raise _not_ported(f"{self.peek().upper} predicates")
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
        """Fold a day-interval literal into date arithmetic."""
        if isinstance(right, _Interval):
            return E.Arith(op, left, E.Literal(right.days))
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
                raise _not_ported("subqueries")
            e = self.parse()
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
        if unit == "DAY":
            return _Interval(days=qty)
        if unit == "WEEK":
            return _Interval(days=7 * qty)
        raise SQLParseError(f"unsupported interval unit {unit!r}")

    _AGG_FNS = {"SUM": E.Sum, "AVG": E.Avg, "MIN": E.Min, "MAX": E.Max,
                "COUNT": E.Count}

    def _parse_function(self, name_tok: Token) -> E.Expression:
        name = name_tok.upper
        if name not in self._AGG_FNS:
            raise SQLParseError(f"unknown function {name_tok.value!r} "
                                f"at {name_tok.pos}")
        self.expect("(")
        if name == "COUNT" and self.accept("*"):
            self.expect(")")
            return E.Count(None)
        if self.accept("DISTINCT"):
            raise _not_ported("DISTINCT aggregates")
        e = self.parse()
        self.expect(")")
        return self._AGG_FNS[name](e)


@dataclass(eq=False, frozen=True)
class _Interval(E.Expression):
    days: int = 0


def _unquote(s: str) -> str:
    return s[1:-1].replace("''", "'")


# ---- statement parser -------------------------------------------------------


class _StmtParser(_Tokens):
    """Parses one SELECT statement; ``catalog`` resolves table names."""

    def __init__(self, tokens: List[Token], catalog):
        super().__init__(tokens)
        self.catalog = catalog

    def _expr(self, resolver: Resolver) -> E.Expression:
        return _ExprParser(self, resolver).parse()

    # -- FROM clause ----------------------------------------------------------

    def _parse_from(self) -> Tuple[L.LogicalPlan, Resolver]:
        """FROM <table> [[AS] alias]; returns the plan and its resolver."""
        if self.accept("("):
            raise _not_ported("subqueries")
        t = self.next()
        if t.kind not in ("id", "qid"):
            raise SQLParseError(f"expected table name at {t.pos}")
        plan = self.catalog.lookup(t.value)
        alias = self._parse_alias() or t.value
        if self.accept(",") or self.peek().upper in _JOIN_WORDS:
            raise _not_ported("joins")
        names = {n.lower(): n for n in plan.schema.names}

        def resolve(qual: Optional[str], name: str) -> E.Expression:
            if (qual is None or qual.lower() == alias.lower()) \
                    and name.lower() in names:
                return E.Col(names[name.lower()])
            raise SQLParseError(
                f"cannot resolve column {qual + '.' if qual else ''}{name}")

        return plan, resolve

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
        plan, resolver = self._parse_from()

        if self.accept("WHERE"):
            plan = L.Filter(self._expr(resolver), plan)

        # parse the saved select list now
        saved = self.pos
        self.pos = select_start
        select_exprs = self._parse_select_list(select_end, plan, resolver)
        self.pos = saved

        group_exprs: List[E.Expression] = []
        if self.at_keyword("GROUP"):
            self.next()
            self.expect("BY")
            gresolver = self._group_resolver(resolver, select_exprs)
            while True:
                group_exprs.append(E.strip_alias(self._expr(gresolver)))
                if not self.accept(","):
                    break
        if self.at_keyword("HAVING"):
            raise _not_ported("HAVING clauses")

        if group_exprs or any(E.contains_aggregate(e) for e in select_exprs):
            plan = L.Aggregate(tuple(group_exprs), tuple(select_exprs), plan)
        else:
            plan = L.Project(tuple(select_exprs), plan)
        if distinct:
            plan = L.Distinct(plan)
        return plan

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

    def _parse_select_list(self, end: int, plan: L.LogicalPlan,
                           resolver: Resolver) -> List[E.Expression]:
        exprs: List[E.Expression] = []
        while self.pos < end:
            t = self.peek()
            if t.kind == "op" and t.value == "*":
                self.next()
                exprs.extend(E.Col(n) for n in plan.schema.names)
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
    """Parse one SELECT statement against ``catalog``'s temp views."""
    p = _StmtParser(tokenize(query), catalog)
    plan = p.parse_query()
    t = p.peek()
    if not (t.kind == "eof" or (t.kind == "op" and t.value == ";")):
        raise SQLParseError(f"trailing input at {t.pos}: {t.value!r}")
    return plan
