"""SQL parser: text -> logical plans, trimmed to the single-device
aggregate, join, subquery, window and scalar-function slices.

Hand-written tokenizer, recursive-descent expression parser and
statement parser for SELECT [DISTINCT] ... [FROM <relations>] [WHERE]
[GROUP BY [ROLLUP | CUBE | GROUPING SETS]] [HAVING] joined by UNION
[ALL], INTERSECT and EXCEPT, then [ORDER BY] [LIMIT [OFFSET]], with
comparisons, BETWEEN, [NOT] IN (list | subquery), [NOT] LIKE, [NOT]
EXISTS, scalar subqueries, IS [NOT] NULL, arithmetic, ``||``, CASE,
CAST, extract, the scalar functions (string, math, date and timestamp;
``sql/functions.py`` builds those without a node of their own), date
and timestamp literals, day/week/month/year intervals, the
count/sum/avg/min/max aggregates (count/sum/avg also DISTINCT),
stddev/variance, percentile/percentile_approx/median,
collect_list/collect_set, grouping()/grouping_id(), and window
functions (row_number, rank, dense_rank, ntile, lag, lead and the
aggregates) OVER (PARTITION BY ... ORDER BY ... ROWS|RANGE frame); the
array and map functions, ``x[i]`` subscripts, explode/posexplode in the
select list and the higher-order functions with their lambdas ``x ->
...`` and ``(acc, x) -> ...``. The FROM clause takes tables and derived
tables ``( SELECT ... ) [AS] alias`` with aliases, comma joins, ``LATERAL
VIEW [POS]EXPLODE(...) [alias] AS col[, col]`` and ``[INNER|CROSS|LEFT
[OUTER]|RIGHT [OUTER]|FULL [OUTER]|LEFT SEMI|LEFT ANTI] JOIN ...
ON/USING``; a SELECT without FROM reads one row. A bare map column name
resolves to its ``#keys`` half (``E.MapHandle``), and a selected map
keeps both halves. A subquery resolves names it cannot find in its own
FROM clause against the enclosing query's (``OuterRef``); ``parse_sql``
hands the plan to ``plan/subquery.py``, which rewrites every subquery
into joins. ``CREATE [OR REPLACE] [TEMP] VIEW ... AS`` and ``DROP
VIEW`` change the catalog; anything else unknown is a parse error. The reference parses with an
ANTLR grammar (reference:
sql/catalyst/src/main/antlr4/.../SqlBaseParser.g4:1 +
parser/AstBuilder.scala); name resolution happens during parsing
against the FROM clause's scope, folding the Analyzer's resolution tier
(reference: analysis/Analyzer.scala:188) into plan construction.
"""

from __future__ import annotations

import datetime
import decimal
import re
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from spark_tpu_torch import types as T
from spark_tpu_torch.expr import expressions as E
from spark_tpu_torch.plan import logical as L
from spark_tpu_torch.plan.grouping import (contains_grouping_fns, cube_sets,
                                           grouping_sets_aggregate,
                                           rewrite_grouping_fns, rollup_sets)
from spark_tpu_torch.plan.optimizer import combine_conjuncts, split_conjuncts
from spark_tpu_torch.plan.subquery import rewrite_subqueries
from spark_tpu_torch.sql import functions as F
from spark_tpu_torch.sql.ddl import parse_type

# ---- tokenizer --------------------------------------------------------------

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+|--[^\n]*|/\*.*?\*/)
  | (?P<num>\d+\.\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?|\d+(?:[eE][+-]?\d+)?)
  | (?P<str>'(?:[^']|'')*')
  | (?P<qid>"[^"]*"|`[^`]*`)
  | (?P<op><>|!=|>=|<=|\|\||->|[=<>+\-*/%(),.;\[\]])
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
        if not hits and not name_l.endswith(T.MAP_KEYS_SUFFIX):
            # a map column decomposes into '<m>#keys'/'<m>#vals'
            # (types.MapType); its bare name resolves to the keys half
            return self.resolve(qualifier, T.map_keys_col(name))
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
        if self.at_keyword("EXISTS") \
                and self.peek(2).upper in ("SELECT", "WITH"):
            # (else exists(array, x -> pred), the higher-order function)
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
            elif t.kind == "op" and t.value == "||":
                self.next()
                left = E.Concat((left, self.parse_multiplicative()))
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
        e = self._parse_primary_base()
        while self.peek().kind == "op" and self.peek().value == "[":
            # x[i]: a 0-based array item or a map key lookup (reference:
            # GetArrayItem / GetMapValue)
            self.next()
            key = self.parse()
            self.expect("]")
            e = E.ElementAt(e, key, sql_subscript=True)
        return e

    def _parse_primary_base(self) -> E.Expression:
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
        if u == "TIMESTAMP" and self.peek().kind == "str":
            # a naive datetime, read in the host's local timezone when it
            # is evaluated, as the reference does (ROADMAP Notes)
            s = _unquote(self.next().value)
            return E.Literal(datetime.datetime.fromisoformat(s))
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
    #: functions that exist only over a window
    _WINDOW_ONLY = (E.RowNumber, E.Rank, E.NTile, E.LagLead)

    def _parse_function(self, name_tok: Token) -> E.Expression:
        self.expect("(")
        e = self._parse_function_args(name_tok.upper, name_tok)
        if self.at_keyword("OVER"):
            self.next()
            return self._parse_window_spec(e)
        if isinstance(e, self._WINDOW_ONLY):
            raise SQLParseError(f"{name_tok.value} requires an OVER clause "
                                f"at {name_tok.pos}")
        return e

    def _parse_window_spec(self, func: E.Expression) -> E.WindowExpr:
        """OVER ( [PARTITION BY ...] [ORDER BY ...] [ROWS|RANGE [BETWEEN]
        bound [AND bound]] ) (reference grammar: SqlBaseParser.g4
        windowSpec)."""
        self.expect("(")
        partition: List[E.Expression] = []
        orders: List[E.SortOrder] = []
        frame = None
        if self.at_keyword("PARTITION"):
            self.next()
            self.expect("BY")
            partition.append(self.parse())
            while self.accept(","):
                partition.append(self.parse())
        if self.at_keyword("ORDER"):
            self.next()
            self.expect("BY")
            while True:
                e = self.parse()
                asc = not self.accept("DESC")
                if asc:
                    self.accept("ASC")
                nulls_first = None
                if self.accept("NULLS"):
                    nulls_first = self.next().upper == "FIRST"
                orders.append(E.SortOrder(e, asc, nulls_first))
                if not self.accept(","):
                    break
        if self.at_keyword("ROWS", "RANGE"):
            mode = self.next().upper.lower()
            if self.accept("BETWEEN"):
                start = self._frame_bound()
                self.expect("AND")
                end = self._frame_bound()
            else:
                start, end = self._frame_bound(), 0
            frame = (mode, start, end)
        self.expect(")")
        return E.WindowExpr(func, tuple(partition), tuple(orders), frame)

    def _frame_bound(self) -> Optional[int]:
        """UNBOUNDED PRECEDING|FOLLOWING (None), CURRENT ROW (0) or n
        PRECEDING|FOLLOWING (-n / n)."""
        if self.accept("UNBOUNDED"):
            n = None
        elif self.accept("CURRENT"):
            self.expect("ROW")
            return 0
        else:
            n = self._int_literal()
        side = self.next()
        if side.upper not in ("PRECEDING", "FOLLOWING"):
            raise SQLParseError(f"expected PRECEDING or FOLLOWING at "
                                f"{side.pos}: {side.value!r}")
        if n is None:
            return None
        return -n if side.upper == "PRECEDING" else n

    def _parse_function_args(self, name: str,
                             name_tok: Token) -> E.Expression:
        if name in ("ROW_NUMBER", "RANK", "DENSE_RANK"):
            self.expect(")")
            if name == "ROW_NUMBER":
                return E.RowNumber()
            return E.Rank(dense=(name == "DENSE_RANK"))
        if name == "NTILE":
            n = self._int_literal()
            self.expect(")")
            return E.NTile(n)
        if name in ("LAG", "LEAD"):
            e = self.parse()
            offset, default = 1, None
            if self.accept(","):
                offset = self._int_literal()
                if self.accept(","):
                    default = self.parse()
            self.expect(")")
            return E.LagLead(e, offset, default, lead=(name == "LEAD"))
        if name == "GROUPING":
            e = self.parse()
            self.expect(")")
            return E.Grouping(e)
        if name == "GROUPING_ID":
            self.expect(")")
            return E.GroupingId()
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
        if name in ("STDDEV", "STDDEV_SAMP", "STDDEV_POP", "VARIANCE",
                    "VAR_SAMP", "VAR_POP"):
            e = self.parse()
            self.expect(")")
            kind = {"STDDEV": "stddev_samp", "VARIANCE": "var_samp"}.get(
                name, name.lower())
            return E.StddevVariance(kind, e)
        if name in ("PERCENTILE", "PERCENTILE_APPROX", "APPROX_PERCENTILE",
                    "MEDIAN"):
            return self._parse_percentile(name)
        if name == "APPROX_COUNT_DISTINCT":
            e = self.parse()
            if self.accept(","):
                self.parse()  # rsd accepted, unused (the count is exact)
            self.expect(")")
            return E.Count(e, distinct=True)
        if name == "ABS":
            e = self.parse()
            self.expect(")")
            return E.Abs(e)
        if name in ("FLOOR", "CEIL", "CEILING", "SQRT", "EXP", "LN", "LOG10",
                    "SIGN"):
            e = self.parse()
            self.expect(")")
            return E.UnaryMath({"CEILING": "ceil"}.get(name, name.lower()), e)
        if name == "ROUND":
            e = self.parse()
            scale = self._int_literal() if self.accept(",") else 0
            self.expect(")")
            return E.Round(e, scale)
        if name in ("POWER", "POW"):
            a = self.parse()
            self.expect(",")
            b = self.parse()
            self.expect(")")
            return E.Pow(a, b)
        if name in ("UPPER", "LOWER", "TRIM", "LTRIM", "RTRIM"):
            e = self.parse()
            self.expect(")")
            return E.StringTransform(name.lower(), e)
        if name in ("LENGTH", "LEN", "CHAR_LENGTH"):
            e = self.parse()
            self.expect(")")
            return E.StrLength(e)
        if name in ("REGEXP_EXTRACT", "REGEXP_REPLACE", "REGEXP_LIKE",
                    "REPLACE", "TRANSLATE"):
            return self._parse_regexp(name)
        if name == "DATE_TRUNC":
            unit = self._str_literal().lower()
            self.expect(",")
            e = self.parse()
            self.expect(")")
            return E.DateTrunc(unit, e)
        if name == "LAST_DAY":
            e = self.parse()
            self.expect(")")
            return E.LastDay(e)
        if name in ("DATE_ADD", "DATE_SUB", "ADD_MONTHS"):
            e = self.parse()
            self.expect(",")
            n = self._int_literal()
            self.expect(")")
            if name == "ADD_MONTHS":
                return E.AddMonths(e, n)
            return E.Arith("+" if name == "DATE_ADD" else "-", e,
                           E.Literal(n))
        if name in ("LPAD", "RPAD", "REPEAT"):
            e = self.parse()
            self.expect(",")
            width = self._int_literal()
            if name == "REPEAT":
                self.expect(")")
                return E.StringTransform("repeat", e, (width,))
            pad = self._str_literal() if self.accept(",") else " "
            self.expect(")")
            return E.StringTransform(name.lower(), e, (width, pad))
        if name in ("CONCAT", "NULLIF"):
            args = [self.parse()]
            while self.accept(","):
                args.append(self.parse())
            self.expect(")")
            if name == "CONCAT":
                return E.Concat(tuple(args))
            if len(args) != 2:
                raise SQLParseError("nullif takes two arguments")
            return F.nullif(*args)
        if name == "CONCAT_WS":
            sep = self._str_literal()
            args = []
            while self.accept(","):
                args.append(self.parse())
            self.expect(")")
            return F.concat_ws(sep, *args)
        if name == "SPLIT":
            e = self.parse()
            self.expect(",")
            delim = self._str_literal()
            self.expect(")")
            return E.Split(e, delim)
        if name in ("TRANSFORM", "FILTER", "EXISTS", "FORALL"):
            arr = self.parse()
            self.expect(",")
            lam = self._parse_lambda()
            self.expect(")")
            return E.HigherOrder(name.lower(), arr, lam)
        if name in ("AGGREGATE", "REDUCE"):
            arr = self.parse()
            self.expect(",")
            zero = self.parse()
            self.expect(",")
            merge = self._parse_lambda()
            finish = self._parse_lambda() if self.accept(",") else None
            self.expect(")")
            return E.HigherOrder("aggregate", arr, merge, zero, finish)
        if name in ("COLLECT_LIST", "COLLECT_SET", "ARRAY_AGG"):
            e = self.parse()
            self.expect(")")
            return E.Collect(e, unique=(name == "COLLECT_SET"))
        if name in F.COMPOSED_FUNCTIONS:
            args = []
            if not self.accept(")"):
                args.append(self.parse())
                while self.accept(","):
                    args.append(self.parse())
                self.expect(")")
            return F.COMPOSED_FUNCTIONS[name](*args)
        # session-injected functions (reference:
        # SparkSessionExtensions.injectFunction:344)
        builder = _extension_function(name)
        if builder is not None:
            args = []
            if not self.accept(")"):
                args.append(self.parse())
                while self.accept(","):
                    args.append(self.parse())
                self.expect(")")
            return builder(*args)
        raise SQLParseError(f"unknown function {name_tok.value!r} "
                            f"at {name_tok.pos}")

    def _parse_lambda(self) -> E.Lambda:
        """``x -> body`` or ``(x, i) -> body`` (reference: LambdaFunction).
        The parameters shadow outer columns inside the body."""
        params = []
        if self.accept("("):
            params.append(self.next().value)
            while self.accept(","):
                params.append(self.next().value)
            self.expect(")")
        else:
            params.append(self.next().value)
        self.expect("->")
        by_lower = {p.lower(): p for p in params}
        outer = self.resolve

        def resolve(qual, name):
            if qual is None and name.lower() in by_lower:
                return E.Col(by_lower[name.lower()])
            return outer(qual, name)

        self.resolve = resolve
        try:
            body = self.parse()
        finally:
            self.resolve = outer
        return E.Lambda(tuple(params), body)

    def _parse_percentile(self, name: str) -> E.Expression:
        """percentile(x, q) and median(x) interpolate between ranks;
        percentile_approx / approx_percentile(x, q [, accuracy]) pick an
        element. All are exact (the accuracy is accepted, unused)."""
        e = self.parse()
        if name == "MEDIAN":
            self.expect(")")
            return E.Percentile(e, 0.5, "median")
        self.expect(",")
        q = self.parse()
        if not isinstance(q, E.Literal):
            raise SQLParseError("percentile fraction must be a literal")
        if self.accept(","):
            self.parse()
        self.expect(")")
        return E.Percentile(e, float(q.value), "percentile"
                            if name == "PERCENTILE" else "percentile_approx")

    def _parse_regexp(self, name: str) -> E.Expression:
        """regexp_extract(s, pattern [, group]), regexp_replace(s, pattern,
        rep), regexp_like(s, pattern), replace(s, find, rep) (a literal
        replace: the needle's pattern syntax and the replacement's
        backslashes are escaped) and translate(s, from, to)."""
        e = self.parse()
        self.expect(",")
        pat = self._str_literal()
        if name == "REGEXP_LIKE":
            self.expect(")")
            return E.RegexpLike(e, pat)
        if name == "REGEXP_EXTRACT":
            group = self._int_literal() if self.accept(",") else 1
            self.expect(")")
            return E.RegexpExtract(e, pat, group)
        self.expect(",")
        rep = self._str_literal()
        self.expect(")")
        if name == "TRANSLATE":
            return E.StringTransform("translate", e, (pat, rep))
        if name == "REPLACE":
            return E.RegexpReplace(e, re.escape(pat),
                                   rep.replace("\\", "\\\\"))
        return E.RegexpReplace(e, pat, rep)

    def _str_literal(self) -> str:
        e = self.parse_primary()
        if isinstance(e, E.Literal) and isinstance(e.value, str):
            return e.value
        raise SQLParseError("expected string literal")

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
                if out.lower() == T.map_keys_col(name).lower():
                    # a bare map name: the select list keeps its pair
                    return E.MapHandle(out)
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
                plan = self._parse_lateral_view(plan, scope)
                continue
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

    def _parse_lateral_view(self, plan: L.LogicalPlan,
                            scope: Scope) -> L.LogicalPlan:
        """``LATERAL VIEW [POS]EXPLODE(expr) [view] AS col[, col]``
        (reference: ``spark_tpu/sql/parser.py:1000``): a ``Generate``
        over the FROM clause so far. The view alias is accepted and not
        used (columns resolve unqualified); posexplode's names are (pos,
        col)."""
        self.next()
        self.next()
        fn = self.next().upper
        if fn not in ("EXPLODE", "POSEXPLODE"):
            raise SQLParseError(
                f"LATERAL VIEW supports explode/posexplode, got {fn}")
        self.expect("(")
        arr = self._expr(self._make_resolver(scope))
        self.expect(")")
        if self.peek().kind in ("id", "qid") and self.peek().upper != "AS":
            self.next()  # the view alias
        names = []
        if self.accept("AS"):
            names.append(self.next().value)
            while self.accept(","):
                names.append(self.next().value)
        if fn == "POSEXPLODE":
            pos_name = names[0] if len(names) > 1 else "pos"
            out_name = names[-1] if names else "col"
        else:
            pos_name, out_name = None, names[0] if names else "col"
        gen = E.Explode(arr, with_position=fn == "POSEXPLODE")
        scope.add_relation(None, ([pos_name] if pos_name else [])
                           + [out_name])
        return L.Generate(gen, out_name, pos_name, plan)

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
        """query := select_core ((UNION [ALL] | INTERSECT | EXCEPT)
        select_core)* [ORDER BY ...] [LIMIT n [OFFSET m]]. INTERSECT and
        EXCEPT are semi and anti joins on every column with null-safe
        keys, then DISTINCT (reference: ReplaceIntersectWithSemiJoin,
        ReplaceExceptWithAntiJoin)."""
        plan = self.parse_select_core()
        while True:
            if self.accept("UNION"):
                all_ = bool(self.accept("ALL"))
                plan = L.Union(plan, self.parse_select_core())
                if not all_:
                    plan = L.Distinct(plan)
            elif self.at_keyword("INTERSECT", "EXCEPT"):
                how = ("left_semi" if self.next().upper == "INTERSECT"
                       else "left_anti")
                rhs = self.parse_select_core()
                plan = L.Distinct(L.Join(plan, rhs, how,
                                         _null_safe_setop_keys(plan),
                                         _null_safe_setop_keys(rhs)))
            else:
                break
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

        if self.accept("FROM"):
            plan, scope = self._parse_from()
        else:
            # SELECT without FROM: a one-row relation
            plan, scope = L.Range(0, 1, 1, "__one"), Scope(self.outer)
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
        gsets = None  # (keys, index sets) of ROLLUP/CUBE/GROUPING SETS
        if self.at_keyword("GROUP"):
            self.next()
            self.expect("BY")
            gresolver = self._group_resolver(resolver, select_exprs)
            if self.peek(0).upper in ("ROLLUP", "CUBE") \
                    and self.peek(1).value == "(":
                head = self.next().upper
                keys = self._parse_key_list(gresolver)
                gsets = (keys, rollup_sets(len(keys)) if head == "ROLLUP"
                         else cube_sets(len(keys)))
            elif self.peek(0).upper == "GROUPING" \
                    and self.peek(1).upper == "SETS":
                gsets = self._parse_grouping_sets(gresolver)
            else:
                while True:
                    group_exprs.append(E.strip_alias(self._expr(gresolver)))
                    if not self.accept(","):
                        break
        having = None
        if self.accept("HAVING"):
            having = self._expr(resolver)

        has_agg = any(E.contains_aggregate(e) for e in select_exprs)
        if any(E.contains_window(e) for e in select_exprs) and (
                group_exprs or gsets or has_agg or having is not None):
            raise NotImplementedError(
                "window functions combined with GROUP BY/HAVING in the "
                "same SELECT are not supported yet")
        if gsets is not None or group_exprs or has_agg \
                or having is not None:
            outputs = list(select_exprs)
            having_cond = None
            if having is not None:
                hidden, having_cond = self._pull_having_aggs(having)
                outputs += hidden
            if gsets is None:
                plan = L.Aggregate(tuple(group_exprs), tuple(outputs), plan)
            else:
                keys, sets = gsets
                if having_cond is not None \
                        and contains_grouping_fns(having_cond):
                    # HAVING reads the grouping id through a hidden
                    # output; its key references resolve against the
                    # aggregate's output names
                    outputs.append(E.Alias(E.GroupingId(), "__gidh"))
                    having_cond = rewrite_grouping_fns(having_cond, keys,
                                                       "__gidh")
                plan = grouping_sets_aggregate(plan, keys, sets,
                                               tuple(outputs))
            if having_cond is not None:
                plan = L.Project(tuple(E.Col(e.name) for e in select_exprs),
                                 L.Filter(having_cond, plan))
        else:
            plan = L.project_with_windows(tuple(select_exprs), plan)
        if distinct:
            plan = L.Distinct(plan)
        return plan

    def _parse_key_list(self, resolver: Resolver) -> List[E.Expression]:
        """( key, ... ) or ( ) of a grouping set."""
        keys: List[E.Expression] = []
        self.expect("(")
        if not self.accept(")"):
            while True:
                keys.append(E.strip_alias(self._expr(resolver)))
                if self.accept(")"):
                    break
                self.expect(",")
        return keys

    def _parse_grouping_sets(self, resolver: Resolver):
        """GROUPING SETS ( set, ... ), a set being ( keys ) or a bare key:
        the keys' ordered union, and each set as indexes into it."""
        self.next()
        self.next()
        self.expect("(")
        raw_sets = []
        while True:
            if self.peek().value == "(":
                raw_sets.append(tuple(self._parse_key_list(resolver)))
            else:
                raw_sets.append((E.strip_alias(self._expr(resolver)),))
            if self.accept(")"):
                break
            self.expect(",")
        keys: List[E.Expression] = []
        index: Dict[tuple, int] = {}
        for s in raw_sets:
            for e in s:
                sk = E.expr_key(e)
                if sk not in index:
                    index[sk] = len(keys)
                    keys.append(e)
        sets = [tuple(index[E.expr_key(e)] for e in s) for s in raw_sets]
        return keys, sets

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
        return _with_map_pairs(exprs)


def _with_map_pairs(exprs: List[E.Expression]) -> List[E.Expression]:
    """A selected map handle ('m' resolved to ``MapHandle('m#keys')``)
    brings its '#vals' sibling, under the item's alias, so the pair
    survives the projection (types.MapType)."""
    out: List[E.Expression] = []
    seen = {e.name for e in exprs}
    for e in exprs:
        out.append(e)
        inner = E.strip_alias(e)
        if not (isinstance(inner, E.MapHandle)
                and inner.col_name.endswith(T.MAP_KEYS_SUFFIX)):
            continue
        vals = T.map_vals_col(T.map_base_name(inner.col_name))
        pair: E.Expression = E.Col(vals)
        if isinstance(e, E.Alias):
            base = T.map_base_name(e.alias_name) or e.alias_name
            out[-1] = E.Alias(inner, T.map_keys_col(base))
            pair = E.Alias(pair, T.map_vals_col(base))
        if pair.name not in seen:
            out.append(pair)
            seen.add(pair.name)
    return out


def _null_safe_setop_keys(plan: L.LogicalPlan) -> tuple:
    """INTERSECT/EXCEPT compare rows with NULL-safe equality (SQL set
    semantics: NULL equals NULL; the reference plans these as null-aware
    joins, ReplaceIntersectWithSemiJoin + EqualNullSafe). Each nullable
    column becomes two join keys: a typed coalesce-to-zero payload and
    an is-null flag."""
    keys = []
    for f in plan.schema.fields:
        c = E.Col(f.name)
        if not f.nullable:
            keys.append(c)
            continue
        dt = f.dtype
        zero: object = 0
        if isinstance(dt, T.StringType):
            zero = ""
        elif isinstance(dt, T.DateType):
            zero = datetime.date(1970, 1, 1)
        elif isinstance(dt, (T.Float32Type, T.Float64Type)):
            zero = 0.0
        elif isinstance(dt, T.DecimalType):
            zero = decimal.Decimal(0)
        elif isinstance(dt, T.BooleanType):
            zero = False
        keys.append(E.Coalesce((c, E.Literal(zero))))
        keys.append(E.IsNull(c))
    return tuple(keys)


# ---- public entry point -------------------------------------------------------


def _extension_function(name: str):
    """The builder of a function injected into the session whose SQL is
    parsed (or, outside one, the active session), or None."""
    from spark_tpu_torch import metrics

    sess = metrics._session()
    ext = getattr(sess, "extensions", None)
    return None if ext is None else ext.function(name)


def parse_sql(query: str, catalog) -> L.LogicalPlan:
    """Parse one statement against ``catalog``'s temp views: a SELECT
    query, with every subquery rewritten into joins
    (``plan/subquery.py``), or ``CREATE [OR REPLACE] [TEMP|TEMPORARY]
    VIEW name AS <query>`` / ``DROP VIEW [IF EXISTS] name``, which change
    the catalog at once and return an empty plan, as the reference's."""
    p = _StmtParser(tokenize(query), catalog)
    if p.at_keyword("CREATE"):
        p.next()
        p.accept("OR")
        p.accept("REPLACE")
        p.accept("TEMP")
        p.accept("TEMPORARY")
        p.expect("VIEW")
        name = p.next().value
        p.expect("AS")
        catalog._register_view(name, p.parse_query())
        return L.Range(0, 0, 1, "__ok")  # DDL: empty result
    if p.at_keyword("DROP"):
        p.next()
        p.expect("VIEW")
        if p.accept("IF"):
            p.expect("EXISTS")
        name = p.next().value
        catalog.dropTempView(name)
        return L.Range(0, 0, 1, "__ok")
    plan = p.parse_query()
    t = p.peek()
    if not (t.kind == "eof" or (t.kind == "op" and t.value == ";")):
        raise SQLParseError(f"trailing input at {t.pos}: {t.value!r}")
    return rewrite_subqueries(plan)


def _schema_resolver(schema) -> Resolver:
    """Names as written, or the schema's spelling of a name that matches
    one of its columns but for case."""
    def resolve(qual: Optional[str], name: str) -> E.Expression:
        if schema is not None and name not in schema:
            for n in schema.names:
                if n.lower() == name.lower():
                    return E.Col(n)
        return E.Col(name)

    return resolve


def _parse_standalone(text: str, schema, alias: bool) -> E.Expression:
    cur = _Tokens(tokenize(text))
    e = _ExprParser(cur, _schema_resolver(schema)).parse()
    t = cur.peek()
    if alias and t.kind == "id" and t.upper == "AS":
        cur.next()
        e = E.Alias(e, cur.next().value)
    elif alias and t.kind in ("id", "qid") and t.upper not in _RESERVED_STOP:
        e = E.Alias(e, cur.next().value)
    t = cur.peek()
    if t.kind != "eof":
        raise SQLParseError(f"trailing input at {t.pos}: {t.value!r}")
    return e


def parse_expression(text: str, schema=None) -> E.Expression:
    """Parse one SQL expression (``df.filter("...")``, ``F.expr``)."""
    return _parse_standalone(text, schema, alias=False)


def parse_projection(text: str, schema=None) -> E.Expression:
    """Parse ``expr [AS alias]`` (``df.selectExpr``)."""
    return _parse_standalone(text, schema, alias=True)
