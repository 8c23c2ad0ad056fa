"""Expression tree (IR), trimmed to the nodes the single-device
aggregate, join, subquery, window and scalar-function slices plan:
columns, literals, aliases, arithmetic, month arithmetic on dates,
comparisons, boolean logic, null tests, casts, IN lists, LIKE and the
other dictionary string predicates, substring, concatenation, the string
transforms, length and regular expressions, the math functions (abs,
floor/ceil/sqrt/exp/ln/log10/sign, round, power), date_trunc and
last_day, CASE, COALESCE, typed NULLs (``NullOf``), date parts, sort
orders, the subquery nodes (removed by ``plan/subquery.py`` before
execution), the grouping markers ``grouping()``/``grouping_id()``
(rewritten by ``plan/grouping.py``), the window functions and the
count/sum/avg/min/max/first, stddev/variance and percentile aggregates,
with DISTINCT on count, sum and avg.

The analogue of Catalyst's expression nodes (reference:
sql/catalyst/.../expressions/Expression.scala). Expressions are
evaluated eagerly over torch tensors (expr/compiler.py); nulls are
(values, validity-mask) pairs, not boxed values.

Nodes are immutable; ``data_type(schema)`` resolves the output type
against an input schema (the analyzer's type-resolution role,
reference: analysis/Analyzer.scala:188).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Tuple

from spark_tpu_torch import types as T
from spark_tpu_torch.types import DataType, Schema


class Expression:
    """Base class. Subclasses are frozen dataclasses."""

    def children(self) -> Tuple["Expression", ...]:
        return ()

    def data_type(self, schema: Schema) -> DataType:
        raise NotImplementedError

    def nullable(self, schema: Schema) -> bool:
        return True

    @property
    def name(self) -> str:
        """Output column name when this expression is projected."""
        return str(self)

    def references(self) -> set:
        refs = set()
        for c in self.children():
            refs |= c.references()
        return refs


def _key_part(v):
    """Key for one field value; recurses into nested tuples (e.g.
    Case.branches, a tuple of (cond, value) pairs)."""
    if isinstance(v, Expression):
        return expr_key(v)
    if isinstance(v, tuple):
        return tuple(_key_part(x) for x in v)
    return repr(v)


def expr_key(e: Expression):
    """Structural identity key. Nodes compare by identity (``eq=False``),
    so structural comparison goes through this."""
    if isinstance(e, Literal):
        return ("lit", e.value, repr(e.dtype))
    return (type(e).__name__,) + tuple(_key_part(v)
                                       for v in vars(e).values())


def dedup_pair_names(left_names, right_names) -> list:
    """Joined-pair output names: left keeps its names, duplicates from
    the right gain '#2' suffixes. The one copy that the logical Join
    schema, the physical pair environments and the optimizer's
    condition rewrites all use."""
    seen = set()
    out = []
    for n in list(left_names) + list(right_names):
        name = n
        while name in seen:
            name = name + "#2"
        seen.add(name)
        out.append(name)
    return out


@dataclass(eq=False, frozen=True)
class Literal(Expression):
    value: Any
    dtype: DataType = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.dtype is None:
            object.__setattr__(self, "dtype", T.infer_type(self.value))

    def data_type(self, schema: Schema) -> DataType:
        return self.dtype

    def nullable(self, schema: Schema) -> bool:
        return self.value is None

    @property
    def name(self) -> str:
        return str(self.value)

    def __str__(self):
        return repr(self.value)


@dataclass(eq=False, frozen=True)
class Col(Expression):
    col_name: str

    def data_type(self, schema: Schema) -> DataType:
        return schema.field(self.col_name).dtype

    def nullable(self, schema: Schema) -> bool:
        return schema.field(self.col_name).nullable

    def references(self) -> set:
        return {self.col_name}

    @property
    def name(self) -> str:
        return self.col_name

    def __str__(self):
        return self.col_name


@dataclass(eq=False, frozen=True)
class Alias(Expression):
    child: Expression
    alias_name: str

    def children(self):
        return (self.child,)

    def data_type(self, schema: Schema) -> DataType:
        return self.child.data_type(schema)

    def nullable(self, schema: Schema) -> bool:
        return self.child.nullable(schema)

    @property
    def name(self) -> str:
        return self.alias_name

    def __str__(self):
        return f"{self.child} AS {self.alias_name}"


@dataclass(eq=False, frozen=True)
class Arith(Expression):
    op: str  # + - * / %
    left: Expression
    right: Expression

    def children(self):
        return (self.left, self.right)

    def data_type(self, schema: Schema) -> DataType:
        lt = self.left.data_type(schema)
        rt = self.right.data_type(schema)
        # date +/- days
        if isinstance(lt, T.DateType) and rt.is_integral and self.op in ("+", "-"):
            return T.DATE
        if isinstance(rt, T.DateType) and lt.is_integral and self.op == "+":
            return T.DATE
        if isinstance(lt, T.DateType) and isinstance(rt, T.DateType) and self.op == "-":
            return T.INT32
        if isinstance(lt, T.DecimalType) or isinstance(rt, T.DecimalType):
            dec = self._decimal_result(lt, rt)
            if dec is not None:
                return dec
        out = T.common_type(lt, rt)
        if self.op == "/" and out.is_integral:
            return T.FLOAT64  # SQL: integer / -> double (non-ANSI Spark)
        return out

    def _decimal_result(self, lt, rt):
        """Spark's decimal arithmetic result types (reference:
        DecimalPrecision.scala / decimalExpressions.scala), bounded at
        the engine's 18-digit cap. None -> fall through (decimal op
        float = double)."""
        if isinstance(lt, (T.Float32Type, T.Float64Type)) \
                or isinstance(rt, (T.Float32Type, T.Float64Type)):
            return None
        p1 = lt.precision if isinstance(lt, T.DecimalType) else 19
        s1 = lt.scale if isinstance(lt, T.DecimalType) else 0
        p2 = rt.precision if isinstance(rt, T.DecimalType) else 19
        s2 = rt.scale if isinstance(rt, T.DecimalType) else 0
        if self.op in ("+", "-"):
            s = max(s1, s2)
            return T.bounded_decimal(max(p1 - s1, p2 - s2) + s + 1, s)
        if self.op == "*":
            return T.bounded_decimal(p1 + p2 + 1, s1 + s2)
        if self.op == "/":
            s = max(6, s1 + p2 + 1)
            return T.bounded_decimal(p1 - s1 + s2 + s, s)
        if self.op == "%":
            return T.bounded_decimal(min(p1 - s1, p2 - s2) + max(s1, s2),
                                     max(s1, s2))
        return None

    def __str__(self):
        return f"({self.left} {self.op} {self.right})"


@dataclass(eq=False, frozen=True)
class Neg(Expression):
    child: Expression

    def children(self):
        return (self.child,)

    def data_type(self, schema):
        return self.child.data_type(schema)

    def __str__(self):
        return f"(- {self.child})"


@dataclass(eq=False, frozen=True)
class Cmp(Expression):
    op: str  # == != < <= > >=
    left: Expression
    right: Expression

    def children(self):
        return (self.left, self.right)

    def data_type(self, schema):
        return T.BOOLEAN

    def __str__(self):
        return f"({self.left} {self.op} {self.right})"


@dataclass(eq=False, frozen=True)
class And(Expression):
    left: Expression
    right: Expression

    def children(self):
        return (self.left, self.right)

    def data_type(self, schema):
        return T.BOOLEAN

    def __str__(self):
        return f"({self.left} AND {self.right})"


@dataclass(eq=False, frozen=True)
class Or(Expression):
    left: Expression
    right: Expression

    def children(self):
        return (self.left, self.right)

    def data_type(self, schema):
        return T.BOOLEAN

    def __str__(self):
        return f"({self.left} OR {self.right})"


@dataclass(eq=False, frozen=True)
class Not(Expression):
    child: Expression

    def children(self):
        return (self.child,)

    def data_type(self, schema):
        return T.BOOLEAN

    def __str__(self):
        return f"(NOT {self.child})"


@dataclass(eq=False, frozen=True)
class IsNull(Expression):
    child: Expression

    def children(self):
        return (self.child,)

    def data_type(self, schema):
        return T.BOOLEAN

    def nullable(self, schema):
        return False

    def __str__(self):
        return f"({self.child} IS NULL)"


@dataclass(eq=False, frozen=True)
class Cast(Expression):
    child: Expression
    dtype: DataType

    def children(self):
        return (self.child,)

    def data_type(self, schema):
        return self.dtype

    def __str__(self):
        return f"CAST({self.child} AS {self.dtype})"


@dataclass(eq=False, frozen=True)
class AddMonths(Expression):
    """date + n months, the day clamped to the target month's length
    (``date + interval 'n' month|year``)."""

    child: Expression
    months: int

    def children(self):
        return (self.child,)

    def data_type(self, schema):
        return T.DATE

    def __str__(self):
        return f"ADD_MONTHS({self.child}, {self.months})"


@dataclass(eq=False, frozen=True)
class TupleExpr(Expression):
    """(a, b, ...) row-value constructor, only legal as the probe of a
    multi-column IN (subquery) (reference: In.scala accepts
    CreateStruct probes; the subquery rewrite expands it to a
    multi-key semi join)."""

    items: Tuple[Expression, ...]

    def children(self):
        return self.items

    def data_type(self, schema):
        raise TypeError(
            "a row-value (a, b) is only valid as the probe of a "
            "multi-column IN (subquery)")

    def __str__(self):
        return "(" + ", ".join(str(i) for i in self.items) + ")"


@dataclass(eq=False, frozen=True)
class In(Expression):
    child: Expression
    values: Tuple[Any, ...]  # python literals

    def children(self):
        return (self.child,)

    def data_type(self, schema):
        return T.BOOLEAN

    def __str__(self):
        return f"({self.child} IN {self.values})"


@dataclass(eq=False, frozen=True)
class Like(Expression):
    """SQL LIKE with % and _ wildcards; evaluated host-side over the
    column dictionary, gathered on the device by code."""

    child: Expression
    pattern: str

    def children(self):
        return (self.child,)

    def data_type(self, schema):
        return T.BOOLEAN

    def __str__(self):
        return f"({self.child} LIKE {self.pattern!r})"


@dataclass(eq=False, frozen=True)
class Case(Expression):
    """CASE WHEN c1 THEN v1 [WHEN ...] ELSE e END. With no ELSE,
    unmatched rows are NULL (SQL semantics)."""

    branches: Tuple[Tuple[Expression, Expression], ...]
    else_value: Optional[Expression]

    def children(self):
        out = []
        for c, v in self.branches:
            out += [c, v]
        if self.else_value is not None:
            out.append(self.else_value)
        return tuple(out)

    def data_type(self, schema):
        dt = self.branches[0][1].data_type(schema)
        for _, v in self.branches[1:]:
            dt = T.common_type(dt, v.data_type(schema))
        if self.else_value is not None:
            dt = T.common_type(dt, self.else_value.data_type(schema))
        return dt

    def __str__(self):
        return "CASE ..."


@dataclass(eq=False, frozen=True)
class Coalesce(Expression):
    args: Tuple[Expression, ...]

    def children(self):
        return self.args

    def data_type(self, schema):
        dt = self.args[0].data_type(schema)
        for a in self.args[1:]:
            dt = T.common_type(dt, a.data_type(schema))
        return dt

    def __str__(self):
        return f"COALESCE({', '.join(map(str, self.args))})"


@dataclass(eq=False, frozen=True)
class ExtractDatePart(Expression):
    """EXTRACT(YEAR|MONTH|DAY FROM date_expr)."""

    part: str  # 'year' | 'month' | 'day'
    child: Expression

    def children(self):
        return (self.child,)

    def data_type(self, schema):
        return T.INT32

    def __str__(self):
        return f"EXTRACT({self.part} FROM {self.child})"


@dataclass(eq=False, frozen=True)
class StringPredicate(Expression):
    """startswith / endswith / contains, evaluated over the host
    dictionary."""

    op: str  # 'startswith' | 'endswith' | 'contains'
    child: Expression
    needle: str

    def children(self):
        return (self.child,)

    def data_type(self, schema):
        return T.BOOLEAN

    def __str__(self):
        return f"{self.op}({self.child}, {self.needle!r})"


@dataclass(eq=False, frozen=True)
class Substring(Expression):
    """SUBSTRING(str, pos, len): 1-based, a host dictionary transform."""

    child: Expression
    pos: int
    length: int

    def children(self):
        return (self.child,)

    def data_type(self, schema):
        return T.STRING

    def __str__(self):
        return f"SUBSTRING({self.child}, {self.pos}, {self.length})"


@dataclass(eq=False, frozen=True)
class Concat(Expression):
    """String concatenation (``||`` / concat()), evaluated over host
    dictionaries: the output dictionary is the product of the input
    dictionaries (at most 2^20 entries), codes combine by mixed radix.
    A NULL input makes the row NULL."""

    args: Tuple[Expression, ...]

    def children(self):
        return self.args

    def data_type(self, schema):
        return T.STRING

    def __str__(self):
        return f"CONCAT({', '.join(map(str, self.args))})"


@dataclass(eq=False, frozen=True)
class ConcatWs(Expression):
    """concat_ws(sep, ...): NULL inputs drop out with their separator,
    and the result is never NULL (reference: ConcatWs,
    stringExpressions.scala). Each nullable input's dictionary gains a
    NULL entry inside the mixed radix."""

    sep: str
    args: Tuple[Expression, ...]

    def children(self):
        return self.args

    def data_type(self, schema):
        return T.STRING

    def nullable(self, schema):
        return False

    def __str__(self):
        return f"CONCAT_WS({self.sep!r}, {', '.join(map(str, self.args))})"


@dataclass(eq=False, frozen=True)
class Abs(Expression):
    child: Expression

    def children(self):
        return (self.child,)

    def data_type(self, schema):
        return self.child.data_type(schema)

    def __str__(self):
        return f"ABS({self.child})"


@dataclass(eq=False, frozen=True)
class UnaryMath(Expression):
    """floor/ceil/sqrt/exp/ln/log10/sign (reference: catalyst
    mathExpressions.scala). floor and ceil give INT64, sign the input's
    type, the others DOUBLE; a decimal input computes on its value."""

    op: str
    child: Expression

    def children(self):
        return (self.child,)

    def data_type(self, schema):
        if self.op in ("floor", "ceil"):
            return T.INT64
        if self.op == "sign":
            return self.child.data_type(schema)
        return T.FLOAT64

    def __str__(self):
        return f"{self.op.upper()}({self.child})"


def round_decimal_type(dt: "T.DecimalType", scale: int) -> "T.DecimalType":
    """ROUND of a decimal(p, s) to ``scale`` digits: Spark's RoundBase
    type, decimal(p - s + 1 + s', s') with s' = min(s, scale), and
    decimal(max(p - s + 1, 1 - scale), 0) for a negative scale."""
    integral = dt.precision - dt.scale + 1
    if scale < 0:
        return T.bounded_decimal(max(integral, 1 - scale), 0)
    new_scale = min(dt.scale, scale)
    return T.bounded_decimal(integral + new_scale, new_scale)


@dataclass(eq=False, frozen=True)
class Round(Expression):
    """ROUND(x, scale) with HALF_UP ties (Spark semantics). Integers stay
    integers, floats give DOUBLE, and decimals round exactly to
    ``round_decimal_type`` (the reference gives DOUBLE of the unscaled
    integer: ROADMAP C)."""

    child: Expression
    scale: int = 0

    def children(self):
        return (self.child,)

    def data_type(self, schema):
        dt = self.child.data_type(schema)
        if isinstance(dt, T.DecimalType):
            return round_decimal_type(dt, self.scale)
        return dt if dt.is_integral else T.FLOAT64

    def __str__(self):
        return f"ROUND({self.child}, {self.scale})"


@dataclass(eq=False, frozen=True)
class Pow(Expression):
    left: Expression
    right: Expression

    def children(self):
        return (self.left, self.right)

    def data_type(self, schema):
        return T.FLOAT64

    def __str__(self):
        return f"POWER({self.left}, {self.right})"


@dataclass(eq=False, frozen=True)
class StringTransform(Expression):
    """upper/lower/trim/ltrim/rtrim/initcap/reverse/repeat/lpad/rpad/
    translate, host dictionary transforms (reference:
    stringExpressions.scala Upper/Lower/StringTrim/StringLPad/...).
    ``args`` carries the op's scalar parameters (pad string, width...),
    and the name shows them, so that lpad(s, 6) and lpad(s, 3) are two
    columns (the reference names both ``LPAD(s)`` and keeps one)."""

    op: str
    child: Expression
    args: Tuple = ()

    def children(self):
        return (self.child,)

    def data_type(self, schema):
        return T.STRING

    def __str__(self):
        args = "".join(f", {a!r}" for a in self.args)
        return f"{self.op.upper()}({self.child}{args})"


@dataclass(eq=False, frozen=True)
class StrLength(Expression):
    child: Expression

    def children(self):
        return (self.child,)

    def data_type(self, schema):
        return T.INT32

    def __str__(self):
        return f"LENGTH({self.child})"


@dataclass(eq=False, frozen=True)
class RegexpExtract(Expression):
    """regexp_extract(str, pattern, group) (reference:
    regexpExpressions.scala RegExpExtract; no match gives '')."""

    child: Expression
    pattern: str
    group: int = 1

    def children(self):
        return (self.child,)

    def data_type(self, schema):
        return T.STRING

    def __str__(self):
        return f"REGEXP_EXTRACT({self.child}, {self.pattern!r}, {self.group})"


@dataclass(eq=False, frozen=True)
class RegexpReplace(Expression):
    child: Expression
    pattern: str
    replacement: str

    def children(self):
        return (self.child,)

    def data_type(self, schema):
        return T.STRING

    def __str__(self):
        return (f"REGEXP_REPLACE({self.child}, {self.pattern!r}, "
                f"{self.replacement!r})")


@dataclass(eq=False, frozen=True)
class RegexpLike(Expression):
    """RLIKE / regexp_like: a regex search over the dictionary."""

    child: Expression
    pattern: str

    def children(self):
        return (self.child,)

    def data_type(self, schema):
        return T.BOOLEAN

    def __str__(self):
        return f"({self.child} RLIKE {self.pattern!r})"


@dataclass(eq=False, frozen=True)
class DateTrunc(Expression):
    """date_trunc('year'|'month', date) (reference:
    datetimeExpressions.scala TruncDate)."""

    unit: str
    child: Expression

    def children(self):
        return (self.child,)

    def data_type(self, schema):
        return T.DATE

    def __str__(self):
        return f"DATE_TRUNC({self.unit!r}, {self.child})"


@dataclass(eq=False, frozen=True)
class LastDay(Expression):
    child: Expression

    def children(self):
        return (self.child,)

    def data_type(self, schema):
        return T.DATE

    def __str__(self):
        return f"LAST_DAY({self.child})"


@dataclass(eq=False, frozen=True)
class SortOrder(Expression):
    """Sort key wrapper (reference: expressions/SortOrder.scala).
    nulls_first default matches Spark: NULLS FIRST for ASC, LAST for DESC."""

    child: Expression
    ascending: bool = True
    nulls_first: Optional[bool] = None

    def children(self):
        return (self.child,)

    def data_type(self, schema):
        return self.child.data_type(schema)

    @property
    def nulls_first_resolved(self) -> bool:
        if self.nulls_first is not None:
            return self.nulls_first
        return self.ascending

    def __str__(self):
        d = "ASC" if self.ascending else "DESC"
        return f"{self.child} {d}"


@dataclass(eq=False, frozen=True)
class NullOf(Expression):
    """NULL typed like ``like`` (reference: Literal(null, child.dataType)
    inside NullIf's If rewrite, nullExpressions.scala). Keeps Case's
    common-type inference working where an untyped null literal cannot;
    the grouping-sets Expand fills aggregated-away keys with it."""

    like: Expression

    def children(self):
        return (self.like,)

    def data_type(self, schema):
        return self.like.data_type(schema)

    def nullable(self, schema):
        return True

    def __str__(self):
        return f"NULL_OF({self.like})"


@dataclass(eq=False, frozen=True)
class Grouping(Expression):
    """grouping(col): 1 when the row is a subtotal that aggregated
    ``col`` away (reference: grouping.scala Grouping). A marker:
    ``plan/grouping.py`` replaces it with arithmetic over the grouping
    id before evaluation."""

    child: Expression

    def children(self):
        return (self.child,)

    def data_type(self, schema):
        return T.INT32

    def __str__(self):
        return f"grouping({self.child})"


@dataclass(eq=False, frozen=True)
class GroupingId(Expression):
    """grouping_id() marker (reference: grouping.scala GroupingID)."""

    def data_type(self, schema):
        return T.INT64

    def __str__(self):
        return "grouping_id()"


# ---- window expressions -----------------------------------------------------


@dataclass(eq=False, frozen=True)
class RowNumber(Expression):
    """row_number(): 1-based position within the window partition
    (reference: expressions/windowExpressions.scala RowNumber)."""

    def data_type(self, schema):
        return T.INT32

    def nullable(self, schema):
        return False

    @property
    def name(self):
        return "row_number()"

    def __str__(self):
        return self.name


@dataclass(eq=False, frozen=True)
class Rank(Expression):
    """rank() / dense_rank() over the window's ORDER BY peers."""

    dense: bool = False

    def data_type(self, schema):
        return T.INT32

    def nullable(self, schema):
        return False

    @property
    def name(self):
        return "dense_rank()" if self.dense else "rank()"

    def __str__(self):
        return self.name


@dataclass(eq=False, frozen=True)
class LagLead(Expression):
    """lag/lead(child, offset, default): the value of the row ``offset``
    rows before/after within the partition (reference:
    windowExpressions.scala Lag/Lead)."""

    child: Expression
    offset: int
    default: Optional[Expression]
    lead: bool  # False = lag

    def children(self):
        return (self.child,) if self.default is None \
            else (self.child, self.default)

    def data_type(self, schema):
        return self.child.data_type(schema)

    @property
    def name(self):
        fn = "lead" if self.lead else "lag"
        return f"{fn}({self.child}, {self.offset})"

    def __str__(self):
        return self.name


@dataclass(eq=False, frozen=True)
class NTile(Expression):
    """ntile(n): the partition split into ``n`` near-equal buckets."""

    n: int

    def data_type(self, schema):
        return T.INT32

    def nullable(self, schema):
        return False

    @property
    def name(self):
        return f"ntile({self.n})"

    def __str__(self):
        return self.name


@dataclass(eq=False, frozen=True)
class WindowExpr(Expression):
    """fn OVER (PARTITION BY ... ORDER BY ... frame) (reference:
    expressions/windowExpressions.scala WindowExpression +
    WindowSpecDefinition). ``frame`` is (mode, start, end) with mode
    'rows'|'range', bounds None=unbounded, 0=current row, +/-n offsets;
    a None frame is the SQL default (RANGE UNBOUNDED PRECEDING..CURRENT
    ROW with ORDER BY, the whole partition without)."""

    func: Expression
    partition_by: Tuple[Expression, ...]
    order_by: Tuple["SortOrder", ...]
    frame: Optional[Tuple[str, Optional[int], Optional[int]]] = None

    def children(self):
        return (self.func,) + tuple(self.partition_by) + tuple(self.order_by)

    def data_type(self, schema):
        if isinstance(self.func, Count):
            return T.INT64
        return self.func.data_type(schema)

    @property
    def name(self):
        return f"{self.func.name} OVER (...)"

    def __str__(self):
        return self.name


def window_dictionary(w: WindowExpr, schema) -> Optional[tuple]:
    """String dictionary of a window output, when the function carries
    values through from a dictionary-encoded column (lag/lead/min/max/
    first)."""
    fn = w.func
    if not isinstance(fn, (LagLead, Min, Max, First)):
        return None
    c = strip_alias(fn.child)
    if isinstance(c, Col) and c.col_name in schema:
        return schema.field(c.col_name).dictionary
    return None


def contains_window(e: Expression) -> bool:
    if isinstance(e, WindowExpr):
        return True
    return any(contains_window(c) for c in e.children())


# ---- subquery expressions ---------------------------------------------------


@dataclass(eq=False, frozen=True)
class OuterRef(Expression):
    """A correlated reference to a column of the OUTER query inside a
    subquery (reference: expressions/subquery.scala OuterReference).
    The dtype is captured at parse time; decorrelation
    (plan/subquery.py) removes these before execution."""

    col_name: str
    dtype: DataType = None  # type: ignore[assignment]

    def data_type(self, schema: Schema) -> DataType:
        return self.dtype

    def references(self) -> set:
        return set()  # not a reference of the INNER plan

    def __str__(self):
        return f"outer({self.col_name})"


class SubqueryExpression(Expression):
    """Marker base (reference: expressions/subquery.scala)."""


@dataclass(eq=False, frozen=True)
class ScalarSubquery(SubqueryExpression):
    plan: Any  # LogicalPlan producing one row, one column

    def data_type(self, schema: Schema) -> DataType:
        return self.plan.schema.fields[0].dtype

    def __str__(self):
        return "scalar-subquery(...)"


@dataclass(eq=False, frozen=True)
class InSubquery(SubqueryExpression):
    child: Expression
    plan: Any  # LogicalPlan producing one column
    negated: bool = False

    def children(self):
        return (self.child,)

    def data_type(self, schema: Schema) -> DataType:
        return T.BOOLEAN

    def __str__(self):
        n = "NOT " if self.negated else ""
        return f"({self.child} {n}IN subquery(...))"


@dataclass(eq=False, frozen=True)
class Exists(SubqueryExpression):
    plan: Any  # LogicalPlan
    negated: bool = False

    def data_type(self, schema: Schema) -> DataType:
        return T.BOOLEAN


def contains_subquery(e: Expression) -> bool:
    if isinstance(e, SubqueryExpression):
        return True
    return any(contains_subquery(c) for c in e.children())


# ---- aggregates ------------------------------------------------------------


class AggregateExpression(Expression):
    """Marker base for aggregate functions (reference:
    expressions/aggregate/)."""

    def data_type(self, schema):
        raise NotImplementedError


@dataclass(eq=False, frozen=True)
class Sum(AggregateExpression):
    child: Expression
    distinct: bool = False

    def children(self):
        return (self.child,)

    def data_type(self, schema):
        dt = self.child.data_type(schema)
        if dt.is_integral:
            return T.INT64
        if isinstance(dt, T.DecimalType):
            # reference: Sum widens by 10 integral digits (Sum.scala)
            return T.bounded_decimal(dt.precision + 10, dt.scale)
        return dt

    @property
    def name(self):
        d = "DISTINCT " if self.distinct else ""
        return f"sum({d}{self.child})"

    def __str__(self):
        return self.name


@dataclass(eq=False, frozen=True)
class Avg(AggregateExpression):
    child: Expression
    distinct: bool = False

    def children(self):
        return (self.child,)

    def data_type(self, schema):
        dt = self.child.data_type(schema)
        if isinstance(dt, T.DecimalType):
            # reference: Average adds 4 fractional digits (Average.scala)
            return T.bounded_decimal(dt.precision + 4, dt.scale + 4)
        return T.FLOAT64

    @property
    def name(self):
        d = "DISTINCT " if self.distinct else ""
        return f"avg({d}{self.child})"

    def __str__(self):
        return self.name


@dataclass(eq=False, frozen=True)
class Count(AggregateExpression):
    """COUNT(expr); COUNT(*) is Count(None)."""

    child: Optional[Expression] = None
    distinct: bool = False

    def children(self):
        return (self.child,) if self.child is not None else ()

    def data_type(self, schema):
        return T.INT64

    def nullable(self, schema):
        return False

    @property
    def name(self):
        inner = "*" if self.child is None else str(self.child)
        d = "DISTINCT " if self.distinct else ""
        return f"count({d}{inner})"

    def __str__(self):
        return self.name


@dataclass(eq=False, frozen=True)
class Min(AggregateExpression):
    child: Expression

    def children(self):
        return (self.child,)

    def data_type(self, schema):
        return self.child.data_type(schema)

    @property
    def name(self):
        return f"min({self.child})"

    def __str__(self):
        return self.name


@dataclass(eq=False, frozen=True)
class Max(AggregateExpression):
    child: Expression

    def children(self):
        return (self.child,)

    def data_type(self, schema):
        return self.child.data_type(schema)

    @property
    def name(self):
        return f"max({self.child})"

    def __str__(self):
        return self.name


@dataclass(eq=False, frozen=True)
class First(AggregateExpression):
    child: Expression
    ignore_nulls: bool = False

    def children(self):
        return (self.child,)

    def data_type(self, schema):
        return self.child.data_type(schema)

    @property
    def name(self):
        return f"first({self.child})"

    def __str__(self):
        return self.name


@dataclass(eq=False, frozen=True)
class StddevVariance(AggregateExpression):
    """stddev_samp/stddev_pop/var_samp/var_pop from the sum and the sum
    of squares, as the reference computes them; a decimal input computes
    on its value (the reference reads the unscaled integer: ROADMAP C)."""

    kind: str  # 'stddev_samp' | 'stddev_pop' | 'var_samp' | 'var_pop'
    child: Expression

    def children(self):
        return (self.child,)

    def data_type(self, schema):
        return T.FLOAT64

    @property
    def name(self):
        return f"{self.kind}({self.child})"

    def __str__(self):
        return self.name


@dataclass(eq=False, frozen=True)
class Percentile(AggregateExpression):
    """percentile / percentile_approx / median, computed exactly per
    group by a (group, value) sort and a gather at each group's rank
    (reference: aggregate/ApproximatePercentile.scala:81). ``fn`` names
    the SQL function. Interpolated (percentile, median), the result is a
    DOUBLE between ranks; otherwise the element at rank ceil(q * n), in
    the input's type. percentile(x, 0.5) and median(x) get distinct
    names (the reference names both ``median`` and loses one column:
    ROADMAP C)."""

    child: Expression
    percentage: float
    fn: str = "percentile_approx"  # | "percentile" | "median"

    def children(self):
        return (self.child,)

    @property
    def interpolate(self) -> bool:
        return self.fn != "percentile_approx"

    def data_type(self, schema):
        if self.interpolate:
            return T.FLOAT64
        return self.child.data_type(schema)

    @property
    def name(self):
        if self.fn == "median":
            return f"median({self.child})"
        return f"{self.fn}({self.child}, {self.percentage})"

    def __str__(self):
        return self.name


def strip_alias(e: Expression) -> Expression:
    while isinstance(e, Alias):
        e = e.child
    return e


def contains_aggregate(e: Expression) -> bool:
    if isinstance(e, AggregateExpression):
        return True
    if isinstance(e, WindowExpr):
        return False  # the aggregate belongs to the window, not the query
    return any(contains_aggregate(c) for c in e.children())


def collect_aggregates(e: Expression) -> list:
    if isinstance(e, AggregateExpression):
        return [e]
    if isinstance(e, WindowExpr):
        return []
    out = []
    for c in e.children():
        out.extend(collect_aggregates(c))
    return out


def transform_expr_down(e: Expression, fn) -> Expression:
    """Pre-order expression transform: ``fn`` sees each node before its
    children; where it returns a replacement, the descent stops there
    (TreeNode.transformDown analogue)."""
    ne = fn(e)
    if ne is not e:
        return ne

    def tx(v):
        if isinstance(v, Expression):
            return transform_expr_down(v, fn)
        if isinstance(v, tuple):
            nv = tuple(tx(x) for x in v)
            return nv if any(a is not b for a, b in zip(nv, v)) else v
        return v

    new_fields = {}
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        nv = tx(v)
        if nv is not v:
            new_fields[f.name] = nv
    return dataclasses.replace(e, **new_fields) if new_fields else e


def transform_expr(e: Expression, fn) -> Expression:
    """Bottom-up expression transform (TreeNode.transformUp analogue,
    reference: catalyst/trees/TreeNode.scala). Descends into tuple
    fields and tuples of pairs (Coalesce.args, Case.branches)."""

    def tx(v):
        if isinstance(v, Expression):
            return transform_expr(v, fn)
        if isinstance(v, tuple):
            nv = tuple(tx(x) for x in v)
            return nv if any(a is not b for a, b in zip(nv, v)) else v
        return v

    new_fields = {}
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        nv = tx(v)
        if nv is not v:
            new_fields[f.name] = nv
    if new_fields:
        e = dataclasses.replace(e, **new_fields)
    return fn(e)
