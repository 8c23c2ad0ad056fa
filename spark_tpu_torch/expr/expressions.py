"""Expression tree (IR), trimmed to the nodes the single-device
aggregate, join and subquery slices plan: columns, literals, aliases,
arithmetic, month arithmetic on dates, comparisons, boolean logic, null
tests, casts, IN lists, LIKE and the other dictionary string predicates,
substring, CASE, COALESCE, date parts, sort orders, the subquery nodes
(removed by ``plan/subquery.py`` before execution) and the
count/sum/avg/min/max/first aggregates, with DISTINCT on count, sum and
avg.

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


def strip_alias(e: Expression) -> Expression:
    while isinstance(e, Alias):
        e = e.child
    return e


def contains_aggregate(e: Expression) -> bool:
    if isinstance(e, AggregateExpression):
        return True
    return any(contains_aggregate(c) for c in e.children())


def collect_aggregates(e: Expression) -> list:
    if isinstance(e, AggregateExpression):
        return [e]
    out = []
    for c in e.children():
        out.extend(collect_aggregates(c))
    return out


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
