"""Expression tree (IR), trimmed to the nodes the single-device
aggregate slice plans: columns, literals, aliases, arithmetic,
comparisons, boolean logic, null tests, casts, sort orders and the
count/sum/avg/min/max aggregates.

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


def expr_key(e: Expression):
    """Structural identity key. Nodes compare by identity (``eq=False``),
    so structural comparison goes through this."""
    if isinstance(e, Literal):
        return ("lit", e.value, repr(e.dtype))
    parts = [type(e).__name__]
    for f_val in vars(e).values():
        parts.append(expr_key(f_val) if isinstance(f_val, Expression)
                     else repr(f_val))
    return tuple(parts)


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


# ---- aggregates ------------------------------------------------------------


class AggregateExpression(Expression):
    """Marker base for aggregate functions (reference:
    expressions/aggregate/)."""

    def data_type(self, schema):
        raise NotImplementedError


@dataclass(eq=False, frozen=True)
class Sum(AggregateExpression):
    child: Expression

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
        return f"sum({self.child})"

    def __str__(self):
        return self.name


@dataclass(eq=False, frozen=True)
class Avg(AggregateExpression):
    child: Expression

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
        return f"avg({self.child})"

    def __str__(self):
        return self.name


@dataclass(eq=False, frozen=True)
class Count(AggregateExpression):
    """COUNT(expr); COUNT(*) is Count(None)."""

    child: Optional[Expression] = None

    def children(self):
        return (self.child,) if self.child is not None else ()

    def data_type(self, schema):
        return T.INT64

    def nullable(self, schema):
        return False

    @property
    def name(self):
        inner = "*" if self.child is None else str(self.child)
        return f"count({inner})"

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
    reference: catalyst/trees/TreeNode.scala)."""
    new_fields = {}
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        if isinstance(v, Expression):
            nv = transform_expr(v, fn)
            if nv is not v:
                new_fields[f.name] = nv
    if new_fields:
        e = dataclasses.replace(e, **new_fields)
    return fn(e)
