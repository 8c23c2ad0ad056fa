"""Expression tree (IR), trimmed to the nodes the single-device
aggregate, join, subquery, window and scalar-function slices plan:
columns, literals, aliases, arithmetic, month arithmetic on dates,
comparisons, boolean logic, null tests, casts, IN lists, LIKE and the
other dictionary string predicates, substring, concatenation, the string
transforms, length and regular expressions, arrays, maps, their
functions, the higher-order functions and the explode generator, the
math functions (abs, floor/ceil/sqrt/exp/ln/log10/sign, round, power),
date_trunc and last_day, CASE, COALESCE, typed NULLs (``NullOf``),
date parts, sort orders, the subquery nodes (removed by
``plan/subquery.py`` before execution), the grouping markers ``grouping()``/``grouping_id()``
(rewritten by ``plan/grouping.py``), the window functions and the
count/sum/avg/min/max/first, stddev/variance, percentile and
collect_list/collect_set aggregates, with DISTINCT on count, sum and avg.

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
from typing import Any, Callable, Optional, Tuple

from spark_tpu_torch import types as T
from spark_tpu_torch.types import DataType, Schema


class Expression:
    """Base class. Subclasses are frozen dataclasses."""

    #: True for a host-only node (an arrow UDF): an operator holding one
    #: runs blocking, outside traced stages (``contains_blocking``)
    blocks_trace: bool = False

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

    # -- the Column DSL (pyspark's Column, reference:
    # ``spark_tpu/expr/expressions.py``): operators build nodes --------

    def __add__(self, other):
        return Arith("+", self, lit_or_expr(other))

    def __radd__(self, other):
        return Arith("+", lit_or_expr(other), self)

    def __sub__(self, other):
        return Arith("-", self, lit_or_expr(other))

    def __rsub__(self, other):
        return Arith("-", lit_or_expr(other), self)

    def __mul__(self, other):
        return Arith("*", self, lit_or_expr(other))

    def __rmul__(self, other):
        return Arith("*", lit_or_expr(other), self)

    def __truediv__(self, other):
        return Arith("/", self, lit_or_expr(other))

    def __mod__(self, other):
        return Arith("%", self, lit_or_expr(other))

    def __neg__(self):
        return Neg(self)

    def __eq__(self, other):  # type: ignore[override]
        return Cmp("==", self, lit_or_expr(other))

    def __ne__(self, other):  # type: ignore[override]
        return Cmp("!=", self, lit_or_expr(other))

    def __lt__(self, other):
        return Cmp("<", self, lit_or_expr(other))

    def __le__(self, other):
        return Cmp("<=", self, lit_or_expr(other))

    def __gt__(self, other):
        return Cmp(">", self, lit_or_expr(other))

    def __ge__(self, other):
        return Cmp(">=", self, lit_or_expr(other))

    def __and__(self, other):
        return And(self, lit_or_expr(other))

    def __or__(self, other):
        return Or(self, lit_or_expr(other))

    def __invert__(self):
        return Not(self)

    def __hash__(self):
        return object.__hash__(self)

    def __bool__(self):
        # __eq__ builds a Cmp, so the truth value of an Expression is
        # always a bug: structural comparison goes through expr_key()
        raise TypeError(
            "Expression has no truth value; use expr_key()/semantic_eq() "
            "for comparison, is_null()/is_not_null() for null tests")

    def alias(self, name: str) -> "Alias":
        return Alias(self, name)

    def cast(self, dtype: DataType) -> "Cast":
        return Cast(self, dtype)

    def is_null(self) -> "IsNull":
        return IsNull(self)

    def is_not_null(self) -> "Not":
        return Not(IsNull(self))

    def isin(self, *values) -> "In":
        if len(values) == 1 and isinstance(values[0], (list, tuple, set)):
            values = tuple(values[0])
        return In(self, tuple(values))

    def between(self, lo, hi) -> "And":
        return And(Cmp(">=", self, lit_or_expr(lo)),
                   Cmp("<=", self, lit_or_expr(hi)))

    def like(self, pattern: str) -> "Like":
        return Like(self, pattern)

    def asc(self) -> "SortOrder":
        return SortOrder(self, ascending=True)

    def desc(self) -> "SortOrder":
        return SortOrder(self, ascending=False)

    def semantic_eq(self, other: "Expression") -> bool:
        return expr_key(self) == expr_key(other)

    def over(self, window) -> "Expression":
        """Attach a window spec (pyspark's Column.over)."""
        return window._attach(self)


def lit_or_expr(v: Any) -> Expression:
    return v if isinstance(v, Expression) else Literal(v)


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
class MapHandle(Col):
    """A bare reference to a map column, resolved to its ``#keys``
    component (types.MapType). It evaluates as that Col; a SELECT list
    that selects it adds the ``#vals`` sibling, so the pair survives."""


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


# ---- arrays, maps and generators (the padded layout, types.ArrayType) ------


@dataclass(eq=False, frozen=True)
class MakeArray(Expression):
    """array(e1, e2, ...) (reference: CreateArray,
    complexTypeCreator.scala): fixed length, the arity. A null input
    nulls the whole array row, since an element cannot be null."""

    args: Tuple[Expression, ...]

    def children(self):
        return self.args

    def data_type(self, schema):
        dt = self.args[0].data_type(schema)
        for a in self.args[1:]:
            dt = T.common_type(dt, a.data_type(schema))
        return T.ArrayType(dt)

    def __str__(self):
        return f"array({', '.join(map(str, self.args))})"


@dataclass(eq=False, frozen=True)
class Split(Expression):
    """split(str, delim) -> array<string> (reference: StringSplit; the
    delimiter is a literal separator, as Python's ``str.split``, and the
    split runs over the host dictionary)."""

    child: Expression
    delim: str

    def children(self):
        return (self.child,)

    def data_type(self, schema):
        return T.ArrayType(T.STRING)

    def __str__(self):
        return f"split({self.child}, {self.delim!r})"


@dataclass(eq=False, frozen=True)
class Size(Expression):
    """size(array) and size(map) (reference: Size)."""

    child: Expression

    def children(self):
        return (self.child,)

    def data_type(self, schema):
        return T.INT32

    def __str__(self):
        return f"size({self.child})"


@dataclass(eq=False, frozen=True)
class ElementAt(Expression):
    """element_at(array, i): 1-based, negative from the end, NULL out of
    range (reference: ElementAt). Over a map the index is a key lookup
    (GetMapValue). ``sql_subscript`` marks ``x[i]``, 0-based for arrays
    (GetArrayItem) and a key lookup for maps."""

    child: Expression
    index: Expression
    sql_subscript: bool = False

    def children(self):
        return (self.child, self.index)

    def data_type(self, schema):
        dt = self.child.data_type(schema)
        if isinstance(dt, T.ArrayType):
            return dt.element
        if isinstance(dt, T.MapType):
            return dt.value
        raise TypeError(f"element_at over non-array {dt!r}")

    def nullable(self, schema):
        return True

    def __str__(self):
        return f"element_at({self.child}, {self.index})"


@dataclass(eq=False, frozen=True)
class ArrayContains(Expression):
    """array_contains(array, value) (reference: ArrayContains)."""

    child: Expression
    value: Expression

    def children(self):
        return (self.child, self.value)

    def data_type(self, schema):
        return T.BOOLEAN

    def __str__(self):
        return f"array_contains({self.child}, {self.value})"


@dataclass(eq=False, frozen=True)
class CreateMap(Expression):
    """map(k1, v1, k2, v2, ...) (reference: CreateMap). A map-typed
    expression is legal only at the top of a projection, which expands
    it into its ``#keys``/``#vals`` pair (types.MapType)."""

    args: Tuple[Expression, ...]

    def __post_init__(self):
        if len(self.args) % 2:
            raise TypeError("map() needs an even argument count")

    def children(self):
        return self.args

    def data_type(self, schema):
        kt = self.args[0].data_type(schema)
        vt = self.args[1].data_type(schema)
        for k in self.args[2::2]:
            kt = T.common_type(kt, k.data_type(schema))
        for v in self.args[3::2]:
            vt = T.common_type(vt, v.data_type(schema))
        return T.MapType(kt, vt)

    def __str__(self):
        return f"map({', '.join(str(a) for a in self.args)})"


@dataclass(eq=False, frozen=True)
class MapFromArrays(Expression):
    """map_from_arrays(keys, values) (reference: MapFromArrays)."""

    keys: Expression
    vals: Expression

    def children(self):
        return (self.keys, self.vals)

    def data_type(self, schema):
        kt = self.keys.data_type(schema)
        vt = self.vals.data_type(schema)
        if not isinstance(kt, T.ArrayType) or not isinstance(vt, T.ArrayType):
            raise TypeError("map_from_arrays needs two array inputs")
        return T.MapType(kt.element, vt.element)

    def __str__(self):
        return f"map_from_arrays({self.keys}, {self.vals})"


@dataclass(eq=False, frozen=True)
class Lambda(Expression):
    """``x -> body`` / ``(x, i) -> body`` of a higher-order function
    (reference: LambdaFunction). The parameters bind as column names in
    the body, shadowing outer columns; the body is evaluated once over
    the flattened rows x max_len element plane."""

    params: Tuple[str, ...]
    body: Expression

    def children(self):
        return (self.body,)

    def data_type(self, schema):
        raise TypeError("a lambda has no standalone type")

    def references(self) -> set:
        return self.body.references() - set(self.params)

    def __str__(self):
        return f"({', '.join(self.params)}) -> {self.body}"


def _with_fields(schema, extra_fields):
    return T.Schema(tuple(schema.fields) + tuple(extra_fields))


@dataclass(eq=False, frozen=True)
class HigherOrder(Expression):
    """transform / filter / exists / forall / aggregate over an array
    (reference: higherOrderFunctions.scala). ``zero`` and ``finish`` are
    aggregate's."""

    kind: str  # transform | filter | exists | forall | aggregate
    child: Expression
    fn: Lambda
    zero: Optional[Expression] = None
    finish: Optional[Lambda] = None

    def children(self):
        return (self.child, self.fn) + tuple(
            e for e in (self.zero, self.finish) if e is not None)

    def _element_schema(self, schema):
        dt = self.child.data_type(schema)
        if not isinstance(dt, T.ArrayType):
            raise TypeError(f"{self.kind}() over non-array {dt!r}")
        fields = [T.Field(self.fn.params[0], dt.element, False)]
        if len(self.fn.params) > 1:
            fields.append(T.Field(self.fn.params[1], T.INT32, False))
        return _with_fields(schema, fields)

    def data_type(self, schema):
        if self.kind == "transform":
            return T.ArrayType(
                self.fn.body.data_type(self._element_schema(schema)))
        if self.kind == "filter":
            return self.child.data_type(schema)
        if self.kind in ("exists", "forall"):
            return T.BOOLEAN
        if self.kind == "aggregate":
            dt = self.child.data_type(schema)
            acc_dt = self.zero.data_type(schema)
            s2 = _with_fields(schema, [
                T.Field(self.fn.params[0], acc_dt, False),
                T.Field(self.fn.params[1], dt.element, False)])
            acc_dt = T.common_type(acc_dt, self.fn.body.data_type(s2))
            if self.finish is not None:
                s3 = _with_fields(
                    schema, [T.Field(self.finish.params[0], acc_dt, False)])
                return self.finish.body.data_type(s3)
            return acc_dt
        raise TypeError(f"unknown higher-order kind {self.kind!r}")

    def __str__(self):
        parts = [str(self.child), str(self.fn)]
        if self.zero is not None:
            parts.insert(1, str(self.zero))
        return f"{self.kind}({', '.join(parts)})"


@dataclass(eq=False, frozen=True)
class Explode(Expression):
    """Generator: one output row per array element (reference:
    Explode/PosExplode, generators.scala). Legal only as a SELECT item
    or in LATERAL VIEW, which plan it as a ``Generate`` node."""

    child: Expression
    with_position: bool = False

    def children(self):
        return (self.child,)

    def data_type(self, schema):
        dt = self.child.data_type(schema)
        if isinstance(dt, T.ArrayType):
            return dt.element
        raise TypeError(f"explode over non-array {dt!r}")

    def __str__(self):
        return ("posexplode" if self.with_position else "explode") \
            + f"({self.child})"


def contains_generator(e: Expression) -> bool:
    if isinstance(e, Explode):
        return True
    return any(contains_generator(c) for c in e.children())


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


def exact_cast(child: Expression, src: DataType, dst: DataType
               ) -> Expression:
    """``child``, of type ``src``, as the same value in ``dst``. CAST keeps
    the reference's decimal quirks (a decimal to a double is its unscaled
    integer, an integer to a decimal is not rescaled), so those two go the
    long way: through the division by 10^scale, and through a decimal of
    scale 0."""
    if src == dst:
        return child
    if isinstance(src, T.DecimalType) and not isinstance(dst, T.DecimalType):
        as_float = Cast(child, T.FLOAT64)
        return as_float if src.scale == 0 else Arith(
            "/", as_float, Literal(float(10 ** src.scale)))
    if isinstance(dst, T.DecimalType) and not isinstance(src, T.DecimalType):
        child = Cast(child, T.DecimalType(T.DecimalType.MAX_PRECISION, 0))
    return Cast(child, dst)


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

    def when(self, condition: Expression, value: Any) -> "Case":
        """Another WHEN branch (pyspark's ``F.when(...).when(...)``)."""
        return Case(self.branches + ((condition, lit_or_expr(value)),),
                    self.else_value)

    def otherwise(self, value: Any) -> "Case":
        return Case(self.branches, lit_or_expr(value))

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


@dataclass(eq=False, frozen=True)
class TumblingWindow(Expression):
    """Tumbling event-time window key: ``child - child % width``, the
    window start (reference: expressions/TimeWindow.scala). The width is
    kept so that streaming eviction closes a window only when the
    watermark passes its end; a batch query evaluates ``as_arith()``."""

    child: Expression
    width: int

    def children(self):
        return (self.child,)

    def data_type(self, schema):
        return self.child.data_type(schema)

    @property
    def name(self):
        return "window"

    def __str__(self):
        return f"window({self.child}, {self.width})"

    def as_arith(self) -> Expression:
        return Arith("-", self.child,
                     Arith("%", self.child, Literal(self.width)))


@dataclass(eq=False, frozen=True)
class SessionWindow(Expression):
    """Gap-based session window key (reference:
    expressions/SessionWindow.scala, planned by MergingSessionsExec).
    The streaming runner groups partials by the raw event time (each
    event opens a provisional [t, t + gap) session) and merges
    overlapping sessions in the state merge; the output is the merged
    session's start."""

    child: Expression
    gap: int

    def children(self):
        return (self.child,)

    def data_type(self, schema):
        return self.child.data_type(schema)

    @property
    def name(self):
        return "session_window"

    def __str__(self):
        return f"session_window({self.child}, {self.gap})"


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
class Collect(AggregateExpression):
    """collect_list / collect_set: a group's non-null values as an array
    (reference: aggregate/collect.scala). collect_list keeps the rows'
    order, collect_set keeps each value once, in value order. The output
    width is the largest group's count, which the host reads."""

    child: Expression
    unique: bool = False  # collect_set

    def children(self):
        return (self.child,)

    def data_type(self, schema):
        return T.ArrayType(self.child.data_type(schema))

    def nullable(self, schema):
        return False

    @property
    def name(self):
        return f"collect_{'set' if self.unique else 'list'}({self.child})"

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


@dataclass(eq=False, frozen=True)
class TensorUdf(Expression):
    """Device UDF (``api/udf.py``'s ``udf``): fn(*tensors) -> tensor,
    evaluated in the stage."""

    fn: Callable
    return_type: DataType
    args: Tuple[Expression, ...]
    fn_name: str = "udf"

    def children(self):
        return self.args

    def data_type(self, schema):
        return self.return_type

    @property
    def name(self):
        return f"{self.fn_name}({', '.join(str(a) for a in self.args)})"

    def __str__(self):
        return self.name


@dataclass(eq=False, frozen=True)
class ArrowUdf(Expression):
    """Host UDF over pyarrow arrays (``api/udf.py``'s ``arrow_udf``);
    evaluated eagerly, between stages."""

    fn: Callable
    return_type: DataType
    args: Tuple[Expression, ...]
    fn_name: str = "arrow_udf"
    blocks_trace = True

    def children(self):
        return self.args

    def data_type(self, schema):
        return self.return_type

    @property
    def name(self):
        return f"{self.fn_name}({', '.join(str(a) for a in self.args)})"

    def __str__(self):
        return self.name


def strip_alias(e: Expression) -> Expression:
    while isinstance(e, Alias):
        e = e.child
    return e


def contains_blocking(e: Expression) -> bool:
    """Whether a host-only expression (an arrow UDF) lies below ``e``:
    the operator holding it runs blocking."""
    return e.blocks_trace or any(contains_blocking(c)
                                 for c in e.children())


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
