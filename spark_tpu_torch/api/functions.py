"""Column functions, the ``pyspark.sql.functions`` surface (the port of
``spark_tpu/api/functions.py``; reference: sql/core/.../functions.scala).
Columns are expression trees: every function builds an
``expr/expressions.py`` node, and the functions the SQL parser composes
out of other nodes come from ``sql/functions.py``.

``udf`` and ``arrow_udf`` are ``api/udf.py``'s; ``window`` and
``session_window`` build the streaming windows (``streaming/``), and
``window`` also groups a batch query.
"""

from __future__ import annotations

import re
from typing import Any, Union

from spark_tpu_torch import types as T
from spark_tpu_torch.api.udf import arrow_udf, udf  # noqa: F401
from spark_tpu_torch.expr import expressions as E
from spark_tpu_torch.sql import functions as SF

Column = E.Expression
ColumnOrName = Union[Column, str]


def _c(c: ColumnOrName) -> Column:
    return c if isinstance(c, E.Expression) else E.Col(c)


def col(name: str) -> Column:
    return E.Col(name)


column = col


def lit(value: Any) -> Column:
    if isinstance(value, E.Expression):
        return value
    return E.Literal(value)


def expr(sql_text: str) -> Column:
    """Parse a SQL expression string (reference: functions.expr)."""
    from spark_tpu_torch.sql.parser import parse_expression

    return parse_expression(sql_text)


# ---- window functions ------------------------------------------------------


def row_number() -> Column:
    return E.RowNumber()


def rank() -> Column:
    return E.Rank(dense=False)


def dense_rank() -> Column:
    return E.Rank(dense=True)


def ntile(n: int) -> Column:
    return E.NTile(n)


def lag(c: ColumnOrName, offset: int = 1, default: Any = None) -> Column:
    d = None if default is None else lit(default)
    return E.LagLead(_c(c), offset, d, lead=False)


def lead(c: ColumnOrName, offset: int = 1, default: Any = None) -> Column:
    d = None if default is None else lit(default)
    return E.LagLead(_c(c), offset, d, lead=True)


# ---- aggregates ------------------------------------------------------------


def sum(c: ColumnOrName) -> Column:  # noqa: A001
    return E.Sum(_c(c))


def avg(c: ColumnOrName) -> Column:
    return E.Avg(_c(c))


mean = avg


def count(c: ColumnOrName = "*") -> Column:
    if isinstance(c, str) and c == "*":
        return E.Count(None)
    return E.Count(_c(c))


def countDistinct(c: ColumnOrName) -> Column:
    return E.Count(_c(c), distinct=True)


count_distinct = countDistinct


def sumDistinct(c: ColumnOrName) -> Column:
    return E.Sum(_c(c), distinct=True)


sum_distinct = sumDistinct


def avgDistinct(c: ColumnOrName) -> Column:
    return E.Avg(_c(c), distinct=True)


avg_distinct = avgDistinct


def min(c: ColumnOrName) -> Column:  # noqa: A001
    return E.Min(_c(c))


def max(c: ColumnOrName) -> Column:  # noqa: A001
    return E.Max(_c(c))


def first(c: ColumnOrName, ignorenulls: bool = False) -> Column:
    return E.First(_c(c), ignorenulls)


def stddev(c: ColumnOrName) -> Column:
    return E.StddevVariance("stddev_samp", _c(c))


stddev_samp = stddev


def stddev_pop(c: ColumnOrName) -> Column:
    return E.StddevVariance("stddev_pop", _c(c))


def variance(c: ColumnOrName) -> Column:
    return E.StddevVariance("var_samp", _c(c))


var_samp = variance


def var_pop(c: ColumnOrName) -> Column:
    return E.StddevVariance("var_pop", _c(c))


def approx_count_distinct(c: ColumnOrName, rsd: float = 0.05) -> Column:
    """Distinct count, computed exactly (a valid estimator with rsd 0),
    as the reference does."""
    return E.Count(_c(c), distinct=True)


def percentile_approx(c: ColumnOrName, percentage: float,
                      accuracy: int = 10000) -> Column:
    """The element at the percentile, computed exactly (``accuracy`` is
    accepted and unused, as in the reference)."""
    return E.Percentile(_c(c), float(percentage), "percentile_approx")


approx_percentile = percentile_approx


def percentile(c: ColumnOrName, percentage: float) -> Column:
    return E.Percentile(_c(c), float(percentage), "percentile")


def median(c: ColumnOrName) -> Column:
    return E.Percentile(_c(c), 0.5, "median")


# ---- scalar ----------------------------------------------------------------


def abs(c: ColumnOrName) -> Column:  # noqa: A001
    return E.Abs(_c(c))


def coalesce(*cols: ColumnOrName) -> Column:
    return E.Coalesce(tuple(_c(c) for c in cols))


def isnull(c: ColumnOrName) -> Column:
    return E.IsNull(_c(c))


def isnotnull(c: ColumnOrName) -> Column:
    return E.Not(E.IsNull(_c(c)))


def when(condition: Column, value: Any) -> E.Case:
    """CASE builder; chain ``.when(...).otherwise(...)`` (a chain with
    no ``otherwise`` is NULL for unmatched rows)."""
    return E.Case(((condition, lit(value)),), None)


def floor(c: ColumnOrName) -> Column:
    return E.UnaryMath("floor", _c(c))


def ceil(c: ColumnOrName) -> Column:
    return E.UnaryMath("ceil", _c(c))


def sqrt(c: ColumnOrName) -> Column:
    return E.UnaryMath("sqrt", _c(c))


def exp(c: ColumnOrName) -> Column:
    return E.UnaryMath("exp", _c(c))


def log(c: ColumnOrName) -> Column:
    return E.UnaryMath("ln", _c(c))


ln = log


def log10(c: ColumnOrName) -> Column:
    return E.UnaryMath("log10", _c(c))


def signum(c: ColumnOrName) -> Column:
    return E.UnaryMath("sign", _c(c))


def round(c: ColumnOrName, scale: int = 0) -> Column:  # noqa: A001
    return E.Round(_c(c), scale)


def pow(a: ColumnOrName, b) -> Column:  # noqa: A001
    return E.Pow(_c(a), lit(b))


power = pow


def greatest(*cols: ColumnOrName) -> Column:
    """Largest non-null value (nulls are skipped, not propagated)."""
    return SF.greatest(*(_c(c) for c in cols))


def least(*cols: ColumnOrName) -> Column:
    return SF.least(*(_c(c) for c in cols))


def ifnull(a: ColumnOrName, b: ColumnOrName) -> Column:
    return SF.ifnull(_c(a), _c(b))


nvl = ifnull


def nvl2(a: ColumnOrName, b: ColumnOrName, c: ColumnOrName) -> Column:
    return SF.nvl2(_c(a), _c(b), _c(c))


def nullif(a: ColumnOrName, b: ColumnOrName) -> Column:
    return SF.nullif(_c(a), _c(b))


def negative(c: ColumnOrName) -> Column:
    return E.Neg(_c(c))


def positive(c: ColumnOrName) -> Column:
    return _c(c)


def log2(c: ColumnOrName) -> Column:
    return SF.log2(_c(c))


def degrees(c: ColumnOrName) -> Column:
    return SF.degrees(_c(c))


def radians(c: ColumnOrName) -> Column:
    return SF.radians(_c(c))


def pmod(a: ColumnOrName, b) -> Column:
    return SF.pmod(_c(a), b)


# ---- string ----------------------------------------------------------------


def substring(c: ColumnOrName, pos: int, length: int) -> Column:
    return E.Substring(_c(c), pos, length)


def startswith(c: ColumnOrName, prefix: str) -> Column:
    return E.StringPredicate("startswith", _c(c), prefix)


def endswith(c: ColumnOrName, suffix: str) -> Column:
    return E.StringPredicate("endswith", _c(c), suffix)


def contains(c: ColumnOrName, needle: str) -> Column:
    return E.StringPredicate("contains", _c(c), needle)


def like(c: ColumnOrName, pattern: str) -> Column:
    return E.Like(_c(c), pattern)


def upper(c: ColumnOrName) -> Column:
    return E.StringTransform("upper", _c(c))


def lower(c: ColumnOrName) -> Column:
    return E.StringTransform("lower", _c(c))


def trim(c: ColumnOrName) -> Column:
    return E.StringTransform("trim", _c(c))


def ltrim(c: ColumnOrName) -> Column:
    return E.StringTransform("ltrim", _c(c))


def rtrim(c: ColumnOrName) -> Column:
    return E.StringTransform("rtrim", _c(c))


def initcap(c: ColumnOrName) -> Column:
    return SF.initcap(_c(c))


def reverse(c: ColumnOrName) -> Column:
    return SF.reverse(_c(c))


def repeat(c: ColumnOrName, n: int) -> Column:
    return E.StringTransform("repeat", _c(c), (int(n),))


def lpad(c: ColumnOrName, length: int, pad: str = " ") -> Column:
    return E.StringTransform("lpad", _c(c), (int(length), str(pad)))


def rpad(c: ColumnOrName, length: int, pad: str = " ") -> Column:
    return E.StringTransform("rpad", _c(c), (int(length), str(pad)))


def translate(c: ColumnOrName, matching: str, replace: str) -> Column:
    return E.StringTransform("translate", _c(c), (matching, replace))


def length(c: ColumnOrName) -> Column:
    return E.StrLength(_c(c))


def regexp_extract(c: ColumnOrName, pattern: str, idx: int = 1) -> Column:
    return E.RegexpExtract(_c(c), pattern, idx)


def regexp_replace(c: ColumnOrName, pattern: str,
                   replacement: str) -> Column:
    return E.RegexpReplace(_c(c), pattern, replacement)


def replace(c: ColumnOrName, find: str, replacement: str) -> Column:
    """Literal substring replacement (reference: StringReplace): the
    pattern is escaped, and so is the one character a replacement
    template reads specially, the backslash."""
    return E.RegexpReplace(_c(c), re.escape(str(find)),
                           str(replacement).replace("\\", "\\\\"))


def rlike(c: ColumnOrName, pattern: str) -> Column:
    return E.RegexpLike(_c(c), pattern)


def concat(*cols: ColumnOrName) -> Column:
    return E.Concat(tuple(_c(c) for c in cols))


def concat_ws(sep: str, *cols: ColumnOrName) -> Column:
    return SF.concat_ws(sep, *(_c(c) for c in cols))


# ---- temporal --------------------------------------------------------------


def year(c: ColumnOrName) -> Column:
    return E.ExtractDatePart("year", _c(c))


def month(c: ColumnOrName) -> Column:
    return E.ExtractDatePart("month", _c(c))


def dayofmonth(c: ColumnOrName) -> Column:
    return E.ExtractDatePart("day", _c(c))


def add_months(c: ColumnOrName, months: int) -> Column:
    return E.AddMonths(_c(c), months)


def date_add(c: ColumnOrName, days: int) -> Column:
    return E.Arith("+", _c(c), E.Literal(days))


def date_sub(c: ColumnOrName, days: int) -> Column:
    return E.Arith("-", _c(c), E.Literal(days))


def datediff(end: ColumnOrName, start: ColumnOrName) -> Column:
    return E.Arith("-", _c(end), _c(start))


def to_date(c: ColumnOrName) -> Column:
    return E.Cast(_c(c), T.DATE)


def date_trunc(unit: str, c: ColumnOrName) -> Column:
    return E.DateTrunc(unit.lower(), _c(c))


def last_day(c: ColumnOrName) -> Column:
    return E.LastDay(_c(c))


def quarter(c: ColumnOrName) -> Column:
    return SF.quarter(_c(c))


def dayofweek(c: ColumnOrName) -> Column:
    """1 = Sunday .. 7 = Saturday."""
    return SF.dayofweek(_c(c))


def weekday(c: ColumnOrName) -> Column:
    """0 = Monday .. 6 = Sunday."""
    return SF.weekday(_c(c))


def dayofyear(c: ColumnOrName) -> Column:
    return SF.dayofyear(_c(c))


def months_between(end: ColumnOrName, start: ColumnOrName) -> Column:
    return SF.months_between(_c(end), _c(start))


def current_date() -> Column:
    return SF.current_date()


def hour(c: ColumnOrName) -> Column:
    return SF.hour(_c(c))


def minute(c: ColumnOrName) -> Column:
    return SF.minute(_c(c))


def second(c: ColumnOrName) -> Column:
    return SF.second(_c(c))


# ---- ordering --------------------------------------------------------------


def asc(c: ColumnOrName) -> Column:
    return E.SortOrder(_c(c), ascending=True)


def desc(c: ColumnOrName) -> Column:
    return E.SortOrder(_c(c), ascending=False)


def asc_nulls_last(c: ColumnOrName) -> Column:
    return E.SortOrder(_c(c), ascending=True, nulls_first=False)


def desc_nulls_first(c: ColumnOrName) -> Column:
    return E.SortOrder(_c(c), ascending=False, nulls_first=True)


# ---- arrays, maps, higher-order functions, collect and explode -------------
# (reference: collectionOperations.scala, complexTypeCreator.scala,
# higherOrderFunctions.scala, aggregate/collect.scala, generators.scala)


def array(*cols: ColumnOrName) -> Column:
    return SF.array(*(_c(c) for c in cols))


def split(c: ColumnOrName, delim: str) -> Column:
    return E.Split(_c(c), str(delim))


def size(c: ColumnOrName) -> Column:
    return SF.size(_c(c))


def element_at(c: ColumnOrName, index) -> Column:
    return SF.element_at(_c(c), index)


def array_contains(c: ColumnOrName, value) -> Column:
    return SF.array_contains(_c(c), value)


def create_map(*cols) -> Column:
    """map(k1, v1, k2, v2, ...), legal at the top of a projection."""
    return SF.create_map(*(_c(c) for c in cols))


def map_from_arrays(keys: ColumnOrName, vals: ColumnOrName) -> Column:
    return SF.map_from_arrays(_c(keys), _c(vals))


def map_keys(c: ColumnOrName) -> Column:
    return SF.map_keys(_c(c))


def map_values(c: ColumnOrName) -> Column:
    return SF.map_values(_c(c))


def map_contains_key(c: ColumnOrName, key) -> Column:
    return SF.map_contains_key(_c(c), key)


def _lambda(fn) -> E.Lambda:
    """A Python callable as a Lambda: its parameter names become the bound
    variables (pyspark's shape)."""
    import inspect

    params = tuple(inspect.signature(fn).parameters)
    return E.Lambda(params, _c(fn(*[E.Col(p) for p in params])))


def transform(c: ColumnOrName, fn) -> Column:
    """transform(array, x -> ...) or (x, i) -> ... (ArrayTransform)."""
    return E.HigherOrder("transform", _c(c), _lambda(fn))


def filter(c: ColumnOrName, fn) -> Column:  # noqa: A001
    return E.HigherOrder("filter", _c(c), _lambda(fn))


def exists(c: ColumnOrName, fn) -> Column:
    return E.HigherOrder("exists", _c(c), _lambda(fn))


def forall(c: ColumnOrName, fn) -> Column:
    return E.HigherOrder("forall", _c(c), _lambda(fn))


def aggregate(c: ColumnOrName, zero, merge, finish=None) -> Column:
    """aggregate(array, zero, (acc, x) -> ..., [acc -> ...])."""
    return E.HigherOrder("aggregate", _c(c), _lambda(merge), lit(zero),
                         None if finish is None else _lambda(finish))


def collect_list(c: ColumnOrName) -> Column:
    return E.Collect(_c(c))


def collect_set(c: ColumnOrName) -> Column:
    return E.Collect(_c(c), unique=True)


array_agg = collect_list


def explode(c: ColumnOrName) -> Column:
    return SF.explode(_c(c))


def posexplode(c: ColumnOrName) -> Column:
    return SF.posexplode(_c(c))


def window(c: ColumnOrName, width: int) -> Column:
    """Tumbling event-time window of ``width`` time units; the column is
    the window start (reference: functions.window)."""
    return E.TumblingWindow(_c(c), int(width))


def session_window(c: ColumnOrName, gap: int) -> Column:
    """Gap-based session window, grouped by a streaming aggregation; the
    column is the merged session's start (reference:
    functions.session_window, MergingSessionsExec)."""
    return E.SessionWindow(_c(c), int(gap))
