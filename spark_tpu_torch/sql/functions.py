"""SQL functions that the parser builds out of other expression nodes, with
no node of their own (reference: ``spark_tpu/sql/parser.py``
``_composed_functions``, whose entries come from
``spark_tpu/api/functions.py``; catalyst's FunctionRegistry entries that
expand to existing expressions). Each builder takes and returns
expression nodes; the Column DSL of the reference's ``api/functions.py``
is not ported here.
"""

from __future__ import annotations

import datetime
import math

from spark_tpu_torch import types as T
from spark_tpu_torch.expr import expressions as E


def _lit(x) -> E.Expression:
    return x if isinstance(x, E.Expression) else E.Literal(x)


def greatest(*cols: E.Expression) -> E.Expression:
    """Largest non-null value (reference: conditionalExpressions.scala
    Greatest: nulls are skipped, not propagated)."""
    out = cols[0]
    for b in cols[1:]:
        out = E.Case(((E.IsNull(out), b),
                      (E.Or(E.IsNull(b), E.Cmp(">=", out, b)), out)), b)
    return out


def least(*cols: E.Expression) -> E.Expression:
    out = cols[0]
    for b in cols[1:]:
        out = E.Case(((E.IsNull(out), b),
                      (E.Or(E.IsNull(b), E.Cmp("<=", out, b)), out)), b)
    return out


def ifnull(a: E.Expression, b: E.Expression) -> E.Expression:
    return E.Coalesce((a, b))


def nvl2(a: E.Expression, b: E.Expression, c: E.Expression) -> E.Expression:
    return E.Case(((E.Not(E.IsNull(a)), b),), c)


def nullif(a: E.Expression, b: E.Expression) -> E.Expression:
    return E.Case(((E.Cmp("==", a, b), E.NullOf(a)),), a)


def log2(c: E.Expression) -> E.Expression:
    return E.Arith("/", E.UnaryMath("ln", c), E.Literal(math.log(2.0)))


def degrees(c: E.Expression) -> E.Expression:
    return E.Arith("*", c, E.Literal(180.0 / math.pi))


def radians(c: E.Expression) -> E.Expression:
    return E.Arith("*", c, E.Literal(math.pi / 180.0))


def pmod(a: E.Expression, b) -> E.Expression:
    bb = _lit(b)
    inner = E.Arith("%", a, bb)
    return E.Arith("%", E.Arith("+", inner, bb), bb)


def quarter(c: E.Expression) -> E.Expression:
    m = E.ExtractDatePart("month", c)
    return E.UnaryMath("floor", E.Arith(
        "/", E.Arith("+", m, E.Literal(2)), E.Literal(3)))


def dayofweek(c: E.Expression) -> E.Expression:
    """1 = Sunday .. 7 = Saturday (reference: datetimeExpressions.scala
    DayOfWeek). 1970-01-01 (day 0) was a Thursday = 5."""
    days = E.Cast(c, T.INT64)
    return E.Arith("+", E.Arith("%", E.Arith("+", days, E.Literal(4)),
                                E.Literal(7)), E.Literal(1))


def weekday(c: E.Expression) -> E.Expression:
    """0 = Monday .. 6 = Sunday."""
    days = E.Cast(c, T.INT64)
    return E.Arith("%", E.Arith("+", days, E.Literal(3)), E.Literal(7))


def dayofyear(c: E.Expression) -> E.Expression:
    return E.Arith("+", E.Arith(
        "-", E.Cast(c, T.INT64),
        E.Cast(E.DateTrunc("year", c), T.INT64)), E.Literal(1))


def months_between(a: E.Expression, b: E.Expression) -> E.Expression:
    """Fractional months (reference: datetimeExpressions.scala
    MonthsBetween): whole months when both dates are the same day of the
    month or both month ends, else plus (day1 - day2) / 31."""
    def months(x):
        return E.Arith("+", E.Arith("*", E.ExtractDatePart("year", x),
                                    E.Literal(12)),
                       E.ExtractDatePart("month", x))

    whole = E.Arith("-", months(a), months(b))
    da = E.ExtractDatePart("day", a)
    db = E.ExtractDatePart("day", b)
    both_end = E.And(E.Cmp("==", a, E.LastDay(a)),
                     E.Cmp("==", b, E.LastDay(b)))
    frac = E.Arith("/", E.Cast(E.Arith("-", da, db), T.FLOAT64),
                   E.Literal(31.0))
    return E.Case(((E.Or(E.Cmp("==", da, db), both_end),
                    E.Cast(whole, T.FLOAT64)),),
                  E.Arith("+", E.Cast(whole, T.FLOAT64), frac))


def current_date() -> E.Expression:
    return E.Literal(datetime.date.today())


_DAY_US = 86_400_000_000


def _micros_of_day(c: E.Expression) -> E.Expression:
    day = E.Literal(_DAY_US)
    return pmod(E.Arith("%", E.Cast(c, T.INT64), day), day)


def hour(c: E.Expression) -> E.Expression:
    return E.UnaryMath("floor", E.Arith(
        "/", _micros_of_day(c), E.Literal(3_600_000_000)))


def minute(c: E.Expression) -> E.Expression:
    return E.Arith("%", E.UnaryMath("floor", E.Arith(
        "/", _micros_of_day(c), E.Literal(60_000_000))), E.Literal(60))


def second(c: E.Expression) -> E.Expression:
    return E.Arith("%", E.UnaryMath("floor", E.Arith(
        "/", _micros_of_day(c), E.Literal(1_000_000))), E.Literal(60))


def initcap(c: E.Expression) -> E.Expression:
    return E.StringTransform("initcap", c)


def reverse(c: E.Expression) -> E.Expression:
    return E.StringTransform("reverse", c)


def concat_ws(sep: str, *cols: E.Expression) -> E.Expression:
    return E.ConcatWs(str(sep), tuple(cols))


#: SQL name -> builder, the reference's ``_composed_functions`` less the
#: array and map builders (ROADMAP A2) and the grouping markers, which the
#: parser builds itself
COMPOSED_FUNCTIONS = {
    "GREATEST": greatest, "LEAST": least,
    "IFNULL": ifnull, "NVL": ifnull, "NVL2": nvl2,
    "LOG2": log2, "DEGREES": degrees, "RADIANS": radians, "PMOD": pmod,
    "QUARTER": quarter, "DAYOFWEEK": dayofweek, "WEEKDAY": weekday,
    "DAYOFYEAR": dayofyear, "MONTHS_BETWEEN": months_between,
    "CURRENT_DATE": current_date,
    "HOUR": hour, "MINUTE": minute, "SECOND": second,
    "INITCAP": initcap, "REVERSE": reverse,
}
