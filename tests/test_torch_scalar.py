"""The scalar-function slice through the port on the CPU: every string,
math, date and timestamp function and the stddev/variance and percentile
aggregates, through ``spark.sql`` on the port (``device("cpu")``) and on
the reference, over the same small table (the inputs of
tests/test_expression_breadth.py and tests/test_expressions.py, with
NULLs, non-ASCII strings, a decimal(12,2) column and timestamps added).

Rows must be equal: exactly for ints, decimals, strings, dates and
booleans; floats within rel 1e-12 (NaN equal to NaN). Timestamps are
read in the host's local timezone, as the reference reads them, so the
module pins ``TZ`` to UTC. Where the reference is at fault (ROADMAP C,
decided: decimal math reads the unscaled integer; percentile(x, 0.5) and
median(x) share a name), the port is held against values computed here.
The string transforms are also held against Python's ``str`` methods
over a dictionary of 3,000 non-ASCII entries, since the port runs
substring and length as pyarrow kernels and dedupes, sorts and remaps
every transformed dictionary in pyarrow.
"""

import datetime
import decimal
import math
import os
import statistics
import time

import numpy as np
import pyarrow as pa
import pytest

from spark_tpu_torch.api.session import SparkSession as PortSession
from spark_tpu_torch.expr import compiler as PC

D = decimal.Decimal
TS = datetime.datetime

ROWS = [
    # id, s, u, x, n, g, m, d, t
    (0, "  Hello ", "x", 2.567, 4, 1, "1.25", "1995-03-17",
     TS(2001, 7, 4, 13, 45, 30)),
    (1, "WORLD", "y", -3.21, 9, 1, "2.50", "1996-12-01",
     TS(2001, 7, 4, 23, 59, 59)),
    (2, "claude v5", None, 0.5, 16, 2, "3.75", "2000-02-29",
     TS(1969, 12, 31, 23, 0, 1)),
    (3, None, "z", None, None, 2, "4.10", None, None),
    (4, "straße", "w", 1e10, 0, 3, "-5.55", "1970-01-01",
     TS(2001, 7, 5, 0, 0, 0)),
    (5, "İstanbul", "x", -0.0, -3, 3, None, "2024-12-31",
     TS(2020, 2, 29, 6, 30, 15)),
    (6, "\x1c tab　", "v", 2.5, 1285, 1, "0.05", "1999-01-31",
     TS(1995, 1, 1, 0, 0, 0)),
    (7, "ǆemal", "y", -2.5, 1234, 2, "-0.05", "1996-10-30",
     TS(2001, 7, 4, 12, 0, 0)),
]
COLS = ("id", "s", "u", "x", "n", "g", "m", "d", "t")


def _table() -> pa.Table:
    cols = list(zip(*ROWS))
    return pa.table({
        "id": pa.array(cols[0], pa.int64()),
        "s": pa.array(cols[1], pa.string()),
        "u": pa.array(cols[2], pa.string()),
        "x": pa.array(cols[3], pa.float64()),
        "n": pa.array(cols[4], pa.int64()),
        "g": pa.array(cols[5], pa.int64()),
        "m": pa.array([None if v is None else D(v) for v in cols[6]],
                      pa.decimal128(12, 2)),
        "d": pa.array([None if v is None else datetime.date.fromisoformat(v)
                       for v in cols[7]], pa.date32()),
        "t": pa.array(cols[8], pa.timestamp("us")),
    })


@pytest.fixture(scope="module")
def engines(spark):
    old = os.environ.get("TZ")
    os.environ["TZ"] = "UTC"
    time.tzset()
    table = _table()
    spark.createDataFrame(table).createOrReplaceTempView("sx")
    port = PortSession.builder.device("cpu").getOrCreate()
    port.createDataFrame(table).createOrReplaceTempView("sx")
    yield spark, port
    if old is None:
        del os.environ["TZ"]
    else:
        os.environ["TZ"] = old
    time.tzset()


def _rows(df):
    return [tuple(r) for r in df.collect()]


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        if math.isinf(a) or math.isinf(b):
            return a == b
        return abs(a - b) <= 1e-12 * max(abs(a), abs(b), 1e-300)
    return type(a) is type(b) and a == b or a is b


def assert_rows_equal(got, want):
    assert len(got) == len(want), (got, want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w) and all(map(_same, g, w)), (i, g, w)


PROJECTIONS = {
    "case": "upper(s), lower(s), initcap(s), reverse(s)",
    "trim": "trim(s), ltrim(s), rtrim(s), length(s), char_length(u)",
    # aliased: the reference names lpad(s, 6, 'xy') and lpad(s, -1, 'x')
    # alike and keeps one (the port names each by its arguments)
    "pad": "lpad(s, 6, 'xy') as l6, rpad(s, 6, 'xy') as r6, "
           "lpad(s, -1, 'x') as l0, rpad(u, 3) as r3, repeat(s, 2) as r2",
    # aliased: the reference names both replaces REGEXP_REPLACE(s, 'l')
    "translate": "translate(s, 'lo', 'L') as tr, "
                 "replace(s, 'l', '\\1') as r1, replace(s, 'l', '') as r0",
    "regexp": "regexp_extract(s, '([a-z]+) v([0-9]+)', 2), "
              "regexp_replace(s, '[aeiou]', '_'), "
              "regexp_like(s, '^[A-Z]+$'), regexp_extract(s, 'l+', 0)",
    "substr": "substr(s, 2, 3), substr(s, 2), substr(s, -3, 2), "
              "substring(s from 1 for 2)",
    "concat": "s || '-' || u, concat(s, u), concat_ws('-', s, u, s)",
    "math_float": "abs(x), floor(x), ceil(x), sign(x), round(x), "
                  "round(x, 1), round(x, -1)",
    "math_float2": "sqrt(x), exp(x), ln(x), log10(x), power(x, 2), "
                   "log2(x), degrees(x), radians(x)",
    "math_int": "abs(n), floor(n), ceiling(n), round(n, -2), sign(n), "
                "power(n, 3), pmod(n, 4), sqrt(n)",
    "conditional": "greatest(n, 7), least(x, 0.0), ifnull(n, -1), "
                   "nvl(s, 'none'), nvl2(n, 100, 200), nullif(n, 4), "
                   "nullif(s, 'WORLD')",
    "dates": "date_trunc('month', d), date_trunc('year', d), last_day(d), "
             "date_add(d, 30), date_sub(d, 3), add_months(d, 1)",
    "date_parts": "quarter(d), dayofweek(d), weekday(d), dayofyear(d), "
                  "months_between(d, date '1996-10-30')",
    "timestamps": "hour(t), minute(t), second(t), "
                  "t >= timestamp '2001-07-04 12:00:00', "
                  "t < '2001-07-05 00:00:00', t = '2001-07-04 13:45:30'",
}


@pytest.mark.parametrize("name", sorted(PROJECTIONS))
def test_functions_match_reference(engines, name):
    spark, port = engines
    q = f"select id, {PROJECTIONS[name]} from sx order by id"
    got = _rows(port.sql(q))
    assert len(got) == len(ROWS)
    assert_rows_equal(got, _rows(spark.sql(q)))


def test_timestamp_filter_matches_reference(engines):
    """A TIMESTAMP literal and a timestamp string in one predicate."""
    spark, port = engines
    q = ("select id from sx where t between timestamp '2001-01-01 "
         "00:00:00' and '2001-07-04 23:59:59' order by id")
    got = _rows(port.sql(q))
    assert got == [(0,), (1,), (7,)] and got == _rows(spark.sql(q))


AGGREGATES = {
    "stddev": "select g, stddev(x), stddev_pop(x), var_samp(n), "
              "var_pop(n), variance(x), count(*) from sx group by g "
              "order by g",
    "percentile": "select g, percentile(n, 0.25), percentile_approx(x, "
                  "0.5), approx_percentile(n, 0.9, 100), median(x), "
                  "approx_count_distinct(s) from sx group by g order by g",
    "global": "select stddev_samp(x), median(n), percentile(x, 0.75), "
              "percentile_approx(s, 0.5), var_pop(x) from sx",
}


@pytest.mark.parametrize("name", sorted(AGGREGATES))
def test_aggregates_match_reference(engines, name):
    """stddev/variance (float sums: index_add_ on the CPU, as the
    reference's segment_sum), exact percentiles and approx_count_distinct
    over ints, floats and strings, grouped and global."""
    spark, port = engines
    got = _rows(port.sql(AGGREGATES[name]))
    assert got
    assert_rows_equal(got, _rows(spark.sql(AGGREGATES[name])))


def _decimals():
    return [(r[0], D(r[6])) for r in ROWS if r[6] is not None]


def test_decimal_round_floor_ceil_sign_are_exact(engines):
    """ROADMAP C, decided: the reference reads a decimal's unscaled
    integer (round(1.25, 1) gives 125.0). The port rounds HALF_UP in
    scaled int64 to Spark's decimal type, floors and ceils by 10^scale,
    and keeps sign in the decimal's type."""
    _, port = engines
    got = _rows(port.sql(
        "select id, round(m, 1), round(m, 0), round(m, -1), floor(m), "
        "ceil(m), sign(m), abs(m) from sx where m is not null order by id"))
    want = []
    for i, m in _decimals():
        def half_up(q):
            return m.quantize(D(q), rounding=decimal.ROUND_HALF_UP)
        tens = (m / 10).quantize(D(1), rounding=decimal.ROUND_HALF_UP) * 10
        want.append((i, half_up("0.1"), half_up("1"), D(int(tens)),
                     math.floor(m), math.ceil(m),
                     D(0 if m == 0 else (1 if m > 0 else -1)).quantize(
                         D("0.01")), abs(m)))
    assert got == want
    assert [str(r[1]) for r in got][:2] == ["1.3", "2.5"]


def test_decimal_math_reads_the_value(engines):
    """sqrt, exp, ln, log10 and power of a decimal compute on its value
    (the reference: sqrt(1.25) gives 11.18, power(1.25, 2) 15625.0)."""
    _, port = engines
    got = _rows(port.sql(
        "select id, sqrt(m), exp(m), ln(m), log10(m), power(m, 2) from sx "
        "where m is not null order by id"))
    want = []
    for i, m in _decimals():
        f = float(m)
        ln = math.log(f) if f > 0 else (float("nan") if f < 0
                                        else float("-inf"))
        lg = math.log10(f) if f > 0 else ln
        want.append((i, math.sqrt(f) if f >= 0 else float("nan"),
                     math.exp(f), ln, lg, f ** 2))
    assert_rows_equal(got, want)


def test_decimal_stddev_variance_read_the_value(engines):
    """stddev/variance of a decimal on its value (the reference: 394.23
    where the answer is 3.9423)."""
    _, port = engines
    got = _rows(port.sql("select stddev(m), stddev_pop(m), var_samp(m), "
                         "var_pop(m) from sx"))
    vals = [float(m) for _, m in _decimals()]
    want = [(statistics.stdev(vals), statistics.pstdev(vals),
             statistics.variance(vals), statistics.pvariance(vals))]
    assert len(got) == 1
    for g, w in zip(got[0], want[0]):
        assert abs(g - w) <= 1e-12 * sum(v * v for v in vals)


def test_string_transforms_named_by_arguments(engines):
    """lpad(s, 6) and lpad(s, 3) are two columns, and so are two replaces
    of one needle (the reference names each pair alike and keeps one)."""
    _, port = engines
    df = port.sql("select lpad(s, 6), lpad(s, 3), replace(s, 'l', 'L'), "
                  "replace(s, 'l', '') from sx order by id")
    assert len(set(df.columns)) == 4
    assert _rows(df)[0] == ("  Hell", "  H", "  HeLLo ", "  Heo ")


def test_percentile_and_median_keep_both_columns(engines):
    """ROADMAP C, decided: the reference names percentile(x, 0.5) and
    median(x) alike and returns two columns for three."""
    _, port = engines
    df = port.sql("select percentile(n, 0.5), percentile_approx(n, 0.5), "
                  "median(n) from sx")
    assert len(set(df.columns)) == 3
    vals = sorted(r[4] for r in ROWS if r[4] is not None)
    assert _rows(df) == [(statistics.median(vals), vals[3],
                          statistics.median(vals))]


ALPHABET = list("aZ \tßİǆﬃ　\x1ćé-_.1") + [
    "\U0001f600"]


@pytest.fixture(scope="module")
def wide_dictionary():
    """3,000 distinct strings over an alphabet with non-ASCII letters whose
    case mapping changes length, Unicode whitespace, combining marks and
    an emoji."""
    rng = np.random.default_rng(11)
    out = set()
    while len(out) < 3000:
        k = int(rng.integers(0, 9))
        out.add("".join(ALPHABET[j] for j in rng.integers(0, len(ALPHABET),
                                                          k)))
    return sorted(out)


def test_string_transforms_equal_python_str(wide_dictionary):
    port = PortSession.builder.device("cpu").getOrCreate()
    port.createDataFrame(pa.table({"s": pa.array(wide_dictionary)})) \
        .createOrReplaceTempView("wide")
    got = _rows(port.sql(
        "select s, upper(s), lower(s), trim(s), ltrim(s), rtrim(s), "
        "length(s), substr(s, 2, 3), initcap(s), lpad(s, 4, 'ß') "
        "from wide"))
    assert len(got) == 3000
    for s, *vals in got:
        want = [s.upper(), s.lower(), s.strip(), s.lstrip(), s.rstrip(),
                len(s), s[1:4], s.title(), PC._pad(s, 4, "ß", True)]
        assert vals == want, s


def test_concat_dictionary_product_is_bounded():
    """Concatenation builds the product of the input dictionaries, at
    most 2^20 entries, as the reference."""
    port = PortSession.builder.device("cpu").getOrCreate()
    words = [f"w{i:04d}" for i in range(1100)]
    port.createDataFrame(pa.table({"a": pa.array(words),
                                   "b": pa.array(words[::-1])})) \
        .createOrReplaceTempView("wide_pair")
    with pytest.raises(NotImplementedError, match="too large"):
        port.sql("select a || b from wide_pair").collect()
    got = _rows(port.sql("select concat_ws('/', a, 'x') from wide_pair "
                         "where a < 'w0003'"))
    assert got == [("w0000/x",), ("w0001/x",), ("w0002/x",)]
