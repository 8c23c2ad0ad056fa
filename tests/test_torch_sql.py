"""The port's SQL slice end to end on the CPU: TPC-H q1 and the q1-wide
aggregate (four dictionary keys, K = 168 packed groups, so counts, int64
sums and float32 min/max take the kernel path) through
``spark_tpu.api.session.SparkSession`` and through
``spark_tpu_torch``'s session with ``device("cpu")``, on the same tables
(TPC-H at sf 0.02, seed 99, as tests/test_tpch.py).

Rows must be equal: exact for ints, decimals, strings and float32
min/max. q1 is also checked against the sqlite oracle (rel 1e-6, the
oracle's own bound).
"""

import pytest

from spark_tpu.tpch.gen import generate_tables
from spark_tpu.tpch.gen import register_views as ref_register_views
from spark_tpu_torch.api.session import SparkSession as PortSession
from spark_tpu_torch.ops import seg_agg
from spark_tpu_torch.tpch import Q1_WIDE, QUERIES
from spark_tpu_torch.tpch import register_views as port_register_views
from spark_tpu_torch.tpch.oracle import (assert_rows_match, load_sqlite,
                                         run_oracle)

SF = 0.02
SEED = 99


@pytest.fixture(scope="module")
def engines(spark):
    tables = generate_tables(SF, seed=SEED)
    ref_register_views(spark, tables)
    port = PortSession.builder.device("cpu").getOrCreate()
    port_register_views(port, tables)
    return spark, port, tables


def _rows(df):
    return [tuple(r) for r in df.collect()]


@pytest.mark.parametrize("name", ["q1", "q1_wide"])
def test_slice_matches_reference(engines, name, monkeypatch):
    spark, port, _ = engines
    query = QUERIES[1] if name == "q1" else Q1_WIDE
    calls = []
    real_sum, real_mm = seg_agg.seg_sum, seg_agg.seg_minmax

    def spy_sum(data, *a, exact_int=False, **kw):
        calls.append("count" if exact_int else f"sum[{data.dtype}]")
        return real_sum(data, *a, exact_int=exact_int, **kw)

    monkeypatch.setattr(seg_agg, "seg_sum", spy_sum)
    monkeypatch.setattr(seg_agg, "seg_minmax", lambda *a, **kw: (
        calls.append("seg_minmax"), real_mm(*a, **kw))[1])
    got = _rows(port.sql(query))
    want = _rows(spark.sql(query))
    assert want and got == want
    if name == "q1_wide":
        # 7 counts (count(*), four any-valid tests and avg's count, and
        # the group-present test), the two exact decimal sums (sum and
        # avg of decimals) and one min, one max
        assert calls.count("count") == 7
        assert calls.count("sum[torch.int64]") == 2
        assert calls.count("seg_minmax") == 2
        assert len(calls) == 11
        assert len(got) == len({r[:4] for r in got})
    else:
        assert calls == []  # K = 6: masked reductions


def test_q1_matches_sqlite_oracle(engines):
    _, port, tables = engines
    conn = load_sqlite({"lineitem": tables["lineitem"]})
    want = run_oracle(conn, QUERIES[1])
    assert_rows_match(_rows(port.sql(QUERIES[1])), want, label="q1[port]")


def test_decimal_to_float_cast_keeps_reference_quirk(engines):
    """CAST(decimal AS float) yields the unscaled integer in the
    reference; the port reproduces it rather than fixing it."""
    spark, port, _ = engines
    q = ("select l_orderkey, l_linenumber, l_extendedprice, "
         "cast(l_extendedprice as float) as f, "
         "cast(l_discount as double) as d from lineitem "
         "where l_orderkey < 40 order by l_orderkey, l_linenumber")
    got, want = _rows(port.sql(q)), _rows(spark.sql(q))
    assert got == want
    price, f = got[0][2], got[0][3]
    assert f == float(price.scaleb(2))  # 59655.18 -> 5965518.0


@pytest.mark.parametrize("query", [
    "select l_shipmode, count(*) as n, min(l_tax) as t from lineitem "
    "where l_shipmode <> 'AIR' and (l_quantity > 10 or l_tax < 0.02) "
    "group by l_shipmode order by n desc, l_shipmode",
    "select l_linenumber, sum(l_quantity) as q, max(l_shipdate) as d "
    "from lineitem where l_shipdate between date '1995-01-01' and "
    "date '1995-03-31' group by l_linenumber order by l_linenumber",
    "select l_returnflag, l_extendedprice * (1 - l_discount) as dp, "
    "l_quantity / 3 as q3, l_linenumber % 3 as m, -l_tax as nt "
    "from lineitem where l_orderkey < 30 "
    "order by dp desc, l_returnflag limit 7",
    "select distinct l_shipmode, l_returnflag from lineitem "
    "where not (l_linestatus = 'F') order by l_shipmode desc, "
    "l_returnflag",
])
def test_sql_shapes_match_reference(engines, query):
    """Filters with Kleene logic, the sorted aggregate path (integer key),
    decimal arithmetic, date ranges, ORDER BY with LIMIT, DISTINCT."""
    spark, port, _ = engines
    got, want = _rows(port.sql(query)), _rows(spark.sql(query))
    assert want and got == want


@pytest.mark.parametrize("query", [
    "select l_orderkey from lineitem, orders where l_orderkey = o_orderkey",
    "select l_orderkey from lineitem join orders on l_orderkey = o_orderkey",
    "select l_orderkey from lineitem where l_orderkey in "
    "(select o_orderkey from orders)",
    "select l_returnflag, count(*) as n from lineitem "
    "group by l_returnflag having count(*) > 1",
    "select count(distinct l_returnflag) as n from lineitem",
    "select l_returnflag from lineitem union select l_linestatus "
    "from lineitem",
])
def test_unported_sql_raises(engines, query):
    """Joins, subqueries, HAVING, DISTINCT aggregates and set operations
    are refused instead of being run wrongly."""
    _, port, _ = engines
    with pytest.raises(NotImplementedError, match="not ported"):
        port.sql(query).collect()
