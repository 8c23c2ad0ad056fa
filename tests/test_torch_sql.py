"""The port's SQL slices end to end on the CPU: TPC-H q1, the q1-wide
aggregate (four dictionary keys, K = 168 packed groups, so counts, int64
sums and float32 min/max take the kernel path), and the join queries q3
and q5, through ``spark_tpu.api.session.SparkSession`` and through
``spark_tpu_torch``'s session with ``device("cpu")``, on the same tables
(TPC-H at sf 0.02, seed 99, as tests/test_tpch.py).

Rows must be equal: exact for ints, decimals, dates, strings and float32
min/max. q1, q3 and q5 are also checked against the sqlite oracle (rel
1e-6, the oracle's own bound), and q3's and q5's optimized join order
against the reference's.
"""

import pytest

from spark_tpu.plan import logical as RL
from spark_tpu.plan.optimizer import optimize as ref_optimize
from spark_tpu.sql.parser import parse_sql as ref_parse_sql
from spark_tpu.tpch.gen import generate_tables
from spark_tpu.tpch.gen import register_views as ref_register_views
from spark_tpu_torch.api.session import SparkSession as PortSession
from spark_tpu_torch.ops import seg_agg
from spark_tpu_torch.plan import logical as PL
from spark_tpu_torch.plan.optimizer import optimize as port_optimize
from spark_tpu_torch.sql.parser import parse_sql as port_parse_sql
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


def _spy_kernels(monkeypatch) -> list:
    """Record every call of the seg_agg kernel wrappers."""
    calls = []
    real_sum, real_mm = seg_agg.seg_sum, seg_agg.seg_minmax

    def spy_sum(data, *a, exact_int=False, **kw):
        calls.append("count" if exact_int else f"sum[{data.dtype}]")
        return real_sum(data, *a, exact_int=exact_int, **kw)

    monkeypatch.setattr(seg_agg, "seg_sum", spy_sum)
    monkeypatch.setattr(seg_agg, "seg_minmax", lambda *a, **kw: (
        calls.append("seg_minmax"), real_mm(*a, **kw))[1])
    return calls


@pytest.mark.parametrize("name", ["q1", "q1_wide"])
def test_slice_matches_reference(engines, name, monkeypatch):
    spark, port, _ = engines
    query = QUERIES[1] if name == "q1" else Q1_WIDE
    calls = _spy_kernels(monkeypatch)
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


@pytest.mark.parametrize("qnum", [3, 5])
def test_join_queries_match_reference_and_oracle(engines, qnum,
                                                 monkeypatch):
    """q3 (3 relations, sorted aggregate over an int64 key, top 10) and
    q5 (six relations, a two-key join, a year interval): the same rows
    as the reference and the oracle. Neither reaches a kernel: q3's
    aggregate is sorted, q5's has K = 26 (masked), and inner joins count
    no matches."""
    spark, port, tables = engines
    calls = _spy_kernels(monkeypatch)
    got = _rows(port.sql(QUERIES[qnum]))
    assert calls == []
    want = _rows(spark.sql(QUERIES[qnum]))
    assert want and got == want
    names = {3: ("customer", "orders", "lineitem"),
             5: ("customer", "orders", "lineitem", "supplier", "nation",
                 "region")}[qnum]
    conn = load_sqlite({n: tables[n] for n in names})
    assert_rows_match(got, run_oracle(conn, QUERIES[qnum]),
                      label=f"q{qnum}[port]")


def _join_keys(plan, L) -> list:
    """The optimized plan's joins, top-down, as (how, key pairs)."""
    out = []
    if isinstance(plan, L.Join):
        out.append((plan.how, tuple(f"{lk}={rk}" for lk, rk in
                                    zip(plan.left_keys, plan.right_keys))))
    for c in plan.children():
        out.extend(_join_keys(c, L))
    return out


@pytest.mark.parametrize("qnum", [3, 5])
def test_join_order_matches_reference(engines, qnum):
    """Cost-based reordering picks the reference's join order (distinct
    key counts taken over the same padded columns)."""
    spark, port, _ = engines
    want = _join_keys(ref_optimize(ref_parse_sql(QUERIES[qnum],
                                                 spark.catalog)), RL)
    got = _join_keys(port_optimize(port_parse_sql(QUERIES[qnum],
                                                  port.catalog)), PL)
    assert len(got) == {3: 2, 5: 5}[qnum]
    assert got == want


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
    "select l_orderkey from lineitem, orders where l_orderkey = o_orderkey",
    "select l_orderkey from lineitem join orders on l_orderkey = o_orderkey",
    "select c.c_custkey, o.o_orderkey, o.o_totalprice from customer c "
    "left join orders o on c.c_custkey = o.o_custkey "
    "and o.o_totalprice > 200000 where c.c_custkey < 300 "
    "order by c.c_custkey, o.o_orderkey",
    "select c_custkey, c_name from customer left semi join orders "
    "on c_custkey = o_custkey and o_orderdate < date '1992-06-01' "
    "order by c_custkey",
    "select c_custkey, c_nationkey from customer left anti join orders "
    "on c_custkey = o_custkey order by c_custkey",
    "select a.n_name, b.n_name as m from nation a join nation b "
    "using (n_regionkey) where a.n_nationkey < 5 order by a.n_name, m",
    "select n_name, r_name from nation right outer join region "
    "on n_regionkey = r_regionkey and n_nationkey < 3 "
    "order by r_name, n_name",
    "select n_name, r_name from nation full join region "
    "on n_regionkey = r_regionkey and r_name <> 'ASIA' "
    "order by r_name, n_name",
    "select r_name, n.* from region cross join nation n "
    "where n_nationkey < 2 order by r_name, n_nationkey",
    "select o_orderpriority, count(*) as n from orders "
    "where o_orderdate >= date '1993-07-01' "
    "and o_orderdate < date '1993-07-01' + interval '3' month "
    "group by o_orderpriority order by o_orderpriority",
])
def test_sql_shapes_match_reference(engines, query):
    """Filters with Kleene logic, the sorted aggregate path (integer key),
    decimal arithmetic, date ranges, ORDER BY with LIMIT, DISTINCT;
    comma, inner, left/right/full outer (residual conditions), left
    semi, left anti and cross joins, USING, table aliases, ``alias.*``,
    month intervals."""
    spark, port, _ = engines
    got, want = _rows(port.sql(query)), _rows(spark.sql(query))
    assert want and got == want


@pytest.mark.parametrize("query", [
    "select t.l_orderkey from (select l_orderkey from lineitem) t",
    "select l_orderkey from lineitem where l_orderkey in "
    "(select o_orderkey from orders)",
    "select l_returnflag, count(*) as n from lineitem "
    "group by l_returnflag having count(*) > 1",
    "select count(distinct l_returnflag) as n from lineitem",
    "select l_returnflag from lineitem union select l_linestatus "
    "from lineitem",
])
def test_unported_sql_raises(engines, query):
    """Subqueries (in FROM and in expressions), HAVING, DISTINCT
    aggregates and set operations are refused instead of being run
    wrongly."""
    _, port, _ = engines
    with pytest.raises(NotImplementedError, match="not ported"):
        port.sql(query).collect()
