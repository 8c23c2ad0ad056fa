"""The port's SQL slices end to end on the CPU: TPC-H q1, the q1-wide
aggregate (four dictionary keys, K = 168 packed groups, so counts, int64
sums and float32 min/max take the kernel path), the join queries q3 and
q5 and SQL shapes of every ported construct, through
``spark_tpu.api.session.SparkSession`` and through ``spark_tpu_torch``'s
session with ``device("cpu")``, on the same tables (TPC-H at sf 0.02,
seed 99, as tests/test_tpch.py). The subquery slice's TPC-H queries run
in tests/test_torch_subquery.py and the window slice's and the other
TPC-H queries in tests/test_torch_tpch.py, files of their own so that
the test workers split the reference engine's compile time. SQL that
the reference parses and the port has not ported raises
``NotImplementedError`` naming what it refuses.

Rows must be equal: exact for ints, decimals, dates, strings and float32
min/max. The TPC-H queries are also checked against the sqlite oracle
(rel 1e-6, the oracle's own bound; LIKE made case-sensitive, as the
engines' is), and the optimized plans of every TPC-H query the port runs
against the reference's join types and keys, with the subquery
rewrite's generated names normalised.
"""

import re

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


@pytest.fixture(scope="module")
def oracle(engines):
    conn = load_sqlite(engines[2])
    conn.execute("pragma case_sensitive_like = on")
    yield conn
    conn.close()


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


def test_q1_matches_sqlite_oracle(engines, oracle):
    _, port, _ = engines
    want = run_oracle(oracle, QUERIES[1])
    assert_rows_match(_rows(port.sql(QUERIES[1])), want, label="q1[port]")


# the TPC-H queries of the join and subquery slices, with the number of
# joins in each optimized plan
TPCH_JOINS = {3: 2, 5: 5, 6: 0, 10: 3, 13: 1, 14: 1, 16: 3, 18: 3, 22: 2}


def check_tpch_query(engines, oracle, qnum, monkeypatch):
    """The port's rows of TPC-H ``qnum`` equal the reference's and the
    oracle's, and its run calls no kernel wrapper."""
    spark, port, _ = engines
    calls = _spy_kernels(monkeypatch)
    got = _rows(port.sql(QUERIES[qnum]))
    assert calls == []
    want = _rows(spark.sql(QUERIES[qnum]))
    assert want and got == want
    assert_rows_match(got, run_oracle(oracle, QUERIES[qnum]),
                      label=f"q{qnum}[port]")


@pytest.mark.parametrize("qnum", [3, 5])
def test_join_queries_match_reference_and_oracle(engines, oracle, qnum,
                                                 monkeypatch):
    """q3 (3 relations, sorted aggregate over an int64 key, top 10) and
    q5 (six relations, a two-key join, a year interval): the same rows
    as the reference and the oracle. Neither reaches a kernel: q3's
    aggregate is sorted, q5's has K = 26 (masked), and inner joins count
    no matches."""
    check_tpch_query(engines, oracle, qnum, monkeypatch)


_GENERATED = re.compile(r"__(sq|sqk|nin)\d+")


def _join_keys(plan, L) -> list:
    """The optimized plan's joins, top-down, as (how, key pairs), with
    the subquery rewrite's counter-numbered names (``__sq12``,
    ``__nin3_n``) normalised."""
    out = []
    if isinstance(plan, L.Join):
        keys = tuple(f"{lk}={rk}" for lk, rk in
                     zip(plan.left_keys, plan.right_keys))
        out.append((plan.how, tuple(_GENERATED.sub(r"__\1#", k)
                                    for k in keys)))
    for c in plan.children():
        out.extend(_join_keys(c, L))
    return out


@pytest.mark.parametrize("qnum", sorted(TPCH_JOINS))
def test_join_order_matches_reference(engines, qnum):
    """Cost-based reordering picks the reference's join order (distinct
    key counts taken over the same padded columns), and the subquery
    rewrite the reference's join types and keys."""
    spark, port, _ = engines
    want = _join_keys(ref_optimize(ref_parse_sql(QUERIES[qnum],
                                                 spark.catalog)), RL)
    got = _join_keys(port_optimize(port_parse_sql(QUERIES[qnum],
                                                  port.catalog)), PL)
    assert len(got) == TPCH_JOINS[qnum]
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
    "select t.l_orderkey from (select l_orderkey from lineitem) t",
    "select l_orderkey from lineitem where l_orderkey in "
    "(select o_orderkey from orders)",
    "select l_returnflag, count(*) as n from lineitem "
    "group by l_returnflag having count(*) > 1",
    "select count(distinct l_returnflag) as n from lineitem",
    # correlated EXISTS / NOT EXISTS: key equalities become semi/anti
    # join keys, a correlated inequality the join's condition
    "select c_custkey, c_name from customer where c_custkey < 200 and "
    "exists (select * from orders where o_custkey = c_custkey and "
    "o_totalprice > 150000) order by c_custkey",
    "select c_custkey from customer where c_custkey < 300 and not exists "
    "(select * from orders where o_custkey = c_custkey and "
    "o_totalprice < c_acctbal * 20) order by c_custkey",
    "select n_name from nation where exists "
    "(select * from region where r_name = 'ASIA') order by n_name",
    # scalar subqueries: a global aggregate (cross join), a plain
    # relation (first row), correlated aggregates (grouped left join;
    # count becomes 0 for an empty group), in WHERE, HAVING and SELECT
    "select c_custkey, c_acctbal from customer where c_acctbal > "
    "(select avg(c_acctbal) + 4000 from customer) order by c_custkey",
    "select n_name from nation where n_regionkey = "
    "(select r_regionkey from region where r_name = 'ASIA') order by n_name",
    "select p_partkey, p_retailprice from part where p_partkey < 300 and "
    "p_retailprice < (select min(ps_supplycost) * 2 from partsupp "
    "where ps_partkey = p_partkey) order by p_partkey",
    "select n_name, (select count(*) from supplier "
    "where s_nationkey = n_nationkey) as k from nation order by n_name",
    "select ps_partkey, sum(ps_availqty) as s from partsupp "
    "group by ps_partkey having sum(ps_availqty) > "
    "(select avg(ps_availqty) * 3 from partsupp) order by ps_partkey",
    # IN subqueries: correlated, and a row-value probe
    "select o_orderkey from orders where o_orderkey < 3000 and o_custkey "
    "in (select c_custkey from customer where c_nationkey = 3) "
    "order by o_orderkey",
    "select l_orderkey, l_linenumber from lineitem where "
    "(l_partkey, l_suppkey) in (select ps_partkey, ps_suppkey "
    "from partsupp where ps_availqty < 300) "
    "order by l_orderkey, l_linenumber",
    # DISTINCT aggregates and the expression breadth of the slice
    "select l_returnflag, count(distinct l_suppkey) as a, "
    "sum(distinct l_quantity) as b, avg(distinct l_discount) as c, "
    "count(*) as n from lineitem group by l_returnflag "
    "order by l_returnflag",
    "select extract(year from o_orderdate) as y, month(o_orderdate) as m, "
    "substring(o_orderpriority, 1, 1) as p, sum(case when o_orderstatus "
    "in ('F', 'P') then 1 else 0 end) as n, count(*) as c from orders "
    "where o_comment like '%furious%' and o_clerk not like '%00_' "
    "group by y, m, p order by y, m, p",
    "select n_name, coalesce(s_acctbal, 0) as b, case when s_acctbal > "
    "5000 then 'rich' when s_acctbal is null then n_name end as t "
    "from nation left join supplier on n_nationkey = s_nationkey "
    "order by n_name, b",
    # a window function, grouping sets and a set operation
    "select l_orderkey, sum(l_quantity) over (partition by l_orderkey) "
    "as s from lineitem",
    "select l_returnflag, l_linestatus, count(*) as n from lineitem "
    "group by rollup (l_returnflag, l_linestatus)",
    "select l_returnflag from lineitem union select l_linestatus "
    "from lineitem",
])
def test_sql_shapes_match_reference(engines, query):
    """Filters with Kleene logic, the sorted aggregate path (integer key),
    decimal arithmetic, date ranges, ORDER BY with LIMIT, DISTINCT;
    comma, inner, left/right/full outer (residual conditions), left
    semi, left anti and cross joins, USING, table aliases, ``alias.*``,
    month intervals; derived tables, HAVING, subqueries of every
    rewritten shape, DISTINCT aggregates, CASE, IN, LIKE, substring,
    extract and coalesce; a window function, ROLLUP and UNION. Rows
    equal the reference's, and so do the optimized plan's join types and
    keys."""
    spark, port, _ = engines
    got, want = _rows(port.sql(query)), _rows(spark.sql(query))
    assert want and got == want
    assert _join_keys(port_optimize(port_parse_sql(query, port.catalog)),
                      PL) == _join_keys(
        ref_optimize(ref_parse_sql(query, spark.catalog)), RL)


@pytest.mark.parametrize("query", [
    "select n_name, x from nation lateral view explode(array(1, 2)) t "
    "as x",
    "select c_custkey from customer where c_custkey not in "
    "(select case when o_totalprice > 1000 then o_custkey end from orders "
    "where o_orderkey = c_custkey)",
    "select l_orderkey, collect_list(l_linenumber) from lineitem "
    "group by l_orderkey",
    "select l_orderkey, map('a', l_linenumber)['a'] from lineitem",
    "select n_name, explode(array(n_nationkey, n_regionkey)) from nation",
    "create view v as select * from nation",
])
def test_unported_sql_raises(engines, query):
    """LATERAL VIEW generators, a correlated NOT IN over a nullable
    subquery column (which the reference refuses too), the collect
    aggregates, map subscripts, generators in the select list and view
    DDL are refused instead of being run wrongly."""
    _, port, _ = engines
    with pytest.raises(NotImplementedError, match="not ported"):
        port.sql(query).collect()


@pytest.mark.parametrize("expr,name", [
    ("split(l_comment, ' ')", "split"),
    ("collect_set(l_linenumber)", "collect_set"),
    ("transform(array(l_linenumber), x -> x + 1)", "transform"),
    ("element_at(array(l_linenumber), 1)", "element_at"),
    ("size(array(l_linenumber))", "size"),
    ("map_keys(map('k', l_linenumber))", "map_keys"),
    ("collect_list(l_linenumber)", "collect_list"),
    ("array(l_linenumber, 1)[0]", "array"),
    ("map('k', l_linenumber)", "map"),
])
def test_reference_function_not_ported_names_it(engines, expr, name):
    """A function or operator the reference parses and the port has not
    ported raises NotImplementedError naming it, not a parse error."""
    _, port, _ = engines
    with pytest.raises(NotImplementedError,
                       match=rf"not ported yet: .*{re.escape(name)}"):
        port.sql(f"select {expr} from lineitem")


def test_every_refused_function_names_itself(engines):
    """Every name left in the parser's ``_REFERENCE_FUNCTIONS`` raises
    NotImplementedError naming it."""
    from spark_tpu_torch.sql.parser import _REFERENCE_FUNCTIONS

    _, port, _ = engines
    for name in sorted(_REFERENCE_FUNCTIONS):
        with pytest.raises(NotImplementedError,
                           match=rf"not ported yet: .*{name.lower()}"):
            port.sql(f"select {name.lower()}(l_linenumber) from lineitem")


_ROWS = ("select l_orderkey, l_linenumber, {} from lineitem "
         "where l_orderkey < 300 order by l_orderkey, l_linenumber")


@pytest.mark.parametrize("expr", [
    "upper(l_shipmode)",
    "l_shipmode || l_returnflag",
    "nullif(l_linenumber, 1)",
    "date_add(l_shipdate, 30)",
])
def test_formerly_refused_functions_match_reference(engines, expr):
    """Functions this test named as refused before the scalar slice:
    their rows equal the reference's."""
    spark, port, _ = engines
    q = _ROWS.format(expr)
    got = _rows(port.sql(q))
    assert len(got) > 100 and got == _rows(spark.sql(q))


def test_percentile_approx_matches_reference(engines):
    """percentile_approx by group, formerly refused: the element at rank
    ceil(q * n) of each group, as the reference's."""
    spark, port, _ = engines
    q = ("select l_returnflag, l_linestatus, "
         "percentile_approx(l_quantity, 0.5) as p from lineitem "
         "group by l_returnflag, l_linestatus "
         "order by l_returnflag, l_linestatus")
    got = _rows(port.sql(q))
    assert got and got == _rows(spark.sql(q))


def test_decimal_round_and_stddev_match_oracle(engines, oracle):
    """round(l_tax, 1) and stddev(l_quantity) take decimals, which the
    reference reads unscaled (ROADMAP C, decided): they are held against
    sqlite, the variance through its sum-of-squares formula."""
    _, port, _ = engines
    got = _rows(port.sql(_ROWS.format("round(l_tax, 1)")))
    assert len(got) > 100
    assert_rows_match(got, run_oracle(oracle, _ROWS.format(
        "round(l_tax, 1)")), label="round[sqlite]")
    assert {str(r[2]) for r in got} <= {"0.0", "0.1"}
    q = ("select l_returnflag, stddev(l_quantity) as s from lineitem "
         "group by l_returnflag order by l_returnflag")
    var = run_oracle(oracle, (
        "select l_returnflag, (sum(l_quantity * l_quantity) - "
        "sum(l_quantity) * sum(l_quantity) / count(l_quantity)) / "
        "(count(l_quantity) - 1) from lineitem group by l_returnflag "
        "order by l_returnflag"))
    assert_rows_match(_rows(port.sql(q)),
                      [(k, v ** 0.5) for k, v in var], rel=1e-9,
                      label="stddev[sqlite]")


def test_unknown_function_is_a_parse_error(engines):
    from spark_tpu_torch.sql.parser import SQLParseError

    _, port, _ = engines
    with pytest.raises(SQLParseError, match="unknown function 'frobnicate'"):
        port.sql("select frobnicate(l_tax) from lineitem")
