"""TPC-H through the port on the CPU (sf 0.02, seed 99, the tables and
fixtures of tests/test_torch_sql.py): the twelve queries no other test
holds against the sqlite oracle (the reference's rows in the slow lane:
its engine compiles for 5-60 s a query), and the queries of
``chip_smoke.py``'s window phase (window functions, ROLLUP, CUBE,
INTERSECT, EXCEPT, UNION) against the reference's rows and sqlite, with
the tie order of ``row_number()`` against the reference's, and the
join order of q2, q8 and q9, whose comma join of part and supplier the
port no longer plans as a cross product (ROADMAP C).

Rows equal to the reference's: exact for ints, decimals, dates and
strings; the oracle within rel 1e-6 (``assert_rows_match``)."""

import pytest

from spark_tpu_torch.plan import logical as PL
from spark_tpu_torch.plan.optimizer import optimize as port_optimize
from spark_tpu_torch.sql.parser import parse_sql as port_parse_sql
from spark_tpu_torch.tpch import QUERIES
from spark_tpu_torch.tpch.oracle import (assert_rows_match, index_keys,
                                         load_sqlite, run_oracle)
from spark_tpu_torch.tpch.queries import (WINDOW_ORACLE_QUERIES,
                                          WINDOW_QUERIES)

from test_torch_sql import _rows, _spy_kernels, engines  # noqa: F401

#: the TPC-H queries that the join and subquery slices' tests do not hold
REST = (2, 4, 7, 8, 9, 11, 12, 15, 17, 19, 20, 21)
#: their kernel-wrapper calls at this scale: q2, q17 and q20 count the
#: matches of a residual join over a 1,024-row probe side (K = 1024);
#: q21 groups by s_name, a 200-entry dictionary, on the direct path
#: (count(*) and the group-present test)
REST_KERNEL_CALLS = {2: ["count"], 17: ["count"], 20: ["count"],
                     21: ["count", "count"]}


@pytest.fixture(scope="module")
def oracle(engines):  # noqa: F811
    """sqlite over the same tables, key columns indexed (q21 takes
    minutes without)."""
    conn = load_sqlite(engines[2])
    index_keys(conn)
    conn.execute("pragma case_sensitive_like = on")
    yield conn
    conn.close()


@pytest.mark.parametrize("qnum", REST)
def test_tpch_rest_match_oracle(engines, oracle, qnum,
                                monkeypatch):  # noqa: F811
    _, port, _ = engines
    calls = _spy_kernels(monkeypatch)
    got = _rows(port.sql(QUERIES[qnum]))
    assert calls == REST_KERNEL_CALLS.get(qnum, [])
    assert got, f"q{qnum} returned no rows at this scale"
    assert_rows_match(got, run_oracle(oracle, QUERIES[qnum]),
                      label=f"q{qnum}[port]")


@pytest.mark.slow
@pytest.mark.parametrize("qnum", REST)
def test_tpch_rest_match_reference(engines, qnum):  # noqa: F811
    spark, port, _ = engines
    want = _rows(spark.sql(QUERIES[qnum]))
    assert want and _rows(port.sql(QUERIES[qnum])) == want


@pytest.mark.parametrize("name", sorted(WINDOW_QUERIES))
def test_window_phase_queries_match_reference_and_oracle(
        engines, oracle, name, monkeypatch):  # noqa: F811
    """W1-W3 (row_number, running sum, rank, lag, sliding min/max/avg),
    R1 (ROLLUP, grouping_id) and C1 (CUBE), held against sqlite through
    the UNION ALL of their GROUP BYs, and the three set operations. None
    calls a kernel wrapper: sorted, masked or single-group aggregates."""
    spark, port, _ = engines
    query = WINDOW_QUERIES[name]
    calls = _spy_kernels(monkeypatch)
    got = _rows(port.sql(query))
    assert calls == []
    assert got and got == _rows(spark.sql(query))
    assert_rows_match(got, run_oracle(
        oracle, WINDOW_ORACLE_QUERIES.get(name, query)), label=name)


def test_row_number_breaks_ties_as_the_reference(engines):  # noqa: F811
    """row_number() among peers follows the input order (a stable sort);
    the rows come back in input order from both engines, with no ORDER
    BY, so equal lists mean equal tie-breaking."""
    spark, port, _ = engines
    query = ("select l_orderkey, l_linenumber, row_number() over "
             "(partition by l_returnflag order by l_shipmode) as rn, "
             "rank() over (order by l_quantity) as rk from lineitem "
             "where l_orderkey < 400")
    got = _rows(port.sql(query))
    assert len(got) > 50 and got == _rows(spark.sql(query))


def _keyless_base_joins(plan) -> list:
    """The joins without keys or condition whose two sides are base
    relations (a Relation under projections and filters)."""
    def base(node):
        while isinstance(node, (PL.Project, PL.Filter, PL.SubqueryAlias)):
            node = node.children()[0]
        return isinstance(node, PL.Relation)

    out = []

    def walk(node):
        if (isinstance(node, PL.Join) and not node.left_keys
                and node.condition is None and base(node.left)
                and base(node.right)):
            out.append(node)
        for c in node.children():
            walk(c)

    walk(plan)
    return out


@pytest.mark.parametrize("qnum", (2, 8, 9))
def test_comma_joins_plan_no_cross_product(engines, oracle,
                                           qnum):  # noqa: F811
    """q2, q8 and q9 list part and supplier in one FROM clause with no key
    between them. The reorder joins each through lineitem or partsupp
    instead of as a cross product (q9's held 9.9 GB on the card at SF1),
    and the rows stay those of sqlite."""
    _, port, _ = engines
    plan = port_optimize(port_parse_sql(QUERIES[qnum], port.catalog))
    assert _keyless_base_joins(plan) == []
    got = _rows(port.sql(QUERIES[qnum]))
    assert got
    assert_rows_match(got, run_oracle(oracle, QUERIES[qnum]),
                      label=f"q{qnum}[port]")


def test_scalar_subquery_joins_stay_keyless(engines):  # noqa: F811
    """The keyless joins of q11, q16 and q22 join a one-row scalar
    subquery, and stay as they are."""
    _, port, _ = engines
    for qnum in (11, 16, 22):
        plan = port_optimize(port_parse_sql(QUERIES[qnum], port.catalog))
        joins = []

        def walk(node):
            if isinstance(node, PL.Join) and not node.left_keys:
                joins.append(node)
            for c in node.children():
                walk(c)

        walk(plan)
        assert joins, f"q{qnum} lost its scalar-subquery join"
