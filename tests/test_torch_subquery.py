"""The subquery slice on the CPU: TPC-H q6, q10, q13, q14, q16, q18 and
q22 through the port's ``SparkSession.sql(...).collect()`` against the
reference's rows and the sqlite oracle (TPC-H at sf 0.02, seed 99, as
tests/test_torch_sql.py, whose fixtures this file shares), and the
three-valued NOT IN of the uncorrelated rewrite (null-aware: counts
aggregate, cross join, filter) against the reference and sqlite, and
grouped aggregates of no rows and CASE over aggregates against sqlite.

Rows must be equal to the reference's: exact for ints, decimals, dates
and strings; the oracle within rel 1e-6."""

import pytest

from spark_tpu_torch.tpch import QUERIES
from spark_tpu_torch.tpch.oracle import assert_rows_match, run_oracle

from test_torch_sql import _rows, check_tpch_query, engines, oracle  # noqa: F401


@pytest.mark.parametrize("qnum", [6, 10, 13, 14, 16, 18, 22])
def test_subquery_slice_queries_match_reference_and_oracle(
        engines, oracle, qnum, monkeypatch):  # noqa: F811
    """q6 and q10 (filters, joins, a top 20); q13 (a derived table over
    a left outer join with NOT LIKE, count(col) over its NULLs, an
    aggregate over an aggregate); q14 (CASE with LIKE inside a sum, the
    repaired CASE fault); q16 (IN list, NOT LIKE, <> on strings,
    uncorrelated NOT IN, count(DISTINCT)); q18 (IN over a grouped
    aggregate with HAVING); q22 (substring, IN on strings, an
    uncorrelated scalar subquery, correlated NOT EXISTS, a derived
    table). None reaches a kernel: the aggregates are sorted, masked
    (K <= 64) or single-group, and the joins count no matches (no
    outer, semi or anti join with a residual condition)."""
    check_tpch_query(engines, oracle, qnum, monkeypatch)


# probe: customers 1..39; a NULL probe for the odd keys in the second pair
_CUSTOMERS = "select c_custkey as k from customer where c_custkey < 40"
_NULLABLE = ("select case when c_custkey % 2 = 0 then c_custkey end as k "
             "from customer where c_custkey < 40")
_WITH_NULL = ("select case when o_orderkey > 100 then o_custkey end "
              "from orders")
_EMPTY = "select o_custkey from orders where o_totalprice < 0"
_PLAIN = "select o_custkey from orders where o_orderkey < 2000"


@pytest.mark.parametrize("probe,sub,want_rows", [
    (_CUSTOMERS, _WITH_NULL, "none"),   # a NULL in the subquery: UNKNOWN
    (_CUSTOMERS, _EMPTY, "all"),        # empty subquery: every row kept
    (_CUSTOMERS, _PLAIN, "some"),
    (_NULLABLE, _PLAIN, "some"),        # NULL probe, non-empty: dropped
    (_NULLABLE, _EMPTY, "all"),         # NULL probe, empty: kept
], ids=["null_in_subquery", "empty_subquery", "plain", "null_probe",
        "null_probe_empty_subquery"])
def test_not_in_is_three_valued(engines, oracle, probe, sub,
                                want_rows):  # noqa: F811
    spark, port, _ = engines
    query = (f"select k from ({probe}) t where k not in ({sub}) "
             "order by k")
    got = _rows(port.sql(query))
    assert got == _rows(spark.sql(query))
    assert_rows_match(got, run_oracle(oracle, query), label="not in")
    n_probe = len(_rows(port.sql(probe)))
    assert {"none": len(got) == 0, "all": len(got) == n_probe,
            "some": 0 < len(got) < n_probe}[want_rows], got


@pytest.mark.parametrize("query", [
    "select o_orderkey, count(*) as n from orders where o_totalprice < 0 "
    "group by o_orderkey",
    "select o_orderstatus, count(*) as n from orders "
    "where o_totalprice < 0 group by o_orderstatus",
    QUERIES[18].replace("> 300", "> 3000"),
], ids=["sorted_path", "direct_path", "q18_empty_in_subquery"])
def test_grouped_aggregate_of_no_rows_is_empty(engines, oracle,
                                               query):  # noqa: F811
    """A grouped aggregate over no live rows has no group, as sqlite
    says. The reference's sorted path emits one empty group here (count
    0, sums NULL; ROADMAP C): the port does not copy that fault."""
    _, port, _ = engines
    assert run_oracle(oracle, query) == []
    assert _rows(port.sql(query)) == []


def test_case_over_aggregates_matches_oracle(engines, oracle):  # noqa: F811
    """CASE whose branches hold aggregates, in a grouped SELECT list: the
    aggregate rewrite descends into Case.branches. The reference raises
    here (its rewrite compares expressions with ``!=``; ROADMAP C), so
    the port is held against sqlite alone."""
    _, port, _ = engines
    query = ("select o_orderstatus, case when count(*) > 10000 then 'many' "
             "else 'few' end as c, count(distinct o_custkey) as k, "
             "coalesce(max(o_shippriority), -1) as p from orders "
             "group by o_orderstatus order by o_orderstatus")
    got = _rows(port.sql(query))
    assert len(got) == 3 and {r[1] for r in got} == {"many", "few"}
    assert_rows_match(got, run_oracle(oracle, query), label="case agg")
