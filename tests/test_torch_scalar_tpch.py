"""The queries of ``chip_smoke.py``'s scalar phase
(``tpch/queries.py:SCALAR_QUERIES``) through the port on the CPU, at sf
0.02 (the tables and fixtures of tests/test_torch_sql.py, plus
``ts_orders`` from ``timestamp_table``): grouped stddev, variance and
avg of sqrt at three group counts (A1), percentiles (P1), string
transforms over host dictionaries (S2), date functions (D1), math over
decimals (M1) and timestamps (T1).

Each is held against sqlite where sqlite computes the same function
(``SCALAR_ORACLE_QUERIES``; rel 1e-6, the oracle's bound), and the
others against the reference's rows (equal; P1's floats rel 1e-12).
A1 and M1 read decimals, which the reference reads unscaled (ROADMAP C),
so they go against sqlite only. The kernel-wrapper calls each query
makes are those the card makes (``kernels._fsum_on`` set as on the
card): five seg_fsum calls in each A1 query and the direct path's counts
in A1-168, and none elsewhere. ``TZ`` is pinned to UTC.
"""

import os
import time

import pytest

from spark_tpu_torch.ops import seg_agg
from spark_tpu_torch.physical import kernels as PK
from spark_tpu_torch.tpch.oracle import (assert_rows_match, index_keys,
                                         load_sqlite, run_oracle)
from spark_tpu_torch.tpch.queries import (SCALAR_ORACLE_QUERIES,
                                          SCALAR_QUERIES, timestamp_table)

from test_torch_scalar import assert_rows_equal
from test_torch_sql import _rows, engines  # noqa: F401

#: kernel-wrapper calls per query with float sums routed as on the card
#: (seg_fsum: stddev and variance two float64 sums each, avg one)
SCALAR_CALLS = {"a1_6": {"fsum": 5}, "a1_168": {"count": 8, "fsum": 5},
                "a1_sorted": {"fsum": 5}}
#: the queries held against the reference's rows
REFERENCE = ("p1_percentile", "s2b_regexp", "d1_dates", "t1_timestamps")


@pytest.fixture(scope="module")
def scalar_engines(engines):  # noqa: F811
    old = os.environ.get("TZ")
    os.environ["TZ"] = "UTC"
    time.tzset()
    spark, port, tables = engines
    ts = timestamp_table(tables["orders"], seed=5)
    spark.createDataFrame(ts).createOrReplaceTempView("ts_orders")
    port.createDataFrame(ts).createOrReplaceTempView("ts_orders")
    conn = load_sqlite(tables)
    index_keys(conn)
    conn.execute("pragma case_sensitive_like = on")
    yield spark, port, conn
    conn.close()
    if old is None:
        del os.environ["TZ"]
    else:
        os.environ["TZ"] = old
    time.tzset()


def _spy(monkeypatch) -> dict:
    """Count the kernel-wrapper calls, with float sums routed to seg_fsum
    as on the card (on CPU tensors every wrapper takes its plain
    version)."""
    calls = {}
    real_sum, real_mm = seg_agg.seg_sum, seg_agg.seg_minmax
    real_fsum = seg_agg.seg_fsum

    def count(name, fn):
        def call(*a, **kw):
            key = name(*a, **kw)
            calls[key] = calls.get(key, 0) + 1
            return fn(*a, **kw)
        return call

    monkeypatch.setattr(PK, "_fsum_on", lambda data: True)
    monkeypatch.setattr(seg_agg, "seg_sum", count(
        lambda d, *a, exact_int=False, **kw: "count" if exact_int
        else "sum", real_sum))
    monkeypatch.setattr(seg_agg, "seg_minmax",
                        count(lambda *a, **kw: "minmax", real_mm))
    monkeypatch.setattr(seg_agg, "seg_fsum",
                        count(lambda *a, **kw: "fsum", real_fsum))
    return calls


@pytest.mark.parametrize("name", sorted(SCALAR_QUERIES))
def test_scalar_phase_query(scalar_engines, name, monkeypatch):
    spark, port, conn = scalar_engines
    calls = _spy(monkeypatch)
    got = _rows(port.sql(SCALAR_QUERIES[name]))
    assert got, f"{name} returned no rows at this scale"
    assert calls == SCALAR_CALLS.get(name, {})
    if name in SCALAR_ORACLE_QUERIES:
        assert_rows_match(got, run_oracle(conn, SCALAR_ORACLE_QUERIES[name]),
                          label=f"{name}[sqlite]")
    if name in REFERENCE:
        assert_rows_equal(got, _rows(spark.sql(SCALAR_QUERIES[name])))
    assert name in SCALAR_ORACLE_QUERIES or name in REFERENCE


def test_a1_float_groups_repeat_bit_for_bit(scalar_engines, monkeypatch):
    """A1's float columns through seg_fsum's plain version are the same
    bits when the query runs twice, and within rel 1e-10 of the CPU's
    index_add_ path: two sums' rounding (1e-12 of each group's sum of
    x^2), times the variance formula's cancellation, sum x^2 / (n var),
    which is under 10 for these columns."""
    _, port, _ = scalar_engines
    q = SCALAR_QUERIES["a1_168"]
    cpu = _rows(port.sql(q))
    _spy(monkeypatch)
    a, b = _rows(port.sql(q)), _rows(port.sql(q))
    assert a == b and len(a) == len(cpu)
    for ra, rc in zip(a, cpu):
        assert ra[:5] == rc[:5]
        for x, y in zip(ra[5:], rc[5:]):
            assert abs(x - y) <= 1e-10 * abs(y)
