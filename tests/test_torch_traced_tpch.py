"""Re-execution of all 22 TPC-H queries through the port on the CPU (sf
0.02, seed 99, the tables of tests/test_torch_sql.py), each run twice in
one port session.

The first run is blocking and records the runtime statistics. The second
binds them and runs traced, every stage under the host-traffic guard
(``physical/graphs.py:HostTrafficGuard``: no host sync, no tensor made
from host data, which is what a CUDA graph capture demands on the card).
The planner's counts (``planner.last_run``) show that every inner, left,
semi and anti equi-join, every sorted aggregate without a collect and
every explode ran inside a traced stage, except above an operator the
reference also keeps blocking (the cross join of an uncorrelated scalar
subquery, in q11, q16 and q22), and that a plan with no such operator
ran as one stage.

Rows: the second run equals the first (ints, decimals, dates and strings
exactly; floats within rel 1e-12, since ``index_add_`` on the CPU adds in
row order and a traced join may emit its rows in another order) and the
sqlite oracle (rel 1e-6, ``assert_rows_match``); q3 and q5 also equal
the reference's second run (``tests/test_tpch.py:95``) exactly, and q7,
q10 and q18 do in the slow lane (the reference compiles for 5-60 s a
query).
"""

import math

import pytest

from spark_tpu_torch.physical import graphs, planner
from spark_tpu_torch.tpch import QUERIES
from spark_tpu_torch.tpch.oracle import (assert_rows_match, index_keys,
                                         load_sqlite, run_oracle)

from test_torch_sql import _rows, engines  # noqa: F401
from test_torch_threads import one_torch_thread  # noqa: F401

#: what a traced re-execution must not leave blocking (reference:
#: planner._bind_adaptive and each operator's traceable)
TRACED_KINDS = frozenset({"join:inner", "join:left", "join:left_semi",
                          "join:left_anti", "agg:sorted", "GenerateExec"})


@pytest.fixture(scope="module")
def oracle(engines):  # noqa: F811
    conn = load_sqlite(engines[2])
    index_keys(conn)
    conn.execute("pragma case_sensitive_like = on")
    yield conn
    conn.close()


def run_twice(spark, query):
    """(first rows, second rows, the second run's RunStats): the second
    run traced under the guard, checked as the module docstring says."""
    frame = query if callable(query) else (lambda s: s.sql(query))
    first = _rows(frame(spark))
    assert planner.last_run.first_run
    with graphs.guarding_stages():
        second = _rows(frame(spark))
    run = planner.last_run
    assert not run.first_run
    assert not set(run.untraceable) & TRACED_KINDS, dict(run.untraceable)
    if not run.untraceable:
        assert not run.blocking and run.stages == 1, dict(run.blocking)
    return first, second, run


def assert_rerun_equal(first, second, rel=1e-12):
    assert len(first) == len(second)
    for a, b in zip(first, second):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            if isinstance(x, float) and isinstance(y, float):
                assert (math.isnan(x) and math.isnan(y)) or \
                    abs(x - y) <= rel * max(abs(x), abs(y), 1.0), (a, b)
            else:
                assert x == y, (a, b)


@pytest.mark.parametrize("qnum", sorted(QUERIES))
def test_second_run_traced_equals_first_and_oracle(engines, oracle, qnum):
    _, port, _ = engines
    first, second, run = run_twice(port, QUERIES[qnum])
    assert first, f"q{qnum} returned no rows at this scale"
    assert_rerun_equal(first, second)
    assert_rows_match(second, run_oracle(oracle, QUERIES[qnum]),
                      label=f"q{qnum}[traced]")
    blocking = set(run.untraceable)
    assert blocking <= {"join:cross:cond"}, blocking
    assert bool(blocking) == (qnum in (11, 16, 22))


@pytest.mark.parametrize("qnum", [3, 5, pytest.param(7, marks=pytest.mark.slow),
                                  pytest.param(10, marks=pytest.mark.slow),
                                  pytest.param(18, marks=pytest.mark.slow)])
def test_second_run_equals_reference_second_run(engines, qnum):
    """The port's traced run against the reference's (both engines' second
    runs at least: the other test may have run the query here before)."""
    spark, port, _ = engines
    for _ in range(2):
        got = _rows(port.sql(QUERIES[qnum]))
    assert not planner.last_run.first_run
    _rows(spark.sql(QUERIES[qnum]))
    want = _rows(spark.sql(QUERIES[qnum]))  # traced in the reference
    assert want and got == want
