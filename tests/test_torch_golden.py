"""The golden SQL files of tests/sql_golden through the port on the CPU
(``harness.setup_engine`` and ``run_engine`` on a ``device("cpu")``
session), one case per query, as tests/test_sql_golden.py runs them
through the JAX package.

A query passes when its rows equal the golden rows. The only other
outcome allowed is ``NotImplementedError``, and only for the queries of
``NOT_PORTED``: list and map columns, the collect aggregates and the
higher-order functions (ROADMAP A2). A query on that list must
still raise, so the list shrinks as the port grows."""

import os

import pytest

from spark_tpu_torch.api.session import SparkSession
from tests.sql_golden import harness as H

#: (file, query index) of the golden queries that need constructs the
#: port has not ported yet, by what they need
NOT_PORTED = {
    "aggregates-advanced.sql": {2, 3},   # collect_list, collect_set
    "arrays.sql": {0, 1, 2, 3},          # array, size, element_at, explode
    "higher-order.sql": {0, 1, 2, 3, 4},  # transform, filter, exists, ...
    "maps.sql": {0, 1, 2, 3},            # map, element_at, map_keys, ...
}


def _cases():
    out = []
    for fname in H.input_files():
        gpath = os.path.join(H.GOLDENS, fname[:-4] + ".out")
        for i, (sql, rows) in enumerate(H.read_golden(gpath)):
            out.append(pytest.param(fname, i, sql, rows, id=f"{fname}:{i}"))
    return out


@pytest.fixture(scope="module")
def port():
    spark = SparkSession(device="cpu")
    H.setup_engine(spark)
    return spark


@pytest.mark.parametrize("fname,index,sql,want", _cases())
def test_golden_through_port(port, fname, index, sql, want):
    if index in NOT_PORTED.get(fname, ()):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            H.run_engine(port, sql)
        return
    got = H.run_engine(port, sql)
    assert got == want, (f"{fname}: result drift for:\n{sql}\n"
                         f"got : {got}\nwant: {want}")


def test_golden_census():
    """At least 95 of the 110 golden queries run through the port, every
    one of window.sql, set-operations.sql, grouping-sets.sql, strings.sql,
    arithmetic.sql, date-functions.sql and null-propagation.sql among
    them; only the 15 that need list or map columns are refused."""
    cases = _cases()
    refused = sum(len(v) for v in NOT_PORTED.values())
    assert len(cases) == 110 and len(cases) - refused >= 95
    assert not {"window.sql", "set-operations.sql", "grouping-sets.sql",
                "strings.sql", "arithmetic.sql", "date-functions.sql",
                "null-propagation.sql"} & set(NOT_PORTED)
