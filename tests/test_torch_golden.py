"""The golden SQL files of tests/sql_golden through the port on the CPU
(``harness.setup_engine`` and ``run_engine`` on a ``device("cpu")``
session), one case per query, as tests/test_sql_golden.py runs them
through the JAX package.

A query passes when its rows equal the golden rows. The only other
outcome allowed is ``NotImplementedError``, and only for the queries of
``NOT_PORTED``, which is empty since the nested-type slice ported list
and map columns, the collect aggregates and the higher-order functions.
A query on that list must still raise."""

import os

import pytest

from spark_tpu_torch.api.session import SparkSession
from tests.sql_golden import harness as H

from test_torch_threads import one_torch_thread  # noqa: F401

#: (file, query index) of the golden queries that need constructs the
#: port has not ported yet, by what they need: none
NOT_PORTED: dict = {}


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
    """All 110 golden queries run through the port: none is refused,
    arrays.sql, maps.sql, higher-order.sql and aggregates-advanced.sql
    included."""
    cases = _cases()
    refused = sum(len(v) for v in NOT_PORTED.values())
    assert len(cases) == 110 and refused == 0
    assert {"arrays.sql", "maps.sql", "higher-order.sql",
            "aggregates-advanced.sql"} <= {c.values[0] for c in cases}
