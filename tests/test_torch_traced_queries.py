"""Re-execution of the window, scalar, complex and DataFrame queries of
``chip_smoke.py``'s phases (``spark_tpu_torch/tpch/queries.py``) through
the port on the CPU, at sf 0.02 (seed 7, with the ``ts_orders`` and
``nested`` tables of the scalar and complex parity tests), each run
twice in one port session: the second run binds the first run's
statistics and runs traced, every stage under the host-traffic guard,
as ``tests/test_torch_traced_tpch.py`` checks TPC-H. Only X2 and X3,
whose collect_list/collect_set size their arrays by the largest group,
keep a blocking aggregate, as in the reference.

Rows: the second run equals the first: ints, decimals, dates, strings
and arrays exactly; floats within rel 1e-12 (``index_add_`` on the CPU
adds in row order)."""

import os
import time

import pytest

from spark_tpu_torch.api.session import SparkSession
from spark_tpu_torch.tpch import generate_tables, register_views
from spark_tpu_torch.tpch.queries import (COMPLEX_QUERIES, DATAFRAME_QUERIES,
                                          SCALAR_QUERIES, WINDOW_QUERIES,
                                          nested_table, timestamp_table)

from test_torch_traced_tpch import assert_rerun_equal, run_twice

QUERY_SETS = {**WINDOW_QUERIES, **SCALAR_QUERIES, **COMPLEX_QUERIES,
              **{k: v for k, v in DATAFRAME_QUERIES.items()
                 if k != "df_flagship"}}
#: queries whose collect aggregate stays blocking on every run
COLLECTS = {"x2_collect", "x3_higher_order"}


@pytest.fixture(scope="module")
def port():
    tz = os.environ.get("TZ")
    os.environ["TZ"] = "UTC"  # timestamp literals read in the local zone
    time.tzset()
    spark = SparkSession(device="cpu")
    tables = generate_tables(0.02, seed=7)
    register_views(spark, tables)
    spark.createDataFrame(timestamp_table(tables["orders"], 7)) \
        .createOrReplaceTempView("ts_orders")
    spark.createDataFrame(nested_table(tables["orders"], tables["lineitem"])) \
        .createOrReplaceTempView("nested")
    yield spark
    if tz is None:
        os.environ.pop("TZ")
    else:
        os.environ["TZ"] = tz
    time.tzset()


@pytest.mark.parametrize("name", sorted(QUERY_SETS))
def test_second_run_traced_equals_first(port, name):
    first, second, run = run_twice(port, QUERY_SETS[name])
    assert first, f"{name} returned no rows at this scale"
    assert_rerun_equal(first, second)
    assert set(run.untraceable) == ({"agg:collect"} if name in COLLECTS
                                    else set()), dict(run.untraceable)
