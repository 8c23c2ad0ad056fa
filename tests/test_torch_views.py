"""SQL view DDL in the port (``spark_tpu_torch/sql/parser.py``:
``CREATE [OR REPLACE] [TEMP|TEMPORARY] VIEW name AS <query>`` and ``DROP
VIEW``) against the JAX package: the same statements on both packages'
sessions over the same numpy-seeded table. A DDL statement returns what
the reference returns (no rows, one column ``__ok``) and changes the
catalog at once; queries over the view give equal rows (integers and
strings exactly, float sums within rel 1e-12: the packages may add in
another order)."""

import math

import numpy as np
import pyarrow as pa
import pytest

from spark_tpu_torch.api.session import SparkSession as PortSession

from test_torch_threads import one_torch_thread  # noqa: F401

REL = 1e-12


@pytest.fixture(scope="module")
def engines(spark):
    rng = np.random.default_rng(21)
    n = 300
    table = pa.table({
        "k": pa.array(rng.integers(0, 12, n), pa.int64()),
        "v": pa.array(rng.normal(size=n)),
        "tag": pa.array(list(np.array(["a", "b", "c"])[
            rng.integers(0, 3, n)])),
    })
    port = PortSession.builder.device("cpu").getOrCreate()
    for s in (spark, port):
        s.createDataFrame(table).createOrReplaceTempView("vt")
    return spark, port


def _rows(df):
    return [tuple(r) for r in df.collect()]


def _same(got, want):
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(a, float):
                assert math.isclose(a, b, rel_tol=REL), (g, w)
            else:
                assert a == b, (g, w)


@pytest.mark.parametrize("ddl", [
    "create view v1 as select k, tag from vt where k > 3",
    "create or replace temp view v1 as select k, tag from vt where k > 3",
    "CREATE TEMPORARY VIEW v1 AS SELECT k, tag FROM vt WHERE k > 3",
])
def test_create_view_then_query(engines, ddl):
    ref, port = engines
    for s in (ref, port):
        out = s.sql(ddl)
        assert out.collect() == [] and out.columns == ["__ok"]
        assert s.catalog.tableExists("v1")
    q = "select tag, count(*) as n, max(k) as m from v1 group by tag " \
        "order by tag"
    got, want = _rows(port.sql(q)), _rows(ref.sql(q))
    assert want and got == want
    for s in (ref, port):
        s.sql("drop view v1")
        assert not s.catalog.tableExists("v1")


def test_view_over_aggregate_and_join(engines):
    """A view of an aggregate, joined back to its table, and a view
    replaced by another of the same name."""
    ref, port = engines
    ddl = ("create or replace view agg as select k, sum(v) as s, "
           "count(*) as n from vt group by k")
    q = ("select vt.tag, agg.k, agg.n, agg.s from vt join agg "
         "on vt.k = agg.k where vt.v > 1.0 order by vt.tag, agg.k, agg.n")
    for s in (ref, port):
        s.sql(ddl)
    _same(_rows(port.sql(q)), _rows(ref.sql(q)))
    ddl2 = ("create or replace view agg as select k, min(v) as s, "
            "count(*) as n from vt where tag = 'a' group by k")
    for s in (ref, port):
        s.sql(ddl2)
    _same(_rows(port.sql(q)), _rows(ref.sql(q)))
    for s in (ref, port):
        s.sql("drop view agg")


def test_drop_view_if_exists_and_missing(engines):
    """DROP VIEW of a missing view is quiet; a dropped view no longer
    resolves."""
    _, port = engines
    port.sql("create view gone as select k from vt")
    assert port.sql("select count(*) as c from gone").collect()[0].c == 300
    port.sql("drop view if exists gone")
    port.sql("drop view gone")
    with pytest.raises(Exception, match="gone"):
        port.sql("select * from gone").collect()
