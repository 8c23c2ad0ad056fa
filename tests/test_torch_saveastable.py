"""``df.write.saveAsTable`` and the persistent catalog in the port
(``spark_tpu_torch/io/readwriter.py``, ``api/session.py:Catalog``)
against the JAX package: a table lives as
``<spark.sql.warehouse.dir>/<name>/{_table.json,data/}`` in both, so a
table written by either package is read back by the other, and by a
fresh session of the same package pointing at the same warehouse. Rows
must be equal exactly (integers, floats as written, strings, NULLs),
in Parquet, CSV and partitioned Parquet."""

import json
import os

import numpy as np
import pyarrow as pa
import pytest

from spark_tpu import conf as RCF
from spark_tpu_torch import conf as PCF
from spark_tpu_torch.api.session import SparkSession as PortSession

from test_torch_threads import one_torch_thread  # noqa: F401


def _table(seed=13, n=200):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=n).astype(object)
    v[rng.random(n) < 0.1] = None
    return pa.table({
        "id": pa.array(np.arange(n), pa.int64()),
        "g": pa.array(rng.integers(0, 3, n), pa.int64()),
        "v": pa.array(list(v), pa.float64()),
        "s": pa.array(list(np.array(["x", "y", "zz"])[
            rng.integers(0, 3, n)])),
    })


@pytest.fixture
def warehouse(spark, tmp_path):
    """The reference's shared session and a fresh port session, both on
    one warehouse directory (the reference's setting restored after)."""
    wh = str(tmp_path / "warehouse")
    spark.conf.set(RCF.WAREHOUSE_DIR.key, wh)
    port = PortSession(device="cpu", conf={PCF.WAREHOUSE_DIR.key: wh})
    try:
        yield wh, spark, port
    finally:
        spark.conf.unset(RCF.WAREHOUSE_DIR.key)


def _sorted_rows(df, cols):
    return sorted((tuple(r[c] for c in cols) for r in df.collect()),
                  key=lambda r: r[0])


COLS = ["id", "g", "v", "s"]
WRITES = [
    ("parquet", ()),
    ("csv", ()),
    ("parquet", ("g",)),
]


@pytest.mark.parametrize("fmt,parts", WRITES)
def test_port_writes_reference_reads(warehouse, fmt, parts):
    wh, ref, port = warehouse
    table = _table()
    w = port.createDataFrame(table).write.format(fmt)
    if fmt == "csv":
        w = w.option("header", "true")
    if parts:
        w = w.partitionBy(*parts)
    w.saveAsTable("PT_T")
    meta = json.load(open(os.path.join(wh, "pt_t", "_table.json")))
    assert meta["format"] == fmt and meta["partition_by"] == list(parts)
    want = sorted(tuple(r.values()) for r in table.to_pylist())
    assert _sorted_rows(ref.table("pt_t"), COLS) == want
    assert _sorted_rows(port.table("pt_t"), COLS) == want
    fresh = PortSession(device="cpu",
                        conf={PCF.WAREHOUSE_DIR.key: wh})
    assert "pt_t" in fresh.catalog.listTables()
    assert _sorted_rows(fresh.sql("select * from pt_t"), COLS) == want


@pytest.mark.parametrize("fmt,parts", WRITES)
def test_reference_writes_port_reads(warehouse, fmt, parts):
    wh, ref, port = warehouse
    table = _table(seed=17)
    w = ref.createDataFrame(table).write.format(fmt)
    if fmt == "csv":
        w = w.option("header", "true")
    if parts:
        w = w.partitionBy(*parts)
    w.saveAsTable("rt_t")
    want = sorted(tuple(r.values()) for r in table.to_pylist())
    assert _sorted_rows(port.table("rt_t"), COLS) == want
    q = "select g, count(*) as n, sum(id) as s from rt_t group by g " \
        "order by g"
    assert [tuple(r) for r in port.sql(q).collect()] == \
        [tuple(r) for r in ref.sql(q).collect()]


def test_overwrite_refreshes_catalog(warehouse):
    """Rewriting a table in mode overwrite: the writing session and the
    other package see the new rows at once."""
    _, ref, port = warehouse
    port.createDataFrame(_table(n=50)).write.saveAsTable("ow")
    assert port.table("ow").count() == 50
    port.createDataFrame(_table(n=70)).write.mode("overwrite") \
        .saveAsTable("ow")
    assert port.table("ow").count() == 70
    assert ref.table("ow").count() == 70
