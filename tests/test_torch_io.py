"""The port's file scan (``spark_tpu_torch/io``) against the JAX package
on the inputs of tests/test_io.py: Parquet, CSV, JSON and ORC round
trips, the writers' save modes and ``partitionBy``, multi-file scans,
re-reads after a rewrite, and pushdown: the optimized plan of a filtered
read holds the same ``UnresolvedScan`` columns and pushed filters in
both packages, and untranslatable conjuncts stay a ``Filter``. The
TPC-H tables at sf 0.02, written to Parquet by the port and read back,
give the in-memory tables' rows for q1, q1-wide, q3 and q5, and
sqlite's.

Both packages read the same files, made from a seed with numpy. Rows
are compared exactly (integers, floats read back unchanged, decimals,
strings, dates and nulls). ``test_mesh_reads_files`` of tests/test_io.py
waits for the port's mesh executor (ROADMAP A10).
"""

import datetime
import decimal
import os
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_tpu.api import functions as RF
from spark_tpu.expr import expressions as RE
from spark_tpu.plan import logical as RL
from spark_tpu.plan.optimizer import optimize as ref_optimize
from spark_tpu_torch import types as T
from spark_tpu_torch.api import functions as F
from spark_tpu_torch.api.session import SparkSession as PortSession
from spark_tpu_torch.expr import expressions as E
from spark_tpu_torch.io.datasource import FileSource
from spark_tpu_torch.plan import logical as L
from spark_tpu_torch.plan.optimizer import optimize as port_optimize

from test_torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def port():
    return PortSession.builder.device("cpu").getOrCreate()


@pytest.fixture()
def sample_table():
    rng = np.random.default_rng(42)
    n = 1000
    return pa.table({
        "id": pa.array(np.arange(n), pa.int64()),
        "grp": pa.array(rng.integers(0, 5, n), pa.int32()),
        "val": pa.array(rng.normal(size=n)),
        "name": pa.array(np.array(["aa", "bb", "cc", "dd"])[
            rng.integers(0, 4, n)]),
        "day": pa.array([datetime.date(2024, 1, 1)
                         + datetime.timedelta(days=int(d))
                         for d in rng.integers(0, 60, n)]),
    })


def _rows(df, key=0):
    """Rows as tuples, sorted by column ``key`` (file scans keep no
    order across part files)."""
    return sorted((tuple(r) for r in df.collect()), key=lambda t: t[key])


def _scan(plan, scan_type):
    node = plan
    while not isinstance(node, scan_type):
        node = node.children()[0]
    return node


def _pushed(scan) -> list:
    return sorted(str(f) for f in scan.filters)


def test_parquet_roundtrip(spark, port, sample_table, tmp_path):
    p = str(tmp_path / "t.parquet")
    pq.write_table(sample_table, p)
    got = _rows(port.read.parquet(p))
    assert port.read.parquet(p).count() == sample_table.num_rows
    assert got == _rows(spark.read.parquet(p))
    assert got == sorted(tuple(r.values()) for r in sample_table.to_pylist())


def test_write_parquet_read_back(spark, port, sample_table, tmp_path):
    outs = {}
    for name, sess in (("ref", spark), ("port", port)):
        df = sess.createDataFrame(sample_table)
        out = str(tmp_path / name)
        df.write.parquet(out)
        assert os.path.isdir(out)
        back = sess.read.parquet(out)
        assert back.count() == sample_table.num_rows
        assert sorted(back.columns) == sorted(df.columns)
        # mode=error raises on an existing path; overwrite replaces it;
        # ignore leaves it; append adds part files
        with pytest.raises(FileExistsError):
            df.write.parquet(out)
        df.limit(10).write.mode("overwrite").parquet(out)
        assert sess.read.parquet(out).count() == 10
        df.write.mode("ignore").parquet(out)
        assert sess.read.parquet(out).count() == 10
        df.limit(5).write.mode("append").parquet(out)
        assert sess.read.parquet(out).count() == 15
        outs[name] = out
    # the port reads the reference's files and the reference the port's
    assert _rows(port.read.parquet(outs["ref"])) == \
        _rows(spark.read.parquet(outs["port"]))


def test_partitioned_write_and_partition_pruning(spark, port, sample_table,
                                                 tmp_path):
    got = {}
    for name, sess, col, opt, scan_type in (
            ("ref", spark, RE.Col, ref_optimize, RL.UnresolvedScan),
            ("port", port, E.Col, port_optimize, L.UnresolvedScan)):
        out = str(tmp_path / f"bygrp_{name}")
        sess.createDataFrame(sample_table).write.partitionBy("grp") \
            .parquet(out)
        assert sorted(os.listdir(out)) == [f"grp={g}" for g in range(5)]
        only2 = sess.read.parquet(out).filter(col("grp") == 2)
        scan = _scan(opt(only2._plan), scan_type)
        assert scan.filters, "partition predicate was not pushed"
        got[name] = (_pushed(scan), _rows(only2))
    assert got["port"] == got["ref"]
    rows = got["port"][1]
    want = sample_table.to_pandas()
    assert len(rows) == int((want["grp"] == 2).sum())
    # the partition column comes back as an ordinary int32 column
    assert {r[-1] for r in rows} == {2}
    back = port.read.parquet(str(tmp_path / "bygrp_port"))
    assert back.schema.field("grp").dtype == T.INT32


def test_projection_and_predicate_pushdown(spark, port, sample_table,
                                           tmp_path):
    p = str(tmp_path / "t2.parquet")
    pq.write_table(sample_table, p)
    ref_df = spark.read.parquet(p).filter(RE.Col("id") >= 900) \
        .select(RE.Col("id"), RE.Col("val"))
    port_df = port.read.parquet(p).filter(E.Col("id") >= 900) \
        .select(E.Col("id"), E.Col("val"))
    ref_scan = _scan(ref_optimize(ref_df._plan), RL.UnresolvedScan)
    port_scan = _scan(port_optimize(port_df._plan), L.UnresolvedScan)
    assert port_scan.columns is not None
    assert set(port_scan.columns) == {"id", "val"}
    assert port_scan.columns == ref_scan.columns
    assert len(port_scan.filters) == 1
    assert _pushed(port_scan) == _pushed(ref_scan)
    got = _rows(port_df)
    assert len(got) == 100 and got[0][0] == 900
    assert got == _rows(ref_df)


def test_residual_filter_stays(spark, port, sample_table, tmp_path):
    """Untranslatable conjuncts (arithmetic on columns) stay in the plan
    while translatable ones push down."""
    p = str(tmp_path / "t3.parquet")
    pq.write_table(sample_table, p)
    shapes = {}
    for name, sess, col, opt in (("ref", spark, RE.Col, ref_optimize),
                                 ("port", port, E.Col, port_optimize)):
        df = sess.read.parquet(p).filter(
            (col("id") >= 500) & (col("id") % 7 == 0))
        node = opt(df._plan)
        kinds = []
        while True:
            kinds.append(type(node).__name__)
            if not node.children():
                break
            node = node.children()[0]
        assert kinds[-1] == "UnresolvedScan" and node.filters
        assert "Filter" in kinds, "residual conjunct was dropped"
        shapes[name] = (kinds, _pushed(node),
                        sorted(r["id"] for r in df.select(col("id"))
                               .collect()))
    assert shapes["port"] == shapes["ref"]
    assert shapes["port"][2] == [i for i in range(500, 1000) if i % 7 == 0]


def test_decimal_and_date_literals_pushed(port, tmp_path):
    """A float literal against a decimal column reaches pyarrow as a
    Decimal, and a folded date expression as a date."""
    p = str(tmp_path / "dec.parquet")
    unscaled = np.arange(100, dtype=np.int64) * 7
    pq.write_table(pa.table({
        "price": pa.array([decimal.Decimal(int(u)).scaleb(-2)
                           for u in unscaled], pa.decimal128(12, 2)),
        "d": pa.array([datetime.date(1998, 1, 1)
                       + datetime.timedelta(days=int(i))
                       for i in range(100)]),
    }), p)
    port.read.parquet(p).createOrReplaceTempView("dec_t")
    df = port.sql("select count(*) as n from dec_t where price < 1.05 "
                  "and d <= date '1998-04-10' - interval 90 day")
    scan = _scan(port_optimize(df._plan), L.UnresolvedScan)
    assert len(scan.filters) == 2
    # price < 1.05: unscaled 0..98 step 7 -> 15 rows; d <= 1998-01-10
    assert df.collect()[0]["n"] == 10


def test_csv_roundtrip(spark, port, tmp_path):
    table = pa.table({
        "a": pa.array([1, 2, 3], pa.int64()),
        "b": pa.array(["x", "y", "z"]),
        "c": pa.array([1.5, -2.0, 0.25]),
    })
    got = {}
    for name, sess in (("ref", spark), ("port", port)):
        out = str(tmp_path / f"c_{name}")
        sess.createDataFrame(table).write.csv(out)
        got[name] = _rows(sess.read.csv(out))
    assert got["port"] == got["ref"] == [(1, "x", 1.5), (2, "y", -2.0),
                                         (3, "z", 0.25)]


def test_csv_explicit_schema(spark, port, tmp_path):
    p = str(tmp_path / "raw.csv")
    with open(p, "w") as f:
        f.write("a,b\n1,2.5\n3,4.5\n")
    df = port.read.csv(p, schema="a BIGINT, b DOUBLE")
    assert [f.dtype for f in df.schema] == [T.INT64, T.FLOAT64]
    assert df.count() == 2
    assert _rows(df) == _rows(spark.read.csv(p, schema="a BIGINT, b DOUBLE"))
    # no header: the declared names
    q = str(tmp_path / "nohdr.csv")
    with open(q, "w") as f:
        f.write("1,2.5\n3,4.5\n")
    df = port.read.option("header", "false").csv(q, schema="a BIGINT, "
                                                            "b DOUBLE")
    assert df.columns == ["a", "b"] and _rows(df) == [(1, 2.5), (3, 4.5)]


def test_json_roundtrip(spark, port, tmp_path):
    table = pa.table({
        "a": pa.array([10, 20], pa.int64()),
        "s": pa.array(["hello", "world"]),
    })
    got = {}
    for name, sess in (("ref", spark), ("port", port)):
        out = str(tmp_path / f"j_{name}")
        sess.createDataFrame(table).write.json(out)
        got[name] = _rows(sess.read.json(out))
    assert got["port"] == got["ref"] == [(10, "hello"), (20, "world")]
    # the same ndjson bytes (but for the part file's name)
    text = {name: open(os.path.join(tmp_path / f"j_{name}", os.listdir(
        tmp_path / f"j_{name}")[0])).read() for name in got}
    assert text["port"] == text["ref"]


def test_multifile_scan(spark, port, sample_table, tmp_path):
    d = tmp_path / "many"
    d.mkdir()
    for i in range(4):
        pq.write_table(sample_table.slice(i * 250, 250),
                       str(d / f"part{i}.parquet"))
    df = port.read.parquet(str(d))
    assert df.count() == 1000
    assert df.agg(F.sum("id").alias("s")).collect()[0]["s"] == \
        999 * 1000 // 2
    ref = spark.read.parquet(str(d))
    assert _rows(df.groupBy("name").agg(F.count("*").alias("n"),
                                        F.max("day").alias("mx"))) == \
        _rows(ref.groupBy("name").agg(RF.count("*").alias("n"),
                                      RF.max("day").alias("mx")))


def test_reread_after_rewrite_not_stale(port, tmp_path):
    """A source must not serve a cached batch after its files were
    rewritten (the freshness fingerprint of io/fingerprint.py)."""
    path = str(tmp_path / "t")
    port.range(5).write.parquet(path)
    df = port.read.parquet(path)
    assert df.count() == 5
    time.sleep(0.01)  # let mtime_ns move even on coarse clocks
    port.range(9).write.mode("overwrite").parquet(path)
    assert df.count() == 9
    assert port.read.parquet(path).count() == 9


def test_orc_roundtrip(spark, port, tmp_path):
    """ORC read and write through pyarrow's C++ ORC reader."""
    got = {}
    for name, sess in (("ref", spark), ("port", port)):
        path = str(tmp_path / f"orc_{name}")
        sess.range(20).withColumnRenamed("id", "n").write.orc(path)
        back = sess.read.orc(path)
        assert back.count() == 20
        # pushdown applies to ORC too
        assert back.filter("n >= 15").count() == 5
        got[name] = _rows(back)
    assert got["port"] == got["ref"] == [(i,) for i in range(20)]
    with pytest.raises(NotImplementedError, match="partitionBy"):
        port.range(3).write.partitionBy("id").orc(str(tmp_path / "p"))


def test_duplicate_dictionary_values_collapse(spark, port):
    """Pre-encoded dictionaries may carry duplicate values: equal strings
    collapse to one code, or GROUP BY and DISTINCT would split groups."""
    arr = pa.DictionaryArray.from_arrays(
        pa.array([0, 1, 2, 3], pa.int32()),
        pa.array(["x", "y", "x", "y"]))  # duplicate values, distinct codes
    got = {}
    for name, sess in (("ref", spark), ("port", port)):
        df = sess.createDataFrame(pa.table({"s": arr}))
        got[name] = (sorted((r["s"], r["count"])
                            for r in df.groupBy("s").count().collect()),
                     df.select("s").distinct().count())
    assert got["port"] == got["ref"] == ([("x", 2), ("y", 2)], 2)


def test_count_rows_and_iter_batches(port, sample_table, tmp_path):
    p = str(tmp_path / "it.parquet")
    pq.write_table(sample_table, p, row_group_size=128)
    src = FileSource("parquet", [p])
    assert src.count_rows() == 1000
    assert src.count_rows((E.Col("grp") == 3,)) == \
        int(sum(1 for g in sample_table.column("grp").to_pylist() if g == 3))
    chunks = list(src.iter_batches(("id",), (E.Col("id") < 700,),
                                   rows_per_chunk=300))
    assert [c.num_rows for c in chunks] == [300, 300, 100]
    assert pa.concat_tables(chunks).column("id").to_pylist() == \
        list(range(700))


def test_read_cache_keyed_by_device(sample_table, tmp_path):
    """The source caches device batches by device, columns and filters:
    a batch read for one device is never served to another."""
    p = str(tmp_path / "dev.parquet")
    pq.write_table(sample_table, p)
    src = FileSource("parquet", [p])
    meta = src.read(("id", "val"), (), torch.device("meta"))
    assert meta.data.row_mask.device.type == "meta"
    cpu = src.read(("id", "val"), (), torch.device("cpu"))
    assert cpu.data.row_mask.device.type == "cpu"
    assert src.read(("id", "val"), (), torch.device("cpu")) is cpu
    assert src.last_read["rows"] == 1000
    assert src.last_read["decode_ms"] >= 0 <= src.last_read["transfer_ms"]
    for i in range(5):  # the cache keeps the four newest reads
        src.read(("id",), (E.Col("id") >= i,), torch.device("cpu"))
    assert len(src._cache) == 4
    assert src.read(("id", "val"), (), torch.device("cpu")) is not cpu


# ---- TPC-H from Parquet -------------------------------------------------------

SF = 0.02
SEED = 99


@pytest.fixture(scope="module")
def tpch_parquet(tmp_path_factory):
    """The eight tables in memory on one CPU session, and written to
    Parquet by the port and read back on another."""
    from spark_tpu_torch.tpch import generate_tables, register_views

    tables = generate_tables(SF, seed=SEED)
    mem = PortSession(device="cpu")
    register_views(mem, tables)
    root = tmp_path_factory.mktemp("tpch")
    files = PortSession(device="cpu")
    for name in tables:
        mem.table(name).write.parquet(str(root / name))
        files.read.parquet(str(root / name)).createOrReplaceTempView(name)
    return tables, mem, files


@pytest.mark.parametrize("name", ["q1", "q1_wide", "q3", "q5"])
def test_tpch_from_parquet_matches_in_memory(tpch_parquet, name):
    from spark_tpu_torch.tpch import Q1_WIDE, QUERIES
    from spark_tpu_torch.tpch.oracle import (assert_rows_match,
                                             load_sqlite, run_oracle)

    tables, mem, files = tpch_parquet
    query = Q1_WIDE if name == "q1_wide" else QUERIES[int(name[1:])]
    got = [tuple(r) for r in files.sql(query).collect()]
    assert got and got == [tuple(r) for r in mem.sql(query).collect()]
    # the scans read only the columns the query needs
    plan = port_optimize(files.sql(query)._plan)
    for scan in L.collect_nodes(plan, L.UnresolvedScan):
        assert scan.columns is not None
        assert not {"l_comment", "o_comment", "c_comment"} & \
            set(scan.columns)
    if name != "q1_wide":
        conn = load_sqlite({t: tables[t] for t in
                            ("lineitem", "orders", "customer", "supplier",
                             "nation", "region")})
        conn.execute("pragma case_sensitive_like = on")
        try:
            assert_rows_match(got, run_oracle(conn, query),
                              label=f"{name}[sqlite]")
        finally:
            conn.close()


def test_tpch_parquet_dictionaries(tpch_parquet):
    """Each string column read back holds the in-memory table's values:
    the rows and every dictionary's contents are equal (the codes may
    differ)."""
    tables, mem, files = tpch_parquet
    for name in ("lineitem", "nation"):
        a = files.table(name)._execute()
        b = mem.table(name)._execute()
        for fa, fb in zip(a.schema.fields, b.schema.fields):
            assert fa.name == fb.name and fa.dtype == fb.dtype
            if fa.dictionary is not None:
                assert fa.dictionary == fb.dictionary, fa.name
        assert [tuple(r) for r in files.table(name).collect()] == \
            [tuple(r) for r in mem.table(name).collect()]


def test_parquet_dictionary_chunks_and_schema(tpch_parquet, tmp_path):
    """Dictionary-typed string columns written by pyarrow come back as
    one dictionary per row group; plain strings under a user-supplied
    schema. Both give the in-memory table's rows and dictionaries."""
    tables, mem, _ = tpch_parquet
    port = PortSession(device="cpu")
    p = str(tmp_path / "orders.parquet")
    pq.write_table(tables["orders"], p, row_group_size=5000)
    chunks = pq.read_table(p).column("o_orderpriority").chunks
    assert len(chunks) > 1 and pa.types.is_dictionary(chunks[0].type)
    nation = str(tmp_path / "nation.parquet")
    pq.write_table(tables["nation"], nation)
    schema = ("n_nationkey BIGINT, n_name STRING, n_regionkey BIGINT, "
              "n_comment STRING")
    for name, df in (("orders", port.read.parquet(p)),
                     ("nation", port.read.schema(schema).parquet(nation))):
        a, b = df._execute(), mem.table(name)._execute()
        assert [f.dictionary for f in a.schema.fields] == \
            [f.dictionary for f in b.schema.fields]
        assert [tuple(r) for r in df.collect()] == \
            [tuple(r) for r in mem.table(name).collect()]


def test_dataframe_queries_from_parquet(tpch_parquet, tmp_path):
    """The io phase's DataFrame-API queries (tpch/queries.py) over the
    Parquet files equal q1's and q3's SQL rows over the in-memory tables,
    and the flagship stage over a Parquet file its in-memory run."""
    from spark_tpu_torch.tpch import QUERIES
    from spark_tpu_torch.tpch.queries import (DATAFRAME_QUERIES,
                                              flagship_table)

    _, mem, files = tpch_parquet
    for name, sql in (("df_q1", QUERIES[1]), ("df_q3", QUERIES[3])):
        got = [tuple(r) for r in DATAFRAME_QUERIES[name](files).collect()]
        assert got and got == [tuple(r) for r in mem.sql(sql).collect()]
    flag = flagship_table(20_000, seed=3)
    pq.write_table(flag, str(tmp_path / "flagship.parquet"))
    mem.createDataFrame(flag).createOrReplaceTempView("flagship")
    files.read.parquet(str(tmp_path / "flagship.parquet")) \
        .createOrReplaceTempView("flagship")
    got, want = ([tuple(r) for r in DATAFRAME_QUERIES["df_flagship"](s)
                  .collect()] for s in (files, mem))
    assert len(got) == 4 and got == want
