"""The port's structured streaming (``spark_tpu_torch/streaming/``) on the
cases of tests/test_streaming.py: incremental grouped aggregates in
complete mode, stateless append, checkpoints and the exactly-once
restart, the watermark's append mode over tumbling and session windows,
late rows, a restart that keeps the watermark, the batch ``F.window``,
the rejected shapes, the processing-time timeout of
``applyInPandasWithState``, the rate source and a stream on a CPU mesh.

Held against the reference: each scenario below runs, as written, through
both packages (the same MemoryStream batches, the same triggers), and
their sink rows are compared. Tolerance: integers, strings and nulls
exact; an average is a sum over a count in both packages, so it is exact
too; a float sum is rel 1e-6 (the summation order differs). The
reference's scenarios run once per module (``ref``), so its compiles are
paid once. State carried across: the port resumes a streaming aggregate
from a checkpoint directory the reference wrote after two triggers, and
after two more triggers its rows equal the reference's own run.
"""

import math

import numpy as np
import pyarrow as pa
import pytest

from spark_tpu.api import functions as RF
from spark_tpu.streaming import MemoryStream as RefStream
from spark_tpu_torch.api import functions as F
from spark_tpu_torch.api.session import SparkSession
from spark_tpu_torch.streaming import MemoryStream

from test_torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.timeout(300)


@pytest.fixture(scope="module")
def port():
    return SparkSession(device="cpu")


class _Ref:
    """Each reference scenario's result, computed on first use."""

    def __init__(self, spark):
        self._spark = spark
        self._out = {}

    def __call__(self, scenario):
        if scenario.__name__ not in self._out:
            self._out[scenario.__name__] = scenario(
                self._spark, RefStream, RF, "ref")
        return self._out[scenario.__name__]


@pytest.fixture(scope="module")
def ref(spark):
    return _Ref(spark)


def _rows(spark, name):
    return sorted(tuple(r.asDict().values())
                  for r in spark.sql(f"select * from {name}").collect())


def _both(port, ref, scenario):
    got = scenario(port, MemoryStream, F, "port")
    assert got == ref(scenario)
    return got


# ---- scenarios (each runs through either package) ---------------------------


def s_grouped_count(spark, MS, Fn, tag):
    src = MS(pa.schema([("k", pa.string()), ("v", pa.int64())]))
    agg = spark.readStream.load(src).groupBy("k").agg(
        Fn.count("v").alias("n"), Fn.sum("v").alias("s"))
    name = f"cnt1_{tag}"
    q = agg.writeStream.outputMode("complete").queryName(name).start()
    out = []
    src.add_data([{"k": "a", "v": 1}, {"k": "b", "v": 2}])
    q.process_all_available()
    out.append(_rows(spark, name))
    src.add_data([{"k": "a", "v": 10}])
    q.process_all_available()
    out.append(_rows(spark, name))
    q.process_all_available()  # no new data: no state change
    out.append(_rows(spark, name))
    return out


def s_avg_min_max(spark, MS, Fn, tag):
    src = MS(pa.schema([("k", pa.string()), ("v", pa.int64())]))
    agg = spark.readStream.load(src).groupBy("k").agg(
        Fn.avg("v").alias("a"), Fn.min("v").alias("lo"),
        Fn.max("v").alias("hi"))
    name = f"avg1_{tag}"
    q = agg.writeStream.outputMode("complete").queryName(name).start()
    src.add_data([{"k": "x", "v": 10}, {"k": "x", "v": 20}])
    q.process_all_available()
    src.add_data([{"k": "x", "v": 60}, {"k": "y", "v": 5}])
    q.process_all_available()
    return _rows(spark, name)


def s_stateless_append(spark, MS, Fn, tag):
    src = MS(pa.schema([("v", pa.int64())]))
    df = spark.readStream.load(src).filter(Fn.col("v") % 2 == 0) \
        .select((Fn.col("v") * 10).alias("w"))
    name = f"flt1_{tag}"
    q = df.writeStream.outputMode("append").queryName(name).start()
    src.add_data([{"v": i} for i in range(5)])
    q.process_all_available()
    src.add_data([{"v": 6}])
    q.process_all_available()
    return _rows(spark, name)


def _seeded_batches(n_batches=3, rows=200, seed=16):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        out.append(pa.table({
            "k": pa.array([f"g{int(i)}" for i in rng.integers(0, 9, rows)]),
            "v": pa.array(rng.integers(-500, 500, rows), pa.int64()),
            "f": pa.array(rng.standard_normal(rows), pa.float64())}))
    return out


def s_seeded_aggregate(spark, MS, Fn, tag):
    batches = _seeded_batches()
    src = MS(batches[0].schema)
    agg = spark.readStream.load(src).groupBy("k").agg(
        Fn.count("v").alias("n"), Fn.sum("v").alias("s"),
        Fn.avg("v").alias("a"), Fn.min("v").alias("lo"),
        Fn.max("f").alias("hi"), Fn.sum("f").alias("fs"))
    name = f"seed1_{tag}"
    q = agg.writeStream.outputMode("complete").queryName(name).start()
    out = []
    for b in batches:
        src.add_data(b)
        q.process_all_available()
        out.append(_rows(spark, name))
    return out


def s_watermark_windows(spark, MS, Fn, tag):
    src = MS(pa.schema([("ts", pa.int64()), ("v", pa.int64())]))
    df = spark.readStream.load(src).withWatermark("ts", 10)
    agg = df.groupBy(Fn.window(Fn.col("ts"), 10).alias("wstart")) \
        .agg(Fn.count("v").alias("n"))
    name = f"wm1_{tag}"
    q = agg.writeStream.outputMode("append").queryName(name).start()
    out = []
    for data in ([{"ts": 1, "v": 1}, {"ts": 5, "v": 1}, {"ts": 12, "v": 1}],
                 [{"ts": 25, "v": 1}], [{"ts": 41, "v": 1}]):
        src.add_data(data)
        q.process_all_available()
        out.append(_rows(spark, name))
    return out


def s_late_rows(spark, MS, Fn, tag):
    src = MS(pa.schema([("ts", pa.int64()), ("v", pa.int64())]))
    df = spark.readStream.load(src).withWatermark("ts", 0)
    agg = df.groupBy(Fn.window(Fn.col("ts"), 10).alias("w")) \
        .agg(Fn.count("v").alias("n"))
    name = f"late1_{tag}"
    q = agg.writeStream.outputMode("append").queryName(name).start()
    for data in ([{"ts": 5, "v": 1}, {"ts": 6, "v": 1}], [{"ts": 25, "v": 1}],
                 [{"ts": 6, "v": 1}], [{"ts": 100, "v": 1}]):
        src.add_data(data)
        q.process_all_available()
    return _rows(spark, name)


def s_session_merging(spark, MS, Fn, tag):
    src = MS(pa.schema([("ts", pa.int64()), ("k", pa.string()),
                        ("v", pa.int64())]))
    df = spark.readStream.load(src).withWatermark("ts", 0)
    sess = Fn.session_window(Fn.col("ts"), 5).alias("sstart")
    agg = df.groupBy(sess, Fn.col("k")).agg(Fn.count("v").alias("n"),
                                            Fn.sum("v").alias("s"))
    name = f"sw1_{tag}"
    q = agg.writeStream.outputMode("append").queryName(name).start()
    for data in ([{"ts": 1, "k": "a", "v": 10}, {"ts": 3, "k": "a", "v": 20},
                  {"ts": 2, "k": "b", "v": 5}],
                 [{"ts": 6, "k": "a", "v": 30}],
                 [{"ts": 30, "k": "c", "v": 1}]):
        src.add_data(data)
        q.process_all_available()
    return _rows(spark, name)


def s_session_gap_split(spark, MS, Fn, tag):
    src = MS(pa.schema([("ts", pa.int64()), ("v", pa.int64())]))
    df = spark.readStream.load(src).withWatermark("ts", 0)
    agg = df.groupBy(Fn.session_window(Fn.col("ts"), 3).alias("st")) \
        .agg(Fn.count("v").alias("n"))
    name = f"sw2_{tag}"
    q = agg.writeStream.outputMode("append").queryName(name).start()
    src.add_data([{"ts": 1, "v": 1}, {"ts": 2, "v": 1},
                  {"ts": 10, "v": 1}, {"ts": 12, "v": 1}])
    q.process_all_available()
    src.add_data([{"ts": 50, "v": 1}])
    q.process_all_available()
    return _rows(spark, name)


def s_batch_window(spark, MS, Fn, tag):
    df = spark.createDataFrame([{"ts": t} for t in (1, 5, 12, 25, -3)])
    out = df.groupBy(Fn.window("ts", 10).alias("w")) \
        .agg(Fn.count("ts").alias("n")).orderBy("w")
    return [(r.w, r.n) for r in out.collect()]


# ---- tests ------------------------------------------------------------------------


def test_incremental_grouped_count(port, ref):
    got = _both(port, ref, s_grouped_count)
    assert got[0] == [("a", 1, 1), ("b", 1, 2)]
    assert got[1] == got[2] == [("a", 2, 11), ("b", 1, 2)]


def test_incremental_avg_min_max(port, ref):
    got = _both(port, ref, s_avg_min_max)
    assert got == [("x", 30.0, 10, 60), ("y", 5.0, 5, 5)]


def test_stateless_append(port, ref):
    assert _both(port, ref, s_stateless_append) == [(0,), (20,), (40,),
                                                    (60,)]


def test_seeded_aggregate_matches_reference(port, ref):
    """Three seeded micro-batches of 200 rows: counts, integer sums,
    averages, minima and float maxima exact; the float sum rel 1e-6."""
    got = s_seeded_aggregate(port, MemoryStream, F, "port")
    want = ref(s_seeded_aggregate)
    assert len(got) == len(want) == 3
    for g_step, w_step in zip(got, want):
        assert [r[:5] for r in g_step] == [r[:5] for r in w_step]
        for g, w in zip(g_step, w_step):
            assert math.isclose(g[5], w[5], rel_tol=1e-6, abs_tol=1e-9)


def test_checkpoint_restart_exactly_once(port, tmp_path):
    ckpt = str(tmp_path / "ck")
    src = MemoryStream(pa.schema([("k", pa.string()), ("v", pa.int64())]))
    agg = port.readStream.load(src).groupBy("k").agg(F.sum("v").alias("s"))
    q = agg.writeStream.outputMode("complete").queryName("ck1") \
        .option("checkpointLocation", ckpt).start()
    src.add_data([{"k": "a", "v": 5}])
    q.process_all_available()
    src.add_data([{"k": "a", "v": 7}])
    q.process_all_available()
    assert _rows(port, "ck1") == [("a", 12)]
    q.stop()
    # a restart from the checkpoint: the state comes back, processed
    # offsets are not processed again, new data continues the totals
    q2 = agg.writeStream.outputMode("complete").queryName("ck2") \
        .option("checkpointLocation", ckpt).start()
    q2.process_all_available()
    assert _rows(port, "ck2") == [("a", 12)]
    src.add_data([{"k": "a", "v": 1}])
    q2.process_all_available()
    assert _rows(port, "ck2") == [("a", 13)]


def _resume_batches():
    rng = np.random.default_rng(23)
    return [pa.table({
        "k": pa.array([f"r{int(i)}" for i in rng.integers(0, 6, 64)]),
        "v": pa.array(rng.integers(0, 1000, 64), pa.int64())})
        for _ in range(4)]


def test_resume_from_reference_checkpoint(port, spark, tmp_path):
    """The reference writes a checkpoint after two triggers; the port
    resumes from it (state Parquet, offset and commit logs) and takes two
    more; its rows equal the reference's own four-trigger run, exactly
    (counts, integer sums, minima and maxima)."""
    batches = _resume_batches()

    def agg_of(sess, MS, Fn):
        src = MS(batches[0].schema)
        return src, sess.readStream.load(src).groupBy("k").agg(
            Fn.count("v").alias("n"), Fn.sum("v").alias("s"),
            Fn.min("v").alias("lo"), Fn.max("v").alias("hi"))

    ckpt = str(tmp_path / "shared")
    rsrc, ragg = agg_of(spark, RefStream, RF)
    rq = ragg.writeStream.outputMode("complete").queryName("res_ref") \
        .option("checkpointLocation", ckpt).start()
    for b in batches[:2]:
        rsrc.add_data(b)
        rq.process_all_available()
    rq.stop()
    for b in batches[2:]:  # the reference's own continuation
        rsrc.add_data(b)
    rq2 = ragg.writeStream.outputMode("complete").queryName("res_ref2") \
        .option("checkpointLocation", str(tmp_path / "own")).start()
    rq2.process_all_available()
    want = _rows(spark, "res_ref2")

    psrc, pagg = agg_of(port, MemoryStream, F)
    for b in batches[:2]:
        psrc.add_data(b)  # the offsets the reference consumed
    pq_ = pagg.writeStream.outputMode("complete").queryName("res_port") \
        .option("checkpointLocation", ckpt).start()
    assert pq_._batch_id == 1  # resumed after the reference's commits
    for b in batches[2:]:
        psrc.add_data(b)
        pq_.process_all_available()
    assert [t["batch"] for t in pq_.trigger_log] == [2, 3]
    assert _rows(port, "res_port") == want


def test_watermark_append_mode_evicts_closed_windows(port, ref):
    got = _both(port, ref, s_watermark_windows)
    assert got == [[], [(0, 2)], [(0, 2), (10, 1), (20, 1)]]


def test_streaming_on_mesh(port):
    """The same incremental machinery over a CPU mesh of four ranks: the
    rows equal the single-device run's and the hand-computed sums."""
    from spark_tpu_torch.expr import expressions as E
    from spark_tpu_torch.plan import logical as L
    from spark_tpu_torch.streaming.execution import (StreamingQuery,
                                                     StreamingSource)

    mesh = (SparkSession.builder.device("cpu").master("mesh[4]")
            .meshDevices(["cpu"] * 4).getOrCreate())
    try:
        out = {}
        for sess in (port, mesh):
            src = MemoryStream(pa.schema([("k", pa.int64()),
                                          ("v", pa.int64())]))
            plan = L.Aggregate((E.Col("k"),),
                               (E.Col("k"), E.Alias(E.Sum(E.Col("v")), "s")),
                               StreamingSource(src))
            name = f"mesh1_{id(sess)}"
            q = StreamingQuery(sess, plan, name, "complete")
            src.add_data([{"k": i % 3, "v": i} for i in range(30)])
            q.process_all_available()
            src.add_data([{"k": 0, "v": 1000}])
            q.process_all_available()
            out[sess is mesh] = dict(_rows(sess, name))
        assert out[True] == out[False]
        assert out[True][0] == sum(i for i in range(30) if i % 3 == 0) + 1000
        assert out[True][1] == sum(i for i in range(30) if i % 3 == 1)
    finally:
        mesh.stop()


def test_rate_source_schema(port, spark):
    df = port.readStream.format("rate").option("rowsPerSecond", 5).load()
    assert df.isStreaming
    ref_df = spark.readStream.format("rate").option("rowsPerSecond", 5).load()
    assert list(df._plan.schema.names) == list(ref_df._plan.schema.names) \
        == ["timestamp", "value"]


def test_late_rows_below_watermark_dropped(port, ref):
    assert _both(port, ref, s_late_rows) == [(0, 2), (20, 1)]


def test_watermark_survives_restart(port, tmp_path):
    ckpt = str(tmp_path / "wmck")
    src = MemoryStream(pa.schema([("ts", pa.int64()), ("v", pa.int64())]))
    df = port.readStream.load(src).withWatermark("ts", 0)
    agg = df.groupBy(F.window(F.col("ts"), 10).alias("w")) \
        .agg(F.count("v").alias("n"))
    q = agg.writeStream.outputMode("append").queryName("wr1") \
        .option("checkpointLocation", ckpt).start()
    src.add_data([{"ts": 5, "v": 1}, {"ts": 25, "v": 1}])
    q.process_all_available()
    q.stop()
    q2 = agg.writeStream.outputMode("append").queryName("wr2") \
        .option("checkpointLocation", ckpt).start()
    assert q2._max_event_time == 25  # from the commit log
    src.add_data([{"ts": 3, "v": 1}])  # late after the restart: dropped
    q2.process_all_available()
    src.add_data([{"ts": 100, "v": 1}])
    q2.process_all_available()
    assert _rows(port, "wr2") == [(20, 1)]


def test_batch_window_function(port, ref):
    """``F.window`` in a batch query: the window start ``ts - ts % 10``,
    with the reference's truncating modulo for a negative time."""
    assert _both(port, ref, s_batch_window) == [(0, 3), (10, 1), (20, 1)]


def test_update_mode_with_agg_rejected(port):
    src = MemoryStream(pa.schema([("k", pa.int64())]))
    agg = port.readStream.load(src).groupBy("k").agg(
        F.count("k").alias("n"))
    with pytest.raises(NotImplementedError):
        agg.writeStream.outputMode("update").queryName("u1").start()


def test_ops_above_streaming_agg_rejected(port):
    src = MemoryStream(pa.schema([("k", pa.int64())]))
    agg = port.readStream.load(src).groupBy("k") \
        .agg(F.count("k").alias("n")).filter(F.col("n") > 5)
    with pytest.raises(NotImplementedError):
        agg.writeStream.outputMode("complete").queryName("x1").start()


def test_append_agg_without_time_key_rejected(port):
    src = MemoryStream(pa.schema([("k", pa.int64())]))
    agg = port.readStream.load(src).groupBy("k") \
        .agg(F.count("k").alias("n"))
    with pytest.raises(NotImplementedError):
        agg.writeStream.outputMode("append").queryName("x2").start()


def test_session_window_merging(port, ref):
    got = dict(((s, k), (n, v)) for s, k, n, v in
               _both(port, ref, s_session_merging))
    assert got[(1, "a")] == (3, 60)  # merged across two batches
    assert got[(2, "b")] == (1, 5)


def test_session_window_gap_split(port, ref):
    assert _both(port, ref, s_session_gap_split) == [(1, 2), (10, 2)]


def test_flat_map_groups_processing_time_timeout(port):
    import pandas as pd

    src = MemoryStream(pa.schema([("k", pa.string()), ("v", pa.int64())]))

    def fn(key, pdf, state):
        if state.hasTimedOut:
            total = state.get()
            state.remove()
            return pd.DataFrame({"k": [key[0]], "total": [total],
                                 "reason": ["timeout"]})
        cur = state.getOption() or 0
        state.update(cur + int(pdf["v"].sum()))
        state.setTimeoutDuration(0)  # expires at the next batch
        return None

    q = (port.readStream.load(src).groupBy("k")
         .applyInPandasWithState(fn, "k string, total bigint, reason string",
                                 timeoutConf="ProcessingTimeTimeout")
         .writeStream.outputMode("append").queryName("fmt1").start())
    src.add_data([{"k": "a", "v": 1}, {"k": "a", "v": 2}])
    q.process_all_available()
    assert port.sql("select * from fmt1").collect() == []
    src.add_data([{"k": "b", "v": 9}])  # a's deadline passed: it fires
    q.process_all_available()
    assert _rows(port, "fmt1") == [("a", 3, "timeout")]
    src.add_data([{"k": "a", "v": 7}])  # a's state is gone: a new sum
    q.process_all_available()
    src.add_data([{"k": "c", "v": 1}])
    q.process_all_available()
    assert ("a", 7, "timeout") in _rows(port, "fmt1")


def test_trigger_log_records_each_micro_batch(port):
    """Each trigger's wall, host Arrow time and planner runs; a
    micro-batch brings new leaves, so it is a first run and captures
    nothing."""
    src = MemoryStream(pa.schema([("k", pa.int64()), ("v", pa.int64())]))
    agg = port.readStream.load(src).groupBy("k").agg(F.sum("v").alias("s"))
    q = agg.writeStream.outputMode("complete").queryName("tl1").start()
    for i in range(3):
        src.add_data([{"k": j % 2, "v": i * 10 + j} for j in range(8)])
        q.process_all_available()
    log = q.trigger_log
    assert [t["batch"] for t in log] == [0, 1, 2]
    for t in log:
        assert t["wall_ms"] >= t["arrow_ms"] > 0
        assert t["runs"] >= 2 and t["captured"] == t["replayed"] == 0
