"""The port's stream-stream joins (``spark_tpu_torch/streaming/join.py``)
on the cases of tests/test_stream_join.py: inner joins across batches,
both sides in one batch, the watermark bounding the state, a checkpoint
restart, the rejected outer shapes, left, right and full outer joins
emitting null-padded rows on eviction, and a projection below the join.

Held against the reference: each scenario runs, as written, through both
packages (the same MemoryStream batches and triggers); the sink rows,
nulls included, are equal exactly (integer columns only). A seeded
inner join of 400 rows a side over four triggers is held the same way.
"""

import numpy as np
import pyarrow as pa
import pytest

from spark_tpu.streaming import MemoryStream as RefStream
from spark_tpu_torch.api.session import SparkSession
from spark_tpu_torch.streaming import MemoryStream

from test_torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.timeout(300)


@pytest.fixture(scope="module")
def port():
    return SparkSession(device="cpu")


@pytest.fixture(scope="module")
def ref(spark):
    out = {}

    def get(scenario):
        if scenario.__name__ not in out:
            out[scenario.__name__] = scenario(spark, RefStream, "ref")
        return out[scenario.__name__]

    return get


def _both(port, ref, scenario):
    got = scenario(port, MemoryStream, "port")
    assert got == ref(scenario)
    return got


def _sel(spark, sql):
    return sorted(tuple(r) for r in spark.sql(sql).collect())


def _sources(spark, MS):
    left = MS(pa.schema([("k", pa.int64()), ("lv", pa.int64())]))
    right = MS(pa.schema([("k", pa.int64()), ("rv", pa.int64())]))
    return left, right, spark.readStream.load(left), \
        spark.readStream.load(right)


def _timed(spark, MS, lcol="t", rcol="t"):
    left = MS(pa.schema([(lcol, pa.int64()), ("k", pa.int64()),
                         ("lv", pa.int64())]))
    right = MS(pa.schema([(rcol, pa.int64()), ("k", pa.int64()),
                          ("rv", pa.int64())]))
    return left, right


# ---- scenarios ---------------------------------------------------------------


def s_inner_across_batches(spark, MS, tag):
    left, right, ldf, rdf = _sources(spark, MS)
    name = f"ssj1_{tag}"
    q = ldf.join(rdf, on="k").writeStream \
        .outputMode("append").queryName(name).start()
    out = []
    left.add_data([{"k": 1, "lv": 10}, {"k": 2, "lv": 20}])
    q.processAllAvailable()
    out.append(spark.table(name).count())
    right.add_data([{"k": 1, "rv": 100}])
    q.processAllAvailable()
    out.append(_sel(spark, f"select k, lv, rv from {name}"))
    left.add_data([{"k": 1, "lv": 11}])  # meets the old right state
    q.processAllAvailable()
    out.append(_sel(spark, f"select k, lv, rv from {name}"))
    return out


def s_same_batch(spark, MS, tag):
    left, right, ldf, rdf = _sources(spark, MS)
    name = f"ssj2_{tag}"
    q = ldf.join(rdf, on="k").writeStream \
        .outputMode("append").queryName(name).start()
    left.add_data([{"k": 5, "lv": 1}])
    right.add_data([{"k": 5, "rv": 2}])
    q.processAllAvailable()
    return _sel(spark, f"select k, lv, rv from {name}")


def s_watermark_bounds(spark, MS, tag):
    left = MS(pa.schema([("t", pa.int64()), ("k", pa.int64())]))
    right = MS(pa.schema([("t", pa.int64()), ("k", pa.int64()),
                          ("rv", pa.int64())]))
    ldf = spark.readStream.load(left).withWatermark("t", 10)
    rdf = spark.readStream.load(right).withWatermark("t", 10)
    name = f"ssj3_{tag}"
    q = ldf.join(rdf.drop("t"), on="k").writeStream \
        .outputMode("append").queryName(name).start()
    out = []
    left.add_data([{"t": 0, "k": 1}])
    right.add_data([{"t": 0, "k": 1, "rv": 7}])
    q.processAllAvailable()
    out.append(spark.table(name).count())
    left.add_data([{"t": 100, "k": 2}])  # far past the watermark
    right.add_data([{"t": 100, "k": 2, "rv": 8}])
    q.processAllAvailable()
    out.append(sorted(q._load_state(q._batch_id)[0].column("t")
                      .to_pylist()))
    right.add_data([{"t": 100, "k": 1, "rv": 9}])  # misses evicted left
    q.processAllAvailable()
    out.append(_sel(spark, f"select k, rv from {name}"))
    return out


def s_left_outer(spark, MS, tag):
    left, right = _timed(spark, MS)
    ldf = spark.readStream.load(left).withWatermark("t", 10)
    rdf = spark.readStream.load(right).withWatermark("t", 10).drop("t")
    name = f"sslo_{tag}"
    q = ldf.join(rdf, on="k", how="left").writeStream \
        .outputMode("append").queryName(name).start()
    out = []
    left.add_data([{"t": 0, "k": 1, "lv": 10}, {"t": 0, "k": 2, "lv": 20}])
    right.add_data([{"t": 0, "k": 1, "rv": 100}])
    q.processAllAvailable()
    out.append(_sel(spark, f"select k, lv, rv from {name}"))
    left.add_data([{"t": 100, "k": 9, "lv": 90}])
    right.add_data([{"t": 100, "k": 9, "rv": 900}])
    q.processAllAvailable()
    out.append(_sel(spark, f"select k, lv, rv from {name}"))
    return out


def s_right_outer(spark, MS, tag):
    left, right = _timed(spark, MS, "t", "t2")
    ldf = spark.readStream.load(left).withWatermark("t", 10).drop("t")
    rdf = spark.readStream.load(right).withWatermark("t2", 10)
    name = f"ssro_{tag}"
    q = ldf.join(rdf, on="k", how="right").writeStream \
        .outputMode("append").queryName(name).start()
    out = []
    left.add_data([{"t": 0, "k": 1, "lv": 10}])
    right.add_data([{"t2": 0, "k": 1, "rv": 100},
                    {"t2": 0, "k": 2, "rv": 200}])
    q.processAllAvailable()
    out.append(_sel(spark, f"select k, lv, rv from {name}"))
    left.add_data([{"t": 100, "k": 9, "lv": 90}])
    right.add_data([{"t2": 100, "k": 9, "rv": 900}])
    q.processAllAvailable()
    out.append(_sel(spark, f"select k, lv, rv from {name}"))
    return out


def s_full_outer(spark, MS, tag):
    left, right = _timed(spark, MS, "t", "t2")
    ldf = spark.readStream.load(left).withWatermark("t", 10)
    rdf = spark.readStream.load(right).withWatermark("t2", 10)
    name = f"ssfo_{tag}"
    q = ldf.join(rdf, on="k", how="full").writeStream \
        .outputMode("append").queryName(name).start()
    out = []
    left.add_data([{"t": 0, "k": 1, "lv": 10}, {"t": 0, "k": 2, "lv": 20}])
    right.add_data([{"t2": 0, "k": 1, "rv": 100},
                    {"t2": 0, "k": 3, "rv": 300}])
    q.processAllAvailable()
    out.append(_sel(spark, f"select k, lv, rv from {name}"))
    left.add_data([{"t": 100, "k": 9, "lv": 90}])
    right.add_data([{"t2": 100, "k": 9, "rv": 900}])
    q.processAllAvailable()
    out.append(_sel(spark, f"select k, lv, rv from {name}"))
    return out


def s_projection_below(spark, MS, tag):
    left, right, ldf, rdf = _sources(spark, MS)
    ldf2 = ldf.withColumnRenamed("lv", "value").filter("k > 0")
    name = f"ssj5_{tag}"
    q = ldf2.join(rdf, on="k").writeStream \
        .outputMode("append").queryName(name).start()
    left.add_data([{"k": -1, "lv": 1}, {"k": 3, "lv": 2}])
    right.add_data([{"k": 3, "rv": 5}, {"k": -1, "rv": 6}])
    q.processAllAvailable()
    return _sel(spark, f"select k, value, rv from {name}")


def s_seeded_inner(spark, MS, tag):
    rng = np.random.default_rng(61)
    left, right, ldf, rdf = _sources(spark, MS)
    name = f"ssj6_{tag}"
    q = ldf.join(rdf, on="k").writeStream \
        .outputMode("append").queryName(name).start()
    for _ in range(4):
        left.add_data(pa.table({
            "k": pa.array(rng.integers(0, 40, 100), pa.int64()),
            "lv": pa.array(rng.integers(0, 1 << 20, 100), pa.int64())}))
        right.add_data(pa.table({
            "k": pa.array(rng.integers(0, 40, 100), pa.int64()),
            "rv": pa.array(rng.integers(0, 1 << 20, 100), pa.int64())}))
        q.processAllAvailable()
    return _sel(spark, f"select k, lv, rv from {name}")


# ---- tests --------------------------------------------------------------------


def test_inner_join_across_batches(port, ref):
    got = _both(port, ref, s_inner_across_batches)
    assert got == [0, [(1, 10, 100)], [(1, 10, 100), (1, 11, 100)]]


def test_same_batch_both_sides_no_duplicates(port, ref):
    assert _both(port, ref, s_same_batch) == [(5, 1, 2)]


def test_watermark_bounds_state(port, ref):
    count, state_ts, rows = _both(port, ref, s_watermark_bounds)
    assert count == 1
    assert all(t >= 90 for t in state_ts)
    assert (1, 9) not in rows


def test_checkpoint_restart(port, tmp_path):
    ckpt = str(tmp_path / "ck")
    left, right, ldf, rdf = _sources(port, MemoryStream)
    plan = ldf.join(rdf, on="k")
    q = plan.writeStream.outputMode("append").queryName("ssj4") \
        .option("checkpointLocation", ckpt).start()
    left.add_data([{"k": 1, "lv": 10}])
    q.processAllAvailable()
    q.stop()
    # the restart restores the state: the old left row still joins
    q2 = plan.writeStream.outputMode("append").queryName("ssj4b") \
        .option("checkpointLocation", ckpt).start()
    right.add_data([{"k": 1, "rv": 99}])
    q2.processAllAvailable()
    assert _sel(port, "select k, lv, rv from ssj4b") == [(1, 10, 99)]


def test_unsupported_outer_shapes_rejected_loudly(port):
    left, right, ldf, rdf = _sources(port, MemoryStream)
    with pytest.raises(NotImplementedError, match="watermark"):
        ldf.join(rdf, on="k", how="full").writeStream \
            .outputMode("append").start()
    with pytest.raises(NotImplementedError, match="watermark"):
        ldf.join(rdf, on="k", how="left").writeStream \
            .outputMode("append").start()


def test_left_outer_join_emits_on_eviction(port, ref):
    first, second = _both(port, ref, s_left_outer)
    assert first == [(1, 10, 100)]  # k=2 may still match
    assert (2, 20, None) in second and (9, 90, 900) in second
    assert (1, 10, None) not in second


def test_join_with_projection_below(port, ref):
    assert _both(port, ref, s_projection_below) == [(3, 2, 5)]


def test_right_outer_join_via_swap(port, ref):
    first, second = _both(port, ref, s_right_outer)
    assert first == [(1, 10, 100)]
    assert (2, None, 200) in second and (9, 90, 900) in second


def test_full_outer_join_symmetric_eviction(port, ref):
    first, second = _both(port, ref, s_full_outer)
    assert first == [(1, 10, 100)]
    assert (2, 20, None) in second and (3, None, 300) in second
    assert (9, 90, 900) in second
    assert (1, 10, None) not in second and (1, None, 100) not in second


def test_seeded_inner_join_matches_reference(port, ref):
    """400 rows a side over four triggers: every pair once, exactly the
    reference's rows."""
    rows = _both(port, ref, s_seeded_inner)
    assert len(rows) > 400
