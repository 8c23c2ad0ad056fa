"""The port's chunk pipeline (``spark_tpu_torch/physical/pipeline.py``) on
the inputs of tests/test_out_of_core.py's pipeline tests: rows equal at
depths 0, 1 and 2 (float sums bit for bit, since chunks are consumed in
source order), the in-flight byte budget, a producer error relayed while
the queue is full, the measured overlap, and the staging of a chunk
(the CPU copy here; pinned memory and a side stream on the card).

The top-k sweep is held against the reference's chunked rows; the
aggregation sweeps against the port's resident rows (float sums within
``rel=1e-9``, counts exactly), as in tests/test_out_of_core.py.
"""

import threading
import time

import numpy as np
import pytest
import torch

from spark_tpu_torch.api import functions as F
from spark_tpu_torch.columnar.batch import from_numpy
from spark_tpu_torch.physical import chunked
from spark_tpu_torch.physical.pipeline import (ChunkPipeline, PipelineStats,
                                               Stager)
from spark_tpu_torch.types import Field, Schema
from spark_tpu_torch import types as T
from test_torch_chunked import _Settings, _rows, files, port  # noqa: F401
from test_torch_threads import one_torch_thread  # noqa: F401

_TOPK = ("select k, v from oc_fact where v >= 10 "
         "order by v desc, k asc limit 9")


def _agg(port, files):
    return port.read.parquet(files["big"]).groupBy("k").agg(
        F.sum("v").alias("s"), F.avg("v").alias("a"),
        F.max("w").alias("hi"), F.count("v").alias("n"))


def _by_key(rows):
    return {r[0]: r[1:] for r in rows}


def test_pipeline_depth_sweep_chunked_agg(port, files):
    """Float sums and averages are bit for bit the same at depths 0, 1
    and 2, and within rel=1e-9 of the resident run."""
    df = _agg(port, files)
    resident = _by_key(_rows(df))
    by_depth = {}
    for depth in (0, 1, 2):
        with _Settings(port.conf, {"spark.tpu.maxDeviceBatchBytes": 1024,
                                   "spark.tpu.chunkRows": 8_192,
                                   "spark.tpu.pipelineDepth": depth}):
            by_depth[depth] = _rows(df)
        rec = chunked.last_run
        assert rec["chunks"] >= 10 and rec["pipeline_depth"] == depth
    assert by_depth[0] == by_depth[1] == by_depth[2]
    got = _by_key(by_depth[0])
    assert set(got) == set(resident)
    for k, (s, a, hi, n) in resident.items():
        assert got[k][2:] == (hi, n)
        assert got[k][0] == pytest.approx(s, rel=1e-9)
        assert got[k][1] == pytest.approx(a, rel=1e-9)


def test_pipeline_depth_sweep_topk(spark, port, files):
    """Streamed top-k at depths 0 and 2: the reference's chunked rows."""
    spark.read.parquet(files["fact"]).createOrReplaceTempView("oc_fact")
    settings = {"spark.tpu.maxDeviceBatchBytes": 100_000,
                "spark.tpu.chunkRows": 32_768}
    with _Settings(spark.conf, settings):
        want = _rows(spark.sql(_TOPK))
    for depth in (0, 2):
        with _Settings(port.conf, dict(settings, **{
                "spark.tpu.pipelineDepth": depth})):
            assert _rows(port.sql(_TOPK)) == want
        assert chunked.last_run["tier"] == "_ChunkedTopK"
        assert chunked.last_run["pipeline_depth"] == depth


def test_pipeline_byte_budget_bounds_inflight(port, files):
    """A one-byte prefetch budget admits one chunk at a time and does not
    deadlock."""
    df = port.read.parquet(files["big"]).groupBy("k").agg(
        F.sum("v").alias("s"), F.count("v").alias("n"))
    want = _by_key(_rows(df))
    with _Settings(port.conf, {"spark.tpu.maxDeviceBatchBytes": 1024,
                               "spark.tpu.chunkRows": 16_384,
                               "spark.tpu.pipelineDepth": 2,
                               "spark.tpu.prefetchBytesMax": 1}):
        got = _by_key(_rows(df))
    rec = chunked.last_run
    assert rec["chunks"] >= 5 and rec["max_inflight_chunks"] == 1
    assert set(got) == set(want)
    for k in want:
        assert got[k][1] == want[k][1]
        assert got[k][0] == pytest.approx(want[k][0], rel=1e-9)


def test_pipeline_producer_error_relayed_under_backpressure():
    """A producer error while the queue is full reaches the consumer
    (dropping it would leave the consumer blocked forever)."""
    def source():
        yield from (1, 2, 3)
        raise ValueError("decode failed")

    pipe = ChunkPipeline(source(), lambda x: x, depth=2,
                         byte_budget=1 << 30, stats=PipelineStats(),
                         nbytes_of=lambda x: 0)
    got, err = [], []

    def consume():
        try:
            for item in pipe:
                got.append(item)
                time.sleep(0.2)  # a slow consumer keeps the queue full
        except ValueError as e:
            err.append(e)

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    t.join(timeout=15)
    assert not t.is_alive(), "consumer hung: the producer's error was lost"
    assert got == [1, 2, 3]
    assert err and "decode failed" in str(err[0])


def test_pipeline_abandoned_consumer_stops_the_producer():
    """A consumer that stops early (an error in its merge) closes the
    pipeline; the producer thread ends."""
    pipe = ChunkPipeline(iter(range(100)), lambda x: x, depth=2,
                         byte_budget=1 << 30, stats=PipelineStats(),
                         nbytes_of=lambda x: 0)
    it = iter(pipe)
    assert next(it) == 0
    it.close()
    assert pipe._thread is None


def test_pipeline_overlap_recorded(port, files):
    """At depth 2 over many chunks the producer's decode and copies
    overlap the consumer's merges: the measured overlap is above 0 and
    within the wall time."""
    df = _agg(port, files)
    with _Settings(port.conf, {"spark.tpu.maxDeviceBatchBytes": 1024,
                               "spark.tpu.chunkRows": 8_192,
                               "spark.tpu.pipelineDepth": 2}):
        df.collect()
    rec = chunked.last_run
    assert rec["chunks"] >= 10 and rec["pipeline_depth"] == 2
    assert rec["overlap_ms"] > 0.0 and rec["overlap_ratio"] > 0.0
    assert rec["wall_ms"] >= rec["overlap_ms"]
    for stage in ("decode_ms", "transfer_ms", "compute_ms"):
        assert rec[stage] >= 0.0


def test_stager_gives_from_numpy_batch():
    """A staged chunk holds the batch ``from_numpy`` builds: values,
    validities and mask padded to the capacity."""
    schema = Schema((Field("a", T.INT64, nullable=True),
                     Field("b", T.FLOAT64, nullable=False)))
    arrays = [np.arange(5, dtype=np.int64), np.linspace(0, 1, 5)]
    valids = [np.array([True, False, True, True, False]), None]
    staged = Stager("cpu").stage(schema, arrays, valids, 8)
    assert staged.event is None and staged.nbytes > 0
    got = staged.adopt().batch
    want = from_numpy(schema, arrays, valids, capacity=8, device="cpu")
    assert torch.equal(got.data.row_mask, want.data.row_mask)
    for g, w in zip(got.data.columns, want.data.columns):
        assert torch.equal(g.data, w.data)
        assert (g.validity is None) == (w.validity is None)
        if g.validity is not None:
            assert torch.equal(g.validity, w.validity)
