"""The port's out-of-memory tier (``spark_tpu_torch/physical/chunked.py``)
against the JAX package, on the inputs of tests/test_out_of_core.py.

For every plan below, at the same budget, the port's ``find_chunkable``
picks a tier of the reference's class name, and the chunked rows equal
the reference's chunked rows and the port's own resident rows: counts,
integer sums, min/max and keys exactly, float sums and averages within
``rel=1e-9`` (a chunked float sum adds in another order than a resident
one). Both packages read the same Parquet files, made from a seed with
numpy. The reference runs once per case, in a module fixture.

The mesh cases of tests/test_out_of_core.py wait for the port's mesh
executor (ROADMAP A10); the fault matrix and the zero-replan case wait
for admission control and fault injection (A12).
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_tpu.api import functions as RF
from spark_tpu_torch.api import functions as F
from spark_tpu_torch.api.session import SparkSession as PortSession
from spark_tpu_torch.physical import chunked

from test_torch_threads import one_torch_thread  # noqa: F401

_OC = ("spark.tpu.maxDeviceBatchBytes", "spark.tpu.chunkRows",
       "spark.tpu.join.hybrid.enabled", "spark.tpu.pipelineDepth",
       "spark.tpu.prefetchBytesMax", "spark.tpu.join.hybrid.partitionsMax",
       "spark.tpu.scheduler.hbmBudgetBytes", "spark.tpu.gracePartitionsMax")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """big (k in 0..999, float v, int w), fact (keys 0..999) and dim
    (keys 0, 10, .., 990: the sidecar's key set drops 90% of fact's rows
    on the host). tests/test_out_of_core.py's tables, cut from 200k to
    100k rows: the reference compiles each merge step's shape anew, and
    half the chunks halve its compiles."""
    d = tmp_path_factory.mktemp("ooc")
    rng = np.random.default_rng(11)
    n = 100_000
    big = pa.table({
        "k": pa.array(rng.integers(0, 1000, n), pa.int64()),
        "v": pa.array(rng.random(n)),
        "w": pa.array(rng.integers(0, 100, n), pa.int64()),
    })
    rng = np.random.default_rng(12)
    fact = pa.table({
        "k": pa.array(rng.integers(0, 1000, n), pa.int64()),
        "v": pa.array(rng.integers(0, 100, n), pa.int64()),
    })
    dim = pa.table({
        "dk": pa.array(np.arange(100) * 10, pa.int64()),
        "w": pa.array(np.arange(100) * 2, pa.int64()),
    })
    paths = {}
    for name, t in (("big", big), ("fact", fact), ("dim", dim)):
        paths[name] = str(d / f"{name}.parquet")
        pq.write_table(t, paths[name])
    return paths


@pytest.fixture(scope="module")
def port(files):
    s = PortSession(device="cpu")
    s.read.parquet(files["fact"]).createOrReplaceTempView("oc_fact")
    s.read.parquet(files["dim"]).createOrReplaceTempView("oc_dim")
    return s


def _big_agg(fns, df):
    return df.groupBy("k").agg(
        fns.count("v").alias("n"), fns.sum("v").alias("s"),
        fns.min("w").alias("lo"), fns.max("w").alias("hi"),
        fns.avg("v").alias("a"))


#: name -> (query: SQL text, or a function of (functions module, the
#: big DataFrame); settings; the reference's tier). The join cases are in
#: tests/test_torch_chunked_join.py, so that the two files' reference
#: runs spread over two test workers.
CASES = {
    "filter_and_order": (
        lambda fns, df: df.filter(fns.col("w") < 50).groupBy("k")
        .agg(fns.count("v").alias("n"))
        .orderBy(fns.desc("n"), "k").limit(5),
        {"spark.tpu.maxDeviceBatchBytes": 1024}, "_ChunkedAgg"),
    "global_agg": (
        lambda fns, df: df.agg(fns.count("v").alias("n"),
                               fns.sum("w").alias("s")),
        {"spark.tpu.maxDeviceBatchBytes": 1024}, "_ChunkedAgg"),
    "aggregation_matches_materialized": (
        _big_agg,
        {"spark.tpu.maxDeviceBatchBytes": 1024,
         "spark.tpu.chunkRows": 32_768}, "_ChunkedAgg"),
    "topk": (
        "select k, v from oc_fact where v >= 10 "
        "order by v desc, k asc limit 7",
        {"spark.tpu.maxDeviceBatchBytes": 100_000,
         "spark.tpu.chunkRows": 32_768}, "_ChunkedTopK"),
}

#: cases whose rows come in a defined order
ORDERED = ("filter_and_order", "streamed_join", "topk")


def _df(session, fns, query, files):
    if isinstance(query, str):
        return session.sql(query)
    return query(fns, session.read.parquet(files["big"]))


def _rows(df):
    return [tuple(r) for r in df.collect()]


class _Settings:
    def __init__(self, conf, settings):
        self.conf, self.settings = conf, settings

    def __enter__(self):
        for k, v in self.settings.items():
            self.conf.set(k, v)

    def __exit__(self, *exc):
        for k in _OC:
            self.conf.unset(k)
        return False


def reference_runs(spark, files, cases, same_rows=None):
    """Per case: the reference's tier and chunked rows (for a case in
    ``same_rows``, the named case's rows: the reference only plans it)."""
    from spark_tpu.physical.chunked import find_chunkable as ref_find
    from spark_tpu.plan.optimizer import optimize as ref_optimize

    spark.read.parquet(files["fact"]).createOrReplaceTempView("oc_fact")
    spark.read.parquet(files["dim"]).createOrReplaceTempView("oc_dim")
    same_rows = same_rows or {}
    out = {}
    for name, (query, settings, _) in cases.items():
        df = _df(spark, RF, query, files)
        with _Settings(spark.conf, settings):
            found = ref_find(ref_optimize(df._plan), spark.conf)
            rows = None if name in same_rows else _rows(df)
        out[name] = (type(found).__name__, rows)
    for name, other in same_rows.items():
        out[name] = (out[name][0], out[other][1])
    return out


@pytest.fixture(scope="module")
def reference(spark, files):
    return reference_runs(spark, files, CASES)


def _port_tier(port, df):
    from spark_tpu_torch.plan.optimizer import optimize

    found = chunked.find_chunkable(optimize(df._plan, port.conf), port.conf)
    return type(found).__name__


def _close(got, want):
    """Rows equal: exact, floats within rel=1e-9."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float) and isinstance(a, float):
                assert a == pytest.approx(b, rel=1e-9), (g, w)
            else:
                assert a == b, (g, w)


def _keyed(rows):
    return sorted(rows, key=lambda r: tuple(
        (x is None, x) for x in r[:1]))


def check_case(port, reference, files, cases, name):
    """The port's tier is the reference's, and its chunked rows equal the
    reference's and its own resident rows."""
    query, settings, tier = cases[name]
    df = _df(port, F, query, files)
    resident = _rows(df)
    with _Settings(port.conf, settings):
        assert _port_tier(port, df) == reference[name][0] == tier
        got = _rows(df)
    assert chunked.last_run["tier"] == tier
    order = (lambda r: r) if name in ORDERED else _keyed
    _close(order(got), order(reference[name][1]))
    _close(order(got), order(resident))
    return chunked.last_run


@pytest.mark.parametrize("name", list(CASES))
def test_tier_and_rows_match_reference(port, reference, files, name):
    check_case(port, reference, files, CASES, name)


@pytest.mark.parametrize("name,ok", [
    ("aggregation_matches_materialized",
     lambda r: r["chunks"] >= 3 and r["sidecars"] == 0),
    ("topk", lambda r: r["chunks"] >= 2),
])
def test_chunk_records(port, files, name, ok):
    """What a tier records of its run (tests/test_out_of_core.py's event
    checks)."""
    query, settings, _ = CASES[name]
    with _Settings(port.conf, settings):
        _rows(_df(port, F, query, files))
    assert ok(chunked.last_run), chunked.last_run


def test_non_mergeable_aggregate_runs_resident(port, files):
    """DISTINCT aggregates do not decompose: the plan runs resident."""
    df = port.read.parquet(files["big"]).agg(
        F.countDistinct("w").alias("d"))
    with _Settings(port.conf, {"spark.tpu.maxDeviceBatchBytes": 1024}):
        assert _port_tier(port, df) == "NoneType"
        assert _rows(df) == [(100,)]


def test_host_key_filter_is_the_reference_filter():
    """The exact filter keeps exactly the members; the Bloom filter keeps
    every member, and the same rows as the reference's (same hash)."""
    from spark_tpu.physical.chunked import _HostKeyFilter as RefFilter

    rng = np.random.default_rng(3)
    keys = rng.choice(1_000_000, 5000, replace=False)
    probe = rng.integers(0, 1_000_000, 50_000)
    want = np.isin(probe, keys)
    for exact_max in (1 << 20, 10):
        port_f = chunked._HostKeyFilter("k", keys, exact_max)
        ref_f = RefFilter("k", keys, exact_max)
        got = port_f.member(probe)
        assert port_f.exact == ref_f.exact == (exact_max > 10)
        assert (got == ref_f.member(probe)).all()
        assert got[want].all()
        if port_f.exact:
            assert (got == want).all()
        assert (port_f.lo, port_f.hi) == (keys.min(), keys.max())


def test_grace_bucket_hash_is_the_reference_hash():
    """Buckets follow the reference's hash, so bucket order (and the
    merge order of float partials) is the reference's."""
    vals = np.array([0, 1, 7, 123456789, -5, 2 ** 40], dtype=np.int64)
    mix = np.uint64(0x9E3779B97F4A7C15)
    want = ((vals.astype(np.uint64) * mix) >> np.uint64(32)) % np.uint64(16)
    assert (chunked._bucket_of(vals, 16) == want.astype(np.int64)).all()
