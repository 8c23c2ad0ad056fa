"""The port's chunked joins against the JAX package, on the inputs of
tests/test_out_of_core.py: the streamed join tree (sidecars and the host
key filter), the grace hash join and the hybrid hash join (grants,
spills, recursive repartition and the unified budget's invariant under
a concurrent tenant). Helpers and the shared files come from
tests/test_torch_chunked.py.

Integer sums and counts are exact, so every chunked result equals the
resident one bit for bit.
"""

import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_tpu_torch.physical import chunked
from test_torch_chunked import (  # noqa: F401 - fixtures used by name
    _Settings, _df, _rows, check_case, files, port, reference_runs)
from spark_tpu_torch.api import functions as F
from test_torch_threads import one_torch_thread  # noqa: F401

_JOIN = ("select sum(v * w) as s, count(*) as n "
         "from oc_fact join oc_dim on k = dk")

CASES = {
    "streamed_join": (
        "select k % 10 as g, sum(v * w) as s, count(*) as n "
        "from oc_fact join oc_dim on k = dk group by k % 10 order by g",
        {"spark.tpu.maxDeviceBatchBytes": 100_000,
         "spark.tpu.chunkRows": 32_768}, "_ChunkedAgg"),
    "streamed_left_join": (
        "select count(*) as n, count(w) as m, sum(v) as s "
        "from oc_fact left join oc_dim on k = dk",
        {"spark.tpu.maxDeviceBatchBytes": 100_000,
         "spark.tpu.chunkRows": 65_536}, "_ChunkedAgg"),
    "grace_hash_join": (
        _JOIN,
        {"spark.tpu.maxDeviceBatchBytes": 1024,
         "spark.tpu.chunkRows": 32_768, "spark.tpu.gracePartitionsMax": 16,
         "spark.tpu.join.hybrid.enabled": False}, "_GraceHashAgg"),
    "grace_hash_left_join": (
        "select count(*) as n, count(w) as m "
        "from oc_fact left join oc_dim on k = dk",
        {"spark.tpu.maxDeviceBatchBytes": 1024,
         "spark.tpu.gracePartitionsMax": 16,
         "spark.tpu.join.hybrid.enabled": False}, "_GraceHashAgg"),
    "hybrid_hash_join": (
        _JOIN,
        {"spark.tpu.maxDeviceBatchBytes": 1024,
         "spark.tpu.chunkRows": 32_768,
         "spark.tpu.join.hybrid.partitionsMax": 16}, "_HybridHashJoinAgg"),
}

#: cases whose reference rows are another case's (same query): the
#: reference only plans them, to pin the tier
_SAME_ROWS = {"hybrid_hash_join": "grace_hash_join"}


@pytest.fixture(scope="module")
def reference(spark, files):
    return reference_runs(spark, files, CASES, _SAME_ROWS)


@pytest.mark.parametrize("name", list(CASES))
def test_join_tier_and_rows_match_reference(port, reference, files, name):
    rec = check_case(port, reference, files, CASES, name)
    if name == "streamed_join":
        assert rec["chunks"] >= 2 and rec["sidecars"] == 1
        assert rec["key_filters"] == 1
        assert rec["rows_kept"] < 0.2 * rec["rows_in"]  # keys 100.. dropped
    if name == "streamed_left_join":
        assert rec["key_filters"] == 0  # left rows without a match stay
        assert rec["rows_kept"] == rec["rows_in"]
    if name.startswith("grace"):
        assert rec["partitions"] >= 2
    if name == "hybrid_hash_join":
        assert rec["grants"] == 1 and rec["fallback"] is None


def test_empty_stream_aggregates_nothing(port, files):
    """A sidecar whose keys match no streamed row: the host key filter
    drops every chunk, and the aggregate runs over an empty relation in
    the scan's place."""
    df = port.sql("select count(*) as n, sum(v) as s from oc_fact "
                  "join oc_dim on k = dk + 5000")
    with _Settings(port.conf, {"spark.tpu.maxDeviceBatchBytes": 100_000}):
        got = _rows(df)
    assert chunked.last_run["tier"] == "_ChunkedAgg"
    assert chunked.last_run["chunks"] == 0
    assert chunked.last_run["rows_kept"] == 0
    assert got == [(0, None)]


@pytest.fixture(scope="module")
def hybrid_files(tmp_path_factory, spark):
    """Per key distribution: fact (60k rows; uniform keys, or 90% on
    key 70, which dim matches) and dim, registered in both packages, and
    the reference's resident rows of the join."""
    d = tmp_path_factory.mktemp("hybrid")
    out = {}
    for dist in ("uniform", "skewed"):
        rng = np.random.default_rng(41)
        n = 60_000
        if dist == "uniform":
            ks = rng.integers(0, 1000, n)
        else:
            ks = np.where(rng.random(n) < 0.9, 70, rng.integers(0, 1000, n))
        fact = pa.table({"k": pa.array(ks.astype(np.int64), pa.int64()),
                         "v": pa.array(rng.integers(0, 100, n), pa.int64())})
        dim = pa.table({"dk": pa.array(np.arange(100) * 10, pa.int64()),
                        "w": pa.array(np.arange(100) * 2, pa.int64())})
        fp, dp = str(d / f"hyf_{dist}.parquet"), str(d / f"hyd_{dist}.parquet")
        pq.write_table(fact, fp)
        pq.write_table(dim, dp)
        spark.read.parquet(fp).createOrReplaceTempView(f"hy_fact_{dist}")
        spark.read.parquet(dp).createOrReplaceTempView(f"hy_dim_{dist}")
        sql = (f"select sum(v * w) as s, count(*) as n from hy_fact_{dist} "
               f"join hy_dim_{dist} on k = dk")
        out[dist] = (fp, dp, sql, _rows(spark.sql(sql)))
    return out


@pytest.mark.parametrize("dist", ["uniform", "skewed"])
def test_hybrid_budget_ladder_byte_identity(port, hybrid_files, dist):
    """The hybrid join equals the resident plan and the reference at
    every grant: unconstrained (nothing spills), constrained and near
    the floor (partitions spill to files and are read back)."""
    fp, dp, sql, want = hybrid_files[dist]
    port.read.parquet(fp).createOrReplaceTempView(f"hy_fact_{dist}")
    port.read.parquet(dp).createOrReplaceTempView(f"hy_dim_{dist}")
    assert _rows(port.sql(sql)) == want and want[0][1] > 0
    port.memory_store.clear()
    for budget, expect_spill in ((2 << 30, False), (512 * 1024, True),
                                 (96 * 1024, True)):
        with _Settings(port.conf, {
                "spark.tpu.maxDeviceBatchBytes": 1024,
                "spark.tpu.chunkRows": 32_768,
                "spark.tpu.join.hybrid.partitionsMax": 16,
                "spark.tpu.scheduler.hbmBudgetBytes": budget}):
            got = _rows(port.sql(sql))
        assert got == want, (dist, budget)
        rec = chunked.last_run
        assert rec["tier"] == "_HybridHashJoinAgg" and rec["partitions"] >= 2
        assert rec["grants"] == 1
        if expect_spill:
            assert rec["spilled_parts"] >= 1
            assert rec["spill_writes"] >= 1 and rec["spill_reads"] >= 1
            assert rec["granted_bytes"] <= budget
        else:
            assert rec["spilled_parts"] == 0


def test_hybrid_recursive_repartition_depth(port, reference):
    """Two coarse partitions over the fact table force the recursive
    repartition two levels deep or more; the rows stay exact."""
    with _Settings(port.conf, {
            "spark.tpu.maxDeviceBatchBytes": 1024,
            "spark.tpu.chunkRows": 65_536,
            "spark.tpu.join.hybrid.partitionsMax": 2}):
        got = _rows(port.sql(_JOIN))
    rec = chunked.last_run
    assert rec["depth"] >= 2 and rec["recursive_repartitions"] >= 2
    assert got == reference["hybrid_hash_join"][1]


def test_hybrid_concurrent_tenant_budget_invariant(port, reference):
    """Execution grants and storage never exceed the unified budget while
    the hybrid join runs against a tenant acquiring and releasing on the
    same manager."""
    mgr = port.memory_manager
    port.memory_store.clear()
    stop = threading.Event()
    violations = []

    def check():
        snap = mgr.snapshot()
        if snap["in_use_bytes"] + snap["storage_bytes"] \
                > snap["budget_bytes"]:
            violations.append(snap)

    def tenant():
        while not stop.is_set():
            c = mgr.acquire_execution(32 * 1024)
            check()
            time.sleep(0.001)
            mgr.release_execution(c)

    def sampler():
        while not stop.is_set():
            check()
            time.sleep(0.0005)

    threads = [threading.Thread(target=tenant, daemon=True),
               threading.Thread(target=sampler, daemon=True)]
    try:
        with _Settings(port.conf, {
                "spark.tpu.maxDeviceBatchBytes": 1024,
                "spark.tpu.chunkRows": 32_768,
                "spark.tpu.join.hybrid.partitionsMax": 16,
                "spark.tpu.scheduler.hbmBudgetBytes": 192 * 1024}):
            for t in threads:
                t.start()
            got = _rows(port.sql(_JOIN))
        assert chunked.last_run["tier"] == "_HybridHashJoinAgg"
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
    assert not violations, violations[:3]
    assert got == reference["hybrid_hash_join"][1]


def test_hybrid_spill_abort_falls_back_to_grace(port, reference,
                                                monkeypatch):
    """A spill write that fails for good aborts the hybrid pass, which
    falls back one rung, to the grace hash join from the source, with
    the same rows; the fallback is recorded."""
    calls = {"n": 0}

    def broken(*a, **k):
        calls["n"] += 1
        raise OSError("disk gone")

    monkeypatch.setattr(pa.ipc, "new_stream", broken)
    with _Settings(port.conf, {
            "spark.tpu.maxDeviceBatchBytes": 1024,
            "spark.tpu.chunkRows": 32_768,
            "spark.tpu.join.hybrid.partitionsMax": 16,
            "spark.tpu.scheduler.hbmBudgetBytes": 96 * 1024}):
        got = _rows(port.sql(_JOIN))
    rec = chunked.last_run
    assert calls["n"] == 1  # not transient: no retry
    assert rec["tier"] == "_HybridHashJoinAgg"
    assert rec["fallback"] == "grace" and rec["aborted"] == "write"
    assert got == reference["hybrid_hash_join"][1]


def test_grace_rows_equal_at_every_depth(port, reference, files):
    """Grace buckets are consumed in bucket order: depths 0, 1 and 2
    give the same rows, the reference's."""
    by_depth = {}
    for depth in (0, 1, 2):
        with _Settings(port.conf, {
                "spark.tpu.maxDeviceBatchBytes": 1024,
                "spark.tpu.chunkRows": 32_768,
                "spark.tpu.pipelineDepth": depth,
                "spark.tpu.join.hybrid.enabled": False}):
            by_depth[depth] = _rows(port.sql(_JOIN))
        assert chunked.last_run["pipeline_depth"] == depth
        assert chunked.last_run["partitions"] >= 2
    assert by_depth[0] == by_depth[1] == by_depth[2] \
        == reference["grace_hash_join"][1]


def test_streamed_join_rows_equal_at_every_depth(port, reference, files):
    """The streamed join at depths 0, 1 and 2: the same rows, the
    reference's (integer sums, so exactly)."""
    query, settings, _ = CASES["streamed_join"]
    by_depth = {}
    for depth in (0, 1, 2):
        with _Settings(port.conf, dict(settings, **{
                "spark.tpu.chunkRows": 16_384,
                "spark.tpu.pipelineDepth": depth})):
            by_depth[depth] = _rows(_df(port, F, query, files))
        assert chunked.last_run["chunks"] >= 2
        assert chunked.last_run["pipeline_depth"] == depth
    assert by_depth[0] == by_depth[1] == by_depth[2] \
        == reference["streamed_join"][1]


# ---- admission's measured bytes ---------------------------------------------


def test_hybrid_zero_replans_where_ladder_replanned(port, reference):
    """Under a starved grant the hybrid join completes in one planned
    pass (no ladder replan, though its spills show memory was short);
    the resident path pays a ladder replan for an injected OOM."""
    from spark_tpu_torch import faults, metrics

    want = reference["hybrid_hash_join"][1]
    with _Settings(port.conf, {
            "spark.tpu.maxDeviceBatchBytes": 1024,
            "spark.tpu.chunkRows": 32_768,
            "spark.tpu.join.hybrid.partitionsMax": 64,
            "spark.tpu.scheduler.hbmBudgetBytes": 64 * 1024}):
        metrics.reset_recovery()
        got = _rows(port.sql(_JOIN))
        assert chunked.last_run["tier"] == "_HybridHashJoinAgg"
        assert chunked.last_run["spill_writes"] >= 1
        assert metrics.recovery_stats()["replans"] == 0
    assert got == want

    port.conf.set("spark.tpu.join.hybrid.enabled", False)
    port.conf.set("spark.tpu.faultInjection.execute.device", "nth:1:oom")
    faults.reset(port.conf)
    try:
        metrics.reset_recovery()
        got2 = _rows(port.sql(_JOIN))
        assert metrics.recovery_stats()["replans"] >= 1
    finally:
        port.conf.unset("spark.tpu.join.hybrid.enabled")
        port.conf.unset("spark.tpu.faultInjection.execute.device")
        faults.reset(port.conf)
    assert got2 == want


def test_hybrid_grant_seeded_from_measured_staging(port, reference):
    """A hybrid run notes what its staging took; the next run of the same
    plan shape asks for that grant instead of the planner's estimate."""
    with _Settings(port.conf, {
            "spark.tpu.maxDeviceBatchBytes": 1024,
            "spark.tpu.chunkRows": 32_768,
            "spark.tpu.join.hybrid.partitionsMax": 16,
            "spark.tpu.scheduler.hbmBudgetBytes": 64 << 20}):
        first = _rows(port.sql(_JOIN))
        staged = chunked.last_run["staged_bytes"]
        again = _rows(port.sql(_JOIN))
        granted_again = chunked.last_run["granted_bytes"]
    assert first == again == reference["hybrid_hash_join"][1]
    assert staged > 0
    assert granted_again == max(64 * 1024, staged)
