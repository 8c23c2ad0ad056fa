"""The port's event ring and JSONL log (``spark_tpu_torch/metrics.py``) on
the inputs of tests/test_conf_metrics.py: the stage events of a query,
the buffered log under ``spark.eventLog.dir``, query marks and per-trace
attribution, the exchange record and its gauges, the counters of this
part's tiers, the one ``PipelineStats`` and ``stage_timer``; and each
event kind's fields (``stage``, ``aqe``, ``agg``, ``fusion_bailout``,
``exchange``, ``fault_injected``, ``fault_recovered``) held against the
reference's for the same workload.
"""

import json
import os
import threading

import numpy as np
import pyarrow as pa
import pytest

from spark_tpu import metrics as RM
from spark_tpu_torch import conf as CF
from spark_tpu_torch import metrics, trace
from spark_tpu_torch.api.session import SparkSession
from spark_tpu_torch.physical import pipeline

from test_torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.timeout(180)


@pytest.fixture(scope="module")
def port():
    return SparkSession(device="cpu")


def test_stage_events_recorded(port):
    metrics.reset()
    df = port.createDataFrame([{"x": i} for i in range(10)])
    df.groupBy((df.x % 3).alias("g")).count().collect()
    evs = metrics.last_query()
    kinds = {e["kind"] for e in evs}
    assert {"query_start", "stage"} <= kinds, kinds
    assert all("ms" in e and "op" in e and "node" in e
               for e in evs if e["kind"] == "stage")


def test_event_log_jsonl(port, tmp_path):
    port.conf.set("spark.eventLog.dir", str(tmp_path))
    try:
        df = port.createDataFrame([{"x": 1}, {"x": 2}])
        assert df.count() == 2
        path = os.path.join(str(tmp_path), "events.jsonl")
        assert os.path.exists(path)  # the trace root's exit flushed it
        with open(path) as f:
            lines = [json.loads(ln) for ln in f]
        assert any(e["kind"] == "stage" for e in lines)
        assert any(e["kind"] == "span" for e in lines)
    finally:
        port.conf.unset("spark.eventLog.dir")
    assert CF.is_registered("spark.eventLog.dir")


def test_last_query_selects_by_trace_id():
    """Events of another trace recorded after the newest query's mark
    are not attributed to it; id-less events after the mark are."""
    metrics.reset()
    with trace.span("query.execute") as root:
        metrics.query_start("mine")
        metrics.record("stage", op="a", ms=1.0)
    with trace.attach(trace.SpanContext("f" * 16, "e" * 8, None, True)):
        metrics.record("stage", op="other", ms=1.0)
    metrics.record("heartbeat", ok=True)
    ops = [e.get("op") for e in metrics.last_query() if e["kind"] == "stage"]
    assert ops == ["a"]
    assert any(e["kind"] == "heartbeat" for e in metrics.last_query())
    assert metrics.query_marks()[-1][1] == root.trace_id
    assert all(e["trace_id"] == root.trace_id
               for e in metrics.query_events(root.trace_id))


def test_record_exchange_matches_reference_and_sets_gauges():
    kw = dict(op="hash", mode="adaptive", devices=4, rows=300,
              capacity_before=4096, capacity_after=1024, buffer_bytes=8192,
              slice_capacity=128)
    metrics.reset()
    RM.reset()
    metrics.record_exchange(**kw)
    RM.record_exchange(**kw)

    def strip(e):
        return {k: v for k, v in e.items() if k not in ("ts", "n")}

    assert strip(metrics.recent(1)[0]) == strip(RM.recent(1)[0])
    g = metrics.gauges()
    assert g["exchange.mode"] == "adaptive" and g["exchange.rows"] == 300


@pytest.mark.parametrize("name", ["agg", "fusion", "join", "recovery",
                                  "retry_budget", "analysis"])
def test_counters_are_the_references(name):
    """The counter tables this part's tiers feed start with the
    reference's keys (so profiles and endpoints read the same names)."""
    stats = {"agg": "agg_stats", "fusion": "fusion_stats",
             "join": "join_stats", "recovery": "recovery_stats",
             "retry_budget": "retry_budget_stats",
             "analysis": "analysis_stats"}[name]
    reset = getattr(metrics, f"reset_{name}", None)
    if reset is not None:
        reset()
        getattr(RM, f"reset_{name}")()
    assert set(getattr(metrics, stats)()) == set(getattr(RM, stats)())


def test_brownout_level_counts_transitions():
    metrics.reset_brownout()
    metrics.set_brownout(1)
    metrics.set_brownout(1)
    metrics.set_brownout(0)
    assert metrics.brownout_stats() == {"level": 0, "entered": 1,
                                        "exited": 1}


def test_one_pipeline_stats():
    assert pipeline.PipelineStats is metrics.PipelineStats
    st = metrics.PipelineStats()
    with st.timed("decode"):
        pass
    with st.timed("compute"):
        pass
    st.note_inflight(100, 2)
    out = st.finish()
    assert out["max_inflight_bytes"] == 100 and out["wall_ms"] >= 0
    assert {"decode_ms", "transfer_ms", "compute_ms", "overlap_ratio",
            "stall_producer_ms"} <= set(out)


def test_stage_timer_records_error():
    metrics.reset()
    with pytest.raises(ValueError):
        with metrics.stage_timer("blocking", node="X"):
            raise ValueError("bad")
    ev = metrics.recent(1)[0]
    assert ev["kind"] == "stage" and "ValueError" in ev["error"]


def test_record_is_thread_safe_and_counted():
    metrics.reset()
    threads = [threading.Thread(target=lambda: [
        metrics.record("heartbeat", ok=True) for _ in range(200)])
        for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    evs = metrics.recent(1000)
    assert len(evs) == 800 and len({e["n"] for e in evs}) == 800


# ---- event fields against the reference -------------------------------------


def _fields(evs, kind):
    return {k for e in evs if e["kind"] == kind for k in e} - {"n", "ts"}


@pytest.fixture(scope="module")
def workloads(spark):
    """The same mesh workload through both packages (a 2-rank CPU mesh
    here; the reference's mesh is its CPU devices): the decision events
    of an adaptive join and aggregate, a fusion bailout, and an injected
    fault absorbed at agg.strategy."""
    from spark_tpu import conf as RCF
    from spark_tpu import faults as RF
    from spark_tpu.parallel.mesh import make_mesh as ref_mesh

    rng = np.random.default_rng(9)
    n = 2_000
    tbl = pa.table({"g": pa.array(rng.integers(0, 40, n), pa.int64()),
                    "v": pa.array(rng.integers(0, 100, n), pa.int64())})
    dim = pa.table({"dg": pa.array(np.arange(40), pa.int64()),
                    "w": pa.array(np.arange(40) * 3, pa.int64())})
    q = ("SELECT g, SUM(v * w) AS s, COUNT(*) AS c FROM ef JOIN ed ON g = dg "
         "GROUP BY g ORDER BY g")
    settings = {"spark.tpu.adaptive.enabled": True,
                "spark.tpu.adaptive.agg.enabled": True,
                "spark.tpu.fusion.enabled": True,
                "spark.tpu.faultInjection.agg.strategy": "nth:1:transient"}
    s = SparkSession("cpu", dict(settings, **{CF.MESH_DEVICES.key: 2}),
                     ["cpu", "cpu"])
    s.createDataFrame(tbl).createOrReplaceTempView("ef")
    s.createDataFrame(dim).createOrReplaceTempView("ed")
    metrics.reset()
    mine_rows = [tuple(r) for r in s.sql(q).collect()]
    mine = metrics.last_query()

    spark.createDataFrame(tbl).createOrReplaceTempView("ef")
    spark.createDataFrame(dim).createOrReplaceTempView("ed")
    for k, v in settings.items():
        spark.conf.set(k, v)
    spark.conf.set(RCF.MESH_DEVICES.key, 2)
    spark._mesh = ref_mesh(2)
    spark._mesh_executor = None
    RF.reset(spark.conf)
    RM.reset()
    try:
        ref_rows = [tuple(r) for r in spark.sql(q).collect()]
        theirs = RM.last_query()
    finally:
        for k in settings:
            spark.conf.unset(k)
        spark.conf.unset(RCF.MESH_DEVICES.key)
        spark._mesh = None
        spark._mesh_executor = None
        RF.reset(spark.conf)
    assert mine_rows == ref_rows
    return mine, theirs


@pytest.mark.parametrize("kind", ["stage", "aqe", "agg", "fusion_bailout",
                                  "exchange", "fault_injected",
                                  "fault_recovered", "query_start", "span"])
def test_event_fields_match_reference(workloads, kind):
    mine, theirs = workloads
    want = _fields(theirs, kind)
    assert want, f"the reference recorded no {kind} event"
    got = _fields(mine, kind)
    if kind == "span":
        # the port's stage.device spans name their rank thread (the
        # reference's SPMD stage is one span on one thread)
        want = want | {"rank"}
    assert got == want, got ^ want


def test_broadcast_threshold_zero_forces_partitioned(port, monkeypatch):
    """tests/test_conf_metrics.py's case through the port's MeshExecutor
    on a 4-rank CPU thread mesh: a threshold of 0 plans a hash
    partitioned join, one of 1 << 30 broadcasts the 8-row build side."""
    from spark_tpu_torch.conf import RuntimeConf
    from spark_tpu_torch.expr import expressions as E
    from spark_tpu_torch.parallel import executor as X
    from spark_tpu_torch.parallel import operators as D
    from spark_tpu_torch.parallel.mesh import make_mesh
    from spark_tpu_torch.plan import logical as L

    left = port.createDataFrame([{"k": i % 8, "v": i} for i in range(64)])
    right = port.createDataFrame([{"k": i, "w": i * 10} for i in range(8)])
    plan = L.Join(left._plan, right._plan, "inner", (E.Col("k"),),
                  (E.Col("k"),))
    run, seen = X.MeshExecutor.run, []

    def spy(self, p):
        seen.append(isinstance(p, D.HashPartitionExchangeExec))
        return run(self, p)

    monkeypatch.setattr(X.MeshExecutor, "run", spy)
    mesh = make_mesh(devices=["cpu"] * 4)
    for threshold, partitioned in ((0, True), (1 << 30, False)):
        seen.clear()
        ex = X.MeshExecutor(mesh, conf=RuntimeConf(
            {"spark.sql.autoBroadcastJoinThreshold": threshold}))
        assert len(ex.execute_logical(plan).to_pylist()) == 64
        assert any(seen) == partitioned, (threshold, seen)
