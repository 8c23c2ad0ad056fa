"""The port's query tracing (``spark_tpu_torch/trace/``) and profiling glue
(``tracing.py``) on the inputs of tests/test_trace.py and
tests/test_tracing.py.

Held against the reference: the span names, and the span tree's names
and nesting for the same single-device query (the ``mview.probe`` span
of the cache and view probe included). Held against the port
itself: one well-formed tree per query, every stage event stamped with
the query's trace id (the mesh's rank threads included), the
breakdown's parts summing to its wall, rows equal bit for bit with
tracing on, sampled and off, and ``torch.profiler`` traces holding the
annotated region. Over the serving tier: one trace from the client
through the router, the replica and the scheduler's worker to the
stages, and a shed re-dispatch that stays in one trace.
"""

import json
import os
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_tpu import metrics as RM
from spark_tpu import trace as RT
from spark_tpu_torch import conf as CF
from spark_tpu_torch import history, metrics, trace, tracing
from spark_tpu_torch.api.session import SparkSession

from test_torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.timeout(180)

_Q = "SELECT a.k, SUM(a.v + b.v) AS s FROM tr_a a JOIN tr_b b ON a.k = b.k " \
     "GROUP BY a.k ORDER BY s"


def _write(path, nrows, nkeys):
    pq.write_table(pa.table({"k": [i % nkeys for i in range(nrows)],
                             "v": [float(i) * 0.5 for i in range(nrows)]}),
                   str(path))
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("trace")
    return _write(d / "a.parquet", 96, 6), _write(d / "b.parquet", 48, 6)


@pytest.fixture(scope="module")
def port(files):
    s = SparkSession(device="cpu")
    s.read.parquet(files[0]).createOrReplaceTempView("tr_a")
    s.read.parquet(files[1]).createOrReplaceTempView("tr_b")
    return s


@pytest.fixture()
def tconf(port):
    yield port.conf
    for k in list(port.conf._overrides):
        if k.startswith("spark.tpu.trace"):
            port.conf.unset(k)


def _spans(evs):
    return [e for e in evs if e.get("kind") == "span"]


def _roots(spans):
    ids = {e.get("span_id") for e in spans}
    return [e for e in spans if e.get("parent_id") not in ids]


def _edges(spans):
    """{(parent name, name)} of one trace."""
    by_id = {e["span_id"]: e for e in spans}

    def parent_name(e):
        p = by_id.get(e.get("parent_id"))
        return None if p is None else p["name"]

    return {(parent_name(e), e["name"]) for e in spans}


# ---- registry and wire form ----------------------------------------------------


def test_trace_conf_keys_registered_with_reference_defaults():
    assert CF.is_registered("spark.tpu.trace.enabled")
    assert CF.is_registered("spark.tpu.trace.sampleRatio")
    assert trace.TRACE_ENABLED.default is True
    assert trace.TRACE_SAMPLE_RATIO.default == 1.0


def test_span_names_are_the_references():
    assert trace.SPAN_NAMES == RT.SPAN_NAMES
    with pytest.raises(ValueError, match="undeclared span name"):
        with trace.span("no.such.span"):
            pass


@pytest.mark.parametrize("value", [
    "ab12ab12ab12ab12-cd34cd34-1", "ab12ab12ab12ab12-cd34cd34-0", None, "",
    "zz", "a-b", "a-b-c-d", "xyz!-12-1", "--1", "ab12-"])
def test_header_decoding_matches_reference(value):
    mine, ref = trace.from_header(value), RT.from_header(value)
    assert (mine is None) == (ref is None)
    if mine is not None:
        assert tuple(mine) == tuple(ref)
        assert mine.header() == ref.header()


def test_header_value_and_attach():
    assert trace.header_value() is None
    with trace.span("query.execute") as root:
        assert trace.header_value() == root.header()
        assert trace.current_trace_id() == root.trace_id
    remote = trace.from_header(root.header())
    with trace.attach(remote):
        with trace.span("stage.run") as child:
            assert child.trace_id == root.trace_id
            assert child.parent_id == root.span_id


# ---- the span tree --------------------------------------------------------------


def test_span_tree_well_formed_multi_stage_plan(port):
    assert port.sql(_Q).collect()
    evs = metrics.last_query()
    spans = _spans(evs)
    assert {e["trace_id"] for e in spans} == {spans[0]["trace_id"]}
    roots = _roots(spans)
    assert [r["name"] for r in roots] == ["query.execute"]
    ids = {e["span_id"] for e in spans}
    assert all(e["parent_id"] in ids for e in spans if e is not roots[0])
    stages = [e for e in evs if e["kind"] == "stage"]
    assert stages and all(e["trace_id"] == roots[0]["trace_id"]
                          for e in stages)
    # one stage.run span per stage event
    assert len([e for e in spans if e["name"] == "stage.run"]) == len(stages)


def test_span_nesting_matches_reference(port, spark, files):
    """The same query through both packages: the same span names under
    the same parents."""
    spark.read.parquet(files[0]).createOrReplaceTempView("tr_a")
    spark.read.parquet(files[1]).createOrReplaceTempView("tr_b")
    ref_rows = spark.sql(_Q).collect()
    ref_edges = _edges(_spans(RM.last_query()))
    rows = port.sql(_Q).collect()
    assert [tuple(r) for r in rows] == [tuple(r) for r in ref_rows]
    assert _edges(_spans(metrics.last_query())) == ref_edges


def test_breakdown_components_sum_to_wall(port):
    port.sql("SELECT k, SUM(v) FROM tr_a GROUP BY k").collect()
    bd = tracing.trace_breakdown()
    assert bd["wall_ms"] > 0
    total = bd["queue_ms"] + bd["device_ms"] + bd["transfer_ms"] \
        + bd["host_ms"]
    assert abs(total - bd["wall_ms"]) <= 0.01
    assert tracing.format_trace().startswith("trace ")


def test_breakdown_unions_overlapping_device_spans():
    evs = [
        {"kind": "span", "name": "query.execute", "span_id": "r",
         "parent_id": None, "t0": 0.0, "ms": 100.0},
        {"kind": "span", "name": "stage.device", "span_id": "a",
         "parent_id": "r", "t0": 0.010, "ms": 30.0},
        {"kind": "span", "name": "stage.device", "span_id": "b",
         "parent_id": "r", "t0": 0.020, "ms": 30.0},
        {"kind": "span", "name": "stage.device", "span_id": "c",
         "parent_id": "r", "t0": 0.080, "ms": 10.0},
    ]
    bd = tracing.trace_breakdown(evs)
    assert bd["device_ms"] == pytest.approx(50.0)
    assert bd["host_ms"] == pytest.approx(50.0)


def test_chrome_trace_valid_json(port):
    port.sql("SELECT k, SUM(v) FROM tr_b GROUP BY k").collect()
    tid = _spans(metrics.last_query())[0]["trace_id"]
    doc = json.loads(json.dumps(history.chrome_trace(
        metrics.query_events(tid))))
    xs = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    assert {e["name"] for e in xs} >= {"query.execute", "stage.run"}
    assert all(e["ts"] >= 0 and e["dur"] >= 0 for e in xs)


def test_mesh_rank_spans_carry_the_query_trace_id(files):
    """The rank threads run in a copy of the query's context: their
    stage.device spans and the stats stages' spans join its trace."""
    s = SparkSession("cpu", {CF.MESH_DEVICES.key: 2,
                             "spark.tpu.adaptive.enabled": True},
                     ["cpu", "cpu"])
    s.read.parquet(files[0]).createOrReplaceTempView("tr_a")
    s.read.parquet(files[1]).createOrReplaceTempView("tr_b")
    s.sql(_Q).collect()
    evs = metrics.last_query()
    spans = _spans(evs)
    tid = _roots(spans)[0]["trace_id"]
    dev = [e for e in spans if e["name"] == "stage.device"]
    stats = [e for e in spans if e["name"] == "exchange.stats"]
    assert dev and stats
    assert {e["rank"] for e in dev} == {0, 1}
    assert all(e["trace_id"] == tid for e in dev + stats)
    assert len({e["tid"] for e in dev}) >= 2  # recorded on rank threads
    assert all(e["trace_id"] == tid for e in evs
               if e["kind"] in ("stage", "exchange", "agg", "aqe"))


# ---- on/off, sampling and cost ---------------------------------------------------


def test_on_off_sweep_rows_equal(port, tconf):
    def run():
        return port.sql(_Q).toArrow()

    ref = run()
    for enabled, ratio in ((True, 1.0), (True, 0.5), (True, 0.0),
                           (False, 1.0)):
        tconf.set("spark.tpu.trace.enabled", enabled)
        tconf.set("spark.tpu.trace.sampleRatio", ratio)
        assert run().equals(ref), (enabled, ratio)


def test_sampling_honored_ids_still_stamped(port, tconf):
    tconf.set("spark.tpu.trace.sampleRatio", 0.0)
    port.sql("SELECT k, SUM(v) FROM tr_a GROUP BY k").collect()
    evs = metrics.last_query()
    assert _spans(evs) == []
    assert all(e.get("trace_id") for e in evs if e["kind"] == "stage")
    tconf.set("spark.tpu.trace.sampleRatio", 1.0)
    port.sql("SELECT k, COUNT(*) FROM tr_a GROUP BY k").collect()
    assert _spans(metrics.last_query())
    tconf.set("spark.tpu.trace.enabled", False)
    port.sql("SELECT k, MAX(v) FROM tr_a GROUP BY k").collect()
    assert _spans(metrics.last_query()) == []


def test_brownout_sheds_new_roots():
    metrics.set_brownout(1)
    try:
        with trace.span("query.execute") as ctx:
            assert not ctx.sampled
    finally:
        metrics.set_brownout(0)
    assert metrics.brownout_stats()["entered"] >= 1


def test_span_and_event_host_cost_is_small():
    """A span (enter, exit and its event) and a flat event cost tens of
    microseconds of host time at most (best of several batches, so a
    loaded host does not decide it); the walls with tracing on and off
    are measured on the card (chip_smoke.py's obs phase)."""
    def best_us(fn, n=2000):
        best = float("inf")
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            best = min(best, (time.perf_counter() - t0) / n * 1e6)
        return best

    def one_span():
        with trace.span("stage.run", op="fused"):
            pass

    with trace.span("query.execute"):
        span_us = best_us(one_span)
        event_us = best_us(lambda: metrics.record("stage", op="x", ms=0.1))
    assert span_us < 200.0 and event_us < 100.0, (span_us, event_us)


# ---- the profiling glue (tests/test_tracing.py) ------------------------------------


def test_query_profile_rolls_up_stage_events(port):
    metrics.reset()
    port.range(1000).filter("id % 3 = 0").count()
    prof = tracing.query_profile()
    assert prof and all({"count", "total_ms", "max_ms"} <= set(v)
                        for v in prof.values())
    assert "total_ms" in tracing.format_profile(prof)


def test_planning_tracker():
    t = tracing.PlanningTracker()
    with t.phase("parse"):
        pass
    with t.phase("optimize"):
        sum(range(1000))
    with t.phase("optimize"):
        pass
    assert set(t.phases()) == {"parse", "optimize"}


def test_profiler_trace_holds_the_annotated_region(tmp_path, port):
    d = str(tmp_path / "trace")
    with tracing.trace(d, cuda=False) as session:
        with tracing.annotate("q-region"):
            port.range(100).count()
    files = [f for f in os.listdir(d) if f.endswith(".json")]
    assert files and session.path.endswith(files[0])
    assert session.profile.key_averages()
    with open(session.path) as f:
        doc = json.load(f)
    names = {e.get("name") for e in doc["traceEvents"]}
    assert "q-region" in names


def test_pipeline_profile_rolls_up_chunk_events():
    evs = [
        {"kind": "chunked_agg", "chunks": 4, "decode_ms": 10.0,
         "transfer_ms": 5.0, "compute_ms": 8.0, "wall_ms": 20.0,
         "overlap_ms": 5.0, "pipeline_depth": 2},
        {"kind": "chunked_agg", "chunks": 2, "decode_ms": 4.0,
         "transfer_ms": 1.0, "compute_ms": 2.0, "wall_ms": 10.0,
         "overlap_ms": 1.0, "pipeline_depth": 2},
        {"kind": "stage", "op": "HashAggregate", "ms": 3.0},
    ]
    from spark_tpu import tracing as RTr

    prof = tracing.pipeline_profile(evs)
    assert prof == RTr.pipeline_profile(evs)
    assert prof["chunked_agg"]["overlap_ratio"] == 0.2
    assert "overlap" in tracing.format_pipeline_profile(prof)
    assert tracing.pipeline_profile([]) == {}


@pytest.mark.parametrize("fold", ["exchange_profile", "fault_profile",
                                  "scheduler_profile", "analysis_profile",
                                  "aggregation_profile", "serve_profile"])
def test_profiles_fold_as_the_references(fold):
    """The pure folds over the same events give the reference's result
    (the live counters each profile adds are zeroed on both sides)."""
    from spark_tpu import tracing as RTr

    rng = np.random.default_rng(3)
    evs = []
    for i in range(40):
        kind = ["exchange", "aqe", "fault_injected", "fault_recovered",
                "scheduler", "analysis", "agg", "stage", "serve",
                "serve_cache"][i % 10]
        evs.append({"kind": kind, "n": i, "op": ["hash", "range"][i % 2],
                    "mode": "adaptive", "devices": 4,
                    "rows": int(rng.integers(0, 1000)),
                    "capacity_before": 4096, "capacity_after": 1024,
                    "buffer_bytes": 8192, "decision": "broadcast_join",
                    "point": "execute.device", "pool": "default",
                    "phase": ["finished", "submitted"][i % 2],
                    "queue_wait_ms": 1.5, "device_ms": 2.0, "plan": "P",
                    "errors": 0, "warnings": 1, "diagnostics": 1,
                    "elapsed_ms": 0.5, "strategy": "hash", "ndv": 10,
                    "ratio": 0.1, "domain": 64,
                    "replica": f"r{i % 3}", "ms": 1.25, "bytes": 64})
    for mod in (metrics, RM):
        mod.reset_agg()
        mod.reset_serve()
        mod.reset_brownout()
        mod.reset_retry_budget()
    mine, ref = getattr(tracing, fold)(evs), getattr(RTr, fold)(evs)
    for d in (mine, ref):
        d.pop("totals", None)
    assert mine == ref


# ---- the serving tier: one trace across client, router and replica ----------


def test_fleet_propagation_two_replicas(port):
    from spark_tpu_torch.connect.server import Client
    from spark_tpu_torch.serve import serve_fleet

    fleet = serve_fleet(port, replicas=2)
    try:
        c = Client(fleet.url, timeout=60)
        rows = c.sql(_Q)
        assert rows.equals(port.sql(_Q).toArrow())
        spans = _spans(metrics.query_events(c.last_trace_id))
        assert {e.get("name") for e in spans} >= {
            "connect.client", "router.dispatch", "router.forward",
            "connect.request", "scheduler.run", "scheduler.queue",
            "query.execute", "stage.run"}
        roots = _roots(spans)
        assert len(roots) == 1 and roots[0]["name"] == "connect.client"
        doc = c.trace()
        xs = {e["name"] for e in doc["traceEvents"] if e.get("ph") == "X"}
        assert xs >= {"router.dispatch", "connect.request", "scheduler.run",
                      "stage.run"}
    finally:
        fleet.stop()


def test_shed_redispatch_shares_one_trace(port):
    import urllib.request

    from spark_tpu_torch.conf import RuntimeConf
    from spark_tpu_torch.connect.server import ConnectServer
    from spark_tpu_torch.scheduler import QueryScheduler
    from spark_tpu_torch.serve import FederationRouter

    full = ConnectServer(
        port, port=0, replica_id="full",
        scheduler=QueryScheduler(conf=RuntimeConf(
            {"spark.tpu.scheduler.queueDepth": 0}))).start()
    ok = ConnectServer(port, port=0, replica_id="ok").start()
    router = FederationRouter(
        [full, ok], conf=RuntimeConf(
            {"spark.tpu.serve.policy": "round_robin"})).start()
    try:
        req = urllib.request.Request(
            router.url + "/sql",
            data=json.dumps({"query": "SELECT k FROM tr_a WHERE k > 0"})
            .encode(), headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert resp.status == 200
            tid = resp.headers.get("X-SparkTpu-Trace-Id")
        assert tid
        evs = metrics.query_events(tid)
        forwards = [e for e in _spans(evs) if e.get("name") == "router.forward"]
        assert [e.get("replica") for e in forwards] == ["full", "ok"]
        sheds = [e for e in evs if e.get("kind") == "serve"
                 and e.get("phase") == "shed"]
        assert sheds and all(e.get("trace_id") == tid for e in sheds)
    finally:
        router.stop()
        full.stop()
        ok.stop()
