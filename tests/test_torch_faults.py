"""The port's fault injection (``spark_tpu_torch/faults.py``) and the seams
it is wired into, on the inputs of tests/test_faults.py.

Held against the reference: the points and kinds, ``parse_spec``'s
accept and reject cases, and each point's fire sequence under nth and
prob specs (the per-point salted streams). Held against the port itself:
the fault matrix of every wired point (``pipeline.decode``,
``pipeline.transfer``, ``execute.device``, ``exchange.all_to_all`` at 1, 2
and 8 CPU ranks, ``agg.strategy``, ``agg.presplit``, ``fusion.decide`` and
``join.spill``) gives the clean run's rows or raises the typed error, the
chunk retry keeps source order, the OOM ladder replans an injected OOM,
and the fault profile and the event log see every injection. The connect
server's cells (``connect.request`` of each kind, a hung request against
the client's deadline, ``/health`` with and without a heartbeat) are
here, and the streaming commit's (a crash of each kind replays from
the WAL to the reference's rows); the scheduler, serve and slo points
have their cells in tests/test_torch_scheduler.py, test_torch_serve.py,
test_torch_fleet.py and test_torch_slo.py, the compile and mview points
in tests/test_torch_compile.py and test_torch_mview.py. Every point of
the reference is wired.
"""

import json
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_tpu import faults as RF
from spark_tpu.conf import RuntimeConf as RefConf
from spark_tpu_torch import conf as CF
from spark_tpu_torch import faults, metrics, recovery, tracing
from spark_tpu_torch.api.session import SparkSession
from spark_tpu_torch.conf import RuntimeConf
from spark_tpu_torch.metrics import PipelineStats
from spark_tpu_torch.physical import chunked
from spark_tpu_torch.physical.pipeline import ChunkPipeline

from test_torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.timeout(300)

_KEYS = tuple(f"spark.tpu.faultInjection.{p}" for p in faults.POINTS) + (
    "spark.tpu.faultInjection.hangSeconds", "spark.tpu.maxDeviceBatchBytes",
    "spark.tpu.chunkRows", "spark.tpu.chunkRetryAttempts",
    "spark.tpu.oomDegrade.floorBytes", "spark.tpu.oomDegrade.enabled",
    "spark.tpu.pipelineDepth", "spark.stage.maxConsecutiveAttempts",
    "spark.eventLog.dir")


@pytest.fixture(scope="module")
def port():
    return SparkSession(device="cpu")


@pytest.fixture()
def fconf(port):
    """The session's settings, every fault arm and tier knob unset and
    the arming counters dropped afterwards."""
    conf = port.conf
    faults.reset(conf)
    yield conf
    for key in _KEYS:
        conf.unset(key)
    faults.reset(conf)


@pytest.fixture(scope="module")
def fact_parquet(tmp_path_factory):
    """An integer fact table: sums and counts are exact in every tier."""
    rng = np.random.default_rng(7)
    n = 40_000
    tbl = pa.table({"k": pa.array(rng.integers(0, 50, n), pa.int64()),
                    "v": pa.array(rng.integers(0, 1000, n), pa.int64())})
    path = str(tmp_path_factory.mktemp("faults") / "fact.parquet")
    pq.write_table(tbl, path, row_group_size=5_000)
    return path


_GOLDEN = "SELECT k, SUM(v) AS s, COUNT(*) AS c FROM {t} GROUP BY k ORDER BY k"


def _golden(spark, path, view="fact_tbl"):
    spark.read.parquet(path).createOrReplaceTempView(view)
    query = _GOLDEN.format(t=view)
    return lambda: [tuple(r) for r in spark.sql(query).collect()]


def _kinds(n=4096):
    return [e["kind"] for e in metrics.recent(n)]


def _set_chunked(conf):
    conf.set("spark.tpu.maxDeviceBatchBytes", 1 << 16)
    conf.set("spark.tpu.chunkRows", 8_192)
    conf.set("spark.tpu.oomDegrade.floorBytes", 1 << 12)


# ---- the switchboard against the reference ---------------------------------


def test_points_and_kinds_are_the_references():
    assert faults.POINTS == RF.POINTS
    assert faults.KINDS == RF.KINDS
    for p in faults.POINTS:
        assert CF.is_registered(f"spark.tpu.faultInjection.{p}")


def test_every_point_is_wired():
    """The streaming, compile and mview tiers wired the last three
    points: every point of the reference has its seam in the port."""
    assert {"streaming.commit", "compile.background",
            "mview.refresh"} <= set(faults.WIRED_POINTS)
    assert set(faults.WIRED_POINTS) == set(faults.POINTS)


_SPECS = ["none", "", "nth:3", "nth:1:oom", "prob:0.25:99:corrupt",
          "prob:1:7:hang", " nth:2:transient ", "nth", "nth:x",
          "nth:1:bogus", "prob:0.5", "prob:p:1", "wat:1", "nth:1:2:3",
          "prob:0.5:1:2:3"]


@pytest.mark.parametrize("spec", _SPECS)
def test_parse_spec_matches_reference(spec):
    def parsed(mod):
        try:
            s = mod.parse_spec(spec)
        except ValueError:
            return "ValueError"
        return None if s is None else (s.mode, s.kind, s.k, s.p, s.seed)

    assert parsed(faults) == parsed(RF)


def _pattern(mod, conf, point, n):
    out = []
    for _ in range(n):
        try:
            mod.inject(point, conf)
            out.append(False)
        except mod.InjectedFault as e:
            out.append(e.kind)
    return out


@pytest.mark.parametrize("point", faults.POINTS)
def test_fire_sequences_match_reference(point):
    """Each point's fire sequence under a prob spec (its salted stream)
    and an nth spec, 64 arrivals, equals the reference's."""
    key = f"spark.tpu.faultInjection.{point}"
    for spec in ("prob:0.4:424242:transient", "prob:0.7:9:corrupt",
                 "nth:5:oom"):
        mine = _pattern(faults, RuntimeConf({key: spec}), point, 64)
        ref = _pattern(RF, RefConf({key: spec}), point, 64)
        assert mine == ref, spec
    assert any(mine)


def test_prob_streams_isolated_per_point():
    """One point's arrivals never shift another's draws."""
    spec = "prob:0.5:424242"
    ka = "spark.tpu.faultInjection.execute.device"
    kb = "spark.tpu.faultInjection.join.spill"
    alone = _pattern(faults, RuntimeConf({ka: spec}), "execute.device", 40)
    conf = RuntimeConf({ka: spec, kb: spec})
    mixed = []
    for _ in range(40):
        mixed += _pattern(faults, conf, "execute.device", 1)
        _pattern(faults, conf, "join.spill", 1)
    assert mixed == alone and 0 < sum(map(bool, alone)) < 40


def test_nth_fires_exactly_once_and_rearms():
    conf = RuntimeConf({})
    conf.set("spark.tpu.faultInjection.execute.device", "nth:2")
    faults.inject("execute.device", conf)
    with pytest.raises(faults.InjectedTransientError) as ei:
        faults.inject("execute.device", conf)
    assert "UNAVAILABLE" in str(ei.value)
    assert ei.value.point == "execute.device"
    for _ in range(5):
        faults.inject("execute.device", conf)
    assert faults.fire_count(conf, "execute.device") == 1
    conf.set("spark.tpu.faultInjection.execute.device", "nth:1:corrupt")
    with pytest.raises(faults.InjectedCorruptionError):
        faults.inject("execute.device", conf)


def test_unknown_point_rejected_and_disarmed_is_noop(fconf):
    with pytest.raises(ValueError, match="unknown fault-injection point"):
        faults.inject("no.such.seam", RuntimeConf({}))
    faults.inject("execute.device", fconf)
    assert faults.fire_count(fconf, "execute.device") == 0


def test_injected_errors_classify_as_the_references():
    from spark_tpu import recovery as RR

    for kind, cls, rcls in (
            ("transient", faults.InjectedTransientError,
             RF.InjectedTransientError),
            ("hang", faults.InjectedDeadlineError, RF.InjectedDeadlineError),
            ("oom", faults.InjectedOOMError, RF.InjectedOOMError),
            ("corrupt", faults.InjectedCorruptionError,
             RF.InjectedCorruptionError)):
        mine, ref = cls("p", kind), rcls("p", kind)
        assert mine.kind == ref.kind == kind
        assert recovery.is_transient(mine) == RR.is_transient(ref)
        assert recovery.is_oom(mine) == RR.is_oom(ref)


def test_hang_sleeps_bounded_by_hang_seconds():
    import time

    conf = RuntimeConf({"spark.tpu.faultInjection.join.spill": "nth:1:hang",
                        "spark.tpu.faultInjection.hangSeconds": 0.05})
    t0 = time.perf_counter()
    with pytest.raises(faults.InjectedDeadlineError,
                       match="DEADLINE_EXCEEDED"):
        faults.inject("join.spill", conf)
    assert 0.04 <= time.perf_counter() - t0 < 2.0


# ---- the chunk pipeline's points --------------------------------------------


@pytest.mark.parametrize("point", ["pipeline.decode", "pipeline.transfer"])
@pytest.mark.parametrize("kind", ["transient", "hang", "oom", "corrupt"])
def test_fault_matrix_pipeline(port, fconf, fact_parquet, point, kind):
    run = _golden(port, fact_parquet)
    _set_chunked(fconf)
    clean = run()
    assert chunked.last_run["chunks"] >= 3
    metrics.reset()
    fconf.set("spark.tpu.faultInjection.hangSeconds", 0.02)
    fconf.set(f"spark.tpu.faultInjection.{point}", f"nth:2:{kind}")
    faults.reset(fconf)
    if kind == "corrupt":
        with pytest.raises(faults.InjectedCorruptionError, match="DATA_LOSS"):
            run()
        return
    assert run() == clean
    kinds = _kinds()
    assert "fault_injected" in kinds
    if kind in ("transient", "hang"):
        # the chunk retry took it; the query was not restarted
        assert "chunk_retry" in kinds and "fault_recovered" in kinds
        assert "stage_retry" not in kinds
    else:
        assert "degraded_to_chunked" in kinds


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_chunk_retry_depth_sweep(port, fconf, fact_parquet, depth):
    run = _golden(port, fact_parquet)
    _set_chunked(fconf)
    fconf.set("spark.tpu.pipelineDepth", depth)
    clean = run()
    metrics.reset()
    fconf.set("spark.tpu.faultInjection.pipeline.transfer", "nth:2")
    faults.reset(fconf)
    assert run() == clean
    assert faults.fire_count(fconf, "pipeline.transfer") == 1
    kinds = _kinds()
    assert "chunk_retry" in kinds and "stage_retry" not in kinds


def test_chunk_retry_exhaustion_fails_cleanly(port, fconf, fact_parquet):
    run = _golden(port, fact_parquet)
    _set_chunked(fconf)
    fconf.set("spark.tpu.faultInjection.pipeline.transfer",
              "prob:1.0:7:transient")
    fconf.set("spark.tpu.chunkRetryAttempts", 2)
    fconf.set("spark.stage.maxConsecutiveAttempts", 2)
    faults.reset(fconf)
    with pytest.raises(RuntimeError, match="consecutive attempts"):
        run()


def test_decode_failure_not_retried_mid_stream():
    """A real decode failure (the source raised) is not retried: the
    generator is spent, and a retry would truncate the stream."""
    def source():
        yield 1
        raise ConnectionResetError("mid-stream")

    pipe = ChunkPipeline(source(), lambda x: x, depth=1, byte_budget=1 << 20,
                         stats=PipelineStats(), nbytes_of=lambda p: 0,
                         conf=RuntimeConf({}))
    with pytest.raises(ConnectionResetError):
        list(pipe)


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("point", ["pipeline.decode", "pipeline.transfer"])
def test_chunk_retry_keeps_source_order(depth, point):
    conf = RuntimeConf({f"spark.tpu.faultInjection.{point}": "nth:3"})
    pipe = ChunkPipeline(iter(range(6)), lambda x: x * 10, depth=depth,
                         byte_budget=1 << 20, stats=PipelineStats(),
                         nbytes_of=lambda p: 0, conf=conf)
    assert list(pipe) == [0, 10, 20, 30, 40, 50]
    assert faults.fire_count(conf, point) == 1


# ---- the whole-batch execution point and the OOM ladder ---------------------


@pytest.mark.parametrize("kind", ["transient", "hang", "oom", "corrupt"])
def test_fault_matrix_execute_device(port, fconf, fact_parquet, kind):
    run = _golden(port, fact_parquet)
    clean = run()
    metrics.reset()
    fconf.set("spark.tpu.faultInjection.hangSeconds", 0.02)
    fconf.set("spark.tpu.faultInjection.execute.device", f"nth:1:{kind}")
    fconf.set("spark.tpu.chunkRows", 8_192)
    # the table is 640 KB: the ladder halves below the default 1 MiB floor
    fconf.set("spark.tpu.oomDegrade.floorBytes", 1 << 12)
    faults.reset(fconf)
    if kind == "corrupt":
        with pytest.raises(faults.InjectedCorruptionError, match="DATA_LOSS"):
            run()
        return
    assert run() == clean
    kinds = _kinds()
    assert "fault_injected" in kinds and "fault_recovered" in kinds
    if kind in ("transient", "hang"):
        assert "stage_retry" in kinds
    else:
        # an OOM is never retried as is: it replans through the ladder
        assert "degraded_to_chunked" in kinds
        assert "stage_retry" not in kinds
        assert recovery.last_ladder["replans"] >= 1


def test_oom_ladder_budget_stays_on_a_shadow(port, fconf, fact_parquet):
    run = _golden(port, fact_parquet)
    clean = run()
    metrics.reset()
    fconf.set("spark.tpu.faultInjection.execute.device", "nth:1:oom")
    fconf.set("spark.tpu.chunkRows", 8_192)
    fconf.set("spark.tpu.oomDegrade.floorBytes", 1 << 12)
    faults.reset(fconf)
    assert run() == clean
    degr = [e for e in metrics.recent() if e["kind"] == "degraded_to_chunked"]
    assert degr and "RESOURCE_EXHAUSTED" in degr[0]["error"]
    rec = [e for e in metrics.recent() if e["kind"] == "fault_recovered"
           and e.get("how") == "degraded_to_chunked"]
    assert rec and rec[0]["budget"] == degr[-1]["budget"]
    assert fconf.get(chunked.MAX_DEVICE_BATCH_BYTES) \
        == chunked.MAX_DEVICE_BATCH_BYTES.default
    assert run() == clean


def test_oom_ladder_gives_up_at_floor(port, fconf, fact_parquet):
    run = _golden(port, fact_parquet)
    fconf.set("spark.tpu.faultInjection.execute.device", "nth:1:oom")
    fconf.set("spark.tpu.faultInjection.pipeline.transfer", "prob:1.0:1:oom")
    fconf.set("spark.tpu.maxDeviceBatchBytes", 1 << 20)
    fconf.set("spark.tpu.chunkRows", 8_192)
    fconf.set("spark.tpu.oomDegrade.floorBytes", 1 << 18)
    faults.reset(fconf)
    with pytest.raises(RuntimeError, match="floor") as ei:
        run()
    assert recovery.is_oom(ei.value.__cause__)


def test_oom_unchunkable_plan_surfaces_original(port, fconf):
    port.createDataFrame([{"k": i % 3, "v": i} for i in range(100)]) \
        .createOrReplaceTempView("mem_tbl")
    fconf.set("spark.tpu.faultInjection.execute.device", "nth:1:oom")
    faults.reset(fconf)
    with pytest.raises(faults.InjectedOOMError, match="RESOURCE_EXHAUSTED"):
        port.sql("SELECT k, SUM(v) AS s FROM mem_tbl GROUP BY k").collect()


def test_oom_degrade_disabled_surfaces_oom(port, fconf, fact_parquet):
    run = _golden(port, fact_parquet)
    fconf.set("spark.tpu.oomDegrade.enabled", False)
    fconf.set("spark.tpu.faultInjection.execute.device", "nth:1:oom")
    faults.reset(fconf)
    with pytest.raises(faults.InjectedOOMError):
        run()


# ---- the mesh's points, at 1, 2 and 8 CPU ranks -----------------------------


def _mesh_session(n):
    return SparkSession("cpu", {CF.MESH_DEVICES.key: n}, ["cpu"] * n)


# ---- fault matrix: streaming micro-batch commit ---------------------------------


@pytest.mark.parametrize("kind", ["transient", "hang", "oom", "corrupt"])
def test_streaming_commit_crash_replays_from_wal(port, fconf, tmp_path, kind):
    """A crash at the commit seam loses nothing, whatever killed it: the
    restarted query replays the logged offsets and reaches the same
    state, and the replay is a fault_recovered event. The rows equal
    the reference's uninterrupted run of the same micro-batches."""
    from spark_tpu.api import functions as RFn
    from spark_tpu.streaming import MemoryStream as RefStream
    from spark_tpu_torch.api import functions as F
    from spark_tpu_torch.streaming import MemoryStream

    expected_exc = {
        "transient": faults.InjectedTransientError,
        "hang": faults.InjectedDeadlineError,
        "oom": faults.InjectedOOMError,
        "corrupt": faults.InjectedCorruptionError,
    }[kind]
    batches = ([{"k": "a", "v": 5}], [{"k": "a", "v": 7}, {"k": "b", "v": 1}])
    ckpt = str(tmp_path / "fck")
    src = MemoryStream(pa.schema([("k", pa.string()), ("v", pa.int64())]))
    agg = port.readStream.load(src).groupBy("k").agg(F.sum("v").alias("s"))
    q = agg.writeStream.outputMode("complete").queryName("fstr1") \
        .option("checkpointLocation", ckpt).start()
    src.add_data(batches[0])
    q.process_all_available()

    fconf.set("spark.tpu.faultInjection.hangSeconds", 0.02)
    fconf.set("spark.tpu.faultInjection.streaming.commit", f"nth:1:{kind}")
    faults.reset(fconf)
    src.add_data(batches[1])
    with pytest.raises(expected_exc):
        q.process_all_available()
    q.stop()
    fconf.unset("spark.tpu.faultInjection.streaming.commit")

    metrics.reset()
    q2 = agg.writeStream.outputMode("complete").queryName("fstr2") \
        .option("checkpointLocation", ckpt).start()
    q2.process_all_available()
    rows = {r.k: r.s for r in port.sql("select * from fstr2").collect()}
    assert rows == {"a": 12, "b": 1}
    assert any(e["kind"] == "fault_recovered"
               and e.get("how") == "wal_replay" for e in metrics.recent(100))
    q2.stop()

    from spark_tpu.api.session import SparkSession as RefSession

    ref = RefSession.builder.getOrCreate()
    rsrc = RefStream(pa.schema([("k", pa.string()), ("v", pa.int64())]))
    rq = ref.readStream.load(rsrc).groupBy("k").agg(
        RFn.sum("v").alias("s")).writeStream.outputMode("complete") \
        .queryName(f"fstr_ref_{kind}").start()
    for b in batches:
        rsrc.add_data(b)
        rq.process_all_available()
    assert rows == {r.k: r.s for r in ref.sql(
        f"select * from fstr_ref_{kind}").collect()}


@pytest.fixture(scope="module")
def mesh_sessions():
    """mesh[1], mesh[2] and mesh[8] sessions over one small table whose
    group keys suit every strategy cell."""
    rng = np.random.default_rng(5)
    n = 6_000
    keys = np.where(rng.random(n) < 0.7, 7, rng.integers(0, 3_000, n))
    tbl = pa.table({"g": pa.array(keys, pa.int64()),
                    "v": pa.array(rng.integers(0, 100, n), pa.int64())})
    out = {}
    for d in (1, 2, 8):
        s = _mesh_session(d)
        s.createDataFrame(tbl).createOrReplaceTempView("mf")
        out[d] = s
    return out


_MESH_Q = ("SELECT g, SUM(v) AS s, COUNT(*) AS c FROM mf GROUP BY g "
           "ORDER BY g")


def _mesh_rows(s):
    return [tuple(r) for r in s.sql(_MESH_Q).collect()]


@pytest.fixture(scope="module")
def mesh_clean(mesh_sessions):
    rows = {d: _mesh_rows(s) for d, s in mesh_sessions.items()}
    assert rows[1] == rows[2] == rows[8]
    return rows[1]


def _armed(conf, settings):
    class _Arm:
        def __enter__(self):
            for k, v in settings.items():
                conf.set(k, v)
            faults.reset(conf)

        def __exit__(self, *exc):
            for k in settings:
                conf.unset(k)
            faults.reset(conf)

    return _Arm()


@pytest.mark.parametrize("ranks", [1, 2, 8])
@pytest.mark.parametrize("kind", ["transient", "hang", "oom", "corrupt"])
def test_fault_matrix_exchange(mesh_sessions, mesh_clean, ranks, kind):
    """``exchange.all_to_all`` fires on a rank's arrival: the stage's
    collectives abort; a transient kind is retried from the logical plan,
    an OOM replans through the ladder's rung 0 (the adaptive retry), and
    both give the clean rows; a corruption surfaces typed."""
    s = mesh_sessions[ranks]
    with _armed(s.conf, {
            "spark.tpu.faultInjection.hangSeconds": 0.02,
            "spark.tpu.faultInjection.exchange.all_to_all": f"nth:1:{kind}"}):
        metrics.reset()
        if kind == "corrupt":
            with pytest.raises(faults.InjectedCorruptionError):
                _mesh_rows(s)
            return
        assert _mesh_rows(s) == mesh_clean
        assert faults.fire_count(s.conf, "exchange.all_to_all") == 1
        want = "stage_retry" if kind != "oom" else "degraded_to_adaptive"
        assert want in _kinds()


_AQE = {"spark.tpu.adaptive.enabled": True,
        "spark.tpu.adaptive.agg.enabled": True}


@pytest.mark.parametrize("ranks", [1, 2, 8])
@pytest.mark.parametrize("kind", ["transient", "oom", "corrupt"])
def test_agg_strategy_fault_falls_back_to_partial(mesh_sessions, mesh_clean,
                                                  ranks, kind):
    s = mesh_sessions[ranks]
    with _armed(s.conf, dict(_AQE, **{
            "spark.tpu.faultInjection.agg.strategy": f"nth:1:{kind}"})):
        metrics.reset()
        assert _mesh_rows(s) == mesh_clean
        agg = [e for e in metrics.last_query() if e["kind"] == "agg"]
        assert agg and agg[0]["strategy"] == "partial" \
            and agg[0]["mode"] == "fallback"
        rec = [e for e in metrics.last_query()
               if e["kind"] == "fault_recovered"]
        assert rec and rec[0]["point"] == "agg.strategy"
        assert s.mesh_executor.last_run["events"][0]["mode"] == "fallback"


@pytest.mark.parametrize("ranks", [2, 8])
def test_agg_presplit_fault_falls_back_to_partial(mesh_sessions, mesh_clean,
                                                  ranks):
    s = mesh_sessions[ranks]
    with _armed(s.conf, dict(_AQE, **{
            "spark.tpu.adaptive.agg.strategy": "presplit",
            "spark.tpu.adaptive.agg.presplitFactor": 1,
            "spark.tpu.adaptive.agg.presplitMinRows": 64})):
        assert _mesh_rows(s) == mesh_clean
        agg = [e for e in metrics.last_query() if e["kind"] == "agg"]
        assert agg[0]["strategy"] == "presplit"
        s.conf.set("spark.tpu.faultInjection.agg.presplit", "nth:1:hang")
        s.conf.set("spark.tpu.faultInjection.hangSeconds", 0.01)
        faults.reset(s.conf)
        assert _mesh_rows(s) == mesh_clean
        agg = [e for e in metrics.last_query() if e["kind"] == "agg"]
        assert (agg[0]["strategy"], agg[0]["mode"]) \
            == ("partial", "presplit_fallback")
        s.conf.unset("spark.tpu.faultInjection.agg.presplit")
        s.conf.unset("spark.tpu.faultInjection.hangSeconds")


@pytest.mark.parametrize("ranks", [1, 2, 8])
def test_fusion_decide_fault_runs_staged(mesh_sessions, ranks):
    """A float-sum aggregate pins to partial and fuses; an injected fault
    at the decision runs it staged, with the same rows."""
    s = mesh_sessions[ranks]
    q = ("SELECT g % 13 AS h, SUM(CAST(v AS DOUBLE)) AS s FROM mf "
         "GROUP BY g % 13 ORDER BY h")
    with _armed(s.conf, dict(_AQE, **{"spark.tpu.fusion.enabled": True})):
        fused = [tuple(r) for r in s.sql(q).collect()]
        assert any(e["kind"] == "fusion" for e in metrics.last_query())
        s.conf.set("spark.tpu.faultInjection.fusion.decide", "nth:1:corrupt")
        faults.reset(s.conf)
        staged = [tuple(r) for r in s.sql(q).collect()]
        bail = [e for e in metrics.last_query()
                if e["kind"] == "fusion_bailout"]
        assert bail and bail[0]["reason"] == "fault_injected"
        s.conf.unset("spark.tpu.faultInjection.fusion.decide")
    assert staged == fused


# ---- the hybrid join's spill point -------------------------------------------


@pytest.fixture(scope="module")
def hybrid(port, tmp_path_factory):
    rng = np.random.default_rng(41)
    n = 60_000
    d = tmp_path_factory.mktemp("spill")
    fact = pa.table({"k": pa.array(rng.integers(0, 1000, n), pa.int64()),
                     "v": pa.array(rng.integers(0, 100, n), pa.int64())})
    dim = pa.table({"dk": pa.array(np.arange(100) * 10, pa.int64()),
                    "w": pa.array(np.arange(100) * 2, pa.int64())})
    pq.write_table(fact, str(d / "f.parquet"))
    pq.write_table(dim, str(d / "d.parquet"))
    port.read.parquet(str(d / "f.parquet")).createOrReplaceTempView("sp_f")
    port.read.parquet(str(d / "d.parquet")).createOrReplaceTempView("sp_d")
    sql = ("select sum(v * w) as s, count(*) as n from sp_f "
           "join sp_d on k = dk")
    want = [tuple(r) for r in port.sql(sql).collect()]
    return sql, want


_SPILL = {"spark.tpu.maxDeviceBatchBytes": 1024,
          "spark.tpu.chunkRows": 32_768,
          "spark.tpu.join.hybrid.partitionsMax": 16,
          "spark.tpu.scheduler.hbmBudgetBytes": 96 * 1024}


@pytest.mark.parametrize("kind", ["transient", "hang", "corrupt", "oom"])
def test_fault_matrix_join_spill(port, hybrid, kind):
    sql, want = hybrid
    with _armed(port.conf, dict(_SPILL, **{
            "spark.tpu.faultInjection.hangSeconds": 0.01,
            "spark.tpu.faultInjection.join.spill": f"nth:1:{kind}"})):
        metrics.reset()
        if kind == "oom":
            # an OOM goes to the degradation ladder, which has no budget
            # below this one to offer: the typed OOM surfaces
            with pytest.raises(faults.InjectedOOMError):
                port.sql(sql).collect()
            return
        got = [tuple(r) for r in port.sql(sql).collect()]
        rec = chunked.last_run
        kinds = _kinds()
    assert got == want
    assert "fault_injected" in kinds
    if kind in ("transient", "hang"):
        assert rec["tier"] == "_HybridHashJoinAgg" and rec["fallback"] is None
        assert rec["spill_retries"] == 1
    else:
        # one rung down: the grace join from the source
        assert rec["fallback"] == "grace"
        assert metrics.join_stats()["fallbacks"] >= 1


def test_join_spans_under_trace(port, hybrid):
    sql, want = hybrid
    with _armed(port.conf, _SPILL):
        assert [tuple(r) for r in port.sql(sql).collect()] == want
    names = {e["name"] for e in metrics.last_query() if e["kind"] == "span"}
    assert {"join.partition", "join.spill", "pipeline.decode",
            "pipeline.transfer"} <= names


# ---- observability of faults --------------------------------------------------


def test_fault_profile_rollup(port, fconf, fact_parquet):
    run = _golden(port, fact_parquet)
    run()
    metrics.reset()
    fconf.set("spark.tpu.faultInjection.execute.device", "nth:1:transient")
    faults.reset(fconf)
    run()
    prof = tracing.fault_profile()
    assert prof["fault_injected"]["count"] == 1
    assert prof["fault_injected"]["points"] == {"execute.device": 1}
    assert prof["stage_retry"]["count"] == 1
    assert prof["fault_recovered"]["count"] == 1
    text = tracing.format_fault_profile(prof)
    assert "fault_injected: 1" in text and "execute.device=1" in text


def test_fault_events_reach_event_log(port, fconf, fact_parquet, tmp_path):
    run = _golden(port, fact_parquet)
    log = str(tmp_path / "events")
    fconf.set("spark.eventLog.dir", log)
    fconf.set("spark.tpu.faultInjection.execute.device", "nth:1:transient")
    faults.reset(fconf)
    run()
    metrics.flush_log()
    recorded = []
    for f in os.listdir(log):
        with open(os.path.join(log, f)) as fh:
            recorded += [json.loads(line) for line in fh]
    kinds = {e.get("kind") for e in recorded}
    assert {"fault_injected", "fault_recovered", "stage_retry"} <= kinds


def test_retry_draws_stay_within_the_budget(port, fconf, fact_parquet):
    """A fault on every chunk transfer: the chunk retries and the stage
    retries all draw from one pool, and the query surfaces a typed error
    with at most the pool's draws (plus each layer's floor)."""
    run = _golden(port, fact_parquet)
    _set_chunked(fconf)
    fconf.set("spark.tpu.faultInjection.pipeline.transfer",
              "prob:1.0:3:transient")
    fconf.set("spark.tpu.recovery.retryBudget.attempts", 3)
    faults.reset(fconf)
    metrics.reset_retry_budget()
    try:
        with pytest.raises(Exception) as ei:
            run()
    finally:
        fconf.unset("spark.tpu.recovery.retryBudget.attempts")
    from spark_tpu_torch import chaos

    assert chaos.is_typed_error(ei.value)
    st = metrics.retry_budget_stats()
    assert st["draws"] - st["floor_draws"] <= 3
    assert st["denials"] >= 1


# ---- fault matrix: the connect round trip ----------------------------------


@pytest.fixture()
def connect_srv(port):
    from spark_tpu_torch.connect.server import ConnectServer

    port.createDataFrame([{"x": 1, "y": "a"}, {"x": 2, "y": "b"}]) \
        .createOrReplaceTempView("fconn_tv")
    srv = ConnectServer(port).start()
    yield srv
    srv.stop()


@pytest.mark.parametrize("kind", ["transient", "oom", "corrupt"])
def test_fault_matrix_connect(port, fconf, connect_srv, kind):
    from spark_tpu_torch.connect.server import Client

    cli = Client(connect_srv.url, timeout=10.0)
    assert cli.sql("SELECT x FROM fconn_tv ORDER BY x") \
        .column("x").to_pylist() == [1, 2]
    fconf.set("spark.tpu.faultInjection.connect.request", f"nth:1:{kind}")
    faults.reset(fconf)
    marker = {"transient": "UNAVAILABLE", "oom": "RESOURCE_EXHAUSTED",
              "corrupt": "DATA_LOSS"}[kind]
    with pytest.raises(RuntimeError) as ei:
        cli.sql("SELECT x FROM fconn_tv")
    # the typed marker and the server's traceback in the raised error
    assert marker in str(ei.value)
    assert "server traceback" in str(ei.value)
    assert faults.fire_count(fconf, "connect.request") == 1
    fconf.unset("spark.tpu.faultInjection.connect.request")
    # the server survives: the next request succeeds
    assert cli.sql("SELECT x FROM fconn_tv ORDER BY x") \
        .column("x").to_pylist() == [1, 2]


def test_connect_client_timeout_on_hung_server(port, fconf, connect_srv):
    """A hang longer than the client's deadline surfaces as
    DEADLINE_EXCEEDED instead of blocking."""
    from spark_tpu_torch.connect.server import Client

    fconf.set("spark.tpu.faultInjection.connect.request", "nth:1:hang")
    fconf.set("spark.tpu.faultInjection.hangSeconds", 3.0)
    faults.reset(fconf)
    cli = Client(connect_srv.url, timeout=0.3)
    with pytest.raises(RuntimeError, match="DEADLINE_EXCEEDED"):
        cli.sql("SELECT x FROM fconn_tv")


def test_connect_health_carries_heartbeat(port):
    from spark_tpu_torch.connect.server import Client, ConnectServer

    mon = recovery.HeartbeatMonitor(interval_s=30, device="cpu").start()
    srv = ConnectServer(port, heartbeat=mon).start()
    try:
        h = Client(srv.url, timeout=10.0).health()
        assert h["status"] == "ok"
        assert h["heartbeat"]["last_ok"] is not None
        assert h["heartbeat"]["interval_s"] == 30
    finally:
        srv.stop()
        mon.stop()


def test_connect_health_without_heartbeat(port, connect_srv):
    from spark_tpu_torch.connect.server import Client

    h = Client(connect_srv.url, timeout=10.0).health()
    assert h["status"] == "ok" and h["heartbeat"] is None
