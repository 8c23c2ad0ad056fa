"""The port's chaos harness (``spark_tpu_torch/chaos.py``) on the inputs of
tests/test_chaos.py: seeded campaigns over the fault points the port
wires (``faults.WIRED_POINTS``), on a CPU mesh and on one device (the
engine's points, and the streaming, compile and mview tiers'), each
schedule graded byte-identical or typed, with no hang, its retry draws
within the budget and the memory invariant kept; and over a two-replica
fleet through the router: a seeded campaign over every wired point, a
replica killed and revived (``chaos.kill_and_revive``), and the
router's health reporting the breakers, the brownout and the retry
budget.
"""

import json
import urllib.request

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_tpu_torch import chaos, faults, metrics
from spark_tpu_torch import conf as CF
from spark_tpu_torch.api.session import SparkSession

from test_torch_threads import one_torch_thread  # noqa: F401

#: the engine's seams (the mesh workload reaches no serving seam)
_ENGINE_POINTS = ("pipeline.decode", "pipeline.transfer", "execute.device",
                  "exchange.all_to_all", "agg.strategy", "agg.presplit",
                  "join.spill", "fusion.decide")

pytestmark = pytest.mark.timeout(240)


def _ipc(table: pa.Table) -> bytes:
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, table.schema) as w:
        w.write_table(table)
    return sink.getvalue().to_pybytes()


@pytest.fixture(scope="module")
def mesh():
    s = SparkSession("cpu", {CF.MESH_DEVICES.key: 2,
                             "spark.tpu.adaptive.enabled": True,
                             "spark.tpu.adaptive.agg.enabled": True,
                             "spark.tpu.fusion.enabled": True,
                             "spark.tpu.faultInjection.hangSeconds": 0.02},
                     ["cpu", "cpu"])
    rng = np.random.default_rng(11)
    n = 4_000
    s.createDataFrame(pa.table({
        "a": pa.array(rng.integers(0, 500, n), pa.int64()),
        "b": pa.array(rng.integers(0, 100, n), pa.int64())})) \
        .createOrReplaceTempView("chaos_t")
    return s


_QUERIES = ("SELECT a % 7 AS g, SUM(b) AS s, COUNT(*) AS c FROM chaos_t "
            "GROUP BY a % 7 ORDER BY g",
            "SELECT a, SUM(b) AS s FROM chaos_t GROUP BY a ORDER BY a")


def _workload(s):
    return b"\x00".join(_ipc(s.sql(q).toArrow()) for q in _QUERIES)


@pytest.mark.parametrize("seed", [7, 2026])
def test_mesh_campaign_passes_its_contract(mesh, seed):
    clean = _workload(mesh)
    schedules = chaos.generate_campaign(
        seed, 4, points=_ENGINE_POINTS, max_points=2)
    report = chaos.run_campaign(
        mesh.conf, lambda: _workload(mesh), schedules, clean_bytes=clean,
        alarm_s=60.0, queries=len(_QUERIES),
        memory_manager=mesh.memory_manager)
    assert report.ok, [r.to_dict() for r in report.failures]
    assert len(report.results) == 4
    for r in report.results:
        assert r.outcome in ("identical", "typed_error")
    assert _workload(mesh) == clean  # every arm was taken off again
    summary = report.summary()
    assert summary["schedules"] == 4 and summary["ok"]


def test_chunked_campaign_passes_its_contract(tmp_path):
    rng = np.random.default_rng(3)
    n = 30_000
    path = str(tmp_path / "c.parquet")
    pq.write_table(pa.table({
        "k": pa.array(rng.integers(0, 40, n), pa.int64()),
        "v": pa.array(rng.integers(0, 1000, n), pa.int64())}), path,
        row_group_size=5_000)
    s = SparkSession("cpu", {"spark.tpu.maxDeviceBatchBytes": 1 << 16,
                             "spark.tpu.chunkRows": 8_192,
                             "spark.tpu.oomDegrade.floorBytes": 1 << 12,
                             "spark.tpu.faultInjection.hangSeconds": 0.02})
    s.read.parquet(path).createOrReplaceTempView("cc")
    q = "SELECT k, SUM(v) AS s, COUNT(*) AS c FROM cc GROUP BY k ORDER BY k"

    def run():
        return _ipc(s.sql(q).toArrow())

    clean = run()
    points = ("pipeline.decode", "pipeline.transfer", "execute.device")
    report = chaos.run_campaign(
        s.conf, run, chaos.generate_campaign(13, 3, points=points),
        clean_bytes=clean, alarm_s=60.0, memory_manager=s.memory_manager)
    assert report.ok, [r.to_dict() for r in report.failures]


#: the seams of the streaming, compile and mview tiers
_TIER_POINTS = ("streaming.commit", "compile.background", "mview.refresh")


def test_tier_campaign_passes_its_contract(tmp_path):
    """A seeded campaign over the three tiers' points on a workload that
    passes each seam once a run: two triggers of a streaming aggregate,
    an appended file merged into a cached view, and a plan served while
    its background capture runs. Each schedule is identical or typed."""
    import itertools
    import os

    from spark_tpu_torch.api import functions as F
    from spark_tpu_torch.streaming import MemoryStream

    s = SparkSession("cpu", {"spark.tpu.mview.enabled": True,
                             "spark.tpu.compile.background": True,
                             "spark.tpu.faultInjection.hangSeconds": 0.02})
    runs = itertools.count()

    def run():
        i = next(runs)
        out = []
        src = MemoryStream(pa.schema([("k", pa.int64()), ("v", pa.int64())]))
        q = s.readStream.load(src).groupBy("k").agg(F.sum("v").alias("s")) \
            .writeStream.outputMode("complete").queryName(f"ct{i}") \
            .option("checkpointLocation", str(tmp_path / f"ck{i}")).start()
        for b in range(2):
            src.add_data([{"k": j % 3, "v": b * 10 + j} for j in range(9)])
            q.process_all_available()
        out.append(s.table(f"ct{i}").orderBy("k").toArrow())
        d = str(tmp_path / f"mv{i}")
        os.makedirs(d)
        for n, part in enumerate((range(40), range(40, 50))):
            pq.write_table(pa.table({"k": [j % 5 for j in part],
                                     "v": list(part)}),
                           os.path.join(d, f"p{n}.parquet"))
            if n == 0:
                view = s.read.parquet(d).groupBy("k").agg(
                    F.sum("v").alias("s"))
                view.cache()
                view.collect()
        out.append(view.orderBy("k").toArrow())
        view.unpersist()
        s.createDataFrame([{"k": j % 4, "v": j} for j in range(20)]) \
            .createOrReplaceTempView(f"bg{i}")
        bq = f"SELECT k, SUM(v) AS s FROM bg{i} GROUP BY k ORDER BY k"
        out.append(s.sql(bq).toArrow())
        assert s.compile_service.wait_background(timeout=30)
        out.append(s.sql(bq).toArrow())
        return b"\x00".join(_ipc(t) for t in out)

    clean = run()
    report = chaos.run_campaign(
        s.conf, run, chaos.generate_campaign(16, 4, points=_TIER_POINTS),
        clean_bytes=clean, alarm_s=60.0, queries=4,
        memory_manager=s.memory_manager)
    assert report.ok, [r.to_dict() for r in report.failures]
    assert len(report.results) == 4
    for r in report.results:
        assert r.outcome in ("identical", "typed_error")
    assert set(_TIER_POINTS) <= set(faults.WIRED_POINTS)
    s.stop()


def test_mismatch_and_untyped_errors_fail_the_schedule():
    sch = chaos.generate_campaign(1, 1, points=("execute.device",))[0]
    conf = CF.RuntimeConf({})
    bad = chaos.run_schedule(conf, lambda: b"x", sch, clean_bytes=b"y",
                             alarm_s=5.0)
    assert not bad.ok and bad.outcome == "mismatch"

    def boom():
        raise AttributeError("half-recovered path")

    worse = chaos.run_schedule(conf, boom, sch, clean_bytes=b"y",
                               alarm_s=5.0)
    assert not worse.ok and worse.outcome == "untyped_error"
    assert conf.entries()[sch.faults[0].conf_key()] == "none"


def test_alarm_fails_a_hanging_schedule():
    import time

    sch = chaos.generate_campaign(1, 1, points=("execute.device",))[0]
    res = chaos.run_schedule(CF.RuntimeConf({}),
                             lambda: time.sleep(5) or b"", sch,
                             clean_bytes=b"", alarm_s=0.2)
    assert res.outcome == "hang" and not res.ok and res.elapsed_s < 2.0


def test_failing_campaign_writes_replay_artifact(tmp_path):
    art = str(tmp_path / "fail.json")
    schedules = chaos.generate_campaign(3, 2, points=("join.spill",))
    report = chaos.run_campaign(CF.RuntimeConf({}), lambda: b"a",
                                schedules, clean_bytes=b"b", alarm_s=5.0,
                                artifact_path=art)
    assert not report.ok and len(report.failures) == 2
    assert chaos.replay_artifact(art) == schedules[0]
    with open(art) as f:
        assert json.load(f)["outcome"] == "mismatch"


# ---- a serving fleet -------------------------------------------------------


_SMOKE_QUERIES = ("SELECT a, b FROM chaos_t WHERE a >= 8 ORDER BY a",
                  "SELECT a % 4 AS g, SUM(b) AS s FROM chaos_t "
                  "GROUP BY a % 4 ORDER BY g")


@pytest.fixture
def fleet(tmp_path):
    from spark_tpu_torch.serve import serve_fleet

    s = SparkSession("cpu", {"spark.tpu.faultInjection.hangSeconds": 0.02})
    path = str(tmp_path / "chaos_t.parquet")
    pq.write_table(pa.table({"a": list(range(64)),
                             "b": [float(i) * 0.5 for i in range(64)]}),
                   path)
    s.read.parquet(path).createOrReplaceTempView("chaos_t")
    fl = serve_fleet(s, replicas=2)
    try:
        yield s, fl
    finally:
        fl.stop()
        s.stop()
        metrics.reset_brownout()


def _fleet_workload(s, url):
    from spark_tpu_torch.connect.server import Client

    if s.serve_result_cache is not None:
        s.serve_result_cache.clear()  # faults reach the engine
    client = Client(url, timeout=20.0, retries=3)
    return b"\x00".join(_ipc(client.sql(q)) for q in _SMOKE_QUERIES)


def test_chaos_smoke_three_schedules(fleet):
    s, fl = fleet
    clean = _fleet_workload(s, fl.url)
    assert clean == b"\x00".join(_ipc(s.sql(q).toArrow())
                                  for q in _SMOKE_QUERIES)
    report = chaos.run_campaign(
        s.conf, lambda: _fleet_workload(s, fl.url),
        chaos.generate_campaign(7, 3, points=faults.WIRED_POINTS),
        clean_bytes=clean, alarm_s=60.0, queries=len(_SMOKE_QUERIES),
        memory_manager=s.memory_manager)
    assert report.ok, [r.to_dict() for r in report.failures]
    assert len(report.results) == 3
    for r in report.results:
        assert r.outcome in ("identical", "typed_error")
        assert r.elapsed_s < 60.0


def test_chaos_kill_and_revive_schedule(fleet):
    s, fl = fleet
    clean = _fleet_workload(s, fl.url)
    out = chaos.kill_and_revive(fl, lambda: _fleet_workload(s, fl.url),
                                clean_bytes=clean)
    assert out["breaker_after_death"] == "open"
    assert out["healthy_after_revival"] is True
    assert fl.replicas[0].replica_id == out["replica"]
    assert "spark.tpu.serve.healthProbeSeconds" not in s.conf._overrides


def test_router_health_reports_resilience(fleet):
    _, fl = fleet
    with urllib.request.urlopen(fl.url + "/health", timeout=10.0) as resp:
        h = json.loads(resp.read())
    assert "level" in h["brownout"] and "draws" in h["retry_budget"]
    assert len(h["replicas"]) == 2
    for rep in h["replicas"]:
        assert rep["breaker"]["state"] in ("closed", "open", "half_open")
