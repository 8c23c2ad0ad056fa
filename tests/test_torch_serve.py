"""The port's serving tier (``spark_tpu_torch/serve/``) on the cases of
tests/test_serve.py: the byte-bounded LRU, the result cache (single
flight, errors, oversized results, invalidation on a rewritten file,
the on/off sweep), the federation router (spreading, affinity, shedding
a 429, all replicas saturated, the ``serve.dispatch`` fault cells, a
replica's death) and the serve profile and UI endpoint.

Held against the port itself: every served stream is the IPC of the
session's own ``toArrow()``, cached or not, byte for byte; a herd of 8
identical queries executes once.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_tpu_torch import conf as CF
from spark_tpu_torch import faults, metrics, tracing
from spark_tpu_torch.api.session import SparkSession
from spark_tpu_torch.conf import RuntimeConf
from spark_tpu_torch.connect.server import Client, ConnectServer
from spark_tpu_torch.scheduler import QueryScheduler
from spark_tpu_torch.serve import (Federation, FederationRouter, ResultCache,
                                   ipc_to_table, plan_result_key,
                                   serve_fleet, table_to_ipc)
from spark_tpu_torch.serve.result_cache import key_digest
from spark_tpu_torch.storage.lru import LruDict

from test_torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.timeout(120)


@pytest.fixture(scope="module")
def port():
    return SparkSession(device="cpu")


@pytest.fixture
def serve_conf(port):
    """The serve tier's settings scoped to one test: every
    spark.tpu.serve.* / serve-fault override set inside the test is
    unset afterwards and the shared result cache is dropped."""
    yield port.conf
    for k in list(port.conf._overrides):
        if k.startswith("spark.tpu.serve") \
                or k == "spark.tpu.faultInjection.serve.dispatch":
            port.conf.unset(k)
    rc = getattr(port, "serve_result_cache", None)
    if rc is not None:
        rc.clear()
    faults.reset(port.conf)
    metrics.reset_serve()


def _write_parquet(path, nrows=64, offset=0):
    t = pa.table({
        "a": list(range(offset, offset + nrows)),
        "b": [float(i) * 0.5 for i in range(nrows)]})
    pq.write_table(t, path)
    return path


def _post_sql(url, query, headers=None, timeout=60):
    """Raw POST /sql so tests can see status code + response headers
    (X-Cache, X-SparkTpu-Replica, Retry-After) the Client hides."""
    req = urllib.request.Request(
        url + "/sql", data=json.dumps({"query": query}).encode(),
        headers={"Content-Type": "application/json",
                 **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


# ---- registration / satellites ---------------------------------------------


def test_serve_conf_keys_and_fault_point_registered():
    for key in ("spark.tpu.serve.policy",
                "spark.tpu.serve.resultCache.enabled",
                "spark.tpu.serve.resultCache.maxBytes",
                "spark.tpu.serve.dispatchRetries",
                "spark.tpu.serve.healthProbeSeconds",
                "spark.tpu.serve.replicas",
                "spark.tpu.faultInjection.serve.dispatch"):
        assert CF.is_registered(key), key
    assert "serve.dispatch" in faults.POINTS
    for point in ("serve.dispatch", "serve.ownership", "serve.invalidate",
                  "connect.request", "scheduler.admit"):
        assert point in faults.WIRED_POINTS
    import spark_tpu_torch.serve.federation  # noqa: F401 (its keys)
    for key in ("spark.tpu.serve.breaker.enabled",
                "spark.tpu.serve.brownout.enterRate",
                "spark.tpu.serve.ownership.enabled",
                "spark.tpu.serve.invalidationLog.maxRecords",
                "spark.tpu.serve.fingerprintCacheSeconds"):
        assert CF.is_registered(key), key


def test_deadlock_guard_marker_registered(request):
    assert request.node.get_closest_marker("timeout") is not None


def test_scheduler_load_snapshot():
    """queue_depth()/running_count() report live load under the lock —
    the signal /health exports and least_queued routes by."""
    sched = QueryScheduler(conf=RuntimeConf({
        "spark.tpu.scheduler.maxConcurrency": 1,
        "spark.tpu.scheduler.queueDepth": 8}))
    release = threading.Event()
    started = threading.Event()

    def blocking(tk):
        started.set()
        release.wait(timeout=30)
        return 1

    try:
        assert sched.queue_depth() == 0
        assert sched.running_count() == 0
        t1 = sched.submit(blocking, description="hold")
        assert started.wait(timeout=30)
        assert sched.running_count() >= 1
        t2 = sched.submit(lambda tk: 2, description="queued")
        # one worker is held: the second submit stays in the queue
        assert sched.queue_depth() >= 1
        release.set()
        assert t1.result(timeout=30) == 1
        assert t2.result(timeout=30) == 2
        assert sched.queue_depth() == 0
        assert sched.running_count() == 0
    finally:
        release.set()
        sched.stop()


def test_client_backoff_full_jitter():
    c = Client("http://127.0.0.1:1", retries=3, backoff_s=0.05,
               max_backoff_s=0.4)
    draws = [c._jitter(2) for _ in range(64)]
    cap = min(0.4, 0.05 * 4)
    assert all(0.0 <= d <= cap for d in draws)
    # full jitter means spread, not a deterministic delay: a herd of
    # rejected clients must not re-arrive in lockstep
    assert len({round(d, 6) for d in draws}) > 8
    assert max(draws) - min(draws) > 0.01


# ---- byte-bounded LRU -------------------------------------------------------


def test_lru_byte_bound_eviction():
    d = LruDict("t_serve_lru", cap=64, max_bytes=100, weigher=len)
    d["a"] = b"x" * 40
    d["b"] = b"y" * 40
    assert d.total_bytes == 80
    d["c"] = b"z" * 40  # 120 > 100: 'a' (oldest) evicts
    assert d.get("a") is None
    assert d.total_bytes == 80
    assert d.evictions == 1
    # touching 'b' makes 'c' the eviction victim for the next insert
    assert d.get("b") is not None
    d["e"] = b"w" * 40
    assert d.get("c") is None and d.get("b") is not None
    d.pop("b")
    assert d.total_bytes == 40


# ---- result cache units -----------------------------------------------------


def _cache(**overrides):
    base = {"spark.tpu.serve.resultCache.enabled": True}
    base.update(overrides)
    return ResultCache(RuntimeConf(base))


def test_result_cache_single_flight_one_execution():
    cache = _cache()
    tbl = pa.table({"x": [1, 2, 3]})
    calls = []
    gate = threading.Event()

    def execute():
        calls.append(1)
        gate.wait(timeout=30)
        return tbl

    results, errors = [], []

    def worker():
        try:
            results.append(cache.get_or_execute(("k",), execute))
        except Exception as e:  # pragma: no cover - failure surface
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    time.sleep(0.2)  # let the herd pile onto the flight
    gate.set()
    for t in threads:
        t.join(timeout=30)
    assert not errors
    assert len(calls) == 1  # exactly one device execution
    blobs = {blob for blob, _ in results}
    assert len(blobs) == 1
    assert ipc_to_table(next(iter(blobs))).equals(tbl)
    statuses = sorted(s for _, s in results)
    assert statuses.count("miss") == 1


def test_result_cache_error_propagates_then_recovers():
    cache = _cache()
    boom = [True]

    def execute():
        if boom[0]:
            raise ValueError("planned failure")
        return pa.table({"x": [7]})

    with pytest.raises(ValueError, match="planned failure"):
        cache.get_or_execute(("err",), execute)
    boom[0] = False  # the failed flight must not wedge the key
    blob, status = cache.get_or_execute(("err",), execute)
    assert status == "miss"
    assert ipc_to_table(blob).to_pydict() == {"x": [7]}


def test_result_cache_oversized_result_served_not_cached():
    cache = _cache(**{"spark.tpu.serve.resultCache.maxBytes": 64})
    big = pa.table({"x": list(range(4096))})
    blob, status = cache.get_or_execute(("big",), lambda: big)
    assert status == "miss" and len(blob) > 64
    assert cache.lookup(("big",)) is None  # never cached
    assert ipc_to_table(blob).equals(big)


# ---- connect-server cache hook ---------------------------------------------


def test_cache_invalidation_on_source_rewrite(port, tmp_path,
                                              serve_conf):
    """The satellite sequence: write parquet -> query (miss) ->
    re-query (hit, byte-identical) -> rewrite the file -> re-query
    must miss and return the NEW data."""
    p = _write_parquet(os.path.join(str(tmp_path), "inv.parquet"), 64)
    port.read.parquet(p).createOrReplaceTempView("serve_inv")
    serve_conf.set("spark.tpu.serve.resultCache.enabled", True)
    srv = ConnectServer(port, port=0).start()
    q = "SELECT a, b FROM serve_inv WHERE a >= 4"
    try:
        code1, body1, h1 = _post_sql(srv.url, q)
        assert code1 == 200 and h1.get("X-Cache") == "miss"
        code2, body2, h2 = _post_sql(srv.url, q)
        assert code2 == 200 and h2.get("X-Cache") == "hit"
        assert body2 == body1  # byte-identical, same serialized stream
        # rewrite with different data; bump mtime past fs granularity
        _write_parquet(p, 32, offset=100)
        st = os.stat(p)
        os.utime(p, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000))
        code3, body3, h3 = _post_sql(srv.url, q)
        assert code3 == 200 and h3.get("X-Cache") == "miss"
        t3 = ipc_to_table(body3)
        assert t3.num_rows == 32  # the NEW data, not the stale cache
        assert min(t3.column("a").to_pylist()) == 100
    finally:
        srv.stop()


def test_cache_on_off_sweep_byte_identical(port, tmp_path,
                                           serve_conf):
    p = _write_parquet(os.path.join(str(tmp_path), "ab.parquet"), 96)
    port.read.parquet(p).createOrReplaceTempView("serve_ab")
    q = ("SELECT a, SUM(b) AS s FROM serve_ab WHERE a < 80 "
         "GROUP BY a ORDER BY a")
    srv = ConnectServer(port, port=0).start()
    try:
        code_off, body_off, h_off = _post_sql(srv.url, q)
        assert code_off == 200 and "X-Cache" not in h_off
        serve_conf.set("spark.tpu.serve.resultCache.enabled", True)
        code_miss, body_miss, h_miss = _post_sql(srv.url, q)
        code_hit, body_hit, h_hit = _post_sql(srv.url, q)
        assert h_miss.get("X-Cache") == "miss"
        assert h_hit.get("X-Cache") == "hit"
        # cached and uncached executions serialize identical streams,
        # the session's own toArrow() bytes
        assert body_miss == body_off
        assert body_hit == body_off
        assert body_off == table_to_ipc(port.sql(q).toArrow())
    finally:
        srv.stop()


def test_single_flight_stress_8_clients_one_execution(port, tmp_path,
                                                      serve_conf):
    p = _write_parquet(os.path.join(str(tmp_path), "sf.parquet"), 128)
    port.read.parquet(p).createOrReplaceTempView("serve_sf")
    serve_conf.set("spark.tpu.serve.resultCache.enabled", True)
    q = "SELECT a, b FROM serve_sf WHERE a > 17"
    kd = key_digest(plan_result_key(port.sql(q)._plan))
    srv = ConnectServer(port, port=0).start()
    results, errors = [], []
    barrier = threading.Barrier(8)

    def client(i):
        try:
            barrier.wait(timeout=30)
            results.append(Client(srv.url, timeout=120).sql(q))
        except Exception as e:
            errors.append(e)

    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errors
        assert len(results) == 8
        direct = table_to_ipc(port.sql(q).toArrow())
        assert all(table_to_ipc(r) == direct for r in results)
        execs = [e for e in metrics.recent(4096)
                 if e.get("kind") == "serve_cache"
                 and e.get("phase") == "execute" and e.get("key") == kd]
        assert len(execs) == 1  # the herd cost ONE device execution
    finally:
        srv.stop()


# ---- federation router ------------------------------------------------------


def test_router_spreads_and_aggregates_health(port, tmp_path,
                                              serve_conf):
    p = _write_parquet(os.path.join(str(tmp_path), "rt.parquet"), 48)
    port.read.parquet(p).createOrReplaceTempView("serve_rt")
    serve_conf.set("spark.tpu.serve.policy", "round_robin")
    serve_conf.set("spark.tpu.serve.healthProbeSeconds", 0.0)
    fleet = serve_fleet(port, replicas=2)
    try:
        seen = set()
        for i in range(4):
            code, body, hdr = _post_sql(
                fleet.url, f"SELECT a FROM serve_rt WHERE a > {i}")
            assert code == 200
            seen.add(hdr.get("X-SparkTpu-Replica"))
        assert seen == {"r0", "r1"}  # round robin used both
        with urllib.request.urlopen(fleet.url + "/health",
                                    timeout=10) as resp:
            h = json.loads(resp.read())
        assert h["status"] == "ok" and h["router"] is True
        assert {r["id"] for r in h["replicas"]} == {"r0", "r1"}
        for r in h["replicas"]:
            assert r["healthy"] is True
            assert "queue_depth" in r and "running" in r
    finally:
        fleet.stop()


def test_router_honors_client_affinity(port, tmp_path, serve_conf):
    p = _write_parquet(os.path.join(str(tmp_path), "af.parquet"), 48)
    port.read.parquet(p).createOrReplaceTempView("serve_af")
    serve_conf.set("spark.tpu.serve.policy", "round_robin")
    serve_conf.set("spark.tpu.serve.healthProbeSeconds", 0.0)
    fleet = serve_fleet(port, replicas=2)
    try:
        c = Client(fleet.url, timeout=60)
        c.sql("SELECT a FROM serve_af WHERE a > 0")
        first = c.affinity
        assert first in ("r0", "r1")
        # round_robin would alternate; the echoed affinity pins us
        for i in range(3):
            c.sql(f"SELECT a FROM serve_af WHERE a > {i + 1}")
            assert c.affinity == first
    finally:
        fleet.stop()


def test_queue_full_sheds_to_other_replica_no_client_429(
        port, tmp_path, serve_conf):
    """The acceptance scenario: a queue-full burst on one replica
    sheds to the other with ZERO client-visible 429s while the second
    replica has capacity."""
    p = _write_parquet(os.path.join(str(tmp_path), "sh.parquet"), 48)
    port.read.parquet(p).createOrReplaceTempView("serve_sh")
    serve_conf.set("spark.tpu.serve.policy", "round_robin")
    serve_conf.set("spark.tpu.serve.healthProbeSeconds", 0.0)
    metrics.reset_serve()
    full = ConnectServer(
        port, port=0, replica_id="full",
        scheduler=QueryScheduler(conf=RuntimeConf(
            {"spark.tpu.scheduler.queueDepth": 0}))).start()
    ok = ConnectServer(port, port=0, replica_id="ok").start()
    router = FederationRouter([full, ok], conf=port.conf).start()
    try:
        for i in range(4):
            code, body, hdr = _post_sql(
                router.url, f"SELECT a FROM serve_sh WHERE a > {i}")
            assert code == 200  # never a 429 while 'ok' has capacity
            assert hdr.get("X-SparkTpu-Replica") == "ok"
        stats = metrics.serve_stats()
        assert stats["sheds"] >= 1
        assert stats["rejected"] == 0
    finally:
        router.stop()
        full.stop()
        ok.stop()


def test_all_replicas_saturated_429_min_retry_after(
        port, tmp_path, serve_conf):
    p = _write_parquet(os.path.join(str(tmp_path), "sat.parquet"), 48)
    port.read.parquet(p).createOrReplaceTempView("serve_sat")
    serve_conf.set("spark.tpu.serve.healthProbeSeconds", 0.0)
    r0 = ConnectServer(
        port, port=0, replica_id="s0",
        scheduler=QueryScheduler(conf=RuntimeConf({
            "spark.tpu.scheduler.queueDepth": 0,
            "spark.tpu.scheduler.retryAfterSeconds": 0.07}))).start()
    r1 = ConnectServer(
        port, port=0, replica_id="s1",
        scheduler=QueryScheduler(conf=RuntimeConf({
            "spark.tpu.scheduler.queueDepth": 0,
            "spark.tpu.scheduler.retryAfterSeconds": 0.03}))).start()
    router = FederationRouter([r0, r1], conf=port.conf).start()
    try:
        code, body, hdr = _post_sql(router.url,
                                    "SELECT a FROM serve_sat")
        assert code == 429
        detail = json.loads(body)
        # Retry-After = min across replicas: the soonest any queue in
        # the fleet expects capacity
        assert abs(float(hdr["Retry-After"]) - 0.03) < 1e-9
        assert abs(detail["retry_after_s"] - 0.03) < 1e-9
        assert metrics.serve_stats()["rejected"] >= 1
    finally:
        router.stop()
        r0.stop()
        r1.stop()


def test_dispatch_fault_redispatches_no_duplicate(port, tmp_path,
                                                  serve_conf):
    """Replica death mid-query (fault serve.dispatch): the query is
    NOT lost (bounded re-dispatch to the other replica answers it) and
    NOT duplicated (one device execution for its key)."""
    p = _write_parquet(os.path.join(str(tmp_path), "fd.parquet"), 48)
    port.read.parquet(p).createOrReplaceTempView("serve_fd")
    serve_conf.set("spark.tpu.serve.resultCache.enabled", True)
    serve_conf.set("spark.tpu.serve.healthProbeSeconds", 0.0)
    serve_conf.set("spark.tpu.faultInjection.serve.dispatch", "nth:1")
    metrics.reset_serve()
    fleet = serve_fleet(port, replicas=2)
    q = "SELECT a, b FROM serve_fd WHERE a > 23"
    kd = key_digest(plan_result_key(port.sql(q)._plan))
    try:
        code, body, hdr = _post_sql(fleet.url, q)
        assert code == 200  # the query was not lost
        assert body == table_to_ipc(port.sql(q).toArrow())
        assert faults.fire_count(port.conf, "serve.dispatch") == 1
        stats = metrics.serve_stats()
        assert stats["redispatches"] >= 1
        assert stats["replica_failures"] >= 1
        execs = [e for e in metrics.recent(4096)
                 if e.get("kind") == "serve_cache"
                 and e.get("phase") == "execute" and e.get("key") == kd]
        assert len(execs) == 1  # no duplicate execution
    finally:
        fleet.stop()


def test_dispatch_fault_corrupt_surfaces_unretried(port, tmp_path,
                                                   serve_conf):
    p = _write_parquet(os.path.join(str(tmp_path), "fc.parquet"), 32)
    port.read.parquet(p).createOrReplaceTempView("serve_fc")
    serve_conf.set("spark.tpu.serve.healthProbeSeconds", 0.0)
    serve_conf.set("spark.tpu.faultInjection.serve.dispatch",
                   "nth:1:corrupt")
    fleet = serve_fleet(port, replicas=2)
    try:
        code, body, hdr = _post_sql(fleet.url,
                                    "SELECT a FROM serve_fc")
        # DATA_LOSS is not a replica death: surfaced typed, no retry
        assert code == 500
        assert json.loads(body)["error"] == "InjectedCorruptionError"
    finally:
        fleet.stop()


def test_replica_death_mid_run_fleet_keeps_serving(port, tmp_path,
                                                   serve_conf):
    p = _write_parquet(os.path.join(str(tmp_path), "rd.parquet"), 48)
    port.read.parquet(p).createOrReplaceTempView("serve_rd")
    serve_conf.set("spark.tpu.serve.policy", "least_queued")
    serve_conf.set("spark.tpu.serve.healthProbeSeconds", 0.0)
    fleet = serve_fleet(port, replicas=2)
    try:
        c = Client(fleet.url, timeout=60)
        assert c.sql("SELECT a FROM serve_rd WHERE a > 1") \
            .num_rows == 46
        fleet.replicas[0].stop()  # kill one replica mid-run
        c.affinity = None  # a fresh client must also survive
        for i in range(3):
            t = c.sql(f"SELECT a FROM serve_rd WHERE a > {i + 2}")
            assert t.num_rows == 48 - (i + 3)
        with urllib.request.urlopen(fleet.url + "/health",
                                    timeout=10) as resp:
            h = json.loads(resp.read())
        healthy = {r["id"]: r["healthy"] for r in h["replicas"]}
        assert healthy["r1"] is True
        assert healthy["r0"] is False
    finally:
        fleet.stop()


# ---- observability ----------------------------------------------------------


def test_serve_profile_and_api_endpoint(port, tmp_path, serve_conf):
    from spark_tpu_torch.ui import StatusServer

    p = _write_parquet(os.path.join(str(tmp_path), "ob.parquet"), 32)
    port.read.parquet(p).createOrReplaceTempView("serve_ob")
    serve_conf.set("spark.tpu.serve.resultCache.enabled", True)
    fleet = serve_fleet(port, replicas=2)
    ui = StatusServer(port, port=0)
    try:
        for _ in range(2):
            code, _, _ = _post_sql(fleet.url,
                                   "SELECT a FROM serve_ob")
            assert code == 200
        prof = tracing.serve_profile()
        assert prof["cache"]["execute"] >= 1
        assert prof["totals"]["dispatches"] >= 2
        text = tracing.format_serve_profile(prof)
        assert "result cache" in text and "router" in text
        with urllib.request.urlopen(ui.url + "/api/v1/serve",
                                    timeout=10) as resp:
            payload = json.loads(resp.read())
        assert "profile" in payload and "counters" in payload
        assert payload["counters"]["dispatches"] >= 2
        assert payload["gauges"].get(
            "serve.result_cache.entries", 0) >= 1
    finally:
        ui.stop()
        fleet.stop()


def test_federation_least_queued_picks_emptier(serve_conf):
    """least_queued picks the replica with the smallest queued plus
    running load of the last probe (no HTTP)."""
    fed = Federation(
        [("a", "http://127.0.0.1:1"), ("b", "http://127.0.0.1:2")],
        conf=RuntimeConf({"spark.tpu.serve.policy": "least_queued"}))
    fed.replicas[0].queue_depth = 5
    fed.replicas[0].last_probe = time.time() + 3600
    fed.replicas[1].queue_depth = 1
    fed.replicas[1].last_probe = time.time() + 3600
    assert fed.pick().id == "b"
    fed.replicas[1].running = 9  # load = queued + running
    assert fed.pick().id == "a"
    assert fed.pick(affinity="b").id == "b"  # affinity wins
    fed.replicas[1].healthy = False
    assert fed.pick(affinity="b").id == "a"  # unless unhealthy
