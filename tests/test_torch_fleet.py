"""The port's fleet data plane (``spark_tpu_torch/serve/ownership.py``) on
the cases of tests/test_fleet.py: rendezvous ownership, shard keys, the
epoch-numbered ownership map, epoch fencing (a stale stamp gets a typed
409 that the router absorbs), owner routing and a byte-identical
failover, the versioned invalidation log and its fault point, the
breaker's trip on a dispatch failure, and the invalidation a rewritten
file broadcasts, and a cached view's refresh racing readers of a second
replica (no read after the refresh's commit returns the old bytes).

Held against the reference on numpy-seeded inputs: ``rendezvous_owner``
and ``shard_key`` on the same shards and replicas, the coordinator's
epochs and owner maps after the same membership changes, and
``InvalidationLog.since`` after the same appends.
"""

import json
import os
import time
import urllib.error
import urllib.request

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_tpu.conf import RuntimeConf as RefConf
from spark_tpu.serve import ownership as ref_own
from spark_tpu_torch import chaos, conf as CF, faults, locks, metrics, trace
from spark_tpu_torch.api.session import SparkSession
from spark_tpu_torch.conf import RuntimeConf
from spark_tpu_torch.connect.server import Client
from spark_tpu_torch.serve.federation import Federation, NoHealthyReplica
from spark_tpu_torch.serve.ownership import (EPOCH_HEADER, EpochRetry,
                                             InvalidationLog,
                                             OwnershipCoordinator,
                                             catalog_shards,
                                             rendezvous_owner, shard_key,
                                             session_invalidation_log,
                                             tables_in_sql)
from spark_tpu_torch.serve.result_cache import ResultCache, table_to_ipc
from spark_tpu_torch.serve.router import serve_fleet

from test_torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.timeout(240)

_FLEET_CONF = ("spark.tpu.serve.ownership.enabled",
               "spark.tpu.serve.resultCache.enabled",
               "spark.tpu.serve.fingerprintCacheSeconds",
               "spark.tpu.serve.healthProbeSeconds")


@pytest.fixture(scope="module")
def port():
    return SparkSession(device="cpu")


@pytest.fixture
def fleet3(port, tmp_path):
    """Three ownership replicas over one Parquet table ``fleet_t``."""
    path = str(tmp_path / "fleet_t.parquet")
    pq.write_table(pa.table({"a": list(range(64)),
                             "b": [float(i) * 0.5 for i in range(64)]}),
                   path)
    port.read.parquet(path).createOrReplaceTempView("fleet_t")
    port.conf.set("spark.tpu.serve.ownership.enabled", "true")
    port.conf.set("spark.tpu.serve.resultCache.enabled", "true")
    fl = serve_fleet(port, replicas=3)
    try:
        yield fl, path
    finally:
        fl.stop()
        for k in _FLEET_CONF:
            port.conf.unset(k)
        faults.reset(port.conf)
        for s in fl.replicas:
            if s.result_cache is not None:
                s.result_cache.detach_invalidation_log()
        if port.serve_result_cache is not None:
            port.serve_result_cache.clear()


# ---- ownership against the reference ---------------------------------------


@pytest.mark.parametrize("seed", [4, 19])
def test_rendezvous_and_shard_keys_match_reference(seed):
    rng = np.random.default_rng(seed)
    members = [f"r{i}" for i in range(int(rng.integers(2, 7)))]
    paths = [f"/data/t{int(i)}/part-{int(j)}.parquet"
             for i, j in rng.integers(0, 40, (60, 2))]
    for _ in range(50):
        pick = rng.choice(len(paths), int(rng.integers(1, 5)), replace=False)
        chosen = [paths[int(i)] for i in pick]
        sk = shard_key(chosen)
        assert sk == ref_own.shard_key(chosen)
        sub = [m for m in members if rng.random() < 0.7] or members[:1]
        assert rendezvous_owner(sk, sub) == ref_own.rendezvous_owner(sk, sub)
    assert rendezvous_owner("x", []) is None
    sql = "select * from a join B on x = y, (select 1 from c) q"
    assert tables_in_sql(sql) == ref_own.tables_in_sql(sql)


@pytest.mark.parametrize("seed", [2, 31])
def test_coordinator_epochs_match_reference(seed):
    rng = np.random.default_rng(seed)
    conf = {"spark.tpu.serve.ownership.enabled": True}
    mine = OwnershipCoordinator(RuntimeConf(conf))
    theirs = ref_own.OwnershipCoordinator(RefConf(conf))
    report = {f"t{i}": {"shard": shard_key([f"/d/t{i}.parquet"]),
                        "paths": [f"/d/t{i}.parquet"]} for i in range(12)}
    mine.register_shards(report)
    theirs.register_shards(report)
    everyone = [f"r{i}" for i in range(5)]
    for _ in range(12):
        healthy = [m for m in everyone if rng.random() < 0.75]
        assert mine.observe(healthy) == theirs.observe(healthy)
        assert mine.epoch == theirs.epoch
        sql = f"select * from t{int(rng.integers(0, 12))}"
        assert mine.shards_for_sql(sql) == theirs.shards_for_sql(sql)
        assert mine.owner_for(mine.shards_for_sql(sql)) \
            == theirs.owner_for(theirs.shards_for_sql(sql))
    snap_m, snap_t = mine.snapshot(), theirs.snapshot()
    assert snap_m == snap_t


@pytest.mark.parametrize("seed", [5, 8])
def test_invalidation_log_since_matches_reference(seed):
    rng = np.random.default_rng(seed)
    cap = int(rng.integers(2, 9))
    mine = InvalidationLog(RuntimeConf(
        {"spark.tpu.serve.invalidationLog.maxRecords": cap}))
    theirs = ref_own.InvalidationLog(RefConf(
        {"spark.tpu.serve.invalidationLog.maxRecords": cap}))
    for _ in range(int(rng.integers(5, 25))):
        kind = ("mview_refresh", "source_changed")[int(rng.integers(0, 2))]
        paths = [f"/d/f{int(i)}.parquet"
                 for i in rng.integers(0, 9, int(rng.integers(1, 4)))]
        assert mine.append(kind, paths) == theirs.append(kind, paths)
    for w in range(0, mine.version + 2):
        got, resync = mine.since(w)
        want, resync_r = theirs.since(w)
        assert resync == resync_r
        assert [{k: v for k, v in r.items() if k != "ts"} for r in got] \
            == [{k: v for k, v in r.items() if k != "ts"} for r in want]
    assert mine.snapshot() == theirs.snapshot()


# ---- ownership map ---------------------------------------------------------


def test_rendezvous_owner_deterministic_minimal_movement():
    members = ["r0", "r1", "r2", "r3"]
    shards = [f"shard-{i:03d}" for i in range(200)]
    before = {s: rendezvous_owner(s, members) for s in shards}
    assert before == {s: rendezvous_owner(s, list(reversed(members)))
                      for s in shards}
    assert set(before.values()) == set(members)
    survivors = [m for m in members if m != "r1"]
    after = {s: rendezvous_owner(s, survivors) for s in shards}
    moved = {s for s in shards if before[s] != after[s]}
    assert moved == {s for s in shards if before[s] == "r1"}


def test_shard_key_is_path_set_only(tmp_path):
    p1, p2 = str(tmp_path / "x.parquet"), str(tmp_path / "y.parquet")
    k = shard_key([p1, p2])
    assert k == shard_key([p2, p1]) == shard_key([p1, p2, p1])
    assert k != shard_key([p1])
    pq.write_table(pa.table({"a": [1]}), p1)
    k2 = shard_key([p1, p2])
    pq.write_table(pa.table({"a": [1, 2]}), p1)
    assert shard_key([p1, p2]) == k2 == k


def test_ownership_coordinator_epoch_lifecycle():
    own = OwnershipCoordinator(
        RuntimeConf({"spark.tpu.serve.ownership.enabled": True}))
    assert own.enabled()
    sk = shard_key(["/data/t.parquet"])
    own.register_shards({
        "t": {"shard": sk, "paths": ["/data/t.parquet"]},
        "u": {"shard": shard_key(["/data/u.parquet"]),
              "paths": ["/data/u.parquet"]}})
    minted = own.observe(["r0", "r1", "r2"])
    assert minted is not None and minted["epoch"] == own.epoch == 1
    assert own.observe(["r2", "r1", "r0"]) is None
    minted2 = own.observe(["r0", "r2"])
    assert minted2 is not None and own.epoch == 2
    assert all(o in ("r0", "r2") for o in minted2["owners"].values())
    shards = own.shards_for_sql("SELECT a FROM t JOIN u ON t.a = u.a")
    assert sk in shards
    assert own.owner_for([sk]) == rendezvous_owner(sk, ["r0", "r2"])
    own.bump_to(7)
    own.bump_to(3)
    assert own.epoch == 7


def test_epoch_retry_is_typed():
    err = EpochRetry(2, 5)
    assert "EPOCH_RETRY" in str(err)
    assert err.request_epoch == 2 and err.fleet_epoch == 5
    assert chaos.is_typed_error(err)


def test_catalog_shards_report(port, tmp_path):
    path = str(tmp_path / "cs.parquet")
    pq.write_table(pa.table({"a": [1, 2]}), path)
    port.read.parquet(path).createOrReplaceTempView("cs_t")
    port.createDataFrame([{"a": 1}]).createOrReplaceTempView("cs_mem")
    rep = catalog_shards(port)
    assert rep["cs_t"] == {"shard": shard_key([path]), "paths": [path]}
    assert "cs_mem" not in rep


# ---- the invalidation log --------------------------------------------------


def test_invalidation_log_append_since_resync():
    log = InvalidationLog(RuntimeConf(
        {"spark.tpu.serve.invalidationLog.maxRecords": 4}))
    seen, bad_calls = [], []

    def bad(_record):
        bad_calls.append(1)
        raise RuntimeError("broken subscriber")

    log.subscribe(bad)
    log.subscribe(seen.append)
    for i in range(3):
        log.append("source_changed", [f"/d/f{i}.parquet"])
    assert log.version == 3 and len(seen) == 3 and len(bad_calls) == 3
    records, resync = log.since(1)
    assert not resync and [r["v"] for r in records] == [2, 3]
    for i in range(6):
        log.append("source_changed", [f"/d/g{i}.parquet"])
    assert log.since(1)[1]
    records, resync = log.since(log.version - 1)
    assert not resync and len(records) == 1
    log.unsubscribe(seen.append)
    log.append("source_changed", ["/d/zz.parquet"])
    assert seen[-1]["v"] != log.version


def test_invalidation_drops_results_and_fp_probes(port, tmp_path):
    path = str(tmp_path / "inv_t.parquet")
    pq.write_table(pa.table({"a": [1, 2, 3]}), path)
    port.read.parquet(path).createOrReplaceTempView("inv_t")
    port.conf.set("spark.tpu.serve.fingerprintCacheSeconds", "300.0")
    log = InvalidationLog(port.conf)
    cache = ResultCache(port.conf).attach_invalidation_log(log)
    try:
        key = cache.result_key(port.sql("SELECT a FROM inv_t WHERE a >= 2")
                               ._plan)
        cache.put(key, b"stale-bytes")
        assert cache.lookup(key) == b"stale-bytes"
        assert len(cache._fp_cache) == 1
        v = log.append("source_changed", [path])
        assert cache.invalidation_watermark == v == 1
        assert cache.lookup(key) is None and len(cache._fp_cache) == 0
        cache.put(key, b"again")
        log.append("source_changed", [str(tmp_path / "other.parquet")])
        assert cache.lookup(key) == b"again"
    finally:
        cache.detach_invalidation_log()
        port.conf.unset("spark.tpu.serve.fingerprintCacheSeconds")


def test_invalidation_fault_degrades_to_full_clear(port):
    log = InvalidationLog(port.conf)
    cache = ResultCache(port.conf).attach_invalidation_log(log)
    try:
        cache.put(("k", ()), b"v")
        port.conf.set("spark.tpu.faultInjection.serve.invalidate", "nth:1")
        faults.reset(port.conf)
        v = log.append("source_changed", ["/nowhere/at/all.parquet"])
        assert len(cache._lru) == 0 and cache.invalidation_watermark == v
        assert faults.fire_count(port.conf, "serve.invalidate") == 1
        assert any(e["kind"] == "fault_recovered"
                   and e.get("point") == "serve.invalidate"
                   for e in metrics.recent(256))
    finally:
        cache.detach_invalidation_log()
        port.conf.unset("spark.tpu.faultInjection.serve.invalidate")
        faults.reset(port.conf)


def test_rewritten_file_broadcasts_an_invalidation(port, tmp_path):
    """A file scan that sees its files change appends ``source_changed``
    to the session's log, which drops a TTL-cached fleet result."""
    path = str(tmp_path / "rw.parquet")
    pq.write_table(pa.table({"a": [1, 2, 3]}), path)
    port.read.parquet(path).createOrReplaceTempView("rw_t")
    port.conf.set("spark.tpu.serve.fingerprintCacheSeconds", "300.0")
    log = session_invalidation_log(port)
    cache = ResultCache(port.conf).attach_invalidation_log(log)
    prev = SparkSession._active
    SparkSession._active = port
    try:
        df = port.sql("SELECT a FROM rw_t")
        assert [r.a for r in df.collect()] == [1, 2, 3]
        key = cache.result_key(df._plan)
        cache.put(key, b"old")
        v0 = log.version
        pq.write_table(pa.table({"a": [7, 8]}), path)
        st = os.stat(path)
        os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000))
        assert [r.a for r in port.sql("SELECT a FROM rw_t").collect()] \
            == [7, 8]
        assert log.version == v0 + 1
        assert cache.lookup(key) is None
    finally:
        SparkSession._active = prev
        cache.detach_invalidation_log()
        port.conf.unset("spark.tpu.serve.fingerprintCacheSeconds")


def test_concurrent_append_read_no_stale_after_refresh(port, tmp_path, rng):
    """Seeded interleaving: readers hammer a second replica (one that
    never appends) while the source grows and a cached view's refresh
    commits on the session. Reads racing the append may see the old or
    the new bytes; once the refresh's invalidation lands, no read
    returns the bytes from before the append again. The fresh rows are
    the reference's over the same file."""
    import threading

    from spark_tpu.api.session import SparkSession as RefSession

    path = str(tmp_path / "ivt.parquet")
    pq.write_table(pa.table({"a": list(range(32)),
                             "b": [float(i) for i in range(32)]}), path)
    port.read.parquet(path).createOrReplaceTempView("ivt")
    for key, value in (("spark.tpu.serve.ownership.enabled", True),
                       ("spark.tpu.serve.resultCache.enabled", True),
                       ("spark.tpu.serve.fingerprintCacheSeconds", 300.0),
                       ("spark.tpu.mview.enabled", True)):
        port.conf.set(key, value)
    # an aggregate: only those register as views, and only the view's
    # refresh closes the plain cache's staleness hole
    q = "SELECT a % 4 AS g, SUM(b) AS s FROM ivt GROUP BY a % 4"
    cached = port.sql(q)
    cached.cache()
    fl = None
    try:
        cached.collect()
        assert len(port.mview_manager.views()) == 1
        fl = serve_fleet(port, replicas=2)
        _probe(fl)
        clients = {s.replica_id: Client(s.url, timeout=20.0, retries=3)
                   for s in fl.replicas}
        pre = {rid: c.sql(q).to_pydict() for rid, c in clients.items()}
        assert len({json.dumps(p, sort_keys=True)
                    for p in pre.values()}) == 1
        reads, stop = [], threading.Event()
        second = sorted(clients)[1]

        def reader():
            c = clients[second]
            while not stop.is_set():
                t0 = time.time()
                reads.append((t0, c.sql(q).to_pydict()))
                time.sleep(float(rng.uniform(0.001, 0.01)))

        th = threading.Thread(target=reader, daemon=True)
        th.start()
        time.sleep(float(rng.uniform(0.01, 0.05)))  # seeded overlap
        pq.write_table(pa.table({
            "a": list(range(32)) + [100 + i for i in range(8)],
            "b": [float(i) for i in range(40)]}), path)
        # the refresh commits here: the collect sees the rewrite,
        # refreshes the cached view and broadcasts
        fresh = port.sql(q).collect()
        commit_t = time.time()
        assert port.mview_manager.views()[0]["refreshes"] >= 1
        deadline = time.time() + 10.0
        while time.time() < deadline:
            if any(t0 > commit_t for t0, _ in reads):
                break
            time.sleep(0.01)
        stop.set()
        th.join(timeout=20.0)
        post = [r for t0, r in reads if t0 > commit_t]
        assert post, "no read landed after the refresh commit"
        stale = [r for r in post if r == pre[second]]
        assert not stale, (f"{len(stale)}/{len(post)} reads after the "
                           "commit returned the bytes from before it")
        want = {row["g"]: row["s"] for row in fresh}
        assert dict(zip(post[-1]["g"], post[-1]["s"])) == want
        ref = RefSession.builder.getOrCreate()
        ref.read.parquet(path).createOrReplaceTempView("ivt_ref")
        assert want == {r.g: r.s for r in ref.sql(
            q.replace("ivt", "ivt_ref")).collect()}
    finally:
        if fl is not None:
            fl.stop()
        cached.unpersist()
        for key in _FLEET_CONF + ("spark.tpu.mview.enabled",):
            port.conf.unset(key)


# ---- epoch fencing, owner routing and failover -----------------------------


def _probe(fl):
    fl.router.federation.probe(force=True)


def test_epoch_fence_stale_dispatch_409(port, fleet3):
    fl, _ = fleet3
    _probe(fl)
    fed = fl.router.federation
    assert fed.ownership.epoch >= 1
    target = next(s for s in fl.replicas
                  if s.fleet_epoch == fed.ownership.epoch)
    req = urllib.request.Request(
        target.url + "/sql",
        data=json.dumps({"query": "SELECT a FROM fleet_t"}).encode(),
        headers={"Content-Type": "application/json", EPOCH_HEADER: "0"},
        method="POST")
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=10.0)
    assert ei.value.code == 409
    detail = json.loads(ei.value.read())
    assert detail["error"] == "EpochRetry"
    assert detail["epoch"] == target.fleet_epoch
    assert metrics.serve_stats().get("epoch_fences", 0) >= 1


def test_router_absorbs_a_newer_replica_epoch(port, fleet3):
    """A replica that learned a newer epoch (another router minted it)
    fences this router's stamp with 409; the router adopts the epoch
    and re-dispatches, and the client gets the rows."""
    fl, _ = fleet3
    _probe(fl)
    fed = fl.router.federation
    for s in fl.replicas:
        s.fleet_epoch = fed.ownership.epoch + 5
    q = "SELECT a, b FROM fleet_t WHERE a >= 8"
    before = metrics.serve_stats().get("epoch_retries", 0)
    got = Client(fl.url, timeout=20.0, retries=3).sql(q)
    assert table_to_ipc(got) == table_to_ipc(port.sql(q).toArrow())
    assert metrics.serve_stats()["epoch_retries"] > before
    assert fed.ownership.epoch >= fl.replicas[0].fleet_epoch


def test_owner_failover_byte_identical(port, fleet3):
    fl, _ = fleet3
    _probe(fl)
    q = "SELECT a, b FROM fleet_t WHERE a >= 8"
    c1 = Client(fl.url, timeout=20.0, retries=3)
    t1 = c1.sql(q)
    assert table_to_ipc(t1) == table_to_ipc(port.sql(q).toArrow())
    owner = c1.last_query["replica"]
    epoch0 = fl.router.federation.ownership.epoch
    c2 = Client(fl.url, timeout=20.0, retries=3)
    assert c2.sql(q).equals(t1) and c2.last_query["replica"] == owner
    next(s for s in fl.replicas if s.replica_id == owner).stop()
    c3 = Client(fl.url, timeout=30.0, retries=3)
    assert c3.sql(q).equals(t1), "failover changed result bytes"
    assert c3.last_query["replica"] != owner
    assert fl.router.federation.ownership.epoch > epoch0


def test_ownership_broadcast_fault_adopts_lazily(port, fleet3):
    """A ``serve.ownership`` fault on the epoch broadcast: the replicas
    miss the push and adopt the epoch from the next stamped request;
    the rows do not change."""
    fl, _ = fleet3
    port.conf.set("spark.tpu.faultInjection.serve.ownership", "prob:1.0:3")
    faults.reset(port.conf)
    try:
        _probe(fl)
        assert all(s.fleet_epoch == 0 for s in fl.replicas)
        q = "SELECT a FROM fleet_t WHERE a < 9"
        c = Client(fl.url, timeout=20.0, retries=3)
        assert table_to_ipc(c.sql(q)) == table_to_ipc(port.sql(q).toArrow())
        assert c.last_query["epoch"] == fl.router.federation.ownership.epoch
        assert any(e["kind"] == "fault_recovered"
                   and e.get("point") == "serve.ownership"
                   and e.get("how") == "lazy_adopt"
                   for e in metrics.recent(512))
    finally:
        port.conf.unset("spark.tpu.faultInjection.serve.ownership")
        faults.reset(port.conf)


def test_client_last_query_surfaces_fleet_metadata(port, fleet3):
    fl, _ = fleet3
    _probe(fl)
    c = Client(fl.url, timeout=20.0, retries=3)
    c.sql("SELECT a FROM fleet_t WHERE a < 4")
    lq = c.last_query
    assert lq["replica"] in {s.replica_id for s in fl.replicas}
    assert lq["cache"] in ("hit", "miss")
    assert isinstance(lq["epoch"], int) and lq["epoch"] >= 1
    c.sql("SELECT a FROM fleet_t WHERE a < 4")
    assert c.last_query["cache"] == "hit"
    assert c.last_query["replica"] == lq["replica"]


# ---- the breaker on a dispatch failure -------------------------------------


def test_dispatch_failure_trips_breaker_inside_probe_throttle():
    fed = Federation(
        [("dead", "http://127.0.0.1:9")],
        conf=RuntimeConf({"spark.tpu.serve.healthProbeSeconds": 3600.0}))
    dead = fed.replicas[0]
    dead.healthy = True
    dead.last_probe = time.time()
    assert dead.breaker.state == "closed"
    with pytest.raises(NoHealthyReplica):
        fed.dispatch("POST", "/sql",
                     json.dumps({"query": "SELECT 1"}).encode(),
                     headers={"Content-Type": "application/json"})
    assert dead.breaker.state == "open"


def test_breaker_trip_is_immediate_and_idempotent():
    br = Federation([("x", "http://127.0.0.1:9")],
                    conf=RuntimeConf()).replicas[0].breaker
    br.trip()
    assert br.state == "open"
    br.trip()
    assert br.state == "open"


def test_fleet_registrations():
    for key in ("spark.tpu.serve.ownership.enabled",
                "spark.tpu.serve.ownership.rebuildOnFailover",
                "spark.tpu.serve.ownership.rebuildTimeoutSeconds",
                "spark.tpu.serve.invalidationLog.maxRecords",
                "spark.tpu.serve.fingerprintCacheSeconds"):
        assert CF.is_registered(key), key
    assert {"serve.ownership", "serve.invalidate",
            "mview.refresh"} <= set(faults.WIRED_POINTS)
    assert {"serve.epoch", "serve.invalidate"} <= trace.SPAN_NAMES
    assert locks.LOCK_RANKS["serve.ownership"] \
        > locks.LOCK_RANKS["serve.invalidation"]
    for m in ("epoch_mints", "epoch_retries", "epoch_fences",
              "invalidations", "rebuilds"):
        assert m in metrics.serve_stats(), m
