"""The port's device-resident storage (``spark_tpu_torch/storage``) and
``DataFrame.cache`` on the inputs of tests/test_storage.py and
tests/test_cache.py.

The store and budget cases run the same steps on the reference's
``MemoryStore``/``UnifiedMemoryManager`` and the port's and compare
every observation (byte accounting, LRU order, evictions, pins, grants).
The session cases cache Parquet scans and aggregates through the port
and compare the rows with the reference's; the store's bytes, hits and
misses, single-flight materialization, eviction and recompute, auto
caching of hot scans and the budget invariant under 8 racing threads
are the port's own. The scheduler's admission and the UI of
tests/test_storage.py wait for ROADMAP A12.
"""

import os
import threading
import time

import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_tpu import storage as RS
from spark_tpu_torch import storage as PS
from spark_tpu_torch.api import functions as F
from spark_tpu_torch.api.session import SparkSession as PortSession
from spark_tpu_torch.storage import lru

from test_torch_threads import one_torch_thread  # noqa: F401


class FakeBatch:
    """A store payload of an exact byte size."""

    def __init__(self, nbytes: int):
        self._n = int(nbytes)

    def device_nbytes(self) -> int:
        return self._n


def _put_get_accounting(S):
    m = S.UnifiedMemoryManager(1000)
    s = S.MemoryStore(m)
    out = [s.put("a", FakeBatch(300)), s.bytes_used(),
           s.get("a") is not None, s.get("zzz") is None]
    st = s.stats()
    return out + [st["hits"], st["misses"], st["hit_bytes"],
                  m.snapshot()["storage_bytes"]]


def _lru_eviction_order(S):
    s = S.MemoryStore(S.UnifiedMemoryManager(1000))
    s.put("a", FakeBatch(400))
    s.put("b", FakeBatch(400))
    s.get("a")  # touch: b becomes the least recently used
    return [s.put("c", FakeBatch(400)), "b" in s, "a" in s, "c" in s,
            s.bytes_used(), s.stats()["evictions"]]


def _larger_than_budget(S):
    s = S.MemoryStore(S.UnifiedMemoryManager(1000))
    return [s.put("huge", FakeBatch(2000)), s.bytes_used(),
            s.stats()["rejected_puts"]]


def _max_storage(S):
    s = S.MemoryStore(S.UnifiedMemoryManager(1000, max_storage_bytes=500))
    return [s.put("a", FakeBatch(400)), s.put("b", FakeBatch(400)),
            "a" in s, s.bytes_used()]


def _execution_evicts_to_floor(S):
    m = S.UnifiedMemoryManager(1000, min_storage_bytes=200)
    s = S.MemoryStore(m)
    s.put("a", FakeBatch(300))
    s.put("b", FakeBatch(300))
    charge = m.acquire_execution(500)  # 100 more than the free span
    snap = m.snapshot()
    out = [charge, snap["in_use_bytes"], snap["storage_bytes"],
           s.stats()["evictions"], m.evicted_for_execution]
    m.release_execution(charge)
    return out + [m.snapshot()["in_use_bytes"]]


def _pinned_survive(S):
    m = S.UnifiedMemoryManager(1000, min_storage_bytes=0)
    s = S.MemoryStore(m)
    s.put("pinned", FakeBatch(600))
    with S.pin_scope():
        got = s.get("pinned", pin=True) is not None
        charge = m.acquire_execution(900)
        snap = m.snapshot()
        out = [got, charge, "pinned" in s, snap["in_use_bytes"],
               snap["storage_bytes"]]
        m.release_execution(charge)
    charge = m.acquire_execution(900)  # the pin is released: evictable
    out += ["pinned" in s, charge]
    m.release_execution(charge)
    return out


def _idle_overbudget_admits(S):
    m = S.UnifiedMemoryManager(1000, min_storage_bytes=0)
    s = S.MemoryStore(m)
    with S.pin_scope():
        s.put("k", FakeBatch(1000), pin=True)
        fits = m.fits_execution(5000)  # an idle device always progresses
        charge = m.acquire_execution(5000)
        snap = m.snapshot()
        m.release_execution(charge)
    return [fits, charge, snap["in_use_bytes"] + snap["storage_bytes"]]


def _pin_scope_reentrant(S):
    s = S.MemoryStore(S.UnifiedMemoryManager(1000))
    s.put("k", FakeBatch(100))
    with S.pin_scope():
        s.get("k", pin=True)
        with S.pin_scope():  # the inner scope folds into the outer one
            s.get("k", pin=True)
        inner = s.entries_snapshot()[0]["pins"]
    return [inner, s.entries_snapshot()[0]["pins"]]


def _grow_and_update(S):
    m = S.UnifiedMemoryManager(1000)
    s = S.MemoryStore(m)
    s.put("a", FakeBatch(300))
    c = m.acquire_execution(400)
    grown = m.try_grow(500)  # only the free span: 300
    denied = m.try_grow(1)
    snap = m.snapshot()
    m.release_execution(c + grown)
    return [c, grown, denied, snap["grants"]["grows"],
            snap["grants"]["grow_denials"], s.remove("a"), s.bytes_used(),
            s.remove("a")]


@pytest.mark.parametrize("scenario", [
    _put_get_accounting, _lru_eviction_order, _larger_than_budget,
    _max_storage, _execution_evicts_to_floor, _pinned_survive,
    _idle_overbudget_admits, _pin_scope_reentrant, _grow_and_update,
], ids=lambda f: f.__name__.strip("_"))
def test_store_and_budget_match_reference(scenario):
    assert scenario(PS) == scenario(RS)


def test_eviction_racing_admission_invariant_8_clients():
    """8 threads churn storage puts and pinned gets while taking and
    releasing execution grants on the same budget; a sampler checks that
    storage plus execution never exceeds it."""
    m = PS.UnifiedMemoryManager(10_000, min_storage_bytes=1_000,
                                max_storage_bytes=8_000)
    store = PS.MemoryStore(m)
    stop = threading.Event()
    violations = []

    def sampler():
        while not stop.is_set():
            snap = m.snapshot()
            if snap["in_use_bytes"] + snap["storage_bytes"] \
                    > snap["budget_bytes"]:
                violations.append(snap)
            time.sleep(0.0005)

    def client(i):
        for j in range(8):
            charge = m.acquire_execution(((i + j) % 5 + 1) * 1200)
            with PS.pin_scope():
                key = ("hot", (i + j) % 6)
                if store.get(key, pin=True) is None:
                    store.put(key, FakeBatch(1500), pin=True)
                time.sleep(0.002)
            m.release_execution(charge)

    t = threading.Thread(target=sampler, daemon=True)
    t.start()
    clients = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(8)]
    for c in clients:
        c.start()
    for c in clients:
        c.join(30)
    stop.set()
    t.join(1)
    assert not any(c.is_alive() for c in clients)
    assert not violations, violations[:3]
    assert m.snapshot()["in_use_bytes"] == 0


def test_lru_dict_bounded_with_gauge():
    d = PS.LruDict("t_bound", cap=3)
    for i in range(6):
        d[i] = i * 10
    assert len(d) == 3
    assert 0 not in d and 5 in d
    assert d.evictions == 3
    assert lru.gauges()["jit_cache.t_bound.entries"] == 3
    d.get(3)  # touch
    d[6] = 60
    assert 3 in d and 4 not in d  # LRU, not FIFO
    w = PS.LruDict("t_bytes", cap=100, max_bytes=10, weigher=len)
    for k in ("aaaa", "bbbb", "cccc"):
        w[k] = k
    assert w.keys() == ["bbbb", "cccc"] and w.total_bytes == 8


# ---- the session's cache on the store ---------------------------------------


@pytest.fixture()
def port():
    return PortSession(device="cpu")


def _write_parquet(tmp_path, name, nrows=256):
    t = pa.table({
        "k": pa.array([i % 7 for i in range(nrows)], pa.int64()),
        "v": pa.array([float(i) for i in range(nrows)], pa.float64()),
    })
    p = os.path.join(str(tmp_path), name)
    pq.write_table(t, p)
    return p


def _sorted_arrow(df):
    return df.toArrow().sort_by("k")


def test_cache_materializes_into_store_and_uncache_releases(
        spark, port, tmp_path):
    path = _write_parquet(tmp_path, "t1.parquet")
    df = port.read.parquet(path)
    agg = df.groupBy("k").count()
    port.conf.set("spark.tpu.storage.autoCacheThreshold", 0)
    before = port.memory_store.bytes_used()
    df.cache()
    r1 = _sorted_arrow(agg)
    after = port.memory_store.bytes_used()
    assert after > before  # the cached table is on the device, in the store
    r2 = _sorted_arrow(agg)
    assert r2.equals(r1)
    assert port.cache_manager.materializations == 1
    df.unpersist()
    assert port.memory_store.bytes_used() == before  # bytes released
    want = spark.read.parquet(path).groupBy("k").count().toArrow()
    assert r1.to_pylist() == want.sort_by("k").to_pylist()


def test_recompute_after_evict_is_byte_identical(port, tmp_path):
    df = port.read.parquet(_write_parquet(tmp_path, "t2.parquet"))
    agg = df.groupBy("k").count()
    df.cache()
    r1 = _sorted_arrow(agg)
    misses0 = port.memory_store.stats()["misses"]
    with port.memory_manager.lock:  # an execution grant's pressure
        port.memory_store._evict_locked(1 << 62, floor=0,
                                        reason="execution")
    r2 = _sorted_arrow(agg)  # single-flight recompute
    assert r2.equals(r1)
    assert port.memory_store.stats()["misses"] > misses0
    assert port.memory_store.stats()["recomputes"] >= 1
    hits0 = port.memory_store.stats()["hits"]
    assert _sorted_arrow(agg).equals(r1)  # the recompute refilled it
    assert port.memory_store.stats()["hits"] > hits0
    df.unpersist()


def test_concurrent_cached_queries_byte_identical_under_eviction(
        port, tmp_path):
    """Two cached tables that cannot both fit: 8 client threads race
    eviction against materialization; every result stays the same and
    the budget holds."""
    port.conf.set("spark.tpu.storage.autoCacheThreshold", 0)
    df1 = port.read.parquet(_write_parquet(tmp_path, "e1.parquet", 512))
    df2 = port.read.parquet(_write_parquet(tmp_path, "e2.parquet", 512))
    a1, a2 = df1.groupBy("k").count(), df2.groupBy("k").count()
    df1.cache()
    df2.cache()
    base = port.memory_store.bytes_used()
    ref1 = _sorted_arrow(a1)
    one = port.memory_store.bytes_used() - base
    ref2 = _sorted_arrow(a2)
    port.conf.set("spark.tpu.storage.maxBytes", max(1, int(one * 1.5)))
    port.conf.set("spark.tpu.storage.minBytes", 0)
    with port.memory_manager.lock:  # the clients materialize under the cap
        port.memory_store._evict_locked(1 << 62, floor=0, reason="storage")
    st0 = port.memory_store.stats()
    bad, lock = [], threading.Lock()

    def client(i):
        for _ in range(6):
            agg, ref = (a1, ref1) if i % 2 == 0 else (a2, ref2)
            try:
                if not _sorted_arrow(agg).equals(ref):
                    with lock:
                        bad.append(f"client{i}: rows differ")
            except Exception as e:  # noqa: BLE001 - collected for the assert
                with lock:
                    bad.append(f"client{i}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not bad, bad[:5]
    snap = port.memory_manager.snapshot()
    assert snap["storage_bytes"] + snap["in_use_bytes"] \
        <= snap["budget_bytes"]
    # the two tables displaced each other (or a pinned one turned the
    # other's insert away)
    st = port.memory_store.stats()
    assert st["evictions"] + st["rejected_puts"] \
        > st0["evictions"] + st0["rejected_puts"]


def test_auto_cache_promotes_hot_scan(port, tmp_path):
    df = port.read.parquet(_write_parquet(tmp_path, "hot.parquet"))
    q = df.select("v").filter(F.col("v") >= 0.0)
    entries0 = len(port.memory_store)
    q.collect()  # read 1: below the threshold (2)
    assert len(port.memory_store) == entries0
    q.collect()  # read 2: promoted into the store
    assert len(port.memory_store) > entries0
    hits0 = port.memory_store.stats()["hits"]
    r = q.collect()  # read 3: served from the store
    assert port.memory_store.stats()["hits"] > hits0
    assert len(r) == 256


def test_auto_cache_disabled_by_conf(port, tmp_path):
    port.conf.set("spark.tpu.storage.autoCacheThreshold", 0)
    q = port.read.parquet(_write_parquet(tmp_path, "cold.parquet")) \
        .select("k")
    entries0 = len(port.memory_store)
    for _ in range(4):
        q.collect()
    assert len(port.memory_store) == entries0


def test_cache_reused_and_unpersist(spark, port):
    """tests/test_cache.py: the cached filter is materialized once and
    both aggregates over it read the stored batch."""
    base = port.range(1000).filter(F.col("id") % 3 == 0)
    base.cache()
    assert base.is_cached
    a = base.agg(F.count("*").alias("n")).collect()[0]["n"]
    b = base.agg(F.sum("id").alias("s")).collect()[0]["s"]
    assert port.cache_manager.materializations == 1
    assert (a, b) == (334, sum(range(0, 1000, 3)))
    base.unpersist()
    assert not base.is_cached
    from spark_tpu.api import functions as RF

    rbase = spark.range(1000).filter(RF.col("id") % 3 == 0)
    assert (a, b) == (rbase.count(),
                      rbase.agg(RF.sum("id").alias("s")).collect()[0].s)


def test_uncached_plans_unaffected(port):
    df = port.range(100)
    assert df.count() == 100
    assert df.filter(F.col("id") > 50).count() == 49
    assert port.cache_manager.materializations == 0
