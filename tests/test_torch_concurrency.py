"""The port's lock hierarchy (``spark_tpu_torch/locks.py``) checked both
ways, on the inputs of tests/test_concurrency_lint.py and
tests/test_concurrency_runtime.py.

- Static: ``analysis/concurrency.py`` over the port's own source against
  the port's ``LOCK_RANKS`` finds nothing (no rank inversion, cycle,
  unlocked mutation, blocking call under a lock or bare wait); each rule
  still fires on a seeded violation with its own code.
- Runtime: the validator (``spark.tpu.debug.lockOrder``) catches a
  seeded inversion and cycle, lets same-name re-entry pass, and records
  no violation over a real workload (single-device and mesh queries, a
  chunked pipelined query, cached frames) whose locks do nest; a proxy's
  cost per acquire is held next to a plain lock's.

- The serving tier: the scheduler's workers and the result cache's
  single flight under the validator, a follower's wait bound, an
  owner's cancellation that its followers do not inherit, and every
  thread the serving tier starts stopping with it.

tools/lint_concurrency.py keeps scanning the reference package.
"""

import textwrap
import threading
import time

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_tpu import locks as RL
from spark_tpu_torch import conf as CF
from spark_tpu_torch import locks
from spark_tpu_torch.analysis import concurrency
from spark_tpu_torch.api.session import SparkSession
from spark_tpu_torch.tpch import QUERIES, generate_tables, register_views

from test_torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.timeout(180)


@pytest.fixture()
def validator():
    locks.reset_observations()
    locks.set_validation(True)
    try:
        yield
    finally:
        locks.set_validation(False)
        locks.reset_observations()


def _codes(src, **kw):
    found = concurrency.analyze_sources({"x.py": textwrap.dedent(src)}, **kw)
    return [d.code for d in found], found


# ---- static: the port's own tree ---------------------------------------------


def test_lint_clean_on_the_port():
    found = concurrency.lint_package()
    assert found == [], "\n".join(d.format() for d in found)


def test_no_rank_inversion_in_the_port():
    assert concurrency.lint_package(codes=("CONC-ORDER-CYCLE",)) == []
    graph = concurrency.lock_graph(concurrency.package_sources(),
                                   concurrency.PACKAGE_ALIASES)
    assert "pipeline.cond -> metrics.pipeline_stats" in graph["edges"]


def test_every_named_lock_is_ranked():
    """Every ``locks.named_*`` name in the port's source is in the
    registry (a typo would raise at import), the reference's ranks are
    kept, and the port-only ranks sit between storage and metrics."""
    import re

    names = set()
    for src in concurrency.package_sources().values():
        names |= set(re.findall(r'named_(?:r?lock|condition)\(\s*"([^"]+)"',
                                src))
    assert names and names <= set(locks.LOCK_RANKS)
    for name, rank in RL.LOCK_RANKS.items():
        assert locks.LOCK_RANKS[name] == rank
    for name in ("device.tables", "expr.arrow_dicts", "mesh.rank_stage",
                 "exchange.thread_comm", "ops.seg_agg"):
        assert locks.rank_of("storage.unified") < locks.rank_of(name) \
            < locks.rank_of("metrics.registry")


def test_seeded_rank_inversion_fires():
    codes, found = _codes("""\
        from spark_tpu_torch import locks

        class Store:
            def __init__(self):
                self._mgr = locks.named_rlock("storage.unified")
                self._reg = locks.named_lock("session.cache.registry")

            def bad(self):
                with self._mgr:
                    with self._reg:
                        return 1
        """)
    assert codes == ["CONC-ORDER-CYCLE"], found


def test_seeded_unranked_cycle_fires():
    codes, found = _codes("""\
        import threading

        _A = threading.Lock()
        _B = threading.Lock()

        def f1():
            with _A:
                with _B:
                    pass

        def f2():
            with _B:
                with _A:
                    pass
        """)
    assert codes == ["CONC-ORDER-CYCLE"] and "cycle" in found[0].message


def test_seeded_unlocked_mutation_fires():
    codes, found = _codes("""\
        import threading

        _LOCK = threading.Lock()
        _TABLE = {}

        def locked_put(k, v):
            with _LOCK:
                _TABLE[k] = v

        def bare_drop(k):
            _TABLE.pop(k, None)
        """)
    assert codes == ["CONC-UNLOCKED-MUT"] and "bare_drop" in found[0].message


def test_seeded_blocking_under_lock_fires_and_exemption_holds():
    src = """\
        import threading
        import time

        _LOCK = threading.Lock()

        def slow():
            with _LOCK:
                time.sleep(0.1)
        """
    codes, found = _codes(src)
    assert codes == ["CONC-BLOCKING-HELD"]
    assert "time.sleep()" in found[0].message
    assert _codes(src, exempt_blocking={"x.py::slow": "seeded"})[0] == []


def test_seeded_bare_wait_fires_and_looped_wait_passes():
    codes, found = _codes("""\
        import threading

        _COND = threading.Condition()

        def bad_wait():
            with _COND:
                _COND.wait()

        def good_wait(pred):
            with _COND:
                while not pred():
                    _COND.wait()
        """)
    assert codes == ["CONC-WAIT-NOLOOP"] and found[0].node == "x.py:7"


# ---- runtime: the validator -----------------------------------------------------


def test_validator_detects_seeded_inversion(validator):
    outer = locks.named_rlock("storage.unified")
    inner = locks.named_lock("session.cache.registry")
    with outer:
        with inner:
            pass
    rep = locks.order_report()
    v = next(v for v in rep["violations"]
             if v["edge"] == ["storage.unified", "session.cache.registry"])
    assert v["kind"] == "rank-inversion" and v["ranks"] == [400, 100]


def test_validator_detects_seeded_cycle(validator):
    locks.register_lock("test.cycle.a", 10_001)
    locks.register_lock("test.cycle.b", 10_002)
    a, b = locks.named_lock("test.cycle.a"), locks.named_lock("test.cycle.b")
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    rep = locks.order_report()
    assert rep["cycles"] and set(rep["cycles"][0]) >= {"test.cycle.a",
                                                       "test.cycle.b"}
    with pytest.raises(ValueError):
        locks.register_lock("test.cycle.a", 5)


def test_validator_same_name_reentry_is_legal(validator):
    l1 = locks.named_lock("session.cache.entry")
    l2 = locks.named_lock("session.cache.entry")
    with l1:
        with l2:
            pass
    r = locks.named_rlock("storage.unified")
    with r:
        with r:
            pass
    rep = locks.order_report()
    assert rep["violations"] == [] and rep["edges"] == []


def test_unregistered_name_refused():
    with pytest.raises(ValueError, match="not in locks.LOCK_RANKS"):
        locks.named_lock("no.such.lock")


def test_session_setting_turns_validation_on():
    try:
        SparkSession(device="cpu", conf={"spark.tpu.debug.lockOrder": True})
        assert locks.validation_enabled()
    finally:
        locks.set_validation(False)
    SparkSession(device="cpu")
    assert not locks.validation_enabled()


def test_workload_zero_violations(validator, tmp_path):
    """Single-device TPC-H, a mesh stage, a pipelined chunked query and a
    cached frame with the validator on: their locks nest, never against
    the ranks."""
    tables = generate_tables(0.01, seed=7)
    s = SparkSession(device="cpu", conf={"spark.tpu.debug.lockOrder": True})
    m = SparkSession("cpu", {CF.MESH_DEVICES.key: 2,
                             "spark.tpu.adaptive.enabled": True,
                             "spark.tpu.debug.lockOrder": True},
                     ["cpu", "cpu"])
    register_views(s, tables)
    register_views(m, tables)
    assert locks.validation_enabled()
    s.sql(QUERIES[1]).collect()
    s.sql(QUERIES[1]).collect()
    df = s.createDataFrame(pd.DataFrame({"k": [1, 2, 1, 2],
                                         "v": [1.0, 2.0, 3.0, 4.0]}))
    cached = df.groupBy("k").count().cache()
    cached.collect()
    cached.collect()
    rng = np.random.default_rng(1)
    path = str(tmp_path / "w.parquet")
    pq.write_table(pa.table({"k": rng.integers(0, 9, 20_000),
                             "v": rng.integers(0, 9, 20_000)}), path)
    s.conf.set("spark.tpu.maxDeviceBatchBytes", 1 << 14)
    s.conf.set("spark.tpu.chunkRows", 4_096)
    s.read.parquet(path).groupBy("k").sum("v").collect()
    m.sql(QUERIES[3]).collect()
    rep = locks.order_report()
    assert rep["violations"] == [], rep["violations"]
    assert rep["cycles"] == []
    assert ("pipeline.cond", "metrics.pipeline_stats") in rep["edges"]


def _pair_cost(lock, n=20_000):
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(n):
            with lock:
                pass
        best = min(best, time.perf_counter() - t0)
    return best / n


def test_proxy_cost_next_to_a_plain_lock():
    """With validation off a proxy costs one flag check and a Python
    call over the plain lock: under a microsecond a pair on an idle
    host (the launch path it guards costs tens of microseconds); the
    bound leaves room for a loaded one."""
    locks.set_validation(False)
    plain = _pair_cost(threading.Lock())
    proxy = _pair_cost(locks.named_lock("ops.seg_agg"))
    assert proxy - plain < 5e-6, (proxy, plain)
    locks.reset_observations()
    locks.set_validation(True)
    try:
        on = _pair_cost(locks.named_lock("metrics.registry"))
    finally:
        locks.set_validation(False)
        locks.reset_observations()
    assert on - proxy < 50e-6, (on, proxy)


# ---- the serving tier ------------------------------------------------------


def _cache(**overrides):
    from spark_tpu_torch.serve.result_cache import ResultCache

    base = {"spark.tpu.serve.resultCache.enabled": True}
    base.update(overrides)
    return ResultCache(CF.RuntimeConf(base))


def test_scheduler_and_result_cache_zero_violations(validator):
    from spark_tpu_torch.scheduler import QueryScheduler

    sched = QueryScheduler(conf=CF.RuntimeConf({}))
    cache = _cache()
    tbl = pa.table({"x": [1, 2, 3]})
    try:
        tasks = [sched.submit(lambda tk, i=i: cache.get_or_execute(
            ("k", i % 2), lambda: tbl)[1]) for i in range(8)]
        got = [t.result(timeout=30) for t in tasks]
        assert got.count("miss") == 2
    finally:
        sched.stop()
    rep = locks.order_report()
    assert rep["violations"] == [] and rep["cycles"] == []
    assert rep["edges"]


def test_flight_wait_timeout_falls_through(monkeypatch):
    from spark_tpu_torch import metrics
    from spark_tpu_torch.serve import result_cache as rc

    monkeypatch.setattr(rc, "_FLIGHT_WAIT_S", 0.2)
    cache = _cache()
    tbl = pa.table({"x": [1, 2, 3]})
    started, release = threading.Event(), threading.Event()

    def wedged_owner():
        started.set()
        release.wait(timeout=30)
        return tbl

    before = metrics.serve_stats().get("wait_timeouts", 0)
    owner_res = {}
    th = threading.Thread(target=lambda: owner_res.update(
        r=cache.get_or_execute("q", wedged_owner)), daemon=True)
    th.start()
    assert started.wait(timeout=10)
    blob, status = cache.get_or_execute("q", lambda: tbl)
    assert status == "timeout"
    assert pa.ipc.open_stream(blob).read_all().equals(tbl)
    assert metrics.serve_stats().get("wait_timeouts", 0) == before + 1
    release.set()
    th.join(timeout=30)
    assert owner_res["r"][1] == "miss"


def test_flight_wait_timeout_is_typed():
    from spark_tpu_torch.serve.result_cache import FlightWaitTimeout

    e = FlightWaitTimeout("abcd1234", 0.25)
    assert isinstance(e, RuntimeError)
    assert e.key_digest == "abcd1234" and e.waited_s == 0.25


def test_owner_cancellation_not_inherited_by_followers():
    from spark_tpu_torch.scheduler import QueryCancelled

    cache = _cache()
    tbl = pa.table({"x": [7]})
    started, proceed = threading.Event(), threading.Event()

    def cancelled_owner():
        started.set()
        proceed.wait(timeout=30)
        raise QueryCancelled("owner-local deadline")

    owner_res, follower_res = {}, {}

    def owner():
        try:
            cache.get_or_execute("qc", cancelled_owner)
        except QueryCancelled as e:
            owner_res["e"] = e

    to = threading.Thread(target=owner, daemon=True)
    to.start()
    assert started.wait(timeout=10)
    tf = threading.Thread(target=lambda: follower_res.update(
        r=cache.get_or_execute("qc", lambda: tbl)), daemon=True)
    tf.start()
    time.sleep(0.1)
    proceed.set()
    to.join(timeout=30)
    tf.join(timeout=30)
    assert isinstance(owner_res["e"], QueryCancelled)
    assert follower_res["r"][1] == "miss"
    assert pa.ipc.open_stream(follower_res["r"][0]).read_all().equals(tbl)


def test_serving_threads_quiesce():
    from spark_tpu_torch.connect.server import ConnectServer
    from spark_tpu_torch.serve import serve_fleet

    s = SparkSession(device="cpu")
    srv = ConnectServer(s, port=0).start()
    fleet = serve_fleet(s, replicas=2)
    assert s.query_scheduler.submit(lambda tk: 41 + 1).result(30) == 42
    alive = {th.name for th in threading.enumerate()}
    assert any(n.startswith("spark-tpu-sched") for n in alive), alive
    fleet.stop()
    srv.stop()
    s.stop()
    deadline = time.time() + 15
    leftover = ["unchecked"]
    while time.time() < deadline:
        leftover = [th.name for th in threading.enumerate()
                    if th.name.startswith(("spark-tpu-router",
                                           "spark-tpu-connect"))]
        if not leftover:
            break
        time.sleep(0.05)
    assert not leftover, leftover
