"""The port's compile tier (``spark_tpu_torch/compile/``) on the cases of
tests/test_compile.py: the cross-session statistics store, stable
fingerprints, background capture with the hot swap, the
``compile.background`` fault matrix, an entry that no longer binds, the
corrupt-entry and size-bound policies, the served-plan history and the
pre-warm, and the settings.

The reference persists XLA executables; the port persists the runtime
statistics of a plan's first run (compile/store.py says why), so a
restarted process's first run of a known plan binds them and is not a
first run (``RunStats.first_run`` False): on the card it captures at
once. A restart is simulated in-process by dropping every statistic,
captured stage, loaded entry and digest (``_forget_process_state``), and
once for real: a child interpreter with another ``PYTHONHASHSEED``
computes the same fingerprint and binds the parent's entry.

Held against the reference: every query's rows equal the reference
session's rows of the same SQL over the same Parquet file (the
reference's own compile tier does not run on this machine's XLA, so its
plain session is the oracle): integers exact, the float sum rel 1e-6.
The port's eager, bound, swapped and pre-warmed runs are held against
each other bit for bit; the history's counts and order against the
reference's ``PlanHistory`` on the same journal; the settings' keys and
defaults against the reference's.
"""

import glob
import json
import math
import os
import re
import subprocess
import sys
import textwrap
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_tpu.compile.service import PlanHistory as RefHistory
from spark_tpu_torch import conf as CF
from spark_tpu_torch import faults, metrics
from spark_tpu_torch.api.session import SparkSession
from spark_tpu_torch.compile import store as store_mod
from spark_tpu_torch.compile.service import PlanHistory, _replayable_sql
from spark_tpu_torch.compile.store import (StatsStore, clear_process_cache,
                                           stable_plan_fingerprint)
from spark_tpu_torch.physical import graphs, planner
from spark_tpu_torch.physical import operators as P

from test_torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.timeout(300)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = ("SELECT k, SUM(v) AS s, COUNT(*) AS c, SUM(f) AS fs, "
          "MAX(g) AS m FROM {t} GROUP BY k ORDER BY k")


@pytest.fixture(scope="module")
def fact_parquet(tmp_path_factory):
    """A small fact table: integer sums and counts are exact in every
    path, the float sum exact between the port's own paths; ``g`` is a
    string column, so the fingerprint digests a dictionary."""
    rng = np.random.default_rng(7)
    n = 5000
    tbl = pa.table({
        "k": pa.array(rng.integers(0, 8, n), pa.int64()),
        "v": pa.array(rng.integers(0, 1000, n), pa.int64()),
        "f": pa.array(rng.standard_normal(n), pa.float64()),
        "g": pa.array([f"s{int(i)}" for i in rng.integers(0, 50, n)]),
    })
    path = str(tmp_path_factory.mktemp("compile") / "fact.parquet")
    pq.write_table(tbl, path, row_group_size=1000)
    return path


@pytest.fixture(scope="module")
def oracle(spark, fact_parquet):
    """The reference session's rows of GOLDEN over the file."""
    spark.read.parquet(fact_parquet).createOrReplaceTempView("cmp_ref")
    return [tuple(r.asDict().values())
            for r in spark.sql(GOLDEN.format(t="cmp_ref")).collect()]


def _agree(rows, oracle):
    assert len(rows) == len(oracle)
    for got, want in zip(rows, oracle):
        assert got[:3] == want[:3] and got[4] == want[4]
        assert math.isclose(got[3], want[3], rel_tol=1e-6)


def _session(master=None, **conf):
    """A private CPU session with ``conf``, over ``master`` (a
    ``mesh[N]`` of CPU ranks) when given."""
    if master is None:
        return SparkSession("cpu", conf)
    n = int(master[master.index("[") + 1:-1])
    return SparkSession("cpu", dict(conf, **{CF.MESH_DEVICES.key: n}),
                        ["cpu"] * n)


def _close(sess):
    svc = sess.__dict__.get("_compile_service")
    if svc is not None:
        svc.wait_background(timeout=60)
    sess.stop()


def _forget_process_state():
    """What a new process lacks: the statistics, captured stages, loaded
    entries and content digests."""
    for cache in (planner._OUTPUT_STATS, planner._COMPACT_STATS,
                  P._AGG_STATS, P._GEN_STATS, P._JOIN_STATS, P._JOIN_INDEX):
        cache.clear()
    graphs.drop_stages()
    clear_process_cache()


def _rows(sess, query):
    return [tuple(r.asDict().values()) for r in sess.sql(query).collect()]


def _run_twice(sess, path, view="compile_fact"):
    sess.read.parquet(path).createOrReplaceTempView(view)
    q = GOLDEN.format(t=view)
    out = _rows(sess, q)
    assert _rows(sess, q) == out
    return out


# ---- the cross-session store ---------------------------------------------------


def test_cross_session_cache_hit(fact_parquet, oracle, tmp_path):
    """A second session over the same store directory binds the first
    session's statistics: its first run is not a first run, and its rows
    are the same bytes."""
    store_dir = str(tmp_path / "store")
    _forget_process_state()
    metrics.reset_exec_store()
    s1 = _session(**{"spark.tpu.compile.store.dir": store_dir})
    try:
        rows1 = _run_twice(s1, fact_parquet)
        st1 = metrics.exec_store_stats()
        assert st1["misses"] >= 1 and st1["puts"] >= 1
        assert s1.compile_service.store.stats()["entries"] >= 1
    finally:
        _close(s1)
    _agree(rows1, oracle)

    _forget_process_state()  # only the disk stays warm
    metrics.reset_exec_store()
    s2 = _session(**{"spark.tpu.compile.store.dir": store_dir})
    try:
        s2.read.parquet(fact_parquet).createOrReplaceTempView("compile_fact")
        rows2 = _rows(s2, GOLDEN.format(t="compile_fact"))
        assert planner.last_run.first_run is False
        st2 = metrics.exec_store_stats()
        assert st2["hits"] >= 1 and st2["corrupt"] == 0
    finally:
        _close(s2)
    assert rows2 == rows1


def test_store_disabled_is_legacy(fact_parquet):
    """No compile setting: no service, no store traffic, a first run is a
    first run."""
    _forget_process_state()
    metrics.reset_exec_store()
    s = _session()
    try:
        assert s.compile_service is None
        s.read.parquet(fact_parquet).createOrReplaceTempView("legacy_t")
        _rows(s, GOLDEN.format(t="legacy_t"))
        assert planner.last_run.first_run is True
        _rows(s, GOLDEN.format(t="legacy_t"))
        assert planner.last_run.first_run is False
    finally:
        _close(s)
    st = metrics.exec_store_stats()
    assert st["hits"] == st["misses"] == st["puts"] == 0


# ---- stable fingerprints -------------------------------------------------------


def test_fingerprint_sensitivity(monkeypatch):
    """Stable for the same plan over the same data, rebuilt too; another
    tier, other data, another capacity or another environment is another
    fingerprint; a plan holding a user function has none."""
    from spark_tpu_torch import types as T
    from spark_tpu_torch.api import functions as F
    from spark_tpu_torch.physical.planner import plan_physical
    from spark_tpu_torch.plan.optimizer import optimize

    s = _session()
    try:
        def physical(rows, v=F.col("v")):
            df = s.createDataFrame(rows).groupBy("k").agg(
                F.sum(v).alias("s"))
            return plan_physical(optimize(df._plan, s.conf), "cpu")

        rows = [{"k": i % 3, "v": i} for i in range(10)]
        plan = physical(rows)
        base = stable_plan_fingerprint("plan", plan)
        assert base is not None
        assert base == stable_plan_fingerprint("plan", plan) \
            == stable_plan_fingerprint("plan", physical(rows))
        assert stable_plan_fingerprint("stats", plan) != base
        other = [{"k": i % 3, "v": i + 1} for i in range(10)]
        assert stable_plan_fingerprint("plan", physical(other)) != base
        assert stable_plan_fingerprint("plan", physical(rows * 500)) != base
        twice = F.udf(lambda v: v * 2, T.INT64)
        assert stable_plan_fingerprint(
            "plan", physical(rows, twice(F.col("v")))) is None
        monkeypatch.setattr(store_mod, "environment_fingerprint",
                            lambda: ("cuda", "another card", "torch"))
        assert stable_plan_fingerprint("plan", plan) != base
    finally:
        _close(s)


_CHILD = textwrap.dedent("""
    import json, sys
    from spark_tpu_torch.api.session import SparkSession
    from spark_tpu_torch.compile.store import stable_plan_fingerprint
    from spark_tpu_torch.physical import planner
    from spark_tpu_torch.physical.planner import plan_physical
    from spark_tpu_torch.plan.optimizer import optimize
    store, path, query = sys.argv[1:4]
    s = SparkSession("cpu", {"spark.tpu.compile.store.dir": store})
    s.read.parquet(path).createOrReplaceTempView("salt_t")
    df = s.sql(query)
    fp = stable_plan_fingerprint(
        "plan", plan_physical(optimize(df._plan, s.conf), "cpu"))
    rows = [list(r.asDict().values()) for r in df.collect()]
    print(json.dumps({"fp": fp, "first_run": planner.last_run.first_run,
                      "rows": rows}))
""")


def test_fingerprint_survives_hash_salting(fact_parquet, tmp_path):
    """The digest does not depend on PYTHONHASHSEED (a string
    dictionary's ``hash()`` is salted per process): two plans built from
    scratch fingerprint alike here, and a child interpreter with another
    seed computes the same digest and binds this process's entry."""
    store_dir = str(tmp_path / "store")
    q = GOLDEN.format(t="salt_t")
    s = _session(**{"spark.tpu.compile.store.dir": store_dir})
    try:
        s.read.parquet(fact_parquet).createOrReplaceTempView("salt_t")
        from spark_tpu_torch.physical.planner import plan_physical
        from spark_tpu_torch.plan.optimizer import optimize

        fps = [stable_plan_fingerprint("plan", plan_physical(
            optimize(s.sql(q)._plan, s.conf), "cpu")) for _ in range(2)]
        assert fps[0] is not None and fps[0] == fps[1]
        rows = [list(r) for r in _rows(s, q)]  # writes the entry
    finally:
        _close(s)
    script = tmp_path / "child.py"
    script.write_text(_CHILD)
    env = dict(os.environ, PYTHONHASHSEED="4242", PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, str(script), store_dir, fact_parquet, q],
        env=env, capture_output=True, text=True, timeout=240, check=True)
    child = json.loads(out.stdout.strip().splitlines()[-1])
    assert child["fp"] == fps[0]
    assert child["first_run"] is False  # bound from this process's entry
    assert child["rows"] == rows


# ---- background capture and the hot swap --------------------------------------


@pytest.mark.parametrize("master", [None, "mesh[2]", "mesh[8]"],
                         ids=["dev1", "dev2", "dev8"])
def test_hot_swap_byte_identity(fact_parquet, oracle, master):
    """Served eagerly while the background job captures, then swapped:
    both give the same bytes as a plain session's runs, the float sum
    included (the port serves the whole plan eagerly, not chunked, so a
    float sum rounds once either way); the swap happens once."""
    view = "swap_fact"
    q = GOLDEN.format(t=view)
    plain = _session(master=master)
    try:
        plain.read.parquet(fact_parquet).createOrReplaceTempView(view)
        want = _rows(plain, q)
        assert _rows(plain, q) == want
    finally:
        _close(plain)
    _agree(want, oracle)

    metrics.reset_exec_store()
    s = _session(master=master, **{"spark.tpu.compile.background": True})
    try:
        svc = s.compile_service
        s.read.parquet(fact_parquet).createOrReplaceTempView(view)
        first = _rows(s, q)  # eager; the capture runs in the background
        assert svc.wait_background(timeout=120)
        after = _rows(s, q)  # swapped
        st = metrics.exec_store_stats()
        assert st["background"] >= 1
        assert st["swaps"] == 1 and st["fallbacks"] == 0
        assert svc.status()["background"]["by_status"] == {"ready": 1}
    finally:
        _close(s)
    assert first == want
    assert after == want


def test_background_unchunkable_runs_foreground():
    """An in-memory plan: served eagerly, captured in the background,
    marked ready once."""
    s = _session(**{"spark.tpu.compile.background": True})
    try:
        s.createDataFrame([{"k": i % 3, "v": i} for i in range(100)]) \
            .createOrReplaceTempView("mem_t")
        q = "SELECT k, SUM(v) AS s FROM mem_t GROUP BY k ORDER BY k"
        rows = _rows(s, q)
        assert s.compile_service.wait_background(timeout=60)
        assert _rows(s, q) == rows == [(0, 1683), (1, 1617), (2, 1650)]
        assert s.compile_service.status()["background"]["by_status"] \
            == {"ready": 1}
    finally:
        _close(s)


# ---- fault matrix: compile.background ------------------------------------------


@pytest.mark.parametrize("kind", list(faults.KINDS))
def test_background_failure_pins_chunked(fact_parquet, oracle, kind):
    """Every failure kind in the background job pins the plan to the
    eager path: no swap, no crash, the same rows every time."""
    view = "fault_fact"
    q = GOLDEN.format(t=view)
    metrics.reset_exec_store()
    s = _session(**{"spark.tpu.compile.background": True,
                    "spark.tpu.faultInjection.hangSeconds": 0.02,
                    "spark.tpu.faultInjection.compile.background":
                        f"nth:1:{kind}"})
    try:
        svc = s.compile_service
        faults.reset(s.conf)
        s.read.parquet(fact_parquet).createOrReplaceTempView(view)
        first = _rows(s, q)
        assert svc.wait_background(timeout=120)
        again = _rows(s, q)  # still eager: the capture failed
        st = metrics.exec_store_stats()
        assert st["fallbacks"] == 1 and st["swaps"] == 0
        assert st["background"] == 2, "both requests served eagerly"
        assert svc.status()["background"]["by_status"] == {"failed": 1}
        assert faults.fire_count(s.conf, "compile.background") == 1
    finally:
        faults.reset(s.conf)
        _close(s)
    _agree(first, oracle)
    assert again == first


def test_symbols_not_found_reload_recompiles_silently(
        fact_parquet, tmp_path, monkeypatch):
    """An entry that no longer binds (the counterpart of an executable
    XLA refuses to load) reads as corrupt: removed, the run a plain
    first run that writes it again, the query never seeing the error;
    once binding works, the rewritten entry serves."""
    store_dir = str(tmp_path / "store")
    conf = {"spark.tpu.compile.store.dir": store_dir}
    _forget_process_state()
    metrics.reset_exec_store()
    s1 = _session(**conf)
    try:
        rows1 = _run_twice(s1, fact_parquet)
        assert s1.compile_service.store.stats()["entries"] >= 1
    finally:
        _close(s1)

    _forget_process_state()
    metrics.reset_exec_store()

    def boom(*a, **k):
        raise RuntimeError("entry names nodes this plan does not have")

    monkeypatch.setattr(store_mod, "bind_stats", boom)
    s2 = _session(**conf)
    try:
        rows2 = _run_twice(s2, fact_parquet)
        st = metrics.exec_store_stats()
        assert st["corrupt"] >= 1 and st["hits"] == 0
        assert st["puts"] >= 1, "the first run writes the entry again"
    finally:
        _close(s2)
    assert rows2 == rows1

    monkeypatch.undo()
    _forget_process_state()
    metrics.reset_exec_store()
    s3 = _session(**conf)
    try:
        rows3 = _run_twice(s3, fact_parquet)
        st = metrics.exec_store_stats()
        assert st["hits"] >= 1 and st["corrupt"] == 0
    finally:
        _close(s3)
    assert rows3 == rows1


def test_corrupt_entry_is_miss_and_evicted(tmp_path):
    store = StatsStore(str(tmp_path / "store"), max_bytes=1 << 30)
    assert store.put("d" * 32, [("n" * 32, {"output": 1024})])
    clear_process_cache()  # the disk path
    path = store._entry_path("d" * 32)
    with open(path, "w") as f:
        f.write("not a literal (")
    before = metrics.exec_store_stats()["corrupt"]
    assert store.load("d" * 32) is None
    assert metrics.exec_store_stats()["corrupt"] == before + 1
    assert not os.path.exists(path), "a corrupt entry is removed"
    assert store.load("d" * 32) is None  # later loads: plain misses
    assert metrics.exec_store_stats()["corrupt"] == before + 1


def test_eviction_at_size_bound(tmp_path):
    """Past maxBytes the least recently used entry goes first; the
    survivor still loads."""
    store = StatsStore(str(tmp_path / "store"), max_bytes=1 << 30)
    nodes_a = [("a" * 32, {"agg": 7, "output": 1024})]
    nodes_b = [("b" * 32, {"join": (((0, 9),), True, False, 2048)})]
    assert store.put("a" * 32, nodes_a)
    one_entry = store.total_bytes()
    assert one_entry > 0
    time.sleep(0.05)  # separate mtimes
    store.max_bytes = int(one_entry * 1.5)
    before = metrics.exec_store_stats()["evictions"]
    assert store.put("b" * 32, nodes_b)
    assert metrics.exec_store_stats()["evictions"] >= before + 1
    assert not os.path.exists(store._entry_path("a" * 32))
    assert os.path.exists(store._entry_path("b" * 32))
    assert store.stats()["entries"] == 1
    assert store.total_bytes() <= store.max_bytes
    clear_process_cache()
    assert store.load("b" * 32)["nodes"] == nodes_b


# ---- history and the pre-warm ------------------------------------------------------


def test_plan_history_journal_and_compaction(tmp_path):
    """The same notes through both packages' histories: the same counts,
    order and compaction bound."""
    hists = []
    for cls, name in ((PlanHistory, "port.jsonl"), (RefHistory, "ref.jsonl")):
        path = str(tmp_path / name)
        h = cls(path, max_entries=4)
        for i in range(10):
            h.note(f"fp{i % 5}", sql=f"SELECT {i % 5}")
        h2 = cls(path, max_entries=4)
        with open(path) as f:
            lines = len(f.readlines())
        hists.append((h2.top(3), h2.size(), lines))
    assert hists[0] == hists[1]
    top, _, lines = hists[0]
    assert len(top) == 3
    counts = [n for _fp, _sql, n in top]
    assert counts == sorted(counts, reverse=True)
    assert lines <= 2 * 4 + 1

    assert _replayable_sql("SELECT 1") == "SELECT 1"
    assert _replayable_sql("  with t as (select 1) select * from t")
    assert _replayable_sql("CREATE VIEW v AS SELECT 1") is None
    assert _replayable_sql(None) is None


def test_prewarm_from_history(fact_parquet, tmp_path):
    """The queries one session served replay in the next, most frequent
    first, each through its first run (bound from the store) and its
    capture; the first client run afterwards is not a first run and
    gives the same rows."""
    store_dir = str(tmp_path / "store")
    conf = {"spark.tpu.compile.store.dir": store_dir}
    view = "warm_fact"
    hot = GOLDEN.format(t=view)
    cold = f"SELECT COUNT(*) AS c FROM {view}"
    _forget_process_state()
    s1 = _session(**conf)
    try:
        s1.read.parquet(fact_parquet).createOrReplaceTempView(view)
        want = _rows(s1, hot)
        _rows(s1, hot)
        _rows(s1, cold)
        assert s1.compile_service.history.size() >= 2
    finally:
        _close(s1)
    assert os.path.exists(os.path.join(store_dir, "plan_history.jsonl"))

    _forget_process_state()
    metrics.reset_exec_store()
    s2 = _session(**conf)
    try:
        s2.read.parquet(fact_parquet).createOrReplaceTempView(view)
        report = s2.compile_service.prewarm(block=True, budget_s=120.0,
                                            max_queries=8)
        assert report is not None and not report["errors"]
        replayed = report["replayed"]
        assert len(replayed) == 2
        assert replayed[0]["count"] >= replayed[1]["count"]
        assert metrics.exec_store_stats()["prewarmed"] == 2
        status = s2.compile_service.status()
        assert status["prewarm"] is report
        assert status["history"]["entries"] >= 2
        assert _rows(s2, hot) == want
        assert planner.last_run.first_run is False
    finally:
        _close(s2)


def test_prewarm_workers_replay_each_plan_once(fact_parquet, tmp_path):
    """``prewarm.workers`` threads share the history's queue and the
    report: with a short switch interval each journaled plan replays
    exactly once, none errs, and the rows after equal the journal's."""
    conf = {"spark.tpu.compile.store.dir": str(tmp_path / "store"),
            "spark.tpu.compile.prewarm.workers": 3}
    queries = [f"SELECT k, SUM(v) AS s FROM w_t WHERE v > {t} GROUP BY k "
               "ORDER BY k" for t in (100, 300, 500, 700, 900)]
    s1 = _session(**conf)
    try:
        s1.read.parquet(fact_parquet).createOrReplaceTempView("w_t")
        want = [_rows(s1, q) for q in queries]
    finally:
        _close(s1)
    _forget_process_state()
    s2 = _session(**conf)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        s2.read.parquet(fact_parquet).createOrReplaceTempView("w_t")
        report = s2.compile_service.prewarm(block=True, budget_s=120.0,
                                            max_queries=8)
        fps = [e["fp"] for e in report["replayed"]]
        assert not report["errors"] and not report["skipped"]
        assert len(fps) == len(set(fps)) == len(queries)
        assert [_rows(s2, q) for q in queries] == want
    finally:
        sys.setswitchinterval(interval)
        _close(s2)


def test_prewarm_time_budget_skips(fact_parquet, tmp_path):
    """A zero budget replays nothing and says why."""
    s = _session(**{"spark.tpu.compile.store.dir": str(tmp_path / "st")})
    try:
        s.read.parquet(fact_parquet).createOrReplaceTempView("budget_t")
        _rows(s, "SELECT COUNT(*) AS c FROM budget_t")
        report = s.compile_service.prewarm(block=True, budget_s=0.0,
                                           max_queries=8)
        assert report["replayed"] == []
        assert any(e["reason"] == "time budget" for e in report["skipped"])
    finally:
        _close(s)


# ---- the settings ------------------------------------------------------------------


def test_all_compile_conf_keys_declared():
    """Every spark.tpu.compile.* key in the port's source is registered
    with a default and a doc, under the reference's key and default."""
    from spark_tpu.conf import _REGISTRY as REF

    root = os.path.join(REPO, "spark_tpu_torch")
    used = set()
    for path in glob.glob(os.path.join(root, "**", "*.py"), recursive=True):
        with open(path) as f:
            used.update(re.findall(r"spark\.tpu\.compile(?:\.\w+)+",
                                   f.read()))
    assert len(used) >= 10
    for key in used:
        assert key in CF._REGISTRY, f"{key} not registered in conf.py"
        entry = CF._REGISTRY[key]
        assert entry.doc and len(entry.doc) > 20, f"{key} lacks a doc"
        assert entry.default is not None
        assert entry.default == REF[key].default, key
    assert "spark.tpu.faultInjection.compile.background" in CF._REGISTRY
    assert "compile.background" in faults.WIRED_POINTS


def test_ui_reports_the_compile_and_mview_tiers(fact_parquet, tmp_path):
    """``/api/v1/compile`` carries the service's status (store, history,
    background plans) once the tier is on, and ``/api/v1/mview`` the
    registered views."""
    import urllib.request

    from spark_tpu_torch import ui
    from spark_tpu_torch.api import functions as F

    s = _session(**{"spark.tpu.compile.store.dir": str(tmp_path / "st"),
                    "spark.tpu.mview.enabled": True})
    srv = ui.StatusServer(s, port=0)
    try:
        s.read.parquet(fact_parquet).createOrReplaceTempView("ui_t")
        _rows(s, GOLDEN.format(t="ui_t"))
        view = s.read.parquet(fact_parquet).groupBy("k").agg(
            F.sum("v").alias("s"))
        view.cache()
        view.collect()

        def get(path):
            with urllib.request.urlopen(srv.url + path, timeout=10) as r:
                return json.loads(r.read())

        comp = get("/api/v1/compile")
        assert comp["service"]["store"]["entries"] >= 1
        assert comp["service"]["history"]["entries"] >= 1
        assert comp["exec_store"]["puts"] >= 1
        views = get("/api/v1/mview")["views"]
        assert len(views) == 1 and views[0]["incremental"]
        view.unpersist()
    finally:
        srv.stop()
        _close(s)
