"""The port's materialized views (``spark_tpu_torch/mview/``) on the cases
of tests/test_mview.py: delta classification, registration through
``cache()``, the incremental merge against the full recompute with the
same bytes under the on/off sweep (1, 2 and 8 CPU ranks, uniform and
skewed appends, string and integer keys), the fallbacks of float sums and
averages, the ``mview.refresh`` fault matrix and retry exhaustion, stream
views with the WAL replay's dedup, the store's in-place update, the
serve tier's repopulation, the PLAN-MVIEW-* diagnostics, the settings and
the profile.

Held against the reference on the same Parquet files (integer sums,
maxima and minima, and string keys: exact): ``classify_delta``'s
answers; ``inspect_plan``'s codes on the same plans; each refreshed
view's rows against the reference's uncached read of the same directory;
the stream views' rows against the reference's stream of the same
micro-batches. The view's counters (merges against recomputes) are held
against the port itself, as in the reference's tests.
"""

import os

import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_tpu.api import functions as RF
from spark_tpu.io import fingerprint as ref_fp
from spark_tpu.mview import inspect_plan as ref_inspect
from spark_tpu_torch import conf as CF
from spark_tpu_torch import faults, metrics
from spark_tpu_torch.api import functions as F
from spark_tpu_torch.api.session import SparkSession
from spark_tpu_torch.columnar.arrow import to_arrow
from spark_tpu_torch.io.fingerprint import classify_delta, stat_paths
from spark_tpu_torch.serve.result_cache import table_to_ipc

from test_torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.timeout(300)

_KEYS = ("spark.tpu.mview.enabled", "spark.tpu.mview.incremental",
         "spark.tpu.mview.refreshRetries",
         "spark.tpu.faultInjection.mview.refresh",
         "spark.tpu.faultInjection.streaming.commit",
         "spark.tpu.faultInjection.hangSeconds",
         "spark.tpu.serve.resultCache.enabled")


@pytest.fixture(scope="module")
def port():
    return SparkSession(device="cpu")


@pytest.fixture
def mview_on(port):
    """The tier armed on the module's session (registration happens at
    cache(), so the flag is set first), every key unset afterwards."""
    port.conf.set("spark.tpu.mview.enabled", True)
    yield port.conf
    for key in _KEYS:
        port.conf.unset(key)
    faults.reset(port.conf)
    port.cache_manager.clear()


def _write(d, name, ks, vs, key_type=pa.string()):
    pq.write_table(pa.table({"k": pa.array(ks, key_type),
                             "v": pa.array(vs, pa.int64())}),
                   os.path.join(d, name))


def _base(d, key_type=pa.string()):
    ks = ([f"k{i % 13}" for i in range(400)] if key_type == pa.string()
          else [i % 13 for i in range(400)])
    _write(d, "base.parquet", ks, [i % 97 for i in range(400)], key_type)


def _sum_df(spark, d, fns=F):
    return spark.read.parquet(d).groupBy("k").agg(fns.sum("v").alias("s"))


def _rows(df):
    return sorted(tuple(r.asDict().values()) for r in df.collect())


# ---- delta classification ----------------------------------------------------


def test_classify_delta(tmp_path):
    d = str(tmp_path)
    _write(d, "a.parquet", ["x"], [1])
    fp1 = stat_paths([d])
    steps = [(fp1, fp1)]
    _write(d, "b.parquet", ["y"], [2])
    fp2 = stat_paths([d])
    steps.append((fp1, fp2))
    _write(d, "a.parquet", ["x", "x"], [1, 1])  # a rewrite
    steps.append((fp2, stat_paths([d])))
    os.remove(os.path.join(d, "b.parquet"))  # a deletion
    steps.append((fp2, stat_paths([d])))
    got = [classify_delta(a, b) for a, b in steps]
    assert got == [ref_fp.classify_delta(a, b) for a, b in steps]
    assert [k for k, _ in got] == ["unchanged", "appended", "changed",
                                   "changed"]
    assert [os.path.basename(p) for p in got[1][1]] == ["b.parquet"]


# ---- registration and inspection ---------------------------------------------


def test_inspect_plan_verdicts(port, spark, tmp_path):
    import dataclasses

    from spark_tpu_torch.mview import inspect_plan

    d = str(tmp_path)
    _base(d)

    def plans(sess, fns):
        scan = sess.read.parquet(d)
        plan = scan.groupBy("k").agg(fns.sum("v").alias("s"))._plan
        return {
            "ok": plan,
            "avg": scan.groupBy("k").agg(fns.avg("v").alias("a"))._plan,
            "shape": scan.groupBy("k").agg(fns.sum("v").alias("s"))
            .filter(fns.col("s") > 0)._plan,
            "mem": sess.createDataFrame([{"k": "a", "v": 1}]).groupBy("k")
            .agg(fns.sum("v").alias("s"))._plan,
            "keyless": dataclasses.replace(
                plan, aggregates=plan.aggregates[1:]),
        }

    mine = {k: inspect_plan(p) for k, p in plans(port, F).items()}
    theirs = {k: ref_inspect(p) for k, p in plans(spark, RF).items()}
    for k in mine:
        assert [c for c, _, _ in mine[k].diagnostics] == \
            [c for c, _, _ in theirs[k].diagnostics], k
        assert (mine[k].registrable, mine[k].incremental, mine[k].kind) == \
            (theirs[k].registrable, theirs[k].incremental, theirs[k].kind)
    assert mine["ok"].diagnostics[0][0] == "PLAN-MVIEW-OK"
    assert mine["ok"].merge_spec.key_names == ("k",)
    assert mine["avg"].diagnostics[0][0] == "PLAN-MVIEW-RECOMPUTE"
    assert mine["shape"].diagnostics[0][0] == "PLAN-MVIEW-SHAPE"
    assert mine["mem"].diagnostics[0][0] == "PLAN-MVIEW-SOURCE"
    assert mine["keyless"].registrable and not mine["keyless"].incremental


def test_registration_rides_on_cache(port, mview_on, tmp_path):
    d = str(tmp_path)
    _base(d)
    df = _sum_df(port, d)
    assert port.mview_manager.views() == []
    df.cache()
    try:
        views = port.mview_manager.views()
        assert len(views) == 1 and views[0]["incremental"]
    finally:
        df.unpersist()
    assert port.mview_manager.views() == []


def test_disabled_means_no_views(port, tmp_path):
    d = str(tmp_path)
    _base(d)
    df = _sum_df(port, d)
    df.cache()
    try:
        assert port.mview_manager.views() == []
    finally:
        df.unpersist()


# ---- freshness --------------------------------------------------------------------


def test_view_refreshes_where_plain_cache_is_stale(port, spark, mview_on,
                                                   tmp_path):
    d = str(tmp_path)
    _base(d)
    df = _sum_df(port, d)
    df.cache()
    try:
        r1 = _rows(df)
        assert r1 == _rows(_sum_df(spark, d, RF))
        _write(d, "delta.parquet", ["k0", "zz"], [1000, 7])
        r2 = _rows(df)
        assert r2 != r1, "the view refreshes after an append"
        assert r2 == _rows(_sum_df(port, d)) == _rows(_sum_df(spark, d, RF))
        view = port.mview_manager.views()[0]
        assert (view["refreshes"], view["incremental_merges"],
                view["full_recomputes"]) == (1, 1, 0)
        assert _rows(df) == r2  # unchanged source: a fresh hit
        assert port.mview_manager.views()[0]["refreshes"] == 1
    finally:
        df.unpersist()


def test_rewrite_forces_full_recompute(port, spark, mview_on, tmp_path):
    d = str(tmp_path)
    _base(d)
    df = _sum_df(port, d)
    df.cache()
    try:
        _rows(df)
        _base(d)  # a rewrite: a merge would count twice
        os.utime(os.path.join(d, "base.parquet"))
        _write(d, "extra.parquet", ["k1"], [5])
        assert _rows(df) == _rows(_sum_df(spark, d, RF))
        view = port.mview_manager.views()[0]
        assert (view["full_recomputes"], view["incremental_merges"]) == \
            (1, 0)
    finally:
        df.unpersist()


def test_eviction_then_refresh_recovers(port, spark, mview_on, tmp_path):
    d = str(tmp_path)
    _base(d)
    df = _sum_df(port, d)
    df.cache()
    try:
        r1 = _rows(df)
        with port.memory_manager.lock:
            port.memory_store._evict_locked(1 << 62, floor=0,
                                            reason="execution")
        assert _rows(df) == r1  # materializes again, not an error
        _write(d, "post.parquet", ["k2"], [11])
        assert _rows(df) == _rows(_sum_df(spark, d, RF))
    finally:
        df.unpersist()


# ---- the same bytes: incremental on/off x ranks x data shape ------------------


class _FakeSession:
    def __init__(self, conf):
        self.conf = conf
        self.device = "cpu"


def _sweep(port, root, ranks, incremental, agg_fn, steps,
           key_type=pa.string()):
    """One (ranks, incremental) configuration: the same base and appends
    in a private directory through a standalone CacheManager and
    ViewManager pair over a CPU mesh; the IPC bytes after each step and
    the view."""
    from spark_tpu_torch.api.session import CacheManager
    from spark_tpu_torch.mview.manager import ViewManager
    from spark_tpu_torch.parallel.executor import MeshExecutor
    from spark_tpu_torch.parallel.mesh import make_mesh
    from spark_tpu_torch.storage import MemoryStore, UnifiedMemoryManager

    d = os.path.join(root, f"r{ranks}_{'on' if incremental else 'off'}")
    os.makedirs(d)
    _base(d, key_type)
    conf = CF.RuntimeConf({"spark.tpu.mview.enabled": True,
                           "spark.tpu.mview.incremental": incremental})
    ex = MeshExecutor(make_mesh(ranks, devices=["cpu"] * ranks), conf=conf)
    cm = CacheManager(store=MemoryStore(
        UnifiedMemoryManager(budget_bytes=1 << 30)))
    mgr = ViewManager(_FakeSession(conf))
    cm._mview = mgr
    plan = agg_fn(port.read.parquet(d))._plan
    cm.add(plan)

    def run(p):
        return ex.execute_logical(p)

    def step():
        return table_to_ipc(to_arrow(cm.apply(plan, run).batch))

    out = [step()]
    for i, (ks, vs) in enumerate(steps):
        _write(d, f"app{i}.parquet", ks, vs, key_type)
        out.append(step())
    return out, mgr.view_for(plan.structural_key())


UNIFORM = [([f"k{i % 13}" for i in range(50)], list(range(50))),
           ([f"k{i % 13}" for i in range(60)], list(range(60)))]
#: appends on one hot key and new keys the base never had (the
#: dictionary grows, the merge's capacity moves)
SKEWED = [(["k0"] * 80 + ["new_a", "new_b"], list(range(82))),
          (["k0"] * 70 + ["new_c"], list(range(71)))]


@pytest.mark.parametrize("ranks", [1, 2, 8])
@pytest.mark.parametrize("shape", ["uniform", "skewed"])
def test_byte_identity_on_off_sweep(port, tmp_path, ranks, shape):
    """The incremental path's bytes equal the full recompute's, step by
    step, and the incremental run merged."""
    steps = UNIFORM if shape == "uniform" else SKEWED
    agg = lambda df: df.groupBy("k").agg(  # noqa: E731
        F.sum("v").alias("s"), F.max("v").alias("m"))
    on, view_on = _sweep(port, str(tmp_path), ranks, True, agg, steps)
    off, view_off = _sweep(port, str(tmp_path), ranks, False, agg, steps)
    assert on == off
    assert (view_on.incremental_merges, view_on.full_recomputes) == \
        (len(steps), 0)
    assert (view_off.incremental_merges, view_off.full_recomputes) == \
        (0, len(steps))


@pytest.mark.parametrize("ranks", [1, 2, 8])
def test_byte_identity_integer_keys(port, spark, tmp_path, ranks):
    """Integer group keys; the last step's rows are the reference's
    uncached read of the same files."""
    steps = [([i % 13 for i in range(50)], list(range(50))),
             ([99, 99, 100], [1, 2, 3])]
    agg = lambda df: df.groupBy("k").agg(  # noqa: E731
        F.sum("v").alias("s"), F.min("v").alias("m"))
    on, view_on = _sweep(port, str(tmp_path), ranks, True, agg, steps,
                         key_type=pa.int64())
    off, _ = _sweep(port, str(tmp_path), ranks, False, agg, steps,
                    key_type=pa.int64())
    assert on == off
    assert view_on.incremental_merges == len(steps)
    from spark_tpu_torch.serve.result_cache import ipc_to_table

    got = sorted(zip(*ipc_to_table(on[-1]).to_pydict().values()))
    d = os.path.join(str(tmp_path), f"r{ranks}_on")
    want = _rows(spark.read.parquet(d).groupBy("k").agg(
        RF.sum("v").alias("s"), RF.min("v").alias("m")))
    assert got == want


# ---- plans that cannot merge fall back ---------------------------------------


def test_nonmergeable_avg_falls_back(port, spark, mview_on, tmp_path):
    d = str(tmp_path)
    _base(d)
    df = port.read.parquet(d).groupBy("k").agg(F.avg("v").alias("a"))
    df.cache()
    try:
        views = port.mview_manager.views()
        assert len(views) == 1 and not views[0]["incremental"]
        _rows(df)
        _write(d, "delta.parquet", ["k0"], [12345])
        assert _rows(df) == _rows(spark.read.parquet(d).groupBy("k")
                                  .agg(RF.avg("v").alias("a")))
        view = port.mview_manager.views()[0]
        assert (view["full_recomputes"], view["incremental_merges"]) == \
            (1, 0)
    finally:
        df.unpersist()


def test_float_sum_falls_back(port, mview_on, tmp_path):
    d = str(tmp_path)
    pq.write_table(pa.table({"k": pa.array(["a", "b", "a"]),
                             "v": pa.array([1.5, 2.5, 3.5], pa.float64())}),
                   os.path.join(d, "f0.parquet"))
    df = _sum_df(port, d)
    df.cache()
    try:
        views = port.mview_manager.views()
        assert len(views) == 1 and not views[0]["incremental"]
    finally:
        df.unpersist()


# ---- fault matrix: mview.refresh ----------------------------------------------


@pytest.mark.parametrize("kind", ["transient", "hang", "oom", "corrupt"])
def test_refresh_fault_matrix(port, spark, mview_on, tmp_path, kind):
    """One fault at the refresh seam: transient kinds retry and the merge
    lands; the others fall back to a full recompute; the rows are right
    either way."""
    d = str(tmp_path)
    _base(d)
    df = _sum_df(port, d)
    df.cache()
    try:
        _rows(df)
        port.conf.set("spark.tpu.faultInjection.hangSeconds", 0.02)
        port.conf.set("spark.tpu.faultInjection.mview.refresh",
                      f"nth:1:{kind}")
        faults.reset(port.conf)
        metrics.reset_mview()
        _write(d, "delta.parquet", ["k0", "zz"], [1000, 7])
        assert _rows(df) == _rows(_sum_df(spark, d, RF))
        assert faults.fire_count(port.conf, "mview.refresh") == 1
        st = metrics.mview_stats()
        view = port.mview_manager.views()[0]
        if kind in ("transient", "hang"):
            assert (st["refresh_retries"], st["refresh_fallbacks"]) == (1, 0)
            assert view["incremental_merges"] == 1
        else:
            assert (st["refresh_retries"], st["refresh_fallbacks"]) == (0, 1)
            assert view["full_recomputes"] == 1
    finally:
        df.unpersist()


def test_refresh_retry_exhaustion_falls_back(port, spark, mview_on,
                                             tmp_path):
    d = str(tmp_path)
    _base(d)
    df = _sum_df(port, d)
    df.cache()
    try:
        _rows(df)
        port.conf.set("spark.tpu.mview.refreshRetries", 2)
        port.conf.set("spark.tpu.faultInjection.mview.refresh",
                      "prob:1.0:7:transient")
        faults.reset(port.conf)
        metrics.reset_mview()
        _write(d, "delta.parquet", ["k1"], [55])
        assert _rows(df) == _rows(_sum_df(spark, d, RF))
        assert faults.fire_count(port.conf, "mview.refresh") == 3
        st = metrics.mview_stats()
        assert (st["refresh_retries"], st["refresh_fallbacks"]) == (2, 1)
        assert port.mview_manager.views()[0]["full_recomputes"] == 1
    finally:
        df.unpersist()


# ---- stream views ---------------------------------------------------------------


def _stream_setup(sess, tmp_path, name, stream_cls):
    src = stream_cls(pa.schema([("k", pa.string()), ("v", pa.int64())]))
    fns = F if stream_cls.__module__.startswith("spark_tpu_torch") else RF
    agg = sess.readStream.load(src).groupBy("k").agg(
        fns.sum("v").alias("s"))
    q = agg.writeStream.outputMode("complete").queryName(name) \
        .option("checkpointLocation", str(tmp_path / name)).start()
    return src, agg, q


def test_stream_view_merges_micro_batches(port, spark, tmp_path):
    from spark_tpu.streaming import MemoryStream as RefStream
    from spark_tpu_torch.streaming import MemoryStream

    out = []
    for sess, cls in ((port, MemoryStream), (spark, RefStream)):
        src, agg, q = _stream_setup(sess, tmp_path, f"mvs1_{len(out)}", cls)
        mgr = sess.mview_manager
        mgr.register_stream_view("sv1", agg._plan, q.name)
        try:
            src.add_data([{"k": "a", "v": 1}, {"k": "b", "v": 2}])
            q.process_all_available()
            src.add_data([{"k": "a", "v": 10}])
            q.process_all_available()
            out.append(_rows(mgr.read("sv1")))
            assert mgr.stream_view("sv1").incremental_merges == 2
        finally:
            q.stop()
            mgr.drop_stream_view("sv1")
    assert out[0] == out[1] == [("a", 11), ("b", 2)]


def test_stream_view_replay_never_double_merges(port, mview_on, tmp_path):
    """A crash at the commit seam after the view merged the batch: the
    WAL replay delivers the same batch id, which the view drops."""
    from spark_tpu_torch.streaming import MemoryStream

    src, agg, q = _stream_setup(port, tmp_path, "mvs2", MemoryStream)
    mgr = port.mview_manager
    mgr.register_stream_view("sv2", agg._plan, "mvs2")
    try:
        src.add_data([{"k": "a", "v": 5}])
        q.process_all_available()
        port.conf.set("spark.tpu.faultInjection.streaming.commit",
                      "nth:1:corrupt")
        faults.reset(port.conf)
        src.add_data([{"k": "a", "v": 7}, {"k": "b", "v": 1}])
        with pytest.raises(faults.InjectedCorruptionError):
            q.process_all_available()
        q.stop()
        port.conf.unset("spark.tpu.faultInjection.streaming.commit")
        assert _rows(mgr.read("sv2")) == [("a", 12), ("b", 1)]
        dedups0 = metrics.mview_stats()["stream_dedups"]
        q2 = agg.writeStream.outputMode("complete").queryName("mvs2") \
            .option("checkpointLocation", str(tmp_path / "mvs2")).start()
        q2.process_all_available()  # the WAL replay of the same batch
        q2.stop()
        assert metrics.mview_stats()["stream_dedups"] == dedups0 + 1
        assert _rows(mgr.read("sv2")) == [("a", 12), ("b", 1)]
        assert _rows(port.table("mvs2")) == [("a", 12), ("b", 1)]
    finally:
        mgr.drop_stream_view("sv2")


def test_stream_view_rejects_nonmergeable(port):
    from spark_tpu_torch.streaming import MemoryStream

    src = MemoryStream(pa.schema([("k", pa.string()), ("v", pa.int64())]))
    agg = port.readStream.load(src).groupBy("k").agg(F.avg("v").alias("a"))
    with pytest.raises(ValueError):
        port.mview_manager.register_stream_view("bad", agg._plan, "x")


# ---- the store's in-place update --------------------------------------------------


class _FakeBatch:
    def __init__(self, n):
        self._n = n

    def device_nbytes(self):
        return self._n


def _store(budget):
    from spark_tpu_torch.storage import MemoryStore, UnifiedMemoryManager

    return MemoryStore(UnifiedMemoryManager(budget_bytes=budget))


def test_memory_store_update_accounting(monkeypatch):
    from spark_tpu_torch.storage import store as store_mod

    monkeypatch.setattr(store_mod, "batch_nbytes", lambda b: b._n)
    store = _store(1 << 30)
    assert store.put("v", _FakeBatch(1000))
    assert store.bytes_used() == 1000
    assert store.update("v", _FakeBatch(1500))
    assert store.bytes_used() == 1500
    assert store.update("v", _FakeBatch(300))
    assert store.bytes_used() == 300
    assert store.get("v").device_nbytes() == 300
    assert store.update("w", _FakeBatch(100))  # absent: a put
    assert store.bytes_used() == 400


def test_memory_store_update_rejects_oversize_and_drops_stale(monkeypatch):
    from spark_tpu_torch.storage import store as store_mod

    monkeypatch.setattr(store_mod, "batch_nbytes", lambda b: b._n)
    store = _store(10_000)
    assert store.put("v", _FakeBatch(1000))
    assert not store.update("v", _FakeBatch(10**9))
    assert store.get("v") is None  # stale bytes are worse than a recompute
    assert store.bytes_used() == 0


# ---- the serve tier --------------------------------------------------------------


def test_serve_cache_repopulated_after_refresh(port, mview_on, tmp_path):
    from spark_tpu_torch.serve import result_cache as rc

    d = str(tmp_path)
    _base(d)
    port.conf.set("spark.tpu.serve.resultCache.enabled", True)
    port.serve_result_cache = rc.ResultCache(port.conf)
    df = _sum_df(port, d)
    df.cache()
    try:
        _rows(df)
        _write(d, "delta.parquet", ["k3", "q"], [42, 9])
        expected = df.toArrow()
        blob = port.serve_result_cache.lookup(rc.plan_result_key(df._plan))
        assert blob is not None, "the refresh pre-warms the serve cache"
        assert blob == rc.table_to_ipc(expected)
        assert metrics.mview_stats()["serve_repopulations"] >= 1
    finally:
        df.unpersist()
        port.serve_result_cache = None


# ---- diagnostics, settings, observability ---------------------------------------


def test_plan_mview_diagnostics_via_analyze(port, spark, tmp_path):
    from spark_tpu.analysis import analyze as ref_analyze
    from spark_tpu_torch.analysis import analyze

    d = str(tmp_path)
    _base(d)

    def codes(report):
        return sorted(c for c in report.codes() if c.startswith("PLAN-MVIEW"))

    ok = analyze(_sum_df(port, d)._plan, port.conf)
    assert codes(ok) == ["PLAN-MVIEW-OK"] == codes(
        ref_analyze(_sum_df(spark, d, RF)._plan, spark.conf))
    rec = analyze(port.read.parquet(d).groupBy("k")
                  .agg(F.avg("v").alias("a"))._plan, port.conf)
    assert codes(rec) == ["PLAN-MVIEW-RECOMPUTE"] == codes(ref_analyze(
        spark.read.parquet(d).groupBy("k").agg(RF.avg("v").alias("a"))
        ._plan, spark.conf))


def test_conf_keys_registered():
    from spark_tpu import conf as RC

    for name in ("MVIEW_ENABLED", "MVIEW_INCREMENTAL",
                 "MVIEW_REFRESH_RETRIES", "MVIEW_SERVE_REPOPULATE"):
        mine, theirs = getattr(CF, name), getattr(RC, name)
        assert (mine.key, mine.default) == (theirs.key, theirs.default)
    assert CF.MVIEW_ENABLED.key == "spark.tpu.mview.enabled"
    assert CF.MVIEW_ENABLED.default is False
    assert CF.MVIEW_REFRESH_RETRIES.default == 2
    assert "mview.refresh" in faults.WIRED_POINTS


def test_mview_profile_renders(port, mview_on, tmp_path):
    from spark_tpu_torch import tracing

    d = str(tmp_path)
    _base(d)
    df = _sum_df(port, d)
    df.cache()
    try:
        _rows(df)
        _write(d, "delta.parquet", ["k5"], [3])
        _rows(df)
        assert "incremental" in tracing.format_mview_profile()
        assert tracing.mview_profile()["totals"]["incremental_merges"] >= 1
    finally:
        df.unpersist()
