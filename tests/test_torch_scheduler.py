"""The port's query scheduler (``spark_tpu_torch/scheduler/``) on the cases
of tests/test_scheduler.py: pools from the settings, FIFO and FAIR
orders, the admission budget, the bounded queue and 429 with
Retry-After, cancel and deadlines, the ``scheduler.admit`` fault cells,
and concurrent clients through the connect server.

Held against the reference: ``estimate_plan_bytes`` of the same SQL over
the same small TPC-H tables (no query runs), and the pools' fair ranks
after the same pool settings. Held against the port itself: served rows
equal the session's own ``toArrow()`` bit for bit, and each worker keeps
its ticket's run records and trace.
"""

import json
import threading
import time

import pyarrow as pa
import pytest

from spark_tpu.scheduler import build_pools as ref_build_pools
from spark_tpu.scheduler import estimate_plan_bytes as ref_estimate
from spark_tpu.tpch.gen import generate_tables as ref_tables
from spark_tpu.tpch.gen import register_views as ref_register
from spark_tpu.tpch.queries import QUERIES as REF_QUERIES
from spark_tpu_torch import faults, locks, metrics, tracing, trace
from spark_tpu_torch.api.session import SparkSession
from spark_tpu_torch.conf import RuntimeConf
from spark_tpu_torch.connect.server import Client, ConnectServer
from spark_tpu_torch.scheduler import (AdmissionController, QueryCancelled,
                                       QueryScheduler, SchedulerQueueFull,
                                       admission, build_pools,
                                       estimate_plan_bytes)
from spark_tpu_torch.serve.result_cache import table_to_ipc
from spark_tpu_torch.storage import MemoryStore, pin_scope
from spark_tpu_torch.tpch import QUERIES, generate_tables, register_views

from test_torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.timeout(90)

SF = 0.01


class FakeBatch:
    """A store payload of an exact byte size."""

    def __init__(self, nbytes: int):
        self._n = int(nbytes)

    def device_nbytes(self) -> int:
        return self._n


def make_scheduler(**overrides):
    return QueryScheduler(conf=RuntimeConf(overrides))


@pytest.fixture(scope="module")
def port():
    s = SparkSession(device="cpu")
    register_views(s, generate_tables(SF, seed=99))
    return s


# ---- pools and policy ------------------------------------------------------


def test_pools_from_conf_match_reference():
    from spark_tpu.conf import RuntimeConf as RefConf

    settings = {"spark.tpu.scheduler.pool.etl.weight": 2,
                "spark.tpu.scheduler.pool.etl.minShare": 1,
                "spark.tpu.scheduler.pool.adhoc.weight": 1}
    mine, theirs = build_pools(RuntimeConf(settings)), \
        ref_build_pools(RefConf(settings))
    assert mine["etl"].weight == 2 and mine["etl"].min_share == 1
    assert mine["adhoc"].weight == 1 and "default" in mine
    assert sorted(mine) == sorted(theirs)
    for name in mine:
        for p in (mine[name], theirs[name]):
            p.device_ms, p.device_running = 12.5, 0
        assert mine[name].fair_rank() == theirs[name].fair_rank()
        assert mine[name].snapshot() == theirs[name].snapshot()


def test_bad_mode_rejected():
    with pytest.raises(ValueError, match="FIFO or FAIR"):
        make_scheduler(**{"spark.scheduler.mode": "LOTTERY"})


def test_fifo_lifecycle_and_metrics():
    sched = make_scheduler()
    try:
        t = sched.submit(lambda tk: 41 + 1, description="answer")
        assert t.result(timeout=30) == 42
        assert t.state == "FINISHED"
        info = t.info()
        assert info["pool"] == "default" and info["queue_wait_ms"] >= 0.0
        assert any(q["id"] == t.id for q in sched.describe())
        assert sched.ticket(t.id) is t
        st = sched.status()
        assert st["mode"] == "FIFO" and st["queued"] == 0
        assert st["admission"]["in_use_bytes"] == 0
    finally:
        sched.stop()


def _blocked(sched):
    """A running ticket that holds the only worker until released."""
    release = threading.Event()
    blocker = sched.submit(lambda tk: release.wait(30))
    deadline = time.time() + 30
    while blocker.state != "RUNNING" and time.time() < deadline:
        time.sleep(0.005)
    return blocker, release


@pytest.mark.parametrize("mode", ["FIFO", "FAIR"])
def test_pick_order(mode):
    """One worker: FIFO runs tickets in submit order; FAIR alternates
    the pools by device time over weight (weight 2 gets two turns to
    weight 1's one)."""
    sched = make_scheduler(**{
        "spark.scheduler.mode": mode,
        "spark.tpu.scheduler.maxConcurrency": 1,
        "spark.tpu.scheduler.pool.a.weight": 2,
        "spark.tpu.scheduler.pool.b.weight": 1})
    order = []
    try:
        blocker, release = _blocked(sched)

        def work(tag):
            def run(tk):
                order.append(tag)
                time.sleep(0.01)
            return run

        tickets = [sched.submit(work(f"a{i}"), pool="a") for i in range(3)]
        tickets += [sched.submit(work(f"b{i}"), pool="b") for i in range(3)]
        release.set()
        for t in [blocker] + tickets:
            t.result(timeout=30)
    finally:
        release.set()
        sched.stop()
    if mode == "FIFO":
        assert order == ["a0", "a1", "a2", "b0", "b1", "b2"]
    else:
        assert order[0] in ("a0", "b0")
        assert order.index("b0") < order.index("a2")  # pools interleave
        assert [x for x in order if x[0] == "a"] == ["a0", "a1", "a2"]


def test_fair_weight_ratio_under_contention():
    """FAIR pools with weights 2:1 split device time about 2:1 under
    contention, measured between two snapshots past the start."""
    sched = make_scheduler(**{
        "spark.scheduler.mode": "FAIR",
        "spark.tpu.scheduler.pool.a.weight": 2,
        "spark.tpu.scheduler.pool.b.weight": 1,
        "spark.tpu.scheduler.hbmBudgetBytes": 1024,  # one at a time
        "spark.tpu.scheduler.maxConcurrency": 4,
        "spark.tpu.scheduler.queueDepth": 200})
    try:
        for _ in range(40):
            sched.submit(lambda tk: time.sleep(0.008), pool="a")
            sched.submit(lambda tk: time.sleep(0.008), pool="b")

        def finished():
            return (sched.pools.get("a").finished
                    + sched.pools.get("b").finished)

        def device_ms():
            return (sched.pools.get("a").device_ms,
                    sched.pools.get("b").device_ms)

        deadline = time.time() + 60
        while finished() < 8 and time.time() < deadline:
            time.sleep(0.005)
        a0, b0 = device_ms()
        while finished() < 40 and time.time() < deadline:
            time.sleep(0.005)
        a1, b1 = device_ms()
        assert finished() >= 40, "scheduler made no progress"
        ratio = (a1 - a0) / max(1e-9, (b1 - b0))
        assert 1.5 <= ratio <= 2.67, f"device-time split {ratio:.2f}:1"
    finally:
        sched.stop()


# ---- admission -------------------------------------------------------------


def test_admission_controller_budget():
    ac = AdmissionController(4096)
    assert ac.fits(2048)
    c1 = ac.acquire(2048)
    assert ac.fits(2048)
    c2 = ac.acquire(2048)
    assert not ac.fits(1)
    ac.release(c1)
    ac.release(c2)
    # an over-budget query admits alone, charged the whole budget
    assert ac.fits(1 << 40)
    c3 = ac.acquire(1 << 40)
    assert c3 == 4096 and not ac.fits(64)
    ac.release(c3)
    assert ac.snapshot()["in_use_bytes"] == 0


@pytest.fixture(scope="module")
def ref_tpch(spark):
    ref_register(spark, ref_tables(SF, seed=99))
    return spark


@pytest.mark.parametrize("qnum", [1, 3, 5, 6, 10, 18])
def test_estimate_plan_bytes_matches_reference(port, ref_tpch, qnum):
    mine = estimate_plan_bytes(port.sql(QUERIES[qnum])._plan, port.conf)
    theirs = ref_estimate(ref_tpch.sql(REF_QUERIES[qnum])._plan,
                          ref_tpch.conf)
    assert mine == theirs and mine >= admission.MIN_ESTIMATE_BYTES


def test_estimate_plan_bytes_scales_with_rows(port):
    small = estimate_plan_bytes(port.createDataFrame(
        [{"k": i % 3, "v": i} for i in range(64)])._plan, port.conf)
    big = estimate_plan_bytes(port.range(1 << 20)._plan, port.conf)
    assert small == admission.MIN_ESTIMATE_BYTES
    assert big >= 8 * (1 << 20)


def test_measured_bytes_preferred_and_bounded():
    class Plan:
        def __init__(self, key):
            self.key = key

        def structural_key(self):
            return ("t", self.key)

    p = Plan(1)
    admission.note_measured_bytes(p, 5 << 20)
    admission.note_measured_bytes(p, 3 << 20)  # keeps the larger
    assert admission.measured_plan_bytes(p) == 5 << 20
    assert estimate_plan_bytes(p, RuntimeConf()) == 5 << 20
    assert admission.seeded_build_bytes(p, 1) == 5 << 20
    assert admission.seeded_build_bytes(Plan(2), 10) \
        == admission.MIN_ESTIMATE_BYTES
    for i in range(admission._MEASURED_MAX_ENTRIES + 5):
        admission.note_measured_bytes(Plan(("fill", i)), 1)
    assert admission.measured_plan_bytes(p) is None  # aged out, LRU
    assert admission.measured_snapshot()["plans"] \
        == admission._MEASURED_MAX_ENTRIES


def test_admission_gates_device_concurrency():
    """Budget for exactly two footprints: a third waits at the gate."""
    sched = make_scheduler(**{"spark.tpu.scheduler.hbmBudgetBytes": 4096,
                              "spark.tpu.scheduler.maxConcurrency": 4})
    try:
        lock = threading.Lock()
        state = {"now": 0, "peak": 0}

        def work(tk):
            with lock:
                state["now"] += 1
                state["peak"] = max(state["peak"], state["now"])
            time.sleep(0.05)
            with lock:
                state["now"] -= 1

        for t in [sched.submit(work, est_bytes=2048) for _ in range(4)]:
            t.result(timeout=30)
        assert state["peak"] == 2
    finally:
        sched.stop()


def test_session_scheduler_share_manager(port):
    sched = QueryScheduler(port)
    try:
        assert sched.admission.manager is port.memory_manager
    finally:
        sched.stop()


def test_session_stop_stops_its_scheduler():
    s = SparkSession(device="cpu")
    srv = ConnectServer(s, port=0).start()
    sched = srv.scheduler
    assert s.query_scheduler is sched
    s.stop()
    assert s.query_scheduler is None
    with pytest.raises(RuntimeError, match="stopped"):
        sched.submit(lambda tk: 1)
    srv._httpd.shutdown()
    srv._httpd.server_close()


def test_eviction_racing_admission_through_the_scheduler():
    """Tickets churn storage puts and pinned gets while the scheduler
    admits and releases grants on the same unified budget; a sampler
    checks storage plus execution never exceeds it."""
    sched = QueryScheduler(conf=RuntimeConf({
        "spark.tpu.scheduler.hbmBudgetBytes": 10_000,
        "spark.tpu.storage.minBytes": 1_000,
        "spark.tpu.storage.maxBytes": 8_000,
        "spark.tpu.scheduler.maxConcurrency": 8,
        "spark.tpu.scheduler.queueDepth": 256}))
    m = sched.admission.manager
    store = MemoryStore(m)
    stop = threading.Event()
    violations = []

    def sampler():
        while not stop.is_set():
            snap = m.snapshot()
            if snap["in_use_bytes"] + snap["storage_bytes"] \
                    > snap["budget_bytes"]:
                violations.append(snap)
            time.sleep(0.0005)

    sampler_t = threading.Thread(target=sampler, daemon=True)
    sampler_t.start()

    def make_run(i):
        def run(t):
            with pin_scope():
                key = ("hot", i % 6)
                if store.get(key, pin=True) is None:
                    store.put(key, FakeBatch(1500), pin=True)
                time.sleep(0.002)
            return i
        return run

    tickets = [sched.submit(make_run(i), description=f"q{i}",
                            est_bytes=(i % 5 + 1) * 1200)
               for i in range(64)]
    results = [t.result(timeout=30) for t in tickets]
    stop.set()
    sampler_t.join(1)
    sched.stop()
    assert results == list(range(64))
    assert not violations, violations[:3]


# ---- the bounded queue and backpressure ------------------------------------


def test_queue_full_rejects_submit():
    sched = make_scheduler(**{
        "spark.tpu.scheduler.maxConcurrency": 1,
        "spark.tpu.scheduler.queueDepth": 1,
        "spark.tpu.scheduler.retryAfterSeconds": 0.25})
    release = threading.Event()
    try:
        blocker, release = _blocked(sched)
        queued = sched.submit(lambda tk: None)
        with pytest.raises(SchedulerQueueFull) as ei:
            sched.submit(lambda tk: None)
        assert ei.value.retry_after_s == 0.25
        release.set()
        assert blocker.result(timeout=30) is True
        queued.result(timeout=30)
        assert sched.rejected == 1
    finally:
        release.set()
        sched.stop()


def test_server_returns_429_with_retry_after(port):
    port.createDataFrame([{"k": 1, "v": 2}]) \
        .createOrReplaceTempView("sched_429_t")
    sched = QueryScheduler(conf=RuntimeConf({
        "spark.tpu.scheduler.queueDepth": 0,
        "spark.tpu.scheduler.retryAfterSeconds": 0.01}))
    srv = ConnectServer(port, port=0, scheduler=sched).start()
    try:
        with pytest.raises(RuntimeError, match="failed after 1 attempt"):
            Client(srv.url, retries=0).sql("select * from sched_429_t")
        c2 = Client(srv.url, retries=2, backoff_s=0.005)
        t0 = time.time()
        with pytest.raises(RuntimeError, match="failed after 3 attempt"):
            c2.sql("select * from sched_429_t")
        assert time.time() - t0 >= 0.02  # honored the Retry-After floor
    finally:
        srv.stop()


def test_client_retries_flapping_server():
    """The client survives a server that answers 429 twice and drops one
    connection before it serves the result."""
    import io
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    tbl = pa.table({"a": [1, 2, 3]})
    sink = io.BytesIO()
    with pa.ipc.new_stream(sink, tbl.schema) as w:
        w.write_table(tbl)
    arrow_bytes = sink.getvalue()
    attempts = []

    class Flapping(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            attempts.append(self.path)
            n = len(attempts)
            if n <= 2:
                body = json.dumps({"error": "SchedulerQueueFull",
                                   "message": "full",
                                   "retry_after_s": 0.01}).encode()
                self.send_response(429)
                self.send_header("Retry-After", "0.01")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif n == 3:
                self.connection.close()
            else:
                self.send_response(200)
                self.send_header("Content-Type",
                                 "application/vnd.apache.arrow.stream")
                self.send_header("Content-Length", str(len(arrow_bytes)))
                self.end_headers()
                self.wfile.write(arrow_bytes)

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Flapping)
    thr = threading.Thread(target=httpd.serve_forever, daemon=True)
    thr.start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        assert Client(url, retries=4, backoff_s=0.005).sql("select 1") \
            .equals(tbl)
        assert len(attempts) == 4
        attempts.clear()
        with pytest.raises(RuntimeError, match="failed after 2 attempt"):
            Client(url, retries=1, backoff_s=0.005).sql("select 1")
    finally:
        httpd.shutdown()
        httpd.server_close()


# ---- cancellation and deadlines --------------------------------------------


def test_cancel_mid_queue():
    sched = make_scheduler(**{"spark.tpu.scheduler.maxConcurrency": 1,
                              "spark.tpu.scheduler.queueDepth": 8})
    release = threading.Event()
    try:
        blocker, release = _blocked(sched)
        queued = sched.submit(lambda tk: "never")
        assert queued.state == "QUEUED"
        assert sched.cancel(queued.id) is True
        assert queued.state == "CANCELLED"
        with pytest.raises(QueryCancelled):
            queued.result(timeout=5)
        release.set()
        blocker.result(timeout=30)
    finally:
        release.set()
        sched.stop()


def test_cancel_mid_run():
    sched = make_scheduler()
    try:
        started = threading.Event()

        def work(tk):
            started.set()
            for _ in range(1000):
                tk.check_cancelled()
                time.sleep(0.005)
            return "ran to completion"

        t = sched.submit(work)
        assert started.wait(30)
        assert t.cancel() is True
        with pytest.raises(QueryCancelled):
            t.result(timeout=30)
        assert t.state == "CANCELLED"
    finally:
        sched.stop()


def test_deadline_expires_in_queue():
    sched = make_scheduler(**{"spark.tpu.scheduler.maxConcurrency": 1})
    release = threading.Event()
    try:
        blocker, release = _blocked(sched)
        t = sched.submit(lambda tk: "late", deadline_s=0.05)
        time.sleep(0.1)
        release.set()
        with pytest.raises(QueryCancelled, match="DEADLINE_EXCEEDED"):
            t.result(timeout=30)
        blocker.result(timeout=30)
    finally:
        release.set()
        sched.stop()


# ---- the scheduler.admit fault point ---------------------------------------


def test_admit_fault_transient_recovers():
    conf = RuntimeConf({"spark.tpu.faultInjection.scheduler.admit": "nth:1"})
    sched = QueryScheduler(conf=conf)
    try:
        metrics.reset()
        assert sched.submit(lambda tk: "ok").result(timeout=30) == "ok"
        assert faults.fire_count(conf, "scheduler.admit") == 1
        evs = metrics.recent(512)
        assert any(e["kind"] == "fault_injected" for e in evs)
        assert any(e["kind"] == "fault_recovered"
                   and e.get("point") == "scheduler.admit" for e in evs)
    finally:
        sched.stop()


def test_admit_fault_oom_degrades_estimate():
    conf = RuntimeConf(
        {"spark.tpu.faultInjection.scheduler.admit": "nth:1:oom"})
    sched = QueryScheduler(conf=conf)
    try:
        t = sched.submit(lambda tk: "ok", est_bytes=1 << 22)
        assert t.result(timeout=30) == "ok"
        assert t.est_bytes == 1 << 21
        degr = [e for e in metrics.recent(512)
                if e.get("kind") == "scheduler"
                and e.get("phase") == "admit_degraded"]
        assert degr and degr[-1]["est_bytes"] == 1 << 21
    finally:
        sched.stop()


def test_admit_fault_corrupt_fails_typed():
    conf = RuntimeConf(
        {"spark.tpu.faultInjection.scheduler.admit": "nth:1:corrupt"})
    sched = QueryScheduler(conf=conf)
    try:
        t = sched.submit(lambda tk: "ok")
        with pytest.raises(faults.InjectedCorruptionError):
            t.result(timeout=30)
        assert t.state == "FAILED"
    finally:
        sched.stop()


# ---- serving: rows, traces, run records ------------------------------------


STRESS_QUERIES = (
    "select k, sum(v) as s, count(*) as n from st_a group by k order by k",
    "select a.k, a.v, b.w from st_a a join st_b b on a.k = b.k "
    "order by a.v limit 20",
    "select k, v from st_a where v > 10 order by v",
    "select max(v) as mx, min(v) as mn, avg(v) as av from st_a",
)


def test_concurrent_results_byte_identical_to_direct(port):
    """8 concurrent clients through the connect server get the session's
    own ``toArrow()`` bytes for every query."""
    port.createDataFrame([{"k": i % 5, "v": i} for i in range(200)]) \
        .createOrReplaceTempView("st_a")
    port.createDataFrame([{"k": i, "w": i * 7} for i in range(5)]) \
        .createOrReplaceTempView("st_b")
    direct = {q: table_to_ipc(port.sql(q).toArrow()) for q in STRESS_QUERIES}
    srv = ConnectServer(port, port=0).start()
    try:
        mismatches, errors = [], []

        def client_loop(idx: int):
            c = Client(srv.url, retries=3, backoff_s=0.01)
            for _ in range(2):
                for q in STRESS_QUERIES:
                    try:
                        out = table_to_ipc(c.sql(q))
                    except Exception as e:  # noqa: BLE001
                        errors.append(repr(e))
                        continue
                    if out != direct[q]:
                        mismatches.append((idx, q))

        threads = [threading.Thread(target=client_loop, args=(i,),
                                    daemon=True) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not errors, errors[:3]
        assert not mismatches, mismatches[:3]
        q = Client(srv.url).queries()
        assert q["status"]["pools"]
        assert sum(rec["state"] == "FINISHED" for rec in q["queries"]) \
            >= 8 * 2 * len(STRESS_QUERIES)
    finally:
        srv.stop()


def test_ticket_keeps_its_runs_trace_and_budget(port):
    """A worker re-enters the submitter's trace, deadline and a fresh
    retry budget, and collects the query's run records on its ticket."""
    sched = QueryScheduler(port)
    try:
        with trace.span("connect.client") as ctx:
            t = sched.submit_query(lambda: port.sql(QUERIES[6]),
                                   deadline_s=60.0)
        tbl = t.result(timeout=60)
        assert tbl.equals(port.sql(QUERIES[6]).toArrow())
        assert len(t.runs) == 1 and t.runs[0].stages >= 1
        assert t.retry_budget is not None
        evs = metrics.query_events(ctx.trace_id)
        names = {e.get("name") for e in evs if e["kind"] == "span"}
        assert {"scheduler.run", "scheduler.queue", "query.execute",
                "stage.run"} <= names
        stages = [e for e in evs if e["kind"] == "stage"]
        assert stages and all(e["trace_id"] == ctx.trace_id
                              for e in stages)
    finally:
        sched.stop()


def test_worker_runs_with_no_lock_order_violation(port):
    locks.reset_observations()
    locks.set_validation(True)
    sched = QueryScheduler(port)
    try:
        tickets = [sched.submit_query(lambda q=q: port.sql(QUERIES[q]))
                   for q in (1, 3, 6) for _ in range(2)]
        for t in tickets:
            t.result(timeout=60)
        report = locks.order_report()
        assert not report["violations"], report["violations"][:3]
        assert not report["cycles"]
    finally:
        sched.stop()
        locks.set_validation(False)
        locks.reset_observations()


# ---- observability ---------------------------------------------------------


def test_scheduler_profile_rollup():
    sched = make_scheduler()
    try:
        sched.submit(lambda tk: 1, pool="default").result(timeout=30)
        prof = tracing.scheduler_profile()
        assert prof.get("default", {}).get("finished", 0) >= 1
        assert "default" in tracing.format_scheduler_profile(prof)
    finally:
        sched.stop()


def test_health_and_ui_report_scheduler(port):
    import urllib.request

    from spark_tpu_torch import ui as UI

    srv = ConnectServer(port, port=0).start()
    ui_srv = UI.StatusServer(port, port=0)
    try:
        h = Client(srv.url).health()
        assert h["scheduler"]["queue_depth"] >= 0
        assert any(p["name"] == "default" for p in h["scheduler"]["pools"])
        with urllib.request.urlopen(f"{ui_srv.url}/api/v1/status",
                                    timeout=10) as resp:
            status = json.loads(resp.read())
        assert status["scheduler"] is not None
        assert "queued" in status["scheduler"]
        with urllib.request.urlopen(ui_srv.url + "/", timeout=10) as resp:
            html = resp.read().decode()
        assert "Scheduler" in html and "pool default" in html
    finally:
        ui_srv.stop()
        srv.stop()


def test_deadlock_guard_marker_registered(request):
    assert request.node.get_closest_marker("timeout") is not None


def test_concurrent_guarded_runs_equal_first_runs(port):
    """Queries whose statistics are bound run traced on several workers
    at once, each under the host-traffic guard (what a capture demands
    on the card: no host sync, no tensor from host data inside a stage),
    and give their first runs' bytes."""
    from spark_tpu_torch.physical import graphs

    names = (1, 3, 5, 6)
    first = {q: table_to_ipc(port.sql(QUERIES[q]).toArrow()) for q in names}
    sched = QueryScheduler(conf=RuntimeConf(
        {"spark.tpu.scheduler.maxConcurrency": 4}))

    def guarded(q):
        def run(t):
            with graphs.guarding_stages():
                return table_to_ipc(port.sql(QUERIES[q]).toArrow())
        return run

    try:
        tickets = [(q, sched.submit(guarded(q))) for q in names * 3]
        for q, t in tickets:
            assert t.result(timeout=120) == first[q], q
            assert [r.first_run for r in t.runs] == [False], q
    finally:
        sched.stop()


def test_capture_call_log_is_the_capturing_threads():
    """A capture logs its kernel-wrapper calls into its own list; a
    launch another thread makes meanwhile goes to ``call_log``."""
    import torch

    from spark_tpu_torch.ops import seg_agg

    mine, theirs = [], []
    inside, done = threading.Event(), threading.Event()

    def capturing():
        with seg_agg.logging_calls_into(mine):
            inside.set()
            done.wait(10)
            seg_agg._log("seg_sum", torch.zeros(1), seg=None)

    prev, seg_agg.call_log = seg_agg.call_log, theirs
    try:
        th = threading.Thread(target=capturing)
        th.start()
        assert inside.wait(10)
        seg_agg._log("seg_minmax", torch.zeros(1), seg=None)
        done.set()
        th.join(10)
    finally:
        seg_agg.call_log = prev
    assert [c[0] for c in mine] == ["seg_sum"]
    assert [c[0] for c in theirs] == ["seg_minmax"]
