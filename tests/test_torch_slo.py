"""The port's SLO tier (``spark_tpu_torch/slo/``) on the cases of
tests/test_slo.py: the EDF order and feasibility, reject at admission and
its fault points, the latency model and its journal, the predictive
brownout and auto-sized concurrency, the on/off byte identity through
the scheduler at 1, 2 and 8 CPU ranks, and the typed reject from client
through router to replica.

Held against the reference on numpy-seeded inputs: ``edf_key``,
``pick_edf``, ``feasible`` and ``backlog_ms`` on the same tickets, and
``LatencyModel`` predictions after the same observation sequence, with
each package reading the other's journal.
"""

import json
import threading
import time

import numpy as np
import pyarrow as pa
import pytest

from spark_tpu.slo import LatencyModel as RefModel
from spark_tpu.slo import edf as ref_edf
from spark_tpu_torch import chaos, conf as CF, faults, locks, metrics, trace
from spark_tpu_torch.api.session import SparkSession
from spark_tpu_torch.columnar.arrow import from_arrow
from spark_tpu_torch.conf import RuntimeConf
from spark_tpu_torch.connect.server import Client
from spark_tpu_torch.expr import expressions as E
from spark_tpu_torch.parallel.executor import MeshExecutor
from spark_tpu_torch.parallel.mesh import make_mesh
from spark_tpu_torch.plan import logical as L
from spark_tpu_torch.scheduler import QueryScheduler
from spark_tpu_torch.slo import (InfeasibleDeadline, LatencyModel,
                                 SloController, fingerprint_plan,
                                 fingerprint_sql, model_path_from_conf,
                                 plan_input_rows)
from spark_tpu_torch.slo.edf import backlog_ms, edf_key, feasible, pick_edf

from test_torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.timeout(240)


def make_scheduler(**overrides):
    return QueryScheduler(conf=RuntimeConf(overrides))


def make_slo_scheduler(**overrides):
    overrides.setdefault("spark.tpu.slo.enabled", True)
    return make_scheduler(**overrides)


def _train(sched, fp, run, n=3, **submit_kw):
    """Run ``run`` n times under ``fp`` and wait until the model
    predicts it (the observation lands just after the ticket
    resolves)."""
    for _ in range(n):
        sched.submit(run, slo_fp=fp, **submit_kw).result(30)
    deadline = time.time() + 5.0
    while time.time() < deadline:
        if sched._slo.model.predict_run_ms(fp) is not None:
            return
        time.sleep(0.01)
    raise AssertionError(f"model never learned {fp}")


# ---- registrations ---------------------------------------------------------


def test_slo_registrations():
    for key in ("spark.tpu.slo.enabled", "spark.tpu.slo.targetP99Ms",
                "spark.tpu.slo.rejectEnabled", "spark.tpu.slo.rejectMargin",
                "spark.tpu.slo.model.alpha", "spark.tpu.slo.model.path",
                "spark.tpu.slo.model.maxEntries",
                "spark.tpu.slo.controller.windowSeconds",
                "spark.tpu.slo.controller.minPredictions",
                "spark.tpu.slo.controller.exitRatio",
                "spark.tpu.slo.autoConcurrency.enabled",
                "spark.tpu.slo.autoConcurrency.min"):
        assert CF.is_registered(key), key
    for point in ("slo.predict", "slo.reject"):
        assert point in faults.POINTS and point in faults.WIRED_POINTS
    assert {"slo.admit", "slo.observe"} <= trace.SPAN_NAMES
    assert locks.LOCK_RANKS["slo.model"] > locks.LOCK_RANKS["scheduler.cond"]
    assert locks.LOCK_RANKS["slo.controller"] \
        > locks.LOCK_RANKS["scheduler.cond"]


def test_infeasible_deadline_is_typed_for_chaos():
    e = InfeasibleDeadline(500.0, time.time() + 0.1)
    assert "INFEASIBLE_DEADLINE" in str(e)
    assert chaos.is_typed_error(e)
    try:
        raise RuntimeError("wrapper") from e
    except RuntimeError as outer:
        assert chaos.is_typed_error(outer)


# ---- EDF helpers against the reference -------------------------------------


class _T:
    def __init__(self, tid, deadline):
        self.id = tid
        self.deadline = deadline


def _tickets(seed: int, n: int = 40):
    rng = np.random.default_rng(seed)
    now = 1_800_000_000.0
    dls = rng.uniform(0.0, 30.0, n)
    none = rng.random(n) < 0.3
    ids = rng.permutation(n) + 1
    return [_T(int(i), None if z else now + float(d))
            for i, d, z in zip(ids, dls, none)], now, rng


@pytest.mark.parametrize("seed", [1, 7, 42])
def test_edf_helpers_match_reference(seed):
    tickets, now, rng = _tickets(seed)
    assert [edf_key(t) for t in tickets] \
        == [ref_edf.edf_key(t) for t in tickets]
    assert pick_edf(tickets) is ref_edf.pick_edf(tickets)
    assert sorted(tickets, key=edf_key) \
        == sorted(tickets, key=ref_edf.edf_key)
    for _ in range(20):
        pend = [None if rng.random() < 0.2 else float(x)
                for x in rng.uniform(0, 200, rng.integers(0, 8))]
        infl = [float(x) for x in rng.uniform(0, 200, rng.integers(0, 4))]
        workers = int(rng.integers(1, 5))
        default = float(rng.uniform(1, 100))
        assert backlog_ms(pend, infl, workers, default) \
            == ref_edf.backlog_ms(pend, infl, workers, default)
        dl = None if rng.random() < 0.2 else now + float(rng.uniform(0, 1))
        q, r, m = (float(x) for x in rng.uniform(0, 600, 3))
        assert feasible(dl, q, r, m / 300.0, now=now) \
            == ref_edf.feasible(dl, q, r, m / 300.0, now=now)


def test_edf_key_total_order():
    now = time.time()
    early, late = _T(5, now + 1), _T(1, now + 9)
    none1, none2 = _T(2, None), _T(3, None)
    assert edf_key(early) < edf_key(late) < edf_key(none1) < edf_key(none2)
    assert pick_edf([none2, late, early, none1]) is early
    assert pick_edf([]) is None


def test_feasibility_math():
    ok, pred = feasible(None, 100.0, 50.0)
    assert ok and pred == 150.0
    now = time.time()
    assert feasible(now + 1.0, 100.0, 50.0, now=now)[0]
    ok, pred = feasible(now + 0.1, 100.0, 50.0, now=now)
    assert not ok and pred == 150.0
    assert not feasible(now + 0.2, 100.0, 50.0, margin=2.0, now=now)[0]
    assert backlog_ms([None, 100.0], [], 1, 40.0) == 140.0
    assert backlog_ms([], [100.0], 1, 40.0) == 50.0
    assert backlog_ms([100.0, 100.0], [], 2, 40.0) == 100.0


# ---- EDF against FIFO ------------------------------------------------------


def _ab_completion_order(slo_on):
    sched = make_scheduler(**{"spark.tpu.scheduler.maxConcurrency": 1,
                              "spark.tpu.slo.enabled": slo_on})
    order = []
    gate = threading.Event()
    try:
        blocker = sched.submit(lambda t: gate.wait(20))
        deadline = time.time() + 10.0
        while blocker.state != "RUNNING" and time.time() < deadline:
            time.sleep(0.005)
        assert blocker.state == "RUNNING"
        # submitted in reverse deadline order
        tickets = [sched.submit(lambda t: order.append("late"),
                                deadline_s=60.0),
                   sched.submit(lambda t: order.append("mid"),
                                deadline_s=40.0),
                   sched.submit(lambda t: order.append("early"),
                                deadline_s=20.0)]
        gate.set()
        blocker.result(30)
        for t in tickets:
            t.result(30)
    finally:
        gate.set()
        sched.stop()
    return order


def test_edf_vs_fifo_ab_determinism():
    assert _ab_completion_order(False) == ["late", "mid", "early"]
    assert _ab_completion_order(True) == ["early", "mid", "late"]
    assert _ab_completion_order(True) == ["early", "mid", "late"]


# ---- reject at admission ---------------------------------------------------


def test_reject_at_admission_no_queue_slot():
    sched = make_slo_scheduler()
    fp = fingerprint_sql("SELECT slo_reject_test")
    try:
        _train(sched, fp, lambda t: time.sleep(0.05))
        seq_before = sched._seq
        t0 = time.perf_counter()
        with pytest.raises(InfeasibleDeadline) as ei:
            sched.submit(lambda t: time.sleep(0.05), slo_fp=fp,
                         deadline_s=0.0001)
        assert time.perf_counter() - t0 < 1.0  # shed before it queued
        assert sched._seq == seq_before and sched.queue_depth() == 0
        assert ei.value.predicted_ms > 0
        assert metrics.slo_stats()["rejects"] >= 1
    finally:
        sched.stop()


def test_reject_disabled_admits_doomed_query():
    sched = make_slo_scheduler(**{"spark.tpu.slo.rejectEnabled": False})
    fp = fingerprint_sql("SELECT slo_noreject_test")
    try:
        _train(sched, fp, lambda t: time.sleep(0.05))
        t = sched.submit(lambda t: time.sleep(0.05), slo_fp=fp,
                         deadline_s=0.0001)
        with pytest.raises(Exception) as ei:
            t.result(30)
        assert "DEADLINE_EXCEEDED" in str(ei.value)
    finally:
        sched.stop()


def test_reject_fault_point_fails_open():
    sched = make_slo_scheduler(
        **{"spark.tpu.faultInjection.slo.reject": "nth:1"})
    fp = fingerprint_sql("SELECT slo_failopen_test")
    try:
        _train(sched, fp, lambda t: time.sleep(0.05))
        t = sched.submit(lambda t: None, slo_fp=fp, deadline_s=0.0001)
        with pytest.raises(Exception) as ei:
            t.result(30)
        assert not isinstance(ei.value, InfeasibleDeadline)
        assert "DEADLINE_EXCEEDED" in str(ei.value)
        assert faults.fire_count(sched._conf, "slo.reject") == 1
    finally:
        sched.stop()


def test_predict_fault_point_degrades_to_no_prediction():
    sched = make_slo_scheduler(
        **{"spark.tpu.faultInjection.slo.predict": "prob:1.0:7"})
    fp = fingerprint_sql("SELECT slo_predfault_test")
    try:
        for _ in range(3):
            sched.submit(lambda t: time.sleep(0.01), slo_fp=fp).result(30)
        t = sched.submit(lambda t: None, slo_fp=fp, deadline_s=0.0001)
        with pytest.raises(Exception) as ei:
            t.result(30)
        assert chaos.is_typed_error(ei.value)
        assert not isinstance(ei.value, InfeasibleDeadline)
        assert faults.fire_count(sched._conf, "slo.predict") >= 4
    finally:
        sched.stop()


# ---- typed reject across client, router and replica ------------------------


@pytest.fixture
def slo_fleet():
    from spark_tpu_torch.serve.router import serve_fleet

    s = SparkSession(device="cpu", conf={"spark.tpu.slo.enabled": True,
                                         "spark.tpu.slo.targetP99Ms": 5000})
    fl = serve_fleet(s, replicas=1)
    try:
        yield s, fl
    finally:
        fl.stop()
        metrics.set_brownout(0)
        metrics.reset_slo()


def test_infeasible_deadline_client_router_replica(slo_fleet):
    s, fleet = slo_fleet
    tbl = pa.table({"a": list(range(64)), "b": [float(i) for i in range(64)]})
    s.createDataFrame(tbl).createOrReplaceTempView("slo_e2e")
    c = Client(fleet.url, timeout=30.0, retries=2)
    sql = "SELECT a, b FROM slo_e2e WHERE a >= 8"
    want = s.sql(sql).toArrow()
    for _ in range(3):
        assert c.sql(sql).equals(want)
    lq = c.last_query
    assert lq["sched_policy"] == "EDF" and lq["slo_rejected"] is False
    assert lq["slo_actual_ms"] > 0 and lq["brownout"] in ("0", "1")
    assert c.sql(sql, deadline_s=60).equals(want)
    with pytest.raises(InfeasibleDeadline) as ei:
        c.sql(sql, deadline_s=0.0005)
    assert ei.value.predicted_ms > 0
    assert c.last_query["slo_rejected"] is True
    assert c.last_query["slo_predicted_ms"] == pytest.approx(
        ei.value.predicted_ms, rel=1e-3)
    assert metrics.serve_stats().get("slo_rejects", 0) >= 1
    assert c.last_query["slo_actual_ms"] < 5_000


# ---- the latency model -----------------------------------------------------


def _observations(seed: int, n: int = 60):
    rng = np.random.default_rng(seed)
    fps = [f"sql:{i:024d}" for i in range(6)]
    out = []
    for _ in range(n):
        out.append(dict(
            fp=fps[int(rng.integers(0, len(fps)))],
            run_ms=float(rng.uniform(1, 500)),
            queue_ms=float(rng.uniform(0, 50)),
            rows=float(rng.integers(0, 5000)) or None,
            device_ms=float(rng.uniform(0, 200)) if rng.random() < 0.5
            else 0.0,
            transfer_ms=float(rng.uniform(0, 20)) if rng.random() < 0.3
            else 0.0,
            cold=bool(rng.random() < 0.15)))
    return fps, out


@pytest.mark.parametrize("seed", [3, 11])
def test_model_predictions_match_reference(tmp_path, seed):
    fps, obs = _observations(seed)
    mine = LatencyModel(str(tmp_path / "port.jsonl"), alpha=0.4,
                        max_entries=8)
    theirs = RefModel(str(tmp_path / "ref.jsonl"), alpha=0.4, max_entries=8)
    for o in obs:
        mine.observe(**o)
        theirs.observe(**o)
    for fp in fps + ["sql:never"]:
        for rows in (None, 10.0, 1000.0, 1e9):
            assert mine.predict_run_ms(fp, rows) \
                == theirs.predict_run_ms(fp, rows)
        assert mine.predict_queue_ms(fp) == theirs.predict_queue_ms(fp)
    snap = {k: v for k, v in mine.snapshot().items() if k != "path"}
    assert snap == {k: v for k, v in theirs.snapshot().items()
                    if k != "path"}
    # each package reads the other's journal to the same predictions
    cross_p = LatencyModel(str(tmp_path / "ref.jsonl"), alpha=0.4)
    cross_r = RefModel(str(tmp_path / "port.jsonl"), alpha=0.4)
    for fp in fps:
        assert cross_p.predict_run_ms(fp, 500.0) \
            == theirs.predict_run_ms(fp, 500.0)
        assert cross_r.predict_run_ms(fp, 500.0) \
            == mine.predict_run_ms(fp, 500.0)


def test_model_cold_start_and_persistence_roundtrip(tmp_path):
    path = str(tmp_path / "slo_model.jsonl")
    m1 = LatencyModel(path, alpha=0.5, max_entries=64)
    fp = fingerprint_sql("SELECT persistence_test")
    assert m1.predict_run_ms(fp) is None
    m1.observe(fp, run_ms=100.0, queue_ms=10.0, rows=1000.0)
    m1.observe(fp, run_ms=50.0, queue_ms=20.0, rows=1000.0)
    pred1 = m1.predict_run_ms(fp)
    assert pred1 is not None and 50.0 <= pred1 <= 100.0
    m2 = LatencyModel(path, alpha=0.5, max_entries=64)
    assert m2.predict_run_ms(fp) == pytest.approx(pred1)
    assert m2.predict_queue_ms(fp) == pytest.approx(m1.predict_queue_ms(fp))


def test_model_rowcount_scaling():
    m = LatencyModel("")
    fp = "sql:" + "a" * 24
    for _ in range(4):
        m.observe(fp, run_ms=100.0, rows=1000.0, device_ms=80.0)
    base = m.predict_run_ms(fp, rows=1000.0)
    assert m.predict_run_ms(fp, rows=500.0) < base \
        < m.predict_run_ms(fp, rows=2000.0)
    assert m.predict_run_ms(fp, rows=1e7) <= m.predict_run_ms(fp, rows=1e4)


def test_model_journal_compaction_bound(tmp_path):
    path = str(tmp_path / "compact.jsonl")
    m = LatencyModel(path, max_entries=8)
    for i in range(40):
        m.observe(f"sql:{i:024d}", run_ms=float(i + 1))
    with open(path) as f:
        assert len([ln for ln in f if ln.strip()]) <= 2 * 8
    m2 = LatencyModel(path, max_entries=8)
    assert m2.snapshot()["entries"] <= 8
    assert m2.predict_run_ms("sql:" + f"{39:024d}") is not None


def test_model_path_from_conf(tmp_path):
    from spark_tpu.conf import RuntimeConf as RefConf
    from spark_tpu.slo.model import model_path_from_conf as ref_path

    explicit = str(tmp_path / "explicit.jsonl")
    assert model_path_from_conf(
        RuntimeConf({"spark.tpu.slo.model.path": explicit})) == explicit
    assert model_path_from_conf(RuntimeConf()) == ""
    store = {"spark.tpu.compile.store.dir": str(tmp_path / "store")}
    assert model_path_from_conf(RuntimeConf(store)) == \
        ref_path(RefConf(store)) == str(tmp_path / "store" /
                                        "slo_model.jsonl")


def test_model_tolerates_torn_journal(tmp_path):
    path = str(tmp_path / "torn.jsonl")
    m = LatencyModel(path)
    fp = "sql:" + "b" * 24
    m.observe(fp, run_ms=42.0)
    with open(path, "a") as f:
        f.write('{"fp": "sql:garbage", "run_ms"\n')
    assert LatencyModel(path).predict_run_ms(fp) == pytest.approx(42.0)


def test_model_cold_run_quarantine(tmp_path):
    """A cold run (a CUDA-graph capture in its trace) never moves the
    warm estimate."""
    path = str(tmp_path / "cold.jsonl")
    m = LatencyModel(path, alpha=0.5)
    fp = "sql:" + "c" * 24
    m.observe(fp, run_ms=5000.0, cold=True)
    assert m.predict_run_ms(fp) is None
    m.observe(fp, run_ms=50.0)
    assert m.predict_run_ms(fp) == pytest.approx(50.0)
    for _ in range(4):
        m.observe(fp, run_ms=50.0)
    m.observe(fp, run_ms=7000.0, cold=True)
    assert m.predict_run_ms(fp) == pytest.approx(50.0)
    assert m.snapshot()["cold_observations"] == 2.0
    m2 = LatencyModel(path, alpha=0.5)
    assert m2.predict_run_ms(fp) == pytest.approx(50.0)
    assert m2.snapshot()["cold_observations"] == 2.0


def test_controller_reads_a_capture_as_cold():
    class Ctx:
        trace_id = "cold-trace-0001"

    class Ticket:
        _trace_ctx = Ctx()

    metrics.record("stage_compile", node="n", ms=3.0,
                   trace_id=Ctx.trace_id)
    metrics.record("span", name="stage.device", ms=2.5,
                   trace_id=Ctx.trace_id)
    assert SloController._span_components(Ticket()) == (2.5, 0.0, True)


def test_model_loads_pre_cold_journal_lines(tmp_path):
    path = str(tmp_path / "legacy.jsonl")
    fp = "sql:" + "d" * 24
    with open(path, "w") as f:
        f.write(json.dumps({
            "fp": fp, "host_ms": 5.0, "device_ms": 20.0, "queue_ms": 2.0,
            "transfer_ms": 1.0, "run_ms": 26.0, "rows": 1000.0,
            "n": 3.0}) + "\n")
    m = LatencyModel(path)
    assert m.predict_run_ms(fp) == pytest.approx(26.0)
    assert m.snapshot()["cold_observations"] == 0.0


def test_plan_fingerprint_and_input_rows():
    s = SparkSession(device="cpu")
    df = s.range(1000).filter("id % 3 = 0")
    assert fingerprint_plan(df._plan) == fingerprint_plan(
        s.range(1000).filter("id % 3 = 0")._plan)
    assert fingerprint_plan(df._plan).startswith("plan:")
    assert plan_input_rows(df._plan) == 1000.0


# ---- on/off byte identity --------------------------------------------------


_MESHES = {}


def _sweep_plan(rng):
    rel = L.Relation(from_arrow(pa.table({
        "k": pa.array(rng.integers(0, 50, 2000), pa.int64()),
        "v": pa.array(rng.integers(0, 1000, 2000), pa.int64())}),
        device="cpu"))
    v = E.Col("v")
    return L.Sort((E.SortOrder(E.Col("k")),), L.Aggregate(
        (E.Col("k"),),
        (E.Col("k"), E.Alias(E.Sum(v), "s"), E.Alias(E.Count(v), "n")),
        rel))


@pytest.mark.parametrize("devices", [1, 2, 8])
def test_on_off_byte_identity_sweep(devices):
    plan = _sweep_plan(np.random.default_rng(42))
    if devices not in _MESHES:
        _MESHES[devices] = make_mesh(devices, devices=["cpu"] * devices)
    ex = MeshExecutor(_MESHES[devices], conf=RuntimeConf())

    def run_through(slo_on):
        sched = make_scheduler(**{"spark.tpu.slo.enabled": slo_on})
        try:
            assert (sched._slo is not None) == slo_on
            t = sched.submit(
                lambda t: ex.execute_logical(plan),
                slo_fp=fingerprint_sql("byte identity sweep")
                if slo_on else None,
                deadline_s=120.0 if slo_on else None)
            return t.result(120).to_pylist()
        finally:
            sched.stop()

    assert run_through(True) == run_through(False), devices


# ---- predictive brownout and auto-concurrency ------------------------------


def _controller(**overrides):
    conf = RuntimeConf({"spark.tpu.slo.enabled": True, **overrides})
    return SloController(conf, LatencyModel(""), max_concurrency=4)


def test_predictive_brownout_enter_exit():
    ctl = _controller(**{
        "spark.tpu.slo.targetP99Ms": 100.0,
        "spark.tpu.slo.controller.windowSeconds": 1.0,
        "spark.tpu.slo.controller.minPredictions": 3,
        "spark.tpu.slo.controller.exitRatio": 0.8})
    try:
        assert ctl.brownout_level() == 0
        for _ in range(4):
            ctl.admission_check_locked(deadline=None, pred_run_ms=500.0,
                                       pending_ms=[], inflight_ms=[],
                                       reject=False)
        assert ctl.brownout_level() == 1 and metrics.brownout_level() == 1
        assert metrics.slo_stats()["brownout_enters"] >= 1
        time.sleep(1.1)
        for _ in range(4):
            ctl.admission_check_locked(deadline=None, pred_run_ms=10.0,
                                       pending_ms=[], inflight_ms=[],
                                       reject=False)
        assert ctl.brownout_level() == 0 and metrics.brownout_level() == 0
        assert metrics.slo_stats()["brownout_exits"] >= 1
    finally:
        metrics.set_brownout(0)


def test_auto_concurrency_resize():
    ctl = _controller(**{"spark.tpu.slo.controller.minPredictions": 1,
                         "spark.tpu.slo.autoConcurrency.min": 1})
    assert ctl.effective_concurrency() == 4
    for _ in range(8):
        ctl._last_resize = 0.0
        ctl._note_ratios(queue_ms=1000.0, run_ms=10.0)
    shrunk = ctl.effective_concurrency()
    assert shrunk < 4
    for _ in range(32):
        ctl._last_resize = 0.0
        ctl._note_ratios(queue_ms=1.0, run_ms=100.0)
    assert shrunk < ctl.effective_concurrency() <= 4
    assert metrics.slo_stats()["resizes"] >= 2


def test_effective_concurrency_bounds_parallel_runs():
    sched = make_slo_scheduler(**{"spark.tpu.scheduler.maxConcurrency": 4})
    try:
        with sched._slo._lock:
            sched._slo._effective = 1
        peak, active = [0], [0]
        lk = threading.Lock()

        def work(t):
            with lk:
                active[0] += 1
                peak[0] = max(peak[0], active[0])
            time.sleep(0.05)
            with lk:
                active[0] -= 1

        for t in [sched.submit(work) for _ in range(4)]:
            t.result(30)
        assert peak[0] == 1
    finally:
        sched.stop()


def test_overload_typed_outcomes_only():
    sched = make_slo_scheduler(**{"spark.tpu.scheduler.maxConcurrency": 2,
                                  "spark.tpu.scheduler.queueDepth": 4})
    fp = fingerprint_sql("SELECT overload_smoke")
    outcomes = []
    lock = threading.Lock()
    try:
        _train(sched, fp, lambda t: time.sleep(0.02))

        def client(i):
            dl = 10.0 if i % 3 else 0.003
            try:
                sched.submit(lambda t: time.sleep(0.02), slo_fp=fp,
                             deadline_s=dl).result(30)
                with lock:
                    outcomes.append(("ok", None))
            except BaseException as e:  # noqa: BLE001 - graded below
                with lock:
                    outcomes.append(("err", e))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(24)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
        assert not any(th.is_alive() for th in threads), "hung client"
    finally:
        sched.stop()
    assert len(outcomes) == 24
    bad = [e for kind, e in outcomes
           if kind == "err" and not chaos.is_typed_error(e)]
    assert not bad, f"untyped under overload: {bad!r}"
    assert any(kind == "ok" for kind, _ in outcomes)
