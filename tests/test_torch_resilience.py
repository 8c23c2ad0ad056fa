"""The port's resilience primitives on the inputs of tests/test_resilience.py:
deadlines (``spark_tpu_torch/deadline.py``), the per-query retry budget
(``recovery.RetryBudget``), the heartbeat monitor, and the chaos
harness's units (``chaos.py``); and the serving tier's: the circuit
breaker and the brownout controller (``serve/federation.py``, each
transition sequence held against the reference's), the deadline's
header round trip, the connect client that never sleeps past its
deadline, and the scheduler's queued deadline (no execution, no grant)
and its merge with the caller's.
"""

import json
import random
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from spark_tpu import chaos as RC
from spark_tpu import deadline as RD
from spark_tpu import recovery as RR
from spark_tpu.serve import federation as RFED
from spark_tpu_torch import chaos, deadline, faults, metrics, recovery, tracing
from spark_tpu_torch.conf import RuntimeConf

from test_torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.timeout(90)


# ---- deadlines ---------------------------------------------------------------


def test_deadline_mint_bind_remaining():
    assert deadline.current() is None and deadline.remaining() is None
    assert not deadline.expired()
    dl = deadline.mint(5.0)
    with deadline.bind(dl):
        assert deadline.current() == dl
        assert 0.0 < deadline.remaining() <= 5.0
        deadline.check("test")
    assert deadline.current() is None


@pytest.mark.parametrize("timeout", [None, 0.0, -3.0])
def test_deadline_mint_none_for_nonpositive(timeout):
    assert deadline.mint(timeout) is None


def test_deadline_tighter_ambient_wins():
    outer, inner = deadline.mint(100.0), deadline.mint(1.0)
    with deadline.bind(outer):
        with deadline.bind(inner):
            assert deadline.current() == inner
        with deadline.bind(deadline.mint(500.0)):
            assert deadline.current() == outer


def test_deadline_check_raises_typed():
    with deadline.bind(time.time() - 0.01):
        assert deadline.expired()
        with pytest.raises(deadline.DeadlineExceeded,
                           match="DEADLINE_EXCEEDED at somewhere"):
            deadline.check("somewhere")


def test_deadline_cap_sleep():
    assert deadline.cap_sleep(3.0) == 3.0
    with deadline.bind(time.time() + 0.2):
        assert deadline.cap_sleep(10.0) <= 0.2
        assert deadline.cap_sleep(0.05) == pytest.approx(0.05, abs=0.01)
    with deadline.bind(time.time() - 1.0):
        assert deadline.cap_sleep(10.0) == 0.0


@pytest.mark.parametrize("seconds", [-1.0, 0.0, 0.05, 3.0])
def test_cap_sleep_matches_reference(seconds):
    dl = time.time() + 1.0
    with deadline.bind(dl), RD.bind(dl):
        assert deadline.cap_sleep(seconds) == pytest.approx(
            RD.cap_sleep(seconds), abs=0.01)
    assert deadline.cap_sleep(seconds) == RD.cap_sleep(seconds)


def test_deadline_exceeded_not_transient_even_wrapped():
    e = deadline.DeadlineExceeded("layer", time.time() - 1.0)
    assert "DEADLINE_EXCEEDED" in str(e)
    assert not recovery.is_transient(e)
    wrapper = RuntimeError("stage failed")
    wrapper.__cause__ = e
    assert not recovery.is_transient(wrapper)


def test_bind_default_mints_only_when_unbound():
    conf = RuntimeConf({"spark.tpu.deadline.defaultTimeoutS": 30.0})
    with deadline.bind_default(conf) as dl:
        assert dl is not None and 29.0 < dl - time.time() <= 30.0
    outer = deadline.mint(5.0)
    with deadline.bind(outer), deadline.bind_default(conf) as dl:
        assert dl == outer  # a nested query inherits the caller's
    with deadline.bind_default(RuntimeConf({})) as dl:
        assert dl is None  # default 0: no deadline


def test_query_under_passed_deadline_raises_typed():
    """A query whose caller's deadline passed stops at the first seam
    that checks it, typed, and is never retried."""
    from spark_tpu_torch.api.session import SparkSession

    s = SparkSession(device="cpu", conf={
        "spark.tpu.faultInjection.execute.device": "nth:1:transient"})
    with deadline.bind(time.time() - 0.01):
        with pytest.raises(deadline.DeadlineExceeded):
            s.range(10).collect()


# ---- the retry budget -----------------------------------------------------------


def test_retry_budget_pool_shared_across_layers():
    b = recovery.RetryBudget(4, layer_floor=0)
    granted = sum(b.draw("a") for _ in range(3)) \
        + sum(b.draw("b") for _ in range(3))
    assert granted == 4 and b.draw("c") is False
    snap = b.snapshot()
    assert snap["remaining"] == 0 and snap["draws"] == 4
    assert set(snap["layers"]) == {"a", "b"}


def test_retry_budget_layer_floor():
    b = recovery.RetryBudget(2, layer_floor=1)
    assert b.draw("noisy") and b.draw("noisy")
    assert not b.draw("noisy")
    assert b.draw("quiet") and not b.draw("quiet")


@pytest.mark.parametrize("attempts,floor", [(0, 0), (3, 0), (2, 1), (5, 2)])
def test_retry_budget_draws_match_reference(attempts, floor):
    rng = random.Random(f"{attempts}:{floor}")
    layers = [rng.choice("abcd") for _ in range(20)]
    mine = recovery.RetryBudget(attempts, layer_floor=floor)
    ref = RR.RetryBudget(attempts, layer_floor=floor)
    assert [mine.draw(x) for x in layers] == [ref.draw(x) for x in layers]
    assert mine.snapshot() == ref.snapshot()


def test_retry_budget_exhausted_typed_and_not_transient():
    b = recovery.RetryBudget(1)
    b.draw("x")
    err = recovery.RetryBudgetExhausted("x", b)
    assert "RETRY_BUDGET_EXHAUSTED" in str(err)
    assert not recovery.is_transient(err)


def test_retry_budget_metrics_events():
    metrics.reset_retry_budget()
    b = recovery.RetryBudget(2, layer_floor=0)
    for _ in range(3):
        b.draw("layer1")
    st = metrics.retry_budget_stats()
    assert st["draws"] == 2 and st["denials"] == 1 and st["exhaustions"] == 1
    evs = [e for e in metrics.recent(64)
           if e["kind"] == "retry_draw" and e["layer"] == "layer1"]
    assert [e["granted"] for e in evs] == [True, True, False]


def test_retry_allowed_legacy_counter_without_budget():
    metrics.reset_retry_budget()
    assert recovery.current_budget() is None
    assert recovery.retry_allowed("anything") is True
    assert metrics.retry_budget_stats()["legacy_attempts"] == 1


def test_budget_from_conf_and_binding():
    conf = RuntimeConf({"spark.tpu.recovery.retryBudget.attempts": 3})
    b = recovery.budget_from_conf(conf)
    assert b is not None and b.snapshot()["attempts"] == 3
    with recovery.bind_budget(b):
        assert recovery.current_budget() is b
        assert recovery.retry_allowed("seam") is True
        with recovery.bind_default_budget(conf) as inner:
            assert inner is b  # nested executions share the outer pool
    assert recovery.current_budget() is None
    off = RuntimeConf({"spark.tpu.recovery.retryBudget.enabled": False})
    assert recovery.budget_from_conf(off) is None


def test_backoff_sleep_capped_by_deadline():
    b = recovery.RetryBudget(4, backoff_base_s=50.0, backoff_cap_s=50.0)
    with deadline.bind(time.time() + 0.15):
        t0 = time.perf_counter()
        b.sleep(3)
        assert time.perf_counter() - t0 < 1.0


def test_stage_retry_draws_from_budget_and_spans():
    """run_stage_with_recovery: each re-attempt draws one from the
    budget and runs in a fault.retry span; a drained budget surfaces as
    RetryBudgetExhausted, typed and chained to the fault."""
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise faults.InjectedTransientError("p", "UNAVAILABLE: x")
        return "ok"

    conf = RuntimeConf({"spark.tpu.recovery.retryBudget.backoffBaseS": 0.0})
    b = recovery.RetryBudget(8, backoff_base_s=0.0)
    metrics.reset()
    from spark_tpu_torch import trace

    with recovery.bind_budget(b), trace.span("query.execute"):
        assert recovery.run_stage_with_recovery(flaky, conf=conf) == "ok"
    assert b.snapshot()["draws"] == 2
    spans = [e for e in metrics.recent() if e["kind"] == "span"
             and e["name"] == "fault.retry"]
    assert [s["attempt"] for s in spans] == [1, 2]
    with recovery.bind_budget(recovery.RetryBudget(0, layer_floor=0)):
        with pytest.raises(recovery.RetryBudgetExhausted) as ei:
            recovery.run_stage_with_recovery(
                lambda: (_ for _ in ()).throw(
                    faults.InjectedTransientError("p", "UNAVAILABLE")),
                conf=conf, label="q")
    assert isinstance(ei.value.__cause__, faults.InjectedTransientError)


# ---- the heartbeat monitor --------------------------------------------------


def test_heartbeat_monitor_probes_and_records():
    metrics.reset()
    hb = recovery.HeartbeatMonitor(interval_s=0.05, device="cpu").start()
    try:
        assert hb.healthy()
        time.sleep(0.2)
        assert any(e["kind"] == "heartbeat" and e["ok"]
                   for e in metrics.recent())
        assert hb.status()["last_error"] is None
    finally:
        hb.stop()
    bad = recovery.HeartbeatMonitor(interval_s=10.0, device="no-such-dev")
    bad.start()
    bad.stop()
    assert not bad.healthy() and bad.status()["last_error"]


# ---- chaos harness units -------------------------------------------------------


@pytest.mark.parametrize("seed", [5, 99, 2024])
def test_campaign_schedules_match_reference(seed):
    mine = [s.to_dict() for s in chaos.generate_campaign(seed, 12)]
    ref = [s.to_dict() for s in RC.generate_campaign(seed, 12)]
    assert mine == ref
    wired = ("pipeline.decode", "execute.device", "exchange.all_to_all",
             "agg.strategy", "fusion.decide")
    assert [s.to_dict() for s in chaos.generate_campaign(
        seed, 6, points=wired, max_points=2)] == [s.to_dict() for s in
        RC.generate_campaign(seed, 6, points=wired, max_points=2)]


def test_campaign_generation_deterministic_and_well_formed():
    a = chaos.generate_campaign(99, 10)
    assert [s.to_dict() for s in a] \
        != [s.to_dict() for s in chaos.generate_campaign(100, 10)]
    for s in a:
        assert 1 <= len(s.faults) <= 3
        for f in s.faults:
            assert f.point in faults.POINTS and f.kind in faults.KINDS
            faults.parse_spec(f.spec())


def test_chaos_schedule_json_roundtrip():
    sch = chaos.generate_campaign(5, 3)[2]
    back = chaos.ChaosSchedule.from_dict(json.loads(json.dumps(sch.to_dict())))
    assert back == sch


def test_is_typed_error_classification():
    assert chaos.is_typed_error(
        faults.InjectedTransientError("p", "UNAVAILABLE: x"))
    assert chaos.is_typed_error(deadline.DeadlineExceeded("w", time.time()))
    assert chaos.is_typed_error(recovery.RetryBudgetExhausted("l", None))
    assert chaos.is_typed_error(RuntimeError("DEADLINE_EXCEEDED: t/o"))
    wrapped = RuntimeError("stage failed")
    wrapped.__cause__ = faults.InjectedCorruptionError("p", "DATA_LOSS")
    assert chaos.is_typed_error(wrapped)
    assert not chaos.is_typed_error(AttributeError("oops"))
    assert not chaos.is_typed_error(RuntimeError("segfault adjacent"))


# ---- the deadline on the wire and the connect client -----------------------


def test_deadline_header_roundtrip_matches_reference():
    dl = time.time() + 12.5
    with deadline.bind(dl):
        hv = deadline.header_value()
    with RD.bind(dl):
        assert hv == RD.header_value()
    assert deadline.from_header(hv) == pytest.approx(dl, abs=1e-3)
    for bad in (None, "", "garbage"):
        assert deadline.from_header(bad) is None
        assert RD.from_header(bad) is None
    assert deadline.DEADLINE_HEADER == RD.DEADLINE_HEADER


class _Always429(BaseHTTPRequestHandler):
    """A server whose Retry-After hint (10 s) far exceeds the client's
    timeout."""

    def log_message(self, *a):
        pass

    def do_POST(self):
        n = int(self.headers.get("Content-Length", "0"))
        self.rfile.read(n)
        body = json.dumps({"error": "SchedulerQueueFull", "message": "full",
                           "retry_after_s": 10.0}).encode()
        self.send_response(429)
        self.send_header("Content-Type", "application/json")
        self.send_header("Retry-After", "10")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def test_client_never_sleeps_past_its_deadline():
    from spark_tpu_torch.connect.server import Client

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _Always429)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        client = Client(f"http://127.0.0.1:{httpd.server_address[1]}",
                        timeout=0.8, retries=8)
        t0 = time.perf_counter()
        with pytest.raises(deadline.DeadlineExceeded):
            client.sql("SELECT 1")
        assert time.perf_counter() - t0 < 5.0
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=5.0)


# ---- the circuit breaker and the brownout, against the reference -----------


def _breakers(**over):
    from spark_tpu.conf import RuntimeConf as RefConf
    from spark_tpu_torch.serve.federation import CircuitBreaker

    base = {"spark.tpu.serve.breaker.minRequests": 2,
            "spark.tpu.serve.breaker.openSeconds": 0.05,
            "spark.tpu.serve.breaker.failureRate": 0.5}
    base.update(over)
    return CircuitBreaker(RuntimeConf(base)), \
        RFED.CircuitBreaker(RefConf(base))


def _transitions(br):
    return [(a, b) for _, a, b in br.state_changes]


@pytest.mark.parametrize("seed", [0, 9])
def test_breaker_sequences_match_reference(seed):
    rng = random.Random(seed)
    mine, theirs = _breakers()
    for _ in range(40):
        op = rng.choice(("success", "failure", "begin", "admits", "trip",
                         "sleep"))
        if op == "sleep":
            time.sleep(0.06)
            continue
        out = [getattr(br, op)() for br in (mine, theirs)]
        assert out[0] == out[1], op
        assert mine.state == theirs.state, op
    assert _transitions(mine) == _transitions(theirs)


def test_breaker_opens_on_failure_rate():
    br, _ = _breakers()
    assert br.admits()
    br.failure()
    assert br.state == "closed"
    br.failure()
    assert br.state == "open" and not br.admits()


def test_breaker_half_open_probe_then_close():
    br, _ = _breakers()
    br.failure()
    br.failure()
    time.sleep(0.06)
    assert br.admits() and br.state == "half_open"
    br.begin()
    assert not br.admits()
    br.success()
    assert br.state == "closed" and br.admits()
    assert _transitions(br) == [("closed", "open"), ("open", "half_open"),
                                ("half_open", "closed")]


def test_breaker_half_open_failure_reopens():
    br, _ = _breakers()
    br.failure()
    br.failure()
    time.sleep(0.06)
    assert br.admits()
    br.begin()
    br.failure()
    assert br.state == "open" and not br.admits()


def test_breaker_successes_keep_rate_low():
    br, _ = _breakers()
    for _ in range(8):
        br.success()
    br.failure()
    br.failure()
    assert br.state == "closed"


def test_breaker_disabled_is_transparent():
    br, _ = _breakers(**{"spark.tpu.serve.breaker.enabled": False})
    for _ in range(10):
        br.failure()
    assert br.state == "closed" and br.admits()


def test_brownout_enters_and_exits_with_hysteresis():
    from spark_tpu_torch.serve.federation import BrownoutController

    metrics.reset_brownout()
    bo = BrownoutController(RuntimeConf({
        "spark.tpu.serve.brownout.minEvents": 4,
        "spark.tpu.serve.brownout.enterRate": 0.5,
        "spark.tpu.serve.brownout.exitRate": 0.1}))
    try:
        for _ in range(4):
            bo.note("failure")
        assert bo.level == 1 and metrics.brownout_level() == 1
        for _ in range(4):
            bo.note("ok")
        assert bo.level == 1  # between the rates: the level holds
        for _ in range(32):
            bo.note("ok")
        assert bo.level == 0 and metrics.brownout_level() == 0
        st = metrics.brownout_stats()
        assert st["entered"] == 1 and st["exited"] == 1
    finally:
        metrics.reset_brownout()


def test_brownout_sheds_trace_sampling_and_auto_cache():
    from spark_tpu_torch import trace as trace_mod

    metrics.reset_brownout()
    try:
        metrics.set_brownout(1)
        assert trace_mod._sample_root() is False
    finally:
        metrics.reset_brownout()


def test_serve_profile_reports_resilience():
    p = tracing.serve_profile(events=[])
    assert set(p["resilience"]) == {"brownout", "retry_budget"}


# ---- the scheduler's deadlines ---------------------------------------------


class _MiniSession:
    """The settings and a memory manager: all the scheduler reads."""

    def __init__(self, conf, mm):
        self.conf = conf
        self.memory_manager = mm


def test_deadline_expired_in_queue_zero_executions_zero_grants():
    from spark_tpu_torch.scheduler import QueryCancelled, QueryScheduler
    from spark_tpu_torch.storage.unified import UnifiedMemoryManager

    conf = RuntimeConf({"spark.tpu.scheduler.maxConcurrency": 1})
    mm = UnifiedMemoryManager(budget_bytes=1 << 24, conf=conf)
    sched = QueryScheduler(_MiniSession(conf, mm))
    release = threading.Event()
    ran = threading.Event()
    try:
        blocker = sched.submit(lambda tk: release.wait(30))
        t0 = time.time() + 30
        while blocker.state != "RUNNING" and time.time() < t0:
            time.sleep(0.005)
        grants_before = mm.snapshot()["grants"]["grants"]
        t = sched.submit(lambda tk: ran.set(), deadline_s=0.05)
        time.sleep(0.1)
        release.set()
        with pytest.raises(QueryCancelled, match="DEADLINE_EXCEEDED"):
            t.result(timeout=30)
        blocker.result(timeout=30)
        assert not ran.is_set()
        snap = mm.snapshot()
        assert snap["grants"]["grants"] == grants_before
        assert snap["in_use_bytes"] == 0
    finally:
        release.set()
        sched.stop()


def test_scheduler_submit_merges_ambient_deadline():
    from spark_tpu_torch.scheduler import QueryScheduler

    sched = QueryScheduler(conf=RuntimeConf())
    try:
        tight = time.time() + 0.5
        with deadline.bind(tight):
            t = sched.submit(lambda tk: "ok", deadline_s=600.0)
        assert t.deadline == pytest.approx(tight, abs=1e-6)
        assert t.result(timeout=30) == "ok"
    finally:
        sched.stop()
