"""The port's resilience primitives on the inputs of tests/test_resilience.py:
deadlines (``spark_tpu_torch/deadline.py``), the per-query retry budget
(``recovery.RetryBudget``), the heartbeat monitor, and the chaos
harness's units (``chaos.py``). The circuit breaker, the brownout
controller, the connect client's fail-fast and the scheduler's queued
deadline wait for the serving tier (ROADMAP A12 part 2).
"""

import json
import random
import time

import pytest

from spark_tpu import chaos as RC
from spark_tpu import deadline as RD
from spark_tpu import recovery as RR
from spark_tpu_torch import chaos, deadline, faults, metrics, recovery
from spark_tpu_torch.conf import RuntimeConf

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
