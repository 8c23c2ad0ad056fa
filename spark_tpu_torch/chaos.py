"""Seeded chaos-campaign harness over the fault-injection switchboard.

faults.py gives every recovery seam a deterministic trigger; this
module drives ALL of them at once, the way the reference's
FailureSuite/DAGSchedulerSuite randomized kill tests prove recovery
composition rather than one seam at a time. A **campaign** is a
sequence of **schedules**, each derived purely from
``random.Random(f"chaos:{campaign_seed}")``: 1..max_points injection
points armed together, each with its own kind (transient / oom / hang
/ corrupt) and its own nth- or prob-mode spec (prob streams are salted
per point by faults._PointState, so a multi-point schedule reproduces
from the campaign seed alone).

Per schedule the harness asserts the fleet-grade resilience contract:

- **byte-identical or typed** — the workload either returns bytes
  equal to the clean (fault-free) run, or raises one of the TYPED
  errors the stack is allowed to surface (``is_typed_error``). A
  mangled result or an anonymous stack trace is a campaign failure.
- **zero hangs** — every schedule runs under a wall-clock alarm
  (SIGALRM on the main thread, a watchdog budget elsewhere); an
  expired alarm is a failure, never a silent stall.
- **attempts <= budget** — the unified retry budget's metrics deltas
  are checked against the per-query pool: draws never exceed
  ``queries x attempts`` (the old multiplicative per-layer stacking
  shows up here immediately).
- **memory invariant** — ``execution + storage <= hbmBudget`` from the
  UnifiedMemoryManager snapshot after every schedule.

Over a serving fleet, ``kill_and_revive`` runs the replica arc: a
replica dies mid-campaign, the fleet serves the same bytes, and the
replica rejoins on its own port.

A failing schedule is dumped as a replayable JSON artifact
(``schedule.to_dict`` round-trips through ``ChaosSchedule.from_dict``)
so one failing seed out of thousands re-runs in isolation.
"""

from __future__ import annotations

import json
import random
import signal
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

from spark_tpu_torch import faults, metrics

#: fault kinds eligible for random schedules, weighted toward the
#: kinds with recovery paths (transient/hang retry; oom degrades;
#: corrupt must surface typed)
_KIND_WEIGHTS = (("transient", 5), ("hang", 2), ("oom", 1),
                 ("corrupt", 1))


class ChaosHang(RuntimeError):
    """A schedule exceeded its wall-clock alarm: the zero-hang
    guarantee failed (or the bound is too tight for the workload)."""


@dataclass(frozen=True)
class ChaosFault:
    """One armed injection point inside a schedule."""

    point: str
    mode: str  # "nth" | "prob"
    kind: str  # faults.KINDS
    k: int = 1
    p: float = 0.0
    seed: int = 0

    def spec(self) -> str:
        if self.mode == "nth":
            return f"nth:{self.k}:{self.kind}"
        return f"prob:{self.p:g}:{self.seed}:{self.kind}"

    def conf_key(self) -> str:
        return f"spark.tpu.faultInjection.{self.point}"

    def to_dict(self) -> dict:
        return {"point": self.point, "mode": self.mode,
                "kind": self.kind, "k": self.k, "p": self.p,
                "seed": self.seed}

    @classmethod
    def from_dict(cls, d: dict) -> "ChaosFault":
        return cls(point=d["point"], mode=d["mode"], kind=d["kind"],
                   k=int(d.get("k", 1)), p=float(d.get("p", 0.0)),
                   seed=int(d.get("seed", 0)))


@dataclass(frozen=True)
class ChaosSchedule:
    """One deterministic multi-point fault configuration."""

    index: int
    campaign_seed: int
    faults: Tuple[ChaosFault, ...]

    def conf_overrides(self) -> dict:
        return {f.conf_key(): f.spec() for f in self.faults}

    def describe(self) -> str:
        return " + ".join(
            f"{f.point}={f.spec()}" for f in self.faults) or "(clean)"

    def to_dict(self) -> dict:
        return {"index": self.index,
                "campaign_seed": self.campaign_seed,
                "faults": [f.to_dict() for f in self.faults]}

    @classmethod
    def from_dict(cls, d: dict) -> "ChaosSchedule":
        return cls(index=int(d["index"]),
                   campaign_seed=int(d["campaign_seed"]),
                   faults=tuple(ChaosFault.from_dict(f)
                                for f in d["faults"]))


def generate_campaign(campaign_seed: int, n: int, *,
                      points: Sequence[str] = faults.POINTS,
                      max_points: int = 3,
                      prob_range: Tuple[float, float] = (0.2, 0.7),
                      ) -> List[ChaosSchedule]:
    """Derive ``n`` schedules purely from ``campaign_seed`` — same
    seed, same campaign, on any host/process (str seeding hashes via
    sha512, independent of PYTHONHASHSEED)."""
    rng = random.Random(f"chaos:{campaign_seed}")
    kinds = [k for k, w in _KIND_WEIGHTS for _ in range(w)]
    out: List[ChaosSchedule] = []
    for i in range(int(n)):
        npts = rng.randint(1, max(1, min(max_points, len(points))))
        chosen = rng.sample(list(points), npts)
        fs = []
        for pt in chosen:
            kind = rng.choice(kinds)
            if rng.random() < 0.5:
                fs.append(ChaosFault(pt, "nth", kind,
                                     k=rng.randint(1, 3)))
            else:
                fs.append(ChaosFault(
                    pt, "prob", kind,
                    p=round(rng.uniform(*prob_range), 3),
                    seed=rng.randrange(1 << 30)))
        out.append(ChaosSchedule(i, int(campaign_seed), tuple(fs)))
    return out


def is_typed_error(exc: BaseException) -> bool:
    """Is ``exc`` (or anything in its cause chain) one of the errors
    the stack is ALLOWED to surface under faults? Everything else —
    an AttributeError out of a half-recovered code path, a mangled
    arrow stream — is a chaos-campaign failure."""
    from spark_tpu_torch import deadline, recovery

    def _typed_one(e: BaseException) -> bool:
        if isinstance(e, (faults.InjectedFault,
                          deadline.DeadlineExceeded,
                          recovery.RetryBudgetExhausted,
                          ChaosHang)):
            return True
        name = type(e).__name__
        if name in ("QueryCancelled", "SchedulerQueueFull",
                    "NoHealthyReplica", "FlightWaitTimeout",
                    "PlanAnalysisError", "EpochRetry",
                    "InfeasibleDeadline"):
            return True
        msg = str(e)
        return any(m in msg for m in (
            "DATA_LOSS", "RESOURCE_EXHAUSTED", "DEADLINE_EXCEEDED",
            "UNAVAILABLE", "RETRY_BUDGET_EXHAUSTED", "CANCELLED",
            "SchedulerQueueFull", "NoHealthyReplica", "EPOCH_RETRY",
            "INFEASIBLE_DEADLINE"))

    seen = set()
    e: Optional[BaseException] = exc
    while e is not None and id(e) not in seen:
        seen.add(id(e))
        if _typed_one(e):
            return True
        e = e.__cause__ or e.__context__
    return False


class _Alarm:
    """Wall-clock bound for one schedule. On the main thread a real
    SIGALRM interrupts even a wedged C-level wait; elsewhere a timer
    thread can only flag the overrun, so ``expired`` is checked after
    the run (the run itself is still bounded by the caller's own
    pytest/campaign timeout)."""

    def __init__(self, seconds: float):
        self.seconds = float(seconds)
        self.expired = False
        self._main = (threading.current_thread()
                      is threading.main_thread())
        self._old = None
        self._timer: Optional[threading.Timer] = None

    def __enter__(self):
        if self.seconds <= 0:
            return self
        if self._main:
            def _fire(signum, frame):
                self.expired = True
                raise ChaosHang(
                    f"schedule exceeded {self.seconds:g}s wall bound")
            self._old = signal.signal(signal.SIGALRM, _fire)
            signal.setitimer(signal.ITIMER_REAL, self.seconds)
        else:
            self._timer = threading.Timer(
                self.seconds, lambda: setattr(self, "expired", True))
            self._timer.daemon = True
            self._timer.start()
        return self

    def __exit__(self, *exc):
        if self.seconds <= 0:
            return False
        if self._main:
            signal.setitimer(signal.ITIMER_REAL, 0.0)
            if self._old is not None:
                signal.signal(signal.SIGALRM, self._old)
        elif self._timer is not None:
            self._timer.cancel()
        return False


@dataclass
class ScheduleResult:
    schedule: ChaosSchedule
    ok: bool
    outcome: str  # identical | typed_error | mismatch | untyped_error
    #             | hang | budget_overdraw | memory_violation
    error: Optional[str] = None
    elapsed_s: float = 0.0
    draws: int = 0
    fired: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"schedule": self.schedule.to_dict(), "ok": self.ok,
                "outcome": self.outcome, "error": self.error,
                "elapsed_s": round(self.elapsed_s, 3),
                "draws": self.draws, "fired": self.fired}


def run_schedule(conf, run_bytes: Callable[[], bytes],
                 schedule: ChaosSchedule, *,
                 clean_bytes: bytes,
                 alarm_s: float = 60.0,
                 queries: int = 1,
                 budget_attempts: Optional[int] = None,
                 memory_manager=None) -> ScheduleResult:
    """Arm ``schedule`` on ``conf``, run the workload once, disarm,
    and grade the outcome against the resilience contract. The
    workload must be deterministic: ``clean_bytes`` is its fault-free
    result."""
    from spark_tpu_torch import recovery

    overrides = schedule.conf_overrides()
    before = metrics.retry_budget_stats()
    if budget_attempts is None:
        try:
            budget_attempts = int(conf.get(
                recovery.RETRY_BUDGET_ATTEMPTS))
        except Exception:
            budget_attempts = int(
                recovery.RETRY_BUDGET_ATTEMPTS.default)
    for key, spec in overrides.items():
        conf.set(key, spec)
    faults.reset(conf)
    t0 = time.perf_counter()
    outcome, err, ok = "identical", None, True
    try:
        with _Alarm(alarm_s) as alarm:
            blob = run_bytes()
        if alarm.expired:
            outcome, ok = "hang", False
            err = f"watchdog: exceeded {alarm_s:g}s off-main-thread"
        elif blob != clean_bytes:
            outcome, ok = "mismatch", False
            err = (f"result diverged from clean run "
                   f"({len(blob)} vs {len(clean_bytes)} bytes)")
    except ChaosHang as e:
        outcome, ok, err = "hang", False, repr(e)
    except BaseException as e:  # noqa: BLE001 — graded, not handled
        if is_typed_error(e):
            outcome, err = "typed_error", repr(e)
        else:
            outcome, ok = "untyped_error", False
            err = repr(e)
    finally:
        elapsed = time.perf_counter() - t0
        fired = {pt: faults.fire_count(conf, pt)
                 for pt in {f.point for f in schedule.faults}}
        for key in overrides:
            conf.unset(key)
        faults.reset(conf)
    after = metrics.retry_budget_stats()
    draws = (after.get("draws", 0) - before.get("draws", 0)
             + after.get("floor_draws", 0)
             - before.get("floor_draws", 0))
    if ok and draws > max(1, int(queries)) * int(budget_attempts):
        ok, outcome = False, "budget_overdraw"
        err = (f"{draws} retry draws > {queries} queries x "
               f"{budget_attempts} budget")
    if ok and memory_manager is not None:
        snap = memory_manager.snapshot()
        used = (int(snap.get("in_use_bytes", 0))
                + int(snap.get("storage_bytes", 0)))
        if used > int(snap.get("budget_bytes", 0)):
            ok, outcome = False, "memory_violation"
            err = (f"execution+storage {used} > budget "
                   f"{snap.get('budget_bytes')}")
    return ScheduleResult(schedule, ok, outcome, err, elapsed,
                          max(0, draws), fired)


@dataclass
class CampaignReport:
    campaign_seed: int
    results: List[ScheduleResult]

    @property
    def ok(self) -> bool:
        return all(r.ok for r in self.results)

    @property
    def failures(self) -> List[ScheduleResult]:
        return [r for r in self.results if not r.ok]

    def summary(self) -> dict:
        counts: dict = {}
        for r in self.results:
            counts[r.outcome] = counts.get(r.outcome, 0) + 1
        return {"campaign_seed": self.campaign_seed,
                "schedules": len(self.results),
                "ok": self.ok, "outcomes": counts,
                "total_draws": sum(r.draws for r in self.results),
                "elapsed_s": round(
                    sum(r.elapsed_s for r in self.results), 3)}


def run_campaign(conf, run_bytes: Callable[[], bytes],
                 schedules: Sequence[ChaosSchedule], *,
                 clean_bytes: bytes,
                 alarm_s: float = 60.0,
                 queries: int = 1,
                 memory_manager=None,
                 artifact_path: Optional[str] = None,
                 log: Optional[Callable[[str], None]] = None
                 ) -> CampaignReport:
    """Run every schedule; on the FIRST failure (if ``artifact_path``)
    write the replayable JSON artifact, then keep going so the report
    covers the whole campaign."""
    results: List[ScheduleResult] = []
    wrote_artifact = False
    seed = schedules[0].campaign_seed if schedules else 0
    for sch in schedules:
        r = run_schedule(conf, run_bytes, sch,
                         clean_bytes=clean_bytes, alarm_s=alarm_s,
                         queries=queries,
                         memory_manager=memory_manager)
        results.append(r)
        if log is not None:
            flag = "ok " if r.ok else "FAIL"
            log(f"[{flag}] #{sch.index:03d} {r.outcome:<13} "
                f"{r.elapsed_s:6.2f}s draws={r.draws:<3} "
                f"{sch.describe()}")
        if not r.ok and artifact_path and not wrote_artifact:
            wrote_artifact = True
            with open(artifact_path, "w") as f:
                json.dump(r.to_dict(), f, indent=2)
            if log is not None:
                log(f"  replay artifact -> {artifact_path}")
    return CampaignReport(seed, results)


def kill_and_revive(fleet, run_bytes: Callable[[], bytes], *,
                    clean_bytes: bytes, victim: int = 0,
                    open_s: float = 0.3) -> dict:
    """The campaign's replica arc over an in-process fleet
    (``serve/router.Fleet`` over one session): with the router's health
    probes throttled, replica ``victim`` dies; the next dispatch that
    finds it dead trips its breaker open at once, and the workload's
    bytes through the death must equal ``clean_bytes``. The replica is
    then revived on its own host, port and id (and put back in
    ``fleet.replicas``, so ``fleet.stop()`` stops it); past the
    breaker's ``open_s`` and a probe it must be healthy again and the
    bytes equal. Returns what happened; raises ``AssertionError`` where
    the contract fails. The session's probe and breaker settings are
    restored."""
    from spark_tpu_torch.connect.server import ConnectServer

    fed = fleet.router.federation
    conf = fleet.router.conf
    keys = ("spark.tpu.serve.healthProbeSeconds",
            "spark.tpu.serve.breaker.openSeconds")
    saved = {k: conf._overrides.get(k) for k in keys}
    conf.set(keys[0], 3600.0)
    conf.set(keys[1], float(open_s))
    t0 = time.perf_counter()
    try:
        fed.probe(force=True)
        for r in fed.replicas:
            r.breaker.reset()
            r.last_probe = time.time()  # probes throttled from here
        server = fleet.replicas[victim]
        host, port, rid = server.host, server.port, server.replica_id
        server.stop()
        during = run_bytes()
        assert during == clean_bytes, "bytes changed during replica death"
        dead = next(r for r in fed.replicas if r.id == rid)
        tripped = dead.breaker.state
        assert tripped == "open", f"breaker {tripped} after the death"
        revived = ConnectServer(server.session, host=host, port=port,
                                replica_id=rid).start()
        fleet.replicas[victim] = revived
        time.sleep(float(open_s) + 0.05)  # past breaker.openSeconds
        fed.probe(force=True)
        after = run_bytes()
        assert after == clean_bytes, "bytes changed after the revival"
        assert dead.healthy, "the revived replica is not healthy"
    finally:
        for k, v in saved.items():
            if v is None:
                conf.unset(k)
            else:
                conf.set(k, v)
    return {"replica": rid, "breaker_after_death": tripped,
            "healthy_after_revival": dead.healthy,
            "elapsed_s": round(time.perf_counter() - t0, 3)}


def replay_artifact(path: str) -> ChaosSchedule:
    """Load the failing schedule back out of a campaign artifact."""
    with open(path) as f:
        d = json.load(f)
    return ChaosSchedule.from_dict(d["schedule"])
