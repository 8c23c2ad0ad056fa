"""Deterministic, conf-driven fault injection (the port of
``spark_tpu/faults.py``).

Every point of the reference is registered and wired here
(``pipeline.*``, ``execute.device``, ``exchange.all_to_all``, ``agg.*``,
``join.spill``, ``fusion.decide``, ``connect.request``,
``scheduler.admit``, ``serve.*``, ``slo.*``, ``streaming.commit``,
``compile.background`` and ``mview.refresh``).

The reference proves its recovery paths with chaos-style suites
(FailureSuite.scala, DAGSchedulerSuite's MockBackend killing executors
mid-stage); none of our failure paths were testable because there was
no way to *cause* a failure deterministically at a given seam. This
module is that switchboard: named injection points wired at the real
seams of the execution stack, armed per-session through ordinary conf
keys, raising *typed* faults that the recovery layer classifies the
same way it classifies the real thing.

Injection points (key = ``spark.tpu.faultInjection.<point>``):

- ``pipeline.decode``    parquet chunk decode in the out-of-HBM chunk
                         pipeline (physical/pipeline.py producer)
- ``pipeline.transfer``  host filter + host->device transfer of one
                         prepared chunk (same producer)
- ``execute.device``     whole-batch (resident) device execution of a
                         plan (api/dataframe.py _execute)
- ``exchange.all_to_all``the all-to-all collective exchange
                         (parallel/exchange.py, fires on each rank's
                         arrival: the first arrival of an nth spec
                         aborts the stage's collectives)
- ``streaming.commit``   micro-batch state/offset commit
                         (streaming/execution.py)
- ``connect.request``    the connect server's HTTP request handling
                         (connect/server.py)
- ``scheduler.admit``    the multi-tenant scheduler's HBM admission
                         decision (scheduler/scheduler.py), fired as a
                         query passes the device-admission gate
- ``compile.background`` the background fused-compile job of the AOT
                         compilation service (compile/service.py);
                         a fired fault pins the plan to the chunked
                         tier permanently (no swap, no crash)
- ``serve.dispatch``     the federation router's forward of one request
                         to a chosen replica (serve/federation.py) —
                         a transient fault is a replica dying mid-query
                         and triggers a bounded re-dispatch to a
                         different replica; the single-flight result
                         cache guarantees the query still executes at
                         most once per structural key
- ``serve.ownership``    the fleet ownership-control seams: the
                         router's per-replica epoch broadcast after a
                         mint (serve/federation.py) and a replica's
                         eager rebuild of newly-gained shards
                         (connect/server.py). ANY kind is absorbed:
                         a replica that misses the broadcast adopts
                         the epoch lazily from the next stamped
                         request, and a failed eager rebuild degrades
                         to lazy rebuild on first query — ownership
                         control traffic is advisory, bytes never
                         depend on it
- ``serve.invalidate``   a ResultCache applying one invalidation-log
                         record (serve/result_cache.py): ANY kind
                         degrades to a FULL cache clear — the planned,
                         bounded worst case is a cold cache, never a
                         stale one
- ``mview.refresh``      one incremental materialized-view refresh
                         (mview/manager.py): transient faults retry up
                         to spark.tpu.mview.refreshRetries, anything
                         past that falls back to a full recompute
                         (file views) or re-raises so the streaming
                         WAL replay redelivers the delta (stream
                         views) — bytes stay identical either way
- ``agg.strategy``       the adaptive aggregation strategy decision
                         (parallel/executor.py), fired between the
                         sketch fetch and the strategy pick: ANY kind
                         (transient/oom/hang/corrupt) is absorbed by
                         falling back to the static partial->final
                         strategy — the sketch is advisory, its result
                         is discarded on failure, so even a 'corrupt'
                         sketch cannot change bytes
- ``agg.presplit``       the hot-key pre-split arm of the adaptive
                         aggregation switch (parallel/executor.py),
                         fired after the Count-Min heavy-hitter scan
                         elects pre-splitting but before the salted
                         exchange is built: ANY kind degrades to the
                         static partial->final strategy — like
                         ``agg.strategy``, the candidate list is pure
                         advice and is discarded whole on failure
- ``fusion.decide``      the whole-query fusion decision
                         (parallel/executor.py _try_fuse), fired after
                         the plan is judged fusible but before the
                         fused span is built: ANY kind
                         (transient/oom/hang/corrupt) degrades to
                         staged adaptive execution — the fused program
                         is pure plan rewriting, the staged path
                         computes the identical bytes, so injection
                         can only cost the host round-trips fusion
                         would have saved
- ``slo.predict``        the SLO latency-model prediction at submit
                         time (slo/controller.py, OUTSIDE the
                         scheduler's condition lock): ANY kind is
                         absorbed as "no prediction" — the query is
                         treated FIFO-equivalent (always feasible, no
                         EDF advantage), bytes never depend on the
                         model
- ``slo.reject``         the reject-at-admission decision gate
                         (slo/controller.py): ANY kind FAILS OPEN —
                         the feasibility check is skipped and the
                         query admitted, so injection can only admit
                         more than policy would, never shed spuriously
- ``join.spill``         the hybrid hash join's host-spill seams
                         (physical/chunked.py _HybridHashJoinAgg):
                         spill-file WRITE during the partition pass,
                         spill-file READ-BACK during the join pass, and
                         the recursive repartition of an overflowing
                         bucket. transient/hang retry up to
                         spark.tpu.join.hybrid.spillRetryAttempts;
                         corrupt (or retry exhaustion) falls back one
                         rung down the ladder — the static grace-hash
                         join recomputed from source, byte-identical;
                         oom surfaces to the OOM degradation ladder
                         (the LAST resort)

Spec grammar (the conf value):

- ``none``               disarmed (default)
- ``nth:K[:kind]``       fire exactly once, on the K-th arrival at the
                         point (1-based) — the deterministic workhorse
- ``prob:P:SEED[:kind]`` fire each arrival with probability P from a
                         dedicated ``random.Random(f"{SEED}:{point}")``
                         stream — deterministic across reruns,
                         independent of any other RNG use, and ISOLATED
                         per point: the stream is salted with the point
                         name, so one point's draw count never perturbs
                         another point's sequence and a multi-point
                         chaos schedule reproduces from the campaign
                         seed alone (str seeding hashes via sha512 —
                         stable across processes and PYTHONHASHSEED)

Fault kinds (default ``transient``):

- ``transient``  UNAVAILABLE-style environment failure — retryable
                 (recovery.is_transient is True)
- ``oom``        RESOURCE_EXHAUSTED device OOM — NOT retryable; routed
                 to the degradation ladder (recovery.is_oom is True)
- ``hang``       sleeps ``spark.tpu.faultInjection.hangSeconds`` then
                 raises DEADLINE_EXCEEDED — a hang that a deadline
                 caught, so suites stay bounded while still exercising
                 the timeout/retry path
- ``corrupt``    DATA_LOSS — neither transient nor OOM: recovery must
                 surface it unretried as a clean, typed error

Arming counters live on the conf object, keyed by (point, spec), so
changing the spec re-arms the point and independent sessions never
share state. Every fired fault lands in the event log as
``fault_injected``; recoveries land as ``fault_recovered`` /
``degraded_to_chunked`` from the layer that absorbed them.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Optional, Tuple

from spark_tpu_torch import locks
from spark_tpu_torch import conf as CF
from spark_tpu_torch import metrics

POINTS = (
    "pipeline.decode",
    "pipeline.transfer",
    "execute.device",
    "exchange.all_to_all",
    "streaming.commit",
    "connect.request",
    "scheduler.admit",
    "compile.background",
    "serve.dispatch",
    "serve.ownership",
    "serve.invalidate",
    "mview.refresh",
    "agg.strategy",
    "agg.presplit",
    "join.spill",
    "slo.predict",
    "slo.reject",
    "fusion.decide",
)

#: the points whose seam the port has; chaos campaigns draw from these
WIRED_POINTS = (
    "pipeline.decode",
    "pipeline.transfer",
    "execute.device",
    "exchange.all_to_all",
    "agg.strategy",
    "agg.presplit",
    "join.spill",
    "fusion.decide",
    "connect.request",
    "scheduler.admit",
    "serve.dispatch",
    "serve.ownership",
    "serve.invalidate",
    "slo.predict",
    "slo.reject",
    "streaming.commit",
    "compile.background",
    "mview.refresh",
)

KINDS = ("transient", "oom", "hang", "corrupt")

_ENTRIES = {
    point: CF.register(
        f"spark.tpu.faultInjection.{point}", "none",
        f"Fault injection spec for the '{point}' seam: none | "
        "nth:K[:kind] | prob:P:SEED[:kind]; kind in "
        "transient|oom|hang|corrupt (default transient).", str)
    for point in POINTS
}

HANG_SECONDS = CF.register(
    "spark.tpu.faultInjection.hangSeconds", 0.2,
    "How long an injected 'hang' fault sleeps before surfacing as "
    "DEADLINE_EXCEEDED (bounded so fault suites never actually hang).",
    float)


class InjectedFault(Exception):
    """Base class for injected faults; carries the point and kind so
    tests and the event log can tell injected failures from real ones."""

    kind = "transient"

    def __init__(self, point: str, message: str):
        super().__init__(message)
        self.point = point


class InjectedTransientError(InjectedFault):
    """UNAVAILABLE-shaped environment failure (retryable)."""

    kind = "transient"


class InjectedDeadlineError(InjectedFault):
    """DEADLINE_EXCEEDED surfaced after an injected hang (retryable)."""

    kind = "hang"


class InjectedOOMError(InjectedFault):
    """RESOURCE_EXHAUSTED device OOM (degradation ladder, not retry)."""

    kind = "oom"


class InjectedCorruptionError(InjectedFault):
    """DATA_LOSS — unrecoverable by design; must surface unretried."""

    kind = "corrupt"


@dataclass(frozen=True)
class _Spec:
    mode: str  # "nth" | "prob"
    kind: str
    k: int = 0
    p: float = 0.0
    seed: int = 0


def parse_spec(spec: str) -> Optional[_Spec]:
    """Parse a spec string; None when disarmed. Raises ValueError on a
    malformed spec — a typo'd injection silently doing nothing would be
    the exact observability hole this module exists to close."""
    s = str(spec or "").strip()
    if not s or s == "none":
        return None
    parts = s.split(":")
    try:
        if parts[0] == "nth" and len(parts) in (2, 3):
            kind = parts[2] if len(parts) == 3 else "transient"
            out = _Spec("nth", kind, k=int(parts[1]))
        elif parts[0] == "prob" and len(parts) in (3, 4):
            kind = parts[3] if len(parts) == 4 else "transient"
            out = _Spec("prob", kind, p=float(parts[1]),
                        seed=int(parts[2]))
        else:
            raise ValueError(s)
    except (ValueError, IndexError):
        raise ValueError(
            f"malformed fault-injection spec {spec!r}: expected "
            "none | nth:K[:kind] | prob:P:SEED[:kind]") from None
    if out.kind not in KINDS:
        raise ValueError(
            f"unknown fault kind {out.kind!r} in spec {spec!r}: "
            f"expected one of {KINDS}")
    return out


class _PointState:
    __slots__ = ("calls", "fired", "rng")

    def __init__(self, point: str, spec: _Spec):
        self.calls = 0
        self.fired = 0
        # the stream is salted with the point name: two points armed
        # from one campaign seed draw DECORRELATED sequences, and one
        # point's arrival count cannot shift another's draws — the
        # reproducibility contract multi-point chaos schedules rely on
        self.rng = random.Random(f"{spec.seed}:{point}") \
            if spec.mode == "prob" else None


_LOCK = locks.named_lock("faults.registry")


def _resolve_conf(conf):
    if conf is not None:
        return conf
    # seams inside collective code (exchange) have no conf in scope:
    # the running session's (the rank threads run in a copy of the
    # query's context), else the active one's
    try:
        sess = metrics._session()
        return None if sess is None else sess.conf
    except Exception:
        return None


def _state(conf, point: str, spec_str: str, spec: _Spec) -> _PointState:
    states = conf.__dict__.setdefault("_fault_injection_state", {})
    key: Tuple[str, str] = (point, spec_str)
    st = states.get(key)
    if st is None:
        st = states[key] = _PointState(point, spec)
    return st


def reset(conf) -> None:
    """Drop all arming counters on ``conf`` (tests re-arm cleanly)."""
    conf.__dict__.pop("_fault_injection_state", None)


def fire_count(conf, point: str) -> int:
    """How many times ``point`` has fired on ``conf`` (any spec)."""
    states = conf.__dict__.get("_fault_injection_state", {})
    return sum(st.fired for (p, _), st in states.items() if p == point)


def inject(point: str, conf=None) -> None:
    """Arrival at a named injection point: no-op unless the point is
    armed on the session conf AND this arrival is selected, in which
    case the typed fault is recorded and raised (or, for ``hang``,
    slept then raised as a deadline)."""
    conf = _resolve_conf(conf)
    if conf is None:
        return
    entry = _ENTRIES.get(point)
    if entry is None:
        raise ValueError(f"unknown fault-injection point {point!r}: "
                         f"expected one of {POINTS}")
    try:
        spec_str = conf.get(entry)
    except KeyError:
        return
    spec = parse_spec(spec_str)
    if spec is None:
        return
    with _LOCK:
        st = _state(conf, point, str(spec_str), spec)
        st.calls += 1
        if spec.mode == "nth":
            fire = st.calls == spec.k and st.fired == 0
        else:
            fire = st.rng.random() < spec.p
        if fire:
            st.fired += 1
        calls = st.calls
    if not fire:
        return
    metrics.record("fault_injected", point=point, fault=spec.kind,
                   call=calls)
    if spec.kind == "oom":
        raise InjectedOOMError(
            point, f"RESOURCE_EXHAUSTED: injected device OOM at "
                   f"{point} (call {calls})")
    if spec.kind == "corrupt":
        raise InjectedCorruptionError(
            point, f"DATA_LOSS: injected corruption at {point} "
                   f"(call {calls})")
    if spec.kind == "hang":
        # the sleep never outlives the caller: a bound deadline caps it
        # (the injected "hang" models exactly the wait a real deadline
        # would cut short)
        from spark_tpu_torch import deadline as _deadline

        delay = float(conf.get(HANG_SECONDS))
        time.sleep(_deadline.cap_sleep(max(0.0, delay)))
        raise InjectedDeadlineError(
            point, f"DEADLINE_EXCEEDED: injected hang at {point} "
                   f"surfaced after {delay:g}s (call {calls})")
    raise InjectedTransientError(
        point, f"UNAVAILABLE: injected transient fault at {point} "
               f"(call {calls})")
