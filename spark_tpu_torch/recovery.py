"""Recovery: the OOM degradation ladder, stage retry, the per-query
retry budget, the heartbeat monitor and durable checkpoints (the port of
``spark_tpu/recovery.py``).

- ``run_plan_with_oom_degradation``: a plan whose scans exceed the
  device budget runs chunked (``physical/chunked.py``); a resident run
  that dies of a device OOM replans through the chunked tier at a halved
  ``spark.tpu.maxDeviceBatchBytes`` (on a shadow of the session's
  settings), halving again on a repeated OOM down to
  ``spark.tpu.oomDegrade.floorBytes`` (reference analogue:
  TungstenAggregationIterator.scala:82's fallback under memory
  pressure). It replans only on an OOM, never moves work to the CPU,
  and re-raises every other error.
- ``run_stage_with_recovery``: re-runs a query thunk on a transient
  environment failure, recomputing from the logical plan (reference:
  DAGScheduler.scala:1762 stage resubmission).
- ``checkpoint_dataframe``: Parquet under ``spark.checkpoint.dir`` and a
  DataFrame over the files, lineage truncated (reference:
  ReliableCheckpointRDD).
- ``RetryBudget``: one pool of re-attempts per query shared by every
  retry layer (stage retry, the chunk retry, the spill seams), so their
  bounds add instead of multiplying under a fault storm; ``bind_budget``
  / ``current_budget`` carry it in a context variable, ``retry_allowed``
  is the seam every bounded retry loop asks, and a drained pool surfaces
  as the typed ``RetryBudgetExhausted``.
- ``HeartbeatMonitor``: a daemon thread that runs a trivial computation
  on the device every ``spark.executor.heartbeatInterval`` seconds and
  records a ``heartbeat`` event.

The whole-batch execution seam ``execute.device`` (``faults.py``) fires
inside the ladder, so an injected OOM replans through it and an injected
transient fault is retried by ``run_stage_with_recovery``; every recovery
records a ``fault_recovered`` event and every re-attempt a ``fault.retry``
span. ``is_oom`` and ``is_transient`` classify the injected errors as the
reference does.

On torch, the caching allocator frees its cached blocks and retries
before it raises ``torch.cuda.OutOfMemoryError``, so an OOM that reaches
the ladder is real. The graph pool's memory is not freed by
``empty_cache()``: before its first replan the ladder drops the captured
stages (``graphs.drop_stages``) and then empties the allocator's cache.

The ladder's rung 0 (reference: ``spark_tpu/recovery.py:476-512``): on a
mesh session whose run ran out of memory with adaptive execution off,
the run is retried once with ``parallel/executor.FORCE_ADAPTIVE`` set
(measured post-exchange capacities shrink the receive buffers an
exchange-heavy plan runs out on, with the same rows), before the
chunked replans.

Measured bytes (``scheduler/admission.py``): a resident run notes its
peak stage bytes under the optimized plan (``_note_measured_resident``),
and a plan whose measured working set exceeds what the memory manager
can grant now is planned into the chunked tier before it runs
(``_grant_planned_chunk``, no replan).
"""

from __future__ import annotations

import os
import random
import threading
import time
import uuid
from contextlib import contextmanager, nullcontext
from contextvars import ContextVar
from typing import Any, Callable, Dict, Iterator, Optional

from spark_tpu_torch import conf as CF
from spark_tpu_torch import deadline, faults, locks, metrics, trace

STAGE_MAX_ATTEMPTS = CF.register(
    "spark.stage.maxConsecutiveAttempts", 4,
    "Attempts for a query whose failure looks transient (reference: "
    "config/package.scala STAGE_MAX_CONSECUTIVE_ATTEMPTS).", int)

CHECKPOINT_DIR = CF.register(
    "spark.checkpoint.dir", "",
    "Durable checkpoint directory for DataFrame.checkpoint() (reference: "
    "SparkContext.setCheckpointDir).", str)

HEARTBEAT_INTERVAL = CF.register(
    "spark.executor.heartbeatInterval", 10.0,
    "Seconds between device liveness probes (reference: "
    "HeartbeatReceiver.scala HEARTBEAT_INTERVAL).", float)

OOM_DEGRADE_ENABLED = CF.register(
    "spark.tpu.oomDegrade.enabled", True,
    "A resident run that dies of a device OOM replans through the "
    "chunked out-of-memory tier at a halved spark.tpu.maxDeviceBatchBytes "
    "(halving again on a repeated OOM) instead of failing.", bool)

OOM_DEGRADE_FLOOR = CF.register(
    "spark.tpu.oomDegrade.floorBytes", 1 << 20,
    "The smallest device-batch budget the OOM ladder tries before it "
    "surfaces the OOM. Default: the reference's.", int)

RETRY_BUDGET_ENABLED = CF.register(
    "spark.tpu.recovery.retryBudget.enabled", True,
    "Share ONE per-query retry budget across every retry layer (stage "
    "recovery, chunk pipeline, spill seams) instead of letting the per-layer "
    "bounds stack multiplicatively under a fault storm.", bool)

RETRY_BUDGET_ATTEMPTS = CF.register(
    "spark.tpu.recovery.retryBudget.attempts", 8,
    "Total re-attempts one query may spend across ALL retry layers "
    "combined. Per-layer bounds still apply individually; this pool "
    "caps their sum.", int)

RETRY_BUDGET_FLOOR = CF.register(
    "spark.tpu.recovery.retryBudget.layerFloor", 1,
    "Re-attempts each layer is guaranteed even after the shared pool "
    "empties, so one retry-hungry layer cannot starve every other "
    "layer of its single recovery chance.", int)

RETRY_BACKOFF_BASE = CF.register(
    "spark.tpu.recovery.retryBudget.backoffBaseS", 0.05,
    "Base of the full-jitter exponential backoff between budgeted "
    "re-attempts (delay ~ uniform[0, min(cap, base * 2^attempt)]).",
    float)

RETRY_BACKOFF_CAP = CF.register(
    "spark.tpu.recovery.retryBudget.backoffCapS", 2.0,
    "Ceiling of the full-jitter backoff between budgeted re-attempts; "
    "every sleep is additionally capped by the caller's remaining "
    "deadline.", float)

# fragments of error messages that say the environment failed (a peer
# went away, a deadline passed), not that the query is wrong: only these
# are retried
_TRANSIENT_MARKERS = (
    "DEADLINE_EXCEEDED",
    "UNAVAILABLE",
    "ABORTED",
    "connection reset",
    "Connection reset",
    "socket closed",
    "device or resource busy",
)

# exception types that are transient whatever their message says
_TRANSIENT_TYPES = (
    ConnectionResetError,
    ConnectionAbortedError,
    BrokenPipeError,
    TimeoutError,
)

# the caching allocator's message when it cannot serve an allocation
_OOM_MARKER = "CUDA out of memory"

#: the record of the newest ladder run: replans, the budgets tried, the
#: captured stages dropped and whether the allocator's cache was emptied
last_ladder: Dict[str, Any] = {}


def _oom_types() -> tuple:
    import torch

    oom = getattr(torch.cuda, "OutOfMemoryError", None)
    return (MemoryError,) if oom is None else (MemoryError, oom)


def _chain(exc: BaseException) -> Iterator[BaseException]:
    """The exception and its ``__cause__``/``__context__`` chain."""
    seen = set()
    node: Optional[BaseException] = exc
    while node is not None and id(node) not in seen:
        seen.add(id(node))
        yield node
        if node.__cause__ is not None:
            node = node.__cause__
        elif not node.__suppress_context__:
            node = node.__context__
        else:
            node = None


def is_oom(exc: BaseException) -> bool:
    """Memory exhaustion anywhere in the cause chain:
    ``torch.cuda.OutOfMemoryError``, ``MemoryError``, an injected OOM
    (``faults.InjectedOOMError``) or the allocator's "CUDA out of memory"
    text, and nothing else. An OOM is never
    transient: rerunning the same plan would exhaust the same memory."""
    types = _oom_types() + (faults.InjectedOOMError,)
    for e in _chain(exc):
        if isinstance(e, types) or _OOM_MARKER in str(e):
            return True
    return False


def is_transient(exc: BaseException) -> bool:
    """True when the failure looks like the environment's and rerunning
    the same plan can succeed: a transient type or message anywhere in
    the cause chain, and no OOM in it. A caller's deadline passing and a
    drained retry budget are terminal whatever their chain says, and an
    injected fault is classified by its kind."""
    if is_oom(exc):
        return False
    for e in _chain(exc):
        if isinstance(e, (deadline.DeadlineExceeded,
                          RetryBudgetExhausted)) \
                or getattr(e, "terminal", False):
            return False
    for e in _chain(exc):
        if isinstance(e, (faults.InjectedTransientError,
                          faults.InjectedDeadlineError)):
            return True
        if isinstance(e, faults.InjectedFault):
            return False  # injected oom/corrupt: typed, not transient
        if isinstance(e, _TRANSIENT_TYPES):
            return True
        msg = str(e)
        if any(m in msg for m in _TRANSIENT_MARKERS):
            return True
    return False


class RetryBudgetExhausted(RuntimeError):
    """A retry seam asked for a re-attempt after the query's unified
    retry budget drained past the layer floor. Typed and terminal:
    never transient (is_transient carves it out by type), so outer
    layers surface it instead of re-retrying."""

    def __init__(self, layer: str, budget: Optional["RetryBudget"]):
        snap = budget.snapshot() if budget is not None else \
            {"draws": "?", "attempts": "?", "layers": {}}
        super().__init__(
            f"RETRY_BUDGET_EXHAUSTED at {layer}: "
            f"{snap['draws']} re-attempts spent of "
            f"{snap['attempts']} budgeted "
            f"(per-layer: {snap['layers']})")
        self.layer = layer


class RetryBudget:
    """One per-query pool of re-attempts shared by EVERY retry layer.

    Without it, resilience is a stack of independent bounded retries —
    ``spark.stage.maxConsecutiveAttempts`` x ``chunkRetryAttempts`` x
    ``spillRetryAttempts`` (and, with the later tiers, dispatch,
    admission and mview refresh retries) — whose worst case is the
    PRODUCT of the bounds under a fault storm. Here every layer draws from one pool:
    the per-query total is the SUM bound ``attempts`` (plus each
    layer's small floor guarantee), whatever the nesting.

    ``draw(layer)`` consumes one re-attempt and returns whether it was
    granted; after the pool drains, a layer that has drawn fewer than
    ``layer_floor`` times is still granted (the floor keeps one
    retry-hungry layer from starving every other layer of its single
    recovery chance). Denials surface as
    :class:`RetryBudgetExhausted` at the seam.

    ``backoff_s(attempt)`` is the shared FULL-JITTER exponential
    backoff — delay ~ uniform[0, min(cap, base * 2^attempt)] — capped
    by the caller's remaining deadline, so no budgeted sleep outlives
    the caller.
    """

    def __init__(self, attempts: int, *, layer_floor: int = 1,
                 backoff_base_s: float = 0.05,
                 backoff_cap_s: float = 2.0,
                 rng: Optional[random.Random] = None):
        self.attempts = max(0, int(attempts))
        self.layer_floor = max(0, int(layer_floor))
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self._rng = rng if rng is not None else random.Random()
        self._remaining = self.attempts
        self._layers: Dict[str, int] = {}
        self._exhausted_noted = False
        self._lock = locks.named_lock("recovery.retry_budget")

    def draw(self, layer: str) -> bool:
        """Consume one re-attempt for ``layer``; True when granted."""
        with self._lock:
            taken = self._layers.get(layer, 0)
            if self._remaining > 0:
                self._remaining -= 1
                self._layers[layer] = taken + 1
                granted, floored = True, False
            elif taken < self.layer_floor:
                self._layers[layer] = taken + 1
                granted, floored = True, True
            else:
                granted, floored = False, False
            remaining = self._remaining
            note_exhausted = (remaining == 0
                              and not self._exhausted_noted)
            if note_exhausted:
                self._exhausted_noted = True
        if granted:
            metrics.note_retry_budget("draws")
            if floored:
                metrics.note_retry_budget("floor_draws")
        else:
            metrics.note_retry_budget("denials")
        if note_exhausted:
            metrics.note_retry_budget("exhaustions")
        metrics.record("retry_draw", layer=layer, granted=granted,
                       floored=floored, remaining=remaining)
        return granted

    def backoff_s(self, attempt: int) -> float:
        """Full-jitter delay for re-attempt ``attempt``, capped by the
        ambient deadline's remaining time."""
        ceiling = min(self.backoff_cap_s,
                      self.backoff_base_s * (2.0 ** max(0, attempt)))
        return deadline.cap_sleep(self._rng.uniform(0.0, ceiling))

    def sleep(self, attempt: int) -> None:
        time.sleep(self.backoff_s(attempt))

    def snapshot(self) -> Dict:
        with self._lock:
            return {"attempts": self.attempts,
                    "remaining": self._remaining,
                    "draws": sum(self._layers.values()),
                    "layers": dict(self._layers),
                    "layer_floor": self.layer_floor}


_BUDGET: ContextVar[Optional[RetryBudget]] = ContextVar(
    "spark_tpu_torch_retry_budget", default=None)


def current_budget() -> Optional[RetryBudget]:
    """The query's ambient RetryBudget (None outside a budgeted query
    or with spark.tpu.recovery.retryBudget.enabled=false)."""
    return _BUDGET.get()


@contextmanager
def bind_budget(budget: Optional[RetryBudget]):
    """Enter a budget for the dynamic extent (None is a no-op).
    Thread-hopping code captures current_budget() and re-binds on the
    worker — same discipline as trace/deadline contexts."""
    if budget is None:
        yield _BUDGET.get()
        return
    token = _BUDGET.set(budget)
    try:
        yield budget
    finally:
        _BUDGET.reset(token)


def budget_from_conf(conf) -> Optional[RetryBudget]:
    """A fresh per-query budget per the conf (None when disabled)."""
    try:
        if not bool(conf.get(RETRY_BUDGET_ENABLED)):
            return None
        return RetryBudget(
            int(conf.get(RETRY_BUDGET_ATTEMPTS)),
            layer_floor=int(conf.get(RETRY_BUDGET_FLOOR)),
            backoff_base_s=float(conf.get(RETRY_BACKOFF_BASE)),
            backoff_cap_s=float(conf.get(RETRY_BACKOFF_CAP)))
    except Exception:
        return None


@contextmanager
def bind_default_budget(conf):
    """Root-entry helper (DataFrame._execute): bind a fresh budget only
    when none is already active — nested executions (cache
    materialization, recovery re-runs) must share the OUTER query's
    pool; that sharing IS the anti-stacking guarantee."""
    if _BUDGET.get() is not None or conf is None:
        yield _BUDGET.get()
        return
    with bind_budget(budget_from_conf(conf)) as b:
        yield b


def retry_allowed(layer: str) -> bool:
    """THE seam API: every bounded-retry loop in the tree asks this
    before each re-attempt. Draws from the ambient budget when one is bound; without one
    (budget disabled, or a bare layer used outside any query) the
    legacy per-layer bound stands alone and the re-attempt is counted
    on the ``legacy_attempts`` A/B counter."""
    b = _BUDGET.get()
    if b is None:
        metrics.note_retry_budget("legacy_attempts")
        return True
    return b.draw(layer)


def backoff_sleep(attempt: int, *, base_s: float = 0.05,
                  cap_s: float = 2.0) -> None:
    """Full-jitter, deadline-capped backoff for seams re-attempting
    WITHOUT an ambient budget (the budget's own backoff_s is preferred
    when bound — it shares the jitter RNG and the configured caps)."""
    b = _BUDGET.get()
    if b is not None:
        b.sleep(attempt)
        return
    ceiling = min(float(cap_s), float(base_s) * (2.0 ** max(0, attempt)))
    time.sleep(deadline.cap_sleep(random.uniform(0.0, ceiling)))


def _release_device_memory(device) -> Dict[str, Any]:
    """Before the ladder's first replan: drop the captured stages (the
    graph pool survives ``empty_cache``) and empty the allocator's
    cache on a CUDA device."""
    import torch

    from spark_tpu_torch.physical import graphs

    dropped = graphs.drop_stages()
    emptied = False
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
        emptied = True
    return {"stages_dropped": dropped, "cache_emptied": emptied}


def query_peak_stage_bytes() -> int:
    """The largest ``stage_bytes`` event of the running query (the mesh
    records one a stage; a single-device run records none, as in the
    reference): the events of the ambient trace, else those since the
    newest query mark."""
    from spark_tpu_torch import trace

    tid = trace.current_trace_id()
    evs = metrics.query_events(tid) if tid else metrics.last_query()
    return max((int(e.get("bytes", 0)) for e in evs
                if e.get("kind") == "stage_bytes"), default=0)


def _note_measured_resident(lp) -> None:
    """Seed admission's measured-bytes table keyed on the optimized plan
    after a resident run (``DataFrame._execute`` keys on the raw plan;
    the planned-chunk pre-step and the hybrid join see the optimized
    one, so both keys are filled)."""
    try:
        from spark_tpu_torch.scheduler import admission

        admission.note_measured_bytes(lp, query_peak_stage_bytes())
    except Exception:  # noqa: BLE001 - observability never fails a query
        pass


def _grant_planned_chunk(lp, conf, manager):
    """Planned degradation before execution, the path with no replan:
    where a measured earlier run of this plan shape says its working set
    exceeds what the unified memory manager could offer now (storage
    pins, a shrunken budget), plan the chunked tier at the free span
    now instead of letting the device OOM and walking the ladder.
    Measured bytes only: static estimates are too noisy to pre-chunk
    on. Returns ``(found, shadow_conf)`` or ``(None, None)``."""
    from spark_tpu_torch.physical.chunked import JOIN_HYBRID_ENABLED
    from spark_tpu_torch.scheduler import admission

    try:
        if manager is None or not bool(conf.get(JOIN_HYBRID_ENABLED)):
            return None, None
        measured = admission.measured_plan_bytes(lp)
        if not measured:
            return None, None
        # the span free for execution; the query's own grant is not
        # modeled: storage is what it cannot evict past
        with manager.lock:
            avail = manager.budget - manager.storage_bytes()
        if avail <= 0 or int(measured) <= avail:
            return None, None
    except Exception:  # noqa: BLE001 - no plan: the usual path
        return None, None
    found, shadow = plan_chunk_first(lp, conf, avail)
    if found is None:
        return None, None
    metrics.record("planned_chunked", budget=avail,
                   measured=int(measured))
    return found, shadow


def run_plan_with_oom_degradation(lp, conf, run_fn, device="cuda",
                                  manager=None, mesh=None):
    """Run an optimized logical plan with the degradation ladder: a plan
    whose scans exceed the device budget runs chunked; a plan whose
    measured working set exceeds what the session's memory manager
    (``manager``) can grant now is planned into the chunked tier before
    it runs (``planned_chunked``, no replan); a run that dies of
    an OOM on a mesh (``mesh``: the session's mesh executor) with
    adaptive execution off is retried once with it forced on (rung 0);
    then the plan replans through ``find_chunkable``/``execute_chunked``
    at a halved budget, down to the floor. Every replan counts in
    ``last_ladder`` and chains the OOM that caused it as ``__cause__``.
    ``run_fn(plan) -> Batch`` is the engine."""
    from spark_tpu_torch.conf import RuntimeConf
    from spark_tpu_torch.physical.chunked import (MAX_DEVICE_BATCH_BYTES,
                                                  execute_chunked,
                                                  find_chunkable)

    global last_ladder
    record: Dict[str, Any] = {"replans": 0, "adaptive_retries": 0,
                              "budgets": [],
                              "stages_dropped": 0, "cache_emptied": False,
                              "exhausted": False, "error": None}
    last_ladder = record
    try:
        found = find_chunkable(lp, conf)
        chunk_conf = conf
        if found is None:
            found, shadow = _grant_planned_chunk(lp, conf, manager)
            if found is not None:
                chunk_conf = shadow
        if found is not None:
            return execute_chunked(found, chunk_conf, run_fn, device,
                                   manager)
        # the whole-batch device execution seam
        faults.inject("execute.device", conf)
        out = run_fn(lp)
        if mesh is not None:  # only a mesh measures its stages
            _note_measured_resident(lp)
        return out
    except Exception as e:  # noqa: BLE001 - re-raised unless an OOM
        if not (conf.get(OOM_DEGRADE_ENABLED) and is_oom(e)):
            raise
        last = e
    record["error"] = repr(last)
    record.update(_release_device_memory(device))

    if mesh is not None:
        # rung 0: adaptive execution, cheaper than chunking (no re-decode)
        from spark_tpu_torch.parallel import executor as mex

        if not (mex.FORCE_ADAPTIVE.get()
                or bool(conf.get(mex.ADAPTIVE_ENABLED))):
            record["replans"] += 1
            record["adaptive_retries"] += 1
            metrics.note_recovery("replans")
            metrics.record("degraded_to_adaptive", error=repr(last))
            token = mex.FORCE_ADAPTIVE.set(True)
            try:
                out = run_fn(lp)
                metrics.record("fault_recovered", point="execute.device",
                               how="degraded_to_adaptive")
                return out
            except Exception as e2:  # noqa: BLE001 - re-raised unless OOM
                if not is_oom(e2):
                    raise
                if e2.__cause__ is None and e2 is not last:
                    e2.__cause__ = last
                last = e2  # compaction was not enough: chunk
            finally:
                mex.FORCE_ADAPTIVE.reset(token)

    budget = int(conf.get(MAX_DEVICE_BATCH_BYTES))
    floor = max(1, int(conf.get(OOM_DEGRADE_FLOOR)))
    # a shadow of the settings: the shrinking budget must not leak into
    # the session (its next query starts from the configured budget)
    shadow = RuntimeConf(dict(conf._overrides))
    attempted = False
    while budget // 2 >= floor:
        budget //= 2
        shadow.set(MAX_DEVICE_BATCH_BYTES.key, budget)
        found = find_chunkable(lp, shadow)
        if found is None:
            continue  # still under the halved budget: halve again
        attempted = True
        record["replans"] += 1
        record["budgets"].append(budget)
        metrics.note_recovery("replans")
        metrics.record("degraded_to_chunked", budget=budget,
                       error=repr(last))
        try:
            out = execute_chunked(found, shadow, run_fn, device, manager)
        except Exception as e2:  # noqa: BLE001 - re-raised unless an OOM
            if not is_oom(e2):
                raise
            if e2.__cause__ is None and e2 is not last:
                e2.__cause__ = last  # the replan history rides the chain
            last = e2
            continue
        metrics.record("fault_recovered", point="execute.device",
                       how="degraded_to_chunked", budget=budget)
        return out
    record["exhausted"] = True
    metrics.note_recovery("ladder_exhausted")
    if not attempted:
        # no budget made the plan chunkable (no file scan to stream):
        # the ladder has nothing to offer, so the original OOM surfaces
        raise last
    raise RuntimeError(
        f"device OOM persisted after degrading the batch budget down to "
        f"the {floor}-byte floor (last: {last!r})") from last


def plan_chunk_first(lp, conf, budget_bytes: int):
    """A forced chunked plan: the device budget shrunk to
    ``budget_bytes`` on a shadow of the settings, so ``find_chunkable``
    fires even for a plan that fits; ``(found, shadow_conf)`` for
    ``execute_chunked``, or ``(None, None)`` when the plan has no
    chunkable shape."""
    from spark_tpu_torch.conf import RuntimeConf
    from spark_tpu_torch.physical.chunked import (MAX_DEVICE_BATCH_BYTES,
                                                  find_chunkable)

    shadow = RuntimeConf(dict(conf._overrides))
    shadow.set(MAX_DEVICE_BATCH_BYTES.key, max(1, int(budget_bytes)))
    found = find_chunkable(lp, shadow)
    if found is None:
        return None, None
    return found, shadow


def run_stage_with_recovery(fn: Callable, *, conf=None,
                            label: str = "stage"):
    """Run ``fn`` (a query thunk that replans from the logical plan),
    retrying transient environment failures up to
    ``spark.stage.maxConsecutiveAttempts`` times. Each re-attempt draws
    from the query's retry budget (``retry_allowed``), runs in a
    ``fault.retry`` span and sleeps a full-jitter backoff capped by the
    caller's deadline. Anything else is raised at once."""
    attempts = int(conf.get(STAGE_MAX_ATTEMPTS)) if conf is not None \
        else STAGE_MAX_ATTEMPTS.default
    attempts = max(1, attempts)
    last: Optional[BaseException] = None
    for attempt in range(attempts):
        try:
            # a re-attempt gets its own span, so a trace shows the time
            # lost to recovery and not only the winning attempt
            rspan = trace.span("fault.retry", point=label,
                               attempt=attempt) if attempt \
                else nullcontext()
            with rspan:
                out = fn()
            if attempt:
                metrics.record("fault_recovered", point=label,
                               how="stage_retry", attempts=attempt)
            return out
        except Exception as e:  # noqa: BLE001 - re-raised unless transient
            if not is_transient(e):
                raise
            last = e
            metrics.record("stage_retry", label=label, attempt=attempt,
                           error=repr(e))
            if attempt + 1 >= attempts:
                break
            deadline.check(label)  # the caller may already be gone
            if not retry_allowed(label):
                raise RetryBudgetExhausted(label, _BUDGET.get()) from last
            backoff_sleep(attempt, base_s=0.1, cap_s=2.0)
    raise RuntimeError(
        f"{label} failed {attempts} consecutive attempts "
        f"(last: {last!r})") from last


class HeartbeatMonitor:
    """Liveness probe: a daemon thread runs a trivial computation on
    ``device`` every interval and records the result in the event log
    (``heartbeat`` events). ``healthy()`` is False once a
    probe fails or the loop stops beating (hang detection)."""

    def __init__(self, interval_s: Optional[float] = None,
                 device="cuda"):
        self.interval = float(interval_s if interval_s is not None
                              else HEARTBEAT_INTERVAL.default)
        self.device = device
        self._stop = threading.Event()
        self._last_ok: Optional[float] = None
        self._last_error: Optional[str] = None
        self._last_err_ts: float = 0.0
        self._thread: Optional[threading.Thread] = None

    def _probe(self) -> None:
        import torch

        x = torch.ones(8, dtype=torch.float32, device=self.device)
        got = float(x.sum().item())  # waits for the device
        if got != 8.0:
            raise RuntimeError(f"heartbeat probe computed {got} != 8.0")

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self._probe()
                self._last_ok = time.time()
                metrics.record("heartbeat", ok=True)
            except Exception as e:  # noqa: BLE001 - recorded, not raised
                self._last_error = repr(e)
                self._last_err_ts = time.time()
                metrics.record("heartbeat", ok=False, error=repr(e))

    def start(self) -> "HeartbeatMonitor":
        if self._thread is None:
            # one synchronous probe, so healthy() means something at once
            try:
                self._probe()
                self._last_ok = time.time()
            except Exception as e:  # noqa: BLE001 - recorded, not raised
                self._last_error = repr(e)
                self._last_err_ts = time.time()
            self._thread = threading.Thread(
                target=self._loop, name="spark-tpu-torch-heartbeat",
                daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def healthy(self, max_silence_s: Optional[float] = None) -> bool:
        if self._last_ok is None:
            return False
        if self._last_err_ts > self._last_ok:  # failed since last success
            return False
        silence = max_silence_s if max_silence_s is not None \
            else 3 * self.interval
        return (time.time() - self._last_ok) <= silence

    def status(self) -> dict:
        return {"last_ok": self._last_ok, "last_error": self._last_error,
                "interval_s": self.interval}


_CKPT_COUNTER = [0]
_CKPT_LOCK = locks.named_lock("recovery.checkpoint")


def checkpoint_dataframe(df, eager: bool = True):
    """Durable checkpoint: the rows written as Parquet under
    ``spark.checkpoint.dir`` and a DataFrame scanning the files, lineage
    truncated (reference: ReliableCheckpointRDD; RDD.scala:1627)."""
    session = df.sparkSession
    d = str(session.conf.get(CHECKPOINT_DIR) or "")
    if not d:
        raise RuntimeError(
            "set spark.checkpoint.dir before calling checkpoint(); use "
            "localCheckpoint() for the in-memory variant")
    with _CKPT_LOCK:
        _CKPT_COUNTER[0] += 1
        seq = _CKPT_COUNTER[0]
    # the uuid keeps paths unique across sessions and processes
    path = os.path.join(
        d, f"ckpt-{os.getpid()}-{seq}-{uuid.uuid4().hex[:8]}")
    df.write.mode("overwrite").parquet(path)
    out = session.read.parquet(path)
    if eager:
        out.count()
    return out
