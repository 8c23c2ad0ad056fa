"""Query-level scheduler (the port of ``spark_tpu/scheduler/scheduler.py``):
lifecycle, worker threads, device admission; the query-level analogue of
the reference's TaskSchedulerImpl.scala + Pool.scala.

- queries are submitted into named pools and move through
  QUEUED -> ADMITTED -> RUNNING -> FINISHED/FAILED/CANCELLED;
- a bounded set of worker threads runs host stages (parse, optimize,
  Parquet decode through the chunk pipeline) of several queries at once;
- device execution is gated by admission (``admission.py``): a query
  passes the gate only when its estimated footprint fits the shared
  budget and it is the policy's best waiter, FIFO by submit order or
  FAIR by each pool's device time over its weight. Grants go strictly
  in policy order (no bypass), so a large query may wait for the budget
  to drain but never starves behind a stream of small ones;
- the queue is bounded: a submit at full depth raises
  ``SchedulerQueueFull`` at once (the connect server answers 429 with
  Retry-After);
- ``scheduler.admit`` is a fault seam: a transient fault retries the
  admission (bounded by ``spark.stage.maxConsecutiveAttempts`` and the
  query's retry budget), an injected OOM halves the footprint estimate
  down to the degradation floor, corruption surfaces typed.

Each worker runs its ticket in the submitter's trace, under the
ticket's deadline and a fresh retry budget, and collects the planner's
run records of the query into ``QueryTicket.runs``
(``planner.recording_runs``): with several queries at once the
module-global ``planner.last_run`` belongs to whichever finished last.
Several workers run stages on one card at once; ``physical/graphs.py``
says how captures and replays stay apart.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from spark_tpu_torch import locks
from spark_tpu_torch import conf as CF
from spark_tpu_torch import deadline as DL
from spark_tpu_torch import faults, metrics
from spark_tpu_torch.scheduler.admission import (AdmissionController,
                                           estimate_plan_bytes)
from spark_tpu_torch.scheduler.pool import PoolRegistry
from spark_tpu_torch.slo.edf import edf_key

QUEUED = "QUEUED"
ADMITTED = "ADMITTED"
RUNNING = "RUNNING"
FINISHED = "FINISHED"
FAILED = "FAILED"
CANCELLED = "CANCELLED"

#: states a ticket can still leave
_LIVE = (QUEUED, ADMITTED, RUNNING)


class SchedulerQueueFull(RuntimeError):
    """Submit rejected: the bounded queue is at depth. Carries the
    Retry-After hint the connect server forwards with its 429."""

    def __init__(self, depth: int, retry_after_s: float):
        super().__init__(
            f"scheduler queue full ({depth} queued); retry after "
            f"{retry_after_s:g}s")
        self.retry_after_s = float(retry_after_s)


class QueryCancelled(RuntimeError):
    """The query was cancelled (explicitly or by its deadline)."""


class QueryTicket:
    """Handle for one submitted query: state, result, cancellation."""

    def __init__(self, qid: int, *, pool: str, description: str,
                 run: Callable, prepare: Optional[Callable],
                 est_bytes: int, deadline: Optional[float]):
        self.id = qid
        self.pool = pool
        self.description = description
        self.est_bytes = int(est_bytes)
        self.deadline = deadline  # absolute time.time(), or None
        self.state = QUEUED
        self.submitted_t = time.time()
        self.admitted_t: Optional[float] = None
        self.started_t: Optional[float] = None
        self.finished_t: Optional[float] = None
        self.device_ms = 0.0
        self.error: Optional[BaseException] = None
        self._run = run
        self._prepare = prepare
        self._result: Any = None
        self._done = threading.Event()
        self._cancel = threading.Event()
        self._charge = 0  # admission bytes currently held
        #: per-query unified RetryBudget, attached by the worker at
        #: execution start (None before that / when disabled)
        self.retry_budget = None
        self._granted = False  # holding an admission grant (charge may
        # legitimately be 0 when storage eviction covered the footprint)
        #: SLO stamps — all None/False unless spark.tpu.slo.enabled
        self.slo_fp: Optional[str] = None
        self.slo_rows: Optional[float] = None
        self.slo_run_pred_ms: Optional[float] = None
        self.slo_predicted_ms: Optional[float] = None
        self._slo_picked = False
        # span context of the submitting thread (connect request /
        # client): workers re-enter it so the whole execution — stages,
        # faults, retries — attributes to the submitter's trace
        self._trace_ctx = metrics.trace_context()
        #: the planner's run records of this query (``planner.RunStats``,
        #: one per engine run), collected on the worker
        self.runs: list = []

    # -- client surface ------------------------------------------------------

    def cancel(self) -> bool:
        """Request cancellation. Queued queries are cancelled
        immediately by the scheduler; running queries observe it at
        their next ``check_cancelled()`` seam. Returns False when the
        query already finished."""
        if self._done.is_set():
            return False
        self._cancel.set()
        return True

    def cancelled(self) -> bool:
        return self._cancel.is_set()

    def check_cancelled(self) -> None:
        """Cooperative cancellation/deadline seam for running queries."""
        if self._cancel.is_set():
            raise QueryCancelled(f"query {self.id} cancelled")
        if self.deadline is not None and time.time() > self.deadline:
            raise QueryCancelled(
                f"DEADLINE_EXCEEDED: query {self.id} passed its "
                f"deadline")

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> Any:
        """Block until the query finishes; raise its error if it
        FAILED or was CANCELLED."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"query {self.id} still {self.state} after {timeout}s")
        if self.error is not None:
            raise self.error
        return self._result

    def queue_wait_ms(self) -> float:
        end = self.admitted_t or self.finished_t or time.time()
        return max(0.0, (end - self.submitted_t) * 1e3)

    def info(self) -> Dict[str, Any]:
        return {
            "id": self.id, "pool": self.pool,
            "description": self.description[:200],
            "state": self.state, "est_bytes": self.est_bytes,
            "submitted": round(self.submitted_t, 3),
            "queue_wait_ms": round(self.queue_wait_ms(), 2),
            "device_ms": round(self.device_ms, 2),
            "error": repr(self.error) if self.error is not None
            else None,
            # SLO fields appear only when the subsystem predicted this
            # query (absent = payload byte-identical to the pre-SLO one)
            **({"slo_predicted_ms": round(self.slo_predicted_ms, 2)}
               if self.slo_predicted_ms is not None else {}),
        }


class QueryScheduler:
    """The control plane. One per serving session (the connect server
    builds one and registers it on the session for the UI)."""

    def __init__(self, session=None, conf=None):
        if conf is None:
            conf = session.conf if session is not None else CF.RuntimeConf()
        self._conf = conf
        self._session = session
        self.mode = str(conf.get(CF.SCHEDULER_MODE)).upper()
        if self.mode not in ("FIFO", "FAIR"):
            raise ValueError(
                f"spark.scheduler.mode must be FIFO or FAIR, got "
                f"{self.mode!r}")
        self.max_queue_depth = max(
            0, int(conf.get(CF.SCHEDULER_QUEUE_DEPTH)))
        self.retry_after_s = float(conf.get(CF.SCHEDULER_RETRY_AFTER))
        self.pools = PoolRegistry(conf)
        # share the session's unified storage/execution memory manager
        # when there is one, so admission can reclaim unpinned cached
        # batches; a conf-only scheduler (tests) gets a private manager
        self.admission = AdmissionController(
            int(conf.get(CF.SCHEDULER_HBM_BUDGET)),
            manager=getattr(session, "memory_manager", None))
        self._cond = locks.named_condition("scheduler.cond")
        # grant releases by OTHER tenants of the shared manager (hybrid
        # join spill grants, direct manager users) must wake the gate
        # too, not just this scheduler's own _release. The manager fires
        # listeners after dropping its lock, so the callback's
        # cond-acquire creates no storage.unified -> scheduler.cond
        # hierarchy edge.
        self.admission.manager.add_release_listener(self._wake_gate)
        self._seq = 0
        self._queued = 0
        self._gate: List[QueryTicket] = []  # waiting for device admission
        self._recent: deque = deque(maxlen=256)  # finished + live tickets
        self._stopped = False
        self.rejected = 0
        n_workers = max(1, int(conf.get(CF.SCHEDULER_MAX_CONCURRENCY)))
        # SLO control plane: None unless
        # spark.tpu.slo.enabled — every SLO branch below is guarded on
        # ``self._slo is not None`` so the FIFO/FAIR paths are
        # byte-identical to the pre-SLO scheduler when off
        self._slo = None
        self._active_runs = 0  # tickets picked and not yet finished
        if bool(conf.get(CF.SLO_ENABLED)):
            try:
                from spark_tpu_torch.slo.controller import SloController
                from spark_tpu_torch.slo.model import (LatencyModel,
                                                 model_path_from_conf)

                model = LatencyModel(
                    model_path_from_conf(conf),
                    alpha=float(conf.get(CF.SLO_MODEL_ALPHA)),
                    max_entries=int(conf.get(CF.SLO_MODEL_MAX_ENTRIES)))
                self._slo = SloController(conf, model, n_workers)
            except Exception:
                self._slo = None  # SLO is advisory: never block startup
        self._workers = [
            threading.Thread(target=self._worker_loop, daemon=True,
                             name=f"spark-tpu-sched-{i}")
            for i in range(n_workers)]
        for w in self._workers:
            w.start()

    # -- submission ----------------------------------------------------------

    def submit(self, run: Callable, *, prepare: Optional[Callable] = None,
               pool: Optional[str] = None, description: str = "",
               est_bytes: Optional[int] = None,
               deadline_s: Optional[float] = None,
               slo_fp: Optional[str] = None,
               slo_rows: Optional[float] = None) -> QueryTicket:
        """Queue a query. ``prepare(ticket)`` is the host-side stage
        (parse/optimize/estimate; runs concurrently on the worker pool,
        may return a refined est_bytes); ``run(ticket)`` is the
        device-side stage, entered only after HBM admission. Raises
        SchedulerQueueFull at full queue depth, and — when
        spark.tpu.slo.enabled with a deadline set and ``slo_fp`` known
        to the latency model — InfeasibleDeadline when predicted
        completion already exceeds the deadline (reject-at-admission:
        the query is shed before it costs a queue slot)."""
        p = self.pools.get(pool)
        deadline = time.time() + float(deadline_s) \
            if deadline_s is not None else None
        # the submitter's propagated absolute deadline (connect header,
        # collect-minted) rides onto the ticket; the tighter bound wins
        ambient = DL.current()
        if ambient is not None:
            deadline = ambient if deadline is None \
                else min(deadline, ambient)
        # prediction + reject-gate fault seams run OUTSIDE the condition
        # lock (a hang-kind injection must never stall the scheduler
        # while holding it); the feasibility math itself is pure and
        # runs under the lock against the live backlog
        pred_ms = None
        slo_reject = False
        if self._slo is not None:
            pred_ms = self._slo.predict_run_ms(slo_fp, slo_rows)
            if deadline is not None and pred_ms is not None:
                slo_reject = self._slo.reject_gate()
        with self._cond:
            if self._stopped:
                raise RuntimeError("scheduler is stopped")
            if self._queued >= self.max_queue_depth:
                self.rejected += 1
                metrics.record("scheduler", phase="rejected",
                               pool=p.name, queued=self._queued)
                raise SchedulerQueueFull(self._queued, self.retry_after_s)
            predicted_total = None
            if self._slo is not None and pred_ms is not None:
                # the queue-wait model must match the EDF pick: a
                # deadlined submit only waits behind queued tickets
                # whose deadline sorts at-or-before its own (it jumps
                # the rest), while a deadline-less submit sorts last
                # and waits behind everything; in-flight work can't be
                # preempted either way
                predicted_total = self._slo.admission_check_locked(
                    deadline=deadline, pred_run_ms=pred_ms,
                    pending_ms=[x.slo_run_pred_ms
                                for q in self.pools.all()
                                for x in q.queue
                                if deadline is None
                                or (x.deadline is not None
                                    and x.deadline <= deadline)],
                    inflight_ms=[x.slo_run_pred_ms
                                 for x in self._recent
                                 if x.state in (ADMITTED, RUNNING)],
                    reject=slo_reject)
            self._seq += 1
            t = QueryTicket(
                self._seq, pool=p.name, description=description,
                run=run, prepare=prepare,
                est_bytes=est_bytes if est_bytes is not None
                else self.admission.budget,
                deadline=deadline)
            t.slo_fp = slo_fp
            t.slo_rows = slo_rows
            t.slo_run_pred_ms = pred_ms
            t.slo_predicted_ms = predicted_total
            p.queue.append(t)
            p.running += 1  # dequeued-or-queued live count, see _finish
            self._queued += 1
            self._recent.append(t)
            metrics.record("scheduler", phase="submitted", id=t.id,
                           pool=p.name, est_bytes=t.est_bytes)
            self._cond.notify_all()
        return t

    def submit_query(self, build_df: Callable[[], Any], *,
                     pool: Optional[str] = None, description: str = "",
                     deadline_s: Optional[float] = None,
                     sql: Optional[str] = None) -> QueryTicket:
        """Engine-query convenience: ``build_df()`` -> DataFrame is the
        host-side parse/plan stage (its footprint is then estimated
        from the logical plan); the device stage materializes Arrow.
        ``sql`` is the raw statement when the caller has one (the
        connect server does): it rides on the DataFrame so the compile
        service's served-plan history records a replayable identity
        even for frames not built via session.sql."""
        holder: dict = {}

        def prepare(t: QueryTicket):
            df = build_df()
            if sql is not None and getattr(df, "_sql_text", None) is None:
                df._sql_text = sql
            holder["df"] = df
            conf = df._session.conf if df._session is not None \
                else self._conf
            if self._slo is not None:
                # refine the SLO identity once the plan exists: a
                # structural fingerprint for SQL-less submissions (so
                # the model still learns them) and scan-stat input
                # rows for size-scaled predictions on the next run
                from spark_tpu_torch.slo.model import (fingerprint_plan,
                                                 plan_input_rows)

                if t.slo_fp is None:
                    t.slo_fp = fingerprint_plan(df._plan)
                if t.slo_rows is None:
                    t.slo_rows = plan_input_rows(df._plan)
            return estimate_plan_bytes(df._plan, conf)

        def run(t: QueryTicket):
            t.check_cancelled()
            return holder["df"].toArrow()

        slo_fp = None
        if self._slo is not None and sql is not None:
            from spark_tpu_torch.slo.model import fingerprint_sql

            slo_fp = fingerprint_sql(sql)
        return self.submit(run, prepare=prepare, pool=pool,
                           description=description, deadline_s=deadline_s,
                           slo_fp=slo_fp)

    def cancel(self, qid: int) -> bool:
        """Cancel by id: a QUEUED query finishes CANCELLED right here;
        an ADMITTED/RUNNING one is flagged for its next seam."""
        with self._cond:
            t = next((x for x in self._recent if x.id == qid), None)
            if t is None or t.done():
                return False
            t._cancel.set()
            if t.state == QUEUED:
                p = self.pools.get(t.pool)
                if t in p.queue:
                    p.queue.remove(t)
                    self._queued -= 1
                    self._finish_locked(
                        t, CANCELLED,
                        error=QueryCancelled(
                            f"query {t.id} cancelled while queued"))
            self._cond.notify_all()
            return True

    # -- introspection -------------------------------------------------------

    def queue_depth(self) -> int:
        """Live queued-query count (NOT the configured bound) under the
        scheduler lock — the federation router's load signal."""
        with self._cond:
            return self._queued

    def running_count(self) -> int:
        """Queries past the queue (ADMITTED at the device gate or
        RUNNING on a worker) right now, under the scheduler lock."""
        with self._cond:
            return sum(1 for t in self._recent
                       if t.state in (ADMITTED, RUNNING))

    def status(self) -> Dict[str, Any]:
        with self._cond:
            st = {
                "mode": self.mode,
                "queue_depth": self.max_queue_depth,
                "queued": self._queued,
                "gate_waiters": len(self._gate),
                "rejected": self.rejected,
                "admission": self.admission.snapshot(),
                "pools": [p.snapshot() for p in self.pools.all()],
            }
            if self._slo is not None:
                st["slo"] = self._slo.snapshot()
            return st

    def ticket(self, qid: int) -> Optional[QueryTicket]:
        """The recent or live ticket with id ``qid``, or None."""
        with self._cond:
            return next((t for t in self._recent if t.id == qid), None)

    def describe(self, n: int = 64) -> List[Dict[str, Any]]:
        """Recent + live tickets, newest first (the /queries payload)."""
        with self._cond:
            return [t.info() for t in list(self._recent)[-n:]][::-1]

    # -- worker side ---------------------------------------------------------

    def _pick_locked(self) -> Optional[QueryTicket]:
        """Next ticket to dequeue, per policy; purges cancelled and
        deadline-expired queue heads. Caller holds the lock."""
        now = time.time()
        if self._slo is not None:
            return self._pick_slo_locked(now)
        for p in self.pools.all():
            while p.queue:
                head = p.queue[0]
                if head.cancelled() or (head.deadline is not None
                                        and now > head.deadline):
                    p.queue.popleft()
                    self._queued -= 1
                    why = "cancelled while queued" if head.cancelled() \
                        else "DEADLINE_EXCEEDED while queued"
                    self._finish_locked(
                        head, CANCELLED,
                        error=QueryCancelled(f"query {head.id} {why}"))
                    continue
                break
        candidates = [p for p in self.pools.all() if p.queue]
        if not candidates:
            return None
        if self.mode == "FAIR":
            best = min(candidates, key=lambda p: p.fair_rank())
        else:
            best = min(candidates, key=lambda p: p.queue[0].id)
        t = best.queue.popleft()
        self._queued -= 1
        return t

    def _pick_slo_locked(self, now: float) -> Optional[QueryTicket]:
        """SLO pick: earliest-deadline-first across ALL pool queues
        (not just heads — EDF may owe the next slot to a mid-queue
        ticket), bounded by the controller's auto-sized effective
        concurrency. Purges cancelled/expired tickets anywhere in the
        queues: under EDF an expired ticket is never "in the way" at
        the head, so head-only purging would leak it. Caller holds
        the lock."""
        for p in self.pools.all():
            for x in list(p.queue):
                if x.cancelled() or (x.deadline is not None
                                     and now > x.deadline):
                    p.queue.remove(x)
                    self._queued -= 1
                    why = "cancelled while queued" if x.cancelled() \
                        else "DEADLINE_EXCEEDED while queued"
                    self._finish_locked(
                        x, CANCELLED,
                        error=QueryCancelled(f"query {x.id} {why}"))
        if self._active_runs >= self._slo.effective_concurrency():
            return None  # auto-sized below the worker count: idle some
        best: Optional[QueryTicket] = None
        best_pool = None
        for p in self.pools.all():
            for x in p.queue:
                if best is None or edf_key(x) < edf_key(best):
                    best, best_pool = x, p
        if best is None:
            return None
        best_pool.queue.remove(best)
        self._queued -= 1
        best._slo_picked = True
        self._active_runs += 1
        return best

    def _worker_loop(self) -> None:
        while True:
            with self._cond:
                t = None
                while not self._stopped:
                    t = self._pick_locked()
                    if t is not None:
                        break
                    # notify-driven: submit/cancel/stop/finish all
                    # notify; the timeout is only a liveness backstop
                    self._cond.wait(0.5)
                if self._stopped:
                    return
            self._execute(t)

    def _execute(self, t: QueryTicket) -> None:
        from spark_tpu_torch import recovery, trace
        from spark_tpu_torch.physical import planner

        # worker threads don't inherit the submitter's contextvars;
        # re-enter the captured span context so the run attributes to
        # the submitting request's trace (root here for tickets
        # submitted outside any trace). The ticket's absolute deadline
        # and a fresh per-query RetryBudget enter scope the same way:
        # every retry/wait seam under this worker draws from ONE pool
        # and stops when the caller's deadline passes.
        t.retry_budget = recovery.budget_from_conf(self._conf)
        with trace.attach(t._trace_ctx), DL.bind(t.deadline), \
                recovery.bind_budget(t.retry_budget), \
                planner.recording_runs(t.runs):
            with trace.span("scheduler.run", id=t.id, pool=t.pool):
                self._execute_traced(t)

    def _execute_traced(self, t: QueryTicket) -> None:
        from spark_tpu_torch import trace

        try:
            t.check_cancelled()
            with trace.span("scheduler.queue", id=t.id, pool=t.pool):
                if t._prepare is not None:
                    # host-side stage: runs concurrently across workers
                    est = t._prepare(t)
                    if est:
                        t.est_bytes = int(est)
                self._admit(t)
            t.state = RUNNING
            t.started_t = time.time()
            t.check_cancelled()
            out = t._run(t)
            self._finish(t, FINISHED, result=out)
            if self._slo is not None:
                # fold the completed run back into the latency model
                # (no scheduler lock held here; never raises)
                self._slo.note_finished(t)
        except (QueryCancelled, DL.DeadlineExceeded) as e:
            self._finish(t, CANCELLED, error=e)
        except Exception as e:  # noqa: BLE001 — typed via ticket.error
            self._finish(t, FAILED, error=e)
        finally:
            self._release(t)
            with self._cond:
                self._cond.notify_all()

    # -- the device-admission gate -------------------------------------------

    def _gate_best_locked(self) -> Optional[QueryTicket]:
        if not self._gate:
            return None
        if self._slo is not None:
            return min(self._gate, key=edf_key)
        if self.mode == "FAIR":
            return min(self._gate, key=lambda x:
                       self.pools.get(x.pool).fair_rank() + (x.id,))
        return min(self._gate, key=lambda x: x.id)

    def _admit(self, t: QueryTicket) -> None:
        """Pass the HBM admission gate, then the ``scheduler.admit``
        fault seam: transient faults re-admit (bounded attempts),
        injected OOM halves the footprint estimate down to the
        degradation floor, corruption surfaces typed."""
        from spark_tpu_torch import recovery

        attempts = max(1, int(self._conf.get(recovery.STAGE_MAX_ATTEMPTS)))
        floor = max(1, int(self._conf.get(recovery.OOM_DEGRADE_FLOOR)))
        last: Optional[BaseException] = None
        for attempt in range(attempts):
            self._gate_wait(t)
            try:
                faults.inject("scheduler.admit", self._conf)
                if attempt:
                    metrics.record("fault_recovered",
                                   point="scheduler.admit",
                                   how="admit_retry", attempts=attempt)
                t.state = ADMITTED
                t.admitted_t = time.time()
                metrics.record("scheduler", phase="admitted", id=t.id,
                               pool=t.pool, est_bytes=t.est_bytes,
                               queue_wait_ms=round(t.queue_wait_ms(), 2))
                return
            except Exception as e:
                self._release(t)
                with self._cond:
                    self._cond.notify_all()
                last = e
                if recovery.is_oom(e):
                    # admission-side degradation rung: shrink the
                    # claimed footprint; execution's own OOM ladder
                    # (run_plan_with_oom_degradation) guards the rest
                    if t.est_bytes // 2 < floor:
                        raise
                    t.est_bytes //= 2
                    metrics.record("scheduler", phase="admit_degraded",
                                   id=t.id, pool=t.pool,
                                   est_bytes=t.est_bytes)
                    continue
                if recovery.is_transient(e):
                    metrics.record("stage_retry",
                                   label="scheduler.admit",
                                   attempt=attempt, error=repr(e))
                    # a re-admission is a re-attempt like any other:
                    # it draws from the query's unified budget so
                    # admit retries and execution retries share one
                    # per-query pool instead of stacking
                    if not recovery.retry_allowed("scheduler.admit"):
                        raise recovery.RetryBudgetExhausted(
                            "scheduler.admit",
                            recovery.current_budget()) from e
                    continue
                raise
        raise RuntimeError(
            f"scheduler.admit failed {attempts} consecutive attempts "
            f"(last: {last!r})") from last

    def _gate_wait(self, t: QueryTicket) -> None:
        """Block until this ticket is the policy-best gate waiter AND
        its estimate fits the budget; acquires the admission charge."""
        with self._cond:
            self._gate.append(t)
            try:
                while True:
                    t.check_cancelled()
                    if self._stopped:
                        raise QueryCancelled(
                            f"query {t.id} cancelled: scheduler stopped")
                    if (self._gate_best_locked() is t
                            and self.admission.fits(t.est_bytes)):
                        t._charge = self.admission.acquire(t.est_bytes)
                        t._granted = True
                        self.pools.get(t.pool).device_running += 1
                        t._gate_t0 = time.perf_counter()
                        return
                    # notify-driven: grant releases (scheduler's own
                    # _release and, via the manager's release listener,
                    # any other tenant's), cancel and stop all notify.
                    # The timeout is a deadline/liveness backstop only.
                    timeout = 0.5
                    if t.deadline is not None:
                        timeout = min(
                            timeout, max(0.01, t.deadline - time.time()))
                    self._cond.wait(timeout)
            finally:
                self._gate.remove(t)
                # the policy-best waiter changed: wake the others so
                # the new best re-checks its fit without polling
                self._cond.notify_all()

    def _wake_gate(self) -> None:
        """Release-listener target: an execution grant somewhere on the
        shared memory manager was released, so a gate waiter may fit."""
        with self._cond:
            self._cond.notify_all()

    def _release(self, t: QueryTicket) -> None:
        if t._granted:
            self.admission.release(t._charge)
            t._charge = 0
            t._granted = False
            elapsed_ms = (time.perf_counter() - t._gate_t0) * 1e3
            t.device_ms += elapsed_ms
            with self._cond:
                p = self.pools.get(t.pool)
                p.device_ms += elapsed_ms
                p.device_running -= 1

    # -- lifecycle end -------------------------------------------------------

    def _finish(self, t: QueryTicket, state: str, result=None,
                error: Optional[BaseException] = None) -> None:
        self._release(t)
        with self._cond:
            self._finish_locked(t, state, result=result, error=error)

    def _finish_locked(self, t: QueryTicket, state: str, result=None,
                       error: Optional[BaseException] = None) -> None:
        if t.done():
            return
        if t._slo_picked:
            t._slo_picked = False
            self._active_runs -= 1
        t.state = state
        t._result = result
        t.error = error
        t.finished_t = time.time()
        p = self.pools.get(t.pool)
        p.running -= 1
        if state == FINISHED:
            p.finished += 1
        metrics.record("scheduler", phase=state.lower(), id=t.id,
                       pool=t.pool,
                       queue_wait_ms=round(t.queue_wait_ms(), 2),
                       device_ms=round(t.device_ms, 2),
                       error=repr(error) if error is not None else None)
        t._done.set()

    # -- shutdown ------------------------------------------------------------

    def stop(self, timeout: float = 5.0) -> None:
        """Stop workers; queued queries finish CANCELLED, running ones
        are flagged and joined briefly (daemon threads — a wedged query
        cannot wedge interpreter exit)."""
        with self._cond:
            self._stopped = True
            for p in self.pools.all():
                while p.queue:
                    t = p.queue.popleft()
                    self._queued -= 1
                    self._finish_locked(
                        t, CANCELLED,
                        error=QueryCancelled(
                            f"query {t.id} cancelled: scheduler stopped"))
            for t in self._recent:
                if not t.done():
                    t._cancel.set()
            self._cond.notify_all()
        deadline = time.time() + timeout
        for w in self._workers:
            w.join(max(0.0, deadline - time.time()))
