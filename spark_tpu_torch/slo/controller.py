"""SLO controller: predictive brownout + auto-sized concurrency (the port
of ``spark_tpu/slo/controller.py``).

One instance per :class:`~spark_tpu.scheduler.scheduler.QueryScheduler`
(constructed only when ``spark.tpu.slo.enabled`` is true — when it is
None the scheduler's FIFO/FAIR paths are byte-identical to before).
Three responsibilities:

1. **Prediction seam** — wraps the :class:`LatencyModel` behind the
   ``slo.predict`` fault point; a failed/injected prediction degrades
   to "no prediction" (FIFO-equivalent for that query), never an error.

2. **Reject-at-admission** — :meth:`admission_check_locked` (called by
   ``submit`` under ``scheduler.cond`` BEFORE the ticket exists)
   compares predicted completion against the caller's deadline and
   raises the typed :class:`InfeasibleDeadline` when the query is
   doomed. The decision gate itself sits behind the ``slo.reject``
   fault point and FAILS OPEN: an injected fault disables rejection
   for that submit, it never rejects spuriously.

3. **Predictive brownout + auto-concurrency** — a sliding window of
   predicted completion times drives brownout entry/exit against the
   configured p99 target *before* queries are observably late (vs the
   serve-layer BrownoutController, which reacts to observed
   failures), and EWMA'd queue/run ratios shrink or grow the
   scheduler's effective concurrency between the configured floor and
   ``spark.tpu.scheduler.maxConcurrency``.

Lock order: ``slo.controller`` (rank 325) and ``slo.model`` (320) are
both legal under ``scheduler.cond`` (300); the controller NEVER calls
into the model while holding its own lock, so 325->320 never nests.
Fault injection happens OUTSIDE ``scheduler.cond`` (in the predict /
reject-gate phases) so a hang-kind injection can never stall the
scheduler with the condition lock held.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict, List, Optional

from spark_tpu_torch import conf as CF
from spark_tpu_torch import faults, locks, metrics, trace
from spark_tpu_torch.slo import edf
from spark_tpu_torch.slo.model import LatencyModel


def _p99(values: List[float]) -> float:
    if not values:
        return 0.0
    s = sorted(values)
    idx = min(len(s) - 1, int(0.99 * (len(s) - 1) + 0.999999))
    return s[idx]


class SloController:
    """Predict -> schedule -> shed loop state for one scheduler."""

    def __init__(self, conf, model: LatencyModel, max_concurrency: int):
        self._conf = conf
        self.model = model
        self._lock = locks.named_lock("slo.controller")
        self._max = max(1, int(max_concurrency))
        self._effective = self._max
        self._target_ms = float(conf.get(CF.SLO_TARGET_P99_MS))
        self._margin = float(conf.get(CF.SLO_REJECT_MARGIN))
        self._reject = bool(conf.get(CF.SLO_REJECT_ENABLED))
        self._window_s = max(1.0, float(conf.get(CF.SLO_WINDOW_SECONDS)))
        self._min_preds = max(1, int(conf.get(CF.SLO_MIN_PREDICTIONS)))
        self._exit_ratio = min(1.0, max(0.1,
                               float(conf.get(CF.SLO_EXIT_RATIO))))
        self._autosize = bool(conf.get(CF.SLO_AUTOSIZE_ENABLED))
        self._auto_min = max(1, int(conf.get(CF.SLO_AUTOSIZE_MIN)))
        #: (wall-time, predicted completion ms) per admitted submit
        self._window: "deque[tuple]" = deque(maxlen=4096)
        self._level = 0
        self._queue_ewma: Optional[float] = None
        self._run_ewma: Optional[float] = None
        self._finished = 0
        self._last_resize = time.time()

    # -- prediction seam (outside scheduler.cond) ----------------------------

    def predict_run_ms(self, fp: Optional[str],
                       rows: Optional[float] = None) -> Optional[float]:
        """Predicted run time, or None (unknown fingerprint, model
        failure, or an injected ``slo.predict`` fault — all absorbed:
        no prediction just means FIFO-equivalent treatment)."""
        try:
            faults.inject("slo.predict", self._conf)
            pred = self.model.predict_run_ms(fp, rows)
            if pred is not None:
                metrics.note_slo("predictions")
            return pred
        except faults.InjectedFault:
            return None
        except Exception:
            return None

    def reject_gate(self) -> bool:
        """Whether reject-at-admission applies to this submit. The
        ``slo.reject`` fault point fails OPEN (gate off) so injection
        can only admit more, never shed spuriously."""
        if not self._reject:
            return False
        try:
            faults.inject("slo.reject", self._conf)
            return True
        except faults.InjectedFault:
            return False
        except Exception:
            return False

    # -- admission (under scheduler.cond; pure computation) ------------------

    def admission_check_locked(self, *, deadline: Optional[float],
                               pred_run_ms: Optional[float],
                               pending_ms: List[float],
                               inflight_ms: List[float],
                               reject: bool) -> Optional[float]:
        """Feasibility check for one submit. Returns the predicted
        completion (queue + run, margin applied) or None when the
        model has nothing to say; raises
        :class:`~spark_tpu.slo.edf.InfeasibleDeadline` when ``reject``
        is on, a deadline is set, and the prediction says it will be
        missed. Pure computation — safe under ``scheduler.cond``."""
        if pred_run_ms is None:
            return None
        with trace.span("slo.admit", deadline=bool(deadline)):
            default_ms = self._run_ewma or pred_run_ms
            queue_ms = edf.backlog_ms(pending_ms, inflight_ms,
                                      self.effective_concurrency(),
                                      default_ms)
            ok, predicted_ms = edf.feasible(
                deadline if reject else None,
                queue_ms, pred_run_ms, self._margin)
            self._note_prediction(predicted_ms)
            if not ok:
                metrics.note_slo("rejects")
                metrics.record("slo", phase="reject",
                               predicted_ms=round(predicted_ms, 3))
                raise edf.InfeasibleDeadline(
                    predicted_ms, deadline,
                    queue_ms=queue_ms, run_ms=pred_run_ms)
            return predicted_ms

    def _note_prediction(self, predicted_ms: float) -> None:
        now = time.time()
        with self._lock:
            self._window.append((now, predicted_ms))
            self._update_brownout_locked(now)

    def _update_brownout_locked(self, now: float) -> None:
        """Predictive brownout: enter when the p99 of recent PREDICTED
        completions exceeds the target, exit (with hysteresis) when it
        falls back under exitRatio x target."""
        if self._target_ms <= 0:
            return
        while self._window and self._window[0][0] < now - self._window_s:
            self._window.popleft()
        # min_preds is noise protection for ENTERING only: a handful
        # of slow predictions must not flap the ladder. The exit check
        # runs on whatever recent evidence exists — requiring a full
        # window to exit would wedge a browned-out replica at level 1
        # forever once the overload (and thus the prediction stream)
        # that caused it dries up to a trickle.
        if not self._window \
                or (self._level == 0
                    and len(self._window) < self._min_preds):
            return
        p99 = _p99([ms for _, ms in self._window])
        if self._level == 0 and p99 > self._target_ms:
            self._level = 1
            metrics.set_brownout(1)
            metrics.note_slo("brownout_enters")
            metrics.record("slo", phase="brownout",
                           level=1, predicted_p99_ms=round(p99, 3))
        elif self._level > 0 and p99 <= self._exit_ratio * self._target_ms:
            self._level = 0
            metrics.set_brownout(0)
            metrics.note_slo("brownout_exits")
            metrics.record("slo", phase="brownout",
                           level=0, predicted_p99_ms=round(p99, 3))

    # -- observation (scheduler worker thread, no scheduler lock held) -------

    def note_finished(self, ticket) -> None:
        """Fold a FINISHED ticket back into the model and the
        auto-sizing EWMAs. Best-effort observability — never raises."""
        try:
            fp = getattr(ticket, "slo_fp", None)
            if not fp or ticket.started_t is None \
                    or ticket.finished_t is None:
                return
            run_ms = (ticket.finished_t - ticket.started_t) * 1e3
            queue_ms = ticket.queue_wait_ms() or 0.0
            device_ms, transfer_ms, cold = self._span_components(ticket)
            with trace.span("slo.observe", fp=fp, cold=cold):
                self.model.observe(
                    fp, run_ms=run_ms, queue_ms=queue_ms,
                    rows=getattr(ticket, "slo_rows", None),
                    device_ms=device_ms, transfer_ms=transfer_ms,
                    cold=cold)
            self._note_ratios(queue_ms, run_ms)
        except Exception:
            pass

    @staticmethod
    def _span_components(ticket):
        """(device_ms, transfer_ms, cold) from the query's trace
        events — components present only when trace sampling recorded
        them, (0, 0) otherwise. Span events carry their wall time as
        ``ms`` (trace.span); ``duration_ms`` is kept as a legacy
        fallback for externally-fed event logs. ``cold`` flags a
        CUDA-graph capture inside this trace (a ``stage_compile``
        event, the port's counterpart of the reference's compile-store
        miss): the run paid warm-up and capture, which no replay pays,
        and the model quarantines it in the cold component instead of
        folding it into the warm run-time EWMA."""
        device_ms = transfer_ms = 0.0
        cold = False
        try:
            ctx = getattr(ticket, "_trace_ctx", None)
            if ctx and getattr(ctx, "trace_id", None):
                for ev in metrics.query_events(ctx.trace_id):
                    if ev.get("kind") == "stage_compile":
                        cold = True
                    name = ev.get("span") or ev.get("name") or ""
                    dur = float(ev.get("duration_ms")
                                or ev.get("ms") or 0.0)
                    if name == "stage.device":
                        device_ms += dur
                    elif name == "pipeline.transfer":
                        transfer_ms += dur
        except Exception:
            pass
        return device_ms, transfer_ms, cold

    def _note_ratios(self, queue_ms: float, run_ms: float) -> None:
        """Auto-size effective concurrency from the queue/run ratio:
        queueing dominating run time means too many queries contend
        for the devices (shrink); near-empty queues mean headroom
        (grow back toward the configured maximum)."""
        a = 0.3
        with self._lock:
            self._queue_ewma = queue_ms if self._queue_ewma is None \
                else (1 - a) * self._queue_ewma + a * queue_ms
            self._run_ewma = run_ms if self._run_ewma is None \
                else (1 - a) * self._run_ewma + a * run_ms
            self._finished += 1
            if not self._autosize or self._run_ewma <= 1e-6 \
                    or self._finished < self._min_preds:
                return
            now = time.time()
            if now - self._last_resize < max(1.0, self._window_s / 10.0):
                return
            ratio = self._queue_ewma / self._run_ewma
            new = self._effective
            if ratio > 2.0:
                new = max(self._auto_min, self._effective - 1)
            elif ratio < 0.5:
                new = min(self._max, self._effective + 1)
            if new != self._effective:
                self._effective = new
                self._last_resize = now
                metrics.note_slo("resizes")
                metrics.set_gauge("slo.effective_concurrency", new)

    # -- introspection -------------------------------------------------------

    def effective_concurrency(self) -> int:
        with self._lock:
            return self._effective

    def brownout_level(self) -> int:
        with self._lock:
            return self._level

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            preds = [ms for _, ms in self._window]
            snap = {
                "target_p99_ms": self._target_ms,
                "reject_enabled": self._reject,
                "margin": self._margin,
                "effective_concurrency": self._effective,
                "max_concurrency": self._max,
                "brownout_level": self._level,
                "window_predictions": len(preds),
                "predicted_p99_ms": round(_p99(preds), 3),
                "queue_ewma_ms": round(self._queue_ewma or 0.0, 3),
                "run_ewma_ms": round(self._run_ewma or 0.0, 3),
            }
        snap["model"] = self.model.snapshot()
        return snap
