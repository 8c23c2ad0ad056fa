"""Earliest-feasible-deadline-first ordering and reject-at-admission
(the port of ``spark_tpu/slo/edf.py``).

Pure policy helpers for the SLO scheduler path (no locks, no IO, no
engine imports — scheduler/scheduler.py calls these under its own
condition lock). Two ideas:

- **EDF ordering** (:func:`edf_key`): among queued tickets, the one
  whose absolute deadline is earliest runs first; deadline-less tickets
  order FIFO *after* every deadlined one (a query that told us when it
  must finish outranks one that did not). Ties break on submit order,
  so the ordering is a total order and A/B-deterministic.

- **Feasibility** (:func:`feasible`): a submit whose predicted
  completion — queue backlog estimate plus its own predicted run time,
  scaled by ``spark.tpu.slo.rejectMargin`` — already exceeds its
  deadline is REJECTED at admission with the typed
  :class:`InfeasibleDeadline` instead of enqueued. Burning queue slots
  and device time on a query that is doomed to miss only makes every
  other query later; shedding it immediately is the whole point of the
  predict->schedule->shed loop.

Classification contract: like ``deadline.DeadlineExceeded``,
:class:`InfeasibleDeadline` is typed and terminal — never retried by
any layer on the same deadline (the prediction does not improve by
asking again), though the federation router may re-dispatch it to a
LESS LOADED replica under the unified retry budget (a different queue
is a different prediction).
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

#: sorts after every real deadline, before nothing
_NO_DEADLINE = float("inf")


class InfeasibleDeadline(RuntimeError):
    """Typed reject-at-admission: the predicted completion time already
    exceeds the caller's deadline, so the query is shed BEFORE it costs
    a queue slot or any device time. Carries the prediction so clients
    (and the 503 payload) can say how infeasible, not just that."""

    def __init__(self, predicted_ms: float, deadline: float,
                 now: Optional[float] = None,
                 queue_ms: float = 0.0, run_ms: float = 0.0):
        now = time.time() if now is None else now
        self.predicted_ms = float(predicted_ms)
        self.deadline = float(deadline)
        self.queue_ms = float(queue_ms)
        self.run_ms = float(run_ms)
        self.slack_ms = (self.deadline - now) * 1e3
        super().__init__(
            f"INFEASIBLE_DEADLINE: predicted completion in "
            f"{self.predicted_ms:.1f}ms (queue {self.queue_ms:.1f}ms + "
            f"run {self.run_ms:.1f}ms) exceeds the deadline "
            f"{self.slack_ms:.1f}ms away — rejected at admission")


def edf_key(ticket) -> Tuple[float, int]:
    """Total order for EDF: (absolute deadline, submit id); tickets
    without a deadline sort last, FIFO among themselves."""
    dl = getattr(ticket, "deadline", None)
    return (dl if dl is not None else _NO_DEADLINE, ticket.id)


def pick_edf(tickets) -> Optional[object]:
    """Earliest-feasible-deadline-first choice among ``tickets``
    (queued or gate-waiting). Returns None on an empty collection."""
    best = None
    best_key = None
    for t in tickets:
        k = edf_key(t)
        if best_key is None or k < best_key:
            best, best_key = t, k
    return best


def backlog_ms(pending_ms: List[float], inflight_ms: List[float],
               workers: int, default_ms: float) -> float:
    """Queue-wait estimate for a NEW submit: predicted run time of
    everything already queued plus in flight, divided by the effective
    worker count (the M/M/c shortcut — crude, but it only has to be
    right about ORDER of magnitude to shed doomed queries early).
    ``default_ms`` substitutes for tickets the model cannot predict."""
    w = max(1, int(workers))
    total = 0.0
    for ms in pending_ms:
        total += ms if ms and ms > 0 else default_ms
    for ms in inflight_ms:
        # in-flight queries are partway done; count half on average
        total += (ms if ms and ms > 0 else default_ms) / 2.0
    return total / w


def feasible(deadline: Optional[float], queue_ms: float, run_ms: float,
             margin: float = 1.0,
             now: Optional[float] = None) -> Tuple[bool, float]:
    """(is_feasible, predicted_total_ms) for a submit with ``deadline``
    (absolute epoch seconds, None = always feasible) given the queue
    backlog estimate and the query's own predicted run time."""
    predicted_ms = (max(0.0, queue_ms) + max(0.0, run_ms)) \
        * max(0.0, float(margin))
    if deadline is None:
        return True, predicted_ms
    now = time.time() if now is None else now
    slack_ms = (float(deadline) - now) * 1e3
    return predicted_ms <= slack_ms, predicted_ms
