"""End-to-end caller-deadline propagation (the port of
``spark_tpu/deadline.py``).

One absolute deadline (epoch seconds), minted at the outermost entry
point (``spark.tpu.deadline.defaultTimeoutS`` at ``DataFrame.collect``,
or the connect client's per-request timeout, carried hop to hop in
``X-SparkTpu-Deadline`` as the absolute time: client, router, replica,
scheduler ticket, worker thread), is bound
for the query and checked at every retry and wait seam (the stage
retry, the chunk pipeline's retry, the spill retry, every backoff
sleep), so work stops the moment the caller can no longer use the
result, and the failure surfaces as the typed :class:`DeadlineExceeded`
instead of the work grinding on against an absent caller. A relative
timeout re-stamped at each hop would grant each hop a fresh budget;
the absolute time does not.

Contextvars do not cross threads: thread-hopping code (scheduler
workers, the chunk-pipeline producer) must capture :func:`current` and re-enter it
with :func:`bind` — the exact discipline trace contexts already follow.
The mesh's rank threads run in a copy of the caller's context, which
carries the deadline with it.

Classification contract: :class:`DeadlineExceeded` is NEVER transient
(``recovery.is_transient`` carves it out by type before its marker
scan) — the caller's deadline passing is a property of the caller, not
of the environment, so no retry layer may absorb it.

This module is deliberately near the bottom of the import graph
(stdlib + the conf registry only): faults, recovery, and every serving
layer import it.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from contextvars import ContextVar
from typing import Iterator, Optional

from spark_tpu_torch import conf as CF

#: absolute epoch-seconds deadline, forwarded verbatim hop to hop
DEADLINE_HEADER = "X-SparkTpu-Deadline"

DEADLINE_DEFAULT_TIMEOUT = CF.register(
    "spark.tpu.deadline.defaultTimeoutS", 0.0,
    "Deadline minted at DataFrame.collect()/toArrow() when no caller "
    "deadline is already bound (seconds; 0 disables). Connect clients "
    "mint their own from the per-request timeout regardless.", float)

_DEADLINE: ContextVar[Optional[float]] = ContextVar(
    "spark_tpu_deadline", default=None)


class DeadlineExceeded(RuntimeError):
    """The caller's absolute deadline passed. Typed and terminal: never
    retried (a deadline that passed once has passed for every retry),
    never absorbed by a fallback ladder."""

    def __init__(self, where: str, deadline: float,
                 now: Optional[float] = None):
        now = time.time() if now is None else now
        self.where = where
        self.deadline = float(deadline)
        self.late_s = max(0.0, now - self.deadline)
        super().__init__(
            f"DEADLINE_EXCEEDED at {where}: caller deadline passed "
            f"{self.late_s:.3f}s ago")


def current() -> Optional[float]:
    """The ambient absolute deadline (epoch s), or None when unbound."""
    return _DEADLINE.get()


def remaining(now: Optional[float] = None) -> Optional[float]:
    """Seconds until the ambient deadline (may be negative once
    passed); None when no deadline is bound."""
    dl = _DEADLINE.get()
    if dl is None:
        return None
    return dl - (time.time() if now is None else now)


def expired(now: Optional[float] = None) -> bool:
    rem = remaining(now)
    return rem is not None and rem <= 0.0


def check(where: str) -> None:
    """Cooperative deadline seam: raise the typed
    :class:`DeadlineExceeded` when the ambient deadline has passed.
    No-op when none is bound."""
    dl = _DEADLINE.get()
    if dl is not None and time.time() > dl:
        raise DeadlineExceeded(where, dl)


def cap_sleep(seconds: float) -> float:
    """Clamp a backoff/wait duration so no seam ever sleeps past the
    ambient deadline (the connect Client's past-timeout-backoff bug,
    fixed everywhere at once)."""
    s = max(0.0, float(seconds))
    rem = remaining()
    if rem is None:
        return s
    return max(0.0, min(s, rem))


def mint(timeout_s: Optional[float]) -> Optional[float]:
    """Absolute deadline ``timeout_s`` from now (None/<=0 -> None)."""
    if timeout_s is None or float(timeout_s) <= 0.0:
        return None
    return time.time() + float(timeout_s)


@contextmanager
def bind(deadline: Optional[float]) -> Iterator[Optional[float]]:
    """Enter an absolute deadline for the dynamic extent (None binds
    nothing and is a no-op, so call sites need no conditionals). When a
    TIGHTER deadline is already bound, it wins — a hop may shorten the
    caller's budget, never extend it."""
    if deadline is None:
        yield _DEADLINE.get()
        return
    prev = _DEADLINE.get()
    eff = deadline if prev is None else min(prev, deadline)
    token = _DEADLINE.set(eff)
    try:
        yield eff
    finally:
        _DEADLINE.reset(token)


@contextmanager
def bind_default(conf) -> Iterator[Optional[float]]:
    """Root-entry helper (DataFrame._execute): mint from
    ``spark.tpu.deadline.defaultTimeoutS`` only when NO deadline is
    already bound — a nested query under a served request must inherit
    the request's deadline, not restart the clock."""
    if _DEADLINE.get() is not None or conf is None:
        yield _DEADLINE.get()
        return
    try:
        timeout = float(conf.get(DEADLINE_DEFAULT_TIMEOUT))
    except Exception:
        timeout = 0.0
    with bind(mint(timeout)) as dl:
        yield dl


def header_value() -> Optional[str]:
    """Wire form of the bound deadline for ``X-SparkTpu-Deadline``."""
    dl = _DEADLINE.get()
    return f"{dl:.6f}" if dl is not None else None


def from_header(value: Optional[str]) -> Optional[float]:
    """Decode ``X-SparkTpu-Deadline``; a malformed value is dropped (a
    bad peer loses its deadline, it does not break serving)."""
    if not value:
        return None
    try:
        return float(str(value).strip())
    except (TypeError, ValueError):
        return None
