"""End-to-end hierarchical query tracing (the port of ``spark_tpu/trace/``).

The span analogue of the reference's TaskMetrics/SQLMetrics + event-log
replay: every query gets a ``trace_id``, and every unit of work —
connect request, router dispatch, scheduler queue/admit/run, plan
analysis, compile-store probe, per-stage device execution, exchange
stats fetch, pipeline chunk decode/transfer, fault retry, result-cache/
mview/storage probe — opens a child span under a contextvar-carried
parent. Spans land in the existing metrics ring/JSONL as ``span``
events, and the active (trace_id, span_id, parent_id) triple is stamped
onto EVERY event ``metrics.record()`` emits, so flat events (stage,
exchange, fault_injected, ...) attribute to the query that caused them
even under the concurrent scheduler — positional slicing survives only
as a fallback for id-less events.

Context crosses threads explicitly (the chunk pipeline producer captures
``current()`` and re-enters it; the mesh's rank threads run in a copy of
the caller's context) and crosses
processes via the ``X-SparkTpu-Trace`` header (``header_value()`` /
``from_header()``), so one trace spans client -> federation router ->
replica -> scheduler -> stages.

Cost discipline: id stamping is always on (one contextvar read per
event). Span *events* obey ``spark.tpu.trace.enabled`` and the
``spark.tpu.trace.sampleRatio`` knob — the sampling decision is made
once at root creation and inherited, so a trace is either complete or
absent, never partial. Tracing never touches data: results are
byte-identical with tracing on or off.

Every span name must be declared in ``SPAN_NAMES`` below; ``span``
refuses any other.
"""

from __future__ import annotations

import random
import threading
import time
import uuid
from contextlib import contextmanager
from typing import Any, Iterator, NamedTuple, Optional

from spark_tpu_torch import conf as CF
from spark_tpu_torch import metrics

TRACE_ENABLED = CF.register(
    "spark.tpu.trace.enabled", True,
    "Record hierarchical span events for every unit of query work "
    "(connect request, dispatch, queue, stage, chunk, ...). Ids are "
    "stamped on events regardless; this only gates span events.", bool)

TRACE_SAMPLE_RATIO = CF.register(
    "spark.tpu.trace.sampleRatio", 1.0,
    "Fraction of traces that record span events (decided once at root "
    "creation, inherited fleet-wide via X-SparkTpu-Trace). Lower it "
    "when span-heavy paths (per-chunk pipeline spans) matter.", float)

TRACE_HEADER = "X-SparkTpu-Trace"

#: central registry of legal span names (every ``trace.span("<name>",
#: ...)`` must appear here)
SPAN_NAMES = frozenset({
    "connect.client",       # client side of one HTTP request
    "connect.request",      # replica/server handling of one request
    "router.dispatch",      # federation routing of one request
    "router.forward",       # one forward attempt to one replica
    "scheduler.queue",      # submit -> admitted (queue + admission gate)
    "scheduler.run",        # prepare + execute on a scheduler worker
    "query.execute",        # DataFrame._execute (root when standalone)
    "query.analysis",       # static plan analysis + submit gate
    "compile.probe",        # AOT executable-store lookup
    "stage.run",            # one physical stage (host glue + device)
    "stage.fused",          # whole-query fused span: the multi-exchange
                            # plan as ONE rank stage, no stats stage
    "stage.device",         # device execution, bounded by a stream sync
    "exchange.stats",       # AQE host round-trip fetching device stats
    "agg.decide",           # adaptive-agg sketch fetch + strategy pick
    "agg.sort",             # sort rung: range exchange + sorted merge
    "agg.presplit",         # hot-key pre-split: salted exchange + merge
    "pipeline.decode",      # chunk pipeline: one chunk decode+filter
    "pipeline.transfer",    # chunk pipeline: one chunk host->device
    "fault.retry",          # one recovery re-attempt after a fault
    "result_cache.probe",   # serve-tier plan-keyed result cache probe
    "serve.epoch",          # ownership epoch mint + fleet broadcast
    "serve.invalidate",     # one invalidation-log record applied
    "mview.probe",          # materialized-view / cache-manager probe
    "storage.pin",          # HBM pin-scope around query execution
    "join.partition",       # hybrid hash join: grant + partition pass
    "join.spill",           # hybrid hash join: one spill write/read
    "slo.admit",            # SLO feasibility check at submit time
    "slo.observe",          # fold a finished query into the SLO model
})


class SpanContext(NamedTuple):
    trace_id: str
    span_id: str
    parent_id: Optional[str]
    sampled: bool

    def header(self) -> str:
        """Wire form for ``X-SparkTpu-Trace`` (traceparent-shaped:
        trace-span-flags)."""
        return f"{self.trace_id}-{self.span_id}-{int(self.sampled)}"


def _new_id(n: int = 16) -> str:
    return uuid.uuid4().hex[:n]


def current() -> Optional[SpanContext]:
    """The active span context on this thread (None outside any trace)."""
    return metrics.trace_context()


def current_trace_id() -> Optional[str]:
    ctx = metrics.trace_context()
    return ctx.trace_id if ctx is not None else None


def _conf():
    sess = metrics._session()
    return None if sess is None else sess.conf


def _sample_root() -> bool:
    """Sampling decision for a NEW trace root."""
    conf = _conf()
    try:
        enabled = bool(conf.get(TRACE_ENABLED)) if conf is not None \
            else bool(TRACE_ENABLED.default)
        ratio = float(conf.get(TRACE_SAMPLE_RATIO)) if conf is not None \
            else float(TRACE_SAMPLE_RATIO.default)
    except Exception:
        enabled, ratio = True, 1.0
    if not enabled or ratio <= 0.0:
        return False
    if metrics.brownout_level() > 0:
        # fleet brownout sheds NEW trace sampling before any query:
        # in-flight traces finish, fresh roots go unsampled
        return False
    return ratio >= 1.0 or random.random() < ratio


@contextmanager
def span(name: str, **attrs: Any) -> Iterator[SpanContext]:
    """Open one unit of work as a child of the ambient span (or as a
    new trace root when none is active). On exit a ``span`` event is
    recorded into the metrics ring/JSONL with trace_id/span_id/
    parent_id, start time ``t0`` (epoch s), ``ms`` and the attrs; root
    exit also flushes the buffered JSONL writer so a finished query is
    always on disk."""
    if name not in SPAN_NAMES:
        raise ValueError(f"undeclared span name {name!r}: add it to "
                         "trace.SPAN_NAMES")
    parent = metrics.trace_context()
    if parent is None:
        ctx = SpanContext(_new_id(16), _new_id(8), None, _sample_root())
    else:
        ctx = SpanContext(parent.trace_id, _new_id(8),
                          parent.span_id, parent.sampled)
    token = metrics.set_trace_context(ctx)
    t0 = time.time()
    p0 = time.perf_counter()
    err: Optional[str] = None
    try:
        yield ctx
    except BaseException as e:
        err = repr(e)
        raise
    finally:
        metrics.reset_trace_context(token)
        if ctx.sampled:
            ms = (time.perf_counter() - p0) * 1e3
            fields = dict(name=name, ms=round(ms, 3), t0=round(t0, 6),
                          tid=threading.get_ident() % 10_000_000,
                          trace_id=ctx.trace_id, span_id=ctx.span_id,
                          parent_id=ctx.parent_id)
            if err is not None:
                fields["error"] = err
            fields.update(attrs)
            metrics.record("span", **fields)
        if parent is None:
            # trace root closed: a query just finished end-to-end
            metrics.flush_log()


@contextmanager
def attach(ctx: Optional[SpanContext]) -> Iterator[None]:
    """Re-enter a captured span context on another thread (scheduler
    worker, pipeline producer) or adopt a remote parent decoded from
    ``X-SparkTpu-Trace``. No span event is recorded — children opened
    inside do that."""
    if ctx is None:
        yield
        return
    token = metrics.set_trace_context(ctx)
    try:
        yield
    finally:
        metrics.reset_trace_context(token)


def from_header(value: Optional[str]) -> Optional[SpanContext]:
    """Decode ``X-SparkTpu-Trace``; malformed values are dropped (a bad
    peer must not break serving)."""
    if not value:
        return None
    parts = value.strip().split("-")
    if len(parts) != 3 or not parts[0] or not parts[1]:
        return None
    if not all(c in "0123456789abcdef" for c in parts[0] + parts[1]):
        return None
    return SpanContext(parts[0], parts[1], None, parts[2] == "1")


def header_value() -> Optional[str]:
    """Wire form of the current context (None outside any trace)."""
    ctx = metrics.trace_context()
    return ctx.header() if ctx is not None else None
