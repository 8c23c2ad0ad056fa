"""Per-stage metrics + JSON event log (the port of ``spark_tpu/metrics.py``).

Analogue of the reference's SQLMetrics + event logging
(sql/core/.../execution/metric/SQLMetrics.scala:40,
core/.../scheduler/EventLoggingListener.scala:48), collapsed to what a
single-process engine needs: every executed stage (fused program or
blocking operator) appends an event carrying operator, capacities and
wall time. The in-memory ring is inspectable via ``recent()``/
``last_query()``; setting ``spark.eventLog.dir`` also appends JSONL to
disk so hung or slow stages are visible post-mortem.

Trace attribution: ``record()`` stamps the active span context
(spark_tpu_torch/trace/ keeps it in the contextvar held here) onto every
event as ``trace_id``/``span_id``/``parent_id``, and query marks are
trace-id keyed — ``last_query()`` selects by trace id when the newest
query has one, so concurrent queries no longer steal each other's
stage/fault events; positional slicing survives only as the fallback
for id-less events.

Disk writes are buffered: ``record()`` appends to an in-memory line
buffer flushed on size (``_LOG_FLUSH_EVENTS``) or age
(``_LOG_FLUSH_SECONDS``), plus ``flush_log()`` at query end (trace root
exit) and atexit — span-volume logging must not serialize hot stages
behind one open+write per event.
"""

from __future__ import annotations

import atexit
import contextvars
import json
import os
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from spark_tpu_torch import locks

_LOCK = locks.named_lock("metrics.registry")
_IO_LOCK = locks.named_lock("metrics.io")
_EVENTS: deque = deque(maxlen=4096)
#: (first event counter, trace_id-or-None) per started query
_QUERY_MARKS: deque = deque(maxlen=64)
_counter = 0

#: active span context — a spark_tpu_torch.trace.SpanContext; lives here (not
#: in spark_tpu_torch/trace/) so record() can read it without an import cycle
_TRACE_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "spark_tpu_trace_ctx", default=None)


def trace_context():
    return _TRACE_CTX.get()


def set_trace_context(ctx):
    """Set the active span context; returns the token for reset."""
    return _TRACE_CTX.set(ctx)


def reset_trace_context(token) -> None:
    _TRACE_CTX.reset(token)


_PATH_CACHE: Dict[str, Optional[str]] = {}

# ---- buffered JSONL writer (all state under _IO_LOCK) ----------------------

_LOG_BUF: List[str] = []
_LOG_BUF_PATH: Optional[str] = None
_LOG_LAST_FLUSH = 0.0
_LOG_FLUSH_EVENTS = 128
_LOG_FLUSH_SECONDS = 0.5


def _session():
    """The session whose query runs in this context, else the active
    one (None outside both)."""
    from spark_tpu_torch.api.session import SparkSession, executing_session

    sess = executing_session()
    return sess if sess is not None else SparkSession._active


def _log_path() -> Optional[str]:
    sess = _session()
    if sess is None:
        return None
    try:
        d = sess.conf.get("spark.eventLog.dir")
    except KeyError:
        return None
    if not d:
        return None
    # resolve + mkdir once per configured directory (under the IO lock:
    # concurrent queries must not race the mkdir/cache fill)
    with _IO_LOCK:
        if d not in _PATH_CACHE:
            os.makedirs(d, exist_ok=True)
            _PATH_CACHE[d] = os.path.join(d, "events.jsonl")
        return _PATH_CACHE[d]


def record(kind: str, **fields: Any) -> None:
    global _counter
    ev = {"ts": round(time.time(), 4), "kind": kind}
    ev.update(fields)
    ctx = _TRACE_CTX.get()
    if ctx is not None:
        # stamp the enclosing span's identity; explicit fields (the
        # span event records its own triple) win
        ev.setdefault("trace_id", ctx[0])
        ev.setdefault("span_id", ctx[1])
        if ctx[2] is not None:
            ev.setdefault("parent_id", ctx[2])
    path = _log_path()
    with _LOCK:
        ev["n"] = _counter
        _counter += 1
        _EVENTS.append(ev)
    if path is not None:
        _buffered_write(path, json.dumps(ev) + "\n")


def _buffered_write(path: str, line: str) -> None:
    """Append one JSONL line through the buffer. Separate IO lock: disk
    latency must not serialize stages that only touch the in-memory
    ring; appends buffer and flush on size/age so span volume costs one
    write per batch, not per event."""
    global _LOG_BUF_PATH, _LOG_LAST_FLUSH
    now = time.monotonic()
    with _IO_LOCK:
        if _LOG_BUF_PATH != path:
            # eventLog.dir changed mid-run: drain to the old file
            if _LOG_BUF and _LOG_BUF_PATH is not None:
                with open(_LOG_BUF_PATH, "a") as f:
                    f.write("".join(_LOG_BUF))
            _LOG_BUF.clear()
            _LOG_BUF_PATH = path
            _LOG_LAST_FLUSH = now
        _LOG_BUF.append(line)
        if (len(_LOG_BUF) >= _LOG_FLUSH_EVENTS
                or now - _LOG_LAST_FLUSH >= _LOG_FLUSH_SECONDS):
            with open(path, "a") as f:
                f.write("".join(_LOG_BUF))
            _LOG_BUF.clear()
            _LOG_LAST_FLUSH = now


def flush_log() -> None:
    """Drain the buffered JSONL writer (query end / atexit / before a
    reader opens the file)."""
    global _LOG_LAST_FLUSH
    with _IO_LOCK:
        if _LOG_BUF and _LOG_BUF_PATH is not None:
            with open(_LOG_BUF_PATH, "a") as f:
                f.write("".join(_LOG_BUF))
        _LOG_BUF.clear()
        _LOG_LAST_FLUSH = time.monotonic()


atexit.register(flush_log)


def query_start(description: str) -> int:
    ctx = _TRACE_CTX.get()
    tid = ctx[0] if ctx is not None else None
    with _LOCK:
        mark = _counter
        # mark append stays inside the lock: with concurrent queries an
        # interleaved record() would otherwise skew which events
        # last_query() attributes to the newest query
        _QUERY_MARKS.append((mark, tid))
    record("query_start", description=description)
    return mark


def recent(n: int = 100) -> List[Dict[str, Any]]:
    with _LOCK:
        return list(_EVENTS)[-n:]


def query_events(trace_id: str) -> List[Dict[str, Any]]:
    """Every ring event stamped with ``trace_id`` (exact attribution,
    immune to concurrent interleaving)."""
    with _LOCK:
        evs = list(_EVENTS)
    return [e for e in evs if e.get("trace_id") == trace_id]


def query_marks() -> List[Tuple[int, Optional[str]]]:
    """(first event counter, trace_id) per started query, oldest
    first — the per-query folding key for history/ui rollups."""
    with _LOCK:
        return list(_QUERY_MARKS)


def last_query() -> List[Dict[str, Any]]:
    """Events of the most recent query. Trace-id keyed when the newest
    mark has one (events of OTHER concurrent queries are excluded;
    id-less events inside the positional window are kept so legacy
    emitters still attribute); pure positional slicing otherwise."""
    with _LOCK:
        evs = list(_EVENTS)
        mark, tid = _QUERY_MARKS[-1] if _QUERY_MARKS else (0, None)
    if tid is not None:
        return [e for e in evs
                if e.get("trace_id") == tid
                or ("trace_id" not in e and e["n"] >= mark)]
    return [e for e in evs if e["n"] >= mark]


def reset() -> None:
    with _LOCK:
        _EVENTS.clear()
        _QUERY_MARKS.clear()


def record_exchange(op: str, *, mode: str, devices: int, rows: int,
                    capacity_before: int, capacity_after: int,
                    buffer_bytes: int, exchanges: int = 1,
                    slice_capacity: Optional[int] = None) -> None:
    """One exchange observation (parallel/executor records these):
    ``mode`` is "adaptive" (a cut stage that ran under measured bounds)
    or "fused" (exchanges ran inside a fused stage at the static
    worst-case capacity — capacities then describe the stage output).
    ``capacity_*`` are PER-DEVICE capacities before/after adaptive
    compaction; ``buffer_bytes`` is the (D, slice) all_to_all send
    tensor a rank ships to the others; ``rows`` is global live rows
    through the exchange. The derived live-row fraction / padding
    ratio and the raw fields also land in gauges (exchange.*) for the
    ui /api/v1/exchange endpoint."""
    slots = max(1, int(capacity_after) * int(devices))
    live_fraction = min(1.0, int(rows) / slots)
    padding_ratio = round(1.0 - live_fraction, 4)
    fields: Dict[str, Any] = dict(
        op=op, mode=mode, devices=int(devices), rows=int(rows),
        exchanges=int(exchanges),
        capacity_before=int(capacity_before),
        capacity_after=int(capacity_after),
        buffer_bytes=int(buffer_bytes),
        live_fraction=round(live_fraction, 4),
        padding_ratio=padding_ratio)
    if slice_capacity is not None:
        fields["slice_capacity"] = int(slice_capacity)
    record("exchange", **fields)
    for k in ("rows", "buffer_bytes", "padding_ratio", "live_fraction",
              "capacity_before", "capacity_after"):
        set_gauge(f"exchange.{k}", fields[k])
    set_gauge("exchange.mode", mode)


# ---- gauges -----------------------------------------------------------------

#: last-set values for point-in-time measures (cache sizes, occupancy)
#: that would flood the event ring if recorded per change
_GAUGES: Dict[str, Any] = {}


def set_gauge(name: str, value: Any) -> None:
    with _LOCK:
        _GAUGES[name] = value


def gauges() -> Dict[str, Any]:
    with _LOCK:
        return dict(_GAUGES)


# ---- persistent compile-cache counters --------------------------------------

#: hit/miss counts of the persistent compile cache: the compile tier's
#: statistics store (compile/store.py), one per plan lookup
_COMPILE_CACHE = {"hits": 0, "misses": 0}


def note_compile_cache(hit: bool) -> None:
    with _LOCK:
        _COMPILE_CACHE["hits" if hit else "misses"] += 1


def compile_cache_stats() -> Dict[str, int]:
    with _LOCK:
        return dict(_COMPILE_CACHE)


# ---- static-analysis counters -----------------------------------------------

#: pre-execution plan analyzer (spark_tpu_torch/analysis/) — runs, total
#: error/warning-level diagnostics produced, and plans rejected by the
#: level=error submit gate. Shown in tracing.analysis_profile and
#: /api/v1/lint.
_ANALYSIS = {"runs": 0, "errors": 0, "warnings": 0, "gated": 0}


def note_analysis(report) -> None:
    """Fold one AnalysisReport into the counters and gauges; also logs
    the run as an ``analysis`` event so it lands in the query mark."""
    errs = len(report.errors())
    warns = len(report.warnings())
    with _LOCK:
        _ANALYSIS["runs"] += 1
        _ANALYSIS["errors"] += errs
        _ANALYSIS["warnings"] += warns
        _GAUGES["analysis.peak_bytes"] = int(report.peak_bytes)
        _GAUGES["analysis.fingerprint_stable"] = \
            bool(report.fingerprint_stable)
        _GAUGES["analysis.elapsed_ms"] = round(report.elapsed_ms, 3)
    record("analysis", plan=report.plan, errors=errs, warnings=warns,
           diagnostics=len(report.diagnostics),
           peak_bytes=int(report.peak_bytes),
           fingerprint_stable=bool(report.fingerprint_stable),
           elapsed_ms=round(report.elapsed_ms, 3))


def note_analysis_gated() -> None:
    with _LOCK:
        _ANALYSIS["gated"] += 1


def analysis_stats() -> Dict[str, int]:
    with _LOCK:
        return dict(_ANALYSIS)


# ---- executable-store counters ----------------------------------------------

#: the compile tier (spark_tpu_torch/compile/) — hits/misses against the
#: statistics store, puts, LRU evictions, corrupt-entry evictions, eager
#: serves while a background capture runs, hot swaps, permanent eager
#: fallbacks after a background failure, and pre-warmed replays. Shown
#: in tracing.warmup_profile and /api/v1/compile.
_EXEC_STORE = {"hits": 0, "misses": 0, "puts": 0, "evictions": 0,
               "corrupt": 0, "background": 0, "swaps": 0,
               "fallbacks": 0, "prewarmed": 0}


def note_exec_store(kind: str, n: int = 1) -> None:
    with _LOCK:
        _EXEC_STORE[kind] = _EXEC_STORE.get(kind, 0) + int(n)


def exec_store_stats() -> Dict[str, int]:
    with _LOCK:
        return dict(_EXEC_STORE)


def reset_exec_store() -> None:
    with _LOCK:
        for k in list(_EXEC_STORE):
            _EXEC_STORE[k] = 0


# ---- serving-tier counters --------------------------------------------------

#: federation router + plan-keyed result cache (spark_tpu_torch/serve/) —
#: result-cache hits/misses, single-flight waits that piggybacked on an
#: in-flight execution, router dispatches, queue-full sheds to another
#: replica, re-dispatches after a replica death, all-replicas-saturated
#: rejections (the only case a client still sees a 429), and replica
#: connection failures. Shown in tracing.serve_profile and
#: /api/v1/serve.
_SERVE = {"hits": 0, "misses": 0, "waits": 0, "wait_timeouts": 0,
          "dispatches": 0, "sheds": 0, "redispatches": 0,
          "rejected": 0, "replica_failures": 0,
          "breaker_transitions": 0, "epoch_mints": 0,
          "epoch_retries": 0, "epoch_fences": 0,
          "invalidations": 0, "rebuilds": 0}


def note_serve(kind: str, n: int = 1) -> None:
    with _LOCK:
        _SERVE[kind] = _SERVE.get(kind, 0) + int(n)


def serve_stats() -> Dict[str, int]:
    with _LOCK:
        return dict(_SERVE)


def reset_serve() -> None:
    with _LOCK:
        for k in list(_SERVE):
            _SERVE[k] = 0


# ---- SLO serving counters ---------------------------------------------------

#: the SLO subsystem (spark_tpu_torch/slo/) — submit-time predictions made,
#: finished queries folded back into the latency model, typed
#: InfeasibleDeadline rejects at admission, predictive brownout
#: transitions (predicted p99 vs target, distinct from the serve
#: tier's failure-driven brownout), effective-concurrency resizes, and
#: model-journal entries loaded at startup. Shown in scheduler.status
#: and /health.
_SLO = {"predictions": 0, "observations": 0, "cold_observations": 0,
        "rejects": 0, "brownout_enters": 0, "brownout_exits": 0,
        "resizes": 0, "loads": 0}


def note_slo(kind: str, n: int = 1) -> None:
    with _LOCK:
        _SLO[kind] = _SLO.get(kind, 0) + int(n)


def slo_stats() -> Dict[str, int]:
    with _LOCK:
        return dict(_SLO)


def reset_slo() -> None:
    with _LOCK:
        for k in list(_SLO):
            _SLO[k] = 0


# ---- adaptive-aggregation counters ------------------------------------------

#: the runtime-adaptive aggregation engine (parallel/executor.py) —
#: per-strategy pick counts (the static partial->final path, the
#: partial-bypass raw-row exchange, the measured hash-partial),
#: strategy pins forced by legality (order-dependent float partials),
#: sketch failures absorbed by falling back to partial->final, and how
#: many decisions ran with a forced conf override. Shown in
#: tracing.aggregation_profile and /api/v1/agg.
_AGG = {"partial": 0, "bypass": 0, "hash": 0, "sort": 0, "presplit": 0,
        "pinned": 0, "sketch_failures": 0, "presplit_failures": 0,
        "forced": 0, "sort_elided": 0}


def note_agg(kind: str, n: int = 1) -> None:
    with _LOCK:
        _AGG[kind] = _AGG.get(kind, 0) + int(n)


def agg_stats() -> Dict[str, int]:
    with _LOCK:
        return dict(_AGG)


def reset_agg() -> None:
    with _LOCK:
        for k in list(_AGG):
            _AGG[k] = 0


# ---- whole-query fusion counters --------------------------------------------

#: whole-query native fusion (parallel/executor.py _try_fuse) — fused
#: programs launched (one per query that fused), exchange+consumer
#: spans folded into them, bailouts back to staged execution (see the
#: per-reason fusion_bailout events for the taxonomy), and injected
#: faults absorbed at fusion.decide. Shown in tracing.fusion_profile
#: and the bench fusion phase.
_FUSION = {"fused_programs": 0, "fused_spans": 0, "bailouts": 0,
           "fault_fallbacks": 0}


def note_fusion(kind: str, n: int = 1) -> None:
    with _LOCK:
        _FUSION[kind] = _FUSION.get(kind, 0) + int(n)


def fusion_stats() -> Dict[str, int]:
    with _LOCK:
        return dict(_FUSION)


def reset_fusion() -> None:
    with _LOCK:
        for k in list(_FUSION):
            _FUSION[k] = 0


# ---- materialized-view counters ---------------------------------------------

#: the incremental materialized-view engine (spark_tpu_torch/mview/) —
#: view registrations, fresh-hit serves, incremental delta merges,
#: full recomputes (non-mergeable plans, rewrites, incremental=off),
#: transient refresh retries, retry-exhaustion fallbacks to full
#: recompute, stream micro-batch merges, WAL-replay dedups dropped by
#: the batch-id watermark, and serve-tier result-cache repopulations.
#: Shown in tracing.mview_profile and /api/v1/mview.
_MVIEW = {"registrations": 0, "hits": 0, "incremental_merges": 0,
          "full_recomputes": 0, "refresh_retries": 0,
          "refresh_fallbacks": 0, "stream_merges": 0,
          "stream_dedups": 0, "serve_repopulations": 0}


def note_mview(kind: str, n: int = 1) -> None:
    with _LOCK:
        _MVIEW[kind] = _MVIEW.get(kind, 0) + int(n)


def mview_stats() -> Dict[str, int]:
    with _LOCK:
        return dict(_MVIEW)


def reset_mview() -> None:
    with _LOCK:
        for k in list(_MVIEW):
            _MVIEW[k] = 0


# ---- hybrid-hash-join counters ----------------------------------------------

#: the grant-driven dynamic hybrid hash join (physical/chunked.py
#: _HybridHashJoinAgg) — grants taken from the unified memory manager
#: (and their byte total), zero-byte grants (storage pins starved the
#: join: everything spills), mid-pass resident-set grows, partitions
#: demoted to host spill files (and the bytes written), spill file
#: writes/read-backs, bounded retries at the join.spill seams, recursive
#: repartitions of overflowing buckets, and fallbacks one rung down to
#: the static grace-hash join. Shown in tracing.storage_profile and
#: /api/v1/storage (via the manager snapshot) plus the hybrid_hash_agg
#: event per join.
_JOIN = {"grants": 0, "grant_bytes": 0, "zero_grants": 0, "grows": 0,
         "spilled_partitions": 0, "spill_bytes": 0, "spill_writes": 0,
         "spill_reads": 0, "spill_retries": 0,
         "recursive_repartitions": 0, "fallbacks": 0}


def note_join(kind: str, n: int = 1) -> None:
    with _LOCK:
        _JOIN[kind] = _JOIN.get(kind, 0) + int(n)


def join_stats() -> Dict[str, int]:
    with _LOCK:
        return dict(_JOIN)


def reset_join() -> None:
    with _LOCK:
        for k in list(_JOIN):
            _JOIN[k] = 0


# ---- recovery / OOM-ladder counters -----------------------------------------

#: the reactive recovery layer (recovery.py) — ``replans`` counts every
#: OOM-ladder re-execution (rung 0 forced-adaptive retry plus each
#: halved-budget chunked attempt): the number a planned single-pass
#: hybrid join keeps at ZERO where the old halve-and-retry path pays
#: one wasted device execution per rung. ``ladder_exhausted`` counts
#: queries that fell off the floor of the ladder.
_RECOVERY = {"replans": 0, "ladder_exhausted": 0}


def note_recovery(kind: str, n: int = 1) -> None:
    with _LOCK:
        _RECOVERY[kind] = _RECOVERY.get(kind, 0) + int(n)


def recovery_stats() -> Dict[str, int]:
    with _LOCK:
        return dict(_RECOVERY)


def reset_recovery() -> None:
    with _LOCK:
        for k in list(_RECOVERY):
            _RECOVERY[k] = 0


# ---- unified retry-budget counters ------------------------------------------

#: the per-query unified retry budget (recovery.RetryBudget) — ``draws``
#: counts every granted re-attempt across ALL layers (the per-query sum
#: is bounded by the budget instead of the old multiplicative product of
#: per-layer bounds), ``floor_draws`` the subset granted by a layer's
#: floor guarantee after the shared pool emptied, ``denials`` refused
#: draws (the seam surfaces RetryBudgetExhausted), ``exhaustions`` the
#: times a pool first hit empty, and ``legacy_attempts`` re-attempts
#: taken on the budget-less fallback path (the A/B counter the chaos
#: campaign compares against the budgeted path).
_RETRY = {"draws": 0, "floor_draws": 0, "denials": 0, "exhaustions": 0,
          "legacy_attempts": 0}


def note_retry_budget(kind: str, n: int = 1) -> None:
    with _LOCK:
        _RETRY[kind] = _RETRY.get(kind, 0) + int(n)


def retry_budget_stats() -> Dict[str, int]:
    with _LOCK:
        return dict(_RETRY)


def reset_retry_budget() -> None:
    with _LOCK:
        for k in list(_RETRY):
            _RETRY[k] = 0


# ---- fleet brownout level ----------------------------------------------------

#: fleet-wide brownout (serve/federation.py BrownoutController) —
#: ``level`` is the CURRENT shedding level (0 = normal; 1 = optional
#: analysis-heavy work shed: trace sampling, compile pre-warm, scan
#: auto-cache promotion), ``entered``/``exited`` count transitions.
#: Stored here (not on the controller) so consumers at the bottom of
#: the import graph — trace sampling, the datasource — read one int
#: without importing the serve tier.
_BROWNOUT = {"level": 0, "entered": 0, "exited": 0}


def set_brownout(level: int) -> None:
    with _LOCK:
        prev = _BROWNOUT["level"]
        level = int(level)
        if level > prev:
            _BROWNOUT["entered"] = _BROWNOUT.get("entered", 0) + 1
        elif level < prev:
            _BROWNOUT["exited"] = _BROWNOUT.get("exited", 0) + 1
        _BROWNOUT["level"] = level


def brownout_level() -> int:
    with _LOCK:
        return int(_BROWNOUT["level"])


def brownout_stats() -> Dict[str, int]:
    with _LOCK:
        return dict(_BROWNOUT)


def reset_brownout() -> None:
    with _LOCK:
        _BROWNOUT["level"] = 0
        _BROWNOUT["entered"] = 0
        _BROWNOUT["exited"] = 0


class PipelineStats:
    """Wall-time accounting of one pipelined run: per-stage totals
    (decode, filter, transfer, compute, sidecar), the producer's and
    consumer's stalls, the most bytes and chunks in flight, and a
    measured overlap: the wall time during which a producer stage
    (decode, filter, transfer) and a consumer stage (compute, sidecar)
    were both running. Host clock throughout."""

    PRODUCER_STAGES = ("decode", "filter", "transfer")
    CONSUMER_STAGES = ("compute", "sidecar")

    def __init__(self):
        self._t0 = time.perf_counter()
        self._lock = locks.named_lock("metrics.pipeline_stats")
        self._ms: Dict[str, float] = {}
        self._active = {"producer": 0, "consumer": 0}
        self._both_since: Optional[float] = None
        self._overlap_s = 0.0
        self.max_inflight_bytes = 0
        self.max_inflight_chunks = 0

    def add(self, stage: str, ms: float) -> None:
        with self._lock:
            self._ms[stage] = self._ms.get(stage, 0.0) + ms

    def timed(self, stage: str) -> "_PipelineStageTimer":
        return _PipelineStageTimer(self, stage)

    def _enter(self, role: str) -> None:
        with self._lock:
            self._active[role] += 1
            if self._both_since is None and all(self._active.values()):
                self._both_since = time.perf_counter()

    def _exit(self, role: str) -> None:
        with self._lock:
            self._active[role] -= 1
            if self._both_since is not None \
                    and not all(self._active.values()):
                self._overlap_s += time.perf_counter() - self._both_since
                self._both_since = None

    def note_inflight(self, nbytes: int, chunks: int) -> None:
        with self._lock:
            self.max_inflight_bytes = max(self.max_inflight_bytes,
                                          int(nbytes))
            self.max_inflight_chunks = max(self.max_inflight_chunks,
                                           int(chunks))

    def overlap_ms(self) -> float:
        with self._lock:
            s = self._overlap_s
            if self._both_since is not None:
                s += time.perf_counter() - self._both_since
        return s * 1e3

    def finish(self) -> Dict[str, Any]:
        """Close the clock: the counters as a flat dict (``*_ms`` per
        stage, ``wall_ms``, ``overlap_ms``, ``overlap_ratio``, stalls and
        the in-flight maxima)."""
        wall_ms = (time.perf_counter() - self._t0) * 1e3
        overlap = self.overlap_ms()
        with self._lock:
            ms = dict(self._ms)
        out: Dict[str, Any] = {
            f"{s}_ms": ms.get(s, 0.0)
            for s in ("decode", "filter", "transfer", "compute",
                      "sidecar")}
        out["wall_ms"] = wall_ms
        out["overlap_ms"] = overlap
        out["overlap_ratio"] = overlap / wall_ms if wall_ms else 0.0
        out["stall_producer_ms"] = ms.get("stall_producer", 0.0)
        out["stall_consumer_ms"] = ms.get("stall_consumer", 0.0)
        out["max_inflight_bytes"] = self.max_inflight_bytes
        out["max_inflight_chunks"] = self.max_inflight_chunks
        return out


class _PipelineStageTimer:
    """One timed stage region, feeding the stage's total and the
    producer/consumer overlap clock."""

    def __init__(self, stats: PipelineStats, stage: str):
        self._stats = stats
        self._stage = stage
        self._role = ("producer" if stage in PipelineStats.PRODUCER_STAGES
                      else "consumer"
                      if stage in PipelineStats.CONSUMER_STAGES else None)

    def __enter__(self):
        self._t0 = time.perf_counter()
        if self._role is not None:
            self._stats._enter(self._role)
        return self

    def __exit__(self, *exc):
        if self._role is not None:
            self._stats._exit(self._role)
        self._stats.add(self._stage, (time.perf_counter() - self._t0) * 1e3)
        return False


class stage_timer:
    """Context manager recording one stage execution event."""

    def __init__(self, op: str, **fields: Any):
        self.op = op
        self.fields = fields

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        ms = (time.perf_counter() - self.t0) * 1e3
        record("stage", op=self.op, ms=round(ms, 2),
               error=None if exc is None else repr(exc), **self.fields)
        return False
