"""Tracing / profiling (the port of ``spark_tpu/tracing.py``).

Reference mechanisms: per-task TaskMetrics flowing back as accumulators
(core/.../executor/TaskMetrics.scala:46, util/AccumulatorV2.scala:44),
per-operator SQLMetrics rendered in the SQL UI
(metric/SQLMetrics.scala:40, ui/SQLAppStatusListener.scala:40), planner
phase timing (QueryPlanningTracker.scala), and event-log replay.

On the card the device-side truth is in CUDA, so deep profiling maps to
``torch.profiler`` (CUPTI: one event per kernel launch, memcpy and
synchronization, with the host's call stack); engine-side accounting
reuses the stage event stream from metrics.py. This module glues the
two:

- ``trace(dir)``: context manager running ``torch.profiler.profile``
  (CPU activity, and CUDA activity where a CUDA device exists) over the
  block and writing a Chrome trace under ``dir`` (load it in Perfetto
  or chrome://tracing); it yields a ``TraceSession`` with the profile and
  the trace's path.
- ``annotate(name)``: names a region (``torch.profiler.record_function``
  and, on the card, an NVTX range) so engine stages are findable inside
  the device trace.
- ``format_trace()`` / ``trace_breakdown()``: the engine-side span
  tree from spark_tpu_torch/trace/ as a text waterfall and as a
  host/queue/device/transfer time split. The two tracing layers
  compose: spans say WHICH query/stage/chunk owned the wall time,
  the profiler says what the device did inside it (Perfetto loads
  both — ``history.chrome_trace`` exports the span side).
- ``query_profile()``: the last query's per-operator wall-time rollup
  from the event stream — the text form of the SQL-tab DAG view.
- ``pipeline_profile()``: the out-of-memory chunk pipeline's per-tier
  stage/overlap rollup (decode/filter/transfer vs device compute).
- the exchange, fault, storage, analysis, aggregation, scheduler,
  serve, warmup (CUDA graph captures and the compile tier) and mview
  profiles.
- ``PlanningTracker``: phase timing for parse/optimize/plan (the
  QueryPlanningTracker analogue).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional

from spark_tpu_torch import metrics

class TraceSession:
    """What one ``trace`` block recorded: ``profile``, the
    ``torch.profiler.profile`` object (for ``key_averages()``), and
    ``path``, the Chrome trace it wrote; both set when the block exits."""

    profile = None
    path: Optional[str] = None


def _cuda_available() -> bool:
    import torch

    return torch.cuda.is_available()


#: kernel launches a CUDA ``trace`` session makes, and waits for, before
#: its block. torch's profiler (kineto over CUPTI) drops the first kernel
#: records of a session as out of its window, more of them the older the
#: process (PERF.md §6-§7); these no-op fills take those places, so the
#: block's own kernel events are kept.
_PRIMER_LAUNCHES = 256


def _prime_device() -> None:
    import torch

    x = torch.zeros(1, device="cuda")
    for _ in range(_PRIMER_LAUNCHES):
        x.fill_(0)
    torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str, *, cuda: Optional[bool] = None
          ) -> Iterator[TraceSession]:
    """Run ``torch.profiler.profile`` over the block and write its Chrome
    trace to ``log_dir/trace-<pid>-<n>.json``. ``cuda``: record CUDA
    activity too (default: when a CUDA device exists), after
    ``_PRIMER_LAUNCHES`` no-op kernels that precede the block in the
    trace. Yields the ``TraceSession`` that holds the profile and the
    path."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if cuda is None:
        cuda = _cuda_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    session = TraceSession()
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        if cuda:
            _prime_device()
        yield session
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        n = len([f for f in os.listdir(log_dir) if f.startswith("trace-")])
        session.path = os.path.join(log_dir, f"trace-{os.getpid()}-{n}.json")
        prof.export_chrome_trace(session.path)
        session.profile = prof


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Mark a named region inside a device trace: a
    ``record_function`` range, and an NVTX range where CUDA exists."""
    import torch

    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(name))
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield


def _trace_events(events_or_id=None) -> List[dict]:
    """Resolve a trace-event source: a trace_id string (exact ring
    lookup), an event list, or None (the last query's events)."""
    if isinstance(events_or_id, str):
        return metrics.query_events(events_or_id)
    if events_or_id is not None:
        return list(events_or_id)
    return metrics.last_query()


def format_trace(events_or_id=None, width: int = 40) -> str:
    """Render one query's span tree as a text waterfall: one line per
    span, indented by depth, children in start order, with start offset
    and duration — the terminal form of the Perfetto view
    (``history.chrome_trace`` is the graphical one). Accepts a
    trace_id, an event list, or nothing (last query)."""
    evs = _trace_events(events_or_id)
    spans = [e for e in evs if e.get("kind") == "span"]
    if not spans:
        return "(no span events recorded — tracing off or unsampled)"
    spans.sort(key=lambda e: float(e.get("t0", 0.0)))
    ids = {e.get("span_id") for e in spans}
    children: Dict[Optional[str], List[dict]] = defaultdict(list)
    roots: List[dict] = []
    for e in spans:
        parent = e.get("parent_id")
        # a parent outside the ring (remote peer's span) makes this a
        # local root
        if parent is None or parent not in ids:
            roots.append(e)
        else:
            children[parent].append(e)
    base = float(roots[0].get("t0", 0.0)) if roots else 0.0
    lines = [f"trace {spans[0].get('trace_id', '?')}"]
    attr_skip = ("kind", "name", "ms", "t0", "ts", "tid", "n",
                 "trace_id", "span_id", "parent_id")

    def walk(e: dict, depth: int) -> None:
        off = (float(e.get("t0", 0.0)) - base) * 1e3
        label = ("  " * depth + str(e.get("name", "span")))[:width]
        attrs = " ".join(
            f"{k}={v}" for k, v in e.items() if k not in attr_skip)
        lines.append(f"{label:<{width}} +{off:>8.1f}ms "
                     f"{float(e.get('ms', 0.0)):>9.2f}ms"
                     + (f"  {attrs}" if attrs else ""))
        for c in children.get(e.get("span_id"), []):
            walk(c, depth + 1)

    for r in roots:
        walk(r, 0)
    return "\n".join(lines)


def trace_breakdown(events_or_id=None) -> Dict[str, float]:
    """Split one trace's wall time into where it went: ``wall_ms`` is
    the root span; ``queue_ms`` the scheduler admission wait
    (scheduler.queue spans), ``device_ms`` the stream-sync-bounded
    device execution (stage.device; on a mesh whose ranks share one
    card, the ranks' spans overlap and their sum can exceed the
    stage), ``transfer_ms`` the chunk-pipeline
    host->device staging (pipeline.transfer); ``host_ms`` is the
    remainder (decode, planning, glue, HTTP) — so the four components
    sum to wall by construction. Accepts a trace_id, an event list, or
    nothing (last query)."""
    evs = _trace_events(events_or_id)
    spans = [e for e in evs if e.get("kind") == "span"]
    out = {"wall_ms": 0.0, "queue_ms": 0.0, "device_ms": 0.0,
           "transfer_ms": 0.0, "host_ms": 0.0}
    if not spans:
        return out
    ids = {e.get("span_id") for e in spans}
    roots = [e for e in spans if e.get("parent_id") is None
             or e.get("parent_id") not in ids]
    out["wall_ms"] = round(max(
        (float(e.get("ms", 0.0)) for e in roots), default=0.0), 3)
    sums = {"scheduler.queue": 0.0, "stage.device": 0.0,
            "pipeline.transfer": 0.0}
    device: List[tuple] = []
    for e in spans:
        name = e.get("name")
        if name == "stage.device":
            t0 = float(e.get("t0", 0.0))
            device.append((t0, t0 + float(e.get("ms", 0.0)) / 1e3))
        elif name in sums:
            sums[name] += float(e.get("ms", 0.0))
    # the union of the device intervals: a mesh's rank threads each
    # record a stage.device span for the same stage
    end = None
    for a, b in sorted(device):
        if end is None or a > end:
            sums["stage.device"] += (b - a) * 1e3
            end = b
        elif b > end:
            sums["stage.device"] += (b - end) * 1e3
            end = b
    out["queue_ms"] = round(sums["scheduler.queue"], 3)
    out["device_ms"] = round(sums["stage.device"], 3)
    out["transfer_ms"] = round(sums["pipeline.transfer"], 3)
    out["host_ms"] = round(max(
        0.0, out["wall_ms"] - out["queue_ms"] - out["device_ms"]
        - out["transfer_ms"]), 3)
    return out


def query_profile(events: Optional[List[dict]] = None) -> Dict[str, dict]:
    """Roll up the last query's stage events into per-operator totals:
    {op: {count, total_ms, max_ms}} (the SQL-tab table, text form)."""
    evs = events if events is not None else metrics.last_query()
    out: Dict[str, dict] = defaultdict(
        lambda: {"count": 0, "total_ms": 0.0, "max_ms": 0.0})
    for e in evs:
        if e.get("kind") != "stage":
            continue
        op = e.get("op", "?")
        ms = float(e.get("ms", 0.0))
        rec = out[op]
        rec["count"] += 1
        rec["total_ms"] = round(rec["total_ms"] + ms, 3)
        rec["max_ms"] = round(max(rec["max_ms"], ms), 3)
    return dict(out)


def format_profile(profile: Optional[Dict[str, dict]] = None) -> str:
    p = profile if profile is not None else query_profile()
    if not p:
        return "(no stage events recorded)"
    rows = sorted(p.items(), key=lambda kv: -kv[1]["total_ms"])
    width = max(len(op) for op, _ in rows)
    lines = [f"{'operator':<{width}}  count  total_ms  max_ms"]
    for op, rec in rows:
        lines.append(f"{op:<{width}}  {rec['count']:>5}  "
                     f"{rec['total_ms']:>8.2f}  {rec['max_ms']:>6.2f}")
    return "\n".join(lines)


_PIPELINE_EVENTS = ("chunked_agg", "chunked_topk", "grace_hash_agg",
                    "hybrid_hash_agg")


def pipeline_profile(events: Optional[List[dict]] = None) -> Dict[str, dict]:
    """Roll up the last query's out-of-HBM pipeline events into a
    per-tier overlap summary: {tier: {chunks, decode_ms, filter_ms,
    transfer_ms, compute_ms, wall_ms, overlap_ms, overlap_ratio,
    stall_producer_ms, stall_consumer_ms, pipeline_depth}}. The
    producer-stage sums (decode+filter+transfer) against wall_ms show
    how much of the host work the pipeline hid behind device compute."""
    evs = events if events is not None else metrics.last_query()
    out: Dict[str, dict] = {}
    for e in evs:
        kind = e.get("kind")
        if kind not in _PIPELINE_EVENTS:
            continue
        rec = out.setdefault(kind, defaultdict(float))
        rec["events"] = int(rec["events"]) + 1
        for k in ("chunks", "decode_ms", "filter_ms", "transfer_ms",
                  "compute_ms", "sidecar_ms", "wall_ms", "overlap_ms",
                  "stall_producer_ms", "stall_consumer_ms"):
            if k in e:
                rec[k] = round(rec[k] + float(e[k]), 3)
        if "pipeline_depth" in e:
            rec["pipeline_depth"] = int(e["pipeline_depth"])
    for rec in out.values():
        wall = rec.get("wall_ms", 0.0)
        rec["overlap_ratio"] = (
            round(rec.get("overlap_ms", 0.0) / wall, 4) if wall else 0.0)
    return {k: dict(v) for k, v in out.items()}


def format_pipeline_profile(profile: Optional[Dict[str, dict]] = None) -> str:
    p = profile if profile is not None else pipeline_profile()
    if not p:
        return "(no out-of-HBM pipeline events recorded)"
    lines = []
    for tier, rec in sorted(p.items()):
        lines.append(
            f"{tier}: chunks={int(rec.get('chunks', 0))} "
            f"depth={rec.get('pipeline_depth', '?')} "
            f"wall={rec.get('wall_ms', 0.0):.1f}ms "
            f"overlap={rec.get('overlap_ms', 0.0):.1f}ms "
            f"({100 * rec.get('overlap_ratio', 0.0):.0f}%)")
        lines.append(
            f"  decode={rec.get('decode_ms', 0.0):.1f} "
            f"filter={rec.get('filter_ms', 0.0):.1f} "
            f"transfer={rec.get('transfer_ms', 0.0):.1f} "
            f"compute={rec.get('compute_ms', 0.0):.1f} "
            f"stall_prod={rec.get('stall_producer_ms', 0.0):.1f} "
            f"stall_cons={rec.get('stall_consumer_ms', 0.0):.1f}")
    return "\n".join(lines)


def exchange_profile(events: Optional[List[dict]] = None) -> Dict[str, dict]:
    """Roll up the last query's exchange events (metrics.record_exchange
    + "aqe" decision events) into {"exchanges", "rows_sent",
    "buffer_bytes", "padding_ratio", "by_op": {op: {count, rows,
    buffer_bytes, capacity_before, capacity_after, padding_ratio}},
    "decisions": [...]} — the MapOutputStatistics view of what each
    shuffle actually moved. ``capacity_*`` are PER-DEVICE: with
    adaptive execution on, ``capacity_after`` is the bucket-rounded
    pmax of measured live counts (vs the D x local-capacity worst case
    in ``capacity_before``); in fused mode the two are equal (the stage
    output shape). ``padding_ratio`` = 1 - live rows / total
    post-exchange slots. "aqe" decisions record broadcast-join
    switches and skew splits."""
    evs = events if events is not None else metrics.last_query()
    by_op: Dict[str, dict] = {}
    decisions: List[dict] = []
    total_rows = total_bytes = total_slots = n_exchanges = 0
    for e in evs:
        kind = e.get("kind")
        if kind == "aqe":
            decisions.append({k: v for k, v in e.items()
                              if k not in ("n", "ts", "kind")})
            continue
        if kind != "exchange":
            continue
        n = int(e.get("exchanges", 1))
        rows = int(e.get("rows", 0))
        nbytes = int(e.get("buffer_bytes", 0))
        slots = int(e.get("capacity_after", 0)) * int(e.get("devices", 1))
        n_exchanges += n
        total_rows += rows
        total_bytes += nbytes
        total_slots += slots
        rec = by_op.setdefault(e.get("op", "?"), {
            "count": 0, "rows": 0, "buffer_bytes": 0, "slots": 0,
            "capacity_before": 0, "capacity_after": 0, "mode": None})
        rec["count"] += n
        rec["rows"] += rows
        rec["buffer_bytes"] += nbytes
        rec["slots"] += slots
        rec["capacity_before"] = max(rec["capacity_before"],
                                     int(e.get("capacity_before", 0)))
        rec["capacity_after"] = max(rec["capacity_after"],
                                    int(e.get("capacity_after", 0)))
        rec["mode"] = e.get("mode")
    for rec in by_op.values():
        s = rec.pop("slots")
        rec["padding_ratio"] = round(1.0 - rec["rows"] / s, 4) if s \
            else 0.0
    return {
        "exchanges": n_exchanges,
        "rows_sent": total_rows,
        "buffer_bytes": total_bytes,
        "padding_ratio": (round(1.0 - total_rows / total_slots, 4)
                          if total_slots else 0.0),
        "by_op": by_op,
        "decisions": decisions,
    }


def format_exchange_profile(profile: Optional[Dict[str, dict]] = None) -> str:
    p = profile if profile is not None else exchange_profile()
    if not p.get("exchanges") and not p.get("decisions"):
        return "(no exchange events recorded)"
    lines = [
        f"exchanges={p['exchanges']} rows_sent={p['rows_sent']} "
        f"send_buffer_bytes={p['buffer_bytes']} "
        f"padding_ratio={p['padding_ratio']:.2%}"]
    for op, rec in sorted(p.get("by_op", {}).items()):
        lines.append(
            f"  {op} ({rec.get('mode', '?')}): count={rec['count']} "
            f"rows={rec['rows']} cap {rec['capacity_before']}->"
            f"{rec['capacity_after']}/dev "
            f"padding={rec['padding_ratio']:.2%}")
    for d in p.get("decisions", []):
        desc = " ".join(f"{k}={v}" for k, v in d.items()
                        if k != "decision")
        lines.append(f"  aqe: {d.get('decision', '?')} {desc}".rstrip())
    return "\n".join(lines)


_FAULT_EVENTS = ("fault_injected", "fault_recovered",
                 "degraded_to_chunked", "degraded_to_adaptive",
                 "stage_retry", "chunk_retry")


def fault_profile(events: Optional[List[dict]] = None) -> Dict[str, dict]:
    """Roll up robustness events into {kind: {count, points}} —
    injected faults, the recoveries that absorbed them, and degradation-
    ladder activations (the fault-tolerance counterpart of the SQL-tab
    rollup; reference surfaces these as stage/task failure counts)."""
    evs = events if events is not None else metrics.recent(4096)
    out: Dict[str, dict] = {}
    for e in evs:
        kind = e.get("kind")
        if kind not in _FAULT_EVENTS:
            continue
        rec = out.setdefault(kind, {"count": 0, "points": {}})
        rec["count"] += 1
        point = e.get("point") or e.get("label")
        if point is not None:
            rec["points"][point] = rec["points"].get(point, 0) + 1
    return out


def format_fault_profile(profile: Optional[Dict[str, dict]] = None) -> str:
    p = profile if profile is not None else fault_profile()
    if not p:
        return "(no fault events recorded)"
    lines = []
    for kind in _FAULT_EVENTS:
        if kind not in p:
            continue
        rec = p[kind]
        pts = " ".join(f"{pt}={n}" for pt, n in sorted(
            rec["points"].items()))
        lines.append(f"{kind}: {rec['count']}" + (f"  ({pts})" if pts
                                                  else ""))
    return "\n".join(lines)


def scheduler_profile(events: Optional[List[dict]] = None) -> Dict[str, dict]:
    """Roll up multi-tenant scheduler events into per-pool serving
    stats: {pool: {submitted, admitted, finished, failed, cancelled,
    rejected, admit_degraded, queue_wait_ms, queue_wait_max_ms,
    device_ms}} — the query-level analogue of the reference's
    fair-scheduler pool table in the UI."""
    evs = events if events is not None else metrics.recent(4096)
    out: Dict[str, dict] = {}
    for e in evs:
        if e.get("kind") != "scheduler":
            continue
        pool = e.get("pool", "?")
        rec = out.setdefault(pool, {
            "submitted": 0, "admitted": 0, "finished": 0, "failed": 0,
            "cancelled": 0, "rejected": 0, "admit_degraded": 0,
            "queue_wait_ms": 0.0, "queue_wait_max_ms": 0.0,
            "device_ms": 0.0})
        phase = e.get("phase")
        if phase in rec:
            rec[phase] += 1
        if phase in ("finished", "failed", "cancelled"):
            qw = float(e.get("queue_wait_ms", 0.0))
            rec["queue_wait_ms"] = round(rec["queue_wait_ms"] + qw, 3)
            rec["queue_wait_max_ms"] = round(
                max(rec["queue_wait_max_ms"], qw), 3)
            rec["device_ms"] = round(
                rec["device_ms"] + float(e.get("device_ms", 0.0)), 3)
    return out


def format_scheduler_profile(
        profile: Optional[Dict[str, dict]] = None) -> str:
    p = profile if profile is not None else scheduler_profile()
    if not p:
        return "(no scheduler events recorded)"
    lines = ["pool        done fail canc rej   queue_wait_ms  device_ms"]
    for pool, rec in sorted(p.items()):
        lines.append(
            f"{pool:<10} {rec['finished']:>5} {rec['failed']:>4} "
            f"{rec['cancelled']:>4} {rec['rejected']:>3} "
            f"{rec['queue_wait_ms']:>14.1f} {rec['device_ms']:>10.1f}")
    return "\n".join(lines)


def storage_profile(events: Optional[List[dict]] = None) -> Dict[str, dict]:
    """Roll up HBM-resident storage events (spark_tpu_torch/storage/) into
    per-phase totals {hit|miss|put|evict|rejected|uncache: {count,
    bytes}}, plus the live store/occupancy numbers of the active
    session ({'store': MemoryStore.stats(), 'memory':
    UnifiedMemoryManager.snapshot()} — storage vs execution occupancy
    under the shared hbmBudgetBytes)."""
    evs = events if events is not None else metrics.recent(4096)
    out: Dict[str, dict] = {}
    for e in evs:
        if e.get("kind") != "storage":
            continue
        phase = e.get("phase", "?")
        rec = out.setdefault(phase, {"count": 0, "bytes": 0})
        rec["count"] += 1
        rec["bytes"] += int(e.get("bytes", 0))
    sess = metrics._session()
    store = getattr(sess, "memory_store", None) if sess else None
    if store is not None:
        out["store"] = store.stats()
        out["memory"] = sess.memory_manager.snapshot()
    return out


def format_storage_profile(profile: Optional[Dict[str, dict]] = None) -> str:
    p = profile if profile is not None else storage_profile()
    phases = {k: v for k, v in p.items() if k not in ("store", "memory")}
    if not phases and "store" not in p:
        return "(no storage events recorded)"
    lines = []
    for phase in ("hit", "miss", "put", "evict", "rejected", "uncache"):
        if phase in phases:
            rec = phases[phase]
            lines.append(f"{phase:<9} count={rec['count']:<6} "
                         f"bytes={rec['bytes']}")
    mem = p.get("memory")
    if mem:
        lines.append(
            f"occupancy: storage={mem['storage_bytes']} "
            f"execution={mem['in_use_bytes']} "
            f"free={mem['free_bytes']} / budget={mem['budget_bytes']}")
        gr = mem.get("grants")
        if gr:
            lines.append(
                f"grants: count={gr['grants']} bytes={gr['grant_bytes']} "
                f"waits={gr['grant_waits']} denials={gr['grant_denials']} "
                f"zero={gr['zero_grants']} grows={gr['grows']} "
                f"grow_denials={gr['grow_denials']}")
    st = p.get("store")
    if st:
        lines.append(
            f"store: entries={st['entries']} bytes={st['bytes_used']} "
            f"hits={st['hits']} misses={st['misses']} "
            f"evictions={st['evictions']} rejected={st['rejected_puts']}")
    return "\n".join(lines) if lines else "(no storage events recorded)"


def warmup_profile(events: Optional[List[dict]] = None) -> Dict[str, dict]:
    """Where did warmup time go? Splits first-run cost into its three
    host-side sinks — CUDA-graph capture (stage_compile events, with
    their ms), parquet decode, and host->device transfer (scan events) —
    plus the compile tier's counters (compile/: statistics-store hits
    and misses, background serves, swaps, pre-warmed replays)."""
    evs = events if events is not None else metrics.recent(4096)
    out = {
        "compile": {"count": 0, "total_ms": 0.0},
        "decode": {"count": 0, "total_ms": 0.0},
        "transfer": {"count": 0, "total_ms": 0.0},
    }
    for e in evs:
        kind = e.get("kind")
        if kind == "stage_compile":
            out["compile"]["count"] += 1
            out["compile"]["total_ms"] = round(
                out["compile"]["total_ms"] + float(e.get("ms", 0.0)), 3)
        elif kind == "scan":
            out["decode"]["count"] += 1
            out["decode"]["total_ms"] = round(
                out["decode"]["total_ms"]
                + float(e.get("decode_ms", 0.0)), 3)
            out["transfer"]["count"] += 1
            out["transfer"]["total_ms"] = round(
                out["transfer"]["total_ms"]
                + float(e.get("transfer_ms", 0.0)), 3)
    out["compile_cache"] = metrics.compile_cache_stats()
    # cross-session executable store + background compile/hot-swap
    # counters (spark_tpu_torch/compile/): hit/miss/background/swap say
    # whether warmup was skipped, hidden, or paid
    out["executable_store"] = metrics.exec_store_stats()
    return out


def format_warmup_profile(profile: Optional[Dict[str, dict]] = None) -> str:
    p = profile if profile is not None else warmup_profile()
    cc = p.get("compile_cache", {})
    lines = [
        f"trace/compile: {p['compile']['count']} stages, "
        f"{p['compile']['total_ms']:.1f}ms",
        f"parquet decode: {p['decode']['count']} scans, "
        f"{p['decode']['total_ms']:.1f}ms",
        f"host->device transfer: {p['transfer']['total_ms']:.1f}ms",
        f"persistent compile cache: {cc.get('hits', 0)} hits / "
        f"{cc.get('misses', 0)} misses",
    ]
    es = p.get("executable_store")
    if es:
        lines.append(
            f"executable store: {es.get('hits', 0)} hits / "
            f"{es.get('misses', 0)} misses, {es.get('puts', 0)} puts, "
            f"{es.get('background', 0)} background serves, "
            f"{es.get('swaps', 0)} swaps, "
            f"{es.get('fallbacks', 0)} fallbacks, "
            f"{es.get('prewarmed', 0)} prewarmed")
    return "\n".join(lines)


def analysis_profile(events: Optional[List[dict]] = None) -> Dict[str, dict]:
    """Roll up static-analysis runs (spark_tpu_torch/analysis/): per-plan
    diagnostic counts and analyzer latency from ``analysis`` events,
    plus the lifetime run/error/warning/gated counters."""
    evs = events if events is not None else metrics.recent(4096)
    out: Dict[str, dict] = {"runs": [], "totals": metrics.analysis_stats()}
    for e in evs:
        if e.get("kind") != "analysis":
            continue
        out["runs"].append({
            "plan": e.get("plan"),
            "errors": int(e.get("errors", 0)),
            "warnings": int(e.get("warnings", 0)),
            "diagnostics": int(e.get("diagnostics", 0)),
            "fingerprint_stable": bool(e.get("fingerprint_stable",
                                             True)),
            "elapsed_ms": float(e.get("elapsed_ms", 0.0)),
        })
    return out


def format_analysis_profile(
        profile: Optional[Dict[str, dict]] = None) -> str:
    p = profile if profile is not None else analysis_profile()
    t = p.get("totals", {})
    lines = [
        f"analyzer: {t.get('runs', 0)} runs, {t.get('errors', 0)} "
        f"errors, {t.get('warnings', 0)} warnings, "
        f"{t.get('gated', 0)} plans gated"]
    for r in p.get("runs", [])[-8:]:
        flag = "" if r["fingerprint_stable"] else "  [recompile-hazard]"
        lines.append(
            f"  {r['plan']}: {r['errors']}E/{r['warnings']}W "
            f"({r['elapsed_ms']:.1f}ms){flag}")
    return "\n".join(lines)


def serve_profile(events: Optional[List[dict]] = None) -> Dict[str, dict]:
    """Roll up federation-tier events (spark_tpu_torch/serve/): per-replica
    dispatch outcomes from ``serve`` events ({replica: {dispatched,
    shed, redispatched, failed}}), result-cache activity from
    ``serve_cache`` events ({hit, miss, wait, execute} counts plus
    cached-execution ms saved), and the lifetime counters
    (metrics.serve_stats)."""
    evs = events if events is not None else metrics.recent(4096)
    replicas: Dict[str, dict] = {}
    cache = {"hit": 0, "miss": 0, "wait": 0, "execute": 0,
             "execute_ms": 0.0}
    for e in evs:
        kind = e.get("kind")
        if kind == "serve":
            rid = str(e.get("replica", "?"))
            rec = replicas.setdefault(rid, {
                "dispatched": 0, "shed": 0, "redispatched": 0,
                "failed": 0, "breaker_transitions": 0})
            phase = e.get("phase")
            key = {"dispatch": "dispatched", "shed": "shed",
                   "redispatch": "redispatched",
                   "replica_down": "failed",
                   "breaker_transition": "breaker_transitions",
                   }.get(phase)
            if key is not None:
                rec[key] += 1
            if phase == "breaker_transition":
                # events arrive oldest-first, so the last one seen is
                # the replica's latest known breaker state
                rec["breaker_state"] = str(e.get("to_state", "?"))
        elif kind == "serve_cache":
            phase = e.get("phase")
            if phase in cache:
                cache[phase] += 1
            if phase == "execute":
                cache["execute_ms"] = round(
                    cache["execute_ms"] + float(e.get("ms", 0.0)), 3)
    return {"replicas": replicas, "cache": cache,
            "totals": metrics.serve_stats(),
            "resilience": {"brownout": metrics.brownout_stats(),
                           "retry_budget": metrics.retry_budget_stats()}}


def format_serve_profile(profile: Optional[Dict[str, dict]] = None) -> str:
    p = profile if profile is not None else serve_profile()
    t = p.get("totals", {})
    if not p.get("replicas") and not any(p.get("cache", {}).values()) \
            and not any(t.values()):
        return "(no serve events recorded)"
    c = p.get("cache", {})
    lines = [
        f"result cache: {c.get('hit', 0)} hits, {c.get('miss', 0)} "
        f"misses, {c.get('wait', 0)} single-flight waits "
        f"({c.get('execute', 0)} device executions, "
        f"{c.get('execute_ms', 0.0):.1f}ms)",
        f"router: {t.get('dispatches', 0)} dispatches, "
        f"{t.get('sheds', 0)} sheds, {t.get('redispatches', 0)} "
        f"re-dispatches, {t.get('rejected', 0)} rejected "
        f"(all saturated), {t.get('replica_failures', 0)} replica "
        "failures"]
    res = p.get("resilience", {})
    if res:
        bo = res.get("brownout", {})
        rb = res.get("retry_budget", {})
        lines.append(
            f"resilience: brownout level {bo.get('level', 0)} "
            f"({bo.get('entered', 0)} entered/{bo.get('exited', 0)} "
            f"exited), retry budget {rb.get('draws', 0)} draws "
            f"({rb.get('floor_draws', 0)} floored, "
            f"{rb.get('denials', 0)} denied, "
            f"{rb.get('exhaustions', 0)} exhausted)")
    if p.get("replicas"):
        lines.append("replica       disp shed redisp fail breaker")
        for rid, rec in sorted(p["replicas"].items()):
            lines.append(
                f"{rid:<12} {rec['dispatched']:>5} {rec['shed']:>4} "
                f"{rec['redispatched']:>6} {rec['failed']:>4} "
                f"{rec.get('breaker_state', 'closed')}")
    return "\n".join(lines)


def aggregation_profile(events: Optional[List[dict]] = None
                        ) -> Dict[str, dict]:
    """Roll up adaptive-aggregation events (parallel/executor.py):
    per-strategy pick counts from ``agg`` events, how each decision was
    made (auto from the sketch / forced by conf / pinned by legality /
    fallback after a sketch fault), the recent decisions with their
    sketched NDV, live rows and NDV ratio, and the lifetime counters
    (metrics.agg_stats)."""
    evs = events if events is not None else metrics.recent(4096)
    strategies: Dict[str, int] = {}
    modes: Dict[str, int] = {}
    recent: List[dict] = []
    for e in evs:
        if e.get("kind") != "agg":
            continue
        strat = str(e.get("strategy", "?"))
        strategies[strat] = strategies.get(strat, 0) + 1
        mode = str(e.get("mode", "?"))
        modes[mode] = modes.get(mode, 0) + 1
        recent.append({
            "strategy": strat, "mode": mode,
            "ndv": int(e.get("ndv", 0)), "rows": int(e.get("rows", 0)),
            "ratio": round(float(e.get("ratio", 0.0)), 4),
            "domain": int(e.get("domain", 0)),
            "hot_keys": int(e.get("hot_keys", 0) or 0),
            "devices": int(e.get("devices", 0))})
    return {"strategies": strategies, "modes": modes,
            "recent": recent[-16:], "totals": metrics.agg_stats()}


def format_aggregation_profile(
        profile: Optional[Dict[str, dict]] = None) -> str:
    p = profile if profile is not None else aggregation_profile()
    t = p.get("totals", {})
    if not p.get("strategies") and not any(t.values()):
        return "(no adaptive aggregation events recorded)"
    s = p.get("strategies", {})
    m = p.get("modes", {})
    lines = [
        f"strategy picks: {s.get('partial', 0)} partial->final, "
        f"{s.get('bypass', 0)} partial-bypass, "
        f"{s.get('hash', 0)} hash-partial, "
        f"{s.get('sort', 0)} sort-merge, "
        f"{s.get('presplit', 0)} hot-key-presplit",
        f"decisions: {m.get('auto', 0)} auto (sketch), "
        f"{m.get('forced', 0)} conf-forced, "
        f"{m.get('pinned', 0)} legality-pinned, "
        f"{m.get('fallback', 0)} sketch-fault fallbacks "
        f"({t.get('sketch_failures', 0)} lifetime)"]
    if p.get("recent"):
        lines.append(
            "strategy  mode      ndv~      rows  ratio domain hot")
        for r in p["recent"][-8:]:
            lines.append(
                f"{r['strategy']:<9} {r['mode']:<8} {r['ndv']:>6} "
                f"{r['rows']:>9} {r['ratio']:>6.2f} {r['domain']:>6} "
                f"{r.get('hot_keys', 0):>3}")
    return "\n".join(lines)


def mview_profile(events: Optional[List[dict]] = None) -> Dict[str, dict]:
    """Roll up materialized-view events (spark_tpu_torch/mview/): refresh
    outcomes by how (incremental / full / fallback), retry + dedup
    activity, per-view stream-merge counts, and the lifetime counters
    (metrics.mview_stats)."""
    evs = events if events is not None else metrics.recent(4096)
    refresh = {"incremental": 0, "full": 0, "fallback": 0,
               "materialize": 0, "files_merged": 0}
    faults = {"retries": 0, "fallbacks": 0}
    streams: Dict[str, dict] = {}
    for e in evs:
        if e.get("kind") != "mview":
            continue
        phase = e.get("phase")
        if phase == "refresh":
            how = str(e.get("how", "full"))
            if how in refresh:
                refresh[how] += 1
            if how == "incremental":
                refresh["files_merged"] += int(e.get("files", 0))
        elif phase == "materialize":
            refresh["materialize"] += 1
        elif phase == "retry":
            faults["retries"] += 1
        elif phase == "fallback":
            faults["fallbacks"] += 1
        elif phase in ("stream_merge", "dedup"):
            name = str(e.get("view", "?"))
            rec = streams.setdefault(name, {"merges": 0, "dedups": 0,
                                            "rows": 0})
            if phase == "stream_merge":
                rec["merges"] += 1
                rec["rows"] += int(e.get("rows", 0))
            else:
                rec["dedups"] += 1
    return {"refresh": refresh, "faults": faults, "streams": streams,
            "totals": metrics.mview_stats()}


def format_mview_profile(profile: Optional[Dict[str, dict]] = None
                         ) -> str:
    p = profile if profile is not None else mview_profile()
    t = p.get("totals", {})
    r = p.get("refresh", {})
    if not any(r.values()) and not any(t.values()):
        return "(no materialized-view events recorded)"
    lines = [
        f"views: {t.get('registrations', 0)} registered, "
        f"{t.get('hits', 0)} fresh hits",
        f"refresh: {r.get('incremental', 0)} incremental "
        f"({r.get('files_merged', 0)} files merged), "
        f"{r.get('full', 0)} full recomputes, "
        f"{r.get('fallback', 0)} retry-exhaustion fallbacks, "
        f"{t.get('refresh_retries', 0)} transient retries",
        f"streaming: {t.get('stream_merges', 0)} micro-batch merges, "
        f"{t.get('stream_dedups', 0)} replay dedups; "
        f"{t.get('serve_repopulations', 0)} serve-cache repopulations"]
    if p.get("streams"):
        lines.append("stream view     merges dedups   rows")
        for name, rec in sorted(p["streams"].items()):
            lines.append(f"{name:<14} {rec['merges']:>6} "
                         f"{rec['dedups']:>6} {rec['rows']:>6}")
    return "\n".join(lines)


class PlanningTracker:
    """Phase timing for the planning pipeline (reference:
    catalyst/QueryPlanningTracker.scala). Use as
    ``with tracker.phase("optimize"): ...``; phases() returns ms."""

    def __init__(self):
        self._phases: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._phases[name] = self._phases.get(name, 0.0) + \
                (time.perf_counter() - t0) * 1e3

    def phases(self) -> Dict[str, float]:
        return {k: round(v, 3) for k, v in self._phases.items()}
