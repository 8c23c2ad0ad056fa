"""Live status server: the reference serves a web UI + REST API while
queries run (reference: core/.../ui/SparkUI.scala:40, the
api/v1 endpoints under status/api/v1/ApiRootResource.scala). Here a
stdlib ThreadingHTTPServer reads the live in-memory metrics ring —
no web framework, no state of its own, always consistent with what the
engine just did.

Endpoints:
  /                     HTML (history.render_html over the live ring)
  /api/v1/queries       per-query rollups (JSON)
  /api/v1/events?n=200  recent raw events (JSON)
  /api/v1/status        app name, event count, active query
  /api/v1/storage       HBM store occupancy, counters, entry listing
  /api/v1/exchange      shuffle stats: rows/bytes/padding per exchange,
                        adaptive (AQE) decisions, exchange.* gauges
  /api/v1/compile       the compile tier: statistics-store
                        hit/miss/put/evict counters, background
                        capture + hot-swap state, pre-warm report,
                        warmup profile, compile.* gauges
  /api/v1/lint          static plan analysis: recent AnalysisReports,
                        run/error/warning/gated counters, analysis.*
                        gauges
  /api/v1/serve         federation tier: per-replica dispatch/shed/
                        re-dispatch rollup, result-cache hit/miss/
                        single-flight counters, serve.* gauges
  /api/v1/agg           adaptive aggregation: per-strategy pick
                        counts (partial->final / bypass / hash),
                        sketch-vs-decision rollup, agg.* gauges
  /api/v1/mview         materialized views: refresh rollup
                        (incremental/full/fallback), per-view state,
                        stream merge/dedup counters, mview.* gauges
  /api/v1/trace         query-latency rollup from trace roots: p50/p95,
                        a log2 latency histogram, the slowest traces
  /trace/<trace_id>     one trace as Chrome trace-event JSON (same
                        payload the connect server serves — load in
                        ui.perfetto.dev)

Enable per session with ``spark.ui.enabled=true`` (port:
``spark.ui.port``, 0 = ephemeral) or programmatically::

    from spark_tpu_torch.ui import StatusServer
    srv = StatusServer(spark)        # srv.port, srv.url
    ...
    srv.stop()
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from spark_tpu_torch import conf as CF
from spark_tpu_torch import history, metrics

UI_ENABLED = CF.register(
    "spark.ui.enabled", False,
    "Serve the live status UI/REST API for this session (reference: "
    "spark.ui.enabled).", bool)

UI_PORT = CF.register(
    "spark.ui.port", 4040,
    "Port for the live status UI; 0 binds an ephemeral port "
    "(reference: spark.ui.port).", int)


def _scheduler_status(session) -> Optional[dict]:
    """Queue depth + per-pool running counts when a query scheduler is
    serving this session (the connect server registers one)."""
    sched = getattr(session, "query_scheduler", None)
    if sched is None:
        return None
    try:
        return sched.status()
    except Exception:
        return None


def _storage_status(session) -> Optional[dict]:
    """HBM-resident store occupancy: storage vs execution bytes under
    the unified budget, hit/miss/evict counters, jit-cache gauges."""
    store = getattr(session, "memory_store", None)
    if store is None:
        return None
    try:
        return {
            "store": store.stats(),
            "memory": session.memory_manager.snapshot(),
            "gauges": metrics.gauges(),
        }
    except Exception:
        return None


def _percentile(sorted_vals, p: float) -> float:
    if not sorted_vals:
        return 0.0
    k = max(0, min(len(sorted_vals) - 1,
                   int(round(p * (len(sorted_vals) - 1)))))
    return sorted_vals[k]


def _trace_summary(events, top: int = 8) -> dict:
    """Latency rollup over trace ROOT spans (one per trace): p50/p95,
    a log2-bucketed histogram, and the slowest traces with their ids —
    the landing table for 'which query should I open in Perfetto'."""
    spans = [e for e in events if e.get("kind") == "span"]
    ids = {e.get("span_id") for e in spans}
    by_trace: dict = {}
    for e in spans:
        parent = e.get("parent_id")
        if parent is not None and parent in ids:
            continue  # not a local root
        t = e.get("trace_id")
        # a remote parent can leave several local roots in one trace:
        # keep the longest (the outermost local view of the query)
        if t not in by_trace or float(e.get("ms", 0.0)) > \
                float(by_trace[t].get("ms", 0.0)):
            by_trace[t] = e
    lat = sorted(float(e.get("ms", 0.0)) for e in by_trace.values())
    hist = []
    if lat:
        edge = 1.0
        while edge < lat[-1]:
            edge *= 2
        edges, e2 = [], 1.0
        while e2 <= edge:
            edges.append(e2)
            e2 *= 2
        for le in edges:
            hist.append({"le_ms": le,
                         "count": sum(1 for v in lat if v <= le)})
    slowest = sorted(by_trace.values(),
                     key=lambda e: -float(e.get("ms", 0.0)))[:top]
    return {
        "traces": len(by_trace),
        "p50_ms": round(_percentile(lat, 0.50), 3),
        "p95_ms": round(_percentile(lat, 0.95), 3),
        "max_ms": round(lat[-1], 3) if lat else 0.0,
        "histogram": hist,
        "slowest": [{"trace_id": e.get("trace_id"),
                     "root": e.get("name"),
                     "ms": round(float(e.get("ms", 0.0)), 3),
                     "t0": e.get("t0")} for e in slowest],
    }


class _Handler(BaseHTTPRequestHandler):
    server_version = "spark-tpu-ui/1"

    def log_message(self, *args) -> None:  # quiet by default
        pass

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, obj) -> None:
        self._send(200, json.dumps(obj, default=str).encode(),
                   "application/json")

    def do_GET(self) -> None:  # noqa: N802
        url = urlparse(self.path)
        q = parse_qs(url.query)
        events = metrics.recent(int(q.get("n", ["5000"])[0]))
        if url.path in ("/", "/index.html"):
            queries = history.summarize_events(events)
            html = history.render_html(queries)
            sched = _scheduler_status(
                getattr(self.server, "spark_session", None))
            if sched is not None:
                block = (
                    "<h2>Scheduler</h2><pre>"
                    f"mode={sched['mode']} queued={sched['queued']} "
                    f"rejected={sched['rejected']}\n"
                    + "\n".join(
                        f"pool {p['name']}: running={p['running']} "
                        f"queued={p['queued']} weight={p['weight']} "
                        f"device_ms={p['device_ms']}"
                        for p in sched["pools"]) + "</pre>")
                html = html.replace("</body>", block + "</body>") \
                    if "</body>" in html else html + block
            ts = _trace_summary(events)
            if ts["traces"]:
                rows = "".join(
                    f"<tr><td>{t['ms']:.1f}</td>"
                    f"<td>{t['root']}</td>"
                    f"<td><a href='/trace/{t['trace_id']}'>"
                    f"{t['trace_id']}</a></td></tr>"
                    for t in ts["slowest"])
                block = (
                    "<h2>Query latency (trace roots)</h2><pre>"
                    f"traces={ts['traces']} p50={ts['p50_ms']:.1f}ms "
                    f"p95={ts['p95_ms']:.1f}ms "
                    f"max={ts['max_ms']:.1f}ms</pre>"
                    "<table border=1 cellpadding=3><tr><th>ms</th>"
                    "<th>root</th><th>trace (Perfetto JSON)</th></tr>"
                    + rows + "</table>")
                html = html.replace("</body>", block + "</body>") \
                    if "</body>" in html else html + block
            sto = _storage_status(
                getattr(self.server, "spark_session", None))
            if sto is not None:
                st, mem = sto["store"], sto["memory"]
                block = (
                    "<h2>Memory (unified storage/execution)</h2><pre>"
                    f"budget={mem['budget_bytes']} "
                    f"storage={mem['storage_bytes']} "
                    f"execution={mem['in_use_bytes']} "
                    f"free={mem['free_bytes']}\n"
                    f"store: entries={st['entries']} hits={st['hits']} "
                    f"misses={st['misses']} evictions={st['evictions']} "
                    f"rejected_puts={st['rejected_puts']}</pre>")
                html = html.replace("</body>", block + "</body>") \
                    if "</body>" in html else html + block
            self._send(200, html.encode(), "text/html; charset=utf-8")
        elif url.path == "/api/v1/queries":
            self._json(history.summarize_events(events))
        elif url.path == "/api/v1/events":
            self._json(events)
        elif url.path == "/api/v1/status":
            session = getattr(self.server, "spark_session", None)
            active = None
            for ev in reversed(events):
                if ev.get("kind") == "query_start":
                    active = ev.get("description")
                    break
            hb = getattr(session, "heartbeat_monitor", None)
            self._json({
                "app": getattr(session, "app_name", "spark-tpu"),
                "events": len(events),
                "active_query": active,
                "heartbeat": hb.status() if hb is not None else None,
                "scheduler": _scheduler_status(session),
                "storage": _storage_status(session),
            })
        elif url.path == "/api/v1/exchange":
            from spark_tpu_torch import tracing

            self._json({
                "profile": tracing.exchange_profile(events),
                "gauges": {k: v for k, v in metrics.gauges().items()
                           if k.startswith("exchange.")},
            })
        elif url.path == "/api/v1/compile":
            from spark_tpu_torch import tracing

            session = getattr(self.server, "spark_session", None)
            svc = None
            try:
                svc = session.compile_service if session else None
            except Exception:
                pass
            self._json({
                "service": svc.status() if svc is not None else None,
                "exec_store": metrics.exec_store_stats(),
                "warmup": tracing.warmup_profile(events),
                "gauges": {k: v for k, v in metrics.gauges().items()
                           if k.startswith("compile.")},
            })
        elif url.path == "/api/v1/lint":
            from spark_tpu_torch import tracing
            from spark_tpu_torch.analysis import recent_reports

            self._json({
                "profile": tracing.analysis_profile(events),
                "recent": [r.to_dict() for r in recent_reports()],
                "gauges": {k: v for k, v in metrics.gauges().items()
                           if k.startswith("analysis.")},
            })
        elif url.path == "/api/v1/serve":
            from spark_tpu_torch import tracing

            self._json({
                "profile": tracing.serve_profile(events),
                "counters": metrics.serve_stats(),
                "gauges": {k: v for k, v in metrics.gauges().items()
                           if k.startswith("serve.")},
            })
        elif url.path == "/api/v1/agg":
            from spark_tpu_torch import tracing

            self._json({
                "profile": tracing.aggregation_profile(events),
                "counters": metrics.agg_stats(),
                "gauges": {k: v for k, v in metrics.gauges().items()
                           if k.startswith("agg.")},
            })
        elif url.path == "/api/v1/mview":
            from spark_tpu_torch import tracing

            session = getattr(self.server, "spark_session", None)
            mgr = getattr(session, "mview_manager", None)
            self._json({
                "profile": tracing.mview_profile(events),
                "counters": metrics.mview_stats(),
                "views": mgr.views() if mgr is not None else [],
                "gauges": {k: v for k, v in metrics.gauges().items()
                           if k.startswith("mview.")},
            })
        elif url.path == "/api/v1/trace":
            from spark_tpu_torch import tracing

            summary = _trace_summary(events)
            for t in summary["slowest"]:
                t["breakdown"] = tracing.trace_breakdown(t["trace_id"])
            self._json(summary)
        elif url.path.startswith("/trace/"):
            tid = url.path[len("/trace/"):]
            evs = metrics.query_events(tid)
            if not evs:
                self._send(404, b'{"error": "unknown trace id"}',
                           "application/json")
            else:
                self._json(history.chrome_trace(evs))
        elif url.path == "/api/v1/storage":
            session = getattr(self.server, "spark_session", None)
            sto = _storage_status(session)
            if sto is not None:
                store = session.memory_store
                sto["entries"] = store.entries_snapshot()
            self._json(sto)
        else:
            self._send(404, b"not found", "text/plain")


class StatusServer:
    """One live UI per session; serves until stop() (daemon thread)."""

    def __init__(self, session=None, port: Optional[int] = None):
        if port is None:
            try:
                port = session.conf.get(UI_PORT) if session else 0
            except Exception:
                port = 0
        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), _Handler)
        self._httpd.spark_session = session  # type: ignore[attr-defined]
        self.port = self._httpd.server_address[1]
        self.url = f"http://127.0.0.1:{self.port}"
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="spark-tpu-ui",
            daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)


def maybe_start(session) -> Optional[StatusServer]:
    """Start the UI when spark.ui.enabled is set (SparkSession calls
    this at construction)."""
    try:
        if session.conf.get(UI_ENABLED):
            return StatusServer(session)
    except Exception:
        pass
    return None
