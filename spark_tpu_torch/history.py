"""History reader: render JSONL event logs for a human.

The reference serves event logs through a Jetty web UI + History Server
(reference: core/src/main/scala/org/apache/spark/ui/SparkUI.scala:40,
deploy/history/FsHistoryProvider.scala:1, status/AppStatusStore.scala).
A single-process engine does not need a web stack to make its
history legible — this module folds the JSONL event stream
(metrics.py, written under ``spark.eventLog.dir``) into per-query and
per-stage rollups and renders them as text (CLI) or a single static
HTML file.

Span events (spark_tpu_torch/trace/) ride the same stream: ``chrome_trace``
folds one query's span tree into Chrome trace-event JSON — load the
file in Perfetto (ui.perfetto.dev) or chrome://tracing for the
waterfall the reference gets from its timeline view. The live server
serves it at ``GET /trace/<trace_id>``; offline, ``--perfetto out.json
[--trace <id>]`` renders it from a JSONL log.

Usage::

    python -m spark_tpu_torch.history <event-log-dir-or-file> [--html out.html]
    python -m spark_tpu_torch.history <event-log-dir> --perfetto out.json \
        [--trace <trace_id>]

or programmatically: ``history.summarize(path)`` -> list of query
dicts; ``spark_tpu_torch.tracing.query_profile()`` remains the live
in-process view.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional


def _iter_events(path: str):
    files = []
    if os.path.isdir(path):
        for name in sorted(os.listdir(path)):
            if name.endswith((".jsonl", ".log", ".json")):
                files.append(os.path.join(path, name))
    else:
        files = [path]
    for f in files:
        with open(f) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    yield json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn tail line of a live log


def summarize(path: str) -> List[Dict[str, Any]]:
    """Fold the event stream into queries: each ``query_start`` mark
    opens a bucket; stage events accumulate wall time per operator."""
    return summarize_events(_iter_events(path))


def summarize_events(events) -> List[Dict[str, Any]]:
    """Fold an event ITERABLE (JSONL file or the live in-memory ring —
    the live UI server in spark_tpu_torch.ui reads the ring through this)."""
    queries: List[Dict[str, Any]] = []
    current: Optional[Dict[str, Any]] = None

    def close():
        nonlocal current
        if current is not None:
            queries.append(current)
            current = None

    for ev in events:
        kind = ev.get("kind", "")
        if kind == "query_start":
            close()
            current = {"label": str(ev.get("description", "?")),
                       "ts": ev.get("ts"), "stages": [],
                       "trace_id": ev.get("trace_id"),
                       "events": 0, "total_ms": 0.0}
            continue
        if kind == "span":
            # spans nest (query.execute contains every stage), so their
            # ms would double-count into total_ms; the trace view
            # (chrome_trace / tracing.format_trace) is their rollup
            continue
        if current is None:
            current = {"label": "(before first query mark)", "ts": None,
                       "stages": [], "events": 0, "total_ms": 0.0}
        current["events"] += 1
        ms = float(ev.get("ms", 0.0) or 0.0)
        current["total_ms"] += ms
        if kind == "stage":
            current["stages"].append({
                "kind": str(ev.get("op", "stage")),
                "node": str(ev.get("node", ""))[:100],
                "ms": ms,
                "cap_in": ev.get("cap_in"),
                "error": ev.get("error"),
            })
        elif kind in ("stage_compile", "chunked_agg", "runtime_filter",
                      "skew_join_broadcast", "stage_retry") \
                or (kind == "heartbeat" and not ev.get("ok", True)):
            current["stages"].append({
                "kind": kind if kind != "heartbeat" else "heartbeat_fail",
                "node": json.dumps({k: v for k, v in ev.items()
                                    if k not in ("kind", "ts")})[:100],
                "ms": ms,
                "error": ev.get("error"),
            })
    close()
    return queries


def chrome_trace(events, trace_id: Optional[str] = None
                 ) -> Dict[str, Any]:
    """Fold span events into Chrome trace-event JSON (the format
    Perfetto and chrome://tracing load). ``events`` is any event
    iterable (``metrics.query_events(tid)``, a JSONL log); when
    ``trace_id`` is given only that trace is rendered.

    Mapping: each ``span`` event becomes one complete ("X") slice —
    ``ts``/``dur`` in microseconds relative to the trace's earliest
    span, ``pid`` per replica (the ``replica`` attr; 0 = the local process/client
    side), ``tid`` from the recording thread — so the fleet renders as
    one process lane per replica with real thread interleaving. Flat
    traced events (fault_injected, serve shed/redispatch, stage_retry)
    become instant ("i") markers on the same lanes."""
    evs = [e for e in events
           if trace_id is None or e.get("trace_id") == trace_id]
    spans = [e for e in evs if e.get("kind") == "span"
             and "t0" in e and "ms" in e]
    if not spans:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    base = min(float(e["t0"]) for e in spans)
    # one Chrome "process" lane per replica; 0 is the local process
    pids: Dict[str, int] = {}

    def pid_of(ev: Dict[str, Any]) -> int:
        rep = ev.get("replica")
        if rep is None:
            return 0
        return pids.setdefault(str(rep), len(pids) + 1)

    meta_keys = ("kind", "name", "ms", "t0", "ts", "tid", "n")
    out: List[Dict[str, Any]] = []
    for e in spans:
        out.append({
            "name": str(e.get("name", "span")),
            "cat": "span",
            "ph": "X",
            "ts": round((float(e["t0"]) - base) * 1e6, 1),
            "dur": round(float(e["ms"]) * 1e3, 1),
            "pid": pid_of(e),
            "tid": int(e.get("tid", 0)),
            "args": {k: v for k, v in e.items() if k not in meta_keys},
        })
    marker_kinds = ("fault_injected", "fault_recovered", "stage_retry",
                    "chunk_retry", "serve", "result_cache")
    for e in evs:
        if e.get("kind") in marker_kinds and "ts" in e:
            out.append({
                "name": str(e.get("kind")),
                "cat": "event",
                "ph": "i",
                "s": "t",
                "ts": round(max(0.0, (float(e["ts"]) - base)) * 1e6, 1),
                "pid": pid_of(e),
                "tid": int(e.get("tid", 0)),
                "args": {k: v for k, v in e.items()
                         if k not in meta_keys},
            })
    meta = [{"name": "process_name", "ph": "M", "pid": 0,
             "args": {"name": "driver"}}]
    meta += [{"name": "process_name", "ph": "M", "pid": p,
              "args": {"name": f"replica {r}"}}
             for r, p in sorted(pids.items(), key=lambda kv: kv[1])]
    return {"traceEvents": meta + out, "displayTimeUnit": "ms"}


def render_text(queries: List[Dict[str, Any]], top: int = 8) -> str:
    out = []
    out.append(f"{'query':<44} {'stages':>6} {'total ms':>10}")
    out.append("-" * 64)
    for q in queries:
        out.append(f"{q['label'][:44]:<44} {len(q['stages']):>6} "
                   f"{q['total_ms']:>10.1f}")
        for st in sorted(q["stages"], key=lambda s: -s["ms"])[:top]:
            err = (f"  ERROR: {st['error']}"
                   if st.get("error") else "")
            out.append(f"    {st['ms']:>9.1f} ms  {st['kind']:<19} "
                       f"{st['node']}{err}")
    return "\n".join(out)


def render_html(queries: List[Dict[str, Any]]) -> str:
    """One static page: per-query bars + stage tables (the SQL-tab
    DAG view collapsed to what matters: where the time went)."""
    from html import escape

    maxms = max((q["total_ms"] for q in queries), default=1.0) or 1.0
    rows = []
    for i, q in enumerate(queries):
        w = int(100 * q["total_ms"] / maxms)
        stage_rows = "".join(
            f"<tr><td>{st['ms']:.1f}</td><td>{escape(st['kind'])}</td>"
            f"<td><code>{escape(st['node'])}"
            + (f" <b>ERROR: {escape(str(st['error']))}</b>"
               if st.get("error") else "")
            + "</code></td></tr>"
            for st in sorted(q["stages"], key=lambda s: -s["ms"]))
        rows.append(
            f"<details><summary><b>{escape(q['label'])}</b> — "
            f"{q['total_ms']:.1f} ms, {len(q['stages'])} stages "
            f"<span style='display:inline-block;background:#4a90d9;"
            f"height:10px;width:{w}%'></span></summary>"
            f"<table border=1 cellpadding=3><tr><th>ms</th><th>kind"
            f"</th><th>stage</th></tr>{stage_rows}</table></details>")
    return ("<html><head><meta charset='utf-8'><title>spark_tpu_torch history"
            "</title></head><body><h2>spark_tpu_torch event-log history</h2>"
            + "".join(rows) + "</body></html>")


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Render a spark_tpu_torch JSONL event log "
                    "(spark.eventLog.dir) as text or HTML.")
    ap.add_argument("path", help="event-log file or directory")
    ap.add_argument("--html", metavar="OUT",
                    help="write a static HTML report instead of text")
    ap.add_argument("--perfetto", metavar="OUT",
                    help="write Chrome trace-event JSON (load in "
                         "ui.perfetto.dev) instead of text")
    ap.add_argument("--trace", metavar="TRACE_ID",
                    help="with --perfetto: render only this trace id")
    args = ap.parse_args(argv)
    if args.perfetto:
        doc = chrome_trace(_iter_events(args.path), trace_id=args.trace)
        n = sum(1 for e in doc["traceEvents"] if e.get("ph") == "X")
        if not n:
            print("no span events found")
            return 1
        with open(args.perfetto, "w") as f:
            json.dump(doc, f)
        print(f"wrote {args.perfetto} ({n} spans)")
        return 0
    queries = summarize(args.path)
    if not queries:
        print("no events found")
        return 1
    if args.html:
        with open(args.html, "w") as f:
            f.write(render_html(queries))
        print(f"wrote {args.html} ({len(queries)} queries)")
    else:
        print(render_text(queries))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
