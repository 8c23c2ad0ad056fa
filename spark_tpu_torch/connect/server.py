"""HTTP + Arrow-IPC result server (the port of
``spark_tpu/connect/server.py``; reference: SparkConnectService.scala —
ExecutePlan returning Arrow batches; SparkExecuteStatementOperation.scala
for the SQL-string entry).

A query runs on the server's ``QueryScheduler``: the request's handler
thread submits it and waits for the ticket; a worker parses, admits and
runs it, in the request's trace and under its deadline. The result is
the IPC stream of the port's ``DataFrame.toArrow()``, through the
result cache where that is on."""

from __future__ import annotations

import io
import json
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import pyarrow as pa

from spark_tpu_torch import conf as CF
from spark_tpu_torch import deadline, faults, locks, metrics, trace
from spark_tpu_torch.serve.ownership import EPOCH_HEADER, EpochRetry


class ConnectServer:
    def __init__(self, session, host: str = "127.0.0.1", port: int = 0,
                 heartbeat=None, scheduler=None,
                 replica_id: Optional[str] = None, result_cache=None):
        from spark_tpu_torch.scheduler import QueryScheduler, SchedulerQueueFull
        from spark_tpu_torch.slo.edf import InfeasibleDeadline

        self.session = session
        #: serve-tier plan-keyed result cache, shared across every
        #: in-process replica of this session so the single-flight
        #: guarantee spans the fleet (active only when
        #: spark.tpu.serve.resultCache.enabled)
        if result_cache is None:
            result_cache = getattr(session, "serve_result_cache", None)
            if result_cache is None:
                from spark_tpu_torch.serve.result_cache import ResultCache

                result_cache = ResultCache(session.conf)
                session.serve_result_cache = result_cache
        self.result_cache = result_cache
        #: highest ownership epoch this replica has adopted (0 until a
        #: router broadcast or stamped request teaches it one); a
        #: request stamped with an OLDER epoch is fenced with a typed
        #: EPOCH_RETRY (409) instead of being served under a stale
        #: shard->owner view
        self.fleet_epoch = 0
        self._epoch_lock = locks.named_lock("serve.ownership")
        self._owned_shards: set = set()
        #: optional recovery.HeartbeatMonitor surfaced via GET /health;
        #: falls back to one attached to the session
        self.heartbeat = heartbeat if heartbeat is not None \
            else getattr(session, "heartbeat_monitor", None)
        #: the multi-tenant query scheduler replaces the old global
        #: _exec_lock: host-side stages run concurrently on its worker
        #: pool, device execution is gated by HBM admission control,
        #: and a full queue answers 429 + Retry-After instead of an
        #: unbounded backlog (reference: TaskSchedulerImpl + FAIR pools)
        self.scheduler = scheduler if scheduler is not None \
            else QueryScheduler(session)
        # the UI status page reads queue depth / per-pool counts here
        session.query_scheduler = self.scheduler
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code: int, body: bytes, ctype: str,
                      headers=None) -> None:
                try:
                    self.send_response(code)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(body)))
                    tid = trace.current_trace_id()
                    if tid:
                        # echo the trace id so clients can fetch
                        # GET /trace/<id> for the waterfall
                        self.send_header("X-SparkTpu-Trace-Id", tid)
                    if outer.fleet_epoch:
                        # every response carries the adopted ownership
                        # epoch so routers and clients converge on the
                        # newest fence without a broadcast round trip
                        self.send_header(EPOCH_HEADER,
                                         str(outer.fleet_epoch))
                    for k, v in (headers or {}).items():
                        self.send_header(k, v)
                    self.end_headers()
                    self.wfile.write(body)
                except (BrokenPipeError, ConnectionResetError):
                    # the client gave up (e.g. its deadline passed while
                    # the request hung) — nothing left to tell it
                    pass

            def do_GET(self):
                if self.path == "/tables":
                    body = json.dumps(
                        outer.session.catalog.listTables()).encode()
                    self._send(200, body, "application/json")
                elif self.path == "/health":
                    hb = outer.heartbeat
                    body = json.dumps(
                        {"status": "ok",
                         "replica": outer.replica_id,
                         # live load snapshot the federation router's
                         # least_queued policy and shedding read
                         "queue_depth": outer.scheduler.queue_depth(),
                         "running": outer.scheduler.running_count(),
                         "heartbeat": hb.status() if hb is not None
                         else None,
                         "scheduler": outer.scheduler.status()}).encode()
                    self._send(
                        200, body, "application/json",
                        headers={"X-SparkTpu-Replica": outer.replica_id})
                elif self.path == "/shards":
                    # shard report: the federation router learns which
                    # scan file-sets this replica's catalog serves and
                    # rendezvous-maps them over the healthy fleet
                    from spark_tpu_torch.serve.ownership import catalog_shards

                    body = json.dumps(
                        {"replica": outer.replica_id,
                         "epoch": outer.fleet_epoch,
                         "tables":
                             catalog_shards(outer.session)}).encode()
                    self._send(200, body, "application/json")
                elif self.path.startswith("/invalidations"):
                    # watermark replay for reconnecting caches:
                    # GET /invalidations?since=<version>
                    from urllib.parse import parse_qs, urlparse

                    from spark_tpu_torch.serve.ownership import \
                        session_invalidation_log

                    q = parse_qs(urlparse(self.path).query)
                    since = int((q.get("since") or ["0"])[0])
                    log = session_invalidation_log(outer.session)
                    records, resync = log.since(since)
                    body = json.dumps(
                        {"version": log.version, "resync": resync,
                         "records": records}).encode()
                    self._send(200, body, "application/json")
                elif self.path.startswith("/queries"):
                    body = json.dumps(
                        {"status": outer.scheduler.status(),
                         "queries": outer.scheduler.describe()}).encode()
                    self._send(200, body, "application/json")
                elif self.path.startswith("/trace/"):
                    # Chrome trace-event JSON for one trace id, ready
                    # for Perfetto / chrome://tracing (in-process
                    # replicas share the metrics ring, so any replica
                    # can render the whole fleet-crossing trace)
                    from spark_tpu_torch import history, metrics

                    tid = self.path.rsplit("/", 1)[1]
                    evs = metrics.query_events(tid)
                    if not evs:
                        self._send(
                            404,
                            json.dumps({"error": "unknown trace",
                                        "trace_id": tid}).encode(),
                            "application/json")
                    else:
                        body = json.dumps(
                            history.chrome_trace(evs)).encode()
                        self._send(200, body, "application/json")
                else:
                    self._send(404, b"not found", "text/plain")

            def do_POST(self):
                if self.path.startswith("/cancel/"):
                    try:
                        qid = int(self.path.rsplit("/", 1)[1])
                    except ValueError:
                        self._send(400, b"bad query id", "text/plain")
                        return
                    ok = outer.scheduler.cancel(qid)
                    self._send(200 if ok else 404,
                               json.dumps({"cancelled": ok}).encode(),
                               "application/json")
                    return
                if self.path == "/epoch":
                    # router broadcast of a freshly minted epoch +
                    # shard->owner map: adopt it and eagerly rebuild
                    # any shards this replica just gained
                    n = int(self.headers.get("Content-Length", "0"))
                    try:
                        payload = json.loads(
                            self.rfile.read(n) or b"{}")
                        resp = outer._adopt_epoch(payload)
                        self._send(200, json.dumps(resp).encode(),
                                   "application/json")
                    except Exception as e:
                        self._send(400, json.dumps(
                            {"error": type(e).__name__,
                             "message": str(e)}).encode(),
                            "application/json")
                    return
                if self.path == "/lint":
                    # static analysis of a SQL query WITHOUT executing
                    # it: build the lazy DataFrame, analyze, return the
                    # report as JSON (the remote twin of
                    # df.explain(mode="lint"))
                    n = int(self.headers.get("Content-Length", "0"))
                    try:
                        req = json.loads(self.rfile.read(n))
                        from spark_tpu_torch import analysis

                        df = outer.session.sql(req["query"])
                        report = analysis.analyze(
                            df._plan, outer.session.conf,
                            intent=req.get("intent"))
                        body = json.dumps(report.to_dict()).encode()
                        self._send(200, body, "application/json")
                    except Exception as e:
                        body = json.dumps(
                            {"error": type(e).__name__,
                             "message": str(e)}).encode()
                        self._send(400, body, "application/json")
                    return
                if self.path not in ("/sql", "/plan"):
                    self._send(404, b"not found", "text/plain")
                    return
                stale = outer._fence_epoch(
                    self.headers.get(EPOCH_HEADER))
                if stale is not None:
                    # epoch fence: the sender's shard->owner map
                    # predates a failover this replica knows about —
                    # answer typed-retryable instead of serving under
                    # stale ownership; the router/client re-dispatch
                    # with a fresh stamp under the unified RetryBudget
                    err = EpochRetry(*stale)
                    metrics.note_serve("epoch_fences")
                    metrics.record("serve", phase="epoch_fence",
                                   replica=outer.replica_id,
                                   request_epoch=err.request_epoch,
                                   fleet_epoch=err.fleet_epoch)
                    body = json.dumps(
                        {"error": "EpochRetry",
                         "message": str(err),
                         "epoch": err.fleet_epoch}).encode()
                    self._send(409, body, "application/json")
                    return
                n = int(self.headers.get("Content-Length", "0"))
                # adopt the caller's trace (client or federation
                # router) so this request's spans — scheduler, stages,
                # faults — join the fleet-wide trace; a missing/bad
                # header starts a fresh root here. The caller's
                # absolute deadline rides the same hop: binding it
                # here puts it in scope for the scheduler ticket and
                # every retry/wait seam under this request.
                rctx = trace.from_header(
                    self.headers.get(trace.TRACE_HEADER))
                rdl = deadline.from_header(
                    self.headers.get(deadline.DEADLINE_HEADER))
                with trace.attach(rctx), deadline.bind(rdl), \
                        trace.span("connect.request", path=self.path,
                                   replica=outer.replica_id):
                    self._handle_query(n)

            def _handle_query(self, n: int) -> None:
                try:
                    faults.inject("connect.request", outer.session.conf)
                    # a request whose caller-deadline already passed in
                    # transit is dead on arrival: answer typed with
                    # ZERO scheduler submits and zero device work
                    deadline.check("connect.request")
                    req = json.loads(self.rfile.read(n))

                    def build_df():
                        if self.path == "/sql":
                            return outer.session.sql(req["query"])
                        # typed logical-plan protocol (reference:
                        # relations.proto decoded by
                        # SparkConnectPlanner.scala:67)
                        from spark_tpu_torch.api.dataframe import DataFrame
                        from spark_tpu_torch.connect.proto import decode_plan

                        return DataFrame(
                            outer.session,
                            decode_plan(req["plan"], outer.session))

                    pool = req.get("pool") \
                        or self.headers.get("X-Spark-Pool")
                    deadline_s = req.get("deadline_s")
                    description = req.get("query", f"plan:{self.path}")

                    def submit(bdf):
                        return outer.scheduler.submit_query(
                            bdf, pool=pool, description=description,
                            deadline_s=float(deadline_s)
                            if deadline_s is not None else None,
                            sql=req.get("query"))

                    cache = outer.result_cache
                    key = None
                    if cache is not None and cache.enabled():
                        # cache hook BEFORE submit_query: a hit (or a
                        # piggyback on an identical in-flight query)
                        # never touches the scheduler at all — the
                        # dispatch+execution cost of a repeated
                        # dashboard query is one dict lookup. The key
                        # goes through THIS cache's fingerprint probe
                        # (TTL-amortized under fingerprintCacheSeconds;
                        # kept fresh by the fleet invalidation log).
                        try:
                            df = build_df()
                            key = cache.result_key(df._plan)
                        except Exception:
                            key = None  # unkeyable: uncached path
                    if key is not None:
                        holder = {}

                        def execute():
                            t = holder["ticket"] = submit(lambda: df)
                            return t.result()

                        with trace.span("result_cache.probe"):
                            blob, status = cache.get_or_execute(
                                key, execute)
                        headers = {
                            "X-SparkTpu-Replica": outer.replica_id,
                            "X-Cache": status}
                        t = holder.get("ticket")
                        if t is not None:
                            headers["X-Query-Id"] = str(t.id)
                            headers["X-Queue-Wait-Ms"] = \
                                f"{t.queue_wait_ms():.2f}"
                        headers.update(outer._slo_headers(t))
                        self._send(
                            200, blob,
                            "application/vnd.apache.arrow.stream",
                            headers=headers)
                        return
                    ticket = submit(build_df)
                    tbl = ticket.result()
                    sink = io.BytesIO()
                    with pa.ipc.new_stream(sink, tbl.schema) as w:
                        w.write_table(tbl)
                    self._send(
                        200, sink.getvalue(),
                        "application/vnd.apache.arrow.stream",
                        headers={
                            "X-Query-Id": str(ticket.id),
                            "X-Queue-Wait-Ms":
                                f"{ticket.queue_wait_ms():.2f}",
                            "X-SparkTpu-Replica": outer.replica_id,
                            **outer._slo_headers(ticket)})
                except SchedulerQueueFull as e:
                    # backpressure, not failure: the client should back
                    # off and retry (Client honors Retry-After); the
                    # federation router instead sheds the request to
                    # the least-loaded healthy replica
                    body = json.dumps(
                        {"error": "SchedulerQueueFull",
                         "message": str(e),
                         "retry_after_s": e.retry_after_s}).encode()
                    self._send(429, body, "application/json",
                               headers={
                                   "Retry-After":
                                       f"{e.retry_after_s:g}",
                                   "X-SparkTpu-Replica":
                                       outer.replica_id})
                except InfeasibleDeadline as e:
                    # SLO reject-at-admission: the latency model says
                    # this query cannot finish inside its deadline, so
                    # it was shed BEFORE costing a queue slot or any
                    # device time. 503 (not 429): the queue is not
                    # full — retrying the same replica with the same
                    # deadline yields the same prediction. The
                    # federation router may still re-dispatch it to a
                    # less-loaded replica under the retry budget.
                    metrics.record("serve", phase="slo_reject",
                                   replica=outer.replica_id,
                                   predicted_ms=round(e.predicted_ms, 2))
                    body = json.dumps(
                        {"error": "InfeasibleDeadline",
                         "message": str(e),
                         "predicted_ms": round(e.predicted_ms, 3),
                         "queue_ms": round(e.queue_ms, 3),
                         "run_ms": round(e.run_ms, 3),
                         "deadline": e.deadline}).encode()
                    self._send(503, body, "application/json",
                               headers={
                                   "X-SparkTpu-Predicted-Ms":
                                       f"{e.predicted_ms:.2f}",
                                   "X-SparkTpu-Sched-Policy": "EDF",
                                   "X-SparkTpu-Replica":
                                       outer.replica_id})
                except Exception as e:  # error -> JSON with message
                    body = json.dumps(
                        {"error": type(e).__name__,
                         "message": str(e),
                         "traceback": traceback.format_exc()}).encode()
                    self._send(400, body, "application/json")

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address
        #: stable identity the federation router routes affinity by;
        #: defaults to the bound port (unique per in-process fleet)
        self.replica_id = replica_id or f"r{self.port}"
        self._thread: Optional[threading.Thread] = None

    # -- SLO surface -----------------------------------------------------------

    def _slo_headers(self, ticket=None) -> dict:
        """Response headers surfacing the SLO outcome (predicted
        latency, scheduling policy, predictive-brownout level). Empty
        when spark.tpu.slo.enabled is off so the off-path response is
        byte-identical to the pre-SLO server."""
        if getattr(self.scheduler, "_slo", None) is None:
            return {}
        h = {"X-SparkTpu-Sched-Policy": "EDF",
             "X-SparkTpu-Brownout": str(metrics.brownout_level())}
        pred = getattr(ticket, "slo_predicted_ms", None) \
            if ticket is not None else None
        if pred is not None:
            h["X-SparkTpu-Predicted-Ms"] = f"{pred:.2f}"
        return h

    # -- fleet ownership ------------------------------------------------------

    def _fence_epoch(self, header_value):
        """None = admit the request; ``(request_epoch, fleet_epoch)``
        = fence it (typed EPOCH_RETRY). A NEWER stamp is adopted
        monotonically — the broadcast that should have carried it may
        have been lost, and the stamp itself is proof the epoch
        exists."""
        if header_value is None:
            return None
        try:
            e = int(header_value)
        except (TypeError, ValueError):
            return None  # malformed stamp: route by policy, no fence
        with self._epoch_lock:
            if e > self.fleet_epoch:
                self.fleet_epoch = e
                return None
            if e < self.fleet_epoch:
                return (e, self.fleet_epoch)
        return None

    def _adopt_epoch(self, payload: dict) -> dict:
        """Adopt a broadcast epoch + owner map; eagerly rebuild any
        shards this replica just GAINED (the lineage-recompute
        analogue: state is re-derived from source files, so a lost or
        failed rebuild only costs latency on the first owned query,
        never bytes)."""
        epoch = int(payload.get("epoch", 0))
        owners = payload.get("owners") or {}
        shard_paths = payload.get("shards") or {}
        with self._epoch_lock:
            if epoch > self.fleet_epoch:
                self.fleet_epoch = epoch
            mine = {s for s, rid in owners.items()
                    if rid == self.replica_id}
            gained = sorted(mine - self._owned_shards)
            self._owned_shards = mine
            fleet = self.fleet_epoch
        if gained:
            self._rebuild_shards(gained, shard_paths)
        return {"replica": self.replica_id, "epoch": fleet,
                "owned": sorted(mine), "gained": gained}

    def _rebuild_shards(self, gained, shard_paths) -> None:
        """Warm the dataset + schema of every newly-gained shard from
        its source files, deadline-capped; ANY failure (including an
        injected ``serve.ownership`` fault) degrades to lazy rebuild
        on the first owned query."""
        from spark_tpu_torch.plan import logical as L
        from spark_tpu_torch.serve.ownership import (
            SERVE_OWNERSHIP_REBUILD,
            SERVE_OWNERSHIP_REBUILD_TIMEOUT_S, shard_key)

        conf = self.session.conf
        try:
            if not bool(conf.get(SERVE_OWNERSHIP_REBUILD)):
                return
            tmo = float(conf.get(SERVE_OWNERSHIP_REBUILD_TIMEOUT_S))
        except Exception:
            return
        warmed = 0
        wanted = set(gained)
        views = getattr(getattr(self.session, "catalog", None),
                        "_views", None) or {}
        try:
            with deadline.bind(deadline.mint(tmo)):
                faults.inject("serve.ownership", conf)
                for name, plan in list(views.items()):
                    scans = L.collect_nodes(plan, L.UnresolvedScan)
                    if len(scans) != 1:
                        continue
                    src = scans[0].source
                    paths = getattr(src, "paths", None)
                    if not paths or shard_key(paths) not in wanted:
                        continue
                    deadline.check("serve.ownership")
                    # warm the REAL session-shared source: dataset
                    # discovery + schema, so the first owned query
                    # pays only the device execution
                    src._open()
                    src.schema  # noqa: B018 - the property reads it
                    warmed += 1
            metrics.note_serve("rebuilds")
            metrics.record("serve", phase="rebuild",
                           replica=self.replica_id,
                           shards=len(gained), warmed=warmed)
        except Exception as e:
            metrics.record("fault_recovered", point="serve.ownership",
                           how="lazy_rebuild",
                           replica=self.replica_id, warmed=warmed,
                           error=type(e).__name__)

    def start(self) -> "ConnectServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="spark-tpu-connect", daemon=True)
        self._thread.start()
        # the pre-warm hook: with the compile tier on, the served-plan
        # history replays on a background worker (each plan through its
        # first run and its capture) before the first client query
        try:
            svc = self.session.compile_service
            if svc is not None and bool(
                    self.session.conf.get(CF.COMPILE_PREWARM_ENABLED)):
                svc.prewarm(self.session, block=False)
        except Exception:  # noqa: BLE001 - never a startup failure
            pass
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self.scheduler.stop()
        if getattr(self.session, "query_scheduler", None) \
                is self.scheduler:
            self.session.query_scheduler = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"


def serve(session, host: str = "127.0.0.1", port: int = 15002,
          heartbeat=None) -> ConnectServer:
    """Start the server (default port mirrors Spark Connect's 15002)."""
    return ConnectServer(session, host, port,
                         heartbeat=heartbeat).start()


class _RetryableHTTP(RuntimeError):
    """A 429 backpressure response; carries the server's Retry-After."""

    def __init__(self, message: str, retry_after_s: float = 0.0):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


class Client:
    """Minimal client: sql() -> pyarrow.Table (reference client surface:
    pyspark.sql.connect.session.SparkSession.sql).

    Transient connection errors (refused/reset — a flapping or
    restarting server) and 429 backpressure responses are retried with
    FULL-JITTER bounded exponential backoff (delay drawn uniformly
    from [0, min(cap, base * 2^attempt)]): N clients rejected by the
    same full queue would otherwise all sleep the identical
    deterministic delay and stampede the queue again the moment it
    expires. A 429's Retry-After hint is still honored as an additive
    floor — the jitter spreads arrivals across the window AFTER the
    server said capacity may exist. Timeouts and real query errors
    are NOT retried — a deadline that passed once will pass again, and
    retrying a genuine bug only quadruples its latency.

    When the server echoes an ``X-SparkTpu-Replica`` header (a
    federation router does, naming the replica that served the
    request), the client sends it back on subsequent requests as
    session affinity, keeping one client's queries on one replica's
    warm scheduler/compile state."""

    def __init__(self, url: str, timeout: float = 60.0,
                 retries: int = 3, backoff_s: float = 0.05,
                 max_backoff_s: float = 2.0):
        self.url = url.rstrip("/")
        #: per-request deadline — urllib otherwise blocks forever on a
        #: hung server
        self.timeout = float(timeout)
        self.retries = max(0, int(retries))
        self.backoff_s = float(backoff_s)
        self.max_backoff_s = float(max_backoff_s)
        #: replica affinity echoed by a federation router; None until
        #: the first routed response
        self.affinity: Optional[str] = None
        #: trace id of the last completed request (the server echoes
        #: it via X-SparkTpu-Trace-Id); fetch the waterfall with
        #: ``trace(client.last_trace_id)``
        self.last_trace_id: Optional[str] = None
        #: metadata of the last completed request: ``replica`` (which
        #: backend served it), ``cache`` (X-Cache: hit/miss/wait),
        #: ``epoch`` (the fleet ownership epoch the response carried),
        #: ``query_id``, ``queue_wait_ms``, ``trace_id``
        self.last_query: dict = {}

    def _jitter(self, attempt: int) -> float:
        import random as _random

        return _random.uniform(
            0.0, min(self.max_backoff_s,
                     self.backoff_s * (2.0 ** attempt)))

    def _post(self, path: str, payload: dict,
              pool: Optional[str] = None) -> pa.Table:
        # one client-side span across every retry attempt: the whole
        # request (including backoff) is a single unit of the trace,
        # and each attempt ships the span context in X-SparkTpu-Trace.
        # The per-request timeout mints the ABSOLUTE deadline the
        # whole fleet honors (X-SparkTpu-Deadline); an already-bound
        # tighter caller deadline wins inside bind().
        with deadline.bind(deadline.mint(self.timeout)), \
                trace.span("connect.client", path=path):
            return self._post_retrying(path, payload, pool)

    def _post_retrying(self, path: str, payload: dict,
                       pool: Optional[str] = None) -> pa.Table:
        import time as _time

        from spark_tpu_torch.recovery import RetryBudget

        # a request-local budget (the client has no session conf):
        # same draw discipline and counters as the server-side seams
        budget = RetryBudget(self.retries, layer_floor=0,
                             backoff_base_s=self.backoff_s,
                             backoff_cap_s=self.max_backoff_s)
        last: Optional[BaseException] = None
        for attempt in range(self.retries + 1):
            try:
                return self._post_once(path, payload, pool)
            except _RetryableHTTP as e:
                # 429 backpressure: the server's Retry-After hint is
                # the floor, full jitter desynchronizes the herd above
                # it
                last = e
                delay = e.retry_after_s + self._jitter(attempt)
            except (ConnectionRefusedError, ConnectionResetError,
                    ConnectionAbortedError, BrokenPipeError) as e:
                last = e
                delay = self._jitter(attempt)
            if attempt >= self.retries \
                    or not budget.draw("connect.client"):
                break
            # never sleep past the request deadline (a Retry-After
            # floor beyond it used to put the client to sleep through
            # its own timeout), and fail FAST with the typed error
            # once the window closes instead of burning an attempt on
            # a doomed round trip
            _time.sleep(deadline.cap_sleep(delay))
            deadline.check("connect.client")
        raise RuntimeError(
            f"connect request to {self.url + path} failed after "
            f"{attempt + 1} attempts (last: {last!r})") from last

    def _post_once(self, path: str, payload: dict,
                   pool: Optional[str] = None) -> pa.Table:
        import socket
        import urllib.error
        import urllib.request

        headers = {"Content-Type": "application/json"}
        if pool:
            headers["X-Spark-Pool"] = pool
        if self.affinity:
            headers["X-SparkTpu-Replica"] = self.affinity
        hv = trace.header_value()
        if hv:
            headers[trace.TRACE_HEADER] = hv
        dv = deadline.header_value()
        if dv:
            headers[deadline.DEADLINE_HEADER] = dv
        # the socket timeout shrinks with the request deadline: a
        # retry attempt near the window's end gets only what is left
        timeout = self.timeout
        rem = deadline.remaining()
        if rem is not None:
            timeout = max(0.001, min(timeout, rem))
        req = urllib.request.Request(
            self.url + path,
            data=json.dumps(payload).encode(), headers=headers)
        t0 = time.monotonic()
        try:
            with urllib.request.urlopen(req,
                                        timeout=timeout) as resp:
                data = resp.read()
                rid = resp.headers.get("X-SparkTpu-Replica")
                if rid:
                    self.affinity = rid
                tid = resp.headers.get("X-SparkTpu-Trace-Id")
                if tid:
                    self.last_trace_id = tid
                epoch = resp.headers.get("X-SparkTpu-Epoch")
                pred = resp.headers.get("X-SparkTpu-Predicted-Ms")
                self.last_query = {
                    "replica": rid,
                    "cache": resp.headers.get("X-Cache"),
                    "epoch": int(epoch) if epoch else None,
                    "query_id": resp.headers.get("X-Query-Id"),
                    "queue_wait_ms":
                        resp.headers.get("X-Queue-Wait-Ms"),
                    "trace_id": tid,
                    # SLO outcome: predicted vs (client-measured)
                    # actual latency, the policy that scheduled it,
                    # and reject/brownout status — None/False with
                    # SLO off, so consumers need no feature check
                    "slo_predicted_ms":
                        float(pred) if pred else None,
                    "slo_actual_ms": round(
                        (time.monotonic() - t0) * 1e3, 2),
                    "sched_policy": resp.headers.get(
                        "X-SparkTpu-Sched-Policy"),
                    "brownout": resp.headers.get("X-SparkTpu-Brownout"),
                    "slo_rejected": False,
                }
        except urllib.error.HTTPError as e:
            detail = json.loads(e.read())
            if e.code == 503 \
                    and detail.get("error") == "InfeasibleDeadline":
                # typed SLO reject: NOT retried here (same replica +
                # same deadline = same prediction); surfaces to the
                # caller with the prediction that condemned it
                from spark_tpu_torch.slo.edf import InfeasibleDeadline

                rid = e.headers.get("X-SparkTpu-Replica")
                if rid:
                    self.affinity = rid
                self.last_query = {
                    "replica": rid,
                    "slo_predicted_ms": detail.get("predicted_ms"),
                    "slo_actual_ms": round(
                        (time.monotonic() - t0) * 1e3, 2),
                    "sched_policy": e.headers.get(
                        "X-SparkTpu-Sched-Policy"),
                    "brownout": e.headers.get("X-SparkTpu-Brownout"),
                    "slo_rejected": True,
                }
                raise InfeasibleDeadline(
                    float(detail.get("predicted_ms") or 0.0),
                    float(detail.get("deadline") or 0.0),
                    queue_ms=float(detail.get("queue_ms") or 0.0),
                    run_ms=float(detail.get("run_ms") or 0.0)) \
                    from None
            if e.code == 429:
                ra = e.headers.get("Retry-After") \
                    or detail.get("retry_after_s") or 0.0
                raise _RetryableHTTP(
                    f"429 {detail.get('message')}",
                    retry_after_s=float(ra)) from None
            if e.code == 409:
                # typed EPOCH_RETRY from an un-routed replica (direct
                # connection): immediately retryable with no backoff
                # floor — the fence is about staleness, not load; the
                # exhaustion error keeps the EPOCH_RETRY marker so it
                # stays typed for the chaos contract
                raise _RetryableHTTP(
                    f"409 {detail.get('message')}",
                    retry_after_s=0.0) from None
            msg = f"{detail.get('error')}: {detail.get('message')}"
            tb = detail.get("traceback")
            if tb:
                msg += f"\n--- server traceback ---\n{tb}"
            raise RuntimeError(msg) from None
        except urllib.error.URLError as e:
            reason = getattr(e, "reason", None)
            if isinstance(reason, (socket.timeout, TimeoutError)):
                raise RuntimeError(
                    f"DEADLINE_EXCEEDED: connect request to "
                    f"{self.url + path} timed out after "
                    f"{self.timeout:g}s") from e
            if isinstance(reason, (ConnectionRefusedError,
                                   ConnectionResetError,
                                   ConnectionAbortedError,
                                   BrokenPipeError)):
                raise reason  # unwrapped: the retry loop classifies it
            raise
        except (socket.timeout, TimeoutError) as e:
            raise RuntimeError(
                f"DEADLINE_EXCEEDED: connect request to "
                f"{self.url + path} timed out after "
                f"{self.timeout:g}s") from e
        return pa.ipc.open_stream(io.BytesIO(data)).read_all()

    def sql(self, query: str, pool: Optional[str] = None,
            deadline_s: Optional[float] = None) -> pa.Table:
        payload = {"query": query}
        if deadline_s is not None:
            payload["deadline_s"] = float(deadline_s)
        return self._post("/sql", payload, pool=pool)

    def queries(self) -> dict:
        """Scheduler status + recent query lifecycle records."""
        import urllib.request

        with urllib.request.urlopen(self.url + "/queries",
                                    timeout=self.timeout) as resp:
            return json.loads(resp.read())

    def cancel(self, query_id: int) -> bool:
        import urllib.request

        req = urllib.request.Request(
            f"{self.url}/cancel/{int(query_id)}", data=b"{}",
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req,
                                        timeout=self.timeout) as resp:
                return bool(json.loads(resp.read()).get("cancelled"))
        except Exception:
            return False

    def tables(self):
        import urllib.request

        with urllib.request.urlopen(self.url + "/tables",
                                    timeout=self.timeout) as resp:
            return json.loads(resp.read())

    def health(self) -> dict:
        import urllib.request

        with urllib.request.urlopen(self.url + "/health",
                                    timeout=self.timeout) as resp:
            return json.loads(resp.read())

    def trace(self, trace_id: Optional[str] = None) -> dict:
        """Chrome trace-event JSON (Perfetto-loadable) for a trace id
        (default: the last completed request's)."""
        import urllib.request

        tid = trace_id or self.last_trace_id
        if not tid:
            raise ValueError("no trace id: run a query first or pass "
                             "trace_id explicitly")
        with urllib.request.urlopen(f"{self.url}/trace/{tid}",
                                    timeout=self.timeout) as resp:
            return json.loads(resp.read())

    def _execute_plan(self, plan: dict) -> pa.Table:
        return self._post("/plan", {"plan": plan})

    def table(self, name: str) -> "RemoteDataFrame":
        """Lazy remote DataFrame over the typed plan protocol
        (connect/proto.py; reference: relations.proto + the pyspark
        connect client's plan builders)."""
        return RemoteDataFrame(self, {"op": "read", "table": name})


def col(name: str) -> dict:
    return {"e": "col", "name": name}


def lit(value, type_: str = None) -> dict:  # noqa: A002
    out = {"e": "lit", "value": value}
    if type_:
        out["type"] = type_
    return out


def fn(name: str, *args, distinct: bool = False) -> dict:
    out = {"e": "fn", "name": name,
           "args": [_e(a) for a in args]}
    if distinct:
        out["distinct"] = True
    return out


def _e(x) -> dict:
    if isinstance(x, dict):
        return x
    if isinstance(x, str):
        return col(x)
    return lit(x)


def _alias(e: dict, name: str) -> dict:
    return {"e": "alias", "name": name, "child": e}


class RemoteDataFrame:
    """Client-side lazy plan builder with NO engine imports — every
    method appends a typed relation node; collect() ships the JSON plan
    and reads back Arrow (the decoupled-client shape of
    pyspark.sql.connect.dataframe.DataFrame)."""

    def __init__(self, client: Client, plan: dict):
        self._client = client
        self._plan = plan

    def filter(self, condition: dict) -> "RemoteDataFrame":
        return RemoteDataFrame(self._client, {
            "op": "filter", "condition": condition, "child": self._plan})

    def select(self, *exprs) -> "RemoteDataFrame":
        return RemoteDataFrame(self._client, {
            "op": "project", "exprs": [_e(x) for x in exprs],
            "child": self._plan})

    def groupBy(self, *keys) -> "RemoteGroupedData":  # noqa: N802
        return RemoteGroupedData(self, [_e(k) for k in keys])

    def join(self, other: "RemoteDataFrame", on,
             how: str = "inner") -> "RemoteDataFrame":
        names = [on] if isinstance(on, str) else list(on)
        return RemoteDataFrame(self._client, {
            "op": "join", "how": how, "on": names,
            "left": self._plan, "right": other._plan})

    def sort(self, *exprs, ascending: bool = True) -> "RemoteDataFrame":
        orders = [{"expr": _e(x), "asc": bool(ascending)}
                  for x in exprs]
        return RemoteDataFrame(self._client, {
            "op": "sort", "orders": orders, "child": self._plan})

    orderBy = sort

    def limit(self, n: int, offset: int = 0) -> "RemoteDataFrame":
        return RemoteDataFrame(self._client, {
            "op": "limit", "n": int(n), "offset": int(offset),
            "child": self._plan})

    def union(self, other: "RemoteDataFrame") -> "RemoteDataFrame":
        return RemoteDataFrame(self._client, {
            "op": "union", "left": self._plan, "right": other._plan})

    def distinct(self) -> "RemoteDataFrame":
        return RemoteDataFrame(self._client,
                               {"op": "distinct", "child": self._plan})

    def toArrow(self) -> pa.Table:  # noqa: N802
        return self._client._execute_plan(self._plan)

    def collect(self):
        return self.toArrow().to_pylist()


class RemoteGroupedData:
    def __init__(self, df: RemoteDataFrame, keys):
        self._df = df
        self._keys = keys

    def agg(self, **aliased) -> RemoteDataFrame:
        aggs = [_alias(e, name) for name, e in aliased.items()]
        return RemoteDataFrame(self._df._client, {
            "op": "aggregate", "groupings": self._keys,
            "aggregates": aggs, "child": self._df._plan})
