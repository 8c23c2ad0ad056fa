"""Federation router: one HTTP front end over N ConnectServer replicas
(the port of ``spark_tpu/serve/router.py``).

A stdlib ThreadingHTTPServer (the same machinery as the connect server
and the status UI — no new dependency) that speaks the EXACT connect
protocol, so the existing ``connect.server.Client`` talks to a fleet
without changes: POST /sql, /plan, /lint, /cancel/<id>; GET /health,
/tables, /queries. Query traffic routes through
``Federation.dispatch`` (policy pick, 429 shedding, bounded
re-dispatch around dead replicas); the chosen replica's id is echoed
back as ``X-SparkTpu-Replica`` and honored as session affinity when
the client sends it on its next request.

Deployment shapes:

- **in-process fleet** (tests, single-host bench): ``serve_fleet``
  spawns N ConnectServers as threads over ONE session — they share
  the device mesh, the HBM store, and one ResultCache (so the
  single-flight herd guarantee spans replicas).
- **multi-process fleet** (production): start one
  ``connect.serve(session)`` per host/mesh-slice, then
  ``FederationRouter(["http://host1:15002", ...])`` anywhere — the
  router only ever speaks HTTP to replica URLs.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Sequence

from spark_tpu_torch import conf as CF
from spark_tpu_torch import deadline, metrics, recovery, trace
from spark_tpu_torch.serve.federation import Federation, NoHealthyReplica

#: request headers the router forwards to the chosen replica
#: (X-SparkTpu-Trace is a passthrough fallback — Federation.dispatch
#: rewrites it per forward attempt so replica spans parent correctly;
#: X-SparkTpu-Deadline is an ABSOLUTE timestamp, forwarded verbatim so
#: the replica's scheduler/retry seams observe the client's window)
_FORWARD_HEADERS = ("Content-Type", "X-Spark-Pool", trace.TRACE_HEADER,
                    deadline.DEADLINE_HEADER)


class FederationRouter:
    """HTTP front end; ``replicas`` is any mix of ConnectServer
    objects, URLs, or (id, url) pairs."""

    def __init__(self, replicas: Sequence, conf=None,
                 host: str = "127.0.0.1", port: int = 0,
                 timeout: float = 120.0):
        self.conf = conf if conf is not None else CF.RuntimeConf()
        self.federation = Federation(replicas, self.conf,
                                     timeout=timeout)
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
                    for k, v in (headers or {}).items():
                        self.send_header(k, v)
                    self.end_headers()
                    self.wfile.write(body)
                except (BrokenPipeError, ConnectionResetError):
                    pass

            def _dispatch(self, method: str) -> None:
                n = int(self.headers.get("Content-Length", "0"))
                body = self.rfile.read(n) if n else None
                fwd = {k: self.headers[k] for k in _FORWARD_HEADERS
                       if self.headers.get(k)}
                affinity = self.headers.get("X-SparkTpu-Replica")
                # adopt the client's trace so router.dispatch /
                # router.forward spans join it (a fresh root otherwise);
                # bind the client's deadline so the dispatch loop's own
                # re-dispatch attempts stop when the window closes, and
                # a per-request retry budget so re-dispatches draw from
                # the same unified pool as every other layer
                rctx = trace.from_header(
                    self.headers.get(trace.TRACE_HEADER))
                rdl = deadline.from_header(
                    self.headers.get(deadline.DEADLINE_HEADER))
                with trace.attach(rctx), deadline.bind(rdl), \
                        recovery.bind_default_budget(outer.conf):
                    self._dispatch_traced(method, body, fwd, affinity)

            def _dispatch_traced(self, method: str, body, fwd,
                                 affinity) -> None:
                try:
                    code, data, hdr = outer.federation.dispatch(
                        method, self.path, body, headers=fwd,
                        affinity=affinity)
                except deadline.DeadlineExceeded as e:
                    self._send(504, json.dumps(
                        {"error": "DeadlineExceeded",
                         "message": str(e)}).encode(),
                        "application/json")
                    return
                except NoHealthyReplica as e:
                    self._send(503, json.dumps(
                        {"error": "NoHealthyReplica",
                         "message": str(e)}).encode(),
                        "application/json")
                    return
                except Exception as e:
                    self._send(500, json.dumps(
                        {"error": type(e).__name__,
                         "message": str(e)}).encode(),
                        "application/json")
                    return
                ctype = "application/vnd.apache.arrow.stream" \
                    if code == 200 and self.path in ("/sql", "/plan") \
                    else "application/json"
                self._send(code, data, ctype, headers=hdr)

            def do_GET(self):
                if self.path == "/health":
                    outer.federation.probe(force=True)
                    reps = outer.federation.status()
                    ok = any(r["healthy"] for r in reps)
                    body = json.dumps({
                        "status": "ok" if ok else "degraded",
                        "router": True,
                        "policy": str(outer.conf.get(CF.SERVE_POLICY)),
                        "replicas": reps,
                        "brownout":
                            outer.federation.brownout.snapshot(),
                        "ownership":
                            outer.federation.ownership.snapshot(),
                        "retry_budget":
                            metrics.retry_budget_stats()}).encode()
                    self._send(200, body, "application/json")
                    return
                if self.path == "/tables" \
                        or self.path.startswith("/queries") \
                        or self.path.startswith("/trace/"):
                    self._dispatch("GET")
                    return
                self._send(404, b"not found", "text/plain")

            def do_POST(self):
                if self.path.startswith("/cancel/"):
                    # query ids are replica-local: broadcast, report
                    # success if any replica owned the id
                    n = int(self.headers.get("Content-Length", "0"))
                    body = self.rfile.read(n) if n else b"{}"
                    cancelled = False
                    for r in outer.federation.healthy():
                        try:
                            code, data, _ = outer.federation.forward(
                                r, "POST", self.path, body,
                                {"Content-Type": "application/json"})
                            if code == 200 and json.loads(data).get(
                                    "cancelled"):
                                cancelled = True
                        except Exception:
                            continue
                    self._send(
                        200 if cancelled else 404,
                        json.dumps({"cancelled": cancelled}).encode(),
                        "application/json")
                    return
                if self.path not in ("/sql", "/plan", "/lint"):
                    self._send(404, b"not found", "text/plain")
                    return
                self._dispatch("POST")

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "FederationRouter":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="spark-tpu-router", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"


class Fleet:
    """An in-process serving fleet: N replica ConnectServers (threads
    over one session) plus the router in front. ``stop()`` tears the
    whole thing down in reverse order."""

    def __init__(self, router: FederationRouter, replicas: List):
        self.router = router
        self.replicas = replicas

    @property
    def url(self) -> str:
        return self.router.url

    def stop(self) -> None:
        self.router.stop()
        for r in self.replicas:
            try:
                r.stop()
            except Exception:
                pass


def serve_fleet(session, replicas: Optional[int] = None,
                host: str = "127.0.0.1", port: int = 0,
                timeout: float = 120.0) -> Fleet:
    """Spawn ``replicas`` in-process ConnectServers over ``session``
    (default ``spark.tpu.serve.replicas``) and a FederationRouter in
    front; returns the started Fleet."""
    from spark_tpu_torch.connect.server import ConnectServer
    from spark_tpu_torch.serve.ownership import (SERVE_OWNERSHIP_ENABLED,
                                           session_invalidation_log)
    from spark_tpu_torch.serve.result_cache import ResultCache

    n = int(replicas if replicas is not None
            else session.conf.get(CF.SERVE_REPLICAS))
    n = max(1, n)
    try:
        owned = bool(session.conf.get(SERVE_OWNERSHIP_ENABLED))
    except Exception:
        owned = False
    caches = None
    if owned:
        # ownership mode: each replica keys and owns its OWN result
        # cache (the fleet-coherence contract is the invalidation log
        # + owner routing, not shared memory) — this is the in-process
        # stand-in for the multi-process fleet, where separate caches
        # are physically forced
        log = session_invalidation_log(session)
        caches = [
            ResultCache(session.conf).attach_invalidation_log(log)
            for _ in range(n)]
    servers = [
        ConnectServer(session, host=host, port=0,
                      replica_id=f"r{i}",
                      result_cache=caches[i] if caches else None
                      ).start()
        for i in range(n)]
    router = FederationRouter(servers, conf=session.conf,
                              host=host, port=port,
                              timeout=timeout).start()
    return Fleet(router, servers)
