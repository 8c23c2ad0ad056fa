"""Cross-replica dispatch: health probing, policy pick, admission
shedding, and bounded re-dispatch on replica death (the port of
``spark_tpu/serve/federation.py``).

The router's brain. Each replica is a ConnectServer (in-process thread
or separate process — only its URL matters here) whose ``/health``
reports ``replica`` id, live ``queue_depth`` and ``running`` count
(scheduler/scheduler.py snapshots under its own lock). Dispatch:

- **pick** honors session affinity first (the ``X-SparkTpu-Replica``
  header a client echoes back), then the configured policy
  (``spark.tpu.serve.policy``): ``round_robin`` cycles healthy
  replicas, ``least_queued`` takes the one with the fewest
  queued+running queries at the last probe.
- **shed** — a 429 (SchedulerQueueFull) from the chosen replica is NOT
  surfaced: the request re-dispatches to the least-loaded healthy
  replica that has not itself answered 429 for this request. Only when
  every healthy replica is saturated does the client see a 429, with
  ``Retry-After = min`` across the replicas' hints (the soonest any
  capacity frees up anywhere in the fleet).
- **re-dispatch** — a connection failure (or an injected
  ``serve.dispatch`` fault: a replica dying mid-query) marks the
  replica unhealthy and retries a different one, bounded by
  ``spark.tpu.serve.dispatchRetries``. The single-flight result cache
  keys re-dispatched queries to the same structural key, so the query
  still executes at most once even when two replicas see it.

Reference analogue: the driver-side OutputCommitCoordinator +
ExecutorFailuresAllowlist shape (task re-offer on a different executor
after a lost one, bounded by spark.task.maxFailures).
"""

from __future__ import annotations

import collections
import json
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional, Sequence, Tuple

from spark_tpu_torch import locks
from spark_tpu_torch import conf as CF
from spark_tpu_torch import deadline, faults, metrics, recovery, trace
from spark_tpu_torch.serve.ownership import (EPOCH_HEADER,
                                       OwnershipCoordinator)

SERVE_BREAKER_ENABLED = CF.register(
    "spark.tpu.serve.breaker.enabled", True,
    "Per-replica circuit breaker: a replica whose recent dispatch "
    "failure rate crosses breaker.failureRate stops receiving traffic "
    "(open) until a probe trickle (half-open) proves it healthy again.",
    bool)
SERVE_BREAKER_WINDOW_S = CF.register(
    "spark.tpu.serve.breaker.windowSeconds", 30.0,
    "Sliding window over which a replica's dispatch failure rate is "
    "measured for the circuit breaker.", float)
SERVE_BREAKER_MIN_REQUESTS = CF.register(
    "spark.tpu.serve.breaker.minRequests", 5,
    "Minimum dispatch outcomes inside the window before the breaker "
    "will open (a single failure on a cold replica is not a rate).",
    int)
SERVE_BREAKER_FAILURE_RATE = CF.register(
    "spark.tpu.serve.breaker.failureRate", 0.5,
    "Windowed failure-rate threshold at which a replica's breaker "
    "opens.", float)
SERVE_BREAKER_OPEN_S = CF.register(
    "spark.tpu.serve.breaker.openSeconds", 2.0,
    "How long an open breaker blocks all traffic before admitting a "
    "single half-open probe request.", float)

SERVE_BROWNOUT_ENABLED = CF.register(
    "spark.tpu.serve.brownout.enabled", True,
    "Fleet-wide brownout: under sustained dispatch pressure the fleet "
    "sheds analysis-heavy OPTIONAL work (trace sampling, compile "
    "pre-warm, scan auto-cache promotion) before it sheds queries.",
    bool)
SERVE_BROWNOUT_WINDOW_S = CF.register(
    "spark.tpu.serve.brownout.windowSeconds", 30.0,
    "Sliding window over which fleet dispatch pressure (sheds + "
    "failures as a fraction of outcomes) is measured.", float)
SERVE_BROWNOUT_ENTER_RATE = CF.register(
    "spark.tpu.serve.brownout.enterRate", 0.5,
    "Windowed pressure at or above which the fleet enters brownout "
    "level 1.", float)
SERVE_BROWNOUT_EXIT_RATE = CF.register(
    "spark.tpu.serve.brownout.exitRate", 0.1,
    "Windowed pressure at or below which the fleet exits brownout "
    "(hysteresis: between exitRate and enterRate the level holds).",
    float)
SERVE_BROWNOUT_MIN_EVENTS = CF.register(
    "spark.tpu.serve.brownout.minEvents", 8,
    "Minimum dispatch outcomes inside the window before the brownout "
    "level may change.", int)

#: response headers a replica sets that the router relays verbatim
RELAY_HEADERS = ("X-Query-Id", "X-Queue-Wait-Ms", "X-Cache",
                 "Retry-After", "X-SparkTpu-Replica",
                 "X-SparkTpu-Trace-Id", "X-SparkTpu-Epoch",
                 "X-SparkTpu-Predicted-Ms", "X-SparkTpu-Sched-Policy",
                 "X-SparkTpu-Brownout")

#: connection-level failures that mean "this replica is gone" — the
#: re-dispatch trigger (same set the connect Client classifies as
#: retryable)
_CONN_ERRORS = (ConnectionRefusedError, ConnectionResetError,
                ConnectionAbortedError, BrokenPipeError, OSError)


class NoHealthyReplica(RuntimeError):
    """Every replica is down (distinct from all-saturated, which is a
    429 the client can retry after Retry-After)."""


class CircuitBreaker:
    """Per-replica closed/open/half-open breaker over a sliding window
    of dispatch outcomes.

    closed: outcomes accumulate in the window; when there are at least
    ``breaker.minRequests`` of them and the failure fraction reaches
    ``breaker.failureRate``, the breaker OPENS. open: all traffic is
    refused for ``breaker.openSeconds``, then the next ``admits()``
    moves to half-open. half-open: exactly ONE probe request is
    admitted at a time (``begin()`` claims the slot); its success
    CLOSES the breaker and clears the window, its failure re-OPENS it.
    The router's health probe is orthogonal: the breaker measures real
    dispatch outcomes, not /health reachability, so a replica that
    answers /health but fails queries still trips."""

    _MAX_TRANSITIONS = 32

    def __init__(self, conf=None):
        self._conf = conf
        self._lock = locks.named_lock("serve.breaker")
        #: replica id, for the breaker_transition metrics events
        self.owner = ""
        self.state = "closed"
        self._window: collections.deque = collections.deque()
        self._opened_at = 0.0
        self._probe_inflight = False
        self._last_change: Optional[Tuple[str, str]] = None
        #: bounded (ts, from, to) history — the chaos campaign asserts
        #: open -> half_open -> closed recovery through this
        self.state_changes: List[Tuple[float, str, str]] = []

    def _param(self, entry, cast):
        try:
            return cast(self._conf.get(entry)) if self._conf is not None \
                else cast(entry.default)
        except Exception:
            return cast(entry.default)

    def _enabled(self) -> bool:
        return self._param(SERVE_BREAKER_ENABLED, bool)

    def _set_state_locked(self, to: str) -> None:
        if to == self.state:
            return
        self.state_changes.append((time.time(), self.state, to))
        del self.state_changes[:-self._MAX_TRANSITIONS]
        self._last_change = (self.state, to)
        self.state = to

    def _publish(self) -> None:
        """Emit the latest transition as a metrics event — called by
        the public methods AFTER releasing the breaker lock (metrics
        takes its own registry lock; same outside-the-lock discipline
        as the brownout controller)."""
        with self._lock:
            change, self._last_change = self._last_change, None
        if change is None:
            return
        metrics.note_serve("breaker_transitions")
        metrics.record("serve", phase="breaker_transition",
                       replica=self.owner, from_state=change[0],
                       to_state=change[1])

    def _prune(self, now: float) -> None:
        horizon = now - self._param(SERVE_BREAKER_WINDOW_S, float)
        w = self._window
        while w and w[0][0] < horizon:
            w.popleft()

    def admits(self) -> bool:
        """May this replica receive a request right now? (Transitions
        open -> half_open once openSeconds have elapsed.)"""
        if not self._enabled():
            return True
        with self._lock:
            if self.state == "open":
                open_s = self._param(SERVE_BREAKER_OPEN_S, float)
                if time.time() - self._opened_at >= open_s:
                    self._set_state_locked("half_open")
                    self._probe_inflight = False
                else:
                    return False
            if self.state == "half_open":
                result = not self._probe_inflight
            else:
                result = True
        self._publish()
        return result

    def reset(self) -> None:
        """Forget all window history and transitions and return to
        closed — used between directed chaos scenarios so one
        scenario's outcome mix does not skew the next one's rate."""
        with self._lock:
            self._window.clear()
            self._probe_inflight = False
            self.state = "closed"
            self._last_change = None
            del self.state_changes[:]

    def begin(self) -> None:
        """A request is about to be forwarded: in half-open this claims
        the single probe slot."""
        if not self._enabled():
            return
        with self._lock:
            if self.state == "half_open":
                self._probe_inflight = True

    def success(self) -> None:
        if not self._enabled():
            return
        with self._lock:
            if self.state == "half_open":
                # the probe proved the replica: full traffic resumes
                # with a clean slate
                self._set_state_locked("closed")
                self._window.clear()
                self._probe_inflight = False
            elif self.state == "closed":
                now = time.time()
                self._window.append((now, True))
                self._prune(now)
        self._publish()

    def trip(self) -> None:
        """OPEN immediately on a connection-level dispatch failure —
        replica death is not a *rate*, it is a fact. ``failure()``
        waits for ``minRequests`` outcomes before it will open, which
        is right for flaky-but-alive replicas and wrong for dead ones:
        inside the healthProbeSeconds throttle window a dead replica
        with a closed breaker kept absorbing one doomed forward per
        dispatch (a race between the probe and the dispatch). The outcome still lands in the window so snapshots
        account for it."""
        if not self._enabled():
            return
        with self._lock:
            now = time.time()
            self._window.append((now, False))
            self._prune(now)
            if self.state in ("closed", "half_open"):
                self._set_state_locked("open")
                self._opened_at = now
                self._probe_inflight = False
                self._window.clear()
        self._publish()

    def failure(self) -> None:
        if not self._enabled():
            return
        with self._lock:
            now = time.time()
            if self.state == "half_open":
                self._set_state_locked("open")
                self._opened_at = now
                self._probe_inflight = False
            elif self.state == "closed":
                self._window.append((now, False))
                self._prune(now)
                total = len(self._window)
                fails = sum(1 for _, ok in self._window if not ok)
                if (total >= self._param(SERVE_BREAKER_MIN_REQUESTS,
                                         int)
                        and fails / total
                        >= self._param(SERVE_BREAKER_FAILURE_RATE,
                                       float)):
                    self._set_state_locked("open")
                    self._opened_at = now
                    self._window.clear()
        self._publish()

    def snapshot(self) -> dict:
        with self._lock:
            total = len(self._window)
            fails = sum(1 for _, ok in self._window if not ok)
            return {
                "state": self.state,
                "window_requests": total,
                "window_failures": fails,
                "state_changes": [
                    {"at": ts, "from": a, "to": b}
                    for ts, a, b in self.state_changes],
            }


class BrownoutController:
    """Fleet-wide load-shedding level derived from dispatch outcomes.

    Every dispatch outcome is noted as ``ok`` / ``shed`` (a 429 from a
    saturated replica) / ``failure`` (replica death). When the windowed
    pressure — (shed + failure) / total — reaches ``brownout.enterRate``
    with at least ``brownout.minEvents`` outcomes, the fleet enters
    level 1: OPTIONAL analysis-heavy work is shed before any query is
    (trace/_sample_root stops sampling new traces, compile/service
    skips pre-warm, io/datasource stops auto-cache promotion). Pressure
    at or below ``brownout.exitRate`` exits; between the two rates the
    level holds (hysteresis). The level is published through
    ``metrics.set_brownout`` so those consumers need no reference to
    the federation."""

    def __init__(self, conf=None):
        self._conf = conf
        self._lock = locks.named_lock("serve.brownout")
        self._window: collections.deque = collections.deque()
        self.level = 0

    def _param(self, entry, cast):
        try:
            return cast(self._conf.get(entry)) if self._conf is not None \
                else cast(entry.default)
        except Exception:
            return cast(entry.default)

    def note(self, kind: str) -> None:
        """Record one dispatch outcome (``ok``/``shed``/``failure``)
        and re-evaluate the level."""
        if not self._param(SERVE_BROWNOUT_ENABLED, bool):
            return
        level = None
        with self._lock:
            now = time.time()
            self._window.append((now, kind))
            horizon = now - self._param(SERVE_BROWNOUT_WINDOW_S, float)
            w = self._window
            while w and w[0][0] < horizon:
                w.popleft()
            total = len(w)
            if total >= self._param(SERVE_BROWNOUT_MIN_EVENTS, int):
                pressure = sum(
                    1 for _, k in w if k != "ok") / total
                if self.level == 0 and pressure >= self._param(
                        SERVE_BROWNOUT_ENTER_RATE, float):
                    self.level = 1
                    level = 1
                elif self.level > 0 and pressure <= self._param(
                        SERVE_BROWNOUT_EXIT_RATE, float):
                    self.level = 0
                    level = 0
        if level is not None:
            metrics.set_brownout(level)
            metrics.record("serve", phase="brownout",
                           level=level)

    def snapshot(self) -> dict:
        with self._lock:
            total = len(self._window)
            bad = sum(1 for _, k in self._window if k != "ok")
            return {"level": self.level, "window_events": total,
                    "window_pressure": (bad / total) if total else 0.0}


class Replica:
    """One backend ConnectServer as the router sees it: URL, last
    probed load, and health."""

    def __init__(self, rid: str, url: str):
        self.id = str(rid)
        self.url = url.rstrip("/")
        self.healthy = True
        self.queue_depth = 0
        self.running = 0
        self.last_probe = 0.0
        self.breaker = CircuitBreaker()

    @property
    def load(self) -> int:
        return int(self.queue_depth) + int(self.running)

    def snapshot(self) -> dict:
        return {"id": self.id, "url": self.url,
                "healthy": self.healthy,
                "queue_depth": self.queue_depth,
                "running": self.running,
                "breaker": self.breaker.snapshot()}


def _as_replica(i: int, r) -> Replica:
    """Accept a ConnectServer, a URL string, or an (id, url) pair."""
    if isinstance(r, Replica):
        return r
    if isinstance(r, str):
        return Replica(f"r{i}", r)
    if isinstance(r, (tuple, list)) and len(r) == 2:
        return Replica(r[0], r[1])
    rid = getattr(r, "replica_id", None) or f"r{i}"
    return Replica(rid, r.url)


class Federation:
    """The replica set + dispatch engine; owned by a FederationRouter
    but usable headless (bench drives it directly)."""

    def __init__(self, replicas: Sequence, conf=None,
                 timeout: float = 120.0):
        self._conf = conf if conf is not None else CF.RuntimeConf()
        self.replicas: List[Replica] = [
            _as_replica(i, r) for i, r in enumerate(replicas)]
        if not self.replicas:
            raise ValueError("federation needs at least one replica")
        self.timeout = float(timeout)
        self._rr = 0
        self._lock = locks.named_lock("serve.federation")
        for r in self.replicas:
            r.breaker._conf = self._conf
            r.breaker.owner = r.id
        self.brownout = BrownoutController(self._conf)
        self.ownership = OwnershipCoordinator(self._conf)

    # -- health ---------------------------------------------------------------

    def probe(self, force: bool = False) -> None:
        """Refresh each replica's /health snapshot; throttled by
        ``spark.tpu.serve.healthProbeSeconds`` unless forced. A probe
        failure marks the replica unhealthy; a later success revives
        it (a restarted replica rejoins without router restart)."""
        try:
            max_age = float(self._conf.get(CF.SERVE_HEALTH_PROBE_SECONDS))
        except Exception:
            max_age = float(CF.SERVE_HEALTH_PROBE_SECONDS.default)
        now = time.time()
        for r in self.replicas:
            if not force and r.last_probe and \
                    now - r.last_probe < max_age:
                continue
            try:
                with urllib.request.urlopen(r.url + "/health",
                                            timeout=2.0) as resp:
                    h = json.loads(resp.read())
                r.healthy = h.get("status") == "ok"
                r.queue_depth = int(h.get("queue_depth", 0))
                r.running = int(h.get("running", 0))
                rid = h.get("replica")
                if rid:
                    r.id = str(rid)
                    r.breaker.owner = r.id
                if r.healthy and self.ownership.enabled():
                    self._fetch_shards(r)
            except Exception:
                r.healthy = False
            r.last_probe = time.time()
        if self.ownership.enabled():
            self._sync_ownership()

    def _fetch_shards(self, r: Replica) -> None:
        """Learn the shard map (table -> scan-fingerprint shard) a
        replica's catalog exposes; best-effort — an older replica
        without /shards just contributes no shards."""
        try:
            with urllib.request.urlopen(r.url + "/shards",
                                        timeout=2.0) as resp:
                payload = json.loads(resp.read())
            self.ownership.register_shards(payload.get("tables", {}))
        except Exception:
            pass

    def _sync_ownership(self) -> None:
        """Re-derive the shard->owner map from current membership; a
        membership change mints a new epoch which is then broadcast so
        replicas can fence stale routers and rebuild gained shards."""
        minted = self.ownership.observe(
            [r.id for r in self.replicas if r.healthy])
        if minted is not None:
            self._broadcast_epoch(minted)

    def _broadcast_epoch(self, payload: dict) -> None:
        """Push a freshly minted epoch + owner map to every healthy
        replica. Strictly best-effort and called OUTSIDE all locks: a
        replica that misses the broadcast (network blip, injected
        ``serve.ownership`` fault) adopts the epoch lazily from the
        next stamped request and rebuilds on first touch — bytes never
        depend on this push landing."""
        body = json.dumps(payload).encode()
        with trace.span("serve.epoch", epoch=payload.get("epoch")):
            for r in self.replicas:
                if not r.healthy:
                    continue
                try:
                    faults.inject("serve.ownership", self._conf)
                    req = urllib.request.Request(
                        r.url + "/epoch", data=body, method="POST",
                        headers={"Content-Type": "application/json"})
                    with urllib.request.urlopen(req, timeout=5.0):
                        pass
                except Exception as e:
                    metrics.record(
                        "fault_recovered", point="serve.ownership",
                        how="lazy_adopt", replica=r.id,
                        error=type(e).__name__)

    def _on_replica_death(self, r: Replica) -> None:
        """A dispatch just proved ``r`` dead: mint a new epoch NOW
        (not at the next throttled probe) so the dead replica's shards
        re-map to survivors and their rebuilds start before the next
        query for those shards arrives."""
        if self.ownership.enabled():
            self._sync_ownership()

    def healthy(self) -> List[Replica]:
        return [r for r in self.replicas if r.healthy]

    def status(self) -> List[dict]:
        return [r.snapshot() for r in self.replicas]

    # -- selection ------------------------------------------------------------

    def pick(self, affinity: Optional[str] = None,
             exclude: Sequence[str] = (),
             least_loaded: bool = False,
             prefer: Optional[str] = None) -> Optional[Replica]:
        """Next replica per policy among healthy, non-excluded ones.
        ``prefer`` (the shard OWNER under the ownership map) wins over
        everything when eligible — owner routing is what makes each
        replica's cache authoritative for its shards. ``affinity``
        (the ``X-SparkTpu-Replica`` header a client echoes back) wins
        next — consistent session routing keeps a client's scheduler
        pool state and compile warmth on one backend. ``least_loaded``
        forces the load-based choice regardless of policy: the shed
        path always moves work to the emptiest queue."""
        pool = [r for r in self.healthy() if r.id not in set(exclude)]
        if not pool:
            return None
        # breaker filtering is advisory: when every candidate's breaker
        # refuses (e.g. the whole fleet just flapped), fall back to the
        # unfiltered pool — an attempt against a maybe-bad replica
        # beats refusing a request the fleet could still serve
        admitted = [r for r in pool if r.breaker.admits()]
        if admitted:
            pool = admitted
        if prefer:
            for r in pool:
                if r.id == prefer:
                    return r
        if affinity:
            for r in pool:
                if r.id == affinity:
                    return r
        try:
            policy = str(self._conf.get(CF.SERVE_POLICY))
        except Exception:
            policy = str(CF.SERVE_POLICY.default)
        if least_loaded or policy == "least_queued":
            return min(pool, key=lambda r: (r.load, r.id))
        with self._lock:
            r = pool[self._rr % len(pool)]
            self._rr += 1
        return r

    # -- dispatch -------------------------------------------------------------

    def forward(self, replica: Replica, method: str, path: str,
                body: Optional[bytes],
                headers: Optional[dict] = None
                ) -> Tuple[int, bytes, Dict[str, str]]:
        """One HTTP round trip to a replica. Returns (code, body,
        relay-headers); 4xx/5xx come back as values (HTTPError bodies
        are real payloads here: 429 carries retry_after_s), connection
        failures raise for the re-dispatch loop."""
        req = urllib.request.Request(
            replica.url + path, data=body, method=method,
            headers=headers or {})
        try:
            with urllib.request.urlopen(req,
                                        timeout=self.timeout) as resp:
                data = resp.read()
                hdr = {k: resp.headers[k] for k in RELAY_HEADERS
                       if resp.headers.get(k)}
                return resp.status, data, hdr
        except urllib.error.HTTPError as e:
            data = e.read()
            hdr = {k: e.headers[k] for k in RELAY_HEADERS
                   if e.headers.get(k)}
            return e.code, data, hdr
        except urllib.error.URLError as e:
            reason = getattr(e, "reason", None)
            if isinstance(reason, _CONN_ERRORS):
                raise reason
            raise

    def dispatch(self, method: str, path: str, body: Optional[bytes],
                 headers: Optional[dict] = None,
                 affinity: Optional[str] = None
                 ) -> Tuple[int, bytes, Dict[str, str]]:
        """Route one request: pick -> forward, shedding 429s to the
        least-loaded remaining replica and re-dispatching around dead
        ones (bounded). The return is what the client sees. One
        ``router.dispatch`` span covers the whole routing decision
        (every shed and re-dispatch attempt stays in the caller's
        trace); each attempt is a ``router.forward`` child whose
        context ships to the replica in ``X-SparkTpu-Trace``."""
        with trace.span("router.dispatch", path=path):
            return self._dispatch_traced(method, path, body,
                                         headers, affinity)

    def _dispatch_traced(self, method: str, path: str,
                         body: Optional[bytes],
                         headers: Optional[dict] = None,
                         affinity: Optional[str] = None
                         ) -> Tuple[int, bytes, Dict[str, str]]:
        try:
            retries = max(0, int(
                self._conf.get(CF.SERVE_DISPATCH_RETRIES)))
        except Exception:
            retries = int(CF.SERVE_DISPATCH_RETRIES.default)
        exhausted: set = set()    # saturated (429) this request
        dead: set = set()         # connection-failed this request
        retry_afters: List[float] = []
        last_err: Optional[BaseException] = None
        shed = False
        slo_reject = None  # last typed 503 (InfeasibleDeadline) seen
        # ownership routing: plan the query to the replica OWNING its
        # scans (rendezvous hash over healthy members) so the fleet
        # behaves as one coherent cache instead of N cold ones
        shards: Tuple[str, ...] = ()
        if self.ownership.enabled() and path in ("/sql", "/plan") \
                and body:
            try:
                q = json.loads(body).get("query", "")
                shards = self.ownership.shards_for_sql(q)
            except Exception:
                shards = ()
        for attempt in range(retries + len(self.replicas) + 1):
            deadline.check("serve.dispatch")
            self.probe()
            # owner is re-derived per attempt: a failover two lines
            # down re-maps the shard, and the retry must follow it
            prefer = self.ownership.owner_for(shards) if shards \
                else None
            r = self.pick(affinity=affinity,
                          exclude=exhausted | dead,
                          least_loaded=shed,
                          prefer=prefer if prefer not in
                          (exhausted | dead) else None)
            affinity = None  # only honored for the first choice
            if r is None:
                break
            r.breaker.begin()
            metrics.note_serve("dispatches")
            metrics.record("serve", phase="dispatch", replica=r.id,
                           path=path)
            try:
                with trace.span("router.forward", replica=r.id):
                    faults.inject("serve.dispatch", self._conf)
                    # rewrite (not passthrough) the trace header: the
                    # replica's spans must parent under THIS forward
                    # attempt, so shed/re-dispatch attempts stay
                    # distinguishable in the waterfall
                    hdrs = dict(headers or {})
                    hv = trace.header_value()
                    if hv:
                        hdrs[trace.TRACE_HEADER] = hv
                    if self.ownership.enabled():
                        # per-ATTEMPT stamp: a failover between
                        # attempts must fence the retry at the new
                        # epoch, not the one the request started with
                        hdrs[EPOCH_HEADER] = str(self.ownership.epoch)
                    code, data, hdr = self.forward(
                        r, method, path, body, hdrs)
            except _CONN_ERRORS as e:
                last_err = e
                # a connection-level failure is a fact, not a rate:
                # trip the breaker open IMMEDIATELY, even inside the
                # healthProbeSeconds throttle window
                r.breaker.trip()
                self.brownout.note("failure")
                r.healthy = False
                dead.add(r.id)
                self._on_replica_death(r)
                if len(dead) > retries:
                    break
                metrics.note_serve("replica_failures")
                metrics.record("serve", phase="replica_down",
                               replica=r.id, error=type(e).__name__)
                if not recovery.retry_allowed("serve.dispatch"):
                    break
                metrics.note_serve("redispatches")
                metrics.record("serve", phase="redispatch",
                               replica=r.id)
                continue
            except faults.InjectedFault as e:
                last_err = e
                if e.kind not in ("transient", "hang"):
                    raise  # corrupt/oom: surface typed, no retry
                # injected replica death mid-query: same recovery as a
                # real connection failure
                r.breaker.trip()
                self.brownout.note("failure")
                r.healthy = False
                dead.add(r.id)
                self._on_replica_death(r)
                if len(dead) > retries:
                    break
                metrics.note_serve("replica_failures")
                metrics.record("serve", phase="replica_down",
                               replica=r.id, error=type(e).__name__)
                if not recovery.retry_allowed("serve.dispatch"):
                    break
                metrics.note_serve("redispatches")
                metrics.record("serve", phase="redispatch",
                               replica=r.id)
                continue
            if code == 409 and self.ownership.enabled():
                # typed EPOCH_RETRY: the replica fenced a stale stamp
                # (it learned of a newer epoch than this router holds,
                # e.g. from a concurrent router). The replica ANSWERED
                # — its breaker records the success — and the request
                # re-dispatches with a fresh stamp under the unified
                # retry budget.
                r.breaker.success()
                new_epoch = 0
                try:
                    detail = json.loads(data)
                    new_epoch = int(hdr.get(EPOCH_HEADER)
                                    or detail.get("epoch") or 0)
                except Exception:
                    pass
                self.ownership.bump_to(new_epoch)
                metrics.note_serve("epoch_retries")
                metrics.record("serve", phase="epoch_retry",
                               replica=r.id, epoch=new_epoch)
                if recovery.retry_allowed("serve.dispatch"):
                    continue
                return code, data, hdr  # budget spent: surface typed
            if code == 503:
                # typed SLO reject (InfeasibleDeadline): the replica's
                # latency model predicts the query cannot finish inside
                # its deadline given THAT replica's backlog. The
                # replica ANSWERED (breaker success), the fleet
                # brownout records a shed, and the request is ABSORBED
                # into a re-dispatch toward the least-loaded other
                # replica while the unified retry budget allows — a
                # different queue is a different prediction. Budget
                # spent (or fleet exhausted), the typed 503 SURFACES
                # with the prediction that condemned it.
                r.breaker.success()
                self.brownout.note("shed")
                exhausted.add(r.id)
                shed = True
                slo_reject = (code, data, hdr)
                metrics.note_serve("slo_rejects")
                metrics.record(
                    "serve", phase="slo_reject", replica=r.id,
                    predicted_ms=hdr.get("X-SparkTpu-Predicted-Ms"))
                if recovery.retry_allowed("serve.dispatch"):
                    continue
                return code, data, hdr  # budget spent: surface typed
            if code == 429:
                # admission shedding: this replica's scheduler is
                # full — take the request to the emptiest other queue.
                # the replica ANSWERED, so its breaker records a
                # success; the fleet-wide brownout records the shed
                r.breaker.success()
                self.brownout.note("shed")
                exhausted.add(r.id)
                try:
                    detail = json.loads(data)
                    ra = float(hdr.get("Retry-After")
                               or detail.get("retry_after_s") or 0.0)
                except Exception:
                    ra = 0.0
                retry_afters.append(ra)
                shed = True
                metrics.note_serve("sheds")
                metrics.record("serve", phase="shed", replica=r.id,
                               retry_after_s=ra)
                continue
            r.breaker.success()
            self.brownout.note("ok")
            return code, data, hdr
        if slo_reject is not None:
            # every candidate replica predicted the deadline
            # infeasible (or the budget ran dry re-dispatching): the
            # typed 503 surfaces with its prediction — more
            # actionable than a synthesized 429, and never retried
            # by the client on the same deadline
            metrics.note_serve("rejected")
            metrics.record("serve", phase="slo_reject_surfaced")
            return slo_reject
        if retry_afters:
            # ALL healthy replicas saturated: now (and only now) the
            # client sees the 429; Retry-After is the soonest any
            # replica expects capacity
            ra = min(retry_afters)
            metrics.note_serve("rejected")
            metrics.record("serve", phase="rejected",
                           retry_after_s=ra)
            body_out = json.dumps(
                {"error": "SchedulerQueueFull",
                 "message": "all replicas saturated",
                 "retry_after_s": ra}).encode()
            return 429, body_out, {"Retry-After": f"{ra:g}"}
        if last_err is not None:
            raise NoHealthyReplica(
                f"dispatch failed after replica failures "
                f"(last: {last_err!r})") from last_err
        raise NoHealthyReplica("no healthy replica available")
