"""Plan-keyed Arrow result cache with single-flight execution (the port of
``spark_tpu/serve/result_cache.py``).

The serving-economics argument (Flare, arxiv 1703.08219): once
per-query compute is native-fast, the dominant serving costs are
dispatch and redundant re-execution of identical dashboard-style
queries. This cache removes the second cost: results are keyed by the
same structural plan key that measured admission uses
(plan/logical.structural_key), folded with the scan-source mtime/size
fingerprint io/datasource.py already computes — so a
rewritten source file misses naturally and the stale entry ages out
LRU, exactly like the datasource's own batch cache.

Values are the Arrow-IPC-serialized result stream of the port's
``DataFrame.toArrow()``, the byte string the connect server would have
produced anyway: a hit returns the bytes an uncached execution
serializes, so the on/off sweep is byte-identical by construction.

Single-flight: a thundering herd of identical queries (8 clients
refreshing the same dashboard) costs ONE device execution — the first
arrival owns the execution, the rest block on its flight and read the
serialized result. Reference shape: CacheManager._materialize's
per-entry lock (api/session.py); the reference system's analogue is
the BlockManager's ``doPutIterator`` single-writer semantics.
"""

from __future__ import annotations

import hashlib
import io
import threading
import time
from typing import Any, Callable, Optional, Tuple

import pyarrow as pa

from spark_tpu_torch import locks
from spark_tpu_torch import conf as CF
from spark_tpu_torch import deadline, faults, metrics, trace
from spark_tpu_torch.storage.lru import LruDict

SERVE_FP_CACHE_SECONDS = CF.register(
    "spark.tpu.serve.fingerprintCacheSeconds", 0.0,
    "TTL on a replica's per-source freshness-fingerprint probe (the "
    "stat walk behind the result-cache key). 0 (default) stats on "
    "every request — always fresh, but a stat storm under fleet "
    "traffic. > 0 amortizes the probe and OPENS a stale-serve window "
    "exactly as wide as the TTL; the fleet invalidation log closes it "
    "by dropping entries (and the cached probe) the moment a refresh "
    "or rewrite commits.", float)

#: follower wait bound per round: the owner always sets the flight
#: event in a ``finally``, so this only guards against an owner thread
#: killed by interpreter shutdown or wedged on the device; on expiry a
#: typed FlightWaitTimeout is recorded and the follower falls through
#: to its own execution instead of waiting forever.
_FLIGHT_WAIT_S = 600.0


class FlightWaitTimeout(RuntimeError):
    """A single-flight follower waited the full bound without the
    owner publishing a result or an error. Surfaced in the event log
    (serve_cache phase=wait_timeout) before the follower executes the
    query itself."""

    def __init__(self, key_digest_: str, waited_s: float):
        super().__init__(
            f"single-flight wait for {key_digest_} timed out after "
            f"{waited_s:g}s; executing independently")
        self.key_digest = key_digest_
        self.waited_s = float(waited_s)


def scan_fingerprints(plan) -> Tuple[Any, ...]:
    """Freshness token over every scan source in ``plan``: the
    (path, mtime_ns, size) fingerprint FileSource computes for its own
    cache invalidation — the same walk (io/fingerprint.py), so this
    cache and the datasource's caches can never disagree about
    staleness. Sources without one
    (in-memory Relations) key by object identity, which structural_key
    already does."""
    from spark_tpu_torch.io.fingerprint import plan_fingerprints

    return plan_fingerprints(plan)


def plan_result_key(plan) -> Tuple[Any, ...]:
    """Cache key: injective structural plan identity + per-source
    freshness. Process-local (structural_key embeds source object
    identity) — each replica process keys its own cache, which is the
    correct scope because fingerprints are local filesystem stats."""
    return (plan.structural_key(), scan_fingerprints(plan))


def key_digest(key: Tuple[Any, ...]) -> str:
    """Short stable digest of a cache key for event-log correlation
    (the full structural key is huge and unreadable in JSON)."""
    return hashlib.sha1(repr(key).encode()).hexdigest()[:12]


def table_to_ipc(tbl: pa.Table) -> bytes:
    sink = io.BytesIO()
    with pa.ipc.new_stream(sink, tbl.schema) as w:
        w.write_table(tbl)
    return sink.getvalue()


def ipc_to_table(blob: bytes) -> pa.Table:
    return pa.ipc.open_stream(io.BytesIO(blob)).read_all()


class _Flight:
    """One in-flight execution: followers wait on the event and read
    either the serialized result or the owner's exception."""

    __slots__ = ("event", "blob", "error")

    def __init__(self):
        self.event = threading.Event()
        self.blob: Optional[bytes] = None
        self.error: Optional[BaseException] = None


class ResultCache:
    """Byte-bounded (``spark.tpu.serve.resultCache.maxBytes``, read
    live) LRU of Arrow-IPC result streams with single-flight execution
    per key. Shared across in-process replicas via the session
    (connect/server.py attaches one per session), so the herd
    guarantee holds even when the router spreads identical queries
    over several replicas."""

    def __init__(self, conf):
        self._conf = conf
        self._lru = LruDict(
            "serve_results",
            cap=4096,
            max_bytes_entry=CF.SERVE_RESULT_CACHE_MAX_BYTES,
            weigher=len,
            conf=conf)
        self._flights: dict = {}
        self._lock = locks.named_lock("serve.result_cache")
        #: TTL'd per-source fingerprint probes: {paths tuple ->
        #: (fingerprint, stamp)} — populated only when
        #: spark.tpu.serve.fingerprintCacheSeconds > 0
        self._fp_cache: dict = {}
        #: last invalidation-log version applied (watermark replay on
        #: reattach)
        self.invalidation_watermark = 0
        self._inval_log = None

    def enabled(self) -> bool:
        try:
            return bool(self._conf.get(CF.SERVE_RESULT_CACHE_ENABLED))
        except Exception:
            return False

    def _max_bytes(self) -> int:
        try:
            return int(self._conf.get(CF.SERVE_RESULT_CACHE_MAX_BYTES))
        except Exception:
            return int(CF.SERVE_RESULT_CACHE_MAX_BYTES.default)

    def _publish_gauges(self) -> None:
        metrics.set_gauge("serve.result_cache.entries", len(self._lru))
        metrics.set_gauge("serve.result_cache.bytes",
                          self._lru.total_bytes)

    def get_or_execute(self, key, execute: Callable[[], pa.Table]
                       ) -> Tuple[bytes, str]:
        """Return ``(arrow_ipc_bytes, status)`` for ``key``; status is
        ``hit`` (served from cache), ``miss`` (this call owned the
        device execution) or ``wait`` (piggybacked on a concurrent
        execution of the same key). ``execute()`` runs AT MOST once
        across all concurrent callers with the same key."""
        kd = key_digest(key)
        while True:
            blob = self._lru.get(key)
            if blob is not None:
                metrics.note_serve("hits")
                metrics.record("serve_cache", phase="hit", key=kd,
                               bytes=len(blob))
                return blob, "hit"
            with self._lock:
                fl = self._flights.get(key)
                owner = fl is None
                if owner:
                    fl = self._flights[key] = _Flight()
            if owner:
                try:
                    t0 = time.perf_counter()
                    tbl = execute()
                    blob = table_to_ipc(tbl)
                    fl.blob = blob
                    self.put(key, blob)
                except BaseException as e:
                    if self._herd_error(e):
                        fl.error = e
                    raise
                finally:
                    fl.event.set()
                    with self._lock:
                        self._flights.pop(key, None)
                metrics.note_serve("misses")
                metrics.record(
                    "serve_cache", phase="execute", key=kd,
                    bytes=len(blob),
                    ms=round((time.perf_counter() - t0) * 1e3, 2))
                metrics.record("serve_cache", phase="miss", key=kd,
                               bytes=len(blob))
                return blob, "miss"
            # follower: block on the owner's flight — never past this
            # caller's own deadline (the owner keeps computing for ITS
            # caller; this follower's window closing is follower-local)
            deadline.check("result_cache.wait")
            metrics.note_serve("waits")
            t0 = time.perf_counter()
            wait_s = _FLIGHT_WAIT_S
            rem = deadline.remaining()
            if rem is not None:
                wait_s = max(0.0, min(wait_s, rem))
            if not fl.event.wait(timeout=wait_s):
                deadline.check("result_cache.wait")
                # the owner exceeded the flight bound without
                # publishing a result or an error: surface the typed
                # timeout and execute independently rather than wait
                # on a wedged owner forever
                tmo = FlightWaitTimeout(kd, time.perf_counter() - t0)
                metrics.note_serve("wait_timeouts")
                metrics.record("serve_cache", phase="wait_timeout",
                               key=kd, error=repr(tmo))
                tbl = execute()
                blob = table_to_ipc(tbl)
                self.put(key, blob)
                return blob, "timeout"
            if fl.error is not None:
                # the owner's failure is this caller's failure too —
                # a SchedulerQueueFull here propagates so the router
                # can shed the whole herd to another replica
                raise fl.error
            if fl.blob is not None:
                metrics.record("serve_cache", phase="wait", key=kd,
                               bytes=len(fl.blob))
                return fl.blob, "wait"
            # owner finished without result or herd-relevant error
            # (owner-local cancellation, interpreter teardown): loop
            # and take ownership

    @staticmethod
    def _herd_error(e: BaseException) -> bool:
        """Owner failures that apply to every follower of the flight.
        Owner-LOCAL outcomes must not fan out: the owner's
        cancellation/deadline belongs to its own caller, not the herd,
        and BaseExceptions (KeyboardInterrupt, SystemExit) are
        interpreter-level. Followers of a non-herd failure find neither
        blob nor error and loop to take ownership themselves."""
        from spark_tpu_torch.scheduler.scheduler import QueryCancelled

        return (isinstance(e, Exception)
                and not isinstance(e, QueryCancelled))

    def put(self, key, blob: bytes) -> None:
        """Insert one serialized result; an oversized single result is
        served but never cached (it would evict the whole cache for
        one entry)."""
        if len(blob) <= self._max_bytes():
            self._lru[key] = blob
        self._publish_gauges()

    def lookup(self, key) -> Optional[bytes]:
        return self._lru.get(key)

    def clear(self) -> None:
        self._lru.clear()
        with self._lock:
            self._fp_cache.clear()
        self._publish_gauges()

    # -- fingerprint probe cache ----------------------------------------------

    def _fp_ttl(self) -> float:
        try:
            return float(self._conf.get(SERVE_FP_CACHE_SECONDS))
        except Exception:
            return float(SERVE_FP_CACHE_SECONDS.default)

    def result_key(self, plan) -> Tuple[Any, ...]:
        """Cache key for ``plan`` through THIS cache's fingerprint
        probe: with fingerprintCacheSeconds <= 0 this is exactly
        ``plan_result_key`` (a fresh stat walk per request); with a
        TTL, per-source probes are reused until they expire or an
        invalidation-log record drops them."""
        ttl = self._fp_ttl()
        if ttl <= 0.0:
            return plan_result_key(plan)
        from spark_tpu_torch.io.fingerprint import source_fingerprint
        from spark_tpu_torch.plan import logical as L

        now = time.time()
        fps = []
        for scan in L.collect_nodes(plan, L.UnresolvedScan):
            src = scan.source
            paths = getattr(src, "paths", None)
            if not paths:
                fp = source_fingerprint(src)
                fps.append(fp if fp is not None
                           else ("src", id(src)))
                continue
            pkey = tuple(str(p) for p in paths)
            with self._lock:
                hit = self._fp_cache.get(pkey)
            if hit is not None and now - hit[1] < ttl:
                fps.append(hit[0])
                continue
            fp = source_fingerprint(src)
            if fp is None:
                fps.append(("src", id(src)))
                continue
            with self._lock:
                self._fp_cache[pkey] = (fp, now)
            fps.append(fp)
        return (plan.structural_key(), tuple(fps))

    # -- fleet-wide invalidation ----------------------------------------------

    def attach_invalidation_log(self, log) -> "ResultCache":
        """Subscribe to a fleet InvalidationLog, first replaying every
        record after this cache's watermark (a reconnecting/revived
        replica catches up); a watermark older than the log's bounded
        ring forces the planned worst case — a full clear (cold,
        never stale)."""
        records, resync = log.since(self.invalidation_watermark)
        if resync:
            self.clear()
            self.invalidation_watermark = log.version
            metrics.record("serve", phase="invalidate_resync",
                           watermark=self.invalidation_watermark)
        else:
            for record in records:
                self.apply_invalidation(record)
        log.subscribe(self.apply_invalidation)
        self._inval_log = log
        return self

    def detach_invalidation_log(self) -> None:
        if self._inval_log is not None:
            self._inval_log.unsubscribe(self.apply_invalidation)
            self._inval_log = None

    def apply_invalidation(self, record: dict) -> None:
        """Drop every cached result (and fingerprint probe) whose key
        touches the record's paths. Any failure — including an
        injected ``serve.invalidate`` fault — degrades to a FULL
        clear: after an invalidation the one state this cache may not
        hold is a stale entry, and empty is always sound."""
        with trace.span("serve.invalidate",
                        version=record.get("v", 0)):
            try:
                faults.inject("serve.invalidate", self._conf)
                dropped = self._drop_paths(record.get("paths", ()))
                metrics.record("serve", phase="invalidate_apply",
                               version=record.get("v", 0),
                               dropped=dropped)
            except Exception as exc:
                self.clear()
                metrics.record(
                    "fault_recovered", point="serve.invalidate",
                    how="full_clear", error=type(exc).__name__)
            self.invalidation_watermark = max(
                self.invalidation_watermark, int(record.get("v", 0)))
        self._publish_gauges()

    @staticmethod
    def _touches(path: str, targets) -> bool:
        """Does file ``path`` equal, live under, or contain one of the
        invalidated ``targets``? (Fingerprints hold walked FILE paths;
        invalidation records may carry the source DIRECTORY.)"""
        import os as _os

        for t in targets:
            if path == t or path.startswith(t.rstrip(_os.sep)
                                            + _os.sep) \
                    or t.startswith(path.rstrip(_os.sep) + _os.sep):
                return True
        return False

    def _drop_paths(self, paths) -> int:
        targets = tuple(str(p) for p in paths)
        if not targets:
            return 0
        dropped = 0
        for key in self._lru.keys():
            fps = key[1] if isinstance(key, tuple) and len(key) == 2 \
                else ()
            hit = False
            for fp in fps if isinstance(fps, tuple) else ():
                if not isinstance(fp, tuple):
                    continue
                for triple in fp:
                    if isinstance(triple, tuple) and triple \
                            and isinstance(triple[0], str) \
                            and self._touches(triple[0], targets):
                        hit = True
                        break
                if hit:
                    break
            if hit and self._lru.pop(key) is not None:
                dropped += 1
        with self._lock:
            for pkey in list(self._fp_cache):
                if any(self._touches(str(p), targets) for p in pkey):
                    del self._fp_cache[pkey]
        return dropped

    def stats(self) -> dict:
        counters = metrics.serve_stats()
        return {
            "entries": len(self._lru),
            "bytes": self._lru.total_bytes,
            "max_bytes": self._max_bytes(),
            "evictions": self._lru.evictions,
            "hits": counters.get("hits", 0),
            "misses": counters.get("misses", 0),
            "waits": counters.get("waits", 0),
        }
