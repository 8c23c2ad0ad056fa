"""Epoch-fenced shard ownership + the fleet-wide invalidation log (the port
of ``spark_tpu/serve/ownership.py``).

The fleet data plane's control state, promoted from the
coordination-service rendezvous idea in ``parallel/multihost.py`` to a
serving-tier deployment mode. Two pieces:

**Shard ownership.** A *shard* is the stable identity of one scan's
file set — a digest of its sorted path list, NOT the mtime-bearing
stat fingerprint, so ownership survives appends and only a genuine
re-pointing of a table moves its shard. The ``OwnershipCoordinator``
(router-side) maintains an **epoch-numbered shard→owner map** over the
currently healthy replicas using rendezvous (highest-random-weight)
hashing: ``owner(shard) = argmax_r H(shard | r)``, which is memoryless
— when one replica dies, ONLY its shards move (to their next-highest
survivor), everyone else's assignment is untouched. Every membership
change (breaker trip, death noticed by a probe, revival) **mints a new
epoch**; the router stamps the current epoch on every dispatched
request (``X-SparkTpu-Epoch``) and broadcasts the new map to the
survivors, whose newly-gained shards are rebuilt from source files —
the lineage-recompute analogue. A replica that receives a request
carrying an epoch OLDER than the fleet epoch it has adopted answers a
typed ``EPOCH_RETRY`` (HTTP 409) instead of serving possibly-stale
ownership state; the router (and the connect ``Client``) absorb it
through the unified RetryBudget and re-dispatch with a fresh stamp.

**Invalidation log.** Cache coherence across replica-local
ResultCaches: materialized-view refresh commits and file-rewrite
detections append versioned records here; the log pushes each record
to every subscribed cache (outside its own lock), which drops every
entry whose fingerprint touches the invalidated paths. A reconnecting
subscriber replays ``since(watermark)``; a watermark older than the
bounded ring forces a full resync (clear) — the planned, bounded
worst case: a cold cache, never a stale one.

Reference analogue: the BlockManagerMaster's epoch-stamped executor
re-registration + ``removeExecutor`` re-replication, and the
driver-side ``CacheManager`` invalidation broadcast.
"""

from __future__ import annotations

import collections
import hashlib
import re
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from spark_tpu_torch import locks
from spark_tpu_torch import conf as CF
from spark_tpu_torch import metrics

SERVE_OWNERSHIP_ENABLED = CF.register(
    "spark.tpu.serve.ownership.enabled", False,
    "Fleet ownership mode: the router plans each query to the replica "
    "owning its scans (rendezvous hashing over healthy replicas), "
    "stamps every dispatch with the ownership epoch, and replicas "
    "fence stale epochs with a typed EPOCH_RETRY. Off (default) the "
    "router routes purely by policy/affinity.", bool)

SERVE_OWNERSHIP_REBUILD = CF.register(
    "spark.tpu.serve.ownership.rebuildOnFailover", True,
    "After an epoch mint re-maps a dead replica's shards, the new "
    "owners eagerly re-discover their gained shards from source files "
    "(dataset + schema warm). Off, rebuild happens lazily on the "
    "first owned query — bytes are identical either way.", bool)

SERVE_OWNERSHIP_REBUILD_TIMEOUT_S = CF.register(
    "spark.tpu.serve.ownership.rebuildTimeoutSeconds", 30.0,
    "Deadline cap on one replica's failover rebuild of newly-gained "
    "shards; on expiry the remaining shards rebuild lazily on first "
    "query (never a hang, never a wrong byte).", float)

SERVE_INVALIDATION_LOG_MAX = CF.register(
    "spark.tpu.serve.invalidationLog.maxRecords", 1024,
    "Bounded ring of invalidation records kept for watermark replay; "
    "a subscriber whose watermark predates the ring resyncs with a "
    "full cache clear (cold, never stale).", int)

#: request/response header carrying the ownership epoch fleet-wide
EPOCH_HEADER = "X-SparkTpu-Epoch"


class EpochRetry(RuntimeError):
    """A request arrived stamped with an epoch OLDER than the fleet
    epoch this replica has adopted: the sender's shard→owner map is
    stale (it may be routing to a dead owner's replacement — or past
    it). Typed and retryable: the unified RetryBudget absorbs it and
    the re-dispatch carries a fresh stamp."""

    def __init__(self, request_epoch: int, fleet_epoch: int):
        super().__init__(
            f"EPOCH_RETRY: request epoch {request_epoch} < fleet "
            f"epoch {fleet_epoch}; re-dispatch with a fresh stamp")
        self.request_epoch = int(request_epoch)
        self.fleet_epoch = int(fleet_epoch)


# --------------------------------------------------------------------------
# shard identity + rendezvous hashing
# --------------------------------------------------------------------------


def shard_key(paths: Sequence[str]) -> str:
    """Stable identity of one scan's file set: a digest of the SORTED
    path list. Deliberately mtime/size-free — appends and rewrites
    change the freshness fingerprint, not the shard, so ownership
    never migrates on a refresh."""
    joined = "\x00".join(sorted({str(p) for p in paths}))
    return hashlib.sha1(joined.encode()).hexdigest()[:16]


def rendezvous_owner(shard: str,
                     members: Sequence[str]) -> Optional[str]:
    """Highest-random-weight owner of ``shard`` among ``members``.
    sha512-based (PYTHONHASHSEED-independent, stable across processes)
    and memoryless: removing one member moves only that member's
    shards."""
    if not members:
        return None
    return max(
        sorted(set(str(m) for m in members)),
        key=lambda rid: hashlib.sha512(
            f"{shard}|{rid}".encode()).digest())


_TABLE_RE = re.compile(
    r"\b(?:from|join)\s+([A-Za-z_][A-Za-z0-9_.]*)", re.IGNORECASE)


def tables_in_sql(sql: str) -> List[str]:
    """Conservative table-identifier extraction from a SQL string
    (FROM/JOIN targets). Subqueries contribute their inner FROMs too —
    over-collection is harmless, the coordinator drops unknown names."""
    return [m.lower() for m in _TABLE_RE.findall(sql or "")]


class OwnershipCoordinator:
    """Router-side epoch-numbered shard→owner map.

    ``observe(healthy_ids)`` mints a new epoch whenever the healthy
    membership changes (including the first observation), returning
    the broadcast payload; unchanged membership returns None. The
    owner function itself is pure rendezvous hashing over the member
    snapshot, so the map never needs repair — only the epoch number
    and the member set are state."""

    def __init__(self, conf=None):
        self._conf = conf
        self._lock = locks.named_lock("serve.ownership")
        self.epoch = 0
        self._members: Tuple[str, ...] = ()
        #: shard -> path list (learned from replicas' GET /shards)
        self._shards: Dict[str, Tuple[str, ...]] = {}
        #: table name (lower) -> shard
        self._tables: Dict[str, str] = {}

    def enabled(self) -> bool:
        try:
            return bool(self._conf.get(SERVE_OWNERSHIP_ENABLED)) \
                if self._conf is not None \
                else bool(SERVE_OWNERSHIP_ENABLED.default)
        except Exception:
            return False

    # -- shard universe -----------------------------------------------------

    def register_shards(self, tables: Dict[str, dict]) -> None:
        """Merge one replica's shard report: ``{table: {"shard": key,
        "paths": [...]}}`` (replicas over one catalog agree; the merge
        is idempotent)."""
        with self._lock:
            for name, info in (tables or {}).items():
                sk = str(info.get("shard", ""))
                if not sk:
                    continue
                self._tables[str(name).lower()] = sk
                self._shards[sk] = tuple(info.get("paths", ()))

    def shards_for_sql(self, sql: str) -> List[str]:
        """Shard keys a SQL query's scans live in (known tables only)."""
        with self._lock:
            tables = dict(self._tables)
        out = []
        for name in tables_in_sql(sql):
            sk = tables.get(name)
            if sk is not None and sk not in out:
                out.append(sk)
        return out

    # -- epoch / membership --------------------------------------------------

    def observe(self, healthy_ids: Iterable[str]) -> Optional[dict]:
        """Note the current healthy membership; mint epoch+1 when it
        changed (or on the first observation) and return the broadcast
        payload {"epoch", "owners", "shards"} — None when nothing
        moved. Metrics are emitted outside the lock."""
        ids = tuple(sorted(set(str(i) for i in healthy_ids)))
        if not ids:
            return None  # a fully-dead fleet has nobody to own shards
        with self._lock:
            if ids == self._members and self.epoch > 0:
                return None
            prev = self._members
            self._members = ids
            self.epoch += 1
            epoch = self.epoch
            owners = {s: rendezvous_owner(s, ids)
                      for s in self._shards}
            shards = {s: list(p) for s, p in self._shards.items()}
        metrics.note_serve("epoch_mints")
        metrics.record("serve", phase="epoch_mint", epoch=epoch,
                       members=list(ids), was=list(prev),
                       shards=len(owners))
        return {"epoch": epoch, "owners": owners, "shards": shards}

    def bump_to(self, epoch: int) -> None:
        """Adopt a newer epoch learned from a replica's EPOCH_RETRY —
        monotonic, never backwards (a second router, or a replica that
        outlived this router's state)."""
        with self._lock:
            if int(epoch) > self.epoch:
                self.epoch = int(epoch)

    def owner_for(self, shards: Sequence[str]) -> Optional[str]:
        """Preferred replica for a query touching ``shards``: the
        rendezvous owner of the first shard (single-table queries are
        the common case; a join's probe side follows its build side)."""
        with self._lock:
            members = self._members
        for s in shards:
            return rendezvous_owner(s, members)
        return None

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "enabled": self.enabled(),
                "epoch": self.epoch,
                "members": list(self._members),
                "shards": {
                    s: rendezvous_owner(s, self._members)
                    for s in self._shards},
                "tables": dict(self._tables),
            }


# --------------------------------------------------------------------------
# catalog -> shard report (replica side of GET /shards)
# --------------------------------------------------------------------------


def catalog_shards(session) -> Dict[str, dict]:
    """``{table: {"shard": key, "paths": [...]}}`` for every catalog
    view backed by exactly one file-fingerprinted scan — the replica's
    shard report. Views over in-memory relations or multiple scans
    have no stable file identity and are routed by policy instead."""
    from spark_tpu_torch.plan import logical as L

    out: Dict[str, dict] = {}
    views = getattr(getattr(session, "catalog", None), "_views", None)
    if not views:
        return out
    for name, plan in list(views.items()):
        try:
            scans = L.collect_nodes(plan, L.UnresolvedScan)
            if len(scans) != 1:
                continue
            src = scans[0].source
            paths = getattr(src, "paths", None)
            if not paths or not callable(
                    getattr(src, "_fingerprint", None)):
                continue
            out[str(name).lower()] = {
                "shard": shard_key(paths),
                "paths": [str(p) for p in paths]}
        except Exception:
            continue  # one odd view must not break the report
    return out


# --------------------------------------------------------------------------
# fleet-wide invalidation log
# --------------------------------------------------------------------------


class InvalidationLog:
    """Versioned, bounded log of cache-invalidation records with live
    push and watermark replay.

    ``append`` assigns the next version and pushes the record to every
    subscriber OUTSIDE the log lock (subscribers take their own cache
    locks). ``since(watermark)`` returns the records a reconnecting
    subscriber missed, or ``resync=True`` when the watermark predates
    the bounded ring — the subscriber must clear instead (cold, never
    stale)."""

    def __init__(self, conf=None):
        self._conf = conf
        self._lock = locks.named_lock("serve.invalidation")
        self._records: collections.deque = collections.deque()
        self._version = 0
        #: version of the OLDEST record still in the ring (0 = nothing
        #: has ever been trimmed)
        self._trimmed_through = 0
        self._subs: List = []

    def _max_records(self) -> int:
        try:
            return max(1, int(
                self._conf.get(SERVE_INVALIDATION_LOG_MAX))) \
                if self._conf is not None \
                else int(SERVE_INVALIDATION_LOG_MAX.default)
        except Exception:
            return int(SERVE_INVALIDATION_LOG_MAX.default)

    def append(self, kind: str, paths: Sequence[str],
               digest: Optional[str] = None) -> int:
        """Record one invalidation (``mview_refresh`` /
        ``source_changed``) over ``paths`` and push it to every
        subscriber; returns the assigned version."""
        with self._lock:
            self._version += 1
            record = {"v": self._version, "kind": str(kind),
                      "paths": tuple(str(p) for p in paths),
                      "digest": digest, "ts": time.time()}
            self._records.append(record)
            cap = self._max_records()
            while len(self._records) > cap:
                dropped = self._records.popleft()
                self._trimmed_through = dropped["v"]
            subs = list(self._subs)
        metrics.note_serve("invalidations")
        metrics.record("serve", phase="invalidate", event=str(kind),
                       version=record["v"], paths=len(record["paths"]))
        for cb in subs:  # outside the log lock: callbacks lock caches
            try:
                cb(record)
            except Exception as exc:
                # a broken subscriber must not lose the record for the
                # others; its own apply path degrades to a full clear
                metrics.record("serve", phase="invalidate_push_error",
                               error=type(exc).__name__)
        return record["v"]

    def subscribe(self, cb) -> None:
        with self._lock:
            if cb not in self._subs:
                self._subs.append(cb)

    def unsubscribe(self, cb) -> None:
        with self._lock:
            if cb in self._subs:
                self._subs.remove(cb)

    def since(self, watermark: int) -> Tuple[List[dict], bool]:
        """(records after ``watermark``, needs_resync). Resync when the
        watermark predates the ring's oldest retained record."""
        with self._lock:
            if int(watermark) < self._trimmed_through:
                return [], True
            return [dict(r) for r in self._records
                    if r["v"] > int(watermark)], False

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    def snapshot(self) -> dict:
        with self._lock:
            return {"version": self._version,
                    "records": len(self._records),
                    "trimmed_through": self._trimmed_through,
                    "subscribers": len(self._subs)}


def session_invalidation_log(session) -> InvalidationLog:
    """The one InvalidationLog of a session (created on first use);
    mview refreshes, file-rewrite detections, and every fleet-mode
    ResultCache share it."""
    log = getattr(session, "serve_invalidation_log", None)
    if log is None:
        log = InvalidationLog(session.conf)
        session.serve_invalidation_log = log
    return log
