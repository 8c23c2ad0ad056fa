"""The device-resident columnar store (the port of
``spark_tpu/storage/store.py``; reference: InMemoryRelation.scala
CachedBatch and storage/memory/MemoryStore.scala:93).

Entries are materialized device ``Batch``es keyed by a plan's or scan's
structural key, byte-accounted against the unified budget
(``unified.py``) and evicted least recently used first when storage or
execution needs the room.

Pinning: a query that reads an entry pins it while it runs
(``pin_scope`` wraps ``DataFrame._execute``); a pinned entry is never
evicted. Eviction drops the store's reference only: the tensors are
freed when the last reader drops its own.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from collections import OrderedDict
from typing import Any, Dict, Iterator, List, Optional

#: per-execution list of (store, key) pins, released when the query's
#: pin_scope exits; None outside any scope (a get then does not pin)
_PINS: contextvars.ContextVar[Optional[list]] = contextvars.ContextVar(
    "spark_tpu_torch_storage_pins", default=None)


@contextlib.contextmanager
def pin_scope() -> Iterator[None]:
    """Pin every entry read inside the block until it exits: one scope
    per query execution. Reentrant: an inner scope (a cached plan's
    materialization running a sub-query) folds into the outer one."""
    if _PINS.get() is not None:
        yield
        return
    token = _PINS.set([])
    try:
        yield
    finally:
        pins = _PINS.get()
        _PINS.reset(token)
        for store, key in pins or ():
            store.unpin(key)


class StoreEntry:
    __slots__ = ("key", "batch", "nbytes", "pins", "hits", "created_t",
                 "last_access_t")

    def __init__(self, key, batch, nbytes: int):
        self.key = key
        self.batch = batch
        self.nbytes = int(nbytes)
        self.pins = 0
        self.hits = 0
        self.created_t = time.time()
        self.last_access_t = self.created_t


def batch_nbytes(batch) -> int:
    """Device bytes of a store candidate: the bytes of its torch tensors
    (values, validities and row mask; ``Batch.device_nbytes``)."""
    return int(batch.device_nbytes())


class MemoryStore:
    """Byte-accounted LRU cache of device batches, sharing its lock and
    byte budget with the UnifiedMemoryManager it registers on."""

    def __init__(self, manager):
        self._m = manager
        self._lock = manager.lock
        self._entries: "OrderedDict[Any, StoreEntry]" = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.hit_bytes = 0
        self.evicted_bytes = 0
        self.put_bytes = 0
        self.rejected_puts = 0
        #: keys ever stored: a miss on one is a recompute after eviction
        self._known: set = set()
        self.recomputes = 0
        manager.attach_store(self)

    # -- accounting (the manager reads these under the shared lock) -----------

    def bytes_used(self) -> int:
        return self._bytes

    def unpinned_bytes(self) -> int:
        return sum(e.nbytes for e in self._entries.values() if e.pins == 0)

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._entries

    # -- the cache ------------------------------------------------------------

    def get(self, key, pin: bool = False):
        """The cached batch or None. ``pin=True`` holds the entry against
        eviction until the enclosing ``pin_scope`` exits (no-op outside
        a scope)."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                self.misses += 1
                if key in self._known:
                    self.recomputes += 1
                return None
            self._entries.move_to_end(key)
            e.hits += 1
            e.last_access_t = time.time()
            self.hits += 1
            self.hit_bytes += e.nbytes
            if pin:
                self._pin_locked(key, e)
            return e.batch

    def put(self, key, batch, pin: bool = False) -> bool:
        """Insert a materialized batch; False when it cannot fit under the
        unified budget even after evicting the store's own LRU tail (the
        caller keeps its batch; the entry stays recomputable)."""
        nbytes = batch_nbytes(batch)
        with self._lock:
            e = self._entries.get(key)
            if e is not None:
                self._entries.move_to_end(key)
                if pin:
                    self._pin_locked(key, e)
                return True
            if not self._m.reserve_storage(nbytes):
                self.rejected_puts += 1
                return False
            e = StoreEntry(key, batch, nbytes)
            self._entries[key] = e
            self._bytes += nbytes
            self._known.add(key)
            self.put_bytes += nbytes
            if pin:
                self._pin_locked(key, e)
            return True

    def update(self, key, batch, pin: bool = False) -> bool:
        """Replace an entry's batch in place, accounting the byte delta
        under the unified budget: a materialized view's refresh keeps
        its key, pins and LRU place. Growth must fit like any storage
        reservation; where it cannot, the stale entry is dropped (stale
        bytes are worse than a recompute) and False returned, the
        ``put`` rejection contract. An absent key falls through to
        ``put``."""
        nbytes = batch_nbytes(batch)
        with self._lock:
            e = self._entries.get(key)
            if e is not None:
                delta = nbytes - e.nbytes
                if delta > 0:
                    # hold the entry against the eviction pass the
                    # reservation may run (evicting the entry being
                    # updated would break the accounting below)
                    e.pins += 1
                    try:
                        ok = self._m.reserve_storage(delta)
                    finally:
                        e.pins -= 1
                    if not ok:
                        self._entries.pop(key)
                        self._bytes -= e.nbytes
                        self.rejected_puts += 1
                        return False
                e.batch = batch
                e.nbytes = nbytes
                self._bytes += delta
                self.put_bytes += max(0, delta)
                e.last_access_t = time.time()
                self._entries.move_to_end(key)
                if pin:
                    self._pin_locked(key, e)
                return True
        return self.put(key, batch, pin=pin)

    def remove(self, key) -> int:
        """Drop an entry wherever it stands (uncache); the bytes
        released. A pinned entry leaves the table too: its reader keeps
        its reference."""
        with self._lock:
            e = self._entries.pop(key, None)
            if e is None:
                return 0
            self._bytes -= e.nbytes
            return e.nbytes

    def unpin(self, key) -> None:
        with self._lock:
            e = self._entries.get(key)
            if e is not None and e.pins > 0:
                e.pins -= 1

    def clear(self) -> int:
        with self._lock:
            freed = self._bytes
            self._entries.clear()
            self._bytes = 0
            return freed

    # -- eviction (the manager calls this under the shared lock) --------------

    def _evict_locked(self, want_bytes: int, floor: int,
                      reason: str) -> int:
        """Evict unpinned entries, least recently used first, until
        ``want_bytes`` are freed or the store holds ``floor`` bytes; the
        bytes freed."""
        freed = 0
        for key in list(self._entries):
            if freed >= want_bytes or self._bytes <= floor:
                break
            e = self._entries[key]
            if e.pins > 0:
                continue
            del self._entries[key]
            self._bytes -= e.nbytes
            freed += e.nbytes
            self.evictions += 1
            self.evicted_bytes += e.nbytes
            if reason == "execution":
                self._m.evicted_for_execution += 1
        return freed

    def _pin_locked(self, key, e: StoreEntry) -> None:
        pins = _PINS.get()
        if pins is None:
            return  # no execution scope: served unpinned
        e.pins += 1
        pins.append((self, key))

    # -- introspection --------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes_used": self._bytes,
                "pinned_entries": sum(
                    1 for e in self._entries.values() if e.pins),
                "hits": self.hits,
                "misses": self.misses,
                "recomputes": self.recomputes,
                "hit_bytes": self.hit_bytes,
                "evictions": self.evictions,
                "evicted_bytes": self.evicted_bytes,
                "put_bytes": self.put_bytes,
                "rejected_puts": self.rejected_puts,
            }

    def entries_snapshot(self, n: int = 64) -> List[Dict[str, Any]]:
        """The newest ``n`` entries, most recently used last."""
        with self._lock:
            return [{
                "key": _short(e.key),
                "bytes": e.nbytes,
                "pins": e.pins,
                "hits": e.hits,
                "age_s": time.time() - e.created_t,
            } for e in list(self._entries.values())[-n:]]


def _short(key) -> str:
    s = str(key)
    return s if len(s) <= 120 else s[:117] + "..."
