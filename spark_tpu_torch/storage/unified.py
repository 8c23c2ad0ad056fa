"""Unified storage/execution accounting of device bytes (the port of
``spark_tpu/storage/unified.py``; reference: UnifiedMemoryManager.scala:56).

Storage (cached device batches, ``store.py``) and execution (the grants
the hybrid hash join's build staging asks for, ``physical/chunked.py``)
share one byte budget, ``spark.tpu.scheduler.hbmBudgetBytes``:

- execution may evict unpinned storage entries (LRU) to make room, but
  never below ``spark.tpu.storage.minBytes``;
- storage may grow into memory execution is not using, but never evicts
  a running grant: a cache insert that does not fit after evicting
  storage's own LRU tail is rejected (the entry stays recomputable);
- with nothing admitted, execution always gets a grant, capped at what
  the budget minus surviving storage allows (possibly zero: the caller
  then runs ungated and relies on the OOM ladder).

Invariant, held under one lock: ``storage_bytes + execution_in_use <=
budget`` at every instant. The scheduler's admission control that also
draws on this budget is ``scheduler/admission.py``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from spark_tpu_torch import locks
from spark_tpu_torch import conf as CF


class UnifiedMemoryManager:
    """Shared device byte-budget ledger. Built with a static budget
    (tests, standalone use) or with a ``conf`` whose
    ``spark.tpu.scheduler.hbmBudgetBytes`` and ``spark.tpu.storage.*``
    keys are read live, so a session resizes it between queries."""

    def __init__(self, budget_bytes: Optional[int] = None, conf=None,
                 min_storage_bytes: Optional[int] = None,
                 max_storage_bytes: Optional[int] = None):
        if budget_bytes is None and conf is None:
            raise ValueError("need budget_bytes or conf")
        self._conf = conf
        self._budget = int(budget_bytes) if budget_bytes is not None \
            else None
        self._min_storage = min_storage_bytes
        self._max_storage = max_storage_bytes
        #: one lock for both sides; the store shares it, so an eviction
        #: decision and the accounting it rests on are atomic
        self.lock = locks.named_rlock("storage.unified")
        self._execution = 0
        self._admitted = 0
        self._store = None  # a MemoryStore registers itself
        self.evicted_for_execution = 0
        self.grants = 0
        self.grant_bytes = 0
        self.grant_waits = 0
        self.grant_denials = 0
        self.zero_grants = 0
        self.grows = 0
        self.grow_denials = 0
        #: called after ``release_execution`` drops the lock: the
        #: scheduler's gate registers here, so a grant released by any
        #: tenant (the hybrid join, the scheduler) wakes its waiters.
        #: Called under the lock, they would nest storage.unified ->
        #: scheduler.cond against the ranks.
        self._release_listeners: list = []

    # -- live settings --------------------------------------------------------

    @property
    def budget(self) -> int:
        if self._budget is not None:
            return max(1, self._budget)
        return max(1, int(self._conf.get(CF.SCHEDULER_HBM_BUDGET)))

    @property
    def min_storage(self) -> int:
        if self._min_storage is not None:
            return max(0, int(self._min_storage))
        if self._conf is not None:
            return max(0, int(self._conf.get(CF.STORAGE_MIN_BYTES)))
        return 0

    @property
    def max_storage(self) -> int:
        cap = self.budget
        if self._max_storage is not None:
            return min(cap, max(0, int(self._max_storage)))
        if self._conf is not None:
            return min(cap, max(0, int(self._conf.get(
                CF.STORAGE_MAX_BYTES))))
        return cap

    # -- wiring ---------------------------------------------------------------

    def attach_store(self, store) -> None:
        self._store = store

    def storage_bytes(self) -> int:
        return self._store.bytes_used() if self._store is not None else 0

    # -- execution side -------------------------------------------------------

    def charge_for(self, nbytes: int) -> int:
        """The most a grant of ``nbytes`` may cost: capped at the whole
        budget, so an over-budget request can still be granted alone."""
        return min(max(1, int(nbytes)), self.budget)

    def fits_execution(self, nbytes: int) -> bool:
        with self.lock:
            if self._admitted == 0:
                return True  # idle device: always make progress
            charge = self.charge_for(nbytes)
            avail = self.budget - self._execution - self.storage_bytes()
            if charge <= avail + self._storage_freeable_locked():
                return True
            self.grant_waits += 1
            return False

    def acquire_execution(self, nbytes: int) -> int:
        """Charge the budget, evicting unpinned storage (LRU, down to the
        protected ``min_storage``) when the free span is short. The
        charge to pass to ``release_execution``: capped so that the
        invariant holds even when protected or pinned storage keeps the
        request from fitting (it may then be 0)."""
        with self.lock:
            charge = self.charge_for(nbytes)
            avail = self.budget - self._execution - self.storage_bytes()
            if charge > avail and self._store is not None:
                self._store._evict_locked(
                    charge - avail, floor=self.min_storage,
                    reason="execution")
                avail = self.budget - self._execution \
                    - self.storage_bytes()
            requested = charge
            charge = max(0, min(charge, avail))
            self._execution += charge
            self._admitted += 1
            self.grants += 1
            self.grant_bytes += charge
            if charge < requested:
                self.grant_denials += 1
            if charge == 0 and int(nbytes) > 0:
                self.zero_grants += 1
            return charge

    def try_grow(self, nbytes: int) -> int:
        """Grow a live grant by up to ``nbytes`` from the free span only,
        never by evicting storage; the bytes added (the caller adds them
        to the charge it releases)."""
        with self.lock:
            nbytes = max(0, int(nbytes))
            avail = max(0, self.budget - self._execution
                        - self.storage_bytes())
            got = min(nbytes, avail)
            if got > 0:
                self._execution += got
                self.grows += 1
                self.grant_bytes += got
            elif nbytes > 0:
                self.grow_denials += 1
            return got

    def add_release_listener(self, callback) -> None:
        """Call ``callback()`` (outside the lock) after every release of
        an execution grant: a blocked admission may fit now."""
        with self.lock:
            self._release_listeners.append(callback)

    def release_execution(self, charge: int) -> None:
        with self.lock:
            self._execution = max(0, self._execution - int(charge))
            self._admitted = max(0, self._admitted - 1)
            listeners = list(self._release_listeners)
        for cb in listeners:
            try:
                cb()
            except Exception:  # noqa: BLE001 - a listener never fails a release
                pass

    def _storage_freeable_locked(self) -> int:
        """Unpinned storage bytes execution could reclaim without going
        into the protected region."""
        if self._store is None:
            return 0
        unpinned = self._store.unpinned_bytes()
        return max(0, min(unpinned, self.storage_bytes() - self.min_storage))

    # -- storage side ---------------------------------------------------------

    def reserve_storage(self, nbytes: int) -> bool:
        """May the store take ``nbytes`` more? Evicts the store's own LRU
        tail to fit under ``min(max_storage, budget - execution)``; never
        touches execution grants. The store inserts under the same lock
        on True."""
        with self.lock:
            nbytes = int(nbytes)
            limit = min(self.max_storage, self.budget - self._execution)
            if nbytes > limit:
                return False
            used = self.storage_bytes()
            if used + nbytes > limit and self._store is not None:
                self._store._evict_locked(
                    used + nbytes - limit, floor=0, reason="storage")
                used = self.storage_bytes()
            return used + nbytes <= limit

    # -- introspection --------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        with self.lock:
            return {
                "budget_bytes": self.budget,
                "in_use_bytes": self._execution,
                "admitted": self._admitted,
                "storage_bytes": self.storage_bytes(),
                "storage_min_bytes": self.min_storage,
                "storage_max_bytes": self.max_storage,
                "free_bytes": max(0, self.budget - self._execution
                                  - self.storage_bytes()),
                "grants": {
                    "grants": self.grants,
                    "grant_bytes": self.grant_bytes,
                    "grant_waits": self.grant_waits,
                    "grant_denials": self.grant_denials,
                    "zero_grants": self.zero_grants,
                    "grows": self.grows,
                    "grow_denials": self.grow_denials,
                },
            }
