"""Lock-hierarchy registry and runtime lock-order validator (the port of
``spark_tpu/locks.py``).

Every long-lived lock in the tree is created through this module's
``named_lock`` / ``named_rlock`` / ``named_condition`` factories and
carries a NAME and a RANK from ``LOCK_RANKS``.  The rank defines the
only legal acquisition order: a thread holding a lock may only acquire
locks of strictly GREATER rank (outermost locks have the smallest
rank).  Re-entry of the same name is always legal — shared RLocks
(MemoryStore aliases UnifiedMemoryManager.lock) and per-instance locks
sharing one name (LruDict, PipelineStats, cache entry locks) both rely
on it.

Two verifiers check the same table:

- the static analyzer (``spark_tpu_torch/analysis/concurrency.py``,
  ``lint_package()``) builds the lock-acquisition graph from
  the AST and reports edges that invert the ranks or form cycles;
- the runtime validator (``spark.tpu.debug.lockOrder``) records the
  per-thread held-stack on every acquire and flags observed
  rank-inverting edges and cycles in the observed edge set
  (``order_report()``).

This module is deliberately stdlib-only: metrics.py and every other
lock-bearing module imports it, so it must sit at the bottom of the
import graph.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Set, Tuple

#: name -> rank.  Ascending rank is the legal outer->inner acquisition
#: order; gaps leave room for future locks.  Locks that never nest with
#: anything still get a name so the runtime validator can prove it.
LOCK_RANKS: Dict[str, int] = {
    # --- session / cache tier (outermost: held around whole queries) --
    "session.cache.registry": 100,   # CacheManager._lock: name->entry map
    "mview.manager": 120,            # ViewManager._lock: view registry
    "session.cache.entry": 140,      # per-entry materialization lock
    "mview.view": 150,               # MaterializedView.lock (refresh state)
    # --- compile service ---------------------------------------------
    "compile.plans": 200,            # CompileService._plans_lock
    "compile.jobs": 210,             # CompileService._jobs_lock
    "compile.stage": 220,            # per-stage background-compile state
    "compile.store": 230,            # StatsStore._lock (disk index)
    "compile.loaded": 240,           # compile/store.py _LOADED cache
    "compile.dict_fp": 250,          # compile/store.py dict-fp cache
    "compile.history": 260,          # PlanHistory._lock (history file)
    "compile.prewarm": 270,          # prewarm report/index accumulators
    # --- scheduler / execution ---------------------------------------
    "scheduler.cond": 300,           # QueryScheduler._cond: queue+gate
    "scheduler.pools": 310,          # PoolRegistry._lock
    "slo.model": 320,                # LatencyModel EWMA state + journal
    "slo.controller": 325,           # SloController window/resize state
    "pipeline.cond": 350,            # ChunkPipeline._cond: inflight budget
    "serve.invalidation": 355,       # InvalidationLog ring + subscribers
    "serve.result_cache": 360,       # ResultCache._flights map
    "serve.federation": 370,         # FederationRouter round-robin state
    "serve.ownership": 372,          # shard->owner map + epoch state
    "serve.breaker": 380,            # per-replica CircuitBreaker window
    "serve.brownout": 385,           # BrownoutController pressure window
    # --- storage / memory manager (inner: leaf data structures) ------
    "storage.unified": 400,          # UnifiedMemoryManager.lock (RLock,
    #                                  shared with MemoryStore._lock)
    "storage.lru": 420,              # LruDict._lock (serve blob cache)
    "storage.lru_gauges": 425,       # port: storage/lru.py's gauge table,
    #                                  set under an LruDict's lock
    "admission.measured": 440,       # measured plan-bytes table
    "streaming.source": 460,         # streaming source buffers
    "recovery.retry_budget": 470,    # per-query RetryBudget pool state
    "recovery.checkpoint": 480,      # checkpoint dir init
    "faults.registry": 500,          # fault-injection spec table
    "graphs.capture": 505,           # port: physical/graphs.py, one CUDA
    #                                  graph capture (warm-up included)
    #                                  at a time; held around the stage
    #                                  function, so below every lock a
    #                                  stage takes (ops.build on a
    #                                  kernel's first load)
    "graphs.replay": 507,            # port: a graph's replay and the
    #                                  clones of its outputs
    "native.registry": 520,          # pallas kernel registry
    "ops.build": 525,                # port: ops/_build.py's library
    #                                  builds and loads (RLock; taken on
    #                                  a kernel's first use, under no
    #                                  other engine lock)
    "analysis.recent": 540,          # recent AnalysisReport ring
    # --- port-only leaves (held around a few dict/counter updates) ----
    "device.tables": 800,            # port: device.py's host-table cache
    "expr.arrow_dicts": 810,         # port: expr/compiler.py's Arrow
    #                                  copies of dictionaries
    "mesh.rank_stage": 820,          # port: parallel/executor.py, one
    #                                  per rank stage (its failures list)
    "exchange.thread_comm": 830,     # port: parallel/exchange.py
    #                                  ThreadComm's exchange events
    "ops.seg_agg": 840,              # port: ops/seg_agg.py's launch
    #                                  counters and library typing (taken
    #                                  on every kernel launch)
    "physical.stats_cache": 850,     # port: physical/operators.py's
    #                                  adaptive stats caches and the stage
    #                                  cache (queries on several threads)
    # --- metrics (innermost: every layer records into them) ----------
    "metrics.registry": 900,         # metrics._LOCK: event/gauge tables
    "metrics.pipeline_stats": 910,   # PipelineStats._lock
    "metrics.io": 920,               # metrics._IO_LOCK: log-file writes
}


def rank_of(name: str) -> int:
    return LOCK_RANKS[name]


def register_lock(name: str, rank: int) -> None:
    """Extend the hierarchy (extensions/tests).  Refuses to re-rank an
    existing name — the table is the single source of truth."""
    existing = LOCK_RANKS.get(name)
    if existing is not None and existing != rank:
        raise ValueError(
            f"lock {name!r} already registered with rank {existing}")
    LOCK_RANKS[name] = rank


# --------------------------------------------------------------------------
# runtime order validation
# --------------------------------------------------------------------------

_VALIDATE = False
_local = threading.local()

# observation state shared by all threads; guarded by a RAW lock that is
# itself outside the validated world (never wrapped, never recorded).
_OBS_LOCK = threading.Lock()
_EDGES: Set[Tuple[str, str]] = set()          # observed (outer, inner)
_VIOLATIONS: List[dict] = []                  # rank inversions observed
_CYCLES: List[Tuple[str, ...]] = []           # cycles in the edge set
_MAX_VIOLATIONS = 256


def set_validation(on: bool) -> None:
    """Turn runtime lock-order recording on/off.  Proxies check the
    flag per acquire, so this works on locks created long before."""
    global _VALIDATE
    _VALIDATE = bool(on)


def validation_enabled() -> bool:
    return _VALIDATE


def configure(conf) -> None:
    """Wire validation to ``spark.tpu.debug.lockOrder``."""
    try:
        set_validation(bool(conf.get("spark.tpu.debug.lockOrder")))
    except Exception:
        pass


def reset_observations() -> None:
    with _OBS_LOCK:
        _EDGES.clear()
        _VIOLATIONS.clear()
        _CYCLES.clear()


def order_report() -> dict:
    """Snapshot of everything the validator observed: the edge set,
    rank-inversion violations, and cycles in the observed graph."""
    with _OBS_LOCK:
        return {
            "enabled": _VALIDATE,
            "edges": sorted(_EDGES),
            "violations": list(_VIOLATIONS),
            "cycles": [list(c) for c in _CYCLES],
        }


def _held_stack() -> List[Tuple[str, int]]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _find_cycle_locked(start: str, target: str) -> Optional[Tuple[str, ...]]:
    """DFS over _EDGES from ``start`` looking for ``target``; returns
    the node path if adding (target -> start) closes a cycle.  Called
    with _OBS_LOCK held on a small graph (dozens of names)."""
    path: List[str] = [start]
    seen = {start}

    def dfs(node: str) -> bool:
        if node == target:
            return True
        for (a, b) in _EDGES:
            if a == node and b not in seen:
                seen.add(b)
                path.append(b)
                if dfs(b):
                    return True
                path.pop()
        return False

    return tuple(path) if dfs(start) else None


def _note_acquired(name: str, ident: int) -> None:
    """Record that the current thread acquired ``name`` while holding
    everything on its stack; detect rank inversions and new cycles."""
    stack = _held_stack()
    new_edges = []
    for held_name, held_id in stack:
        if held_name == name:
            # same-name re-entry (RLock sharing / sibling instances
            # under one name) is legal by construction
            continue
        edge = (held_name, name)
        r_held = LOCK_RANKS.get(held_name)
        r_new = LOCK_RANKS.get(name)
        bad = (r_held is not None and r_new is not None and r_new <= r_held)
        with _OBS_LOCK:
            fresh = edge not in _EDGES
            if fresh:
                _EDGES.add(edge)
                new_edges.append(edge)
            if bad and len(_VIOLATIONS) < _MAX_VIOLATIONS:
                if fresh or not any(v["edge"] == list(edge)
                                    for v in _VIOLATIONS):
                    _VIOLATIONS.append({
                        "kind": "rank-inversion",
                        "edge": [held_name, name],
                        "ranks": [r_held, r_new],
                        "thread": threading.current_thread().name,
                    })
    # cycle check only on fresh edges (the graph is tiny and edges are
    # recorded once, so this is off the steady-state hot path)
    for (a, b) in new_edges:
        with _OBS_LOCK:
            cyc = _find_cycle_locked(b, a)
            if cyc is not None:
                full = cyc + (b,)          # b -> ... -> a -> b
                if full not in _CYCLES:
                    _CYCLES.append(full)
    stack.append((name, ident))


def _note_released(name: str, ident: int) -> None:
    stack = _held_stack()
    for i in range(len(stack) - 1, -1, -1):
        if stack[i] == (name, ident):
            del stack[i]
            return


class _NamedLockBase:
    """Thin proxy over a threading lock primitive.  Always constructed
    (so validation can be flipped on mid-process for locks created at
    import time); per-acquire cost when validation is off is a single
    global-flag check."""

    __slots__ = ("name", "rank", "_inner")
    _kind = "lock"

    def __init__(self, name: str, inner) -> None:
        if name not in LOCK_RANKS:
            raise ValueError(
                f"lock name {name!r} is not in locks.LOCK_RANKS — "
                "register it (with a rank) before use")
        self.name = name
        self.rank = LOCK_RANKS[name]
        self._inner = inner

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got and _VALIDATE:
            _note_acquired(self.name, id(self._inner))
        return got

    def release(self) -> None:
        if _VALIDATE:
            _note_released(self.name, id(self._inner))
        self._inner.release()

    # ``with`` is the hot path (a kernel launch takes the launch
    # counters' lock): inlined, one flag check over the plain lock
    def __enter__(self):
        self._inner.acquire()
        if _VALIDATE:
            _note_acquired(self.name, id(self._inner))
        return self

    def __exit__(self, *exc) -> None:
        if _VALIDATE:
            _note_released(self.name, id(self._inner))
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<{type(self).__name__} {self.name!r} rank={self.rank}>"


class NamedLock(_NamedLockBase):
    _kind = "lock"


class NamedRLock(_NamedLockBase):
    _kind = "rlock"

    def locked(self) -> bool:  # RLock has no .locked() before 3.12
        raise NotImplementedError


class NamedCondition(_NamedLockBase):
    """Condition proxy: the underlying lock is acquired/released via
    the proxy bookkeeping; wait's internal release-reacquire is not
    modelled (the thread is blocked, so it records no edges)."""

    _kind = "condition"

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._inner.wait(timeout)

    def wait_for(self, predicate: Callable[[], bool],
                 timeout: Optional[float] = None) -> bool:
        return self._inner.wait_for(predicate, timeout)

    def notify(self, n: int = 1) -> None:
        self._inner.notify(n)

    def notify_all(self) -> None:
        self._inner.notify_all()


def named_lock(name: str) -> NamedLock:
    return NamedLock(name, threading.Lock())


def named_rlock(name: str) -> NamedRLock:
    return NamedRLock(name, threading.RLock())


def named_condition(name: str) -> NamedCondition:
    return NamedCondition(name, threading.Condition())
