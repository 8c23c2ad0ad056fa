"""Typed configuration registry: the port of ``spark_tpu/conf.py``.

Typed entries with defaults and docs, and a session-scoped mutable view
over them (Spark: ConfigEntry.scala:74 and
SQLConf.scala:56). Only the keys that ported code reads are registered
here; the runtime-filter keys are registered by ``plan/optimizer.py``,
and those of the out-of-memory tier by ``physical/chunked.py`` and
``recovery.py``, which read them, as in the reference. Keys of tiers
that are not ported yet come with those tiers (ROADMAP queue A).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional


@dataclass(frozen=True)
class ConfigEntry:
    key: str
    default: Any
    doc: str
    value_type: Callable[[Any], Any] = lambda x: x


_REGISTRY: Dict[str, ConfigEntry] = {}

#: registered free-form key prefixes: prefix -> doc. A key matching a
#: registered prefix is declared even though its suffix is user-chosen.
_PREFIXES: Dict[str, str] = {}


def register(key: str, default: Any, doc: str,
             value_type: Callable[[Any], Any] = lambda x: x) -> ConfigEntry:
    entry = ConfigEntry(key, default, doc, value_type)
    _REGISTRY[key] = entry
    return entry


def register_prefix(prefix: str, doc: str) -> str:
    """Declare a free-form key family. Returns the prefix, so callers can
    keep it as a plain string constant."""
    _PREFIXES[prefix] = doc
    return prefix


def is_registered(key: str) -> bool:
    """True when ``key`` is a declared ConfigEntry or matches a
    registered prefix."""
    return key in _REGISTRY or any(key.startswith(p) for p in _PREFIXES)


CBO_JOIN_REORDER = register(
    "spark.sql.cbo.joinReorder.enabled", True,
    "Reorder maximal inner equi-join clusters greedily by estimated "
    "cardinality (reference: CostBasedJoinReorder.scala:1; here driven "
    "by batch capacities and Parquet metadata, not ANALYZE stats).", bool)

ANALYSIS_LEVEL = register(
    "spark.tpu.analysis.level", "off",
    "Governs conf.set of undeclared keys: off accepts them silently, "
    "warn emits a warning, error raises. (In the reference it also "
    "gates a static plan analysis before execution, which is not "
    "ported.)", str)


WAREHOUSE_DIR = register(
    "spark.sql.warehouse.dir", "spark-warehouse",
    "Directory of the persistent (saveAsTable) tables: each is "
    "<dir>/<name>/{_table.json,data/}, the reference's layout, so either "
    "package reads what the other wrote (reference: StaticSQLConf "
    "WAREHOUSE_PATH).", str)

MESH_DEVICES = register(
    "spark_tpu.mesh.devices", None,
    "The mesh size SparkSession.builder.master('mesh[N]') asks for: N "
    "ranks, -1 for every CUDA device, None (unset) for one device. The "
    "ranks run on cuda:0 .. cuda:N-1 unless the builder lists the "
    "devices (meshDevices), which may repeat one.",
    lambda v: v if v is None else int(v))

JIT_STAGE_CACHE_ENTRIES = register(
    "spark.tpu.jit.stageCacheEntries", 512,
    "Entry cap for the captured-stage cache (physical/graphs._STAGE_CACHE: "
    "one CUDA graph per fused stage and leaf tensors). Graphs beyond the "
    "cap are dropped LRU; an evicted stage is captured again on next "
    "use.", int)

ADAPTIVE_CAPACITY_BUCKET = register(
    "spark.tpu.adaptive.capacityBucket", 1024,
    "Compaction capacities between stages and of a result before its "
    "copy to the host are the recorded live count rounded UP to a "
    "multiple of this, so re-executions land on a small set of "
    "capacities (reference analogue: "
    "spark.sql.adaptive.coalescePartitions.*).", int)


# ---- the out-of-memory tier (physical/pipeline.py, storage/) --------------
# The defaults below are the reference's, so both packages pick the same
# tier for the same plan; they are not sized for the port's card yet
# (ROADMAP A9).

PIPELINE_DEPTH = register(
    "spark.tpu.pipelineDepth", 2,
    "Out-of-memory chunk pipeline depth: how many prepared chunks the "
    "producer thread (Arrow decode, host key filter, staging in pinned "
    "host memory and the copy to the device on a side stream) may run "
    "ahead of device compute. 0 runs the serial loop on the caller's "
    "thread. Rows are identical at every depth: chunks are consumed in "
    "source order. Default: the reference's.", int)

PREFETCH_BYTES_MAX = register(
    "spark.tpu.prefetchBytesMax", 1 << 30,
    "Byte cap on prepared but unconsumed pipeline chunks (their device "
    "bytes). The producer stalls before the next chunk once in-flight "
    "bytes reach it; one chunk is always admitted, so a cap below one "
    "chunk degrades to serial and never deadlocks. Default: the "
    "reference's.", int)

SCHEDULER_HBM_BUDGET = register(
    "spark.tpu.scheduler.hbmBudgetBytes", 2 << 30,
    "The device-bytes budget that storage (cached batches in the "
    "session's MemoryStore) and execution grants (the hybrid hash "
    "join's build staging) share through the UnifiedMemoryManager. "
    "Default: the reference's, not yet sized for the port's card.", int)

STORAGE_MAX_BYTES = register(
    "spark.tpu.storage.maxBytes", 1 << 30,
    "Cap on the storage region of the unified budget: the device bytes "
    "the MemoryStore may hold. The effective cap is min(this, "
    "hbmBudgetBytes - execution grants) (reference: "
    "spark.memory.fraction / UnifiedMemoryManager). Default: the "
    "reference's.", int)

STORAGE_MIN_BYTES = register(
    "spark.tpu.storage.minBytes", 64 * 1024 * 1024,
    "Protected storage region: an execution grant may evict unpinned "
    "cached batches, but never below this many bytes (reference: "
    "spark.memory.storageFraction). Default: the reference's.", int)

STORAGE_AUTOCACHE_THRESHOLD = register(
    "spark.tpu.storage.autoCacheThreshold", 2,
    "A (source, columns, filters) file scan read this many times in the "
    "session is promoted into the session's MemoryStore "
    "(byte-accounted, LRU-evictable), so later reads skip the decode, "
    "the encoding and the copy to the device. 0 disables it; "
    "DataFrame.cache() is unaffected. Default: the reference's.", int)


def active_int(entry: ConfigEntry, conf=None) -> int:
    """An integer setting from ``conf``, else the active session's, else
    its default."""
    if conf is None:
        from spark_tpu_torch.api.session import SparkSession

        sess = SparkSession.getActiveSession()
        conf = None if sess is None else sess.conf
    return int(entry.default if conf is None else conf.get(entry))


class RuntimeConf:
    """Session-scoped mutable view over the registry."""

    def __init__(self, overrides: Optional[Dict[str, Any]] = None):
        self._overrides: Dict[str, Any] = dict(overrides or {})

    def get(self, entry_or_key) -> Any:
        key = (entry_or_key.key if isinstance(entry_or_key, ConfigEntry)
               else entry_or_key)
        if key in self._overrides:
            return self._overrides[key]
        if key in _REGISTRY:
            return _REGISTRY[key].default
        raise KeyError(f"unknown config key: {key}")

    def set(self, key: str, value: Any) -> None:
        if key in _REGISTRY:
            value = _REGISTRY[key].value_type(value)
        elif not is_registered(key):
            # an undeclared key no-ops every read path (get() raises on
            # it): surface the typo at the level the session asked for
            level = str(self._overrides.get(
                ANALYSIS_LEVEL.key, ANALYSIS_LEVEL.default)).lower()
            if level == "error":
                raise KeyError(
                    f"unknown config key: {key} (not a registered "
                    "ConfigEntry or prefix; set "
                    "spark.tpu.analysis.level=warn to tolerate)")
            if level == "warn":
                warnings.warn(
                    f"conf.set of undeclared key {key!r}: not a "
                    "registered ConfigEntry or prefix; reads of it "
                    "will raise KeyError", stacklevel=2)
        self._overrides[key] = value

    def unset(self, key: str) -> None:
        self._overrides.pop(key, None)

    def entries(self) -> Dict[str, Any]:
        out = {k: e.default for k, e in _REGISTRY.items()}
        out.update(self._overrides)
        return out
