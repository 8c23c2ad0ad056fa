"""Typed configuration registry: the port of ``spark_tpu/conf.py``.

Typed entries with defaults and docs, and a session-scoped mutable view
over them (Spark: ConfigEntry.scala:74 and
SQLConf.scala:56). Only the keys that ported code reads are registered
here; the runtime-filter keys are registered by ``plan/optimizer.py``,
those of the out-of-memory tier by ``physical/chunked.py`` and
``recovery.py``, and the serve tier's breaker, brownout, ownership and
fingerprint keys by ``serve/``, which read them, as in the reference.
The compile tier's and the materialized views' keys are here, and the
RDD tier's ``spark.task.maxFailures``; the streaming tier reads none of
its own.
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
    "Pre-execution static plan analysis gate (analysis/analyzer.py): "
    "off (default, no analysis on the submit path), warn (analyze every "
    "submitted plan and record its diagnostics as events and metrics) "
    "or error (also raise PlanAnalysisError when an error-level "
    "diagnostic fires, before anything touches the device). The same "
    "level governs conf.set of undeclared keys: warn emits a warning, "
    "error raises.", str)

ANALYSIS_DIVERGENCE_FACTOR = register(
    "spark.tpu.analysis.divergenceFactor", 16.0,
    "The analyzer's static byte estimate is cross-checked against a "
    "measured byte count of the same plan where one exists; when the "
    "two differ by more than this factor either way the plan gets a "
    "PLAN-EST-DIVERGE diagnostic. Default: the reference's.", float)

ANALYSIS_ERROR_CODES = register(
    "spark.tpu.analysis.errorCodes", "",
    "Comma-separated diagnostic codes escalated to error level at the "
    "submit-time gate (e.g. 'PLAN-DTYPE-F64,PLAN-RECOMPILE-SHAPE').",
    str)

DEBUG_LOCK_ORDER = register(
    "spark.tpu.debug.lockOrder", False,
    "Runtime cross-check of the lock hierarchy (locks.py): when true, "
    "every named lock records the per-thread held stack on acquire and "
    "locks.order_report() lists the observed acquisition edges and any "
    "rank inversions or cycles. Off by default (one flag check per "
    "acquire either way).", bool)

TASK_MAX_FAILURES = register(
    "spark.task.maxFailures", 4,
    "Attempts per partition-compute task of the RDD tier (rdd.py) before "
    "the job fails (reference: config/package.scala TASK_MAX_FAILURES).",
    int)


EVENT_LOG_DIR = register(
    "spark.eventLog.dir", "",
    "When set, every event of the metrics ring (metrics.py) is appended "
    "as JSONL to events.jsonl under this directory (reference: "
    "EventLoggingListener.scala:48).", str)

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
    "capacities; on a mesh with adaptive execution on, a post-exchange "
    "capacity is the measured largest incoming live count rounded up "
    "to it (reference analogue: spark.sql.adaptive.coalescePartitions.*)."
    , int)

# ---- adaptive query execution over the mesh (parallel/executor.py) --------
# Names, defaults and meanings are the reference's (spark_tpu/conf.py).

ADAPTIVE_ENABLED = register(
    "spark.tpu.adaptive.enabled", False,
    "Adaptive query execution over the mesh (reference: "
    "spark.sql.adaptive.enabled / AdaptiveSparkPlanExec.scala:98): cut "
    "the plan at exchange boundaries, measure per-rank live counts with "
    "one psum/pmax stats stage, run the exchange at a compacted "
    "bucket-rounded capacity, switch measured-small join builds to "
    "broadcast, fan skewed destinations over the partial->final "
    "aggregate merge, and choose the aggregation strategy at runtime. "
    "Results are byte-identical on or off; the OOM-degradation ladder "
    "also retries a failed mesh run with this forced on before it "
    "chunks.", bool)

ADAPTIVE_BROADCAST_THRESHOLD = register(
    "spark.tpu.adaptive.autoBroadcastJoinThreshold", 8 * 1024 * 1024,
    "Max MEASURED build-side bytes (live rows x row width, counted on "
    "the device, not the static capacity estimate) for runtime "
    "broadcast-join switching when adaptive execution is on (reference: "
    "DynamicJoinSelection.scala:40 over MapOutputStatistics).", int)

ADAPTIVE_SKEW_FACTOR = register(
    "spark.tpu.adaptive.skewedPartitionFactor", 4,
    "A hash-exchange destination whose measured incoming live count "
    "exceeds this many times the median destination's is skewed: its "
    "rows stay on their source rank (a local-shuffle-reader fan), are "
    "pre-merged by the aggregate, and only the merged groups exchange "
    "again (reference: OptimizeSkewedJoin.scala "
    "SKEW_JOIN_SKEWED_PARTITION_FACTOR). Taken only when every "
    "aggregate merge re-applies exactly (integer sum, non-float "
    "min/max), so results stay byte-identical.", int)

ADAPTIVE_SKEW_MIN_ROWS = register(
    "spark.tpu.adaptive.skewMinRows", 4096,
    "Absolute floor for the skew fan: the hottest destination must "
    "expect at least this many incoming rows (the factor alone misfires "
    "on tiny exchanges).", int)

ADAPTIVE_AGG_ENABLED = register(
    "spark.tpu.adaptive.agg.enabled", True,
    "Runtime-adaptive aggregation (only with spark.tpu.adaptive.enabled "
    "on): the exchange stats stage also sketches the group keys "
    "(HyperLogLog register maxima, per-key min/max, a Count-Min heavy "
    "hitter probe) and the executor picks partial->final, bypass, "
    "hash-partial, the sort rung or hot-key pre-split. Results are "
    "byte-identical across strategies; aggregates whose partials are "
    "order-dependent (float Sum/Avg/Min/Max) pin to partial->final.",
    bool)

ADAPTIVE_AGG_STRATEGY = register(
    "spark.tpu.adaptive.agg.strategy", "auto",
    "Aggregation strategy override: 'auto' decides from the runtime "
    "sketch; 'partial', 'bypass', 'hash', 'sort' or 'presplit' force one "
    "(an illegal or unexecutable forced choice falls back to 'partial', "
    "so results stay byte-identical). A test and debugging knob.", str)

ADAPTIVE_AGG_BYPASS_NDV_RATIO = register(
    "spark.tpu.adaptive.agg.bypassNdvRatio", 0.5,
    "Partial-bypass threshold: when the sketched distinct-key estimate "
    "is at least this fraction of the live rows, pre-aggregation cannot "
    "shrink the exchange, so raw rows exchange straight to the final "
    "aggregate.", float)

ADAPTIVE_AGG_HASH_DOMAIN_LIMIT = register(
    "spark.tpu.adaptive.agg.hashDomainLimit", 1024,
    "Max packed key-code domain (product of the measured per-key value "
    "ranges, NULL slots included) for the hash-partial strategy: its "
    "dense segment reductions run the hand kernels up to 1024 groups "
    "(physical/kernels.MAX_KERNEL_K). Beyond it the sort partial wins.",
    int)

ADAPTIVE_AGG_SKETCH_REGISTERS = register(
    "spark.tpu.adaptive.agg.sketchRegisters", 512,
    "HyperLogLog register count of the group-key distinct sketch in the "
    "exchange stats stage (a power of two; 512 gives about 5% relative "
    "error, enough to tell NDV ~ rows from NDV << rows).", int)

ADAPTIVE_AGG_SORT_DOMAIN_WIDTH = register(
    "spark.tpu.adaptive.agg.sortDomainWidth", 1 << 20,
    "Sort/hash crossover: a high-NDV grouping whose measured packed key "
    "domain exceeds this width takes the sort rung (raw rows range-"
    "partitioned on the group keys, one sorted merge per rank, output "
    "key-ordered across the mesh, so a matching global sort is elided); "
    "below it the hash-exchange bypass.", int)

ADAPTIVE_AGG_PRESPLIT_FACTOR = register(
    "spark.tpu.adaptive.agg.presplitFactor", 4,
    "Hot-key pre-split threshold: a group key whose Count-Min estimated "
    "row count exceeds this multiple of the fair per-rank share "
    "(rows / D) is salted across all ranks before the exchange (contrast "
    "spark.tpu.adaptive.skewedPartitionFactor, which reacts to hot "
    "destinations after routing).", int)

ADAPTIVE_AGG_PRESPLIT_MIN_ROWS = register(
    "spark.tpu.adaptive.agg.presplitMinRows", 4096,
    "Absolute floor for the hot-key pre-split: the hottest key's "
    "Count-Min estimate must reach this many rows.", int)

ADAPTIVE_AGG_CM_DEPTH = register(
    "spark.tpu.adaptive.agg.cmDepth", 4,
    "Count-Min sketch depth (independent hash rows, at most 8) of the "
    "heavy-hitter estimate in the exchange stats stage; the estimate is "
    "the min over rows, so it never under-counts.", int)

ADAPTIVE_AGG_CM_WIDTH = register(
    "spark.tpu.adaptive.agg.cmWidth", 1024,
    "Count-Min sketch width (counters per row, a power of two); the "
    "over-count of an estimate is rows/width in expectation.", int)

# ---- whole-query fusion ----------------------------------------------------

FUSION_ENABLED = register(
    "spark.tpu.fusion.enabled", False,
    "Whole-query fusion (only with spark.tpu.adaptive.enabled on): an "
    "adaptive exchange and its consumer whose only host dependency is "
    "the capacity decision run as one span, in one rank stage with the "
    "row-preserving operators between them, the capacity rung taken "
    "from the exchange's own count read instead of a separate stats "
    "stage. Decisions that need the host (broadcast switching on "
    "measured bytes, the skew fan, the aggregation strategy, sort "
    "elision, the OOM ladder) bail out to staged execution with a typed "
    "reason. Results are byte-identical on or off.", bool)

FUSION_MAX_BUCKET_VARIANTS = register(
    "spark.tpu.fusion.maxBucketVariants", 4,
    "Capacity-ladder rungs of one fused span: receive capacities from "
    "the balanced load (rounded to spark.tpu.adaptive.capacityBucket, "
    "plus one bucket) down by 4x, at most this many rungs, the last "
    "always the worst case so any measured count is covered.", int)


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

# ---- the query scheduler (scheduler/) -------------------------------------

SCHEDULER_MODE = register(
    "spark.scheduler.mode", "FIFO",
    "Query scheduling policy across pools: FIFO (global submit order) "
    "or FAIR (weighted-fair device time across pools; reference: "
    "TaskSchedulerImpl.scala + Pool.scala spark.scheduler.mode).", str)

SCHEDULER_MAX_CONCURRENCY = register(
    "spark.tpu.scheduler.maxConcurrency", 4,
    "Scheduler worker threads: how many queries may run their host "
    "stages (parse, optimize, Parquet decode) at once. Device execution "
    "is gated by the admission budget besides. Default: the "
    "reference's.", int)

SCHEDULER_QUEUE_DEPTH = register(
    "spark.tpu.scheduler.queueDepth", 64,
    "Bound on queued (not yet dequeued) queries across all pools; a "
    "submit at the bound is refused at once (the connect server answers "
    "429 with Retry-After). Default: the reference's.", int)

SCHEDULER_HBM_BUDGET = register(
    "spark.tpu.scheduler.hbmBudgetBytes", 2 << 30,
    "The device-bytes budget that storage (cached batches in the "
    "session's MemoryStore), execution grants (the hybrid hash join's "
    "build staging) and the scheduler's admission share through the "
    "UnifiedMemoryManager. A query over the whole budget still admits "
    "alone. Default: the reference's, not yet sized for the port's "
    "card.", int)

SCHEDULER_RETRY_AFTER = register(
    "spark.tpu.scheduler.retryAfterSeconds", 1.0,
    "Retry-After hint (seconds) sent with a 429 when the scheduler "
    "queue is full.", float)

SCHEDULER_DEFAULT_POOL = register(
    "spark.tpu.scheduler.defaultPool", "default",
    "Pool a query lands in when its submit names none (reference: "
    "spark.scheduler.pool).", str)

#: free-form per-pool keys: spark.tpu.scheduler.pool.<name>.weight (int,
#: default 1) and .minShare (int, default 0)
SCHEDULER_POOL_PREFIX = register_prefix(
    "spark.tpu.scheduler.pool.",
    "Per-pool FAIR scheduling keys: "
    "spark.tpu.scheduler.pool.<name>.{weight,minShare}.")

# ---- the serving tier (serve/) ---------------------------------------------

SERVE_POLICY = register(
    "spark.tpu.serve.policy", "least_queued",
    "Federation router replica choice: 'round_robin' cycles replicas, "
    "'least_queued' takes the replica whose scheduler reported the "
    "fewest queued plus running queries at the last health probe.", str)

SERVE_RESULT_CACHE_ENABLED = register(
    "spark.tpu.serve.resultCache.enabled", False,
    "Serve repeated identical queries from the plan-keyed Arrow result "
    "cache (serve/result_cache.py): keyed on the structural plan key "
    "and the scan sources' stat fingerprints, one execution per key at "
    "a time, byte-identical to an uncached run.", bool)

SERVE_RESULT_CACHE_MAX_BYTES = register(
    "spark.tpu.serve.resultCache.maxBytes", 256 * 1024 * 1024,
    "Byte bound of the result cache; least recently used entries are "
    "evicted past it, and a single result larger than it is served but "
    "not cached.", int)

SERVE_DISPATCH_RETRIES = register(
    "spark.tpu.serve.dispatchRetries", 3,
    "How many times the router re-dispatches one request to another "
    "replica after a connection failure or an injected serve.dispatch "
    "fault before it surfaces the error.", int)

SERVE_HEALTH_PROBE_SECONDS = register(
    "spark.tpu.serve.healthProbeSeconds", 0.5,
    "Least age of a replica's cached /health answer before the router "
    "probes it again; 0 probes on every dispatch.", float)

SERVE_REPLICAS = register(
    "spark.tpu.serve.replicas", 2,
    "Replicas serve_fleet() starts when its caller names no count.", int)

# ---- SLO-driven serving (slo/) ---------------------------------------------

SLO_ENABLED = register(
    "spark.tpu.slo.enabled", False,
    "The SLO tier: per-plan latency prediction (slo/model.py), "
    "earliest-deadline-first scheduling with reject-at-admission "
    "(slo/edf.py), predictive brownout and auto-sized concurrency "
    "(slo/controller.py). Off, the scheduler's FIFO/FAIR paths run as "
    "without it.", bool)

SLO_TARGET_P99_MS = register(
    "spark.tpu.slo.targetP99Ms", 0.0,
    "p99 latency target in ms. Above 0, the controller enters brownout "
    "when the predicted p99 over the window crosses it, and leaves it "
    "under exitRatio x target. 0 disables predictive brownout.", float)

SLO_REJECT_ENABLED = register(
    "spark.tpu.slo.rejectEnabled", True,
    "Reject at admission (under spark.tpu.slo.enabled): a submit whose "
    "predicted completion exceeds its deadline raises the typed "
    "InfeasibleDeadline at once.", bool)

SLO_REJECT_MARGIN = register(
    "spark.tpu.slo.rejectMargin", 1.0,
    "Factor on the predicted completion before it is compared with the "
    "deadline.", float)

SLO_MODEL_ALPHA = register(
    "spark.tpu.slo.model.alpha", 0.3,
    "EWMA factor of the per-fingerprint latency model.", float)

SLO_MODEL_PATH = register(
    "spark.tpu.slo.model.path", "",
    "JSONL journal of the latency model; empty puts it beside the plan "
    "history under spark.tpu.compile.store.dir when the store is on, "
    "else keeps it in memory.", str)

SLO_MODEL_MAX_ENTRIES = register(
    "spark.tpu.slo.model.maxEntries", 512,
    "Plan fingerprints the latency model keeps (LRU past it; the "
    "journal is compacted past twice as many lines).", int)

SLO_WINDOW_SECONDS = register(
    "spark.tpu.slo.controller.windowSeconds", 30.0,
    "Window over which the controller takes the predicted p99.", float)

SLO_MIN_PREDICTIONS = register(
    "spark.tpu.slo.controller.minPredictions", 8,
    "Predictions in the window before predictive brownout may enter.",
    int)

SLO_EXIT_RATIO = register(
    "spark.tpu.slo.controller.exitRatio", 0.8,
    "Brownout exits once the predicted p99 <= exitRatio x target.",
    float)

SLO_AUTOSIZE_ENABLED = register(
    "spark.tpu.slo.autoConcurrency.enabled", True,
    "Size the scheduler's effective concurrency from the observed "
    "queue/run ratio (under spark.tpu.slo.enabled), between "
    "autoConcurrency.min and maxConcurrency.", bool)

SLO_AUTOSIZE_MIN = register(
    "spark.tpu.slo.autoConcurrency.min", 1,
    "Floor of the auto-sized effective concurrency.", int)

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


# ---- the compile tier (compile/) ---------------------------------------------

COMPILE_STORE_DIR = register(
    "spark.tpu.compile.store.dir", "",
    "Root directory of the cross-session statistics store "
    "(compile/store.py): the runtime statistics a plan's first run "
    "records (output, aggregate, explode, join and compaction sizes), "
    "keyed by a stable plan fingerprint that digests the data, so a "
    "restarted process binds them and its first run of a known plan "
    "is traced and captured. Empty disables the store.", str)

COMPILE_STORE_MAX_BYTES = register(
    "spark.tpu.compile.store.maxBytes", 1 << 30,
    "Size bound of the store directory; beyond it the least recently "
    "used entry files are evicted. Default: the reference's.", int)

COMPILE_STORE_SERIALIZE = register(
    "spark.tpu.compile.store.serialize", True,
    "Write the statistics of each plan's first run to the store. Off "
    "= lookups only.", bool)

COMPILE_BACKGROUND = register(
    "spark.tpu.compile.background", False,
    "A plan whose stages are not captured yet is served eagerly while "
    "its statistics run and its CUDA graph capture happen on a "
    "background thread; the next execution replays the graphs. Rows "
    "are the same either way. A background failure pins the plan to "
    "the eager path (no swap, no crash).", bool)

COMPILE_HISTORY_PATH = register(
    "spark.tpu.compile.history.path", "",
    "Served-plan history file (JSONL of served SQL and fingerprints) "
    "that the pre-warm replays. Empty defaults to "
    "<store.dir>/plan_history.jsonl when the store is on.", str)

COMPILE_HISTORY_MAX_ENTRIES = register(
    "spark.tpu.compile.history.maxEntries", 512,
    "Distinct plans kept in the served-plan history (the file is "
    "compacted past about twice as many lines).", int)

COMPILE_PREWARM_ENABLED = register(
    "spark.tpu.compile.prewarm.enabled", True,
    "Replay the served-plan history when a connect server starts, on "
    "a background worker, most frequent first: each plan runs its "
    "first run and its capture, so the first client query replays.",
    bool)

COMPILE_PREWARM_BUDGET_S = register(
    "spark.tpu.compile.prewarm.budgetSeconds", 120.0,
    "Wall-clock budget of the pre-warm replay; the entries left when "
    "it is spent are skipped (and named in the pre-warm report).",
    float)

COMPILE_PREWARM_MAX_QUERIES = register(
    "spark.tpu.compile.prewarm.maxQueries", 32,
    "Most distinct history plans the pre-warm replays, most frequent "
    "first.", int)

COMPILE_PREWARM_WORKERS = register(
    "spark.tpu.compile.prewarm.workers", 1,
    "Threads replaying the history at once during the pre-warm. 1 = "
    "one after another (deterministic order).", int)

# ---- materialized views (mview/) ----------------------------------------------

MVIEW_ENABLED = register(
    "spark.tpu.mview.enabled", False,
    "Treat df.cache() of an aggregate over a fingerprinted file source "
    "as a materialized view (mview/): the cached device batch is "
    "refreshed when the source files change instead of being served "
    "stale, incrementally when the aggregate is exactly "
    "re-mergeable.", bool)

MVIEW_INCREMENTAL = register(
    "spark.tpu.mview.incremental", True,
    "Refresh an appended-to view by running the aggregate over the new "
    "files only and re-merging the partials into the cached batch "
    "(integer Sum and non-float Min/Max only; everything else "
    "recomputes in full). Off = always a full recompute; both give "
    "the same bytes.", bool)

MVIEW_REFRESH_RETRIES = register(
    "spark.tpu.mview.refreshRetries", 2,
    "Retries of one incremental view refresh after a transient failure "
    "(injected mview.refresh faults included) before it falls back to "
    "a full recompute.", int)

MVIEW_SERVE_REPOPULATE = register(
    "spark.tpu.mview.serveRepopulate", True,
    "After a view refresh, put the refreshed Arrow result into the "
    "serve tier's result cache under the new fingerprint key, so "
    "readers keep hitting across updates.", bool)


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
