"""The mesh executor: distributed planning and stage execution (the port
of ``spark_tpu/parallel/executor.py``).

The reference's control stack for a query (DAGScheduler stages, task
offers, launch RPCs, shuffle fetches; DAGScheduler.scala:1355) becomes:
cut the plan at join boundaries, run each cut as one stage, the stages
in dependency order. A stage runs one thread per rank, each on its
rank's device, in a copy of the caller's context
(``contextvars.copy_context``: the engine's context variables, such as
the stats-recording switch, cross into the ranks); the exchanges inside
it are collectives on a ``ThreadComm`` of its own. A rank that raises
aborts the collectives, the others stop, and the stage re-raises the
first failure in the caller; no thread outlives its stage.

On a mesh that spans processes (``multihost``: k ranks a process) each
process runs the same program and, for each stage, only its own ranks,
one thread each (one rank: the calling thread), on a
``ProcessThreadComm``: a barrier between the threads, one ``DistComm``
call a collective between the processes. Every host decision (a
compaction, the fused overflow sentinel, the stats stages, an
aggregation strategy, the broadcast switch, join counts, key ranges,
hot keys) reads values gathered from every rank
(``ShardedBatch.rank_values``), so every process decides alike and
issues the same collectives; a stage's end gathers every rank's
capacity and a digest of its dictionaries.

Mesh stages run eagerly under ``stats_recording_disabled``: they bind
and record no runtime statistics and capture no CUDA graph (a capture
while another thread launches on the same device fails).

Join sizing follows the reference's AQE pattern (reference:
adaptive/AdaptiveSparkPlanExec.scala:247): a stage of the key
projections gives the key ranges and unified dictionaries, a count
stage sizes the pair capacity, then the join stage runs.

Adaptive execution (``spark.tpu.adaptive.enabled``, the reference's AQE
over the mesh, ``executor.py:560-1455`` there): every hash, range and
round-robin exchange is cut out of its stage, its producer run and
measured by an ``ExchangeStatsExec`` stage, and the exchange run at the
measured, bucket-rounded capacities; a skewed destination of an exactly
re-mergeable aggregate fans into a pre-merge; a partial->final aggregate
picks its strategy (partial, bypass, hash, sort, presplit) from one
extended stats stage; a join's broadcast decision takes the build
side's measured bytes. Whole-query fusion (``spark.tpu.fusion.enabled``)
runs every exchange whose only adaptive decision is its capacity as a
``FusedSpanExec`` inside one rank stage. Every decision is listed in
``last_run["events"]`` and recorded in the event log (``metrics.py``)
under the reference's kinds and fields.

Observability and faults (the reference's seams): each rank stage runs in
a ``stage.run`` span and records a ``stage`` and a ``stage_bytes`` event;
with a sampled trace, each rank's share of a stage runs in a
``stage.device`` span closed by a sync of the rank's device (ranks that
share one card share its stream, so a rank's span also covers the other
ranks' queued work: it bounds the stage's device time, it is not a
per-rank device time). The stats stages run in ``exchange.stats`` and
``agg.decide`` spans, the sort and pre-split rungs in ``agg.sort`` and
``agg.presplit``, a fused plan in ``stage.fused``. The fault points
``agg.strategy`` and ``agg.presplit`` (any kind degrades the aggregate to
the static partial->final strategy) and ``fusion.decide`` (any kind
degrades to staged execution) sit at the decisions; ``exchange.all_to_all``
sits in ``exchange.exchange``.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
import threading
import time
import weakref
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from spark_tpu_torch import locks
from spark_tpu_torch import conf as CF
from spark_tpu_torch import faults, metrics, trace
from spark_tpu_torch import types as T
from spark_tpu_torch.columnar.batch import Batch
from spark_tpu_torch.expr import compiler as C
from spark_tpu_torch.expr import expressions as E
from spark_tpu_torch.parallel import exchange as X
from spark_tpu_torch.parallel import operators as D
from spark_tpu_torch.parallel.mesh import Mesh, mesh_size
from spark_tpu_torch.parallel.sharded import ShardedBatch
from spark_tpu_torch.physical import kernels as K
from spark_tpu_torch.physical import operators as P
from spark_tpu_torch.physical.operators import Pipe
from spark_tpu_torch.plan import logical as L
from spark_tpu_torch.sketch import hll_estimate
from spark_tpu_torch.types import Schema

BROADCAST_THRESHOLD = CF.register(
    "spark.sql.autoBroadcastJoinThreshold", 8 * 1024 * 1024,
    "Max estimated build-side bytes (capacity times row width) for a "
    "broadcast join on a mesh (reference: SQLConf "
    "AUTO_BROADCASTJOIN_THRESHOLD).", int)

SKEW_FACTOR = CF.register(
    "spark.tpu.skewJoin.factor", 5,
    "A mesh join whose hottest rank counts more than this many times the "
    "median rank's pairs after the hash exchange is re-planned as a "
    "broadcast join over the balanced rows before the exchange "
    "(reference: SKEW_JOIN_SKEWED_PARTITION_FACTOR).", int)

SKEW_MIN_PAIRS = CF.register(
    "spark.tpu.skewJoin.minPairs", 1 << 16,
    "Absolute floor for the skew re-plan: the hottest rank must exceed "
    "this many pairs.", int)

SKEW_MAX_BROADCAST_BYTES = CF.register(
    "spark.tpu.skewJoin.maxBroadcastBytes", 256 * 1024 * 1024,
    "The skew re-plan broadcasts the build side only below this many "
    "estimated bytes; above it the join splits around the hot keys.", int)

#: the adaptive and fusion settings (registered in ``conf.py``)
ADAPTIVE_ENABLED = CF.ADAPTIVE_ENABLED
FUSION_ENABLED = CF.FUSION_ENABLED

#: the OOM ladder's rung 0 (``recovery.py``): a mesh run that ran out of
#: memory with adaptive execution off retries once with it forced on.
#: A context variable, not a setting, so the retry does not leak into
#: other queries of the session.
FORCE_ADAPTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "spark_tpu_torch_force_adaptive", default=False)

#: the exchanges adaptive execution cuts out of their stage (broadcast and
#: single-partition exchanges gather, with no routed buffer to size)
_ADAPTIVE_EXCHANGES = (D.HashPartitionExchangeExec,
                       D.RoundRobinExchangeExec,
                       D.RangeExchangeExec)

#: stage inputs at most this many rows per rank are never compacted
_COMPACT_MIN_CAPACITY = 4096


def _row_width(schema: Schema) -> int:
    """Device bytes per row (data and validity) from the schema."""
    width = 0
    for f in schema.fields:
        try:
            width += C._torch_dtype(f.dtype).itemsize
        except Exception:
            width += 8
        if f.nullable:
            width += 1
    return width


def _estimated_bytes(sb: ShardedBatch) -> int:
    """A join build side's estimated device bytes: total capacity times
    row width (the reference's size estimate)."""
    return int(sb.capacity) * _row_width(sb.schema)


def _decode_key_value(raw, field):
    """A device key value as the Python literal of its type (the host side
    of the hot-key probe)."""
    if field.dictionary is not None:
        code = int(raw)
        return (field.dictionary[code]
                if 0 <= code < len(field.dictionary) else None)
    if isinstance(field.dtype, T.DateType):
        return T.days_to_date(int(raw))
    if isinstance(field.dtype, T.DecimalType):
        import decimal

        return decimal.Decimal(int(raw)).scaleb(-field.dtype.scale)
    return raw.item() if hasattr(raw, "item") else raw


def _key_raw(bits: int, field):
    """A key value from its gathered int64 (``_detect_hot_keys``): a
    float from its bits, a boolean, else the integer."""
    if isinstance(field.dtype, (T.Float32Type, T.Float64Type)):
        return float(np.array(bits, dtype=np.int64).view(np.float64))
    if isinstance(field.dtype, T.BooleanType):
        return bool(bits)
    return int(bits)


def _dictionary_digest(field) -> int:
    """A field's string dictionary as one int64 (0 without one), equal
    across processes when the dictionaries are."""
    if field.dictionary is None:
        return 0
    import hashlib

    h = hashlib.blake2b(repr(field.dictionary).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little", signed=True)


def _hot_key_pred(keys, fields, hot) -> E.Expression:
    """OR over the hot candidates of AND(key == literal), each literal of
    its key's type (``fields``: the probe keys' fields): a timestamp's
    integer or a decimal's value has no inferred type of its own."""
    ors = None
    for vals in hot:
        ands = None
        for k, f, v in zip(keys, fields, vals):
            c = E.Cmp("==", k, E.Literal(v, f.dtype))
            ands = c if ands is None else E.And(ands, c)
        ors = ands if ors is None else E.Or(ors, ands)
    return ors


def _null_any(keys) -> E.Expression:
    out = None
    for k in keys:
        c = E.IsNull(k)
        out = c if out is None else E.Or(out, c)
    return out


def _exchange_op(ex: P.PhysicalPlan) -> str:
    return getattr(ex, "op", type(ex).__name__)


def _exactly_remergeable(consumer: "D.DistSortAggExec",
                         schema: Schema) -> bool:
    """Whether the consumer's aggregate list re-applies to its own output
    byte-identically: the skew fan's pre-merge precondition
    (``analysis/legality.py``)."""
    from spark_tpu_torch.analysis import legality

    return bool(legality.remerge_verdict_cols(consumer.aggregates, schema))


def _project_sorted_by(sorted_by, exprs):
    """A ``sorted_by`` guarantee through a row-wise projection: every
    ordered column must survive as a bare Col (or an alias of one) under
    its projected name, else the guarantee is dropped."""
    if not sorted_by:
        return None
    out = []
    for name, asc, nf in sorted_by:
        for e in exprs:
            c = E.strip_alias(e)
            if isinstance(c, E.Col) and c.col_name == name:
                out.append((e.name, asc, nf))
                break
        else:
            return None
    return tuple(out)


def _sorted_by_satisfies(sorted_by, orders) -> bool:
    """Whether a batch's ``sorted_by`` makes a global sort by ``orders`` a
    no-op: an exact pairwise match over the whole tuple (bare Col orders,
    the same direction and null placement), so on unique-key aggregate
    output no tie is left to break differently."""
    if not sorted_by or len(orders) != len(sorted_by):
        return False
    for o, (name, asc, nf) in zip(orders, sorted_by):
        c = E.strip_alias(o.child)
        if not (isinstance(c, E.Col) and c.col_name == name):
            return False
        if bool(o.ascending) != bool(asc) \
                or bool(o.nulls_first_resolved) != bool(nf):
            return False
    return True


class _FusionOverflow(Exception):
    """A speculative fused output cut off live rows (its sentinel slot is
    set): the result is discarded and the staged path runs."""


class _FusionBailout(Exception):
    """A fusion attempt met a decision that needs the host; ``reason`` is
    the reference's typed bailout reason."""

    def __init__(self, reason: str, detail: str = ""):
        self.reason = reason
        self.detail = detail
        super().__init__(reason)


def _collect_fused(plan: P.PhysicalPlan,
                   out: List["D.FusedSpanExec"]) -> None:
    if isinstance(plan, D.FusedSpanExec):
        out.append(plan)
        for t in plan.tail:  # merged chains nest further pairs here
            if isinstance(t, D.FusedSpanExec):
                out.append(t)
    for c in plan.children():
        _collect_fused(c, out)


def _walk_plan(plan: P.PhysicalPlan):
    yield plan
    for c in plan.children():
        yield from _walk_plan(c)


def _has_blocking(plan: P.PhysicalPlan) -> bool:
    return any(p.has_blocking_exprs() for p in _walk_plan(plan))


@dataclass(eq=False)
class _CompactExec(P.PhysicalPlan):
    """Shrink a rank's capacity to a host-chosen size, live rows first in
    their order (the reference's pressure valve between stages,
    CoalesceShufflePartitions). ``sliced``: every live row already lies
    within the first ``new_capacity`` slots (exchange and fused outputs
    are front-compacted), so a plain cut replaces the stable gather."""

    new_capacity: int
    child: P.PhysicalPlan
    sliced: bool = False

    def children(self):
        return (self.child,)

    @property
    def schema(self) -> Schema:
        return self.child.schema

    def execute(self, child_pipes: List[Pipe]) -> Pipe:
        pipe = child_pipes[0]
        if self.sliced:
            return D._slice_pipe(pipe, self.new_capacity)
        return X.compact(pipe, self.new_capacity)

    def _key(self):
        return ("Compact", self.new_capacity, self.sliced,
                self.child.plan_key())


def _run_tree(plan: P.PhysicalPlan) -> Pipe:
    """One rank's view of a stage: every node eagerly, children first."""
    return plan.execute_blocking([_run_tree(c) for c in plan.children()])


def run_rank(plan: P.PhysicalPlan, rank: int, comm: X.Comm,
             device) -> Batch:
    """Rank ``rank``'s part of a mesh stage, in the calling thread: its
    shard through ``plan``, eagerly, its collectives on ``comm`` (a
    ``ThreadComm`` in a stage's thread; a ``ProcessThreadComm`` on a
    mesh that spans processes). No runtime statistics are recorded."""
    dev = torch.device(device)
    with X.on_rank(rank, comm, dev), P.stats_recording_disabled(), \
            (torch.cuda.device(dev) if dev.type == "cuda"
             else contextlib.nullcontext()):
        return _run_tree(plan).to_batch()


def _check_stage(plan: P.PhysicalPlan) -> None:
    if isinstance(plan, D.DistJoinBoundary):
        raise AssertionError("a join boundary inside a stage")
    if plan.has_blocking_exprs():
        raise NotImplementedError(
            "plan contains host-only (arrow UDF) expressions, which a mesh "
            "stage does not run; run on one device or use a tensor UDF:\n"
            + plan.tree_string())
    for c in plan.children():
        _check_stage(c)


class MeshExecutor:
    """Plans and runs logical plans over a mesh (``parallel/mesh.py``).

    ``last_run`` (a dict) says what the newest ``execute_logical`` did:

    - ``stages``: each rank stage, its node, wall and per-rank wall ms;
      ``rank_stages``: how many ran;
    - ``exchanges``: every exchange's live rows, rows moved to another
      rank, their bytes and its capacities in and out;
    - ``host_reads``: reads of device values on the host, by the executor
      and the collectives (one per read all ranks make);
    - ``gather_ms``: the result's gather (``ShardedBatch.to_batch``);
      ``staged_bytes``: across processes over gloo, the bytes the
      collectives copied between the card and the host;
    - ``events``: every decision, as the reference's metrics events
      (``kind`` ``aqe``: ``decision`` broadcast_join / exchange_join with
      ``measured_bytes``, ``static_bytes`` and ``threshold``, skew_split
      with ``hot``, sort_elide; ``agg``: ``strategy``, ``mode``, ``ndv``,
      ``rows``, ``ratio``, ``domain``, ``hot_keys``; ``fusion`` and
      ``fusion_bailout`` with its ``reason``; ``exchange`` with ``mode``
      adaptive, ``capacity_before``/``capacity_after`` and
      ``buffer_bytes``; the skew join's re-plans). The same dicts go to
      the event log (``metrics.record``; an exchange through
      ``metrics.record_exchange``), stamped with the query's trace."""

    def __init__(self, mesh: Mesh, conf=None):
        self.mesh = mesh
        self.d = mesh_size(mesh)
        self.conf = conf if conf is not None else CF.RuntimeConf()
        self.last_run: dict = {}
        self._stats: Optional[dict] = None
        self._relation_cache = weakref.WeakKeyDictionary()

    # ---- public entry point -------------------------------------------------

    def execute_logical(self, plan: L.LogicalPlan,
                        optimize: bool = True) -> Batch:
        """Optimize (under this executor's settings), plan and run
        ``plan``; the result's shards concatenated on rank 0's device
        (across processes: every rank's live rows, in every process, on
        its first rank's device)."""
        from spark_tpu_torch.plan.optimizer import optimize as opt

        lp = opt(plan, self.conf) if optimize else plan
        self._stats = {"stages": [], "exchanges": [], "events": [],
                       "host_reads": 0, "staged_bytes": 0}
        comm = self.mesh.comm
        staged = comm.staged_bytes if comm is not None else 0
        t0 = time.perf_counter()
        try:
            sb = self.run(self.plan(lp))
            t1 = time.perf_counter()
            out = sb.to_batch()
            self._stats["gather_ms"] = (time.perf_counter() - t1) * 1e3
        finally:
            if comm is not None:  # host decisions' and the result's
                self._stats["staged_bytes"] += comm.staged_bytes - staged
            stats, self._stats = self._stats, None
            stats["wall_ms"] = (time.perf_counter() - t0) * 1e3
            stats["rank_stages"] = len(stats["stages"])
            self.last_run = stats
        return out

    # ---- logical -> distributed physical ------------------------------------

    def plan(self, plan: L.LogicalPlan) -> P.PhysicalPlan:
        d = self.d
        if isinstance(plan, L.Relation):
            return D.ShardScanExec(self._shard_relation(plan.batch))
        if isinstance(plan, L.UnresolvedScan):
            return D.ShardScanExec(self._shard_relation(
                plan.source.read(plan.columns, plan.filters,
                                 self.mesh.home_device)))
        if isinstance(plan, L.Range):
            n = plan.num_rows
            p = K.bucket(math.ceil(max(1, n) / d), 128)
            return D.DistRangeExec(plan.start, plan.end, plan.step, n, p,
                                   plan.col_name)
        if isinstance(plan, L.Project):
            return P.ProjectExec(plan.exprs, self.plan(plan.child))
        if isinstance(plan, L.Filter):
            return P.FilterExec(plan.condition, self.plan(plan.child))
        if isinstance(plan, L.Sample):
            return D.DistSampleExec(plan.fraction, plan.seed,
                                    self.plan(plan.child))
        if isinstance(plan, L.Aggregate):
            return self._plan_aggregate(plan.groupings, plan.aggregates,
                                        self.plan(plan.child))
        if isinstance(plan, L.Distinct):
            cols = tuple(E.Col(n) for n in plan.schema.names)
            return self._plan_aggregate(cols, cols, self.plan(plan.child))
        if isinstance(plan, L.Sort):
            return P.SortExec(plan.orders, D.RangeExchangeExec(
                plan.orders, self.plan(plan.child)))
        if isinstance(plan, L.Limit):
            return D.DistLimitExec(plan.n, plan.offset, self.plan(plan.child))
        if isinstance(plan, L.SubqueryAlias):
            return self.plan(plan.child)
        if isinstance(plan, L.Repartition):
            child = self.plan(plan.child)
            if plan.keys:
                return D.HashPartitionExchangeExec(plan.keys, child)
            return D.RoundRobinExchangeExec(child)
        if isinstance(plan, L.Union):
            return P.UnionExec(self.plan(plan.left), self.plan(plan.right))
        if isinstance(plan, L.Join):
            lkeys, rkeys = P.coerce_join_keys(
                plan.left_keys, plan.right_keys, plan.left.schema,
                plan.right.schema)
            return D.DistJoinBoundary(self.plan(plan.left),
                                      self.plan(plan.right), plan.how,
                                      lkeys, rkeys, plan.condition)
        if isinstance(plan, L.Expand):
            # row-local: each rank expands its own rows
            return P.ExpandExec(plan.projections, plan.names,
                                self.plan(plan.child))
        if isinstance(plan, L.Generate):
            return P.GenerateExec(plan.generator, plan.out_name,
                                  plan.pos_name, self.plan(plan.child))
        if isinstance(plan, L.Window):
            return self._plan_window(plan)
        raise NotImplementedError(
            f"no distributed plan for {type(plan).__name__}")

    def _plan_window(self, plan: L.Window) -> P.PhysicalPlan:
        """Hash-exchange on each partition key set, so every partition is
        whole on one rank, then the local window operator; different key
        sets chain (reference: WindowExec.scala:87
        ClusteredDistribution; EnsureRequirements inserts the same
        shuffles)."""
        from spark_tpu_torch.physical.window import WindowExec

        groups: list = []  # (frozen key set, keys, [exprs])
        for e in plan.window_exprs:
            keys = E.strip_alias(e).partition_by
            fs = frozenset(E.expr_key(k) for k in keys)
            for g in groups:
                if g[0] == fs:
                    g[2].append(e)
                    break
            else:
                groups.append((fs, keys, [e]))
        cur = self.plan(plan.child)
        for _, keys, exprs in groups:
            ex = (D.HashPartitionExchangeExec(tuple(keys), cur) if keys
                  else D.SinglePartitionExchangeExec(cur))
            cur = WindowExec(tuple(exprs), ex)
        if len(groups) > 1:
            # window columns were appended per chained stage
            cur = P.ProjectExec(tuple(E.Col(n) for n in plan.schema.names),
                                cur)
        return cur

    def _plan_aggregate(self, groupings, aggregates,
                        child: P.PhysicalPlan) -> P.PhysicalPlan:
        _, agg_calls = P.rewrite_agg_outputs(groupings, aggregates)
        distinct_aggs = [a for a in agg_calls
                         if getattr(a, "distinct", False)]
        if distinct_aggs and not groupings:
            # global DISTINCT: exchange on the distinct child so each
            # value lives on one rank, then psum the deduplicated partials
            # (reference: RewriteDistinctAggregates.scala:1)
            key_sets = {tuple(E.expr_key(c) for c in a.children())
                        for a in distinct_aggs}
            if len(key_sets) > 1:
                return self._plan_multi_distinct(groupings, aggregates,
                                                 agg_calls, child)
            ex = D.HashPartitionExchangeExec(
                tuple(distinct_aggs[0].children()), child)
            return D.PSumAggExec(groupings, aggregates, ex)
        probe = P.HashAggregateExec(groupings, aggregates, child)
        if not distinct_aggs and (probe._static_direct_ok() or not groupings):
            return D.PSumAggExec(groupings, aggregates, child)
        if not distinct_aggs:
            # map-side combine (reference: AggUtils partial/final): a
            # partial aggregate before the exchange sends one row per key
            # and rank instead of the whole table
            from spark_tpu_torch.plan.incremental import AggSpec

            try:
                spec = AggSpec(tuple(groupings), tuple(aggregates))
            except NotImplementedError:
                spec = None
            if spec is not None:
                key_aliases = tuple(E.Alias(g, n) for g, n in zip(
                    spec.groupings_exec, spec.key_names))
                partial = D.DistSortAggExec(
                    tuple(spec.groupings_exec),
                    key_aliases + tuple(spec.partials), child,
                    phase="partial")
                key_cols = tuple(E.Col(n) for n in spec.key_names)
                ex = D.HashPartitionExchangeExec(key_cols, partial)
                final = D.DistSortAggExec(
                    key_cols,
                    tuple(E.Alias(E.Col(n), n) for n in spec.key_names)
                    + tuple(spec.merges), ex)
                return P.ProjectExec(tuple(spec.outputs), final)
        # whole groups (and for DISTINCT all their values) on one rank
        ex = D.HashPartitionExchangeExec(tuple(groupings), child)
        return D.DistSortAggExec(groupings, aggregates, ex)

    def _plan_multi_distinct(self, groupings, aggregates, agg_calls,
                             child: P.PhysicalPlan) -> P.PhysicalPlan:
        """A global aggregate with DISTINCT aggregates over different
        columns: one exchange and psum sub-aggregate per distinct child
        set, their one-row results cross-joined, the outputs projected
        (reference: RewriteDistinctAggregates.scala:1)."""
        outputs, _ = P.rewrite_agg_outputs(groupings, aggregates)
        buckets: dict = {}
        for i, call in enumerate(agg_calls):
            k = (tuple(E.expr_key(c) for c in call.children())
                 if getattr(call, "distinct", False) else None)
            buckets.setdefault(k, []).append((i, call))
        sub_plans = []
        for k, items in buckets.items():
            aliases = tuple(E.Alias(call, f"__agg{i}") for i, call in items)
            if k is None:
                sub_plans.append(D.PSumAggExec((), aliases, child))
            else:
                ex = D.HashPartitionExchangeExec(
                    tuple(items[0][1].children()), child)
                sub_plans.append(D.PSumAggExec((), aliases, ex))
        combined = sub_plans[0]
        for sp in sub_plans[1:]:
            combined = D.DistJoinBoundary(combined, sp, "cross", (), (), None)
        return P.ProjectExec(tuple(outputs), combined)

    def _shard_relation(self, batch) -> ShardedBatch:
        if isinstance(batch, ShardedBatch):
            return batch  # placed already (multihost.sharded_batch_from_local)
        sb = self._relation_cache.get(batch)
        if sb is None:
            sb = ShardedBatch.from_batch(batch, self.mesh)
            self._relation_cache[batch] = sb
        return sb

    # ---- execution ----------------------------------------------------------

    def run(self, plan: P.PhysicalPlan) -> ShardedBatch:
        plan = self._materialize_boundaries(plan)
        if self._adaptive_enabled():
            if self._fusion_enabled():
                fused = self._try_fuse(plan)
                if fused is not None:
                    sb = self._run_fused(*fused)
                    if sb is not None:
                        return sb
                    # the speculative output overflowed: run staged
            plan = self._materialize_exchanges(plan)
        if isinstance(plan, D.ShardScanExec):
            return plan.sharded
        return self._run_stage(plan)

    def _adaptive_enabled(self) -> bool:
        return bool(FORCE_ADAPTIVE.get()) \
            or bool(self.conf.get(ADAPTIVE_ENABLED))

    def _fusion_enabled(self) -> bool:
        return bool(self.conf.get(FUSION_ENABLED))

    def _note(self, kind: str, **fields) -> None:
        """Record one decision in ``last_run["events"]`` and in the event
        log (an ``exchange`` through ``metrics.record_exchange``, which
        also sets the ``exchange.*`` gauges)."""
        if self._stats is not None:
            self._stats["events"].append(dict(kind=kind, **fields))
        if kind == "exchange":
            metrics.record_exchange(**fields)
        else:
            metrics.record(kind, **fields)

    def _host_read(self, n: int = 1) -> None:
        if self._stats is not None:
            self._stats["host_reads"] += n

    # ---- whole-query fusion -------------------------------------------------

    def _try_fuse(self, plan: P.PhysicalPlan):
        """When every adaptive exchange in ``plan`` pairs with a consumer
        whose only host decision is its capacity, rewrite the pairs into
        FusedSpanExec nodes, so the plan runs as one rank stage with no
        stats stage. Returns (plan, spans) or None: None takes the staged
        path, with a typed ``fusion_bailout`` event wherever a decision
        needed the host."""
        if _has_blocking(plan):
            return None  # both paths refuse it; let the staged one raise
        if not any(isinstance(p, _ADAPTIVE_EXCHANGES)
                   for p in _walk_plan(plan)):
            return None  # nothing to fuse, nothing to bail out of
        if FORCE_ADAPTIVE.get():
            # the OOM retry wants the staged path's measured capacities
            self._fusion_bailout("oom_ladder",
                                 "FORCE_ADAPTIVE retry in flight")
            return None
        try:
            fused, n_spans = self._fuse_rewrite(plan)
        except _FusionBailout as b:
            self._fusion_bailout(b.reason, b.detail)
            return None
        if isinstance(fused, D.FusedSpanExec):
            # the root span: nothing above reads its sentinel slot, so
            # its output may be cut to the ladder's anchor
            fused = dataclasses.replace(fused, speculate=True)
        try:
            # fault point: the plan is judged fusible, the span not yet
            # run; any kind degrades to staged execution (the staged
            # path computes the same rows)
            faults.inject("fusion.decide", self.conf)
        except faults.InjectedFault as e:
            metrics.note_fusion("fault_fallbacks")
            metrics.record("fault_recovered", point="fusion.decide",
                           fault=e.kind, action="staged")
            self._fusion_bailout("fault_injected", e.kind)
            return None
        return fused, n_spans

    def _fuse_rewrite(self, plan: P.PhysicalPlan):
        """Rewrite adaptive exchange and consumer pairs into fused spans;
        raises _FusionBailout at the first decision that needs the host.
        A bare adaptive exchange (no consumer a span takes) stays inline
        at its unmeasured capacity. Mirrors ``_materialize_exchanges``'s
        pairs, so a plan fuses exactly when the staged path would make
        only capacity decisions for it."""
        from spark_tpu_torch.analysis import legality

        bucket = max(1, int(self.conf.get(CF.ADAPTIVE_CAPACITY_BUCKET)))
        variants = max(1, int(self.conf.get(CF.FUSION_MAX_BUCKET_VARIANTS)))
        spans = [0]

        def pair(consumer: P.PhysicalPlan,
                 ex: P.PhysicalPlan) -> "D.FusedSpanExec":
            producer = rewrite(ex.child)
            new_ex = dataclasses.replace(ex, child=producer)
            spans[0] += 1
            span = D.FusedSpanExec(
                consumer=dataclasses.replace(consumer, child=new_ex),
                exchange=new_ex, bucket=bucket, variants=variants)
            # a chain: when the producer is another span reached through
            # row-preserving operators only, this pair joins that span's
            # tail, and the chain stays one span
            inters: List[P.PhysicalPlan] = []
            node = producer
            while isinstance(node, (P.ProjectExec, P.FilterExec)):
                inters.append(node)
                node = node.child
            if isinstance(node, D.FusedSpanExec):
                return dataclasses.replace(
                    node, tail=node.tail + tuple(reversed(inters))
                    + (span,))
            return span

        def rewrite(p: P.PhysicalPlan) -> P.PhysicalPlan:
            if (isinstance(p, D.DistSortAggExec)
                    and isinstance(p.child, D.HashPartitionExchangeExec)):
                ex = p.child
                if (isinstance(ex.child, D.DistSortAggExec)
                        and ex.child.phase == "partial"
                        and ex.child.groupings
                        and self._agg_adaptive_enabled()
                        and legality.strategy_verdict(
                            ex.child.aggregates,
                            ex.child.child.schema).ok):
                    # a legal strategy crossover needs the sketches on
                    # the host; a pinned pair (float partials) has only
                    # its capacity left and fuses
                    raise _FusionBailout(
                        "agg_strategy",
                        "strategy crossover needs the host sketch fetch")
                if self.d > 1 and _exactly_remergeable(p, ex.child.schema):
                    raise _FusionBailout(
                        "skew_presplit",
                        "re-mergeable consumer: destination skew fan "
                        "is a host decision")
                return pair(p, ex)
            if (isinstance(p, P.SortExec)
                    and isinstance(p.child, D.RangeExchangeExec)):
                ex = p.child
                sorted_by = None
                if isinstance(ex.child, D.ShardScanExec):
                    sorted_by = ex.child.sharded.sorted_by
                elif (isinstance(ex.child, P.ProjectExec)
                        and isinstance(ex.child.child, D.ShardScanExec)):
                    sorted_by = _project_sorted_by(
                        ex.child.child.sharded.sorted_by, ex.child.exprs)
                if sorted_by and _sorted_by_satisfies(sorted_by, p.orders):
                    raise _FusionBailout(
                        "sort_elide",
                        "producer order guarantee elides the sort")
                return pair(p, ex)
            fields = {}
            changed = False
            for f in dataclasses.fields(p):
                v = getattr(p, f.name)
                if isinstance(v, P.PhysicalPlan):
                    nv = rewrite(v)
                    changed |= nv is not v
                    fields[f.name] = nv
                else:
                    fields[f.name] = v
            if isinstance(p, _ADAPTIVE_EXCHANGES):
                spans[0] += 1  # a bare exchange, kept inline
            return dataclasses.replace(p, **fields) if changed else p

        return rewrite(plan), spans[0]

    def _fusion_bailout(self, reason: str, detail: str = "") -> None:
        metrics.note_fusion("bailouts")
        self._note("fusion_bailout", reason=reason, detail=detail)

    def _run_fused(self, plan: P.PhysicalPlan,
                   n_spans: int) -> Optional[ShardedBatch]:
        try:
            with trace.span("stage.fused", spans=n_spans, devices=self.d):
                sb = self._run_stage(plan)
        except _FusionOverflow:
            self._fusion_bailout(
                "overflow", "live rows past the speculative output "
                "capacity; staged re-run")
            return None
        metrics.note_fusion("fused_programs")
        metrics.note_fusion("fused_spans", n_spans)
        self._note("fusion", spans=n_spans, devices=self.d,
                   capacity=sb.per_device_capacity)
        metrics.set_gauge("fusion.last_spans", n_spans)
        metrics.set_gauge("fusion.last_devices", self.d)
        return sb

    # ---- adaptive execution (AQE over the mesh) -----------------------------

    def _materialize_exchanges(self, plan: P.PhysicalPlan
                               ) -> P.PhysicalPlan:
        """The AdaptiveSparkPlanExec loop (reference:
        adaptive/AdaptiveSparkPlanExec.scala:247 createQueryStages): cut
        the plan at hash, range and round-robin exchanges, run each
        producer as its own stage, measure it (ExchangeStatsExec), run the
        exchange at the measured capacities and splice the result back as
        a ShardScan leaf. A final-merge aggregate on its exchange is taken
        as a pair: there a skewed destination can fan into a pre-merge,
        and a partial->final pair picks its strategy."""
        if (isinstance(plan, D.DistSortAggExec)
                and isinstance(plan.child, D.HashPartitionExchangeExec)):
            if (isinstance(plan.child.child, D.DistSortAggExec)
                    and plan.child.child.phase == "partial"
                    and plan.child.child.groupings
                    and self._agg_adaptive_enabled()):
                return self._adaptive_aggregate(
                    final=plan, ex=plan.child, partial=plan.child.child)
            sb = self._run_adaptive_exchange(plan.child, consumer=plan)
            return dataclasses.replace(plan, child=D.ShardScanExec(sb))
        if (isinstance(plan, P.SortExec)
                and isinstance(plan.child, D.RangeExchangeExec)):
            # a global sort is a local sort over a range exchange; when
            # the producer already carries the exact total order, the
            # whole Sort stage is skipped
            sb = self._run_adaptive_exchange(plan.child)
            if _sorted_by_satisfies(sb.sorted_by, plan.orders):
                return D.ShardScanExec(sb)
            return dataclasses.replace(plan, child=D.ShardScanExec(sb))
        if isinstance(plan, _ADAPTIVE_EXCHANGES):
            return D.ShardScanExec(self._run_adaptive_exchange(plan))
        fields = {}
        changed = False
        for f in dataclasses.fields(plan):
            v = getattr(plan, f.name)
            if isinstance(v, P.PhysicalPlan):
                nv = self._materialize_exchanges(v)
                changed |= nv is not v
                v = nv
            fields[f.name] = v
        return dataclasses.replace(plan, **fields) if changed else plan

    def _run_adaptive_exchange(self, ex: P.PhysicalPlan,
                               consumer=None) -> ShardedBatch:
        """The producer of one exchange as its own stage, then the
        exchange at measured capacities; a range exchange whose producer
        already carries a ``sorted_by`` that satisfies its orders (the
        sort rung's key-ordered output) passes the batch through."""
        child = self._materialize_exchanges(ex.child)
        child_sb = self._producer_batch(child)
        if (isinstance(ex, D.RangeExchangeExec)
                and _sorted_by_satisfies(child_sb.sorted_by, ex.orders)):
            self._note("aqe", decision="sort_elide", op="range",
                       orders=tuple(s[0] for s in child_sb.sorted_by))
            metrics.note_agg("sort_elided")
            return child_sb
        return self._exchange_with_stats(ex, child_sb, consumer=consumer)

    def _producer_batch(self, child: P.PhysicalPlan) -> ShardedBatch:
        """A materialized producer plan as a ShardedBatch, carrying a
        ``sorted_by`` guarantee through a row-wise projection of an
        ordered scan (a projection keeps row order)."""
        if isinstance(child, D.ShardScanExec):
            return child.sharded
        sorted_by = None
        if (isinstance(child, P.ProjectExec)
                and isinstance(child.child, D.ShardScanExec)):
            sorted_by = _project_sorted_by(child.child.sharded.sorted_by,
                                           child.exprs)
        sb = self.run(child)
        if sorted_by:
            sb.sorted_by = sorted_by
        return sb

    def _read_stats(self, stats_sb: ShardedBatch, widths) -> list:
        """The stats stage's columns, each cut to its width, in one host
        read. They are reductions over every rank, combined in rank
        order, so each rank's copy is the same bit for bit: this
        process's first rank's is read (rank 0's lives in process 0
        only; the others of this process hold the same values)."""
        cols = stats_sb.shards[self.mesh.local_ranks[0]].columns
        flat = torch.cat([cols[i].data[:w] for i, w in enumerate(widths)])
        values = flat.tolist()
        self._host_read()
        out, at = [], 0
        for w in widths:
            out.append(np.asarray(values[at:at + w], dtype=np.int64))
            at += w
        return out

    def _measured_capacities(self, incoming, maxslice,
                             child_sb: ShardedBatch) -> Tuple[int, int]:
        bucket = max(1, int(self.conf.get(CF.ADAPTIVE_CAPACITY_BUCKET)))
        max_in = int(incoming.max()) if incoming.size else 0
        max_sl = int(maxslice.max()) if maxslice.size else 0
        out_cap = K.bucket(max(1, max_in), bucket)
        slice_cap = min(child_sb.per_device_capacity,
                        K.bucket(max(1, max_sl), min(bucket, 128)))
        return slice_cap, out_cap

    def _run_measured(self, ex: P.PhysicalPlan, child_sb: ShardedBatch,
                      incoming, maxslice) -> ShardedBatch:
        """The exchange at the measured capacities, recorded as the
        reference's adaptive exchange event."""
        slice_cap, out_cap = self._measured_capacities(incoming, maxslice,
                                                       child_sb)
        sb = self._run_stage(dataclasses.replace(
            ex, slice_capacity=slice_cap, out_capacity=out_cap))
        self._note("exchange", op=_exchange_op(ex), mode="adaptive",
                   devices=self.d, rows=int(incoming.sum()),
                   capacity_before=self.d * child_sb.per_device_capacity,
                   capacity_after=sb.per_device_capacity,
                   slice_capacity=slice_cap,
                   buffer_bytes=self.d * slice_cap
                   * _row_width(child_sb.schema))
        return sb

    def _exchange_with_stats(self, ex: P.PhysicalPlan,
                             child_sb: ShardedBatch, consumer=None,
                             allow_skew: bool = True) -> ShardedBatch:
        d = self.d
        ex = dataclasses.replace(ex, child=D.ShardScanExec(child_sb))
        # one span per stats stage and its host read: the round trip
        # adaptive execution pays for measured capacities
        with trace.span("exchange.stats", op=_exchange_op(ex)):
            stats_sb = self._run_stage(D.ExchangeStatsExec(ex))
            incoming, maxslice = self._read_stats(stats_sb, (d, d))

        if (allow_skew and consumer is not None and d > 1
                and isinstance(ex, D.HashPartitionExchangeExec)
                and incoming.size):
            factor = int(self.conf.get(CF.ADAPTIVE_SKEW_FACTOR))
            min_rows = int(self.conf.get(CF.ADAPTIVE_SKEW_MIN_ROWS))
            med = float(np.median(incoming))
            hot = [int(j) for j in range(d)
                   if int(incoming[j]) >= min_rows
                   and float(incoming[j]) > factor * max(1.0, med)]
            if hot and _exactly_remergeable(consumer, child_sb.schema):
                self._note("aqe", decision="skew_split",
                           op=_exchange_op(ex), hot=tuple(hot),
                           max_incoming=int(incoming.max()), median=med,
                           factor=factor)
                # fan: hot destinations' rows stay on their (balanced)
                # source ranks, a pre-merge collapses them to one row per
                # rank and group, and only the merged groups take the
                # second exchange into the final merge
                fanned = dataclasses.replace(ex, fan_destinations=tuple(hot))
                fanned_sb = self._exchange_with_stats(
                    fanned, child_sb, consumer=None, allow_skew=False)
                pre_sb = self._run_stage(dataclasses.replace(
                    consumer, child=D.ShardScanExec(fanned_sb)))
                plain = dataclasses.replace(ex, fan_destinations=None)
                return self._exchange_with_stats(
                    plain, pre_sb, consumer=None, allow_skew=False)
        return self._run_measured(ex, child_sb, incoming, maxslice)

    # ---- runtime-adaptive aggregation ---------------------------------------

    def _agg_adaptive_enabled(self) -> bool:
        return bool(self.conf.get(CF.ADAPTIVE_AGG_ENABLED))

    #: the one HLL estimator (``sketch.py``), as the reference keeps it
    _hll_estimate = staticmethod(hll_estimate)

    def _adaptive_aggregate(self, final: "D.DistSortAggExec",
                            ex: "D.HashPartitionExchangeExec",
                            partial: "D.DistSortAggExec") -> P.PhysicalPlan:
        """The runtime strategy switch of a partial->final pair (the
        reference's ``_adaptive_aggregate``). One extended stats stage
        over the raw rows (the exchange bypass would run) measures the
        routing counts, an HLL sketch of the group keys, each key's
        global min/max/NULL count and a Count-Min heavy-hitter probe; the
        host then picks:

        - ``presplit``: a key whose Count-Min estimate alone overloads a
          rank, where the crossover chose a raw-row exchange (bypass or
          sort): its rows are salted over every rank before the exchange,
          partial-merged, and the balanced partials exchange into the
          final merge.
        - ``bypass``: NDV ~ rows over a bounded domain: the raw rows
          exchange by key straight into the partial node, which then is
          the final aggregate.
        - ``sort``: NDV ~ rows over a huge or unbounded domain: a range
          exchange on the group keys and one sorted merge per rank
          (DistRangeAggExec), key-ordered across the mesh.
        - ``hash``: a small measured domain: DistHashPartialAggExec over
          packed codes instead of the sort partial.
        - ``partial``: the static plan, the fallback and the baseline.

        Aggregates outside ``legality.strategy_verdict`` (float Sum/Avg
        partials, float Min/Max) pin to ``partial``; every legal strategy
        gives the static plan's bytes. An injected fault at
        ``agg.strategy`` (between the sketch read and the pick) or at
        ``agg.presplit`` (once presplit is picked), of any kind, drops
        the sketches' advice: ``partial``, mode ``fallback`` or
        ``presplit_fallback``, with a ``fault_recovered`` event."""
        from spark_tpu_torch.analysis import legality

        d = self.d
        child = self._materialize_exchanges(partial.child)
        child_sb = child.sharded if isinstance(child, D.ShardScanExec) \
            else self.run(child)
        raw_ex = D.HashPartitionExchangeExec(
            tuple(partial.groupings), D.ShardScanExec(child_sb))

        r = int(self.conf.get(CF.ADAPTIVE_AGG_SKETCH_REGISTERS))
        r = max(16, min(4096, r))
        if r & (r - 1):
            r = 1 << (r.bit_length() - 1)  # down to a power of two
        # per-key min/max only where every key range-compresses to int64
        # codes exactly (everything but floats)
        nk = len(partial.groupings)
        try:
            for g in partial.groupings:
                dt = legality._np_dtype(
                    E.strip_alias(g).data_type(partial.child.schema))
                if np.issubdtype(dt, np.floating):
                    nk = 0
                    break
        except Exception:
            nk = 0
        cmd = max(1, min(len(D._CM_SEEDS),
                         int(self.conf.get(CF.ADAPTIVE_AGG_CM_DEPTH))))
        cmw = max(64, min(1 << 16, int(self.conf.get(CF.ADAPTIVE_AGG_CM_WIDTH))))
        if cmw & (cmw - 1):
            cmw = 1 << (cmw.bit_length() - 1)
        use_cm = d > 1  # pre-splitting needs somewhere to spread to

        with trace.span("agg.decide", node=final.node_string()):
            stats_sb = self._run_stage(D.ExchangeStatsExec(
                raw_ex, sketch_registers=r, key_stats=nk,
                cm_depth=cmd if use_cm else 0,
                cm_width=cmw if use_cm else 0))
            widths = [d, d, r] + [nk] * (3 if nk else 0) + \
                [d, d] * int(use_cm)
            cols = self._read_stats(stats_sb, widths)
            incoming, maxslice = cols[0], cols[1]
            rows = int(incoming.sum())
            verdict = legality.strategy_verdict(partial.aggregates,
                                                partial.child.schema)
            forced = str(self.conf.get(CF.ADAPTIVE_AGG_STRATEGY)).lower()

            ndv = 0
            ratio = 0.0
            mins: Tuple[int, ...] = ()
            ranges: Tuple[int, ...] = ()
            domain = 0
            hot_hashes: Tuple[int, ...] = ()
            try:
                # fault point: everything the sketches feed the decision
                # is inside this block, so an injected failure of any
                # kind degrades to the static plan, the estimates dropped
                faults.inject("agg.strategy", self.conf)
                ndv = min(rows, int(round(self._hll_estimate(cols[2]))))
                ratio = (ndv / rows) if rows else 0.0
                ci = 3
                if nk and rows:
                    kmin, kmax = cols[ci], cols[ci + 1]
                    if bool(np.all(kmin <= kmax)):
                        mins = tuple(int(v) for v in kmin)
                        ranges = tuple(int(mx) - int(mn) + 1
                                       for mn, mx in zip(kmin, kmax))
                        domain = 1
                        for rg in ranges:
                            domain *= rg + 1  # and a NULL slot per key
                            if domain > (1 << 62):
                                domain = 1 << 62
                                break
                ci += 3 if nk else 0
                if use_cm and rows:
                    # hot: one key alone would overload a rank, its
                    # Count-Min estimate past the fair per-rank share
                    # times the factor (CM never under-counts, so a
                    # collision can only salt a cold key, which the
                    # partials' partition invariance makes free)
                    cut = max(
                        int(self.conf.get(CF.ADAPTIVE_AGG_PRESPLIT_MIN_ROWS)),
                        int(self.conf.get(CF.ADAPTIVE_AGG_PRESPLIT_FACTOR))
                        * max(1, rows // d))
                    hot_hashes = tuple(sorted({int(h) for h, e in zip(
                        cols[ci], cols[ci + 1]) if int(e) >= cut}))
                sketch_ok = True
            except faults.InjectedFault as e:
                metrics.note_agg("sketch_failures")
                metrics.record("fault_recovered", point="agg.strategy",
                               fault=e.kind, action="static_partial_final")
                sketch_ok = False

            hash_ok = bool(ranges) and 0 < domain <= int(
                self.conf.get(CF.ADAPTIVE_AGG_HASH_DOMAIN_LIMIT))
            presplit_ok = bool(hot_hashes) and d > 1
            if not sketch_ok:
                strategy, mode = "partial", "fallback"
            elif not verdict.ok:
                strategy, mode = "partial", "pinned"
                metrics.note_agg("pinned")
            elif forced in ("partial", "bypass", "hash", "sort",
                            "presplit"):
                # an unexecutable forced choice falls back to partial
                strategy = forced
                if (forced == "hash" and not hash_ok) \
                        or (forced == "presplit" and not presplit_ok):
                    strategy = "partial"
                mode = "forced"
                metrics.note_agg("forced")
            elif rows:
                strategy = legality.strategy_crossover(
                    ratio, domain if ranges else -1,
                    float(self.conf.get(CF.ADAPTIVE_AGG_BYPASS_NDV_RATIO)),
                    int(self.conf.get(CF.ADAPTIVE_AGG_HASH_DOMAIN_LIMIT)),
                    int(self.conf.get(CF.ADAPTIVE_AGG_SORT_DOMAIN_WIDTH)))
                mode = "auto"
                # pre-splitting pays only where the chosen strategy
                # exchanges raw rows; partial and hash collapse a hot key
                # to one row per rank first
                if strategy in ("bypass", "sort") and presplit_ok:
                    strategy = "presplit"
            else:
                strategy, mode = "partial", "auto"

            if strategy == "presplit":
                # second fault point: the candidate list is advice only,
                # dropped whole on any injected fault
                try:
                    faults.inject("agg.presplit", self.conf)
                except faults.InjectedFault as e:
                    metrics.note_agg("presplit_failures")
                    metrics.record("fault_recovered", point="agg.presplit",
                                   fault=e.kind,
                                   action="static_partial_final")
                    strategy, mode = "partial", "presplit_fallback"

        self._note("agg", strategy=strategy, mode=mode, ndv=int(ndv),
                   rows=rows, ratio=round(ratio, 4), domain=int(domain),
                   devices=d, hot_keys=len(hot_hashes),
                   node=final.node_string())
        metrics.note_agg(strategy)
        metrics.set_gauge("agg.last_ndv", int(ndv))
        metrics.set_gauge("agg.last_rows", rows)
        metrics.set_gauge("agg.last_strategy", strategy)

        if strategy == "bypass":
            # raw rows to their group's rank under the measured bounds;
            # the partial node over them is the final aggregate (AggSpec
            # gives partials and merges the same aliases and types)
            sb = self._run_measured(raw_ex, child_sb, incoming, maxslice)
            return dataclasses.replace(partial, child=D.ShardScanExec(sb),
                                       phase=None)
        if strategy == "sort":
            with trace.span("agg.sort", rows=rows, ndv=int(ndv)):
                orders = tuple(E.SortOrder(E.strip_alias(g))
                               for g in partial.groupings)
                range_ex = D.RangeExchangeExec(orders,
                                               D.ShardScanExec(child_sb))
                ex_sb = self._exchange_with_stats(range_ex, child_sb)
                out_sb = self._run_stage(D.DistRangeAggExec(
                    tuple(partial.groupings), tuple(partial.aggregates),
                    D.ShardScanExec(ex_sb)))
                out_sb.sorted_by = self._agg_sorted_by(partial)
            return D.ShardScanExec(out_sb)
        if strategy == "presplit":
            with trace.span("agg.presplit", hot=len(hot_hashes), rows=rows):
                salted = dataclasses.replace(raw_ex,
                                             presplit_hashes=hot_hashes)
                salted_sb = self._exchange_with_stats(
                    salted, child_sb, consumer=None, allow_skew=False)
                pre_sb = self._run_stage(dataclasses.replace(
                    partial, child=D.ShardScanExec(salted_sb)))
                sb = self._exchange_with_stats(ex, pre_sb, consumer=None,
                                               allow_skew=False)
            return dataclasses.replace(final, child=D.ShardScanExec(sb))
        if strategy == "hash":
            pre: P.PhysicalPlan = D.DistHashPartialAggExec(
                tuple(partial.groupings), tuple(partial.aggregates),
                D.ShardScanExec(child_sb), key_mins=mins, key_ranges=ranges)
        else:
            pre = dataclasses.replace(partial, child=D.ShardScanExec(child_sb))
        sb = self._run_adaptive_exchange(dataclasses.replace(ex, child=pre),
                                         consumer=final)
        return dataclasses.replace(final, child=D.ShardScanExec(sb))

    def _agg_sorted_by(self, partial: "D.DistSortAggExec"):
        """The sort rung's ``sorted_by`` under the partial's key aliases,
        or None where the key types carry none: dictionary strings
        range-partition by rank but sort locally by code, and floats
        never reach here (pinned). Integer-coded keys (ints, bools,
        dates, decimals) qualify: their code order is their value
        order."""
        from spark_tpu_torch.analysis import legality

        out = []
        for i, g in enumerate(partial.groupings):
            try:
                dt_engine = E.strip_alias(g).data_type(partial.child.schema)
                dt = legality._np_dtype(dt_engine)
            except Exception:
                return None
            if isinstance(dt_engine, T.StringType) \
                    or np.issubdtype(dt, np.floating):
                return None
            alias = partial.aggregates[i]
            if not (isinstance(alias, E.Alias)
                    and E.expr_key(alias.child)
                    == E.expr_key(E.strip_alias(g))):
                return None
            out.append((alias.name, True, True))
        return tuple(out)

    def _materialize_boundaries(self, plan: P.PhysicalPlan
                                ) -> P.PhysicalPlan:
        if isinstance(plan, D.DistJoinBoundary):
            return D.ShardScanExec(self._run_join(plan))
        fields = {}
        changed = False
        for f in dataclasses.fields(plan):
            v = getattr(plan, f.name)
            if isinstance(v, P.PhysicalPlan):
                nv = self._materialize_boundaries(v)
                changed |= nv is not v
                v = nv
            fields[f.name] = v
        return dataclasses.replace(plan, **fields) if changed else plan

    def _run_stage(self, plan: P.PhysicalPlan) -> ShardedBatch:
        """One rank stage in a ``stage.run`` span, recorded as a ``stage``
        event and its output's ``stage_bytes``."""
        with trace.span("stage.run", op=type(plan).__name__), \
                metrics.stage_timer("stage", mesh=self.d,
                                    node=plan.node_string()):
            sb = self._run_stage_inner(plan)
        metrics.record("stage_bytes",
                       bytes=int(sb.capacity) * _row_width(sb.schema))
        return sb

    def _run_stage_inner(self, plan: P.PhysicalPlan) -> ShardedBatch:
        """Run ``plan`` on every rank of this process (``_run_threads``,
        or ``_run_processes`` on a mesh that spans processes), then
        record the stage, check the fused overflow sentinel and compact
        a sparse output."""
        _check_stage(plan)
        d = self.d
        t0 = time.perf_counter()
        if self.mesh.spans_processes:
            sb, walls, comm = self._run_processes(plan)
        else:
            sb, walls, comm = self._run_threads(plan)
        wall = (time.perf_counter() - t0) * 1e3
        if self._stats is not None:
            self._stats["host_reads"] += comm.host_reads
            self._stats["stages"].append({
                "node": plan.node_string(), "wall_ms": wall,
                "rank_ms": walls, "exchanges": len(comm.events)})
            self._stats["exchanges"].extend(comm.events)
            self._stats["staged_bytes"] += getattr(comm, "staged_bytes", 0)
        if comm.events and not self._adaptive_enabled():
            # static mode: the stage's exchanges ran inside it at their
            # own capacities; report the stage output as the post-exchange
            # shape (the live rows were counted by the exchanges' reads)
            p = sb.per_device_capacity
            metrics.record_exchange(
                op="fused", mode="fused", devices=d,
                exchanges=len(comm.events),
                rows=int(comm.events[-1]["rows"]),
                capacity_before=p, capacity_after=p,
                buffer_bytes=d * p * _row_width(sb.schema))
        if isinstance(plan, D.FusedSpanExec) and plan.speculate:
            # each shard's last slot is the overflow sentinel: read it
            # before any compaction could move it
            self._host_read()
            if any(v[0] for v in sb.rank_values(
                    lambda s: s.row_mask[-1:])):
                raise _FusionOverflow()
        return self._maybe_compact(sb)

    def _run_threads(self, plan: P.PhysicalPlan):
        """Every rank, one thread each, their collectives on one
        ThreadComm (``_run_ranks``). Returns the output, the ranks' walls
        and the communicator."""
        d = self.d
        comm = X.ThreadComm(d)
        outs, walls = self._run_ranks(plan, range(d), comm)
        schema = outs[0].schema
        for r, b in enumerate(outs[1:], 1):
            if any(a.dictionary is not b_.dictionary
                   and a.dictionary != b_.dictionary
                   for a, b_ in zip(schema.fields, b.schema.fields)):
                raise AssertionError(
                    f"rank {r}'s string dictionaries differ from rank 0's")
        return (ShardedBatch(schema, [b.data for b in outs], self.mesh),
                walls, comm)

    def _run_ranks(self, plan: P.PhysicalPlan, ranks, comm):
        """``ranks`` of the stage, one thread each (the caller's context
        copied into each; one rank runs in the calling thread), their
        collectives on ``comm``; the first failure is raised here once
        every rank has stopped. With a sampled trace each rank runs in a
        ``stage.device`` span that ends with a sync of its device.
        Returns the ranks' outputs and walls (ms)."""
        ranks = list(ranks)
        outs: List[Optional[Batch]] = [None] * len(ranks)
        walls = [0.0] * len(ranks)
        failures: list = []  # (rank, exception), first failure first
        lock = locks.named_lock("mesh.rank_stage")

        def rank_main(i: int) -> None:
            t0 = time.perf_counter()
            try:
                outs[i] = self._run_on(plan, ranks[i], comm)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                with lock:
                    failures.append((ranks[i], e))
                comm.abort()
            finally:
                walls[i] = (time.perf_counter() - t0) * 1e3

        if len(ranks) == 1:
            contextvars.copy_context().run(rank_main, 0)
        else:
            threads = [threading.Thread(
                target=contextvars.copy_context().run, args=(rank_main, i),
                name=f"mesh-rank-{r}", daemon=True)
                for i, r in enumerate(ranks)]
            for t in threads:
                t.start()
            deadline = time.monotonic() + comm.timeout + 30.0
            for t in threads:
                t.join(max(0.0, deadline - time.monotonic()))
            if any(t.is_alive() for t in threads):
                comm.abort()
                for t in threads:
                    t.join(30.0)
                raise RuntimeError(
                    f"mesh stage did not finish within {comm.timeout} s: "
                    + plan.node_string())
        if failures:
            if self._stats is not None:
                self._stats["host_reads"] += comm.host_reads
            # a rank's own failure (a lost group is one) before the
            # aborts it caused
            real = [f for f in failures
                    if not isinstance(f[1], X.CommAborted)
                    or isinstance(f[1], X.ProcessGroupLost)]
            raise (real or failures)[0][1]
        return outs, walls

    def _run_processes(self, plan: P.PhysicalPlan):
        """On a mesh that spans processes: this process's ranks, one
        thread each (``_run_ranks``), their collectives on a
        ProcessThreadComm over the process group. A failure here tears
        the group down (``DistComm.abort``), so the other processes'
        collectives fail at once instead of waiting out the timeout, and
        is raised as ``ProcessGroupLost`` (terminal, never retried: a
        retry would meet no peer). Then one all-gather of every rank's
        capacity, wall and a digest of its output's dictionaries: a
        digest that differs fails the stage in every process. Returns
        the output, the ranks' walls and the communicator."""
        local = self.mesh.local_ranks
        comm = X.ProcessThreadComm(local, self.d,
                                   X.DistComm(self.mesh.comm.group))
        try:
            outs, walls = self._run_ranks(plan, local, comm)
        except X.ProcessGroupLost:
            comm.dist.abort()
            raise
        except BaseException as e:
            comm.dist.abort()
            raise X.ProcessGroupLost(
                f"{plan.node_string()} failed in process "
                f"{self.mesh.process_index} ({type(e).__name__}: {e}); the "
                "process group is torn down") from e
        mine = [(b.capacity, int(w * 1e3),
                 [_dictionary_digest(f) for f in b.schema.fields])
                for b, w in zip(outs, walls)]
        rows = [x for got in self.mesh.comm.gather_objects(mine)
                for x in got]
        for q, (_, _, dg) in enumerate(rows):
            if dg != mine[0][2]:
                raise AssertionError(
                    f"rank {q}'s string dictionaries differ from rank "
                    f"{local[0]}'s after {plan.node_string()}")
        shards = [None] * self.d
        for r, b in zip(local, outs):
            shards[r] = b.data
        sb = ShardedBatch(outs[0].schema, shards, self.mesh,
                          capacities=[c for c, _, _ in rows])
        return sb, [w / 1e3 for _, w, _ in rows], comm

    def _run_on(self, plan: P.PhysicalPlan, r: int, comm: X.Comm) -> Batch:
        """Rank ``r``'s part of the stage, in a ``stage.device`` span
        closed by a sync of its device when the trace is sampled."""
        dev = self.mesh.devices[r]
        ctx = trace.current()
        if ctx is None or not ctx.sampled:
            return run_rank(plan, r, comm, dev)
        with trace.span("stage.device", op=type(plan).__name__, rank=r):
            out = run_rank(plan, r, comm, dev)
            if torch.device(dev).type == "cuda":
                # device time, not launch time: only a sampled trace
                # pays the sync (the host reads the same buffers right
                # after anyway)
                torch.cuda.current_stream(dev).synchronize()
            return out

    def _maybe_compact(self, sb: ShardedBatch) -> ShardedBatch:
        """Shrink the shards when at most a quarter of the rows live, to
        bucket(largest live count, 128) (the reference's pressure valve,
        CoalesceShufflePartitions). Live rows keep their order; where no
        live row lies past the new capacity on any rank, a plain cut."""
        p = sb.per_device_capacity
        if p <= _COMPACT_MIN_CAPACITY:
            return sb

        def live_and_end(s):
            # live rows and 1 + the last live row's position
            pos = torch.arange(s.capacity + 1, device=s.row_mask.device)
            mask = torch.cat([s.row_mask.new_zeros(1), s.row_mask])
            return torch.stack([
                s.row_mask.sum(),
                torch.where(mask, pos, torch.zeros_like(pos)).max()])

        stats = sb.rank_values(live_and_end)
        self._host_read()
        max_live = max(live for live, _ in stats)
        if max_live * 4 > p:
            return sb
        new_p = K.bucket(max_live, 128)
        op = _CompactExec(new_p, D.ShardScanExec(sb),
                          sliced=all(end <= new_p for _, end in stats))
        shards = [None if s is None else
                  op.execute([Pipe.from_batch(sb.shard_batch(r))])
                  .to_batch().data for r, s in enumerate(sb.shards)]
        return ShardedBatch(sb.schema, shards, sb.mesh, sb.sorted_by,
                            capacities=[new_p] * self.d)

    # ---- join lowering ------------------------------------------------------

    def _run_join(self, jb: D.DistJoinBoundary) -> ShardedBatch:
        left_sb = self.run(jb.left)
        right_sb = self.run(jb.right)
        how = jb.how
        if how == "cross":
            return self._run_cross(jb, left_sb, right_sb)

        if self._adaptive_enabled():
            # runtime broadcast switching (reference:
            # DynamicJoinSelection.scala:40 over MapOutputStatistics): the
            # build side's measured bytes (live rows x row width) instead
            # of the static capacity estimate, which a filtered build
            # side inflates
            measured = right_sb.num_valid_rows() * _row_width(right_sb.schema)
            self._host_read()
            threshold = int(self.conf.get(CF.ADAPTIVE_BROADCAST_THRESHOLD))
            small_build = measured <= threshold
            self._note("aqe", decision=("broadcast_join" if small_build
                                        else "exchange_join"),
                       measured_bytes=int(measured), threshold=threshold,
                       static_bytes=_estimated_bytes(right_sb))
            if self._fusion_enabled():
                # a measured-bytes host decision by construction: joins
                # run at their staged boundary, never inside a span
                self._fusion_bailout("broadcast_switch",
                                     "join build side measured on host")
        else:
            small_build = (_estimated_bytes(right_sb)
                           <= int(self.conf.get(BROADCAST_THRESHOLD)))
        broadcast = (how in ("inner", "left", "left_semi", "left_anti")
                     and small_build)

        # the key projections, run once: their executed schema carries the
        # true dictionaries of computed string keys
        lproj = self._run_stage(P.ProjectExec(
            tuple(E.Alias(k, f"__k{i}") for i, k in enumerate(jb.left_keys)),
            D.ShardScanExec(left_sb)))
        rproj = self._run_stage(P.ProjectExec(
            tuple(E.Alias(k, f"__k{i}") for i, k in enumerate(jb.right_keys)),
            D.ShardScanExec(right_sb)))
        union_dicts = self._union_dicts(lproj.schema, rproj.schema)
        mins, ranges = self._key_stats(lproj, rproj, union_dicts)

        left0, right0 = left_sb, right_sb  # before the exchange: balanced
        if not broadcast:
            left_sb = self.run(D.HashPartitionExchangeExec(
                jb.left_keys, D.ShardScanExec(left_sb),
                key_union_dicts=union_dicts))
            right_sb = self.run(D.HashPartitionExchangeExec(
                jb.right_keys, D.ShardScanExec(right_sb),
                key_union_dicts=union_dicts))

        def count_pairs(ls, rs, bcast):
            cnt_sb = self._run_stage(D.JoinCountExec(
                D.ShardScanExec(ls), D.ShardScanExec(rs), jb.left_keys,
                jb.right_keys, mins, ranges, bcast))
            counts = [v[0] for v in cnt_sb.rank_values(
                lambda s: s.columns[0].data[:1])]
            self._host_read()
            return np.array(counts, dtype=np.int64)

        need_count = not (how in ("left_semi", "left_anti")
                          and jb.condition is None and mins is not None)
        pair_cap = 0
        if need_count:
            counts = count_pairs(left_sb, right_sb, broadcast)
            # skew (reference: OptimizeSkewedJoin.scala:37): a hot key
            # puts all its pairs on one rank, and that rank's count sizes
            # every rank's capacity; re-plan as a broadcast join over the
            # balanced rows, or split around the hot keys
            factor = int(self.conf.get(SKEW_FACTOR))
            min_pairs = int(self.conf.get(SKEW_MIN_PAIRS))
            med = float(np.median(counts)) if counts.size else 0.0
            skewed = (not broadcast and counts.size
                      and int(counts.max()) >= min_pairs
                      and float(counts.max()) > factor * max(1.0, med))
            if skewed and how in ("inner", "left", "left_semi", "left_anti"):
                if _estimated_bytes(right0) <= int(
                        self.conf.get(SKEW_MAX_BROADCAST_BYTES)):
                    self._note("skew_join_broadcast", max=int(counts.max()),
                               median=med)
                    broadcast = True
                    left_sb, right_sb = left0, right0
                    counts = count_pairs(left_sb, right_sb, True)
                else:
                    fields, hot = self._detect_hot_keys(jb.left_keys,
                                                        left0)
                    if hot:
                        self._note("skew_join_split", max=int(counts.max()),
                                   median=med, hot_keys=len(hot))
                        return self._run_skew_split(
                            jb, how, left0, right0, fields, hot,
                            union_dicts, mins, ranges, count_pairs)
            pair_cap = K.bucket(int(counts.max()) if counts.size else 0)

        left0 = right0 = None  # release the rows before the exchange
        return self._run_stage(D.JoinApplyExec(
            D.ShardScanExec(left_sb), D.ShardScanExec(right_sb), how,
            jb.left_keys, jb.right_keys, jb.condition, mins, ranges,
            pair_cap, broadcast))

    def _detect_hot_keys(self, keys, sb: ShardedBatch):
        """The keys' fields and the hot-key candidates: each rank's local
        mode (TopKeyExec); a candidate is hot when its global count (a
        lower bound) exceeds one balanced rank's share."""
        cand = self._run_stage(D.TopKeyExec(tuple(keys), D.ShardScanExec(sb)))
        self._host_read(2)  # the candidates, then the live rows
        nkeys = len(keys)
        fields = cand.schema.fields

        def first_row(s):
            # per key: valid, the value's int64 (K.key_int64); the count
            out = []
            for cd in s.columns[:nkeys]:
                v = K.key_int64(cd.data[:1])
                out += [torch.ones(1, dtype=torch.int64, device=v.device)
                        if cd.validity is None
                        else cd.validity[:1].to(torch.int64), v]
            return torch.cat(out + [s.columns[nkeys].data[:1]
                                    .to(torch.int64)])

        counts: dict = {}
        for row in cand.rank_values(first_row):
            if not all(row[2 * i] for i in range(nkeys)):
                continue  # a NULL key never joins
            key = tuple(_decode_key_value(_key_raw(row[2 * i + 1],
                                                   fields[i]), fields[i])
                        for i in range(nkeys))
            counts[key] = counts.get(key, 0) + int(row[-1])
        share = max(1, sb.num_valid_rows() // max(1, self.d))
        hot = [k for k, c in sorted(counts.items(), key=lambda kv: -kv[1])
               if c > share]
        return fields[:nkeys], hot[:4]

    def _run_skew_split(self, jb: D.DistJoinBoundary, how: str,
                        left0: ShardedBatch, right0: ShardedBatch, fields,
                        hot, union_dicts, mins, ranges,
                        count_pairs) -> ShardedBatch:
        """The skew split: the hot keys' probe rows stay where they are
        and join a broadcast of the hot keys' build rows; the rest take
        the hash exchange; the union of the two joins is exact for the
        left-preserving join types."""
        lpred = _hot_key_pred(jb.left_keys, fields, hot)
        rpred = _hot_key_pred(jb.right_keys, fields, hot)
        # NULL probe keys belong to the rest (preserved rows of outer and
        # anti joins); NOT(pred) alone is NULL for them
        lrest_pred = E.Or(E.Not(lpred), _null_any(jb.left_keys))
        rrest_pred = E.Or(E.Not(rpred), _null_any(jb.right_keys))
        lhot = self._run_stage(P.FilterExec(lpred, D.ShardScanExec(left0)))
        lrest = self._run_stage(P.FilterExec(lrest_pred,
                                             D.ShardScanExec(left0)))
        rhot = self._run_stage(P.FilterExec(rpred, D.ShardScanExec(right0)))
        rrest = self._run_stage(P.FilterExec(rrest_pred,
                                             D.ShardScanExec(right0)))
        lrest_ex = self.run(D.HashPartitionExchangeExec(
            jb.left_keys, D.ShardScanExec(lrest),
            key_union_dicts=union_dicts))
        rrest_ex = self.run(D.HashPartitionExchangeExec(
            jb.right_keys, D.ShardScanExec(rrest),
            key_union_dicts=union_dicts))
        c1 = count_pairs(lrest_ex, rrest_ex, False)
        c2 = count_pairs(lhot, rhot, True)
        self._note("skew_join_branches", hot_pairs=int(c2.sum()),
                   rest_pairs=int(c1.sum()), hot_max=int(c2.max()),
                   rest_max=int(c1.max()))
        j1 = self._run_stage(D.JoinApplyExec(
            D.ShardScanExec(lrest_ex), D.ShardScanExec(rrest_ex), how,
            jb.left_keys, jb.right_keys, jb.condition, mins, ranges,
            K.bucket(int(c1.max()) if c1.size else 0), False))
        j2 = self._run_stage(D.JoinApplyExec(
            D.ShardScanExec(lhot), D.ShardScanExec(rhot), how,
            jb.left_keys, jb.right_keys, jb.condition, mins, ranges,
            K.bucket(int(c2.max()) if c2.size else 0), True))
        return self._run_stage(P.UnionExec(D.ShardScanExec(j1),
                                           D.ShardScanExec(j2)))

    def _run_cross(self, jb: D.DistJoinBoundary, left_sb: ShardedBatch,
                   right_sb: ShardedBatch) -> ShardedBatch:
        rn = right_sb.num_valid_rows()
        self._host_read()
        pair_cap = left_sb.per_device_capacity * max(1, rn)
        return self._run_stage(D.JoinApplyExec(
            D.ShardScanExec(left_sb), D.ShardScanExec(right_sb), "cross",
            (), (), jb.condition, (), (), pair_cap, broadcast=True))

    @staticmethod
    def _union_dicts(lschema: Schema, rschema: Schema):
        """Per key, the unified dictionary of both sides' executed key
        columns (None for a key without strings), so codes hash and pack
        alike on both sides."""
        out = []
        for lf, rf in zip(lschema.fields, rschema.fields):
            if lf.dictionary is None and rf.dictionary is None:
                out.append(None)
            else:
                union, _ = C.unify_dictionaries(
                    (lf.dictionary or (), rf.dictionary or ()))
                out.append(union)
        return tuple(out)

    def _key_stats(self, lproj: ShardedBatch, rproj: ShardedBatch,
                   union_dicts) -> Tuple[Optional[tuple], Optional[tuple]]:
        """Per join key, (min, range) over both sides' live, non-NULL
        values (each shard reduced on its device, one copy each to the
        host); strings range over their unified dictionary. (None, None)
        when the packed range passes 2^62: the join then hashes and
        verifies (reference: HashedRelation.scala:208)."""
        mins: List[int] = []
        ranges: List[int] = []
        total = 1
        for i, ud in enumerate(union_dicts):
            if ud is not None or isinstance(lproj.schema.fields[i].dtype,
                                            T.StringType):
                mins.append(0)
                ranges.append(max(1, len(ud or ())))
            else:
                def any_min_max(s, i=i):
                    cd = s.columns[i]
                    ok = s.row_mask if cd.validity is None \
                        else s.row_mask & cd.validity
                    v = K.key_int64(cd.data)
                    big = torch.full((), K.INT64_MAX, dtype=torch.int64,
                                     device=v.device)
                    small = torch.full((), K.INT64_MIN, dtype=torch.int64,
                                       device=v.device)
                    return torch.stack([ok.any().to(torch.int64),
                                        torch.where(ok, v, big).min(),
                                        torch.where(ok, v, small).max()])

                stats = []
                for sb in (lproj, rproj):
                    stats += sb.rank_values(any_min_max)
                    self._host_read()
                found = [(lo, hi) for any_, lo, hi in stats if any_]
                if not found:
                    mins.append(0)
                    ranges.append(1)
                else:
                    mn = min(lo for lo, _ in found)
                    mx = max(hi for _, hi in found)
                    mins.append(mn)
                    ranges.append(mx - mn + 1)
            total *= ranges[-1]
            if total > (1 << 62):
                return None, None
        return tuple(mins), tuple(ranges)
