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

Mesh stages run eagerly under ``stats_recording_disabled``: they bind
and record no runtime statistics and capture no CUDA graph (a capture
while another thread launches on the same device fails).

Join sizing follows the reference's AQE pattern (reference:
adaptive/AdaptiveSparkPlanExec.scala:247): a stage of the key
projections gives the key ranges and unified dictionaries, a count
stage sizes the pair capacity, then the join stage runs.

Not ported yet (off by default in the reference too; a mesh run with
either turned on raises): the adaptive exchanges and aggregation
(``spark.tpu.adaptive.enabled``) and whole-query fusion
(``spark.tpu.fusion.enabled``).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
import threading
import time
import weakref
from typing import List, Optional, Tuple

import numpy as np
import torch

from spark_tpu_torch import conf as CF
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

ADAPTIVE_ENABLED = CF.register(
    "spark.tpu.adaptive.enabled", False,
    "The reference's adaptive execution over the mesh (measured exchange "
    "capacities, runtime broadcast switching, adaptive aggregation). Not "
    "ported yet: a mesh run with it on raises NotImplementedError.", bool)

FUSION_ENABLED = CF.register(
    "spark.tpu.fusion.enabled", False,
    "The reference's whole-query fusion of adaptive exchange spans. Not "
    "ported yet: a mesh run with it on raises NotImplementedError.", bool)

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


def _hot_key_pred(keys, hot) -> E.Expression:
    """OR over the hot candidates of AND(key == literal)."""
    ors = None
    for vals in hot:
        ands = None
        for k, v in zip(keys, vals):
            c = E.Cmp("==", k, E.Literal(v))
            ands = c if ands is None else E.And(ands, c)
        ors = ands if ors is None else E.Or(ors, ands)
    return ors


def _null_any(keys) -> E.Expression:
    out = None
    for k in keys:
        c = E.IsNull(k)
        out = c if out is None else E.Or(out, c)
    return out


def _run_tree(plan: P.PhysicalPlan) -> Pipe:
    """One rank's view of a stage: every node eagerly, children first."""
    return plan.execute_blocking([_run_tree(c) for c in plan.children()])


def run_rank(plan: P.PhysicalPlan, rank: int, comm: X.Comm,
             device) -> Batch:
    """Rank ``rank``'s part of a mesh stage, in the calling thread: its
    shard through ``plan``, eagerly, its collectives on ``comm`` (a
    ``ThreadComm`` in a stage's thread; a ``DistComm`` in a process of
    its own). No runtime statistics are recorded."""
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
    its stages, each stage's wall and per-rank wall milliseconds, and
    every exchange with its live rows, rows moved to another rank and
    their bytes."""

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
        ``plan``; the result's shards concatenated on rank 0's device."""
        from spark_tpu_torch.plan.optimizer import optimize as opt

        for entry in (ADAPTIVE_ENABLED, FUSION_ENABLED):
            if bool(self.conf.get(entry)):
                raise NotImplementedError(
                    f"not ported yet: {entry.key} on a mesh (ROADMAP A10)")
        lp = opt(plan, self.conf) if optimize else plan
        self._stats = {"stages": [], "exchanges": []}
        t0 = time.perf_counter()
        try:
            out = self.run(self.plan(lp)).to_batch()
        finally:
            stats, self._stats = self._stats, None
            stats["wall_ms"] = (time.perf_counter() - t0) * 1e3
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
                                 self.mesh.devices[0])))
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
            return D.DistJoinBoundary(self.plan(plan.left),
                                      self.plan(plan.right), plan.how,
                                      plan.left_keys, plan.right_keys,
                                      plan.condition)
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
        if isinstance(plan, D.ShardScanExec):
            return plan.sharded
        return self._run_stage(plan)

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
        """Run ``plan`` on every rank (one thread each, the caller's
        context copied into each), its collectives on one ThreadComm;
        the first failure is raised here once every rank has stopped."""
        _check_stage(plan)
        d = self.d
        comm = X.ThreadComm(d)
        outs: List[Optional[Batch]] = [None] * d
        walls = [0.0] * d
        failures: list = []  # (rank, exception), first failure first
        lock = threading.Lock()

        def rank_main(r: int) -> None:
            t0 = time.perf_counter()
            try:
                outs[r] = run_rank(plan, r, comm, self.mesh.devices[r])
            except BaseException as e:  # noqa: BLE001 - re-raised below
                with lock:
                    failures.append((r, e))
                comm.abort()
            finally:
                walls[r] = (time.perf_counter() - t0) * 1e3

        t0 = time.perf_counter()
        if d == 1:
            contextvars.copy_context().run(rank_main, 0)
        else:
            threads = [threading.Thread(
                target=contextvars.copy_context().run, args=(rank_main, r),
                name=f"mesh-rank-{r}", daemon=True) for r in range(d)]
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
        wall = (time.perf_counter() - t0) * 1e3
        if failures:
            real = [f for f in failures
                    if not isinstance(f[1], X.CommAborted)]
            raise (real or failures)[0][1]
        schema = outs[0].schema
        for r, b in enumerate(outs[1:], 1):
            if any(a.dictionary is not b_.dictionary
                   and a.dictionary != b_.dictionary
                   for a, b_ in zip(schema.fields, b.schema.fields)):
                raise AssertionError(
                    f"rank {r}'s string dictionaries differ from rank 0's")
        sb = ShardedBatch(schema, [b.data for b in outs], self.mesh)
        if self._stats is not None:
            self._stats["stages"].append({
                "node": plan.node_string(), "wall_ms": wall,
                "rank_ms": walls, "exchanges": len(comm.events)})
            self._stats["exchanges"].extend(comm.events)
        return self._maybe_compact(sb)

    def _maybe_compact(self, sb: ShardedBatch) -> ShardedBatch:
        """Shrink the shards when at most a quarter of the rows live, to
        bucket(largest live count, 128) (the reference's pressure valve,
        CoalesceShufflePartitions). Live rows keep their order."""
        p = sb.per_device_capacity
        if p <= _COMPACT_MIN_CAPACITY:
            return sb
        live = sb.live_counts()
        if max(live) * 4 > p:
            return sb
        new_p = K.bucket(max(live), 128)
        shards = [X.compact(Pipe.from_batch(sb.shard_batch(r)), new_p)
                  .to_batch().data for r in range(self.d)]
        return ShardedBatch(sb.schema, shards, sb.mesh, sb.sorted_by)

    # ---- join lowering ------------------------------------------------------

    def _run_join(self, jb: D.DistJoinBoundary) -> ShardedBatch:
        left_sb = self.run(jb.left)
        right_sb = self.run(jb.right)
        how = jb.how
        if how == "cross":
            return self._run_cross(jb, left_sb, right_sb)

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
            return np.array([int(s.columns[0].data[0]) for s in
                             cnt_sb.shards], dtype=np.int64)

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
                    hot = self._detect_hot_keys(jb.left_keys, left0)
                    if hot:
                        self._note("skew_join_split", max=int(counts.max()),
                                   median=med, hot_keys=len(hot))
                        return self._run_skew_split(
                            jb, how, left0, right0, hot, union_dicts, mins,
                            ranges, count_pairs)
            pair_cap = K.bucket(int(counts.max()) if counts.size else 0)

        left0 = right0 = None  # release the rows before the exchange
        return self._run_stage(D.JoinApplyExec(
            D.ShardScanExec(left_sb), D.ShardScanExec(right_sb), how,
            jb.left_keys, jb.right_keys, jb.condition, mins, ranges,
            pair_cap, broadcast))

    def _note(self, kind: str, **fields) -> None:
        if self._stats is not None:
            self._stats.setdefault("events", []).append(
                dict(kind=kind, **fields))

    def _detect_hot_keys(self, keys, sb: ShardedBatch):
        """Hot-key candidates: each rank's local mode (TopKeyExec); a
        candidate is hot when its global count (a lower bound) exceeds one
        balanced rank's share."""
        cand = self._run_stage(D.TopKeyExec(tuple(keys), D.ShardScanExec(sb)))
        nkeys = len(keys)
        fields = cand.schema.fields
        counts: dict = {}
        for s in cand.shards:
            vals = []
            for i in range(nkeys):
                cd = s.columns[i]
                if cd.validity is not None and not bool(cd.validity[0]):
                    break  # a NULL key never joins
                vals.append(_decode_key_value(cd.data[0].cpu(), fields[i]))
            else:
                key = tuple(vals)
                counts[key] = counts.get(key, 0) + int(s.columns[nkeys]
                                                       .data[0])
        share = max(1, sb.num_valid_rows() // max(1, self.d))
        hot = [k for k, c in sorted(counts.items(), key=lambda kv: -kv[1])
               if c > share]
        return hot[:4]

    def _run_skew_split(self, jb: D.DistJoinBoundary, how: str,
                        left0: ShardedBatch, right0: ShardedBatch, hot,
                        union_dicts, mins, ranges,
                        count_pairs) -> ShardedBatch:
        """The skew split: the hot keys' probe rows stay where they are
        and join a broadcast of the hot keys' build rows; the rest take
        the hash exchange; the union of the two joins is exact for the
        left-preserving join types."""
        lpred = _hot_key_pred(jb.left_keys, hot)
        rpred = _hot_key_pred(jb.right_keys, hot)
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
                stats = []
                for sb in (lproj, rproj):
                    for s in sb.shards:
                        cd = s.columns[i]
                        ok = s.row_mask if cd.validity is None \
                            else s.row_mask & cd.validity
                        v = cd.data.to(torch.int64)
                        big = torch.full((), K.INT64_MAX, dtype=torch.int64,
                                         device=v.device)
                        small = torch.full((), K.INT64_MIN,
                                           dtype=torch.int64,
                                           device=v.device)
                        stats.append(torch.stack([
                            ok.any().to(torch.int64),
                            torch.where(ok, v, big).min(),
                            torch.where(ok, v, small).max()]).tolist())
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
