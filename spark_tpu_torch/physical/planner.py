"""Logical -> physical planning and the stage-fusing executor.

Planning mirrors ``spark_tpu/physical/planner.py:plan_physical`` for the
operators of the single-device aggregate, join, window and nested-type
paths: one physical choice per logical operator. A ``Range`` is made,
and a file scan read, on the device the caller names (the session's).

Execution mirrors the reference's ``execute``: every maximal traceable
subtree runs as one stage (``physical/graphs.py``: on the card a CUDA
graph captured once and replayed, on the CPU the same stage function
run eagerly); blocking operators run eagerly between stages, syncing to
size their outputs, and a sparse stage input is compacted there
(``_maybe_compact``). The first run of a plan records its runtime
statistics: the caches of ``physical/operators.py`` and the two here,
keyed on the plan and the ids of its leaf tensors. A later run over the
same leaves binds them (``_bind_adaptive``), which makes joins, sorted
aggregates and explodes traceable, replays the first run's compactions
inside the stages (``_replay_compactions``) and compacts the result on
the device before the copy to the host (``_OUTPUT_STATS``). ``last_run``
counts what a run did: the nodes that ran traced and blocking, the
stages, the captures and the replays.
"""

from __future__ import annotations

import collections
import contextvars
import dataclasses
from dataclasses import dataclass, field

from spark_tpu_torch import conf as CF
from spark_tpu_torch.columnar.batch import Batch
from spark_tpu_torch.device import DEFAULT_DEVICE
from spark_tpu_torch.expr import expressions as E
from spark_tpu_torch.physical import graphs
from spark_tpu_torch.physical import kernels as K
from spark_tpu_torch.physical import operators as P
from spark_tpu_torch.physical.window import WindowExec
from spark_tpu_torch.plan import logical as L


def plan_physical(plan: L.LogicalPlan,
                  device=DEFAULT_DEVICE) -> P.PhysicalPlan:
    """The physical plan of ``plan``; ``device`` is where a ``Range``
    makes its rows and a file scan puts its batch (relations carry their
    own)."""

    def go(p: L.LogicalPlan) -> P.PhysicalPlan:
        return plan_physical(p, device)

    if isinstance(plan, L.Relation):
        return P.BatchScanExec(plan.batch)
    if isinstance(plan, L.UnresolvedScan):
        return P.BatchScanExec(plan.source.read(plan.columns, plan.filters,
                                                device))
    if isinstance(plan, L.Range):
        return P.RangeExec(plan.start, plan.end, plan.step, plan.col_name,
                           device)
    if isinstance(plan, L.Project):
        return P.ProjectExec(plan.exprs, go(plan.child))
    if isinstance(plan, L.Filter):
        return P.FilterExec(plan.condition, go(plan.child))
    if isinstance(plan, L.Aggregate):
        return P.HashAggregateExec(plan.groupings, plan.aggregates,
                                   go(plan.child))
    if isinstance(plan, L.Sort):
        return P.SortExec(plan.orders, go(plan.child))
    if isinstance(plan, L.Limit):
        return P.LimitExec(plan.n, go(plan.child), plan.offset)
    if isinstance(plan, L.Distinct):
        cols = tuple(E.Col(n) for n in plan.schema.names)
        return P.HashAggregateExec(cols, cols, go(plan.child))
    if isinstance(plan, L.SubqueryAlias):
        return go(plan.child)
    if isinstance(plan, L.Window):
        return WindowExec(plan.window_exprs, go(plan.child))
    if isinstance(plan, L.Expand):
        return P.ExpandExec(plan.projections, plan.names, go(plan.child))
    if isinstance(plan, L.Join):
        return P.JoinExec(go(plan.left), go(plan.right), plan.how,
                          plan.left_keys, plan.right_keys, plan.condition)
    if isinstance(plan, L.Union):
        return P.UnionExec(go(plan.left), go(plan.right))
    if isinstance(plan, L.Generate):
        return P.GenerateExec(plan.generator, plan.out_name, plan.pos_name,
                              go(plan.child))
    if isinstance(plan, L.Sample):
        return P.SampleExec(plan.fraction, plan.seed, go(plan.child))
    raise NotImplementedError(
        f"no physical plan for {type(plan).__name__} in the port yet "
        "(see ROADMAP queue A)")


def _fully_traceable(plan: P.PhysicalPlan) -> bool:
    return plan.traceable and all(_fully_traceable(c)
                                  for c in plan.children())


def node_label(plan: P.PhysicalPlan) -> str:
    """What ``RunStats`` counts a node as: a join by its type (and
    ``:cond`` for one without keys), an aggregate by its strategy."""
    if isinstance(plan, P.JoinExec):
        return f"join:{plan.how}" + ("" if plan.left_keys else ":cond")
    if isinstance(plan, P.HashAggregateExec):
        if plan.has_collect():
            return "agg:collect"
        return "agg:direct" if plan._static_direct_ok() else "agg:sorted"
    return type(plan).__name__


@dataclass
class RunStats:
    """What one ``execute`` did (nested executions add to the outer
    one's)."""

    #: node labels (``node_label``) run inside traced stages / blocking
    traced: collections.Counter = field(default_factory=collections.Counter)
    blocking: collections.Counter = field(
        default_factory=collections.Counter)
    #: of the blocking ones, those not traceable themselves (the others
    #: sit above one of these, as in the reference)
    untraceable: collections.Counter = field(
        default_factory=collections.Counter)
    stages: int = 0          # traced stages run
    captured: int = 0        # of those, captured into a CUDA graph
    replayed: int = 0        # of those, replayed from one
    capture_ms: float = 0.0  # warm-up and capture, host clock
    first_run: bool = True   # no output stats were bound


#: the counts of the newest run
last_run = RunStats()
_RUN = contextvars.ContextVar("run_stats", default=None)


def _capacity_bucket(conf) -> int:
    """Compaction capacities round up to spark.tpu.adaptive.capacityBucket
    (default 1024), so re-executions land on few capacities."""
    return max(1, CF.active_int(CF.ADAPTIVE_CAPACITY_BUCKET, conf))


def _bind_adaptive(plan: P.PhysicalPlan) -> None:
    """Attach recorded runtime stats to the nodes (the re-optimization
    step of AQE, reference: AdaptiveSparkPlanExec.getFinalPhysicalPlan:
    247, here between executions instead of between stages). A join
    whose first run over these leaves recorded its packing and sizes
    becomes traceable, with the build index that run cached."""
    for c in plan.children():
        _bind_adaptive(c)
    if isinstance(plan, P.JoinExec) and plan.how in (
            "inner", "left", "left_semi", "left_anti") and plan.left_keys:
        sk = plan.stats_key()
        plan.adaptive = P._JOIN_STATS.get(sk)
        plan.index_scan = plan.table_scan = plan.index_orient = None
        if plan.adaptive is not None:
            idx = P._JOIN_INDEX.get(sk)
            if idx is not None:
                orient, ib, tb = idx
                plan.index_scan = P.BatchScanExec(ib, aux=True)
                plan.table_scan = (P.BatchScanExec(tb, aux=True)
                                   if tb is not None else None)
                plan.index_orient = orient
    elif isinstance(plan, P.HashAggregateExec) and plan.groupings \
            and not plan._static_direct_ok():
        plan.adaptive = P._AGG_STATS.get(plan.stats_key())
    elif isinstance(plan, P.GenerateExec):
        plan.adaptive = P._GEN_STATS.get(plan.stats_key())


def _adaptive_snapshot(plan: P.PhysicalPlan) -> tuple:
    """The adaptive state of every node in tree order: part of the stage
    cache key (plan_key alone is stable across stats changes and treats
    compactions and index scans as transparent)."""
    out = []

    def go(p: P.PhysicalPlan) -> None:
        if isinstance(p, P.JoinExec):
            out.append((p.adaptive, p.index_orient,
                        None if p.index_scan is None
                        else p.index_scan.plan_key(),
                        None if p.table_scan is None
                        else p.table_scan.plan_key()))
        elif isinstance(p, (P.HashAggregateExec, P.GenerateExec)):
            out.append(p.adaptive)
        elif isinstance(p, P.CompactExec):
            out.append(("compact", p.cap))
        for c in p.children():
            go(c)

    go(plan)
    return tuple(out)


#: inputs at most this many rows are never compacted (reference:
#: planner._maybe_compact)
_COMPACT_MIN_CAPACITY = 4096

#: compaction capacity per (stage input, leaves), 0 = "not worthwhile":
#: replayed as explicit CompactExec nodes (``_replay_compactions``), so a
#: traced run sees exactly the arrays the blocking run fed downstream —
#: which the cached join indexes' positions need
_COMPACT_STATS = P._AdaptiveStatsCache()

#: live result rows per (plan, leaves), bucketed: a later run compacts its
#: result to that capacity on the device before the copy to the host
_OUTPUT_STATS = P._AdaptiveStatsCache()


def _maybe_compact(pipe: P.Pipe, child: P.PhysicalPlan, conf) -> P.Pipe:
    """Shrink a sparse stage input so capacities don't cascade (the
    reference's pressure valve is AQE partition coalescing,
    CoalesceShufflePartitions.scala): at most a quarter of the rows live
    -> compact to bucket(live). Scans are never compacted. The decision
    is recorded per (plan, leaves) and replayed by later runs."""
    cap = pipe.capacity
    if cap <= _COMPACT_MIN_CAPACITY or isinstance(child, P.BatchScanExec):
        return pipe
    sk = child.stats_key()
    new_cap = _COMPACT_STATS.get(sk)
    if new_cap is None:
        if not P.stats_recording():
            return pipe  # single-shot plan: skip the sizing sync
        live = int(pipe.mask.sum())  # host sync: first run only
        new_cap = (K.bucket(live, _capacity_bucket(conf))
                   if live * 4 <= cap else 0)
        _COMPACT_STATS.put(sk, new_cap)
    if not new_cap or new_cap >= cap:
        return pipe
    return P.CompactExec(child, new_cap).execute([pipe])


def _replay_compactions(plan: P.PhysicalPlan) -> P.PhysicalPlan:
    """Insert explicit CompactExec nodes where blocking runs compacted,
    so traced stages reproduce the same intermediate arrays."""
    if isinstance(plan, P.BatchScanExec):
        return plan
    fields = {}
    changed = False
    for f in dataclasses.fields(plan):
        v = getattr(plan, f.name)
        if isinstance(v, P.PhysicalPlan) \
                and not isinstance(v, P.BatchScanExec):
            nv = _replay_compactions(v)
            cap = _COMPACT_STATS.get(nv.stats_key())
            if cap:
                nv = P.CompactExec(nv, cap)
            changed = changed or nv is not v
            v = nv
        fields[f.name] = v
    return dataclasses.replace(plan, **fields) if changed else plan


def _execute(plan: P.PhysicalPlan, run: RunStats, conf) -> P.Pipe:
    if isinstance(plan, P.BatchScanExec):
        return plan.execute([])
    if _fully_traceable(plan):
        _count(plan, run.traced)
        return graphs.run_stage(plan, _adaptive_snapshot(plan),
                                not run.first_run, run, conf)
    pipes = [_maybe_compact(_execute(c, run, conf), c, conf)
             for c in plan.children()]
    run.blocking[node_label(plan)] += 1
    if not plan.traceable:
        run.untraceable[node_label(plan)] += 1
    return plan.execute_blocking(pipes)


def _count(plan: P.PhysicalPlan, into: collections.Counter) -> None:
    if not isinstance(plan, P.BatchScanExec):
        into[node_label(plan)] += 1
    for c in plan.children():
        _count(c, into)


def execute(plan: P.PhysicalPlan, conf=None) -> Batch:
    """Run a physical plan to a device batch: fuse what we can, block
    where we must. ``conf``: the session's settings (None reads the
    active session's)."""
    global last_run
    outer = _RUN.get()
    run = RunStats() if outer is None else outer
    token = _RUN.set(run)
    try:
        plan = _replay_compactions(plan)
        _bind_adaptive(plan)
        sk = plan.stats_key()
        cap = _OUTPUT_STATS.get(sk)
        if cap is not None:
            run.first_run = False
            return _execute(P.CompactExec(plan, cap), run, conf).to_batch()
        pipe = _execute(plan, run, conf)
        if P.stats_recording():
            live = int(pipe.mask.sum())  # host sync: first run only
            _OUTPUT_STATS.put(sk, K.bucket(live, _capacity_bucket(conf)))
        return pipe.to_batch()
    finally:
        _RUN.reset(token)
        if outer is None:
            last_run = run


def execute_logical(plan: L.LogicalPlan, optimize: bool = True,
                    device=DEFAULT_DEVICE, conf=None) -> Batch:
    """Optimize ``plan`` under ``conf`` (the session's settings; None
    takes every default) and run it on ``device``."""
    from spark_tpu_torch.plan.optimizer import optimize as opt

    lp = opt(plan, conf) if optimize else plan
    return execute(plan_physical(lp, device), conf)
