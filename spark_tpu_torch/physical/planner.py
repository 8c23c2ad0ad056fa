"""Logical -> physical planning and execution.

Planning mirrors ``spark_tpu/physical/planner.py:plan_physical`` for the
operators of the single-device aggregate, join and window paths: one
physical choice per logical operator. A ``Range`` is made on the device
the caller names (the session's). The reference compiles maximal
traceable subtrees into one XLA program; the port evaluates the operator
tree recursively, eagerly, over torch tensors. Where a subtree holds a
blocking operator (a join, a sorted aggregate), each input of every
operator on the path to it is a stage boundary, and a sparse input is
compacted there as the reference's eager executor does
(``_maybe_compact``).
"""

from __future__ import annotations

from spark_tpu_torch.columnar.batch import Batch
from spark_tpu_torch.device import DEFAULT_DEVICE
from spark_tpu_torch.expr import expressions as E
from spark_tpu_torch.physical import kernels as K
from spark_tpu_torch.physical import operators as P
from spark_tpu_torch.physical.window import WindowExec
from spark_tpu_torch.plan import logical as L


def plan_physical(plan: L.LogicalPlan,
                  device=DEFAULT_DEVICE) -> P.PhysicalPlan:
    """The physical plan of ``plan``; ``device`` is where a ``Range``
    makes its rows (relations carry their own)."""

    def go(p: L.LogicalPlan) -> P.PhysicalPlan:
        return plan_physical(p, device)

    if isinstance(plan, L.Relation):
        return P.BatchScanExec(plan.batch)
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
    raise NotImplementedError(
        f"no physical plan for {type(plan).__name__} in the port yet "
        "(see ROADMAP queue A)")


def _fully_traceable(plan: P.PhysicalPlan) -> bool:
    return plan.traceable and all(_fully_traceable(c)
                                  for c in plan.children())


#: inputs at most this many rows are never compacted (reference:
#: planner._maybe_compact)
_COMPACT_MIN_CAPACITY = 4096


def _maybe_compact(pipe: P.Pipe, child: P.PhysicalPlan) -> P.Pipe:
    """Shrink a sparse stage input so capacities don't cascade (the
    reference's pressure valve is AQE partition coalescing,
    CoalesceShufflePartitions.scala): at most a quarter of the rows live
    -> compact to bucket(live). Scans are never compacted."""
    cap = pipe.capacity
    if cap <= _COMPACT_MIN_CAPACITY or isinstance(child, P.BatchScanExec):
        return pipe
    live = int(pipe.mask.sum())  # host sync: one per stage input
    if live * 4 > cap:
        return pipe
    return P.CompactExec(child, K.bucket(live)).execute([pipe])


def _run(plan: P.PhysicalPlan) -> P.Pipe:
    if _fully_traceable(plan):
        return plan.execute([_run(c) for c in plan.children()])
    return plan.execute([_maybe_compact(_run(c), c)
                         for c in plan.children()])


def execute(plan: P.PhysicalPlan) -> Batch:
    """Run a physical plan to a device batch."""
    return _run(plan).to_batch()


def execute_logical(plan: L.LogicalPlan, optimize: bool = True,
                    device=DEFAULT_DEVICE) -> Batch:
    from spark_tpu_torch.plan.optimizer import optimize as opt

    lp = opt(plan) if optimize else plan
    return execute(plan_physical(lp, device))
