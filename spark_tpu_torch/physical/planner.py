"""Logical -> physical planning and execution.

Planning mirrors ``spark_tpu/physical/planner.py:plan_physical`` for the
operators of the single-device aggregate path: one physical choice per
logical operator. The reference compiles maximal traceable subtrees into
one XLA program; the port evaluates the operator tree recursively,
eagerly, over torch tensors.
"""

from __future__ import annotations

from spark_tpu_torch.columnar.batch import Batch
from spark_tpu_torch.expr import expressions as E
from spark_tpu_torch.physical import operators as P
from spark_tpu_torch.plan import logical as L


def plan_physical(plan: L.LogicalPlan) -> P.PhysicalPlan:
    if isinstance(plan, L.Relation):
        return P.BatchScanExec(plan.batch)
    if isinstance(plan, L.Project):
        return P.ProjectExec(plan.exprs, plan_physical(plan.child))
    if isinstance(plan, L.Filter):
        return P.FilterExec(plan.condition, plan_physical(plan.child))
    if isinstance(plan, L.Aggregate):
        return P.HashAggregateExec(plan.groupings, plan.aggregates,
                                   plan_physical(plan.child))
    if isinstance(plan, L.Sort):
        return P.SortExec(plan.orders, plan_physical(plan.child))
    if isinstance(plan, L.Limit):
        return P.LimitExec(plan.n, plan_physical(plan.child), plan.offset)
    if isinstance(plan, L.Distinct):
        cols = tuple(E.Col(n) for n in plan.schema.names)
        return P.HashAggregateExec(cols, cols, plan_physical(plan.child))
    raise NotImplementedError(
        f"no physical plan for {type(plan).__name__} in the port yet "
        "(see ROADMAP queue A)")


def _run(plan: P.PhysicalPlan) -> P.Pipe:
    return plan.execute([_run(c) for c in plan.children()])


def execute(plan: P.PhysicalPlan) -> Batch:
    """Run a physical plan to a device batch."""
    return _run(plan).to_batch()


def execute_logical(plan: L.LogicalPlan, optimize: bool = True) -> Batch:
    from spark_tpu_torch.plan.optimizer import optimize as opt

    lp = opt(plan) if optimize else plan
    return execute(plan_physical(lp))
