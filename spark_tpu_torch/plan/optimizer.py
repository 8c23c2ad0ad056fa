"""Rule-based logical optimizer.

Analogue of Catalyst's optimizer (reference:
sql/catalyst/.../optimizer/Optimizer.scala:44 defaultBatches:71) with the
rules the single-table slice needs: predicate pushdown, column pruning,
project collapsing, constant folding, pruning of always-true filters.
The rule-executor loop mirrors RuleExecutor.scala (fixed-point batches).
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Callable, List, Tuple

from spark_tpu_torch.expr import expressions as E
from spark_tpu_torch.plan import logical as L


# ---- expression-level helpers ----------------------------------------------


def substitute(expr: E.Expression, mapping: dict) -> E.Expression:
    """Replace Col(name) by mapping[name] expressions (used when moving a
    predicate through a Project)."""

    def fn(e: E.Expression) -> E.Expression:
        if isinstance(e, E.Col) and e.col_name in mapping:
            return mapping[e.col_name]
        return e

    return E.transform_expr(expr, fn)


def split_conjuncts(e: E.Expression) -> List[E.Expression]:
    if isinstance(e, E.And):
        return split_conjuncts(e.left) + split_conjuncts(e.right)
    return [e]


def combine_conjuncts(parts: List[E.Expression]) -> E.Expression:
    out = parts[0]
    for p in parts[1:]:
        out = E.And(out, p)
    return out


def fold_constants(e: E.Expression) -> E.Expression:
    """Evaluate literal-only subtrees host-side (reference:
    optimizer/expressions.scala ConstantFolding)."""

    def fn(node: E.Expression) -> E.Expression:
        if isinstance(node, E.Arith) and isinstance(node.left, E.Literal) \
                and isinstance(node.right, E.Literal):
            lv, rv = node.left.value, node.right.value
            if lv is None or rv is None:
                return E.Literal(None, node.left.dtype)
            try:
                if isinstance(lv, datetime.date) and isinstance(rv, int):
                    val = (lv + datetime.timedelta(days=rv) if node.op == "+"
                           else lv - datetime.timedelta(days=rv))
                    return E.Literal(val)
                ops = {"+": lambda a, b: a + b, "-": lambda a, b: a - b,
                       "*": lambda a, b: a * b,
                       "/": lambda a, b: a / b if b != 0 else None,
                       "%": lambda a, b: a % b if b != 0 else None}
                val = ops[node.op](lv, rv)
                if val is None:
                    return E.Literal(None, node.left.dtype)
                return E.Literal(val)
            except Exception:
                return node
        if isinstance(node, E.Not) and isinstance(node.child, E.Literal) \
                and isinstance(node.child.value, bool):
            return E.Literal(not node.child.value)
        return node

    return E.transform_expr(e, fn)


# ---- plan-level rules -------------------------------------------------------


def collapse_projects(plan: L.LogicalPlan) -> L.LogicalPlan:
    """Project(Project(x)) -> Project(x) by substitution (reference:
    Optimizer.scala CollapseProject)."""

    def fn(node: L.LogicalPlan) -> L.LogicalPlan:
        if isinstance(node, L.Project) and isinstance(node.child, L.Project):
            inner = node.child
            mapping = {e.name: E.strip_alias(e) for e in inner.exprs}
            new_exprs = []
            for e in node.exprs:
                ne = substitute(E.strip_alias(e), mapping)
                if ne.name != e.name:
                    ne = E.Alias(ne, e.name)
                new_exprs.append(ne)
            return L.Project(tuple(new_exprs), inner.child)
        return node

    return plan.transform_up(fn)


def push_down_predicates(plan: L.LogicalPlan) -> L.LogicalPlan:
    """Move Filters toward scans through Projects (with substitution);
    merge adjacent Filters (reference: Optimizer.scala
    PushDownPredicates)."""

    def fn(node: L.LogicalPlan) -> L.LogicalPlan:
        if not isinstance(node, L.Filter):
            return node
        child = node.child
        if isinstance(child, L.Filter):
            return L.Filter(E.And(child.condition, node.condition), child.child)
        if isinstance(child, L.Project):
            has_agg = any(E.contains_aggregate(e) for e in child.exprs)
            if not has_agg:
                mapping = {e.name: E.strip_alias(e) for e in child.exprs}
                cond = substitute(node.condition, mapping)
                return L.Project(child.exprs, L.Filter(cond, child.child))
        return node

    return plan.transform_up(fn)


def prune_filters(plan: L.LogicalPlan) -> L.LogicalPlan:
    def fn(node: L.LogicalPlan) -> L.LogicalPlan:
        if isinstance(node, L.Filter) and isinstance(node.condition, E.Literal):
            if node.condition.value is True:
                return node.child
        return node

    return plan.transform_up(fn)


def constant_folding(plan: L.LogicalPlan) -> L.LogicalPlan:
    def fn(node: L.LogicalPlan) -> L.LogicalPlan:
        return node.transform_expressions(
            lambda e: fold_constants(e) if isinstance(
                e, (E.Arith, E.Not)) else e)

    return plan.transform_up(fn)


def prune_columns(plan: L.LogicalPlan) -> L.LogicalPlan:
    """Top-down required-column analysis; inserts narrow Projects above
    leaves so scans read only what is needed (reference: Optimizer.scala
    ColumnPruning)."""

    def prune(node: L.LogicalPlan, required: set) -> L.LogicalPlan:
        if isinstance(node, L.Relation):
            names = node.schema.names
            keep = [n for n in names if n in required]
            if 0 < len(keep) < len(names):
                return L.Project(tuple(E.Col(n) for n in keep), node)
            return node
        if isinstance(node, L.Project):
            kept = tuple(e for e in node.exprs if e.name in required) or node.exprs[:1]
            child_req = set()
            for e in kept:
                child_req |= e.references()
            return L.Project(kept, prune(node.child, child_req))
        if isinstance(node, L.Filter):
            child_req = required | node.condition.references()
            return L.Filter(node.condition, prune(node.child, child_req))
        if isinstance(node, L.Aggregate):
            child_req = set()
            for e in node.groupings + node.aggregates:
                child_req |= e.references()
            return dataclasses.replace(
                node, child=prune(node.child, child_req))
        if isinstance(node, (L.Sort, L.Limit, L.Distinct)):
            child_req = set(required)
            for e in node.expressions():
                child_req |= e.references()
            if isinstance(node, L.Distinct):
                child_req |= set(node.schema.names)
            return node.with_children((prune(node.children()[0], child_req),))
        raise NotImplementedError(
            f"column pruning for {type(node).__name__}")

    return prune(plan, set(plan.schema.names))


# ---- rule executor ----------------------------------------------------------

Rule = Callable[[L.LogicalPlan], L.LogicalPlan]

_FIXED_POINT_BATCH: Tuple[Rule, ...] = (
    constant_folding,
    push_down_predicates,
    collapse_projects,
    prune_filters,
)

MAX_ITERATIONS = 20  # reference: RuleExecutor FixedPoint(100); ours converge fast


def optimize(plan: L.LogicalPlan) -> L.LogicalPlan:
    """Run rule batches to fixpoint, then one column-pruning pass
    (reference: RuleExecutor.execute, rules/RuleExecutor.scala). The
    join rules, join reordering, runtime filters and session-injected
    rules are not ported yet."""
    for _ in range(MAX_ITERATIONS):
        new_plan = plan
        for rule in _FIXED_POINT_BATCH:
            new_plan = rule(new_plan)
        if new_plan.tree_string() == plan.tree_string():
            plan = new_plan
            break
        plan = new_plan
    return prune_columns(plan)
