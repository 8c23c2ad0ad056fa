"""Subquery rewriting: EXISTS/IN -> semi/anti joins, scalar subqueries
-> aggregate joins, with decorrelation of equality predicates.

The port's copy of ``spark_tpu/plan/subquery.py``: host-only plan
rewriting, no device code. Generated columns are named from a
process-wide counter (``__sq{i}``, ``__nin{i}_n``), as in the reference.

The analogue of the reference's subquery planning + decorrelation tier
(reference: sql/catalyst/.../optimizer/subquery.scala
RewritePredicateSubquery, DecorrelateInnerQuery.scala,
RewriteCorrelatedScalarSubquery in Optimizer.scala). Correlated
references are OuterRef nodes captured at parse time; this pass removes
every SubqueryExpression from the plan, so the executors never see one.

Supported shapes (the TPC-H dialect):
- [NOT] EXISTS (SELECT ... WHERE outer_eq AND ... [non-equi corr]) —
  equality conjuncts become semi/anti join keys, other correlated
  conjuncts become the join condition.
- expr [NOT] IN (SELECT col ...), optionally correlated by equalities.
- scalar subqueries: uncorrelated (cross join of a 1-row aggregate) and
  correlated-by-equality aggregates (GROUP BY the correlation columns +
  LEFT JOIN — empty groups yield NULL, matching SQL).
"""

from __future__ import annotations

import contextvars
import itertools
from typing import List, Optional, Tuple

from spark_tpu_torch.expr import expressions as E
from spark_tpu_torch.plan import logical as L
from spark_tpu_torch.plan.optimizer import combine_conjuncts, split_conjuncts

#: the names of one statement's rewritten subqueries count from 0, so a
#: statement parsed again gets the same plan (and plan key) as before
_SQ_NAMES = contextvars.ContextVar("subquery_names", default=None)


def _next_sq() -> int:
    return next(_SQ_NAMES.get())


def _has_outer(e: E.Expression) -> bool:
    if isinstance(e, E.OuterRef):
        return True
    return any(_has_outer(c) for c in e.children())


def _outer_to_col(e: E.Expression) -> E.Expression:
    def fn(x):
        if isinstance(x, E.OuterRef):
            return E.Col(x.col_name)
        return x

    return E.transform_expr(e, fn)


def _pure_outer(e: E.Expression) -> bool:
    """Only OuterRefs and literals below (no inner columns)."""
    if isinstance(e, E.Col):
        return False
    if isinstance(e, (E.OuterRef, E.Literal)):
        return True
    return bool(e.children()) and all(_pure_outer(c) for c in e.children()) \
        or isinstance(e, E.Literal)


def _pure_inner(e: E.Expression) -> bool:
    return not _has_outer(e)


def _strip_correlated(
    plan: L.LogicalPlan,
) -> Tuple[L.LogicalPlan, List[E.Expression], bool]:
    """Remove correlated conjuncts from Filter nodes anywhere in the
    plan. Returns (stripped_plan, conjuncts, found_below_agg)."""
    collected: List[E.Expression] = []
    below_agg = False

    def go(node: L.LogicalPlan, under_agg: bool) -> L.LogicalPlan:
        nonlocal below_agg
        before = len(collected)
        child_under = under_agg or isinstance(node, L.Aggregate)
        children = tuple(go(c, child_under) for c in node.children())
        node = node.with_children(children) if children else node
        if isinstance(node, L.Filter):
            parts = split_conjuncts(node.condition)
            corr = [p for p in parts if _has_outer(p)]
            rest = [p for p in parts if not _has_outer(p)]
            if corr:
                collected.extend(corr)
                if under_agg:
                    below_agg = True
                return L.Filter(combine_conjuncts(rest), node.child) if rest \
                    else node.child
        if isinstance(node, L.Project):
            # correlated conjuncts collected in this subtree become join
            # keys/conditions ABOVE the subquery plan — widen the
            # projection so the inner columns they reference survive
            # (reference: DecorrelateInnerQuery threads attributes up)
            needed: set = set()
            for p in collected[before:]:
                needed |= p.references()  # OuterRefs contribute nothing
            missing = [n for n in needed
                       if n not in set(node.schema.names)
                       and n in set(node.child.schema.names)]
            if missing:
                node = L.Project(
                    node.exprs + tuple(E.Col(n) for n in sorted(missing)),
                    node.child)
        return node

    return go(plan, False), collected, below_agg


def _corr_to_keys(
    corr: List[E.Expression],
) -> Tuple[List[E.Expression], List[E.Expression], List[E.Expression]]:
    """Split correlated conjuncts into (outer_keys, inner_keys, residual).
    Equalities with one pure-outer and one pure-inner side become key
    pairs; everything else is residual (goes to the join condition)."""
    outer_keys: List[E.Expression] = []
    inner_keys: List[E.Expression] = []
    residual: List[E.Expression] = []
    for p in corr:
        if isinstance(p, E.Cmp) and p.op == "==":
            if _pure_outer(p.left) and _pure_inner(p.right):
                outer_keys.append(_outer_to_col(p.left))
                inner_keys.append(p.right)
                continue
            if _pure_outer(p.right) and _pure_inner(p.left):
                outer_keys.append(_outer_to_col(p.right))
                inner_keys.append(p.left)
                continue
        residual.append(p)
    return outer_keys, inner_keys, residual


def _join_condition(residual: List[E.Expression], left_names,
                    right_names) -> Optional[E.Expression]:
    """Residual correlated conjuncts reference outer columns as OuterRef
    and inner columns by their own names; the join condition evaluates
    on the joined pair where right-side duplicates carry '#2' suffixes
    (logical.Join.schema dedup). Rewrite both."""
    if not residual:
        return None
    pair = E.dedup_pair_names(left_names, right_names)
    rename = dict(zip(right_names, pair[len(list(left_names)):]))

    def fix(e: E.Expression) -> E.Expression:
        def fn(x):
            if isinstance(x, E.OuterRef):
                return E.Col(x.col_name)
            if isinstance(x, E.Col) and x.col_name in rename:
                return E.Col(rename[x.col_name])
            return x

        return E.transform_expr(e, fn)

    return combine_conjuncts([fix(p) for p in residual])


def _apply_exists(plan: L.LogicalPlan, ex: E.Exists) -> L.LogicalPlan:
    sub = rewrite_subqueries(ex.plan)
    stripped, corr, below_agg = _strip_correlated(sub)
    if below_agg:
        raise NotImplementedError(
            "correlated predicate below an aggregate inside EXISTS")
    how = "left_anti" if ex.negated else "left_semi"
    if not corr:
        # uncorrelated EXISTS: keep all or no rows depending on whether
        # the subquery has any row — a 1-row COUNT()>0 cross join + filter
        flag = L.Aggregate(
            (), (E.Alias(E.Cmp(">", E.Count(None), E.Literal(0)),
                         "__exists__"),), stripped)
        joined = L.Join(plan, flag, "cross", (), ())
        cond = E.Col("__exists__") if not ex.negated \
            else E.Not(E.Col("__exists__"))
        return L.Project(tuple(E.Col(n) for n in plan.schema.names),
                         L.Filter(cond, joined))
    outer_keys, inner_keys, residual = _corr_to_keys(corr)
    cond = _join_condition(residual, plan.schema.names,
                           stripped.schema.names)
    return L.Join(plan, stripped, how, tuple(outer_keys),
                  tuple(inner_keys), cond)


def _apply_in(plan: L.LogicalPlan, isq: E.InSubquery) -> L.LogicalPlan:
    """[NOT] IN (subquery) as a semi/anti join on value equality (+ any
    correlated equalities). NOT IN is null-aware for the uncorrelated
    case (reference: RewritePredicateSubquery's null-aware anti join):
    a NULL anywhere in the subquery result, or a NULL probe value with a
    non-empty subquery, yields UNKNOWN — the row is dropped."""
    sub = rewrite_subqueries(isq.plan)
    stripped, corr, below_agg = _strip_correlated(sub)
    if below_agg:
        raise NotImplementedError(
            "correlated predicate below an aggregate inside IN subquery")
    outer_keys, inner_keys, residual = _corr_to_keys(corr)
    if isinstance(isq.child, E.TupleExpr):
        # (a, b) IN (select x, y ...): multi-key semi join (reference:
        # In.scala with a CreateStruct probe)
        probes = list(isq.child.items)
        if isq.negated:
            raise NotImplementedError(
                "NOT IN with a row-value probe (null-aware anti join "
                "over multiple columns)")
        if len(probes) > len(stripped.schema.names):
            raise ValueError("IN subquery arity mismatch")
        value_cols = [E.Col(n)
                      for n in stripped.schema.names[:len(probes)]]
        outer_keys = probes + outer_keys
        inner_keys = value_cols + inner_keys
    else:
        value_col = stripped.schema.names[0]
        outer_keys = [isq.child] + outer_keys
        inner_keys = [E.Col(value_col)] + inner_keys
    cond = _join_condition(residual, plan.schema.names,
                           stripped.schema.names)
    how = "left_anti" if isq.negated else "left_semi"
    joined = L.Join(plan, stripped, how, tuple(outer_keys),
                    tuple(inner_keys), cond)
    if not isq.negated:
        return joined
    if corr:
        # per-group null-awareness over a nullable inner column is not
        # implemented; with a non-nullable inner column the anti join is
        # exact except for a NULL probe vs a non-empty group (UNKNOWN ->
        # drop), handled via per-group counts when the probe is nullable
        if stripped.schema.fields[0].nullable:
            # the reference refuses this shape too
            raise NotImplementedError(
                "correlated NOT IN over a nullable subquery column is not "
                "ported (the reference does not support it either)")
        try:
            probe_nullable = isq.child.nullable(plan.schema)
        except KeyError:  # a name the schema lacks: assume nullable
            probe_nullable = True
        if not probe_nullable:
            return joined
        corr_outer = outer_keys[1:]
        corr_inner = inner_keys[1:]
        n_name = f"__nin{_next_sq()}_n"
        key_aliases = [E.Alias(k, f"{n_name}_k{j}")
                      for j, k in enumerate(corr_inner)]
        counts = L.Aggregate(tuple(corr_inner),
                             tuple(key_aliases) +
                             (E.Alias(E.Count(None), n_name),), stripped)
        with_counts = L.Join(joined, counts, "left", tuple(corr_outer),
                             tuple(E.Col(a.alias_name)
                                   for a in key_aliases))
        group_empty = E.IsNull(E.Col(n_name))
        keep = E.Or(group_empty, E.Not(E.IsNull(isq.child)))
        return L.Project(tuple(E.Col(n) for n in plan.schema.names),
                         L.Filter(keep, with_counts))
    # uncorrelated NOT IN: attach subquery row/non-null counts and apply
    # three-valued logic: empty subquery -> keep everything; any NULL in
    # the subquery -> keep nothing; NULL probe + non-empty -> drop row
    i = _next_sq()
    n_name, nn_name = f"__nin{i}_n", f"__nin{i}_nn"
    counts = L.Aggregate(
        (), (E.Alias(E.Count(None), n_name),
             E.Alias(E.Count(E.Col(value_col)), nn_name)), stripped)
    with_counts = L.Join(joined, counts, "cross", (), ())
    empty = E.Cmp("==", E.Col(n_name), E.Literal(0))
    no_nulls = E.Cmp("==", E.Col(n_name), E.Col(nn_name))
    probe_ok = E.Not(E.IsNull(isq.child))
    keep = E.Or(empty, E.And(no_nulls, probe_ok))
    return L.Project(tuple(E.Col(n) for n in plan.schema.names),
                     L.Filter(keep, with_counts))


def _apply_scalar(
    plan: L.LogicalPlan, sq: E.ScalarSubquery,
) -> Tuple[L.LogicalPlan, E.Expression]:
    """Returns (new_plan, replacement column expr)."""
    i = _next_sq()
    out_name = f"__sq{i}"
    sub = rewrite_subqueries(sq.plan)
    stripped, corr, _ = _strip_correlated(sub)
    if not corr:
        first = stripped.schema.names[0]
        if isinstance(stripped, L.Aggregate) and not stripped.groupings:
            # already exactly one row — a straight cross join is safe
            renamed = L.Project((E.Alias(E.Col(first), out_name),), stripped)
            return L.Join(plan, renamed, "cross", (), ()), E.Col(out_name)
        # general relation: reduce to one row so an empty result yields
        # NULL instead of dropping all outer rows (SQL scalar-subquery
        # semantics; reference: RewriteCorrelatedScalarSubquery notes).
        # Deviation: >1 row takes the first instead of raising.
        one_row = L.Aggregate(
            (), (E.Alias(E.First(E.Col(first)), out_name),),
            L.Limit(1, stripped))
        return L.Join(plan, one_row, "cross", (), ()), E.Col(out_name)
    # correlated: the top of the subquery must be a global aggregate;
    # group it by the correlation columns and LEFT JOIN on them
    # (reference: RewriteCorrelatedScalarSubquery + constructLeftJoins)
    if not (isinstance(stripped, L.Aggregate) and not stripped.groupings
            and len(stripped.aggregates) == 1):
        raise NotImplementedError(
            "correlated scalar subquery must be a single global aggregate")
    outer_keys, inner_keys, residual = _corr_to_keys(corr)
    if residual:
        raise NotImplementedError(
            "non-equality correlation in scalar subquery")
    key_aliases = [E.Alias(k, f"__sqk{i}_{j}")
                   for j, k in enumerate(inner_keys)]
    agg_expr = E.strip_alias(stripped.aggregates[0])
    agg_out = E.Alias(agg_expr, out_name)
    grouped = L.Aggregate(tuple(inner_keys),
                          tuple(key_aliases) + (agg_out,),
                          stripped.child)
    joined = L.Join(plan, grouped, "left", tuple(outer_keys),
                    tuple(E.Col(a.alias_name) for a in key_aliases))
    result: E.Expression = E.Col(out_name)
    if isinstance(agg_expr, E.Count):
        # COUNT over an empty correlated group is 0, but the grouped LEFT
        # JOIN produces NULL for groups with no rows (reference:
        # RewriteCorrelatedScalarSubquery's COUNT bug handling)
        result = E.Coalesce((result, E.Literal(0)))
    return joined, result


def _rewrite_filter(node: L.Filter) -> L.LogicalPlan:
    base_names = node.child.schema.names
    plan = node.child
    kept: List[E.Expression] = []
    for c in split_conjuncts(node.condition):
        if isinstance(c, E.Exists):
            plan = _apply_exists(plan, c)
        elif isinstance(c, E.Not) and isinstance(c.child, E.Exists):
            inner = c.child
            plan = _apply_exists(plan, E.Exists(inner.plan,
                                                not inner.negated))
        elif isinstance(c, E.InSubquery):
            plan = _apply_in(plan, c)
        elif isinstance(c, E.Not) and isinstance(c.child, E.InSubquery):
            inner = c.child
            plan = _apply_in(plan, E.InSubquery(inner.child, inner.plan,
                                                not inner.negated))
        elif E.contains_subquery(c):
            # scalar subqueries inside a comparison/expression
            def replace(e: E.Expression) -> E.Expression:
                nonlocal plan
                if isinstance(e, E.ScalarSubquery):
                    plan, col = _apply_scalar(plan, e)
                    return col
                if isinstance(e, (E.Exists, E.InSubquery)):
                    raise NotImplementedError(
                        "EXISTS/IN under OR or non-conjunct position")
                return e

            kept.append(E.transform_expr(c, replace))
        else:
            kept.append(c)
    if kept:
        plan = L.Filter(combine_conjuncts(kept), plan)
    if tuple(plan.schema.names) != tuple(base_names):
        plan = L.Project(tuple(E.Col(n) for n in base_names), plan)
    return plan


def _rewrite_project(node: L.Project) -> L.LogicalPlan:
    """Scalar subqueries in SELECT position (reference:
    RewriteCorrelatedScalarSubquery handles Project as well as Filter)."""
    plan = node.child
    new_exprs: List[E.Expression] = []
    for e in node.exprs:
        if not E.contains_subquery(e):
            new_exprs.append(e)
            continue
        out_name = e.name

        def replace(x: E.Expression) -> E.Expression:
            nonlocal plan
            if isinstance(x, E.ScalarSubquery):
                plan, col = _apply_scalar(plan, x)
                return col
            if isinstance(x, (E.Exists, E.InSubquery)):
                raise NotImplementedError(
                    "EXISTS/IN subquery in SELECT position")
            return x

        ne = E.transform_expr(E.strip_alias(e), replace)
        new_exprs.append(E.Alias(ne, out_name))
    return L.Project(tuple(new_exprs), plan)


def rewrite_subqueries(plan: L.LogicalPlan) -> L.LogicalPlan:
    """Remove every SubqueryExpression (bottom-up; nested subqueries are
    rewritten when their enclosing Filter/Project is processed)."""
    if _SQ_NAMES.get() is None:
        token = _SQ_NAMES.set(itertools.count())
        try:
            return rewrite_subqueries(plan)
        finally:
            _SQ_NAMES.reset(token)

    def fn(node: L.LogicalPlan) -> L.LogicalPlan:
        if isinstance(node, L.Filter) and E.contains_subquery(node.condition):
            return _rewrite_filter(node)
        if isinstance(node, L.Project) and any(
                E.contains_subquery(e) for e in node.exprs):
            return _rewrite_project(node)
        for e in node.expressions():
            if E.contains_subquery(e):
                raise NotImplementedError(
                    f"subquery expression outside WHERE/HAVING/SELECT: {e}")
        return node

    return plan.transform_up(fn)
