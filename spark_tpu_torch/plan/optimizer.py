"""Rule-based logical optimizer.

Analogue of Catalyst's optimizer (reference:
sql/catalyst/.../optimizer/Optimizer.scala:44 defaultBatches:71) with the
rules the aggregate and join slices need: predicate pushdown (into join
sides too), equi-join key extraction from WHERE and ON conditions,
factoring of common OR conjuncts, column pruning (windows, unions and
the grouping-sets Expand included), project collapsing,
constant folding (date and month arithmetic included), pruning of
always-true filters, and cost-based join reordering
(``plan/join_reorder.py``). The rule-executor loop mirrors
RuleExecutor.scala (fixed-point batches).
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


def split_disjuncts(e: E.Expression) -> List[E.Expression]:
    if isinstance(e, E.Or):
        return split_disjuncts(e.left) + split_disjuncts(e.right)
    return [e]


def combine_disjuncts(parts: List[E.Expression]) -> E.Expression:
    out = parts[0]
    for p in parts[1:]:
        out = E.Or(out, p)
    return out


def factor_or_common(e: E.Expression) -> E.Expression:
    """(A AND X) OR (A AND Y) -> A AND (X OR Y): factor conjuncts common
    to every OR branch (distributivity holds under Kleene 3-valued logic).
    Unlocks equi-key extraction for TPC-H q19-style predicates where the
    join key equality is repeated inside each OR branch (reference:
    optimizer/expressions.scala BooleanSimplification 'common factor
    extraction' case)."""

    def fn(node: E.Expression) -> E.Expression:
        if not isinstance(node, E.Or):
            return node
        branches = split_disjuncts(node)
        conj_lists = [split_conjuncts(b) for b in branches]
        key_lists = [[E.expr_key(c) for c in cl] for cl in conj_lists]
        common = set(key_lists[0])
        for kl in key_lists[1:]:
            common &= set(kl)
        if not common:
            return node
        factored = [c for c, k in zip(conj_lists[0], key_lists[0])
                    if k in common]
        rest_branches: List[E.Expression] = []
        any_true = False
        for cl, kl in zip(conj_lists, key_lists):
            remaining = [c for c, k in zip(cl, kl) if k not in common]
            if not remaining:
                any_true = True
            else:
                rest_branches.append(combine_conjuncts(remaining))
        if any_true:
            # one branch reduced to TRUE: OR-part vanishes entirely
            return combine_conjuncts(factored)
        return combine_conjuncts(factored +
                                 [combine_disjuncts(rest_branches)])

    return E.transform_expr(e, fn)


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
        if isinstance(node, E.AddMonths) and isinstance(node.child, E.Literal):
            v = node.child.value
            if isinstance(v, datetime.date):
                months = v.year * 12 + (v.month - 1) + node.months
                y, m = divmod(months, 12)
                m += 1
                day = min(v.day, _days_in_month(y, m))
                return E.Literal(datetime.date(y, m, day))
        if isinstance(node, E.Not) and isinstance(node.child, E.Literal) \
                and isinstance(node.child.value, bool):
            return E.Literal(not node.child.value)
        return node

    return E.transform_expr(e, fn)


def _days_in_month(y: int, m: int) -> int:
    if m == 12:
        return 31
    return (datetime.date(y, m + 1, 1) - datetime.date(y, m, 1)).days


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
    """Move Filters toward scans: through Projects (with substitution),
    into Join sides, below SubqueryAlias; merge adjacent Filters
    (reference: Optimizer.scala PushDownPredicates)."""

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
        if isinstance(child, L.SubqueryAlias):
            return L.SubqueryAlias(child.alias,
                                   L.Filter(node.condition, child.child))
        if isinstance(child, L.Join):
            left_names = set(child.left.schema.names)
            right_names = set(child.right.schema.names)
            left_parts, right_parts, keep = [], [], []
            for c in split_conjuncts(node.condition):
                refs = c.references()
                if refs and refs <= left_names and child.how in (
                        "inner", "left", "left_semi", "left_anti", "cross"):
                    left_parts.append(c)
                elif refs and refs <= right_names and child.how in (
                        "inner", "right", "cross"):
                    right_parts.append(c)
                else:
                    keep.append(c)
            if left_parts or right_parts:
                new_left = (L.Filter(combine_conjuncts(left_parts),
                                     child.left)
                            if left_parts else child.left)
                new_right = (L.Filter(combine_conjuncts(right_parts),
                                      child.right)
                             if right_parts else child.right)
                new_join = dataclasses.replace(
                    child, left=new_left, right=new_right)
                return L.Filter(combine_conjuncts(keep), new_join) if keep \
                    else new_join
        return node

    return plan.transform_up(fn)


def extract_equi_joins(plan: L.LogicalPlan) -> L.LogicalPlan:
    """Filter(Join(cross/inner)) with cross-side equality conjuncts ->
    equi join keys (reference: planning/patterns.scala ExtractEquiJoinKeys
    + the planner turning ON-less comma joins into hash joins). Essential
    for SQL comma-style joins: FROM a, b WHERE a.k = b.k."""

    def fn(node: L.LogicalPlan) -> L.LogicalPlan:
        if not (isinstance(node, L.Filter) and isinstance(node.child, L.Join)):
            return node
        join = node.child
        if join.how not in ("cross", "inner"):
            return node
        out_names = join.schema.names
        n_l = len(join.left.schema.names)
        left_out = set(out_names[:n_l])
        right_out_map = dict(zip(out_names[n_l:], join.right.schema.names))
        lkeys = list(join.left_keys)
        rkeys = list(join.right_keys)
        keep, changed = _take_equi_keys(split_conjuncts(node.condition),
                                        left_out, right_out_map,
                                        lkeys, rkeys)
        if not changed:
            return node
        new_join = L.Join(join.left, join.right, "inner",
                          tuple(lkeys), tuple(rkeys), join.condition)
        return L.Filter(combine_conjuncts(keep), new_join) if keep \
            else new_join

    return plan.transform_up(fn)


def _take_equi_keys(conjuncts, left_out: set, right_out_map: dict,
                    lkeys: list, rkeys: list):
    """Move each ``l == r`` conjunct whose sides reference only the
    left's and only the right's output names into the key lists (right
    keys mapped back to right-source names). Returns (the conjuncts
    left over, whether any moved)."""

    def to_src(e: E.Expression) -> E.Expression:
        def sub(x):
            if isinstance(x, E.Col) and x.col_name in right_out_map:
                return E.Col(right_out_map[x.col_name])
            return x

        return E.transform_expr(e, sub)

    right_out = set(right_out_map)
    keep: List[E.Expression] = []
    changed = False
    for c in conjuncts:
        if isinstance(c, E.Cmp) and c.op == "==":
            lr, rr = c.left.references(), c.right.references()
            if lr and lr <= left_out and rr and rr <= right_out:
                lkeys.append(c.left)
                rkeys.append(to_src(c.right))
                changed = True
                continue
            if rr and rr <= left_out and lr and lr <= right_out:
                lkeys.append(c.right)
                rkeys.append(to_src(c.left))
                changed = True
                continue
        keep.append(c)
    return keep, changed


def extract_condition_keys(plan: L.LogicalPlan) -> L.LogicalPlan:
    """Move equality conjuncts of a Join's ON condition into equi-join
    keys, for EVERY join type (reference: planning/patterns.scala
    ExtractEquiJoinKeys operates on the full join condition). Without
    this, semi/anti/outer joins whose keys live only in the condition
    degrade to all-pairs nested loops. The condition is expressed in the
    join's PAIR name space (right-side duplicates carry '#2' suffixes);
    extracted right keys are mapped back to right-source names. Safe for
    outer joins: keys and condition are both part of the match predicate,
    and unmatched-row padding is unaffected."""

    def fn(node: L.LogicalPlan) -> L.LogicalPlan:
        if not isinstance(node, L.Join) or node.condition is None:
            return node
        if node.how == "cross":
            return node
        # the condition is evaluated over the joined PAIR, whose namespace
        # is left names + '#2'-deduped right names — NOT node.schema
        # (which is left-only for semi/anti joins)
        left_names = list(node.left.schema.names)
        right_names = list(node.right.schema.names)
        pair_names = E.dedup_pair_names(left_names, right_names)
        n_l = len(left_names)
        lkeys = list(node.left_keys)
        rkeys = list(node.right_keys)
        keep, changed = _take_equi_keys(
            split_conjuncts(factor_or_common(node.condition)),
            set(pair_names[:n_l]), dict(zip(pair_names[n_l:], right_names)),
            lkeys, rkeys)
        if not changed:
            return node
        return dataclasses.replace(
            node, left_keys=tuple(lkeys), right_keys=tuple(rkeys),
            condition=combine_conjuncts(keep) if keep else None)

    return plan.transform_up(fn)


def simplify_booleans(plan: L.LogicalPlan) -> L.LogicalPlan:
    """Factor common conjuncts out of OR trees in every Filter so that
    predicate pushdown and equi-key extraction see them as top-level
    conjuncts (q19's `p_partkey = l_partkey` lives inside each OR
    branch). Reference: optimizer/expressions.scala BooleanSimplification."""

    def fn(node: L.LogicalPlan) -> L.LogicalPlan:
        if isinstance(node, L.Filter):
            new_cond = factor_or_common(node.condition)
            if new_cond is not node.condition:
                return L.Filter(new_cond, node.child)
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
                e, (E.Arith, E.AddMonths, E.Not)) else e)

    return plan.transform_up(fn)


def prune_columns(plan: L.LogicalPlan) -> L.LogicalPlan:
    """Top-down required-column analysis; inserts narrow Projects above
    leaves so scans read only what is needed (reference: Optimizer.scala
    ColumnPruning)."""

    def prune(node: L.LogicalPlan, required: set) -> L.LogicalPlan:
        if isinstance(node, (L.Relation, L.Range)):
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
        if isinstance(node, L.Window):
            win_names = {e.name for e in node.window_exprs}
            child_req = {n for n in required if n not in win_names}
            for e in node.window_exprs:
                child_req |= e.references()
            child_req &= set(node.child.schema.names)
            if not child_req:
                child_req = set(node.child.schema.names)
            return dataclasses.replace(
                node, child=prune(node.child, child_req))
        if isinstance(node, (L.Sort, L.Limit, L.Distinct, L.SubqueryAlias)):
            child_req = set(required)
            for e in node.expressions():
                child_req |= e.references()
            if isinstance(node, L.Distinct):
                child_req |= set(node.schema.names)
            return node.with_children((prune(node.children()[0], child_req),))
        if isinstance(node, L.Join):
            return _prune_join(node, required, prune)
        if isinstance(node, L.Expand):
            # only the outputs required above: the grouping-sets Expand
            # passes every child column through, and replicates each
            # once per set (the reference keeps them all)
            keep = [i for i, n in enumerate(node.names)
                    if n in required] or [0]
            child_req = set()
            for proj in node.projections:
                for i in keep:
                    child_req |= proj[i].references()
            return L.Expand(
                tuple(tuple(proj[i] for i in keep)
                      for proj in node.projections),
                tuple(node.names[i] for i in keep),
                prune(node.child, child_req))
        if isinstance(node, L.Union):
            # positional: every column of both sides is kept
            return node.with_children(tuple(
                prune(c, set(c.schema.names)) for c in node.children()))
        raise NotImplementedError(
            f"column pruning for {type(node).__name__}")

    return prune(plan, set(plan.schema.names))


def _prune_join(node: L.Join, required: set, prune) -> L.Join:
    """Join branch of prune_columns. ``required`` and the condition's
    names live in the OUTPUT name space (right-side duplicates carry
    '#2' suffixes); they are mapped back to source columns before each
    side is pruned."""
    refs = set(required)
    if node.condition is not None:
        refs |= node.condition.references()
    seen: set = set()
    left_req: set = set()
    right_req: set = set()
    entries = []  # (out_name, side_req_set, src_name) in dedup order
    for side_req, names in ((left_req, node.left.schema.names),
                            (right_req, node.right.schema.names)):
        for n in names:
            out = n
            while out in seen:
                out = out + "#2"
            seen.add(out)
            entries.append((out, side_req, n))
    lookup = {out: (side_req, src) for out, side_req, src in entries}
    needed = {out for out, _, _ in entries if out in refs}
    # '#2' suffixes are collision-dependent: keeping 'x#2' only stays
    # named 'x#2' if every dedup ancestor ('x') survives too
    for out in list(needed):
        base = out
        while base.endswith("#2"):
            base = base[:-2]
            if base in lookup:
                needed.add(base)
    for out in needed:
        side_req, src = lookup[out]
        side_req.add(src)
    for k in node.left_keys:
        left_req |= k.references()
    for k in node.right_keys:
        right_req |= k.references()
    return dataclasses.replace(node, left=prune(node.left, left_req),
                               right=prune(node.right, right_req))


# ---- rule executor ----------------------------------------------------------

Rule = Callable[[L.LogicalPlan], L.LogicalPlan]

_FIXED_POINT_BATCH: Tuple[Rule, ...] = (
    constant_folding,
    simplify_booleans,
    push_down_predicates,
    extract_equi_joins,
    extract_condition_keys,
    collapse_projects,
    prune_filters,
)

MAX_ITERATIONS = 20  # reference: RuleExecutor FixedPoint(100); ours converge fast


def optimize(plan: L.LogicalPlan) -> L.LogicalPlan:
    """Run rule batches to fixpoint, reorder inner-join clusters by cost,
    then one column-pruning pass (reference: RuleExecutor.execute,
    rules/RuleExecutor.scala). Join reordering always runs, as under the
    reference's default settings. Runtime filters (off by default in the
    reference) and session-injected rules are not ported yet."""
    from spark_tpu_torch.plan.join_reorder import reorder_joins

    for _ in range(MAX_ITERATIONS):
        new_plan = plan
        for rule in _FIXED_POINT_BATCH:
            new_plan = rule(new_plan)
        if new_plan.tree_string() == plan.tree_string():
            plan = new_plan
            break
        plan = new_plan
    return prune_columns(reorder_joins(plan))
