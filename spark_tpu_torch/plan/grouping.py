"""GROUPING SETS / ROLLUP / CUBE planning (reference:
analysis ResolveGroupingAnalytics in Analyzer.scala +
execution/ExpandExec.scala:1 + grouping.scala Grouping/GroupingID).

The input replicates once per grouping set through an Expand node; each
replica carries the set's keys (others typed-NULL via NullOf) plus a
literal grouping id, and the ordinary aggregation paths run over
(masked keys..., grouping_id). grouping()/grouping_id() calls rewrite
to arithmetic over the id column; references to grouping keys OUTSIDE
aggregate calls rewrite to the masked columns."""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

from spark_tpu_torch import types as T
from spark_tpu_torch.expr import expressions as E
from spark_tpu_torch.plan import logical as L

GID = "__grouping_id"


def _bit_test(gid_ref: E.Expression, bit: int) -> E.Expression:
    """grouping() bit extraction with integer ops only (int / int is
    DOUBLE in this SQL dialect): (gid % 2^(bit+1)) >= 2^bit."""
    return E.Cast(
        E.Cmp(">=", E.Arith("%", gid_ref, E.Literal(1 << (bit + 1))),
              E.Literal(1 << bit)),
        T.INT32)


def contains_grouping_fns(e: E.Expression) -> bool:
    if isinstance(e, (E.Grouping, E.GroupingId)):
        return True
    return any(contains_grouping_fns(c) for c in e.children())


def rewrite_grouping_fns(e: E.Expression,
                         keys: Sequence[E.Expression],
                         gid_col: str) -> E.Expression:
    """Rewrite grouping()/grouping_id() calls AGAINST THE AGGREGATE
    OUTPUT (e.g. in a HAVING predicate sitting above it): they read the
    grouping id from ``gid_col``; key references stay untouched (they
    resolve against the aggregate's output names)."""
    key_bit = {E.expr_key(k): len(keys) - 1 - i
               for i, k in enumerate(keys)}

    def fn(x: E.Expression) -> E.Expression:
        if isinstance(x, E.GroupingId):
            return E.Col(gid_col)
        if isinstance(x, E.Grouping):
            bit = key_bit.get(E.expr_key(x.child))
            if bit is None:
                raise ValueError(
                    f"grouping() argument {x.child} is not a grouping "
                    f"key")
            return _bit_test(E.Col(gid_col), bit)
        return x

    return E.transform_expr_down(e, fn)


MAX_SETS = 64  # cube(6) — capacity multiplies by the set count


def rollup_sets(k: int) -> List[Tuple[int, ...]]:
    return [tuple(range(i)) for i in range(k, -1, -1)]


def cube_sets(k: int) -> List[Tuple[int, ...]]:
    out = []
    for m in range((1 << k) - 1, -1, -1):
        out.append(tuple(i for i in range(k) if m & (1 << (k - 1 - i))))
    return out


def grouping_sets_aggregate(
    child: L.LogicalPlan,
    keys: Sequence[E.Expression],
    sets: Sequence[Tuple[int, ...]],
    outputs: Sequence[E.Expression],
) -> L.LogicalPlan:
    """Build Expand + Aggregate for the given grouping sets, with
    ``outputs`` rewritten into the grouped output space."""
    if len(sets) > MAX_SETS:
        raise NotImplementedError(
            f"{len(sets)} grouping sets would replicate the input "
            f"{len(sets)}x (max {MAX_SETS})")
    k = len(keys)
    child_names = list(child.schema.names)
    gs_names = [f"__gs{i}" for i in range(k)]
    projections = []
    for s in sets:
        proj: List[E.Expression] = [E.Col(n) for n in child_names]
        gid = 0
        for i, key in enumerate(keys):
            if i in s:
                proj.append(key)
            else:
                proj.append(E.NullOf(key))
                gid |= 1 << (k - 1 - i)
        proj.append(E.Literal(gid))
        projections.append(tuple(proj))
    expand = L.Expand(tuple(projections),
                      tuple(child_names + gs_names + [GID]), child)

    key_map = {E.expr_key(key): E.Col(gs_names[i])
               for i, key in enumerate(keys)}
    key_bit = {E.expr_key(key): k - 1 - i for i, key in enumerate(keys)}

    def bit_of(child: E.Expression):
        bit = key_bit.get(E.expr_key(child))
        if bit is None:
            raise ValueError(
                f"grouping() argument {child} is not a grouping key")
        return bit

    def rewrite(expr: E.Expression) -> E.Expression:
        """Grouping-key refs -> masked columns; grouping()/grouping_id()
        -> arithmetic over the id. Aggregate call ARGUMENTS keep the
        original (unmasked) columns, like the reference's Expand."""

        def fn(e: E.Expression) -> E.Expression:
            if isinstance(e, E.AggregateExpression):
                # a fresh copy stops transform_expr_down's descent so
                # the aggregate's inputs stay unmasked
                return dataclasses.replace(e)
            if isinstance(e, E.GroupingId):
                return E.Col(GID)
            if isinstance(e, E.Grouping):
                return _bit_test(E.Col(GID), bit_of(e.child))
            hit = key_map.get(E.expr_key(e))
            if hit is not None:
                return hit
            return e

        return E.transform_expr_down(expr, fn)

    def rw_named(e: E.Expression) -> E.Expression:
        if isinstance(e, E.Alias):
            return E.Alias(rewrite(e.child), e.alias_name)
        r = rewrite(e)
        if r is not e and not isinstance(r, E.Alias):
            # keep the user-facing name (e.g. 'a' not '__gs0')
            return E.Alias(r, e.name)
        return r

    new_outputs = tuple(rw_named(e) for e in outputs)
    groupings = tuple(E.Col(n) for n in gs_names) + (E.Col(GID),)
    return L.Aggregate(groupings, new_outputs, expand)
