"""Logical plans, trimmed to the nodes the single-device aggregate,
join and subquery slices plan: relations, projections, filters,
aggregates, sorts, limits, DISTINCT, subquery aliases and joins.

The analogue of Catalyst's logical operators (reference:
sql/catalyst/src/main/scala/org/apache/spark/sql/catalyst/plans/logical/
basicLogicalOperators.scala) plus the TreeNode transform machinery
(reference: catalyst/trees/TreeNode.scala). Nodes are immutable
dataclasses; ``schema`` resolves output types bottom-up, which folds the
analyzer's resolution role (reference: analysis/Analyzer.scala:188) into
plan construction: the SQL parser resolves names against child schemas
as it builds.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import cached_property
from typing import Any, Callable, Optional, Tuple

from spark_tpu_torch.expr import expressions as E
from spark_tpu_torch.types import Field, Schema


class LogicalPlan:
    """Base class; subclasses are frozen dataclasses."""

    def children(self) -> Tuple["LogicalPlan", ...]:
        return ()

    @property
    def schema(self) -> Schema:
        raise NotImplementedError

    def with_children(self, children: Tuple["LogicalPlan", ...]) -> "LogicalPlan":
        """Rebuild this node with new children (positional)."""
        if not children:
            return self
        fields = {}
        it = iter(children)
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, LogicalPlan):
                fields[f.name] = next(it)
            else:
                fields[f.name] = v
        return dataclasses.replace(self, **fields)

    def transform_up(self, fn: Callable[["LogicalPlan"], "LogicalPlan"]) -> "LogicalPlan":
        new_children = tuple(c.transform_up(fn) for c in self.children())
        node = self.with_children(new_children) if new_children else self
        return fn(node)

    def transform_expressions(self, fn) -> "LogicalPlan":
        """Apply an expression transform to every expression in this node."""
        fields = {}
        changed = False
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            nv = _transform_value(v, fn)
            changed |= nv is not v
            fields[f.name] = nv
        return dataclasses.replace(self, **fields) if changed else self

    def expressions(self) -> Tuple[E.Expression, ...]:
        out = []
        for f in dataclasses.fields(self):
            _collect_exprs(getattr(self, f.name), out)
        return tuple(out)

    def references(self) -> set:
        refs = set()
        for e in self.expressions():
            refs |= e.references()
        return refs

    def tree_string(self, indent: int = 0) -> str:
        line = "  " * indent + self.node_string()
        return "\n".join([line] + [c.tree_string(indent + 1)
                                   for c in self.children()])

    def node_string(self) -> str:
        return type(self).__name__

    def __repr__(self):
        return self.tree_string()


def _transform_value(v, fn):
    if isinstance(v, E.Expression):
        return E.transform_expr(v, fn)
    if isinstance(v, tuple):
        nv = tuple(_transform_value(x, fn) for x in v)
        return nv if any(a is not b for a, b in zip(nv, v)) else v
    return v


def _collect_exprs(v, out: list) -> None:
    if isinstance(v, E.Expression):
        out.append(v)
    elif isinstance(v, tuple):
        for x in v:
            _collect_exprs(x, out)


# ---- leaves ----------------------------------------------------------------


@dataclass(eq=False, frozen=True)
class Relation(LogicalPlan):
    """In-memory relation over an already-built device Batch (analogue of
    LocalRelation, reference: catalyst/plans/logical/LocalRelation.scala)."""

    batch: Any  # columnar.batch.Batch

    @property
    def schema(self) -> Schema:
        return self.batch.schema

    def node_string(self):
        return f"Relation{list(self.schema.names)}"


# ---- unary -----------------------------------------------------------------


@dataclass(eq=False, frozen=True)
class Project(LogicalPlan):
    exprs: Tuple[E.Expression, ...]
    child: LogicalPlan

    def children(self):
        return (self.child,)

    @cached_property
    def schema(self) -> Schema:
        cs = self.child.schema
        fields = []
        for e in self.exprs:
            dt = e.data_type(cs)
            inner = E.strip_alias(e)
            dictionary = None
            if isinstance(inner, E.Col) and inner.col_name in cs:
                dictionary = cs.field(inner.col_name).dictionary
            fields.append(Field(e.name, dt, e.nullable(cs), dictionary))
        return Schema(tuple(fields))

    def node_string(self):
        return f"Project[{', '.join(str(e) for e in self.exprs)}]"


@dataclass(eq=False, frozen=True)
class Filter(LogicalPlan):
    condition: E.Expression
    child: LogicalPlan

    def children(self):
        return (self.child,)

    @property
    def schema(self) -> Schema:
        return self.child.schema

    def node_string(self):
        return f"Filter[{self.condition}]"


@dataclass(eq=False, frozen=True)
class Aggregate(LogicalPlan):
    """GROUP BY. ``groupings`` are key expressions; ``aggregates`` are the
    output expressions (may mix keys and aggregate functions), matching
    the reference (plans/logical/basicLogicalOperators.scala Aggregate)."""

    groupings: Tuple[E.Expression, ...]
    aggregates: Tuple[E.Expression, ...]
    child: LogicalPlan

    def children(self):
        return (self.child,)

    @cached_property
    def schema(self) -> Schema:
        cs = self.child.schema
        fields = []
        for e in self.aggregates:
            dt = e.data_type(cs)
            inner = E.strip_alias(e)
            dictionary = None
            if isinstance(inner, E.Col) and inner.col_name in cs:
                dictionary = cs.field(inner.col_name).dictionary
            elif isinstance(inner, (E.Min, E.Max)):
                c = E.strip_alias(inner.child)
                if isinstance(c, E.Col) and c.col_name in cs:
                    dictionary = cs.field(c.col_name).dictionary
            fields.append(Field(e.name, dt, e.nullable(cs), dictionary))
        return Schema(tuple(fields))

    def node_string(self):
        return (f"Aggregate[keys=[{', '.join(map(str, self.groupings))}], "
                f"out=[{', '.join(str(e) for e in self.aggregates)}]]")


@dataclass(eq=False, frozen=True)
class Sort(LogicalPlan):
    orders: Tuple[E.SortOrder, ...]
    child: LogicalPlan
    is_global: bool = True

    def children(self):
        return (self.child,)

    @property
    def schema(self) -> Schema:
        return self.child.schema

    def node_string(self):
        return f"Sort[{', '.join(map(str, self.orders))}]"


@dataclass(eq=False, frozen=True)
class Limit(LogicalPlan):
    n: int
    child: LogicalPlan
    offset: int = 0

    def children(self):
        return (self.child,)

    @property
    def schema(self) -> Schema:
        return self.child.schema

    def node_string(self):
        return f"Limit[{self.n}]"


@dataclass(eq=False, frozen=True)
class Distinct(LogicalPlan):
    child: LogicalPlan

    def children(self):
        return (self.child,)

    @property
    def schema(self) -> Schema:
        return self.child.schema


@dataclass(eq=False, frozen=True)
class SubqueryAlias(LogicalPlan):
    alias: str
    child: LogicalPlan

    def children(self):
        return (self.child,)

    @property
    def schema(self) -> Schema:
        return self.child.schema

    def node_string(self):
        return f"SubqueryAlias[{self.alias}]"


# ---- binary ----------------------------------------------------------------


def join_schema(how: str, left: Schema, right: Schema) -> Schema:
    """Output schema of a join: the left side's for semi/anti joins,
    else both sides with '#2'-deduplicated right names, the outer side
    of an outer join made nullable."""
    if how in ("left_semi", "left_anti"):
        return left
    lf = list(left.fields)
    rf = list(right.fields)
    if how in ("left", "full"):
        rf = [dataclasses.replace(f, nullable=True) for f in rf]
    if how in ("right", "full"):
        lf = [dataclasses.replace(f, nullable=True) for f in lf]
    names = E.dedup_pair_names([f.name for f in lf], [f.name for f in rf])
    return Schema(tuple(dataclasses.replace(f, name=n)
                        for f, n in zip(lf + rf, names)))


@dataclass(eq=False, frozen=True)
class Join(LogicalPlan):
    left: LogicalPlan
    right: LogicalPlan
    # inner, left, right, full, left_semi, left_anti or cross
    how: str
    # Equi-join keys (left_keys[i] == right_keys[i]); extra non-equi
    # predicates go to ``condition`` and are applied post-match.
    left_keys: Tuple[E.Expression, ...]
    right_keys: Tuple[E.Expression, ...]
    condition: Optional[E.Expression] = None

    def children(self):
        return (self.left, self.right)

    @cached_property
    def schema(self) -> Schema:
        return join_schema(self.how, self.left.schema, self.right.schema)

    def node_string(self):
        ks = ", ".join(f"{l}={r}"
                       for l, r in zip(self.left_keys, self.right_keys))
        return f"Join[{self.how}, keys=({ks}), cond={self.condition}]"
