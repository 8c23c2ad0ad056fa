"""Logical plans, trimmed to the nodes the single-device aggregate,
join, subquery, window, file-scan and nested-type slices plan:
relations, file scans with pushed projections and predicates, ranges,
projections, filters, aggregates, the grouping-sets ``Expand``, windows,
``Generate`` (explode), ``Sample``, sorts, limits, DISTINCT, subquery
aliases, joins and unions.

A projection or aggregate that outputs an array also outputs its
``<name>#len`` companion, and a map-typed projection item its
``#keys``/``#vals`` pair (types.ArrayType, types.MapType), in the
logical schema as in the physical one.

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

from spark_tpu_torch import types as T
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

    def structural_key(self) -> tuple:
        """Injective structural identity: the node types, their fields
        and expressions, and the identity of leaf batches and sources
        (``node_string`` is for display and may omit fields)."""
        parts: list = [type(self).__name__]
        for f in dataclasses.fields(self):
            parts.append(_field_key(getattr(self, f.name)))
        return tuple(parts)

    def __repr__(self):
        return self.tree_string()


def _field_key(v):
    if isinstance(v, LogicalPlan):
        return v.structural_key()
    if isinstance(v, E.Expression):
        return E.expr_key(v)
    if isinstance(v, tuple):
        return tuple(_field_key(x) for x in v)
    if v.__class__.__module__ == "builtins" and not callable(v):
        return repr(v)
    return ("obj", id(v))  # sources and batches: identity


def collect_nodes(plan: LogicalPlan, cls) -> list:
    """All nodes of type ``cls`` in the tree, in pre-order."""
    out = [plan] if isinstance(plan, cls) else []
    for c in plan.children():
        out += collect_nodes(c, cls)
    return out


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


@dataclass(eq=False, frozen=True)
class Range(LogicalPlan):
    """spark.range(start, end, step) (reference: basicLogicalOperators
    Range + RangeExec basicPhysicalOperators.scala:412), and the one-row
    relation of a SELECT without FROM. Generated on the device."""

    start: int
    end: int
    step: int = 1
    col_name: str = "id"

    @property
    def schema(self) -> Schema:
        return Schema((Field(self.col_name, T.INT64, nullable=False),))

    @property
    def num_rows(self) -> int:
        return range_rows(self.start, self.end, self.step)

    def node_string(self):
        return f"Range({self.start}, {self.end}, {self.step})"


@dataclass(eq=False, frozen=True)
class UnresolvedScan(LogicalPlan):
    """A file scan with pushed-down projection and predicates (the DSv2
    Scan with SupportsPushDownRequiredColumns/Filters, reference:
    connector/read/SupportsPushDown*.java; physical peer
    FileSourceScanExec). ``columns=None`` means all; ``filters`` are
    exact (the source prunes files and row groups and filters rows by
    them)."""

    source: Any  # io.datasource.FileSource
    options: Tuple[Tuple[str, str], ...] = ()
    columns: Optional[Tuple[str, ...]] = None
    filters: Tuple[E.Expression, ...] = ()

    @property
    def schema(self) -> Schema:
        full = self.source.schema
        if self.columns is None:
            return full
        return Schema(tuple(full.field(n) for n in self.columns))

    def node_string(self):
        parts = [str(self.source)]
        if self.columns is not None:
            parts.append(f"cols={list(self.columns)}")
        if self.filters:
            parts.append(f"pushed=[{', '.join(map(str, self.filters))}]")
        return f"Scan({', '.join(parts)})"


def range_rows(start: int, end: int, step: int) -> int:
    """Row count of ``range(start, end, step)``."""
    if step == 0:
        return 0
    n = end - start + step - (1 if step > 0 else -1)
    return max(0, n // step)


# ---- unary -----------------------------------------------------------------


@dataclass(eq=False, frozen=True)
class Project(LogicalPlan):
    exprs: Tuple[E.Expression, ...]
    child: LogicalPlan

    def children(self):
        return (self.child,)

    @cached_property
    def schema(self) -> Schema:
        return projection_schema(self.exprs, self.child.schema)

    def node_string(self):
        return f"Project[{', '.join(str(e) for e in self.exprs)}]"


def with_len_companions(fields) -> Schema:
    """``fields`` with each array field followed by its ``#len``
    companion (int32, never null), unless the list names that companion
    itself."""
    names = {f.name for f in fields}
    out = []
    for f in fields:
        out.append(f)
        comp = T.array_len_col(f.name)
        if isinstance(f.dtype, T.ArrayType) and comp not in names:
            out.append(Field(comp, T.INT32, nullable=False))
    return Schema(tuple(out))


def map_outputs(e: E.Expression, cs: Schema):
    """The ``(keys name, values name)`` a map-typed projection item
    expands into, or None when ``e`` is not map-typed."""
    try:
        dt = e.data_type(cs)
    except (KeyError, TypeError):
        return None
    if not isinstance(dt, T.MapType):
        return None
    return T.map_keys_col(e.name), T.map_vals_col(e.name)


def projection_schema(exprs, cs: Schema) -> Schema:
    """Output schema of a projection over ``cs``: a map item becomes its
    ``#keys``/``#vals`` array pair, and every array its ``#len``
    companion (the physical ProjectExec emits exactly these)."""
    fields = []
    for e in exprs:
        dt = e.data_type(cs)
        if isinstance(dt, T.MapType):
            kn, vn = map_outputs(e, cs)
            nullable = e.nullable(cs)
            fields.append(Field(kn, T.ArrayType(dt.key), nullable))
            fields.append(Field(vn, T.ArrayType(dt.value), nullable))
            continue
        inner = E.strip_alias(e)
        dictionary = None
        if isinstance(inner, E.Col) and inner.col_name in cs:
            dictionary = cs.field(inner.col_name).dictionary
        fields.append(Field(e.name, dt, e.nullable(cs), dictionary))
    return with_len_companions(fields)


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
        return with_len_companions(fields)

    def node_string(self):
        return (f"Aggregate[keys=[{', '.join(map(str, self.groupings))}], "
                f"out=[{', '.join(str(e) for e in self.aggregates)}]]")


def expand_schema(projections, names, cs: Schema) -> Schema:
    """Output schema of an Expand over a child of schema ``cs``: each
    column's common type over the projections, nullable when any is,
    and the dictionary of a column a projection passes through."""
    fields = []
    for i, name in enumerate(names):
        dt = projections[0][i].data_type(cs)
        nullable = False
        dictionary = None
        for proj in projections:
            e = proj[i]
            dt = T.common_type(dt, e.data_type(cs))
            nullable = nullable or e.nullable(cs)
            inner = E.strip_alias(e)
            if isinstance(inner, E.Col) and inner.col_name in cs:
                dictionary = dictionary or cs.field(inner.col_name).dictionary
        fields.append(Field(name, dt, nullable, dictionary))
    return with_len_companions(fields)


@dataclass(eq=False, frozen=True)
class Expand(LogicalPlan):
    """Replicate the input once per projection (reference: plans/logical
    Expand + execution/ExpandExec.scala:1, the engine under
    ROLLUP/CUBE/GROUPING SETS). Output capacity is the child's times
    ``len(projections)``."""

    projections: Tuple[Tuple[E.Expression, ...], ...]
    names: Tuple[str, ...]
    child: LogicalPlan

    def children(self):
        return (self.child,)

    @cached_property
    def schema(self) -> Schema:
        return expand_schema(self.projections, self.names, self.child.schema)

    def node_string(self):
        return f"Expand[{len(self.projections)} sets]"


def window_schema(window_exprs, cs: Schema) -> Schema:
    """The child's columns followed by one column per window output."""
    fields = list(cs.fields)
    for e in window_exprs:
        fields.append(Field(e.name, e.data_type(cs), e.nullable(cs),
                            E.window_dictionary(E.strip_alias(e), cs)))
    return Schema(tuple(fields))


@dataclass(eq=False, frozen=True)
class Window(LogicalPlan):
    """Append window-function columns to the child's output (reference:
    plans/logical/basicLogicalOperators.scala Window +
    execution/window/WindowExec.scala:87). Each entry is an
    Alias(WindowExpr, out_name); the physical operator groups them by
    (partition, order) spec."""

    window_exprs: Tuple[E.Alias, ...]
    child: LogicalPlan

    def children(self):
        return (self.child,)

    @cached_property
    def schema(self) -> Schema:
        return window_schema(self.window_exprs, self.child.schema)

    def node_string(self):
        return f"Window[{', '.join(str(e) for e in self.window_exprs)}]"


def project_with_windows(exprs: Tuple[E.Expression, ...],
                         child: LogicalPlan) -> LogicalPlan:
    """Project(exprs, child), with every WindowExpr hoisted into a Window
    node below the projection as a ``__w{i}`` column (the analyzer's
    ExtractWindowExpressions rule, reference: analysis/Analyzer.scala)."""
    win: list = []
    new_exprs: list = []

    def repl(x: E.Expression) -> E.Expression:
        if isinstance(x, E.WindowExpr):
            nm = f"__w{len(win)}"
            win.append(E.Alias(x, nm))
            return E.Col(nm)
        return x

    for e in exprs:
        if not E.contains_window(e):
            new_exprs.append(e)
            continue
        ne = E.transform_expr(E.strip_alias(e), repl)
        new_exprs.append(E.Alias(ne, e.name))
    if not win:
        return Project(tuple(exprs), child)
    return Project(tuple(new_exprs), Window(tuple(win), child))


def generate_schema(generator: E.Explode, out_name: str,
                    pos_name: Optional[str], cs: Schema) -> Schema:
    """The child's columns, then [pos,] the generated element."""
    fields = list(cs.fields)
    if pos_name is not None:
        fields.append(Field(pos_name, T.INT32, nullable=False))
    dictionary = None
    inner = E.strip_alias(generator.child)
    if isinstance(inner, E.Col) and inner.col_name in cs:
        dictionary = cs.field(inner.col_name).dictionary
    fields.append(Field(out_name, generator.data_type(cs), nullable=False,
                        dictionary=dictionary))
    return Schema(tuple(fields))


@dataclass(eq=False, frozen=True)
class Generate(LogicalPlan):
    """One output row per array element, the child's columns repeated
    (reference: plans/logical Generate, execution/GenerateExec.scala;
    SQL: explode in a SELECT list, LATERAL VIEW). ``generator`` is an
    ``E.Explode``; the output appends [pos,] value."""

    generator: E.Expression
    out_name: str
    pos_name: Optional[str]  # posexplode's position column
    child: LogicalPlan

    def children(self):
        return (self.child,)

    @cached_property
    def schema(self) -> Schema:
        return generate_schema(self.generator, self.out_name, self.pos_name,
                               self.child.schema)

    def node_string(self):
        return f"Generate[{self.generator} AS {self.out_name}]"


@dataclass(eq=False, frozen=True)
class Sample(LogicalPlan):
    """Each row kept when its draw from the seeded stream is below
    ``fraction`` (reference: Sample; ``physical/random.py`` holds the
    stream)."""

    fraction: float
    seed: int
    child: LogicalPlan

    def children(self):
        return (self.child,)

    @property
    def schema(self) -> Schema:
        return self.child.schema

    def node_string(self):
        return f"Sample[{self.fraction}, seed={self.seed}]"


@dataclass(eq=False, frozen=True)
class Repartition(LogicalPlan):
    """repartition(n[, keys]) / coalesce(n): an explicit exchange request
    (reference: Repartition + RepartitionByExpression). One device runs
    its child unchanged; a mesh plans it as a hash exchange on ``keys``,
    or a round-robin one without keys (``parallel/executor.py``)."""

    num_partitions: int
    keys: Tuple[E.Expression, ...]
    child: LogicalPlan

    def children(self):
        return (self.child,)

    @property
    def schema(self) -> Schema:
        return self.child.schema


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


JOIN_TYPES = ("inner", "left", "right", "full", "left_semi", "left_anti",
              "cross")


@dataclass(eq=False, frozen=True)
class Join(LogicalPlan):
    left: LogicalPlan
    right: LogicalPlan
    how: str  # one of JOIN_TYPES
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


@dataclass(eq=False, frozen=True)
class Union(LogicalPlan):
    """UNION ALL by position; names and types come from the left side
    (Spark semantics)."""

    left: LogicalPlan
    right: LogicalPlan

    def children(self):
        return (self.left, self.right)

    @property
    def schema(self) -> Schema:
        return self.left.schema
