"""Physical operators, run eagerly over torch tensors.

The port of the single-device main path of
``spark_tpu/physical/operators.py``: scan, filter, project, sort, limit
and grouped aggregation. A pipeline carries ``(cols: {name: TV},
row_mask)``; filters flip mask bits, projections rebuild the dict —
shapes never change mid-stage. The reference fuses traceable operators
into one XLA program; here every operator runs eagerly
(``execute(child_pipes) -> Pipe``) and the planner evaluates the tree
recursively.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import torch

from spark_tpu_torch import types as T
from spark_tpu_torch.columnar.batch import Batch, BatchData, ColumnData
from spark_tpu_torch.expr import compiler as C
from spark_tpu_torch.expr import expressions as E
from spark_tpu_torch.expr.compiler import TV, Env
from spark_tpu_torch.physical import kernels as K
from spark_tpu_torch.types import Field, Schema


class Pipe:
    """Pipeline state flowing between operators."""

    __slots__ = ("cols", "mask", "order")

    def __init__(self, cols: Dict[str, TV], mask: torch.Tensor,
                 order: Sequence[str]):
        self.cols = cols
        self.mask = mask
        self.order = list(order)

    @property
    def capacity(self) -> int:
        return int(self.mask.shape[0])

    def env(self) -> Env:
        return Env(self.cols, self.capacity, self.mask)

    @classmethod
    def from_batch(cls, batch: Batch) -> "Pipe":
        cols = {
            f.name: TV(cd.data, cd.validity, f.dtype, f.dictionary)
            for f, cd in zip(batch.schema.fields, batch.data.columns)}
        return cls(cols, batch.data.row_mask, batch.schema.names)

    def to_batch(self) -> Batch:
        fields = []
        cds = []
        for name in self.order:
            tv = self.cols[name]
            fields.append(Field(name, tv.dtype,
                                nullable=tv.validity is not None,
                                dictionary=tv.dictionary))
            cds.append(ColumnData(tv.data, tv.validity))
        return Batch(Schema(tuple(fields)),
                     BatchData(tuple(cds), self.mask))


class PhysicalPlan:
    """Base physical operator."""

    def children(self) -> Tuple["PhysicalPlan", ...]:
        return ()

    @property
    def schema(self) -> Schema:
        raise NotImplementedError

    def execute(self, child_pipes: List[Pipe]) -> Pipe:
        raise NotImplementedError

    def tree_string(self, indent: int = 0) -> str:
        line = "  " * indent + self.node_string()
        return "\n".join([line] + [c.tree_string(indent + 1)
                                   for c in self.children()])

    def node_string(self) -> str:
        return type(self).__name__

    def __repr__(self):
        return self.tree_string()


# ---- leaves ----------------------------------------------------------------


@dataclass(eq=False)
class BatchScanExec(PhysicalPlan):
    """Scan over an in-memory device batch."""

    batch: Batch

    @property
    def schema(self) -> Schema:
        return self.batch.schema

    def execute(self, child_pipes: List[Pipe]) -> Pipe:
        return Pipe.from_batch(self.batch)

    def node_string(self):
        return f"BatchScan{list(self.schema.names)}"


# ---- pipelined unary ops ----------------------------------------------------


@dataclass(eq=False)
class ProjectExec(PhysicalPlan):
    exprs: Tuple[E.Expression, ...]
    child: PhysicalPlan

    def children(self):
        return (self.child,)

    @property
    def schema(self) -> Schema:
        cs = self.child.schema
        fields = []
        for e in self.exprs:
            inner = E.strip_alias(e)
            dictionary = None
            if isinstance(inner, E.Col) and inner.col_name in cs:
                dictionary = cs.field(inner.col_name).dictionary
            fields.append(Field(e.name, e.data_type(cs), e.nullable(cs),
                                dictionary))
        return Schema(tuple(fields))

    def execute(self, child_pipes: List[Pipe]) -> Pipe:
        pipe = child_pipes[0]
        env = pipe.env()
        cols = {e.name: C.evaluate(e, env) for e in self.exprs}
        return Pipe(cols, pipe.mask, [e.name for e in self.exprs])

    def node_string(self):
        return f"Project[{', '.join(str(e) for e in self.exprs)}]"


@dataclass(eq=False)
class FilterExec(PhysicalPlan):
    condition: E.Expression
    child: PhysicalPlan

    def children(self):
        return (self.child,)

    @property
    def schema(self) -> Schema:
        return self.child.schema

    def execute(self, child_pipes: List[Pipe]) -> Pipe:
        pipe = child_pipes[0]
        tv = C.evaluate(self.condition, pipe.env())
        keep = tv.data & tv.valid_or_true(pipe.capacity)
        return Pipe(pipe.cols, pipe.mask & keep, pipe.order)

    def node_string(self):
        return f"Filter[{self.condition}]"


def _take(tv: TV, perm: torch.Tensor) -> TV:
    return TV(tv.data[perm],
              None if tv.validity is None else tv.validity[perm],
              tv.dtype, tv.dictionary)


@dataclass(eq=False)
class SortExec(PhysicalPlan):
    """Global sort: chained stable argsorts."""

    orders: Tuple[E.SortOrder, ...]
    child: PhysicalPlan

    def children(self):
        return (self.child,)

    @property
    def schema(self) -> Schema:
        return self.child.schema

    def execute(self, child_pipes: List[Pipe]) -> Pipe:
        pipe = child_pipes[0]
        env = pipe.env()
        keys = []
        for o in self.orders:
            tv = C.evaluate(o.child, env)
            keys.append(K.SortKey(tv.data, tv.validity, o.ascending,
                                  o.nulls_first_resolved))
        perm = K.lexsort_permutation(keys, pipe.mask)
        cols = {name: _take(tv, perm) for name, tv in pipe.cols.items()}
        return Pipe(cols, pipe.mask[perm], pipe.order)

    def node_string(self):
        return f"Sort[{', '.join(map(str, self.orders))}]"


@dataclass(eq=False)
class LimitExec(PhysicalPlan):
    """Keep first n live rows."""

    n: int
    child: PhysicalPlan
    offset: int = 0

    def children(self):
        return (self.child,)

    @property
    def schema(self) -> Schema:
        return self.child.schema

    def execute(self, child_pipes: List[Pipe]) -> Pipe:
        pipe = child_pipes[0]
        return Pipe(pipe.cols, K.limit_mask(pipe.mask, self.n, self.offset),
                    pipe.order)

    def node_string(self):
        return f"Limit[{self.n}]"


# ---- aggregation ------------------------------------------------------------

_DIRECT_CARDINALITY_LIMIT = 1 << 22  # packed-key segment count bound


def rewrite_agg_outputs(
    groupings: Tuple[E.Expression, ...],
    aggregates: Tuple[E.Expression, ...],
) -> Tuple[Tuple[E.Expression, ...], List[E.AggregateExpression]]:
    """Rewrite output expressions so aggregate calls become __agg{i} col
    refs and grouping subtrees become __key{j} col refs; returns the
    rewritten outputs plus the distinct aggregate calls."""
    agg_calls: List[E.AggregateExpression] = []
    agg_keys: List[tuple] = []
    grouping_keys = [E.expr_key(g) for g in groupings]

    def rewrite(e: E.Expression) -> E.Expression:
        """Top-down: a whole subtree matching a grouping / aggregate is
        replaced before descending."""
        sk = E.expr_key(e)
        for j, gk in enumerate(grouping_keys):
            if sk == gk:
                return E.Col(f"__key{j}")
        if isinstance(e, E.AggregateExpression):
            for i, k in enumerate(agg_keys):
                if k == sk:
                    return E.Col(f"__agg{i}")
            agg_calls.append(e)
            agg_keys.append(sk)
            return E.Col(f"__agg{len(agg_calls) - 1}")
        if isinstance(e, E.Alias):
            return E.Alias(rewrite(e.child), e.alias_name)
        # generic rebuild with rewritten expression-valued fields
        new_fields = {}
        changed = False
        for fl in dataclasses.fields(e):
            v = getattr(e, fl.name)
            if isinstance(v, E.Expression):
                nv = rewrite(v)
                changed |= nv is not v
                new_fields[fl.name] = nv
            elif isinstance(v, tuple) and any(
                    isinstance(x, E.Expression) for x in v):
                nv = tuple(rewrite(x) if isinstance(x, E.Expression) else x
                           for x in v)
                changed |= any(a is not b for a, b in zip(nv, v))
                new_fields[fl.name] = nv
            else:
                new_fields[fl.name] = v
        return dataclasses.replace(e, **new_fields) if changed else e

    outputs = []
    for e in aggregates:
        name = e.name
        ne = rewrite(e)
        if ne.name != name:
            ne = E.Alias(ne, name)
        outputs.append(ne)
    return tuple(outputs), agg_calls


def group_key_codes(key_tvs: List[TV]):
    """Small-int codes + cardinalities for direct (packed) grouping."""
    codes, validities, cards = [], [], []
    for tv in key_tvs:
        if isinstance(tv.dtype, T.BooleanType):
            codes.append(tv.data.to(torch.int32))
            validities.append(tv.validity)
            cards.append(2)
        elif isinstance(tv.dtype, T.StringType) and tv.dictionary is not None:
            codes.append(tv.data)
            validities.append(tv.validity)
            cards.append(max(1, len(tv.dictionary)))
        else:
            raise ValueError(
                "direct agg path needs a key cardinality known up front")
    return codes, validities, cards


def sorted_groups(pipe: Pipe, key_tvs: List[TV]):
    """Sort rows by grouping keys and assign change-flag group ids.
    Returns (sorted_pipe, sorted_key_tvs, seg_ids, num_groups)."""
    keys = [K.SortKey(tv.data, tv.validity, True, True) for tv in key_tvs]
    perm = K.lexsort_permutation(keys, pipe.mask)
    spipe = Pipe({name: _take(tv, perm) for name, tv in pipe.cols.items()},
                 pipe.mask[perm], pipe.order)
    sorted_keys = [_take(tv, perm) for tv in key_tvs]
    seg, ng = K.group_ids_from_sorted(
        [(tv.data, tv.validity) for tv in sorted_keys], spipe.mask)
    return spipe, sorted_keys, seg, ng


def first_group_keys(sorted_keys: List[TV], seg, mask, num_segments: int,
                     capacity: int, sorted_seg: bool = False) -> List[TV]:
    """Representative (first-row) key values per group."""
    out = []
    for tv in sorted_keys:
        data, found = K.seg_first(tv.data, seg, mask, num_segments, capacity,
                                  sorted_seg)
        if tv.validity is None:
            valid = None
        else:
            vdata, _ = K.seg_first(tv.validity, seg, mask, num_segments,
                                   capacity, sorted_seg)
            valid = vdata & found
        out.append(TV(data, valid, tv.dtype, tv.dictionary))
    return out


def decimal_sum_type(dt: "T.DecimalType") -> "T.DecimalType":
    """Sum widens decimals by 10 integral digits (Sum.scala)."""
    return T.bounded_decimal(dt.precision + 10, dt.scale)


def decimal_avg(total, cnt, dt: "T.DecimalType"):
    """Exact decimal average from a scaled-int sum and a count:
    (sum * 10^(s'-s)) / count with HALF_UP rounding, result scale s+4
    (Average.scala)."""
    out_dt = T.bounded_decimal(dt.precision + 4, dt.scale + 4)
    num = total * (10 ** (out_dt.scale - dt.scale))
    cc = cnt.clamp(min=1)
    data = torch.sign(num) * torch.div(num.abs() + torch.div(
        cc, 2, rounding_mode="floor"), cc, rounding_mode="floor")
    return data, out_dt


def _compute_agg(agg: E.AggregateExpression, env: Env, seg, mask,
                 num_segments: int, capacity: int,
                 sorted_seg: bool = False) -> TV:
    """Compute one aggregate over segments. Nulls in the input are
    excluded per SQL semantics; a group with no valid input yields NULL
    (except count). ``sorted_seg`` marks monotone segment ids."""
    if isinstance(agg, E.Count) and agg.child is None:
        cnt = K.seg_count(seg, mask, num_segments, sorted_seg)
        return TV(cnt, None, T.INT64, None)

    tv = C.evaluate(agg.child, env)  # type: ignore[attr-defined]
    ok = mask & tv.valid_or_true(capacity)
    any_valid = K.seg_count(seg, ok, num_segments, sorted_seg) > 0

    if isinstance(agg, E.Count):
        cnt = K.seg_count(seg, ok, num_segments, sorted_seg)
        return TV(cnt, None, T.INT64, None)
    if isinstance(agg, E.Sum):
        if isinstance(tv.dtype, T.DecimalType):
            # exact scaled-int64 sum (reference: Sum.scala resultType)
            s = K.seg_sum(tv.data, seg, ok, num_segments, sorted_seg)
            return TV(s, any_valid, decimal_sum_type(tv.dtype), None)
        out_dt = T.INT64 if tv.dtype.is_integral else tv.dtype
        data = tv.data.to(C._torch_dtype(out_dt))
        s = K.seg_sum(data, seg, ok, num_segments, sorted_seg)
        return TV(s, any_valid, out_dt, None)
    if isinstance(agg, E.Avg):
        c = K.seg_count(seg, ok, num_segments, sorted_seg)
        if isinstance(tv.dtype, T.DecimalType):
            total = K.seg_sum(tv.data, seg, ok, num_segments, sorted_seg)
            data, out_dt = decimal_avg(total, c, tv.dtype)
            return TV(data, any_valid, out_dt, None)
        s = K.seg_sum(tv.data.to(torch.float64), seg, ok, num_segments,
                      sorted_seg)
        data = s / c.clamp(min=1).to(torch.float64)
        return TV(data, any_valid, T.FLOAT64, None)
    if isinstance(agg, E.Min):
        m = K.seg_min(tv.data, seg, ok, num_segments, sorted_seg)
        return TV(m, any_valid, tv.dtype, tv.dictionary)
    if isinstance(agg, E.Max):
        m = K.seg_max(tv.data, seg, ok, num_segments, sorted_seg)
        return TV(m, any_valid, tv.dtype, tv.dictionary)
    raise NotImplementedError(f"aggregate {agg!r} is not ported yet")


@dataclass(eq=False)
class HashAggregateExec(PhysicalPlan):
    """Group-by aggregation, with the reference's two strategies:

    - **direct**: every grouping key has a cardinality known from the
      schema (string dictionary / boolean) -> mixed-radix pack to dense
      group ids -> segment reductions. No sort, no host sync.
    - **sorted**: sort rows by keys, change-flag cumsum assigns group
      ids, and the group count comes to the host to size the output
      (``num_segments = bucket(groups, 256)``).
    """

    groupings: Tuple[E.Expression, ...]
    aggregates: Tuple[E.Expression, ...]
    child: PhysicalPlan

    def children(self):
        return (self.child,)

    def _static_direct_ok(self) -> bool:
        """Can we guarantee the direct path from schema info alone?"""
        cs = self.child.schema
        total = 1
        for g in self.groupings:
            dt = g.data_type(cs)
            if isinstance(dt, T.BooleanType):
                total *= 3
            elif isinstance(dt, T.StringType):
                inner = E.strip_alias(g)
                if not (isinstance(inner, E.Col) and inner.col_name in cs
                        and cs.field(inner.col_name).dictionary is not None):
                    return False
                total *= len(cs.field(inner.col_name).dictionary) + 1
            else:
                return False
            if total > _DIRECT_CARDINALITY_LIMIT:
                return False
        return True

    @property
    def schema(self) -> Schema:
        cs = self.child.schema
        fields = []
        for e in self.aggregates:
            inner = E.strip_alias(e)
            dictionary = None
            if isinstance(inner, E.Col) and inner.col_name in cs:
                dictionary = cs.field(inner.col_name).dictionary
            elif isinstance(inner, (E.Min, E.Max)):
                c = E.strip_alias(inner.child)
                if isinstance(c, E.Col) and c.col_name in cs:
                    dictionary = cs.field(c.col_name).dictionary
            fields.append(Field(e.name, e.data_type(cs), e.nullable(cs),
                                dictionary))
        return Schema(tuple(fields))

    def _finalize(self, key_tvs: List[TV], agg_tvs: List[TV],
                  out_mask: torch.Tensor, num_segments: int) -> Pipe:
        outputs, _ = rewrite_agg_outputs(self.groupings, self.aggregates)
        cols = {f"__key{j}": tv for j, tv in enumerate(key_tvs)}
        cols.update({f"__agg{i}": tv for i, tv in enumerate(agg_tvs)})
        env = Env(cols, num_segments, device=out_mask.device)
        out_cols = {e.name: C.evaluate(e, env) for e in outputs}
        return Pipe(out_cols, out_mask, [e.name for e in outputs])

    def execute(self, child_pipes: List[Pipe]) -> Pipe:
        pipe = child_pipes[0]
        if self._static_direct_ok():
            return self._execute_direct(pipe)
        return self._execute_sorted(pipe)

    # -- direct (packed-key) path --------------------------------------------

    def _execute_direct(self, pipe: Pipe) -> Pipe:
        env = pipe.env()
        cap = pipe.capacity
        dev = pipe.mask.device
        key_tvs = [C.evaluate(g, env) for g in self.groupings]
        codes, validities, cards = group_key_codes(key_tvs)

        if not key_tvs:
            seg = torch.zeros((cap,), dtype=torch.int32, device=dev)
            num_segments = 1
        else:
            seg, num_segments = K.pack_codes(codes, validities, cards)
            seg = seg.to(torch.int32)

        _, agg_calls = rewrite_agg_outputs(self.groupings, self.aggregates)
        agg_tvs = [_compute_agg(a, env, seg, pipe.mask, num_segments, cap)
                   for a in agg_calls]

        group_present = K.seg_count(seg, pipe.mask, num_segments) > 0
        if not key_tvs:
            out_mask = torch.ones((1,), dtype=torch.bool, device=dev)
            out_keys: List[TV] = []
        else:
            out_mask = group_present
            nullable = [v is not None for v in validities]
            unpacked = K.unpack_code(
                torch.arange(num_segments, device=dev), cards, nullable)
            out_keys = []
            for (code, valid), tv in zip(unpacked, key_tvs):
                data = code.to(C._torch_dtype(tv.dtype))
                out_keys.append(TV(data, valid, tv.dtype, tv.dictionary))
        return self._finalize(out_keys, agg_tvs, out_mask,
                              max(1, num_segments))

    # -- sort-based path ------------------------------------------------------

    def _execute_sorted(self, pipe: Pipe) -> Pipe:
        env = pipe.env()
        cap = pipe.capacity
        key_tvs = [C.evaluate(g, env) for g in self.groupings]
        pipe2, sorted_keys, seg, ng = sorted_groups(pipe, key_tvs)
        n_groups = max(1, int(ng))  # host sync: output sizing
        num_segments = K.bucket(n_groups, 256)
        env2 = pipe2.env()
        _, agg_calls = rewrite_agg_outputs(self.groupings, self.aggregates)
        agg_tvs = [_compute_agg(a, env2, seg, pipe2.mask, num_segments, cap,
                                sorted_seg=True)
                   for a in agg_calls]
        out_keys = first_group_keys(sorted_keys, seg, pipe2.mask,
                                    num_segments, cap, sorted_seg=True)
        out_mask = torch.arange(num_segments, device=seg.device) < n_groups
        return self._finalize(out_keys, agg_tvs, out_mask, num_segments)

    def node_string(self):
        return (f"HashAggregate[keys=[{', '.join(map(str, self.groupings))}], "
                f"out=[{', '.join(str(e) for e in self.aggregates)}]]")
