"""Physical operators, run eagerly over torch tensors.

The port of the single-device main path of
``spark_tpu/physical/operators.py``: scan, filter, project, sort, limit,
compaction, grouped aggregation and the sorted-build equi-join
(``JoinExec``, its blocking path). A pipeline carries ``(cols: {name:
TV}, row_mask)``; filters flip mask bits, projections rebuild the dict —
shapes never change mid-stage. The reference fuses traceable operators
into one XLA program; here every operator runs eagerly
(``execute(child_pipes) -> Pipe``) and the planner evaluates the tree
recursively. ``traceable`` keeps the reference's meaning: the operator
needs no host sync, so the planner does not compact its inputs.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_tpu_torch import types as T
from spark_tpu_torch.columnar.batch import Batch, BatchData, ColumnData
from spark_tpu_torch.expr import compiler as C
from spark_tpu_torch.expr import expressions as E
from spark_tpu_torch.expr.compiler import TV, Env
from spark_tpu_torch.physical import kernels as K
from spark_tpu_torch.plan.logical import join_schema
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

    #: True when ``execute`` needs no host sync (the reference's flag:
    #: such operators fuse into one program there)
    traceable: bool = True

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


@dataclass(eq=False)
class CompactExec(PhysicalPlan):
    """Gather live rows to the front and truncate to a bucketed capacity
    (reference analogue: AQE's CoalesceShufflePartitions.scala). Stable
    compaction preserves sorted row order."""

    child: PhysicalPlan
    cap: int

    def children(self):
        return (self.child,)

    @property
    def schema(self) -> Schema:
        return self.child.schema

    def execute(self, child_pipes: List[Pipe]) -> Pipe:
        pipe = child_pipes[0]
        if self.cap >= pipe.capacity:
            return pipe
        idx = K.compaction_permutation(pipe.mask)[:self.cap]
        cols = {name: _take(pipe.cols[name], idx) for name in pipe.order}
        return Pipe(cols, pipe.mask[idx], pipe.order)

    def node_string(self):
        return f"Compact[{self.cap}]"


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
        # generic rebuild with rewritten expression-valued fields, also
        # inside tuples (Coalesce.args) and tuples of pairs
        # (Case.branches)
        def field(v):
            if isinstance(v, E.Expression):
                return rewrite(v)
            if isinstance(v, tuple):
                nv = tuple(field(x) for x in v)
                return nv if any(a is not b for a, b in zip(nv, v)) else v
            return v

        new_fields = {fl.name: field(getattr(e, fl.name))
                      for fl in dataclasses.fields(e)}
        changed = any(new_fields[fl.name] is not getattr(e, fl.name)
                      for fl in dataclasses.fields(e))
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


def _distinct_mask_cached(env: Env, child: E.Expression, tv: TV, seg,
                          ok) -> torch.Tensor:
    """distinct_first_mask memoized per (env, child expression): several
    DISTINCT aggregates over one column share one (seg, value) sort."""
    cache = getattr(env, "_distinct_cache", None)
    if cache is None:
        cache = env._distinct_cache = {}
    key = E.expr_key(child)
    if key not in cache:
        cache[key] = K.distinct_first_mask(tv.data, seg, ok)
    return cache[key]


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
    if getattr(agg, "distinct", False):
        # keep one ok row per (group, value); any_valid is taken before
        # (the dedup leaves it unchanged)
        ok = ok & _distinct_mask_cached(env, agg.child, tv, seg, ok)

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
    if isinstance(agg, E.First):
        use = ok if agg.ignore_nulls else mask
        data, found = K.seg_first(tv.data, seg, use, num_segments, capacity,
                                  sorted_seg)
        valid = found if tv.validity is None else (
            found & K.seg_first(tv.valid_or_true(capacity), seg, use,
                                num_segments, capacity, sorted_seg)[0])
        return TV(data, valid, tv.dtype, tv.dictionary)
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

    @property
    def traceable(self) -> bool:  # type: ignore[override]
        return self._static_direct_ok()

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
        n_groups = int(ng)  # host sync: output sizing
        # an empty input has no group; the reference sizes with
        # max(1, groups) and so emits one empty group (ROADMAP C)
        num_segments = K.bucket(max(1, n_groups), 256)
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


# ---- join ------------------------------------------------------------------


def _hash_keys(lds, rds):
    """Hash-combine multiple key columns into one int64 per row. Shifted
    right by 2 (logically, on the uint64 bits) so the max value is
    2^62-1 — strictly below the int64 sentinel build_join_ranges uses
    for dead rows."""
    lh = K.hash64(lds[0])
    rh = K.hash64(rds[0])
    for ld, rd in zip(lds[1:], rds[1:]):
        lh = K.hash_combine(lh, ld)
        rh = K.hash_combine(rh, rd)
    return K.shift_right_logical(lh, 2), K.shift_right_logical(rh, 2)


def _verify_key_pairs(prepped, p_idx, b_idx, cap):
    """Exact key equality for hash-matched pairs."""
    ok = torch.ones((cap,), dtype=torch.bool, device=p_idx.device)
    for ld, rd in prepped:
        ok = ok & (ld[p_idx] == rd[b_idx])
    return ok


def _gather_pairs(lpipe: Pipe, rpipe: Pipe, p_idx, b_idx
                  ) -> Tuple[Dict[str, TV], List[str]]:
    """Both sides' columns gathered at the pair indices, under the
    '#2'-deduplicated pair names."""
    pair_names = E.dedup_pair_names(lpipe.order, rpipe.order)
    n_l = len(lpipe.order)
    cols: Dict[str, TV] = {}
    for out_name, src_name in zip(pair_names[:n_l], lpipe.order):
        cols[out_name] = _take(lpipe.cols[src_name], p_idx)
    for out_name, src_name in zip(pair_names[n_l:], rpipe.order):
        cols[out_name] = _take(rpipe.cols[src_name], b_idx)
    return cols, pair_names


@dataclass(eq=False)
class JoinExec(PhysicalPlan):
    """Equi-join via sorted-build + searchsorted ranges (reference:
    ShuffledHashJoinExec.scala:38 / BroadcastHashJoinExec.scala:40 +
    HashedRelation.scala — rebuilt without hash tables, see
    kernels.build_join_ranges). Blocking: the output capacity is the
    host-synced match count. The reference's traced re-execution path
    and its adaptive statistics caches are not ported."""

    left: PhysicalPlan
    right: PhysicalPlan
    how: str
    left_keys: Tuple[E.Expression, ...]
    right_keys: Tuple[E.Expression, ...]
    condition: Optional[E.Expression] = None
    traceable = False

    def children(self):
        return (self.left, self.right)

    @property
    def schema(self) -> Schema:
        return join_schema(self.how, self.left.schema, self.right.schema)

    # -- key normalization ----------------------------------------------------

    def _combined_keys(self, lpipe: Pipe, rpipe: Pipe):
        """Evaluate equi-join keys on both sides and pack them into one
        int64 key per row; strings go through a unified dictionary, ints
        through range compression on min/max stats that come to the host
        in ONE copy for all keys. Returns (left key, left key-valid,
        right key, right key-valid, hashed, per-key (left, right) data):
        ``hashed`` when the packed range would pass 2^62 and the keys
        were hashed instead, so pairs must be verified."""
        lenv, renv = lpipe.env(), rpipe.env()
        lks = [C.evaluate(k, lenv) for k in self.left_keys]
        rks = [C.evaluate(k, renv) for k in self.right_keys]
        dev = lpipe.mask.device
        i64max = torch.full((), K.INT64_MAX, dtype=torch.int64, device=dev)
        i64min = torch.full((), K.INT64_MIN, dtype=torch.int64, device=dev)

        lcomb = torch.zeros((lpipe.capacity,), dtype=torch.int64, device=dev)
        rcomb = torch.zeros((rpipe.capacity,), dtype=torch.int64, device=dev)
        lvalid = torch.ones((lpipe.capacity,), dtype=torch.bool, device=dev)
        rvalid = torch.ones((rpipe.capacity,), dtype=torch.bool, device=dev)

        prepped = []  # (ld, rd, rg_or_None, stat_index_or_None)
        stats = []
        for lt, rt in zip(lks, rks):
            if isinstance(lt.dtype, T.StringType) \
                    or isinstance(rt.dtype, T.StringType):
                union, (tl, tr) = C.unify_dictionaries(
                    (lt.dictionary or (), rt.dictionary or ()))
                ld = (C._gather(tl, lt.data) if len(lt.dictionary or ())
                      else lt.data)
                rd = (C._gather(tr, rt.data) if len(rt.dictionary or ())
                      else rt.data)
                prepped.append((ld, rd, max(1, len(union)), None))
            else:
                ld = lt.data.to(torch.int64)
                rd = rt.data.to(torch.int64)
                lok = lpipe.mask & lt.valid_or_true(lpipe.capacity)
                rok = rpipe.mask & rt.valid_or_true(rpipe.capacity)
                lo = torch.minimum(torch.where(lok, ld, i64max).min(),
                                   torch.where(rok, rd, i64max).min())
                hi = torch.maximum(torch.where(lok, ld, i64min).max(),
                                   torch.where(rok, rd, i64min).max())
                prepped.append((ld, rd, None, len(stats)))
                stats.append(torch.stack([lo, hi]))
        # host sync: every key's (min, max) in one copy
        fetched = torch.stack(stats).tolist() if stats else []

        total_range = 1
        hashed = False
        for ld, rd, rg, si in prepped:
            mn = 0
            if rg is None:
                mn, mx = fetched[si]
                if mn > mx:
                    mn, mx = 0, 0
                rg = mx - mn + 1
            if total_range * rg > (1 << 62):  # incl. single wide key
                hashed = True
                break
            lcomb = lcomb * rg + (ld - mn).clamp(0, rg - 1)
            rcomb = rcomb * rg + (rd - mn).clamp(0, rg - 1)
            total_range *= rg
        if hashed:
            # exact range packing impossible (e.g. two hash-like int64
            # ids): hash-combine the keys and VERIFY pairs after
            # expansion (reference: HashedRelation.scala:208 — probe by
            # hash, confirm by key equality)
            lcomb, rcomb = _hash_keys([p[0] for p in prepped],
                                      [p[1] for p in prepped])
        for lt, rt in zip(lks, rks):
            if lt.validity is not None:
                lvalid = lvalid & lt.validity
            if rt.validity is not None:
                rvalid = rvalid & rt.validity
        return lcomb, lvalid, rcomb, rvalid, hashed, \
            [(p[0], p[1]) for p in prepped]

    def execute(self, child_pipes: List[Pipe]) -> Pipe:
        lpipe, rpipe = child_pipes
        how = self.how
        if how == "cross" and self.condition is None:
            return self._cross(lpipe, rpipe)
        if not self.left_keys:
            # condition-only join: chunked nested loop instead of
            # materializing all L*R pairs at once (reference:
            # BroadcastNestedLoopJoinExec)
            return self._nested_loop(lpipe, rpipe, how)

        lkey, lvalid, rkey, rvalid, hashed, prepped = self._combined_keys(
            lpipe, rpipe)
        # probe = left, build = right (left-side row order is preserved,
        # matching streamed-side semantics)
        ranges = K.build_join_ranges(rkey, rpipe.mask & rvalid,
                                     lkey, lpipe.mask & lvalid)
        if how in ("left_semi", "left_anti") and self.condition is None \
                and not hashed:
            has_match = ranges.counts > 0
            keep = lpipe.mask & (has_match if how == "left_semi"
                                 else ~has_match)
            return Pipe(lpipe.cols, keep, lpipe.order)
        total = int(ranges.counts.sum())  # host sync: output sizing
        return self._pairs_pipe(lpipe, rpipe, ranges, hashed, prepped,
                                K.bucket(total))

    def _pairs_pipe(self, lpipe: Pipe, rpipe: Pipe, ranges, hashed,
                    prepped, cap: int) -> Pipe:
        """General match expansion at a static capacity."""
        how = self.how
        p_idx, b_idx, pair_mask = K.expand_join_pairs(ranges, cap)
        # The pair environment always carries BOTH sides (with '#2'
        # dedup names) so semi/anti join conditions can reference the
        # inner relation; the output schema narrows afterwards.
        cols, order = _gather_pairs(lpipe, rpipe, p_idx, b_idx)

        pair_ok = pair_mask
        if hashed:
            # hash probe: confirm candidate pairs by exact key equality
            pair_ok = pair_ok & _verify_key_pairs(prepped, p_idx, b_idx,
                                                  cap)
        if self.condition is not None:
            ctv = C.evaluate(self.condition,
                             Env(cols, cap, device=pair_ok.device))
            pair_ok = pair_ok & ctv.data & ctv.valid_or_true(cap)

        if how == "inner":
            return Pipe(cols, pair_ok, order)

        # matched flags must be computed on the ORIGINAL pair arrays,
        # before any unmatched-row appends change the capacity
        matched = K.seg_count(p_idx, pair_ok, lpipe.capacity) > 0
        matched_b = (K.seg_count(b_idx, pair_ok, rpipe.capacity) > 0
                     if how in ("right", "full") else None)
        if how == "left_semi":
            return Pipe(lpipe.cols, lpipe.mask & matched, lpipe.order)
        if how == "left_anti":
            return Pipe(lpipe.cols, lpipe.mask & ~matched, lpipe.order)
        if how in ("left", "full"):
            cols, pair_ok = append_unmatched_left(cols, pair_ok, order,
                                                  lpipe, matched)
        if how in ("right", "full"):
            cols, pair_ok = append_unmatched_right(cols, pair_ok, order,
                                                   lpipe, rpipe, matched_b)
        return Pipe(cols, pair_ok, order)

    def _nested_loop(self, lpipe: Pipe, rpipe: Pipe, how: str) -> Pipe:
        """Condition-only join evaluated in fixed-size left-chunks of
        bounded pair count; surviving pair indices come to the host per
        chunk and are gathered once at the end."""
        lcap = lpipe.capacity
        rcap = rpipe.capacity
        dev = lpipe.mask.device
        rn = int(rpipe.mask.sum())  # host sync: build size
        rperm = K.compaction_permutation(rpipe.mask)

        matched_l = np.zeros(lcap, dtype=bool)
        matched_r = np.zeros(rcap, dtype=bool)
        keep_p: List[np.ndarray] = []
        keep_b: List[np.ndarray] = []
        if rn > 0:
            budget = 1 << 22  # pairs per chunk (~32 MB of int64 per col)
            chunk = max(1, min(lcap, budget // rn))
            j = torch.arange(chunk * rn, device=dev)
            local_p = torch.div(j, rn, rounding_mode="floor")
            b_idx = rperm[j % rn]
            for start in range(0, lcap, chunk):
                p_idx = (local_p + start).clamp(0, lcap - 1)
                pair_ok = (local_p + start < lcap) & lpipe.mask[p_idx]
                if self.condition is not None:
                    cols, _ = _gather_pairs(lpipe, rpipe, p_idx, b_idx)
                    ctv = C.evaluate(self.condition,
                                     Env(cols, chunk * rn, device=dev))
                    pair_ok = pair_ok & ctv.data & ctv.valid_or_true(
                        chunk * rn)
                idx = np.nonzero(pair_ok.cpu().numpy())[0]  # host sync
                if idx.size:
                    ps = p_idx.cpu().numpy()[idx]
                    bs = b_idx.cpu().numpy()[idx]
                    matched_l[ps] = True
                    matched_r[bs] = True
                    if how not in ("left_semi", "left_anti"):
                        keep_p.append(ps)
                        keep_b.append(bs)

        ml = torch.from_numpy(matched_l).to(dev)
        if how == "left_semi":
            return Pipe(lpipe.cols, lpipe.mask & ml, lpipe.order)
        if how == "left_anti":
            return Pipe(lpipe.cols, lpipe.mask & ~ml, lpipe.order)

        all_p = (np.concatenate(keep_p) if keep_p
                 else np.zeros((0,), dtype=np.int64))
        all_b = (np.concatenate(keep_b) if keep_b
                 else np.zeros((0,), dtype=np.int64))
        total = int(all_p.shape[0])
        cap = K.bucket(total)
        pad_p = np.zeros(cap, dtype=np.int64)
        pad_b = np.zeros(cap, dtype=np.int64)
        pad_p[:total] = all_p
        pad_b[:total] = all_b
        pair_ok = torch.arange(cap, device=dev) < total
        cols, order = _gather_pairs(lpipe, rpipe,
                                    torch.from_numpy(pad_p).to(dev),
                                    torch.from_numpy(pad_b).to(dev))
        if how in ("left", "full"):
            cols, pair_ok = append_unmatched_left(cols, pair_ok, order,
                                                  lpipe, ml)
        if how in ("right", "full"):
            cols, pair_ok = append_unmatched_right(
                cols, pair_ok, order, lpipe, rpipe,
                torch.from_numpy(matched_r).to(dev))
        return Pipe(cols, pair_ok, order)

    def _cross(self, lpipe: Pipe, rpipe: Pipe) -> Pipe:
        """Cartesian product with the right side's live rows compacted
        to the front; an empty right side gives an empty product."""
        dev = lpipe.mask.device
        rn = int(rpipe.mask.sum())  # host sync: output sizing
        lcap = lpipe.capacity
        cap = K.bucket(lcap * rn if rn else 1)
        j = torch.arange(cap, device=dev)
        rs = max(rn, 1)
        p_idx = torch.div(j, rs, rounding_mode="floor")
        rperm = K.compaction_permutation(rpipe.mask)
        b_idx = rperm[j % rs]
        pair_mask = (j < lcap * rs) & lpipe.mask[p_idx.clamp(0, lcap - 1)]
        if rn == 0:
            pair_mask = torch.zeros_like(pair_mask)
        cols, order = _gather_pairs(lpipe, rpipe, p_idx.clamp(0, lcap - 1),
                                    b_idx)
        return Pipe(cols, pair_mask, order)

    def node_string(self):
        ks = ", ".join(f"{l}={r}" for l, r in zip(self.left_keys,
                                                  self.right_keys))
        return f"Join[{self.how}, ({ks}), cond={self.condition}]"


def append_unmatched_left(cols, pair_ok, order, lpipe, matched):
    """Append left rows with no (condition-passing) match; right side
    NULL (reference contract: joins/ShuffledHashJoinExec.scala:38 —
    unmatched stream rows padded with nulls). Returns (cols, mask)."""
    lcap = lpipe.capacity
    n_l = len(lpipe.order)
    new_cols: Dict[str, TV] = {}
    for i, name in enumerate(order):
        tv = cols[name]
        rows = tv.data.shape[0]
        if i < n_l:
            src = lpipe.cols[lpipe.order[i]]
            data = torch.cat([tv.data, src.data])
            validity = None
            if tv.validity is not None or src.validity is not None:
                validity = torch.cat([tv.valid_or_true(rows),
                                      src.valid_or_true(lcap)])
        else:
            data = torch.cat([tv.data, torch.zeros(
                (lcap,), dtype=tv.data.dtype, device=tv.data.device)])
            validity = torch.cat([tv.valid_or_true(rows), torch.zeros(
                (lcap,), dtype=torch.bool, device=tv.data.device)])
        new_cols[name] = TV(data, validity, tv.dtype, tv.dictionary)
    return new_cols, torch.cat([pair_ok, lpipe.mask & ~matched])


def append_unmatched_right(cols, pair_ok, order, lpipe, rpipe, matched_b):
    """Append right rows with no (condition-passing) match; left side
    NULL. Returns (cols, mask)."""
    rcap = rpipe.capacity
    n_l = len(lpipe.order)
    new_cols: Dict[str, TV] = {}
    for i, name in enumerate(order):
        tv = cols[name]
        rows = tv.data.shape[0]
        if i < n_l:
            data = torch.cat([tv.data, torch.zeros(
                (rcap,), dtype=tv.data.dtype, device=tv.data.device)])
            validity = torch.cat([tv.valid_or_true(rows), torch.zeros(
                (rcap,), dtype=torch.bool, device=tv.data.device)])
        else:
            src = rpipe.cols[rpipe.order[i - n_l]]
            data = torch.cat([tv.data, src.data])
            validity = None
            if tv.validity is not None or src.validity is not None:
                validity = torch.cat([tv.valid_or_true(rows),
                                      src.valid_or_true(rcap)])
        new_cols[name] = TV(data, validity, tv.dtype, tv.dictionary)
    return new_cols, torch.cat([pair_ok, rpipe.mask & ~matched_b])
