"""Physical operators over torch tensors.

The port of the single-device main path of
``spark_tpu/physical/operators.py``: scan, range, filter, project, sort,
limit, compaction, the grouping-sets expand, union, grouped aggregation
(with collect_list/collect_set), the sorted-build equi-join
(``JoinExec``), ``GenerateExec`` (explode) and ``SampleExec``; the
window operator is ``physical/window.py``.

An array column is 2-D (capacity, max_len): every row operator gathers
and concatenates it along rows, pads widths to the widest where inputs
meet, and moves its lengths twice, in the TV (``TV.lengths``) and as the
``<col>#len`` companion column that results and batches carry.

A pipeline carries ``(cols: {name: TV}, row_mask)``; filters flip mask
bits, projections rebuild the dict — shapes never change mid-stage.
``execute(child_pipes) -> Pipe`` is the reference's ``trace``: for an
operator whose ``traceable`` is true it makes no host sync and copies
nothing from the host, so the planner fuses a maximal traceable subtree
into one stage (``physical/planner.py``), which the card captures into
one CUDA graph (``physical/graphs.py``). ``execute_blocking`` may sync
to size its output; on the first run of a plan it records the sizes
(the adaptive statistics caches below, keyed on the plan and the ids of
its leaf tensors), and with them bound a join, a sorted aggregate and
an explode become traceable on the next run over the same leaves.
"""

from __future__ import annotations

import contextvars
import dataclasses
import functools
import weakref
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_tpu_torch import locks
from spark_tpu_torch import types as T
from spark_tpu_torch.columnar.batch import Batch, BatchData, ColumnData
from spark_tpu_torch.expr import compiler as C
from spark_tpu_torch.expr import expressions as E
from spark_tpu_torch.expr.compiler import TV, Env
from spark_tpu_torch.physical import kernels as K
from spark_tpu_torch.device import resolve_device
from spark_tpu_torch.plan.logical import (expand_schema, generate_schema,
                                          join_schema, map_outputs,
                                          projection_schema, range_rows,
                                          with_len_companions)
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
        env = Env.from_batch(batch)
        return cls(env.columns, batch.data.row_mask, batch.schema.names)

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

    #: True when ``execute`` makes no host sync and copies nothing from
    #: the host (the reference's flag: such operators fuse into one stage)
    traceable: bool = True

    def children(self) -> Tuple["PhysicalPlan", ...]:
        return ()

    @functools.cached_property
    def schema(self) -> Schema:
        raise NotImplementedError

    def execute(self, child_pipes: List[Pipe]) -> Pipe:
        raise NotImplementedError

    def execute_blocking(self, child_pipes: List[Pipe]) -> Pipe:
        """Eager execution with host syncs allowed; an operator that sizes
        its output records the size here (first runs)."""
        return self.execute(child_pipes)

    def has_blocking_exprs(self) -> bool:
        """Whether a field of this node holds a host-only expression (an
        arrow UDF): such a node runs blocking, whatever ``traceable``
        says. Memoized per plan instance, as ``plan_key``."""
        memo = self.__dict__.get("_blocking_memo")
        if memo is not None:
            return memo

        def scan(v) -> bool:
            if isinstance(v, E.Expression):
                return E.contains_blocking(v)
            if isinstance(v, tuple):
                return any(scan(x) for x in v)
            return False

        fields = dataclasses.fields(self) \
            if dataclasses.is_dataclass(self) else ()
        memo = any(scan(getattr(self, f.name)) for f in fields)
        self.__dict__["_blocking_memo"] = memo
        return memo

    def stats_key(self) -> tuple:
        """Identity for adaptive runtime stats: plan structure + the ids
        of the leaf scans' column tensors (the engine never writes a leaf
        in place, so equal ids mean equal data while the tensors live).
        Returns (key, tensors): the caches weakref ``tensors`` and drop
        the entry when any dies, so a recycled id never aliases a live
        entry. Memoized per plan instance (nodes are rebuilt per run)."""
        cached = self.__dict__.get("_stats_key_memo")
        if cached is not None:
            return cached
        scans: List["BatchScanExec"] = []

        def collect(p: PhysicalPlan) -> None:
            if isinstance(p, BatchScanExec):
                if not p.aux:  # derived data, not identity
                    scans.append(p)
                return
            for c in p.children():
                collect(c)

        collect(self)
        pins = tuple(cd.data for s in scans for cd in s.batch.data.columns)
        out = ((self.plan_key(), tuple(id(a) for a in pins)), pins)
        self.__dict__["_stats_key_memo"] = out
        return out

    def plan_key(self) -> tuple:
        """Structural key: equal for plans that compute the same function
        of their leaves. Memoized per plan instance, as ``stats_key``; the
        adaptive fields the planner binds later are not part of it."""
        key = self.__dict__.get("_plan_key_memo")
        if key is None:
            key = self.__dict__["_plan_key_memo"] = self._key()
        return key

    def _key(self) -> tuple:
        return (type(self).__name__,) + tuple(
            c.plan_key() for c in self.children())

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
    #: aux scans carry derived device data (cached join indexes) fully
    #: determined by the real leaves: excluded from stats_key identity
    aux: bool = False

    @functools.cached_property
    def schema(self) -> Schema:
        return self.batch.schema

    def execute(self, child_pipes: List[Pipe]) -> Pipe:
        return Pipe.from_batch(self.batch)

    def node_string(self):
        return f"BatchScan{list(self.schema.names)}"

    def _key(self):
        fields = self.batch.schema.fields
        return ("BatchScan", self.batch.capacity,
                tuple((f.name, repr(f.dtype)) for f in fields),
                tuple(_dictionary_hash(f) for f in fields))


#: id(field) -> (weakref to a string field, the hash of its dictionary):
#: a dictionary of 150k entries hashes in about a millisecond, and every
#: run's scans key on theirs; an entry whose field died is never hit
#: (the weakref no longer points at the field asked about)
_DICT_HASHES: Dict[int, tuple] = {}


def _dictionary_hash(field: Field) -> Optional[int]:
    if field.dictionary is None:
        return None
    hit = _DICT_HASHES.get(id(field))
    if hit is not None and hit[0]() is field:
        return hit[1]
    if len(_DICT_HASHES) > 4096:
        for k in [k for k, (ref, _) in _DICT_HASHES.items()
                  if ref() is None]:
            del _DICT_HASHES[k]
    h = hash(field.dictionary)
    _DICT_HASHES[id(field)] = (weakref.ref(field), h)
    return h


@dataclass(eq=False)
class RangeExec(PhysicalPlan):
    """``range(start, end, step)`` as one int64 column made on the device
    (reference: basicPhysicalOperators.scala RangeExec:412)."""

    start: int
    end: int
    step: int
    col_name: str
    device: object

    @functools.cached_property
    def schema(self) -> Schema:
        return Schema((Field(self.col_name, T.INT64, nullable=False),))

    def execute(self, child_pipes: List[Pipe]) -> Pipe:
        dev = resolve_device(self.device)
        n = range_rows(self.start, self.end, self.step)
        pos = torch.arange(K.bucket(n), dtype=torch.int64, device=dev)
        ids = self.start + pos * self.step
        return Pipe({self.col_name: TV(ids, None, T.INT64, None)}, pos < n,
                    [self.col_name])

    def node_string(self):
        return f"Range({self.start}, {self.end}, {self.step})"

    def _key(self):
        return ("Range", self.start, self.end, self.step, self.col_name)


# ---- pipelined unary ops ----------------------------------------------------


@dataclass(eq=False)
class ProjectExec(PhysicalPlan):
    exprs: Tuple[E.Expression, ...]
    child: PhysicalPlan

    def children(self):
        return (self.child,)

    @functools.cached_property
    def schema(self) -> Schema:
        return projection_schema(self.exprs, self.child.schema)

    def execute(self, child_pipes: List[Pipe]) -> Pipe:
        """Each item evaluated; a map item expands into its
        ``#keys``/``#vals`` pair, and every array output gains its
        ``#len`` companion (``projection_schema``)."""
        pipe = child_pipes[0]
        env = pipe.env()
        cs = self.child.schema
        cols: Dict[str, TV] = {}
        order: List[str] = []
        for e in self.exprs:
            pair = map_outputs(e, cs)
            if pair is not None:
                for name, tv in zip(pair, C.evaluate_map_pair(e, env)):
                    cols[name] = tv
                    order.append(name)
                continue
            cols[e.name] = C.evaluate(e, env)
            order.append(e.name)
        cols, order = with_companion_cols(cols, order)
        return Pipe(cols, pipe.mask, order)

    def node_string(self):
        return f"Project[{', '.join(str(e) for e in self.exprs)}]"

    def _key(self):
        return ("Project", tuple(E.expr_key(e) for e in self.exprs),
                self.child.plan_key())


def with_companion_cols(cols: Dict[str, TV], order: Sequence[str]):
    """(cols, order) with each array column followed by its ``#len``
    companion (from the TV's lengths; the full width without them),
    unless ``order`` names that companion itself: the columns of
    ``plan/logical.py:with_len_companions``."""
    out = dict(cols)
    names = set(order)
    new_order: List[str] = []
    for name in order:
        new_order.append(name)
        tv = cols[name]
        comp = T.array_len_col(name)
        if isinstance(tv.dtype, T.ArrayType) and comp not in names:
            lens = tv.lengths
            if lens is None:
                lens = torch.full((tv.data.shape[0],), tv.data.shape[1],
                                  dtype=torch.int32, device=tv.data.device)
            out[comp] = TV(lens.to(torch.int32), None, T.INT32, None)
            new_order.append(comp)
    return out, new_order


def _scalar_column(tv: TV, what: str) -> TV:
    """``tv`` when it is one value a row; arrays and maps are neither
    orderable nor groupable, as in the reference."""
    if tv.data.dim() != 1 or isinstance(tv.dtype, (T.ArrayType, T.MapType)):
        raise ValueError(f"{what}: an array or map column ({tv.dtype}) is "
                         "not orderable or groupable")
    return tv


def _key_scale(dtype) -> Optional[int]:
    """An exact numeric key type's scale (0 for an integer), None for
    any other type."""
    if isinstance(dtype, T.DecimalType):
        return dtype.scale
    if isinstance(dtype, T.IntegralType):
        return 0
    return None


def coerce_join_keys(left_keys, right_keys, lschema: Schema,
                     rschema: Schema):
    """Equi-join keys cast to their pair's common type where the two
    sides' int64 forms would differ for one value: a float against an
    exact number, or decimals (or a decimal and an integer) of other
    scales. Other pairs stay as they are (int32 against int64 codes
    alike, a float32 and a float64 join by their float64 bits)."""
    lout, rout = [], []
    for lk, rk in zip(left_keys, right_keys):
        a, b = lk.data_type(lschema), rk.data_type(rschema)
        fa = isinstance(a, (T.Float32Type, T.Float64Type))
        fb = isinstance(b, (T.Float32Type, T.Float64Type))
        sa, sb = _key_scale(a), _key_scale(b)
        differ = ((fa and sb is not None) or (fb and sa is not None)
                  or (sa is not None and sb is not None and sa != sb))
        if differ:
            t = T.common_type(a, b)
            lk, rk = E.exact_cast(lk, a, t), E.exact_cast(rk, b, t)
        lout.append(lk)
        rout.append(rk)
    return tuple(lout), tuple(rout)


@dataclass(eq=False)
class FilterExec(PhysicalPlan):
    condition: E.Expression
    child: PhysicalPlan

    def children(self):
        return (self.child,)

    @functools.cached_property
    def schema(self) -> Schema:
        return self.child.schema

    def execute(self, child_pipes: List[Pipe]) -> Pipe:
        pipe = child_pipes[0]
        tv = C.evaluate(self.condition, pipe.env())
        keep = tv.data & tv.valid_or_true(pipe.capacity)
        return Pipe(pipe.cols, pipe.mask & keep, pipe.order)

    def node_string(self):
        return f"Filter[{self.condition}]"

    def _key(self):
        return ("Filter", E.expr_key(self.condition), self.child.plan_key())


def _take(tv: TV, perm: torch.Tensor) -> TV:
    """The rows ``perm`` of a TV (an array's rows and lengths)."""
    return TV(tv.data[perm],
              None if tv.validity is None else tv.validity[perm],
              tv.dtype, tv.dictionary,
              None if tv.lengths is None else tv.lengths[perm])


@dataclass(eq=False)
class SortExec(PhysicalPlan):
    """Global sort: chained stable argsorts."""

    orders: Tuple[E.SortOrder, ...]
    child: PhysicalPlan

    def children(self):
        return (self.child,)

    @functools.cached_property
    def schema(self) -> Schema:
        return self.child.schema

    def execute(self, child_pipes: List[Pipe]) -> Pipe:
        pipe = child_pipes[0]
        env = pipe.env()
        keys = []
        for o in self.orders:
            tv = _scalar_column(C.evaluate(o.child, env), "ORDER BY")
            keys.append(K.SortKey(tv.data, tv.validity, o.ascending,
                                  o.nulls_first_resolved))
        perm = K.lexsort_permutation(keys, pipe.mask)
        cols = {name: _take(tv, perm) for name, tv in pipe.cols.items()}
        return Pipe(cols, pipe.mask[perm], pipe.order)

    def node_string(self):
        return f"Sort[{', '.join(map(str, self.orders))}]"

    def _key(self):
        return ("Sort",
                tuple((E.expr_key(o.child), o.ascending,
                       o.nulls_first_resolved) for o in self.orders),
                self.child.plan_key())


@dataclass(eq=False)
class LimitExec(PhysicalPlan):
    """Keep first n live rows."""

    n: int
    child: PhysicalPlan
    offset: int = 0

    def children(self):
        return (self.child,)

    @functools.cached_property
    def schema(self) -> Schema:
        return self.child.schema

    def execute(self, child_pipes: List[Pipe]) -> Pipe:
        pipe = child_pipes[0]
        return Pipe(pipe.cols, K.limit_mask(pipe.mask, self.n, self.offset),
                    pipe.order)

    def node_string(self):
        return f"Limit[{self.n}]"

    def _key(self):
        return ("Limit", self.n, self.offset, self.child.plan_key())


@dataclass(eq=False)
class CompactExec(PhysicalPlan):
    """Gather live rows to the front and truncate to a recorded bucketed
    capacity (reference analogue: AQE's CoalesceShufflePartitions.scala):
    between stages, where the planner replays a first run's compaction,
    and at the root, so the copy to the host moves ``bucket(live)`` rows.
    Stable compaction preserves sorted row order."""

    child: PhysicalPlan
    cap: int

    def children(self):
        return (self.child,)

    @functools.cached_property
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

    def _key(self):
        # transparent: stats recorded on a blocking run (where the
        # planner compacts between stages unseen) are found when the
        # replayed plan carries explicit CompactExec nodes; the stage
        # cache tells compactions apart by planner._adaptive_snapshot
        return self.child.plan_key()


@dataclass(eq=False)
class ExpandExec(PhysicalPlan):
    """One output block per projection, stacked (reference:
    execution/ExpandExec.scala:1): capacity = child capacity x sets, no
    host sync. String columns are re-coded into the union of the
    projections' dictionaries."""

    projections: Tuple[Tuple[E.Expression, ...], ...]
    names: Tuple[str, ...]
    child: PhysicalPlan

    def children(self):
        return (self.child,)

    @functools.cached_property
    def schema(self) -> Schema:
        return expand_schema(self.projections, self.names, self.child.schema)

    def execute(self, child_pipes: List[Pipe]) -> Pipe:
        pipe = child_pipes[0]
        env = pipe.env()
        cs = self.child.schema
        cols: Dict[str, TV] = {}
        for i, name in enumerate(self.names):
            tvs = [C.evaluate(proj[i], env) for proj in self.projections]
            out_dt = tvs[0].dtype
            for proj in self.projections[1:]:
                out_dt = T.common_type(out_dt, proj[i].data_type(cs))
            cols[name] = _stack_tvs(tvs, out_dt)
        mask = torch.cat([pipe.mask] * len(self.projections))
        cols, order = with_companion_cols(cols, self.names)
        return Pipe(cols, mask, order)

    def node_string(self):
        return f"Expand[{len(self.projections)} sets]"

    def _key(self):
        return ("Expand",
                tuple(tuple(E.expr_key(e) for e in p)
                      for p in self.projections),
                self.names, self.child.plan_key())


def _stack_tvs(tvs: Sequence[TV], out_dt) -> TV:
    """Several TVs concatenated along rows as one column of ``out_dt``:
    strings (and string arrays) re-coded into their dictionaries' union,
    other types cast, arrays padded to the widest and their lengths
    concatenated."""
    el = out_dt.element if isinstance(out_dt, T.ArrayType) else out_dt
    dictionary = None
    if isinstance(el, T.StringType):
        dictionary, tables = C.unify_dictionaries(
            tuple(tv.dictionary or () for tv in tvs))
        datas = [C._coded(tv, tb) for tv, tb in zip(tvs, tables)]
    else:
        datas = [C._cast_data(tv.data, tv.dtype, out_dt) for tv in tvs]
    lengths = None
    if isinstance(out_dt, T.ArrayType):
        width = max(d.shape[1] for d in datas)
        datas = [C.pad_width(d, width) for d in datas]
        lengths = torch.cat([C._array_tv(tv, "UNION").lengths.to(torch.int32)
                             for tv in tvs])
    validity = None
    if any(tv.validity is not None for tv in tvs):
        validity = torch.cat([tv.valid_or_true(tv.data.shape[0])
                              for tv in tvs])
    return TV(torch.cat(datas), validity, out_dt, dictionary, lengths)


@dataclass(eq=False)
class UnionExec(PhysicalPlan):
    """UNION ALL by position: both sides' rows concatenated, capacities
    added (no compaction); names from the left side."""

    left: PhysicalPlan
    right: PhysicalPlan

    def children(self):
        return (self.left, self.right)

    @functools.cached_property
    def schema(self) -> Schema:
        return self.left.schema

    def execute(self, child_pipes: List[Pipe]) -> Pipe:
        lp, rp = child_pipes
        cols: Dict[str, TV] = {}
        for lname, rname in zip(lp.order, rp.order):
            lt, rt = lp.cols[lname], rp.cols[rname]
            out_dt = lt.dtype if type(lt.dtype) is type(rt.dtype) \
                and not isinstance(lt.dtype, T.ArrayType) \
                else T.common_type(lt.dtype, rt.dtype)
            cols[lname] = _stack_tvs((lt, rt), out_dt)
        return Pipe(cols, torch.cat([lp.mask, rp.mask]), list(cols))

    def node_string(self):
        return "Union"

    def _key(self):
        return ("Union", self.left.plan_key(), self.right.plan_key())


@dataclass(eq=False)
class GenerateExec(PhysicalPlan):
    """explode/posexplode: one output row per live element of the
    generator's array, the input columns gathered per output row
    (reference: ``spark_tpu/physical/operators.py:498``,
    execution/GenerateExec.scala): each row's element offset by a
    cumulative sum, each output row's input row by a binary search of the
    offsets, its element by a gather. The first run syncs to size the
    output and records the bucketed size in ``_GEN_STATS``; bound
    (``adaptive``), a later run over the same leaves expands at that
    capacity with no sync."""

    generator: E.Explode
    out_name: str
    pos_name: Optional[str]
    child: PhysicalPlan
    adaptive: Optional[int] = None

    def children(self):
        return (self.child,)

    @property
    def traceable(self) -> bool:  # type: ignore[override]
        return self.adaptive is not None

    @functools.cached_property
    def schema(self) -> Schema:
        return generate_schema(self.generator, self.out_name, self.pos_name,
                               self.child.schema)

    def _counts(self, pipe: Pipe):
        tv = C._array_tv(C.evaluate(self.generator.child, pipe.env()),
                         "explode()")
        ok = pipe.mask & tv.valid_or_true(pipe.capacity)
        counts = torch.where(ok, tv.lengths.to(torch.int64),
                             torch.zeros((), dtype=torch.int64,
                                         device=pipe.mask.device))
        return tv, counts, torch.cumsum(counts, 0)

    def execute(self, child_pipes: List[Pipe]) -> Pipe:
        if self.adaptive is None:
            return self._blocking(child_pipes[0], record=False)
        return self._expand(child_pipes[0], self.adaptive)

    def execute_blocking(self, child_pipes: List[Pipe]) -> Pipe:
        return self._blocking(child_pipes[0], record=True)

    def _blocking(self, pipe: Pipe, record: bool) -> Pipe:
        tv, counts, ends = self._counts(pipe)
        cap = K.bucket(int(ends[-1]))  # host sync: output sizing
        if record:
            sk = self.stats_key()
            if sk not in _GEN_STATS:
                _GEN_STATS.put(sk, cap)
        return self._expand(pipe, cap, (tv, counts, ends))

    def _expand(self, pipe: Pipe, cap: int, sized=None) -> Pipe:
        tv, counts, ends = sized if sized is not None else self._counts(pipe)
        cap_in = pipe.capacity
        dev = pipe.mask.device
        offsets = ends - counts
        total = ends[-1]
        j = torch.arange(cap, dtype=torch.int64, device=dev)
        # the input row of output row j: the last row whose offset <= j
        # (rows with no element share the next row's offset, which wins)
        p = (K.searchsorted(offsets, j, side="right") - 1).clamp(
            0, cap_in - 1)
        k = j - offsets[p]
        cols = {name: _take(pipe.cols[name], p) for name in pipe.order}
        order = list(pipe.order)
        if self.pos_name is not None:
            cols[self.pos_name] = TV(k.to(torch.int32), None, T.INT32, None)
            order.append(self.pos_name)
        width = tv.data.shape[1]
        el = tv.data.reshape(-1)[p * width + k.clamp(0, width - 1)]
        cols[self.out_name] = TV(el, None, tv.dtype.element, tv.dictionary)
        order.append(self.out_name)
        return Pipe(cols, j < total, order)

    def node_string(self):
        return f"Generate[{self.generator} AS {self.out_name}]"

    def _key(self):
        return ("Generate", E.expr_key(self.generator), self.out_name,
                self.pos_name, self.child.plan_key())


@dataclass(eq=False)
class SampleExec(PhysicalPlan):
    """Bernoulli sample: row i kept when draw i of the seeded stream
    (``physical/random.uniform``, JAX's ``uniform(PRNGKey(seed),
    (capacity,))`` bit for bit) is below ``fraction`` (reference:
    ``spark_tpu/physical/operators.py:651``): the same rows on the CPU
    and on the card."""

    fraction: float
    seed: int
    child: PhysicalPlan

    def children(self):
        return (self.child,)

    @functools.cached_property
    def schema(self) -> Schema:
        return self.child.schema

    def execute(self, child_pipes: List[Pipe]) -> Pipe:
        from spark_tpu_torch.physical.random import uniform

        pipe = child_pipes[0]
        u = uniform(self.seed, pipe.capacity, pipe.mask.device)
        return Pipe(pipe.cols, pipe.mask & (u < self.fraction), pipe.order)

    def node_string(self):
        return f"Sample[{self.fraction}, seed={self.seed}]"

    def _key(self):
        return ("Sample", self.fraction, self.seed, self.child.plan_key())


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
        _scalar_column(tv, "GROUP BY")
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
    keys = [K.SortKey(_scalar_column(tv, "GROUP BY").data, tv.validity,
                      True, True) for tv in key_tvs]
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
    if tv.data.dim() != 1 and not (isinstance(agg, E.Count)
                                   and not agg.distinct):
        raise NotImplementedError(
            f"aggregate {agg} over an array or map value is not ported")
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
    if isinstance(agg, E.StddevVariance):
        return _stddev_variance(agg, tv, seg, ok, any_valid, num_segments,
                                sorted_seg)
    if isinstance(agg, E.Percentile):
        return _percentile(agg, tv, seg, ok, any_valid, num_segments,
                           capacity, sorted_seg)
    if isinstance(agg, E.Collect):
        return _collect(agg, env, tv, seg, ok, num_segments, capacity,
                        sorted_seg)
    raise NotImplementedError(f"aggregate {agg!r} is not ported yet")


def _collect(agg: E.Collect, env: Env, tv: TV, seg, ok, num_segments: int,
             capacity: int, sorted_seg: bool) -> TV:
    """collect_list / collect_set (reference:
    ``spark_tpu/physical/operators.py:996``): one stable sort of the ok
    rows by group (and, for a set, by value after the DISTINCT mask), so a
    list keeps the rows' order and a set holds each value once, in value
    order; each group's run is gathered into a row of an array as wide as
    the largest group, whose count the host reads (one sync)."""
    if agg.unique:
        ok = ok & _distinct_mask_cached(env, agg.child, tv, seg, ok)
    keys = [K.SortKey(seg, None, True, True)]
    if agg.unique:
        keys.append(K.SortKey(tv.data, tv.validity, True, True))
    perm = K.lexsort_permutation(keys, ok)  # stable: keeps row order
    svals = tv.data[perm]
    cnt = K.seg_count(seg, ok, num_segments, sorted_seg)
    starts = torch.cumsum(cnt, 0) - cnt
    width = max(int(cnt.max()) if num_segments else 0, 1)  # host sync
    idx = starts[:, None] + torch.arange(width, device=cnt.device)[None, :]
    return TV(svals[idx.clamp(0, capacity - 1)], None,
              T.ArrayType(tv.dtype), tv.dictionary, cnt.to(torch.int32))


def _stddev_variance(agg: E.StddevVariance, tv: TV, seg, ok, any_valid,
                     num_segments: int, sorted_seg: bool) -> TV:
    """Variance from the grouped sum and sum of squares, as the reference
    (``spark_tpu/physical/operators.py:948``): two float64 grouped sums,
    which take ``seg_agg.seg_fsum`` on the card. A decimal computes on its
    value (the reference reads the unscaled integer: ROADMAP C). The
    formula cancels when the spread is small against the mean."""
    x = C._cast_data(tv.data, tv.dtype, T.FLOAT64)
    c = K.seg_count(seg, ok, num_segments, sorted_seg).to(torch.float64)
    s = K.seg_sum(x, seg, ok, num_segments, sorted_seg)
    s2 = K.seg_sum(x * x, seg, ok, num_segments, sorted_seg)
    m2 = (s2 - s * s / c.clamp(min=1.0)).clamp(min=0.0)
    samp = agg.kind.endswith("_samp")
    var = m2 / (c - 1.0 if samp else c).clamp(min=1.0)
    data = torch.sqrt(var) if agg.kind.startswith("stddev") else var
    enough = c >= (2.0 if samp else 1.0)
    return TV(data, any_valid & enough, T.FLOAT64, None)


def _percentile(agg: E.Percentile, tv: TV, seg, ok, any_valid,
                num_segments: int, capacity: int, sorted_seg: bool) -> TV:
    """Exact per-group percentile (reference
    ``spark_tpu/physical/operators.py:969``): one stable sort of (group,
    value) with the ok rows first, each group's start from its count,
    and a gather at its rank. Interpolated (percentile, median): float64
    between ranks floor and ceil of q * (n - 1); otherwise the element at
    rank ceil(q * n), in the input's type."""
    q = float(agg.percentage)
    perm = K.lexsort_permutation(
        [K.SortKey(seg, None, True, True),
         K.SortKey(tv.data, tv.validity, True, True)], ok)
    svals = tv.data[perm]
    cnt = K.seg_count(seg, ok, num_segments, sorted_seg)
    starts = torch.cumsum(cnt, 0) - cnt
    last = capacity - 1
    if agg.interpolate:
        fvals = C._cast_data(svals, tv.dtype, T.FLOAT64)
        pos = q * (cnt - 1).to(torch.float64)
        lo = torch.floor(pos).to(torch.int64)
        hi = torch.ceil(pos).to(torch.int64)
        frac = pos - lo.to(torch.float64)
        vlo = fvals[(starts + lo).clamp(0, last)]
        vhi = fvals[(starts + hi).clamp(0, last)]
        return TV(vlo + (vhi - vlo) * frac, any_valid, T.FLOAT64, None)
    rank = torch.ceil(q * cnt.to(torch.float64)).to(torch.int64) - 1
    rank = torch.minimum(rank.clamp(min=0), (cnt - 1).clamp(min=0))
    data = svals[(starts + rank).clamp(0, last)]
    return TV(data, any_valid, tv.dtype, tv.dictionary)


@dataclass(eq=False)
class HashAggregateExec(PhysicalPlan):
    """Group-by aggregation, with the reference's two strategies:

    - **direct**: every grouping key has a cardinality known from the
      schema (string dictionary / boolean) -> mixed-radix pack to dense
      group ids -> segment reductions. No sort, no host sync.
    - **sorted**: sort rows by keys, change-flag cumsum assigns group
      ids, and the group count comes to the host to size the output
      (``num_segments = bucket(groups, 256)``). The first run records
      the count in ``_AGG_STATS``; bound (``adaptive``), a later run over
      the same leaves takes its capacity from it and keeps the count on
      the device (``out_mask = arange < ng``).

    collect_list/collect_set size their arrays by the largest group: an
    aggregate holding one stays blocking, as in the reference.
    """

    groupings: Tuple[E.Expression, ...]
    aggregates: Tuple[E.Expression, ...]
    child: PhysicalPlan
    #: bound by the planner from _AGG_STATS: the group count observed on
    #: the first run over these leaves
    adaptive: Optional[int] = None

    def children(self):
        return (self.child,)

    @property
    def traceable(self) -> bool:  # type: ignore[override]
        if self.has_collect():
            return False  # output width = largest group: blocking only
        return self._static_direct_ok() or self.adaptive is not None

    def has_collect(self) -> bool:
        return any(isinstance(a, E.Collect) for e in self.aggregates
                   for a in E.collect_aggregates(e))

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

    @functools.cached_property
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
        return with_len_companions(fields)

    def _finalize(self, key_tvs: List[TV], agg_tvs: List[TV],
                  out_mask: torch.Tensor, num_segments: int) -> Pipe:
        outputs, _ = rewrite_agg_outputs(self.groupings, self.aggregates)
        cols = {f"__key{j}": tv for j, tv in enumerate(key_tvs)}
        cols.update({f"__agg{i}": tv for i, tv in enumerate(agg_tvs)})
        env = Env(cols, num_segments, device=out_mask.device)
        out_cols = {e.name: C.evaluate(e, env) for e in outputs}
        out_cols, order = with_companion_cols(out_cols,
                                              [e.name for e in outputs])
        return Pipe(out_cols, out_mask, order)

    def execute(self, child_pipes: List[Pipe]) -> Pipe:
        pipe = child_pipes[0]
        if self._static_direct_ok():
            return self._execute_direct(pipe)
        return self._execute_sorted(pipe, self.adaptive)

    def execute_blocking(self, child_pipes: List[Pipe]) -> Pipe:
        pipe = child_pipes[0]
        if self._static_direct_ok():
            return self._execute_direct(pipe)
        return self._execute_sorted(pipe, self.adaptive, record=True)

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

    def _execute_sorted(self, pipe: Pipe, groups: Optional[int] = None,
                        record: bool = False) -> Pipe:
        """The sorted path at ``bucket(groups, 256)`` segments, ``groups``
        recorded by a first run (traced: no sync), or, where None, the
        count read from the device (recorded in ``_AGG_STATS`` when
        ``record``)."""
        env = pipe.env()
        cap = pipe.capacity
        key_tvs = [C.evaluate(g, env) for g in self.groupings]
        pipe2, sorted_keys, seg, ng = sorted_groups(pipe, key_tvs)
        n_groups = ng
        if groups is None:
            n_groups = int(ng)  # host sync: output sizing
            groups = max(1, n_groups)
            if record:
                _AGG_STATS.put(self.stats_key(), groups)
        # an empty input has no group (out_mask all False); the reference
        # emits one empty group there (ROADMAP C)
        num_segments = K.bucket(groups, 256)
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

    def _key(self):
        return ("HashAggregate",
                tuple(E.expr_key(g) for g in self.groupings),
                tuple(E.expr_key(a) for a in self.aggregates),
                self.child.plan_key())


# ---- adaptive runtime statistics -------------------------------------------

#: Gate for stats RECORDING (reads stay enabled): a plan run once over
#: leaves that never recur skips the syncs that feed the caches and does
#: not flood them. A ContextVar, so one thread's window neither leaks
#: into nor is clobbered by another's.
_STATS_RECORDING = contextvars.ContextVar("stats_recording", default=True)


class stats_recording_disabled:
    """Context manager: suppress adaptive-stat recording (and the host
    syncs that feed it) for single-shot plan executions."""

    def __enter__(self):
        self._token = _STATS_RECORDING.set(False)

    def __exit__(self, *exc):
        _STATS_RECORDING.reset(self._token)
        return False


def stats_recording() -> bool:
    return _STATS_RECORDING.get()


class _AdaptiveStatsCache:
    """Bounded stats cache whose keys embed the ids of leaf tensors
    (``PhysicalPlan.stats_key``). Entries hold weakrefs to the tensors
    and are dropped the moment any dies, so no device memory is pinned
    and a recycled id never aliases a live entry; LRU beyond
    ``maxsize`` entries and, where ``max_bytes`` is set, beyond that many
    bytes of values (``nbytes``; one entry past it is kept). ``put``
    records only under ``stats_recording``; ``insert`` always does."""

    def __init__(self, maxsize: int = 256, max_bytes: Optional[int] = None):
        self._data: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._maxsize = maxsize
        self.max_bytes = max_bytes
        # queries on several threads (the scheduler's workers) share it
        self._lock = locks.named_lock("physical.stats_cache")

    @staticmethod
    def nbytes(value) -> int:
        return 0

    def total_bytes(self) -> int:
        with self._lock:
            return sum(self.nbytes(v) for v, _ in self._data.values())

    def _alive_locked(self, key) -> bool:
        v = self._data.get(key)
        if v is None:
            return False
        if any(r() is None for r in v[1]):
            del self._data[key]
            return False
        return True

    def get(self, key_and_pins):
        key, _ = key_and_pins
        with self._lock:
            if not self._alive_locked(key):
                return None
            self._data.move_to_end(key)
            return self._data[key][0]

    def put(self, key_and_pins, value) -> None:
        if _STATS_RECORDING.get():
            self.insert(key_and_pins, value)

    def insert(self, key_and_pins, value) -> None:
        key, pins = key_and_pins
        refs = tuple(weakref.ref(a) for a in pins)
        with self._lock:
            # sweep entries whose leaves died: never hit again, but they
            # would pin their values (device memory, for _JoinIndexCache)
            for k in [k for k, (_, rs) in self._data.items()
                      if any(r() is None for r in rs)]:
                del self._data[k]
            self._data[key] = (value, refs)
            self._data.move_to_end(key)
            while len(self._data) > self._maxsize:
                self._data.popitem(last=False)
            if self.max_bytes is not None:
                total = sum(self.nbytes(v) for v, _ in self._data.values())
                while total > self.max_bytes and len(self._data) > 1:
                    _, (v, _) = self._data.popitem(last=False)
                    total -= self.nbytes(v)

    def __contains__(self, key_and_pins) -> bool:
        with self._lock:
            return self._alive_locked(key_and_pins[0])

    def clear(self) -> int:
        """Drop every entry; the number dropped."""
        with self._lock:
            n = len(self._data)
            self._data.clear()
            return n

    def __len__(self) -> int:
        return len(self._data)


class _JoinIndexCache(_AdaptiveStatsCache):
    """Join-index cache bounded by device bytes, not entries: a
    lineitem-scale index holds ~100 MB while a dimension table's holds a
    few KB. Values are (orient, index batch, tables batch | None). An
    evicted index is recorded again only by a later blocking run; until
    then the traced join builds its ranges live."""

    def __init__(self, max_bytes: int = 1 << 30):
        super().__init__(maxsize=1 << 62, max_bytes=max_bytes)

    @staticmethod
    def nbytes(value) -> int:
        return sum(b.device_nbytes() for b in value[1:] if b is not None)


#: per (join, leaves): (packing, unique build, unique probe, bucketed
#: output capacity or None). packing is the tuple of per-key (min,
#: range) or "hash" (reference: adaptive/AdaptiveSparkPlanExec.scala:247,
#: here between executions instead of between stages)
_JOIN_STATS = _AdaptiveStatsCache()
#: cached build indexes (kernels.make_join_index outputs as aux batches)
_JOIN_INDEX = _JoinIndexCache()
#: per (explode, leaves): the bucketed output capacity
_GEN_STATS = _AdaptiveStatsCache()
#: per (sorted aggregate, leaves): the group count, at least 1
_AGG_STATS = _AdaptiveStatsCache()


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


def _take_valid(tv: TV, idx: torch.Tensor, has: torch.Tensor) -> TV:
    """The rows ``idx`` of ``tv``, NULL where ``has`` is False."""
    return _mask_valid(_take(tv, idx), has)


def _mask_valid(tv: TV, keep: torch.Tensor) -> TV:
    """``tv`` NULL where ``keep`` is False (an array's length 0 there,
    as an outer join's padding rows have)."""
    lengths = tv.lengths
    if lengths is not None:
        lengths = torch.where(keep, lengths, torch.zeros_like(lengths))
    return TV(tv.data, tv.valid_or_true(keep.shape[0]) & keep, tv.dtype,
              tv.dictionary, lengths)


def _layout_stable(p: PhysicalPlan) -> bool:
    """Whether ``p`` lays its rows out the same on the blocking and the
    traced path (no join or sorted aggregate below)."""
    if isinstance(p, (JoinExec, HashAggregateExec)):
        return False
    return all(_layout_stable(c) for c in p.children())


def _aux_batch(named) -> Batch:
    """Non-null integer tensors of one length as a batch."""
    fields = tuple(Field(name, T.INT32 if a.dtype == torch.int32 else T.INT64,
                         nullable=False) for name, a in named)
    cols = tuple(ColumnData(a, None) for _, a in named)
    mask = torch.ones((named[0][1].shape[0],), dtype=torch.bool,
                      device=named[0][1].device)
    return Batch(Schema(fields), BatchData(cols, mask))


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
    kernels.build_join_ranges). Blocking on the first run: the key
    ranges and the output capacity are host-synced, and ``_JOIN_STATS``
    records the key packing, whether either side matched each row at
    most once, and the bucketed capacity. Bound (``adaptive``), an inner,
    left, semi or anti equi-join over the same leaves runs traced
    (``_strategy``), with the build index the first run cached
    (``_JOIN_INDEX``) where its layout holds. Right, full, cross and
    condition-only joins stay blocking."""

    left: PhysicalPlan
    right: PhysicalPlan
    how: str
    left_keys: Tuple[E.Expression, ...]
    right_keys: Tuple[E.Expression, ...]
    condition: Optional[E.Expression] = None
    #: bound by the planner from _JOIN_STATS
    adaptive: Optional[tuple] = None
    #: bound by the planner from _JOIN_INDEX: aux scans over the cached
    #: build permutation and sorted key, and the dense lo/cnt tables.
    #: Derived data: outside plan_key and stats_key; the stage cache
    #: tells them apart by planner._adaptive_snapshot
    index_scan: Optional[PhysicalPlan] = None
    table_scan: Optional[PhysicalPlan] = None
    #: the orientation the cached index was built for: 'fwd' = build on
    #: the right (every strategy but swap), 'rev' = build on the left
    index_orient: Optional[str] = None

    @property
    def traceable(self) -> bool:  # type: ignore[override]
        if self.adaptive is None:
            return False
        _, unique_build, unique_probe, cap = self.adaptive
        if self.how not in ("inner", "left", "left_semi", "left_anti"):
            return False
        if unique_build or cap is not None:
            return True
        # a unique probe side plays the build role of an inner join
        if unique_probe and self.how == "inner":
            return True
        # semi/anti membership without condition or hash sizes itself
        return (self.how in ("left_semi", "left_anti")
                and self.condition is None and self.adaptive[0] != "hash")

    def children(self):
        out = (self.left, self.right)
        if self.index_scan is not None:
            out += (self.index_scan,)
        if self.table_scan is not None:
            out += (self.table_scan,)
        return out

    @functools.cached_property
    def schema(self) -> Schema:
        return join_schema(self.how, self.left.schema, self.right.schema)

    def _strategy(self, unique_build: bool, unique_probe: bool,
                  sized_cap, lcap: int, rcap: int):
        """Traced strategy and the orientation its ranges need, chosen by
        OUTPUT capacity: every operator above the join runs at the
        capacity chosen here, so a selective join must shrink the
        pipeline even where a gather is locally cheaper; expansion pays
        an offsets search and a pair mask, so it must be about 2x
        smaller to win. Shared with the recorder, so the cached index
        has the orientation the next run picks. Returns (strategy,
        'fwd'|'rev')."""
        if self.how == "inner":
            cands = []
            if unique_build:
                cands.append((lcap, 0, "build"))
            if unique_probe:
                cands.append((rcap, 1, "swap"))
            if sized_cap is not None:
                cands.append((sized_cap * 2, 2, "expand"))
            if not cands:
                return None, "fwd"
            strat = min(cands)[2]
            return strat, ("rev" if strat == "swap" else "fwd")
        if unique_build:
            return "build", "fwd"
        if sized_cap is None:
            return "member", "fwd"
        return "expand", "fwd"

    def _indexed_ranges(self, build_key, build_ok, probe_key, probe_ok,
                        child_pipes: List[Pipe], want: str):
        """Join ranges from the cached index where one of the wanted
        orientation is bound and its layout matches; built live
        otherwise. The index is positional, recorded against the build
        side as the first run saw it; a recorded compaction always
        changes the capacity, so equal lengths are the invariant."""
        if self.index_scan is not None and self.index_orient == want:
            ipipe = child_pipes[2]
            perm = ipipe.cols["perm"].data
            if perm.shape[0] == build_key.shape[0]:
                lo_t = cnt_t = None
                if self.table_scan is not None:
                    tpipe = child_pipes[3]
                    lo_t = tpipe.cols["lo"].data
                    cnt_t = tpipe.cols["cnt"].data
                return K.ranges_from_index(perm, ipipe.cols["skey"].data,
                                           lo_t, cnt_t, probe_key, probe_ok)
        return K.build_join_ranges(build_key, build_ok, probe_key, probe_ok)

    # -- key normalization ----------------------------------------------------

    def _key_columns(self, lpipe: Pipe, rpipe: Pipe):
        """Both sides' key columns and their int64 data: strings re-coded
        into one unified dictionary, whose size is their range. Returns
        (left TVs, right TVs, [(left data, right data, string range or
        None)])."""
        lenv, renv = lpipe.env(), rpipe.env()
        lks = [_scalar_column(C.evaluate(k, lenv), "join key")
               for k in self.left_keys]
        rks = [_scalar_column(C.evaluate(k, renv), "join key")
               for k in self.right_keys]
        prepped = []
        for lt, rt in zip(lks, rks):
            if isinstance(lt.dtype, T.StringType) \
                    or isinstance(rt.dtype, T.StringType):
                union, (tl, tr) = C.unify_dictionaries(
                    (lt.dictionary or (), rt.dictionary or ()))
                ld = (C._gather(tl, lt.data) if len(lt.dictionary or ())
                      else lt.data)
                rd = (C._gather(tr, rt.data) if len(rt.dictionary or ())
                      else rt.data)
                prepped.append((ld, rd, max(1, len(union))))
            else:
                prepped.append((K.key_int64(lt.data), K.key_int64(rt.data),
                                None))
        return lks, rks, prepped

    def _packing(self, lpipe: Pipe, rpipe: Pipe, lks, rks, prepped):
        """Per-key (min, range) from the live keys' min/max, which come
        to the host in ONE copy for all keys; "hash" when the packed
        range would pass 2^62."""
        dev = lpipe.mask.device
        i64max = torch.full((), K.INT64_MAX, dtype=torch.int64, device=dev)
        i64min = torch.full((), K.INT64_MIN, dtype=torch.int64, device=dev)
        stats = []
        for lt, rt, (ld, rd, rg) in zip(lks, rks, prepped):
            if rg is None:
                lok = lpipe.mask & lt.valid_or_true(lpipe.capacity)
                rok = rpipe.mask & rt.valid_or_true(rpipe.capacity)
                lo = torch.minimum(torch.where(lok, ld, i64max).min(),
                                   torch.where(rok, rd, i64max).min())
                hi = torch.maximum(torch.where(lok, ld, i64min).max(),
                                   torch.where(rok, rd, i64min).max())
                stats.append(torch.stack([lo, hi]))
        # host sync: every key's (min, max) in one copy
        fetched = iter(torch.stack(stats).tolist() if stats else [])
        total_range = 1
        packing = []
        for _, _, rg in prepped:
            mn = 0
            if rg is None:
                mn, mx = next(fetched)
                if mn > mx:
                    mn, mx = 0, 0
                rg = mx - mn + 1
            if total_range * rg > (1 << 62):  # incl. single wide key
                return "hash"
            total_range *= rg
            packing.append((mn, rg))
        return tuple(packing)

    def _pack(self, lpipe: Pipe, rpipe: Pipe, lks, rks, prepped, packing):
        """One int64 key per row: range packing, or where the range would
        overflow (e.g. two hash-like int64 ids) the keys hash-combined, so
        pairs must be verified by exact key equality (reference:
        HashedRelation.scala:208 — probe by hash, confirm by key).
        Returns (left key, left key-valid, right key, right key-valid,
        hashed, per-key (left, right) data)."""
        pairs = [(ld, rd) for ld, rd, _ in prepped]
        hashed = packing == "hash"
        if hashed:
            lcomb, rcomb = _hash_keys([p[0] for p in pairs],
                                      [p[1] for p in pairs])
        else:
            dev = lpipe.mask.device
            lcomb = torch.zeros((lpipe.capacity,), dtype=torch.int64,
                                device=dev)
            rcomb = torch.zeros((rpipe.capacity,), dtype=torch.int64,
                                device=dev)
            for (ld, rd), (mn, rg) in zip(pairs, packing):
                lcomb = lcomb * rg + (ld - mn).clamp(0, rg - 1)
                rcomb = rcomb * rg + (rd - mn).clamp(0, rg - 1)
        lvalid = lpipe.mask.new_ones((lpipe.capacity,))
        rvalid = rpipe.mask.new_ones((rpipe.capacity,))
        for lt, rt in zip(lks, rks):
            if lt.validity is not None:
                lvalid = lvalid & lt.validity
            if rt.validity is not None:
                rvalid = rvalid & rt.validity
        return lcomb, lvalid, rcomb, rvalid, hashed, pairs

    def _combined_keys(self, lpipe: Pipe, rpipe: Pipe):
        """Blocking key packing (one host sync). Returns (left key, left
        key-valid, right key, right key-valid, packing, per-key data)."""
        lks, rks, prepped = self._key_columns(lpipe, rpipe)
        packing = self._packing(lpipe, rpipe, lks, rks, prepped)
        lkey, lvalid, rkey, rvalid, _, pairs = self._pack(
            lpipe, rpipe, lks, rks, prepped, packing)
        return lkey, lvalid, rkey, rvalid, packing, pairs

    def _traced_keys(self, lpipe: Pipe, rpipe: Pipe):
        """Key packing with the recorded per-key (min, range): no sync.
        Sound because the planner binds only stats recorded for these
        leaves."""
        lks, rks, prepped = self._key_columns(lpipe, rpipe)
        return self._pack(lpipe, rpipe, lks, rks, prepped, self.adaptive[0])

    # -- execution ------------------------------------------------------------

    def execute(self, child_pipes: List[Pipe]) -> Pipe:
        if self.traceable:
            return self._trace(child_pipes)
        return self._blocking(child_pipes, record=False)

    def execute_blocking(self, child_pipes: List[Pipe]) -> Pipe:
        return self._blocking(child_pipes, record=True)

    def _blocking(self, child_pipes: List[Pipe], record: bool) -> Pipe:
        lpipe, rpipe = child_pipes[:2]
        how = self.how
        if how == "cross" and self.condition is None:
            return self._cross(lpipe, rpipe)
        if not self.left_keys:
            # condition-only join: chunked nested loop instead of
            # materializing all L*R pairs at once (reference:
            # BroadcastNestedLoopJoinExec)
            return self._nested_loop(lpipe, rpipe, how)

        lkey, lvalid, rkey, rvalid, packing, prepped = self._combined_keys(
            lpipe, rpipe)
        hashed = packing == "hash"
        # probe = left, build = right (left-side row order is preserved,
        # matching streamed-side semantics)
        ranges = K.build_join_ranges(rkey, rpipe.mask & rvalid,
                                     lkey, lpipe.mask & lvalid)
        sk = (self.stats_key()
              if how in ("inner", "left", "left_semi", "left_anti") else None)
        record = record and sk is not None and sk not in _JOIN_STATS
        if how in ("left_semi", "left_anti") and self.condition is None \
                and not hashed:
            if record:
                maxc = int(ranges.counts.max())  # host sync: first run
                _JOIN_STATS.put(sk, (packing, maxc <= 1, False, None))
                self._record_index(sk, "fwd", rkey, rpipe.mask & rvalid,
                                   packing)
            has_match = ranges.counts > 0
            keep = lpipe.mask & (has_match if how == "left_semi"
                                 else ~has_match)
            return Pipe(lpipe.cols, keep, lpipe.order)
        if record:
            # host sync: the output size and, on the first run only, the
            # most matches of a probe row and of a build row; either side
            # unique makes the join traceable, and the bucketed capacity
            # makes even a many-to-many join replay at a static size
            rev = K.build_join_ranges(lkey, lpipe.mask & lvalid,
                                      rkey, rpipe.mask & rvalid)
            total, maxc, maxb = torch.stack(
                [ranges.counts.sum(), ranges.counts.max(),
                 rev.counts.max()]).tolist()
            cap = K.bucket(total)
            _JOIN_STATS.put(sk, (packing, maxc <= 1, maxb <= 1, cap))
            # cache the build index in the orientation the next (traced)
            # run picks, so it skips the argsort and the searches
            _, orient = self._strategy(maxc <= 1, maxb <= 1, cap,
                                       lpipe.capacity, rpipe.capacity)
            if orient == "rev":
                self._record_index(sk, "rev", lkey, lpipe.mask & lvalid,
                                   packing)
            else:
                self._record_index(sk, "fwd", rkey, rpipe.mask & rvalid,
                                   packing)
        else:
            st = _JOIN_STATS.get(sk) if sk is not None else None
            if st is not None and st[3] is not None:
                cap = st[3]  # recorded for these leaves: no sync
            else:
                cap = K.bucket(int(ranges.counts.sum()))  # host sync
        return self._pairs_pipe(lpipe, rpipe, ranges, hashed, prepped, cap)

    def _trace(self, child_pipes: List[Pipe]) -> Pipe:
        """The traced join, with no host sync: strategy by output
        capacity (``_strategy``)."""
        lpipe, rpipe = child_pipes[:2]
        _, unique_build, unique_probe, sized_cap = self.adaptive
        lcomb, lvalid, rcomb, rvalid, hashed, prepped = self._traced_keys(
            lpipe, rpipe)
        strat, _ = self._strategy(unique_build, unique_probe, sized_cap,
                                  lpipe.capacity, rpipe.capacity)
        if strat == "swap":
            return self._trace_swapped(lpipe, rpipe, lcomb, lvalid, rcomb,
                                       rvalid, hashed, prepped, child_pipes)
        ranges = self._indexed_ranges(rcomb, rpipe.mask & rvalid,
                                      lcomb, lpipe.mask & lvalid,
                                      child_pipes, "fwd")
        if strat == "expand":
            return self._pairs_pipe(lpipe, rpipe, ranges, hashed, prepped,
                                    sized_cap)
        has = ranges.counts > 0
        if strat == "member":
            # semi/anti without condition or hash: membership only
            keep = lpipe.mask & (has if self.how == "left_semi" else ~has)
            return Pipe(lpipe.cols, keep, lpipe.order)
        # 'build': each probe row has at most one match, so the output
        # is a gather at probe capacity (the PK-FK path)
        lcap, rcap = lpipe.capacity, rpipe.capacity
        b_idx = ranges.build_perm[ranges.lo.clamp(0, rcap - 1)]
        if hashed:
            p_idx = torch.arange(lcap, device=lpipe.mask.device)
            has = has & _verify_key_pairs(prepped, p_idx, b_idx, lcap)
        if self.how in ("left_semi", "left_anti") and self.condition is None:
            keep = lpipe.mask & (has if self.how == "left_semi" else ~has)
            return Pipe(lpipe.cols, keep, lpipe.order)
        pair_names = E.dedup_pair_names(lpipe.order, rpipe.order)
        n_l = len(lpipe.order)
        cols: Dict[str, TV] = {}
        for out_name, src in zip(pair_names[:n_l], lpipe.order):
            cols[out_name] = lpipe.cols[src]
        for out_name, src in zip(pair_names[n_l:], rpipe.order):
            cols[out_name] = _take_valid(rpipe.cols[src], b_idx, has)
        pair_ok = lpipe.mask & has
        if self.condition is not None:
            ctv = C.evaluate(self.condition,
                             Env(cols, lcap, device=pair_ok.device))
            pair_ok = pair_ok & ctv.data & ctv.valid_or_true(lcap)
        if self.how == "left_semi":
            return Pipe(lpipe.cols, pair_ok, lpipe.order)
        if self.how == "left_anti":
            return Pipe(lpipe.cols, lpipe.mask & ~pair_ok, lpipe.order)
        if self.how == "inner":
            return Pipe(cols, pair_ok, pair_names)
        # left outer: every live left row, the right side NULL where the
        # (condition-passing) match is absent
        for out_name in pair_names[n_l:]:
            cols[out_name] = _mask_valid(cols[out_name], pair_ok)
        return Pipe(cols, lpipe.mask, pair_names)

    def _trace_swapped(self, lpipe: Pipe, rpipe: Pipe, lcomb, lvalid,
                       rcomb, rvalid, hashed, prepped,
                       child_pipes: List[Pipe]) -> Pipe:
        """Inner join with a unique LEFT side: build on the left, stream
        the right; each right row gathers its single left match, so rows
        come out in the right side's order."""
        ranges = self._indexed_ranges(lcomb, lpipe.mask & lvalid,
                                      rcomb, rpipe.mask & rvalid,
                                      child_pipes, "rev")
        has = ranges.counts > 0
        rcap = rpipe.capacity
        l_idx = ranges.build_perm[ranges.lo.clamp(0, lpipe.capacity - 1)]
        if hashed:
            # verify with the sides swapped: the left is the build
            swapped = [(rd, ld) for ld, rd in prepped]
            has = has & _verify_key_pairs(
                swapped, torch.arange(rcap, device=has.device), l_idx, rcap)
        pair_names = E.dedup_pair_names(lpipe.order, rpipe.order)
        n_l = len(lpipe.order)
        cols: Dict[str, TV] = {}
        for out_name, src in zip(pair_names[:n_l], lpipe.order):
            cols[out_name] = _take_valid(lpipe.cols[src], l_idx, has)
        for out_name, src in zip(pair_names[n_l:], rpipe.order):
            cols[out_name] = rpipe.cols[src]
        pair_ok = rpipe.mask & has
        if self.condition is not None:
            ctv = C.evaluate(self.condition,
                             Env(cols, rcap, device=pair_ok.device))
            pair_ok = pair_ok & ctv.data & ctv.valid_or_true(rcap)
        return Pipe(cols, pair_ok, pair_names)

    def _record_index(self, sk, orient: str, build_key, build_ok,
                      packing) -> None:
        """Build and cache the join index (permutation and sorted key,
        and the dense lo/cnt tables where the packed domain is small) for
        these leaves: one-time work on the blocking run, read by later
        traced runs through aux scans. The index is positional, so the
        build side's row layout must be the same in the blocking and the
        traced run; joins and sorted aggregates lay their output out
        differently on the two paths, so a build side holding one is not
        indexed."""
        build_side = self.left if orient == "rev" else self.right
        if not _layout_stable(build_side):
            return
        domain = None
        if packing != "hash":
            domain = 1
            for _, rg in packing:
                domain *= rg
        perm, skey, lo_t, cnt_t = K.make_join_index(build_key, build_ok,
                                                    domain)
        ib = _aux_batch((("perm", perm), ("skey", skey)))
        tb = (_aux_batch((("lo", lo_t), ("cnt", cnt_t)))
              if lo_t is not None else None)
        _JOIN_INDEX.put(sk, (orient, ib, tb))

    def _pairs_pipe(self, lpipe: Pipe, rpipe: Pipe, ranges, hashed,
                    prepped, cap: int) -> Pipe:
        """General match expansion at a static capacity: the blocking
        tail and the traced 'expand' strategy alike."""
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

    def _key(self):
        return ("Join", self.how,
                tuple(E.expr_key(k) for k in self.left_keys),
                tuple(E.expr_key(k) for k in self.right_keys),
                None if self.condition is None else E.expr_key(self.condition),
                self.left.plan_key(), self.right.plan_key())


def append_unmatched_left(cols, pair_ok, order, lpipe, matched):
    """Append left rows with no (condition-passing) match; right side
    NULL (reference contract: joins/ShuffledHashJoinExec.scala:38 —
    unmatched stream rows padded with nulls). Returns (cols, mask)."""
    lcap = lpipe.capacity
    n_l = len(lpipe.order)
    new_cols: Dict[str, TV] = {}
    for i, name in enumerate(order):
        tv = cols[name]
        src = (lpipe.cols[lpipe.order[i]] if i < n_l
               else _null_rows(tv, lcap))
        new_cols[name] = _cat_rows(tv, src)
    return new_cols, torch.cat([pair_ok, lpipe.mask & ~matched])


def _null_rows(tv: TV, rows: int) -> TV:
    """``rows`` NULL rows shaped as ``tv``'s (an array's as wide, with
    zero lengths): the padding side of an outer join."""
    dev = tv.data.device
    lengths = (None if tv.lengths is None
               else torch.zeros((rows,), dtype=torch.int32, device=dev))
    return TV(torch.zeros((rows,) + tuple(tv.data.shape[1:]),
                          dtype=tv.data.dtype, device=dev),
              torch.zeros((rows,), dtype=torch.bool, device=dev), tv.dtype,
              tv.dictionary, lengths)


def _cat_lengths(a: TV, b: TV) -> Optional[torch.Tensor]:
    if a.lengths is None or b.lengths is None:
        return None
    return torch.cat([a.lengths.to(torch.int32), b.lengths.to(torch.int32)])


def _cat_rows(a: TV, b: TV) -> TV:
    """The rows of ``a`` then those of ``b`` (same type), arrays padded
    to the wider."""
    ad, bd = a.data, b.data
    if ad.dim() == 2:
        width = max(ad.shape[1], bd.shape[1])
        ad, bd = C.pad_width(ad, width), C.pad_width(bd, width)
    validity = None
    if a.validity is not None or b.validity is not None:
        validity = torch.cat([a.valid_or_true(ad.shape[0]),
                              b.valid_or_true(bd.shape[0])])
    return TV(torch.cat([ad, bd]), validity, a.dtype, a.dictionary,
              _cat_lengths(a, b))


def append_unmatched_right(cols, pair_ok, order, lpipe, rpipe, matched_b):
    """Append right rows with no (condition-passing) match; left side
    NULL. Returns (cols, mask)."""
    rcap = rpipe.capacity
    n_l = len(lpipe.order)
    new_cols: Dict[str, TV] = {}
    for i, name in enumerate(order):
        tv = cols[name]
        src = (_null_rows(tv, rcap) if i < n_l
               else rpipe.cols[rpipe.order[i - n_l]])
        new_cols[name] = _cat_rows(tv, src)
    return new_cols, torch.cat([pair_ok, rpipe.mask & ~matched_b])
