"""Distributed physical operators (the port of
``spark_tpu/parallel/operators.py``).

Each ``execute`` is one rank's view: it runs on the rank's thread, over
its shard, beside the single-device operators of
``physical/operators.py``, and calls the collectives of
``parallel/exchange.py`` at the points where the reference plants its
ShuffleExchangeExec / BroadcastExchangeExec nodes (reference:
exchange/EnsureRequirements.scala:49). A mesh stage is the tree of such
operators between join boundaries (``parallel/executor.py``).

The aggregates reduce locally with the engine's grouped reductions
(``physical/kernels.py``: on the card the hand kernels ``seg_agg.seg_sum``,
``seg_minmax`` and ``seg_fsum``) and merge across ranks with
``psum``/``pmin``/``pmax``.

Adaptive execution (``parallel/executor.py``) measures an exchange with
``ExchangeStatsExec`` (its Count-Min tables and HyperLogLog registers
are grouped reductions too, so on the card they run the hand kernels)
and runs it at the measured capacities; a fused span
(``FusedSpanExec``) runs an exchange, its consumer and the
row-preserving operators after it in one rank stage, its capacity rung
(``capacity_ladder``) taken from the exchange's own count read.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from spark_tpu_torch import types as T
from spark_tpu_torch.expr import compiler as C
from spark_tpu_torch.expr import expressions as E
from spark_tpu_torch.expr.compiler import TV, Env
from spark_tpu_torch.parallel import exchange as X
from spark_tpu_torch.parallel.sharded import ShardedBatch
from spark_tpu_torch.physical import kernels as K
from spark_tpu_torch.physical import operators as P
from spark_tpu_torch.physical.operators import Pipe, rewrite_agg_outputs
from spark_tpu_torch.physical.random import fold_in, prng_key, uniform
from spark_tpu_torch.plan.logical import join_schema
from spark_tpu_torch.types import Field, Schema


@dataclass(eq=False)
class ShardScanExec(P.PhysicalPlan):
    """Leaf: a materialized ShardedBatch; each rank reads its shard."""

    sharded: ShardedBatch

    @functools.cached_property
    def schema(self) -> Schema:
        return self.sharded.schema

    def execute(self, child_pipes: List[Pipe]) -> Pipe:
        return Pipe.from_batch(self.sharded.shard_batch(X.axis_index()))

    def node_string(self):
        return f"ShardScan{list(self.schema.names)}"

    def _key(self):
        return ("ShardScan", self.sharded.per_device_capacity,
                tuple((f.name, repr(f.dtype)) for f in self.schema.fields))


@dataclass(eq=False)
class DistRangeExec(P.PhysicalPlan):
    """range() made sharded: rank d makes global positions
    [d*p, (d+1)*p) (reference RangeExec:412 splits by numSlices)."""

    start: int
    end: int
    step: int
    num_rows: int
    per_device: int
    col_name: str = "id"

    @functools.cached_property
    def schema(self) -> Schema:
        return Schema((Field(self.col_name, T.INT64, nullable=False),))

    def execute(self, child_pipes: List[Pipe]) -> Pipe:
        p = self.per_device
        dev = X.current().device
        gpos = X.axis_index() * p + torch.arange(p, dtype=torch.int64,
                                                 device=dev)
        ids = self.start + gpos * self.step
        return Pipe({self.col_name: TV(ids, None, T.INT64, None)},
                    gpos < self.num_rows, [self.col_name])

    def _key(self):
        return ("DistRange", self.start, self.end, self.step, self.num_rows,
                self.per_device, self.col_name)


# ---- exchanges --------------------------------------------------------------


#: fixed odd 64-bit seeds of the Count-Min hash rows (the reference's,
#: spark_tpu/parallel/operators.py:97), as int64 bits
_CM_SEEDS = tuple(K._signed64(s) for s in (
    0x9E3779B97F4A7C15, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9,
    0x27D4EB2F165667C5, 0x85EBCA77C2B2AE63, 0x2545F4914F6CDD1D,
    0xD6E8FEB86659FD93, 0xA24BAED4963EE407))


@dataclass(eq=False)
class HashPartitionExchangeExec(P.PhysicalPlan):
    """Rows to rank hash(keys) mod D. ``key_union_dicts`` (per key,
    optional): a unified string dictionary the codes translate through
    before hashing, so two relations with different dictionaries route
    equal strings to the same rank.

    Adaptive fields, set by the executor from measured stats:
    ``slice_capacity``/``out_capacity`` bound the send slice and the
    received capacity (``exchange.exchange``); ``fan_destinations`` keeps
    rows bound for skewed destinations on their own rank ahead of a
    pre-merge (``exchange.fan_local``); ``presplit_hashes`` (Count-Min
    heavy-hitter row hashes) salts the rows of hot keys round-robin over
    all ranks before the exchange, legal only on a raw-row exchange
    ahead of a partial->final pair whose accumulators are
    partition-invariant (``legality.strategy_verdict``)."""

    keys: Tuple[E.Expression, ...]
    child: P.PhysicalPlan
    key_union_dicts: Optional[Tuple[Optional[Tuple[str, ...]], ...]] = None
    slice_capacity: Optional[int] = None
    out_capacity: Optional[int] = None
    fan_destinations: Optional[Tuple[int, ...]] = None
    presplit_hashes: Optional[Tuple[int, ...]] = None
    op = "hash"

    def children(self):
        return (self.child,)

    @functools.cached_property
    def schema(self) -> Schema:
        return self.child.schema

    def _key_tvs(self, pipe: Pipe) -> List[TV]:
        """The key columns after union-dictionary translation: what
        routing hashes, and what the stats stage sketches."""
        env = pipe.env()
        tvs = [C.evaluate(k, env) for k in self.keys]
        if self.key_union_dicts is None:
            return tvs
        out = []
        for tv, union in zip(tvs, self.key_union_dicts):
            if union is not None and tv.dictionary is not None:
                pos = {s: i for i, s in enumerate(union)}
                table = np.asarray([pos[s] for s in tv.dictionary],
                                   dtype=np.int64)
                tv = TV(C._gather(table, tv.data), tv.validity, tv.dtype,
                        union)
            out.append(tv)
        return out

    def _target(self, pipe: Pipe, d: int) -> torch.Tensor:
        key_tvs = self._key_tvs(pipe)
        target = X.hash_target(key_tvs, pipe.mask, d)
        if self.presplit_hashes:
            h = X.hash_rows(key_tvs)
            hot = torch.zeros(h.shape, dtype=torch.bool, device=h.device)
            for ph in self.presplit_hashes:
                hot = hot | (h == K._signed64(int(ph) % (1 << 64)))
            hot = hot & pipe.mask
            # hot rows round-robin over every rank, offset by the source
            # rank so the D salted streams interleave
            rank = torch.cumsum(hot.to(torch.int64), 0) - 1
            target = torch.where(hot, (rank + X.axis_index()) % d, target)
        if self.fan_destinations:
            target = X.fan_local(target, self.fan_destinations)
        return target

    def execute(self, child_pipes: List[Pipe]) -> Pipe:
        pipe = child_pipes[0]
        return X.exchange(pipe, self._target(pipe, X.axis_size()), self.op,
                          self.slice_capacity, self.out_capacity)

    def node_string(self):
        return f"Exchange[hash({', '.join(map(str, self.keys))})]"

    def _key(self):
        return ("HashExchange", tuple(E.expr_key(k) for k in self.keys),
                self.key_union_dicts, self.slice_capacity,
                self.out_capacity, self.fan_destinations,
                self.presplit_hashes, self.child.plan_key())


@dataclass(eq=False)
class RoundRobinExchangeExec(P.PhysicalPlan):
    """Balanced redistribution (RoundRobinPartitioning)."""

    child: P.PhysicalPlan
    slice_capacity: Optional[int] = None
    out_capacity: Optional[int] = None
    op = "roundrobin"

    def children(self):
        return (self.child,)

    @functools.cached_property
    def schema(self) -> Schema:
        return self.child.schema

    def _target(self, pipe: Pipe, d: int) -> torch.Tensor:
        rank = torch.cumsum(pipe.mask.to(torch.int64), 0) - 1
        return (rank + X.axis_index()) % d

    def execute(self, child_pipes: List[Pipe]) -> Pipe:
        pipe = child_pipes[0]
        return X.exchange(pipe, self._target(pipe, X.axis_size()), self.op,
                          self.slice_capacity, self.out_capacity)

    def _key(self):
        return ("RoundRobinExchange", self.slice_capacity,
                self.out_capacity, self.child.plan_key())


@dataclass(eq=False)
class RangeExchangeExec(P.PhysicalPlan):
    """Range-partition rows by the leading sort key, so rank order is the
    global sort order; a local sort completes the global one (reference:
    ShuffleExchangeExec.scala:280 + SortExec)."""

    orders: Tuple[E.SortOrder, ...]
    child: P.PhysicalPlan
    slice_capacity: Optional[int] = None
    out_capacity: Optional[int] = None
    op = "range"

    def children(self):
        return (self.child,)

    @functools.cached_property
    def schema(self) -> Schema:
        return self.child.schema

    def _target(self, pipe: Pipe, d: int) -> torch.Tensor:
        o = self.orders[0]
        key = P._scalar_column(C.evaluate(o.child, pipe.env()), "ORDER BY")
        return X.range_target(key, o.ascending, o.nulls_first_resolved, d,
                              pipe.mask)

    def execute(self, child_pipes: List[Pipe]) -> Pipe:
        pipe = child_pipes[0]
        return X.exchange(pipe, self._target(pipe, X.axis_size()), self.op,
                          self.slice_capacity, self.out_capacity)

    def node_string(self):
        return f"Exchange[range({', '.join(map(str, self.orders))})]"

    def _key(self):
        return ("RangeExchange",
                tuple((E.expr_key(o.child), o.ascending,
                       o.nulls_first_resolved) for o in self.orders),
                self.slice_capacity, self.out_capacity,
                self.child.plan_key())


@dataclass(eq=False)
class ExchangeStatsExec(P.PhysicalPlan):
    """Measure an exchange without running it: the routing targets the
    exchange itself computes, reduced to ``__incoming`` (psum of the
    per-destination live counts: the rows each rank will receive) and
    ``__maxslice`` (pmax: the largest (source, destination) cell). The
    reference's MapOutputStatistics (MapOutputTrackerMaster.getStatistics,
    read by AdaptiveSparkPlanExec between stages). One output row block,
    live on rank 0 only; the executor reads it once.

    Optional, hash exchanges only (reference:
    spark_tpu/parallel/operators.py:267-438):

    - ``sketch_registers`` > 0 adds ``__ndvreg``: HyperLogLog register
      maxima over the exchange keys. Index and rank come from the row
      hash routing uses; the ranks (float32) reduce per register with
      ``kernels.seg_max`` (the card's B2 max kernel at 64 < R <= 1024)
      and pmax across the ranks.
    - ``key_stats`` > 0 adds ``__kmin``/``__kmax``/``__knull``: each key's
      global min, max and NULL count over the translated key columns
      (the measured domain of the hash-partial strategy).
    - ``cm_depth``/``cm_width`` > 0 add ``__hothash``/``__hotest``: a
      Count-Min heavy-hitter probe over the same row hashes. Each depth
      rehashes with a fixed seed into a ``cm_width``-wide table
      (``kernels.seg_count``, the card's B1 count kernel at width <= 1024;
      psum across the ranks); a row's estimate is the min over depths,
      dead rows estimate -1, and each rank publishes its first argmax row
      (its full hash and estimate) at its own slot through a one-hot psum.
    """

    exchange: P.PhysicalPlan  # Hash/RoundRobin/Range exchange exec
    sketch_registers: int = 0    # power of two; 0 = no distinct sketch
    key_stats: int = 0           # number of keys to min/max; 0 = none
    cm_depth: int = 0            # Count-Min hash rows; 0 = no CM probe
    cm_width: int = 0            # power of two; 0 = no CM probe

    def children(self):
        return self.exchange.children()

    @functools.cached_property
    def schema(self) -> Schema:
        names = ["__incoming", "__maxslice"]
        if self.sketch_registers:
            names.append("__ndvreg")
        if self.key_stats:
            names += ["__kmin", "__kmax", "__knull"]
        if self.cm_depth and self.cm_width:
            names += ["__hothash", "__hotest"]
        return Schema(tuple(Field(n, T.INT64, nullable=False)
                            for n in names))

    def execute(self, child_pipes: List[Pipe]) -> Pipe:
        pipe = child_pipes[0]
        d, me = X.axis_size(), X.axis_index()
        dev = pipe.mask.device
        i64 = torch.int64
        target = self.exchange._target(pipe, d)
        local = K.seg_count(target.clamp(0, d - 1).to(torch.int32),
                            pipe.mask, d)
        cap = max(d, self.sketch_registers or 0, self.key_stats or 0)

        def padded(v: torch.Tensor) -> TV:
            v = v.to(i64)
            data = torch.cat([v, torch.zeros((cap - v.shape[0],), dtype=i64,
                                             device=dev)])
            return TV(data, None, T.INT64, None)

        cols = {"__incoming": padded(X.psum(local)),
                "__maxslice": padded(X.pmax(local))}
        cm = bool(self.cm_depth and self.cm_width)
        if self.sketch_registers or self.key_stats or cm:
            key_tvs = self.exchange._key_tvs(pipe)
            h = X.hash_rows(key_tvs)

        if self.sketch_registers:
            r = int(self.sketch_registers)
            p = r.bit_length() - 1  # r = 2 ** p (the caller checks)
            idx = (h & (r - 1)).to(torch.int32)
            w = K.shift_right_logical(h, p)
            # the rank (leading zeros of the 64 - p bit suffix, plus 1)
            # through the float64 highest-set-bit of the reference, so the
            # registers are its own: a suffix within half an ulp below a
            # power of two rounds up and ranks one low, as there
            hb = torch.floor(torch.log2(w.to(torch.float64).clamp(min=1.0)))
            rho = torch.where(w == 0,
                              torch.full((), 64 - p + 1, dtype=torch.float64,
                                         device=dev),
                              (64 - p) - hb)
            reg = K.seg_max(rho.to(torch.float32), idx, pipe.mask, r)
            cols["__ndvreg"] = padded(X.pmax(reg).clamp(min=0.0))

        if self.key_stats:
            big = torch.full((1,), K.INT64_MAX, dtype=i64, device=dev)
            small = torch.full((1,), K.INT64_MIN, dtype=i64, device=dev)
            mins, maxs, nulls = [], [], []
            for tv in key_tvs[:self.key_stats]:
                data = tv.data.to(i64)
                valid = pipe.mask if tv.validity is None                     else pipe.mask & tv.validity
                mins.append(torch.cat([torch.where(valid, data, big),
                                       big]).min())
                maxs.append(torch.cat([torch.where(valid, data, small),
                                       small]).max())
                nulls.append(torch.zeros((), dtype=i64, device=dev)
                             if tv.validity is None
                             else (pipe.mask & ~tv.validity).sum())
            cols["__kmin"] = padded(X.pmin(torch.stack(mins)))
            cols["__kmax"] = padded(X.pmax(torch.stack(maxs)))
            cols["__knull"] = padded(X.psum(torch.stack(nulls)))

        if cm:
            width = int(self.cm_width)  # a power of two (the caller)
            est = None
            for seed in _CM_SEEDS[:int(self.cm_depth)]:
                idx = (K.hash64(h ^ seed) & (width - 1)).to(torch.int32)
                table = X.psum(K.seg_count(idx, pipe.mask, width))
                e = table[idx.long()]
                est = e if est is None else torch.minimum(est, e)
            # dead rows estimate -1, so a live row is the candidate
            # whenever one exists; the host drops estimates <= 0 anyway
            est = torch.where(pipe.mask, est, torch.full_like(est, -1))
            if pipe.capacity:
                cand = torch.argmax(est)  # the first maximal row
                cand_h, cand_e = h[cand], est[cand]
            else:
                cand_h = torch.zeros((), dtype=i64, device=dev)
                cand_e = torch.full((), -1, dtype=i64, device=dev)
            slot = torch.arange(cap, device=dev) == me
            zero = torch.zeros((), dtype=i64, device=dev)
            cols["__hothash"] = TV(X.psum(torch.where(slot, cand_h, zero)),
                                   None, T.INT64, None)
            cols["__hotest"] = TV(X.psum(torch.where(slot, cand_e, zero)),
                                  None, T.INT64, None)

        # replicated reductions: rank 0 keeps the one live copy
        mask = torch.full((cap,), me == 0, dtype=torch.bool, device=dev)
        return Pipe(cols, mask, list(self.schema.names))

    def node_string(self):
        return f"ExchangeStats[{self.exchange.node_string()}]"

    def _key(self):
        return ("ExchangeStats", self.sketch_registers, self.key_stats,
                self.cm_depth, self.cm_width, self.exchange.plan_key())


@dataclass(eq=False)
class BroadcastExchangeExec(P.PhysicalPlan):
    child: P.PhysicalPlan

    def children(self):
        return (self.child,)

    @functools.cached_property
    def schema(self) -> Schema:
        return self.child.schema

    def execute(self, child_pipes: List[Pipe]) -> Pipe:
        return X.broadcast_gather(child_pipes[0])

    def _key(self):
        return ("BroadcastExchange", self.child.plan_key())


@dataclass(eq=False)
class SinglePartitionExchangeExec(P.PhysicalPlan):
    child: P.PhysicalPlan

    def children(self):
        return (self.child,)

    @functools.cached_property
    def schema(self) -> Schema:
        return self.child.schema

    def execute(self, child_pipes: List[Pipe]) -> Pipe:
        return X.to_single_partition(child_pipes[0])

    def _key(self):
        return ("SingleExchange", self.child.plan_key())


@dataclass(eq=False)
class DistSampleExec(P.PhysicalPlan):
    """Bernoulli sample with the rank folded into the key: each shard
    draws ``uniform(fold_in(PRNGKey(seed), rank), (capacity,))``, the
    reference's draws bit for bit (``physical/random.py``)."""

    fraction: float
    seed: int
    child: P.PhysicalPlan

    def children(self):
        return (self.child,)

    @functools.cached_property
    def schema(self) -> Schema:
        return self.child.schema

    def execute(self, child_pipes: List[Pipe]) -> Pipe:
        pipe = child_pipes[0]
        key = fold_in(prng_key(self.seed), X.axis_index())
        u = uniform(0, pipe.capacity, pipe.mask.device, key=key)
        return Pipe(pipe.cols, pipe.mask & (u < self.fraction), pipe.order)

    def _key(self):
        return ("DistSample", self.fraction, self.seed,
                self.child.plan_key())


@dataclass(eq=False)
class DistLimitExec(P.PhysicalPlan):
    """Global limit without gathering: a row's global live rank is its
    local rank plus the live counts of the ranks before it (one
    all_gather of D counts)."""

    n: int
    offset: int
    child: P.PhysicalPlan

    def children(self):
        return (self.child,)

    @functools.cached_property
    def schema(self) -> Schema:
        return self.child.schema

    def execute(self, child_pipes: List[Pipe]) -> Pipe:
        pipe = child_pipes[0]
        local = pipe.mask.to(torch.int64)
        counts = X.all_gather(local.sum().reshape(1))
        prefix = counts[:X.axis_index()].sum()
        rank = torch.cumsum(local, 0) - 1 + prefix
        keep = pipe.mask & (rank >= self.offset) & (
            rank < self.offset + self.n)
        return Pipe(pipe.cols, keep, pipe.order)

    def node_string(self):
        return f"DistLimit[{self.n}]"

    def _key(self):
        return ("DistLimit", self.n, self.offset, self.child.plan_key())


# ---- distributed aggregation ------------------------------------------------


def _merged_agg(agg: E.AggregateExpression, env: Env, seg, mask,
                num_segments: int, capacity: int) -> TV:
    """One aggregate reduced per segment on each rank, then merged across
    the ranks: the partial/final plan (reference: AggUtils.scala:33)
    with a collective as the phase boundary. The local reductions are
    the engine's (on the card the hand kernels)."""
    if isinstance(agg, E.Count) and agg.child is None:
        return TV(X.psum(K.seg_count(seg, mask, num_segments)), None,
                  T.INT64, None)

    tv = C.evaluate(agg.child, env)  # type: ignore[attr-defined]
    ok = mask & tv.valid_or_true(capacity)
    if getattr(agg, "distinct", False):
        # exact only when equal values are co-resident: the planner
        # hash-exchanges on the distinct child first
        ok = ok & P._distinct_mask_cached(env, agg.child, tv, seg, ok)
    cnt = X.psum(K.seg_count(seg, ok, num_segments))
    any_valid = cnt > 0

    if isinstance(agg, E.Count):
        return TV(cnt, None, T.INT64, None)
    if isinstance(agg, E.Sum):
        if isinstance(tv.dtype, T.DecimalType):
            s = X.psum(K.seg_sum(tv.data, seg, ok, num_segments))
            return TV(s, any_valid, P.decimal_sum_type(tv.dtype), None)
        out_dt = T.INT64 if tv.dtype.is_integral else tv.dtype
        data = tv.data.to(C._torch_dtype(out_dt))
        return TV(X.psum(K.seg_sum(data, seg, ok, num_segments)), any_valid,
                  out_dt, None)
    if isinstance(agg, E.Avg):
        if isinstance(tv.dtype, T.DecimalType):
            total = X.psum(K.seg_sum(tv.data, seg, ok, num_segments))
            data, out_dt = P.decimal_avg(total, cnt, tv.dtype)
            return TV(data, any_valid, out_dt, None)
        s = X.psum(K.seg_sum(tv.data.to(torch.float64), seg, ok,
                             num_segments))
        return TV(s / cnt.clamp(min=1).to(torch.float64), any_valid,
                  T.FLOAT64, None)
    if isinstance(agg, E.Min):
        return TV(X.pmin(K.seg_min(tv.data, seg, ok, num_segments)),
                  any_valid, tv.dtype, tv.dictionary)
    if isinstance(agg, E.Max):
        return TV(X.pmax(K.seg_max(tv.data, seg, ok, num_segments)),
                  any_valid, tv.dtype, tv.dictionary)
    if isinstance(agg, E.StddevVariance):
        # as the single-device operator: a decimal computes on its value
        x = C._cast_data(tv.data, tv.dtype, T.FLOAT64)
        c = cnt.to(torch.float64)
        s = X.psum(K.seg_sum(x, seg, ok, num_segments))
        s2 = X.psum(K.seg_sum(x * x, seg, ok, num_segments))
        m2 = (s2 - s * s / c.clamp(min=1.0)).clamp(min=0.0)
        samp = agg.kind.endswith("_samp")
        var = m2 / (c - 1.0 if samp else c).clamp(min=1.0)
        data = torch.sqrt(var) if agg.kind.startswith("stddev") else var
        return TV(data, any_valid & (c >= (2.0 if samp else 1.0)),
                  T.FLOAT64, None)
    if isinstance(agg, E.First):
        use = ok if agg.ignore_nulls else mask
        data, found = K.seg_first(tv.data, seg, use, num_segments, capacity)
        if tv.validity is not None:
            vfirst, _ = K.seg_first(tv.valid_or_true(capacity), seg, use,
                                    num_segments, capacity)
        else:
            vfirst = torch.ones((num_segments,), dtype=torch.bool,
                                device=seg.device)
        # the lowest rank that found a first row wins
        d, me = X.axis_size(), X.axis_index()
        winner = X.pmin(torch.where(found, me, d))
        mine = found & (winner == me)
        data = X.psum(torch.where(mine, data, torch.zeros_like(data)))
        valid = X.psum((mine & vfirst).to(torch.int32)) > 0
        return TV(data, (winner < d) & valid, tv.dtype, tv.dictionary)
    raise NotImplementedError(f"distributed aggregate {agg!r}")


@dataclass(eq=False)
class PSumAggExec(P.PhysicalPlan):
    """Direct-path aggregation over the mesh: dense group ids from the
    keys' known cardinalities, local segment reductions, a psum merge
    across ranks, no shuffle (the north-star operator, SURVEY.md §2).
    The merged result lives on rank 0 (masked off elsewhere)."""

    groupings: Tuple[E.Expression, ...]
    aggregates: Tuple[E.Expression, ...]
    child: P.PhysicalPlan

    def children(self):
        return (self.child,)

    @functools.cached_property
    def schema(self) -> Schema:
        return P.HashAggregateExec(self.groupings, self.aggregates,
                                   self.child).schema

    def execute(self, child_pipes: List[Pipe]) -> Pipe:
        pipe = child_pipes[0]
        env = pipe.env()
        cap = pipe.capacity
        dev = pipe.mask.device
        key_tvs = [C.evaluate(g, env) for g in self.groupings]
        codes, validities, cards = P.group_key_codes(key_tvs)
        if not key_tvs:
            seg = torch.zeros((cap,), dtype=torch.int32, device=dev)
            num_segments = 1
        else:
            seg, num_segments = K.pack_codes(codes, validities, cards)
            seg = seg.to(torch.int32)

        _, agg_calls = rewrite_agg_outputs(self.groupings, self.aggregates)
        agg_tvs = [_merged_agg(a, env, seg, pipe.mask, num_segments, cap)
                   for a in agg_calls]
        if not key_tvs:
            out_mask = torch.ones((1,), dtype=torch.bool, device=dev)
            out_keys: List[TV] = []
        else:
            out_mask = X.psum(K.seg_count(seg, pipe.mask, num_segments)) > 0
            nullable = [v is not None for v in validities]
            unpacked = K.unpack_code(
                torch.arange(num_segments, device=dev), cards, nullable)
            out_keys = [TV(code.to(C._torch_dtype(tv.dtype)), valid,
                           tv.dtype, tv.dictionary)
                        for (code, valid), tv in zip(unpacked, key_tvs)]
        if X.axis_index() != 0:  # replicated: rank 0 keeps the one copy
            out_mask = torch.zeros_like(out_mask)
        agg_exec = P.HashAggregateExec(self.groupings, self.aggregates,
                                       self.child)
        return agg_exec._finalize(out_keys, agg_tvs, out_mask,
                                  max(1, num_segments))

    def node_string(self):
        return (f"PSumAgg[keys=[{', '.join(map(str, self.groupings))}], "
                f"out=[{', '.join(str(e) for e in self.aggregates)}]]")

    def _key(self):
        return ("PSumAgg", tuple(E.expr_key(g) for g in self.groupings),
                tuple(E.expr_key(a) for a in self.aggregates),
                self.child.plan_key())


@dataclass(eq=False)
class DistSortAggExec(P.PhysicalPlan):
    """Group-by after a hash exchange: each rank holds whole groups,
    sorts locally and numbers groups by change flags, as the reference.
    ``phase="partial"`` marks the pre-exchange half of a partial/final
    pair."""

    groupings: Tuple[E.Expression, ...]
    aggregates: Tuple[E.Expression, ...]
    child: P.PhysicalPlan
    phase: Optional[str] = None

    def children(self):
        return (self.child,)

    @functools.cached_property
    def schema(self) -> Schema:
        return P.HashAggregateExec(self.groupings, self.aggregates,
                                   self.child).schema

    def execute(self, child_pipes: List[Pipe]) -> Pipe:
        pipe = child_pipes[0]
        cap = pipe.capacity
        key_tvs = [C.evaluate(g, pipe.env()) for g in self.groupings]
        spipe, sorted_keys, seg, ng = P.sorted_groups(pipe, key_tvs)
        # the segment count is the largest rank's group count (one host
        # sync; the reference, static-shaped, takes the row capacity):
        # every rank's output has the same capacity, and a float sum's
        # seg_fsum scratch grows with the groups, not the rows
        groups = int(X.pmax(ng.reshape(1).to(torch.int64))[0])
        X.note_host_read()
        k = K.bucket(max(1, groups), 256)
        env2 = spipe.env()
        _, agg_calls = rewrite_agg_outputs(self.groupings, self.aggregates)
        agg_tvs = [P._compute_agg(a, env2, seg, spipe.mask, k, cap,
                                  sorted_seg=True) for a in agg_calls]
        out_keys = P.first_group_keys(sorted_keys, seg, spipe.mask, k, cap,
                                      sorted_seg=True)
        out_mask = torch.arange(k, device=seg.device) < ng
        agg_exec = P.HashAggregateExec(self.groupings, self.aggregates,
                                       self.child)
        return agg_exec._finalize(out_keys, agg_tvs, out_mask, k)

    def node_string(self):
        return (f"DistSortAgg[keys=[{', '.join(map(str, self.groupings))}], "
                f"out=[{', '.join(str(e) for e in self.aggregates)}]]")

    def _key(self):
        return ("DistSortAgg", tuple(E.expr_key(g) for g in self.groupings),
                tuple(E.expr_key(a) for a in self.aggregates),
                self.phase, self.child.plan_key())


@dataclass(eq=False)
class DistRangeAggExec(DistSortAggExec):
    """The sort-based aggregation rung's final: DistSortAggExec over a
    range exchange on the group keys, so its output is key-ordered
    across the mesh (a distinct node for plan keys and EXPLAIN)."""

    def node_string(self):
        return (f"DistRangeAgg[keys=[{', '.join(map(str, self.groupings))}],"
                f" out=[{', '.join(str(e) for e in self.aggregates)}]]")

    def _key(self):
        return ("DistRangeAgg",) + super()._key()[1:]


# ---- fused spans ------------------------------------------------------------


def capacity_ladder(bucket: int, variants: int, worst: int,
                    devices: int = 1) -> Tuple[int, ...]:
    """The capacity rungs of one fused span, anchored at the balanced
    receive load: a well-spread exchange over ``devices`` destinations
    delivers about worst/devices rows to the hottest, so the top working
    rung is ceil(worst/devices) rounded up to ``bucket`` plus one bucket
    of headroom; below it the rungs shrink by 4 (bucket-rounded, the same
    headroom); the worst case (every live row to one destination) is
    always the last rung, so any measured incoming count is covered. The
    reference's ladder (spark_tpu/parallel/operators.py:783), rung for
    rung."""
    bucket = max(1, int(bucket))
    variants = max(1, int(variants))
    worst = max(1, int(worst))
    d = max(1, int(devices))
    anchor = -(-worst // d)                            # balanced load
    anchor = -(-anchor // bucket) * bucket + bucket    # round up + headroom
    rungs: List[int] = [worst]
    c = min(anchor, worst)
    while len(rungs) < variants and c < rungs[-1]:
        rungs.append(c)
        nxt = -(-c // 4)                               # ceil(c / 4)
        nxt = -(-nxt // bucket) * bucket + bucket
        if nxt >= c:
            break
        c = nxt
    return tuple(reversed(rungs))


def _slice_pipe(pipe: Pipe, capacity: int) -> Pipe:
    """A pipe's first ``capacity`` slots (live rows past the cut are lost:
    the caller detects that and re-runs; see FusedSpanExec)."""
    cols = {name: TV(tv.data[:capacity],
                     None if tv.validity is None else tv.validity[:capacity],
                     tv.dtype, tv.dictionary,
                     None if tv.lengths is None else tv.lengths[:capacity])
            for name, tv in pipe.cols.items()}
    return Pipe(cols, pipe.mask[:capacity], pipe.order)


def _pad_pipe(pipe: Pipe, capacity: int) -> Pipe:
    """A pipe grown to ``capacity`` slots with dead rows (mask False)."""
    n = int(capacity) - pipe.capacity
    if n <= 0:
        return pipe

    def grow(x: torch.Tensor) -> torch.Tensor:
        return torch.cat([x, x.new_zeros((n,) + tuple(x.shape[1:]))])

    cols = {name: TV(grow(tv.data),
                     None if tv.validity is None else grow(tv.validity),
                     tv.dtype, tv.dictionary,
                     None if tv.lengths is None else grow(tv.lengths))
            for name, tv in pipe.cols.items()}
    return Pipe(cols, grow(pipe.mask), pipe.order)


@dataclass(eq=False)
class FusedSpanExec(P.PhysicalPlan):
    """An adaptive exchange and its consumer in one rank stage (the
    reference's fusion building block, spark_tpu/parallel/operators.py:822).

    Staged, an adaptive exchange takes a producer stage, a stats stage
    (``ExchangeStatsExec``) and its host read, the exchange stage at the
    measured capacities and the consumer's stage. The reference fuses
    them into one XLA program whose ``lax.switch`` over the capacity
    ladder picks the rung on the device. The port's ranks run eagerly,
    and its exchange already reads the all-gathered count matrix on the
    host to size its send slice: here the rung is taken from that same
    read (the first rung of ``capacity_ladder`` that covers the largest
    incoming count), the exchange compacts its received rows to it, and
    the consumer and ``tail`` run on in the same stage, with no stats
    stage and no stage boundary.

    Byte identity with the staged path: the exchange's live rows and
    their order do not depend on its capacities (stable routing, stable
    compaction), and the consumers a span takes (SortExec,
    DistSortAggExec) and the interstitials (Project, Filter) depend only
    on live rows and their order.

    ``tail``: downstream operators run inside this span, in dataflow
    order: row-preserving interstitials and further FusedSpanExec pairs
    (a chain of pairs is one span). ``speculate`` (the plan's root only):
    the output is cut to the ladder's anchor rung plus an eighth, in
    bucket multiples, and one sentinel slot whose mask bit says that live
    rows were cut off; the executor reads it and re-runs the staged path
    (a typed ``overflow`` bailout). A span that is not the root returns
    its consumer's output as it is (eager ranks need no common shape
    across rungs)."""

    consumer: P.PhysicalPlan
    exchange: P.PhysicalPlan
    bucket: int
    variants: int
    tail: Tuple[P.PhysicalPlan, ...] = ()
    speculate: bool = False

    def children(self):
        return self.exchange.children()

    @functools.cached_property
    def schema(self) -> Schema:
        return self.tail[-1].schema if self.tail else self.consumer.schema

    def execute(self, child_pipes: List[Pipe]) -> Pipe:
        pipe = child_pipes[0]
        d = X.axis_size()
        f_out = None
        if self.speculate:
            worst0 = d * pipe.capacity
            ladder0 = capacity_ladder(self.bucket, self.variants, worst0, d)
            if len(ladder0) > 1:  # else the output keeps its capacity
                b = max(1, int(self.bucket))
                f_out = min(worst0, -(-(ladder0[-2] * 9 // 8) // b) * b)

        def run_ops(p: Pipe, ops) -> Pipe:
            for i, op in enumerate(ops):
                if isinstance(op, FusedSpanExec):
                    return pair(p, op, ops[i + 1:])
                p = op.execute_blocking([p])
            return p

        def pair(p: Pipe, span: "FusedSpanExec", rest) -> Pipe:
            ladder = capacity_ladder(span.bucket, span.variants,
                                     d * p.capacity, d)

            def rung(incoming) -> int:
                most = max(incoming)
                return next((c for c in ladder if c >= most), ladder[-1])

            sub = X.exchange(p, span.exchange._target(p, d),
                             span.exchange.op, None, rung)
            return run_ops(span.consumer.execute_blocking([sub]), rest)

        out = pair(pipe, self, tuple(self.tail))
        if f_out is None:
            return out
        over = out.mask[f_out:].any() if out.capacity > f_out \
            else torch.zeros((), dtype=torch.bool, device=out.mask.device)
        out = _pad_pipe(_slice_pipe(out, f_out), f_out + 1)
        mask = out.mask.clone()
        mask[f_out] = over
        return Pipe(out.cols, mask, out.order)

    def node_string(self):
        chain = "".join(" -> " + (t.consumer.node_string()
                                  if isinstance(t, FusedSpanExec)
                                  else t.node_string())
                        for t in self.tail)
        return (f"FusedSpan[bucket={self.bucket}, "
                f"variants={self.variants}, "
                f"consumer={self.consumer.node_string()}{chain}]")

    def _key(self):
        return ("FusedSpan", self.bucket, self.variants, self.speculate,
                self.consumer.plan_key(), self.exchange.plan_key(),
                tuple(t.plan_key() for t in self.tail))


@dataclass(eq=False)
class DistHashPartialAggExec(P.PhysicalPlan):
    """Partial aggregation over a measured key domain: each key's global
    [min, max] (and whether NULLs occur) range-compresses it into a
    collision-free packed code, so the partials are dense segment
    reductions over the domain, with no sort and no host sync (on the
    card the hand kernels where 64 < K <= 1024). The output is the sort
    partial's (key aliases, then partial accumulators), so the exchange
    and the final merge that follow do not depend on the strategy; only
    the row order and the capacity differ. Each rank keeps its own
    groups (no merge here). The executor's adaptive aggregation plans it
    from the measured key domain (the ``hash`` strategy)."""

    groupings: Tuple[E.Expression, ...]
    aggregates: Tuple[E.Expression, ...]
    child: P.PhysicalPlan
    key_mins: Tuple[int, ...] = ()    # measured per-key global min
    key_ranges: Tuple[int, ...] = ()  # measured value range (max-min+1)

    def children(self):
        return (self.child,)

    @functools.cached_property
    def schema(self) -> Schema:
        return P.HashAggregateExec(self.groupings, self.aggregates,
                                   self.child).schema

    def execute(self, child_pipes: List[Pipe]) -> Pipe:
        pipe = child_pipes[0]
        env = pipe.env()
        dev = pipe.mask.device
        key_tvs = [C.evaluate(g, env) for g in self.groupings]
        # the measured range makes the clamp a no-op on every live row;
        # pack_codes adds each nullable key's NULL slot
        codes = [(tv.data.to(torch.int64) - mn).clamp(0, rg - 1)
                 for tv, mn, rg in zip(key_tvs, self.key_mins,
                                       self.key_ranges)]
        validities = [tv.validity for tv in key_tvs]
        cards = [int(rg) for rg in self.key_ranges]
        seg, k = K.pack_codes(codes, validities, cards)
        seg, k = seg.to(torch.int32), max(1, int(k))
        _, agg_calls = rewrite_agg_outputs(self.groupings, self.aggregates)
        agg_tvs = [P._compute_agg(a, env, seg, pipe.mask, k, pipe.capacity)
                   for a in agg_calls]
        out_mask = K.seg_count(seg, pipe.mask, k) > 0
        nullable = [v is not None for v in validities]
        unpacked = K.unpack_code(torch.arange(k, device=dev), cards,
                                 nullable)
        out_keys = [TV((code + mn).to(C._torch_dtype(tv.dtype)), valid,
                       tv.dtype, tv.dictionary)
                    for (code, valid), tv, mn in zip(unpacked, key_tvs,
                                                     self.key_mins)]
        agg_exec = P.HashAggregateExec(self.groupings, self.aggregates,
                                       self.child)
        return agg_exec._finalize(out_keys, agg_tvs, out_mask, k)

    def node_string(self):
        return (f"DistHashPartialAgg[keys="
                f"[{', '.join(map(str, self.groupings))}], "
                f"domain={tuple(self.key_ranges)}]")

    def _key(self):
        return ("DistHashPartialAgg",
                tuple(E.expr_key(g) for g in self.groupings),
                tuple(E.expr_key(a) for a in self.aggregates),
                self.key_mins, self.key_ranges, self.child.plan_key())


# ---- distributed join -------------------------------------------------------


def join_output_schema(left: Schema, right: Schema, how: str) -> Schema:
    return join_schema(how, left, right)


def packed_join_keys(lpipe: Pipe, rpipe: Pipe,
                     left_keys: Tuple[E.Expression, ...],
                     right_keys: Tuple[E.Expression, ...], mins, ranges):
    """Equi-join keys packed into one int64 per row by host-supplied
    per-key (min, range) stats (collision-free); strings through a
    unified dictionary. ``mins is None`` hash-combines instead, and the
    caller verifies candidate pairs by exact key equality. Returns
    (lkey, lvalid, rkey, rvalid, per-key (left, right) data)."""
    hashed = mins is None
    lenv, renv = lpipe.env(), rpipe.env()
    lks = [P._scalar_column(C.evaluate(k, lenv), "join key")
           for k in left_keys]
    rks = [P._scalar_column(C.evaluate(k, renv), "join key")
           for k in right_keys]
    dev = lpipe.mask.device
    lcomb = torch.zeros((lpipe.capacity,), dtype=torch.int64, device=dev)
    rcomb = torch.zeros((rpipe.capacity,), dtype=torch.int64, device=dev)
    lvalid = torch.ones((lpipe.capacity,), dtype=torch.bool, device=dev)
    rvalid = torch.ones((rpipe.capacity,), dtype=torch.bool, device=dev)
    prepped = []
    for ki, (lt, rt) in enumerate(zip(lks, rks)):
        if isinstance(lt.dtype, T.StringType) \
                or isinstance(rt.dtype, T.StringType):
            _, (tl, tr) = C.unify_dictionaries(
                (lt.dictionary or (), rt.dictionary or ()))
            ld = (C._gather(tl, lt.data) if len(lt.dictionary or ())
                  else lt.data.to(torch.int64))
            rd = (C._gather(tr, rt.data) if len(rt.dictionary or ())
                  else rt.data.to(torch.int64))
        else:
            ld = K.key_int64(lt.data)
            rd = K.key_int64(rt.data)
        prepped.append((ld, rd))
        if not hashed:
            mn, rg = mins[ki], ranges[ki]
            lcomb = lcomb * rg + (ld - mn).clamp(0, rg - 1)
            rcomb = rcomb * rg + (rd - mn).clamp(0, rg - 1)
        if lt.validity is not None:
            lvalid = lvalid & lt.validity
        if rt.validity is not None:
            rvalid = rvalid & rt.validity
    if hashed:
        lcomb, rcomb = P._hash_keys([p[0] for p in prepped],
                                    [p[1] for p in prepped])
    return lcomb, lvalid, rcomb, rvalid, prepped


@dataclass(eq=False)
class TopKeyExec(P.PhysicalPlan):
    """The most frequent key tuple of the rank's shard with its local
    count (one row per rank): the hot-key probe of the skew split
    (reference: OptimizeSkewedJoin.scala:37 detects by partition size;
    here the hot key value)."""

    keys: Tuple[E.Expression, ...]
    child: P.PhysicalPlan

    def children(self):
        return (self.child,)

    @functools.cached_property
    def schema(self) -> Schema:
        cs = self.child.schema
        fields = []
        for i, k in enumerate(self.keys):
            inner = E.strip_alias(k)
            dictionary = None
            if isinstance(inner, E.Col) and inner.col_name in cs:
                dictionary = cs.field(inner.col_name).dictionary
            fields.append(Field(f"__hk{i}", k.data_type(cs), True,
                                dictionary))
        fields.append(Field("__cnt", T.INT64, nullable=False))
        return Schema(tuple(fields))

    def execute(self, child_pipes: List[Pipe]) -> Pipe:
        pipe = child_pipes[0]
        cap = pipe.capacity
        key_tvs = [C.evaluate(k, pipe.env()) for k in self.keys]
        spipe, sorted_keys, seg, _ = P.sorted_groups(pipe, key_tvs)
        cnt = K.seg_count(seg, spipe.mask, cap, sorted_seg=True)
        best = torch.argmax(cnt).reshape(1)
        reps = P.first_group_keys(sorted_keys, seg, spipe.mask, cap, cap,
                                  sorted_seg=True)
        cols: Dict[str, TV] = {}
        for i, tv in enumerate(reps):
            cols[f"__hk{i}"] = TV(tv.data[best],
                                  None if tv.validity is None
                                  else tv.validity[best],
                                  tv.dtype, tv.dictionary)
        cols["__cnt"] = TV(cnt[best].to(torch.int64), None, T.INT64, None)
        return Pipe(cols, torch.ones((1,), dtype=torch.bool,
                                     device=cnt.device), list(cols))

    def node_string(self):
        return f"TopKey[{', '.join(map(str, self.keys))}]"

    def _key(self):
        return ("TopKey", tuple(E.expr_key(k) for k in self.keys),
                self.child.plan_key())


@dataclass(eq=False)
class JoinCountExec(P.PhysicalPlan):
    """Stats pass: the rank's equi-join match count (sizes
    JoinApplyExec's pair capacity). One int64 per rank."""

    left: P.PhysicalPlan
    right: P.PhysicalPlan
    left_keys: Tuple[E.Expression, ...]
    right_keys: Tuple[E.Expression, ...]
    mins: Optional[Tuple[int, ...]]
    ranges: Optional[Tuple[int, ...]]
    broadcast: bool

    def children(self):
        return (self.left, self.right)

    @functools.cached_property
    def schema(self) -> Schema:
        return Schema((Field("cnt", T.INT64, nullable=False),))

    def execute(self, child_pipes: List[Pipe]) -> Pipe:
        lpipe, rpipe = child_pipes
        if self.broadcast:
            rpipe = X.broadcast_gather(rpipe)
        lkey, lvalid, rkey, rvalid, _ = packed_join_keys(
            lpipe, rpipe, self.left_keys, self.right_keys, self.mins,
            self.ranges)
        rng = K.build_join_ranges(rkey, rpipe.mask & rvalid, lkey,
                                  lpipe.mask & lvalid)
        lok = lpipe.mask & lvalid
        cnt = torch.where(lok, rng.counts, torch.zeros_like(rng.counts)) \
            .sum(dtype=torch.int64)
        return Pipe({"cnt": TV(cnt.reshape(1), None, T.INT64, None)},
                    torch.ones((1,), dtype=torch.bool, device=cnt.device),
                    ["cnt"])

    def _key(self):
        return ("JoinCount", tuple(E.expr_key(k) for k in self.left_keys),
                tuple(E.expr_key(k) for k in self.right_keys),
                self.mins, self.ranges, self.broadcast,
                self.left.plan_key(), self.right.plan_key())


@dataclass(eq=False)
class JoinApplyExec(P.PhysicalPlan):
    """The rank's equi-join at a host-sized pair capacity: after a hash
    exchange both sides of a key are on one rank, so the single-device
    sorted-build ranges and pair expansion give the shuffled hash join
    (ShuffledHashJoinExec.scala:38); with ``broadcast`` the build side
    is gathered on every rank (BroadcastHashJoinExec.scala:40)."""

    left: P.PhysicalPlan
    right: P.PhysicalPlan
    how: str
    left_keys: Tuple[E.Expression, ...]
    right_keys: Tuple[E.Expression, ...]
    condition: Optional[E.Expression]
    mins: Optional[Tuple[int, ...]]
    ranges: Optional[Tuple[int, ...]]
    pair_capacity: int
    broadcast: bool

    def children(self):
        return (self.left, self.right)

    @functools.cached_property
    def schema(self) -> Schema:
        return join_output_schema(self.left.schema, self.right.schema,
                                  self.how)

    def execute(self, child_pipes: List[Pipe]) -> Pipe:
        lpipe, rpipe = child_pipes
        how = self.how
        if self.broadcast:
            rpipe = X.broadcast_gather(rpipe)
        if how == "cross":
            return self._cross(lpipe, rpipe)
        lkey, lvalid, rkey, rvalid, prepped = packed_join_keys(
            lpipe, rpipe, self.left_keys, self.right_keys, self.mins,
            self.ranges)
        hashed = self.mins is None
        ranges = K.build_join_ranges(rkey, rpipe.mask & rvalid, lkey,
                                     lpipe.mask & lvalid)
        if how in ("left_semi", "left_anti") and self.condition is None \
                and not hashed:
            has_match = ranges.counts > 0
            keep = lpipe.mask & (has_match if how == "left_semi"
                                 else ~has_match)
            return Pipe(lpipe.cols, keep, lpipe.order)

        cap = self.pair_capacity
        p_idx, b_idx, pair_ok = K.expand_join_pairs(ranges, cap)
        if hashed:
            pair_ok = pair_ok & P._verify_key_pairs(prepped, p_idx, b_idx,
                                                    cap)
        # the pair environment carries both sides, so a semi/anti
        # condition can read the inner relation
        cols, order = P._gather_pairs(lpipe, rpipe, p_idx, b_idx)
        if self.condition is not None:
            ctv = C.evaluate(self.condition,
                             Env(cols, cap, device=pair_ok.device))
            pair_ok = pair_ok & ctv.data & ctv.valid_or_true(cap)
        if how == "inner":
            return Pipe(cols, pair_ok, order)

        matched = K.seg_count(p_idx, pair_ok, lpipe.capacity) > 0
        if how == "left_semi":
            return Pipe(lpipe.cols, lpipe.mask & matched, lpipe.order)
        if how == "left_anti":
            return Pipe(lpipe.cols, lpipe.mask & ~matched, lpipe.order)
        matched_b = (K.seg_count(b_idx, pair_ok, rpipe.capacity) > 0
                     if how in ("right", "full") else None)
        if how in ("left", "full"):
            cols, pair_ok = P.append_unmatched_left(cols, pair_ok, order,
                                                    lpipe, matched)
        if how in ("right", "full"):
            if self.broadcast:
                raise AssertionError(
                    "right/full outer join must not broadcast the build side")
            cols, pair_ok = P.append_unmatched_right(cols, pair_ok, order,
                                                     lpipe, rpipe, matched_b)
        return Pipe(cols, pair_ok, order)

    def _cross(self, lpipe: Pipe, rpipe: Pipe) -> Pipe:
        """pair_capacity = the rank's left capacity times the live right
        rows of the whole mesh (host-computed)."""
        cap = self.pair_capacity
        dev = lpipe.mask.device
        rn = max(1, cap // max(1, lpipe.capacity))
        j = torch.arange(cap, device=dev)
        p_idx = torch.div(j, rn, rounding_mode="floor") \
            .clamp(0, lpipe.capacity - 1)
        rperm = K.compaction_permutation(rpipe.mask)
        b_idx = rperm[(j % rn).clamp(0, rpipe.capacity - 1)]
        live_r = rpipe.mask.to(torch.int64).sum()
        pair_mask = lpipe.mask[p_idx] & ((j % rn) < live_r)
        cols, order = P._gather_pairs(lpipe, rpipe, p_idx, b_idx)
        if self.condition is not None:
            ctv = C.evaluate(self.condition, Env(cols, cap, device=dev))
            pair_mask = pair_mask & ctv.data & ctv.valid_or_true(cap)
        return Pipe(cols, pair_mask, order)

    def node_string(self):
        ks = ", ".join(f"{l}={r}" for l, r in zip(self.left_keys,
                                                  self.right_keys))
        tag = "broadcast" if self.broadcast else "partitioned"
        return f"DistJoin[{self.how}, {tag}, ({ks}), cond={self.condition}]"

    def _key(self):
        return ("JoinApply", self.how,
                tuple(E.expr_key(k) for k in self.left_keys),
                tuple(E.expr_key(k) for k in self.right_keys),
                None if self.condition is None else E.expr_key(self.condition),
                self.mins, self.ranges, self.pair_capacity, self.broadcast,
                self.left.plan_key(), self.right.plan_key())


@dataclass(eq=False)
class DistJoinBoundary(P.PhysicalPlan):
    """Planner marker: a join the executor lowers into exchange, stats,
    count and apply stages. A stage boundary, where the reference's
    DAGScheduler cuts stages (DAGScheduler.scala:1355)."""

    left: P.PhysicalPlan
    right: P.PhysicalPlan
    how: str
    left_keys: Tuple[E.Expression, ...]
    right_keys: Tuple[E.Expression, ...]
    condition: Optional[E.Expression]
    traceable = False

    def children(self):
        return (self.left, self.right)

    @functools.cached_property
    def schema(self) -> Schema:
        return join_output_schema(self.left.schema, self.right.schema,
                                  self.how)

    def node_string(self):
        return f"JoinBoundary[{self.how}]"

    def _key(self):
        return ("JoinBoundary", self.how,
                tuple(E.expr_key(k) for k in self.left_keys),
                tuple(E.expr_key(k) for k in self.right_keys),
                None if self.condition is None else E.expr_key(self.condition),
                self.left.plan_key(), self.right.plan_key())
