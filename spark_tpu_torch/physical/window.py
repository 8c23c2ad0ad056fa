"""Window function execution over torch tensors (reference:
``spark_tpu/physical/window.py``; Spark's
sql/core/.../execution/window/WindowExec.scala:87 and
WindowFunctionFrame.scala).

Spark streams each partition through per-frame processors row by row.
Here, as in the reference, each distinct (partition, order) spec costs
one sort of the rows; segment, peer and frame geometry come from scans
and binary searches over the sorted order, every window column is
prefix-sum / gather arithmetic over it, and the results are scattered
back to the input row order. Output capacity equals input capacity and
no step reads a value back to the host.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from spark_tpu_torch import types as T
from spark_tpu_torch.expr import compiler as C
from spark_tpu_torch.expr import expressions as E
from spark_tpu_torch.expr.compiler import TV, Env
from spark_tpu_torch.physical import kernels as K
from spark_tpu_torch.physical.operators import (PhysicalPlan, Pipe,
                                                decimal_avg)
from spark_tpu_torch.plan.logical import window_schema
from spark_tpu_torch.types import Schema

#: a bounded (sliding) min/max frame builds a sparse table of
#: log2(capacity) levels; larger batches are refused, as in the reference
SPARSE_TABLE_MAX_ROWS = 1 << 22


def _scalar(tv: TV, what: str) -> TV:
    """``tv`` when it holds one value a row: an array or map column
    cannot partition, order or feed a window function, as in the
    reference (an array may pass through a window query unchanged)."""
    if tv.data.dim() != 1:
        raise NotImplementedError(
            f"{what}: an array or map column ({tv.dtype}) in a window "
            "is not supported")
    return tv


def _floor_log2(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) of int64 ``x >= 1``, exactly (63 - clz(x)): a
    binary search over the bit positions in integer shifts."""
    k = torch.zeros_like(x)
    for s in (32, 16, 8, 4, 2, 1):
        big = (x >> s) > 0
        x = torch.where(big, x >> s, x)
        k = k + big.to(torch.int64) * s
    return k


class _Geometry(NamedTuple):
    """Per-row geometry of one spec group, in sorted coordinates."""

    perm: torch.Tensor       # the sort permutation
    live: torch.Tensor       # row mask, sorted
    pos: torch.Tensor        # 0 .. cap - 1
    seg: torch.Tensor        # partition ids (monotone)
    seg_start: torch.Tensor  # each row's partition start and end
    seg_end: torch.Tensor
    head: torch.Tensor       # first row of a peer group
    peer_last: torch.Tensor  # last row of each row's peer group
    cap: int

    @property
    def rn0(self) -> torch.Tensor:
        """0-based row number within the partition."""
        return self.pos - self.seg_start


@dataclass(eq=False)
class WindowExec(PhysicalPlan):
    """Compute every window column of the child: one sort per distinct
    (partition_by, order_by) spec."""

    window_exprs: Tuple[E.Alias, ...]
    child: PhysicalPlan

    def children(self):
        return (self.child,)

    @functools.cached_property
    def schema(self) -> Schema:
        return window_schema(self.window_exprs, self.child.schema)

    def execute(self, child_pipes: List[Pipe]) -> Pipe:
        pipe = child_pipes[0]
        out_cols = dict(pipe.cols)
        out_order = list(pipe.order)
        groups: Dict[tuple, List[E.Alias]] = {}
        for alias in self.window_exprs:
            w = E.strip_alias(alias)
            key = (tuple(E.expr_key(p) for p in w.partition_by),
                   tuple(E.expr_key(o) for o in w.order_by))
            groups.setdefault(key, []).append(alias)
        env = pipe.env()
        cs = self.child.schema
        for aliases in groups.values():
            g = self._geometry(pipe, env, E.strip_alias(aliases[0]))
            for alias in aliases:
                w = E.strip_alias(alias)
                data, validity, dictionary = self._eval_func(w, env, g, cs)
                # scatter back to the input row order
                odata = torch.empty_like(data)
                odata[g.perm] = data
                ovalid = None
                if validity is not None:
                    ovalid = torch.empty_like(validity)
                    ovalid[g.perm] = validity
                out_cols[alias.name] = TV(odata, ovalid, w.data_type(cs),
                                          dictionary)
                out_order.append(alias.name)
        return Pipe(out_cols, pipe.mask, out_order)

    # -- one (partition, order) spec group ------------------------------------

    @staticmethod
    def _geometry(pipe: Pipe, env: Env, spec: E.WindowExpr) -> _Geometry:
        cap = pipe.capacity
        dev = pipe.mask.device
        part_tvs = [_scalar(C.evaluate(p, env), "PARTITION BY")
                    for p in spec.partition_by]
        order_tvs = [(_scalar(C.evaluate(o.child, env), "window ORDER BY"),
                      o) for o in spec.order_by]
        sort_keys = [K.SortKey(tv.data, tv.validity, True, True)
                     for tv in part_tvs]
        sort_keys += [K.SortKey(tv.data, tv.validity, o.ascending,
                                o.nulls_first_resolved)
                      for tv, o in order_tvs]
        perm = (K.lexsort_permutation(sort_keys, pipe.mask) if sort_keys
                else K.compaction_permutation(pipe.mask))
        live = pipe.mask[perm]
        pos = torch.arange(cap, dtype=torch.int64, device=dev)

        if part_tvs:
            seg, _ = K.group_ids_from_sorted(
                [(tv.data[perm],
                  None if tv.validity is None else tv.validity[perm])
                 for tv in part_tvs], live)
        else:
            # one partition; dead rows (sorted to the back) get a segment
            # of their own so they never reach live geometry
            seg = (~live).to(torch.int32)
        seg = seg.to(torch.int32)
        # seg is monotone in sorted order: bounds by binary search
        seg_start = K.searchsorted(seg, seg, side="left")
        seg_end = K.searchsorted(seg, seg, side="right") - 1
        # dead rows sort to the back: the trailing live segment ends at
        # the last live row
        last_live = (live.sum() - 1).clamp(min=0)
        seg_end = torch.minimum(seg_end, last_live)

        first = torch.ones((1,), dtype=torch.bool, device=dev)
        part_change = torch.cat([first, seg[1:] != seg[:-1]])
        if order_tvs:
            # peers: rows equal on every order key (and partition)
            head = part_change
            for tv, _ in order_tvs:
                data = tv.data[perm]
                if data.is_floating_point():
                    # all NaNs are mutual peers (they sort together)
                    data = torch.where(torch.isnan(data),
                                       torch.finfo(data.dtype).max, data)
                neq = torch.cat([first, data[1:] != data[:-1]])
                if tv.validity is not None:
                    v = tv.validity[perm]
                    vneq = torch.cat([first, v[1:] != v[:-1]])
                    both_null = torch.cat([~first, ~v[1:] & ~v[:-1]])
                    neq = (neq & ~both_null) | vneq
                head = head | neq
        else:
            head = part_change
        peer_id = torch.cumsum(head.to(torch.int32), 0, dtype=torch.int32) - 1
        peer_last = torch.minimum(
            K.searchsorted(peer_id, peer_id, side="right") - 1, last_live)

        return _Geometry(perm, live, pos, seg, seg_start, seg_end, head,
                         peer_last, cap)

    # -- individual functions (sorted coordinates) ----------------------------

    def _eval_func(self, w: E.WindowExpr, env: Env, g: _Geometry, cs
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                              Optional[tuple]]:
        fn = w.func
        if isinstance(fn, E.RowNumber):
            return (g.rn0 + 1).to(torch.int32), None, None
        if isinstance(fn, E.Rank):
            if fn.dense:
                ch = torch.cumsum(g.head.to(torch.int64), 0)
                dense = ch - ch[g.seg_start.clamp(0, g.cap - 1)] + 1
                return dense.to(torch.int32), None, None
            hp = torch.where(g.head, g.pos, torch.zeros_like(g.pos))
            run = K.seg_scan(g.seg, hp, torch.maximum)
            return (run - g.seg_start + 1).to(torch.int32), None, None
        if isinstance(fn, E.NTile):
            cnt = g.seg_end - g.seg_start + 1
            tile = torch.div(g.rn0 * fn.n, cnt.clamp(min=1),
                             rounding_mode="floor") + 1
            return tile.to(torch.int32), None, None
        if isinstance(fn, E.LagLead):
            return self._lag_lead(fn, env, g)
        if isinstance(fn, E.AggregateExpression):
            return self._framed_agg(w, fn, env, g, cs)
        raise NotImplementedError(f"window function {fn} is not ported yet")

    @staticmethod
    def _lag_lead(fn: E.LagLead, env: Env, g: _Geometry):
        tv = _scalar(C.evaluate(fn.child, env), "lag/lead")
        sdata = tv.data[g.perm]
        src = g.pos + (fn.offset if fn.lead else -fn.offset)
        in_part = (src >= g.seg_start) & (src <= g.seg_end)
        srcc = src.clamp(0, g.cap - 1)
        data = sdata[srcc]
        valid = in_part
        if tv.validity is not None:
            valid = valid & tv.validity[g.perm][srcc]
        dictionary = tv.dictionary
        if fn.default is not None:
            dtv = C.evaluate(fn.default, env)
            if isinstance(tv.dtype, T.StringType):
                # re-code both into one dictionary
                dictionary, (ta, tb) = C.unify_dictionaries(
                    (tv.dictionary or (), dtv.dictionary or ()))
                data = C._gather(ta, data) if len(ta) else data
                dval = C._gather(tb, dtv.data) if len(tb) else dtv.data
            else:
                dval = C._cast_data(dtv.data, dtv.dtype, tv.dtype)
            # the default is a constant: its first row
            data = torch.where(in_part, data, dval[0].to(data.dtype))
            # the default can itself be NULL (lag(v, 1, NULL))
            valid = valid | (~in_part & dtv.valid_or_true(g.cap)[0])
        return data, valid, dictionary

    @staticmethod
    def _frame_bounds(w: E.WindowExpr, env: Env, g: _Geometry):
        """Per-row inclusive [lo, hi] frame positions in sorted order."""
        frame = w.frame
        if frame is None:
            if w.order_by:
                # SQL default: RANGE UNBOUNDED PRECEDING .. CURRENT ROW,
                # the current row's peers included
                return g.seg_start, g.peer_last
            return g.seg_start, g.seg_end
        mode, start, end = frame
        if mode == "rows":
            lo = g.seg_start if start is None else torch.maximum(
                g.seg_start, g.pos + start)
            hi = g.seg_end if end is None else torch.minimum(
                g.seg_end, g.pos + end)
            return lo, hi
        # RANGE: unbounded and current-row bounds need no key values
        lo = g.seg_start if start is None else None
        hi = g.peer_last if end == 0 else (g.seg_end if end is None
                                           else None)
        if lo is not None and hi is not None:
            return lo, hi
        # value offsets: a per-row binary search over the ORDER key
        # within each partition's sorted run (reference:
        # window/WindowExec.scala RangeBoundOrdering)
        if len(w.order_by) != 1:
            raise NotImplementedError(
                "RANGE frames with value offsets require exactly one "
                "ORDER BY key (the reference has the same restriction)")
        so = w.order_by[0]
        tv = C.evaluate(so.child, env)
        if isinstance(tv.dtype, T.StringType):
            raise NotImplementedError(
                "RANGE value offsets need a numeric/date ORDER key")
        scale = (10 ** tv.dtype.scale
                 if isinstance(tv.dtype, T.DecimalType) else 1)
        key = tv.data[g.perm]
        nan_mask = None
        if not key.is_floating_point():
            # exact integers: a float cast would merge int64 and decimal
            # keys above 2^53
            key = key.to(torch.int64)
            off_lo = None if start is None else int(round(start * scale))
            off_hi = None if end is None else int(round(end * scale))
            neg_inf, pos_inf = K.INT64_MIN, K.INT64_MAX
        else:
            key = key.to(torch.float64)
            off_lo = None if start is None else float(start) * scale
            off_hi = None if end is None else float(end) * scale
            neg_inf, pos_inf = float("-inf"), float("inf")
            # NaN sorts greatest but is a peer group apart from NULLs:
            # the largest finite float keeps it inside the null sentinels
            nan_mask = torch.isnan(key)
            key = torch.where(nan_mask, torch.finfo(torch.float64).max, key)
        if not so.ascending:
            key = -key  # DESC: PRECEDING means larger values
        if tv.validity is not None:
            # null keys are mutual peers; the sentinel's sign follows
            # where the sort placed them, so the run stays monotone
            sval = tv.validity[g.perm]
            sent = neg_inf if so.nulls_first_resolved else pos_inf
            key = torch.where(sval, key, torch.full((), sent,
                                                    dtype=key.dtype,
                                                    device=key.device))

        def target(off):
            # sentinel rows keep their sentinel (an int64 sentinel plus
            # an offset would wrap); a NaN row's frame is its NaN peers
            fixed = (key == neg_inf) | (key == pos_inf)
            if nan_mask is not None:
                fixed = fixed | nan_mask
            return torch.where(fixed, key, key + off)

        if lo is None:
            lo = _bounded_search(key, target(off_lo), g.seg_start,
                                 g.seg_end, g.cap, side="left")
        if hi is None:
            hi = _bounded_search(key, target(off_hi), g.seg_start,
                                 g.seg_end, g.cap, side="right") - 1
        return lo, hi

    def _framed_agg(self, w: E.WindowExpr, fn, env: Env, g: _Geometry, cs):
        lo, hi = self._frame_bounds(w, env, g)
        cap = g.cap
        child = getattr(fn, "child", None)
        if child is not None:
            tv = _scalar(C.evaluate(child, env), "window aggregate")
            sdata = tv.data[g.perm]
            ok = g.live & tv.valid_or_true(cap)[g.perm]
        else:  # COUNT(*)
            sdata = torch.ones((cap,), dtype=torch.int64, device=lo.device)
            ok = g.live
        hic = hi.clamp(0, cap - 1)
        empty = hi < lo

        def prefix_diff(x):
            """[lo, hi] sums as differences of one inclusive prefix sum
            over the whole batch."""
            zero = torch.zeros((), dtype=x.dtype, device=x.device)
            csum = torch.cumsum(torch.where(ok, x, zero), 0, dtype=x.dtype)
            pre_lo = torch.where(lo > 0, csum[(lo - 1).clamp(0, cap - 1)],
                                 zero)
            return torch.where(empty, zero, csum[hic] - pre_lo)

        def block_sum(x):
            """[lo, hi] sums of float rows, without a subtraction: each
            frame is the disjoint power-of-two blocks of its rows, taken
            low bit of its length first, so only the frame's own rows
            are added and the result does not depend on the rows around
            it (ROADMAP C3). Level k is ``b[i] = b[i] + b[i + 2^(k-1)]``
            of level k - 1; two levels are alive at a time. NaN and
            infinities follow IEEE addition inside the frame."""
            zero = torch.zeros((), dtype=x.dtype, device=x.device)
            blk = torch.where(ok, x, zero)
            length = torch.where(empty, torch.zeros_like(lo), hic - lo + 1)
            pos = lo.clamp(0, cap - 1)
            acc = torch.zeros_like(blk)
            for k in range(levels):
                take = ((length >> k) & 1).bool()
                acc = torch.where(take, acc + blk[pos.clamp(0, cap - 1)],
                                  acc)
                pos = pos + (take.to(pos.dtype) << k)
                if k + 1 < levels:
                    half = 1 << k
                    shifted = torch.zeros_like(blk)
                    shifted[:cap - half] = blk[half:]
                    blk = blk + shifted
            return acc

        # static: bits of the longest frame (a ROWS frame of n preceding
        # and m following rows holds at most n + m + 1 rows)
        longest = cap
        if w.frame is not None and w.frame[0] == "rows" \
                and w.frame[1] is not None and w.frame[2] is not None:
            longest = min(cap, max(1, int(w.frame[2]) - int(w.frame[1]) + 1))
        levels = max(1, longest.bit_length())

        def ranged_sum(x):
            """Per-row frame sums: integers and decimals (and counts) as
            differences of a prefix sum, which is exact for them; floats
            as block sums, which add only the frame's rows."""
            if x.is_floating_point():
                return block_sum(x)
            return prefix_diff(x)

        cnt = ranged_sum(torch.ones((cap,), dtype=torch.int64,
                                    device=lo.device))
        if isinstance(fn, E.Count):
            return cnt, None, None
        dt = fn.data_type(cs)
        if isinstance(fn, E.Sum):
            return ranged_sum(sdata.to(C._torch_dtype(dt))), cnt > 0, None
        if isinstance(fn, E.Avg):
            if isinstance(tv.dtype, T.DecimalType):
                data, _ = decimal_avg(ranged_sum(sdata), cnt, tv.dtype)
                return data, cnt > 0, None
            s = ranged_sum(sdata.to(torch.float64))
            return s / cnt.clamp(min=1).to(torch.float64), cnt > 0, None
        if isinstance(fn, (E.Min, E.Max)):
            return (self._framed_min_max(w, isinstance(fn, E.Min), sdata, ok,
                                         g, lo, hic),
                    cnt > 0, tv.dictionary)
        raise NotImplementedError(f"window aggregate {fn} is not ported yet")

    @staticmethod
    def _framed_min_max(w: E.WindowExpr, is_min: bool, sdata, ok,
                        g: _Geometry, lo, hic) -> torch.Tensor:
        cap = g.cap
        sent = (K._pos_sentinel(sdata.dtype) if is_min
                else K._neg_sentinel(sdata.dtype))
        fill = torch.full((), sent, dtype=sdata.dtype, device=sdata.device)
        masked = torch.where(ok, sdata, fill)
        combine = torch.minimum if is_min else torch.maximum
        if w.frame is None or w.frame[1] is None:
            # the frame starts at the partition start (a whole partition
            # ends at seg_end): a running min/max read at its end
            return K.seg_scan(g.seg, masked, combine)[hic]
        # bounded frame: a sparse table of doubling windows; each [lo, hi]
        # is the min/max of two overlapping power-of-two windows
        if cap > SPARSE_TABLE_MAX_ROWS:
            raise NotImplementedError(
                "sliding min/max over > 4M-row batches (sparse table "
                "would exceed the window memory budget)")
        levels = max(1, (max(2, cap) - 1).bit_length())  # ceil(log2(cap))
        tabs = [masked]
        for k in range(1, levels + 1):
            half = 1 << (k - 1)
            prev = tabs[-1]
            shifted = torch.cat([prev[half:], fill.expand(half)])
            tabs.append(combine(prev, shifted))
        stacked = torch.stack(tabs)  # (levels + 1, cap)
        length = (hic - lo + 1).clamp(min=1)
        kk = _floor_log2(length).clamp(0, levels)
        span = torch.ones_like(kk) << kk
        a = stacked[kk, lo.clamp(0, cap - 1)]
        b = stacked[kk, (hic - span + 1).clamp(0, cap - 1)]
        return combine(a, b)

    def node_string(self):
        return f"Window[{', '.join(str(e) for e in self.window_exprs)}]"

    def _key(self):
        return ("Window", tuple(E.expr_key(e) for e in self.window_exprs),
                self.child.plan_key())


def _bounded_search(sorted_key, targets, seg_start, seg_end, cap: int,
                    side: str) -> torch.Tensor:
    """Per-row binary search of ``targets[i]`` inside the row's own
    partition run [seg_start[i], seg_end[i]] (the batch is sorted only
    within partitions): ceil(log2(cap)) + 1 gather rounds."""
    lo = seg_start
    hi = seg_end + 1  # exclusive
    for _ in range(max(1, (max(2, cap) - 1).bit_length()) + 1):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        mv = sorted_key[mid.clamp(0, cap - 1)]
        go_right = (mv < targets) if side == "left" else (mv <= targets)
        within = mid < hi
        lo = torch.where(within & go_right, mid + 1, lo)
        hi = torch.where(within & ~go_right, mid, hi)
    return lo
