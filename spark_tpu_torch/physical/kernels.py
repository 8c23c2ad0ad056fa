"""Device kernels of the physical operators, as torch ops.

The port of ``spark_tpu/physical/kernels.py`` for the single-device
aggregate, join and window paths: sort and compaction permutations,
group ids, mixed-radix key packing, segmented reductions and scans, the
DISTINCT-aggregate first-row mask, the limit mask, and the sorted-build
join (build index, per-probe match ranges, pair expansion, range packing
and 64-bit key hashing). Everything is mask-carrying:
dead rows ride along and are neutralized per reduction.

Counts, sums and min/max select a path as the reference does
(``select_path``):

- K == 1: a plain reduction;
- K <= 64 (``MIN_ENGINE_K``): K masked dense reductions;
- 64 < K <= 1024, unsorted ids and a type the kernels take
  (``kernel_eligible``: any count, int64 sums, float32 min/max): the
  one-pass CUDA kernels of ``ops/seg_agg.py`` (their plain versions on
  CPU tensors);
- sorted ids: cumsum differences (counts, integer sums), a
  scatter-reduce over the sorted ids (min, max; exact in any order), a
  running count and a binary search per segment (first rows); the
  reference's segmented-scan reduction ``_sorted_seg_red`` is not
  needed, and its scan, ``seg_scan``, serves the window operator;
- anything else: scatter.

Integer sums are exact on every path (int64 adds natively on the GPU, so
the reference's 21-bit limb split is not needed). Float sums are a plain
reduction for K == 1. For K > 1, on every path, they take the
deterministic CUDA float sum ``ops/seg_agg.seg_fsum`` on the card, whose
bits depend only on each group's live values, and a scatter-add
(``index_add_``) on the CPU, which equals the reference's float branch
(``jax.ops.segment_sum``) bit for bit there; so the card's float groups
differ from the CPU run's by rounding only. ``MIN_ENGINE_K`` was
measured for the reference on a TPU; it is kept unchanged here.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_tpu_torch.device import device_table, host_side
from spark_tpu_torch.ops import seg_agg

MIN_ENGINE_K = 64                # _MASKED_SEG_LIMIT / pallas MIN_ENGINE_K
MAX_KERNEL_K = seg_agg.MAX_K     # 1024

INT64_MIN = -(1 << 63)
INT64_MAX = (1 << 63) - 1


class SortKey(NamedTuple):
    data: torch.Tensor
    validity: Optional[torch.Tensor]  # None = all valid
    ascending: bool = True
    nulls_first: bool = True


def _argsort(x: torch.Tensor, descending: bool = False) -> torch.Tensor:
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    return torch.argsort(x, stable=True, descending=descending)


def searchsorted(a: torch.Tensor, v: torch.Tensor,
                 side: str = "left") -> torch.Tensor:
    """Insertion positions of ``v`` in the sorted 1-D ``a`` (int64). The
    reference picks a binary-search or co-sort method by a TPU-tuned
    size ratio, which changes only speed; torch has one method."""
    return torch.searchsorted(a.contiguous(), v.to(a.dtype).contiguous(),
                              right=side == "right")


def lexsort_permutation(keys: Sequence[SortKey],
                        row_mask: torch.Tensor) -> torch.Tensor:
    """Stable lexicographic sort permutation. Live rows first; within the
    live region rows are ordered by ``keys`` (most significant first)
    with SQL null placement."""
    n = row_mask.shape[0]
    perm = torch.arange(n, device=row_mask.device)
    for key in reversed(list(keys)):
        d = key.data[perm]
        if key.validity is not None:
            # canonicalize NULL rows' payload before the data sort, so
            # nulls keep the order the less significant keys gave them
            v = key.validity[perm]
            d = torch.where(v, d, torch.zeros((), dtype=d.dtype,
                                              device=d.device))
        perm = perm[_argsort(d, descending=not key.ascending)]
        if key.validity is not None:
            v = key.validity[perm]
            perm = perm[_argsort(v, descending=not key.nulls_first)]
    live = row_mask[perm]
    return perm[_argsort(~live)]  # live rows (False) first


def compaction_permutation(row_mask: torch.Tensor) -> torch.Tensor:
    """Permutation moving live rows to the front, preserving order."""
    return _argsort(~row_mask)


def group_ids_from_sorted(
    sorted_keys: Sequence[Tuple[torch.Tensor, Optional[torch.Tensor]]],
    sorted_mask: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Given key columns already sorted (live rows first), return
    (segment_ids int32, num_groups). Equal adjacent keys (null==null)
    share a segment; dead rows get the last segment id."""
    n = sorted_mask.shape[0]
    dev = sorted_mask.device
    first = torch.zeros((1,), dtype=torch.bool, device=dev)
    change = torch.zeros((n,), dtype=torch.bool, device=dev)
    for data, validity in sorted_keys:
        neq = torch.cat([first, data[1:] != data[:-1]])
        if validity is not None:
            vneq = torch.cat([first, validity[1:] != validity[:-1]])
            both_null = torch.cat([first, (~validity[1:]) & (~validity[:-1])])
            neq = (neq & ~both_null) | vneq
        change = change | neq
    change = change & sorted_mask
    seg = torch.cumsum(change.to(torch.int32), 0, dtype=torch.int32)
    num_groups = torch.where(sorted_mask.any(), seg[-1] + 1,
                             torch.zeros((), dtype=torch.int32, device=dev))
    return seg, num_groups


# ---- segment aggregation ----------------------------------------------------


def kernel_eligible(op: str, dtype: Optional[torch.dtype]) -> bool:
    """Whether the seg_agg kernels take reduction ``op`` ("count", "sum",
    "min", "max") of ``dtype`` data: counts always, sums of int64 (the
    exact sum mode), min/max of float32."""
    if op == "count":
        return True
    if op == "sum":
        return dtype == torch.int64
    return dtype == torch.float32


def select_path(num_segments: int, sorted_seg: bool, kernel_dtype_ok: bool,
                ) -> str:
    """Which implementation a segmented reduction takes: ``"single"``,
    ``"masked"``, ``"kernel"``, ``"sorted"`` or ``"scatter"``.
    ``kernel_dtype_ok``: ``kernel_eligible`` of the reduction."""
    if num_segments == 1:
        return "single"
    if num_segments <= MIN_ENGINE_K:
        return "masked"
    if not sorted_seg and kernel_dtype_ok and num_segments <= MAX_KERNEL_K:
        return "kernel"
    if sorted_seg:
        return "sorted"
    return "scatter"


def _masked_reduce(data, seg, mask, num_segments: int, red, init):
    cols = []
    for k in range(num_segments):
        sel = mask & (seg == k)
        cols.append(red(torch.where(sel, data, init)))
    return torch.stack(cols)


def seg_bounds(seg: torch.Tensor, num_segments: int):
    """First/last row positions per segment for MONOTONE seg ids."""
    ks = torch.arange(num_segments, dtype=seg.dtype, device=seg.device)
    starts = torch.searchsorted(seg, ks, right=False)
    ends = torch.searchsorted(seg, ks, right=True) - 1
    return starts, ends


def _sorted_seg_sum(masked, seg, num_segments: int):
    csum = torch.cumsum(masked, 0, dtype=masked.dtype)
    starts, ends = seg_bounds(seg, num_segments)
    n = masked.shape[0]
    e = ends.clamp(0, n - 1)
    s = starts.clamp(0, n - 1)
    total = csum[e] - csum[s] + masked[s]
    return torch.where(ends >= starts, total,
                       torch.zeros((), dtype=masked.dtype,
                                   device=masked.device))


def _scatter_sum(masked, seg, num_segments: int):
    out = torch.zeros(num_segments, dtype=masked.dtype, device=masked.device)
    return out.index_add_(0, seg.long(), masked)


def _scatter_minmax(masked, seg, num_segments: int, is_max: bool):
    """Min/max over every row of each segment (dead rows carry the
    identity); NaN propagates as in jnp.minimum/maximum."""
    ident = _neg_sentinel(masked.dtype) if is_max \
        else _pos_sentinel(masked.dtype)
    out = torch.full((num_segments,), ident, dtype=masked.dtype,
                     device=masked.device)
    idx = seg.long()
    out.scatter_reduce_(0, idx, masked, "amax" if is_max else "amin",
                        include_self=True)
    if masked.is_floating_point():
        has_nan = torch.zeros(num_segments, dtype=torch.int32,
                              device=masked.device).scatter_reduce_(
            0, idx, torch.isnan(masked).to(torch.int32), "amax")
        out = out.masked_fill(has_nan > 0, float("nan"))
    return out


def seg_scan(seg: torch.Tensor, x: torch.Tensor, combine) -> torch.Tensor:
    """Segmented inclusive scan of ``x`` under the associative
    ``combine`` (torch.minimum, torch.maximum), restarting where the
    MONOTONE ``seg`` changes (the reference's associative_scan): log2(n)
    doubling steps, each combining a row with the row 2^k back when both
    lie in one segment. Exact for min/max; NaN propagates as in
    torch.minimum/maximum."""
    n = x.shape[0]
    out = x
    d = 1
    while d < n:
        same = seg[d:] == seg[:-d]
        out = torch.cat([out[:d], torch.where(same, combine(out[:-d], out[d:]),
                                              out[d:])])
        d *= 2
    return out


def _wrapper(name: str, *args, **kwargs):
    """Call the seg_agg wrapper ``name``. On CPU tensors its plain
    version stands in for the card's kernel: host work the card does not
    do (``device.host_side``)."""
    fn = getattr(seg_agg, name)
    if args[1].is_cuda:
        return fn(*args, **kwargs)
    with host_side():
        return fn(*args, **kwargs)


def _fsum_on(t: torch.Tensor) -> bool:
    """Whether a float sum over more than one group takes
    ``seg_agg.seg_fsum``: on a CUDA tensor always, and nothing falls back
    to ``index_add_`` there."""
    return t.is_cuda


def exact_seg_fsum(data, seg, mask, num_segments: int):
    """Grouped float sum, each group's exact sum rounded once, on every
    device: ``seg_agg.seg_fsum`` on the card, its plain version (the same
    bits) on the CPU. For callers whose result must not depend on the
    device (the KMeans update); the engine's own float sums keep the
    reference's ``index_add_`` on the CPU (``seg_sum``)."""
    return _wrapper("seg_fsum", data.contiguous(),
                    seg.to(torch.int32).contiguous(), mask.contiguous(),
                    num_segments)


def seg_sum(data, seg, mask, num_segments: int, sorted_seg: bool = False):
    """Grouped sum of int64 or float data (the only types the
    aggregates pass). Integer sums are exact on every path. A float sum
    over more than one group takes ``seg_agg.seg_fsum`` on the card
    (bits independent of row layout and atomic order) and a scatter-add
    on the CPU (the reference's float branch, bit for bit)."""
    path = select_path(num_segments, sorted_seg,
                       kernel_eligible("sum", data.dtype))
    if path == "kernel":
        return _wrapper("seg_sum", data.contiguous(),
                        seg.to(torch.int32).contiguous(), mask.contiguous(),
                        num_segments)
    if data.is_floating_point() and path != "single" and _fsum_on(data):
        return _wrapper("seg_fsum", data.contiguous(),
                        seg.to(torch.int32).contiguous(), mask.contiguous(),
                        num_segments)
    zero = torch.zeros((), dtype=data.dtype, device=data.device)
    if path == "masked" and not data.is_floating_point():
        return _masked_reduce(data, seg, mask, num_segments, torch.sum, zero)
    masked = torch.where(mask, data, zero)
    if path == "single":
        return masked.sum(dtype=data.dtype).reshape(1)
    if data.is_floating_point():
        return _scatter_sum(masked, seg, num_segments)
    if path == "sorted":
        return _sorted_seg_sum(masked, seg, num_segments)
    return _scatter_sum(masked, seg, num_segments)


def seg_count(seg, mask, num_segments: int, sorted_seg: bool = False):
    path = select_path(num_segments, sorted_seg,
                       kernel_eligible("count", None))
    if path == "kernel":
        return _wrapper("seg_sum", None, seg.to(torch.int32).contiguous(),
                        mask.contiguous(), num_segments, exact_int=True)
    ones = mask.to(torch.int64)
    if path == "single":
        return ones.sum().reshape(1)
    if path == "masked":
        return _masked_reduce(ones, seg, mask, num_segments, torch.sum,
                              torch.zeros((), dtype=torch.int64,
                                          device=seg.device))
    if path == "sorted":
        return _sorted_seg_sum(ones, seg, num_segments)
    return _scatter_sum(ones, seg, num_segments)


def _seg_minmax(data, seg, mask, num_segments: int, sorted_seg: bool,
                is_max: bool):
    path = select_path(num_segments, sorted_seg,
                       kernel_eligible("max" if is_max else "min",
                                       data.dtype))
    if path == "kernel":
        return _wrapper("seg_minmax", data.contiguous(),
                        seg.to(torch.int32).contiguous(), mask.contiguous(),
                        num_segments, is_max)
    ident = _neg_sentinel(data.dtype) if is_max else _pos_sentinel(data.dtype)
    ident_t = torch.full((), ident, dtype=data.dtype, device=data.device)
    red = _nan_max if is_max else _nan_min
    if path == "masked":
        return _masked_reduce(data, seg, mask, num_segments, red, ident_t)
    masked = torch.where(mask, data, ident_t)
    if path == "single":
        return red(masked).reshape(1)
    # "sorted" (ids monotone) and "scatter": the same scatter-reduce,
    # exact for min/max in any order
    return _scatter_minmax(masked, seg, num_segments, is_max)


def _nan_min(x):
    return x.amin() if not x.is_floating_point() else \
        torch.where(torch.isnan(x).any(), _nan_like(x), x.amin())


def _nan_max(x):
    return x.amax() if not x.is_floating_point() else \
        torch.where(torch.isnan(x).any(), _nan_like(x), x.amax())


def _nan_like(x):
    return torch.full((), float("nan"), dtype=x.dtype, device=x.device)


def seg_min(data, seg, mask, num_segments: int, sorted_seg: bool = False):
    return _seg_minmax(data, seg, mask, num_segments, sorted_seg, False)


def seg_max(data, seg, mask, num_segments: int, sorted_seg: bool = False):
    return _seg_minmax(data, seg, mask, num_segments, sorted_seg, True)


def seg_first(data, seg, mask, num_segments: int, capacity: int,
              sorted_seg: bool = False):
    """Value of the first (by position) masked row in each segment, and
    whether the segment has one. Paths as the reference's, sorted,
    masked (up to ``MIN_ENGINE_K`` segments) or scatter: with monotone
    ids a segment's first masked row is where the running count of
    masked rows first passes its count before the segment (one cumsum
    and a binary search per segment, where the reference runs a
    segmented scan); a scatter-min's atomics serialize when few
    segments take many rows."""
    dev = seg.device
    cap_t = torch.full((), capacity, device=dev)
    if sorted_seg:
        starts, ends = seg_bounds(seg, num_segments)
        count = torch.cumsum(mask.to(torch.int64), 0)
        before = torch.where(starts > 0,
                             count[(starts - 1).clamp(0, capacity - 1)],
                             torch.zeros((), dtype=torch.int64, device=dev))
        first_pos = searchsorted(count, before + 1, side="left")
        first_pos = torch.where((ends >= starts) & (first_pos <= ends),
                                first_pos, cap_t)
    else:
        pos = torch.where(mask, torch.arange(capacity, device=dev), cap_t)
        if num_segments <= MIN_ENGINE_K:
            first_pos = _masked_reduce(pos, seg, mask, num_segments,
                                       torch.min, cap_t)
        else:
            first_pos = torch.full((num_segments,), capacity,
                                   dtype=pos.dtype, device=dev)
            first_pos.scatter_reduce_(0, seg.long(), pos, "amin",
                                      include_self=True)
    idx = first_pos.clamp(0, capacity - 1)
    return data[idx], first_pos < capacity


def _pos_sentinel(dtype):
    if dtype.is_floating_point:
        return float("inf")
    if dtype == torch.bool:
        return True
    return torch.iinfo(dtype).max


def _neg_sentinel(dtype):
    if dtype.is_floating_point:
        return float("-inf")
    if dtype == torch.bool:
        return False
    return torch.iinfo(dtype).min


# ---- mixed-radix key packing ------------------------------------------------


def pack_codes(
    codes: Sequence[torch.Tensor],
    validities: Sequence[Optional[torch.Tensor]],
    cardinalities: Sequence[int],
) -> Tuple[torch.Tensor, int]:
    """Combine per-column small-int codes into one dense int64 group id
    with mixed-radix packing. Each nullable column contributes
    (cardinality+1) states, the extra one encoding NULL.

    Returns (combined_ids, total_cardinality)."""
    total = 1
    combined = None
    for code, validity, card in zip(codes, validities, cardinalities):
        slot = code.to(torch.int64)
        if validity is not None:
            slot = torch.where(validity, slot,
                               torch.full((), card, dtype=torch.int64,
                                          device=slot.device))
            card = card + 1
        combined = slot if combined is None else combined * card + slot
        total *= card
    if combined is None:
        raise ValueError("pack_codes needs at least one key")
    return combined, total


def unpack_code(combined: torch.Tensor, cardinalities: Sequence[int],
                nullable: Sequence[bool]):
    """Inverse of pack_codes: combined id -> per-column (code, validity)."""
    cards = [c + (1 if nl else 0) for c, nl in zip(cardinalities, nullable)]
    out = []
    rem = combined
    for card, orig_card, nl in zip(reversed(cards),
                                   reversed(list(cardinalities)),
                                   reversed(list(nullable))):
        slot = torch.remainder(rem, card)
        rem = torch.div(rem, card, rounding_mode="floor")
        if nl:
            valid = slot < orig_card
            code = torch.where(valid, slot, torch.zeros_like(slot))
            out.append((code, valid))
        else:
            out.append((slot, None))
    return list(reversed(out))


def distinct_first_mask(data: torch.Tensor, seg: torch.Tensor,
                        ok: torch.Tensor) -> torch.Tensor:
    """True for the first ok row of each (segment, value) pair: the
    DISTINCT-aggregate core (reference: ``kernels.distinct_first_mask``;
    Spark plans an Expand + two-level aggregate,
    RewriteDistinctAggregates.scala). A stable lexsort by (segment,
    value) with dead rows last, head flags of each run, scattered back
    to the rows' positions. ANDed into an aggregate's ok mask, it makes
    count/sum/avg see each value once per group.

    Floats compare by the bits of a canonical value (every NaN one NaN,
    -0.0 as +0.0), so NaN == NaN (Spark's NormalizeFloatingNumbers.scala).
    The bits are read as signed integers where the reference reads them
    unsigned: the order of the values differs, the runs and so the head
    of each run do not, since the stable sort keeps each run's first
    row first."""
    n = data.shape[0]
    if data.is_floating_point():
        canon = torch.where(torch.isnan(data),
                            torch.full((), float("nan"), dtype=data.dtype,
                                       device=data.device), data)
        canon = torch.where(canon == 0.0, torch.zeros((), dtype=data.dtype,
                                                      device=data.device),
                            canon)
        data = canon.view(torch.int32 if data.dtype == torch.float32
                          else torch.int64)
    keys = [SortKey(seg, None, True, True), SortKey(data, None, True, True)]
    perm = lexsort_permutation(keys, ok)
    sseg, sval = seg[perm], data[perm]
    head = torch.cat([torch.ones((1,), dtype=torch.bool, device=seg.device),
                      (sseg[1:] != sseg[:-1]) | (sval[1:] != sval[:-1])])
    out = torch.zeros((n,), dtype=torch.bool, device=seg.device)
    out[perm] = head & ok[perm]
    return out


# ---- key encoding -----------------------------------------------------------


def orderable_int64(
    data: torch.Tensor,
    validity: Optional[torch.Tensor],
    ascending: bool = True,
    nulls_first: bool = True,
    rank_table: Optional[np.ndarray] = None,
) -> torch.Tensor:
    """Encode a sort key column as int64 such that plain integer order ==
    the SQL sort order (direction + null placement). Floats use the
    IEEE754 sign-flip trick; dictionary-coded strings go through a rank
    table."""
    if rank_table is not None:
        y = device_table(np.asarray(rank_table, dtype=np.int64),
                         data.device)[data.long()]
    elif data.is_floating_point():
        bits = data.to(torch.float64).view(torch.int64)
        sign = bits < 0
        top = torch.full((), INT64_MIN, dtype=torch.int64, device=data.device)
        u = torch.where(sign, ~bits, bits | top)
        y = u ^ top
    else:
        y = data.to(torch.int64)
    if not ascending:
        y = ~y  # bitwise-not reverses integer order without overflow
    if validity is not None:
        fill = INT64_MIN if nulls_first else INT64_MAX
        y = torch.where(validity, y,
                        torch.full((), fill, dtype=torch.int64,
                                   device=y.device))
    return y


# ---- join ------------------------------------------------------------------


class JoinRanges(NamedTuple):
    """Per-probe-row contiguous match range in the sorted build side."""

    build_perm: torch.Tensor  # int32 sort permutation of the build side
    lo: torch.Tensor          # int64[probe_cap]
    hi: torch.Tensor          # int64[probe_cap]

    @property
    def counts(self) -> torch.Tensor:
        return self.hi - self.lo


def build_join_ranges(build_key: torch.Tensor, build_ok: torch.Tensor,
                      probe_key: torch.Tensor,
                      probe_ok: torch.Tensor) -> JoinRanges:
    """Sorted-build equi-join core (replaces HashedRelation.scala /
    LongToUnsafeRowMap:535): sort build keys with dead/null rows pushed to
    +inf, then two binary searches per probe row give its match range.
    ``build_ok``/``probe_ok``: live AND key-valid."""
    perm, skey, _, _ = make_join_index(build_key, build_ok, None)
    return ranges_from_index(perm, skey, None, None, probe_key, probe_ok)


#: dense lo/cnt lookup tables are built when the packed key domain is at
#: most this many entries (two int32 tables, 64 MB at 8M entries)
JOIN_TABLE_MAX = 1 << 23


def make_join_index(build_key: torch.Tensor, build_ok: torch.Tensor,
                    domain: Optional[int]):
    """The reusable part of a sorted-build join: the build permutation
    (stable, so equal keys keep build order and pairs come out in the
    reference's order), the sorted key with dead rows at the +inf
    sentinel, and, when the packed key domain is small enough, dense
    lo/cnt lookup tables over the whole domain. A join's first run
    caches it (``operators._JOIN_INDEX``, with the packed domain) for its
    traced re-executions; ``build_join_ranges`` passes ``domain=None``.

    Returns (perm int32[bcap], sorted_key[bcap], lo_table|None,
    cnt_table|None)."""
    sentinel = _pos_sentinel(build_key.dtype)
    masked = torch.where(build_ok, build_key,
                         torch.full((), sentinel, dtype=build_key.dtype,
                                    device=build_key.device))
    perm = torch.argsort(masked, stable=True)
    skey = masked[perm]
    lo_t = cnt_t = None
    if domain is not None and 0 < domain <= JOIN_TABLE_MAX:
        vals = torch.arange(domain, dtype=build_key.dtype,
                            device=build_key.device)
        lo = searchsorted(skey, vals, "left")
        hi = searchsorted(skey, vals, "right")
        lo_t = lo.to(torch.int32)
        cnt_t = (hi - lo).to(torch.int32)
    return perm.to(torch.int32), skey, lo_t, cnt_t


def ranges_from_index(perm: torch.Tensor, sorted_key: torch.Tensor,
                      lo_table: Optional[torch.Tensor],
                      cnt_table: Optional[torch.Tensor],
                      probe_key: torch.Tensor,
                      probe_ok: torch.Tensor) -> JoinRanges:
    """build_join_ranges against a precomputed make_join_index. Dead
    build rows carry the +inf sentinel key, so they sit past every dense
    table entry / real probe key and never match."""
    zero = torch.zeros((), dtype=torch.int64, device=probe_key.device)
    if lo_table is not None:
        domain = lo_table.shape[0]
        k = probe_key.clamp(0, domain - 1).long()
        ok = probe_ok & (probe_key >= 0) & (probe_key < domain)
        lo = torch.where(ok, lo_table[k].to(torch.int64), zero)
        hi = torch.where(ok, lo + cnt_table[k].to(torch.int64), zero)
        return JoinRanges(perm, lo, hi)
    sentinel = _pos_sentinel(sorted_key.dtype)
    lo = searchsorted(sorted_key, probe_key, side="left")
    hi = searchsorted(sorted_key, probe_key, side="right")
    ok = probe_ok & (probe_key != sentinel)
    return JoinRanges(perm, torch.where(ok, lo, zero),
                      torch.where(ok, hi, zero))


def expand_join_pairs(ranges: JoinRanges, total: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Materialize (probe_idx, build_idx, pair_mask) for all match pairs.
    ``total`` is the static output capacity (host-synced count, bucketed).
    Pair j belongs to the probe row p whose exclusive-offset range covers
    j; its build index is the j-offsets[p]'th sorted match."""
    counts = ranges.counts
    offsets = torch.cumsum(counts, 0) - counts  # exclusive prefix
    grand_total = offsets[-1] + counts[-1]
    j = torch.arange(total, device=counts.device)
    p = searchsorted(offsets, j, side="right") - 1
    p = p.clamp(0, counts.shape[0] - 1)
    k = j - offsets[p]
    build_sorted_pos = ranges.lo[p] + k
    build_idx = ranges.build_perm[
        build_sorted_pos.clamp(0, ranges.build_perm.shape[0] - 1)]
    pair_mask = j < grand_total
    return p, build_idx, pair_mask


def range_compress_keys(
    keys: List[Tuple[torch.Tensor, Optional[torch.Tensor]]],
    mins: List[int],
    ranges: List[int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack multiple integer join keys into one int64 via range
    compression (host supplies per-key min/range from lightweight stats).
    Returns (combined_key, all_valid_mask)."""
    combined = torch.zeros(keys[0][0].shape, dtype=torch.int64,
                           device=keys[0][0].device)
    valid = None
    for (data, validity), mn, rg in zip(keys, mins, ranges):
        slot = (data.to(torch.int64) - mn).clamp(0, rg - 1)
        combined = combined * rg + slot
        if validity is not None:
            valid = validity if valid is None else (valid & validity)
    if valid is None:
        valid = torch.ones(combined.shape, dtype=torch.bool,
                           device=combined.device)
    return combined, valid


# ---- 64-bit hashing ---------------------------------------------------------
#
# The reference hashes in uint64. torch has no uint64 right shift on the
# CPU and thin uint64 support on CUDA, so the port holds the same bits in
# int64: multiplies and adds wrap identically in two's complement, and a
# logical right shift is the arithmetic one with the sign-filled high
# bits masked off.


def _signed64(u: int) -> int:
    """The int64 whose bits are the uint64 ``u``."""
    return u - (1 << 64) if u >= 1 << 63 else u


_MIX1 = _signed64(0xFF51AFD7ED558CCD)
_MIX2 = _signed64(0xC4CEB9FE1A85EC53)
_GOLDEN = _signed64(0x9E3779B97F4A7C15)


def shift_right_logical(h: torch.Tensor, s: int) -> torch.Tensor:
    """``h >> s`` on the uint64 bits of int64 ``h`` (0 < s < 64)."""
    return (h >> s) & ((1 << (64 - s)) - 1)


def hash64(x: torch.Tensor) -> torch.Tensor:
    """Deterministic 64-bit avalanche mix (splitmix64/xxh64 finalizer
    shape), as int64 holding the reference's uint64 bits. Role of the
    reference's Murmur3/XXH64 hashes (common/unsafe hash/, catalyst
    XXH64.java)."""
    h = x.to(torch.int64)
    h = (h ^ shift_right_logical(h, 33)) * _MIX1
    h = (h ^ shift_right_logical(h, 33)) * _MIX2
    return h ^ shift_right_logical(h, 33)


def hash_combine(h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Fold another column into a running row hash."""
    return hash64(h ^ (x.to(torch.int64) + _GOLDEN))


# ---- misc ------------------------------------------------------------------


def limit_mask(row_mask: torch.Tensor, n: int, offset: int = 0
               ) -> torch.Tensor:
    """Keep only live rows with live-rank in [offset, offset+n)."""
    rank = torch.cumsum(row_mask.to(torch.int64), 0) - 1
    return row_mask & (rank >= offset) & (rank < offset + n)


def bucket(n: int, multiple: int = 1024) -> int:
    """Round up to a capacity bucket."""
    if n <= 0:
        return multiple
    return ((n + multiple - 1) // multiple) * multiple
