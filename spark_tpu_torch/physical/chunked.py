"""The out-of-memory tier: chunked scans through aggregation, joins and
top-k, and grace and hybrid hash joins when both sides exceed the device
budget (the port of ``spark_tpu/physical/chunked.py``).

When a plan's scan would take more device bytes than
``spark.tpu.maxDeviceBatchBytes``, the plan is not materialized whole.
Every tier is built on one merge-state decomposition
(``plan/incremental.AggSpec``):

1. **Streamed aggregation** (``_ChunkedAgg`` without sidecars): the
   file streams through host memory in bounded chunks
   (``FileSource.iter_batches``, never ``FileSource.read``, whose device
   cache would keep every chunk on the card); each chunk's partial
   aggregates run on the device and merge there with the running state.
2. **Streamed join tree** (``_ChunkedAgg`` with sidecars): one big scan
   joined against plans under the budget. The small join inputs
   ("sidecars") materialize once on the device; the big chunks flow
   through the original join tree. Sound where the big side is a
   preserved streamed side (inner and cross on either side; left, semi
   and anti on the left; right on the right). The sidecars' join keys
   filter each chunk on the host before it is copied (an exact sorted
   filter up to ``spark.tpu.semiFilterExactMax`` keys, a Bloom bitset
   above), and the key's range is pushed into the file scan.
3. **Hybrid hash join** (``_HybridHashJoinAgg``, the default when both
   sides are over the budget): build staging asks the session's
   ``UnifiedMemoryManager`` for a grant, partitions beyond the grant
   spill to Arrow IPC files in a temporary directory, overflowing
   buckets repartition recursively under a salted hash. The static
   **grace hash join** (``_GraceHashAgg``) is the path with
   ``spark.tpu.join.hybrid.enabled`` off and the rung the hybrid falls
   back to when a spill fails: both scans hash-partition by the join
   key into P host bucket sets, and each bucket pair joins on the
   device as an ordinary plan under the budget.

plus **streamed top-k** (``_ChunkedTopK``): Limit(Sort(big scan)) keeps a
running device top-(n + offset), merged per chunk.

Every tier streams through ``physical/pipeline.ChunkPipeline`` and runs
each chunk and merge through the planner under
``operators.stats_recording_disabled``: a chunk plan is single-shot with
fresh leaves, so it records no adaptive statistics and is never captured
into a CUDA graph. Each tier object keeps the record of its last run in
``last_run`` (and the module the newest in ``last_run``): the tier, its
chunks, rows in and kept and the pipeline's counters.

Chunks are shipped in their own integer widths (int64 stays int64): the
reference's ``narrow_transfer`` is not ported, and rows do not depend
on it. Reference analogue: ExternalSorter.scala:93,
SortMergeJoinExec.scala:39, ShuffledHashJoinExec and
TungstenAggregationIterator.scala:82.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from spark_tpu_torch import conf as CF
from spark_tpu_torch import deadline, faults, metrics, trace
from spark_tpu_torch import types as T
from spark_tpu_torch.expr import expressions as E
from spark_tpu_torch.plan import logical as L
from spark_tpu_torch.plan.incremental import AggSpec

# The defaults of these settings are the reference's, so both packages
# pick the same tier for the same plan; sizing them for the port's card
# is open (ROADMAP A9).

MAX_DEVICE_BATCH_BYTES = CF.register(
    "spark.tpu.maxDeviceBatchBytes", 5 << 30,
    "Scans whose materialized size would exceed this run in bounded "
    "host-memory chunks with partial aggregation on the device (the "
    "out-of-memory tier). The estimate is rows times the scan's row "
    "width. Default: the reference's, not yet sized for the port's "
    "card.", int)

CHUNK_ROWS = CF.register(
    "spark.tpu.chunkRows", 1 << 21,
    "Rows per device chunk of the out-of-memory tier. Default: the "
    "reference's.", int)

SEMI_FILTER_EXACT_MAX = CF.register(
    "spark.tpu.semiFilterExactMax", 64 << 20,
    "Chunked joins filter the big side's chunks on the host by join-key "
    "membership in the materialized small side: exact (a sorted array) "
    "up to this many distinct keys, a Bloom bitset above (false "
    "positives only cost copies). 0 disables the host filter. Default: "
    "the reference's.", int)

GRACE_PARTITIONS_MAX = CF.register(
    "spark.tpu.gracePartitionsMax", 256,
    "Upper bound on the grace hash join's partition count. Default: the "
    "reference's.", int)

JOIN_HYBRID_ENABLED = CF.register(
    "spark.tpu.join.hybrid.enabled", True,
    "Route joins with both sides over the budget through the hybrid "
    "hash join (_HybridHashJoinAgg: build staging sized to the bytes "
    "the unified memory manager grants, partitions beyond them spilled "
    "to host files, overflowing buckets repartitioned). Off: the static "
    "grace hash join, which is also the rung a failed spill falls back "
    "to.", bool)

JOIN_HYBRID_PARTITIONS_MAX = CF.register(
    "spark.tpu.join.hybrid.partitionsMax", 256,
    "Upper bound on the hybrid hash join's top-level partitions. "
    "Buckets still over the budget repartition recursively with a "
    "salt per level. Default: the reference's.", int)

JOIN_HYBRID_SPILL_RETRIES = CF.register(
    "spark.tpu.join.hybrid.spillRetryAttempts", 2,
    "Retries of one spill operation (a spill file's write or read-back, "
    "a recursive repartition) on a transient failure before the join "
    "falls back one rung, to the grace hash join recomputed from the "
    "source. Default: the reference's.", int)

JOIN_HYBRID_GROW_WHEN_IDLE = CF.register(
    "spark.tpu.join.hybrid.growWhenIdle", True,
    "Let the hybrid hash join grow its resident set from the unified "
    "memory manager's free span (never by evicting storage) before it "
    "demotes a partition to a spill file.", bool)

# join types through which a big left / right child may stream
_STREAM_LEFT = ("inner", "cross", "left", "left_semi", "left_anti")
_STREAM_RIGHT = ("inner", "cross", "right")
# join types where streamed rows without a match may be dropped on the host
_FILTER_LEFT = ("inner", "left_semi")
_FILTER_RIGHT = ("inner",)

#: the record of the newest tier run (each tier object keeps its own)
last_run: Optional[Dict[str, Any]] = None


@dataclasses.dataclass
class ChunkContext:
    """What a tier runs with: the settings, the engine
    (``run(logical plan) -> Batch``, optimized already), the device the
    chunks go to and the session's memory manager (None: the hybrid join
    stages everything resident, as the grace join does)."""

    conf: Any
    run: Callable[[L.LogicalPlan], Any]
    device: torch.device
    manager: Any = None


def _schema_width(schema) -> int:
    """Bytes per row of the scan's (column-pruned) schema: each value's
    width, and one byte for a nullable column's validity."""
    width = 0
    for f in schema.fields:
        try:
            width += np.dtype(f.dtype.np_dtype).itemsize
        except (AttributeError, TypeError):
            width += 8
        if f.nullable:
            width += 1
    return width


def _est_scan(scan: L.UnresolvedScan) -> Optional[int]:
    """The scan's device bytes if materialized: rows after its pushed
    filters (file metadata or a filtered count) times its row width."""
    try:
        rows = scan.source.count_rows(scan.filters)
    except Exception:  # noqa: BLE001 - an unknown size is "not chunkable"
        return None
    return rows * _schema_width(scan.schema)


def _contains(plan: L.LogicalPlan, target: L.LogicalPlan) -> bool:
    if plan is target:
        return True
    return any(_contains(c, target) for c in plan.children())


def _peel_above(plan: L.LogicalPlan):
    """The per-row, sort and limit nodes above the plan's first other
    node, outermost first, and that node."""
    above: List[L.LogicalPlan] = []
    node = plan
    while isinstance(node, (L.Project, L.Sort, L.Limit, L.Filter)):
        above.append(node)
        node = node.children()[0]
    return above, node


@dataclasses.dataclass
class _PathJoin:
    join: L.Join
    big_on_left: bool

    @property
    def sidecar(self) -> L.LogicalPlan:
        return self.join.right if self.big_on_left else self.join.left

    @property
    def big_keys(self) -> Tuple[E.Expression, ...]:
        return self.join.left_keys if self.big_on_left \
            else self.join.right_keys

    @property
    def sidecar_keys(self) -> Tuple[E.Expression, ...]:
        return self.join.right_keys if self.big_on_left \
            else self.join.left_keys

    @property
    def can_filter(self) -> bool:
        how = self.join.how
        return how in (_FILTER_LEFT if self.big_on_left else _FILTER_RIGHT)


def _stream_path(root: L.LogicalPlan,
                 big: L.UnresolvedScan) -> Optional[List[_PathJoin]]:
    """The joins between ``root`` and the big scan, outermost first, when
    every node on the way is per-row (Filter, Project, SubqueryAlias) or
    a join the big side may stream through; else None."""
    out: List[_PathJoin] = []
    node = root
    while node is not big:
        if isinstance(node, (L.Filter, L.Project, L.SubqueryAlias)):
            node = node.children()[0]
            continue
        if isinstance(node, L.Join):
            in_left = _contains(node.left, big)
            in_right = _contains(node.right, big)
            if in_left == in_right:  # both (a self-join) or neither
                return None
            how = node.how
            if in_left and how in _STREAM_LEFT:
                out.append(_PathJoin(node, True))
                node = node.left
                continue
            if in_right and how in _STREAM_RIGHT:
                out.append(_PathJoin(node, False))
                node = node.right
                continue
            return None
        return None
    return out


def _resolve_to_scan_col(expr: E.Expression, root: L.LogicalPlan,
                         big: L.UnresolvedScan) -> Optional[str]:
    """Trace a join-key expression from ``root``'s output down the
    streamed path to a column of the big scan (through Project aliases
    and join-output positions); None when it is computed or lands
    outside the scan."""
    expr = E.strip_alias(expr)
    node = root
    while node is not big:
        if not isinstance(expr, E.Col):
            return None
        name = expr.col_name
        if isinstance(node, (L.Filter, L.SubqueryAlias)):
            node = node.children()[0]
            continue
        if isinstance(node, L.Project):
            for e in node.exprs:
                if isinstance(e, E.Alias) and e.alias_name == name:
                    expr = E.strip_alias(e.child)
                    break
                if isinstance(e, E.Col) and e.col_name == name:
                    break
            else:
                return None
            node = node.children()[0]
            continue
        if isinstance(node, L.Join):
            big_on_left = _contains(node.left, big)
            out_names = list(node.schema.names)
            if name not in out_names:
                return None
            pos = out_names.index(name)
            ln = list(node.left.schema.names)
            if big_on_left:
                if pos >= len(ln):
                    return None
                expr = E.Col(ln[pos])
                node = node.left
            else:
                if pos < len(ln):
                    return None
                rn = list(node.right.schema.names)
                expr = E.Col(rn[pos - len(ln)])
                node = node.right
            continue
        return None
    if isinstance(expr, E.Col) and expr.col_name in big.schema.names:
        return expr.col_name
    return None


class _MergeState:
    """The running device-side merge of per-chunk partials: the state
    stays a device batch across chunks, so partials never go through the
    host."""

    def __init__(self, merge_plan_fn, run_fn):
        # (state relation or None, partial plan) -> merge plan
        self._merge_plan_fn = merge_plan_fn
        self._run = run_fn
        self.batch = None
        self.chunks = 0

    def feed(self, partial_plan: L.LogicalPlan) -> None:
        state_rel = None if self.batch is None else L.Relation(self.batch)
        self.batch = self._run(self._merge_plan_fn(state_rel, partial_plan))
        self.chunks += 1


def _merge_plan_for(spec: AggSpec):
    """The device merge step every aggregating tier shares: re-aggregate
    the union of the running state and one chunk's partials."""
    keys = tuple(E.Col(n) for n in spec.key_names)
    merge_outs = tuple(E.Alias(E.Col(n), n)
                       for n in spec.key_names) + tuple(spec.merges)

    def merge_plan(state_rel, partial):
        if state_rel is None:
            return L.Aggregate(keys, merge_outs, partial)
        aligned = L.Project(
            tuple(E.Col(n) for n in state_rel.schema.names), partial)
        return L.Aggregate(keys, merge_outs, L.Union(state_rel, aligned))

    return merge_plan


def _integral_key(dt) -> bool:
    return getattr(dt, "is_integral", False) \
        or isinstance(dt, (T.DateType, T.DecimalType))


def _int_key_values(batch, col: str) -> Optional[np.ndarray]:
    """A key column of a device batch as host int64 values (live, valid
    rows only); None for a key that is not integral."""
    try:
        i = batch.schema.index(col)
    except (KeyError, ValueError):
        return None
    if not _integral_key(batch.schema.fields[i].dtype):
        return None
    cd = batch.data.columns[i]
    data = cd.data.cpu().numpy().astype(np.int64)
    mask = batch.data.row_mask.cpu().numpy()
    if cd.validity is not None:
        mask = mask & cd.validity.cpu().numpy()
    return data[mask]


class _HostKeyFilter:
    """Host membership filter over one big-side key column: an exact
    sorted-array semi filter up to ``semiFilterExactMax`` distinct keys,
    a Bloom bitset above (two probes of the multiplicative hash below;
    false positives only cost copies). Also gives the key range for the
    scan's row-group pruning."""

    _MIX = np.uint64(0x9E3779B97F4A7C15)

    def __init__(self, col: str, values: np.ndarray, exact_max: int):
        self.col = col
        uniq = np.unique(values)  # sorted
        self.lo = int(uniq[0]) if len(uniq) else 0
        self.hi = int(uniq[-1]) if len(uniq) else 0
        self.exact = len(uniq) <= exact_max
        if self.exact:
            self._keys = uniq
        else:
            # about 16 bits a key, two probes: under 1% false positives
            nbits = 1 << int(np.ceil(np.log2(max(len(uniq), 2) * 16)))
            self._nbits = np.uint64(nbits)
            words = np.zeros(nbits // 64, dtype=np.uint64)
            for salt in (np.uint64(1), np.uint64(2)):
                h = (uniq.astype(np.uint64) * self._MIX * salt) \
                    % self._nbits
                np.bitwise_or.at(words, (h // 64).astype(np.int64),
                                 np.uint64(1) << (h % np.uint64(64)))
            self._words = words

    def member(self, vals: np.ndarray) -> np.ndarray:
        vals = vals.astype(np.int64, copy=False)
        if self.exact:
            if not len(self._keys):
                return np.zeros(len(vals), dtype=bool)
            pos = np.clip(np.searchsorted(self._keys, vals), 0,
                          len(self._keys) - 1)
            return self._keys[pos] == vals
        ok = np.ones(len(vals), dtype=bool)
        for salt in (np.uint64(1), np.uint64(2)):
            h = (vals.astype(np.uint64) * self._MIX * salt) % self._nbits
            bit = (self._words[(h // 64).astype(np.int64)]
                   >> (h % np.uint64(64))) & np.uint64(1)
            ok &= bit.astype(bool)
        return ok

    def range_conjuncts(self, schema) -> List[E.Expression]:
        """min/max predicates pushed into the file scan (row-group
        pruning; the membership test stays in numpy)."""
        dt = schema.field(self.col).dtype
        lo: object = self.lo
        hi: object = self.hi
        if isinstance(dt, T.DecimalType):
            return []  # the literal would need descaling; nothing to gain
        if isinstance(dt, T.DateType):
            epoch = datetime.date(1970, 1, 1)
            lo = epoch + datetime.timedelta(days=self.lo)
            hi = epoch + datetime.timedelta(days=self.hi)
        return [E.Cmp(">=", E.Col(self.col), E.Literal(lo)),
                E.Cmp("<=", E.Col(self.col), E.Literal(hi))]


def _decode_key_np(col) -> Optional[np.ndarray]:
    """An Arrow (chunked) column as int64 numpy for the membership test
    and the bucket hash; None when its storage is not integral
    (dictionaries, strings, floats). Nulls read as 0."""
    import pyarrow as pa
    import pyarrow.compute as pc

    if isinstance(col, pa.ChunkedArray):
        col = col.combine_chunks()
    t = col.type
    if pa.types.is_dictionary(t):
        return None
    if pa.types.is_decimal(t):
        raw = np.frombuffer(col.buffers()[1], dtype=np.int64)
        lo = col.offset * 2
        return raw[lo:lo + 2 * len(col):2].copy()
    try:
        if pa.types.is_date(t) or pa.types.is_timestamp(t):
            col = col.cast(pa.int64())
        vals = pc.fill_null(col, 0).to_numpy(zero_copy_only=False)
    except (pa.ArrowInvalid, pa.ArrowNotImplementedError, TypeError):
        return None
    if not np.issubdtype(vals.dtype, np.integer):
        return None
    return vals.astype(np.int64, copy=False)


def _chunk_capacity(rows: int, cap_max: int) -> int:
    """A power-of-two capacity in [2^16, cap_max]: few distinct
    capacities across a stream, while a chunk the key filter thinned
    ships in proportion to its surviving rows."""
    cap = 1 << 16
    while cap < rows:
        cap <<= 1
    return min(cap, cap_max) if rows <= cap_max else cap_max


def _empty_rel(scan: L.UnresolvedScan, device) -> L.Relation:
    """A relation of the scan's schema with no rows."""
    from spark_tpu_torch.columnar.arrow import from_arrow
    from spark_tpu_torch.io.datasource import _pa_schema_from_schema

    empty = _pa_schema_from_schema(scan.schema).empty_table()
    return L.Relation(from_arrow(empty, device=device))


def _splice(root: L.LogicalPlan,
            mapping: Dict[int, L.LogicalPlan]) -> L.LogicalPlan:
    """``root`` with the subtrees whose ids ``mapping`` names replaced,
    top-down (a replaced subtree is not entered, and a subtree with no
    replacement below it keeps its identity)."""
    hit = mapping.get(id(root))
    if hit is not None:
        return hit
    kids = root.children()
    if not kids:
        return root
    new = tuple(_splice(c, mapping) for c in kids)
    if all(a is b for a, b in zip(new, kids)):
        return root
    return root.with_children(new)


def _finish(above, final: L.LogicalPlan, run) -> Any:
    for node in reversed(above):
        final = node.with_children((final,))
    return run(final)


#: the event kind each tier records (the reference's names)
_EVENT_KINDS = {"_ChunkedAgg": "chunked_agg",
                "_GraceHashAgg": "grace_hash_agg",
                "_HybridHashJoinAgg": "hybrid_hash_agg",
                "_ChunkedTopK": "chunked_topk"}


def _record(tier, **fields) -> Dict[str, Any]:
    """Keep a tier's run in ``last_run`` and record it as the
    reference's event (``tracing.pipeline_profile`` folds them)."""
    global last_run
    rec = {"tier": type(tier).__name__, **fields}
    tier.last_run = rec
    last_run = rec
    metrics.record(_EVENT_KINDS.get(rec["tier"], "chunked"), **{
        k: v for k, v in fields.items()
        if isinstance(v, (int, float, str, bool, type(None)))})
    return rec


def _stager(ctx: ChunkContext):
    from spark_tpu_torch.physical.pipeline import Stager

    return Stager(ctx.device)


@dataclasses.dataclass(eq=False)
class _ChunkedAgg:
    """Tiers 1 and 2: an Aggregate over per-row nodes and streamable
    joins around one scan over the budget."""

    above: List[L.LogicalPlan]
    agg: L.Aggregate
    big: L.UnresolvedScan
    path_joins: List[_PathJoin]
    last_run: Optional[Dict[str, Any]] = None

    def execute(self, ctx: ChunkContext):
        from spark_tpu_torch.columnar.arrow import arrow_to_numpy
        from spark_tpu_torch.columnar.batch import round_capacity
        from spark_tpu_torch.physical.pipeline import (ChunkPipeline,
                                                       PipelineStats)

        conf, run_fn = ctx.conf, ctx.run
        agg, scan = self.agg, self.big
        spec = AggSpec(agg.groupings, agg.aggregates)
        key_aliases = tuple(E.Alias(g, n) for g, n
                            in zip(spec.groupings_exec, spec.key_names))
        chunk_rows = conf.get(CHUNK_ROWS)
        fixed_cap = round_capacity(chunk_rows)
        exact_max = conf.get(SEMI_FILTER_EXACT_MAX)
        depth = conf.get(CF.PIPELINE_DEPTH)
        prefetch_budget = conf.get(CF.PREFETCH_BYTES_MAX)
        stats = PipelineStats()
        stager = _stager(ctx)

        # plan-only pre-pass: which path joins could give a host key
        # filter. With none, the producer starts before the sidecars
        # materialize; with one, the stream waits for the sidecars' key
        # sets, so the membership filter and the range pruning hold.
        filter_col: Dict[int, str] = {}
        for pj in self.path_joins:
            if exact_max > 0 and pj.can_filter and len(pj.big_keys) == 1:
                col = _resolve_to_scan_col(
                    pj.big_keys[0],
                    pj.join.left if pj.big_on_left else pj.join.right,
                    scan)
                if col is not None:
                    filter_col[id(pj)] = col

        scan_cols = scan.columns
        filters: List[_HostKeyFilter] = []
        counters = {"rows_in": 0, "rows_kept": 0}

        def make_prepare(read_cols):
            drop_extra = (scan_cols is not None
                          and len(read_cols or ()) != len(scan_cols))

            def prepare(tbl):
                counters["rows_in"] += tbl.num_rows
                if filters:
                    with stats.timed("filter"):
                        keep = np.ones(tbl.num_rows, dtype=bool)
                        for kf in filters:
                            vals = _decode_key_np(tbl.column(kf.col))
                            if vals is None:
                                continue
                            keep &= kf.member(vals)
                        if not keep.all():
                            tbl = tbl.filter(keep)
                        if drop_extra:
                            tbl = tbl.select(list(scan_cols))
                if tbl.num_rows == 0:
                    return None
                counters["rows_kept"] += tbl.num_rows
                with stats.timed("decode"):
                    sch, arrs, vlds = arrow_to_numpy(tbl)
                with stats.timed("transfer"):
                    return stager.stage(
                        sch, arrs, vlds,
                        _chunk_capacity(tbl.num_rows, fixed_cap))

            return prepare

        pipe = None
        sidecar_rel: Dict[int, L.LogicalPlan] = {}
        state = _MergeState(_merge_plan_for(spec), run_fn)
        try:
            if depth >= 1 and not filter_col:
                pipe = ChunkPipeline(
                    scan.source.iter_batches(scan_cols,
                                             tuple(scan.filters),
                                             chunk_rows),
                    make_prepare(scan_cols), depth=depth,
                    byte_budget=prefetch_budget, stats=stats,
                    conf=conf)

            # 1. each sidecar materializes once and stays on the device
            for pj in self.path_joins:
                with stats.timed("sidecar"):
                    batch = run_fn(pj.sidecar)
                sidecar_rel[id(pj.sidecar)] = L.Relation(batch)
                col = filter_col.get(id(pj))
                if col is None:
                    continue
                skey = E.strip_alias(pj.sidecar_keys[0])
                with stats.timed("sidecar"):
                    kb = run_fn(L.Project(
                        (E.Alias(skey, "__semi_k"),), L.Relation(batch)))
                vals = _int_key_values(kb, "__semi_k")
                if vals is not None:
                    filters.append(_HostKeyFilter(col, vals, exact_max))
            skeleton = _splice(agg.child, sidecar_rel) \
                if sidecar_rel else agg.child

            if pipe is None:
                # 2. push the key ranges into the scan, then stream and
                # filter the chunks
                scan_filters = tuple(scan.filters)
                for kf in filters:
                    scan_filters += tuple(kf.range_conjuncts(scan.schema))
                if filters and scan_cols is not None:
                    # the membership columns must be read too
                    need = [kf.col for kf in filters
                            if kf.col not in scan_cols]
                    read_cols = tuple(scan_cols) \
                        + tuple(dict.fromkeys(need))
                else:
                    read_cols = scan_cols
                pipe = ChunkPipeline(
                    scan.source.iter_batches(read_cols, scan_filters,
                                             chunk_rows),
                    make_prepare(read_cols), depth=depth,
                    byte_budget=prefetch_budget, stats=stats,
                    conf=conf)

            for rel in pipe:
                with stats.timed("compute"):
                    chunk_plan = _splice(skeleton, {id(scan): rel})
                    state.feed(L.Aggregate(
                        tuple(spec.groupings_exec),
                        key_aliases + tuple(spec.partials), chunk_plan))
        finally:
            if pipe is not None:
                pipe.close()
        _record(self, chunks=state.chunks, sidecars=len(sidecar_rel),
                key_filters=len(filters), rows_in=counters["rows_in"],
                rows_kept=counters["rows_kept"], pipeline_depth=depth,
                **stats.finish())

        if state.batch is None:
            # an empty stream: the aggregate over an empty relation in
            # the scan's place (the original plan would read the scan)
            return _finish(self.above, L.Aggregate(
                agg.groupings, agg.aggregates,
                _splice(skeleton, {id(scan): _empty_rel(scan, ctx.device)})),
                run_fn)
        return _finish(self.above, L.Project(tuple(spec.outputs),
                                             L.Relation(state.batch)),
                       run_fn)


def _bucket_of(vals: np.ndarray, nparts: int, salt: int = 1) -> np.ndarray:
    """The grace hash of int64 keys: ``(key * 0x9E3779B97F4A7C15 * salt
    mod 2^64) >> 32``, mod ``nparts``."""
    mix = np.uint64(0x9E3779B97F4A7C15)
    h = vals.astype(np.uint64) * mix
    if salt != 1:
        h = h * np.uint64(salt)
    return ((h >> np.uint64(32)) % np.uint64(nparts)).astype(np.int64)


def _empty_table(scan: L.UnresolvedScan):
    from spark_tpu_torch.io.datasource import _pa_schema_from_schema

    return _pa_schema_from_schema(scan.schema).empty_table()


def _pair_to_device(stager, stats, scan_a, scan_b, ta, tb, cap_a: int,
                    cap_b: int):
    """One bucket pair's tables staged on the device, keyed by their
    scans' ids (the splice mapping)."""
    from spark_tpu_torch.columnar.arrow import arrow_to_numpy

    with stats.timed("decode"):
        sa, aa, va = arrow_to_numpy(ta)
        sb, ab, vb = arrow_to_numpy(tb)
    with stats.timed("transfer"):
        return {id(scan_a): stager.stage(sa, aa, va, cap_a),
                id(scan_b): stager.stage(sb, ab, vb, cap_b)}


def _join_keeps(how: str, has_a: bool, has_b: bool) -> bool:
    """Whether a bucket pair can give output rows under join type
    ``how`` (every key lands in one bucket, so the join is local)."""
    if not has_a and not has_b:
        return False
    if how not in ("left", "right", "full") and (not has_a or not has_b):
        return how == "left_anti" and has_a
    return True


@dataclasses.dataclass(eq=False)
class _GraceHashAgg:
    """Tier 3: an Aggregate over Join(per-row(big A), per-row(big B))
    with both scans over the budget: both partition into host buckets by
    the grace hash of the join key, then each bucket pair joins on the
    device and feeds the merge state, in bucket order."""

    above: List[L.LogicalPlan]
    agg: L.Aggregate
    join: L.Join
    scan_a: L.UnresolvedScan  # under join.left
    scan_b: L.UnresolvedScan  # under join.right
    key_a: str  # partition column of scan_a
    key_b: str
    est_total: int
    last_run: Optional[Dict[str, Any]] = None

    def execute(self, ctx: ChunkContext):
        import pyarrow as pa

        from spark_tpu_torch.columnar.batch import round_capacity
        from spark_tpu_torch.physical.pipeline import (ChunkPipeline,
                                                       PipelineStats)

        conf, run_fn = ctx.conf, ctx.run
        budget = conf.get(MAX_DEVICE_BATCH_BYTES)
        chunk_rows = conf.get(CHUNK_ROWS)
        depth = conf.get(CF.PIPELINE_DEPTH)
        prefetch_budget = conf.get(CF.PREFETCH_BYTES_MAX)
        stats = PipelineStats()
        stager = _stager(ctx)
        nparts = int(min(conf.get(GRACE_PARTITIONS_MAX),
                         max(2, -(-4 * self.est_total // max(budget, 1)))))

        def partition(scan, key_col):
            buckets: List[list] = [[] for _ in range(nparts)]
            for tbl in scan.source.iter_batches(
                    scan.columns, scan.filters, chunk_rows):
                vals = _decode_key_np(tbl.column(key_col))
                if vals is None:
                    raise NotImplementedError(
                        "grace hash join needs an integral partition key")
                h = _bucket_of(vals, nparts)
                for p in np.unique(h):
                    buckets[p].append(tbl.filter(h == p))
            return buckets

        with stats.timed("decode"):
            if depth >= 1:
                # both sides' partition passes are host work over
                # disjoint state: run them together
                import concurrent.futures as cf

                with cf.ThreadPoolExecutor(
                        2, thread_name_prefix="grace-partition") as pool:
                    fa = pool.submit(partition, self.scan_a, self.key_a)
                    fb = pool.submit(partition, self.scan_b, self.key_b)
                    buckets_a, buckets_b = fa.result(), fb.result()
            else:
                buckets_a = partition(self.scan_a, self.key_a)
                buckets_b = partition(self.scan_b, self.key_b)

        spec = AggSpec(self.agg.groupings, self.agg.aggregates)
        key_aliases = tuple(E.Alias(g, n) for g, n
                            in zip(spec.groupings_exec, spec.key_names))
        state = _MergeState(_merge_plan_for(spec), run_fn)

        def concat(parts, scan):
            return pa.concat_tables(parts) if parts else _empty_table(scan)

        # one capacity per side across all buckets
        cap_a = round_capacity(max(
            [sum(t.num_rows for t in b) for b in buckets_a] or [1]))
        cap_b = round_capacity(max(
            [sum(t.num_rows for t in b) for b in buckets_b] or [1]))
        parts = [p for p in range(nparts)
                 if _join_keeps(self.join.how, bool(buckets_a[p]),
                                bool(buckets_b[p]))]

        def prepare(p):
            with stats.timed("decode"):
                ta = concat(buckets_a[p], self.scan_a)
                tb = concat(buckets_b[p], self.scan_b)
                buckets_a[p] = buckets_b[p] = []  # free host memory
            return _pair_to_device(stager, stats, self.scan_a, self.scan_b,
                                   ta, tb, cap_a, cap_b)

        pipe = ChunkPipeline(parts, prepare, depth=depth,
                             byte_budget=prefetch_budget, stats=stats,
                             conf=conf)
        try:
            for mapping in pipe:
                with stats.timed("compute"):
                    chunk_plan = _splice(self.agg.child, mapping)
                    state.feed(L.Aggregate(
                        tuple(spec.groupings_exec),
                        key_aliases + tuple(spec.partials), chunk_plan))
        finally:
            pipe.close()
        _record(self, partitions=nparts, chunks=state.chunks,
                pipeline_depth=depth, **stats.finish())
        return _finish_pair(self, spec, state, ctx)


def _finish_pair(tier, spec: AggSpec, state: _MergeState,
                 ctx: ChunkContext):
    if state.batch is None:
        return _finish(tier.above, L.Aggregate(
            tier.agg.groupings, tier.agg.aggregates,
            _splice(tier.agg.child,
                    {id(tier.scan_a): _empty_rel(tier.scan_a, ctx.device),
                     id(tier.scan_b): _empty_rel(tier.scan_b, ctx.device)})),
            ctx.run)
    return _finish(tier.above, L.Project(tuple(spec.outputs),
                                         L.Relation(state.batch)), ctx.run)


# recursive repartition: an overflowing bucket splits 4 ways a level under
# a fresh salt, until it fits the budget, falls under the row floor, holds
# one hot key (splitting cannot help) or reaches the depth cap
_RECURSE_FANOUT = 4
_RECURSE_MAX_DEPTH = 8
_RECURSE_MIN_ROWS = 4096

#: registers of the host distinct sketch of the join keys
_HLL_REGISTERS = 256

class _HybridSpillAbort(Exception):
    """A spill operation exhausted its retries or failed for good: the
    hybrid pass drops its partial state and falls back one rung, to the
    grace hash join recomputed from the source."""

    def __init__(self, op: str, kind: str):
        super().__init__(f"hybrid hash join {op} aborted ({kind})")
        self.op = op
        self.kind = kind


def _spill_seam(conf, op: str, attempts: int, fn,
                counters: Dict[str, int]):
    """Run one spill operation behind the ``join.spill`` fault point, in
    a ``join.spill`` span: a transient failure retries up to
    ``attempts`` times (each re-attempt drawn from the query's retry
    budget and checked against its deadline), any other failure (or
    exhausted retries) aborts the hybrid pass, an OOM propagates so that
    the degradation ladder stays the last resort, and a passed deadline
    surfaces as itself."""
    from spark_tpu_torch import recovery

    last: Optional[BaseException] = None
    for attempt in range(max(0, int(attempts)) + 1):
        try:
            with trace.span("join.spill", op=op, attempt=attempt):
                faults.inject("join.spill", conf)
                return fn()
        except deadline.DeadlineExceeded:
            # not a spill failure: the query's window closed, and the
            # fallback to the grace join would only burn more time
            raise
        except Exception as e:  # noqa: BLE001 - classified below
            if recovery.is_oom(e):
                raise
            if recovery.is_transient(e) and attempt < attempts:
                deadline.check(f"join.spill.{op}")
                if not recovery.retry_allowed("join.spill"):
                    raise recovery.RetryBudgetExhausted(
                        "join.spill", recovery.current_budget()) from e
                counters["spill_retries"] += 1
                metrics.note_join("spill_retries")
                metrics.record("stage_retry", label=f"join.spill.{op}",
                               attempt=attempt, error=repr(e))
                last = e
                continue
            raise _HybridSpillAbort(
                op, getattr(e, "kind", type(e).__name__)) from e
    raise _HybridSpillAbort(op, getattr(last, "kind", "exhausted")) from last


class _HybridPart:
    """One side of one hybrid-join partition: resident Arrow tables while
    it fits the grant, a write-through spill file after demotion."""

    __slots__ = ("tables", "rows", "nbytes", "path", "sink", "writer",
                 "spilled")

    def __init__(self):
        self.tables: list = []
        self.rows = 0
        self.nbytes = 0
        self.path: Optional[str] = None
        self.sink = None
        self.writer = None
        self.spilled = False


@dataclasses.dataclass(eq=False)
class _HybridHashJoinAgg:
    """Tier 3, dynamic: the grant-driven hybrid hash join.

    1. **Grant.** Before touching data it asks the session's
       UnifiedMemoryManager for an execution grant of the planner's
       measured staging of an earlier run of the same plan shape
       (``scheduler/admission.seeded_build_bytes``, noted at the end of
       each hybrid run), else the planner's estimate. The grant is what
       staging may keep resident; a zero grant spills everything and
       still completes in one pass.
    2. **Partition pass.** Both scans stream once, bucketed by the grace
       hash. Partitions stay resident until the grant is spent; then
       the join grows the grant from the manager's free span
       (growWhenIdle, never evicting storage) or demotes the largest
       resident partition to an Arrow IPC spill file. A host HLL sketch
       of the join keys is kept.
    3. **Join pass.** Partitions run in index order (resident ones
       directly, spilled ones read back), feeding the same device merge
       state as grace, so the rows are the grace join's. A bucket pair
       whose working set would exceed the device budget repartitions
       recursively with a salt per level.

    A spill operation that fails for good falls back one rung, to the
    grace hash join recomputed from the source."""

    above: List[L.LogicalPlan]
    agg: L.Aggregate
    join: L.Join
    scan_a: L.UnresolvedScan
    scan_b: L.UnresolvedScan
    key_a: str
    key_b: str
    est_total: int
    last_run: Optional[Dict[str, Any]] = None

    def execute(self, ctx: ChunkContext):
        try:
            return self._execute_hybrid(ctx)
        except _HybridSpillAbort as e:
            metrics.note_join("fallbacks")
            metrics.record("fault_recovered", point="join.spill",
                           fault=e.kind, op=e.op, action="grace_fallback")
            grace = _GraceHashAgg(self.above, self.agg, self.join,
                                  self.scan_a, self.scan_b, self.key_a,
                                  self.key_b, self.est_total)
            out = grace.execute(ctx)
            self.last_run = dict(grace.last_run, tier=type(self).__name__,
                                 fallback="grace", aborted=e.op,
                                 abort_kind=e.kind)
            _record(self, **{k: v for k, v in self.last_run.items()
                             if k != "tier"})
            return out

    def _execute_hybrid(self, ctx: ChunkContext):
        import os
        import shutil
        import tempfile

        import pyarrow as pa

        from spark_tpu_torch.columnar.batch import round_capacity
        from spark_tpu_torch.physical.pipeline import (ChunkPipeline,
                                                       PipelineStats)
        from spark_tpu_torch.scheduler import admission
        from spark_tpu_torch.sketch import HyperLogLog

        conf, run_fn = ctx.conf, ctx.run
        budget = conf.get(MAX_DEVICE_BATCH_BYTES)
        chunk_rows = conf.get(CHUNK_ROWS)
        depth = conf.get(CF.PIPELINE_DEPTH)
        prefetch_budget = conf.get(CF.PREFETCH_BYTES_MAX)
        retries = int(conf.get(JOIN_HYBRID_SPILL_RETRIES))
        grow_idle = bool(conf.get(JOIN_HYBRID_GROW_WHEN_IDLE))
        stats = PipelineStats()
        stager = _stager(ctx)
        nparts = int(min(conf.get(JOIN_HYBRID_PARTITIONS_MAX),
                         max(2, -(-4 * self.est_total // max(budget, 1)))))

        manager = ctx.manager
        counters = {"resident": 0, "staged": 0, "spill_bytes": 0,
                    "max_depth": 0, "grants": 0, "grows": 0,
                    "spill_writes": 0, "spill_reads": 0,
                    "spill_retries": 0, "recursive_repartitions": 0}
        charge = 0
        resident_cap: Optional[int] = None  # None: ungoverned
        if manager is not None:
            # the measured staging of an earlier run of this plan shape,
            # else the planner's estimate
            charge = manager.acquire_execution(
                admission.seeded_build_bytes(self.agg, self.est_total))
            resident_cap = charge
            counters["grants"] += 1
        granted0 = charge

        parts_a = [_HybridPart() for _ in range(nparts)]
        parts_b = [_HybridPart() for _ in range(nparts)]
        hll = HyperLogLog(_HLL_REGISTERS)
        tmpdir: Optional[str] = None

        def spill_write(side, p, part, tables):
            nbytes = sum(t.nbytes for t in tables)

            def do():
                nonlocal tmpdir
                if part.writer is None:
                    if tmpdir is None:
                        tmpdir = tempfile.mkdtemp(
                            prefix="spark-tpu-torch-hybrid-join-")
                    part.path = os.path.join(tmpdir, f"{side}{p}.arrows")
                    part.sink = pa.OSFile(part.path, "wb")
                    part.writer = pa.ipc.new_stream(part.sink,
                                                    tables[0].schema)
                for t in tables:
                    part.writer.write_table(t)

            _spill_seam(conf, "write", retries, do, counters)
            counters["spill_writes"] += 1
            counters["spill_bytes"] += nbytes

        def demote_one() -> int:
            """Spill the largest resident partition whole; the resident
            bytes freed (0 when nothing can be demoted)."""
            best = None
            for side, plist in (("a", parts_a), ("b", parts_b)):
                for p, part in enumerate(plist):
                    if part.tables and (best is None
                                        or part.nbytes > best[2].nbytes):
                        best = (side, p, part)
            if best is None:
                return 0
            side, p, part = best
            tables, freed = part.tables, part.nbytes
            part.tables, part.nbytes = [], 0
            part.spilled = True
            spill_write(side, p, part, tables)
            return freed

        def partition_side(side, scan, key_col, plist):
            nonlocal charge, resident_cap
            for tbl in scan.source.iter_batches(
                    scan.columns, scan.filters, chunk_rows):
                vals = _decode_key_np(tbl.column(key_col))
                if vals is None:
                    raise NotImplementedError(
                        "hybrid hash join needs an integral partition key")
                hll.update(vals)
                h = _bucket_of(vals, nparts)
                for p in np.unique(h):
                    part = plist[p]
                    sub = tbl.filter(h == p)
                    part.rows += sub.num_rows
                    counters["staged"] += sub.nbytes
                    if part.spilled:  # write-through: stays spilled
                        spill_write(side, p, part, [sub])
                        continue
                    part.tables.append(sub)
                    part.nbytes += sub.nbytes
                    counters["resident"] += sub.nbytes
                # keep staged bytes inside the grant: grow from the free
                # span when allowed, else demote the largest partition
                while resident_cap is not None \
                        and counters["resident"] > resident_cap:
                    need = counters["resident"] - resident_cap
                    if grow_idle and manager is not None:
                        got = manager.try_grow(need)
                        if got:
                            charge += got
                            resident_cap += got
                            counters["grows"] += 1
                            continue
                    freed = demote_one()
                    if freed == 0:
                        break  # nothing to demote: run over the grant
                    counters["resident"] -= freed

        def close_writers():
            for plist in (parts_a, parts_b):
                for part in plist:
                    if part.writer is not None:
                        part.writer.close()
                        part.sink.close()
                        part.writer = part.sink = None

        def read_back(part):
            def do():
                with pa.OSFile(part.path, "rb") as f:
                    return pa.ipc.open_stream(f).read_all()

            tbl = _spill_seam(conf, "read", retries, do, counters)
            counters["spill_reads"] += 1
            return tbl

        def materialize(part, scan):
            if part.spilled:
                return read_back(part)
            if not part.tables:
                return _empty_table(scan)
            return pa.concat_tables(part.tables)

        spec = AggSpec(self.agg.groupings, self.agg.aggregates)
        key_aliases = tuple(E.Alias(g, n) for g, n
                            in zip(spec.groupings_exec, spec.key_names))
        state = _MergeState(_merge_plan_for(spec), run_fn)
        how = self.join.how

        try:
            with trace.span("join.partition", partitions=nparts,
                            granted=granted0):
                # the sides run one after the other: spill and grow
                # decisions against the shared grant stay deterministic
                partition_side("a", self.scan_a, self.key_a, parts_a)
                partition_side("b", self.scan_b, self.key_b, parts_b)
                close_writers()

            # one capacity ladder per side: the top level from the
            # largest bucket, sub-buckets on _chunk_capacity below it
            cap_a = round_capacity(max([p.rows for p in parts_a] + [1]))
            cap_b = round_capacity(max([p.rows for p in parts_b] + [1]))
            parts = [p for p in range(nparts)
                     if _join_keeps(how, parts_a[p].rows > 0,
                                    parts_b[p].rows > 0)]

            def to_device(ta, tb):
                return _pair_to_device(
                    stager, stats, self.scan_a, self.scan_b, ta, tb,
                    _chunk_capacity(max(ta.num_rows, 1), cap_a),
                    _chunk_capacity(max(tb.num_rows, 1), cap_b))

            def split_bucket(ta, tb, level, out):
                pair = ta.nbytes + tb.nbytes
                if (4 * pair <= budget or level >= _RECURSE_MAX_DEPTH
                        or max(ta.num_rows,
                               tb.num_rows) <= _RECURSE_MIN_ROWS):
                    out.append(to_device(ta, tb))
                    return
                ka = _decode_key_np(ta.column(self.key_a)) \
                    if ta.num_rows else None
                if ka is not None and len(np.unique(ka)) <= 1:
                    out.append(to_device(ta, tb))  # one hot key
                    return

                def do():
                    salt = 2 * level + 3

                    def rehash(tbl, col):
                        if tbl.num_rows == 0:
                            return [tbl] * _RECURSE_FANOUT
                        h = _bucket_of(_decode_key_np(tbl.column(col)),
                                       _RECURSE_FANOUT, salt)
                        return [tbl.filter(h == i)
                                for i in range(_RECURSE_FANOUT)]

                    return (rehash(ta, self.key_a),
                            rehash(tb, self.key_b))

                subs_a, subs_b = _spill_seam(conf, "repartition", retries,
                                             do, counters)
                counters["recursive_repartitions"] += 1
                counters["max_depth"] = max(counters["max_depth"],
                                            level + 1)
                for i in range(_RECURSE_FANOUT):
                    if _join_keeps(how, subs_a[i].num_rows > 0,
                                   subs_b[i].num_rows > 0):
                        split_bucket(subs_a[i], subs_b[i], level + 1, out)

            def prepare(p):
                ta = materialize(parts_a[p], self.scan_a)
                tb = materialize(parts_b[p], self.scan_b)
                parts_a[p].tables = parts_b[p].tables = []  # free memory
                out: list = []
                split_bucket(ta, tb, 0, out)
                return out or None

            pipe = ChunkPipeline(parts, prepare, depth=depth,
                                 byte_budget=prefetch_budget, stats=stats,
                                 conf=conf)
            try:
                for mappings in pipe:
                    for mapping in mappings:
                        with stats.timed("compute"):
                            chunk_plan = _splice(self.agg.child, mapping)
                            state.feed(L.Aggregate(
                                tuple(spec.groupings_exec),
                                key_aliases + tuple(spec.partials),
                                chunk_plan))
            finally:
                pipe.close()
        finally:
            close_writers()
            if tmpdir is not None:
                shutil.rmtree(tmpdir, ignore_errors=True)
            if manager is not None:
                manager.release_execution(charge)

        spilled = sum(1 for plist in (parts_a, parts_b)
                      for pt in plist if pt.spilled)
        _record(self, partitions=nparts, spilled_parts=spilled,
                resident_parts=2 * nparts - spilled,
                granted_bytes=granted0, grown_bytes=charge - granted0,
                staged_bytes=counters["staged"],
                spill_bytes=counters["spill_bytes"],
                depth=counters["max_depth"], ndv=int(hll.estimate()),
                grants=counters["grants"], grows=counters["grows"],
                spill_writes=counters["spill_writes"],
                spill_reads=counters["spill_reads"],
                spill_retries=counters["spill_retries"],
                recursive_repartitions=counters["recursive_repartitions"],
                fallback=None, chunks=state.chunks, pipeline_depth=depth,
                **stats.finish())
        # the next run of this plan shape asks for what staging took
        admission.note_measured_bytes(self.agg, counters["staged"])
        return _finish_pair(self, spec, state, ctx)


@dataclasses.dataclass(eq=False)
class _ChunkedTopK:
    """Streamed top-k: Limit(Sort(per-row(big scan))) keeps a running
    device top-(n + offset), merged per chunk (TakeOrderedAndProjectExec's
    shape)."""

    above: List[L.LogicalPlan]  # Projects above the Limit
    limit: L.Limit
    sort: L.Sort
    chain_root: L.LogicalPlan  # sort.child (per-row nodes over the scan)
    big: L.UnresolvedScan
    last_run: Optional[Dict[str, Any]] = None

    def execute(self, ctx: ChunkContext):
        from spark_tpu_torch.columnar.arrow import arrow_to_numpy
        from spark_tpu_torch.columnar.batch import round_capacity
        from spark_tpu_torch.physical.pipeline import (ChunkPipeline,
                                                       PipelineStats)

        conf, run_fn = ctx.conf, ctx.run
        chunk_rows = conf.get(CHUNK_ROWS)
        depth = conf.get(CF.PIPELINE_DEPTH)
        prefetch_budget = conf.get(CF.PREFETCH_BYTES_MAX)
        stats = PipelineStats()
        stager = _stager(ctx)
        k = self.limit.n + self.limit.offset
        counters = {"rows_in": 0}

        def merge_plan(state_rel, chunk_plan):
            child = chunk_plan if state_rel is None else L.Union(
                state_rel,
                L.Project(tuple(E.Col(n) for n in state_rel.schema.names),
                          chunk_plan))
            return L.Limit(k, L.Sort(self.sort.orders, child))

        fixed_cap = round_capacity(chunk_rows)
        state = _MergeState(merge_plan, run_fn)

        def prepare(tbl):
            counters["rows_in"] += tbl.num_rows
            if tbl.num_rows == 0:
                return None
            with stats.timed("decode"):
                sch, arrs, vlds = arrow_to_numpy(tbl)
            with stats.timed("transfer"):
                return stager.stage(sch, arrs, vlds,
                                    _chunk_capacity(tbl.num_rows, fixed_cap))

        pipe = ChunkPipeline(
            self.big.source.iter_batches(self.big.columns, self.big.filters,
                                         chunk_rows),
            prepare, depth=depth, byte_budget=prefetch_budget, stats=stats,
            conf=conf)
        try:
            for rel in pipe:
                with stats.timed("compute"):
                    state.feed(_splice(self.chain_root, {id(self.big): rel}))
        finally:
            pipe.close()
        _record(self, chunks=state.chunks, k=k, rows_in=counters["rows_in"],
                rows_kept=counters["rows_in"], pipeline_depth=depth,
                **stats.finish())

        source = L.Relation(state.batch) if state.batch is not None \
            else _splice(self.chain_root,
                         {id(self.big): _empty_rel(self.big, ctx.device)})
        return _finish(self.above, L.Limit(
            self.limit.n, L.Sort(self.sort.orders, source),
            offset=self.limit.offset), run_fn)


def find_chunkable(plan: L.LogicalPlan, conf):
    """The out-of-memory tier for an optimized plan whose scans exceed
    the device budget: a tier object (``execute_chunked`` runs it), or
    None to run the plan resident."""
    budget = conf.get(MAX_DEVICE_BATCH_BYTES)
    above, node = _peel_above(plan)

    if isinstance(node, L.Aggregate):
        return _find_agg(above, node, budget, conf)

    # top-k: Project* (Limit (Sort (per-row (big scan))))
    above2: List[L.LogicalPlan] = []
    n2 = plan
    while isinstance(n2, L.Project):
        above2.append(n2)
        n2 = n2.children()[0]
    if not isinstance(n2, L.Limit) or not isinstance(n2.child, L.Sort):
        return None
    lim, sort = n2, n2.child
    chain = node = sort.child
    while isinstance(node, (L.Filter, L.Project, L.SubqueryAlias)):
        node = node.children()[0]
    if not isinstance(node, L.UnresolvedScan):
        return None
    est = _est_scan(node)
    if est is None or est <= budget:
        return None
    if lim.n + lim.offset > conf.get(CHUNK_ROWS):
        return None  # the running state would itself exceed a chunk
    return _ChunkedTopK(above2, lim, sort, chain, node)


def _find_agg(above, agg: L.Aggregate, budget: int, conf):
    from spark_tpu_torch.analysis import legality

    if not legality.accumulators_verdict(agg.aggregates):
        return None  # an aggregate that does not merge: run it resident
    try:
        AggSpec(agg.groupings, agg.aggregates)
    except NotImplementedError:
        return None
    scans = L.collect_nodes(agg.child, L.UnresolvedScan)
    ests = []
    for s in scans:
        e = _est_scan(s)
        if e is None:
            return None
        ests.append(e)
    big = [(s, e) for s, e in zip(scans, ests) if e > budget]
    if not big:
        return None

    if len(big) == 1:
        scan = big[0][0]
        path = _stream_path(agg.child, scan)
        # every sidecar must itself fit the device budget
        if path is not None and all(
                sum(_est_scan(s) or (budget + 1)
                    for s in L.collect_nodes(pj.sidecar, L.UnresolvedScan))
                <= budget for pj in path):
            return _ChunkedAgg(above, agg, scan, path)

    if len(big) == 2:
        return _find_grace(above, agg, big[0][0], big[1][0],
                           big[0][1] + big[1][1], conf)
    return None


def _find_grace(above, agg: L.Aggregate, sa: L.UnresolvedScan,
                sb: L.UnresolvedScan, est_total: int, conf):
    """Tier 3's shape: one join under the aggregate separates the two big
    scans, with only per-row nodes between."""
    joins = [j for j in L.collect_nodes(agg.child, L.Join)
             if _contains(j.left, sa) != _contains(j.left, sb)]
    if len(joins) != 1:
        return None
    join = joins[0]
    if _contains(join.left, sb):
        sa, sb = sb, sa

    def per_row_to(root, target):
        n = root
        while n is not target:
            if not isinstance(n, (L.Filter, L.Project, L.SubqueryAlias)):
                return False
            n = n.children()[0]
        return True

    if not per_row_to(agg.child, join) or not per_row_to(join.left, sa) \
            or not per_row_to(join.right, sb):
        return None
    if len(join.left_keys) != 1 or join.how == "cross":
        return None
    ka = _resolve_to_scan_col(join.left_keys[0], join.left, sa)
    kb = _resolve_to_scan_col(join.right_keys[0], join.right, sb)
    if ka is None or kb is None:
        return None
    for scan, key in ((sa, ka), (sb, kb)):
        if not _integral_key(scan.schema.field(key).dtype):
            return None
    cls = _HybridHashJoinAgg if bool(conf.get(JOIN_HYBRID_ENABLED)) \
        else _GraceHashAgg
    return cls(above, agg, join, sa, sb, ka, kb, est_total)


def execute_chunked(found, conf, run_fn, device="cuda", manager=None):
    """Run a tier from ``find_chunkable``: ``run_fn(logical plan) ->
    Batch`` is the engine (plans it is given are optimized already),
    ``device`` where chunks go, ``manager`` the session's
    UnifiedMemoryManager. Every chunk, merge and sidecar runs with
    adaptive-stat recording off. The final device batch."""
    from spark_tpu_torch.physical.operators import stats_recording_disabled

    ctx = ChunkContext(conf, run_fn, torch.device(device), manager)
    with stats_recording_disabled():
        return found.execute(ctx)
