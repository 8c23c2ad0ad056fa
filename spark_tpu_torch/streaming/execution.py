"""Micro-batch incremental execution (the port of
``spark_tpu/streaming/execution.py``; reference:
sql/core/.../execution/streaming/MicroBatchExecution.scala:41
runActivatedStream:234 constructNextBatch:475 runBatch:579,
IncrementalExecution.scala:43, WatermarkTracker.scala).

Each trigger logs the new source offsets to the write-ahead log, splices
the new rows into the logical plan as a ``Relation`` on the session's
device, and runs ordinary batch executions: (a) the new rows' partial
aggregates and (b) their merge with the previous state version over a
union. Both run on the session's engine (one device, or the mesh under
``master("mesh[N]")``) and so through the hand kernels of
``ops/seg_agg.py`` on the card. Then the state and the offsets commit.
Aggregates are incrementalized by accumulator decomposition
(``plan/incremental.AggSpec``: sum, count, min and max merge; avg is a
sum and a count).

Each micro-batch is a plan's first run: its leaves are new tensors, and
the planner keys its runtime statistics on the leaves
(``physical/planner.py``), so a micro-batch runs its stages eagerly and
captures no CUDA graph. ``trigger_log`` keeps each trigger's wall, its
host Arrow time (the copies between the device and Arrow, the state's
concatenation and re-encoding) and its planner runs.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass
from typing import List, Optional

import pyarrow as pa
import pyarrow.compute as pc

from spark_tpu_torch import faults, metrics
from spark_tpu_torch.expr import expressions as E
from spark_tpu_torch.plan import logical as L
from spark_tpu_torch.plan.incremental import AggSpec
from spark_tpu_torch.streaming.state import OffsetLog, StateStore

_qids = itertools.count()


@dataclass(eq=False, frozen=True)
class StreamingSource(L.LogicalPlan):
    """Leaf marker for a streaming source; replaced per micro-batch by a
    Relation over the new rows (reference: StreamingExecutionRelation)."""

    source: object  # MemoryStream / RateStreamSource
    watermark_col: Optional[str] = None
    watermark_delay: int = 0  # in the event-time column's units

    @property
    def schema(self):
        return self.source.schema

    def node_string(self):
        return f"StreamingSource[{getattr(self.source, 'name', '?')}]"


def _find_source(plan: L.LogicalPlan) -> StreamingSource:
    found = L.collect_nodes(plan, StreamingSource)
    if len(found) != 1:
        raise NotImplementedError(
            f"exactly one streaming source supported, got {len(found)}")
    return found[0]


def _splice(plan: L.LogicalPlan, replacement: L.LogicalPlan):
    def fn(p):
        if isinstance(p, StreamingSource):
            return replacement
        return p

    return plan.transform_up(fn)


class _Engine:
    """The batch engine a streaming runner drives: the session's mesh
    executor, else the planner on the session's device; Arrow tables in
    and out, the host time of the conversions summed in ``arrow_ms``."""

    def __init__(self, session):
        self._session = session
        self.arrow_ms = 0.0

    def run(self, plan: L.LogicalPlan):
        ex = getattr(self._session, "mesh_executor", None)
        if ex is not None:
            return ex.execute_logical(plan)
        from spark_tpu_torch.physical.planner import execute_logical

        return execute_logical(plan, device=self._session.device,
                               conf=self._session.conf)

    def relation(self, tbl: pa.Table) -> L.Relation:
        from spark_tpu_torch.columnar.arrow import from_arrow

        t0 = time.perf_counter()
        batch = from_arrow(tbl, device=self._session.device)
        self.arrow_ms += (time.perf_counter() - t0) * 1e3
        return L.Relation(batch)

    def to_arrow(self, plan: L.LogicalPlan) -> pa.Table:
        from spark_tpu_torch.columnar.arrow import to_arrow

        batch = self.run(plan)
        t0 = time.perf_counter()
        out = to_arrow(batch)
        self.arrow_ms += (time.perf_counter() - t0) * 1e3
        return out


class _Triggers:
    """The trigger loop and its log, shared by the three runners."""

    def _run_logged(self, batch_id: int, start, end) -> None:
        from spark_tpu_torch.physical import planner

        runs: list = []
        self._engine.arrow_ms = 0.0
        t0 = time.perf_counter()
        with planner.recording_runs(runs):
            self._run_batch(batch_id, start, end)
        self.trigger_log.append({
            "batch": batch_id,
            "wall_ms": (time.perf_counter() - t0) * 1e3,
            "arrow_ms": self._engine.arrow_ms,
            "runs": len(runs),
            "captured": sum(r.captured for r in runs),
            "replayed": sum(r.replayed for r in runs)})


class StreamingQuery(_Triggers):
    """One running (manually triggered) streaming query (reference:
    StreamExecution, StreamingQuery)."""

    def __init__(self, session, plan: L.LogicalPlan, sink_name: str,
                 output_mode: str = "complete",
                 checkpoint_dir: Optional[str] = None):
        self._session = session
        self._engine = _Engine(session)
        self._plan = plan
        self.name = sink_name or f"stream{next(_qids)}"
        self.output_mode = output_mode
        self._src_node = _find_source(plan)
        self._source = self._src_node.source
        self._log = OffsetLog(checkpoint_dir)
        self._store = StateStore(checkpoint_dir)
        self._batch_id = self._log.last_committed
        self._appended: List[pa.Table] = []
        self.trigger_log: List[dict] = []
        #: restored from the commit log, so the watermark survives a
        #: restart
        self._max_event_time: Optional[int] = self._log.last_watermark()
        self._agg = self._split_plan()
        if self._agg is not None and output_mode == "update":
            raise NotImplementedError(
                "outputMode('update') with aggregation: use 'complete' "
                "or 'append' (with a watermark)")
        if self._agg is not None and output_mode == "append":
            wm_col = self._src_node.watermark_col
            has_time_key = wm_col is not None and any(
                wm_col in g.references() for g in self._agg.groupings)
            if not has_time_key:
                raise NotImplementedError(
                    "append-mode streaming aggregation requires a "
                    "watermark and an event-time grouping key "
                    "(reference: UnsupportedOperationChecker)")
        self._register_sink()
        self.is_active = True

    # -- plan surgery ---------------------------------------------------------

    def _split_plan(self) -> Optional[AggSpec]:
        """The (single) streaming Aggregate's decomposition, None for a
        stateless query; the aggregate must be the plan's root."""
        aggs = L.collect_nodes(self._plan, L.Aggregate)
        if not aggs:
            return None
        if len(aggs) > 1:
            raise NotImplementedError(
                "multiple aggregations in one streaming query")
        agg = aggs[0]
        if agg is not self._plan:
            # operators above the aggregate are not incrementalized;
            # refusing beats dropping them silently
            raise NotImplementedError(
                "operators above a streaming aggregation are not "
                "supported; aggregate must be the query root")
        self._below = agg.child
        return AggSpec(agg.groupings, agg.aggregates)

    # -- execution ------------------------------------------------------------

    def process_all_available(self) -> None:
        """Drain the source (Trigger.AvailableNow)."""
        while True:
            latest = self._source.latest_offset()
            batch_id = self._batch_id + 1
            logged = self._log.offsets_for(batch_id)
            if logged is not None:
                # offsets logged but never committed (a crash between
                # the log and the commit): replay the same range
                start, end = logged["start"], logged["end"]
                metrics.record("fault_recovered", point="streaming.commit",
                               how="wal_replay", batch=batch_id)
            else:
                prev = self._log.offsets_for(self._batch_id)
                start = prev["end"] if prev else 0
                end = latest
                if end <= start:
                    return
                self._log.log_offsets(batch_id, {"start": start,
                                                 "end": end})
            self._run_logged(batch_id, start, end)

    processAllAvailable = process_all_available

    def _publish_delta(self, batch_id: int, new_rows) -> None:
        """Hand the micro-batch's (late-filtered) rows to the
        materialized-view manager before the WAL commit: a crash between
        the two replays the same batch id, which the manager's batch-id
        watermark drops, so subscribed views never merge twice nor miss
        a committed batch. A view merge that fails past its retries
        raises from here and the batch stays uncommitted."""
        mgr = getattr(self._session, "mview_manager", None)
        if mgr is not None:
            mgr.on_micro_batch(self.name, batch_id, new_rows)

    def _run_batch(self, batch_id: int, start: int, end: int) -> None:
        eng = self._engine
        new_rows = self._source.get_batch(start, end)
        wm_col = self._src_node.watermark_col
        wm_before = self._watermark()
        if wm_col is not None and wm_before is not None \
                and new_rows.num_rows > 0 \
                and wm_col in new_rows.column_names:
            # rows older than the watermark are late and dropped before
            # any state update (reference: EventTimeWatermark), else an
            # emitted window could reopen
            new_rows = new_rows.filter(
                pc.greater_equal(new_rows.column(wm_col),
                                 pa.scalar(wm_before)))
        rel = eng.relation(new_rows)

        if self._agg is None:
            out = eng.to_arrow(_splice(self._plan, rel))
            self._publish_delta(batch_id, new_rows)
            faults.inject("streaming.commit", self._session.conf)
            self._store.commit(batch_id, pa.table({}))
            self._log.commit(batch_id)
            # appended only after the commit, so a commit crash and the
            # WAL replay cannot duplicate sink rows
            self._appended.append(out)
            self._batch_id = batch_id
            self._register_sink()
            return

        spec = self._agg
        batch_child = _splice(self._below, rel)
        key_aliases = tuple(E.Alias(g, n) for g, n
                            in zip(spec.groupings_exec, spec.key_names))
        partial_outs = key_aliases + tuple(spec.partials)
        if spec.session_idx is not None:
            # a provisional session ends at max(event) + gap per
            # provisional key (which is the event time: end = key + gap)
            ev = spec.groupings[spec.session_idx].child
            partial_outs = partial_outs + (E.Alias(
                E.Max(E.Arith("+", ev, E.Literal(spec.session_gap))),
                "__send"),)
        partial = L.Aggregate(
            tuple(spec.groupings_exec), partial_outs, batch_child)
        partial_tbl = eng.to_arrow(partial)

        prev = self._store.get(self._batch_id)
        t0 = time.perf_counter()
        if prev is not None and prev.num_rows > 0:
            merged_in = pa.concat_tables(
                [prev, partial_tbl.select(prev.column_names)])
        else:
            merged_in = partial_tbl
        eng.arrow_ms += (time.perf_counter() - t0) * 1e3
        mrel = eng.relation(merged_in)
        keys = tuple(E.Col(n) for n in spec.key_names)
        merge_outs = tuple(E.Alias(E.Col(n), n)
                           for n in spec.key_names) + tuple(spec.merges)
        if spec.session_idx is not None:
            merge_outs = merge_outs + (E.Alias(
                E.Max(E.Col("__send")), "__send"),)
        state_tbl = eng.to_arrow(L.Aggregate(keys, merge_outs, mrel))
        if spec.session_idx is not None and state_tbl.num_rows > 0:
            state_tbl = self._merge_sessions(state_tbl)

        # the watermark follows the new rows' largest event time
        emitted: Optional[pa.Table] = None
        if wm_col is not None and new_rows.num_rows > 0 \
                and wm_col in new_rows.column_names:
            mx = pc.max(new_rows.column(wm_col)).as_py()
            if mx is not None:
                mx = int(mx)
                if self._max_event_time is None \
                        or mx > self._max_event_time:
                    self._max_event_time = mx
        if self.output_mode == "append":
            state_tbl, emitted = self._evict_closed(state_tbl)

        self._publish_delta(batch_id, new_rows)
        faults.inject("streaming.commit", self._session.conf)
        self._store.commit(batch_id, state_tbl)
        self._log.commit(batch_id, watermark=self._max_event_time)
        self._batch_id = batch_id
        if emitted is not None and emitted.num_rows > 0:
            self._appended.append(self._finalize(emitted))
        self._register_sink()

    def _merge_sessions(self, state_tbl: pa.Table) -> pa.Table:
        """Merge overlapping or adjacent provisional sessions per key
        (reference: MergingSessionsExec): sorted by (keys, start), a
        session chains onto the previous one while its start is at most
        the running largest end; the chained groups re-aggregate through
        the same merge accumulators, start = min(start), end =
        max(end)."""
        spec = self._agg
        skey = spec.key_names[spec.session_idx]
        other = [n for i, n in enumerate(spec.key_names)
                 if i != spec.session_idx]
        df = state_tbl.to_pandas()
        df = df.sort_values(other + [skey], kind="mergesort",
                            na_position="first").reset_index(drop=True)
        if other:
            grp = df.groupby(other, dropna=False, sort=False)
            prev_end = grp["__send"].cummax().shift(1)
            new_key = grp.cumcount() == 0
        else:
            prev_end = df["__send"].cummax().shift(1)
            new_key = df.index == 0
        head = new_key | (df[skey] > prev_end)
        df["__sid"] = head.cumsum()
        rel = self._engine.relation(pa.Table.from_pandas(
            df, preserve_index=False))
        keys2 = tuple(E.Col(n) for n in other) + (E.Col("__sid"),)
        outs = (tuple(E.Alias(E.Col(n), n) for n in other)
                + (E.Alias(E.Min(E.Col(skey)), skey),)
                + tuple(spec.merges)
                + (E.Alias(E.Max(E.Col("__send")), "__send"),))
        out = self._engine.to_arrow(L.Aggregate(keys2, outs, rel))
        # the state's column order (the next batch's concat selects by
        # the previous state's names)
        return out.select(state_tbl.column_names)

    def _watermark(self) -> Optional[int]:
        if self._max_event_time is None:
            return None
        return self._max_event_time - self._src_node.watermark_delay

    def _evict_closed(self, state: pa.Table):
        """Append mode: groups whose event-time key lies wholly below the
        watermark can no longer change; they are emitted and dropped
        (reference: statefulOperators.scala, StateStoreSaveExec)."""
        wm = self._watermark()
        if wm is None or state.num_rows == 0:
            return state, None
        spec = self._agg
        idx = None
        for i, g in enumerate(spec.groupings):
            if self._src_node.watermark_col in g.references():
                idx = i
                break
        if idx is None:
            return state, None
        if spec.session_idx is not None:
            # a session closes when the watermark passes its end
            closed = pc.less_equal(state.column("__send"), pa.scalar(wm))
            return state.filter(pc.invert(closed)), state.filter(closed)
        key = state.column(spec.key_names[idx])
        width = spec.window_widths[idx]
        if width is not None:
            # a window [start, start + width) closes when the watermark
            # passes its end
            closed = pc.less_equal(pc.add(key, pa.scalar(width)),
                                   pa.scalar(wm))
        else:
            closed = pc.less(key, pa.scalar(wm))
        return state.filter(pc.invert(closed)), state.filter(closed)

    def _finalize(self, state_tbl: pa.Table) -> pa.Table:
        spec = self._agg
        return self._engine.to_arrow(L.Project(
            tuple(spec.outputs), self._engine.relation(state_tbl)))

    # -- sink -----------------------------------------------------------------

    def _current_result(self) -> pa.Table:
        if self._agg is None or self.output_mode == "append":
            if self._appended:
                return pa.concat_tables(self._appended)
            state = self._store.get(self._batch_id)
            if self._agg is not None and state is not None:
                return self._finalize(state.slice(0, 0))
            return pa.table({})
        state = self._store.get(self._batch_id)
        if state is None or state.num_rows == 0:
            return pa.table({})
        return self._finalize(state)

    def _register_sink(self) -> None:
        """Memory sink: the result is a temp view named after the query
        (reference: memory.scala MemorySink)."""
        tbl = self._current_result()
        if tbl.num_columns == 0:
            return
        self._session.catalog._register_view(
            self.name, self._engine.relation(tbl))

    def stop(self) -> None:
        self.is_active = False
