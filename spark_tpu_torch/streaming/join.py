"""Stream-stream joins (the port of ``spark_tpu/streaming/join.py``;
reference: sql/core/.../streaming/StreamingSymmetricHashJoinExec.scala,
a symmetric hash join with per-side watermark-bounded state, and
UnsupportedOperationChecker for the mode and type matrix).

The micro-batch form over the batch engine keeps every row seen so far
per side (trimmed by the watermark) and emits per trigger

    new_left  JOIN (right_state UNION new_right)
    UNION  left_state JOIN new_right

which covers old x new, new x old and new x new exactly once. The joins
are ordinary batch ``L.Join`` executions on the session's device (or
mesh). The state is one Arrow table per side per committed version,
written like a streaming aggregate's (``state.py``); the global
watermark is the smallest of the per-side watermarks (the reference's
WatermarkTracker policy for several sources), and rows below it leave
the state.

Supported: inner, left outer, right outer and full outer equi-joins in
append mode, with an optional extra condition. A preserved side tracks
matched bits and emits its unmatched rows padded with nulls when the
watermark evicts them; a full outer join tracks both sides and needs
watermarks on both."""

from __future__ import annotations

import itertools
from typing import List, Optional, Tuple

import pyarrow as pa
import pyarrow.compute as pc

from spark_tpu_torch.plan import logical as L
from spark_tpu_torch.streaming.execution import (StreamingSource, _Engine,
                                                 _splice, _Triggers)
from spark_tpu_torch.streaming.state import OffsetLog, StateStore

_qids = itertools.count()


def find_streaming_join(plan: L.LogicalPlan) -> Optional[L.Join]:
    """The Join of a two-source streaming query, or None. Stateless
    operators (Project, Filter, alias: the column-ordering Project of a
    USING join, say) may sit above it; they run again per emitted
    micro-batch."""
    sources = L.collect_nodes(plan, StreamingSource)
    if len(sources) != 2:
        return None
    node = plan
    while isinstance(node, (L.Project, L.Filter, L.SubqueryAlias)):
        node = node.children()[0]
    if not isinstance(node, L.Join):
        raise NotImplementedError(
            "stream-stream join supports only stateless operators "
            "(project/filter) above the join")
    left_srcs = L.collect_nodes(node.left, StreamingSource)
    right_srcs = L.collect_nodes(node.right, StreamingSource)
    if len(left_srcs) != 1 or len(right_srcs) != 1:
        raise NotImplementedError(
            "each join side must read exactly one streaming source")
    return node


class StreamStreamJoinQuery(_Triggers):
    """Runner of a two-source streaming join (the StreamingQuery surface:
    processAllAvailable, stop, is_active, name)."""

    def __init__(self, session, root: L.LogicalPlan, plan: L.Join,
                 sink_name: Optional[str],
                 output_mode: str = "append",
                 checkpoint_dir: Optional[str] = None):
        self._root = root
        if plan.how == "right":
            # a right outer join is the left outer join with the sides
            # swapped (the operators above, always a Project for a USING
            # join, run per batch and restore the columns' order)
            from spark_tpu_torch.expr import expressions as E

            lnames = set(plan.left.schema.names)
            rnames = set(plan.right.schema.names)
            if lnames & rnames and (root is plan
                                    or plan.condition is not None):
                raise NotImplementedError(
                    "right outer stream join with colliding column "
                    "names and no projection above: '#2' dedup names "
                    "shift under the side swap")
            orig = plan
            orig_names = plan.schema.names
            plan = L.Join(plan.right, plan.left, "left",
                          plan.right_keys, plan.left_keys,
                          plan.condition)
            if root is orig:
                # bare root: restore the right join's column order
                self._root = L.Project(
                    tuple(E.Col(n) for n in orig_names), plan)
        if plan.how not in ("inner", "left", "full"):
            raise NotImplementedError(
                f"stream-stream {plan.how} join: inner, left, right and "
                "full outer are supported")
        if plan.how in ("left", "full"):
            left_src = L.collect_nodes(plan.left, StreamingSource)[0]
            if left_src.watermark_col is None:
                raise NotImplementedError(
                    "outer stream-stream joins require a watermark "
                    "on the preserved side: null-padded results emit "
                    "when the watermark proves no match can arrive "
                    "(reference: StreamingSymmetricHashJoinExec "
                    "outer-join condition)")
        if plan.how == "full":
            right_src = L.collect_nodes(plan.right, StreamingSource)[0]
            if right_src.watermark_col is None:
                raise NotImplementedError(
                    "full outer stream-stream join requires watermarks "
                    "on BOTH sides (symmetric matched-bit eviction)")
        if output_mode not in ("append", "update"):
            raise NotImplementedError(
                "stream-stream joins support append mode only "
                "(reference: UnsupportedOperationChecker)")
        if not plan.left_keys:
            raise NotImplementedError(
                "stream-stream join requires equi-join keys (unbounded "
                "cross state otherwise)")
        self._session = session
        self._engine = _Engine(session)
        self._join = plan
        self.name = sink_name or f"stream{next(_qids)}"
        self._sides = (L.collect_nodes(plan.left, StreamingSource)[0],
                       L.collect_nodes(plan.right, StreamingSource)[0])
        self._subtrees = (plan.left, plan.right)
        preserved = {0: plan.how in ("left", "full"),
                     1: plan.how == "full"}
        for i in (0, 1):
            wc = self._sides[i].watermark_col
            if preserved[i] and wc is not None \
                    and wc not in self._subtrees[i].schema.names:
                raise NotImplementedError(
                    "outer stream-stream join: the preserved side's "
                    f"watermark column {wc!r} must survive to the join "
                    "(state eviction reads it — drop it above the join "
                    "instead)")
        self._log = OffsetLog(checkpoint_dir)
        self._store = StateStore(checkpoint_dir)
        self._batch_id = self._log.last_committed
        self._appended: List[pa.Table] = []
        self.trigger_log: List[dict] = []
        wm = self._log.last_watermark()
        # each side's largest event time, a pair in the commit log
        self._max_event: List[Optional[int]] = list(wm) if \
            isinstance(wm, (list, tuple)) else [None, None]
        self.is_active = True
        self._register_sink()

    def _side_rows(self, side: int, start: int, end: int) -> pa.Table:
        """A side's new source rows through its subtree (the projections
        and filters between the source and the join). The largest event
        time is taken on the raw rows: a projection may drop the
        watermark column before the join, and the watermark still
        advances (reference: EventTimeWatermarkExec sits at the
        source)."""
        src = self._sides[side]
        raw = src.source.get_batch(start, end)
        wm_col = src.watermark_col
        if wm_col and raw.num_rows > 0 and wm_col in raw.column_names:
            mx = pc.max(raw.column(wm_col)).as_py()
            if mx is not None:
                mx = int(mx)
                if self._max_event[side] is None \
                        or mx > self._max_event[side]:
                    self._max_event[side] = mx
        subtree = self._subtrees[side]
        if isinstance(subtree, StreamingSource):
            return raw
        return self._engine.to_arrow(
            _splice(subtree, self._engine.relation(raw)))

    # -- trigger loop ---------------------------------------------------------

    def process_all_available(self) -> None:
        while True:
            batch_id = self._batch_id + 1
            logged = self._log.offsets_for(batch_id)
            if logged is not None:
                starts, ends = logged["start"], logged["end"]
            else:
                prev = self._log.offsets_for(self._batch_id)
                starts = prev["end"] if prev else [0, 0]
                ends = [self._sides[0].source.latest_offset(),
                        self._sides[1].source.latest_offset()]
                if ends[0] <= starts[0] and ends[1] <= starts[1]:
                    return
                self._log.log_offsets(batch_id,
                                      {"start": starts, "end": ends})
            self._run_logged(batch_id, starts, ends)

    processAllAvailable = process_all_available

    def _run_batch(self, batch_id: int, starts, ends) -> None:
        new = [self._side_rows(i, starts[i], ends[i]) for i in (0, 1)]
        state = self._load_state(self._batch_id)
        # the preserved sides (emit null-padded when unmatched): a left
        # outer join tracks side 0, a full outer join both (reference:
        # SymmetricHashJoinStateManager's KeyWithIndexToValue)
        track = {0: self._join.how in ("left", "full"),
                 1: self._join.how == "full"}
        tag = {0: "__lid", 1: "__rid"}
        flag = {0: "__matched", 1: "__matched_r"}
        for i in (0, 1):
            if track[i]:
                n = new[i].num_rows
                tagged = new[i].append_column(tag[i], pa.array(
                    [(batch_id << 32) + j for j in range(n)], pa.int64()))
                new[i] = tagged.append_column(
                    flag[i], pa.array([False] * n, pa.bool_()))

        out_parts = []
        matched: dict = {0: set(), 1: set()}
        right_all = pa.concat_tables([state[1], new[1]]) \
            if state[1].num_rows else new[1]
        joinables = []
        if new[0].num_rows and right_all.num_rows:
            joinables.append((new[0], right_all))
        if state[0].num_rows and new[1].num_rows:
            joinables.append((state[0], new[1]))
        for lt, rt in joinables:
            if track[0]:
                lt = lt.drop_columns([flag[0]])
            if track[1]:
                rt = rt.drop_columns([flag[1]])
            joined = self._join_tables(lt, rt)
            for i in (0, 1):
                if track[i]:
                    matched[i] |= set(
                        joined.column(tag[i]).to_pylist())
                    joined = joined.drop_columns([tag[i]])
            out_parts.append(joined)
        out_parts = [self._apply_above(t) for t in out_parts]

        # grow the state; flip the matched bits
        new_state = [
            pa.concat_tables([state[i], new[i]])
            if state[i].num_rows else new[i]
            for i in (0, 1)
        ]
        for i in (0, 1):
            if track[i] and matched[i] and new_state[i].num_rows:
                ids = new_state[i].column(tag[i]).to_pylist()
                flags = new_state[i].column(flag[i]).to_pylist()
                flags = [f or (x in matched[i])
                         for f, x in zip(flags, ids)]
                idx = new_state[i].schema.get_field_index(flag[i])
                new_state[i] = new_state[i].set_column(
                    idx, flag[i], pa.array(flags, pa.bool_()))

        # trim the state by the watermark; evicted unmatched rows of a
        # preserved side emit null-padded (the watermark proves that no
        # later row can match them)
        wm = self._watermark()
        if wm is not None:
            for i in (0, 1):
                wm_col = self._sides[i].watermark_col
                if wm_col and new_state[i].num_rows > 0 \
                        and wm_col in new_state[i].column_names:
                    keep = pc.greater_equal(
                        new_state[i].column(wm_col), pa.scalar(wm))
                    if track[i]:
                        evicted = new_state[i].filter(pc.invert(keep))
                        unmatched = evicted.filter(
                            pc.invert(evicted.column(flag[i])))
                        if unmatched.num_rows:
                            out_parts.append(self._apply_above(
                                self._null_padded(unmatched, side=i)))
                    new_state[i] = new_state[i].filter(keep)

        self._commit_state(batch_id, new_state)
        self._log.commit(batch_id, watermark=self._max_event)
        self._batch_id = batch_id
        for t in out_parts:
            if t.num_rows:
                self._appended.append(t)
        self._register_sink()

    def _null_padded(self, rows: pa.Table, side: int = 0) -> pa.Table:
        """Unmatched rows of a preserved side in the join's output shape:
        that side's columns and all-null columns for the other side."""
        from spark_tpu_torch.io.datasource import _pa_schema_from_schema

        clean = rows.drop_columns(
            [c for c in ("__lid", "__matched", "__rid", "__matched_r")
             if c in rows.column_names])
        n = clean.num_rows
        out_schema = _pa_schema_from_schema(self._join.schema)
        # join output = left fields then right fields (dedup-renamed):
        # this side's columns map by position into its region
        ln = len(self._subtrees[0].schema.names)
        arrays = []
        for pos, f in enumerate(out_schema):
            src = None
            if side == 0 and pos < ln:
                src = self._subtrees[0].schema.names[pos]
            elif side == 1 and pos >= ln:
                src = self._subtrees[1].schema.names[pos - ln]
            if src is not None and src in clean.column_names:
                arrays.append(clean.column(src).cast(f.type))
            else:
                arrays.append(pa.nulls(n, f.type))
        return pa.Table.from_arrays(arrays, schema=out_schema)

    def _watermark(self) -> Optional[int]:
        """The smallest of the per-side watermarks (a row may still meet
        a match from the slower side, so the faster side cannot evict
        past it)."""
        wms = []
        for i in (0, 1):
            if self._sides[i].watermark_col is not None:
                if self._max_event[i] is None:
                    return None
                wms.append(self._max_event[i]
                           - self._sides[i].watermark_delay)
        return min(wms) if wms else None

    def _join_tables(self, left: pa.Table, right: pa.Table) -> pa.Table:
        j = L.Join(self._engine.relation(left),
                   self._engine.relation(right),
                   "inner", self._join.left_keys, self._join.right_keys,
                   self._join.condition)
        return self._engine.to_arrow(j)

    def _apply_above(self, joined: pa.Table) -> pa.Table:
        """Run the stateless operators above the join (the USING
        Project, filters after the join) on one emitted batch."""
        if self._root is self._join:
            return joined
        rel = self._engine.relation(joined)

        # transform_up rebuilds the ancestors, so identity matching
        # fails; the tree holds exactly one Join (find_streaming_join)
        def fn(p):
            return rel if isinstance(p, L.Join) else p

        return self._engine.to_arrow(self._root.transform_up(fn))

    # -- state layout: one table per side, tagged columns --------------------

    def _load_state(self, version: int) -> Tuple[pa.Table, pa.Table]:
        empty = (self._empty_side(0), self._empty_side(1))
        tbl = self._store.get(version)
        if tbl is None or tbl.num_rows == 0 or "__side" not in \
                tbl.column_names:
            return empty
        out = []
        for i in (0, 1):
            part = tbl.filter(pc.equal(tbl.column("__side"), i))
            names = [n for n in part.column_names
                     if n.startswith(f"s{i}_")]
            out.append(pa.table({n[3:]: part.column(n) for n in names}))
        return tuple(out)  # type: ignore[return-value]

    def _empty_side(self, i: int) -> pa.Table:
        from spark_tpu_torch.io.datasource import _pa_schema_from_schema

        schema = _pa_schema_from_schema(self._subtrees[i].schema)
        return pa.Table.from_arrays(
            [pa.array([], f.type) for f in schema], schema=schema)

    def _commit_state(self, version: int,
                      sides: List[pa.Table]) -> None:
        """Pack both sides into one table (prefixed columns and a
        ``__side`` tag) so the versioned snapshots apply unchanged."""
        parts = []
        for i, side in enumerate(sides):
            n = side.num_rows
            cols = {"__side": pa.array([i] * n, pa.int8())}
            for name in side.column_names:
                cols[f"s{i}_{name}"] = side.column(name)
            parts.append(cols)
        # the union of the columns, nulls on the other side
        all_names: List[str] = ["__side"]
        for i, side in enumerate(sides):
            all_names += [f"s{i}_{n}" for n in side.column_names]
        arrays = {}
        for name in all_names:
            chunks = []
            for i, cols in enumerate(parts):
                n = sides[i].num_rows
                if name in cols:
                    chunks.append(cols[name])
                else:
                    typ = None
                    for c2 in parts:
                        if name in c2:
                            a = c2[name]
                            typ = a.type if isinstance(a, pa.Array) \
                                else a.chunk(0).type if a.num_chunks \
                                else pa.null()
                            break
                    chunks.append(pa.nulls(n, typ or pa.null()))
            arrays[name] = pa.concat_arrays(
                [c.combine_chunks() if isinstance(c, pa.ChunkedArray)
                 else c for c in chunks])
        self._store.commit(version, pa.table(arrays))

    # -- sink -----------------------------------------------------------------

    def _current_result(self) -> pa.Table:
        if self._appended:
            return pa.concat_tables(self._appended)
        return pa.Table.from_arrays(
            [pa.array([], f.type) for f in self._result_schema()],
            schema=self._result_schema())

    def _result_schema(self) -> pa.Schema:
        from spark_tpu_torch.io.datasource import _pa_schema_from_schema

        return _pa_schema_from_schema(self._root.schema)

    def _register_sink(self) -> None:
        tbl = self._current_result()
        if tbl.num_columns == 0:
            return
        self._session.catalog._register_view(
            self.name, self._engine.relation(tbl))

    def stop(self) -> None:
        self.is_active = False
