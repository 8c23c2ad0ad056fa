"""Arbitrary stateful per-group streaming: applyInPandasWithState /
flatMapGroupsWithState (the port of ``spark_tpu/streaming/groups.py``;
reference: sql/core/.../streaming/FlatMapGroupsWithStateExec.scala and
python/pyspark/sql/pandas/group_ops.py).

Host-side by nature: the user function is arbitrary Python over pandas
frames, as on the reference's Python worker path. Per micro-batch the
plan below the operator (filters, projections, joins) runs on the
session's device, the new rows are grouped on the host, each group's
saved state is restored, the user function runs, and the updated states
commit with the same versioned snapshot and commit protocol as a
streaming aggregate (``state.py``). A state is pickled whole, in the
reference's tagged layout, so either package reads the other's
checkpoint of the same function."""

from __future__ import annotations

import itertools
import pickle
import time as _time
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import pyarrow as pa

from spark_tpu_torch.plan import logical as L
from spark_tpu_torch.streaming.execution import (StreamingSource, _Engine,
                                                 _splice, _Triggers)
from spark_tpu_torch.streaming.state import OffsetLog, StateStore

_qids = itertools.count()


class GroupState:
    """Per-key mutable state handle (reference: GroupState.scala).
    ``setTimeoutDuration(ms)`` arms a processing-time timeout: when no
    new rows arrive for the key before the deadline, the user function
    is called once with an empty frame and ``hasTimedOut`` True
    (reference: FlatMapGroupsWithStateExec.scala:373)."""

    def __init__(self, value=None, exists: bool = False,
                 deadline_ms: Optional[int] = None,
                 has_timed_out: bool = False):
        self._value = value
        self._exists = exists
        self._removed = False
        self._updated = False
        self._deadline_ms = deadline_ms
        self._has_timed_out = has_timed_out
        self._now_ms: Optional[int] = None  # set by the runner

    @property
    def hasTimedOut(self) -> bool:  # noqa: N802 (pyspark surface)
        return self._has_timed_out

    def setTimeoutDuration(self, duration_ms: int) -> None:  # noqa: N802
        if self._now_ms is None:
            raise ValueError(
                "timeouts require timeoutConf='ProcessingTimeTimeout'")
        self._deadline_ms = self._now_ms + int(duration_ms)

    @property
    def exists(self) -> bool:
        return self._exists and not self._removed

    def get(self):
        if not self.exists:
            raise ValueError("state does not exist; check state.exists")
        return self._value

    def getOption(self):
        return self._value if self.exists else None

    def update(self, value) -> None:
        self._value = value
        self._exists = True
        self._removed = False
        self._updated = True

    def remove(self) -> None:
        self._removed = True
        self._updated = True


@dataclass(eq=False, frozen=True)
class FlatMapGroupsWithState(L.LogicalPlan):
    """Logical marker; only the streaming runner executes it."""

    keys: Tuple[str, ...]
    func: Callable  # func(key_tuple, pandas.DataFrame, GroupState) -> pdf
    out_schema: object
    child: L.LogicalPlan
    timeout_conf: str = "NoTimeout"

    def children(self):
        return (self.child,)

    @property
    def schema(self):
        return self.out_schema

    def node_string(self):
        return f"FlatMapGroupsWithState[keys={list(self.keys)}]"


class GroupStateQuery(_Triggers):
    """Streaming runner for a FlatMapGroupsWithState root (the
    StreamingQuery surface: processAllAvailable, stop, is_active,
    name)."""

    def __init__(self, session, plan: FlatMapGroupsWithState,
                 sink_name: Optional[str], output_mode: str = "append",
                 checkpoint_dir: Optional[str] = None):
        if output_mode not in ("append", "update"):
            raise NotImplementedError(
                "flatMapGroupsWithState supports append/update output")
        self._session = session
        self._engine = _Engine(session)
        self._node = plan
        self.name = sink_name or f"stream{next(_qids)}"
        srcs = L.collect_nodes(plan, StreamingSource)
        if len(srcs) != 1:
            raise NotImplementedError(
                "exactly one streaming source per stateful-group query")
        self._src = srcs[0]
        self._log = OffsetLog(checkpoint_dir)
        self._store = StateStore(checkpoint_dir)
        self._batch_id = self._log.last_committed
        self._appended: List[pa.Table] = []
        self.trigger_log: List[dict] = []
        self.is_active = True
        self._register_sink()

    def process_all_available(self) -> None:
        while True:
            batch_id = self._batch_id + 1
            logged = self._log.offsets_for(batch_id)
            if logged is not None:
                start, end = logged["start"], logged["end"]
            else:
                prev = self._log.offsets_for(self._batch_id)
                start = prev["end"] if prev else 0
                end = self._src.source.latest_offset()
                if end <= start:
                    return
                self._log.log_offsets(batch_id,
                                      {"start": start, "end": end})
            self._run_logged(batch_id, start, end)

    processAllAvailable = process_all_available

    def _run_batch(self, batch_id: int, start: int, end: int) -> None:
        raw = self._src.source.get_batch(start, end)
        below = self._node.child
        if isinstance(below, StreamingSource):
            tbl = raw
        else:
            tbl = self._engine.to_arrow(
                _splice(below, self._engine.relation(raw)))
        pdf = tbl.to_pandas()

        states = self._load_states(self._batch_id)
        timeouts_on = self._node.timeout_conf == "ProcessingTimeTimeout"
        now_ms = int(_time.time() * 1000)
        out_frames = []
        keys = list(self._node.keys)
        seen: set = set()
        if len(pdf):
            for key_vals, group in pdf.groupby(keys, dropna=False):
                kt = key_vals if isinstance(key_vals, tuple) \
                    else (key_vals,)
                st = states.get(kt, GroupState())
                if timeouts_on:
                    st._now_ms = now_ms
                    st._deadline_ms = None  # re-armed explicitly per call
                st._has_timed_out = False
                result = self._node.func(kt, group, st)
                states[kt] = st
                seen.add(kt)
                if result is not None and len(result):
                    out_frames.append(result)
        if timeouts_on:
            # an expired group without new rows fires once, with an
            # empty frame and hasTimedOut (reference:
            # FlatMapGroupsWithStateExec.scala:373)
            import pandas as _pd

            empty_pdf = (pdf.iloc[0:0] if len(pdf.columns)
                         else _pd.DataFrame())
            for kt, st in list(states.items()):
                if kt in seen or not st.exists:
                    continue
                if st._deadline_ms is not None \
                        and st._deadline_ms <= now_ms:
                    st._now_ms = now_ms
                    st._has_timed_out = True
                    st._deadline_ms = None
                    result = self._node.func(kt, empty_pdf, st)
                    st._has_timed_out = False
                    if result is not None and len(result):
                        out_frames.append(result)
        states = {k: s for k, s in states.items() if s.exists}
        self._commit_states(batch_id, states)
        self._log.commit(batch_id)
        self._batch_id = batch_id
        for f in out_frames:
            self._appended.append(pa.Table.from_pandas(
                f, preserve_index=False))
        self._register_sink()

    # -- state layout: key tuple and a pickled, versioned payload ------------
    #
    # The payload is a tagged dict ({_STATE_TAG: <format version>, ...}),
    # not a bare (value, deadline) tuple: shape-sniffing breaks once a
    # user's state is itself a 2-tuple. The older layouts (an untagged
    # (value, deadline) tuple, and a bare value before it) still load.

    _STATE_TAG = "__group_state__"
    _STATE_VERSION = 1

    def _load_states(self, version: int) -> dict:
        tbl = self._store.get(version)
        out: dict = {}
        if tbl is None or tbl.num_rows == 0:
            return out
        key_bin = tbl.column("__key").to_pylist()
        val_bin = tbl.column("__state").to_pylist()
        for kb, vb in zip(key_bin, val_bin):
            payload = pickle.loads(vb)
            if isinstance(payload, dict) and self._STATE_TAG in payload:
                ver = payload[self._STATE_TAG]
                if ver > self._STATE_VERSION:
                    raise ValueError(
                        f"group-state checkpoint format v{ver} is newer "
                        f"than this engine supports "
                        f"(v{self._STATE_VERSION})")
                value = payload["value"]
                deadline = payload.get("deadline_ms")
            elif isinstance(payload, tuple) and len(payload) == 2:
                value, deadline = payload  # older (value, deadline)
            else:  # the layout before timeouts: a bare value
                value, deadline = payload, None
            out[pickle.loads(kb)] = GroupState(value, True,
                                               deadline_ms=deadline)
        return out

    def _commit_states(self, version: int, states: dict) -> None:
        keys = [pickle.dumps(k) for k in states]
        vals = [pickle.dumps({self._STATE_TAG: self._STATE_VERSION,
                              "value": s.getOption(),
                              "deadline_ms": s._deadline_ms})
                for s in states.values()]
        self._store.commit(version, pa.table({
            "__key": pa.array(keys, pa.binary()),
            "__state": pa.array(vals, pa.binary())}))

    # -- sink -----------------------------------------------------------------

    def _register_sink(self) -> None:
        from spark_tpu_torch.io.datasource import _pa_schema_from_schema

        if self._appended:
            tbl = pa.concat_tables(self._appended)
        else:
            schema = _pa_schema_from_schema(self._node.out_schema)
            tbl = pa.Table.from_arrays(
                [pa.array([], f.type) for f in schema], schema=schema)
        if tbl.num_columns == 0:
            return
        self._session.catalog._register_view(
            self.name, self._engine.relation(tbl))

    def stop(self) -> None:
        self.is_active = False
