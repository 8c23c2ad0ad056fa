"""Streaming sources (the port of ``spark_tpu/streaming/sources.py``;
reference: sql/core/.../execution/streaming/memory.scala:42 MemoryStream,
sources/RateStreamProvider.scala).

A source has monotonically increasing integer offsets; the engine reads
half-open offset ranges ``[start, end)`` of its appended parts, so every
row runs exactly once per committed batch. Rows stay on the host as
Arrow tables until a trigger copies them to the session's device."""

from __future__ import annotations

import itertools
import time
from typing import List

import pyarrow as pa

from spark_tpu_torch import locks
from spark_tpu_torch.types import Schema

_ids = itertools.count()


class MemoryStream:
    """In-memory source for deterministic tests and scripts (the
    StreamTest pattern, reference: StreamTest.scala:342). Each
    ``add_data`` call is one offset."""

    def __init__(self, schema_or_example):
        if isinstance(schema_or_example, pa.Table):
            self._example = schema_or_example.schema
        else:
            self._example = schema_or_example
        self._rows: List[pa.Table] = []
        self._lock = locks.named_lock("streaming.source")
        self.name = f"memory-{next(_ids)}"

    # -- producer side --------------------------------------------------------

    def add_data(self, data) -> int:
        """Append rows (an Arrow table, a pandas DataFrame or a list of
        dicts); returns the new latest offset."""
        if isinstance(data, pa.Table):
            tbl = data
        elif type(data).__module__.startswith("pandas"):
            tbl = pa.Table.from_pandas(data, preserve_index=False)
        else:
            rows = list(data)
            names = list(rows[0].keys())
            tbl = pa.table({n: [r[n] for r in rows] for n in names})
        with self._lock:
            self._rows.append(tbl)
            return len(self._rows)

    # -- engine side ----------------------------------------------------------

    @property
    def schema(self) -> Schema:
        from spark_tpu_torch.columnar.arrow import schema_from_arrow

        with self._lock:
            if self._rows:
                return schema_from_arrow(self._rows[0].schema)
        if isinstance(self._example, pa.Schema):
            return schema_from_arrow(self._example)
        return self._example

    def latest_offset(self) -> int:
        with self._lock:
            return len(self._rows)

    def get_batch(self, start: int, end: int) -> pa.Table:
        with self._lock:
            parts = self._rows[start:end]
            first = self._rows[0] if self._rows else None
        if not parts:
            return (first.slice(0, 0) if first is not None
                    else pa.table({}))
        return pa.concat_tables(parts)


class RateStreamSource:
    """Rows-per-second generator (reference: RateStreamProvider.scala):
    the offset is the seconds elapsed; each second gives
    ``rows_per_second`` rows of (timestamp, value)."""

    def __init__(self, rows_per_second: int = 10):
        self.rows_per_second = int(rows_per_second)
        self._t0 = time.time()
        self.name = f"rate-{next(_ids)}"

    @property
    def schema(self) -> Schema:
        from spark_tpu_torch import types as T
        from spark_tpu_torch.types import Field

        return Schema((Field("timestamp", T.INT64, nullable=False),
                       Field("value", T.INT64, nullable=False)))

    def latest_offset(self) -> int:
        return int(time.time() - self._t0)

    def get_batch(self, start: int, end: int) -> pa.Table:
        rps = self.rows_per_second
        values = list(range(start * rps, end * rps))
        ts = [int(self._t0) + v // rps for v in values]
        return pa.table({"timestamp": pa.array(ts, pa.int64()),
                         "value": pa.array(values, pa.int64())})
