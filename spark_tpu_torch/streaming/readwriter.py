"""DataStreamReader and DataStreamWriter, the pyspark streaming surface
(the port of ``spark_tpu/streaming/readwriter.py``; reference:
sql/streaming/DataStreamReader.scala, DataStreamWriter.scala:226)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from spark_tpu_torch.streaming.execution import StreamingQuery, StreamingSource


class DataStreamReader:
    def __init__(self, session):
        self._session = session
        self._format = "memory"
        self._options: Dict[str, Any] = {}

    def format(self, fmt: str) -> "DataStreamReader":
        self._format = fmt
        return self

    def option(self, key: str, value: Any) -> "DataStreamReader":
        self._options[key] = value
        return self

    def load(self, source=None):
        from spark_tpu_torch.api.dataframe import DataFrame

        if source is not None:  # a MemoryStream or another source
            return DataFrame(self._session, StreamingSource(source))
        if self._format == "rate":
            from spark_tpu_torch.streaming.sources import RateStreamSource

            rps = int(self._options.get("rowsPerSecond", 10))
            return DataFrame(self._session,
                             StreamingSource(RateStreamSource(rps)))
        raise NotImplementedError(
            f"streaming format {self._format!r}; use "
            "spark.readStream.load(MemoryStream(...)) or format('rate')")


class DataStreamWriter:
    def __init__(self, df):
        self._df = df
        self._output_mode = "complete"
        self._format = "memory"
        self._name: Optional[str] = None
        self._checkpoint: Optional[str] = None

    def outputMode(self, mode: str) -> "DataStreamWriter":
        if mode not in ("complete", "update", "append"):
            raise ValueError(f"unknown output mode {mode!r}")
        self._output_mode = mode
        return self

    def format(self, fmt: str) -> "DataStreamWriter":
        self._format = fmt
        return self

    def queryName(self, name: str) -> "DataStreamWriter":
        self._name = name
        return self

    def option(self, key: str, value) -> "DataStreamWriter":
        if key == "checkpointLocation":
            self._checkpoint = str(value)
        return self

    def start(self):
        if self._format != "memory":
            raise NotImplementedError(
                f"streaming sink {self._format!r} (memory only)")
        from spark_tpu_torch.streaming.groups import (FlatMapGroupsWithState,
                                                      GroupStateQuery)
        from spark_tpu_torch.streaming.join import (StreamStreamJoinQuery,
                                                    find_streaming_join)

        sess = self._df._session
        if isinstance(self._df._plan, FlatMapGroupsWithState):
            return GroupStateQuery(sess, self._df._plan, self._name,
                                   self._output_mode, self._checkpoint)
        join = find_streaming_join(self._df._plan)
        if join is not None:
            return StreamStreamJoinQuery(
                sess, self._df._plan, join, self._name,
                self._output_mode, self._checkpoint)
        return StreamingQuery(sess, self._df._plan, self._name,
                              self._output_mode, self._checkpoint)


def with_watermark(df, col_name: str, delay: int):
    """``df.withWatermark``: marks the event-time column and its lateness
    bound on the streaming source (reference: EventTimeWatermark)."""

    def fn(p):
        if isinstance(p, StreamingSource):
            return dataclasses.replace(p, watermark_col=col_name,
                                       watermark_delay=int(delay))
        return p

    return df._with(df._plan.transform_up(fn))
