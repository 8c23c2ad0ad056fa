"""Structured streaming: micro-batch incremental execution (the port of
``spark_tpu/streaming/``; reference:
sql/core/.../execution/streaming/MicroBatchExecution.scala:41,
StreamExecution.scala, IncrementalExecution.scala:43).

A streaming query rides on the batch engine: each trigger reads the new
source offsets, splices the new rows into the logical plan as a
``Relation`` on the session's device, and runs ordinary batch
executions (``physical/planner.execute_logical``, or the mesh executor
under ``master("mesh[N]")``). A streaming aggregate computes the new
rows' partial aggregates, merges them with the committed state by a
second aggregate over their union (``plan/incremental.AggSpec``), and
commits the merged state as the next version. Both aggregates run the
hand kernels of ``ops/seg_agg.py`` on the card: counts and int64 sums,
min and max, and ``seg_fsum`` for float sums. Sources, sinks, the state
store, the watermark and the write-ahead offset log live here; no
operator code is duplicated.
"""

from spark_tpu_torch.streaming.execution import StreamingQuery, StreamingSource
from spark_tpu_torch.streaming.sources import MemoryStream, RateStreamSource
from spark_tpu_torch.streaming.state import StateStore

__all__ = ["MemoryStream", "RateStreamSource", "StateStore",
           "StreamingQuery", "StreamingSource"]
