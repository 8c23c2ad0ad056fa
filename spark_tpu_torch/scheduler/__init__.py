"""Multi-tenant query scheduler (the port of ``spark_tpu/scheduler/``;
reference: TaskSchedulerImpl.scala + Pool.scala, lifted from the task
level to the query level): fair pools, device-bytes admission and
concurrent serving for the connect server.

- ``pool``       FIFO / weighted-fair pools from ``spark.scheduler.mode``
                 and ``spark.tpu.scheduler.pool.<name>.{weight,minShare}``
- ``admission``  the device-bytes budget a query must fit before it
                 runs, shared with the session's storage through the
                 unified memory manager
- ``scheduler``  the query lifecycle (QUEUED -> ADMITTED -> RUNNING ->
                 FINISHED/FAILED/CANCELLED), the worker threads,
                 cancellation, deadlines and per-query records
"""

from spark_tpu_torch.scheduler.admission import (AdmissionController,
                                                 estimate_plan_bytes)
from spark_tpu_torch.scheduler.pool import Pool, build_pools
from spark_tpu_torch.scheduler.scheduler import (QueryCancelled,
                                                 QueryScheduler, QueryTicket,
                                                 SchedulerQueueFull)

__all__ = [
    "AdmissionController",
    "estimate_plan_bytes",
    "Pool",
    "build_pools",
    "QueryCancelled",
    "QueryScheduler",
    "QueryTicket",
    "SchedulerQueueFull",
]
