"""Scale-out serving tier (the port of ``spark_tpu/serve/``): replica
federation router, plan-keyed result cache and cross-replica admission
shedding.

- ``router.FederationRouter``: an HTTP front end speaking the connect
  protocol over N ConnectServer replicas (``serve_fleet`` starts an
  in-process fleet over one session; a deployment runs one replica
  process per host and hands the router their URLs).
- ``result_cache.ResultCache``: Arrow-IPC results keyed on the
  structural plan key and the scan sources' freshness fingerprints,
  bounded by ``spark.tpu.serve.resultCache.maxBytes``, one execution a
  key at a time.
- ``federation.Federation``: health probes, the routing policy
  (``spark.tpu.serve.policy``), shedding a 429 to the least loaded
  replica, and bounded re-dispatch around a dead replica (fault point
  ``serve.dispatch``).
"""

from spark_tpu_torch.serve.federation import (Federation, NoHealthyReplica,
                                              Replica)
from spark_tpu_torch.serve.result_cache import (ResultCache, ipc_to_table,
                                                plan_result_key,
                                                table_to_ipc)
from spark_tpu_torch.serve.router import (FederationRouter, Fleet,
                                          serve_fleet)

__all__ = [
    "Federation",
    "FederationRouter",
    "Fleet",
    "NoHealthyReplica",
    "Replica",
    "ResultCache",
    "ipc_to_table",
    "plan_result_key",
    "serve_fleet",
    "table_to_ipc",
]
