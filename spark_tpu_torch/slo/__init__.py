"""SLO-driven serving (the port of ``spark_tpu/slo/``): predict ->
schedule -> shed.

Per-plan latency prediction (:mod:`spark_tpu_torch.slo.model`),
earliest-deadline-first ordering with a typed reject at admission
(:mod:`spark_tpu_torch.slo.edf`), and the predictive brownout and
auto-sized concurrency (:mod:`spark_tpu_torch.slo.controller`). The
tier is gated on ``spark.tpu.slo.enabled``; off, the scheduler's
FIFO/FAIR paths run as without it.
"""

from spark_tpu_torch.slo.edf import InfeasibleDeadline, edf_key  # noqa: F401
from spark_tpu_torch.slo.model import (LatencyModel,  # noqa: F401
                                       fingerprint_plan, fingerprint_sql,
                                       model_path_from_conf,
                                       plan_input_rows)
from spark_tpu_torch.slo.controller import SloController  # noqa: F401
