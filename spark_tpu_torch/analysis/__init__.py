"""Pre-execution static plan analysis (the port of
``spark_tpu/analysis/``).

Public surface::

    from spark_tpu_torch import analysis

    report = analysis.analyze(df._plan, spark.conf)   # never raises
    print(report.format())

    analysis.maybe_gate(plan, conf)   # spark.tpu.analysis.level gate

Diagnostic codes are documented in analysis/diagnostics.py; the shared
transform-legality rules (also used by the mesh's skew fan and adaptive
aggregation and by the chunked tier) live in analysis/legality.py;
``concurrency.py`` lints this package's own source against
``locks.LOCK_RANKS``.
"""

from spark_tpu_torch.analysis.analyzer import (analyze, maybe_gate,
                                               recent_reports)
from spark_tpu_torch.analysis.diagnostics import (AnalysisReport,
                                                  Diagnostic,
                                                  PlanAnalysisError)
from spark_tpu_torch.analysis import hazards, legality, oracle  # noqa: F401

__all__ = [
    "analyze", "maybe_gate", "recent_reports",
    "AnalysisReport", "Diagnostic", "PlanAnalysisError",
    "legality", "oracle", "hazards",
]
