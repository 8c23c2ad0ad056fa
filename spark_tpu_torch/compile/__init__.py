"""The compile tier (the port of ``spark_tpu/compile/``): the
cross-session statistics store, background capture with the hot swap,
and the served-plan history with its pre-warm.

The reference's product is the compiled executable (Flare, PAPERS.md,
arxiv 1703.08219): persisted, keyed and served. The port's compiled form
of a stage is a CUDA graph, which lives and dies with its process; what
crosses processes is what lets a plan's first run be captured at once,
its runtime statistics (``store.py`` says what is kept and why).
``service.py`` holds the session-facing policies.
"""

from spark_tpu_torch.compile.service import (CompileService, PlanHistory,
                                             maybe_service)
from spark_tpu_torch.compile.store import StatsStore, stable_plan_fingerprint

__all__ = [
    "CompileService",
    "PlanHistory",
    "StatsStore",
    "maybe_service",
    "stable_plan_fingerprint",
]
