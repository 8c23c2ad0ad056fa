"""Incrementally maintained materialized views (the port of
``spark_tpu/mview/``).

With ``spark.tpu.mview.enabled``, ``df.cache()`` of an aggregate over a
fingerprinted file source becomes a materialized view: the cached
device batch is refreshed when the source files change (a plain cache
would serve stale bytes), and when files were only appended and the
aggregate is exactly re-mergeable (integer Sum, non-float Min/Max:
``analysis/legality.remerge_verdict``), the refresh runs the aggregate
over the new files only and re-merges the partials into the cached
batch, on the device, through the hand kernels. Anything else falls
back to a full recompute; both paths give the same bytes.

Streaming meets views here: each micro-batch publishes its rows
(``streaming/execution.py``) to the views registered on its query,
deduplicated by the WAL's batch id, so a replay after a crash never
merges twice.

``view.py`` holds the maintainability verdict (the PLAN-MVIEW-*
diagnostics of ``df.explain(mode="lint")``), ``manager.py`` the refresh
and merge engine.
"""

from spark_tpu_torch.mview.manager import ViewManager
from spark_tpu_torch.mview.view import MaterializedView, inspect_plan

__all__ = ["ViewManager", "MaterializedView", "inspect_plan"]
