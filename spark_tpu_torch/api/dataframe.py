"""DataFrame: a (session, logical plan) pair with the actions the
single-device SQL slice needs. Actions run optimize -> physical plan ->
eager execution (physical/planner.py)."""

from __future__ import annotations

from typing import List

from spark_tpu_torch.api.row import Row
from spark_tpu_torch.columnar.batch import Batch
from spark_tpu_torch.plan import logical as L
from spark_tpu_torch.types import Schema


class DataFrame:
    def __init__(self, session, plan: L.LogicalPlan):
        self._session = session
        self._plan = plan

    @property
    def schema(self) -> Schema:
        return self._plan.schema

    @property
    def columns(self) -> List[str]:
        return list(self._plan.schema.names)

    def _execute(self) -> Batch:
        from spark_tpu_torch.physical.planner import execute_logical

        return execute_logical(self._plan, device=self._session.device)

    def collect(self) -> List[Row]:
        return [Row.from_dict(d) for d in self._execute().to_pylist()]

    def createOrReplaceTempView(self, name: str) -> None:
        self._session.catalog._register_view(name, self._plan)
