"""SparkSession for the port: the entry point a user calls.

What the single-device SQL slice needs: ``SparkSession.builder
.device("cuda"|"cpu").getOrCreate()``, ``createDataFrame(pa.Table)``,
``range``, temp views, ``sql`` and ``table``. The device defaults to
``"cuda"``; without a usable CUDA device the session raises unless the
caller asked for ``"cpu"``. Every relation the session creates lives on
its device.
"""

from __future__ import annotations

from typing import Dict, Optional

import pyarrow as pa

from spark_tpu_torch.api.dataframe import DataFrame
from spark_tpu_torch.columnar.arrow import from_arrow
from spark_tpu_torch.columnar.batch import round_capacity
from spark_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from spark_tpu_torch.plan import logical as L


class Catalog:
    """Temp-view registry."""

    def __init__(self):
        self._views: Dict[str, L.LogicalPlan] = {}

    def _register_view(self, name: str, plan: L.LogicalPlan) -> None:
        self._views[name.lower()] = plan

    def lookup(self, name: str) -> L.LogicalPlan:
        try:
            return self._views[name.lower()]
        except KeyError:
            raise KeyError(f"table or view not found: {name}") from None


class SparkSessionBuilder:
    def __init__(self):
        self._device = DEFAULT_DEVICE

    def device(self, name) -> "SparkSessionBuilder":
        """``"cuda"`` (the default) or ``"cpu"``."""
        self._device = name
        return self

    def getOrCreate(self) -> "SparkSession":
        """The active session when it runs on the requested device, else a
        new session, which becomes the active one."""
        dev = resolve_device(self._device)
        active = SparkSession._active
        if active is None or active.device != dev:
            active = SparkSession(dev)
            SparkSession._active = active
        return active


class SparkSession:
    _active: Optional["SparkSession"] = None

    def __init__(self, device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.catalog = Catalog()

    class _BuilderDescriptor:
        def __get__(self, obj, cls):
            return SparkSessionBuilder()

    builder = _BuilderDescriptor()

    def table(self, name: str) -> DataFrame:
        return DataFrame(self, self.catalog.lookup(name))

    def range(self, start: int, end: Optional[int] = None,
              step: int = 1) -> DataFrame:
        """One int64 column ``id``: start, start + step, ... below end
        (``range(n)`` is 0 .. n-1), made on the session's device."""
        if end is None:
            start, end = 0, start
        return DataFrame(self, L.Range(int(start), int(end), int(step)))

    def sql(self, query: str) -> DataFrame:
        from spark_tpu_torch.sql.parser import parse_sql

        return DataFrame(self, parse_sql(query, self.catalog))

    def createDataFrame(self, data: pa.Table) -> DataFrame:
        if not isinstance(data, pa.Table):
            raise TypeError("createDataFrame takes a pyarrow.Table")
        batch = from_arrow(data, capacity=round_capacity(data.num_rows),
                           device=self.device)
        return DataFrame(self, L.Relation(batch))

    def __repr__(self):
        return f"SparkSession(device={self.device})"
