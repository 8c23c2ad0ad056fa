"""SparkSession for the port: the entry point a user calls.

``SparkSession.builder.device("cuda"|"cpu").config(key, value)
.getOrCreate()``; ``createDataFrame`` from a ``pyarrow.Table``, a
``pandas.DataFrame`` or a list of dicts or tuples; ``read`` (Parquet,
CSV, JSON, ORC); ``range``; temp views; ``sql``; ``table``; ``conf``.
The device defaults to ``"cuda"``; without a usable CUDA device the
session raises unless the caller asked for ``"cpu"``. Every relation the
session creates, and every file it reads, lives on its device.
"""

from __future__ import annotations

import sys
from typing import Any, Dict, Iterable, List, Optional, Sequence, Union

import pyarrow as pa

from spark_tpu_torch.api.dataframe import DataFrame
from spark_tpu_torch.columnar.arrow import from_arrow
from spark_tpu_torch.columnar.batch import round_capacity
from spark_tpu_torch.conf import RuntimeConf
from spark_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from spark_tpu_torch.plan import logical as L
from spark_tpu_torch.types import Schema


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

    def listTables(self) -> List[str]:
        return sorted(self._views)

    def dropTempView(self, name: str) -> bool:
        return self._views.pop(name.lower(), None) is not None

    def tableExists(self, name: str) -> bool:
        return name.lower() in self._views


class SparkSessionBuilder:
    def __init__(self):
        self._device = DEFAULT_DEVICE
        self._conf: Dict[str, Any] = {}

    def device(self, name) -> "SparkSessionBuilder":
        """``"cuda"`` (the default) or ``"cpu"``."""
        self._device = name
        return self

    def config(self, key: str, value: Any) -> "SparkSessionBuilder":
        self._conf[key] = value
        return self

    def getOrCreate(self) -> "SparkSession":
        """The active session when it runs on the requested device, with
        this builder's settings applied to it; else a new session with
        them, which becomes the active one."""
        dev = resolve_device(self._device)
        active = SparkSession._active
        if active is None or active.device != dev:
            active = SparkSession(dev, self._conf)
            SparkSession._active = active
        else:
            for key, value in self._conf.items():
                active.conf.set(key, value)
        return active


def _is_pandas(data) -> bool:
    """Whether ``data`` is a pandas DataFrame, without importing pandas
    (a machine may lack it; then no caller can hold one)."""
    pd = sys.modules.get("pandas")
    return pd is not None and isinstance(data, pd.DataFrame)


class SparkSession:
    _active: Optional["SparkSession"] = None

    def __init__(self, device=DEFAULT_DEVICE,
                 conf: Optional[Dict[str, Any]] = None):
        self.device = resolve_device(device)
        self.conf = RuntimeConf(conf)
        self.catalog = Catalog()

    class _BuilderDescriptor:
        def __get__(self, obj, cls):
            return SparkSessionBuilder()

    builder = _BuilderDescriptor()

    @classmethod
    def getActiveSession(cls) -> Optional["SparkSession"]:
        return cls._active

    @property
    def read(self):
        from spark_tpu_torch.io.readwriter import DataFrameReader

        return DataFrameReader(self)

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

    def createDataFrame(
        self,
        data: Union[pa.Table, Iterable],
        schema: Optional[Union[Schema, Sequence[str]]] = None,
    ) -> DataFrame:
        """A DataFrame over ``data``: a pyarrow Table, a pandas DataFrame,
        or rows as dicts (named by the first row's keys) or tuples (named
        by ``schema``). Names in ``schema`` rename the columns."""
        if isinstance(data, pa.Table):
            table = data
        elif _is_pandas(data):
            table = pa.Table.from_pandas(data, preserve_index=False)
        else:
            rows = list(data)
            if not rows:
                raise ValueError("cannot create DataFrame from empty data "
                                 "without an explicit arrow/pandas input")
            if isinstance(rows[0], dict):
                names = list(rows[0].keys())
                cols = {n: [r[n] for r in rows] for n in names}
            else:
                if schema is None:
                    raise ValueError("tuple rows require column names")
                names = (list(schema.names) if isinstance(schema, Schema)
                         else list(schema))
                cols = {n: [r[i] for r in rows] for i, n in enumerate(names)}
            table = pa.table(cols)
        batch = from_arrow(table, capacity=round_capacity(table.num_rows),
                           device=self.device)
        df = DataFrame(self, L.Relation(batch))
        if schema is not None and not isinstance(schema, (Schema, str)):
            new = list(schema)
            if new != df.columns and len(new) == len(df.columns):
                for old, name in zip(df.columns, new):
                    df = df.withColumnRenamed(old, name)
        return df

    def __repr__(self):
        return f"SparkSession(device={self.device})"
