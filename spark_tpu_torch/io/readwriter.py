"""DataFrameReader and DataFrameWriter, the ``spark.read`` / ``df.write``
surface (the port of ``spark_tpu/io/readwriter.py``; reference:
sql/core/.../DataFrameReader.scala, DataFrameWriter.scala).

Reads go through ``io.datasource.FileSource`` (pyarrow.dataset). Writes
take the query's rows as Arrow and write a directory of part files, as
Spark does, with Spark's save modes and hive-style ``partitionBy``;
``saveAsTable`` writes a persistent table under
``spark.sql.warehouse.dir`` that the session catalog reads back.
"""

from __future__ import annotations

import os
import shutil
import uuid
from typing import Any, Dict, List, Optional, Sequence, Union

import pyarrow as pa

from spark_tpu_torch.plan import logical as L
from spark_tpu_torch.types import Schema


class DataFrameReader:
    def __init__(self, session):
        self._session = session
        self._format = "parquet"
        self._schema: Optional[Schema] = None
        self._options: Dict[str, Any] = {}

    def format(self, fmt: str) -> "DataFrameReader":  # noqa: A003
        self._format = fmt
        return self

    def schema(self, schema: Union[Schema, str]) -> "DataFrameReader":
        """A Schema, or DDL text: ``"a BIGINT, b DOUBLE"``."""
        if isinstance(schema, str):
            from spark_tpu_torch.sql.ddl import parse_ddl_schema

            schema = parse_ddl_schema(schema)
        self._schema = schema
        return self

    def option(self, key: str, value: Any) -> "DataFrameReader":
        self._options[key] = value
        return self

    def options(self, **opts: Any) -> "DataFrameReader":
        self._options.update(opts)
        return self

    def load(self, path: Union[str, Sequence[str]],
             format: Optional[str] = None,  # noqa: A002
             schema: Optional[Union[Schema, str]] = None,
             **options: Any):
        from spark_tpu_torch.api.dataframe import DataFrame
        from spark_tpu_torch.io.datasource import FileSource

        if format is not None:
            self._format = format
        if schema is not None:
            self.schema(schema)
        self._options.update(options)
        paths = [path] if isinstance(path, str) else list(path)
        source = FileSource(self._format, paths, self._schema, self._options)
        return DataFrame(self._session, L.UnresolvedScan(source))

    def parquet(self, *paths: str):
        self._format = "parquet"
        return self.load(list(paths) if len(paths) > 1 else paths[0])

    def csv(self, path: Union[str, Sequence[str]],
            schema: Optional[Union[Schema, str]] = None, **options: Any):
        self._format = "csv"
        return self.load(path, schema=schema, **options)

    def orc(self, *paths: str):
        self._format = "orc"
        return self.load(list(paths) if len(paths) > 1 else paths[0])

    def json(self, path: Union[str, Sequence[str]], **options: Any):
        self._format = "json"
        return self.load(path, **options)

    def table(self, name: str):
        return self._session.table(name)


_SAVE_MODES = ("error", "overwrite", "append", "ignore")


class DataFrameWriter:
    def __init__(self, df):
        self._df = df
        self._format = "parquet"
        self._mode = "error"
        self._options: Dict[str, Any] = {}
        self._partition_by: List[str] = []

    def format(self, fmt: str) -> "DataFrameWriter":  # noqa: A003
        self._format = fmt
        return self

    def mode(self, mode: str) -> "DataFrameWriter":
        """Spark's save modes: error (or errorifexists, default),
        overwrite, append, ignore."""
        aliases = {"errorifexists": "error", "default": "error"}
        mode = aliases.get(mode.lower(), mode.lower())
        if mode not in _SAVE_MODES:
            raise ValueError(f"unknown save mode {mode!r}")
        self._mode = mode
        return self

    def option(self, key: str, value: Any) -> "DataFrameWriter":
        self._options[key] = value
        return self

    def options(self, **opts: Any) -> "DataFrameWriter":
        self._options.update(opts)
        return self

    def partitionBy(self, *cols: str) -> "DataFrameWriter":
        self._partition_by = [
            c for group in cols
            for c in (group if isinstance(group, (list, tuple)) else [group])]
        return self

    # -- terminal actions ----------------------------------------------------

    def save(self, path: str, format: Optional[str] = None,  # noqa: A002
             mode: Optional[str] = None, **options: Any) -> None:
        if format is not None:
            self._format = format
        if mode is not None:
            self.mode(mode)
        self._options.update(options)
        if os.path.exists(path):
            if self._mode == "error":
                raise FileExistsError(
                    f"path {path} already exists (mode=error; use "
                    "mode('overwrite') or mode('append'))")
            if self._mode == "ignore":
                return
            if self._mode == "overwrite":
                if os.path.isdir(path):
                    shutil.rmtree(path)
                else:
                    os.remove(path)
        self._write_table(self._df.toArrow(), path)

    def saveAsTable(self, name: str) -> None:
        """A persistent table under spark.sql.warehouse.dir (reference:
        DataFrameWriter.saveAsTable and SessionCatalog.scala:61): the rows
        in this writer's format under ``<warehouse>/<name>/data`` and a
        ``_table.json`` naming the format, the partition columns and the
        options, which any later session on that warehouse reads back.
        The layout is the reference's."""
        import json

        from spark_tpu_torch import conf as CF

        session = self._df._session
        wh = session.conf.get(CF.WAREHOUSE_DIR)
        os.makedirs(wh, exist_ok=True)
        path = os.path.join(wh, name.lower())
        self.save(os.path.join(path, "data"))
        meta = {"name": name.lower(), "format": self._format,
                "partition_by": self._partition_by,
                "options": {k: str(v) for k, v in self._options.items()}}
        with open(os.path.join(path, "_table.json"), "w") as f:
            json.dump(meta, f)
        session.catalog.refresh_persistent(name.lower())

    def _write_table(self, table: pa.Table, path: str) -> None:
        import pyarrow.dataset as pads

        part_id = uuid.uuid4().hex[:8]
        fmt: Any = self._format
        write_opts = None
        if self._format == "csv":
            import pyarrow.csv as pacsv

            header = str(self._options.get("header", "true")).lower() == "true"
            delim = self._options.get(
                "sep", self._options.get("delimiter", ","))
            fmt = pads.CsvFileFormat(
                parse_options=pacsv.ParseOptions(delimiter=delim))
            write_opts = fmt.make_write_options(
                include_header=header, delimiter=delim)
        elif self._format == "json":
            # pyarrow.dataset cannot write json: one ndjson part file, as
            # the reference writes it (pandas, imported only here)
            os.makedirs(path, exist_ok=True)
            fname = os.path.join(path, f"part-00000-{part_id}.json")
            table.to_pandas().to_json(fname, orient="records", lines=True,
                                      date_format="iso")
            return
        elif self._format == "orc":
            # pyarrow.dataset cannot write orc: the direct writer
            if self._partition_by:
                raise NotImplementedError(
                    "partitionBy with the ORC writer is not supported "
                    "(pyarrow's dataset writer has no ORC output); use "
                    "parquet for partitioned layouts")
            from pyarrow import orc as paorc

            os.makedirs(path, exist_ok=True)
            paorc.write_table(
                table, os.path.join(path, f"part-00000-{part_id}.orc"))
            return
        elif self._format != "parquet":
            raise ValueError(f"unsupported format {self._format!r}")
        partitioning = None
        if self._partition_by:
            partitioning = pads.partitioning(
                pa.schema([table.schema.field(c)
                           for c in self._partition_by]), flavor="hive")
        pads.write_dataset(
            table, path, format=fmt, file_options=write_opts,
            basename_template=f"part-{{i}}-{part_id}.{self._format}",
            partitioning=partitioning,
            existing_data_behavior="overwrite_or_ignore")

    def parquet(self, path: str, mode: Optional[str] = None) -> None:
        self.save(path, format="parquet", mode=mode)

    def csv(self, path: str, mode: Optional[str] = None,
            **options: Any) -> None:
        self.save(path, format="csv", mode=mode, **options)

    def json(self, path: str, mode: Optional[str] = None) -> None:
        self.save(path, format="json", mode=mode)

    def orc(self, path: str, mode: Optional[str] = None) -> None:
        self.save(path, format="orc", mode=mode)
