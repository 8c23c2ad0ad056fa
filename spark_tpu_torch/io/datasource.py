"""File scan source and pushdown translation (the port of
``spark_tpu/io/datasource.py``).

pyarrow.dataset does the multi-file scan, hive partition discovery,
column projection, predicate-based file and row-group pruning and exact
row filtering; ``columnar/arrow.from_arrow`` encodes the Arrow columns
and puts them on the device the caller names (the session's).

The optimizer calls ``translate_filters`` to split a predicate into the
conjuncts a pyarrow dataset expression can hold (pushed: pruned at the
file and row-group level and applied exactly by the scan) and the
residual, which stays in the plan as a Filter.
"""

from __future__ import annotations

import decimal
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.dataset as pads
import torch

from spark_tpu_torch import metrics
from spark_tpu_torch import types as T
from spark_tpu_torch.columnar.arrow import (dtype_to_arrow_type, from_arrow,
                                            schema_from_arrow, source_column)
from spark_tpu_torch.columnar.batch import Batch, round_capacity
from spark_tpu_torch.expr import expressions as E
from spark_tpu_torch.types import Field, Schema

#: device batches a source keeps, least recently used first out:
#: parameterised pushed filters must not pin an unbounded number
_CACHE_ENTRIES = 4


def _pa_schema_from_schema(schema: Schema) -> pa.Schema:
    return pa.schema([
        pa.field(f.name, dtype_to_arrow_type(f.dtype), nullable=f.nullable)
        for f in schema.fields])


def _schema_from_pa(pa_schema: pa.Schema) -> Schema:
    """The engine schema of a file schema: a list column becomes the
    array and its ``#len`` companion, a map its ``#keys``/``#vals``
    pair, a struct its dotted children (``columnar/arrow.py``)."""
    fields = schema_from_arrow(pa_schema).fields
    nullable = {f.name: f.nullable for f in pa_schema}
    return Schema(tuple(
        Field(f.name, f.dtype, nullable=nullable.get(f.name, f.nullable))
        for f in fields))


# ---- predicate translation --------------------------------------------------


class _Untranslatable(Exception):
    pass


def _literal_value(e: E.Expression):
    if isinstance(e, E.Literal):
        return e.value
    raise _Untranslatable


def _coerce_literal(v, col_name: str, dtypes):
    """A Python literal in the column's storage type for pyarrow: a float
    literal against a DECIMAL column becomes a Decimal (pyarrow refuses
    decimal against double). str(float) round-trips the short literals
    SQL texts hold, so 0.05 means exactly 0.05."""
    if dtypes is None or not isinstance(v, (int, float)):
        return v
    if isinstance(dtypes.get(col_name), T.DecimalType):
        return decimal.Decimal(str(v))
    return v


_FLIP = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}


def _flat_column(name: str) -> str:
    """``name`` when it can name a flat file column: the parts of nested
    columns (``#len``, ``#keys``/``#vals``, dotted struct children) are
    never pushed."""
    if "#" in name or "." in name:
        raise _Untranslatable
    return name


def _translate(e: E.Expression, dtypes=None) -> pads.Expression:
    """Expression -> pyarrow.dataset expression; raises _Untranslatable
    for anything the scan cannot evaluate (filters on nested columns
    included). ``dtypes`` ({column: DataType}) turns on the storage-aware
    literal coercion of a read."""
    for c in e.children():
        if isinstance(c, E.Col):
            _flat_column(c.col_name)
    if isinstance(e, E.Cmp):
        if isinstance(e.left, E.Col):
            name, v, op = e.left.col_name, _literal_value(e.right), e.op
        elif isinstance(e.right, E.Col):
            name, v = e.right.col_name, _literal_value(e.left)
            op = _FLIP.get(e.op, e.op)
        else:
            raise _Untranslatable
        if v is None:
            raise _Untranslatable
        f = pc.field(name)
        v = _coerce_literal(v, name, dtypes)
        return {"==": f == v, "!=": f != v, "<": f < v,
                "<=": f <= v, ">": f > v, ">=": f >= v}[op]
    if isinstance(e, E.In) and isinstance(e.child, E.Col):
        if any(v is None for v in e.values):
            raise _Untranslatable
        vals = [_coerce_literal(v, e.child.col_name, dtypes)
                for v in e.values]
        return pc.field(e.child.col_name).isin(vals)
    if isinstance(e, E.IsNull) and isinstance(e.child, E.Col):
        return pc.field(e.child.col_name).is_null()
    if isinstance(e, E.Not):
        return ~_translate(e.child, dtypes)
    if isinstance(e, E.And):
        return _translate(e.left, dtypes) & _translate(e.right, dtypes)
    if isinstance(e, E.Or):
        return _translate(e.left, dtypes) | _translate(e.right, dtypes)
    raise _Untranslatable


def translate_filters(
    conjuncts: Sequence[E.Expression],
) -> Tuple[List[E.Expression], List[E.Expression]]:
    """Split conjuncts into (pushable, residual). A conjunct is pushable
    when ``_translate`` understands all of it."""
    pushed: List[E.Expression] = []
    residual: List[E.Expression] = []
    for c in conjuncts:
        try:
            _translate(c)
            pushed.append(c)
        except _Untranslatable:
            residual.append(c)
    return pushed, residual


def _filters_to_pads(filters: Tuple[E.Expression, ...],
                     dtypes=None) -> Optional[pads.Expression]:
    if not filters:
        return None
    out = _translate(filters[0], dtypes)
    for c in filters[1:]:
        out = out & _translate(c, dtypes)
    return out


# ---- the source -------------------------------------------------------------


class FileSource:
    """A lazily opened multi-file scan (one table, one source).

    ``fmt`` is 'parquet', 'csv', 'json' or 'orc'. Hive partition
    directories are discovered for parquet and orc (and for csv and json
    under the option ``partitioning="hive"``): partition columns become
    ordinary columns and take part in predicate pushdown, which prunes
    partitions (reference: PartitioningUtils.scala).

    ``last_read`` holds the rows, decode milliseconds (pyarrow's scan)
    and transfer milliseconds (encoding and the copy to the device) of
    the newest read that was not served from the cache.
    """

    def __init__(self, fmt: str, paths: Sequence[str],
                 schema: Optional[Schema] = None,
                 options: Optional[Dict[str, Any]] = None):
        self.fmt = fmt
        self.paths = list(paths)
        self._schema = schema
        self.options = dict(options or {})
        self._dataset: Optional[pads.Dataset] = None
        self._fp: Optional[tuple] = None
        # (device, columns, filter keys) -> device batch, LRU order
        self._cache: Dict[tuple, Batch] = {}
        self._count_cache: Dict[tuple, int] = {}
        # (device, columns, filter keys) -> reads asked for (auto-cache)
        self._read_counts: Dict[tuple, int] = {}
        # column -> distinct count (plan/join_reorder.py's _scan_ndv)
        self._ndv_cache: Dict[str, int] = {}
        self.last_read: Optional[Dict[str, Any]] = None

    # -- dataset and schema --------------------------------------------------

    def _fingerprint(self) -> tuple:
        """Freshness token over the files, so a re-read after a rewrite
        never serves a stale batch and the dataset (which pins its file
        list) is rebuilt."""
        from spark_tpu_torch.io.fingerprint import stat_paths

        return stat_paths(self.paths)

    def _broadcast_change(self) -> None:
        """A rewrite or append of this source was just detected: append
        a ``source_changed`` record to the active session's fleet
        invalidation log, where it has one (``serve/ownership.py``), so
        every replica's cached results for these paths drop now. Reads
        never depend on it."""
        try:
            from spark_tpu_torch.api.session import SparkSession

            sess = SparkSession.getActiveSession()
            log = getattr(sess, "serve_invalidation_log", None) \
                if sess is not None else None
            if log is not None:
                log.append("source_changed", self.paths)
        except Exception:  # noqa: BLE001 - best effort
            pass

    def _open(self) -> pads.Dataset:
        fp = self._fingerprint()
        if self._fp != fp:
            changed = self._fp is not None
            self._dataset = None
            self._cache.clear()
            self._count_cache.clear()
            self._ndv_cache.clear()
            self._fp = fp
            if changed:
                self._broadcast_change()
        if self._dataset is None:
            self._dataset = self._make_dataset()
        return self._dataset

    def _make_dataset(self) -> pads.Dataset:
        kwargs: Dict[str, Any] = {}
        hive = str(self.options.get("partitioning", "")) == "hive"
        if self.fmt in ("parquet", "orc"):
            # orc: pyarrow's C++ ORC reader
            kwargs["format"] = self.fmt
            kwargs["partitioning"] = "hive"
        elif self.fmt == "csv":
            kwargs["format"] = self._csv_format()
            if hive:
                kwargs["partitioning"] = "hive"
        elif self.fmt == "json":
            kwargs["format"] = "json"
            if hive:
                kwargs["partitioning"] = "hive"
        else:
            raise ValueError(f"unsupported format {self.fmt!r}")
        if self._schema is not None and self.fmt == "parquet":
            kwargs["schema"] = _pa_schema_from_schema(self._schema)
        # pyarrow takes a directory only as a scalar path, not in a list
        src = self.paths[0] if len(self.paths) == 1 else self.paths
        return pads.dataset(src, **kwargs)

    def _csv_format(self) -> pads.CsvFileFormat:
        import pyarrow.csv as pacsv

        header = str(self.options.get("header", "true")).lower() == "true"
        delim = self.options.get("sep", self.options.get("delimiter", ","))
        read_opts: Dict[str, Any] = {}
        if not header:
            if self._schema is not None:
                # the declared names up front, so projection, pushdown
                # and the column types see them
                read_opts["column_names"] = list(self._schema.names)
            else:
                read_opts["autogenerate_column_names"] = True
        convert = None
        if self._schema is not None:
            convert = pacsv.ConvertOptions(column_types={
                f.name: dtype_to_arrow_type(f.dtype)
                for f in self._schema.fields})
        return pads.CsvFileFormat(
            parse_options=pacsv.ParseOptions(delimiter=delim),
            read_options=pacsv.ReadOptions(**read_opts),
            convert_options=convert)

    @property
    def schema(self) -> Schema:
        if self._schema is None:
            self._schema = _schema_from_pa(self._open().schema)
        return self._schema

    def _dtypes(self) -> Dict[str, Any]:
        """{column: DataType}, for the literal coercion of pushed
        filters (decimal columns against float literals)."""
        return {f.name: f.dtype for f in self.schema.fields}

    # -- scanning ------------------------------------------------------------

    def _session_store(self, device):
        """The MemoryStore of the session whose query is running, and its
        auto-cache threshold; (None, 0) outside a query, for another
        device than the session's, or with auto-caching off."""
        from spark_tpu_torch import conf as CF
        from spark_tpu_torch.api.session import executing_session

        sess = executing_session()
        if sess is None or sess.device != torch.device(device):
            return None, 0
        thr = int(sess.conf.get(CF.STORAGE_AUTOCACHE_THRESHOLD))
        return (sess.memory_store, thr) if thr > 0 else (None, 0)

    def _store_key(self, key) -> tuple:
        # the fingerprint is in the key: a rewritten file misses, and
        # the stale entry ages out
        return ("scan", self.fmt, tuple(self.paths), self._fp, key)

    def read(self, columns: Optional[Tuple[str, ...]] = None,
             filters: Tuple[E.Expression, ...] = (),
             device="cuda") -> Batch:
        """The scan as a batch on ``device``, reading only ``columns``
        and pruning and filtering rows by ``filters`` (exactly). The four
        newest reads stay cached, keyed by device, columns and filters,
        until the files change.

        Hot scans are promoted: once the same (columns, filters) read has
        been asked for ``spark.tpu.storage.autoCacheThreshold`` times, its
        batch moves into the running session's MemoryStore
        (byte-accounted, LRU-evictable, pinned while the query reads it)
        and later reads are served from there (reference:
        ``spark_tpu/io/datasource.py`` ``read``)."""
        ds = self._open()  # first: the freshness check may clear the cache
        key = (str(device), columns, tuple(E.expr_key(f) for f in filters))
        self._read_counts[key] = self._read_counts.get(key, 0) + 1
        store, threshold = self._session_store(device)
        skey = self._store_key(key) if store is not None else None
        if store is not None:
            hit = store.get(skey, pin=True)
            if hit is not None:
                return hit
        # promotion is optional work: under fleet brownout the scan
        # still serves (and store hits still hit), it stops promoting
        hot = (store is not None and self._read_counts[key] >= threshold
               and metrics.brownout_level() == 0)
        hit = self._cache.pop(key, None)
        if hit is not None:
            if hot and store.put(skey, hit, pin=True):
                return hit  # now owned by the store
            self._cache[key] = hit  # most recently used
            return hit
        t0 = time.perf_counter()
        file_cols = None
        if columns is not None:
            # the file columns behind the engine's: a list, map or struct
            # column is read whole and expanded by from_arrow
            names = ds.schema.names
            file_cols = list(dict.fromkeys(source_column(c, names)
                                           for c in columns))
        table = ds.to_table(
            columns=file_cols,
            filter=_filters_to_pads(filters, self._dtypes()))
        t1 = time.perf_counter()
        batch = from_arrow(table, capacity=round_capacity(table.num_rows),
                           device=device)
        if columns is not None and tuple(batch.schema.names) != columns:
            batch = batch.select(columns)
        if batch.data.row_mask.is_cuda:
            # wait for the copies, so that the transfer time is theirs
            torch.cuda.synchronize(batch.data.row_mask.device)
        t2 = time.perf_counter()
        self.last_read = {"rows": table.num_rows,
                          "decode_ms": (t1 - t0) * 1e3,
                          "transfer_ms": (t2 - t1) * 1e3}
        metrics.record("scan", fmt=self.fmt, rows=table.num_rows,
                       decode_ms=round(self.last_read["decode_ms"], 2),
                       transfer_ms=round(self.last_read["transfer_ms"], 2))
        if hot and store.put(skey, batch, pin=True):
            return batch
        while len(self._cache) >= _CACHE_ENTRIES:
            self._cache.pop(next(iter(self._cache)))
        self._cache[key] = batch
        return batch

    def count_rows(self, filters: Tuple[E.Expression, ...] = ()) -> int:
        """Row count without reading the columns (file metadata, or a
        filtered count for pushed filters), memoized per filter set."""
        ds = self._open()  # the freshness check may clear the memo
        key = tuple(E.expr_key(f) for f in filters)
        hit = self._count_cache.get(key)
        if hit is None:
            hit = ds.count_rows(
                filter=_filters_to_pads(filters, self._dtypes()))
            self._count_cache[key] = hit
        return hit

    def iter_batches(self, columns: Optional[Tuple[str, ...]] = None,
                     filters: Tuple[E.Expression, ...] = (),
                     rows_per_chunk: int = 1 << 20):
        """Stream the scan as Arrow tables of exactly ``rows_per_chunk``
        rows (the last one shorter) without reading the whole dataset
        into host memory."""
        ds = self._open()
        pending: list = []
        n = 0
        for rb in ds.to_batches(
                columns=list(columns) if columns is not None else None,
                filter=_filters_to_pads(filters, self._dtypes()),
                batch_size=rows_per_chunk):
            if rb.num_rows == 0:
                continue
            pending.append(rb)
            n += rb.num_rows
            while n >= rows_per_chunk:
                tbl = pa.Table.from_batches(pending)
                yield tbl.slice(0, rows_per_chunk)
                rest = tbl.slice(rows_per_chunk)
                pending = rest.to_batches() if rest.num_rows else []
                n = rest.num_rows
        if pending:
            yield pa.Table.from_batches(pending)

    def __repr__(self):
        return f"{self.fmt}:{','.join(self.paths)}"
