"""Arrow <-> device-batch interchange.

The port of ``spark_tpu/columnar/arrow.py``: booleans, integers,
floats, decimal128 (as scaled int64), dictionary or plain strings (as
int32 codes over a sorted host dictionary), date32 and timestamps, with
nulls as validity masks. A list column becomes a padded 2-D column and
its ``#len`` companion, a map the ``#keys``/``#vals`` pair of lists, and a
struct flattens into dotted columns, a null struct row nulling every
child (types.ArrayType, types.MapType); ``to_arrow`` rebuilds lists and
maps.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from spark_tpu_torch import types as T
from spark_tpu_torch.columnar.batch import Batch, from_numpy
from spark_tpu_torch.types import Field, Schema


def arrow_type_to_dtype(at: pa.DataType) -> T.DataType:
    if pa.types.is_boolean(at):
        return T.BOOLEAN
    if pa.types.is_int8(at):
        return T.INT8
    if pa.types.is_int16(at):
        return T.INT16
    if pa.types.is_int32(at):
        return T.INT32
    if pa.types.is_int64(at):
        return T.INT64
    if pa.types.is_float32(at):
        return T.FLOAT32
    if pa.types.is_float64(at):
        return T.FLOAT64
    if pa.types.is_decimal(at):
        if at.precision > T.DecimalType.MAX_PRECISION:
            # the device representation is scaled int64 (18 digits); a
            # wider column's high limb carries real data the ingest
            # would silently drop — refuse loudly instead
            raise NotImplementedError(
                f"decimal({at.precision},{at.scale}) exceeds the "
                f"engine's {T.DecimalType.MAX_PRECISION}-digit "
                f"(int64) cap")
        return T.DecimalType(at.precision, at.scale)
    if pa.types.is_string(at) or pa.types.is_large_string(at):
        return T.STRING
    if pa.types.is_date32(at):
        return T.DATE
    if pa.types.is_timestamp(at):
        return T.TIMESTAMP
    if pa.types.is_dictionary(at):
        return arrow_type_to_dtype(at.value_type)
    raise TypeError(f"unsupported arrow type: {at}")


def dtype_to_arrow_type(dt: T.DataType) -> pa.DataType:
    if isinstance(dt, T.BooleanType):
        return pa.bool_()
    if isinstance(dt, T.Int8Type):
        return pa.int8()
    if isinstance(dt, T.Int16Type):
        return pa.int16()
    if isinstance(dt, T.Int32Type):
        return pa.int32()
    if isinstance(dt, T.Int64Type):
        return pa.int64()
    if isinstance(dt, T.Float32Type):
        return pa.float32()
    if isinstance(dt, T.Float64Type):
        return pa.float64()
    if isinstance(dt, T.DecimalType):
        return pa.decimal128(dt.precision, dt.scale)
    if isinstance(dt, T.StringType):
        return pa.string()
    if isinstance(dt, T.DateType):
        return pa.date32()
    if isinstance(dt, T.TimestampType):
        return pa.timestamp("us")
    if isinstance(dt, T.ArrayType):
        return pa.list_(dtype_to_arrow_type(dt.element))
    if isinstance(dt, T.MapType):
        return pa.map_(dtype_to_arrow_type(dt.key),
                       dtype_to_arrow_type(dt.value))
    raise TypeError(f"unsupported dtype: {dt}")


def decimal_from_unscaled(unscaled: np.ndarray,
                          typ: pa.DataType,
                          validity: Optional[np.ndarray] = None) -> pa.Array:
    """Exact decimal128 column from unscaled int64 values via the raw
    16-byte little-endian buffer — a per-value python-Decimal loop is
    ~100x slower at lineitem scale. Values must fit int64 (the engine's
    p<=18 cap guarantees it)."""
    unscaled = unscaled.astype(np.int64)
    buf = np.empty((len(unscaled), 2), dtype=np.int64)
    buf[:, 0] = unscaled
    buf[:, 1] = np.where(unscaled < 0, -1, 0)  # sign extension limb
    vbuf = None
    if validity is not None and not validity.all():
        vbuf = pa.py_buffer(np.packbits(
            validity.astype(np.uint8), bitorder="little").tobytes())
    return pa.Array.from_buffers(
        typ, len(unscaled), [vbuf, pa.py_buffer(buf.tobytes())],
        null_count=-1 if vbuf is not None else 0)


def _column_to_numpy(
    arr: pa.ChunkedArray, dtype: T.DataType
) -> Tuple[np.ndarray, Optional[np.ndarray], Optional[Tuple[str, ...]]]:
    """Convert one Arrow column to (values, validity, dictionary)."""
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()

    validity: Optional[np.ndarray] = None
    if arr.null_count > 0:
        validity = pc.is_valid(arr).to_numpy(zero_copy_only=False)

    dictionary: Optional[Tuple[str, ...]] = None
    if isinstance(dtype, T.StringType):
        if not pa.types.is_dictionary(arr.type):
            arr = pc.dictionary_encode(arr)
        # pre-encoded dictionaries may contain a null entry; rows mapping
        # to it are nulls (validity already covers them) — use "" so the
        # sort below stays total
        raw_dict = [s if s is not None else ""
                    for s in arr.dictionary.to_pylist()]
        codes = pc.fill_null(arr.indices, 0).to_numpy(zero_copy_only=False)
        values = np.ascontiguousarray(codes, dtype=np.int32)
        # Normalize to a SORTED, DEDUPLICATED dictionary so code order ==
        # lexicographic order AND code equality == value equality (the
        # engine's GROUP BY/DISTINCT/join invariant): string min/max/
        # compare/sort become plain int32 ops on device. Pre-encoded
        # inputs (dictionary parquet) may legally carry duplicate values
        # — equal strings must collapse to ONE code.
        uniq = sorted(set(raw_dict))
        pos = {s: i for i, s in enumerate(uniq)}
        remap = np.array([pos[s] for s in raw_dict], dtype=np.int32)
        dictionary = tuple(uniq)
        if len(remap):
            values = remap[values]
        if validity is not None:
            values = np.where(validity, values, 0).astype(np.int32)
        return values.astype(np.int32, copy=False), validity, dictionary

    if isinstance(dtype, T.DecimalType):
        if pa.types.is_decimal(arr.type):
            # exact unscaled int64 straight from the decimal128 buffer:
            # low limb of each 16-byte little-endian value (values fit
            # int64 at the engine's p<=18 cap, so the high limb is pure
            # sign extension)
            raw = np.frombuffer(arr.buffers()[1], dtype=np.int64)
            lo = arr.offset * 2
            values = raw[lo:lo + 2 * len(arr):2].copy()
            delta = dtype.scale - arr.type.scale
            if delta > 0:
                limit = (10 ** 18 - 1) // (10 ** delta)
                if len(values) and np.abs(values).max() > limit:
                    raise NotImplementedError(
                        f"rescaling decimal({arr.type.precision},"
                        f"{arr.type.scale}) storage to scale "
                        f"{dtype.scale} overflows the engine's 18-digit "
                        "int64 cap — narrow the schema scale or cast to "
                        "double")
                values = values * (10 ** delta)
            elif delta < 0:
                # HALF_UP, matching every other ->decimal path
                factor = 10 ** (-delta)
                values = (np.sign(values)
                          * ((np.abs(values) + factor // 2) // factor))
            if validity is not None:
                values = np.where(validity, values, 0)
            return values, validity, None
        # non-decimal storage (e.g. float parquet read with a decimal
        # schema): scale + round through float64, HALF_UP like every
        # other float->decimal path (np.rint would be HALF_EVEN)
        f = np.nan_to_num(
            arr.cast(pa.float64()).to_numpy(zero_copy_only=False))
        scaled = f * (10 ** dtype.scale)
        values = (np.sign(scaled)
                  * np.floor(np.abs(scaled) + 0.5)).astype(np.int64)
        return values, validity, None
    if isinstance(dtype, T.DateType):
        arr = arr.cast(pa.int32())
    if isinstance(dtype, T.TimestampType):
        arr = arr.cast(pa.timestamp("us")).cast(pa.int64())
    if isinstance(dtype, T.BooleanType):
        values = arr.to_numpy(zero_copy_only=False).astype(np.bool_)
    else:
        values = arr.to_numpy(zero_copy_only=False)
    values = np.asarray(values)
    if validity is not None:
        # Arrow may hand us an object/NaN-filled array for nullable cols.
        fill = np.zeros((), dtype=dtype.np_dtype)
        values = np.where(validity, values, fill)
    return values.astype(dtype.np_dtype, copy=False), validity, dictionary


def _list_to_padded(col):
    """Arrow list column -> (padded 2-D values, lengths, validity, element
    dictionary, element dtype): the ArrayType layout."""
    if isinstance(col, pa.ChunkedArray):
        col = col.combine_chunks()
    if pa.types.is_large_list(col.type):
        col = col.cast(pa.list_(col.type.value_type))
    validity = None
    if col.null_count > 0:
        validity = pc.is_valid(col).to_numpy(zero_copy_only=False)
    # absolute offsets into col.values: flatten() would drop a null row's
    # value range (legal Arrow) and misalign every later row
    offsets = col.offsets.to_numpy(zero_copy_only=False).astype(np.int64)
    lengths = np.diff(offsets).astype(np.int32)
    if validity is not None:
        lengths = np.where(validity, lengths, 0).astype(np.int32)
    el_dtype = arrow_type_to_dtype(col.type.value_type)
    fvals, _, dictionary = _column_to_numpy(col.values, el_dtype)
    n = len(col)
    max_len = max(1, int(lengths.max()) if n else 1)
    vals = np.zeros((n, max_len), dtype=fvals.dtype)
    if len(fvals):
        jj = np.arange(max_len)[None, :]
        alive = jj < lengths[:, None]
        take = offsets[:-1, None] + jj
        vals[alive] = fvals[take[alive]]
    return vals, lengths, validity, dictionary, el_dtype


def _and_valid(a: Optional[np.ndarray], b: Optional[np.ndarray]):
    if a is None:
        return b
    return a if b is None else a & b


def arrow_to_numpy(table: pa.Table):
    """Arrow table -> (Schema, host arrays, validities): the host half
    of ``from_arrow``. A list column becomes a padded 2-D ArrayType
    column and its ``#len`` companion, a map the ``#keys``/``#vals``
    pair, a struct its dotted children."""
    fields = []
    arrays = []
    validities = []

    def add(name, col, parent_valid=None):
        if isinstance(col, pa.ChunkedArray):
            col = col.combine_chunks()
        own = (pc.is_valid(col).to_numpy(zero_copy_only=False)
               if col.null_count > 0 else None)
        if pa.types.is_struct(col.type):
            pv = _and_valid(parent_valid, own)
            for i, f in enumerate(col.type):
                add(f"{name}.{f.name}", col.field(i), pv)
            return
        if pa.types.is_map(col.type):
            # the map's own nulls ride on both components
            pv = _and_valid(parent_valid, own)
            offsets = col.offsets
            add(T.map_keys_col(name),
                pa.ListArray.from_arrays(offsets, col.keys), pv)
            add(T.map_vals_col(name),
                pa.ListArray.from_arrays(offsets, col.items), pv)
            return
        if pa.types.is_list(col.type) or pa.types.is_large_list(col.type):
            vals, lengths, validity, dictionary, el_dtype = \
                _list_to_padded(col)
            if parent_valid is not None:
                validity = _and_valid(validity, parent_valid)
                lengths = np.where(validity, lengths, 0).astype(np.int32)
            fields.append(Field(name, T.ArrayType(el_dtype),
                                nullable=validity is not None,
                                dictionary=dictionary))
            arrays.append(vals)
            validities.append(validity)
            fields.append(Field(T.array_len_col(name), T.INT32,
                                nullable=False))
            arrays.append(lengths)
            validities.append(None)
            return
        if pa.types.is_nested(col.type):
            raise NotImplementedError(
                f"nested column {name!r} ({col.type}) is not ported yet")
        dtype = arrow_type_to_dtype(col.type)
        values, validity, dictionary = _column_to_numpy(col, dtype)
        # a null struct row means every child field is null
        validity = _and_valid(validity, parent_valid)
        fields.append(Field(name, dtype, nullable=validity is not None,
                            dictionary=dictionary))
        arrays.append(values)
        validities.append(validity)

    for name, col in zip(table.column_names, table.columns):
        add(name, col)
    return Schema(tuple(fields)), arrays, validities


def schema_from_arrow(pa_schema: pa.Schema) -> Schema:
    """The engine schema an Arrow schema ingests as (nested columns
    expanded as ``arrow_to_numpy`` expands them)."""
    empty = pa.table({f.name: pa.array([], type=f.type) for f in pa_schema})
    return arrow_to_numpy(empty)[0]


def source_column(name: str, file_names) -> str:
    """The top-level Arrow column that holds engine column ``name``: the
    array or map behind a ``#len``/``#keys``/``#vals`` name, the struct
    behind a dotted child."""
    if name in file_names:
        return name
    if name.endswith(T.LEN_SUFFIX):
        return source_column(name[:-len(T.LEN_SUFFIX)], file_names)
    base = T.map_base_name(name)
    if base is not None and base in file_names:
        return base
    head = name.split(".", 1)[0]
    if head in file_names:
        return head
    raise KeyError(f"column {name!r} not in {list(file_names)}")


def from_arrow(table: pa.Table, capacity: Optional[int] = None,
               device="cuda") -> Batch:
    """Arrow table -> device Batch (pads to bucketed capacity); see
    ``arrow_to_numpy`` for the host-side column conversion rules."""
    schema, arrays, validities = arrow_to_numpy(table)
    return from_numpy(schema, arrays, validities, capacity=capacity,
                      device=device)


def _flat_arrow(f: Field, data: np.ndarray,
                valid: Optional[np.ndarray]) -> pa.Array:
    """One flat column's values (live rows) as an Arrow array."""
    nulls = None if valid is None else ~valid
    if isinstance(f.dtype, T.StringType):
        codes = pa.array(data, type=pa.int32(), mask=nulls)
        return pa.DictionaryArray.from_arrays(
            codes, pa.array(list(f.dictionary or ()), type=pa.string())
        ).cast(pa.string())
    if isinstance(f.dtype, T.DateType):
        return pa.array(data, type=pa.int32(), mask=nulls).cast(pa.date32())
    if isinstance(f.dtype, T.TimestampType):
        return pa.array(data, type=pa.int64(), mask=nulls).cast(
            pa.timestamp("us"))
    if isinstance(f.dtype, T.DecimalType):
        return decimal_from_unscaled(
            data, pa.decimal128(f.dtype.precision, f.dtype.scale), valid)
    return pa.array(data, type=dtype_to_arrow_type(f.dtype), mask=nulls)


def to_arrow(batch: Batch) -> pa.Table:
    """Device Batch -> Arrow table with only live rows. Array columns
    become lists (their ``#len`` companions are dropped), a
    ``#keys``/``#vals`` pair one map column named by the map."""
    mask, host_cols = batch.fetch_host()
    fields = batch.schema.fields
    by_name = {f.name: i for i, f in enumerate(fields)}
    hidden = {T.array_len_col(f.name) for f in fields
              if isinstance(f.dtype, T.ArrayType)}

    def rebuild_list(i):
        """(int32 offsets, flat element values, validity) of array
        column ``i``'s live rows."""
        f = fields[i]
        cdata, cvalid = host_cols[i]
        data = cdata[mask]
        valid = None if cvalid is None else cvalid[mask]
        comp = by_name.get(T.array_len_col(f.name))
        lens = (host_cols[comp][0][mask].astype(np.int64)
                if comp is not None
                else np.full(len(data), data.shape[1], np.int64))
        if valid is not None:
            lens = np.where(valid, lens, 0)
        offsets = np.zeros(len(data) + 1, dtype=np.int32)
        np.cumsum(lens, out=offsets[1:])
        alive = np.arange(data.shape[1])[None, :] < lens[:, None]
        el = Field(f.name, f.dtype.element, dictionary=f.dictionary)
        return offsets, _flat_arrow(el, data[alive], None), valid

    columns, names = [], []
    for i, f in enumerate(fields):
        if f.name in hidden:
            continue
        if isinstance(f.dtype, T.ArrayType):
            base = T.map_base_name(f.name)
            pair = (base is not None and T.map_keys_col(base) in by_name
                    and T.map_vals_col(base) in by_name)
            if pair and f.name == T.map_vals_col(base):
                continue  # emitted with its '#keys' sibling
            offsets, values, valid = rebuild_list(i)
            omask = (None if valid is None or valid.all()
                     else np.concatenate([~valid, [False]]))
            off = pa.array(offsets, pa.int32(), mask=omask)
            if pair:
                _, items, _ = rebuild_list(by_name[T.map_vals_col(base)])
                columns.append(pa.MapArray.from_arrays(off, values, items))
                names.append(base)
            else:
                columns.append(pa.ListArray.from_arrays(off, values))
                names.append(f.name)
            continue
        cdata, cvalid = host_cols[i]
        columns.append(_flat_arrow(f, cdata[mask],
                                   None if cvalid is None else cvalid[mask]))
        names.append(f.name)
    return pa.table(columns, names=names)
