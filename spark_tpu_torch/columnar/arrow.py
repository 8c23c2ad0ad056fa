"""Arrow <-> device-batch interchange.

The port of ``spark_tpu/columnar/arrow.py`` for flat columns: booleans,
integers, floats, decimal128 (as scaled int64), dictionary or plain
strings (as int32 codes over a sorted host dictionary), date32 and
timestamps, with nulls as validity masks. Nested columns (lists,
structs, maps) are not ported yet.
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


def arrow_to_numpy(table: pa.Table):
    """Arrow table -> (Schema, host arrays, validities): the host half
    of ``from_arrow``."""
    fields = []
    arrays = []
    validities = []
    for name, col in zip(table.column_names, table.columns):
        if pa.types.is_nested(col.type):
            raise NotImplementedError(
                f"nested column {name!r} ({col.type}) is not ported yet")
        dtype = arrow_type_to_dtype(col.type)
        values, validity, dictionary = _column_to_numpy(col, dtype)
        fields.append(Field(name, dtype, nullable=validity is not None,
                            dictionary=dictionary))
        arrays.append(values)
        validities.append(validity)
    return Schema(tuple(fields)), arrays, validities


def from_arrow(table: pa.Table, capacity: Optional[int] = None,
               device="cuda") -> Batch:
    """Arrow table -> device Batch (pads to bucketed capacity); see
    ``arrow_to_numpy`` for the host-side column conversion rules."""
    schema, arrays, validities = arrow_to_numpy(table)
    return from_numpy(schema, arrays, validities, capacity=capacity,
                      device=device)


def to_arrow(batch: Batch) -> pa.Table:
    """Device Batch -> Arrow table with only live rows."""
    mask, host_cols = batch.fetch_host()
    columns = []
    for f, (cdata, cvalid) in zip(batch.schema.fields, host_cols):
        data = cdata[mask]
        valid = None if cvalid is None else cvalid[mask]
        nulls = None if valid is None else ~valid
        if isinstance(f.dtype, T.StringType):
            codes = pa.array(data, type=pa.int32(), mask=nulls)
            arr = pa.DictionaryArray.from_arrays(
                codes, pa.array(list(f.dictionary or ()), type=pa.string())
            ).cast(pa.string())
        elif isinstance(f.dtype, T.DateType):
            arr = pa.array(data, type=pa.int32(), mask=nulls).cast(
                pa.date32())
        elif isinstance(f.dtype, T.TimestampType):
            arr = pa.array(data, type=pa.int64(), mask=nulls).cast(
                pa.timestamp("us"))
        elif isinstance(f.dtype, T.DecimalType):
            arr = decimal_from_unscaled(
                data, pa.decimal128(f.dtype.precision, f.dtype.scale),
                valid)
        else:
            arr = pa.array(data, type=dtype_to_arrow_type(f.dtype),
                           mask=nulls)
        columns.append(arr)
    return pa.table(columns, names=list(batch.schema.names))
