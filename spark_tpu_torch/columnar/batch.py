"""Device-side columnar batch, as torch tensors.

The port of ``spark_tpu/columnar/batch.py``. The layout is the
reference's:

- A batch has a *static* row capacity. Live rows are tracked with a
  boolean ``row_mask`` instead of a dynamic length: filters flip mask
  bits, they never compact.
- Per-column nulls are separate boolean validity tensors (Arrow-style),
  ``None`` meaning "all valid".
- Strings are int32 dictionary codes; the dictionary itself lives on the
  host in the Schema, never on the device.
- An array column is a padded 2-D tensor (capacity, max_len) with its
  lengths in the hidden int32 column ``<col>#len``; a map column is the
  pair of array columns ``<col>#keys``/``<col>#vals`` (types.ArrayType,
  types.MapType). Results hide the companions and join map pairs.

Every tensor of a batch lies on one device.
"""

from __future__ import annotations

import decimal
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_tpu_torch import types as T
from spark_tpu_torch.types import (ArrayType, DateType, DecimalType, Field,
                                   Schema, StringType, TimestampType)


class ColumnData(NamedTuple):
    """Device tensors for one column: dense values + optional validity."""

    data: torch.Tensor
    validity: Optional[torch.Tensor]  # bool[capacity]; None = all valid


class BatchData(NamedTuple):
    """Device half of a batch: column tensors + live-row mask.

    All tensors share the same leading (and only) dimension: the static
    row capacity. ``row_mask[i]`` False means row i does not exist
    (filtered out or padding) — distinct from SQL NULL.
    """

    columns: Tuple[ColumnData, ...]
    row_mask: torch.Tensor  # bool[capacity]

    @property
    def capacity(self) -> int:
        return int(self.row_mask.shape[0])


class Batch:
    """Host-level pairing of a Schema with BatchData."""

    __slots__ = ("schema", "data", "__weakref__")

    def __init__(self, schema: Schema, data: BatchData):
        if len(schema) != len(data.columns):
            raise ValueError(f"schema arity {len(schema)} != data arity "
                             f"{len(data.columns)}")
        self.schema = schema
        self.data = data

    @property
    def capacity(self) -> int:
        return self.data.capacity

    def __repr__(self) -> str:
        return f"Batch({self.schema}, capacity={self.capacity})"

    # ---- host materialization -------------------------------------------

    def fetch_host(self):
        """Copy the batch to host numpy arrays.

        Returns (mask: np.bool_[cap], [(data, validity|None)] per column).
        """
        def host(t):
            return None if t is None else t.cpu().numpy()

        return host(self.data.row_mask), [
            (host(cd.data), host(cd.validity)) for cd in self.data.columns]

    def select(self, names) -> "Batch":
        """The batch narrowed to the columns ``names``, in that order."""
        idx = [self.schema.index(n) for n in names]
        return Batch(Schema(tuple(self.schema.fields[i] for i in idx)),
                     BatchData(tuple(self.data.columns[i] for i in idx),
                               self.data.row_mask))

    def device_nbytes(self) -> int:
        """Device bytes held by this batch: values, validity and mask."""
        total = self.data.row_mask.numel() * self.data.row_mask.element_size()
        for cd in self.data.columns:
            total += cd.data.numel() * cd.data.element_size()
            if cd.validity is not None:
                total += cd.validity.numel() * cd.validity.element_size()
        return int(total)

    def to_pylist(self) -> list:
        """Materialize live rows as a list of dicts (decoding string
        dictionaries, dates, timestamps, decimals, arrays and maps);
        ``collect()`` builds its Rows from ``result_columns`` directly."""
        names, cols = self.result_columns()
        return [dict(zip(names, vals)) for vals in zip(*cols)]

    def to_pandas(self):
        """The live rows as a pandas DataFrame (imports pandas)."""
        import pandas as pd

        names, cols = self.result_columns()
        return pd.DataFrame(dict(zip(names, cols)), columns=names)

    def result_columns(self) -> Tuple[list, list]:
        """(names, values) of the visible columns: each a list of the
        live rows' Python values (None where null), decoded a whole
        column at a time. An array's ``#len`` companion is hidden and its
        rows are lists cut to their lengths; a ``#keys``/``#vals`` pair
        becomes one column of dicts named by the map."""
        mask, host_cols = self.fetch_host()
        fields = self.schema.fields
        by_name = {f.name: i for i, f in enumerate(fields)}
        hidden = {T.array_len_col(f.name) for f in fields
                  if isinstance(f.dtype, ArrayType)}
        names: list = []
        cols: list = []
        for i, (f, (cdata, cvalid)) in enumerate(zip(fields, host_cols)):
            if f.name in hidden:
                continue
            base = T.map_base_name(f.name)
            if base is not None and isinstance(f.dtype, ArrayType):
                kn, vn = T.map_keys_col(base), T.map_vals_col(base)
                if kn in by_name and vn in by_name:
                    if f.name == vn:
                        continue  # emitted with its '#keys' sibling
                    keys = self._array_values(i, mask, host_cols, by_name)
                    vals = self._array_values(by_name[vn], mask, host_cols,
                                              by_name)
                    names.append(base)
                    cols.append([None if k is None else dict(zip(k, v))
                                 for k, v in zip(keys, vals)])
                    continue
            names.append(f.name)
            if isinstance(f.dtype, ArrayType):
                cols.append(self._array_values(i, mask, host_cols, by_name))
            else:
                cols.append(_decode(f, cdata[mask],
                                    None if cvalid is None
                                    else cvalid[mask]))
        return names, cols

    def _array_values(self, i: int, mask, host_cols, by_name) -> list:
        """Column ``i`` (an array) as one list per live row, cut to the
        row's length (from the ``#len`` companion; the full width without
        one), elements decoded as a flat column of the element type."""
        f = self.schema.fields[i]
        cdata, cvalid = host_cols[i]
        data = cdata[mask]
        valid = None if cvalid is None else cvalid[mask]
        comp = by_name.get(T.array_len_col(f.name))
        if comp is not None:
            lens = host_cols[comp][0][mask].astype(np.int64)
        else:
            lens = np.full(len(data), data.shape[1] if data.ndim > 1 else 0,
                           dtype=np.int64)
        if valid is not None:
            lens = np.where(valid, lens, 0)
        width = data.shape[1] if data.ndim > 1 else 0
        lens = np.minimum(lens, width)
        alive = np.arange(width)[None, :] < lens[:, None]
        flat = _decode(Field(f.name, f.dtype.element,
                             dictionary=f.dictionary),
                       data[alive] if width else data.reshape(-1)[:0], None)
        ends = np.cumsum(lens).tolist()
        starts = [0] + ends[:-1]
        out = [flat[a:b] for a, b in zip(starts, ends)]
        return _with_nulls(out, valid)


def _decode(f, data: np.ndarray, valid: Optional[np.ndarray]) -> list:
    """One column's live values as Python objects: ``str`` (a code
    outside the dictionary reads as None), ``datetime.date``,
    ``datetime.datetime``, ``decimal.Decimal`` at the column's scale, or
    the numpy values' own Python types."""
    if isinstance(f.dtype, StringType):
        dictionary = np.array(list(f.dictionary or ()) + [None],
                              dtype=object)
        codes = data.astype(np.int64)
        codes[(codes < 0) | (codes >= len(dictionary) - 1)] = \
            len(dictionary) - 1
        vals = dictionary[codes]
    elif isinstance(f.dtype, DateType):
        vals = data.astype("datetime64[D]").astype(object)
    elif isinstance(f.dtype, TimestampType):
        vals = data.astype("datetime64[us]").astype(object)
    elif isinstance(f.dtype, DecimalType):
        neg_scale = -f.dtype.scale
        return _with_nulls([decimal.Decimal(d).scaleb(neg_scale)
                            for d in data.tolist()], valid)
    else:
        return _with_nulls(data.tolist(), valid)
    return _with_nulls(vals.tolist(), valid)


def _with_nulls(vals: list, valid: Optional[np.ndarray]) -> list:
    if valid is None or valid.all():
        return vals
    for i in np.flatnonzero(~valid).tolist():
        vals[i] = None
    return vals


def round_capacity(n: int, multiple: int = 1024) -> int:
    """Round row count up to a bucketed capacity."""
    if n <= 0:
        return multiple
    return ((n + multiple - 1) // multiple) * multiple


def pad_host(schema: Schema, arrays: Sequence[np.ndarray],
             validities: Optional[Sequence[Optional[np.ndarray]]] = None,
             capacity: Optional[int] = None):
    """Host columns padded to one capacity, in the schema's dtypes:
    (datas, validities, row_mask), ready for ``from_host_arrays``."""
    n = int(arrays[0].shape[0]) if arrays else 0
    for a in arrays:
        if a.shape[0] != n:
            raise ValueError("all columns must have equal length")
    cap = capacity if capacity is not None else round_capacity(n)
    if cap < n:
        raise ValueError(f"capacity {cap} < {n} rows")
    if validities is None:
        validities = [None] * len(arrays)
    datas, valids = [], []
    for f, arr, val in zip(schema.fields, arrays, validities):
        # an array column is 2-D: (rows, max_len) of its element's dtype
        padded = np.zeros((cap,) + tuple(arr.shape[1:]),
                          dtype=f.dtype.np_dtype)
        padded[:n] = arr.astype(f.dtype.np_dtype, copy=False)
        datas.append(padded)
        if val is None:
            valids.append(None)
        else:
            pv = np.zeros((cap,), dtype=bool)
            pv[:n] = val
            valids.append(pv)
    row_mask = np.zeros((cap,), dtype=bool)
    row_mask[:n] = True
    return datas, valids, row_mask


def from_numpy(
    schema: Schema,
    arrays: Sequence[np.ndarray],
    validities: Optional[Sequence[Optional[np.ndarray]]] = None,
    capacity: Optional[int] = None,
    device="cuda",
) -> Batch:
    """Build a device batch from host numpy columns, padding to capacity."""
    datas, valids, row_mask = pad_host(schema, arrays, validities, capacity)
    return from_host_arrays(schema, datas, valids, row_mask, device)


def from_host_arrays(schema: Schema, datas: Sequence[np.ndarray],
                     validities: Sequence[Optional[np.ndarray]],
                     row_mask: np.ndarray, device="cuda") -> Batch:
    """A port batch holding exactly these host arrays (already padded to
    one capacity): the values, validities and row mask of a reference
    ``Batch`` carried across, so both engines start from identical
    state. Each column's dtype is the schema's."""
    dev = torch.device(device)

    def put(arr, np_dtype):
        # np.array copies: the batch never aliases the caller's arrays
        return torch.from_numpy(np.array(arr, dtype=np_dtype)).to(dev)

    cols = [ColumnData(put(d, f.dtype.np_dtype),
                       None if v is None else put(v, bool))
            for f, d, v in zip(schema.fields, datas, validities)]
    return Batch(schema, BatchData(tuple(cols), put(row_mask, bool)))


def empty_batch(schema: Schema, capacity: int = 1024,
                device="cuda") -> Batch:
    """A batch of ``schema`` with no live row (array columns one element
    wide)."""
    arrays = [np.zeros((0, 1) if isinstance(f.dtype, ArrayType) else (0,),
                       dtype=f.dtype.np_dtype) for f in schema.fields]
    return from_numpy(schema, arrays, capacity=capacity, device=device)
