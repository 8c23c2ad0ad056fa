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

Every tensor of a batch lies on one device.
"""

from __future__ import annotations

import datetime
import decimal
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_tpu_torch.types import (DateType, DecimalType, Schema,
                                   StringType, TimestampType)


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

    __slots__ = ("schema", "data")

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

    def to_pylist(self) -> list:
        """Materialize live rows as a list of dicts (decoding string
        dictionaries, dates and decimals). For tests and ``collect()``."""
        mask, host_cols = self.fetch_host()
        cols = []
        for f, (cdata, cvalid) in zip(self.schema.fields, host_cols):
            data = cdata[mask]
            valid = (np.ones(len(data), dtype=bool) if cvalid is None
                     else cvalid[mask])
            if isinstance(f.dtype, StringType):
                dictionary = f.dictionary or ()
                vals = [
                    dictionary[c] if (v and 0 <= c < len(dictionary)) else None
                    for c, v in zip(data, valid)
                ]
            elif isinstance(f.dtype, DateType):
                epoch = datetime.date(1970, 1, 1)
                vals = [
                    epoch + datetime.timedelta(days=int(d)) if v else None
                    for d, v in zip(data, valid)
                ]
            elif isinstance(f.dtype, TimestampType):
                epoch = datetime.datetime(1970, 1, 1)
                vals = [
                    epoch + datetime.timedelta(microseconds=int(d)) if v
                    else None
                    for d, v in zip(data, valid)
                ]
            elif isinstance(f.dtype, DecimalType):
                s = f.dtype.scale
                vals = [
                    decimal.Decimal(int(d)).scaleb(-s) if v else None
                    for d, v in zip(data, valid)
                ]
            else:
                vals = [d.item() if v else None for d, v in zip(data, valid)]
            cols.append(vals)
        names = self.schema.names
        n_rows = len(cols[0]) if cols else 0
        return [{name: col[i] for name, col in zip(names, cols)}
                for i in range(n_rows)]


def round_capacity(n: int, multiple: int = 1024) -> int:
    """Round row count up to a bucketed capacity."""
    if n <= 0:
        return multiple
    return ((n + multiple - 1) // multiple) * multiple


def from_numpy(
    schema: Schema,
    arrays: Sequence[np.ndarray],
    validities: Optional[Sequence[Optional[np.ndarray]]] = None,
    capacity: Optional[int] = None,
    device="cuda",
) -> Batch:
    """Build a device batch from host numpy columns, padding to capacity."""
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
        if arr.ndim != 1:
            raise NotImplementedError("array columns are not ported yet")
        padded = np.zeros((cap,), dtype=f.dtype.np_dtype)
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
