"""The port's Arrow interchange and batch materialization
(spark_tpu_torch/columnar) against the reference's, on tables with
nulls, dictionary and plain strings, decimal128, date32, timestamps,
booleans, ints and floats. Rows must be equal exactly."""

import datetime
import decimal

import numpy as np
import pyarrow as pa
import pytest

from spark_tpu.columnar.arrow import from_arrow as ref_from_arrow
from spark_tpu_torch.columnar.arrow import from_arrow, to_arrow

from test_torch_threads import one_torch_thread  # noqa: F401


def _table(n: int = 300, seed: int = 4):
    rng = np.random.default_rng(seed)
    null = rng.random(n) < 0.1
    words = np.array(["delta", "alpha", "", "charlie", "bravo"])
    cents = rng.integers(-10 ** 9, 10 ** 9, n)
    return pa.table({
        "i": pa.array(rng.integers(-50, 50, n), pa.int64(), mask=null),
        "i32": pa.array(rng.integers(0, 9, n).astype(np.int32)),
        "f": pa.array(rng.normal(size=n).astype(np.float32)),
        "d": pa.array(rng.normal(size=n), mask=~null),
        "b": pa.array(rng.random(n) < 0.5),
        "s": pa.array(list(words[rng.integers(0, 5, n)]), mask=null),
        "ds": pa.DictionaryArray.from_arrays(
            pa.array(rng.integers(0, 3, n).astype(np.int32)),
            pa.array(["zeta", "eta", "theta"])),
        "m": pa.array([decimal.Decimal(int(c)).scaleb(-2) for c in cents],
                      pa.decimal128(12, 2), mask=null),
        "dt": pa.array(rng.integers(0, 20000, n).astype(np.int32),
                       pa.int32()).cast(pa.date32()),
        "ts": pa.array(rng.integers(0, 10 ** 15, n), pa.int64()).cast(
            pa.timestamp("us")),
    })


@pytest.mark.parametrize("capacity", [None, 2048])
def test_from_arrow_to_pylist_matches_reference(capacity):
    t = _table()
    got = from_arrow(t, capacity=capacity, device="cpu")
    want = ref_from_arrow(t, capacity=capacity)
    assert got.capacity == want.capacity
    def fields(schema):
        return [(f.name, repr(f.dtype), f.nullable, f.dictionary)
                for f in schema.fields]

    assert fields(got.schema) == fields(want.schema)
    assert got.to_pylist() == want.to_pylist()


def test_to_arrow_round_trip():
    t = _table()
    back = to_arrow(from_arrow(t, device="cpu"))
    plain = t.set_column(t.schema.get_field_index("ds"), "ds",
                         t["ds"].cast(pa.string()))
    assert back.to_pylist() == plain.to_pylist()
    row = back.slice(0, 1).to_pylist()[0]
    assert isinstance(row["dt"], datetime.date)
    assert isinstance(row["ts"], datetime.datetime)


def _per_cell_rows(batch) -> list:
    """``Batch.to_pylist`` as it was before columns were decoded whole:
    one Python value per cell. The vectorised decoding must give the same
    rows, value for value and type for type."""
    from spark_tpu_torch.types import (DateType, DecimalType, StringType,
                                       TimestampType)

    mask, host_cols = batch.fetch_host()
    cols = []
    for f, (cdata, cvalid) in zip(batch.schema.fields, host_cols):
        data = cdata[mask]
        valid = (np.ones(len(data), dtype=bool) if cvalid is None
                 else cvalid[mask])
        if isinstance(f.dtype, StringType):
            d = f.dictionary or ()
            vals = [d[c] if (v and 0 <= c < len(d)) else None
                    for c, v in zip(data, valid)]
        elif isinstance(f.dtype, DateType):
            epoch = datetime.date(1970, 1, 1)
            vals = [epoch + datetime.timedelta(days=int(x)) if v else None
                    for x, v in zip(data, valid)]
        elif isinstance(f.dtype, TimestampType):
            epoch = datetime.datetime(1970, 1, 1)
            vals = [epoch + datetime.timedelta(microseconds=int(x)) if v
                    else None for x, v in zip(data, valid)]
        elif isinstance(f.dtype, DecimalType):
            vals = [decimal.Decimal(int(x)).scaleb(-f.dtype.scale) if v
                    else None for x, v in zip(data, valid)]
        else:
            vals = [x.item() if v else None for x, v in zip(data, valid)]
        cols.append(vals)
    return [dict(zip(batch.schema.names, vals)) for vals in zip(*cols)]


def _typed(rows):
    """Rows with each value's type and, for Decimals, its exponent, so
    that equal lists mean equal types and representations; NaN as a
    string, so that it equals itself."""
    return [{k: (type(v), v.as_tuple() if isinstance(v, decimal.Decimal)
                 else "nan" if v != v else v) for k, v in r.items()}
            for r in rows]


@pytest.mark.parametrize("seed", [4, 5])
def test_to_pylist_matches_per_cell_decoding(seed):
    table = _table(seed=seed)
    n = table.num_rows
    rng = np.random.default_rng(seed)
    f = np.asarray(table.column("d").to_numpy(zero_copy_only=False))
    f[rng.random(n) < 0.05] = np.nan
    table = table.set_column(3, "d", pa.array(f, mask=rng.random(n) < 0.1))
    table = table.append_column("z", pa.array(
        [decimal.Decimal(0).scaleb(-3)] * n, pa.decimal128(9, 3)))
    batch = from_arrow(table, capacity=512, device="cpu")
    # rows past the live ones, and a dead row in the middle
    batch.data.row_mask[7] = False
    # a code past the dictionary reads as None
    batch.data.columns[6].data[3] = 99
    got = batch.to_pylist()
    want = _per_cell_rows(batch)
    assert len(got) == n - 1
    assert _typed(got) == _typed(want)
    assert any(r["d"] is None for r in got) and any(
        r["d"] != r["d"] for r in got if r["d"] is not None)
    assert got[3]["ds"] is None


def test_to_pylist_empty_and_all_null():
    table = pa.table({"s": pa.array([None, None], pa.string()),
                      "m": pa.array([None, None], pa.decimal128(5, 2)),
                      "t": pa.array([None, None], pa.date32())})
    batch = from_arrow(table, device="cpu")
    assert batch.to_pylist() == _per_cell_rows(batch) == [
        {"s": None, "m": None, "t": None}] * 2
    batch.data.row_mask[:] = False
    assert batch.to_pylist() == []
