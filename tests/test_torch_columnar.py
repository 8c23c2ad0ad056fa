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
