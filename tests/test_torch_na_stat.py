"""The port's ``df.na``, ``df.stat``, ``describe`` and ``summary``
(``spark_tpu_torch/api/na_stat.py``) against the JAX package on the
inputs of tests/test_na_stat.py, plus a wider table with NULLs in every
column (numpy-seeded). Each case is written once, over a session, and
run through both packages.

Rows must be equal: integers, strings and NULLs exactly; floats within
rel 1e-12 (the two packages may add a column's values in another order:
describe's mean and stddev, corr and cov come from float sums). The
original asserts of tests/test_na_stat.py hold for the port too.
sampleBy's rows equal the reference's exactly: both draw the threefry
stream of ``physical/random.py`` / ``jax.random.uniform``.
"""

import json
import math

import numpy as np
import pyarrow as pa
import pytest

from spark_tpu.expr import expressions as RE
from spark_tpu_torch.api.session import SparkSession as PortSession
from spark_tpu_torch.expr import expressions as PE

from test_torch_threads import one_torch_thread  # noqa: F401

REL = 1e-12

NA_TABLE = pa.table({
    "a": pa.array([1, None, 3, None, 5], pa.int64()),
    "b": pa.array([10.0, 20.0, None, None, 50.0]),
    "s": pa.array(["x", None, "y", "x", None]),
})


def _wide_table(n=400, seed=5):
    rng = np.random.default_rng(seed)

    def holes(vals, p):
        vals = vals.astype(object)
        vals[rng.random(n) < p] = None
        return list(vals)

    return pa.table({
        "i": pa.array(holes(rng.integers(-50, 50, n), 0.1), pa.int64()),
        "f": pa.array(holes(rng.normal(size=n) * 100, 0.2), pa.float64()),
        "g": pa.array(rng.integers(0, 4, n), pa.int64()),
        "t": pa.array(holes(np.array(["p", "q", "r"])[
            rng.integers(0, 3, n)], 0.15), pa.string()),
    })


@pytest.fixture(scope="module")
def engines(spark):
    return {"ref": (spark, RE), "port": (
        PortSession.builder.device("cpu").getOrCreate(), PE)}


def _close(a, b):
    if isinstance(a, float) and isinstance(b, float):
        return (math.isnan(a) and math.isnan(b)) or a == pytest.approx(
            b, rel=REL, abs=1e-300)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))
    return a == b and type(a) is type(b)


def _both(engines, case):
    """``case(session, expressions module)`` through both packages: the
    port's result equals the reference's and is returned."""
    got = case(*engines["port"])
    want = case(*engines["ref"])
    assert _close(got, want), (got, want)
    return got


def _rows(df):
    return [tuple(r) for r in df.collect()]


def test_dropna_any_all_thresh(engines):
    def case(s, E):
        df = s.createDataFrame(NA_TABLE)
        return [df.na.drop().count(), df.na.drop("all").count(),
                df.na.drop("all", subset=["a", "b"]).count(),
                df.dropna(subset=["a"]).count(),
                df.na.drop(thresh=2).count(), df.na.drop(thresh=1).count(),
                _rows(df.na.drop(thresh=2))]
    got = _both(engines, case)
    assert got[:6] == [1, 5, 4, 3, 3, 5]


def test_fillna(engines):
    def case(s, E):
        df = s.createDataFrame(NA_TABLE)
        return [_rows(df.fillna(0, subset=["a"])),
                _rows(df.fillna({"a": -1, "b": 9.5})),
                _rows(df.fillna("zz")), _rows(df.na.fill(7))]
    got = _both(engines, case)
    assert [r[0] for r in got[0]] == [1, 0, 3, 0, 5]
    assert [r[1] for r in got[1]] == [10.0, 20.0, 9.5, 9.5, 50.0]
    assert [r[2] for r in got[2]] == ["x", "zz", "y", "x", "zz"]


def test_replace(engines):
    def case(s, E):
        df = s.createDataFrame(NA_TABLE)
        return [_rows(df.replace(1, 100, subset=["a"])),
                _rows(df.replace([10.0, 50.0], [11.0, 51.0])),
                _rows(df.replace({"x": "X"})),
                _rows(df.na.replace("y", "Y", subset=["s"]))]
    got = _both(engines, case)
    assert [r[0] for r in got[0]] == [100, None, 3, None, 5]
    assert [r[1] for r in got[1]] == [11.0, 20.0, None, None, 51.0]


def test_corr_cov(engines):
    xs = [float(x) for x in range(50)]
    table = pa.table({"x": pa.array(xs),
                      "y": pa.array([3.0 * x + 1.0 for x in xs])})

    def case(s, E):
        d = s.createDataFrame(table)
        return [d.corr("x", "y"), d.cov("x", "y"), d.stat.corr("y", "x")]
    got = _both(engines, case)
    assert abs(got[0] - 1.0) < 1e-9
    assert abs(got[1] - float(np.cov(xs, [3.0 * x + 1.0 for x in xs])[0][1])
               ) < 1e-6


def test_corr_cov_pairwise_null_deletion(engines):
    table = pa.table({"x": pa.array([1.0, 2.0, 3.0, None, 100.0]),
                      "y": pa.array([2.0, 4.0, 6.0, 50.0, None])})

    def case(s, E):
        d = s.createDataFrame(table)
        return [d.stat.corr("x", "y"), d.stat.cov("x", "y")]
    got = _both(engines, case)
    assert abs(got[0] - 1.0) < 1e-12 and abs(got[1] - 2.0) < 1e-12


def test_approx_quantile(engines):
    table = pa.table({"v": pa.array([float(i) for i in range(100)]),
                      "w": pa.array([float(i % 7) for i in range(100)])})

    def case(s, E):
        d = s.createDataFrame(table)
        return [d.approxQuantile("v", [0.0, 0.5, 0.99]),
                d.stat.approxQuantile(["v", "w"], [0.25, 0.75], 0.01)]
    got = _both(engines, case)
    q = got[0]
    assert q[0] == 0.0 and 49.0 <= q[1] <= 51.0 and q[2] >= 98.0


def test_crosstab_freqitems(engines):
    table = pa.table({"k": pa.array(["a", "a", "b", "b", "b"]),
                      "v": pa.array([1, 2, 1, 1, 2], pa.int64())})

    def case(s, E):
        d = s.createDataFrame(table)
        ct = sorted(_rows(d.crosstab("k", "v")))
        fi = d.freqItems(["k", "v"], support=0.5).collect()[0]
        return [ct, fi["k_freqItems"], fi["v_freqItems"]]
    got = _both(engines, case)
    assert got[0] == [("a", 1, 1), ("b", 2, 1)]
    assert json.loads(got[1]) == ["b"]


def test_sample_by(engines):
    def case(s, E):
        d = s.range(1000).withColumn("g", E.Col("id") % 2)
        only_odd = _rows(d.sampleBy("g", {0: 0.0, 1: 1.0}, seed=1))
        mixed = _rows(d.sampleBy("g", {0: 0.3, 1: 0.6}, seed=11))
        return [only_odd, mixed]
    got = _both(engines, case)
    assert all(r[1] == 1 for r in got[0]) and 400 <= len(got[0]) <= 500
    assert 0 < len(got[1]) < 1000


def test_describe(engines):
    table = pa.table({"v": pa.array([1.0, 2.0, 3.0, 4.0])})

    def case(s, E):
        return _rows(s.createDataFrame(table).describe())
    rows = {r[0]: r[1] for r in _both(engines, case)}
    assert rows["count"] == "4" and float(rows["mean"]) == 2.5
    assert abs(float(rows["stddev"]) - 1.2909944487358056) < 1e-9


def _as_numbers(rows):
    """describe's strings as floats (compared within REL), its labels
    and NULLs as they are."""
    return [tuple(v if v is None or i == 0 else float(v)
                  for i, v in enumerate(r)) for r in rows]


def test_describe_summary_wide(engines):
    """describe and summary over a seeded table with NULLs: every
    numeric column, the string column left out; the statistics within
    REL of the reference's."""
    table = _wide_table()

    def case(s, E):
        d = s.createDataFrame(table)
        return [_as_numbers(_rows(d.describe())),
                _as_numbers(_rows(d.summary("f"))),
                list(d.describe().columns)]
    got = _both(engines, case)
    assert got[2] == ["summary", "i", "f", "g"]


def test_na_stat_wide(engines):
    """drop/fill/replace and the statistics over the seeded table."""
    table = _wide_table(seed=9)

    def case(s, E):
        d = s.createDataFrame(table)
        return [d.dropna().count(),
                d.na.drop("all", subset=["f", "t"]).count(),
                d.na.drop(thresh=3).count(),
                sorted(_rows(d.fillna({"t": "none", "i": 0})
                             .groupBy("t").count())),
                sorted(_rows(d.replace("p", "P").groupBy("t").count()),
                       key=str),
                d.corr("i", "f"), d.cov("g", "f"),
                d.approxQuantile("f", [0.1, 0.5, 0.9])]
    _both(engines, case)
