"""The port's pandas API (``spark_tpu_torch/pandas``) against the JAX
package's on the cases of tests/test_pandas_api.py: each case is written
once over a ``ps`` module, runs through both packages and must give
equal pandas frames (``assert_frame_equal``: the same columns, dtypes
and values), or equal scalars, exactly. The port's frames run on the
active session, the CPU one the fixture makes.
"""

import numpy as np
import pandas as pd
import pytest

import spark_tpu.pandas as rps
import spark_tpu_torch.pandas as pps
from spark_tpu_torch.api.session import SparkSession as PortSession

DATA = pd.DataFrame({
    "k": ["a", "b", "a", "c", "b", "a"],
    "x": [1, 2, 3, 4, 5, 6],
    "y": [1.5, 2.5, 3.5, 4.5, 5.5, 6.5],
})


@pytest.fixture(scope="module")
def engines(spark):
    """Each package's ``ps`` module, its session active."""
    PortSession.builder.device("cpu").master("local").getOrCreate()
    return {"ref": rps, "port": pps}


def _frames_equal(got, want, sort=None):
    if sort is not None:
        got = got.sort_values(sort).reset_index(drop=True)
        want = want.sort_values(sort).reset_index(drop=True)
    pd.testing.assert_frame_equal(got, want)


def _both(engines, case, sort=None):
    """``case(ps)`` through both packages; a frame (or a tuple of frames
    and values) equal to the reference's, returned."""
    got, want = case(engines["port"]), case(engines["ref"])
    items = (got, want) if not isinstance(got, tuple) else None
    pairs = [items] if items else list(zip(got, want))
    for g, w in pairs:
        if isinstance(g, pd.DataFrame):
            _frames_equal(g, w, sort)
        elif isinstance(g, pd.Series):
            pd.testing.assert_series_equal(g, w)
        else:
            assert g == w and type(g) is type(w), (g, w)
    return got


def test_filter_and_select(engines):
    def case(ps):
        f = ps.from_pandas(DATA)
        return f[f.x > 3][["k", "x"]].to_pandas()

    out = _both(engines, case, sort="x")
    want = DATA[DATA.x > 3][["k", "x"]].reset_index(drop=True)
    _frames_equal(out, want, sort="x")


def test_column_arith_and_assign(engines):
    def case(ps):
        f = ps.from_pandas(DATA)
        g = f.assign(z=f.x * 2 + f.y, w=3)
        g["v"] = g.x - g.y / 2
        return g.to_pandas(), (g.z * 1).to_pandas()

    out = _both(engines, case)[0]
    assert (out.z == out.x * 2 + out.y).all()


def test_groupby_agg(engines):
    def case(ps):
        f = ps.from_pandas(DATA)
        return (f.groupby("k").agg({"x": "sum", "y": "mean"}).to_pandas(),
                f.groupby(["k"]).agg({"x": ["min", "max", "count"],
                                      "y": ["std", "nunique"]}).to_pandas())

    out = _both(engines, case, sort="k")[0]
    want = DATA.groupby("k").agg(x=("x", "sum"), y=("y", "mean")) \
        .reset_index()
    _frames_equal(out, want, sort="k")


def test_groupby_count_sum(engines):
    def case(ps):
        g = ps.from_pandas(DATA).groupby("k")
        return (g.count().to_pandas(), g.sum().to_pandas(),
                g.mean().to_pandas(), g.min().to_pandas(),
                g.max().to_pandas())

    out = _both(engines, case, sort="k")[0]
    assert dict(zip(out.k, out["count"])) == \
        DATA.groupby("k").size().to_dict()


def test_merge(engines):
    def case(ps):
        f = ps.from_pandas(DATA)
        dim = ps.from_pandas(pd.DataFrame(
            {"k": ["a", "b", "c"], "w": [10, 20, 30]}))
        return f.merge(dim, on=["k"]).to_pandas()

    out = _both(engines, case, sort=["k", "x"])
    assert len(out) == 6 and set(out.columns) >= {"k", "x", "y", "w"}
    assert (out[out.k == "a"].w == 10).all()


def test_reductions(engines):
    def case(ps):
        f = ps.from_pandas(DATA)
        return (f.x.sum(), f.y.mean(), f.x.max(), f.x.min(),
                f.k.nunique(), f.y.count(), (f.x + f.y).sum())

    got = _both(engines, case)
    assert got[:5] == (DATA.x.sum(), DATA.y.mean(), 6, 1, 3)


def test_sort_head_len(engines):
    def case(ps):
        f = ps.from_pandas(DATA)
        return (len(f), f.sort_values("x", ascending=False).head(2),
                f.sort_values(["k", "x"]).to_pandas(), f.columns,
                f.dtypes, repr(f))

    got = _both(engines, case)
    assert got[0] == 6 and got[1].x.tolist() == [6, 5]


def test_describe(engines):
    def case(ps):
        return ps.from_pandas(DATA).describe()

    d = _both(engines, case)
    assert d.loc["count", "x"] == 6 and d.loc["max", "y"] == 6.5


def test_iloc_and_loc(engines):
    frame = pd.DataFrame({"a": range(10), "b": [i * 2 for i in range(10)]})

    def case(ps):
        f = ps.from_pandas(frame)
        row = f.iloc[4]
        return (f.iloc[2:5].to_pandas(), f.iloc[:3].to_pandas(),
                f.iloc[7:].to_pandas(), (int(row["a"]), int(row["b"])),
                f.loc[f.a > 6, ["b"]].to_pandas(),
                f.loc[:, ["a"]].to_pandas(), f.loc[f.a < 2].to_pandas())

    got = _both(engines, case)
    assert list(got[0]["a"]) == [2, 3, 4] and got[3] == (4, 8)
    assert list(got[4]["b"]) == [14, 16, 18]
    for ps in (pps, rps):
        f = ps.from_pandas(frame)
        with pytest.raises(IndexError):
            f.iloc[10]
        with pytest.raises(NotImplementedError):
            f.iloc[::2]
        with pytest.raises(NotImplementedError):
            f.loc[1:3]


def test_concat_aligns_columns(engines):
    def case(ps):
        a = ps.from_pandas(pd.DataFrame({"x": [1, 2], "y": [10.0, 20.0]}))
        b = ps.from_pandas(pd.DataFrame({"x": [3], "z": [99.0]}))
        return ps.concat([a, b]).to_pandas()

    out = _both(engines, case, sort="x")
    assert list(out.columns) == ["x", "y", "z"]
    assert list(out["x"]) == [1, 2, 3]
    assert pd.isna(out["z"][0]) and out["z"][2] == 99.0
    assert pd.isna(out["y"][2])


def test_value_counts_and_ranking(engines):
    frame = pd.DataFrame({"k": ["a", "b", "a", "a", "c"], "v": [5, 3, 9, 1, 7]})

    def case(ps):
        f = ps.from_pandas(frame)
        return (f.value_counts("k").head(1), f.nlargest(2, "v").to_pandas(),
                f.nsmallest(2, "v").to_pandas(),
                f.drop_duplicates(["k"]).to_pandas().k.tolist(),
                f.rename({"v": "w"}).drop(["k"]).to_pandas())

    got = _both(engines, case)
    assert list(got[0]["k"]) == ["a"] and list(got[0]["count"]) == [3]
    assert list(got[1]["v"]) == [9, 7] and list(got[2]["v"]) == [1, 3]


def test_fillna_dropna(engines):
    frame = pd.DataFrame({"a": [1.0, np.nan, 3.0], "b": [np.nan, 5.0, 6.0]})

    def case(ps):
        f = ps.from_pandas(frame)
        return (f.fillna(0.0).to_pandas(), f.dropna().to_pandas(),
                f.dropna(subset=["a"]).to_pandas(),
                f.fillna(1.0, subset=["b"]).to_pandas())

    got = _both(engines, case)
    assert list(got[0]["a"]) == [1.0, 0.0, 3.0]
    assert len(got[1]) == 1 and got[1]["a"].iloc[0] == 3.0


def test_read_parquet(engines, tmp_path):
    path = str(tmp_path / "t.parquet")
    DATA.to_parquet(path)

    def case(ps):
        f = ps.read_parquet(path)
        return f[f.k.isin(["a", "c"]) & ~(f.x == 3)].to_pandas()

    assert _both(engines, case, sort="x").x.tolist() == [1, 4, 6]


def test_frames_run_on_the_active_session(engines):
    """The port's frames run on the active session; without one the
    pandas API asks for a new session on the card."""
    import torch

    active = PortSession.getActiveSession()
    f = pps.from_pandas(DATA)
    assert f._df._session is active and active.device.type == "cpu"
    PortSession._active = None
    try:
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="cuda"):
                pps.from_pandas(DATA)
    finally:
        PortSession._active = active
