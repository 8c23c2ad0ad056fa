"""PsFrame / PsColumn / PsGroupBy: the port of
``spark_tpu/pandas/frame.py`` (reference: python/pyspark/pandas/
frame.py, generic.py, groupby.py — pared to the core surface).

Frames are lazy over the port's DataFrame; they run on the active
session's device, a new session on the card where none is active."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

from spark_tpu_torch.api import functions as F
from spark_tpu_torch.expr import expressions as E


def _session():
    """The active session, else a new one on the card."""
    from spark_tpu_torch.api.session import SparkSession

    return SparkSession.getActiveSession() \
        or SparkSession.builder.getOrCreate()


def from_pandas(pdf) -> "PsFrame":
    return PsFrame(_session().createDataFrame(pdf))


def read_parquet(path: str) -> "PsFrame":
    return PsFrame(_session().read.parquet(path))


class PsColumn:
    """A deferred column expression bound to a frame."""

    def __init__(self, frame: "PsFrame", expr: E.Expression):
        self._frame = frame
        self._expr = expr

    def _bin(self, other, fn):
        o = other._expr if isinstance(other, PsColumn) else other
        return PsColumn(self._frame, fn(self._expr, o))

    def __add__(self, o):
        return self._bin(o, lambda a, b: a + b)

    def __sub__(self, o):
        return self._bin(o, lambda a, b: a - b)

    def __mul__(self, o):
        return self._bin(o, lambda a, b: a * b)

    def __truediv__(self, o):
        return self._bin(o, lambda a, b: a / b)

    def __gt__(self, o):
        return self._bin(o, lambda a, b: a > b)

    def __ge__(self, o):
        return self._bin(o, lambda a, b: a >= b)

    def __lt__(self, o):
        return self._bin(o, lambda a, b: a < b)

    def __le__(self, o):
        return self._bin(o, lambda a, b: a <= b)

    def __eq__(self, o):  # type: ignore[override]
        return self._bin(o, lambda a, b: a == b)

    def __ne__(self, o):  # type: ignore[override]
        return self._bin(o, lambda a, b: a != b)

    def __and__(self, o):
        return self._bin(o, lambda a, b: a & b)

    def __or__(self, o):
        return self._bin(o, lambda a, b: a | b)

    def __invert__(self):
        return PsColumn(self._frame, ~self._expr)

    def isin(self, values):
        return PsColumn(self._frame, self._expr.isin(list(values)))

    # reductions materialize
    def _agg(self, fn):
        row = self._frame._df.agg(fn(self._expr).alias("v")).collect()
        return row[0].v

    def sum(self):
        return self._agg(F.sum)

    def mean(self):
        return self._agg(F.avg)

    def min(self):  # noqa: A003
        return self._agg(F.min)

    def max(self):  # noqa: A003
        return self._agg(F.max)

    def count(self):
        return self._agg(F.count)

    def nunique(self):
        return self._agg(F.countDistinct)

    def to_pandas(self):
        name = getattr(self._expr, "name", "col")
        return self._frame._df.select(
            self._expr.alias(name))._execute().to_pandas()[name]


_AGG_FNS = {"sum": F.sum, "mean": F.avg, "avg": F.avg, "count": F.count,
            "min": F.min, "max": F.max, "nunique": F.countDistinct,
            "std": F.stddev}


class PsGroupBy:
    def __init__(self, frame: "PsFrame", keys: List[str]):
        self._frame = frame
        self._keys = keys

    def agg(self, spec: Dict[str, Union[str, List[str]]]) -> "PsFrame":
        aggs = []
        for col, hows in spec.items():
            for how in ([hows] if isinstance(hows, str) else hows):
                aggs.append(_AGG_FNS[how](col).alias(
                    f"{col}_{how}" if not isinstance(hows, str)
                    else col))
        return PsFrame(self._frame._df.groupBy(*self._keys).agg(*aggs))

    def _all_numeric(self, how: str) -> "PsFrame":
        from spark_tpu_torch import types as T

        df = self._frame._df
        cols = [f.name for f in df.schema.fields
                if f.name not in self._keys
                and not isinstance(f.dtype, (T.StringType, T.DateType))]
        aggs = [_AGG_FNS[how](c).alias(c) for c in cols]
        return PsFrame(df.groupBy(*self._keys).agg(*aggs))

    def sum(self):
        return self._all_numeric("sum")

    def mean(self):
        return self._all_numeric("mean")

    def count(self):
        return PsFrame(self._frame._df.groupBy(*self._keys)
                       .agg(F.count("*").alias("count")))

    def min(self):  # noqa: A003
        return self._all_numeric("min")

    def max(self):  # noqa: A003
        return self._all_numeric("max")


class PsFrame:
    def __init__(self, df):
        self._df = df

    # -- metadata -------------------------------------------------------------

    @property
    def columns(self) -> List[str]:
        return self._df.columns

    @property
    def dtypes(self):
        return {f.name: repr(f.dtype) for f in self._df.schema.fields}

    def __len__(self) -> int:
        return self._df.count()

    def __repr__(self):
        return f"PsFrame{self.columns}"

    # -- selection / filtering ------------------------------------------------

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        if name in self._df.columns:
            return PsColumn(self, E.Col(name))
        raise AttributeError(name)

    def __getitem__(self, key):
        if isinstance(key, str):
            return PsColumn(self, E.Col(key))
        if isinstance(key, list):
            return PsFrame(self._df.select(*key))
        if isinstance(key, PsColumn):  # boolean filter
            return PsFrame(self._df.filter(key._expr))
        raise TypeError(f"cannot index with {type(key).__name__}")

    def __setitem__(self, name: str, value) -> None:
        expr = value._expr if isinstance(value, PsColumn) else E.Literal(value)
        self._df = self._df.withColumn(name, expr)

    def assign(self, **cols) -> "PsFrame":
        df = self._df
        for name, v in cols.items():
            df = df.withColumn(
                name, v._expr if isinstance(v, PsColumn) else E.Literal(v))
        return PsFrame(df)

    def drop(self, columns: Sequence[str]) -> "PsFrame":
        return PsFrame(self._df.drop(*columns))

    def rename(self, columns: Dict[str, str]) -> "PsFrame":
        df = self._df
        for old, new in columns.items():
            df = df.withColumnRenamed(old, new)
        return PsFrame(df)

    def drop_duplicates(self, subset=None) -> "PsFrame":
        return PsFrame(self._df.dropDuplicates(subset))

    # -- relational -----------------------------------------------------------

    def groupby(self, by: Union[str, List[str]]) -> PsGroupBy:
        keys = [by] if isinstance(by, str) else list(by)
        return PsGroupBy(self, keys)

    def merge(self, other: "PsFrame", on: Union[str, List[str]],
              how: str = "inner") -> "PsFrame":
        return PsFrame(self._df.join(other._df, on=on, how=how))

    def sort_values(self, by: Union[str, List[str]],
                    ascending: bool = True) -> "PsFrame":
        cols = [by] if isinstance(by, str) else list(by)
        return PsFrame(self._df.sort(*cols, ascending=ascending))

    # -- indexing -------------------------------------------------------------

    @property
    def iloc(self) -> "_ILoc":
        return _ILoc(self)

    @property
    def loc(self) -> "_Loc":
        return _Loc(self)

    # -- cleaning / ranking ---------------------------------------------------

    def fillna(self, value, subset=None) -> "PsFrame":
        return PsFrame(self._df.fillna(value, subset=subset))

    def dropna(self, subset=None) -> "PsFrame":
        return PsFrame(self._df.dropna(subset=subset))

    def value_counts(self, col: str) -> "PsFrame":
        return PsFrame(self._df.groupBy(col)
                       .agg(F.count("*").alias("count"))
                       .sort("count", ascending=False))

    def nlargest(self, n: int, col: str) -> "PsFrame":
        return PsFrame(self._df.sort(col, ascending=False).limit(n))

    def nsmallest(self, n: int, col: str) -> "PsFrame":
        return PsFrame(self._df.sort(col, ascending=True).limit(n))

    # -- materialization ------------------------------------------------------

    def head(self, n: int = 5):
        return PsFrame(self._df.limit(n)).to_pandas()

    def to_pandas(self):
        return self._df._execute().to_pandas()

    def describe(self):
        from spark_tpu_torch import types as T

        df = self._df
        cols = [f.name for f in df.schema.fields
                if not isinstance(f.dtype, (T.StringType, T.DateType))]
        hows = ("count", "mean", "std", "min", "max")
        aggs = [_AGG_FNS[how](c).alias(f"{how}__{c}")
                for how in hows for c in cols]
        row = df.agg(*aggs).collect()[0].asDict()  # ONE execution
        stats = [dict({c: row[f"{how}__{c}"] for c in cols},
                      statistic=how) for how in hows]
        import pandas as pd

        return pd.DataFrame(stats).set_index("statistic")


class _ILoc:
    """Positional row access: slices plan as limit/offset (no full
    materialization); a bare int materializes one row (reference:
    pyspark.pandas iLocIndexer)."""

    def __init__(self, frame: "PsFrame"):
        self._frame = frame

    def __getitem__(self, key):
        df = self._frame._df
        if isinstance(key, slice):
            if (key.step or 1) != 1:
                raise NotImplementedError("iloc step slicing")
            start = key.start or 0
            if start < 0 or (key.stop is not None and key.stop < 0):
                raise NotImplementedError("negative iloc bounds")
            out = df.offset(start) if start else df
            if key.stop is not None:
                out = out.limit(max(0, key.stop - start))
            return PsFrame(out)
        if isinstance(key, int):
            pdf = PsFrame(df.offset(key).limit(1)).to_pandas()
            if not len(pdf):
                raise IndexError(key)
            return pdf.iloc[0]
        raise TypeError(f"cannot iloc-index with {type(key).__name__}")


class _Loc:
    """Label/mask access: loc[mask], loc[mask, cols], loc[:, cols]
    (reference: pyspark.pandas LocIndexer — the row-label forms that
    need a materialized index are out of scope, like ps defaults with
    distributed-sequence off)."""

    def __init__(self, frame: "PsFrame"):
        self._frame = frame

    def __getitem__(self, key):
        rows, cols = key if isinstance(key, tuple) else (key, None)
        df = self._frame._df
        if isinstance(rows, PsColumn):
            df = df.filter(rows._expr)
        elif not (isinstance(rows, slice) and rows.start is None
                  and rows.stop is None):
            raise NotImplementedError(
                "loc supports boolean-mask rows or ':' (positional "
                "label indexes are not materialized)")
        if cols is not None:
            names = [cols] if isinstance(cols, str) else list(cols)
            df = df.select(*names)
        return PsFrame(df)


def concat(frames: Sequence["PsFrame"], ignore_index: bool = True
           ) -> "PsFrame":
    """Row-wise union by COLUMN NAME; a column missing from a frame
    contributes NULLs (reference: pyspark.pandas.concat outer-align
    behavior)."""
    if not frames:
        raise ValueError("concat of no frames")
    all_cols: List[str] = []
    for f in frames:
        for c in f.columns:
            if c not in all_cols:
                all_cols.append(c)
    dtypes = {}
    for f in frames:
        for fld in f._df.schema.fields:
            dtypes.setdefault(fld.name, fld.dtype)
    aligned = []
    for f in frames:
        df = f._df
        missing = [c for c in all_cols if c not in f.columns]
        for c in missing:
            # typed NULL: the column's type comes from a frame that has it
            df = df.withColumn(c, E.Literal(None, dtypes[c]))
        aligned.append(df.select(*all_cols))
    out = aligned[0]
    for df in aligned[1:]:
        out = out.unionByName(df)
    return PsFrame(out)


