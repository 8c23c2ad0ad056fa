"""DataFrameNaFunctions and DataFrameStatFunctions: the port of
``spark_tpu/api/na_stat.py``.

Reference: sql/core/.../DataFrameNaFunctions.scala (drop/fill/replace)
and DataFrameStatFunctions.scala (approxQuantile:75, corr, cov,
crosstab, freqItems, sampleBy). Everything lowers to engine expressions
(IsNull, Coalesce, Case and aggregates), so it runs in the session's
stages on its device, and its grouped aggregates take the hand kernels
there; only the shaping of a result (the crosstab pivot, describe's
table) happens on the host.
"""

from __future__ import annotations

import json
import math
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import pyarrow as pa

from spark_tpu_torch import types as T
from spark_tpu_torch.expr import expressions as E


def _is_numeric(dtype) -> bool:
    return isinstance(dtype, (T.IntegralType, T.FractionalType))


class DataFrameNaFunctions:
    """``df.na``: null handling (reference: DataFrameNaFunctions.scala)."""

    def __init__(self, df):
        self._df = df

    def drop(self, how: str = "any", thresh: Optional[int] = None,
             subset: Optional[Sequence[str]] = None):
        """Rows without a NULL among ``subset`` (``how="all"``: rows not
        NULL everywhere there; ``thresh``: rows with at least that many
        non-NULL values there)."""
        df = self._df
        cols = list(subset) if subset is not None else df.columns
        nullable = [c for c in cols if df.schema.field(c).nullable]
        if not nullable:
            return df
        not_nulls = [E.Not(E.IsNull(E.Col(c))) for c in nullable]
        if thresh is not None:
            # columns that cannot be NULL always count as non-null
            total: E.Expression = E.Literal(len(cols) - len(nullable))
            for nn in not_nulls:
                total = E.Arith("+", total,
                                E.Case(((nn, E.Literal(1)),), E.Literal(0)))
            return df.filter(E.Cmp(">=", total, E.Literal(int(thresh))))
        combine = E.And if how == "any" else E.Or
        cond = not_nulls[0]
        for nn in not_nulls[1:]:
            cond = combine(cond, nn)
        return df.filter(cond)

    def fill(self, value: Union[int, float, str, bool, dict],
             subset: Optional[Sequence[str]] = None):
        """NULLs replaced by ``value`` in the columns of its type (a dict
        maps column names to values)."""
        df = self._df
        if isinstance(value, dict):
            mapping: Dict[str, object] = dict(value)
        else:
            cols = list(subset) if subset is not None else df.columns
            mapping = {}
            for c in cols:
                f = df.schema.field(c)
                if isinstance(value, str) and isinstance(f.dtype,
                                                         T.StringType):
                    mapping[c] = value
                elif isinstance(value, bool):
                    if isinstance(f.dtype, T.BooleanType):
                        mapping[c] = value
                elif isinstance(value, (int, float)) and _is_numeric(f.dtype):
                    mapping[c] = value
        out = df
        for c, v in mapping.items():
            if c not in df.columns or not df.schema.field(c).nullable:
                continue
            out = out.withColumn(c, E.Coalesce((E.Col(c), E.Literal(v))))
        return out

    def replace(self, to_replace, value=None,
                subset: Optional[Sequence[str]] = None):
        """Values equal to an old one replaced by its new one, in the
        columns of the old value's type."""
        df = self._df
        if isinstance(to_replace, dict):
            pairs = list(to_replace.items())
        else:
            olds = (to_replace if isinstance(to_replace, (list, tuple))
                    else [to_replace])
            news = (value if isinstance(value, (list, tuple))
                    else [value] * len(olds))
            pairs = list(zip(olds, news))
        cols = list(subset) if subset is not None else df.columns
        out = df
        for c in cols:
            f = df.schema.field(c)
            branches = []
            for old, new in pairs:
                type_ok = (isinstance(old, str)
                           and isinstance(f.dtype, T.StringType)) or (
                    isinstance(old, (int, float))
                    and not isinstance(old, bool) and _is_numeric(f.dtype))
                if type_ok:
                    branches.append((E.Cmp("==", E.Col(c), E.Literal(old)),
                                     E.Literal(new, f.dtype)))
            if branches:
                out = out.withColumn(c, E.Case(tuple(branches), E.Col(c)))
        return out


class DataFrameStatFunctions:
    """``df.stat`` (reference: DataFrameStatFunctions.scala)."""

    def __init__(self, df):
        self._df = df

    def approxQuantile(self, col: Union[str, Sequence[str]],
                       probabilities: Sequence[float],
                       relativeError: float = 0.0) -> List:
        """Quantiles per column, exact (the column's non-NULL values
        copied to the host as one Arrow column, sorted there, the value
        at ``int(p * n)``), which meets any requested error bound."""
        cols = [col] if isinstance(col, str) else list(col)
        out = []
        for c in cols:
            column = self._df.select(c).toArrow().column(0).drop_null()
            vals = np.sort(np.asarray(column.to_numpy(zero_copy_only=False),
                                      dtype=np.float64))
            if vals.size == 0:
                out.append([float("nan")] * len(probabilities))
                continue
            out.append([float(vals[min(int(p * vals.size), vals.size - 1)])
                        for p in probabilities])
        return out[0] if isinstance(col, str) else out

    def corr(self, col1: str, col2: str, method: str = "pearson") -> float:
        if method != "pearson":
            raise ValueError("only pearson correlation is supported "
                             "(reference: StatFunctions.pearsonCorrelation)")
        s = self._moments(col1, col2)
        n = s["n"]
        if n == 0:
            return float("nan")
        cov = s["xy"] / n - (s["x"] / n) * (s["y"] / n)
        vx = s["xx"] / n - (s["x"] / n) ** 2
        vy = s["yy"] / n - (s["y"] / n) ** 2
        denom = math.sqrt(vx * vy)
        return cov / denom if denom else float("nan")

    def cov(self, col1: str, col2: str) -> float:
        """The sample covariance (reference: StatFunctions.calculateCov)."""
        s = self._moments(col1, col2)
        n = s["n"]
        if n <= 1:
            return float("nan")
        return (s["xy"] - s["x"] * s["y"] / n) / (n - 1)

    def _moments(self, c1: str, c2: str) -> Dict[str, float]:
        """Sums of x, y, xy, x^2, y^2 and the count over the rows where
        both columns are present (pairwise deletion, as the reference's
        StatFunctions)."""
        df = self._df.filter(E.And(E.Not(E.IsNull(E.Col(c1))),
                                   E.Not(E.IsNull(E.Col(c2)))))
        x = E.Cast(E.Col(c1), T.FLOAT64)
        y = E.Cast(E.Col(c2), T.FLOAT64)
        r = df.agg(E.Alias(E.Sum(x), "x"), E.Alias(E.Sum(y), "y"),
                   E.Alias(E.Sum(x * y), "xy"), E.Alias(E.Sum(x * x), "xx"),
                   E.Alias(E.Sum(y * y), "yy"),
                   E.Alias(E.Count(x), "n")).collect()[0]
        return {k: (float(r[k]) if r[k] is not None else 0.0)
                for k in ("x", "y", "xy", "xx", "yy", "n")}

    def crosstab(self, col1: str, col2: str):
        """Contingency table: one row per distinct ``col1``, one column
        per distinct ``col2`` (reference: StatFunctions.crossTabulate)."""
        df = self._df
        rows = df.groupBy(col1, col2).count().collect()
        row_keys = sorted({str(r[col1]) for r in rows})
        col_keys = sorted({str(r[col2]) for r in rows})
        counts = {(str(r[col1]), str(r[col2])): r["count"] for r in rows}
        data = {f"{col1}_{col2}": row_keys}
        for ck in col_keys:
            data[ck] = [counts.get((rk, ck), 0) for rk in row_keys]
        return df.sparkSession.createDataFrame(pa.table(data))

    def freqItems(self, cols: Sequence[str], support: float = 0.01):
        """Items in at least ``support`` of the rows, counted exactly by a
        group-by; each ``{col}_freqItems`` cell is the item list as a JSON
        string, as the reference gives it."""
        df = self._df
        floor = max(1.0, df.count() * support)
        data = {}
        for c in cols:
            items = sorted((r[c] for r in df.groupBy(c).count().collect()
                            if r["count"] >= floor),
                           key=lambda x: (x is None, str(x)))
            data[f"{c}_freqItems"] = [json.dumps(items)]
        return df.sparkSession.createDataFrame(pa.table(data))

    def sampleBy(self, col: str, fractions: Dict, seed: int = 42):
        """Stratified sample: a Bernoulli sample of each stratum (the
        sampler's stream, seeded ``seed + i`` for the i-th stratum in
        order of ``str(key)``), unioned."""
        df = self._df
        out = None
        for i, (k, frac) in enumerate(sorted(fractions.items(),
                                             key=lambda kv: str(kv[0]))):
            part = df.filter(E.Cmp("==", E.Col(col), E.Literal(k))) \
                .sample(float(frac), seed=seed + i)
            out = part if out is None else out.union(part)
        return out if out is not None else df.limit(0)


def describe(df, cols: Optional[Sequence[str]] = None):
    """count, mean, stddev, min and max of each numeric column, as
    strings (reference: Dataset.describe -> StatFunctions.summary)."""
    names = [c for c in (cols or df.columns)
             if _is_numeric(df.schema.field(c).dtype)]
    aggs = []
    for c in names:
        x = E.Cast(E.Col(c), T.FLOAT64)
        aggs += [E.Alias(E.Count(x), f"n_{c}"), E.Alias(E.Avg(x), f"mean_{c}"),
                 E.Alias(E.StddevVariance("stddev_samp", x), f"std_{c}"),
                 E.Alias(E.Min(x), f"min_{c}"), E.Alias(E.Max(x), f"max_{c}")]
    if not aggs:
        return df.limit(0)
    r = df.agg(*aggs).collect()[0]

    def fmt(v):
        return None if v is None else str(v)

    data = {"summary": ["count", "mean", "stddev", "min", "max"]}
    for c in names:
        data[c] = [fmt(r[f"{k}_{c}"]) for k in ("n", "mean", "std", "min",
                                                "max")]
    return df.sparkSession.createDataFrame(pa.table(data))
