"""Feature transformers: the port of ``spark_tpu/ml/features.py``
(reference: ml/feature/StandardScaler.scala, StringIndexer.scala)."""

from __future__ import annotations

from typing import Optional, Sequence

from spark_tpu_torch.api import functions as F
from spark_tpu_torch.expr import expressions as E
from spark_tpu_torch.ml.pipeline import Estimator, Model


class StandardScaler(Estimator):
    """Column-wise (x - mean) / std over ``inputCols`` (the reference
    scales a vector column; here features are plain columns so the
    transform is ordinary fused arithmetic)."""

    def __init__(self, inputCols: Sequence[str],
                 outputCols: Optional[Sequence[str]] = None,
                 withMean: bool = True, withStd: bool = True):
        self.input_cols = list(inputCols)
        self.output_cols = list(outputCols or
                                [c + "_scaled" for c in inputCols])
        self.with_mean = withMean
        self.with_std = withStd

    def fit(self, df) -> "StandardScalerModel":
        aggs = []
        for c in self.input_cols:
            aggs.append(F.avg(c).alias(f"m_{c}"))
            aggs.append(F.stddev(c).alias(f"s_{c}"))
        row = df.agg(*aggs).collect()[0].asDict()
        means = [row[f"m_{c}"] for c in self.input_cols]
        stds = [row[f"s_{c}"] or 1.0 for c in self.input_cols]
        return StandardScalerModel(self, means, stds)


class StandardScalerModel(Model):
    def __init__(self, scaler: StandardScaler, means, stds):
        self.scaler = scaler
        self.means = means
        self.stds = stds

    def transform(self, df):
        for c, out, m, s in zip(self.scaler.input_cols,
                                self.scaler.output_cols,
                                self.means, self.stds):
            e: E.Expression = F.col(c)
            if self.scaler.with_mean:
                e = e - float(m)
            if self.scaler.with_std:
                e = e / float(s if s else 1.0)
            df = df.withColumn(out, e)
        return df


class StringIndexer(Estimator):
    """Label -> index by descending frequency (reference:
    StringIndexer.scala 'frequencyDesc')."""

    def __init__(self, inputCol: str, outputCol: Optional[str] = None):
        self.input_col = inputCol
        self.output_col = outputCol or inputCol + "_idx"

    def fit(self, df) -> "StringIndexerModel":
        rows = (df.groupBy(self.input_col)
                .agg(F.count("*").alias("__n")).collect())
        pairs = sorted(((r.asDict()[self.input_col], r.asDict()["__n"])
                        for r in rows if r.asDict()[self.input_col] is not None),
                       key=lambda t: (-t[1], t[0]))
        labels = [p[0] for p in pairs]
        return StringIndexerModel(self, labels)


class StringIndexerModel(Model):
    def __init__(self, indexer: StringIndexer, labels):
        self.indexer = indexer
        self.labels = list(labels)

    def transform(self, df):
        # label -> index via CASE over the dictionary (evaluated on the
        # dictionary's entries, then a gather by code)
        e: E.Expression = E.Case(
            tuple((E.Cmp("==", E.Col(self.indexer.input_col),
                         E.Literal(lbl)), E.Literal(float(i)))
                  for i, lbl in enumerate(self.labels)), None)
        return df.withColumn(self.indexer.output_col, e)
