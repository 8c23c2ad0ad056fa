"""Linear regression: the port of ``spark_tpu/ml/regression.py``
(reference: ml/regression/LinearRegression.scala — WLS/normal-equations
solver path)."""

from __future__ import annotations

from typing import Sequence

import torch

from spark_tpu_torch.api import functions as F
from spark_tpu_torch.expr import expressions as E
from spark_tpu_torch.ml.pipeline import Estimator, Model, features_matrix


def with_intercept(x: torch.Tensor) -> torch.Tensor:
    """``x`` with a column of ones appended (the intercept's feature)."""
    ones = torch.ones((x.shape[0], 1), dtype=x.dtype, device=x.device)
    return torch.cat([x, ones], dim=1)


class LinearRegression(Estimator):
    """Closed-form ridge-regularized normal equations on the session's
    device: one float32 (d+1)x(d+1) gram matrix and one
    ``torch.linalg.solve`` (TF32 stays off, torch's default for
    float32 matmuls)."""

    def __init__(self, featuresCols: Sequence[str], labelCol: str,
                 predictionCol: str = "prediction",
                 regParam: float = 1e-6):
        self.features_cols = list(featuresCols)
        self.label_col = labelCol
        self.prediction_col = predictionCol
        self.reg = regParam

    def fit(self, df) -> "LinearRegressionModel":
        xy = features_matrix(df, self.features_cols + [self.label_col])
        xa, y = with_intercept(xy[:, :-1]), xy[:, -1]
        g = xa.T @ xa + self.reg * torch.eye(xa.shape[1], dtype=xa.dtype,
                                             device=xa.device)
        w = torch.linalg.solve(g, xa.T @ y).tolist()
        return LinearRegressionModel(self, w[:-1], w[-1])


class LinearRegressionModel(Model):
    def __init__(self, lr: LinearRegression, coefficients, intercept):
        self.lr = lr
        self.coefficients = coefficients
        self.intercept = intercept

    def transform(self, df):
        e: E.Expression = E.Literal(self.intercept)
        for c, w in zip(self.lr.features_cols, self.coefficients):
            e = e + F.col(c) * float(w)
        return df.withColumn(self.lr.prediction_col, e)
