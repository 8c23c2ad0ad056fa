"""Logistic regression: the port of ``spark_tpu/ml/classification.py``
(reference: ml/classification/LogisticRegression.scala — LBFGS over
breeze; here full-batch gradient descent, ``maxIter`` steps of two
float32 matrix-vector products on the session's device)."""

from __future__ import annotations

from typing import Sequence

import torch

from spark_tpu_torch.api import functions as F
from spark_tpu_torch.expr import expressions as E
from spark_tpu_torch.ml.pipeline import Estimator, Model, features_matrix
from spark_tpu_torch.ml.regression import with_intercept


class LogisticRegression(Estimator):
    """Minimizes the mean logistic loss ``log(1 + e^z) - y z`` (z = xa w,
    xa the features and a ones column) plus ``regParam * |w|^2`` over the
    coefficients (not the intercept), from w = 0, by ``maxIter`` steps of
    ``w -= stepSize * grad``. The gradient is the closed form
    ``xaᵀ(σ(z) − y)/n + 2·regParam·w`` (0 for the intercept), where the
    reference takes ``jax.grad`` of the loss: the same function, rounded
    in another order."""

    def __init__(self, featuresCols: Sequence[str], labelCol: str,
                 predictionCol: str = "prediction",
                 probabilityCol: str = "probability",
                 maxIter: int = 200, stepSize: float = 0.5,
                 regParam: float = 0.0):
        self.features_cols = list(featuresCols)
        self.label_col = labelCol
        self.prediction_col = predictionCol
        self.probability_col = probabilityCol
        self.max_iter = maxIter
        self.step = stepSize
        self.reg = regParam

    def fit(self, df) -> "LogisticRegressionModel":
        xy = features_matrix(df, self.features_cols + [self.label_col])
        xa, y = with_intercept(xy[:, :-1]), xy[:, -1]
        n, d1 = xa.shape
        reg = torch.full((d1,), 2.0 * self.reg, dtype=xa.dtype,
                         device=xa.device)
        reg[-1] = 0.0
        w = torch.zeros((d1,), dtype=xa.dtype, device=xa.device)
        for _ in range(self.max_iter):
            r = torch.sigmoid(xa @ w) - y
            w = w - self.step * ((xa.T @ r) / n + reg * w)
        w = w.tolist()
        return LogisticRegressionModel(self, w[:-1], w[-1])


class LogisticRegressionModel(Model):
    def __init__(self, lr: LogisticRegression, coefficients, intercept):
        self.lr = lr
        self.coefficients = coefficients
        self.intercept = intercept

    def transform(self, df):
        z: E.Expression = E.Literal(self.intercept)
        for c, w in zip(self.lr.features_cols, self.coefficients):
            z = z + F.col(c) * float(w)
        prob = E.Literal(1.0) / (E.Literal(1.0)
                                 + E.UnaryMath("exp", E.Neg(z)))
        df = df.withColumn(self.lr.probability_col, prob)
        pred = E.Case(((E.Cmp(">", E.Col(self.lr.probability_col),
                              E.Literal(0.5)), E.Literal(1.0)),),
                      E.Literal(0.0))
        return df.withColumn(self.lr.prediction_col, pred)
