"""Evaluators: the port of ``spark_tpu/ml/evaluation.py`` (reference:
ml/evaluation/RegressionEvaluator.scala,
MulticlassClassificationEvaluator.scala) — metrics computed by the
engine as one aggregate query, not a host loop."""

from __future__ import annotations

from spark_tpu_torch.api import functions as F
from spark_tpu_torch.expr import expressions as E


class RegressionEvaluator:
    def __init__(self, labelCol: str = "label",
                 predictionCol: str = "prediction",
                 metricName: str = "rmse"):
        if metricName not in ("rmse", "mse", "mae"):
            raise ValueError(f"unknown metric {metricName!r}")
        self.label_col = labelCol
        self.prediction_col = predictionCol
        self.metric = metricName

    @property
    def is_larger_better(self) -> bool:
        return False

    def evaluate(self, df) -> float:
        err = E.Arith("-", E.Col(self.prediction_col),
                      E.Col(self.label_col))
        if self.metric == "mae":
            agg = F.avg(E.Abs(err))
        else:
            agg = F.avg(E.Arith("*", err, err))
        v = float(df.agg(E.Alias(agg, "m")).collect()[0]["m"])
        return v ** 0.5 if self.metric == "rmse" else v


class MulticlassClassificationEvaluator:
    def __init__(self, labelCol: str = "label",
                 predictionCol: str = "prediction",
                 metricName: str = "accuracy"):
        if metricName != "accuracy":
            raise ValueError(f"unknown metric {metricName!r}")
        self.label_col = labelCol
        self.prediction_col = predictionCol
        self.metric = metricName

    @property
    def is_larger_better(self) -> bool:
        return True

    def evaluate(self, df) -> float:
        hit = E.Case(((E.Cmp("==", E.Col(self.prediction_col),
                             E.Col(self.label_col)), E.Literal(1.0)),),
                     E.Literal(0.0))
        return float(df.agg(E.Alias(F.avg(hit), "m")).collect()[0]["m"])
