"""Model selection: the port of ``spark_tpu/ml/tuning.py`` (reference:
ml/tuning/CrossValidator.scala:102 k-fold fit/eval loop,
ParamGridBuilder.scala). The folds draw from the reference's numpy
``default_rng(seed)``, so both packages split the rows alike."""

from __future__ import annotations

import copy
from typing import Dict, List, Sequence

import numpy as np

from spark_tpu_torch.ml.pipeline import Estimator, Model


class ParamGridBuilder:
    """Cartesian product of (attribute-name, values) grids. Params are
    named by the ESTIMATOR ATTRIBUTE they set (the engine has no Param
    objects — estimators are plain-attribute configured)."""

    def __init__(self):
        self._grid: Dict[str, Sequence] = {}

    def addGrid(self, attr: str, values: Sequence) -> "ParamGridBuilder":
        self._grid[attr] = list(values)
        return self

    def build(self) -> List[Dict[str, object]]:
        maps: List[Dict[str, object]] = [{}]
        for attr, values in self._grid.items():
            maps = [{**m, attr: v} for m in maps for v in values]
        return maps


class CrossValidator(Estimator):
    """k-fold cross validation over a param grid; refits the best
    params on the full data (reference: CrossValidator.scala:102)."""

    def __init__(self, estimator: Estimator,
                 estimatorParamMaps: List[Dict[str, object]],
                 evaluator, numFolds: int = 3, seed: int = 7):
        self.estimator = estimator
        self.param_maps = estimatorParamMaps or [{}]
        self.evaluator = evaluator
        self.num_folds = max(2, int(numFolds))
        self.seed = seed
        self.avg_metrics: List[float] = []

    def _folds(self, df):
        tbl = df.toArrow()
        n = tbl.num_rows
        rng = np.random.default_rng(self.seed)
        fold = rng.integers(0, self.num_folds, n)
        session = df._session
        out = []
        for k in range(self.num_folds):
            train = session.createDataFrame(tbl.filter(fold != k))
            test = session.createDataFrame(tbl.filter(fold == k))
            out.append((train, test))
        return out

    def fit(self, df) -> "CrossValidatorModel":
        folds = self._folds(df)
        self.avg_metrics = []
        for params in self.param_maps:
            scores = []
            for train, test in folds:
                est = copy.deepcopy(self.estimator)
                for attr, v in params.items():
                    if not hasattr(est, attr):
                        raise AttributeError(
                            f"estimator has no param attribute {attr!r}")
                    setattr(est, attr, v)
                model = est.fit(train)
                scores.append(self.evaluator.evaluate(
                    model.transform(test)))
            self.avg_metrics.append(float(np.mean(scores)))
        pick = (int(np.argmax(self.avg_metrics))
                if self.evaluator.is_larger_better
                else int(np.argmin(self.avg_metrics)))
        best_est = copy.deepcopy(self.estimator)
        for attr, v in self.param_maps[pick].items():
            setattr(best_est, attr, v)
        best_model = best_est.fit(df)
        return CrossValidatorModel(best_model, self.param_maps[pick],
                                   list(self.avg_metrics))


class CrossValidatorModel(Model):
    def __init__(self, best_model: Model, best_params, avg_metrics):
        self.bestModel = best_model
        self.bestParams = best_params
        self.avgMetrics = avg_metrics

    def transform(self, df):
        return self.bestModel.transform(df)
