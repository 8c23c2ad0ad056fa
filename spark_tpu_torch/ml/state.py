"""Fitted models from plain values: ``model_from_state(kind, state)``.

``state`` holds numpy arrays and Python values only, so a model fitted
elsewhere (the JAX package's, or a saved one) carries over: ``params``,
the estimator's constructor arguments by their spark.ml names, and the
fitted values of the kind:

- ``"linear_regression"``, ``"logistic_regression"``: ``coefficients``
  (one per feature) and ``intercept``;
- ``"kmeans"``: ``centers``, (k, features);
- ``"decision_tree_regressor"``, ``"decision_tree_classifier"``,
  ``"random_forest_regressor"``, ``"random_forest_classifier"``:
  ``trees``, each ``{"splits": {node: (feature, threshold, bin)},
  "leaves": {node: leaf}}`` (heap node ids: the children of i are
  2i+1 and 2i+2);
- ``"standard_scaler"``: ``means`` and ``stds``, one per input column;
- ``"string_indexer"``: ``labels``, most frequent first.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from spark_tpu_torch.ml.classification import (LogisticRegression,
                                               LogisticRegressionModel)
from spark_tpu_torch.ml.clustering import KMeans, KMeansModel
from spark_tpu_torch.ml.features import (StandardScaler, StandardScalerModel,
                                         StringIndexer, StringIndexerModel)
from spark_tpu_torch.ml.pipeline import Model
from spark_tpu_torch.ml.regression import (LinearRegression,
                                           LinearRegressionModel)
from spark_tpu_torch.ml.tree import (DecisionTreeClassifier,
                                     DecisionTreeRegressor,
                                     RandomForestClassifier,
                                     RandomForestRegressor,
                                     TreeEnsembleModel, _TreeFit)

_TREES = {"decision_tree_regressor": DecisionTreeRegressor,
          "decision_tree_classifier": DecisionTreeClassifier,
          "random_forest_regressor": RandomForestRegressor,
          "random_forest_classifier": RandomForestClassifier}


def _floats(values) -> list:
    return [float(v) for v in np.asarray(values, dtype=np.float64).ravel()]


def model_from_state(kind: str, state: Dict[str, Any]) -> Model:
    """The fitted model of ``kind`` that ``state`` describes (see the
    module docstring)."""
    params = dict(state.get("params", {}))
    if kind == "linear_regression":
        return LinearRegressionModel(LinearRegression(**params),
                                     _floats(state["coefficients"]),
                                     float(state["intercept"]))
    if kind == "logistic_regression":
        return LogisticRegressionModel(LogisticRegression(**params),
                                       _floats(state["coefficients"]),
                                       float(state["intercept"]))
    if kind == "kmeans":
        centers = np.asarray(state["centers"], dtype=np.float32)
        params.setdefault("k", centers.shape[0])
        return KMeansModel(KMeans(**params), centers)
    if kind in _TREES:
        est = _TREES[kind](**params)
        fits = [_TreeFit({int(n): (int(f), float(t), int(b))
                          for n, (f, t, b) in tree["splits"].items()},
                         {int(n): float(v)
                          for n, v in tree["leaves"].items()},
                         est.features_cols)
                for tree in state["trees"]]
        return TreeEnsembleModel(est, fits)
    if kind == "standard_scaler":
        return StandardScalerModel(StandardScaler(**params),
                                   _floats(state["means"]),
                                   _floats(state["stds"]))
    if kind == "string_indexer":
        return StringIndexerModel(StringIndexer(**params),
                                  list(state["labels"]))
    raise ValueError(f"unknown model kind {kind!r}")
