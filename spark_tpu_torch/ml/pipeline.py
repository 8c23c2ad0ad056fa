"""Estimator / Transformer / Pipeline core: the port of
``spark_tpu/ml/pipeline.py`` (reference: ml/Pipeline.scala:41
Estimator.fit, :93 Pipeline.fit — stage-by-stage fit-then-transform)."""

from __future__ import annotations

from typing import List, Sequence

import torch


class Transformer:
    def transform(self, df):
        raise NotImplementedError


class Model(Transformer):
    pass


class Estimator:
    def fit(self, df) -> Model:
        raise NotImplementedError


class Pipeline(Estimator):
    """fit() runs stages in order: estimators fit on the running
    dataframe and their models transform it for later stages
    (reference: Pipeline.scala:93)."""

    def __init__(self, stages: Sequence):
        self.stages = list(stages)

    def fit(self, df) -> "PipelineModel":
        fitted: List[Transformer] = []
        cur = df
        for st in self.stages:
            if isinstance(st, Estimator):
                model = st.fit(cur)
                fitted.append(model)
                cur = model.transform(cur)
            else:
                fitted.append(st)
                cur = st.transform(cur)
        return PipelineModel(fitted)


class PipelineModel(Model):
    def __init__(self, stages: Sequence[Transformer]):
        self.stages = list(stages)

    def transform(self, df):
        for st in self.stages:
            df = st.transform(df)
        return df


def features_matrix(df, cols: Sequence[str]) -> torch.Tensor:
    """The feature columns' live rows as a dense float32 (rows, cols)
    matrix on the session's device: the input surface every fitter
    shares. A column's values are cast as they are stored, so a decimal
    column gives its unscaled integers, as the reference reads it (the
    quirk of ``CAST(decimal AS double)``, ROADMAP's reference quirks).
    One host sync checks for NULLs and one compacts the live rows."""
    batch = df.select(*cols)._execute()
    mask = batch.data.row_mask
    bad = [(mask & ~cd.validity).any() for cd in batch.data.columns
           if cd.validity is not None]
    if bad and bool(torch.stack(bad).any()):
        for name, cd in zip(cols, batch.data.columns):
            if cd.validity is not None and bool((mask & ~cd.validity).any()):
                raise ValueError(
                    f"feature column {name!r} contains NULLs; drop or "
                    "impute before fitting (reference: spark.ml raises on "
                    "null features too)")
    x = torch.stack([cd.data.to(torch.float32)
                     for cd in batch.data.columns], dim=1)
    return x[mask]
