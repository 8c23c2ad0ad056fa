"""ML pipelines — the spark.ml subset: the port of ``spark_tpu/ml``
(reference: mllib/src/main/scala/org/apache/spark/ml/Pipeline.scala:41,93
— Estimator/Transformer/PipelineModel; feature/, regression/,
classification/, clustering/, evaluation/, tree/, tuning/).

Fitting extracts the feature columns' live rows into one float32 matrix
on the session's device (``pipeline.features_matrix``) and runs the
solvers there as plain torch functions: the normal equations through
``torch.linalg.solve``, full-batch gradient descent as a Python loop of
matrix-vector products, Lloyd iterations whose cluster sums are
``seg_fsum`` launches, and tree histograms as grouped sums
(``physical/kernels.seg_sum``). transform() emits ordinary engine
expressions or tensor UDFs, so model application fuses into query
stages like any other projection (and is captured with them on the
card) — there is no separate "ML runtime" (the reference drives per-row
JVM UDFs over breeze/BLAS). ``state.model_from_state`` builds a fitted
model from plain values."""

from spark_tpu_torch.ml.pipeline import Estimator, Model, Pipeline, Transformer
from spark_tpu_torch.ml.features import StandardScaler, StringIndexer
from spark_tpu_torch.ml.regression import LinearRegression
from spark_tpu_torch.ml.classification import LogisticRegression
from spark_tpu_torch.ml.clustering import KMeans

__all__ = ["Estimator", "Transformer", "Model", "Pipeline",
           "StandardScaler", "StringIndexer", "LinearRegression",
           "LogisticRegression", "KMeans"]
from spark_tpu_torch.ml.tree import (  # noqa: F401,E402
    DecisionTreeClassifier, DecisionTreeRegressor, RandomForestClassifier,
    RandomForestRegressor)
from spark_tpu_torch.ml.tuning import (CrossValidator,  # noqa: F401,E402
                                       ParamGridBuilder)
from spark_tpu_torch.ml.evaluation import (  # noqa: F401,E402
    MulticlassClassificationEvaluator, RegressionEvaluator)
