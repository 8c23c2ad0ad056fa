"""The port's spark.ml pipelines (``spark_tpu_torch/ml``: features,
linear and logistic regression, KMeans, evaluators, ``Pipeline``)
against the JAX package's on the inputs of tests/test_ml.py. The same
numpy-seeded rows go through both packages; the reference's fits run
once per module.

Tolerances:

- linear and logistic coefficients and intercepts, scaler means and
  KMeans centers: relative 1e-4 (both fit in float32; the port's
  gradient is the closed form, the reference's ``jax.grad``, and the
  port's KMeans sums are exact where the reference multiplies by a
  one-hot matrix);
- KMeans assignments, StringIndexer labels and indexes: equal;
- a model carried over from the reference (``ml/state.model_from_state``)
  transforms the rows as the reference's model does: probabilities,
  predictions and scaled columns within relative 1e-6 (the same
  expressions; doubles), class predictions and cluster ids equal.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_tpu.ml as RML
import spark_tpu_torch.ml as PML
from spark_tpu.api import functions as RF
from spark_tpu_torch.api import functions as PF
from spark_tpu_torch.api.session import SparkSession as PortSession
from spark_tpu_torch.ml.state import model_from_state

REL = 1e-4


@pytest.fixture(scope="module")
def engines(spark):
    port = PortSession.builder.device("cpu").master("local").getOrCreate()
    return {"ref": (spark, RML, RF), "port": (port, PML, PF)}


def _frames(engines, table):
    return (engines["port"][0].createDataFrame(table),
            engines["ref"][0].createDataFrame(table))


def _reg_table(n=600, seed=21):
    rng = np.random.default_rng(seed)
    x1 = rng.normal(size=n)
    x2 = rng.normal(size=n) * 3 + 1
    y = 2.5 * x1 - 1.25 * x2 + 0.75 + rng.normal(size=n) * 0.01
    return pa.table({"x1": x1, "x2": x2, "y": y})


def _logit_table(n=600, seed=22):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 2))
    label = (x[:, 0] + 2 * x[:, 1] > 0).astype(float)
    return pa.table({"a": x[:, 0], "b": x[:, 1], "lbl": label})


def _blobs_table(seed=23, per=150):
    rng = np.random.default_rng(seed)
    centers = np.array([[0.0, 0.0], [10.0, 10.0], [-10.0, 10.0]])
    pts = np.concatenate([rng.normal(size=(per, 2)) * 0.5 + c
                          for c in centers])
    return pa.table({"px": pts[:, 0], "py": pts[:, 1],
                     "t": np.repeat(np.arange(3), per)})


def _pipe_table(n=600, seed=24):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n) * 7 + 3
    cat = rng.choice(["red", "green", "blue"], size=n, p=[0.5, 0.3, 0.2])
    y = 3 * ((x - 3) / 7) + (cat == "red") * 2.0 + 0.5
    return pa.table({"x": x, "cat": cat.astype(str), "y": y})


def _rows(df, *cols):
    return [tuple(r[c] for c in cols) for r in df.collect()]


def _close(got, want, rel):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == pytest.approx(w, rel=rel, abs=rel * 1e-3), (got, want)


@pytest.fixture(scope="module")
def reg(engines):
    port_df, ref_df = _frames(engines, _reg_table())
    ref = RML.LinearRegression(["x1", "x2"], "y").fit(ref_df)
    return port_df, ref_df, ref


def test_linear_regression_recovers_coefficients(reg):
    port_df, ref_df, ref = reg
    model = PML.LinearRegression(["x1", "x2"], "y").fit(port_df)
    _close(model.coefficients + [model.intercept],
           ref.coefficients + [ref.intercept], REL)
    assert model.coefficients[0] == pytest.approx(2.5, abs=0.01)
    assert model.intercept == pytest.approx(0.75, abs=0.01)
    diff = PF.col("prediction") - PF.col("y")
    rmse = model.transform(port_df).select((diff * diff).alias("se")) \
        .agg(PF.avg("se").alias("m")).collect()[0].m ** 0.5
    assert rmse < 0.05
    ev = PML.RegressionEvaluator(labelCol="y")
    rev = RML.RegressionEvaluator(labelCol="y")
    for metric in ("rmse", "mse", "mae"):
        ev.metric = rev.metric = metric
        assert ev.evaluate(model.transform(port_df)) == pytest.approx(
            rev.evaluate(ref.transform(ref_df)), rel=1e-2)
    assert not ev.is_larger_better
    with pytest.raises(ValueError):
        PML.RegressionEvaluator(metricName="r2")


def test_linear_regression_from_reference_state(reg):
    port_df, ref_df, ref = reg
    model = model_from_state("linear_regression", {
        "params": {"featuresCols": ["x1", "x2"], "labelCol": "y"},
        "coefficients": np.asarray(ref.coefficients),
        "intercept": ref.intercept})
    _close(_rows(model.transform(port_df), "prediction"),
           _rows(ref.transform(ref_df), "prediction"), 1e-6)


@pytest.fixture(scope="module")
def logit(engines):
    port_df, ref_df = _frames(engines, _logit_table())
    ref = RML.LogisticRegression(["a", "b"], "lbl", maxIter=300).fit(ref_df)
    return port_df, ref_df, ref


def test_logistic_regression_separates(logit):
    """The closed-form gradient (the port) against ``jax.grad`` (the
    reference): the same 300 steps, within relative 1e-4."""
    port_df, ref_df, ref = logit
    model = PML.LogisticRegression(["a", "b"], "lbl", maxIter=300) \
        .fit(port_df)
    _close(model.coefficients + [model.intercept],
           ref.coefficients + [ref.intercept], REL)
    ev = PML.MulticlassClassificationEvaluator(labelCol="lbl")
    acc = ev.evaluate(model.transform(port_df))
    assert acc > 0.97 and ev.is_larger_better
    assert acc == RML.MulticlassClassificationEvaluator(
        labelCol="lbl").evaluate(ref.transform(ref_df))
    with pytest.raises(ValueError):
        PML.MulticlassClassificationEvaluator(metricName="f1")


def test_logistic_regression_regularized(engines):
    port_df, ref_df = _frames(engines, _logit_table(300, seed=5))
    kw = dict(maxIter=40, stepSize=0.3, regParam=0.05)
    got = PML.LogisticRegression(["a", "b"], "lbl", **kw).fit(port_df)
    want = RML.LogisticRegression(["a", "b"], "lbl", **kw).fit(ref_df)
    _close(got.coefficients + [got.intercept],
           want.coefficients + [want.intercept], REL)


def test_logistic_regression_from_reference_state(logit):
    port_df, ref_df, ref = logit
    model = model_from_state("logistic_regression", {
        "params": {"featuresCols": ["a", "b"], "labelCol": "lbl"},
        "coefficients": ref.coefficients, "intercept": ref.intercept})
    got = _rows(model.transform(port_df), "probability", "prediction")
    want = _rows(ref.transform(ref_df), "probability", "prediction")
    assert [g[1] for g in got] == [w[1] for w in want]
    _close([g[0] for g in got], [w[0] for w in want], 1e-6)


@pytest.fixture(scope="module")
def blobs(engines):
    port_df, ref_df = _frames(engines, _blobs_table())
    ref = RML.KMeans(["px", "py"], k=3, maxIter=30).fit(ref_df)
    return port_df, ref_df, ref


def test_kmeans_three_blobs(blobs):
    port_df, ref_df, ref = blobs
    model = PML.KMeans(["px", "py"], k=3, maxIter=30).fit(port_df)
    np.testing.assert_allclose(model.centers, ref.centers, rtol=REL,
                               atol=1e-6)
    got = _rows(model.transform(port_df), "t", "prediction")
    assert got == _rows(ref.transform(ref_df), "t", "prediction")
    mapping = {}
    for t, p in got:
        mapping.setdefault(t, set()).add(p)
    assert all(len(v) == 1 for v in mapping.values())
    assert len({next(iter(v)) for v in mapping.values()}) == 3


def test_kmeans_from_reference_state_and_replay(blobs):
    """A model carried over transforms as the reference's does; its
    transform's second run (traced, under the host-traffic guard) equals
    the first bit for bit, and a model with other centers does not take
    its stage."""
    from spark_tpu_torch.physical import graphs

    port_df, ref_df, ref = blobs
    model = model_from_state("kmeans", {
        "params": {"featuresCols": ["px", "py"]}, "centers": ref.centers})
    assert model.km.k == 3
    first = _rows(model.transform(port_df), "prediction")
    assert first == _rows(ref.transform(ref_df), "prediction")
    with graphs.guarding_stages():
        assert _rows(model.transform(port_df), "prediction") == first
    swapped = model_from_state("kmeans", {
        "params": {"featuresCols": ["px", "py"]},
        "centers": ref.centers[::-1].copy()})
    again = _rows(swapped.transform(port_df), "prediction")
    assert again == [(2 - p,) for (p,) in first]


def test_kmeans_fit_is_the_same_on_every_layout(engines):
    """Each Lloyd step's sums are exact, rounded once: the fit does not
    depend on the order of the rows."""
    table = _blobs_table(seed=31, per=60)
    port = engines["port"][0]
    a = PML.KMeans(["px", "py"], k=3, maxIter=10).fit(
        port.createDataFrame(table))
    perm = np.random.default_rng(0).permutation(table.num_rows)
    b = PML.KMeans(["px", "py"], k=3, maxIter=10, seed=13)
    bm = b.fit(port.createDataFrame(table.take(perm)))
    assert sorted(map(tuple, a.centers.tolist())) == \
        sorted(map(tuple, bm.centers.tolist()))


def test_pipeline_scaler_indexer_lr(engines):
    port_df, ref_df = _frames(engines, _pipe_table())

    def pipe(ml):
        return ml.Pipeline([
            ml.StandardScaler(["x"]),
            ml.StringIndexer("cat"),
            ml.LinearRegression(["x_scaled", "cat_idx"], "y"),
        ])

    got, want = pipe(PML).fit(port_df), pipe(RML).fit(ref_df)
    _close(got.stages[0].means + got.stages[0].stds,
           want.stages[0].means + want.stages[0].stds, 1e-9)
    assert got.stages[1].labels == want.stages[1].labels
    lr, rlr = got.stages[2], want.stages[2]
    _close(lr.coefficients + [lr.intercept],
           rlr.coefficients + [rlr.intercept], REL)
    out = got.transform(port_df)
    se = out.select(((PF.col("prediction") - PF.col("y"))
                     * (PF.col("prediction") - PF.col("y"))).alias("se"))
    assert se.agg(PF.avg("se").alias("m")).collect()[0].m < 1.0


def test_scaler_and_indexer_from_reference_state(engines):
    port_df, ref_df = _frames(engines, _pipe_table(200, seed=8))
    scaler = RML.StandardScaler(["x", "y"], withMean=False).fit(ref_df)
    indexer = RML.StringIndexer("cat", "ci").fit(ref_df)
    models = [
        model_from_state("standard_scaler", {
            "params": {"inputCols": ["x", "y"], "withMean": False},
            "means": scaler.means, "stds": scaler.stds}),
        model_from_state("string_indexer", {
            "params": {"inputCol": "cat", "outputCol": "ci"},
            "labels": indexer.labels})]
    got = models[1].transform(models[0].transform(port_df))
    want = indexer.transform(scaler.transform(ref_df))
    g = _rows(got, "x_scaled", "y_scaled", "ci")
    w = _rows(want, "x_scaled", "y_scaled", "ci")
    assert [r[2] for r in g] == [r[2] for r in w]
    _close([v for r in g for v in r[:2]], [v for r in w for v in r[:2]],
           1e-12)
    with pytest.raises(ValueError, match="unknown model kind"):
        model_from_state("svm", {})


def test_string_indexer_frequency_order(engines):
    table = pa.table({"c": ["b", "a", "b", "b", "a", "c", None]})
    port_df, ref_df = _frames(engines, table)
    model = PML.StringIndexer("c").fit(port_df)
    want = RML.StringIndexer("c").fit(ref_df)
    assert model.labels == want.labels == ["b", "a", "c"]
    assert sorted(_rows(model.transform(port_df), "c", "c_idx"),
                  key=str) == sorted(_rows(want.transform(ref_df), "c",
                                           "c_idx"), key=str)


def test_features_matrix_on_the_device_refuses_nulls(engines):
    from spark_tpu_torch.ml.pipeline import features_matrix

    port = engines["port"][0]
    df = port.createDataFrame(pa.table({"a": [1.5, 2.5, 3.5],
                                        "b": [1, None, 3]}))
    x = features_matrix(df.filter("a > 2"), ["a"])
    assert x.dtype == torch.float32 and x.device == port.device
    assert x[:, 0].tolist() == [2.5, 3.5]
    with pytest.raises(ValueError, match="'b' contains NULLs"):
        features_matrix(df, ["a", "b"])
    assert features_matrix(df.filter("b > 0"), ["b"]).tolist() == \
        [[1.0], [3.0]]
