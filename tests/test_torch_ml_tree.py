"""The port's trees, forests and cross validation
(``spark_tpu_torch/ml/tree.py``, ``ml/tuning.py``) against the JAX
package's on the inputs of tests/test_ml.py, cut to n <= 600 rows,
depth <= 3 and at most 3 trees (the reference's fits run once per
module).

Tolerances (``ml/tree.py``'s docstring says why):

- the bin edges: ``jnp.quantile``'s bit for bit (numerically equal: the
  sign of a zero may differ);
- classification trees and forests: equal split for split (feature,
  bin and threshold) and leaf for leaf, also with the histograms summed
  by ``seg_fsum`` as on the card;
- regression trees and forests: the same splits, leaves within relative
  1e-5 (float32 histograms summed in another order);
- a tree carried over from the reference (``model_from_state``)
  predicts as the reference's does: classes and a single tree's values
  exactly, a forest's mean within relative 1e-12 (XLA may divide by
  the number of trees as a multiplication by its reciprocal).
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_tpu.ml as RML
import spark_tpu_torch.ml as PML
from spark_tpu_torch.api.session import SparkSession as PortSession
from spark_tpu_torch.ml import tree as PT
from spark_tpu_torch.ml.state import model_from_state
from spark_tpu_torch.physical import kernels as PK


@pytest.fixture(scope="module")
def engines(spark):
    port = PortSession.builder.device("cpu").master("local").getOrCreate()
    return {"ref": spark, "port": port}


def _frames(engines, table):
    return (engines["port"].createDataFrame(table),
            engines["ref"].createDataFrame(table))


def _xor_table(n=600, seed=3):
    """Nonlinear (XOR-ish) data with a noise feature: linear models cap
    near 50%, trees exceed 90%."""
    rng = np.random.default_rng(seed)
    x1 = rng.normal(size=n)
    x2 = rng.normal(size=n)
    x3 = np.round(rng.normal(size=n) * 4) / 4  # ties in the edges
    y = ((x1 > 0) ^ (x2 > 0)).astype(np.float64)
    return pa.table({"x1": x1, "x2": x2, "x3": x3, "label": y})


def _sine_table(n=600, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, size=(n, 2))
    y = np.sin(x[:, 0]) * 2 + np.where(x[:, 1] > 0, 3.0, -3.0)
    return pa.table({"a": x[:, 0], "b": x[:, 1], "label": y})


FEATS = ["x1", "x2", "x3"]


def _same_trees(got, want, leaf_rel=0.0):
    assert len(got.fits) == len(want.fits)
    for g, w in zip(got.fits, want.fits):
        assert g.splits == w.splits
        assert g.leaves.keys() == w.leaves.keys()
        for nid, v in w.leaves.items():
            if leaf_rel:
                assert g.leaves[nid] == pytest.approx(v, rel=leaf_rel,
                                                      abs=1e-6)
            else:
                assert g.leaves[nid] == v, (nid, g.leaves[nid], v)


def _predictions(df, *cols):
    return [tuple(r[c] for c in cols) for r in df.collect()]


@pytest.mark.parametrize("n,d,kind", [(600, 3, "normal"), (37, 2, "ties"),
                                      (2, 1, "normal"), (400, 2, "nan")])
def test_quantile_edges_are_the_references(n, d, kind):
    import jax.numpy as jnp

    from spark_tpu.ml.tree import _bin_features as ref_bin

    rng = np.random.default_rng(n)
    x = rng.normal(size=(n, d)).astype(np.float32) * 100
    if kind == "ties":
        x = np.round(x / 50).astype(np.float32)
    if kind == "nan":
        x[7, 1] = np.nan
    want_b, want_e = (np.asarray(a) for a in ref_bin(jnp.asarray(x)))
    got_b, got_e = PT._bin_features(torch.from_numpy(x))
    np.testing.assert_array_equal(got_e.numpy(), want_e)
    np.testing.assert_array_equal(got_b.numpy(), want_b)


@pytest.fixture(scope="module")
def xor(engines):
    port_df, ref_df = _frames(engines, _xor_table())
    ref = RML.DecisionTreeClassifier(FEATS, "label", maxDepth=3) \
        .fit(ref_df)
    return port_df, ref_df, ref


@pytest.mark.parametrize("fsum", [False, True], ids=["index_add", "seg_fsum"])
def test_decision_tree_classifier_equals_the_references(xor, monkeypatch,
                                                        fsum):
    """Split for split and leaf for leaf; with ``fsum`` the histograms
    take ``seg_fsum`` (its plain version here) as on the card."""
    if fsum:
        monkeypatch.setattr(PK, "_fsum_on", lambda t: True)
    port_df, ref_df, ref = xor
    model = PML.DecisionTreeClassifier(FEATS, "label", maxDepth=3) \
        .fit(port_df)
    _same_trees(model, ref)
    got = _predictions(model.transform(port_df), "probability",
                       "prediction")
    assert got == _predictions(ref.transform(ref_df), "probability",
                               "prediction")


def test_decision_tree_beats_logistic_on_xor(xor):
    port_df, _, _ = xor
    ev = PML.MulticlassClassificationEvaluator(labelCol="label")
    tree = PML.DecisionTreeClassifier(["x1", "x2"], "label", maxDepth=4)
    tree_acc = ev.evaluate(tree.fit(port_df).transform(port_df))
    lr = PML.LogisticRegression(["x1", "x2"], "label", maxIter=100)
    lr_acc = ev.evaluate(lr.fit(port_df).transform(port_df))
    assert tree_acc > 0.9 and tree_acc > lr_acc + 0.2, (tree_acc, lr_acc)


@pytest.fixture(scope="module")
def forest(engines, xor):
    port_df, ref_df = xor[:2]
    kw = dict(numTrees=3, maxDepth=3, featureSubsetStrategy=0.67,
              minInstancesPerNode=2, seed=11)
    ref = RML.RandomForestClassifier(FEATS, "label", **kw).fit(ref_df)
    return port_df, ref_df, ref, kw


@pytest.mark.parametrize("fsum", [False, True], ids=["index_add", "seg_fsum"])
def test_random_forest_classifier_equals_the_references(forest, monkeypatch,
                                                        fsum):
    """The same bootstrap and feature subsets (numpy's Generator), so
    the same trees."""
    if fsum:
        monkeypatch.setattr(PK, "_fsum_on", lambda t: True)
    port_df, ref_df, ref, kw = forest
    model = PML.RandomForestClassifier(FEATS, "label", **kw).fit(port_df)
    _same_trees(model, ref)
    assert _predictions(model.transform(port_df), "prediction") == \
        _predictions(ref.transform(ref_df), "prediction")


@pytest.fixture(scope="module")
def sine(engines):
    port_df, ref_df = _frames(engines, _sine_table())
    tree = RML.DecisionTreeRegressor(["a", "b"], "label", maxDepth=3) \
        .fit(ref_df)
    rf = RML.RandomForestRegressor(["a", "b"], "label", numTrees=3,
                                   maxDepth=3, featureSubsetStrategy=1.0) \
        .fit(ref_df)
    return port_df, ref_df, tree, rf


def test_regression_tree_and_forest(sine):
    port_df, ref_df, tree, rf = sine
    got = PML.DecisionTreeRegressor(["a", "b"], "label", maxDepth=3) \
        .fit(port_df)
    _same_trees(got, tree, leaf_rel=1e-5)
    forest = PML.RandomForestRegressor(
        ["a", "b"], "label", numTrees=3, maxDepth=3,
        featureSubsetStrategy=1.0).fit(port_df)
    _same_trees(forest, rf, leaf_rel=1e-5)
    rmse = PML.RegressionEvaluator(labelCol="label").evaluate(
        forest.transform(port_df))
    assert rmse < 1.5 and rmse == pytest.approx(
        RML.RegressionEvaluator(labelCol="label").evaluate(
            rf.transform(ref_df)), rel=1e-4)


def _tree_state(model):
    return [{"splits": dict(f.splits), "leaves": dict(f.leaves)}
            for f in model.fits]


def test_trees_from_reference_state(xor, forest, sine):
    for (port_df, ref_df, ref, kind, params, cols) in (
            (xor[0], xor[1], xor[2], "decision_tree_classifier",
             {"featuresCols": FEATS, "labelCol": "label"},
             ("probability", "prediction")),
            (forest[0], forest[1], forest[2], "random_forest_classifier",
             {"featuresCols": FEATS, "labelCol": "label"},
             ("probability", "prediction")),
            (sine[0], sine[1], sine[3], "random_forest_regressor",
             {"featuresCols": ["a", "b"], "labelCol": "label"},
             ("prediction",))):
        model = model_from_state(kind, {"params": params,
                                        "trees": _tree_state(ref)})
        got = _predictions(model.transform(port_df), *cols)
        want = _predictions(ref.transform(ref_df), *cols)
        if len(ref.fits) == 1:
            assert got == want, kind
            continue
        if kind.endswith("classifier"):
            assert [g[-1] for g in got] == [w[-1] for w in want], kind
        assert [g[0] for g in got] == pytest.approx(
            [w[0] for w in want], rel=1e-12), kind


def test_cross_validator_picks_deeper_tree(xor):
    port_df, ref_df = xor[:2]

    def cv(ml):
        tree = ml.DecisionTreeClassifier(["x1", "x2"], "label")
        grid = ml.ParamGridBuilder().addGrid("max_depth", [1, 3]).build()
        return ml.CrossValidator(
            tree, grid, ml.MulticlassClassificationEvaluator(
                labelCol="label"), numFolds=3)

    pcv, rcv = cv(PML), cv(RML)
    model, want = pcv.fit(port_df), rcv.fit(ref_df)
    # depth 1 cannot represent XOR: both pick depth 3, on the same folds
    assert model.bestParams == want.bestParams == {"max_depth": 3}
    assert model.avgMetrics == rcv.avg_metrics == pcv.avg_metrics
    _same_trees(model.bestModel, want.bestModel)
    bad = PML.CrossValidator(PML.DecisionTreeClassifier(["x1"], "label"),
                             [{"depth": 2}],
                             PML.MulticlassClassificationEvaluator())
    with pytest.raises(AttributeError, match="depth"):
        bad.fit(port_df)
