"""Decision trees + random forests: the port of ``spark_tpu/ml/tree.py``
(reference: ml/tree/ — DecisionTreeClassifier.scala, RandomForest.scala
level-wise training over binned features, impurity/Variance.scala +
Gini).

The reference's level-wise histogram algorithm, on the session's
device. Each feature is quantile-binned into 32 bins. At each level
every row in the level gets the cell ``local * 32 + bin`` (``local`` its
node's rank in the level); the level's histograms of ``[w, w y, w y^2]``
(w the row's weight, y its label) are three grouped sums over those
cells, ``physical/kernels.seg_sum`` with ``num_segments = cells``. On
the card that is ``ops/seg_agg.seg_fsum`` in float32 (each cell's exact
sum rounded once, independent of row order), on the CPU ``index_add_``;
the reference multiplies a one-hot (rows, cells) matrix by the stats
instead, which at 6M rows and 1024 cells would be 24 GB. Prefix sums
over bins give all candidate splits, and the argmax picks each node's
(feature, bin). Rows never leave the device during growth: each level
syncs once for its gains and totals.

Parity with the reference:

- Counts, bootstrap weights and 0/1 labels make every histogram entry
  an integer below 2^24, exact in float32 in any order, so
  classification trees and forests equal the reference's split for
  split (feature and bin) and leaf for leaf, on the CPU and on the card.
  A regression tree's histograms differ from the matmul's by rounding
  only.
- The bin edges are ``jnp.quantile``'s ('linear'; the position and the
  interpolation in float64, rounded to float32 at the end), computed by
  the same formula over a sorted column, so the thresholds equal the
  reference's bit for bit (up to the sign of a zero).
- The bootstrap and the feature subsets draw from the same numpy
  ``Generator`` in the same order, so a forest grows the same trees.

Prediction compiles the fitted tree into nested CASE expressions, so
scoring fuses into whatever query pipeline follows (the reference
walks Node objects per row on the JVM)."""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from spark_tpu_torch.expr import expressions as E
from spark_tpu_torch.ml.pipeline import Estimator, Model, features_matrix
from spark_tpu_torch.physical import kernels as K

_BINS = 32
#: the quantiles of the bin edges, as the reference's
#: ``jnp.linspace(0.0, 1.0, _BINS + 1)[1:-1]`` (float64, the same values)
_QS = np.linspace(0.0, 1.0, _BINS + 1)[1:-1]


def quantile_edges(x: torch.Tensor) -> torch.Tensor:
    """(B-1, d) float32 edges: the quantiles ``_QS`` of each column of
    ``x`` as ``jnp.quantile(x, _QS, axis=0)`` computes them ('linear'):
    position ``q (n-1)`` and weights in float64, the two neighbours of
    the sorted column interpolated in float64, rounded to float32. A
    column holding a NaN has NaN edges. One column is sorted at a time
    (``torch.quantile`` refuses more than 2^24 elements)."""
    n, d = x.shape
    q = torch.as_tensor(_QS, dtype=torch.float64, device=x.device)
    pos = q * float(n - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    hw = pos - low
    lw = 1.0 - hw
    low = low.clamp(0, n - 1).long()
    high = high.clamp(0, n - 1).long()
    out = []
    for f in range(d):
        s = torch.sort(x[:, f]).values
        e = s[low].double() * lw + s[high].double() * hw
        e = torch.where(torch.isnan(s).any(),
                        torch.full_like(e, float("nan")), e)
        out.append(e.to(torch.float32))
    return torch.stack(out, dim=1)


def _bin_features(x: torch.Tensor):
    """Quantile-bin each feature column to int32 codes (the number of
    edges below the value) + edge values (reference: RandomForest.scala
    findSplits quantile sketching)."""
    edges = quantile_edges(x)
    binned = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for b in range(edges.shape[0]):
        binned += (x > edges[b][None, :]).to(torch.int32)
    return binned, edges


def _grow_tree(xb: torch.Tensor, edges: np.ndarray, y: torch.Tensor,
               max_depth: int, min_rows: int, rng: np.random.Generator,
               sample_weight: Optional[np.ndarray] = None,
               feature_frac: float = 1.0):
    """Level-wise growth; returns a dict-shaped tree:
    {node_id: (feature, threshold_value, bin)} for internal nodes and
    {node_id: leaf_value} for leaves (node ids heap-ordered: children
    of i are 2i+1 / 2i+2). Split criterion: variance reduction (squared
    loss — Gini for 0/1 labels is an affine transform of it, so one
    criterion serves both learners, impurity/Variance.scala)."""
    n, d = xb.shape
    dev = xb.device
    feat_mask = np.ones((d,), bool)
    if feature_frac < 1.0:
        k = max(1, int(round(feature_frac * d)))
        feat_mask[:] = False
        feat_mask[rng.choice(d, size=k, replace=False)] = True
    feats = [f for f in range(d) if feat_mask[f]]
    w = (torch.from_numpy(sample_weight.astype(np.float32)).to(dev)
         if sample_weight is not None
         else torch.ones((n,), dtype=torch.float32, device=dev))
    wy = w * y
    stats = (w, wy, wy * y)

    node = torch.zeros((n,), dtype=torch.int64, device=dev)  # heap id
    splits = {}  # node_id -> (feature, threshold_value, bin)
    leaves = {}  # node_id -> value
    level_nodes = [0]
    for depth in range(max_depth + 1):
        if not level_nodes:
            break
        n_level = len(level_nodes)
        # heap ids at a level are sparse (leaf siblings drop out): map
        # them to dense local ids; rows of earlier leaves have smaller
        # ids and map to n_level (out of the level)
        lut = np.full((level_nodes[-1] + 1,), n_level, np.int64)
        lut[level_nodes] = np.arange(n_level)
        local = torch.from_numpy(lut).to(dev)[node]
        in_level = local < n_level
        cells = n_level * _BINS
        base = torch.where(in_level, local * _BINS, 0)
        hists = []
        # the last level only needs its totals (every node is a leaf)
        for f in (feats if depth < max_depth else feats[:1]):
            key = base + xb[:, f]
            hists.append(torch.stack(
                [K.seg_sum(s, key, in_level, cells) for s in stats],
                dim=1).reshape(n_level, _BINS, 3))
        # per node: total stats (same for every feature)
        tot = hists[0].sum(dim=1)  # (n_level, 3)
        gains, bins = [], []
        base_score = tot[:, 1] * tot[:, 1] / torch.clamp_min(tot[:, 0], 1e-9)
        for h in hists:
            lc = torch.cumsum(h, dim=1)[:, :-1, :]  # left of bin b+1
            rc = tot[:, None, :] - lc
            ln, ls = lc[..., 0], lc[..., 1]
            rn, rs = rc[..., 0], rc[..., 1]
            ok = (ln >= min_rows) & (rn >= min_rows)
            # variance reduction == sum of per-side (sum^2/count) up to
            # a constant; maximize that
            gain = torch.where(
                ok,
                ls * ls / torch.clamp_min(ln, 1e-9)
                + rs * rs / torch.clamp_min(rn, 1e-9),
                torch.full((), float("-inf"), device=dev))
            gains.append(gain.max(dim=1).values - base_score)
            bins.append(torch.argmax(gain, dim=1))
        # one host sync a level
        g_all = torch.stack(gains).cpu().numpy()
        b_all = torch.stack(bins).cpu().numpy()
        tot_np = tot.cpu().numpy()
        best_gain = np.full((n_level,), 1e-12)
        best_feat = np.full((n_level,), -1, np.int64)
        best_bin = np.zeros((n_level,), np.int64)
        for f, g, b in zip(feats, g_all, b_all):
            upd = g > best_gain
            best_gain = np.where(upd, g, best_gain)
            best_feat = np.where(upd, f, best_feat)
            best_bin = np.where(upd, b, best_bin)

        next_level = []
        split_feat = np.full((level_nodes[-1] + 1,), -1, np.int64)
        split_bin = np.zeros((level_nodes[-1] + 1,), np.int64)
        for i, nid in enumerate(level_nodes):
            mean = (tot_np[i, 1] / tot_np[i, 0]
                    if tot_np[i, 0] > 0 else 0.0)
            if depth == max_depth or best_feat[i] < 0 \
                    or tot_np[i, 0] < 2 * min_rows:
                leaves[nid] = float(mean)
                continue
            f, b = int(best_feat[i]), int(best_bin[i])
            thr = float(edges[b, f])
            splits[nid] = (f, thr, b)
            split_feat[nid], split_bin[nid] = f, b
            next_level.extend([2 * nid + 1, 2 * nid + 2])
        if next_level:
            # rows of split nodes go left (2i+1) where bin <= b, else
            # right (2i+2)
            sf = torch.from_numpy(split_feat).to(dev)[
                node.clamp_max(level_nodes[-1])]
            sb = torch.from_numpy(split_bin).to(dev)[
                node.clamp_max(level_nodes[-1])]
            moves = in_level & (sf >= 0)
            xv = xb.gather(1, sf.clamp_min(0)[:, None])[:, 0]
            node = torch.where(moves, 2 * node + 1 + (xv > sb).long(), node)
        level_nodes = sorted(next_level)
    return splits, leaves


class _TreeFit:
    """One fitted tree as parallel dicts keyed by node id."""

    def __init__(self, splits, leaves, features: List[str]):
        self.splits = splits
        self.leaves = leaves
        self.features = features

    def to_expr(self, nid: int = 0) -> E.Expression:
        """Nested CASE over feature columns (fuses into the plan)."""
        if nid in self.leaves:
            return E.Literal(float(self.leaves[nid]))
        f, thr, _ = self.splits[nid]
        cond = E.Cmp("<=", E.Col(self.features[f]), E.Literal(thr))
        return E.Case(((cond, self.to_expr(2 * nid + 1)),),
                      self.to_expr(2 * nid + 2))


class DecisionTreeRegressor(Estimator):
    """CART regression tree (reference: ml/regression/
    DecisionTreeRegressor.scala)."""

    def __init__(self, featuresCols: Sequence[str], labelCol: str,
                 predictionCol: str = "prediction", maxDepth: int = 5,
                 minInstancesPerNode: int = 1, seed: int = 42):
        self.features_cols = list(featuresCols)
        self.label_col = labelCol
        self.prediction_col = predictionCol
        self.max_depth = maxDepth
        self.min_rows = minInstancesPerNode
        self.seed = seed
        self._classifier = False

    def _fit_trees(self, df, n_trees: int, feature_frac: float,
                   bootstrap: bool):
        xy = features_matrix(df, self.features_cols + [self.label_col])
        x, y = xy[:, :-1], xy[:, -1].contiguous()
        xb, edges = _bin_features(x)
        edges = edges.cpu().numpy()
        rng = np.random.default_rng(self.seed)
        n = int(x.shape[0])
        fits = []
        for _ in range(n_trees):
            w = None
            if bootstrap:
                w = np.bincount(rng.integers(0, n, n),
                                minlength=n).astype(np.float32)
            s, lv = _grow_tree(xb, edges, y, self.max_depth,
                               self.min_rows, rng, sample_weight=w,
                               feature_frac=feature_frac)
            fits.append(_TreeFit(s, lv, self.features_cols))
        return fits

    def fit(self, df) -> "TreeEnsembleModel":
        fits = self._fit_trees(df, 1, 1.0, bootstrap=False)
        return TreeEnsembleModel(self, fits)


class DecisionTreeClassifier(DecisionTreeRegressor):
    """Binary classification tree: 0/1 labels make Gini an affine
    transform of variance, so the regression grower serves directly
    (reference: ml/classification/DecisionTreeClassifier.scala +
    impurity/Gini)."""

    def __init__(self, featuresCols: Sequence[str], labelCol: str,
                 predictionCol: str = "prediction",
                 probabilityCol: str = "probability",
                 maxDepth: int = 5, minInstancesPerNode: int = 1,
                 seed: int = 42):
        super().__init__(featuresCols, labelCol, predictionCol,
                         maxDepth, minInstancesPerNode, seed)
        self.probability_col = probabilityCol
        self._classifier = True


class RandomForestRegressor(DecisionTreeRegressor):
    """Bagged ensemble: bootstrap rows + feature subsampling per tree
    (reference: ml/regression/RandomForestRegressor.scala,
    RandomForest.scala)."""

    def __init__(self, featuresCols: Sequence[str], labelCol: str,
                 predictionCol: str = "prediction", numTrees: int = 20,
                 maxDepth: int = 5, minInstancesPerNode: int = 1,
                 featureSubsetStrategy: float = 0.7, seed: int = 42):
        super().__init__(featuresCols, labelCol, predictionCol,
                         maxDepth, minInstancesPerNode, seed)
        self.num_trees = numTrees
        self.feature_frac = float(featureSubsetStrategy)

    def fit(self, df) -> "TreeEnsembleModel":
        fits = self._fit_trees(df, self.num_trees, self.feature_frac,
                               bootstrap=True)
        return TreeEnsembleModel(self, fits)


class RandomForestClassifier(RandomForestRegressor):
    def __init__(self, featuresCols: Sequence[str], labelCol: str,
                 predictionCol: str = "prediction",
                 probabilityCol: str = "probability",
                 numTrees: int = 20, maxDepth: int = 5,
                 minInstancesPerNode: int = 1,
                 featureSubsetStrategy: float = 0.7, seed: int = 42):
        super().__init__(featuresCols, labelCol, predictionCol,
                         numTrees, maxDepth, minInstancesPerNode,
                         featureSubsetStrategy, seed)
        self.probability_col = probabilityCol
        self._classifier = True


class TreeEnsembleModel(Model):
    """Average of per-tree CASE expressions; classification thresholds
    the mean leaf probability at 0.5."""

    def __init__(self, est, fits: List[_TreeFit]):
        self.est = est
        self.fits = fits

    def transform(self, df):
        score: E.Expression = self.fits[0].to_expr()
        for f in self.fits[1:]:
            score = E.Arith("+", score, f.to_expr())
        if len(self.fits) > 1:
            score = E.Arith("/", score, E.Literal(float(len(self.fits))))
        if getattr(self.est, "_classifier", False):
            df = df.withColumn(self.est.probability_col, score)
            pred = E.Case(
                ((E.Cmp(">", E.Col(self.est.probability_col),
                        E.Literal(0.5)), E.Literal(1.0)),),
                E.Literal(0.0))
            return df.withColumn(self.est.prediction_col, pred)
        return df.withColumn(self.est.prediction_col, score)
