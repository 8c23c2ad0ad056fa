"""KMeans: the port of ``spark_tpu/ml/clustering.py`` (reference:
ml/clustering/KMeans.scala — Lloyd's algorithm).

Lloyd's loop runs in float32 on the session's device. The assignment
step takes each row's squared distance to each center as
``sum_j (x_j - c_j)^2``, elementwise in a fixed order of j (the
reference expands it into ``|x|^2 - 2 x.c + |c|^2`` with a matmul: the
same distances, rounded in another order). The update step sums each
cluster's rows with ``ops/seg_agg.seg_fsum`` (each sum exact, rounded
once; its plain version on CPU tensors), where the reference multiplies
by a one-hot matrix. Every step is then IEEE elementwise arithmetic or a
sum rounded once, so a fit on the card equals the same fit on the CPU
bit for bit: the same centers and the same assignments. The
farthest-point init runs on the host in numpy with the reference's
``default_rng(seed)``, so both packages start from the same rows."""

from __future__ import annotations

import hashlib
from typing import Sequence

import numpy as np
import torch

from spark_tpu_torch import types as T
from spark_tpu_torch.device import device_table
from spark_tpu_torch.expr import expressions as E
from spark_tpu_torch.ml.pipeline import Estimator, Model, features_matrix
from spark_tpu_torch.physical import kernels as K


def nearest(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Index of each row's nearest center (the first of equals)."""
    d2 = None
    for j in range(x.shape[1]):
        diff = x[:, j, None] - centers[None, :, j]
        sq = diff * diff
        d2 = sq if d2 is None else d2 + sq
    return torch.argmin(d2, dim=1)


class KMeans(Estimator):
    def __init__(self, featuresCols: Sequence[str], k: int,
                 predictionCol: str = "prediction",
                 maxIter: int = 50, seed: int = 13):
        self.features_cols = list(featuresCols)
        self.k = int(k)
        self.prediction_col = predictionCol
        self.max_iter = maxIter
        self.seed = seed

    def fit(self, df) -> "KMeansModel":
        x = features_matrix(df, self.features_cols)
        k = self.k
        # k-means|| style greedy farthest-point init (reference:
        # KMeans.scala initKMeansParallel) — random init can drop two
        # seeds in one blob and converge to a bad local optimum
        rng = np.random.default_rng(self.seed)
        xn = x.cpu().numpy()
        idxs = [int(rng.integers(0, xn.shape[0]))]
        d2 = ((xn - xn[idxs[0]]) ** 2).sum(1)
        for _ in range(1, k):
            nxt = int(np.argmax(d2))
            idxs.append(nxt)
            d2 = np.minimum(d2, ((xn - xn[nxt]) ** 2).sum(1))
        centers = x[torch.as_tensor(idxs, device=x.device)]
        live = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
        cols = [x[:, j].contiguous() for j in range(x.shape[1])]
        for _ in range(self.max_iter):
            a = nearest(x, centers)
            counts = torch.bincount(a, minlength=k).to(x.dtype)
            seg = a.to(torch.int32)
            sums = torch.stack([K.exact_seg_fsum(c, seg, live, k)
                                for c in cols], dim=1)
            new = sums / torch.clamp_min(counts, 1.0)[:, None]
            centers = torch.where((counts > 0)[:, None], new, centers)
        return KMeansModel(self, centers.cpu().numpy())


class _Nearest:
    """A KMeansModel's tensor UDF: each row's nearest center. The
    centers reach the stage through ``device.device_table`` (copied once
    per device, so a captured stage finds them on the card); its repr
    names their digest, so two models' transforms never share a plan's
    key."""

    __name__ = "nearest"

    def __init__(self, centers: np.ndarray):
        self.centers = np.ascontiguousarray(centers, dtype=np.float32)
        self._digest = hashlib.blake2b(self.centers.tobytes(),
                                       digest_size=8).hexdigest()

    def __call__(self, *cols):
        x = torch.stack([c.to(torch.float32) for c in cols], dim=1)
        centers = device_table(self.centers, x.device)
        return nearest(x, centers).to(torch.int32)

    def __repr__(self):
        return f"kmeans_nearest({self._digest})"


class KMeansModel(Model):
    def __init__(self, km: KMeans, centers: np.ndarray):
        self.km = km
        self.centers = centers

    def transform(self, df):
        udf = E.TensorUdf(_Nearest(self.centers), T.INT32,
                          tuple(E.Col(c) for c in self.km.features_cols),
                          "nearest")
        return df.withColumn(self.km.prediction_col, udf)
