"""The port's grouped-aggregation kernels (spark_tpu_torch/ops/seg_agg.py)
against the reference's Pallas kernels (spark_tpu/ops/pallas_agg.py).

On the CPU the port's wrappers compute their plain PyTorch versions and
the Pallas kernels run in interpret mode, as tests/test_pallas_ops.py
runs them. Inputs come from one numpy seed and carry masked rows,
out-of-range group ids, empty groups and, for min/max, NaNs.

Tolerances: counts, int64 sums and min/max exact (NaN in the same
groups; -0.0 and 0.0 compare equal, since which of the two a group of
both returns depends on the order of the plain version's scatter);
float32 sums rtol 1e-5, atol 1e-5, because the two sum in different
orders. The int64 sum mode has no Pallas counterpart: it is held against
the reference's exact int64 ``seg_sum`` (21-bit limbs summed in
float64). The CUDA kernels themselves run only on a card:
tests/test_torch_cuda.py (marker ``cuda``) and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_tpu.ops import pallas_seg_minmax, pallas_seg_sum
from spark_tpu.physical import kernels as RK
from spark_tpu_torch.ops import seg_agg

from test_torch_threads import one_torch_thread  # noqa: F401

KS = [2, 65, 100, 1024]


def _inputs(k: int, n: int = 3000, seed: int = 7, nans: bool = False):
    rng = np.random.default_rng(seed + k)
    data = (rng.normal(size=n) * 100).astype(np.float32)
    # ids in [-2, k + 2): some rows fall outside [0, k) and count nowhere;
    # only the lower half of groups is used, so the upper half is empty
    hi = max(1, k // 2)
    seg = rng.integers(-2, hi, n).astype(np.int32)
    seg[rng.random(n) < 0.05] = k + 1
    mask = rng.random(n) < 0.7
    if nans:
        data[rng.random(n) < 0.002] = np.nan
    return data, seg, mask


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("k", KS)
def test_seg_sum_matches_pallas(k):
    data, seg, mask = _inputs(k)
    want = np.asarray(pallas_seg_sum(data, seg, mask, k, interpret=True))
    got = seg_agg.seg_sum(*_torch(data, seg, mask), k).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k", KS)
def test_seg_count_matches_pallas(k):
    _, seg, mask = _inputs(k)
    want = np.asarray(pallas_seg_sum(mask.astype(np.float32), seg, mask, k,
                                     interpret=True, exact_int=True))
    got = seg_agg.seg_sum(None, *_torch(seg, mask), k, exact_int=True)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[k // 2 + 1:] == 0).all()  # empty groups present


@pytest.mark.parametrize("is_max", [False, True])
@pytest.mark.parametrize("k", KS)
def test_seg_minmax_matches_pallas(k, is_max):
    data, seg, mask = _inputs(k, nans=True)
    want = np.asarray(pallas_seg_minmax(data, seg, mask, k, is_max=is_max,
                                        interpret=True))
    got = seg_agg.seg_minmax(*_torch(data, seg, mask), k, is_max).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got, want)  # NaN == NaN here
    assert np.isinf(want[k // 2 + 1:]).all()  # empty groups: +-inf


@pytest.mark.parametrize("k", [65, 168, 1024])
def test_seg_sum_int64_matches_reference(k):
    """Values in +-1e15 with negatives, masked rows, empty upper groups."""
    rng = np.random.default_rng(11 + k)
    n = 3000
    seg = rng.integers(0, max(1, k // 2), n).astype(np.int32)
    mask = rng.random(n) < 0.7
    data = rng.integers(-10 ** 15, 10 ** 15, n)
    want = np.asarray(RK.seg_sum(jnp.asarray(data), jnp.asarray(seg),
                                 jnp.asarray(mask), k))
    for got in (seg_agg.seg_sum(*_torch(data, seg, mask), k),
                seg_agg.seg_sum_plain(*_torch(data, seg, mask), k)):
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)
    assert (want[k // 2:] == 0).all() and (want < 0).any()


@pytest.mark.parametrize("is_max", [False, True])
def test_seg_minmax_signed_zero_and_inf_groups(is_max):
    """Group 0 holds -0.0 and +0.0, group 1 only +inf rows, group 2 only
    -inf rows, group 3 only masked rows, the rest no rows."""
    k = 65
    seg = np.array([0, 0, 0, 1, 1, 2, 2, 3, 0, 1], dtype=np.int32)
    data = np.array([-0.0, 0.0, -0.0, np.inf, np.inf, -np.inf, -np.inf,
                     5.0, 7.0, -1.0], dtype=np.float32)
    mask = np.array([True] * 8 + [False, False])
    mask[7] = False
    want = np.asarray(pallas_seg_minmax(data, seg, mask, k, is_max=is_max,
                                        interpret=True))
    got = seg_agg.seg_minmax(*_torch(data, seg, mask), k, is_max).numpy()
    np.testing.assert_array_equal(got, want)
    empty = -np.inf if is_max else np.inf
    assert got[0] == 0.0
    assert got[1] == np.inf and got[2] == -np.inf
    assert (got[3:] == empty).all()


def test_seg_minmax_nan_group_and_all_masked():
    seg = torch.tensor([0, 0, 1, 1, 2], dtype=torch.int32)
    data = torch.tensor([1.0, float("nan"), 5.0, -3.0, 7.0])
    mask = torch.tensor([True, True, True, True, False])
    mn = seg_agg.seg_minmax(data, seg, mask, 3)
    mx = seg_agg.seg_minmax(data, seg, mask, 3, is_max=True)
    assert torch.isnan(mn[0]) and torch.isnan(mx[0])
    assert mn[1] == -3.0 and mx[1] == 5.0
    assert mn[2] == float("inf") and mx[2] == float("-inf")


def test_cpu_tensors_take_plain_version_without_launch():
    data, seg, mask = _torch(*_inputs(100))
    before = (seg_agg.seg_sum.launches, seg_agg.seg_minmax.launches)
    seg_agg.seg_sum(data, seg, mask, 100)
    seg_agg.seg_sum(None, seg, mask, 100, exact_int=True)
    seg_agg.seg_minmax(data, seg, mask, 100)
    assert (seg_agg.seg_sum.launches, seg_agg.seg_minmax.launches) == before
