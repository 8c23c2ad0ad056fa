"""The port's CUDA kernels and its SQL slice on the card (marker ``cuda``).

They skip where ``torch.cuda.is_available()`` is false: a CUDA kernel has
no CPU mode. This file imports neither jax nor the reference package, so
it also runs on a GPU machine without them (``--noconftest`` skips the
suite's jax-based conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: counts and int64 sums exact; min/max exact with NaN in the
same groups (-0.0 and +0.0 compare equal against the plain version,
whose answer for a group of both depends on its scatter order); every
mode bit-identical between two launches, signs of zeros included;
float32 sums within rtol 1e-4 / atol 1e-2 of the plain version
(different summation order); query rows on the card equal to the CPU
run's.
"""

import numpy as np
import pytest
import torch

from spark_tpu_torch.ops import seg_agg


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(k: int, n: int, seed: int = 7):
    rng = np.random.default_rng(seed + k)
    data = (rng.normal(size=n) * 100).astype(np.float32)
    seg = rng.integers(-2, max(1, k // 2), n).astype(np.int32)
    seg[rng.random(n) < 0.05] = k + 1
    mask = rng.random(n) < 0.7
    data[rng.random(n) < 0.002] = np.nan
    return data, seg, mask


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _check_all_modes(k, data, seg, mask, i64, dev):
    """Every mode against its plain version at offsets 0 and 1 (offset 1
    makes the inputs misaligned for the kernels' scalar path), and two
    launches bit-identical."""
    finite = np.nan_to_num(data, nan=0.0)
    d, s, m, f, i = [torch.from_numpy(a).to(dev)
                     for a in (data, seg, mask, finite, i64)]
    for off in (0, 1):
        dd, ss, mm, ff, ii = d[off:], s[off:], m[off:], f[off:], i[off:]
        runs = {}
        for name, x, exact in (("count", None, True), ("sum_i64", ii, False),
                               ("sum_f32", ff, False)):
            a = seg_agg.seg_sum(x, ss, mm, k, exact_int=exact)
            b = seg_agg.seg_sum(x, ss, mm, k, exact_int=exact)
            want = seg_agg.seg_sum_plain(x, ss, mm, k, exact)
            runs[name] = (a, b)
            if name == "sum_f32":
                torch.testing.assert_close(a, want, rtol=1e-4, atol=1e-2)
            else:
                assert a.dtype == torch.int64 and torch.equal(a, want), name
        for is_max in (False, True):
            a = seg_agg.seg_minmax(dd, ss, mm, k, is_max)
            b = seg_agg.seg_minmax(dd, ss, mm, k, is_max)
            want = seg_agg.seg_minmax_plain(dd, ss, mm, k, is_max)
            runs[f"max={is_max}"] = (a, b)
            assert torch.equal(torch.isnan(a), torch.isnan(want))
            assert not torch.signbit(a[torch.isnan(a)]).any()
            assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(want))
        for name, (a, b) in runs.items():
            assert torch.equal(_bits(a), _bits(b)), f"{name} off={off}"


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 65, 168, 1024])
def test_kernels_match_plain_on_card(cuda_device, k):
    """Out-of-range ids, masked rows, empty groups and NaNs; int64 values
    in +-1e15 with negatives."""
    data, seg, mask = _inputs(k, 200_003)
    i64 = np.random.default_rng(k).integers(-10 ** 15, 10 ** 15, 200_003)
    _check_all_modes(k, data, seg, mask, i64, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [65, 1024])
def test_skewed_input_on_card(cuda_device, k):
    """90% of live rows in one group, the rest spread: every mode."""
    n = 300_007
    rng = np.random.default_rng(5 + k)
    data, seg, mask = _inputs(k, n)
    hot = rng.random(n) < 0.9
    seg[hot] = 7
    i64 = rng.integers(-10 ** 15, 10 ** 15, n)
    _check_all_modes(k, data, seg, mask, i64, cuda_device)
    live = mask & (seg >= 0) & (seg < k)
    assert (seg[live] == 7).mean() > 0.85


@pytest.mark.cuda
def test_signed_zero_inf_and_wrap_on_card(cuda_device):
    """A group of -0.0 and +0.0 gives min -0.0 and max +0.0 on every
    launch; a group of only +inf rows gives +inf for both, not the empty
    group's answer; int64 sums wrap as index_add_ does."""
    k = 100
    n = 50_000
    seg = np.full(n, 5, dtype=np.int32)
    seg[: n // 2] = 3
    data = np.where(np.arange(n) % 2 == 0, -0.0, 0.0).astype(np.float32)
    data[n // 2:] = np.inf
    mask = np.ones(n, dtype=bool)
    big = np.full(n, 2 ** 62 + 12345, dtype=np.int64)
    d, s, m, i = [torch.from_numpy(a).to(cuda_device)
                  for a in (data, seg, mask, big)]
    for _ in range(2):
        mn = seg_agg.seg_minmax(d, s, m, k).cpu()
        mx = seg_agg.seg_minmax(d, s, m, k, is_max=True).cpu()
        assert mn[3] == 0.0 and torch.signbit(mn[3])
        assert mx[3] == 0.0 and not torch.signbit(mx[3])
        assert mn[5] == float("inf") and mx[5] == float("inf")
        assert mn[0] == float("inf") and mx[0] == float("-inf")  # empty
    got = seg_agg.seg_sum(i, s, m, k)
    assert torch.equal(got, seg_agg.seg_sum_plain(i, s, m, k))
    want = (n // 2 * (2 ** 62 + 12345) + 2 ** 63) % 2 ** 64 - 2 ** 63
    assert got[3].item() == want


@pytest.mark.cuda
def test_kernels_small_and_empty_on_card(cuda_device):
    seg = torch.tensor([0, 0, 1, 1, 2], dtype=torch.int32, device=cuda_device)
    data = torch.tensor([1.0, float("nan"), 5.0, -3.0, 7.0],
                        device=cuda_device)
    mask = torch.tensor([True, True, True, True, False], device=cuda_device)
    mn = seg_agg.seg_minmax(data, seg, mask, 3).cpu()
    assert torch.isnan(mn[0]) and mn[1] == -3.0 and mn[2] == float("inf")
    cnt = seg_agg.seg_sum(None, seg, mask, 3, exact_int=True).cpu()
    assert cnt.tolist() == [2, 2, 0]
    empty = torch.zeros(0, dtype=torch.int32, device=cuda_device)
    out = seg_agg.seg_sum(None, empty, empty.bool(), 5, exact_int=True)
    assert out.cpu().tolist() == [0] * 5


@pytest.mark.cuda
def test_slice_on_card_matches_cpu(cuda_device):
    from spark_tpu_torch.api.session import SparkSession
    from spark_tpu_torch.tpch import (Q1_WIDE, QUERIES, generate_tables,
                                      register_views)

    tables = generate_tables(0.02, seed=99)
    gpu = SparkSession(device="cuda")
    cpu = SparkSession(device="cpu")
    register_views(gpu, tables)
    register_views(cpu, tables)
    seg_agg.reset_launches()
    for q in (QUERIES[1], Q1_WIDE):
        got = [tuple(r) for r in gpu.sql(q).collect()]
        assert got and got == [tuple(r) for r in cpu.sql(q).collect()]
    assert seg_agg.seg_sum.mode_launches == {"count": 7, "sum_f32": 0,
                                             "sum_i64": 2}
    assert seg_agg.seg_minmax.mode_launches == {"min": 1, "max": 1}
    assert seg_agg.seg_sum.launches == 9
    assert seg_agg.seg_minmax.launches == 2
