"""The port's CUDA kernels and its SQL slice on the card (marker ``cuda``).

They skip where ``torch.cuda.is_available()`` is false: a CUDA kernel has
no CPU mode. This file imports neither jax nor the reference package, so
it also runs on a GPU machine without them (``--noconftest`` skips the
suite's jax-based conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: counts exact; min/max exact with NaN in the same groups;
float32 sums bit-identical from run to run and within rtol 1e-4 /
atol 1e-2 of the plain version (different summation order); query rows
on the card equal to the CPU run's.
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


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 65, 168, 1024])
def test_kernels_match_plain_on_card(cuda_device, k):
    """Out-of-range ids, masked rows, empty groups and NaNs; offset 1
    makes the inputs misaligned for the kernels' scalar path."""
    data, seg, mask = _inputs(k, 200_003)
    finite = np.nan_to_num(data, nan=0.0)
    d, s, m, f = [torch.from_numpy(a).to(cuda_device)
                  for a in (data, seg, mask, finite)]
    for off in (0, 1):
        dd, ss, mm, ff = d[off:], s[off:], m[off:], f[off:]
        got = seg_agg.seg_sum(None, ss, mm, k, exact_int=True)
        assert torch.equal(got, seg_agg.seg_sum_plain(None, ss, mm, k, True))
        for is_max in (False, True):
            got = seg_agg.seg_minmax(dd, ss, mm, k, is_max)
            want = seg_agg.seg_minmax_plain(dd, ss, mm, k, is_max)
            assert torch.equal(torch.isnan(got), torch.isnan(want))
            assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
        a = seg_agg.seg_sum(ff, ss, mm, k)
        b = seg_agg.seg_sum(ff, ss, mm, k)
        assert torch.equal(a, b)
        torch.testing.assert_close(a, seg_agg.seg_sum_plain(ff, ss, mm, k),
                                   rtol=1e-4, atol=1e-2)


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
    before = (seg_agg.seg_sum.launches, seg_agg.seg_minmax.launches)
    for q in (QUERIES[1], Q1_WIDE):
        got = [tuple(r) for r in gpu.sql(q).collect()]
        assert got and got == [tuple(r) for r in cpu.sql(q).collect()]
    assert seg_agg.seg_sum.launches - before[0] == 7
    assert seg_agg.seg_minmax.launches - before[1] == 2
