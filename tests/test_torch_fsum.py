"""The plain version of the port's deterministic grouped float sum
(``spark_tpu_torch/ops/seg_agg.py:seg_fsum_plain``), which the CUDA
kernel ``ops/csrc/seg_fsum.cu`` equals bit for bit on the card
(tests/test_torch_cuda.py, chip_smoke.py), and the engine's routing of
float sums to it.

The reference's float branch is ``jax.ops.segment_sum``
(``spark_tpu/physical/kernels.py:seg_sum``); on the CPU a float64
``index_add_`` equals it bit for bit. The fixed-point sum is held within
1e-12 * sum|x| of each group of that (float32 data: 1e-5 * sum|x|), and
bit-identical across a static layout, its compacted copy and a row
permutation. NaN, +-inf, zeros-only and empty groups follow the kernel's
rules: a NaN or both infinities give NaN, one infinity gives it, an
empty group or one of zeros gives 0.0.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_tpu.physical import kernels as RK
from spark_tpu_torch.ops import seg_agg
from spark_tpu_torch.physical import kernels as PK

KS = [1, 6, 168, 1024, 10_000]


def _inputs(k: int, n: int = 20_000, seed: int = 3, dtype=np.float64):
    """Group ids in [-2, k + 2) (some out of range), 70% of rows live,
    values spread over twelve decades with both signs."""
    rng = np.random.default_rng(seed + k)
    seg = rng.integers(-2, k + 2, n).astype(np.int32)
    mask = rng.random(n) < 0.7
    x = (rng.normal(size=n) * 10.0 ** rng.integers(-6, 7, n)).astype(dtype)
    return x, seg, mask


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)


def _index_add(x, seg, mask, k, absolute=False):
    live = mask & (seg >= 0) & (seg < k)
    v = torch.from_numpy(x[live]).to(torch.float64)
    out = torch.zeros(k, dtype=torch.float64)
    return out.index_add_(0, torch.from_numpy(seg[live]).long(),
                          v.abs() if absolute else v)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-5)])
def test_within_bound_of_index_add(k, dtype, tol):
    x, seg, mask = _inputs(k, dtype=dtype)
    got = seg_agg.seg_fsum_plain(*map(torch.from_numpy, (x, seg, mask)), k)
    assert got.dtype == torch.from_numpy(x).dtype and got.shape == (k,)
    want = _index_add(x, seg, mask, k)
    bound = tol * _index_add(x, seg, mask, k, absolute=True)
    assert bool(((got.to(torch.float64) - want).abs() <= bound).all())


@pytest.mark.parametrize("k", KS)
def test_matches_reference_segment_sum(k):
    """Against the reference's float branch on the same rows (ids in
    range: the reference's single-group path reads no ids)."""
    x, seg, mask = _inputs(k)
    seg = np.clip(seg, 0, k - 1)
    want = np.asarray(RK.seg_sum(jnp.asarray(x), jnp.asarray(seg),
                                 jnp.asarray(mask), k))
    got = seg_agg.seg_fsum_plain(*map(torch.from_numpy, (x, seg, mask)),
                                 k).numpy()
    bound = 1e-12 * _index_add(x, seg, mask, k, absolute=True).numpy()
    assert (np.abs(got - want) <= bound).all()


@pytest.mark.parametrize("k", KS)
def test_bits_independent_of_layout(k):
    """A static batch, its compacted copy (dead rows dropped) and a
    permutation of its rows give the same bits."""
    x, seg, mask = _inputs(k)
    t = list(map(torch.from_numpy, (x, seg, mask)))
    got = seg_agg.seg_fsum_plain(*t, k)
    live = t[2]
    compact = seg_agg.seg_fsum_plain(
        t[0][live], t[1][live], torch.ones(int(live.sum()),
                                           dtype=torch.bool), k)
    perm = torch.from_numpy(np.random.default_rng(k).permutation(len(x)))
    shuffled = seg_agg.seg_fsum_plain(t[0][perm], t[1][perm], t[2][perm], k)
    assert torch.equal(_bits(got), _bits(compact))
    assert torch.equal(_bits(got), _bits(shuffled))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_nan_inf_zero_and_empty_groups(dtype):
    nan, inf = float("nan"), float("inf")
    rows = [(0, 1.0), (0, nan), (1, inf), (1, 2.0), (2, inf), (2, -inf),
            (3, -inf), (4, 0.0), (4, -0.0), (6, -0.0), (7, 1e-300),
            (7, -1e-300), (8, 5e-324), (8, 5e-324), (9, 2.5), (9, -2.5)]
    seg = torch.tensor([r[0] for r in rows], dtype=torch.int32)
    x = torch.tensor([r[1] for r in rows], dtype=dtype)
    got = seg_agg.seg_fsum_plain(x, seg, torch.ones(len(rows),
                                                    dtype=torch.bool), 10)
    assert torch.isnan(got[0]) and torch.isnan(got[2])
    assert got[1] == inf and got[3] == -inf
    for g in (4, 5, 6, 7, 9):  # zeros, empty, -0.0 alone, cancelling
        assert _bits(got[g:g + 1]).item() == 0, g
    want8 = 1e-323 if dtype == torch.float64 else 0.0
    assert got[8].item() == want8


def test_overflow_gives_inf():
    x = torch.tensor([1e308, 1e308, -1e308, -1e308, -1e308],
                     dtype=torch.float64)
    seg = torch.tensor([0, 0, 1, 1, 1], dtype=torch.int32)
    got = seg_agg.seg_fsum_plain(x, seg, torch.ones(5, dtype=torch.bool), 2)
    assert got[0] == float("inf") and got[1] == float("-inf")
    # the exact sum is finite where index_add_'s running sum overflows
    y = torch.tensor([1e308, 1e308, -1e308], dtype=torch.float64)
    got = seg_agg.seg_fsum_plain(y, torch.zeros(3, dtype=torch.int32),
                                 torch.ones(3, dtype=torch.bool), 1)
    assert got.item() == 1e308


def test_values_far_below_the_largest_drop_out():
    """Only the 90 bits below a group's largest value count: 2^-100 next
    to 1.0 is lost, 2^-80 is kept."""
    x = torch.tensor([1.0, 2.0 ** -100, 1.0, 2.0 ** -80],
                     dtype=torch.float64)
    seg = torch.tensor([0, 0, 1, 1], dtype=torch.int32)
    got = seg_agg.seg_fsum_plain(x, seg, torch.ones(4, dtype=torch.bool), 2)
    assert got[0].item() == 1.0 and got[1].item() == 1.0 + 2.0 ** -80


def test_wrapper_takes_plain_version_on_cpu():
    x, seg, mask = _inputs(168)
    t = list(map(torch.from_numpy, (x, seg, mask)))
    seg_agg.reset_launches()
    got = seg_agg.seg_fsum(*t, 168)
    assert torch.equal(_bits(got), _bits(seg_agg.seg_fsum_plain(*t, 168)))
    assert seg_agg.seg_fsum.launches == 0


@pytest.mark.parametrize("k,sorted_seg", [(6, False), (168, False),
                                          (10_000, True)])
def test_engine_routes_float_sums(k, sorted_seg, monkeypatch):
    """kernels.seg_sum sends a float sum over K > 1 groups to seg_fsum
    on the card (``_fsum_on``), on the masked, direct and sorted paths,
    and keeps index_add_ on the CPU, where it equals the reference's
    segment_sum bit for bit."""
    x, seg, mask = _inputs(k)
    if sorted_seg:
        order = np.argsort(seg, kind="stable")
        x, seg, mask = x[order], np.clip(seg[order], 0, k - 1), mask[order]
    else:
        seg = np.clip(seg, 0, k - 1)
    t = list(map(torch.from_numpy, (x, seg, mask)))
    cpu = PK.seg_sum(*t, k, sorted_seg)
    ref = np.asarray(RK.seg_sum(*map(jnp.asarray, (x, seg, mask)), k,
                                sorted_seg))
    np.testing.assert_array_equal(cpu.numpy(), ref)
    calls = []
    real = seg_agg.seg_fsum

    def spy(*a, **kw):
        calls.append(a[3])
        return real(*a, **kw)

    monkeypatch.setattr(seg_agg, "seg_fsum", spy)
    monkeypatch.setattr(PK, "_fsum_on", lambda data: True)
    routed = PK.seg_sum(*t, k, sorted_seg)
    assert calls == [k]
    assert torch.equal(_bits(routed), _bits(seg_agg.seg_fsum_plain(*t, k)))
    assert PK.seg_sum(t[0][:1], t[1][:1] * 0, t[2][:1], 1).shape == (1,)
    assert calls == [k]  # K == 1 stays a plain reduction
