"""The plain version of the port's exact grouped float sum
(``spark_tpu_torch/ops/seg_agg.py:seg_fsum_plain``), which the CUDA
kernel ``ops/csrc/seg_fsum.cu`` equals bit for bit on the card
(tests/test_torch_cuda.py, chip_smoke.py), and the engine's routing of
float sums to it.

Each group's result is its exact sum rounded once to nearest-even: held
equal to ``math.fsum`` (correctly rounded) for float64, to the exact
``fractions.Fraction`` sum rounded once where ``math.fsum`` overflows
on the way (near DBL_MAX), and to the ``Fraction`` sum rounded once to
float32 for float32 data. The reference's float branch is
``jax.ops.segment_sum`` (``spark_tpu/physical/kernels.py:seg_sum``); on
the CPU a float64 ``index_add_`` equals it bit for bit, and the exact sum
is held within 1e-12 * sum|x| of each group of that (float32 data: 1e-5
* sum|x|), and bit-identical across a static layout, its compacted copy
and a row permutation. NaN, +-inf, zeros-only and empty groups follow
the kernel's rules: a NaN or both infinities give NaN, one infinity
gives it, an empty group or one of zeros gives +0.0.
"""

import math
from fractions import Fraction

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


# per dtype: significand bits, least normal exponent, largest exponent
_FORMATS = {torch.float64: (53, -1022, 1023), torch.float32: (24, -126, 127)}


def _round_once(total: Fraction, dtype: torch.dtype) -> float:
    """The exact ``total`` rounded once to nearest, ties to even, into
    ``dtype`` (subnormals included, +-inf past the largest finite)."""
    if total == 0:
        return 0.0
    bits, emin, emax = _FORMATS[dtype]
    a = abs(total)
    e = a.numerator.bit_length() - a.denominator.bit_length()
    if Fraction(2) ** e > a:
        e -= 1
    q = max(e, emin) - (bits - 1)  # the quantum at a's binade
    scaled = a / Fraction(2) ** q
    n, rem = divmod(scaled.numerator, scaled.denominator)
    if 2 * rem > scaled.denominator or (2 * rem == scaled.denominator
                                        and n % 2):
        n += 1
    sign = -1.0 if total < 0 else 1.0
    if Fraction(n) * Fraction(2) ** q >= Fraction(2) ** (emax + 1):
        return sign * math.inf
    return sign * math.ldexp(n, q)


def _exact_sums(x: np.ndarray, seg: np.ndarray, mask: np.ndarray, k: int,
                dtype: torch.dtype) -> list:
    """Each group's live values' exact sum, rounded once into ``dtype``."""
    out = []
    for g in range(k):
        vals = x[mask & (seg == g)]
        out.append(_round_once(sum(map(Fraction, vals.tolist()),
                                   Fraction(0)), dtype))
    return out


def _fsum(x, seg, k: int) -> torch.Tensor:
    t = torch.as_tensor
    return seg_agg.seg_fsum_plain(t(x), t(np.asarray(seg, dtype=np.int32)),
                                  torch.ones(len(x), dtype=torch.bool), k)


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


def test_values_far_below_the_largest_are_kept():
    """No value drops out, however far below the group's largest: the
    sum is exact until its one rounding."""
    got = _fsum(np.array([2.0 ** 100, 1.0, -2.0 ** 100, 1.0, 2.0 ** -100,
                          -1.0]), [0, 0, 0, 1, 1, 1], 2)
    assert got[0].item() == 1.0 and got[1].item() == 2.0 ** -100


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_equals_math_fsum(seed):
    """float64 groups whose exponents spread over 400 bits, with both
    signs and cancellation: each equals math.fsum of its live values,
    which is correctly rounded."""
    rng = np.random.default_rng(seed)
    n, k = 6000, 40
    seg = rng.integers(-1, k + 1, n).astype(np.int32)
    mask = rng.random(n) < 0.8
    x = rng.normal(size=n) * 2.0 ** rng.integers(-200, 200, n)
    big = rng.random(n) < 0.05  # cancelling pairs far above the rest
    x[big] = 2.0 ** 300
    x[np.flatnonzero(big) - 1] = -2.0 ** 300
    got = seg_agg.seg_fsum_plain(*map(torch.from_numpy, (x, seg, mask)), k)
    for g in range(k):
        want = math.fsum(x[mask & (seg == g)].tolist())
        assert got[g].item() == want, g


def test_subnormal_sums_and_ties_to_even():
    """Sums in the subnormal range are exact; a sum halfway between two
    doubles rounds to the even one."""
    tiny = 5e-324
    groups = [
        [1e-310, -9.99e-311, tiny],          # subnormal result
        [2.5e-308, -2.4e-308, 3 * tiny],     # subnormal after cancelling
        [2.0 ** -1022, -tiny],               # the largest subnormal
        [1.0, 2.0 ** -53],                   # tie: stays at 1.0 (even)
        [1.0 + 2.0 ** -52, 2.0 ** -53],      # tie: up to the even 1 + 2^-51
        [1.0, 2.0 ** -53, 2.0 ** -200],      # just past the tie: up
        [-1.0, -(2.0 ** -53), 2.0 ** -200],  # just short of it: stays
    ]
    x = np.array([v for g in groups for v in g])
    seg = [i for i, g in enumerate(groups) for _ in g]
    got = _fsum(x, seg, len(groups))
    for g, vals in enumerate(groups):
        assert got[g].item() == math.fsum(vals), g
    assert got[3].item() == 1.0 and got[4].item() == 1.0 + 2.0 ** -51
    assert got[5].item() == 1.0 + 2.0 ** -52 and got[6].item() == -1.0


def test_near_dbl_max_against_fraction():
    """Where math.fsum raises "intermediate overflow" the oracle is the
    exact Fraction sum rounded once; past DBL_MAX the sum is +-inf."""
    top = np.finfo(np.float64).max
    half_ulp = 2.0 ** 970  # DBL_MAX's ulp is 2^971
    groups = [[1e308, 1e308, -1e308], [top, top, -top], [top, half_ulp / 2],
              [top, half_ulp], [-top, -top], [top, top, -1e308]]
    with pytest.raises(OverflowError):
        math.fsum(groups[0])
    x = np.array([v for g in groups for v in g])
    seg = np.array([i for i, g in enumerate(groups) for _ in g],
                   dtype=np.int32)
    got = _fsum(x, seg, len(groups)).tolist()
    want = _exact_sums(x, seg, np.ones(len(x), dtype=bool), len(groups),
                       torch.float64)
    assert got == want
    assert got[0] == 1e308 and got[1] == top and got[2] == top
    assert got[3] == math.inf and got[4] == -math.inf  # tie past the top


@pytest.mark.parametrize("seed", [0, 1])
def test_float32_rounded_once_from_the_exact_sum(seed):
    """float32 data: each group is the exact sum rounded once to float32,
    never through float64 (the double rounding of [1, 2^-24, 2^-80]
    would give 1.0)."""
    rng = np.random.default_rng(seed)
    n, k = 4000, 30
    seg = rng.integers(-1, k + 1, n).astype(np.int32)
    mask = rng.random(n) < 0.8
    x = (rng.normal(size=n) * 2.0 ** rng.integers(-140, 120, n)).astype(
        np.float32)
    got = seg_agg.seg_fsum_plain(*map(torch.from_numpy, (x, seg, mask)), k)
    assert got.dtype == torch.float32
    want = _exact_sums(x, seg, mask, k, torch.float32)
    assert [float(v) for v in got] == [float(np.float32(w)) for w in want]
    once = _fsum(np.array([1.0, 2.0 ** -24, 2.0 ** -80], dtype=np.float32),
                 [0, 0, 0], 1).item()
    assert once == 1.0 + 2.0 ** -23
    assert float(np.float32(np.float64(1.0) + 2.0 ** -24 + 2.0 ** -80)) \
        == 1.0


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
