"""The port's physical kernels (spark_tpu_torch/physical/kernels.py)
against the reference's (spark_tpu/physical/kernels.py), on the same
numpy inputs, plus the path each segmented reduction selects.

Tolerances: integer results (counts, int64 sums, ids, permutations)
exact; min/max exact; float64 sums rtol 1e-12 (scatter-add order may
differ between jax and torch).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_tpu.physical import kernels as RK
from spark_tpu_torch.ops import seg_agg
from spark_tpu_torch.physical import kernels as PK


def _case(k: int, sorted_seg: bool, seed: int = 3, n: int = 4000):
    rng = np.random.default_rng(seed + k + 10 * sorted_seg)
    seg = rng.integers(0, max(1, k - 3), n)  # last groups empty
    if sorted_seg:
        seg = np.sort(seg)
    mask = rng.random(n) < 0.75
    f32 = (rng.normal(size=n) * 50).astype(np.float32)
    f64 = rng.normal(size=n) * 1e3
    i64 = rng.integers(-10 ** 12, 10 ** 12, n)
    return seg, mask, f32, f64, i64


def _both(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a)
                                              for a in arrays]


CASES = [(k, s) for k in (8, 100) for s in (False, True)]


@pytest.mark.parametrize("k,sorted_seg", CASES)
def test_seg_count_parity(k, sorted_seg):
    seg, mask, *_ = _case(k, sorted_seg)
    (js, jm), (ts, tm) = _both(seg, mask)
    want = np.asarray(RK.seg_count(js, jm, k, sorted_seg))
    got = PK.seg_count(ts, tm, k, sorted_seg)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k,sorted_seg", CASES)
def test_seg_sum_parity(k, sorted_seg):
    seg, mask, _, f64, i64 = _case(k, sorted_seg)
    (js, jm, jf, ji), (ts, tm, tf, ti) = _both(seg, mask, f64, i64)
    np.testing.assert_array_equal(
        PK.seg_sum(ti, ts, tm, k, sorted_seg).numpy(),
        np.asarray(RK.seg_sum(ji, js, jm, k, sorted_seg)))
    np.testing.assert_allclose(
        PK.seg_sum(tf, ts, tm, k, sorted_seg).numpy(),
        np.asarray(RK.seg_sum(jf, js, jm, k, sorted_seg)), rtol=1e-12)


@pytest.mark.parametrize("k,sorted_seg", CASES)
@pytest.mark.parametrize("fn", ["seg_min", "seg_max"])
def test_seg_minmax_parity(k, sorted_seg, fn):
    seg, mask, f32, f64, i64 = _case(k, sorted_seg)
    f32[::997] = np.nan
    for data in (f32, f64, i64):
        (js, jm, jd), (ts, tm, td) = _both(seg, mask, data)
        want = np.asarray(getattr(RK, fn)(jd, js, jm, k, sorted_seg))
        got = getattr(PK, fn)(td, ts, tm, k, sorted_seg).numpy()
        assert got.dtype == want.dtype
        # empty groups carry the sentinel on both sides; compare only
        # groups with a live row
        live = np.bincount(seg[mask], minlength=k)[:k] > 0
        np.testing.assert_array_equal(got[live], want[live])


def test_select_path():
    assert PK.select_path(1, False, True) == "single"
    assert PK.select_path(64, False, True) == "masked"
    assert PK.select_path(65, False, True) == "kernel"
    assert PK.select_path(168, False, True) == "kernel"
    assert PK.select_path(1024, False, True) == "kernel"
    assert PK.select_path(1025, False, True) == "scatter"
    assert PK.select_path(168, True, True) == "sorted"
    assert PK.select_path(168, False, False) == "scatter"  # not float32
    # which reductions the kernels take: counts, int64 sums, f32 min/max
    assert PK.kernel_eligible("count", None)
    assert PK.kernel_eligible("sum", torch.int64)
    assert not PK.kernel_eligible("sum", torch.float32)
    assert not PK.kernel_eligible("sum", torch.float64)
    assert PK.kernel_eligible("min", torch.float32)
    assert not PK.kernel_eligible("max", torch.int64)
    i64 = PK.kernel_eligible("sum", torch.int64)
    assert PK.select_path(64, False, i64) == "masked"
    assert PK.select_path(65, False, i64) == "kernel"
    assert PK.select_path(1024, False, i64) == "kernel"
    assert PK.select_path(1025, False, i64) == "scatter"
    assert PK.select_path(168, True, i64) == "sorted"


def test_direct_path_reductions_route_through_kernel_wrappers(monkeypatch):
    """64 < K <= 1024 unsorted: counts, int64 sums and float32 min/max
    reach the seg_agg wrappers (which take their plain versions on CPU
    tensors and launch the CUDA kernels on CUDA tensors); float sums,
    float64 min/max, K <= 64 and sorted ids do not."""
    calls = []
    real_sum, real_mm = seg_agg.seg_sum, seg_agg.seg_minmax
    monkeypatch.setattr(seg_agg, "seg_sum", lambda *a, **kw: (
        calls.append("sum"), real_sum(*a, **kw))[1])
    monkeypatch.setattr(seg_agg, "seg_minmax", lambda *a, **kw: (
        calls.append("minmax"), real_mm(*a, **kw))[1])
    seg, mask, f32, f64, i64 = _case(100, False)
    ts, tm, t32, t64 = [torch.from_numpy(a) for a in (seg, mask, f32, f64)]
    PK.seg_count(ts, tm, 100)
    PK.seg_min(t32, ts, tm, 100)
    PK.seg_max(t32, ts, tm, 100)
    assert calls == ["sum", "minmax", "minmax"]
    PK.seg_min(t64, ts, tm, 100)
    PK.seg_count(ts, tm, 8)
    PK.seg_count(torch.sort(ts).values, tm, 100, sorted_seg=True)
    assert calls == ["sum", "minmax", "minmax"]
    ti = torch.from_numpy(i64)
    PK.seg_sum(ti, ts, tm, 100)
    assert calls == ["sum", "minmax", "minmax", "sum"]
    PK.seg_sum(ti, ts, tm, 8)
    PK.seg_sum(ti, torch.sort(ts).values, tm, 100, sorted_seg=True)
    PK.seg_sum(t32, ts, tm, 100)
    PK.seg_sum(t64, ts, tm, 100)
    assert calls == ["sum", "minmax", "minmax", "sum"]


@pytest.mark.parametrize("k", [65, 168, 1024])
def test_seg_sum_int64_kernel_route_parity(k, monkeypatch):
    """The direct path's int64 sum at 64 < K <= 1024 goes through the
    seg_agg wrapper and equals the reference's exact limb sum: values in
    +-1e15 with negatives, masked rows, empty groups."""
    rng = np.random.default_rng(17 + k)
    n = 3000
    seg = rng.integers(0, k - k // 4, n)  # the last quarter of groups empty
    mask = rng.random(n) < 0.7
    data = rng.integers(-10 ** 15, 10 ** 15, n)
    calls = []
    real_sum = seg_agg.seg_sum
    monkeypatch.setattr(seg_agg, "seg_sum", lambda *a, **kw: (
        calls.append(a[0].dtype), real_sum(*a, **kw))[1])
    (js, jm, jd), (ts, tm, td) = _both(seg, mask, data)
    got = PK.seg_sum(td, ts, tm, k)
    want = np.asarray(RK.seg_sum(jd, js, jm, k))
    assert calls == [torch.int64] and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[k - k // 4:] == 0).all() and (want < 0).any()


def test_pack_unpack_parity():
    rng = np.random.default_rng(5)
    n = 500
    cards = [3, 7, 4]
    codes = [rng.integers(0, c, n).astype(np.int32) for c in cards]
    valid = rng.random(n) < 0.8
    jv = [None, jnp.asarray(valid), None]
    tv = [None, torch.from_numpy(valid), None]
    jc, jt = RK.pack_codes([jnp.asarray(c) for c in codes], jv, cards)
    tc, tt = PK.pack_codes([torch.from_numpy(c) for c in codes], tv, cards)
    assert jt == tt
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    nullable = [False, True, False]
    for (jcode, jval), (tcode, tval) in zip(
            RK.unpack_code(jnp.arange(jt), cards, nullable),
            PK.unpack_code(torch.arange(tt), cards, nullable)):
        np.testing.assert_array_equal(tcode.numpy(), np.asarray(jcode))
        if jval is None:
            assert tval is None
        else:
            np.testing.assert_array_equal(tval.numpy(), np.asarray(jval))


def test_lexsort_group_ids_first_limit_parity():
    rng = np.random.default_rng(9)
    n = 1000
    a = rng.integers(0, 5, n)
    b = rng.normal(size=n).round(1)
    bv = rng.random(n) < 0.9
    mask = rng.random(n) < 0.8
    (ja, jb, jbv, jm), (ta, tb, tbv, tm) = _both(a, b, bv, mask)
    for asc, nf in [(True, True), (False, False), (True, False)]:
        jp = RK.lexsort_permutation(
            [RK.SortKey(ja, None, asc, nf), RK.SortKey(jb, jbv, not asc, nf)],
            jm)
        tp = PK.lexsort_permutation(
            [PK.SortKey(ta, None, asc, nf), PK.SortKey(tb, tbv, not asc, nf)],
            tm)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    perm = np.asarray(jp)
    js, jng = RK.group_ids_from_sorted(
        [(ja[perm], None), (jb[perm], jbv[perm])], jm[perm])
    tperm = torch.from_numpy(np.array(perm))
    ts, tng = PK.group_ids_from_sorted(
        [(ta[tperm], None), (tb[tperm], tbv[tperm])], tm[tperm])
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert int(tng) == int(jng)
    k = int(jng) + 3
    jd, jf = RK.seg_first(jb[perm], js, jm[perm], k, n, True)
    td, tf = PK.seg_first(tb[tperm], ts, tm[tperm], k, n, True)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(td.numpy()[tf.numpy()],
                                  np.asarray(jd)[np.asarray(jf)])
    np.testing.assert_array_equal(PK.limit_mask(tm, 17, 5).numpy(),
                                  np.asarray(RK.limit_mask(jm, 17, 5)))


@pytest.mark.parametrize("asc,nf", [(True, True), (False, True),
                                    (True, False)])
def test_orderable_int64_parity(asc, nf):
    f = np.array([1.5, -0.0, 0.0, -2.25, np.inf, -np.inf, 3e300, -7e-300])
    v = np.array([True] * 7 + [False])
    got = PK.orderable_int64(torch.from_numpy(f), torch.from_numpy(v),
                             asc, nf)
    want = RK.orderable_int64(jnp.asarray(f), jnp.asarray(v), asc, nf)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    i = np.array([5, -3, 0, 2 ** 40], dtype=np.int64)
    np.testing.assert_array_equal(
        PK.orderable_int64(torch.from_numpy(i), None, asc, nf).numpy(),
        np.asarray(RK.orderable_int64(jnp.asarray(i), None, asc, nf)))


@pytest.mark.parametrize("dtype", ["float32", "float64", "int64"])
@pytest.mark.parametrize("sorted_seg", [False, True])
def test_distinct_first_mask_parity(dtype, sorted_seg):
    """The DISTINCT first-row mask, exact: few distinct values per
    group, so runs repeat; floats carry NaN (two payloads), -0.0 beside
    +0.0 and inf; NULL rows (not ok) and dead rows at the tail."""
    rng = np.random.default_rng(17 + sorted_seg)
    n = 3000
    seg = rng.integers(0, 40, n).astype(np.int32)
    if sorted_seg:
        seg = np.sort(seg)
    vals = rng.integers(-6, 6, n)
    if dtype == "int64":
        data = vals * (1 << 40)
    else:
        data = vals.astype(dtype) / 4
        data[rng.random(n) < 0.05] = np.nan
        data[rng.random(n) < 0.03] = -np.nan  # the sign bit set
        data[vals == 0] = np.where(rng.random(int((vals == 0).sum())) < 0.5,
                                   -0.0, 0.0)
        data[vals == 5] = np.inf
    ok = rng.random(n) < 0.85          # NULL or masked rows
    ok[-300:] = False                  # dead padding rows
    (jd, js, jo), (td, ts, to) = _both(data, seg, ok)
    want = np.asarray(RK.distinct_first_mask(jd, js, jo))
    got = PK.distinct_first_mask(td, ts, to)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < ok.sum()


@pytest.mark.parametrize("k,sorted_seg", [(40, True), (5000, True),
                                          (40, False), (300, False)])
def test_seg_first_paths_match_reference(k, sorted_seg):
    """seg_first on each path (monotone ids: a suffix minimum; K <= 64:
    masked reductions; else a scatter-min) against the reference's, with
    masked-out rows inside segments and empty segments."""
    rng = np.random.default_rng(k)
    n = 3000
    seg = rng.integers(0, max(1, k - 3), n).astype(np.int32)
    if sorted_seg:
        seg.sort()
    data = rng.normal(size=n)
    mask = rng.random(n) < 0.6
    (js, jd, jm), (ts, td, tm) = _both(seg, data, mask)
    jv, jf = RK.seg_first(jd, js, jm, k, n, sorted_seg)
    tv, tf = PK.seg_first(td, ts, tm, k, n, sorted_seg)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tv.numpy()[tf.numpy()],
                                  np.asarray(jv)[np.asarray(jf)])
