"""The port's CUDA kernels, its join path and its SQL slices on the card
(marker ``cuda``).

They skip where ``torch.cuda.is_available()`` is false: a CUDA kernel has
no CPU mode. This file imports neither jax nor the reference package, so
it also runs on a GPU machine without them (``--noconftest`` skips the
suite's jax-based conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: counts and int64 sums exact; min/max exact with NaN in the
same groups (-0.0 and +0.0 compare equal against the plain version,
whose answer for a group of both depends on its scatter order); every
mode bit-identical between two launches, signs of zeros included;
float32 sums within rtol 1e-4 / atol 1e-2 of a float64 sum (the plain
version's float32 atomics drift past that on a skewed input); the join
kernels and ``JoinExec`` of every join type equal on the card and on
the CPU (integers, permutations, hashes, and every output column's
data, validity and the row mask);
query rows on the card equal to the CPU run's.
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
    makes the inputs misaligned for the kernels' scalar path), the
    float32 sum against a float64 sum, and two launches bit-identical."""
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
                # held against a float64 sum: the plain version adds in
                # float32 through atomics in no fixed order, and on the
                # skewed input its own drift passes rtol 1e-4
                ok = mm & (ss >= 0) & (ss < k)
                truth = torch.zeros(k, dtype=torch.float64, device=dev)
                truth.index_add_(0, ss[ok].long(), ff[ok].double())
                torch.testing.assert_close(a, truth.float(), rtol=1e-4,
                                           atol=1e-2)
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
@pytest.mark.parametrize("k,n,runs", [
    (1024, 12_288, "pairs"),    # a join's probe ids after pair expansion
    (65, 400_013, "long"),      # runs of thousands of one id
    (1024, 300_007, "one"),     # every row one id
])
def test_sorted_ids_on_card(cuda_device, k, n, runs):
    """Ids in ascending order, in runs that cross lanes and blocks (the
    kernels' run-combining path), with a masked tail of out-of-range
    padding ids as ``expand_join_pairs`` leaves: every mode."""
    rng = np.random.default_rng(11 + k)
    data, _, mask = _inputs(k, n)
    live = n - n // 7
    if runs == "pairs":
        lengths = rng.geometric(0.08, size=k)
    elif runs == "long":
        lengths = rng.integers(1, 12_000, size=k)
    else:
        lengths = np.zeros(k, dtype=np.int64)
        lengths[k // 3] = live
    ids = np.repeat(np.arange(k, dtype=np.int32), lengths)[:live]
    seg = np.full(n, k, dtype=np.int32)
    seg[:len(ids)] = ids
    mask[len(ids):] = False
    i64 = rng.integers(-10 ** 15, 10 ** 15, n)
    _check_all_modes(k, data, seg, mask, i64, cuda_device)
    assert (np.diff(seg) >= 0).all() and len(np.unique(ids)) < n // 4


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


# ---- the join path -----------------------------------------------------------


def _both_devices(dev, *arrays):
    return ([torch.from_numpy(a).to(dev) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


def _same(got, want):
    assert torch.equal(got.cpu(), want), (got, want)


@pytest.mark.cuda
def test_join_kernels_on_card_match_cpu(cuda_device):
    from spark_tpu_torch.physical import kernels as PK

    rng = np.random.default_rng(3)
    bkey = rng.integers(0, 5000, 200_000).astype(np.int64)
    bok = rng.random(200_000) < 0.9
    pkey = rng.integers(-10, 5010, 300_000).astype(np.int64)
    pok = rng.random(300_000) < 0.9
    (gb, gbo, gp, gpo), (cb, cbo, cp, cpo) = _both_devices(
        cuda_device, bkey, bok, pkey, pok)
    for side in ("left", "right"):
        a = np.sort(bkey)
        ga, ca = torch.from_numpy(a).to(cuda_device), torch.from_numpy(a)
        _same(PK.searchsorted(ga, gp, side), PK.searchsorted(ca, cp, side))
    for domain in (None, 5000):
        gi = PK.make_join_index(gb, gbo, domain)
        ci = PK.make_join_index(cb, cbo, domain)
        for g, c in zip(gi, ci):
            if c is not None:
                _same(g, c)
        gr = PK.ranges_from_index(*gi, gp, gpo)
        cr = PK.ranges_from_index(*ci, cp, cpo)
        for g, c in zip(gr, cr):
            _same(g, c)
    gr = PK.build_join_ranges(gb, gbo, gp, gpo)
    cr = PK.build_join_ranges(cb, cbo, cp, cpo)
    cap = PK.bucket(int(cr.counts.sum()))
    for g, c in zip(PK.expand_join_pairs(gr, cap),
                    PK.expand_join_pairs(cr, cap)):
        _same(g, c)
    _same(PK.compaction_permutation(gbo), PK.compaction_permutation(cbo))
    x = np.concatenate([np.array([0, -1, 1 << 62, -(1 << 62), (1 << 63) - 1,
                                  -(1 << 63)], dtype=np.int64), pkey])
    (gx,), (cx,) = _both_devices(cuda_device, x)
    _same(PK.hash64(gx), PK.hash64(cx))
    _same(PK.hash_combine(PK.hash64(gx), gx.flip(0)),
          PK.hash_combine(PK.hash64(cx), cx.flip(0)))


def _join_side(seed: int, n: int, cap: int, dev):
    """One join side at ``cap`` rows on ``dev``: k int64 with duplicates
    and NULLs, k2 int64, w/w2 int64 near +-2^40, s dictionary string,
    v float64; some dead rows."""
    from spark_tpu_torch import types as PT
    from spark_tpu_torch.columnar.batch import from_host_arrays

    rng = np.random.default_rng(seed)
    wide = (1 << 40) + np.arange(-3, 4, dtype=np.int64)
    cols = [
        ("k", PT.INT64, rng.integers(0, 25, n), rng.random(n) < 0.9),
        ("k2", PT.INT64, rng.integers(0, 3, n), None),
        ("w", PT.INT64, rng.choice(wide, n) * rng.choice([-1, 1], n), None),
        # the right side (odd seed) holds no negative w2: some left rows
        # stay unmatched under the hashed keys
        ("w2", PT.INT64, rng.choice(wide, n)
         * (rng.choice([-1, 1], n) if seed % 2 == 0 else 1), None),
        ("s", PT.STRING, rng.integers(0, 3, n), rng.random(n) < 0.9),
        ("v", PT.FLOAT64, np.round(rng.normal(size=n) * 10, 3), None),
    ]
    fields, datas, valids = [], [], []
    for name, dt, values, validity in cols:
        pad = np.zeros(cap, dtype=dt.np_dtype)
        pad[:n] = values
        datas.append(pad)
        d = ("apple", "kiwi", "pear", "plum")[seed % 2:] \
            if name == "s" else None
        fields.append(PT.Field(name, dt, validity is not None, d))
        if validity is None:
            valids.append(None)
        else:
            pv = np.zeros(cap, dtype=bool)
            pv[:n] = validity
            valids.append(pv)
    mask = np.zeros(cap, dtype=bool)
    mask[:n] = rng.random(n) < 0.9
    return from_host_arrays(PT.Schema(tuple(fields)), datas, valids, mask,
                            dev)


@pytest.mark.cuda
@pytest.mark.parametrize("how", ["inner", "left", "right", "full",
                                 "left_semi", "left_anti", "cross"])
def test_join_exec_on_card_matches_cpu(cuda_device, how):
    """Integer keys with duplicates and NULLs, string keys, the hashed
    fallback, a residual condition and a condition-only join; the left
    side's capacity is 1024, so outer, semi and anti joins with a
    residual count matches with the seg_sum kernel on the card."""
    from spark_tpu_torch.expr import expressions as PE
    from spark_tpu_torch.physical import operators as PP

    cases = [(("k",), None), (("s",), None), (("w", "w2"), None),
             (("k",), PE.Cmp("<", PE.Col("v"), PE.Col("v#2"))),
             ((), PE.Cmp("<", PE.Col("k"), PE.Col("k2#2")))]
    for keys, cond in cases:
        if how == "cross":
            keys = ()
        ks = tuple(PE.Col(k) for k in keys)
        outs = []
        for dev in (cuda_device, "cpu"):
            left = _join_side(10, 700, 1024, dev)
            right = _join_side(21, 1500, 2048, dev)
            node = PP.JoinExec(PP.BatchScanExec(left),
                               PP.BatchScanExec(right), how, ks, ks, cond)
            outs.append(node.execute([PP.Pipe.from_batch(left),
                                      PP.Pipe.from_batch(right)]).to_batch())
        got, want = outs
        assert got.schema.names == want.schema.names
        _same(got.data.row_mask, want.data.row_mask)
        assert bool(want.data.row_mask.any()), (keys, cond)
        for g, w in zip(got.data.columns, want.data.columns):
            _same(g.data, w.data)
            assert (g.validity is None) == (w.validity is None)
            if w.validity is not None:
                _same(g.validity, w.validity)


@pytest.mark.cuda
def test_join_queries_on_card_match_cpu(cuda_device):
    from spark_tpu_torch.api.session import SparkSession
    from spark_tpu_torch.tpch import QUERIES, generate_tables, register_views

    tables = generate_tables(0.02, seed=99)
    gpu = SparkSession(device="cuda")
    cpu = SparkSession(device="cpu")
    register_views(gpu, tables)
    register_views(cpu, tables)
    seg_agg.reset_launches()
    for q in (QUERIES[3], QUERIES[5]):
        got = [tuple(r) for r in gpu.sql(q).collect()]
        assert got and got == [tuple(r) for r in cpu.sql(q).collect()]
    assert seg_agg.seg_sum.launches == 0
    assert seg_agg.seg_minmax.launches == 0
