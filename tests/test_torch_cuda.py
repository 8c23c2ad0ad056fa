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
query rows on the card equal to the CPU run's (the slices' queries, the
window phase's windows, grouping sets and set operations, and the twelve
other TPC-H queries), except a float window sum, held within 1e-10 of
the batch's prefix magnitude; the exact float sum (seg_fsum) equal to
its plain version bit for bit, across launches, a compacted layout and a
row permutation, in two kernels a call; the scalar phase's grouped stddev and
variance (A1) within rel 1e-10 of the CPU run and bit-identical across
two runs on the card; q1-wide and the flagship stage read from Parquet
equal to their in-memory runs on the card bit for bit, with the same
launches; the complex phase's queries, 2-D gathers, explode, a square
collect and outer-join padding equal to the CPU run, X1 and X2 with
their launches; the sampler's stream bit-identical on the card and the
CPU; captured stages (``physical/graphs.py``): q1-wide, q3 and A1-168
replayed bit for bit with the eager runs' launches, a replayed output
that survives the next replay, a dead leaf's graph dropped, and a sync
inside a capture raising; on a mesh of 1 and 4 ranks sharing the card,
q1-wide and a float sum with every logged kernel call equal to its plain
version, rows equal to the CPU run (float sums within 1e-12 of each
group's sum of |x|) and bit-identical across two mesh runs.
"""

import struct

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
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


# ---- the window slice -------------------------------------------------------


@pytest.mark.cuda
def test_window_rollup_union_on_card_match_cpu(cuda_device):
    """The window phase's queries (W-shaped windows, ROLLUP, CUBE and the
    set operations), the other twelve TPC-H queries and a window with a
    float sum, on the card against the CPU run. Rows equal, except the
    float window sum: a difference of one cumulative sum over the batch,
    whose order of additions differs on the card, held within 1e-10 of
    the batch's prefix magnitude."""
    from spark_tpu_torch.api.session import SparkSession
    from spark_tpu_torch.tpch import QUERIES, generate_tables, register_views
    from spark_tpu_torch.tpch.queries import WINDOW_QUERIES

    tables = generate_tables(0.02, seed=99)
    gpu = SparkSession(device="cuda")
    cpu = SparkSession(device="cpu")
    register_views(gpu, tables)
    register_views(cpu, tables)
    seg_agg.reset_launches()
    rest = [QUERIES[q] for q in (2, 4, 7, 8, 9, 11, 12, 15, 17, 19, 20, 21)]
    for q in list(WINDOW_QUERIES.values()) + rest:
        got = [tuple(r) for r in gpu.sql(q).collect()]
        assert got and got == [tuple(r) for r in cpu.sql(q).collect()], q
    # q2, q17 and q20 one count each (a residual join over a 1,024-row
    # probe side), q21 two (a 200-group direct aggregate)
    assert seg_agg.seg_sum.mode_launches == {"count": 5, "sum_f32": 0,
                                             "sum_i64": 0}
    assert seg_agg.seg_minmax.launches == 0
    # the float window: held within 1e-10 of the batch's prefix
    # magnitude (the sum over every row the cumulative sum adds)
    where = "from lineitem where l_orderkey < 3000"
    prefix = float(cpu.sql(f"select sum(l_extendedprice) {where}")
                   .collect()[0][0])
    q = ("select l_orderkey, l_linenumber, sum(l_extendedprice * 1.0) "
         "over (partition by l_orderkey order by l_linenumber rows between "
         f"2 preceding and current row) as s {where} "
         "order by l_orderkey, l_linenumber")
    got = gpu.sql(q).collect()
    want = cpu.sql(q).collect()
    assert len(got) == len(want) > 100
    for g, w in zip(got, want):
        assert tuple(g)[:2] == tuple(w)[:2]
        assert abs(g[2] - w[2]) <= 1e-10 * prefix, (g, w)


# ---- the scalar slice: the exact float sum ----------------------------------


def _fsum_bits(t):
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("k,sorted_ids,wide", [
    (1, False, False), (6, False, False), (168, False, False),
    (1024, False, False), (5000, False, False), (10_000, True, False),
    (168, False, True)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_seg_fsum_matches_plain_bit_for_bit(cuda_device, k, sorted_ids,
                                            wide, dtype):
    """seg_fsum against seg_fsum_plain on the same tensors, bit for bit:
    two launches, a compacted copy of the live rows and a permutation of
    the rows give the same bits; NaN, +-inf and empty groups included;
    ``wide`` spreads the values' exponents over the type's whole range. A
    call is two kernels: one reads the rows, one finishes the groups."""
    rng = np.random.default_rng(k)
    n = 300_000
    seg = rng.integers(-1, k + 1, n).astype(np.int32)
    if sorted_ids:
        seg.sort()
    mask = rng.random(n) < 0.7
    spread = (1000 if dtype == torch.float64 else 120) if wide else 0
    x = rng.normal(size=n) * (2.0 ** rng.integers(-spread, spread + 1, n)
                              if wide else 10.0 ** rng.integers(-8, 9, n))
    x[rng.random(n) < 1e-4] = np.nan
    x[rng.random(n) < 1e-4] = np.inf
    x[rng.random(n) < 1e-4] = -np.inf
    d, s, m = (torch.from_numpy(a).to(cuda_device)
               for a in (x.astype(np.float64), seg, mask))
    d = d.to(dtype)
    got = seg_agg.seg_fsum(d, s, m, k)
    again = seg_agg.seg_fsum(d, s, m, k)
    want = seg_agg.seg_fsum_plain(d, s, m, k)
    live = m
    compact = seg_agg.seg_fsum(d[live].contiguous(), s[live].contiguous(),
                               torch.ones(int(live.sum()), dtype=torch.bool,
                                          device=cuda_device), k)
    perm = torch.randperm(n, device=cuda_device)
    shuffled = seg_agg.seg_fsum(d[perm].contiguous(), s[perm].contiguous(),
                                m[perm].contiguous(), k)
    torch.cuda.synchronize()
    for other in (again, want, compact, shuffled):
        assert torch.equal(_fsum_bits(got), _fsum_bits(other))
    assert got.dtype == dtype and got.shape == (k,)
    import chip_smoke

    _, _, names = chip_smoke.profile_calls(
        lambda: seg_agg.seg_fsum(d, s, m, k), calls=4)
    assert sorted(names.values()) == [1.0, 1.0], names
    assert sum("fsum_digit_kernel" in key for key in names) == 1, names
    assert sum("fsum_finish_kernel" in key for key in names) == 1, names


@pytest.mark.cuda
def test_scalar_a1_on_card_matches_cpu(cuda_device):
    """A1's grouped stddev, variance and avg of sqrt at K = 6, 168 and the
    sorted path on the card against the CPU run: keys and counts equal,
    floats within rel 1e-10 (the card's seg_fsum and the CPU's index_add_
    round differently; the variance formula's cancellation is under 10
    here), the card's floats bit-identical across two runs, and five
    seg_fsum launches a query."""
    from spark_tpu_torch.api.session import SparkSession
    from spark_tpu_torch.tpch import generate_tables, register_views
    from spark_tpu_torch.tpch.queries import SCALAR_QUERIES

    tables = generate_tables(0.02, seed=99)
    gpu = SparkSession(device="cuda")
    cpu = SparkSession(device="cpu")
    register_views(gpu, tables)
    register_views(cpu, tables)
    for name in ("a1_6", "a1_168", "a1_sorted"):
        q = SCALAR_QUERIES[name]
        seg_agg.reset_launches()
        got = [tuple(r) for r in gpu.sql(q).collect()]
        assert seg_agg.seg_fsum.mode_launches == {"fsum_f64": 5,
                                                  "fsum_f32": 0}, name
        assert got == [tuple(r) for r in gpu.sql(q).collect()]
        want = [tuple(r) for r in cpu.sql(q).collect()]
        assert got and len(got) == len(want)
        for g, w in zip(got, want):
            assert g[:-3] == w[:-3]
            for a, b in zip(g[-3:], w[-3:]):
                assert abs(a - b) <= 1e-10 * abs(b), (name, g, w)


# ---- the file scan -------------------------------------------------------------


@pytest.mark.cuda
def test_parquet_q1_wide_on_card_matches_in_memory(cuda_device, tmp_path):
    """q1-wide over the lineitem table written to Parquet and read back
    on the card (the pushed filter and the pruned columns read by the
    scan) equals the in-memory run on the card bit for bit, and
    launches the same kernels: 7 counts, 2 int64 sums, 1 min, 1 max.
    The flagship stage over Parquet through the DataFrame API, with its
    grouped float sums in seg_fsum, equals its in-memory run bit for bit
    too."""
    from spark_tpu_torch.api import functions as F
    from spark_tpu_torch.api.session import SparkSession
    from spark_tpu_torch.tpch import Q1_WIDE, generate_tables

    def bits(rows):
        return [tuple(struct.pack("<d", v) if isinstance(v, float) else v
                      for v in r) for r in rows]

    lineitem = generate_tables(0.02, seed=99)["lineitem"]
    mem = SparkSession(device="cuda")
    files = SparkSession(device="cuda")
    mem.createDataFrame(lineitem).createOrReplaceTempView("lineitem")
    mem.table("lineitem").write.parquet(str(tmp_path / "lineitem"))
    files.read.parquet(str(tmp_path / "lineitem")) \
        .createOrReplaceTempView("lineitem")
    launches = []
    rows = []
    for spark in (mem, files):
        seg_agg.reset_launches()
        rows.append([tuple(r) for r in spark.sql(Q1_WIDE).collect()])
        launches.append((dict(seg_agg.seg_sum.mode_launches),
                         dict(seg_agg.seg_minmax.mode_launches)))
    assert rows[0] and rows[1] == rows[0]
    assert launches[1] == launches[0] == (
        {"count": 7, "sum_f32": 0, "sum_i64": 2}, {"min": 1, "max": 1})

    rng = np.random.default_rng(0)
    n = 4096
    flag = {"k": rng.integers(0, 50, n), "v": rng.normal(size=n) * 10,
            "tag": np.array(["red", "green", "blue", "gold"])[
                rng.integers(0, 4, n)]}
    pq.write_table(pa.table(flag), str(tmp_path / "flag.parquet"))
    stage = []
    for df in (mem.createDataFrame(pa.table(flag)),
               files.read.parquet(str(tmp_path / "flag.parquet"))):
        seg_agg.reset_launches()
        stage.append(bits(
            df.filter(F.col("k") > 10)
            .select("tag", (F.col("v") * 2.0).alias("v2"))
            .groupBy("tag")
            .agg(F.sum("v2").alias("s"), F.count("*").alias("n"),
                 F.avg("v2").alias("a"))
            .orderBy(F.desc("s")).collect()))
        assert seg_agg.seg_fsum.mode_launches["fsum_f64"] == 2
    assert len(stage[0]) == 4 and stage[1] == stage[0]


# ---- arrays, maps, explode, collect and sample ---------------------------------


def _complex_sessions(sf: float = 0.02):
    from spark_tpu_torch.api.session import SparkSession
    from spark_tpu_torch.tpch import generate_tables, register_views
    from spark_tpu_torch.tpch.queries import nested_table

    tables = generate_tables(sf, seed=99)
    out = []
    for dev in ("cuda", "cpu"):
        spark = SparkSession(device=dev)
        register_views(spark, tables)
        spark.createDataFrame(nested_table(tables["orders"],
                                           tables["lineitem"])) \
            .createOrReplaceTempView("nested")
        out.append(spark)
    return out


@pytest.mark.cuda
def test_complex_x1_x2_on_card_match_cpu(cuda_device):
    """X1 (explode then aggregate at K = 168) launches 4 counts, 1 min and
    1 max; X2 (three collects at K = 168) 7 counts; rows equal to the CPU
    run's."""
    from spark_tpu_torch.tpch.queries import COMPLEX_QUERIES

    gpu, cpu = _complex_sessions()
    want = {"x1_explode": ({"count": 4, "sum_f32": 0, "sum_i64": 0},
                           {"min": 1, "max": 1}),
            "x2_collect": ({"count": 7, "sum_f32": 0, "sum_i64": 0},
                           {"min": 0, "max": 0})}
    for name, launches in want.items():
        q = COMPLEX_QUERIES[name]
        seg_agg.reset_launches()
        got = [tuple(r) for r in gpu.sql(q).collect()]
        assert (dict(seg_agg.seg_sum.mode_launches),
                dict(seg_agg.seg_minmax.mode_launches)) == launches, name
        assert got and got == [tuple(r) for r in cpu.sql(q).collect()]


@pytest.mark.cuda
def test_complex_queries_on_card_match_cpu(cuda_device):
    """Every complex-phase query (X1-X6 and the sample SM1) on the card
    equals the CPU run row for row."""
    from spark_tpu_torch.tpch.queries import COMPLEX_QUERIES

    gpu, cpu = _complex_sessions()
    for name, q in COMPLEX_QUERIES.items():
        rows = [[tuple(r) for r in (q(s) if callable(q) else s.sql(q))
                 .collect()] for s in (gpu, cpu)]
        assert rows[0] and rows[0] == rows[1], name


@pytest.mark.cuda
def test_gather_explode_collect_on_card_match_cpu(cuda_device):
    """The 2-D row operators on the card: a gather (sort) of array
    columns, an explode, a collect_list as wide as its capacity and an
    outer join's padding equal the CPU run."""
    from spark_tpu_torch.api.session import SparkSession

    n = 2047
    keys = ["g0000"] * 1024 + [f"g{i:04d}" for i in range(1, 1024)]
    tbl = pa.table({"g": pa.array(keys),
                    "v": pa.array(np.arange(n), pa.int64()),
                    "xs": pa.array([[i, i * 2][: i % 3] for i in range(n)],
                                   pa.list_(pa.int64()))})
    queries = [
        "select v, xs from t order by v desc limit 50",
        "select v, x from t lateral view posexplode(xs) e as p, x "
        "order by v, p",
        "select g, size(l), element_at(l, -1) from (select g, "
        "collect_list(v) as l from t group by g) u order by g",
        "select a.v, b.xs from t a left join t b on a.v = b.v + 1000 "
        "order by a.v",
    ]
    out = []
    for dev in ("cuda", "cpu"):
        spark = SparkSession(device=dev)
        spark.createDataFrame(tbl).createOrReplaceTempView("t")
        out.append([[tuple(r) for r in spark.sql(q).collect()]
                    for q in queries])
    assert out[0] == out[1] and all(out[0])


@pytest.mark.cuda
def test_uniform_on_card_equals_cpu(cuda_device):
    """The sampler's stream is integer ops: the card's draws equal the
    CPU's bit for bit."""
    from spark_tpu_torch.physical.random import uniform

    for seed in (0, 7, 2 ** 40 + 5):
        for n in (1, 1024, 65_537, 6_000_000):
            got = uniform(seed, n, cuda_device).cpu()
            want = uniform(seed, n, "cpu")
            assert torch.equal(got.view(torch.int64),
                               want.view(torch.int64))


# ---- captured stages -------------------------------------------------------


def _graph_session(dev):
    from spark_tpu_torch.api.session import SparkSession
    from spark_tpu_torch.tpch import generate_tables, register_views

    spark = SparkSession(device=dev)
    register_views(spark, generate_tables(0.02, seed=99))
    return spark


def _row_bits(rows):
    return [tuple(struct.pack("<d", v) if isinstance(v, float) else v
                  for v in r) for r in rows]


def _wrapper_launches():
    return dict(seg_agg.seg_sum.mode_launches,
                **seg_agg.seg_minmax.mode_launches,
                **seg_agg.seg_fsum.mode_launches)


def _ran(before):
    """The kernel runs the device counted since ``before``."""
    after = seg_agg.device_runs()
    return {m: after[m] - before[m] for m in after}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["q1_wide", "q3", "a1_168"])
def test_replay_equals_eager_run_bit_for_bit(cuda_device, name):
    """The first (blocking) run, the capture run and three replays: the
    same rows bit for bit, every replay's stages replayed from graphs, and
    the hand-kernel runs the device counts in each replay equal to the
    launches of the capture run (its warm-up), which for q1-wide and A1
    equal the first run's. A capture itself runs, and counts, nothing."""
    from spark_tpu_torch.physical import planner
    from spark_tpu_torch.tpch import Q1_WIDE, QUERIES
    from spark_tpu_torch.tpch.queries import SCALAR_QUERIES

    q = {"q1_wide": Q1_WIDE, "q3": QUERIES[3],
         "a1_168": SCALAR_QUERIES["a1_168"]}[name]
    spark = _graph_session("cuda")
    seg_agg.reset_launches()
    runs = seg_agg.device_runs()
    first = _row_bits(tuple(r) for r in spark.sql(q).collect())
    eager = _wrapper_launches()
    assert _ran(runs) == eager
    assert planner.last_run.first_run
    seg_agg.reset_launches()
    runs = seg_agg.device_runs()
    assert _row_bits(tuple(r) for r in spark.sql(q).collect()) == first
    assert planner.last_run.captured == planner.last_run.stages == 1
    captured = _wrapper_launches()
    assert _ran(runs) == captured
    if name != "q3":
        assert captured == eager and any(captured.values())
    for _ in range(3):
        seg_agg.reset_launches()
        runs = seg_agg.device_runs()
        assert _row_bits(tuple(r) for r in spark.sql(q).collect()) == first
        run = planner.last_run
        assert run.replayed == run.stages == 1 and run.captured == 0
        assert _ran(runs) == captured
        assert not any(_wrapper_launches().values())


@pytest.mark.cuda
def test_replayed_output_survives_the_next_replay(cuda_device):
    from spark_tpu_torch.tpch import QUERIES

    spark = _graph_session("cuda")
    q = QUERIES[1]
    first = spark.sql(q)._execute()
    spark.sql(q).collect()  # capture
    a = spark.sql(q)._execute()
    b = spark.sql(q)._execute()
    for x, y, z in zip(a.data.columns, b.data.columns, first.data.columns):
        assert x.data.data_ptr() != y.data.data_ptr()
        assert torch.equal(x.data, y.data)
    assert a.result_columns() == first.result_columns()


@pytest.mark.cuda
def test_dead_leaf_evicts_its_graph(cuda_device):
    import gc

    from spark_tpu_torch.physical import graphs, planner

    spark = _graph_session("cuda")
    q = "select count(*) as n, sum(l_quantity) as s from lineitem " \
        "where l_discount > 0.05"
    want = [tuple(r) for r in spark.sql(q).collect()]
    spark.sql(q).collect()
    assert planner.last_run.captured == 1
    old = [refs for _, refs in graphs._STAGE_CACHE._data.values()]
    from spark_tpu_torch.tpch import generate_tables, register_views

    register_views(spark, generate_tables(0.02, seed=99))  # new leaves
    gc.collect()
    assert [tuple(r) for r in spark.sql(q).collect()] == want
    assert planner.last_run.first_run  # new leaves: no stats yet
    assert [tuple(r) for r in spark.sql(q).collect()] == want
    assert planner.last_run.captured == 1
    # the capture swept every entry whose leaves died, this query's too
    assert any(r() is None for refs in old for r in refs)
    assert all(r() is not None for _, refs in
               graphs._STAGE_CACHE._data.values() for r in refs)


@pytest.mark.cuda
def test_capture_keeps_the_tables_its_warm_up_copied(cuda_device,
                                                     monkeypatch):
    """A stage reads several host tables (dictionary predicates) whose
    copies pass ``device.TABLE_BYTES``: the warm-up's copies are not
    evicted before the capture reads them, and the replay equals the
    blocking run."""
    from spark_tpu_torch import device as PD
    from spark_tpu_torch.physical import planner

    spark = _graph_session("cuda")
    q = ("select p_brand, count(*) as n from part "
         "where p_type like '%BRASS' and p_container in ('SM BOX', 'LG CASE')"
         " and p_brand <> 'Brand#45' and p_mfgr like '%3' "
         "group by p_brand order by p_brand")
    monkeypatch.setattr(PD, "TABLE_BYTES", 1)
    with PD._TABLES_LOCK:
        PD._TABLES.clear()
    want = [tuple(r) for r in spark.sql(q).collect()]
    assert want
    assert [tuple(r) for r in spark.sql(q).collect()] == want
    assert planner.last_run.captured == planner.last_run.stages >= 1
    assert [tuple(r) for r in spark.sql(q).collect()] == want
    assert planner.last_run.replayed == planner.last_run.stages


@pytest.mark.cuda
def test_a_stage_that_syncs_in_its_capture_raises(cuda_device):
    """No fallback: a traced stage that reads a value on the host raises
    in its capture instead of running eagerly."""
    from spark_tpu_torch.physical import operators as P

    spark = _graph_session("cuda")
    q = "select l_returnflag, count(*) as n from lineitem " \
        "group by l_returnflag order by l_returnflag"
    spark.sql(q).collect()
    real_sort = P.SortExec.execute

    def syncing(self, child_pipes):
        int(child_pipes[0].mask.sum())  # a host sync inside the stage
        return real_sort(self, child_pipes)

    P.SortExec.execute = syncing
    try:
        with pytest.raises(RuntimeError):
            spark.sql(q).collect()
    finally:
        P.SortExec.execute = real_sort
    torch.cuda.synchronize()


# ---- the mesh: ranks sharing the card ----------------------------------------------


def _mesh_sessions(ranks: int):
    from spark_tpu_torch.api.session import SparkSession
    from spark_tpu_torch.tpch import generate_tables, register_views

    tables = generate_tables(0.02, seed=99)
    mesh = SparkSession(device="cuda", conf={"spark_tpu.mesh.devices": ranks},
                        mesh_devices=["cuda:0"] * ranks)
    cpu = SparkSession(device="cpu")
    register_views(mesh, tables)
    register_views(cpu, tables)
    return mesh, cpu


def _hold_logged(calls):
    """Each logged wrapper call against its plain version on the same
    tensors: integers equal, min/max equal with NaN in the same groups,
    seg_fsum bit for bit."""
    assert calls
    for name, args, got in calls:
        want = getattr(seg_agg, f"{name}_plain")(**args)
        if name == "seg_fsum":
            assert torch.equal(_bits(got), _bits(want)), name
        elif not got.is_floating_point():
            assert torch.equal(got, want), name
        else:
            nan = torch.isnan(got)
            assert torch.equal(nan, torch.isnan(want))
            assert torch.equal(got[~nan], want[~nan]), name


@pytest.mark.cuda
@pytest.mark.parametrize("ranks", [1, 4])
def test_mesh_on_card_kernels_match_plain_and_cpu(cuda_device, ranks):
    """q1-wide (K = 168 direct groups: PSumAgg's counts take seg_sum, its
    min/max seg_minmax) and a float sum on the sorted path (seg_fsum in
    the partial and the final aggregate) on a mesh of ranks sharing
    cuda:0: every logged kernel call equal to its plain version, rows
    equal to the CPU's single-device run (the float sums within 1e-12 of
    each group's sum of |x|: the card rounds each rank's partial once,
    the CPU adds in row order), and bit-identical across two mesh
    runs."""
    from spark_tpu_torch.tpch import Q1_WIDE

    mesh, cpu = _mesh_sessions(ranks)
    fsum = ("select l_suppkey, sum(l_extendedprice * 1.0 * "
            "(l_discount - 0.05)) as s, sum(abs(l_extendedprice * 1.0 * "
            "(l_discount - 0.05))) as m from lineitem group by l_suppkey "
            "order by l_suppkey")
    for q in (Q1_WIDE, fsum):
        seg_agg.reset_launches()
        seg_agg.call_log = []
        try:
            got = [tuple(r) for r in mesh.sql(q).collect()]
            calls = seg_agg.call_log
        finally:
            seg_agg.call_log = None
        _hold_logged(calls)
        again = [tuple(r) for r in mesh.sql(q).collect()]
        assert [tuple(struct.pack("<d", v) if isinstance(v, float) else v
                      for v in r) for r in got] == \
            [tuple(struct.pack("<d", v) if isinstance(v, float) else v
                   for v in r) for r in again]
        want = [tuple(r) for r in cpu.sql(q).collect()]
        assert got and len(got) == len(want)
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                if isinstance(a, float):  # f sums: within 1e-12 of sum |x|
                    bound = abs(w[-1]) if q is fsum else abs(b)
                    assert abs(a - b) <= 1e-12 * max(1.0, bound), (g, w)
                else:
                    assert a == b, (g, w)
