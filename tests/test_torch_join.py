"""The port's sorted-build join against the reference's, on the CPU.

Kernels (``spark_tpu_torch/physical/kernels.py`` against
``spark_tpu/physical/kernels.py``): searchsorted, the build index with
and without dense lo/cnt tables, per-probe match ranges, pair
expansion, range packing, the compaction permutation and the 64-bit
hashes, on the same numpy inputs.

``JoinExec`` (``physical/operators.py``): both engines start from the
same host arrays (``columnar/batch.py:from_host_arrays`` carries them
across) and run their blocking join for every join type over one input
case each: duplicate keys on both sides with NULL keys and dead rows,
string keys from two different dictionaries, two integer keys, the
hashed fallback (two int64 keys near +-2^40, whose packed range
overflows 2^62), a residual condition over '#2'-deduplicated names, an
empty build side, and a condition-only join (the nested loop).

Tolerance: none. Integers, permutations, hashes and every output
column's data, validity and the row mask are equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_tpu import types as RT
from spark_tpu.columnar.batch import Batch as RBatch
from spark_tpu.columnar.batch import BatchData as RBatchData
from spark_tpu.columnar.batch import ColumnData as RColumnData
from spark_tpu.expr import expressions as RE
from spark_tpu.physical import kernels as RK
from spark_tpu.physical import operators as RP
from spark_tpu_torch import types as PT
from spark_tpu_torch.columnar.batch import from_host_arrays
from spark_tpu_torch.expr import expressions as PE
from spark_tpu_torch.physical import kernels as PK
from spark_tpu_torch.physical import operators as PP


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _equal(got, want):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape
    assert np.array_equal(g.astype(np.int64), w.astype(np.int64))


# ---- kernels ----------------------------------------------------------------


def _build_probe(seed: int, n_build=700, n_probe=900, hi=60):
    rng = np.random.default_rng(seed)
    bkey = rng.integers(0, hi, n_build).astype(np.int64)
    bok = rng.random(n_build) < 0.85
    pkey = rng.integers(-3, hi + 5, n_probe).astype(np.int64)
    pok = rng.random(n_probe) < 0.9
    return bkey, bok, pkey, pok


@pytest.mark.parametrize("side", ["left", "right"])
def test_searchsorted(side):
    rng = np.random.default_rng(1)
    a = np.sort(rng.integers(-50, 50, 3000)).astype(np.int64)
    v = rng.integers(-60, 60, 5000).astype(np.int64)
    _equal(PK.searchsorted(torch.from_numpy(a), torch.from_numpy(v), side),
           RK.searchsorted(jnp.asarray(a), jnp.asarray(v), side))


def test_build_join_ranges():
    bkey, bok, pkey, pok = _build_probe(2)
    want = RK.build_join_ranges(*map(jnp.asarray, (bkey, bok, pkey, pok)))
    got = PK.build_join_ranges(*map(torch.from_numpy, (bkey, bok, pkey,
                                                       pok)))
    for g, w in zip(got, want):
        _equal(g, w)
    _equal(got.counts, want.counts)


@pytest.mark.parametrize("domain", [None, 64])
def test_make_join_index_and_ranges_from_index(domain):
    bkey, bok, pkey, pok = _build_probe(3)
    want = RK.make_join_index(jnp.asarray(bkey), jnp.asarray(bok), domain)
    got = PK.make_join_index(torch.from_numpy(bkey), torch.from_numpy(bok),
                             domain)
    assert (got[2] is None) == (domain is None)
    for g, w in zip(got, want):
        if w is not None:
            _equal(g, w)
    want_r = RK.ranges_from_index(*want, jnp.asarray(pkey), jnp.asarray(pok))
    got_r = PK.ranges_from_index(*got, torch.from_numpy(pkey),
                                 torch.from_numpy(pok))
    for g, w in zip(got_r, want_r):
        _equal(g, w)


@pytest.mark.parametrize("n_build", [700, 0])
def test_expand_join_pairs(n_build):
    """Pairs in the reference's order, at a capacity past the total; an
    empty build side expands to no pairs."""
    bkey, bok, pkey, pok = _build_probe(4)
    bkey, bok = bkey[:max(n_build, 1)], bok[:max(n_build, 1)] & (n_build > 0)
    want_r = RK.build_join_ranges(*map(jnp.asarray, (bkey, bok, pkey, pok)))
    got_r = PK.build_join_ranges(*map(torch.from_numpy, (bkey, bok, pkey,
                                                         pok)))
    total = int(np.asarray(want_r.counts).sum())
    assert (total > 0) == (n_build > 0)
    cap = RK.bucket(total)
    for g, w in zip(PK.expand_join_pairs(got_r, cap),
                    RK.expand_join_pairs(want_r, cap)):
        _equal(g, w)


def test_range_compress_keys():
    rng = np.random.default_rng(5)
    a = rng.integers(-20, 20, 500)
    b = rng.integers(100, 130, 500).astype(np.int32)
    va = rng.random(500) < 0.9
    want = RK.range_compress_keys(
        [(jnp.asarray(a), jnp.asarray(va)), (jnp.asarray(b), None)],
        [-20, 100], [41, 31])
    got = PK.range_compress_keys(
        [(torch.from_numpy(a), torch.from_numpy(va)),
         (torch.from_numpy(b), None)], [-20, 100], [41, 31])
    for g, w in zip(got, want):
        _equal(g, w)


def test_compaction_permutation():
    mask = np.random.default_rng(6).random(3000) < 0.3
    _equal(PK.compaction_permutation(torch.from_numpy(mask)),
           RK.compaction_permutation(jnp.asarray(mask)))


_HASH_INPUTS = np.concatenate([
    np.array([0, 1, -1, 2, -2, 1 << 62, -(1 << 62), (1 << 62) - 1,
              (1 << 63) - 1, -(1 << 63), 1 << 40, -(1 << 40)],
             dtype=np.int64),
    np.random.default_rng(7).integers(-(1 << 63), (1 << 63) - 1, 2000,
                                      dtype=np.int64)])


@pytest.mark.parametrize("dtype", [np.int64, np.int32])
def test_hash64_bits(dtype):
    x = _HASH_INPUTS.astype(dtype)
    want = np.asarray(RK.hash64(jnp.asarray(x))).view(np.int64)
    assert np.array_equal(PK.hash64(torch.from_numpy(x)).numpy(), want)


def test_hash_combine_bits():
    x, y = _HASH_INPUTS, _HASH_INPUTS[::-1].copy()
    want = RK.hash_combine(RK.hash64(jnp.asarray(x)), jnp.asarray(y))
    got = PK.hash_combine(PK.hash64(torch.from_numpy(x)),
                          torch.from_numpy(y))
    assert np.array_equal(got.numpy(), np.asarray(want).view(np.int64))
    # the join's shifted hash stays below the int64 sentinel
    rl, _ = RP._hash_keys([jnp.asarray(x), jnp.asarray(y)],
                          [jnp.asarray(x), jnp.asarray(y)])
    pl, _ = PP._hash_keys([torch.from_numpy(x), torch.from_numpy(y)],
                          [torch.from_numpy(x), torch.from_numpy(y)])
    assert np.array_equal(pl.numpy(), np.asarray(rl))
    assert int(pl.max()) <= (1 << 62) - 1 and int(pl.min()) >= 0


# ---- JoinExec ---------------------------------------------------------------

HOWS = ["inner", "left", "right", "full", "left_semi", "left_anti", "cross"]
CASES = ["dup_null_keys", "string_keys", "two_int_keys", "hashed",
         "residual", "empty_build", "condition_only"]

_LEFT_DICT = ("apple", "kiwi", "pear", "plum")
_RIGHT_DICT = ("fig", "kiwi", "pear", "apple", "zzz")
_WIDE = (1 << 40) + np.arange(-3, 4, dtype=np.int64)


def _side(seed: int, n: int, cap: int, dictionary, empty: bool = False):
    """Host arrays (padded to ``cap``) of one join side: k int64 with
    duplicates and NULLs, k2 int64, s dictionary string (nullable), w/w2
    wide int64 near +-2^40, v float64; some dead rows inside."""
    rng = np.random.default_rng(seed)
    fields, datas, valids = [], [], []

    def col(name, dt, values, validity=None):
        pad = np.zeros(cap, dtype=dt.np_dtype)
        pad[:n] = values
        fields.append((name, dt, validity is not None))
        datas.append(pad)
        if validity is None:
            valids.append(None)
        else:
            pv = np.zeros(cap, dtype=bool)
            pv[:n] = validity
            valids.append(pv)

    col("k", RT.INT64, rng.integers(0, 25, n), rng.random(n) < 0.9)
    col("k2", RT.INT64, rng.integers(0, 3, n))
    col("s", RT.STRING, rng.integers(0, len(dictionary), n),
        rng.random(n) < 0.92)
    col("w", RT.INT64, rng.choice(_WIDE, n) * rng.choice([-1, 1], n))
    col("w2", RT.INT64, rng.choice(_WIDE[:3], n) * rng.choice([-1, 1], n))
    col("v", RT.FLOAT64, np.round(rng.normal(size=n) * 10, 3))
    mask = np.zeros(cap, dtype=bool)
    mask[:n] = (rng.random(n) < 0.9) & (not empty)
    return fields, datas, valids, mask, dictionary


def _batches(side):
    """(reference batch, port batch) over the same host arrays."""
    fields, datas, valids, mask, dictionary = side
    rfields, pfields = [], []
    for name, dt, nullable in fields:
        d = dictionary if dt == RT.STRING else None
        rfields.append(RT.Field(name, dt, nullable, d))
        pfields.append(PT.Field(name, getattr(PT, type(dt).__name__)(),
                                nullable, d))
    ref = RBatch(RT.Schema(tuple(rfields)), RBatchData(
        tuple(RColumnData(jnp.asarray(d),
                          None if v is None else jnp.asarray(v))
              for d, v in zip(datas, valids)), jnp.asarray(mask)))
    port = from_host_arrays(PT.Schema(tuple(pfields)), datas, valids, mask,
                            "cpu")
    return ref, port


def _join_spec(E, how: str, case: str):
    """(left keys, right keys, condition) in module set ``E``."""
    keys = {"dup_null_keys": ("k",), "string_keys": ("s",),
            "two_int_keys": ("k", "k2"), "hashed": ("w", "w2"),
            "residual": ("k",), "empty_build": ("k",),
            "condition_only": ()}[case]
    cond = None
    if case == "residual":
        cond = E.Cmp("<", E.Col("v"), E.Col("v#2"))
    elif case == "condition_only":
        cond = E.And(E.Cmp("<", E.Col("k"), E.Col("k2#2")),
                     E.Cmp(">", E.Col("v"), E.Col("v#2")))
    if how == "cross":
        keys = ()
    ks = tuple(E.Col(k) for k in keys)
    return ks, ks, cond


def _assert_batches_equal(got, want):
    assert list(got.schema.names) == list(want.schema.names)
    for gf, wf in zip(got.schema.fields, want.schema.fields):
        assert type(gf.dtype).__name__ == type(wf.dtype).__name__
        assert gf.dictionary == wf.dictionary
    assert np.array_equal(got.data.row_mask.numpy(),
                          np.asarray(want.data.row_mask))
    for name, g, w in zip(want.schema.names, got.data.columns,
                          want.data.columns):
        wd = np.asarray(w.data)
        assert g.data.numpy().dtype == wd.dtype, name
        assert np.array_equal(g.data.numpy(), wd, equal_nan=True), name
        assert (g.validity is None) == (w.validity is None), name
        if w.validity is not None:
            assert np.array_equal(g.validity.numpy(),
                                  np.asarray(w.validity)), name


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("how", HOWS)
def test_join_exec_parity(how, case):
    lref, lport = _batches(_side(10, 300, 1024, _LEFT_DICT))
    rref, rport = _batches(_side(20, 200, 1024, _RIGHT_DICT,
                                 empty=case == "empty_build"))
    lk, rk, cond = _join_spec(RE, how, case)
    want = RP.JoinExec(RP.BatchScanExec(lref), RP.BatchScanExec(rref), how,
                       lk, rk, cond).execute_blocking([lref, rref])
    lk, rk, cond = _join_spec(PE, how, case)
    node = PP.JoinExec(PP.BatchScanExec(lport), PP.BatchScanExec(rport), how,
                       lk, rk, cond)
    got = node.execute([PP.Pipe.from_batch(lport),
                        PP.Pipe.from_batch(rport)]).to_batch()
    _assert_batches_equal(got, want)
    live = int(got.data.row_mask.sum())
    if case == "empty_build" and how in ("inner", "right", "left_semi",
                                         "cross"):
        assert live == 0
    else:
        assert live > 0
    if case == "hashed" and how != "cross":
        *_, hashed, _ = node._combined_keys(PP.Pipe.from_batch(lport),
                                            PP.Pipe.from_batch(rport))
        assert hashed
