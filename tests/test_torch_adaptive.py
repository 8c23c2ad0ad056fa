"""The port's adaptive re-execution against the reference's, on the CPU.

The caches (``spark_tpu_torch/physical/operators.py``): a dead leaf
tensor evicts its entry, the LRU bound holds, the join-index cache keeps
to its byte bound, and ``stats_recording_disabled`` records nothing; the
captured-stage cache (``physical/graphs.py``) reads its entry cap from
the settings and keeps to its byte cap; ``device_table`` evicts no table
the active ``collecting_tables`` block holds.

``JoinExec``: both engines start from the same host arrays
(``columnar/batch.py:from_host_arrays`` carries them across). The stats
the port records on its blocking run (key packing, unique build, unique
probe, bucketed capacity) equal the reference's, for inner, left, left
semi and left anti joins, with and without a residual condition, with
packed keys (an int64 and a string key over two dictionaries) and with
hashed keys (two int64 keys whose packed range passes 2^62). Each traced
strategy (build, swap, expand, member) gives the reference's
``JoinExec.trace`` output bit for bit (data, validity, row mask) and the
blocking path's rows as a multiset, with and without the cached build
index.

The traced sorted aggregate (an empty input included: no row, where the
reference's blocking path emits one empty group, ROADMAP C), the traced
explode and a replayed compaction, through SQL on the port's and the
reference's sessions: the port's second (traced) run equals its first
(blocking) run and the reference's second run. The host-traffic guard
(``physical/graphs.py``) raises on each call it names.

Tolerance: none; every value is an integer, a string or a float32 or
float64 value both engines compute the same way.
"""

import gc

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_tpu import types as RT
from spark_tpu.expr import expressions as RE
from spark_tpu.physical import operators as RP
from spark_tpu_torch import conf as PC
from spark_tpu_torch import device as PD
from spark_tpu_torch.api.session import SparkSession as PortSession
from spark_tpu_torch.columnar.batch import Batch
from spark_tpu_torch.expr import expressions as PE
from spark_tpu_torch.physical import graphs, planner
from spark_tpu_torch.physical import kernels as PK
from spark_tpu_torch.physical import operators as PP
from test_torch_join import _assert_batches_equal, _batches
from test_torch_threads import one_torch_thread  # noqa: F401

# ---- caches -----------------------------------------------------------------


def _key(tag, pins):
    return ((tag, tuple(id(t) for t in pins)), pins)


def test_dead_leaf_evicts_its_entry():
    cache = PP._AdaptiveStatsCache()
    a, b = torch.arange(4), torch.arange(5)
    ka, kb = _key("a", (a,)), _key("b", (a, b))
    cache.put(ka, 1)
    cache.put(kb, 2)
    assert cache.get(ka) == 1 and cache.get(kb) == 2
    kb_key = kb[0]
    del b, kb
    gc.collect()
    assert cache.get((kb_key, ())) is None
    assert len(cache) == 1 and cache.get(ka) == 1


def test_stats_cache_lru_bound():
    cache = PP._AdaptiveStatsCache(maxsize=3)
    pins = [torch.arange(i + 1) for i in range(5)]
    keys = [_key(i, (p,)) for i, p in enumerate(pins)]
    for i, k in enumerate(keys):
        cache.put(k, i)
    assert len(cache) == 3
    assert [cache.get(k) for k in keys] == [None, None, 2, 3, 4]


def test_join_index_cache_keeps_its_byte_bound():
    one = PP._aux_batch((("perm", torch.arange(1000, dtype=torch.int32)),
                         ("skey", torch.arange(1000))))
    nbytes = PP._JoinIndexCache.nbytes(("fwd", one, None))
    assert nbytes == 1000 * (4 + 8 + 1)
    cache = PP._JoinIndexCache(max_bytes=2 * nbytes + 10)
    pins = [torch.arange(3) for _ in range(5)]
    for i, p in enumerate(pins):
        cache.put(_key(i, (p,)), ("fwd", one, None))
        assert cache.total_bytes() <= cache.max_bytes
    assert len(cache) == 2
    assert cache.get(_key(4, (pins[4],))) is not None
    assert cache.get(_key(0, (pins[0],))) is None
    # one entry past the bound is kept: an index is never refused
    small = PP._JoinIndexCache(max_bytes=10)
    small.put(_key(0, (pins[0],)), ("fwd", one, None))
    assert len(small) == 1


def test_stats_recording_disabled_records_nothing():
    cache = PP._AdaptiveStatsCache()
    t = torch.arange(3)
    with PP.stats_recording_disabled():
        assert not PP.stats_recording()
        cache.put(_key("x", (t,)), 1)
    assert PP.stats_recording() and len(cache) == 0
    # a plan run under it records no statistic and compacts no result
    port = PortSession(device="cpu")
    port.createDataFrame(pa.table({"k": [3, 1, 2, 1] * 300})) \
        .createOrReplaceTempView("t")
    q = "select k, count(*) as n from t group by k order by k"
    sizes = [len(c) for c in (PP._AGG_STATS, planner._OUTPUT_STATS)]
    with PP.stats_recording_disabled():
        rows = [tuple(r) for r in port.sql(q).collect()]
        rows2 = [tuple(r) for r in port.sql(q).collect()]
    assert rows == rows2 == [(1, 600), (2, 300), (3, 300)]
    assert [len(c) for c in (PP._AGG_STATS, planner._OUTPUT_STATS)] == sizes
    assert planner.last_run.first_run and planner.last_run.untraceable


def test_stage_cache_reads_its_cap_from_the_settings():
    from types import SimpleNamespace

    conf = PC.RuntimeConf()
    cache = graphs._StageCache()
    pins = [torch.arange(i + 1) for i in range(4)]
    keys = [_key(i, (p,)) for i, p in enumerate(pins)]
    entry = SimpleNamespace(nbytes=100)
    cache.put(keys[0], entry, conf)
    assert cache._maxsize == 512
    assert cache.max_bytes == graphs.STAGE_CACHE_BYTES == 4 << 30
    conf.set("spark.tpu.jit.stageCacheEntries", 2)
    for k in keys:
        cache.put(k, entry, conf)
    assert len(cache) == 2
    assert [cache.get(k) is entry for k in keys] == [False, False, True,
                                                     True]
    conf.unset("spark.tpu.jit.stageCacheEntries")
    cache = graphs._StageCache(max_bytes=250)
    for k in keys:
        cache.put(k, entry, conf)
    assert len(cache) == 2 and cache.total_bytes() == 200
    # a graph is kept whether or not stats are recorded
    with PP.stats_recording_disabled():
        cache.put(_key("x", (pins[0],)), SimpleNamespace(nbytes=0), conf)
    assert _key("x", (pins[0],)) in cache


def test_device_table_keeps_the_collected_tables(monkeypatch):
    """A stage's warm-up and its capture read the same tables: while a
    block collects them none is evicted, past TABLE_BYTES too."""
    monkeypatch.setattr(PD, "TABLE_BYTES", 16)
    arrays = [np.arange(10 * i, 10 * i + 4) + 777 for i in range(3)]
    got = []
    with PD.collecting_tables(got):
        tables = [PD.device_table(a, "cpu") for a in arrays]
        assert all(PD.device_table(a, "cpu") is t
                   for a, t in zip(arrays, tables))
    assert len(got) == 6
    PD.device_table(np.arange(4) + 999, "cpu")  # evicts all but itself
    assert PD.device_table(arrays[0], "cpu") is not tables[0]


def test_device_table_copies_each_table_once():
    a = np.array([3, 1, 2], dtype=np.int64)
    t1 = PD.device_table(a, "cpu")
    t2 = PD.device_table(a.copy(), torch.device("cpu"))
    assert t1 is t2 and t1.tolist() == [3, 1, 2]
    a[0] = 9  # the copy does not alias the host array
    assert t1.tolist() == [3, 1, 2]
    assert PD.device_table(a, "cpu") is not t1
    got = []
    with PD.collecting_tables(got):
        PD.device_table(a, "cpu")
    assert len(got) == 1


# ---- JoinExec stats and traced strategies ----------------------------------

_LEFT_DICT = ("apple", "kiwi", "pear", "plum")
_RIGHT_DICT = ("fig", "kiwi", "pear", "apple", "zzz")
#: each left dictionary code's string as a right dictionary code (plum:
#: none, so those rows never match)
_TO_RIGHT = {0: 3, 1: 1, 2: 2, 3: 0}
CAP = 1024


def _side(seed: int, n: int, unique: bool, dictionary, remap=None):
    """One join side in test_torch_join's host-array form: k int64 (a
    permutation when ``unique``, else with duplicates; some NULL), s a
    string of k % 4, w/w2 int64 of k spread past a 2^62 packed range, v
    float64; dead rows inside."""
    rng = np.random.default_rng(seed)
    k = rng.permutation(n) if unique else rng.integers(0, n, n)
    codes = k % 4
    if remap is not None:
        codes = np.array([remap[c] for c in codes])
    fields, datas, valids = [], [], []

    def col(name, dt, values, validity=None):
        pad = np.zeros(CAP, dtype=dt.np_dtype)
        pad[:n] = values
        fields.append((name, dt, validity is not None))
        datas.append(pad)
        pv = None
        if validity is not None:
            pv = np.zeros(CAP, dtype=bool)
            pv[:n] = validity
        valids.append(pv)

    col("k", RT.INT64, k, rng.random(n) < 0.95)
    col("s", RT.STRING, codes)
    col("w", RT.INT64, k.astype(np.int64) << 21)
    col("w2", RT.INT64, (k.astype(np.int64) % 7) << 35)
    col("v", RT.FLOAT64, np.round(rng.normal(size=n) * 10, 3))
    mask = np.zeros(CAP, dtype=bool)
    mask[:n] = rng.random(n) < 0.9
    return fields, datas, valids, mask, dictionary


def _inputs(unique_side: str):
    """(left ref, left port, right ref, right port) batches: 300 left
    rows, 250 right rows, the named side's keys unique."""
    left = _side(11, 300, unique_side == "left", _LEFT_DICT)
    right = _side(12, 250, unique_side == "right", _RIGHT_DICT, _TO_RIGHT)
    return _batches(left) + _batches(right)


def _spec(E, keys: str, residual: bool):
    names = ("k", "s") if keys == "packed" else ("w", "w2")
    ks = tuple(E.Col(n) for n in names)
    cond = E.Cmp("<", E.Col("v"), E.Col("v#2")) if residual else None
    return ks, ks, cond


def _nodes(how, keys, residual, lref, lport, rref, rport):
    lk, rk, cond = _spec(RE, keys, residual)
    ref = RP.JoinExec(RP.BatchScanExec(lref), RP.BatchScanExec(rref), how,
                      lk, rk, cond)
    lk, rk, cond = _spec(PE, keys, residual)
    port = PP.JoinExec(PP.BatchScanExec(lport), PP.BatchScanExec(rport),
                       how, lk, rk, cond)
    return ref, port


def _pipes(*batches):
    return [PP.Pipe.from_batch(b) for b in batches]


def _live_rows(batch: Batch) -> list:
    names, cols = batch.result_columns()
    return sorted(zip(*cols), key=repr)


HOWS = ["inner", "left", "left_semi", "left_anti"]


@pytest.mark.parametrize("keys", ["packed", "hashed"])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("how", HOWS)
def test_join_stats_equal_the_reference(how, residual, keys):
    for unique_side in ("left", "right"):
        lref, lport, rref, rport = _inputs(unique_side)
        ref, port = _nodes(how, keys, residual, lref, lport, rref, rport)
        ref.execute_blocking([lref, rref])
        port.execute_blocking(_pipes(lport, rport))
        want = RP._JOIN_STATS.get(ref.stats_key())
        got = PP._JOIN_STATS.get(port.stats_key())
        assert want is not None and got == want
        assert (got[0] == "hash") == (keys == "hashed")


def _strategy_cases():
    out = []
    for how in HOWS:
        for residual in (False, True):
            for keys in ("packed", "hashed"):
                strats = ["build", "expand"]
                if how == "inner":
                    strats.append("swap")
                if how in ("left_semi", "left_anti") and not residual \
                        and keys == "packed":
                    strats.append("member")
                out += [(how, s, residual, keys) for s in strats]
    return out


def _bind(node, stats, index):
    node.adaptive = stats
    node.index_scan = node.table_scan = node.index_orient = None
    if index is not None:
        orient, ib, tb = index
        node.index_scan = type(node.left)(ib, aux=True)
        node.table_scan = (type(node.left)(tb, aux=True)
                           if tb is not None else None)
        node.index_orient = orient


@pytest.mark.parametrize("how,strategy,residual,keys", _strategy_cases())
def test_traced_strategy_equals_reference_and_blocking(how, strategy,
                                                       residual, keys):
    """build: unique right keys; swap: unique left keys (inner); member:
    semi/anti over duplicate right keys; expand: the recorded capacity
    with both uniqueness flags off, which holds for any input."""
    unique_side = "left" if strategy in ("swap", "member") else "right"
    lref, lport, rref, rport = _inputs(unique_side)
    ref, port = _nodes(how, keys, residual, lref, lport, rref, rport)
    want_blocking = ref.execute_blocking([lref, rref])
    blocking = port.execute_blocking(_pipes(lport, rport)).to_batch()
    _assert_batches_equal(blocking, want_blocking)
    stats = PP._JOIN_STATS.get(port.stats_key())
    index = PP._JOIN_INDEX.get(port.stats_key())
    rindex = RP._JOIN_INDEX.get(ref.stats_key())
    if strategy == "expand":
        inner = PP.JoinExec(port.left, port.right, "inner", port.left_keys,
                            port.right_keys)
        inner.execute_blocking(_pipes(lport, rport))
        stats = (stats[0], False, False,
                 PP._JOIN_STATS.get(inner.stats_key())[3])
        index = rindex = None  # recorded for the other strategy
    picked, _ = port._strategy(stats[1], stats[2], stats[3], CAP, CAP)
    assert picked == strategy
    for idx, ridx in ((None, None), (index, rindex)):
        _bind(ref, stats, ridx)
        _bind(port, stats, idx)
        assert port.traceable and ref.traceable
        rbatches = [lref, rref] + [s.batch for s in ref.children()[2:]]
        rpipes = [RP.Pipe.from_batch_data(b.schema, b.data)
                  for b in rbatches]
        want = ref.trace(rpipes).to_batch()
        pbatches = [lport, rport] + [s.batch for s in port.children()[2:]]
        got = port.execute(_pipes(*pbatches)).to_batch()
        _assert_batches_equal(got, want)
        assert _live_rows(got) == _live_rows(blocking)


def test_traced_join_uses_the_dense_index_tables():
    """A unique-build join over packed keys records its index with the
    dense lo/cnt tables; the traced run reads them (through its aux
    scans) and equals the run that builds its ranges live."""
    lref, lport, rref, rport = _inputs("right")
    _, port = _nodes("inner", "packed", False, lref, lport, rref, rport)
    port.execute_blocking(_pipes(lport, rport))
    orient, ib, tb = PP._JOIN_INDEX.get(port.stats_key())
    assert orient == "fwd" and tb is not None
    assert list(tb.schema.names) == ["lo", "cnt"]
    stats = PP._JOIN_STATS.get(port.stats_key())
    _bind(port, stats, None)
    live = port.execute(_pipes(lport, rport)).to_batch()
    _bind(port, stats, (orient, ib, tb))
    assert len(port.children()) == 4
    indexed = port.execute(_pipes(lport, rport, ib, tb)).to_batch()
    assert torch.equal(indexed.data.row_mask, live.data.row_mask)
    for a, b in zip(indexed.data.columns, live.data.columns):
        assert torch.equal(a.data, b.data)
        assert (a.validity is None) == (b.validity is None)
        assert a.validity is None or torch.equal(a.validity, b.validity)


def test_join_index_skips_a_build_side_holding_a_join():
    lref, lport, rref, rport = _inputs("right")
    inner = PP.JoinExec(PP.BatchScanExec(rport), PP.BatchScanExec(rport),
                        "inner", (PE.Col("k"),), (PE.Col("k"),))
    assert PP._layout_stable(PP.BatchScanExec(rport))
    assert not PP._layout_stable(PP.ProjectExec((PE.Col("k"),), inner))


# ---- sorted aggregate, explode and compaction through SQL --------------------


@pytest.fixture(scope="module")
def sessions(spark):
    rng = np.random.default_rng(5)
    n = 20000
    table = pa.table({
        "k": rng.integers(0, 500, n),
        "k2": rng.integers(0, 9, n),
        "v": np.round(rng.normal(size=n), 3),
    })
    port = PortSession(device="cpu")
    for s in (spark, port):
        s.createDataFrame(table).createOrReplaceTempView("adaptive_t")
    return spark, port


ADAPTIVE_QUERIES = {
    "sorted_agg": """select k, count(*) as n, sum(k2) as s, min(v) as lo,
                            max(v) as hi
                     from adaptive_t group by k order by k""",
    "sorted_agg_empty": """select k, count(*) as n from adaptive_t
                           where k < 0 group by k""",
    "explode": """select k, e, count(*) as n
                  from adaptive_t lateral view explode(array(k2, k2 + 1)) x as e
                  where k < 40 group by k, e order by k, e""",
    # a sparse filter under a join: the first run compacts the join's
    # input and records the capacity, the second replays it in the stage
    "compaction": """select a.k, count(*) as n
                     from adaptive_t a join adaptive_t b
                       on a.k = b.k2 and a.k2 = b.k2
                     where a.k < 9 and a.v > 1.5
                     group by a.k order by a.k""",
}


def _rows(df):
    return [tuple(r) for r in df.collect()]


@pytest.mark.parametrize("name", sorted(ADAPTIVE_QUERIES))
def test_traced_run_equals_blocking_run_and_reference(sessions, name):
    spark, port = sessions
    q = ADAPTIVE_QUERIES[name]
    first = _rows(port.sql(q))
    assert planner.last_run.first_run
    with graphs.guarding_stages():
        second = _rows(port.sql(q))
    run = planner.last_run
    assert not run.first_run and not run.blocking and run.stages == 1
    assert second == first
    _rows(spark.sql(q))
    want = _rows(spark.sql(q))  # the reference's traced second run
    assert second == want
    if name == "sorted_agg_empty":
        assert first == []
    elif name == "sorted_agg":
        assert run.traced["agg:sorted"] == 1 and len(first) == 500
    elif name == "explode":
        assert run.traced["GenerateExec"] == 1
    else:
        assert run.traced["join:inner"] == 1
        # the root's compaction and the replayed one below the join
        assert run.traced["CompactExec"] >= 2


# ---- the host-traffic guard ---------------------------------------------------

_T = torch.arange(10)
_CALLS = {
    "item": lambda: _T.sum().item(),
    "int": lambda: int(_T[0]),
    "bool": lambda: bool(_T.any()),
    "tolist": lambda: _T.tolist(),
    "numpy": lambda: _T.numpy(),
    "nonzero": lambda: _T.nonzero(),
    "unique": lambda: torch.unique(_T),
    "masked_select": lambda: torch.masked_select(_T, _T > 3),
    "bool_index": lambda: _T[_T > 3],
    "repeat_interleave": lambda: _T.repeat_interleave(_T),
    "where1": lambda: torch.where(_T > 1),
    "tensor": lambda: torch.tensor([1, 2]),
    "as_tensor": lambda: torch.as_tensor(np.arange(3)),
    "from_numpy": lambda: torch.from_numpy(np.arange(3)),
}


@pytest.mark.parametrize("call", sorted(_CALLS))
def test_guard_raises_on_host_traffic(call):
    with pytest.raises(graphs.HostTrafficError):
        with graphs.HostTrafficGuard():
            _CALLS[call]()
    assert torch.from_numpy(np.arange(2)).tolist() == [0, 1]


def test_guard_passes_device_work_and_host_side():
    with graphs.HostTrafficGuard():
        _T.repeat_interleave(3)
        torch.where(_T > 1, _T, 0)
        torch.full((3,), 7)
        PK.bucket(5)
        with PD.host_side():
            int(_T[0])
            torch.from_numpy(np.arange(3))
        PD.device_table(np.arange(4), "cpu")
