"""The port's mesh execution (``spark_tpu_torch/parallel``) on the CPU:
the cases of tests/test_distributed.py at 1, 2 and 8 ranks, all on the
``cpu`` device (ranks share a device when the caller lists it; the
reference's suite uses 8 virtual XLA CPU devices for the same role).

- Every case against the port's single-device run of the same plan:
  rows equal as multisets (integers, strings, decimals and NULLs
  exactly; floats within rel 1e-9, because a mesh adds each rank's
  partial sums in rank order); ordered plans also by their sort-key
  sequence (ties may permute).
- The operator cases against the reference's ``MeshExecutor(make_mesh(8))``
  on the same numpy-seeded tables, once per file (a module fixture).
- ``hash_rows`` against the reference's bit for bit (so rows route to the
  same rank in both packages), ``fold_in`` and ``DistSampleExec``'s rows
  equal to the reference's at 8 ranks.
- A rank that raises fails the query within the stage's own timeout,
  and no rank thread outlives it; a mesh that asks for the card raises
  without one; the adaptive and fusion settings run on a mesh and give
  the adaptive-off rows.
"""

import sqlite3
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_tpu.expr.expressions as RE
import spark_tpu.plan.logical as RL
import spark_tpu_torch.expr.expressions as E
import spark_tpu_torch.plan.logical as L
from spark_tpu.columnar.arrow import from_arrow as ref_from_arrow
from spark_tpu.parallel.executor import MeshExecutor as RefMeshExecutor
from spark_tpu.parallel.mesh import make_mesh as ref_make_mesh
from spark_tpu_torch import types as PT
from spark_tpu_torch.api import functions as PF
from spark_tpu_torch.api.session import SparkSession as PortSession
from spark_tpu_torch.columnar.arrow import from_arrow
from spark_tpu_torch.parallel import exchange as X
from spark_tpu_torch.parallel.executor import (ADAPTIVE_ENABLED,
                                               BROADCAST_THRESHOLD,
                                               FUSION_ENABLED,
                                               SKEW_MIN_PAIRS, MeshExecutor)
from spark_tpu_torch.parallel.mesh import make_mesh
from spark_tpu_torch.physical.planner import execute_logical

from test_torch_threads import one_torch_thread  # noqa: F401

REL = 1e-9
RANKS = (1, 2, 8)


def _mesh_ex(d, broadcast_bytes=None):
    """A mesh executor of ``d`` CPU ranks; ``broadcast_bytes`` sets its
    broadcast-join threshold (-1: every join is partitioned)."""
    ex = MeshExecutor(make_mesh(d, devices=["cpu"] * d))
    if broadcast_bytes is not None:
        ex.conf.set(BROADCAST_THRESHOLD.key, broadcast_bytes)
    return ex


@pytest.fixture(scope="module")
def executors():
    return {d: _mesh_ex(d) for d in RANKS}


def _key(r):
    return tuple((v is None, v) for v in r)


def _rows(batch, ordered=False):
    rows = [tuple(d.values()) for d in batch.to_pylist()]
    return rows if ordered else sorted(rows, key=_key)


def _same(got, want):
    assert len(got) == len(want), (len(got), len(want))
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(a, float) and isinstance(b, float):
                assert a == pytest.approx(b, rel=REL, abs=1e-12), (g, w)
            else:
                assert a == b, (g, w)


def check(ex, plan, order_cols=None):
    """The mesh's rows equal the single-device run's as multisets; with
    ``order_cols`` the sequence of those columns too."""
    got = ex.execute_logical(plan)
    want = execute_logical(plan, device="cpu")
    _same(_rows(got), _rows(want))
    if order_cols is not None:
        names = list(want.schema.names)
        idx = [names.index(c) for c in order_cols]
        seq = [[tuple(r[i] for i in idx) for r in _rows(b, True)]
               for b in (got, want)]
        assert seq[0] == seq[1]
    return got


# ---- the tables, made once from numpy for both packages ---------------------


def _table(rng, n=5000, with_nulls=True):
    ks = rng.integers(0, 50, n)
    vs = (rng.normal(size=n) * 10).astype(object)
    if with_nulls:
        vs[rng.random(n) < 0.1] = None
    tag = np.array(["red", "green", "blue", "gold"])[rng.integers(0, 4, n)]
    return pa.table({"k": pa.array(ks, pa.int64()),
                     "v": pa.array(list(vs), pa.float64()),
                     "tag": pa.array(list(tag), pa.string())})


@pytest.fixture(scope="module")
def tables():
    rng = np.random.default_rng(42)
    main = _table(rng)
    other = _table(rng, n=1000)
    n, m = 2000, 400
    left = pa.table({"id": pa.array(rng.integers(0, 300, n), pa.int64()),
                     "x": pa.array(rng.normal(size=n), pa.float64())})
    right = pa.table({"id": pa.array(rng.integers(0, 300, m), pa.int64()),
                      "name": pa.array(list(np.array(["a", "b", "c"])[
                          rng.integers(0, 3, m)]), pa.string())})
    return {"main": main, "other": other, "left": left, "right": right}


def _rel(tables, name):
    return L.Relation(from_arrow(tables[name], device="cpu"))


def _ref_rel(tables, name):
    return RL.Relation(ref_from_arrow(tables[name]))


def _agg_cases(mod, rel):
    """The aggregate plans of tests/test_distributed.py, built with the
    logical and expression modules ``mod`` = (L, E) of either package."""
    Lm, Em = mod
    return {
        "global": Lm.Aggregate((), (
            Em.Alias(Em.Sum(Em.Col("v")), "s"),
            Em.Alias(Em.Count(None), "n"),
            Em.Alias(Em.Avg(Em.Col("v")), "a"),
            Em.Alias(Em.Min(Em.Col("k")), "mn"),
            Em.Alias(Em.Max(Em.Col("k")), "mx"),
            Em.Alias(Em.StddevVariance("stddev_samp", Em.Col("v")), "sd")),
            rel),
        "direct": Lm.Aggregate((Em.Col("tag"),), (
            Em.Col("tag"), Em.Alias(Em.Sum(Em.Col("v")), "s"),
            Em.Alias(Em.Count(None), "n")), rel),
        "shuffle": Lm.Aggregate((Em.Col("k"),), (
            Em.Col("k"), Em.Alias(Em.Sum(Em.Col("v")), "s"),
            Em.Alias(Em.Count(Em.Col("v")), "n"),
            Em.Alias(Em.Avg(Em.Col("v")), "a")), rel),
        "distinct": Lm.Distinct(Lm.Project((Em.Col("k"),), rel)),
        "sort": Lm.Sort((Em.SortOrder(Em.Col("v"), ascending=False),
                         Em.SortOrder(Em.Col("k"))), rel),
        "count_distinct": Lm.Aggregate((), (
            Em.Alias(Em.Count(Em.Col("k"), distinct=True), "dk"),
            Em.Alias(Em.Count(Em.Col("tag"), distinct=True), "dt"),
            Em.Alias(Em.Sum(Em.Col("k")), "s")), rel),
    }


@pytest.fixture(scope="module")
def reference_mesh_rows(tables):
    """The reference's MeshExecutor(make_mesh(8)) on the operator cases,
    run once for the file."""
    ex = RefMeshExecutor(ref_make_mesh(8))
    cases = _agg_cases((RL, RE), _ref_rel(tables, "main"))
    out = {name: [tuple(d.values()) for d in
                  ex.execute_logical(p).to_pylist()]
           for name, p in cases.items()}
    lr, rr = _ref_rel(tables, "left"), _ref_rel(tables, "right")
    big = RefMeshExecutor(ex.mesh, broadcast_threshold=1)
    for how in ("inner", "left", "full", "left_anti"):
        out[f"join_{how}"] = [tuple(d.values()) for d in big.execute_logical(
            RL.Join(lr, rr, how, (RE.Col("id"),), (RE.Col("id"),)))
            .to_pylist()]
    return out


@pytest.mark.parametrize("d", RANKS)
def test_operator_cases_match_single_device_and_reference(
        executors, tables, reference_mesh_rows, d):
    """Each aggregate/sort/distinct case: the mesh's rows equal the
    single-device run's and, at every rank count, the reference mesh's
    at 8 devices."""
    ex = executors[d]
    for name, plan in _agg_cases((L, E), _rel(tables, "main")).items():
        got = check(ex, plan, order_cols=["v", "k"] if name == "sort"
                    else None)
        want = reference_mesh_rows[name]
        _same(_rows(got, ordered=name == "sort") if name == "sort"
              else _rows(got), want if name == "sort"
              else sorted(want, key=_key))


@pytest.mark.parametrize("d", RANKS)
@pytest.mark.parametrize("how", ["inner", "left", "right", "full",
                                 "left_semi", "left_anti"])
def test_join_partitioned(tables, reference_mesh_rows, d, how):
    plan = L.Join(_rel(tables, "left"), _rel(tables, "right"), how,
                  (E.Col("id"),), (E.Col("id"),))
    got = check(_mesh_ex(d, broadcast_bytes=-1), plan)
    if f"join_{how}" in reference_mesh_rows:
        _same(_rows(got), sorted(reference_mesh_rows[f"join_{how}"],
                                 key=_key))


@pytest.mark.parametrize("d", RANKS)
def test_filter_project_range_union_repartition(executors, tables, d):
    ex = executors[d]
    rel = _rel(tables, "main")
    check(ex, L.Project((E.Col("k"), E.Alias(E.Col("v") * 2.0, "v2")),
                        L.Filter(E.Col("k") > 25, rel)))
    check(ex, L.Filter(E.Col("id") % 7 == 0, L.Range(0, 10000, 3)))
    check(ex, L.Union(L.Filter(E.Col("k") < 10, rel),
                      L.Filter(E.Col("k") >= 40, _rel(tables, "other"))))
    check(ex, L.Repartition(8, (E.Col("k"),), rel))
    check(ex, L.Repartition(3, (), rel))


@pytest.mark.parametrize("d", RANKS)
def test_sorts_and_limits(executors, tables, d):
    ex = executors[d]
    rel = _rel(tables, "main")
    check(ex, L.Sort((E.SortOrder(E.Col("v"), ascending=False),), rel),
          order_cols=["v"])
    check(ex, L.Sort((E.SortOrder(E.Col("tag")), E.SortOrder(E.Col("k"))),
                     rel), order_cols=["tag", "k"])
    for plan in (L.Limit(17, L.Sort((E.SortOrder(E.Col("v")),), rel)),
                 L.Limit(10, L.Sort((E.SortOrder(E.Col("v")),), rel),
                         offset=5)):
        got = ex.execute_logical(plan)
        want = execute_logical(plan, device="cpu")
        assert [r[1] for r in _rows(got, True)] == \
            [r[1] for r in _rows(want, True)]
    b = from_arrow(pa.table({"x": np.arange(2000, dtype=np.int64)}),
                   device="cpu")
    plan = L.Limit(7, L.Relation(b))
    assert _rows(ex.execute_logical(plan), True) == \
        _rows(execute_logical(plan, device="cpu"), True)


@pytest.mark.parametrize("d", RANKS)
def test_joins_broadcast_condition_string_cross(executors, tables, d):
    ex = executors[d]
    lr, rr = _rel(tables, "left"), _rel(tables, "right")
    for how in ("inner", "left", "left_semi", "left_anti"):
        check(ex, L.Join(lr, rr, how, (E.Col("id"),), (E.Col("id"),)))
    check(ex, L.Join(lr, rr, "inner", (E.Col("id"),), (E.Col("id"),),
                     condition=E.Col("x") > 0.0))
    rng = np.random.default_rng(5)
    sl = L.Relation(from_arrow(pa.table({
        "tag": pa.array(list(np.array(["xred", "xgreen", "xblue"])[
            rng.integers(0, 3, 300)])),
        "v": pa.array(rng.normal(size=300))}), device="cpu"))
    sr = L.Relation(from_arrow(pa.table({
        "t2": pa.array(list(np.array(["red", "green", "gold"])[
            rng.integers(0, 3, 80)])),
        "w": pa.array(rng.normal(size=80))}), device="cpu"))
    key = E.Substring(E.Col("tag"), 2, 100)
    for threshold in (-1, 1 << 20):  # partitioned and broadcast
        check(_mesh_ex(d, broadcast_bytes=threshold),
              L.Join(sl, sr, "inner", (key,), (E.Col("t2"),)))
    check(ex, L.Join(
        L.Relation(from_arrow(pa.table({"a": np.arange(37)}), device="cpu")),
        L.Relation(from_arrow(pa.table({"b": np.arange(11)}), device="cpu")),
        "cross", (), ()))


def test_relation_cache_no_id_aliasing(executors):
    ex = executors[8]
    for i in range(6):
        b = from_arrow(pa.table({"x": np.full(100, i, dtype=np.int64)}),
                       device="cpu")
        got = {r[0] for r in _rows(ex.execute_logical(
            L.Distinct(L.Relation(b))))}
        assert got == {i}, (i, got)


# ---- bit-for-bit routing and sampling against the reference -----------------


def _hash_inputs(rng, n=3000):
    ints = rng.integers(-2 ** 62, 2 ** 62, n)
    floats = rng.normal(size=n) * 1e3
    floats[:4] = [0.0, -0.0, np.inf, -np.inf]
    small = rng.integers(-5, 5, n).astype(np.int32)
    valid = rng.random(n) > 0.2
    flags = rng.random(n) > 0.5
    return ints, floats, small, valid, flags


def test_hash_rows_bit_for_bit():
    """B9: the port's row hash (int64 bits) equals the reference's uint64
    hash for int64, float64 (with +-0.0 and infinities), int32 and bool
    columns, with and without NULLs; and hash_target routes every row
    to the same rank at D = 2, 3 and 8."""
    from spark_tpu import types as RT
    from spark_tpu.expr.compiler import TV as RTV
    from spark_tpu.parallel import exchange as RX
    from spark_tpu_torch import types as PT
    from spark_tpu_torch.expr.compiler import TV as PTV

    ints, floats, small, valid, flags = _hash_inputs(
        np.random.default_rng(8))
    combos = [
        [(ints, None, "INT64")],
        [(floats, None, "FLOAT64")],
        [(small, valid, "INT32"), (ints, None, "INT64")],
        [(floats, valid, "FLOAT64"), (flags, None, "BOOLEAN"),
         (small, None, "INT32")],
    ]
    mask = np.ones(len(ints), dtype=bool)
    for cols in combos:
        rtvs = [RTV(jnp.asarray(a), None if v is None else jnp.asarray(v),
                    getattr(RT, t), None) for a, v, t in cols]
        ptvs = [PTV(torch.from_numpy(a), None if v is None
                    else torch.from_numpy(v), getattr(PT, t), None)
                for a, v, t in cols]
        want = np.asarray(RX.hash_rows(rtvs)).view(np.int64)
        got = X.hash_rows(ptvs).numpy()
        assert np.array_equal(got, want)
        for d in (2, 3, 8):
            rt = np.asarray(RX.hash_target(rtvs, jnp.asarray(mask), d))
            pt = X.hash_target(ptvs, torch.from_numpy(mask), d).numpy()
            assert np.array_equal(pt, rt.astype(np.int64))


def test_fold_in_and_dist_sample_rows_match_reference():
    """fold_in(PRNGKey(seed), rank) bit for bit with JAX, and the rows of
    a mesh sample at 8 ranks equal to the reference mesh's."""
    from spark_tpu_torch.physical import random as R

    for seed in (7, 42, 123456789):
        for d in range(8):
            k = jax.random.fold_in(jax.random.PRNGKey(seed), d)
            want = np.asarray(jax.random.uniform(k, (513,)))
            got = R.uniform(0, 513, "cpu", key=R.fold_in(R.prng_key(seed), d))
            assert np.array_equal(got.numpy().view(np.int64),
                                  want.view(np.int64))
    want = sorted(r["id"] for r in RefMeshExecutor(ref_make_mesh(8))
                  .execute_logical(RL.Sample(0.5, 7, RL.Range(0, 4096, 1)))
                  .to_pylist())
    got = sorted(r[0] for r in _rows(_mesh_ex(8).execute_logical(
        L.Sample(0.5, 7, L.Range(0, 4096, 1)))))
    assert got == want and 1500 < len(got) < 2600
    gaps = np.diff(np.array(got))
    assert (gaps == 1).mean() < 0.8


# ---- regressions and the session --------------------------------------------


def test_skew_join_rebalances_to_broadcast():
    """90% of the probe rows on one key: the hash exchange would put
    nearly every pair on one rank, so the join re-plans as a broadcast
    over the balanced rows (bounded pair capacity, same rows)."""
    rng = np.random.default_rng(17)
    n = 40_000
    keys = np.where(rng.random(n) < 0.9, 7, rng.integers(0, 1000, n))
    probe = L.Relation(from_arrow(pa.table({
        "k": pa.array(keys, pa.int64()),
        "v": pa.array(np.arange(n), pa.int64())}), device="cpu"))
    build = L.Relation(from_arrow(pa.table({
        "k": pa.array(np.arange(1000), pa.int64()),
        "w": pa.array(np.arange(1000) * 10, pa.int64())}), device="cpu"))
    plan = L.Aggregate((), (E.Alias(E.Count(None), "c"),
                            E.Alias(E.Sum(E.Col("w")), "s")),
                       L.Join(probe, build, "inner", (E.Col("k"),),
                              (E.Col("k"),)))
    ex = _mesh_ex(8)
    ex.conf.set(BROADCAST_THRESHOLD.key, 1)
    ex.conf.set(SKEW_MIN_PAIRS.key, 5000)
    from spark_tpu_torch.parallel import operators as D

    caps = []
    real = ex._run_stage

    def spy(stage):
        if isinstance(stage, D.JoinApplyExec):
            caps.append(stage.pair_capacity)
        return real(stage)

    ex._run_stage = spy
    got = ex.execute_logical(plan).to_pylist()[0]
    assert any(e["kind"] == "skew_join_broadcast"
               for e in ex.last_run.get("events", []))
    assert caps and max(caps) <= (n // 8) * 2 + 2048, caps
    want = execute_logical(plan, device="cpu").to_pylist()[0]
    assert got["c"] == want["c"] == n and got["s"] == want["s"]


def test_multi_distinct_different_columns_global(executors):
    rows = pa.table({"a": [i % 7 for i in range(2000)],
                     "b": [i % 11 for i in range(2000)],
                     "v": list(range(2000))})
    rel = L.Relation(from_arrow(rows, device="cpu"))
    plan = L.Aggregate((), (
        E.Alias(E.Count(E.Col("a"), distinct=True), "da"),
        E.Alias(E.Count(E.Col("b"), distinct=True), "db"),
        E.Alias(E.Sum(E.Col("v")), "s"), E.Alias(E.Count(None), "n")), rel)
    r = executors[8].execute_logical(plan).to_pylist()[0]
    assert (r["da"], r["db"], r["s"], r["n"]) == (7, 11, sum(range(2000)),
                                                  2000)


@pytest.mark.parametrize("d", (2, 8))
def test_windows_with_different_partition_keys(d):
    """Two window specs over different partition keys (an exchange and a
    local window each) and a row_number over the whole table (a single
    partition), against sqlite."""
    rows = [{"g": i % 3, "h": i % 5, "v": i} for i in range(200)]
    spark = PortSession(device="cpu", conf={"spark_tpu.mesh.devices": d},
                        mesh_devices=["cpu"] * d)
    spark.createDataFrame(rows).createOrReplaceTempView("mw")
    sql = ("select g, h, v, sum(v) over (partition by g) as sg, "
           "sum(v) over (partition by h) as sh, "
           "row_number() over (order by v) as rn from mw order by v")
    got = [tuple(r) for r in spark.sql(sql).collect()]
    conn = sqlite3.connect(":memory:")
    conn.execute("create table mw(g int, h int, v int)")
    conn.executemany("insert into mw values (?,?,?)",
                     [(r["g"], r["h"], r["v"]) for r in rows])
    assert got == [tuple(w) for w in conn.execute(sql).fetchall()]


def test_session_mesh_master():
    """master("mesh[8]") with the ranks' devices listed: spark.sql,
    groupBy and count run on the mesh; a mesh that asks for the card
    raises without one (no fallback to the CPU)."""
    spark = (PortSession.builder.device("cpu").master("mesh[8]")
             .meshDevices(["cpu"] * 8).getOrCreate())
    try:
        assert spark.mesh_executor is not None
        df = spark.range(1000).withColumn("g", E.Col("id") % 10)
        out = (df.groupBy("g").agg(PF.count("*").alias("n"),
                                   PF.sum("id").alias("s"))
               .sort("g").collect())
        assert [r.n for r in out] == [100] * 10
        assert sum(r.s for r in out) == 999 * 1000 // 2
        assert df.count() == 1000
        assert df.repartition(4, "g").count() == 1000
        assert len(spark.mesh_executor.last_run["stages"]) >= 1
    finally:
        PortSession._active = None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            make_mesh(2)
        with pytest.raises(RuntimeError, match="cuda"):
            PortSession.builder.device("cpu").master("mesh[2]").getOrCreate()
    PortSession._active = None


def test_adaptive_and_fusion_raise_on_a_mesh(executors, tables):
    """The adaptive and fusion settings, which raised on a mesh before
    they were ported, run and give the adaptive-off run's rows (the
    adaptive suites are tests/test_torch_aqe.py, test_torch_fusion.py and
    test_torch_agg_adaptive.py)."""
    rel = _rel(tables, "main")
    plan = L.Sort((E.SortOrder(E.Col("k")),), L.Aggregate(
        (E.Col("k"),), (E.Col("k"), E.Alias(E.Sum(E.Col("v")), "s"),
                        E.Alias(E.Count(None), "n")), rel))
    want = _rows(_mesh_ex(2).execute_logical(plan), ordered=True)
    for fusion in (False, True):
        ex = _mesh_ex(2)
        ex.conf.set(ADAPTIVE_ENABLED.key, True)
        ex.conf.set(FUSION_ENABLED.key, fusion)
        assert _rows(ex.execute_logical(plan), ordered=True) == want
        assert ex.last_run["events"]


def test_failing_rank_fails_query_without_leftover_threads(tables):
    """A tensor UDF that raises on rank 3 only (after the others have
    reached a collective): the query fails with that error at once, not
    after the collectives' timeout, and no rank thread is left
    running."""
    @PF.udf(returnType=PT.INT64)
    def boom(x):
        if X.axis_index() == 3:
            raise ValueError("rank 3 failed")
        return x

    rel = _rel(tables, "main")
    plan = L.Aggregate((E.Col("k"),), (E.Col("k"), E.Alias(
        E.Sum(boom(E.Col("k"))), "s")), rel)
    ex = _mesh_ex(8)
    t0 = time.perf_counter()
    with pytest.raises(ValueError, match="rank 3 failed"):
        ex.execute_logical(plan)
    assert time.perf_counter() - t0 < 20.0
    time.sleep(0.05)
    assert not [t for t in threading.enumerate()
                if t.name.startswith("mesh-rank-")]
    # the executor still runs the next query
    check(ex, L.Filter(E.Col("k") > 40, rel))


def test_fan_local_and_broadcast_on_thread_ranks():
    """fan_local keeps rows bound for a hot rank on their own rank; the
    seam's broadcast hands every rank the source rank's tensors."""
    comm = X.ThreadComm(1)
    with X.on_rank(0, comm, "cpu"):
        target = torch.tensor([0, 1, 3, 2, 1, 0])
        assert X.fan_local(target, [1, 3]).tolist() == [0, 0, 0, 2, 0, 0]
    comm = X.ThreadComm(3)
    out = [None] * 3

    def rank(r):
        out[r] = comm.broadcast(r, "cpu", [torch.full((2,), r)], src=2)[0]

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert all(o.tolist() == [2, 2] for o in out)


def test_dist_hash_partial_agg_matches_reference_and_sort_partial(tables):
    """DistHashPartialAggExec over a measured domain (k in [0, 50), tag's
    4-entry dictionary): each rank's partial groups at 8 ranks equal the
    reference's operator on the same shards and the port's sort partial
    (floats within REL: the ranks' sums add in another order)."""
    from spark_tpu.parallel import operators as RD
    from spark_tpu.parallel.sharded import ShardedBatch as RefSharded
    from spark_tpu_torch.parallel import operators as D
    from spark_tpu_torch.parallel.sharded import ShardedBatch

    def plans(Dm, Em, scan):
        keys = (Em.Col("k"), Em.Col("tag"))
        outs = (Em.Alias(Em.Col("k"), "__k0"), Em.Alias(Em.Col("tag"),
                                                        "__k1"),
                Em.Alias(Em.Sum(Em.Col("v")), "s"),
                Em.Alias(Em.Count(None), "n"),
                Em.Alias(Em.Min(Em.Col("v")), "mn"))
        return (Dm.DistHashPartialAggExec(keys, outs, scan, (0, 0), (50, 4)),
                Dm.DistSortAggExec(keys, outs, scan, phase="partial"))

    ex = _mesh_ex(8)
    scan = D.ShardScanExec(ShardedBatch.from_batch(
        from_arrow(tables["main"], device="cpu"), ex.mesh))
    hashed, sort = plans(D, E, scan)
    got = _rows(ex._run_stage(hashed).to_batch())
    _same(got, _rows(ex._run_stage(sort).to_batch()))
    ref_ex = RefMeshExecutor(ref_make_mesh(8))
    ref_scan = RD.ShardScanExec(RefSharded.from_batch(
        ref_from_arrow(tables["main"]), ref_ex.mesh))
    want = [tuple(d.values()) for d in ref_ex._run_stage(
        plans(RD, RE, ref_scan)[0]).to_batch().to_pylist()]
    _same(got, sorted(want, key=_key))


def test_dist_range_agg_matches_reference_and_is_key_ordered(tables):
    """DistRangeAggExec over a range exchange on k at 8 ranks: its groups
    equal the single-device aggregate and the reference's operator on the
    same exchanged rows, and rank order is key order across the mesh."""
    from spark_tpu.parallel import operators as RD
    from spark_tpu.parallel.sharded import ShardedBatch as RefSharded
    from spark_tpu_torch.parallel import operators as D
    from spark_tpu_torch.parallel.sharded import ShardedBatch

    def plans(Dm, Em, sharded, run_stage):
        keys = (Em.Col("k"),)
        outs = (Em.Col("k"), Em.Alias(Em.Sum(Em.Col("v")), "s"),
                Em.Alias(Em.Count(None), "n"),
                Em.Alias(Em.Max(Em.Col("tag")), "t"))
        ranged = run_stage(Dm.RangeExchangeExec(
            (Em.SortOrder(Em.Col("k")),), Dm.ShardScanExec(sharded)))
        return run_stage(Dm.DistRangeAggExec(keys, outs,
                                             Dm.ShardScanExec(ranged)))

    ex = _mesh_ex(8)
    sb = plans(D, E, ShardedBatch.from_batch(
        from_arrow(tables["main"], device="cpu"), ex.mesh), ex._run_stage)
    got = _rows(sb.to_batch(), ordered=True)
    assert [r[0] for r in got] == sorted(r[0] for r in got)
    rel = _rel(tables, "main")
    want = execute_logical(L.Aggregate((E.Col("k"),), (
        E.Col("k"), E.Alias(E.Sum(E.Col("v")), "s"),
        E.Alias(E.Count(None), "n"), E.Alias(E.Max(E.Col("tag")), "t")),
        rel), device="cpu")
    _same(sorted(got, key=_key), _rows(want))
    ref_ex = RefMeshExecutor(ref_make_mesh(8))
    ref_sb = plans(RD, RE, RefSharded.from_batch(
        ref_from_arrow(tables["main"]), ref_ex.mesh), ref_ex._run_stage)
    _same(got, [tuple(d.values()) for d in ref_sb.to_batch().to_pylist()])
