"""The port's whole-query fusion over the mesh
(``spark_tpu_torch/parallel/executor.py`` ``_try_fuse`` and
``parallel/operators.FusedSpanExec``) on the CPU: the cases of
tests/test_fusion.py that need no A12 tier.

- Fusion on never changes the rows: fused equals staged exactly (float
  payloads included), at 1, 2 and 8 ranks, on uniform and skewed data, at
  the ladder's edge capacities and through every bailout; the fused rows
  also equal the reference's fused ``MeshExecutor(make_mesh(8))`` (floats
  within rel 1e-9: another rank count sums in another order).
- A fused plan runs fewer rank stages than the staged one and no
  ``ExchangeStatsExec`` stage; ``last_run`` lists a ``fusion`` event with
  its span count, or a ``fusion_bailout`` with the reference's typed
  reason (agg_strategy, skew_presplit, broadcast_switch, oom_ladder,
  sort_elide, overflow).
- ``capacity_ladder`` equals the reference's rung for rung.

The ``fusion.decide`` fault matrix, the compile-store digest and the
trace spans wait for the port's A12 tiers (ROADMAP).
"""

import glob
import os
import re

import numpy as np
import pyarrow as pa
import pytest

import spark_tpu.expr.expressions as RE
import spark_tpu.plan.logical as RL
import spark_tpu_torch.expr.expressions as E
import spark_tpu_torch.plan.logical as L
from spark_tpu.columnar.arrow import from_arrow as ref_from_arrow
from spark_tpu.conf import RuntimeConf as RefConf
from spark_tpu.parallel.executor import MeshExecutor as RefMeshExecutor
from spark_tpu.parallel.mesh import make_mesh as ref_make_mesh
from spark_tpu.parallel.operators import capacity_ladder as ref_ladder
from spark_tpu_torch import conf as CF
from spark_tpu_torch.columnar.arrow import from_arrow
from spark_tpu_torch.conf import RuntimeConf
from spark_tpu_torch.parallel import executor as PX
from spark_tpu_torch.parallel import operators as D
from spark_tpu_torch.parallel.executor import MeshExecutor
from spark_tpu_torch.parallel.mesh import make_mesh
from spark_tpu_torch.parallel.operators import FusedSpanExec, capacity_ladder
from spark_tpu_torch.parallel.sharded import ShardedBatch
from spark_tpu_torch.physical import operators as P
from spark_tpu_torch.physical.planner import execute_logical

from test_torch_threads import one_torch_thread  # noqa: F401

RANKS = (1, 2, 8)


def _executor(d, fusion, **overrides):
    conf = RuntimeConf({"spark.tpu.adaptive.enabled": True,
                        "spark.tpu.fusion.enabled": bool(fusion),
                        **overrides})
    return MeshExecutor(make_mesh(d, devices=["cpu"] * d), conf=conf)


def _rows(batch):
    return [tuple(r.values()) for r in batch.to_pylist()]


def _arrow(keys, vals):
    vals = np.asarray(vals, np.int64)
    return pa.table({"k": pa.array(np.asarray(keys, np.int64), pa.int64()),
                     "v": pa.array(vals, pa.int64()),
                     "f": pa.array(vals * 0.25 + 0.1, pa.float64())})


def _dataset(dist, n=6000):
    rng = np.random.default_rng({"uniform": 21, "skewed": 22}[dist])
    if dist == "uniform":
        keys = rng.integers(0, 200, n)
    else:  # 90% of the rows share one key
        keys = np.where(rng.random(n) < 0.9, 7, rng.integers(0, 200, n))
    return _arrow(keys, rng.integers(0, 1000, n))


def _rel(table):
    return L.Relation(from_arrow(table, device="cpu"))


def _q5_shape(mod, rel):
    """TPC-H q5's tail: a group-by with a float sum (strategy-pinned, so
    its only adaptive decision is the capacity: it fuses) under a global
    sort: two adaptive exchanges, two spans, one chain."""
    Lm, Em = mod
    agg = Lm.Aggregate(
        (Em.Col("k"),),
        (Em.Col("k"), Em.Alias(Em.Sum(Em.Col("f")), "fs"),
         Em.Alias(Em.Count(Em.Col("v")), "n")), rel)
    return Lm.Sort((Em.SortOrder(Em.Col("k")),), agg)


def _events(ex, kind):
    return [e for e in ex.last_run["events"] if e["kind"] == kind]


def _reasons(ex):
    return [e["reason"] for e in _events(ex, "fusion_bailout")]


def _stage_nodes(ex):
    return [s["node"] for s in ex.last_run["stages"]]


def _close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(a, float):
                assert a == pytest.approx(b, rel=1e-9)
            else:
                assert a == b


@pytest.fixture(scope="module")
def reference():
    """The reference's fused q5 shape at 8 devices on both datasets (a
    2-rung ladder: the rows do not depend on the rung count), once for
    the file."""
    out = {}
    for dist in ("uniform", "skewed"):
        ex = RefMeshExecutor(ref_make_mesh(8), conf=RefConf({
            "spark.tpu.adaptive.enabled": True,
            "spark.tpu.fusion.enabled": True,
            "spark.tpu.fusion.maxBucketVariants": 2}))
        out[dist] = _rows(ex.execute_logical(_q5_shape(
            (RL, RE), RL.Relation(ref_from_arrow(_dataset(dist))))))
    return out


# ---- fused against staged ---------------------------------------------------


@pytest.mark.parametrize("devices", RANKS)
@pytest.mark.parametrize("dist", ["uniform", "skewed"])
def test_byte_identity_fused_sweep(devices, dist, reference):
    plan = _q5_shape((L, E), _rel(_dataset(dist)))
    staged_ex = _executor(devices, False)
    staged = _rows(staged_ex.execute_logical(plan))
    assert not _events(staged_ex, "fusion")
    fused_ex = _executor(devices, True)
    fused = _rows(fused_ex.execute_logical(plan))
    assert fused == staged
    (fusion,) = _events(fused_ex, "fusion")
    assert fusion["spans"] == 2  # the aggregate's pair and the sort's
    assert not _reasons(fused_ex)
    assert fused_ex.last_run["rank_stages"] \
        < staged_ex.last_run["rank_stages"]
    _close(fused, reference[dist])


@pytest.mark.parametrize("devices", RANKS)
def test_byte_identity_q3_join_groupby(devices):
    """q3's shape: join -> group-by (float sum) -> sort. The join runs
    staged (its broadcast switch measures bytes on the host, a
    ``broadcast_switch`` bailout), the aggregate and the sort after it
    fuse."""
    n = 4000
    left = _rel(_dataset("skewed", n))
    right = L.Relation(from_arrow(pa.table({
        "k2": pa.array(np.arange(200, dtype=np.int64), pa.int64()),
        "w": pa.array(np.arange(200, dtype=np.int64) * 3, pa.int64()),
    }), device="cpu"))
    join = L.Join(left, right, "inner", (E.Col("k"),), (E.Col("k2"),))
    plan = L.Sort((E.SortOrder(E.Col("k")),), L.Aggregate(
        (E.Col("k"),), (E.Col("k"), E.Alias(E.Sum(E.Col("f")), "fs")),
        join))
    staged = _rows(_executor(devices, False).execute_logical(plan))
    ex = _executor(devices, True)
    fused = _rows(ex.execute_logical(plan))
    assert fused == staged
    assert _events(ex, "fusion")
    assert "broadcast_switch" in _reasons(ex)


def test_overflow_sentinel_bails_to_staged():
    """The root span's output is cut to the ladder's anchor plus an
    eighth, with one sentinel slot. A constant sort key routes every row
    to one rank, past that capacity: the sentinel trips and the staged
    path re-runs (an ``overflow`` bailout) with the same rows."""
    rng = np.random.default_rng(23)
    n = 2000
    plan = L.Sort((E.SortOrder(E.Col("v")),),
                  _rel(_arrow(rng.integers(0, 5, n), np.full(n, 7))))
    over = {"spark.tpu.adaptive.capacityBucket": 64}
    staged = _rows(_executor(2, False, **over).execute_logical(plan))
    ex = _executor(2, True, **over)
    fused = _rows(ex.execute_logical(plan))
    assert fused == staged
    assert _reasons(ex) == ["overflow"]
    assert not _events(ex, "fusion")


# ---- the capacity ladder ----------------------------------------------------


@pytest.mark.parametrize("args", [
    (1024, 4, 400384, 8), (1024, 4, 65536, 8), (1024, 4, 65536),
    (1024, 4, 512, 8), (64, 2, 1 << 20, 8), (64, 1, 1 << 20, 8),
    (1000, 4, 70001, 8), (0, 0, 0), (128, 8, 10 ** 9, 4), (7, 3, 100, 3)])
def test_capacity_ladder_matches_reference(args):
    assert capacity_ladder(*args) == ref_ladder(*args)


def test_capacity_ladder_shape():
    assert capacity_ladder(1024, 4, 400384, 8) == (5120, 14336, 51200,
                                                   400384)
    assert capacity_ladder(1024, 4, 65536, 8) == (2048, 4096, 9216, 65536)
    assert capacity_ladder(1024, 4, 65536) == (65536,)
    assert capacity_ladder(1024, 4, 512, 8) == (512,)
    assert capacity_ladder(64, 2, 1 << 20, 8) == (131136, 1 << 20)
    assert capacity_ladder(64, 1, 1 << 20, 8) == (1 << 20,)
    assert all(c % 1000 == 0 or c == 70001
               for c in capacity_ladder(1000, 4, 70001, 8))
    ladder = capacity_ladder(1024, 4, 400384, 8)
    assert any(c >= -(-400384 // 8) for c in ladder[:-1])
    assert capacity_ladder(0, 0, 0) == (1,)


@pytest.mark.parametrize("n", [63, 64, 65, 255, 256, 257])
def test_ladder_edge_cells_vs_staged_oracle(n):
    """All-distinct keys put the largest incoming count on and around the
    rungs of a bucket-64 ladder: the span picks a covering rung and stays
    equal to the staged run; against one device the float sums within
    rel 1e-9."""
    rng = np.random.default_rng(n)
    plan = _q5_shape((L, E), _rel(_arrow(np.arange(n),
                                         rng.integers(0, 1000, n))))
    over = {"spark.tpu.adaptive.capacityBucket": 64,
            "spark.tpu.fusion.maxBucketVariants": 2}
    staged = _rows(_executor(2, False, **over).execute_logical(plan))
    ex = _executor(2, True, **over)
    fused = _rows(ex.execute_logical(plan))
    assert fused == staged
    assert len(_events(ex, "fusion")) == 1
    _close(fused, _rows(execute_logical(plan, device="cpu")))


def test_fused_span_plan_key_includes_the_ladder():
    sb = ShardedBatch.from_batch(from_arrow(pa.table({
        "k": pa.array(np.arange(8, dtype=np.int64), pa.int64())}),
        device="cpu"), make_mesh(2, devices=["cpu"] * 2))
    ex = D.HashPartitionExchangeExec((E.Col("k"),), D.ShardScanExec(sb))
    sort = P.SortExec((E.SortOrder(E.Col("k")),), ex)

    def span(bucket, variants):
        return FusedSpanExec(consumer=sort, exchange=ex, bucket=bucket,
                             variants=variants)

    keys = {span(b, v).plan_key() for b, v in ((1024, 4), (512, 4),
                                               (1024, 8))}
    assert len(keys) == 3


# ---- bailouts: a typed reason and the same rows -----------------------------


def test_bailout_agg_strategy():
    """An integer aggregate passes the strategy verdict, so the
    crossover is a live host decision: the whole plan stays staged."""
    plan = L.Sort((E.SortOrder(E.Col("k")),), L.Aggregate(
        (E.Col("k"),), (E.Col("k"), E.Alias(E.Sum(E.Col("v")), "s")),
        _rel(_dataset("uniform"))))
    staged = _rows(_executor(8, False).execute_logical(plan))
    ex = _executor(8, True)
    assert _rows(ex.execute_logical(plan)) == staged
    assert not _events(ex, "fusion")
    assert "agg_strategy" in _reasons(ex)


def test_bailout_skew_presplit():
    """With the strategy switch off, a re-mergeable (integer) final merge
    could still fan skewed destinations, elected on the host."""
    plan = L.Aggregate(
        (E.Col("k"),), (E.Col("k"), E.Alias(E.Sum(E.Col("v")), "s")),
        _rel(_dataset("skewed")))
    over = {"spark.tpu.adaptive.agg.enabled": False}
    staged = sorted(_rows(_executor(8, False, **over).execute_logical(plan)))
    ex = _executor(8, True, **over)
    assert sorted(_rows(ex.execute_logical(plan))) == staged
    assert not _events(ex, "fusion")
    assert "skew_presplit" in _reasons(ex)


def test_bailout_broadcast_switch():
    n = 2000
    left = _rel(_dataset("uniform", n))
    right = L.Relation(from_arrow(pa.table({
        "k2": pa.array(np.arange(64, dtype=np.int64), pa.int64()),
        "w": pa.array(np.arange(64, dtype=np.int64) * 10, pa.int64()),
    }), device="cpu"))
    join = L.Join(left, right, "inner", (E.Col("k"),), (E.Col("k2"),))
    staged = sorted(_rows(_executor(8, False).execute_logical(join)))
    ex = _executor(8, True)
    assert sorted(_rows(ex.execute_logical(join))) == staged
    assert "broadcast_switch" in _reasons(ex)


def test_bailout_oom_ladder():
    """The OOM ladder's adaptive retry (``FORCE_ADAPTIVE``) wants the
    staged path's measured capacities: fusion steps aside."""
    plan = _q5_shape((L, E), _rel(_dataset("uniform")))
    staged = _rows(_executor(2, False).execute_logical(plan))
    ex = _executor(2, True)
    token = PX.FORCE_ADAPTIVE.set(True)
    try:
        fused = _rows(ex.execute_logical(plan))
    finally:
        PX.FORCE_ADAPTIVE.reset(token)
    assert fused == staged
    assert not _events(ex, "fusion")
    assert "oom_ladder" in _reasons(ex)


def test_bailout_sort_elide():
    """A producer whose batch carries ``sorted_by`` lets the staged path
    skip the whole sort: a host metadata decision, so the rewrite bails
    before building a span."""
    sb = ShardedBatch.from_batch(from_arrow(pa.table({
        "k": pa.array(np.arange(64, dtype=np.int64), pa.int64())}),
        device="cpu"), make_mesh(2, devices=["cpu"] * 2))
    sb.sorted_by = (("k", True, True),)
    orders = (E.SortOrder(E.Col("k")),)
    plan = P.SortExec(orders, D.RangeExchangeExec(orders,
                                                  D.ShardScanExec(sb)))
    ex = _executor(2, True)
    with pytest.raises(PX._FusionBailout) as exc:
        ex._fuse_rewrite(plan)
    assert exc.value.reason == "sort_elide"
    staged = _rows(_executor(2, False).run(plan).to_batch())
    ex._stats = {"stages": [], "exchanges": [], "events": [],
                 "host_reads": 0}
    fused = _rows(ex.run(plan).to_batch())
    assert fused == staged
    reasons = [e["reason"] for e in ex._stats["events"]
               if e["kind"] == "fusion_bailout"]
    assert reasons == ["sort_elide"]


# ---- no stats stage inside a fused plan -------------------------------------


def test_fused_plan_has_no_exchange_stats_stage():
    """The staged path runs one ExchangeStatsExec stage (and its host
    read) per adaptive exchange; the fused plan runs none, and one
    FusedSpan stage."""
    plan = _q5_shape((L, E), _rel(_dataset("uniform")))
    staged = _executor(2, False)
    staged.execute_logical(plan)
    nodes = _stage_nodes(staged)
    assert sum(n.startswith("ExchangeStats") for n in nodes) >= 2
    fused = _executor(2, True)
    fused.execute_logical(plan)
    nodes = _stage_nodes(fused)
    assert not [n for n in nodes if n.startswith("ExchangeStats")]
    assert len([n for n in nodes if n.startswith("FusedSpan")]) == 1
    assert fused.last_run["host_reads"] < staged.last_run["host_reads"]


def test_fusion_conf_declaration_scan():
    """Every spark.tpu.fusion.* key the port's source names is
    registered with a default and a doc."""
    root = os.path.join(os.path.dirname(__file__), "..", "spark_tpu_torch")
    used = set()
    for path in glob.glob(os.path.join(root, "**", "*.py"), recursive=True):
        with open(path) as f:
            used.update(re.findall(r"spark\.tpu\.fusion\.\w+(?:\.\w+)*",
                                   f.read()))
    assert used, "no fusion conf keys found in source"
    for key in used:
        assert key in CF._REGISTRY, f"{key} not registered in conf.py"
        entry = CF._REGISTRY[key]
        assert entry.doc and len(entry.doc) > 20, f"{key} lacks a doc"
        assert entry.default is not None, f"{key} lacks a default"
