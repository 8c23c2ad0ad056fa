"""The port's adaptive execution over the mesh (``spark_tpu_torch/parallel``
with ``spark.tpu.adaptive.enabled``) on the CPU: the cases of
tests/test_aqe.py that need no A12 tier, the mesh cases of
tests/test_out_of_core.py (:88, :112, :466, :501, :626) and the OOM
ladder's rung 0.

- Adaptive on, and fused, give the adaptive-off rows exactly (float
  payloads included: measured compaction keeps the live rows' order), at
  1, 2 and 8 ranks, and the reference's adaptive ``MeshExecutor(make_mesh(8))``
  rows (floats within rel 1e-9: another rank count adds in another
  order).
- The post-exchange capacity is the bucket-rounded largest incoming
  count, computed here from the routing hash; the runtime broadcast
  switch flips at the measured bytes, which equal the reference's.
- A skewed destination fans into a pre-merge (``skew_split``), reached
  through rung 0 of the OOM ladder: a mesh session's run that runs out
  of memory with adaptive execution off is retried once with it forced.
- A skewed join splits around its hot key for every key type a mesh
  join takes (hot-key literals of the key's type, ROADMAP C9 and C10),
  inner and left, against a host count, the reference where it runs the
  type, and the skew-off run where it raises; keys of two types meet
  where their values are equal (C11).

The UI exchange endpoint and the admission feedback of measured bytes
wait for the port's A12 tiers (ROADMAP).
"""

import decimal
import glob
import os
import re

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import spark_tpu.expr.expressions as RE
import spark_tpu.plan.logical as RL
import spark_tpu_torch.expr.expressions as E
import spark_tpu_torch.plan.logical as L
from spark_tpu import metrics as ref_metrics
from spark_tpu.columnar.arrow import from_arrow as ref_from_arrow
from spark_tpu.conf import RuntimeConf as RefConf
from spark_tpu.parallel.executor import MeshExecutor as RefMeshExecutor
from spark_tpu.parallel.mesh import make_mesh as ref_make_mesh
from spark_tpu_torch import conf as CF
from spark_tpu_torch import recovery
from spark_tpu_torch.api import functions as PF
from spark_tpu_torch.api.session import SparkSession as PortSession
from spark_tpu_torch.columnar.arrow import from_arrow
from spark_tpu_torch.conf import RuntimeConf
from spark_tpu_torch.expr.compiler import TV
from spark_tpu_torch.parallel import exchange as X
from spark_tpu_torch.parallel import executor as PX
from spark_tpu_torch.parallel.executor import (BROADCAST_THRESHOLD,
                                               MeshExecutor)
from spark_tpu_torch.parallel.mesh import make_mesh
from spark_tpu_torch.physical import kernels as K
from spark_tpu_torch.physical.planner import execute_logical
from spark_tpu_torch.types import INT64

from test_torch_threads import one_torch_thread  # noqa: F401

RANKS = (1, 2, 8)


def _executor(d, adaptive, **overrides):
    conf = RuntimeConf({"spark.tpu.adaptive.enabled": bool(adaptive),
                        **overrides})
    return MeshExecutor(make_mesh(d, devices=["cpu"] * d), conf=conf)


def _rows(batch):
    return [tuple(r.values()) for r in batch.to_pylist()]


def _close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert a == pytest.approx(b, rel=1e-9)
            else:
                assert a == b


def _arrow(keys, vals):
    vals = np.asarray(vals, np.int64)
    return pa.table({"k": pa.array(np.asarray(keys, np.int64), pa.int64()),
                     "v": pa.array(vals, pa.int64()),
                     "f": pa.array(vals * 0.25 + 0.1, pa.float64())})


def _dataset(dist, n=6000):
    rng = np.random.default_rng({"uniform": 31, "skewed": 32}[dist])
    if dist == "uniform":
        keys = rng.integers(0, 200, n)
    else:  # 90% of the rows share one key
        keys = np.where(rng.random(n) < 0.9, 7, rng.integers(0, 200, n))
    return _arrow(keys, rng.integers(0, 1000, n))


def _groupby_sort(mod, rel):
    Lm, Em = mod
    agg = Lm.Aggregate(
        (Em.Col("k"),),
        (Em.Col("k"), Em.Alias(Em.Sum(Em.Col("v")), "s"),
         Em.Alias(Em.Count(Em.Col("v")), "n"),
         Em.Alias(Em.Min(Em.Col("v")), "mn"),
         Em.Alias(Em.Max(Em.Col("v")), "mx"),
         Em.Alias(Em.Sum(Em.Col("f")), "fs")), rel)
    return Lm.Sort((Em.SortOrder(Em.Col("k")),), agg)


def _join_tables():
    rng = np.random.default_rng(33)
    n = 4000
    left = pa.table({"k": pa.array(rng.integers(0, 64, n), pa.int64()),
                     "v": pa.array(rng.integers(0, 1000, n), pa.int64())})
    right = pa.table({
        "k2": pa.array(np.arange(64, dtype=np.int64), pa.int64()),
        "w": pa.array(np.arange(64, dtype=np.int64) * 10, pa.int64())})
    return left, right


def _join(mod, rel_of):
    Lm, Em = mod
    left, right = _join_tables()
    return Lm.Join(rel_of(left), rel_of(right), "inner", (Em.Col("k"),),
                   (Em.Col("k2"),))


@pytest.fixture(scope="module")
def reference():
    """The reference's adaptive MeshExecutor(make_mesh(8)): the group-by
    on both datasets, and the join's broadcast decision, once for the
    file."""
    out = {}
    for dist in ("uniform", "skewed"):
        ex = RefMeshExecutor(ref_make_mesh(8), conf=RefConf(
            {"spark.tpu.adaptive.enabled": True}))
        out[dist] = _rows(ex.execute_logical(_groupby_sort(
            (RL, RE), RL.Relation(ref_from_arrow(_dataset(dist))))))
    ex = RefMeshExecutor(ref_make_mesh(8), conf=RefConf({
        "spark.tpu.adaptive.enabled": True,
        "spark.tpu.adaptive.autoBroadcastJoinThreshold": 1 << 30}))
    out["join"] = sorted(_rows(ex.execute_logical(_join(
        (RL, RE), lambda t: RL.Relation(ref_from_arrow(t))))))
    out["join_event"] = [e for e in ref_metrics.recent(4096)
                         if e.get("kind") == "aqe"][-1]
    return out


# ---- the invariant: the same rows on or off ---------------------------------


@pytest.mark.parametrize("devices", RANKS)
@pytest.mark.parametrize("dist", ["uniform", "skewed"])
def test_byte_identity_groupby_sort(devices, dist, reference):
    plan = _groupby_sort((L, E), L.Relation(from_arrow(_dataset(dist),
                                                       device="cpu")))
    off_ex, on_ex = _executor(devices, False), _executor(devices, True)
    off = _rows(off_ex.execute_logical(plan))
    on = _rows(on_ex.execute_logical(plan))
    assert on == off
    fused = _executor(devices, True, **{"spark.tpu.fusion.enabled": True})
    assert _rows(fused.execute_logical(plan)) == off
    _close(on, reference[dist])
    _close(on, _rows(execute_logical(plan, device="cpu")))
    assert not off_ex.last_run["events"]
    assert [e["mode"] for e in on_ex.last_run["events"]
            if e["kind"] == "exchange"] == ["adaptive", "adaptive"]
    assert on_ex.last_run["rank_stages"] > off_ex.last_run["rank_stages"]


def _hash_dest(keys, d):
    """The rank each int64 key routes to (exchange.hash_target's hash)."""
    tv = TV(torch.as_tensor(np.asarray(keys, np.int64)), None, INT64, None)
    return X._umod(X.hash_rows([tv]), d).numpy()


@pytest.mark.parametrize("bucket", [1, 64])
def test_capacity_compaction_bucket_edges(bucket):
    """All-distinct keys: the hash exchange carries exactly n rows, and
    the consumer's capacity is the bucket-rounded largest incoming count
    (bucket 1: exactly that count), not D times the producer's."""
    d, n = 8, 4096
    keys = np.arange(n, dtype=np.int64)
    table = _arrow(keys, np.random.default_rng(34).integers(0, 1000, n))
    plan = _groupby_sort((L, E), L.Relation(from_arrow(table, device="cpu")))
    counts = np.bincount(_hash_dest(keys, d), minlength=d)
    expected = K.bucket(int(counts.max()), bucket)
    ex = _executor(d, True, **{"spark.tpu.adaptive.capacityBucket": bucket})
    got = _rows(ex.execute_logical(plan))
    _close(got, _rows(execute_logical(plan, device="cpu")))
    hash_ex = [e for e in ex.last_run["events"]
               if e["kind"] == "exchange" and e["op"] == "hash"][-1]
    assert hash_ex["mode"] == "adaptive"
    assert hash_ex["rows"] == n
    assert hash_ex["capacity_after"] == expected
    assert hash_ex["capacity_after"] < hash_ex["capacity_before"]
    assert hash_ex["capacity_before"] == d * (n // d)


def test_broadcast_switch_threshold_boundary(reference):
    def run(threshold):
        ex = _executor(8, True, **{
            "spark.tpu.adaptive.autoBroadcastJoinThreshold": threshold})
        out = ex.execute_logical(_join(
            (L, E), lambda t: L.Relation(from_arrow(t, device="cpu"))))
        decisions = [e for e in ex.last_run["events"] if e["kind"] == "aqe"
                     and e["decision"] in ("broadcast_join",
                                           "exchange_join")]
        assert decisions, "adaptive join made no recorded decision"
        return sorted(_rows(out)), decisions[-1]

    rows_hi, dec_hi = run(1 << 30)
    measured = dec_hi["measured_bytes"]
    ref_ev = reference["join_event"]
    assert dec_hi["decision"] == ref_ev["decision"] == "broadcast_join"
    assert measured == ref_ev["measured_bytes"]
    assert dec_hi["static_bytes"] >= measured
    rows_eq, dec_eq = run(measured)
    rows_lo, dec_lo = run(measured - 1)
    assert dec_eq["decision"] == "broadcast_join"
    assert dec_lo["decision"] == "exchange_join"
    assert rows_hi == rows_eq == rows_lo == reference["join"]


def test_broadcast_switch_flips_a_filtered_build_side():
    """The static estimate (capacity x row width) of a filtered build side
    says partitioned; its measured bytes say broadcast, and the rows stay
    the same."""
    left, right = _join_tables()
    rel_r = L.Filter(E.Cmp("<", E.Col("k2"), E.Literal(4)),
                     L.Relation(from_arrow(right, device="cpu")))
    plan = L.Join(L.Relation(from_arrow(left, device="cpu")), rel_r,
                  "inner", (E.Col("k"),), (E.Col("k2"),))
    over = {BROADCAST_THRESHOLD.key: 512,
            "spark.tpu.adaptive.autoBroadcastJoinThreshold": 512}
    off = _executor(2, False, **over)
    want = sorted(_rows(off.execute_logical(plan)))
    ex = _executor(2, True, **over)
    assert sorted(_rows(ex.execute_logical(plan))) == want
    (dec,) = [e for e in ex.last_run["events"] if e["kind"] == "aqe"]
    assert dec["decision"] == "broadcast_join"
    assert dec["measured_bytes"] <= 512 < dec["static_bytes"]


# ---- the skew fan through the OOM ladder's rung 0 ---------------------------


@pytest.fixture()
def mesh_session():
    prev = PortSession._active
    spark = (PortSession.builder.device("cpu").master("mesh[8]")
             .meshDevices(["cpu"] * 8).getOrCreate())
    yield spark
    PortSession._active = prev


def test_skew_split_and_oom_ladder_composition(mesh_session, monkeypatch):
    """A mesh run that runs out of memory with adaptive execution off
    takes rung 0 of the ladder (adaptive forced on, no chunking), where
    the skewed hash destination (thousands of distinct keys that all
    route to rank 0, so partials cannot collapse them) fans over the
    ranks into a pre-merge. The rows equal the run without the fault."""
    import pandas as pd

    spark = mesh_session
    d = 8
    cand = np.arange(60_000, dtype=np.int64)
    dest = _hash_dest(cand, d)
    keys = np.concatenate([cand[dest == 0][:6000], cand[dest != 0][:64]])
    vals = np.random.default_rng(35).integers(0, 1000, keys.size)
    spark.createDataFrame(pd.DataFrame({"k": keys, "v": vals})) \
        .createOrReplaceTempView("aqe_skew")
    q = ("SELECT k, sum(v) s, count(*) c, min(v) mn, max(v) mx "
         "FROM aqe_skew GROUP BY k ORDER BY k")
    want = [tuple(r) for r in spark.sql(q).collect()]
    assert recovery.last_ladder["replans"] == 0

    spark.conf.set("spark.tpu.adaptive.skewedPartitionFactor", 2)
    spark.conf.set("spark.tpu.adaptive.skewMinRows", 256)
    mesh = spark.mesh_executor
    real = MeshExecutor.execute_logical
    calls = []

    def oom_once(self, plan, optimize=True):
        calls.append(bool(PX.FORCE_ADAPTIVE.get()))
        if len(calls) == 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")
        return real(self, plan, optimize)

    monkeypatch.setattr(MeshExecutor, "execute_logical", oom_once)
    got = [tuple(r) for r in spark.sql(q).collect()]
    assert got == want
    assert calls == [False, True]
    assert recovery.last_ladder["adaptive_retries"] == 1
    assert recovery.last_ladder["replans"] == 1
    assert recovery.last_ladder["budgets"] == []  # no chunked replan
    events = mesh.last_run["events"]
    splits = [e for e in events if e["kind"] == "aqe"
              and e["decision"] == "skew_split"]
    assert splits and 0 in splits[-1]["hot"]
    assert splits[-1]["max_incoming"] >= 6000
    assert not PX.FORCE_ADAPTIVE.get()
    assert not spark.conf.get(CF.ADAPTIVE_ENABLED)


def test_rung_zero_is_skipped_when_adaptive_is_on(mesh_session,
                                                  monkeypatch):
    """With adaptive execution on already, an OOM goes straight to the
    chunked replans (none apply to an in-memory relation: the OOM
    surfaces)."""
    spark = mesh_session
    spark.conf.set("spark.tpu.adaptive.enabled", True)
    df = spark.range(100).withColumn("g", E.Col("id") % 10) \
        .groupBy("g").count()

    def oom(self, plan, optimize=True):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")

    monkeypatch.setattr(MeshExecutor, "execute_logical", oom)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        df.collect()
    assert recovery.last_ladder["adaptive_retries"] == 0


def test_all_adaptive_conf_keys_declared():
    """Every spark.tpu.adaptive.* key the port's source names is
    registered with a default and a doc."""
    root = os.path.join(os.path.dirname(__file__), "..", "spark_tpu_torch")
    used = set()
    for path in glob.glob(os.path.join(root, "**", "*.py"), recursive=True):
        with open(path) as f:
            used.update(re.findall(r"spark\.tpu\.adaptive\.\w+(?:\.\w+)*",
                                   f.read()))
    assert len(used) >= 15
    for key in used:
        assert key in CF._REGISTRY, f"{key} not registered in conf.py"
        entry = CF._REGISTRY[key]
        assert entry.doc and len(entry.doc) > 20, f"{key} lacks a doc"
        assert entry.default is not None, f"{key} lacks a default"


def test_adaptive_defaults_are_the_reference_s():
    from spark_tpu import conf as ref_conf

    for name in dir(CF):
        entry = getattr(CF, name)
        if name.startswith(("ADAPTIVE_", "FUSION_")) \
                and isinstance(entry, CF.ConfigEntry):
            ref = getattr(ref_conf, name)
            assert (entry.key, entry.default) == (ref.key, ref.default)


# ---- the out-of-memory tier's mesh cases (tests/test_out_of_core.py) ---------


def _port_df(rows):
    return PortSession(device="cpu").createDataFrame(rows)


@pytest.mark.parametrize("adaptive", [False, True])
def test_skewed_aggregation_map_side_combine(adaptive):
    """90% of the rows share one key: the partial aggregate collapses the
    hot key to one row per rank before the exchange."""
    n = 10_000
    rows = [{"k": (7 if i % 10 else i % 97), "v": 1} for i in range(n)]
    plan = L.Aggregate((E.Col("k"),),
                       (E.Col("k"), E.Alias(E.Count(None), "n"),
                        E.Alias(E.Sum(E.Col("v")), "s")), _port_df(rows)._plan)
    got = {r["k"]: (r["n"], r["s"]) for r in
           _executor(8, adaptive).execute_logical(plan).to_pylist()}
    want: dict = {}
    for r in rows:
        c, s = want.get(r["k"], (0, 0))
        want[r["k"]] = (c + 1, s + r["v"])
    assert got == want


@pytest.mark.parametrize("adaptive", [False, True])
def test_skewed_join_completes(adaptive):
    """A 90%-one-key join, every join partitioned, completes on the mesh
    (the skew re-plan and compaction absorb the hot partition)."""
    fact = _port_df([{"k": (1 if i % 10 else i % 50), "v": i}
                     for i in range(5000)])
    dim = _port_df([{"k": i, "w": i * 2} for i in range(50)])
    plan = L.Aggregate(
        (), (E.Alias(E.Count(None), "n"), E.Alias(E.Sum(E.Col("w")), "s")),
        L.Join(fact._plan, dim._plan, "inner", (E.Col("k"),), (E.Col("k"),)))
    ex = _executor(8, adaptive, **{
        BROADCAST_THRESHOLD.key: -1,
        "spark.tpu.adaptive.autoBroadcastJoinThreshold": -1})
    r = ex.execute_logical(plan).to_pylist()[0]
    assert r["n"] == 5000
    assert r["s"] == sum((1 if i % 10 else i % 50) * 2 for i in range(5000))


#: every key type a mesh join takes; the split's hot-key literals carry
#: the key's type
SKEW_KEYS = ("int16", "int32", "int64", "float32", "float64", "bool",
             "string", "date", "timestamp", "decimal")
#: the key types whose skew split the reference runs and gets right: it
#: raises on a timestamp or decimal hot key (ROADMAP C10), and joins
#: float keys by their int64 cast, so 0.5 meets 0.0 (C11)
REF_SKEW_KEYS = ("int64", "string", "date")


def _skew_key(kind, ks, mask=None):
    """The base integers ``ks`` as a key column of type ``kind`` (one key
    value per integer; ``mask`` marks NULLs)."""
    ks = np.asarray(ks, np.int64)
    if kind in ("int16", "int32", "int64"):
        return pa.array(ks.astype(kind), mask=mask)
    if kind in ("float32", "float64"):
        return pa.array((ks * 0.5).astype(kind), mask=mask)
    if kind == "bool":
        return pa.array(ks % 2 == 1, mask=mask)
    if kind == "string":
        return pa.array([f"s{k:03d}" for k in ks], pa.string(), mask=mask)
    if kind == "date":
        return pa.array(ks.astype(np.int32), pa.int32(),
                        mask=mask).cast(pa.date32())
    if kind == "timestamp":  # hours past the epoch
        return pa.array(ks * 3_600_000_000, pa.int64(),
                        mask=mask).cast(pa.timestamp("us"))
    assert kind == "decimal"
    return pa.array([decimal.Decimal(int(k)).scaleb(-2) for k in ks],
                    pa.decimal128(12, 2), mask=mask)


def _skew_tables(kind, how):
    """The skewed fact and its dimension. inner: 8000 rows, 90% on base
    key 1, the rest on 0..399 (n = 8000 and s = 326400 wherever the
    type keeps the 400 keys apart); left: 6000 rows, 80% on base key 7,
    every 97th key NULL, the rest on 0..899 against a dimension of
    0..499."""
    if how == "inner":
        n, hot, spread, mod, wmul, nd = 8000, 1, 10, 400, 2, 400
        mask = None
    else:
        n, hot, spread, mod, wmul, nd = 6000, 7, 5, 900, 3, 500
        mask = np.arange(n) % 97 == 0
    ks = np.array([(hot if i % spread else i % mod) for i in range(n)])
    dk = np.arange(2 if kind == "bool" else nd)
    fact = pa.table({"k": _skew_key(kind, ks, mask),
                     "v": pa.array(np.arange(n), pa.int64())})
    dim = pa.table({"k": _skew_key(kind, dk),
                    "w": pa.array(dk * wmul, pa.int64())})
    return fact, dim


def _join_plan(mod, rel_of, fact, dim, how):
    Lm, Em = mod
    return Lm.Aggregate(
        (), (Em.Alias(Em.Count(None), "n"),
             Em.Alias(Em.Count(Em.Col("w")), "m"),
             Em.Alias(Em.Sum(Em.Col("w")), "s")),
        Lm.Join(rel_of(fact), rel_of(dim), how, (Em.Col("k"),),
                (Em.Col("k"),)))


def _join_host(fact, dim, how):
    """(n, m, s) counted on the host from the tables' Python values (an
    int, a float and a Decimal of one value are one dict key)."""
    w = dict(zip(dim["k"].to_pylist(), dim["w"].to_pylist()))
    hits = [w[k] for k in fact["k"].to_pylist() if k is not None and k in w]
    n = fact.num_rows if how == "left" else len(hits)
    return {"n": n, "m": len(hits), "s": sum(hits)}


def _skew_plan(mod, rel_of, kind, how):
    return _join_plan(mod, rel_of, *_skew_tables(kind, how), how)


def _skew_host(kind, how):
    return _join_host(*_skew_tables(kind, how), how)


@pytest.fixture(scope="module")
def skew_reference():
    """The reference's MeshExecutor(make_mesh(8)) over the split cases it
    runs, once for the file: (how, kind) -> its row."""
    conf = RefConf({BROADCAST_THRESHOLD.key: -1,
                    "spark.tpu.adaptive.autoBroadcastJoinThreshold": -1,
                    "spark.tpu.skewJoin.maxBroadcastBytes": 1,
                    "spark.tpu.skewJoin.minPairs": 1000})
    def rel(t):
        return RL.Relation(ref_from_arrow(t))

    out = {}
    for how in ("inner", "left"):
        for kind in REF_SKEW_KEYS:
            ex = RefMeshExecutor(ref_make_mesh(8), conf=conf)
            out[(how, kind)] = ex.execute_logical(_skew_plan(
                (RL, RE), rel, kind, how)).to_pylist()[0]
    ex = RefMeshExecutor(ref_make_mesh(8), conf=conf)
    out[("left", "date", "inner rows")] = ex.execute_logical(_join_plan(
        (RL, RE), rel, *_skew_tables("date", "inner"),
        "left")).to_pylist()[0]
    return out


def _split_executor(adaptive, **over):
    return _executor(8, adaptive, **{
        BROADCAST_THRESHOLD.key: -1,
        "spark.tpu.adaptive.autoBroadcastJoinThreshold": -1,
        "spark.tpu.skewJoin.maxBroadcastBytes": 1,  # no demotion
        "spark.tpu.skewJoin.minPairs": 1000, **over})


def _check_split(kind, how, adaptive, skew_reference):
    """The split runs (a ``skew_join_split`` event with a hot key) and its
    row equals the host count, the reference's where it runs the type,
    and the skew-off mesh run's where the reference raises (C10)."""
    plan = _skew_plan((L, E), lambda t: L.Relation(from_arrow(
        t, device="cpu")), kind, how)
    ex = _split_executor(adaptive)
    r = ex.execute_logical(plan).to_pylist()[0]
    evs = [e for e in ex.last_run["events"] if e["kind"] == "skew_join_split"]
    assert evs and evs[-1]["hot_keys"] >= 1
    assert r == _skew_host(kind, how)
    # the branches' matched pairs add up to the join's
    (br,) = [e for e in ex.last_run["events"]
             if e["kind"] == "skew_join_branches"]
    assert br["hot_pairs"] + br["rest_pairs"] == r["m"]
    assert br["hot_pairs"] > br["rest_pairs"] > 0
    if kind in REF_SKEW_KEYS:
        assert r == skew_reference[(how, kind)]
    if kind in ("timestamp", "decimal"):
        off = _split_executor(adaptive, **{
            "spark.tpu.skewJoin.minPairs": 1 << 40})
        assert off.execute_logical(plan).to_pylist()[0] == r
        assert not [e for e in off.last_run["events"]
                    if e["kind"] == "skew_join_split"]
    return r


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("kind", SKEW_KEYS)
def test_skewed_join_split_non_broadcastable(kind, adaptive,
                                             skew_reference):
    """A build side over the skew re-plan's broadcast limit: the join
    splits around the hot key (hot probe rows stay where they are against
    a broadcast of only the hot build rows), for every key type."""
    r = _check_split(kind, "inner", adaptive, skew_reference)
    if kind != "bool":
        assert (r["n"], r["s"]) == (8000, 326400)


@pytest.mark.parametrize("adaptive", [False, True])
def test_date_skew_split_left_join_of_the_inner_rows(adaptive,
                                                     skew_reference):
    """ROADMAP C9's rows as a left join: every fact row finds its date,
    so n = 8000 and s = 326400, as on the reference."""
    plan = _join_plan((L, E), lambda t: L.Relation(from_arrow(
        t, device="cpu")), *_skew_tables("date", "inner"), "left")
    ex = _split_executor(adaptive)
    r = ex.execute_logical(plan).to_pylist()[0]
    assert [e for e in ex.last_run["events"]
            if e["kind"] == "skew_join_split"]
    assert r == {"n": 8000, "m": 8000, "s": 326400}
    assert r == skew_reference[("left", "date", "inner rows")]


def _typed(kind, values):
    """Exact values (Decimals) as a key column of ``kind``."""
    if kind.startswith("float"):
        return pa.array([float(v) for v in values], kind)
    if kind == "int64":
        return pa.array([int(v) for v in values], pa.int64())
    scale = {"decimal": 2, "decimal3": 3}[kind]
    return pa.array(values, pa.decimal128(10 + scale, scale))


@pytest.mark.parametrize("kinds,step", [
    (("float32", "float64"), "0.5"), (("float64", "int64"), "1"),
    (("decimal", "int64"), "1"), (("decimal", "decimal3"), "0.01"),
    (("decimal", "float64"), "0.5")])
def test_join_keys_meet_across_types(kinds, step):
    """Keys of two types meet where their values are equal (ROADMAP C11):
    a float by its value, not its int64 cast, and an integer, a decimal
    and a float of one value alike, on one device and split on the mesh.
    The values are the skew cases' base keys times ``step``."""
    kind, dim_kind = kinds
    ks = [(1 if i % 10 else i % 400) for i in range(8000)]
    unit = decimal.Decimal(step)
    fact = pa.table({"k": _typed(kind, [k * unit for k in ks])})
    dim = pa.table({"k": _typed(dim_kind, [k * unit for k in range(400)]),
                    "w": pa.array(np.arange(400) * 2, pa.int64())})
    plan = _join_plan((L, E), lambda t: L.Relation(from_arrow(
        t, device="cpu")), fact, dim, "inner")
    want = _join_host(fact, dim, "inner")
    assert (want["n"], want["s"]) == (8000, 326400)
    assert execute_logical(plan, device="cpu").to_pylist()[0] == want
    ex = _split_executor(True)
    assert ex.execute_logical(plan).to_pylist()[0] == want
    assert [e for e in ex.last_run["events"]
            if e["kind"] == "skew_join_split"]


def test_float_keys_meet_nan_and_signed_zero():
    """Float keys meet by value as Spark's do: -0.0 meets 0.0 and a NaN
    meets a NaN of another payload, on one device and through the mesh's
    hash exchange; 0.5 meets nothing."""
    other_nan = np.array([0x7FF8000000000001], np.int64).view(np.float64)[0]
    fact = pa.table({"k": pa.array([np.nan, -0.0, 0.0, 1.5, 0.5] * 40,
                                   pa.float64())})
    dim = pa.table({"k": pa.array([other_nan, 0.0, 1.5, 1.0], pa.float64()),
                    "w": pa.array([1, 10, 100, 1000], pa.int64())})
    plan = _join_plan((L, E), lambda t: L.Relation(from_arrow(
        t, device="cpu")), fact, dim, "inner")
    want = {"n": 160, "m": 160, "s": 40 * (1 + 10 + 10 + 100)}
    assert execute_logical(plan, device="cpu").to_pylist()[0] == want
    assert _executor(8, False, **{
        BROADCAST_THRESHOLD.key: -1}).execute_logical(
            plan).to_pylist()[0] == want


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("kind", SKEW_KEYS)
def test_skewed_left_join_split_parity(kind, adaptive, skew_reference):
    """The split keeps left-outer semantics: unmatched and NULL probe keys
    survive through the rest branch."""
    r = _check_split(kind, "left", adaptive, skew_reference)
    assert r["n"] == 6000 and r["m"] < r["n"]


@pytest.mark.parametrize("devices", RANKS)
def test_hybrid_device_sweep_byte_identity(tmp_path, devices):
    """``find_chunkable`` routes to the hybrid hash join and its result
    over the mesh equals a host oracle exactly at 1, 2 and 8 ranks (the
    per-bucket feeds run on whatever engine ``run_fn`` wraps)."""
    from spark_tpu_torch.physical.chunked import (_HybridHashJoinAgg,
                                                  execute_chunked,
                                                  find_chunkable)
    from spark_tpu_torch.plan.optimizer import optimize

    rng = np.random.default_rng(43)
    n = 20_000
    fact = pa.table({"k": pa.array(rng.integers(0, 500, n), pa.int64()),
                     "v": pa.array(rng.integers(0, 100, n), pa.int64())})
    dim = pa.table({"dk": pa.array(np.arange(100) * 10, pa.int64()),
                    "w": pa.array(np.arange(100) * 2, pa.int64())})
    fp, dp = str(tmp_path / "dsf.parquet"), str(tmp_path / "dsd.parquet")
    pq.write_table(fact, fp)
    pq.write_table(dim, dp)
    spark = PortSession(device="cpu")
    spark.read.parquet(fp).createOrReplaceTempView("ds_fact")
    spark.read.parquet(dp).createOrReplaceTempView("ds_dim")
    wmap = dict(zip(dim["dk"].to_pylist(), dim["w"].to_pylist()))
    hits = [v * wmap[k] for k, v in zip(fact["k"].to_pylist(),
                                         fact["v"].to_pylist()) if k in wmap]
    df = spark.sql("select sum(v * w) as s, count(*) as n "
                   "from ds_fact join ds_dim on k = dk")
    conf = RuntimeConf()
    conf.set("spark.tpu.maxDeviceBatchBytes", 1024)
    conf.set("spark.tpu.chunkRows", 16_384)
    conf.set("spark.tpu.join.hybrid.partitionsMax", 4)
    found = find_chunkable(optimize(df._plan, conf), conf)
    assert isinstance(found, _HybridHashJoinAgg)
    ex = _executor(devices, False)
    out = execute_chunked(found, conf, lambda p: ex.execute_logical(p),
                          "cpu")
    row = out.to_pylist()[0]
    assert (row["s"], row["n"]) == (sum(hits), len(hits))


def test_mesh_session_runs_the_chunked_tier(tmp_path):
    """A mesh session's queries go through the degradation ladder: a scan
    past the device budget runs chunked, its chunks on the mesh, with the
    resident rows."""
    from spark_tpu_torch.physical import chunked

    rng = np.random.default_rng(44)
    n = 50_000
    pq.write_table(pa.table({
        "k": pa.array(rng.integers(0, 100, n), pa.int64()),
        "v": pa.array(rng.integers(0, 1000, n), pa.int64())}),
        str(tmp_path / "big.parquet"))
    prev = PortSession._active
    spark = (PortSession.builder.device("cpu").master("mesh[2]")
             .meshDevices(["cpu"] * 2).getOrCreate())
    try:
        df = spark.read.parquet(str(tmp_path / "big.parquet")) \
            .groupBy("k").agg(PF.sum("v").alias("s")).orderBy("k")
        want = [tuple(r) for r in df.collect()]
        spark.conf.set("spark.tpu.maxDeviceBatchBytes", 1024)
        spark.conf.set("spark.tpu.chunkRows", 16_384)
        got = [tuple(r) for r in df.collect()]
        assert chunked.last_run["chunks"] >= 2
        assert spark.mesh_executor.last_run["stages"]
        assert got == want
    finally:
        PortSession._active = prev


def test_measured_bytes_feed_admission(mesh_session):
    """A mesh query's largest stage_bytes event is noted for its plan,
    and admission's estimate of the plan is that measurement."""
    from spark_tpu_torch.scheduler import admission

    rng = np.random.default_rng(42)
    mesh_session.createDataFrame(pa.table({
        "k": pa.array(rng.integers(0, 50, 4000), pa.int64()),
        "v": pa.array(rng.integers(0, 1000, 4000), pa.int64())})) \
        .createOrReplaceTempView("aqe_adm")
    df = mesh_session.sql(
        "SELECT k, sum(v) s FROM aqe_adm GROUP BY k ORDER BY k")
    df.collect()
    measured = admission.measured_plan_bytes(df._plan)
    assert measured is not None and measured > 0
    assert admission.estimate_plan_bytes(df._plan, mesh_session.conf) \
        == max(admission.MIN_ESTIMATE_BYTES, measured)
