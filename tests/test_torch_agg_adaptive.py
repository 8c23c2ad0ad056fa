"""The port's runtime-adaptive aggregation over the mesh
(``spark_tpu_torch/parallel/executor.py`` ``_adaptive_aggregate``) on the
CPU: the cases of tests/test_agg_adaptive.py that need no A12 tier.

- Every strategy (partial, bypass, hash, sort, presplit, and auto), and
  auto with fusion on, gives the adaptive-off run's rows exactly, at 1,
  2 and 8 ranks, on the reference's four datasets, string keys and a
  compound string key.
- ``auto`` picks what the reference's ``MeshExecutor`` picks on the same
  numpy-seeded tables at the same rank count, with the same NDV estimate,
  rows, domain and hot-key count (the sketches are bit for bit the
  reference's); its rows equal the reference's. The reference's runs sit
  in one module fixture.
- The crossover's boundary cells, the float pin, the forced fallbacks,
  the sketch's accuracy and the empty input.

The fault-injection cases (``agg.strategy``, ``agg.presplit``) and the
aggregation profile wait for the port's A12 tiers (ROADMAP).
"""

import numpy as np
import pyarrow as pa
import pytest

import spark_tpu.expr.expressions as RE
import spark_tpu.plan.logical as RL
import spark_tpu_torch.expr.expressions as E
import spark_tpu_torch.plan.logical as L
from spark_tpu import metrics as ref_metrics
from spark_tpu.columnar.arrow import from_arrow as ref_from_arrow
from spark_tpu.conf import RuntimeConf as RefConf
from spark_tpu.parallel.executor import MeshExecutor as RefMeshExecutor
from spark_tpu.parallel.mesh import make_mesh as ref_make_mesh
from spark_tpu_torch.columnar.arrow import from_arrow
from spark_tpu_torch.conf import RuntimeConf
from spark_tpu_torch.parallel.executor import MeshExecutor
from spark_tpu_torch.parallel.mesh import make_mesh

from test_torch_threads import one_torch_thread  # noqa: F401

RANKS = (1, 2, 8)
STRATEGIES = ("auto", "partial", "bypass", "hash", "sort", "presplit")
#: presplit thresholds low enough that the hot dataset pre-splits at 8
PRESPLIT = {"spark.tpu.adaptive.agg.presplitMinRows": 64,
            "spark.tpu.adaptive.agg.presplitFactor": 2}


def _executor(d, adaptive, **overrides):
    conf = RuntimeConf({"spark.tpu.adaptive.enabled": bool(adaptive),
                        **overrides})
    return MeshExecutor(make_mesh(d, devices=["cpu"] * d), conf=conf)


def _rows(batch):
    return [tuple(r.values()) for r in batch.to_pylist()]


def _arrow(keys, vals):
    return pa.table({"k": pa.array(np.asarray(keys, np.int64), pa.int64()),
                     "v": pa.array(np.asarray(vals, np.int64), pa.int64())})


def _dataset(dist, n=3000):
    """The reference suite's datasets, made from numpy seeds."""
    rng = np.random.default_rng({"uniform": 1, "skewed": 2, "hot": 3,
                                 "distinct": 4}[dist])
    if dist == "uniform":
        keys = rng.integers(0, 50, n)          # low NDV, small domain
    elif dist == "skewed":
        keys = np.where(rng.random(n) < 0.9, 7, rng.integers(0, 5000, n))
    elif dist == "hot":
        # one heavy hitter over a near-distinct huge-domain tail
        keys = np.where(np.arange(n) % 3 == 0, 7,
                        np.arange(n, dtype=np.int64) * 1_000_003)
    else:
        keys = np.arange(n)
    return _arrow(keys, rng.integers(0, 1000, n))


def _agg_plan(mod, rel, value_col="v"):
    """A group-by with every strategy-legal accumulator class, sorted."""
    Lm, Em = mod
    v = Em.Col(value_col)
    return Lm.Sort((Em.SortOrder(Em.Col("k")),), Lm.Aggregate(
        (Em.Col("k"),),
        (Em.Col("k"), Em.Alias(Em.Sum(v), "s"), Em.Alias(Em.Count(v), "n"),
         Em.Alias(Em.Min(v), "mn"), Em.Alias(Em.Max(v), "mx")), rel))


def _float_plan(mod, rel):
    Lm, Em = mod
    return Lm.Sort((Em.SortOrder(Em.Col("k")),), Lm.Aggregate(
        (Em.Col("k"),), (Em.Col("k"), Em.Alias(Em.Sum(Em.Col("f")), "fs")),
        rel))


def _count_plan(mod, rel):
    Lm, Em = mod
    return Lm.Sort((Em.SortOrder(Em.Col("k")),), Lm.Aggregate(
        (Em.Col("k"),), (Em.Col("k"), Em.Alias(Em.Count(Em.Col("v")), "n")),
        rel))


def _wide_table():
    # mid ratio and a domain past the hash limit: neither bypass nor hash
    rng = np.random.default_rng(5)
    n = 3000
    keys = rng.integers(0, 1 << 30, n) * 2
    keys[n // 2:] = keys[: n - n // 2]     # about 50% duplication
    return _arrow(keys, rng.integers(0, 1000, n))


def _float_sum_table():
    rng = np.random.default_rng(6)
    n = 2000
    return pa.table({"k": pa.array(np.arange(n), pa.int64()),
                     "f": pa.array(rng.random(n), pa.float64())})


def _float_key_table():
    rng = np.random.default_rng(7)
    n = 1000
    return pa.table({
        "k": pa.array(rng.integers(0, 20, n).astype(np.float64),
                      pa.float64()),
        "v": pa.array(rng.integers(0, 100, n), pa.int64())})


def _ndv_table():
    rng = np.random.default_rng(8)
    return _arrow(rng.integers(0, 200, 4000), rng.integers(0, 1000, 4000))


#: the reference's auto-mode cells: name -> (table, plan maker, ranks,
#: settings, the strategy and mode the reference suite asserts)
CELLS = {
    "bypass_all_distinct": (lambda: _dataset("distinct"), _agg_plan, 2, {},
                            ("bypass", "auto")),
    "hash_small_domain": (lambda: _dataset("uniform"), _agg_plan, 2, {},
                          ("hash", "auto")),
    "partial_wide_domain": (_wide_table, _agg_plan, 2,
                            {"spark.tpu.adaptive.agg.bypassNdvRatio": 0.9},
                            ("partial", "auto")),
    "sort_huge_domain": (
        lambda: _arrow(np.arange(3000, dtype=np.int64) * 1_000_003,
                       np.random.default_rng(9).integers(0, 1000, 3000)),
        _agg_plan, 2, {}, ("sort", "auto")),
    "presplit_hot_key": (lambda: _dataset("hot"), _agg_plan, 8, PRESPLIT,
                         ("presplit", "auto")),
    "partial_low_ndv_skew": (lambda: _dataset("skewed"), _agg_plan, 8,
                             {"spark.tpu.adaptive.agg.presplitMinRows": 64},
                             ("partial", "auto")),
    "forced_presplit_no_hot_keys": (
        lambda: _dataset("uniform"), _agg_plan, 2,
        {"spark.tpu.adaptive.agg.strategy": "presplit"},
        ("partial", "forced")),
    "float_sum_pinned": (_float_sum_table, _float_plan, 2,
                         {"spark.tpu.adaptive.agg.strategy": "bypass"},
                         ("partial", "pinned")),
    "forced_hash_float_keys": (_float_key_table, _count_plan, 2,
                               {"spark.tpu.adaptive.agg.strategy": "hash"},
                               ("partial", "forced")),
    "sketch_ndv": (_ndv_table, _agg_plan, 2,
                   {"spark.tpu.adaptive.agg.hashDomainLimit": 16}, None),
    "empty": (lambda: _arrow(np.array([], np.int64), np.array([], np.int64)),
              _agg_plan, 2, {}, ("partial", "auto")),
}

#: the decision fields held against the reference's event
FIELDS = ("strategy", "mode", "ndv", "rows", "ratio", "domain", "devices",
          "hot_keys")


@pytest.fixture(scope="module")
def reference():
    """The reference's adaptive ``MeshExecutor`` on every cell and on the
    sweep's four datasets at 8 devices: rows and its last ``agg`` event,
    once for the file."""
    out = {}

    def run(table, make_plan, d, over):
        ex = RefMeshExecutor(ref_make_mesh(d), conf=RefConf(
            {"spark.tpu.adaptive.enabled": True, **over}))
        rows = _rows(ex.execute_logical(make_plan(
            (RL, RE), RL.Relation(ref_from_arrow(table)))))
        ev = [e for e in ref_metrics.recent(4096) if e.get("kind") == "agg"]
        return rows, ev[-1]

    for name, (make, make_plan, d, over, _) in CELLS.items():
        out[name] = run(make(), make_plan, d, over)
    for dist in ("uniform", "skewed", "distinct", "hot"):
        out[f"sweep_{dist}"] = run(_dataset(dist), _agg_plan, 8, PRESPLIT)
    return out


def _port_run(table, make_plan, d, adaptive, **over):
    ex = _executor(d, adaptive, **over)
    rows = _rows(ex.execute_logical(make_plan(
        (L, E), L.Relation(from_arrow(table, device="cpu")))))
    agg = [e for e in ex.last_run["events"] if e["kind"] == "agg"]
    return rows, (agg[-1] if agg else None), ex.last_run


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(a, float) and isinstance(b, float):
                assert a == pytest.approx(b, rel=1e-9, abs=1e-12)
            else:
                assert a == b


# ---- byte identity across the whole sweep -----------------------------------


@pytest.mark.parametrize("devices", RANKS)
@pytest.mark.parametrize("dist", ["uniform", "skewed", "distinct", "hot"])
def test_byte_identity_strategy_sweep(devices, dist, reference):
    table = _dataset(dist)
    off, _, _ = _port_run(table, _agg_plan, devices, False)
    for strategy in STRATEGIES:
        on, ev, _ = _port_run(table, _agg_plan, devices, True,
                              **{"spark.tpu.adaptive.agg.strategy": strategy,
                                 **PRESPLIT})
        assert on == off, (devices, dist, strategy)
        assert ev is not None and ev["devices"] == devices
    fused, _, _ = _port_run(table, _agg_plan, devices, True, **{
        "spark.tpu.fusion.enabled": True, **PRESPLIT})
    assert fused == off
    # and the reference's adaptive rows at 8 devices
    assert off == reference[f"sweep_{dist}"][0]


def test_byte_identity_string_keys():
    rng = np.random.default_rng(10)
    n = 2000
    words = [f"key-{i}" for i in range(40)]
    table = pa.table({
        "k": pa.array([words[i] for i in rng.integers(0, len(words), n)],
                      pa.string()),
        "v": pa.array(rng.integers(0, 1000, n), pa.int64())})
    off, _, _ = _port_run(table, _agg_plan, 2, False)
    for strategy in STRATEGIES:
        on, _, _ = _port_run(table, _agg_plan, 2, True, **{
            "spark.tpu.adaptive.agg.strategy": strategy})
        assert on == off, strategy


def _compound_plan(mod, rel):
    Lm, Em = mod
    v = Em.Col("v")
    return Lm.Sort(
        (Em.SortOrder(Em.Col("k")), Em.SortOrder(Em.Col("s"))),
        Lm.Aggregate((Em.Col("k"), Em.Col("s")),
                     (Em.Col("k"), Em.Col("s"), Em.Alias(Em.Sum(v), "sv"),
                      Em.Alias(Em.Count(v), "n")), rel))


def test_byte_identity_compound_string_key():
    # an int key beside a string key defeats the static direct path, so
    # a string key rides through every strategy, the sort rung included
    # (whose output must not claim a global string order)
    rng = np.random.default_rng(11)
    n = 2000
    table = pa.table({
        "k": pa.array(np.arange(n, dtype=np.int64) * 1_000_003, pa.int64()),
        "s": pa.array([f"w{i % 37}" for i in range(n)], pa.string()),
        "v": pa.array(rng.integers(0, 1000, n), pa.int64())})
    off, _, _ = _port_run(table, _compound_plan, 2, False)
    for strategy in STRATEGIES:
        on, _, _ = _port_run(table, _compound_plan, 2, True, **{
            "spark.tpu.adaptive.agg.strategy": strategy})
        assert on == off, strategy


# ---- the picks equal the reference's ----------------------------------------


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_picks_and_rows_match_reference(cell, reference):
    make, make_plan, d, over, want = CELLS[cell]
    table = make()
    ref_rows, ref_ev = reference[cell]
    on, ev, _ = _port_run(table, make_plan, d, True, **over)
    off, _, _ = _port_run(table, make_plan, d, False)
    assert on == off
    _same(on, ref_rows)
    assert {f: ev[f] for f in FIELDS} == {f: ref_ev[f] for f in FIELDS}
    if want is not None:
        assert (ev["strategy"], ev["mode"]) == want


def test_auto_picks_bypass_on_all_distinct():
    on, ev, _ = _port_run(_dataset("distinct"), _agg_plan, 2, True)
    assert ev["strategy"] == "bypass" and ev["mode"] == "auto"
    assert ev["ratio"] >= 0.5


def test_auto_picks_hash_on_small_domain():
    got, ev, _ = _port_run(_dataset("uniform"), _agg_plan, 2, True)
    assert ev["strategy"] == "hash" and ev["mode"] == "auto"
    assert 0 < ev["domain"] <= 1024
    assert len(got) == len({r[0] for r in got})


def test_auto_picks_sort_on_huge_domain_and_elides_the_sort():
    table = CELLS["sort_huge_domain"][0]()
    off, _, _ = _port_run(table, _agg_plan, 2, False)
    on, ev, run = _port_run(table, _agg_plan, 2, True)
    assert on == off
    assert ev["strategy"] == "sort" and ev["mode"] == "auto"
    assert ev["ratio"] >= 0.5 and ev["domain"] > (1 << 20)
    elided = [e for e in run["events"] if e["kind"] == "aqe"
              and e["decision"] == "sort_elide"]
    assert len(elided) == 1


def test_auto_picks_presplit_on_hot_key():
    table = _dataset("hot")
    off, _, _ = _port_run(table, _agg_plan, 8, False)
    on, ev, run = _port_run(table, _agg_plan, 8, True, **PRESPLIT)
    assert on == off
    assert ev["strategy"] == "presplit" and ev["mode"] == "auto"
    assert ev["hot_keys"] >= 1
    # the salted exchange, the merged partials' exchange, the sort's
    assert [e["op"] for e in run["events"]
            if e["kind"] == "exchange"] == ["hash", "hash", "range"]


def test_auto_keeps_partial_on_low_ndv_skew():
    _, ev, _ = _port_run(_dataset("skewed"), _agg_plan, 8, True, **{
        "spark.tpu.adaptive.agg.presplitMinRows": 64})
    assert ev["strategy"] == "partial" and ev["mode"] == "auto"
    assert ev["hot_keys"] >= 1  # detected, deliberately not acted on


def test_strategy_crossover_boundary_cells():
    """The crossover pinned at the settings' documented boundaries, and
    equal to the reference's function on every cell."""
    from spark_tpu.analysis.legality import strategy_crossover as ref_cross
    from spark_tpu_torch.analysis.legality import strategy_crossover

    bypass_r, hash_w, sort_w = 0.5, 1024, 1 << 20

    def cell(ratio, width):
        got = strategy_crossover(ratio, width, bypass_r, hash_w, sort_w)
        assert got == ref_cross(ratio, width, bypass_r, hash_w, sort_w)
        return got

    assert cell(0.1, 100) == "hash"
    assert cell(0.1, hash_w + 1) == "partial"
    assert cell(0.9, sort_w) == "bypass"
    assert cell(0.9, sort_w + 1) == "sort"
    assert cell(bypass_r, sort_w) == "bypass"
    assert cell(float(np.nextafter(bypass_r, 0)), 100) == "hash"
    assert cell(0.9, hash_w) == "bypass"
    assert cell(0.1, hash_w) == "hash"
    assert cell(0.9, -1) == "sort"
    assert cell(0.1, -1) == "partial"


def test_float_sum_pins_to_partial():
    table = _float_sum_table()
    off, _, _ = _port_run(table, _float_plan, 2, False)
    on, ev, _ = _port_run(table, _float_plan, 2, True, **{
        "spark.tpu.adaptive.agg.strategy": "bypass"})
    assert on == off
    assert ev["strategy"] == "partial" and ev["mode"] == "pinned"


def test_forced_hash_falls_back_without_key_stats():
    table = _float_key_table()
    off, _, _ = _port_run(table, _count_plan, 2, False)
    on, ev, _ = _port_run(table, _count_plan, 2, True, **{
        "spark.tpu.adaptive.agg.strategy": "hash"})
    assert on == off
    assert ev["strategy"] == "partial" and ev["mode"] == "forced"


def test_forced_presplit_degrades_without_hot_keys():
    table = _dataset("uniform")
    off, _, _ = _port_run(table, _agg_plan, 2, False)
    on, ev, _ = _port_run(table, _agg_plan, 2, True, **{
        "spark.tpu.adaptive.agg.strategy": "presplit"})
    assert on == off
    assert ev["strategy"] == "partial" and ev["mode"] == "forced"


def test_adaptive_agg_off_keeps_the_static_pair():
    table = _dataset("distinct")
    off, _, _ = _port_run(table, _agg_plan, 2, False)
    on, ev, run = _port_run(table, _agg_plan, 2, True, **{
        "spark.tpu.adaptive.agg.enabled": False})
    assert on == off and ev is None
    assert any(e["kind"] == "exchange" for e in run["events"])


# ---- the sketch -------------------------------------------------------------


@pytest.mark.parametrize("true_ndv", [10, 100, 1000, 5000])
def test_hll_estimate_accuracy(true_ndv):
    """The port's estimator over the register construction the stats
    stage uses: 512 registers give 1.04/sqrt(512) = 4.6% standard error;
    bound at 4 sigma, and equal to the reference's estimator."""
    from spark_tpu.sketch import hll_estimate as ref_estimate

    rng = np.random.default_rng(true_ndv)
    m, p = 512, 9
    h = ((rng.integers(0, 1 << 32, true_ndv, dtype=np.uint64)
          << np.uint64(32))
         | rng.integers(0, 1 << 32, true_ndv, dtype=np.uint64))
    idx = (h & np.uint64(m - 1)).astype(np.int64)
    w = h >> np.uint64(p)
    nbits = 64 - p
    rho = np.where(w == 0, nbits + 1,
                   nbits - np.floor(np.log2(np.maximum(
                       w.astype(np.float64), 1.0))))
    regs = np.zeros(m, dtype=np.int64)
    np.maximum.at(regs, idx, rho.astype(np.int64))
    est = MeshExecutor._hll_estimate(regs)
    assert est == ref_estimate(regs)
    assert abs(est - true_ndv) <= max(4, 4 * 1.04 / np.sqrt(m) * true_ndv)


def test_sketch_ndv_end_to_end():
    _, ev, _ = _port_run(_ndv_table(), _agg_plan, 2, True, **{
        "spark.tpu.adaptive.agg.hashDomainLimit": 16})
    assert ev["rows"] == 4000
    assert abs(ev["ndv"] - 200) <= 0.25 * 200


def test_empty_input_defaults_to_partial():
    got, ev, _ = _port_run(CELLS["empty"][0](), _agg_plan, 2, True)
    assert got == []
    assert ev["strategy"] == "partial" and ev["rows"] == 0
