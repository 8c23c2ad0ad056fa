"""The port's static plan analyzer (``spark_tpu_torch/analysis/``) on the
inputs of tests/test_analysis.py.

Held against the reference: the diagnostic codes ``analyze`` gives the
same SQL over the same small TPC-H tables (it runs no query in either
package), the materialized-view candidacy codes (PLAN-MVIEW-*)
included.
Held against the port itself: no TPC-H query has an error-level
diagnostic, each seeded defect gets its own code, the gate is off by
default and rejects at level=error, the oracle's widths and capacities,
the hazards detector, ``explain(mode="lint")`` and ``/api/v1/lint``. The
invariant linter (tools/lint_invariants.py) keeps scanning the reference
package; the connect server's lint endpoint is in tests/test_torch_connect.py.
"""

import json
import urllib.request

import numpy as np
import pandas as pd
import pytest

from spark_tpu import analysis as RA
from spark_tpu.tpch.gen import generate_tables as ref_tables
from spark_tpu.tpch.gen import register_views as ref_register
from spark_tpu.tpch.queries import QUERIES as REF_QUERIES
from spark_tpu_torch import analysis, metrics
from spark_tpu_torch import conf as CF
from spark_tpu_torch.analysis import legality, oracle
from spark_tpu_torch.api import functions as F
from spark_tpu_torch.api.session import SparkSession
from spark_tpu_torch.expr import expressions as E
from spark_tpu_torch.tpch import QUERIES, generate_tables, register_views

from test_torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.timeout(180)

SF = 0.01


@pytest.fixture(scope="module")
def port():
    s = SparkSession(device="cpu")
    register_views(s, generate_tables(SF, seed=99))
    return s


@pytest.fixture(scope="module")
def ref(spark):
    ref_register(spark, ref_tables(SF, seed=99))
    return spark


@pytest.fixture()
def aconf(port):
    keys = (CF.ANALYSIS_LEVEL.key, CF.ANALYSIS_ERROR_CODES.key,
            CF.ANALYSIS_DIVERGENCE_FACTOR.key)
    yield port.conf
    for k in keys:
        port.conf.unset(k)


def _codes(report):
    return sorted(report.codes())


@pytest.mark.parametrize("qnum", sorted(QUERIES))
def test_tpch_codes_match_reference(port, ref, qnum):
    mine = analysis.analyze(port.sql(QUERIES[qnum])._plan, port.conf)
    theirs = RA.analyze(ref.sql(REF_QUERIES[qnum])._plan, ref.conf)
    assert _codes(mine) == _codes(theirs), (mine.format(), theirs.format())
    assert mine.node_count > 0 and mine.peak_bytes > 0
    assert "PLAN-ANALYZE-FAIL" not in mine.codes(), mine.format()
    assert not mine.errors(), mine.format()
    assert mine.fingerprint_stable == theirs.fingerprint_stable


def test_tpch_error_gate_admits_all_queries(port, aconf):
    aconf.set(CF.ANALYSIS_LEVEL.key, "error")
    for qnum in sorted(QUERIES):
        assert analysis.maybe_gate(port.sql(QUERIES[qnum])._plan,
                                   aconf) is not None


_SEEDED = {
    "shape": lambda s: s.range(0, 12345),
    "f64": lambda s: s.range(0, 64).selectExpr("id * 1.5 AS x"),
    "floatsum": lambda s: s.createDataFrame(pd.DataFrame({
        "k": np.arange(64) % 4,
        "v": np.linspace(0.0, 1.0, 64)})).groupBy("k").agg(F.sum("v")),
    "stable": lambda s: s.createDataFrame(pd.DataFrame({
        "a": np.arange(16), "b": np.arange(16.0)})).select("a", "b"),
    "distinct": lambda s: s.createDataFrame(pd.DataFrame({
        "k": np.arange(64) % 4, "v": np.arange(64)})).groupBy("k").agg(
        F.countDistinct("v")),
    "repartition": lambda s: s.range(0, 64).repartition(7),
    "limit": lambda s: s.range(0, 64).filter("id > 3").limit(5),
}


@pytest.mark.parametrize("name", sorted(_SEEDED))
@pytest.mark.parametrize("intent", [None, "skew_split"])
def test_seeded_plans_codes_match_reference(port, spark, name, intent):
    """Each seeded plan, built the same way through both packages'
    DataFrame APIs, gets the same codes at the same levels."""
    from spark_tpu.api import functions as RF

    mine = analysis.analyze(_SEEDED[name](port)._plan, port.conf,
                            intent=intent)
    ref_builders = {
        "shape": lambda s: s.range(0, 12345),
        "f64": lambda s: s.range(0, 64).selectExpr("id * 1.5 AS x"),
        "floatsum": lambda s: s.createDataFrame(pd.DataFrame({
            "k": np.arange(64) % 4,
            "v": np.linspace(0.0, 1.0, 64)})).groupBy("k").agg(
            RF.sum("v")),
        "stable": lambda s: s.createDataFrame(pd.DataFrame({
            "a": np.arange(16), "b": np.arange(16.0)})).select("a", "b"),
        "distinct": lambda s: s.createDataFrame(pd.DataFrame({
            "k": np.arange(64) % 4, "v": np.arange(64)})).groupBy("k").agg(
            RF.countDistinct("v")),
        "repartition": lambda s: s.range(0, 64).repartition(7),
        "limit": lambda s: s.range(0, 64).filter("id > 3").limit(5),
    }
    theirs = RA.analyze(ref_builders[name](spark)._plan, spark.conf,
                        intent=intent)

    def levels(r):
        return sorted((d.code, d.level) for d in r.diagnostics)

    assert levels(mine) == levels(theirs), (mine.format(), theirs.format())
    assert mine.fingerprint_stable == theirs.fingerprint_stable


def test_seeded_defects_flagged_with_distinct_codes(port):
    shape = analysis.analyze(_SEEDED["shape"](port)._plan, port.conf)
    assert "PLAN-RECOMPILE-SHAPE" in shape.codes()
    assert not shape.fingerprint_stable
    assert "Range" in next(d.node for d in shape.diagnostics
                           if d.code == "PLAN-RECOMPILE-SHAPE")
    f64 = analysis.analyze(_SEEDED["f64"](port)._plan, port.conf)
    assert "PLAN-DTYPE-F64" in f64.codes()
    fs = _SEEDED["floatsum"](port)._plan
    strict = analysis.analyze(fs, port.conf, intent="skew_split")
    assert any(d.code == "PLAN-MERGE-FLOATSUM" and d.level == "error"
               for d in strict.diagnostics)
    assert not analysis.analyze(fs, port.conf).errors()


def test_aval_cross_check_agrees_with_physical_planner(port):
    """PLAN-AVAL-MISMATCH never fires on the port's own plans: the
    oracle's root schema is the physical planner's."""
    for qnum in (1, 3, 13, 18):
        r = analysis.analyze(port.sql(QUERIES[qnum])._plan, port.conf)
        assert "PLAN-AVAL-MISMATCH" not in r.codes()


def test_gate_off_by_default(port):
    assert port.conf.get(CF.ANALYSIS_LEVEL) == "off"
    assert analysis.maybe_gate(port.range(0, 8)._plan, port.conf) is None


def test_gate_error_codes_escalation_rejects_collect(port, aconf):
    aconf.set(CF.ANALYSIS_LEVEL.key, "error")
    aconf.set(CF.ANALYSIS_ERROR_CODES.key, "PLAN-RECOMPILE-SHAPE")
    df = port.range(0, 999)
    before = metrics.analysis_stats()["gated"]
    with pytest.raises(analysis.PlanAnalysisError) as ei:
        df.collect()
    assert any(d.code == "PLAN-RECOMPILE-SHAPE" for d in ei.value.errors)
    assert ei.value.report.node_count > 0
    assert metrics.analysis_stats()["gated"] == before + 1
    aconf.set(CF.ANALYSIS_LEVEL.key, "warn")
    assert len(df.collect()) == 999
    spans = {e["name"] for e in metrics.last_query() if e["kind"] == "span"}
    assert "query.analysis" in spans
    assert any(e["kind"] == "analysis" for e in metrics.last_query())


def test_gate_records_metrics(port):
    before = metrics.analysis_stats()
    analysis.analyze(port.range(0, 16)._plan, port.conf)
    assert metrics.analysis_stats()["runs"] == before["runs"] + 1
    assert "analysis.elapsed_ms" in metrics.gauges()
    assert analysis.recent_reports(1)[0].node_count > 0


def test_explain_lint_mode(port, capsys):
    port.range(0, 32).explain(mode="lint")
    out = capsys.readouterr().out
    assert "== Plan Analysis ==" in out and "PLAN-RECOMPILE-SHAPE" in out


def test_analyzer_never_raises():
    class Broken:
        def node_string(self):
            raise RuntimeError("boom")

    r = analysis.analyze(Broken(), CF.RuntimeConf(), optimize=False)
    assert r.codes() == ("PLAN-ANALYZE-FAIL",)


def test_legality_verdicts():
    v = legality.accumulator_verdict(E.Count(E.Col("x"), distinct=True))
    assert not v.ok and v.code == "PLAN-ACC-NONMERGEABLE"
    assert legality.accumulator_verdict(E.Sum(E.Col("x"))).ok


def test_oracle_row_width_and_capacity(port):
    est = oracle.infer(port.range(0, 8)._plan, port.conf)
    assert est[-1].row_bytes == 8 and est[-1].capacity == 1024
    assert est[-1].device_bytes == 1024 * 8
    est = oracle.infer(port.range(0, 1025)._plan, port.conf)
    assert est[-1].capacity == 2048


def test_analyzer_fast_on_q1(port):
    df = port.sql(QUERIES[1])
    analysis.analyze(df._plan, port.conf)
    assert analysis.analyze(df._plan, port.conf).elapsed_ms < 200.0


def test_api_v1_lint_endpoint(port):
    from spark_tpu_torch.ui import StatusServer

    analysis.analyze(port.range(0, 8)._plan, port.conf)
    srv = StatusServer(session=port, port=0)
    try:
        with urllib.request.urlopen(srv.url + "/api/v1/lint",
                                    timeout=10) as r:
            body = json.loads(r.read())
    finally:
        srv.stop()
    assert body["profile"]["totals"]["runs"] >= 1
    assert body["recent"] and "diagnostics" in body["recent"][-1]
