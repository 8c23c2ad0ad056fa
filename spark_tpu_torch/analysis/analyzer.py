"""Pre-execution plan analyzer: orchestration + submit-time gate (the
port of ``spark_tpu/analysis/analyzer.py``).

``analyze(plan, conf)`` walks a LOGICAL plan without executing it and
returns an :class:`AnalysisReport` combining the three sub-analyses:

1. the shape/dtype/capacity oracle (analysis/oracle.py) — per-node
   avals, peak device bytes, float64-literal widenings, capacity
   blowups against the HBM admission budget, and a divergence check of
   the static byte estimate against admission control's AQE-measured
   table,
2. the recompilation-hazard detector (analysis/hazards.py) — is the
   structural fingerprint stable under data-dependent values,
3. the transform-legality rules (analysis/legality.py) — shared with
   the AQE skew fan, accumulator decomposition, and the chunked tier.

The analyzer itself NEVER raises: an internal failure becomes a single
``PLAN-ANALYZE-FAIL`` diagnostic. The submit-time gate
(``maybe_gate``) raises :class:`PlanAnalysisError` only at
``spark.tpu.analysis.level=error`` and only for error-level findings.

The materialized-view candidacy codes (PLAN-MVIEW-*) are
``mview/view.inspect_plan``'s, for a root aggregate. PLAN-EST-DIVERGE holds the static
estimate against the measured bytes admission keeps
(``scheduler/admission.py``; the mesh records them), so it fires only
for a plan that has run.

Level policy: defect rules default to warn/info because a finding like
float Sum is only FATAL relative to an intent — q1's sum(l_quantity)
is fine to execute, illegal to skew-split. Passing
``intent="skew_split"`` escalates the PLAN-MERGE-* codes to error;
``spark.tpu.analysis.errorCodes`` (comma-separated) escalates any
chosen codes at the gate; PLAN-AVAL-MISMATCH is intrinsically error
(the oracle and the physical planner disagree — an engine bug, not a
user plan problem).
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

from spark_tpu_torch import locks
from spark_tpu_torch import conf as CF
from spark_tpu_torch.plan import logical as L
from spark_tpu_torch.scheduler import admission

from spark_tpu_torch.analysis import hazards, legality, oracle
from spark_tpu_torch.analysis.diagnostics import (AnalysisReport, Diagnostic,
                                            PlanAnalysisError)

#: codes whose severity is intent-relative: error only when the caller
#: declares it will actually attempt the transform
_MERGE_CODES = ("PLAN-MERGE-FLOATSUM", "PLAN-MERGE-NONMERGEABLE")

_RECENT_LOCK = locks.named_lock("analysis.recent")
_RECENT_MAX = 64
_RECENT: List[AnalysisReport] = []


def _escalations(conf) -> Tuple[str, ...]:
    raw = str(conf.get(CF.ANALYSIS_ERROR_CODES) or "")
    return tuple(c.strip() for c in raw.split(",") if c.strip())


def _legality_diags(plan: L.LogicalPlan,
                    intent: Optional[str]) -> List[Diagnostic]:
    level = "error" if intent == "skew_split" else "info"
    diags: List[Diagnostic] = []

    def go(node: L.LogicalPlan) -> None:
        if isinstance(node, L.Aggregate):
            v = legality.remerge_verdict(node)
            if not v.ok:
                diags.append(Diagnostic(
                    code=v.code, level=level,
                    node=node.node_string(),
                    message=f"not exactly re-mergeable: {v.reason}",
                    hint=("the AQE skew fan and incremental merges "
                          "will fall back to single-shard execution "
                          f"for this aggregate ({v.offending})")))
            va = legality.accumulators_verdict(node.aggregates)
            if not va.ok:
                diags.append(Diagnostic(
                    code=va.code, level="info",
                    node=node.node_string(),
                    message=("no mergeable accumulator decomposition: "
                             f"{va.reason}"),
                    hint=("the chunked out-of-HBM tier will execute "
                          f"this aggregate directly ({va.offending})")))
            try:
                vs = legality.strategy_verdict(node.aggregates,
                                               node.child.schema)
            except Exception:
                vs = legality.OK
            if not vs.ok:
                diags.append(Diagnostic(
                    code="PLAN-AGG-STRATEGY", level="info",
                    node=node.node_string(),
                    message=("adaptive aggregation pinned to the "
                             f"partial->final strategy: {vs.reason}"),
                    hint=("the runtime strategy switch (partial-bypass "
                          "/ hash-partial) is skipped for this "
                          f"aggregate ({vs.offending})")))
        for c in node.children():
            go(c)

    go(plan)
    return diags


def _mview_diags(plan: L.LogicalPlan) -> List[Diagnostic]:
    """Materialized-view candidacy of a root aggregate (the only plan a
    view registers): whether a cache() of this plan would refresh
    incrementally, by full recompute or not register at all. The
    PLAN-MVIEW-* family is mview/view.inspect_plan's, so the lint and
    the manager never disagree."""
    if not isinstance(plan, L.Aggregate):
        return []
    try:
        from spark_tpu_torch.mview import inspect_plan

        insp = inspect_plan(plan)
    except Exception:  # noqa: BLE001 - the analyzer never raises
        return []
    return [Diagnostic(code=code, level="info", node=plan.node_string(),
                       message=message, hint=hint)
            for code, message, hint in insp.diagnostics]


def _aval_cross_check(optimized: L.LogicalPlan,
                      estimates) -> List[Diagnostic]:
    """The oracle's root aval must agree with the physical planner's
    traced schema — a mismatch means the static model and the engine
    disagree about what this plan materializes (always an error)."""
    from spark_tpu_torch.columnar.batch import empty_batch
    from spark_tpu_torch.physical.planner import plan_physical

    def stub_scans(node: L.LogicalPlan) -> L.LogicalPlan:
        # plan_physical materializes UnresolvedScan leaves
        # (source.read() = parquet decode + host->device transfer);
        # the analyzer must stay static, so file scans are planned
        # against empty same-schema relations instead
        if isinstance(node, L.UnresolvedScan):
            return L.Relation(empty_batch(node.schema, device="cpu"))
        return node

    try:
        stubbed = optimized.transform_up(stub_scans)
        phys_schema = plan_physical(stubbed, "cpu").schema
    except Exception as exc:
        return [Diagnostic(
            code="PLAN-ANALYZE-FAIL", level="warn",
            node=optimized.node_string(),
            message=f"physical planning failed during analysis: {exc!r}",
            hint="the aval cross-check was skipped for this plan")]
    root = estimates[-1]
    phys_names = tuple(phys_schema.names)
    phys_dtypes = tuple(repr(f.dtype) for f in phys_schema.fields)
    if root.names and (phys_names != root.names
                       or phys_dtypes != root.dtypes):
        return [Diagnostic(
            code="PLAN-AVAL-MISMATCH", level="error",
            node=optimized.node_string(),
            message=(
                "static oracle aval "
                f"{list(zip(root.names, root.dtypes))} disagrees with "
                "the physical planner's schema "
                f"{list(zip(phys_names, phys_dtypes))}"),
            hint=("engine inconsistency between the logical schema "
                  "and physical planning — report this plan"))]
    return []


def analyze(plan: L.LogicalPlan, conf=None,
            intent: Optional[str] = None,
            optimize: bool = True) -> AnalysisReport:
    """Statically analyze a logical plan. Never raises; internal
    failures surface as a PLAN-ANALYZE-FAIL diagnostic."""
    from spark_tpu_torch import metrics

    if conf is None:
        conf = CF.RuntimeConf()

    t0 = time.perf_counter()
    diags: List[Diagnostic] = []
    peak = adm = measured = node_count = 0
    stable = True
    root_str = ""
    try:
        root_str = plan.node_string()
        optimized = plan
        if optimize:
            from spark_tpu_torch.plan.optimizer import optimize as _opt

            optimized = _opt(plan, conf)
        estimates = oracle.infer(optimized, conf)
        node_count = len(estimates)
        peak = oracle.peak_bytes(estimates)
        diags.extend(oracle.dtype_diagnostics(optimized))
        diags.extend(oracle.capacity_diagnostics(estimates, conf))
        diags.extend(_aval_cross_check(optimized, estimates))

        hz, stable = hazards.detect(optimized, conf)
        diags.extend(hz)
        diags.extend(_legality_diags(optimized, intent))
        diags.extend(_mview_diags(optimized))

        # estimate-divergence: the static oracle vs what admission
        # control will believe (measured bytes preferred)
        adm = int(admission.estimate_plan_bytes(plan, conf))
        measured = int(admission.measured_plan_bytes(plan) or 0)
        if measured:
            factor = float(conf.get(CF.ANALYSIS_DIVERGENCE_FACTOR))
            lo, hi = sorted((max(1, peak), max(1, measured)))
            if factor > 0 and hi / lo > factor:
                diags.append(Diagnostic(
                    code="PLAN-EST-DIVERGE", level="warn",
                    node=root_str,
                    message=(
                        f"static estimate {peak} B vs AQE-measured "
                        f"{measured} B diverge by more than "
                        f"{factor:g}x"),
                    hint=("the cost model is unreliable for this plan "
                          "shape; admission and join ordering run on "
                          "measured bytes, but cold-start decisions "
                          "do not — tune "
                          "spark.tpu.analysis.divergenceFactor to "
                          "silence")))
    except Exception as exc:  # analyzer must never break submission
        diags.append(Diagnostic(
            code="PLAN-ANALYZE-FAIL", level="warn",
            node=root_str,
            message=f"static analysis failed: {exc!r}",
            hint="execution proceeds unanalyzed"))

    # conf-driven escalation of chosen codes to error (the gate's
    # deployment knob; also how tests exercise the error path)
    esc = _escalations(conf)
    if esc:
        diags = [
            Diagnostic(code=d.code, level="error", node=d.node,
                       message=d.message, hint=d.hint)
            if d.code in esc and d.level != "error" else d
            for d in diags]

    elapsed = (time.perf_counter() - t0) * 1e3
    report = AnalysisReport(
        diagnostics=tuple(diags), peak_bytes=int(peak),
        admission_bytes=int(adm), measured_bytes=int(measured),
        fingerprint_stable=bool(stable), node_count=node_count,
        elapsed_ms=elapsed, plan=root_str)

    with _RECENT_LOCK:
        _RECENT.append(report)
        del _RECENT[:-_RECENT_MAX]
    try:
        metrics.note_analysis(report)
    except Exception:
        pass
    return report


def recent_reports(n: int = 16) -> List[AnalysisReport]:
    with _RECENT_LOCK:
        return list(_RECENT[-max(0, int(n)):])


def maybe_gate(plan: L.LogicalPlan, conf) -> Optional[AnalysisReport]:
    """Submit-time gate, keyed on spark.tpu.analysis.level:

    - ``off``   (default): no analysis, returns None
    - ``warn``: analyze, log warn+ diagnostics through metrics, admit
    - ``error``: analyze and raise PlanAnalysisError if any
      diagnostic is error-level (including errorCodes escalations)
    """
    level = str(conf.get(CF.ANALYSIS_LEVEL) or "off").lower()
    if level not in ("warn", "error"):
        return None
    report = analyze(plan, conf)
    if level == "error":
        errs = report.errors()
        if errs:
            from spark_tpu_torch import metrics

            try:
                metrics.note_analysis_gated()
            except Exception:
                pass
            raise PlanAnalysisError(errs, report)
    return report
