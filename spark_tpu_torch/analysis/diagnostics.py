"""Typed diagnostics for the pre-execution plan analyzer.

The reference surfaces plan problems as free-text warnings scattered
across the optimizer and AQE logs; here every finding is a typed
``Diagnostic`` with a stable code, so the submit gate, ``/api/v1/lint``
and tests can match on identity instead of message text.

Diagnostic codes (stable API — tests and deployments key on these):

- ``PLAN-DTYPE-F64``        silent float64 widening: a float64 literal
                            mixed into integral arithmetic/comparison
                            promotes the whole expression to f64
- ``PLAN-CAP-BLOWUP``       a plan node's static device footprint
                            (capacity x row width) exceeds the HBM
                            admission budget — cross joins, expands
- ``PLAN-EST-DIVERGE``      static byte estimate vs AQE's measured
                            bytes differ by more than
                            spark.tpu.analysis.divergenceFactor
- ``PLAN-AVAL-MISMATCH``    the shape/dtype oracle disagrees with the
                            physical planner's schema (engine
                            inconsistency — always error level)
- ``PLAN-RECOMPILE-SHAPE``  a shape-bearing scalar (Range bounds,
                            repartition count, expand arity) is baked
                            into the plan fingerprint: varying it
                            re-traces AND recompiles; the compile
                            store can never hit across values
- ``PLAN-RECOMPILE-LITERAL``value-only literals baked into the
                            structural fingerprint (filter constants,
                            limit counts): shapes stay stable but each
                            distinct value is a compile-store miss
- ``PLAN-MERGE-FLOATSUM``   skew split / incremental re-merge is
                            illegal: float Sum re-merge changes
                            rounding, breaking byte-identity
- ``PLAN-MERGE-NONMERGEABLE`` re-merge illegal for any other reason
                            (non-Sum/Min/Max aggregate, float Min/Max
                            -0.0/NaN ordering, computed argument)
- ``PLAN-ACC-NONMERGEABLE`` the aggregate cannot be decomposed into
                            mergeable accumulators (DISTINCT,
                            unsupported call): chunked/streaming
                            tiers execute it directly
- ``PLAN-AGG-STRATEGY``     the runtime-adaptive aggregation engine
                            cannot switch strategies for this
                            aggregate (float Sum/Min/Max partials are
                            order-dependent): it stays pinned to the
                            static partial->final path
- ``PLAN-ANALYZE-FAIL``     the analyzer itself failed on this plan
                            (reported, never raised)

Materialized-view candidacy (root aggregates only; mirrors
``mview/view.inspect_plan`` so the linter and the view manager can
never disagree):

- ``PLAN-MVIEW-OK``         cache() of this plan registers an
                            INCREMENTALLY maintainable view: appended
                            files merge into the cached batch without
                            a full recompute
- ``PLAN-MVIEW-RECOMPUTE``  registrable, but every refresh pays a
                            full device recompute (aggregate not
                            exactly re-mergeable)
- ``PLAN-MVIEW-KEYS``       a grouping key is not carried through to
                            the output as a plain column, so delta
                            partials cannot be re-grouped
- ``PLAN-MVIEW-SOURCE``     not registrable: zero/many scans, mixed
                            stream+file sources, or a source without
                            a file fingerprint
- ``PLAN-MVIEW-SHAPE``      not registrable: the aggregate is not at
                            the plan root

Tree-wide concurrency analysis (``analysis/concurrency.py`` via
``lint_package()``; ``node`` is ``path:line`` instead of a
plan node for these):

- ``CONC-ORDER-CYCLE``      the static lock-acquisition graph contains
                            an edge that inverts the registered lock
                            hierarchy (spark_tpu_torch/locks.py ranks) or a
                            cycle among unranked locks — a lock-order
                            deadlock waiting for the right interleaving
- ``CONC-UNLOCKED-MUT``     module-level or ``self._``-prefixed state
                            that is mutated under a lock somewhere is
                            mutated with no lock held here (exempt
                            table: ``[tool.lint-concurrency]``)
- ``CONC-BLOCKING-HELD``    a blocking operation (queue put/get, HTTP,
                            file IO, subprocess, sleep, device sync,
                            thread join) runs while a lock is held
- ``CONC-WAIT-NOLOOP``      ``Condition.wait`` outside a predicate
                            loop: wakeups are permitted to be spurious,
                            so every wait must re-check its predicate
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Tuple

LEVELS = ("info", "warn", "error")


@dataclass(frozen=True)
class Diagnostic:
    code: str
    level: str           # "info" | "warn" | "error"
    node: str            # node_string() of the offending plan node
    message: str
    hint: str = ""

    def to_dict(self) -> Dict[str, Any]:
        return {"code": self.code, "level": self.level,
                "node": self.node, "message": self.message,
                "hint": self.hint}

    def format(self) -> str:
        loc = f" at {self.node}" if self.node else ""
        hint = f"\n    hint: {self.hint}" if self.hint else ""
        return f"[{self.level.upper()}] {self.code}{loc}: " \
               f"{self.message}{hint}"


@dataclass(frozen=True)
class AnalysisReport:
    """One analyzer run over one plan: diagnostics + the oracle's
    byte accounting + the recompilation-hazard verdict."""

    diagnostics: Tuple[Diagnostic, ...]
    peak_bytes: int = 0            # oracle: max node capacity x width
    admission_bytes: int = 0       # admission.estimate_plan_bytes
    measured_bytes: int = 0        # AQE measured table (0 = none)
    fingerprint_stable: bool = True
    node_count: int = 0
    elapsed_ms: float = 0.0
    plan: str = ""                 # root node_string of analyzed plan
    extra: Dict[str, Any] = field(default_factory=dict)

    def errors(self) -> Tuple[Diagnostic, ...]:
        return tuple(d for d in self.diagnostics if d.level == "error")

    def warnings(self) -> Tuple[Diagnostic, ...]:
        return tuple(d for d in self.diagnostics if d.level == "warn")

    def codes(self) -> Tuple[str, ...]:
        return tuple(d.code for d in self.diagnostics)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "plan": self.plan,
            "diagnostics": [d.to_dict() for d in self.diagnostics],
            "peak_bytes": self.peak_bytes,
            "admission_bytes": self.admission_bytes,
            "measured_bytes": self.measured_bytes,
            "fingerprint_stable": self.fingerprint_stable,
            "node_count": self.node_count,
            "elapsed_ms": self.elapsed_ms,
            "errors": len(self.errors()),
            "warnings": len(self.warnings()),
        }

    def format(self) -> str:
        head = [
            "== Plan Analysis ==",
            f"nodes={self.node_count} "
            f"peak_bytes={self.peak_bytes} "
            f"admission_bytes={self.admission_bytes} "
            f"measured_bytes={self.measured_bytes or '-'} "
            f"fingerprint_stable={self.fingerprint_stable} "
            f"({self.elapsed_ms:.1f} ms)",
        ]
        if not self.diagnostics:
            head.append("no diagnostics")
        return "\n".join(head + [d.format() for d in self.diagnostics])


class PlanAnalysisError(Exception):
    """Raised by the submit-time gate at spark.tpu.analysis.level=error
    when a plan carries error-level diagnostics. Carries the report so
    callers can render every finding, not just the first."""

    def __init__(self, errors: Tuple[Diagnostic, ...],
                 report: AnalysisReport):
        self.errors = tuple(errors)
        self.report = report
        lines = "; ".join(d.format() for d in self.errors)
        super().__init__(
            f"plan rejected by static analysis ({len(self.errors)} "
            f"error-level diagnostic(s)): {lines}")
