"""Transform legality: may an aggregate be decomposed into mergeable
accumulators without changing its result? (The part of
``spark_tpu/analysis/legality.py`` the out-of-memory tier calls; the
exact re-merge and strategy rules come with ROADMAP A12.)

An aggregate decomposes when every call is count/sum/avg/min/max
without DISTINCT: ``plan/incremental.AggSpec`` then splits it into
partials over chunks and one merge over their union. This is purely
structural: partials merge once, so a float Sum is legal here.
"""

from __future__ import annotations

from dataclasses import dataclass

from spark_tpu_torch.expr import expressions as E


@dataclass(frozen=True)
class Verdict:
    ok: bool
    code: str = ""        # diagnostic code when not ok
    reason: str = ""
    offending: str = ""   # offending expression, printable

    def __bool__(self) -> bool:
        return self.ok


OK = Verdict(True)


def accumulator_verdict(call: E.Expression) -> Verdict:
    """Mergeable-accumulator legality of ONE aggregate call."""
    if getattr(call, "distinct", False):
        return Verdict(
            False, "PLAN-ACC-NONMERGEABLE",
            "DISTINCT aggregates are not mergeable accumulators",
            str(call))
    if not isinstance(call, (E.Count, E.Sum, E.Avg, E.Min, E.Max)):
        return Verdict(
            False, "PLAN-ACC-NONMERGEABLE",
            f"aggregate {call} is not a mergeable accumulator",
            str(call))
    return OK


def accumulators_verdict(aggregates) -> Verdict:
    """Mergeable-accumulator legality over a whole aggregate list."""
    for e in aggregates:
        for call in E.collect_aggregates(e):
            v = accumulator_verdict(call)
            if not v.ok:
                return v
    return OK
