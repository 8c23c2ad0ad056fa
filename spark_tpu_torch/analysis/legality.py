"""Transform legality: may an aggregate be re-applied, decomposed or
switched between strategies without changing its result? (The port of
``spark_tpu/analysis/legality.py``'s rules; ``analyzer.py`` reports them
before a plan runs.)

Three questions, one rule set:

- **exact re-merge** (``remerge_verdict*``): can the aggregate list be
  re-applied to its own output byte-identically? The mesh's skew fan
  needs it (a pre-merge runs the consumer aggregate twice). Group keys
  pass through; only Sum/Min/Max over a single column qualify; Sum must
  be integral (int wraparound is associative, float rounding is not);
  Min/Max must be non-float (-0.0/NaN selection is order-dependent).
- **mergeable accumulators** (``accumulator_verdict``): can the
  aggregate split into partials that one more aggregation merges
  (count/sum/avg/min/max without DISTINCT)? The out-of-memory tier
  needs it. Purely structural: partials merge once, so a float Sum is
  legal here.
- **strategy flexibility** (``strategy_verdict``): may the mesh's
  adaptive aggregation switch the aggregate between partial->final,
  bypass, hash-partial, the sort rung and pre-split? Switching changes
  which rows each accumulator sees before the merge, so every partial
  accumulator must be partition- and order-invariant: Count always;
  Sum/Avg with an integral partial sum (decimals are scaled int64);
  Min/Max non-float. Anything else pins to partial->final (code
  PLAN-AGG-STRATEGY).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

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


def _np_dtype(dtype) -> "np.dtype":
    """The numpy dtype of an engine DataType as the executor stores it
    (a string is int32 dictionary codes and a decimal scaled int64, so
    both re-merge exactly)."""
    return np.dtype(dtype.np_dtype)


def _merge_dtype_verdict(call: E.Expression, dt: "np.dtype") -> Verdict:
    """The numeric half of the exact re-merge rule for one Sum/Min/Max
    call whose merged accumulator has numpy dtype ``dt``."""
    if isinstance(call, E.Sum):
        if not (np.issubdtype(dt, np.integer) or dt == np.bool_):
            return Verdict(
                False, "PLAN-MERGE-FLOATSUM",
                "float Sum re-merge changes rounding (float addition "
                "is not associative); results would not be "
                "byte-identical", str(call))
        return OK
    if np.issubdtype(dt, np.floating):
        return Verdict(
            False, "PLAN-MERGE-NONMERGEABLE",
            "float Min/Max re-merge is order-dependent (-0.0 vs 0.0 "
            "and NaN selection)", str(call))
    return OK


def remerge_verdict_cols(aggregates, schema) -> Verdict:
    """Exact re-merge legality over an already-partial output schema:
    every aggregate is a group key (a plain Col) or Sum/Min/Max over one
    column of ``schema`` with a re-mergeable dtype (the skew fan's
    precondition)."""
    by_name = {f.name: f for f in schema.fields}
    for a in aggregates:
        e = E.strip_alias(a)
        if isinstance(e, E.Col):  # group key carried through
            continue
        if not isinstance(e, (E.Sum, E.Min, E.Max)):
            return Verdict(
                False, "PLAN-MERGE-NONMERGEABLE",
                f"{type(e).__name__} is not exactly re-mergeable "
                "(only integral Sum and non-float Min/Max re-apply "
                "byte-identically)", str(e))
        kids = e.children()
        if len(kids) != 1 or not isinstance(kids[0], E.Col):
            return Verdict(
                False, "PLAN-MERGE-NONMERGEABLE",
                "re-merge argument must be a single plain column "
                "(computed arguments would be re-evaluated over "
                "already-aggregated rows)", str(e))
        f = by_name.get(kids[0].col_name)
        if f is None:
            return Verdict(
                False, "PLAN-MERGE-NONMERGEABLE",
                f"column {kids[0].col_name!r} absent from the merge "
                "schema", str(e))
        try:
            dt = _np_dtype(f.dtype)
        except Exception:
            return Verdict(
                False, "PLAN-MERGE-NONMERGEABLE",
                f"no numeric device dtype for {f.dtype}", str(e))
        v = _merge_dtype_verdict(e, dt)
        if not v.ok:
            return v
    return OK


def remerge_verdict(agg) -> Verdict:
    """The logical-plan form of the exact re-merge rule: each aggregate
    call's merged accumulator dtype (its output type over the child
    schema) must satisfy the Sum/Min/Max rules; group keys and plain
    column pass-throughs are fine, anything else is not exactly
    re-mergeable."""
    schema = agg.child.schema
    for a in agg.aggregates:
        e = E.strip_alias(a)
        if isinstance(e, E.Col):
            continue
        calls = E.collect_aggregates(e)
        if not calls or E.expr_key(e) != E.expr_key(calls[0]) \
                or len(calls) != 1:
            # a composite output (avg = sum/count, arithmetic over
            # aggregates) re-applied to its own output is not the merge
            return Verdict(
                False, "PLAN-MERGE-NONMERGEABLE",
                "composite aggregate output is not exactly "
                "re-mergeable", str(e))
        call = calls[0]
        if not isinstance(call, (E.Sum, E.Min, E.Max)):
            return Verdict(
                False, "PLAN-MERGE-NONMERGEABLE",
                f"{type(call).__name__} is not exactly re-mergeable",
                str(call))
        try:
            dt = _np_dtype(call.data_type(schema))
        except Exception:
            return Verdict(
                False, "PLAN-MERGE-NONMERGEABLE",
                "cannot resolve the merged accumulator dtype",
                str(call))
        v = _merge_dtype_verdict(call, dt)
        if not v.ok:
            return v
    return OK


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


def strategy_call_verdict(call: E.Expression, schema) -> Verdict:
    """Strategy flexibility of ONE aggregate call over ``schema`` (the
    rows before aggregation): OK means its partial accumulators may be
    computed under any partitioning and grouping order (bypass, hash,
    sort) and merge to byte-identical results."""
    v = accumulator_verdict(call)
    if not v.ok:
        return v
    if isinstance(call, E.Count):
        return OK  # int64 counting is exact under any row order
    if isinstance(call, (E.Sum, E.Avg)):
        # the decomposition's partial is Sum(child) (AggSpec): its
        # accumulator dtype decides, so a decimal Avg (scaled int64 sum
        # and int64 count) passes
        try:
            dt = _np_dtype(E.Sum(call.child).data_type(schema))
        except Exception:
            return Verdict(
                False, "PLAN-AGG-STRATEGY",
                "cannot resolve the partial Sum accumulator dtype",
                str(call))
        if not (np.issubdtype(dt, np.integer) or dt == np.bool_):
            return Verdict(
                False, "PLAN-AGG-STRATEGY",
                "float Sum partials are order-dependent (float "
                "addition is not associative); strategy switching "
                "would change rounding", str(call))
        return OK
    try:
        dt = _np_dtype(call.data_type(schema))
    except Exception:
        return Verdict(
            False, "PLAN-AGG-STRATEGY",
            "cannot resolve the Min/Max accumulator dtype", str(call))
    if np.issubdtype(dt, np.floating):
        return Verdict(
            False, "PLAN-AGG-STRATEGY",
            "float Min/Max selection is order-dependent (-0.0 vs 0.0 "
            "and NaN)", str(call))
    return OK


def strategy_verdict(aggregates, schema) -> Verdict:
    """Strategy flexibility over a whole aggregate list (logical output
    expressions or the executor's partial aliases: both reduce to the
    same Count/Sum/Avg/Min/Max calls over the input schema)."""
    for e in aggregates:
        for call in E.collect_aggregates(e):
            v = strategy_call_verdict(call, schema)
            if not v.ok:
                return v
    return OK


def strategy_crossover(ndv_ratio: float, domain_width: int,
                       bypass_ndv_ratio: float, hash_domain_limit: int,
                       sort_domain_width: int) -> str:
    """The sort/hash crossover of adaptive aggregation: the measured
    NDV-to-rows ratio and packed key domain width (-1: unbounded or
    unpackable, e.g. string keys or a range past int64 packing) to the
    cheapest non-static strategy:

    - low ratio, small domain  -> ``"hash"`` (a dense table, no sort)
    - low ratio, wide domain   -> ``"partial"`` (partials still shrink)
    - high ratio, bounded domain -> ``"bypass"`` (one raw-row exchange)
    - high ratio, huge/unbounded domain -> ``"sort"`` (range exchange,
      one sorted merge per rank, key-ordered output for free)
    """
    high_ndv = ndv_ratio >= bypass_ndv_ratio
    small_domain = 0 <= domain_width <= hash_domain_limit
    if high_ndv:
        if domain_width < 0 or domain_width > sort_domain_width:
            return "sort"
        return "bypass"
    if small_domain:
        return "hash"
    return "partial"
