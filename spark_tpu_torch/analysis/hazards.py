"""Recompilation-hazard detection (the port of
``spark_tpu/analysis/hazards.py``).

The stage cache (``physical/graphs.py``: one captured CUDA graph per
fused stage) and the reference's compile store key programs by a
structural fingerprint that embeds every literal value (expr_key's
``("lit", value, dtype)``) and every scalar plan field (Range bounds,
Limit.n, Repartition.num_partitions). A plan built from a template with
data-dependent constants therefore gets a FRESH fingerprint per value —
the store can never hit, the jit stage caches never hit, and warmup is
paid on every query. This detector proves, statically, which plans are
fingerprint-stable and names the offending node when one is not.

Hazard classes (by consequence, worst first):

- **shape-bearing scalars** (PLAN-RECOMPILE-SHAPE, warn): values that
  flow into traced array shapes — Range start/end/step (capacity =
  bucket-rounded row count), Repartition.num_partitions (exchange
  buffer layout), Expand arity. Varying one re-traces AND recompiles.
  The detector additionally runs a perturbation probe: re-deriving the
  capacity with the value nudged by one says whether the capacity
  bucket (``oracle.CAPACITY_MULTIPLE``) absorbs small variations
  (adjacent values land in one bucket and share an executable) or
  whether EVERY distinct value is a distinct program.

- **value-only literals** (PLAN-RECOMPILE-LITERAL, info): constants
  baked into the fingerprint whose variation keeps shapes stable
  (filter predicates, projection arithmetic, Limit.n — the engine
  limits by masking, not reshaping). Each distinct value still misses
  the compile store, but the re-trace lands on cached shapes.

A plan with neither class is **fingerprint-stable**: the compile store
hits for every future submission of the same query text.
"""

from __future__ import annotations

from typing import List, Tuple

from spark_tpu_torch.expr import expressions as E
from spark_tpu_torch.plan import logical as L

from spark_tpu_torch.analysis.diagnostics import Diagnostic
from spark_tpu_torch.analysis.oracle import CAPACITY_MULTIPLE, _bucket


def _literals(expr: E.Expression, out: List[E.Literal]) -> None:
    if isinstance(expr, E.Literal):
        out.append(expr)
    for k in expr.children():
        _literals(k, out)


def _range_bucket_absorbs(node: L.Range, multiple: int) -> bool:
    """Perturbation probe: does nudging the range bound by one step
    keep the bucket-rounded capacity (and hence every traced shape
    downstream) unchanged?"""
    cap = _bucket(node.num_rows, multiple)
    import dataclasses

    nudged = dataclasses.replace(node, end=node.end + node.step)
    return _bucket(nudged.num_rows, multiple) == cap


def detect(plan: L.LogicalPlan, conf) \
        -> Tuple[List[Diagnostic], bool]:
    """Returns (diagnostics, fingerprint_stable)."""
    multiple = CAPACITY_MULTIPLE
    diags: List[Diagnostic] = []
    value_literal_count = 0
    first_value_node = ""

    def go(node: L.LogicalPlan) -> None:
        nonlocal value_literal_count, first_value_node
        if isinstance(node, L.Range):
            absorbed = _range_bucket_absorbs(node, multiple)
            diags.append(Diagnostic(
                code="PLAN-RECOMPILE-SHAPE", level="warn",
                node=node.node_string(),
                message=(
                    f"Range bounds ({node.start}, {node.end}, "
                    f"{node.step}) are baked into the plan "
                    "fingerprint AND size the traced arrays: a "
                    "data-dependent bound re-traces and recompiles "
                    "per distinct value"
                    + ("; the capacity bucket absorbs +-1-step "
                       "variation (adjacent values share an "
                       "executable)" if absorbed else
                       "; the value sits on a capacity-bucket edge — "
                       "even +-1-step variation is a new "
                       "executable")),
                hint=("pass data-dependent row counts through a "
                      "Relation/scan instead of range bounds, or "
                      "round bounds to multiples of "
                      f"{CAPACITY_MULTIPLE}")))
        elif isinstance(node, L.Repartition) \
                and node.num_partitions > 0:
            diags.append(Diagnostic(
                code="PLAN-RECOMPILE-SHAPE", level="warn",
                node=node.node_string(),
                message=(
                    f"repartition({node.num_partitions}) bakes the "
                    "partition count into exchange buffer shapes: a "
                    "data-dependent count re-traces and recompiles "
                    "per distinct value"),
                hint=("leave num_partitions at the mesh default "
                      "(spark.sql.shuffle.partitions=0) unless the "
                      "count is a fixed constant")))
        # value-only literals: everything expr_key embeds
        lits: List[E.Literal] = []
        for e in node.expressions():
            _literals(e, lits)
        n_here = len(lits)
        if isinstance(node, L.Limit):
            n_here += 1  # Limit.n is a plan field, masked not reshaped
        if isinstance(node, L.Sample):
            n_here += 1
        if n_here:
            value_literal_count += n_here
            if not first_value_node:
                first_value_node = node.node_string()
        for c in node.children():
            go(c)

    go(plan)

    if value_literal_count:
        diags.append(Diagnostic(
            code="PLAN-RECOMPILE-LITERAL", level="info",
            node=first_value_node,
            message=(
                f"{value_literal_count} literal value(s) are baked "
                "into the structural fingerprint (first at "
                f"{first_value_node}); each distinct value is a "
                "compile-store miss, though traced shapes stay "
                "stable"),
            hint=("stable for fixed query text; parameterized "
                  "dashboards that vary constants per request will "
                  "never hit the executable store")))

    stable = not diags
    return diags, stable
