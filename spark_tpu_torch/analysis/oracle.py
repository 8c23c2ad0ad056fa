"""Shape/dtype/capacity propagation oracle (the port of
``spark_tpu/analysis/oracle.py``).

Infers, per logical operator and WITHOUT executing or tracing, the
output aval the engine will materialize for it: schema (dtypes from the
expression layer), row-count estimate (plan/join_reorder.estimate_rows
— the same cost model admission control trusts), static device row
capacity (the padded batch size after the port's capacity rounding,
``columnar/batch.round_capacity``'s multiple of 1024, mirroring the
physical planner), and the resulting device bytes (capacity x true per-row
width from each dtype's numpy itemsize plus validity planes — NOT the
flat 8-bytes-a-column guess admission uses).

The per-node accounting feeds three analyzer checks:

- capacity blowups: any node whose static footprint exceeds the HBM
  admission budget (PLAN-CAP-BLOWUP),
- estimate divergence: static peak vs AQE's measured-bytes table
  (PLAN-EST-DIVERGE),
- silent float64 widening: a float64 literal promoted into integral
  arithmetic (PLAN-DTYPE-F64) — every such leak doubles the column's
  device footprint and silently changes comparison semantics.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from spark_tpu_torch import conf as CF
from spark_tpu_torch import types as T
from spark_tpu_torch.columnar.batch import round_capacity
from spark_tpu_torch.expr import expressions as E
from spark_tpu_torch.plan import logical as L

from spark_tpu_torch.analysis.diagnostics import Diagnostic


@dataclass(frozen=True)
class NodeEstimate:
    """Static aval of one plan node's output."""

    node: str            # node_string()
    depth: int
    names: Tuple[str, ...]
    dtypes: Tuple[str, ...]
    rows: float          # cost-model row estimate
    capacity: int        # padded static device row capacity
    row_bytes: int       # true per-row width (itemsize + validity)
    device_bytes: int    # capacity x row_bytes

    def to_dict(self) -> dict:
        return {"node": self.node, "depth": self.depth,
                "rows": round(self.rows, 1), "capacity": self.capacity,
                "row_bytes": self.row_bytes,
                "device_bytes": self.device_bytes}


#: the row-capacity multiple every batch of the port is rounded up to
#: (``round_capacity``'s default; the reference reads it from
#: spark.tpu.batch.capacityMultiple, whose default it is)
CAPACITY_MULTIPLE = 1024


def _bucket(n: int, multiple: int = CAPACITY_MULTIPLE) -> int:
    return round_capacity(max(0, int(n)), max(1, int(multiple)))


def row_width_bytes(schema) -> int:
    """True materialized per-row width: each column's numpy itemsize
    (StringType int32 codes, DecimalType scaled int64, ...) plus one
    validity byte per nullable column."""
    total = 0
    for f in schema.fields:
        try:
            total += np.dtype(f.dtype.np_dtype or np.int64).itemsize
        except Exception:
            total += 8
        if getattr(f, "nullable", False):
            total += 1
    return max(1, total)


def _capacity(plan: L.LogicalPlan, child_caps: List[int],
              rows: float, multiple: int) -> int:
    """Static device row capacity of a node's output, mirroring the
    physical layer: leaves pad their row count up to the capacity
    multiple; most unary operators keep their child's capacity (masks,
    not reshapes); Expand stacks one block per projection; joins carry
    the PK-FK pair estimate; Union concatenates."""
    if isinstance(plan, L.Relation):
        return int(plan.batch.capacity)
    if isinstance(plan, (L.UnresolvedScan, L.Range)):
        return _bucket(int(np.ceil(rows)), multiple)
    if isinstance(plan, L.Expand):
        return child_caps[0] * max(1, len(plan.projections))
    if isinstance(plan, (L.Aggregate, L.Distinct)):
        # blocking boundary: the planner compacts aggregate output to
        # bucket(live) before anything downstream consumes it
        return _bucket(int(np.ceil(rows)), multiple)
    if isinstance(plan, L.Join):
        if plan.how == "cross" and not plan.left_keys:
            return max(1, child_caps[0]) * max(1, child_caps[1])
        if plan.how in ("left_semi", "left_anti"):
            return child_caps[0]
        return max(child_caps)
    if isinstance(plan, L.Union):
        return sum(child_caps)
    if child_caps:
        return max(child_caps)
    return _bucket(int(np.ceil(rows)), multiple)


def infer(plan: L.LogicalPlan, conf) -> List[NodeEstimate]:
    """Bottom-up per-node avals, post-order (children precede
    parents; the last entry is the root)."""
    from spark_tpu_torch.plan.join_reorder import estimate_rows

    multiple = CAPACITY_MULTIPLE
    out: List[NodeEstimate] = []

    def go(node: L.LogicalPlan, depth: int) -> NodeEstimate:
        child_ests = [go(c, depth + 1) for c in node.children()]
        try:
            rows = float(estimate_rows(node))
        except Exception:
            rows = max((e.rows for e in child_ests), default=1.0)
        try:
            schema = node.schema
            names = tuple(schema.names)
            dtypes = tuple(repr(f.dtype) for f in schema.fields)
            width = row_width_bytes(schema)
        except Exception:
            names, dtypes, width = (), (), 8
        cap = _capacity(node, [e.capacity for e in child_ests],
                        rows, multiple)
        est = NodeEstimate(
            node=node.node_string(), depth=depth, names=names,
            dtypes=dtypes, rows=rows, capacity=int(cap),
            row_bytes=int(width),
            device_bytes=int(cap) * int(width))
        out.append(est)
        return est

    go(plan, 0)
    return out


def peak_bytes(estimates: List[NodeEstimate]) -> int:
    return max((e.device_bytes for e in estimates), default=0)


# ---- dtype discipline -------------------------------------------------------


def _is_integral(dt) -> bool:
    return isinstance(dt, (T.IntegralType, T.BooleanType))


def _f64_literal_leaks(expr: E.Expression, schema,
                       out: List[Tuple[E.Expression, E.Expression]]) \
        -> None:
    """Collect (container, literal) pairs where a float64 Literal sits
    beside an integral operand inside arithmetic/comparison — the
    silent widening common_type applies there promotes the whole
    expression (and, downstream, the materialized column) to f64."""
    kids = expr.children()
    if isinstance(expr, (E.Arith, E.Cmp)) and len(kids) >= 2:
        def dt_of(e):
            try:
                return e.data_type(schema)
            except Exception:
                return None

        dts = [dt_of(k) for k in kids]
        has_integral = any(d is not None and _is_integral(d)
                           for d in dts)
        if has_integral:
            for k, d in zip(kids, dts):
                if isinstance(E.strip_alias(k), E.Literal) \
                        and isinstance(d, T.Float64Type):
                    out.append((expr, E.strip_alias(k)))
    for k in kids:
        _f64_literal_leaks(k, schema, out)


def dtype_diagnostics(plan: L.LogicalPlan) -> List[Diagnostic]:
    """Walk every single-child node's expressions against its input
    schema, flagging float64-literal widenings (PLAN-DTYPE-F64)."""
    diags: List[Diagnostic] = []

    def go(node: L.LogicalPlan) -> None:
        kids = node.children()
        if len(kids) == 1:
            try:
                schema = kids[0].schema
            except Exception:
                schema = None
            if schema is not None:
                found: List[Tuple[E.Expression, E.Expression]] = []
                for e in node.expressions():
                    _f64_literal_leaks(e, schema, found)
                for container, lit in found:
                    diags.append(Diagnostic(
                        code="PLAN-DTYPE-F64", level="warn",
                        node=node.node_string(),
                        message=(
                            f"float64 literal {lit.value!r} widens "
                            f"integral arithmetic in {container} to "
                            "float64 (silent x2 device bytes per "
                            "element, inexact compare semantics)"),
                        hint=("cast the literal to the column's "
                              "integral dtype, or cast the column "
                              "explicitly if float math is "
                              "intended")))
        for k in kids:
            go(k)

    go(plan)
    return diags


def capacity_diagnostics(estimates: List[NodeEstimate],
                         conf) -> List[Diagnostic]:
    """PLAN-CAP-BLOWUP for nodes whose static footprint alone exceeds
    the shared device budget (spark.tpu.scheduler.hbmBudgetBytes)."""
    budget = int(conf.get(CF.SCHEDULER_HBM_BUDGET))
    diags: List[Diagnostic] = []
    for e in estimates:
        if e.device_bytes > budget:
            if e.node.startswith("Join"):
                # joins no longer ride the replan ladder: the hybrid
                # hash join stages to its memory grant and spills the
                # rest as a planned single pass
                hint = ("an over-budget join over file scans runs "
                        "through the grant-driven hybrid hash join "
                        "(spark.tpu.join.hybrid.*), spilling partitions "
                        "beyond its memory grant; add join keys or "
                        "filters, or raise "
                        "spark.tpu.scheduler.hbmBudgetBytes, to avoid "
                        "the spill traffic")
            else:
                hint = ("this plan will rely on the chunked/OOM-"
                        "degradation ladder; add join keys or filters, "
                        "or raise spark.tpu.scheduler.hbmBudgetBytes")
            diags.append(Diagnostic(
                code="PLAN-CAP-BLOWUP", level="warn",
                node=e.node,
                message=(
                    f"static footprint {e.device_bytes} bytes "
                    f"(capacity {e.capacity} x {e.row_bytes} B/row) "
                    f"exceeds the device admission budget {budget}"),
                hint=hint))
    return diags
