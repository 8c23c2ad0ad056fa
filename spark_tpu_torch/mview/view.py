"""Materialized-view descriptors and the maintainability verdict (the
port of ``spark_tpu/mview/view.py``).

``inspect_plan`` answers, statically, the two questions the manager and
the plan analyzer both ask:

1. can this plan be registered as a view at all (a root Aggregate over
   exactly one fingerprinted file scan, or over one streaming source),
2. is a registered view incrementally maintainable (grouping keys
   carried through to the output, every aggregate exactly re-mergeable
   by ``analysis/legality.remerge_verdict``)?

A registrable view that is not incremental still refreshes, by a full
recompute, so freshness never depends on merge legality; legality only
decides what a refresh costs on the device. The same inspection gives
the ``PLAN-MVIEW-*`` diagnostics of ``df.explain(mode="lint")``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

from spark_tpu_torch import locks
from spark_tpu_torch.analysis import legality
from spark_tpu_torch.expr import expressions as E
from spark_tpu_torch.plan import logical as L


@dataclass(frozen=True)
class MergeSpec:
    """How a view's own output re-merges with delta partials: grouped by
    the key output columns, each Sum/Min/Max re-applied to its own output
    column (exact by the re-merge rule)."""

    key_names: Tuple[str, ...]
    merge_outs: Tuple[E.Expression, ...]

    def merge_plan(self, child: L.LogicalPlan) -> L.LogicalPlan:
        keys = tuple(E.Col(n) for n in self.key_names)
        return L.Aggregate(keys, self.merge_outs, child)


@dataclass(frozen=True)
class Inspection:
    """Static view-candidacy report of one logical plan."""

    registrable: bool
    incremental: bool
    kind: str                      # "file" | "stream" | ""
    scan: Optional[L.LogicalPlan]  # the one UnresolvedScan of a file view
    merge_spec: Optional[MergeSpec]
    #: (code, message, hint) triples of the PLAN-MVIEW-* family
    diagnostics: Tuple[Tuple[str, str, str], ...]


def _not_registrable(code: str, message: str, hint: str) -> Inspection:
    return Inspection(False, False, "", None, None,
                      ((code, message, hint),))


def _merge_spec(agg: L.Aggregate):
    """The key and merge output lists, or (code, message) where the
    structure cannot re-merge: every grouping must come out as a plain
    output column (its value is what the merge groups by again)."""
    out_by_key = {}
    for e in agg.aggregates:
        inner = E.strip_alias(e)
        if isinstance(inner, E.Col):
            out_by_key[E.expr_key(inner)] = e.name
    key_names = []
    for g in agg.groupings:
        name = out_by_key.get(E.expr_key(E.strip_alias(g)))
        if name is None:
            return None, (
                "PLAN-MVIEW-KEYS",
                f"grouping key {g} is not carried through to the "
                "output as a plain column; the merge cannot re-group "
                "delta partials without its value")
        key_names.append(name)
    merge_outs: List[E.Expression] = []
    for e in agg.aggregates:
        inner = E.strip_alias(e)
        if isinstance(inner, E.Col):
            merge_outs.append(E.Alias(E.Col(e.name), e.name))
            continue
        # remerge_verdict (checked by the caller) leaves exactly one
        # Sum/Min/Max call equal to the whole expression
        call = E.collect_aggregates(inner)[0]
        merge_outs.append(E.Alias(type(call)(E.Col(e.name)), e.name))
    return MergeSpec(tuple(key_names), tuple(merge_outs)), None


def inspect_plan(plan: L.LogicalPlan) -> Inspection:
    """Classify ``plan`` as a materialized-view candidate. Only root
    Aggregates are candidates (operators above the aggregate would have
    to run again over the refreshed state: the streaming restriction)."""
    from spark_tpu_torch.io.fingerprint import source_fingerprint
    from spark_tpu_torch.streaming.execution import StreamingSource

    if not isinstance(plan, L.Aggregate):
        return _not_registrable(
            "PLAN-MVIEW-SHAPE",
            "materialized views require the aggregate at the plan "
            "root",
            "cache() the groupBy().agg() result itself; operators "
            "above it re-run per query anyway")

    streams = L.collect_nodes(plan, StreamingSource)
    scans = L.collect_nodes(plan, L.UnresolvedScan)
    if streams:
        if len(streams) != 1 or scans:
            return _not_registrable(
                "PLAN-MVIEW-SOURCE",
                "stream views require exactly one streaming source "
                "and no file scans",
                "split multi-source plans before registering")
        kind, scan = "stream", None
    else:
        if len(scans) != 1:
            return _not_registrable(
                "PLAN-MVIEW-SOURCE",
                f"materialized views require exactly one file scan "
                f"(found {len(scans)})",
                "joins of several sources refresh ambiguously; cache "
                "each side instead")
        scan = scans[0]
        if source_fingerprint(scan.source) is None:
            return _not_registrable(
                "PLAN-MVIEW-SOURCE",
                "the scan source has no file fingerprint (in-memory "
                "relation?) — no delta to detect",
                "only file-backed sources can be refreshed")
        kind = "file"

    diags: List[Tuple[str, str, str]] = []
    v = legality.remerge_verdict(plan)
    spec = None
    if not v.ok:
        diags.append((
            "PLAN-MVIEW-RECOMPUTE",
            f"view refreshes by FULL recompute: {v.reason} "
            f"({v.offending})",
            "integer Sum / non-float Min/Max aggregates merge "
            "incrementally; others stay correct but pay a full "
            "device recompute per refresh"))
    else:
        spec, err = _merge_spec(plan)
        if spec is None:
            code, message = err
            diags.append((
                code, message,
                "add the grouping column itself to the aggregate "
                "output list"))
        else:
            diags.append((
                "PLAN-MVIEW-OK",
                "view is incrementally maintainable: appended files "
                "merge into the cached batch without a full recompute",
                ""))
    incremental = spec is not None
    if kind == "stream" and not incremental:
        # a stream cannot be scanned again, so a stream view without a
        # merge cannot exist
        return Inspection(False, False, kind, scan, None, tuple(diags))
    return Inspection(True, incremental, kind, scan, spec, tuple(diags))


@dataclass(eq=False)
class MaterializedView:
    """One registered view: the plan, its inspection and the refresh
    state, which changes under ``lock`` (the manager refreshes a view
    one at a time)."""

    key: Any                        # structural plan key
    plan: L.LogicalPlan
    inspection: Inspection
    name: str = ""                  # stream views: the reader's handle
    stream: str = ""                # stream views: the source query
    fingerprint: Optional[tuple] = None   # file views: last refreshed
    last_batch_id: int = -1         # stream views: WAL dedup watermark
    state: Any = None               # stream views: merged device batch
    lock: Any = field(default_factory=lambda: locks.named_lock(
        "mview.view"))
    refreshes: int = 0
    incremental_merges: int = 0
    full_recomputes: int = 0

    @property
    def kind(self) -> str:
        return self.inspection.kind

    def source(self):
        return self.inspection.scan.source \
            if self.inspection.scan is not None else None

    def to_dict(self) -> dict:
        return {
            "kind": self.kind,
            "name": self.name,
            "stream": self.stream,
            "incremental": self.inspection.incremental,
            "plan": self.plan.node_string(),
            "files": len(self.fingerprint or ()),
            "last_batch_id": self.last_batch_id,
            "refreshes": self.refreshes,
            "incremental_merges": self.incremental_merges,
            "full_recomputes": self.full_recomputes,
        }
