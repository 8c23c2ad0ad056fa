"""Incremental aggregation: the accumulator decomposition (the port of
``spark_tpu/plan/incremental.py``).

Splits an Aggregate into mergeable accumulators (count/sum/avg/min/max;
avg = sum + count) so that partial results computed over chunks of the
input combine by a second ordinary aggregation over their union. The
out-of-memory tier (``physical/chunked.py``) runs each chunk's partials
and every merge through the planner (reference analogue:
ExternalSorter.scala:93 and TungstenAggregation's sort-merge passes;
AggUtils' partial/final split). The streaming state merge
(``streaming/execution.py``) uses the same decomposition, with the
tumbling and session windows a streaming aggregate groups by
(reference: statefulOperators.scala).
"""

from __future__ import annotations

from typing import Dict, List

from spark_tpu_torch.expr import expressions as E


class AggSpec:
    """Accumulator decomposition of one Aggregate: ``partials`` run over
    input rows grouped by ``groupings_exec`` (aliased ``key_names``),
    ``merges`` over the union of the running state and a chunk's
    partials, and ``outputs`` finalize the merged state into the
    aggregate's own output columns."""

    def __init__(self, groupings, aggregates):
        self._aggregates = tuple(aggregates)
        self.groupings = [E.strip_alias(g) for g in groupings]
        #: tumbling-window widths per grouping (None: not a window key);
        #: the window runs as plain arithmetic, its width matters only
        #: to the watermark's eviction
        self.window_widths = [
            g.width if isinstance(g, E.TumblingWindow) else None
            for g in self.groupings]
        #: the one gap-based session window grouping, if any: the
        #: streaming runner merges overlapping sessions in the state
        self.session_idx: "int | None" = None
        self.session_gap: "int | None" = None
        for i, g in enumerate(self.groupings):
            if isinstance(g, E.SessionWindow):
                if self.session_idx is not None:
                    raise NotImplementedError(
                        "multiple session_window groupings")
                self.session_idx = i
                self.session_gap = g.gap
        self.groupings_exec = [
            g.as_arith() if isinstance(g, E.TumblingWindow)
            else (g.child if isinstance(g, E.SessionWindow) else g)
            for g in self.groupings]
        self.key_names = [f"__k{i}" for i in range(len(self.groupings))]
        self.partials: List[E.Alias] = []   # over input rows
        self.merges: List[E.Alias] = []     # over union(state, partials)
        self._final: Dict[tuple, E.Expression] = {}
        for call in {E.expr_key(a): a
                     for e in self._aggregates
                     for a in E.collect_aggregates(e)}.values():
            self._add(call)
        self.outputs: List[E.Alias] = []
        key_map = {E.expr_key(g): E.Col(n)
                   for g, n in zip(self.groupings, self.key_names)}

        def repl(x: E.Expression) -> E.Expression:
            # pre-order: an aggregate call is replaced wholesale before
            # its children could be rewritten (count(k) grouped by k)
            if isinstance(x, E.AggregateExpression):
                return self._final[E.expr_key(x)]
            k = E.expr_key(x)
            if k in key_map:
                return key_map[k]
            return x

        for e in self._aggregates:
            out = E.transform_expr_down(E.strip_alias(e), repl)
            self.outputs.append(E.Alias(out, e.name))

    def _acc(self, name: str, partial: E.Expression,
             merge: E.Expression) -> None:
        self.partials.append(E.Alias(partial, name))
        self.merges.append(E.Alias(merge, name))

    def _add(self, call: E.AggregateExpression) -> None:
        from spark_tpu_torch.analysis import legality

        verdict = legality.accumulator_verdict(call)
        if not verdict.ok:
            raise NotImplementedError(verdict.reason)
        i = len(self.partials)
        k = E.expr_key(call)
        if isinstance(call, E.Count):
            n = f"__a{i}"
            self._acc(n, call, E.Sum(E.Col(n)))
            self._final[k] = E.Coalesce((E.Col(n), E.Literal(0)))
        elif isinstance(call, (E.Sum, E.Avg)):
            s, c = f"__a{i}s", f"__a{i}n"
            self._acc(s, E.Sum(call.child), E.Sum(E.Col(s)))
            self._acc(c, E.Count(call.child), E.Sum(E.Col(c)))
            nonzero = E.Cmp(">", E.Coalesce((E.Col(c), E.Literal(0))),
                            E.Literal(0))
            if isinstance(call, E.Sum):
                self._final[k] = E.Case(((nonzero, E.Col(s)),), None)
            else:
                self._final[k] = E.Case(
                    ((nonzero, E.Arith("/", E.Col(s), E.Col(c))),), None)
        else:  # Min / Max (the verdict admits nothing else)
            n = f"__a{i}"
            cls = E.Min if isinstance(call, E.Min) else E.Max
            self._acc(n, call, cls(E.Col(n)))
            self._final[k] = E.Col(n)
