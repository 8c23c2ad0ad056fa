"""Cost-based join reordering.

The port of ``spark_tpu/plan/join_reorder.py``.
Analogue of the reference's CostBasedJoinReorder (reference:
sql/catalyst/.../optimizer/CostBasedJoinReorder.scala:1 — a DP over join
orders driven by ANALYZE-collected statistics) and the size-estimation
side of JoinSelectionHelper. There are no persisted statistics; the
estimates come from the relations themselves (batch capacities and
distinct key counts on the device; for file scans, Parquet metadata and
pushed-filter counts through ``FileSource.count_rows`` and distinct
counts of the file columns), and a greedy pass builds a left-deep order
that keeps intermediate results small. Greedy-smallest-next rather than
full DP: TPC-H-class plans have <=8 relations and star/snowflake shapes
where greedy and DP agree.

Scope guard: only maximal clusters of INNER equi-joins are reordered,
and only when every column name in the cluster is globally unique (so
key/condition expressions keep meaning under any order; '#2' dedup
renames would otherwise shift). Residual non-equi conditions are applied
as a Filter above the reordered cluster — equivalent for inner joins.
The cluster's output column order is restored with a Project so parents
observe an identical schema.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from spark_tpu_torch.expr import expressions as E
from spark_tpu_torch.plan import logical as L
from spark_tpu_torch.plan.optimizer import combine_conjuncts, split_conjuncts


# ---- cardinality estimation -------------------------------------------------


def _filter_selectivity(cond: E.Expression) -> float:
    """Per-conjunct heuristic (reference: FilterEstimation.scala defaults
    collapsed to: equality selects less than a range predicate)."""
    sel = 1.0
    for c in split_conjuncts(cond):
        if isinstance(c, E.Cmp) and c.op == "==":
            sel *= 0.1
        elif isinstance(c, (E.In, E.Like)):
            sel *= 0.2
        else:
            sel *= 0.4
    return max(sel, 1e-4)


def estimate_rows(plan: L.LogicalPlan) -> float:
    """Output cardinality estimate. Exact at leaves (batch capacities,
    file metadata and pushed-filter counts), heuristic above them (reference: statsEstimation/
    {SizeInBytesOnlyStatsPlanVisitor,FilterEstimation,
    JoinEstimation}.scala)."""
    if isinstance(plan, L.Relation):
        return float(plan.batch.capacity)
    if isinstance(plan, L.UnresolvedScan):
        # exact: file metadata, or a memoized filtered count when
        # predicates were pushed into the scan
        return float(plan.source.count_rows(plan.filters))
    if isinstance(plan, L.Range):
        return float(plan.num_rows)
    if isinstance(plan, L.Filter):
        return max(1.0, estimate_rows(plan.child)
                   * _filter_selectivity(plan.condition))
    if isinstance(plan, L.Limit):
        return min(float(plan.n), estimate_rows(plan.child))
    if isinstance(plan, L.Sample):
        return estimate_rows(plan.child) * plan.fraction
    if isinstance(plan, L.Aggregate):
        child = estimate_rows(plan.child)
        if not plan.groupings:
            return 1.0
        return max(1.0, child ** 0.75)
    if isinstance(plan, L.Distinct):
        return max(1.0, estimate_rows(plan.child) ** 0.9)
    if isinstance(plan, L.Join):
        lr = estimate_rows(plan.left)
        rr = estimate_rows(plan.right)
        if plan.how == "cross" and not plan.left_keys:
            return lr * rr
        if plan.how in ("left_semi", "left_anti"):
            return max(1.0, lr * 0.5)
        # PK-FK assumption for equi joins: one side's keys are ~unique
        return max(lr, rr)
    if isinstance(plan, L.Union):
        return sum(estimate_rows(c) for c in plan.children())
    children = plan.children()
    if len(children) == 1:
        return estimate_rows(children[0])
    return max((estimate_rows(c) for c in children), default=1.0)


# ---- NDV (distinct-count) estimation ---------------------------------------
#
# |T join R on k| = |T|*|R| / max(ndv_T(k), ndv_R(k)) — without this, a
# many-to-many key (e.g. TPC-H q5 joining supplier to customer on
# nationkey, 25 distinct values) looks identical to a PK-FK join and the
# greedy happily materializes the junk-pair blowup.

_REL_NDV_CAP = 1 << 22  # relations larger than this: no distinct count


def _atom_ndv(atom: L.LogicalPlan, expr: E.Expression) -> Optional[float]:
    """Distinct count of a join-key expression on an atom; None =
    unknown (callers fall back to rows, i.e. assume unique). A relation's
    count is taken over its whole padded column, padding rows included,
    as the reference counts it."""
    inner = E.strip_alias(expr)
    if not isinstance(inner, E.Col):
        return None
    name = inner.col_name
    node = atom
    while True:
        if isinstance(node, (L.Filter, L.SubqueryAlias, L.Limit, L.Distinct,
                             L.Sort)):
            node = node.children()[0]
            continue
        if isinstance(node, L.Project):
            # follow plain renames only
            match = [e for e in node.exprs if e.name == name]
            if len(match) != 1:
                return None
            src = E.strip_alias(match[0])
            if not isinstance(src, E.Col):
                return None
            name = src.col_name
            node = node.child
            continue
        break
    if isinstance(node, L.Relation):
        if node.batch.capacity > _REL_NDV_CAP \
                or name not in node.batch.schema:
            return None
        data = node.batch.data.columns[node.batch.schema.index(name)].data
        return float(torch.unique(data).numel())  # host sync
    if isinstance(node, L.UnresolvedScan):
        return float(_scan_ndv(node.source, name))
    if isinstance(node, L.Range):
        return float(node.num_rows)
    return None


def _scan_ndv(source, column: str) -> int:
    """Distinct count of a file column, over every row of the files:
    one projected read per (source, column), memoized on the source
    until its files change."""
    ds = source._open()  # first: a rewrite clears the memo
    cache = source._ndv_cache
    if column not in cache:
        import pyarrow.compute as pc

        tbl = ds.to_table(columns=[column])
        cache[column] = int(pc.count_distinct(tbl.column(column)).as_py())
    return cache[column]


# ---- cluster flattening -----------------------------------------------------


def _is_scalar_side(plan: L.LogicalPlan) -> bool:
    """An ungrouped aggregate (one row), under projections, filters and
    aliases: the scalar-subquery side of a keyless join (q11, q16, q22)."""
    while isinstance(plan, (L.Project, L.Filter, L.SubqueryAlias)):
        plan = plan.children()[0]
    return isinstance(plan, L.Aggregate) and not plan.groupings


def _flatten(node: L.LogicalPlan, atoms: List[L.LogicalPlan],
             key_pairs: List[Tuple[E.Expression, E.Expression]],
             conds: List[E.Expression], cross: bool = True) -> bool:
    """Flatten a maximal inner-equi-join subtree. Returns False when the
    cluster shape is out of scope (a keyless theta join would otherwise
    be turned into a cartesian product). With ``cross``, a keyless join
    without a condition between relations that are not one-row scalar
    sides (the comma join ``part, supplier`` of q2, q8 and q9) is
    flattened too, so that the greedy order joins only connected atoms;
    the reference keeps it as one atom, a cross product (ROADMAP C)."""
    keyless_cross = (isinstance(node, L.Join) and cross
                     and node.how in ("inner", "cross")
                     and not node.left_keys and node.condition is None
                     and not _is_scalar_side(node.left)
                     and not _is_scalar_side(node.right))
    if isinstance(node, L.Join) and node.how == "inner" or keyless_cross:
        if not node.left_keys and not keyless_cross:
            return False
        if not _flatten(node.left, atoms, key_pairs, conds, cross):
            return False
        if not _flatten(node.right, atoms, key_pairs, conds, cross):
            return False
        key_pairs.extend(zip(node.left_keys, node.right_keys))
        if node.condition is not None:
            conds.append(node.condition)
        return True
    atoms.append(node)
    return True


def _atom_of(expr: E.Expression,
             name_to_atom: Dict[str, int]) -> Optional[int]:
    """The single atom an expression's references resolve to; None when
    it spans atoms or references nothing (a literal key)."""
    owners = {name_to_atom.get(n) for n in expr.references()}
    if len(owners) != 1 or None in owners:
        return None
    return owners.pop()


def reorder_joins(plan: L.LogicalPlan) -> L.LogicalPlan:
    """Top-down pass: reorder every maximal inner-join cluster of >= 3
    relations by greedy smallest-intermediate-first."""
    if isinstance(plan, L.Join) and plan.how == "inner":
        reordered = _reorder_cluster(plan)
        if reordered is not None:
            return reordered
    return plan.with_children(tuple(
        reorder_joins(c) for c in plan.children()))


def _reorder_cluster(root: L.Join) -> Optional[L.LogicalPlan]:
    """The cluster under ``root`` in greedy order. Keyless joins between
    relations are flattened into it first; where that leaves the cluster
    disconnected (a true cross product), they stay atoms as before."""
    for cross in (True, False):
        out = _reorder_flat(root, cross)
        if out is not None:
            return out
    return None


def _reorder_flat(root: L.Join, cross: bool) -> Optional[L.LogicalPlan]:
    atoms: List[L.LogicalPlan] = []
    key_pairs: List[Tuple[E.Expression, E.Expression]] = []
    conds: List[E.Expression] = []
    if not _flatten(root, atoms, key_pairs, conds, cross) or len(atoms) < 3:
        return None

    # global name uniqueness: expressions keep meaning under any order
    name_to_atom: Dict[str, int] = {}
    for i, a in enumerate(atoms):
        for n in a.schema.names:
            if n in name_to_atom:
                return None
            name_to_atom[n] = i

    # edges: (atom_i, atom_j, key_on_i, key_on_j)
    edges: List[Tuple[int, int, E.Expression, E.Expression]] = []
    for lk, rk in key_pairs:
        i = _atom_of(lk, name_to_atom)
        j = _atom_of(rk, name_to_atom)
        if i is None or j is None or i == j:
            return None
        edges.append((i, j, lk, rk))

    # recurse into atoms first (nested clusters under Projects/aggregates)
    atoms = [reorder_joins(a) for a in atoms]
    est = [estimate_rows(a) for a in atoms]

    # per-edge NDVs; None -> assume unique on that atom
    edge_ndv = [(_atom_ndv(atoms[i], ki), _atom_ndv(atoms[j], kj))
                for (i, j, ki, kj) in edges]

    def join_size(t_est: float, joined: set, c: int) -> Tuple[float, int]:
        """(estimated output size, 0 if some edge is ~PK-FK else 1).
        size = t*r / max_k(max(ndv_t, ndv_c)) over the connecting keys;
        unknown NDV counts as the side's row estimate (unique)."""
        denom = 1.0
        fkish = 1
        for e, (i, j, _, _) in enumerate(edges):
            ndv_i, ndv_j = edge_ndv[e]
            if i in joined and j == c:
                nt, nc, t_atom, c_atom = ndv_i, ndv_j, i, j
            elif j in joined and i == c:
                nt, nc, t_atom, c_atom = ndv_j, ndv_i, j, i
            else:
                continue
            nt = nt if nt is not None else est[t_atom]
            nc = nc if nc is not None else est[c_atom]
            denom = max(denom, max(nt, nc))
            # PK-FK: one side's key is ~unique on its atom
            if nc >= 0.8 * est[c_atom] or nt >= 0.8 * est[t_atom]:
                fkish = 0
        return t_est * est[c] / denom, fkish

    n = len(atoms)
    start = min(range(n), key=lambda i: est[i])
    joined = {start}
    tree: L.LogicalPlan = atoms[start]
    tree_est = est[start]
    while len(joined) < n:
        connected = set()
        for (i, j, _, _) in edges:
            if i in joined and j not in joined:
                connected.add(j)
            elif j in joined and i not in joined:
                connected.add(i)
        if not connected:
            # disconnected components despite keys: out of scope
            return None

        # cost of joining candidate c next: PK-FK edges first, then the
        # smallest estimated output, then the smaller input
        def cost(x: int):
            size, non_fk = join_size(tree_est, joined, x)
            return (non_fk, size, est[x])

        c = min(connected, key=cost)
        new_est = join_size(tree_est, joined, c)[0]
        lkeys: List[E.Expression] = []
        rkeys: List[E.Expression] = []
        for (i, j, ki, kj) in edges:
            if i in joined and j == c:
                lkeys.append(ki)
                rkeys.append(kj)
            elif j in joined and i == c:
                lkeys.append(kj)
                rkeys.append(ki)
        tree = L.Join(tree, atoms[c], "inner",
                      tuple(lkeys), tuple(rkeys), None)
        tree_est = max(new_est, 1.0)
        joined.add(c)

    if conds:
        tree = L.Filter(combine_conjuncts(conds), tree)
    # restore the original output column order for parents
    orig = root.schema.names
    if tuple(tree.schema.names) != tuple(orig):
        tree = L.Project(tuple(E.Col(nm) for nm in orig), tree)
    return tree
