"""DataFrame: a lazy logical-plan builder and its actions (the port of
``spark_tpu/api/dataframe.py``; reference: sql/core/.../Dataset.scala,
python/pyspark/sql/dataframe.py).

A DataFrame is a (session, logical plan) pair. Transformations build new
plans; actions optimize under the session's settings, plan and execute
eagerly on the session's device (``physical/planner.py``).

An action runs through the out-of-memory tier: the optimized plan goes
to ``recovery.run_plan_with_oom_degradation`` (chunked when a scan
exceeds ``spark.tpu.maxDeviceBatchBytes``, replanned there on a device
OOM), retried on a transient failure (``run_stage_with_recovery``),
with the session's cached plans substituted and pinned for the query
(``CacheManager``, ``storage.pin_scope``).

``na``, ``stat``, ``describe`` and the rest of the statistics are
``api/na_stat.py``'s. On a session with a mesh (``master("mesh[N]")``)
an action runs through ``parallel/executor.MeshExecutor``. A streaming
frame (``session.readStream``) starts with ``writeStream``
(``streaming/``). ``rdd`` collects the rows into the RDD tier
(``rdd.py``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

from spark_tpu_torch.api.row import Row
from spark_tpu_torch.columnar.batch import Batch
from spark_tpu_torch.expr import expressions as E
from spark_tpu_torch.plan import logical as L
from spark_tpu_torch.types import Schema

ColumnOrName = Union[E.Expression, str]


def _c(c: ColumnOrName) -> E.Expression:
    return c if isinstance(c, E.Expression) else E.Col(c)


def _order(c: ColumnOrName) -> E.SortOrder:
    e = _c(c)
    return e if isinstance(e, E.SortOrder) else E.SortOrder(e, ascending=True)


_JOIN_ALIASES = {"outer": "full", "full_outer": "full", "fullouter": "full",
                 "leftouter": "left", "left_outer": "left",
                 "rightouter": "right", "right_outer": "right",
                 "semi": "left_semi", "leftsemi": "left_semi",
                 "anti": "left_anti", "leftanti": "left_anti"}


class DataFrame:
    def __init__(self, session, plan: L.LogicalPlan):
        self._session = session
        self._plan = plan

    # ---- metadata ----------------------------------------------------------

    @property
    def schema(self) -> Schema:
        return self._plan.schema

    @property
    def columns(self) -> List[str]:
        return list(self._plan.schema.names)

    @property
    def sparkSession(self):
        return self._session

    def explain(self, extended: bool = False,
                mode: Optional[str] = None) -> None:
        """The logical, optimized and physical plans; ``mode="lint"``
        prints the static plan analysis instead, without executing
        (reference: Dataset.explain(mode), with the reference's extra
        "lint" mode)."""
        from spark_tpu_torch.physical.planner import plan_physical
        from spark_tpu_torch.plan.optimizer import optimize

        if mode == "lint" or extended == "lint":
            from spark_tpu_torch import analysis

            print(analysis.analyze(self._plan, self._session.conf).format())
            return
        print("== Logical Plan ==")
        print(self._plan.tree_string())
        opt = optimize(self._plan, self._session.conf)
        if extended:
            print("== Optimized Logical Plan ==")
            print(opt.tree_string())
        print("== Physical Plan ==")
        print(plan_physical(opt, self._session.device).tree_string())

    def _with(self, plan: L.LogicalPlan) -> "DataFrame":
        return DataFrame(self._session, plan)

    # ---- transformations ---------------------------------------------------

    def select(self, *cols: ColumnOrName) -> "DataFrame":
        if not cols:
            cols = tuple(self.columns)
        exprs: List[E.Expression] = []
        for c in cols:
            if isinstance(c, str) and c == "*":
                exprs.extend(E.Col(n) for n in self.columns)
            else:
                exprs.append(_c(c))
        return self._with(L.project_with_windows(tuple(exprs), self._plan))

    def selectExpr(self, *exprs: str) -> "DataFrame":
        from spark_tpu_torch.sql.parser import parse_projection

        parsed = [parse_projection(s, self._plan.schema) for s in exprs]
        return self._with(L.project_with_windows(tuple(parsed), self._plan))

    def filter(self, condition: Union[E.Expression, str]) -> "DataFrame":
        if isinstance(condition, str):
            from spark_tpu_torch.sql.parser import parse_expression

            condition = parse_expression(condition)
        return self._with(L.Filter(condition, self._plan))

    where = filter

    def withColumn(self, name: str, col: E.Expression) -> "DataFrame":
        exprs = [E.Alias(col, name) if n == name else E.Col(n)
                 for n in self.columns]
        if name not in self.columns:
            exprs.append(E.Alias(col, name))
        return self._with(L.project_with_windows(tuple(exprs), self._plan))

    def withColumnRenamed(self, old: str, new: str) -> "DataFrame":
        exprs = tuple(E.Alias(E.Col(n), new) if n == old else E.Col(n)
                      for n in self.columns)
        return self._with(L.Project(exprs, self._plan))

    def drop(self, *names: str) -> "DataFrame":
        """The columns but ``names``, an array's ``#len`` companion and
        a map's halves going with it."""
        from spark_tpu_torch.plan.optimizer import _with_nested_parts

        gone = _with_nested_parts(set(names))
        exprs = tuple(E.Col(n) for n in self.columns if n not in gone)
        return self._with(L.Project(exprs, self._plan))

    def alias(self, name: str) -> "DataFrame":
        return self._with(L.SubqueryAlias(name, self._plan))

    def distinct(self) -> "DataFrame":
        return self._with(L.Distinct(self._plan))

    def dropDuplicates(self,
                       subset: Optional[Sequence[str]] = None) -> "DataFrame":
        """One row per distinct ``subset`` (every column when None), the
        other columns from the group's first row."""
        if subset is None:
            return self.distinct()
        keys = tuple(E.Col(n) for n in subset)
        outs = tuple(E.Col(n) if n in subset
                     else E.Alias(E.First(E.Col(n)), n)
                     for n in self.columns)
        return self._with(L.Aggregate(keys, outs, self._plan))

    drop_duplicates = dropDuplicates

    def limit(self, n: int) -> "DataFrame":
        return self._with(L.Limit(n, self._plan))

    def offset(self, n: int) -> "DataFrame":
        return self._with(L.Limit(1 << 62, self._plan, offset=n))

    def sort(self, *cols: ColumnOrName, ascending=None) -> "DataFrame":
        orders = [_order(c) for c in cols]
        if ascending is not None:
            flags = ([ascending] * len(orders)
                     if isinstance(ascending, bool) else list(ascending))
            orders = [E.SortOrder(o.child, asc, o.nulls_first)
                      for o, asc in zip(orders, flags)]
        return self._with(L.Sort(tuple(orders), self._plan))

    orderBy = sort

    def sample(self, fraction: float, seed: int = 42) -> "DataFrame":
        """Each row kept with probability ``fraction``, drawn from the
        seeded stream of ``physical/random.py`` (the reference's draws,
        bit for bit: the same rows on every device)."""
        return self._with(L.Sample(float(fraction), int(seed), self._plan))

    def union(self, other: "DataFrame") -> "DataFrame":
        """UNION ALL by position (Spark's ``union``)."""
        return self._with(L.Union(self._plan, other._plan))

    unionAll = union

    def unionByName(self, other: "DataFrame") -> "DataFrame":
        reordered = other.select(*[E.Col(n) for n in self.columns])
        return self._with(L.Union(self._plan, reordered._plan))

    def join(self, other: "DataFrame", on=None,
             how: str = "inner") -> "DataFrame":
        """Join on column names (one copy of each join column is kept,
        merged for right and full outer joins), on a Column condition
        (equality conjuncts across the sides become equi-join keys, the
        rest a residual condition) or, with ``on=None``, a cross join."""
        how = _JOIN_ALIASES.get(how, how)
        if how not in L.JOIN_TYPES:
            raise ValueError(f"unsupported join type {how!r}")
        if on is None:
            return self.crossJoin(other)
        if isinstance(on, str):
            on = [on]
        if isinstance(on, (list, tuple)) and on and isinstance(on[0], str):
            return self._join_using(other, list(on), how)
        return self._join_on(other, on, how)

    def _join_using(self, other: "DataFrame", on: List[str],
                    how: str) -> "DataFrame":
        keys = tuple(E.Col(n) for n in on)
        joined = L.Join(self._plan, other._plan, how, keys, keys)
        if how in ("left_semi", "left_anti"):
            return self._with(joined)
        # the right copy of join column k is named k or k#2 after the
        # join's name dedup (Dataset.join(usingColumns) keeps one copy)
        right_start = len(self._plan.schema.names)
        names = list(joined.schema.names)
        right_copy = {}
        for n in names[right_start:]:
            base = n[:-2] if n.endswith("#2") else n
            if base in on:
                right_copy[base] = n
        keep = []
        for i, n in enumerate(names):
            if i >= right_start and n in right_copy.values():
                continue
            if i < right_start and n in on and how in ("right", "full"):
                keep.append(E.Alias(
                    E.Coalesce((E.Col(n), E.Col(right_copy[n]))), n))
            else:
                keep.append(E.Col(n))
        return self._with(L.Project(tuple(keep), joined))

    def _join_on(self, other: "DataFrame", cond: E.Expression,
                 how: str) -> "DataFrame":
        from spark_tpu_torch.plan.optimizer import (combine_conjuncts,
                                                    split_conjuncts)

        lnames = set(self._plan.schema.names)
        rnames = set(other._plan.schema.names)
        lkeys: List[E.Expression] = []
        rkeys: List[E.Expression] = []
        residual: List[E.Expression] = []
        for c in split_conjuncts(cond):
            if isinstance(c, E.Cmp) and c.op == "==":
                lr, rr = c.left.references(), c.right.references()
                if lr <= lnames and rr <= rnames:
                    lkeys.append(c.left)
                    rkeys.append(c.right)
                    continue
                if lr <= rnames and rr <= lnames:
                    lkeys.append(c.right)
                    rkeys.append(c.left)
                    continue
            residual.append(c)
        res = combine_conjuncts(residual) if residual else None
        if not lkeys and how == "inner":
            how = "cross"
        return self._with(L.Join(self._plan, other._plan, how,
                                 tuple(lkeys), tuple(rkeys), res))

    def crossJoin(self, other: "DataFrame") -> "DataFrame":
        return self._with(L.Join(self._plan, other._plan, "cross", (), ()))

    def groupBy(self, *cols: ColumnOrName) -> "GroupedData":
        return GroupedData(self, tuple(_c(c) for c in cols))

    groupby = groupBy

    def rollup(self, *cols: ColumnOrName) -> "GroupedData":
        """Hierarchical subtotals (reference: Dataset.rollup)."""
        return GroupedData(self, tuple(_c(c) for c in cols), "rollup")

    def cube(self, *cols: ColumnOrName) -> "GroupedData":
        """Every subtotal combination (reference: Dataset.cube)."""
        return GroupedData(self, tuple(_c(c) for c in cols), "cube")

    def agg(self, *exprs: E.Expression) -> "DataFrame":
        return self.groupBy().agg(*exprs)

    def __getitem__(self, item):
        if isinstance(item, str):
            return E.Col(item)
        if isinstance(item, E.Expression):
            return self.filter(item)
        raise TypeError(item)

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        if name in self._plan.schema:
            return E.Col(name)
        raise AttributeError(name)

    # ---- actions -----------------------------------------------------------

    def _execute(self) -> Batch:
        """Run the plan on the session's device: cached subtrees read
        from the store (pinned while the query runs), the optimized plan
        through the degradation ladder, a transient failure retried
        from the logical plan. The query runs in a ``query.execute``
        span (the trace root when standalone), under the default
        deadline (``spark.tpu.deadline.defaultTimeoutS``) and a fresh
        retry budget unless the caller bound them, behind the analyzer
        gate (``spark.tpu.analysis.level``), and marks its start in the
        event log (``metrics.query_start``); its measured peak stage
        bytes feed admission (``scheduler/admission.py``)."""
        from spark_tpu_torch import deadline, metrics, recovery, trace
        from spark_tpu_torch.analysis import maybe_gate
        from spark_tpu_torch.api.session import _EXECUTING
        from spark_tpu_torch.physical.planner import execute_logical
        from spark_tpu_torch.plan.optimizer import optimize
        from spark_tpu_torch.storage import pin_scope

        sess = self._session
        conf, dev = sess.conf, sess.device
        mesh = sess.mesh_executor

        def run(lp):
            if mesh is not None:
                return mesh.execute_logical(lp, optimize=False)
            return execute_logical(lp, optimize=False, device=dev, conf=conf)

        def ladder(lp):
            return recovery.run_plan_with_oom_degradation(
                lp, conf, run, dev, sess.memory_manager, mesh)

        svc = sess.compile_service

        def run_full(plan):
            """The engine with the chunking decision and the OOM ladder;
            cached plans materialize through it too, so a cached big
            aggregate chunks. A mesh session's engine is its mesh
            executor, and its ladder starts with the adaptive retry.
            With background capture on (``compile/``) a plan not
            captured yet is served eagerly meanwhile."""
            lp = optimize(plan, conf)
            if svc is not None:
                return svc.execute_plan(lp, conf, ladder)
            return ladder(lp)

        token = _EXECUTING.set(sess)
        try:
            with deadline.bind_default(conf), \
                    recovery.bind_default_budget(conf), \
                    trace.span("query.execute",
                               plan=type(self._plan).__name__):
                with trace.span("query.analysis"):
                    maybe_gate(self._plan, conf)
                metrics.query_start(self._plan.node_string())
                if svc is not None:
                    # journaled for the pre-warm, with the SQL text of a
                    # frame from session.sql
                    svc.note_served(self._plan,
                                    sql=getattr(self, "_sql_text", None))
                # every store entry the query reads stays pinned until
                # it finishes
                with trace.span("storage.pin"), pin_scope():
                    with trace.span("mview.probe"):
                        plan = sess.cache_manager.apply(self._plan,
                                                        run_full)
                    out = recovery.run_stage_with_recovery(
                        lambda: run_full(plan), conf=conf,
                        label=type(self._plan).__name__)
                    if mesh is not None:  # only a mesh measures its stages
                        self._note_measured_bytes()
                    return out
        finally:
            _EXECUTING.reset(token)

    def _note_measured_bytes(self) -> None:
        """Feed admission the measured peak stage footprint of this query
        (the largest ``stage_bytes`` event the mesh executor recorded),
        keyed on the raw logical plan: the shape
        ``QueryScheduler.submit_query`` estimates before execution, so
        the next admission of this query uses measured bytes."""
        try:
            from spark_tpu_torch import recovery
            from spark_tpu_torch.scheduler import admission

            admission.note_measured_bytes(
                self._plan, recovery.query_peak_stage_bytes())
        except Exception:  # noqa: BLE001 - never fails the query
            pass

    def collect(self) -> List[Row]:
        """The rows; an array's ``#len`` companion is hidden and a map's
        ``#keys``/``#vals`` pair is one dict (``Batch.result_columns``)."""
        names, cols = self._execute().result_columns()
        names = tuple(names)
        if len(set(names)) < len(names):
            # rows are keyed by name: of two equal names the last value
            # wins, as in to_pylist's dicts
            return [Row.from_dict(dict(zip(names, vals)))
                    for vals in zip(*cols)]
        return [Row(names, vals) for vals in zip(*cols)]

    def toArrow(self):
        from spark_tpu_torch.columnar.arrow import to_arrow

        return to_arrow(self._execute())

    def toPandas(self):
        """The rows as a pandas DataFrame (imports pandas); arrays as
        lists and maps as dicts, as ``collect()`` gives them."""
        return self._execute().to_pandas()

    def count(self) -> int:
        agg = L.Aggregate((), (E.Alias(E.Count(None), "count"),), self._plan)
        return int(self._with(agg)._execute().to_pylist()[0]["count"])

    def first(self) -> Optional[Row]:
        rows = self.limit(1).collect()
        return rows[0] if rows else None

    def head(self, n: int = 1):
        rows = self.limit(n).collect()
        return rows[0] if n == 1 and rows else rows

    def take(self, n: int) -> List[Row]:
        return self.limit(n).collect()

    def isEmpty(self) -> bool:
        return len(self.take(1)) == 0

    def show(self, n: int = 20, truncate: bool = True) -> None:
        names, cols = self.limit(n)._execute().result_columns()
        cells = [[_fmt(v, truncate) for v in r] for r in zip(*cols)]
        widths = [max([len(str(nm))] + [len(row[i]) for row in cells])
                  for i, nm in enumerate(names)]
        sep = "+" + "+".join("-" * w for w in widths) + "+"
        print(sep)
        print("|" + "|".join(str(nm).ljust(w)
                             for nm, w in zip(names, widths)) + "|")
        print(sep)
        for row in cells:
            print("|" + "|".join(v.ljust(w)
                                 for v, w in zip(row, widths)) + "|")
        print(sep)

    @property
    def write(self):
        from spark_tpu_torch.io.readwriter import DataFrameWriter

        return DataFrameWriter(self)

    def createOrReplaceTempView(self, name: str) -> None:
        self._session.catalog._register_view(name, self._plan)

    # ---- caching and checkpoints --------------------------------------------

    def cache(self) -> "DataFrame":
        """Mark this plan cached: lazily materialized on first use into
        the session's MemoryStore and read by any query containing it
        (reference: CacheManager.scala / InMemoryRelation)."""
        self._session.cache_manager.add(self._plan)
        return self

    def persist(self, storageLevel=None) -> "DataFrame":
        """``cache()``: the device store is the one storage level."""
        return self.cache()

    def unpersist(self, blocking: bool = False) -> "DataFrame":
        """Drop the plan from the cache and its batch from the store."""
        self._session.cache_manager.drop(self._plan)
        return self

    @property
    def is_cached(self) -> bool:
        return self._session.cache_manager.is_cached(self._plan)

    def checkpoint(self, eager: bool = True) -> "DataFrame":
        """Durable checkpoint: Parquet under ``spark.checkpoint.dir`` and
        a DataFrame over the files, lineage truncated (reference:
        Dataset.checkpoint, ReliableCheckpointRDD)."""
        from spark_tpu_torch.recovery import checkpoint_dataframe

        return checkpoint_dataframe(self, eager=eager)

    def localCheckpoint(self, eager: bool = True) -> "DataFrame":
        """In-memory lineage truncation: the plan cached, and
        materialized now when ``eager`` (reference:
        Dataset.localCheckpoint)."""
        df = self.cache()
        if eager:
            df.count()
        return df

    # ---- repartitioning, null handling and statistics ------------------------

    def repartition(self, num_partitions: int,
                    *cols: ColumnOrName) -> "DataFrame":
        """A hash exchange on ``cols`` (round-robin without them) on a
        mesh; on one device the rows stay as they are."""
        return self._with(L.Repartition(
            num_partitions, tuple(_c(c) for c in cols), self._plan))

    def coalesce(self, num_partitions: int) -> "DataFrame":
        return self._with(L.Repartition(num_partitions, (), self._plan))

    @property
    def na(self):
        """Null handling (reference: DataFrameNaFunctions.scala)."""
        from spark_tpu_torch.api.na_stat import DataFrameNaFunctions

        return DataFrameNaFunctions(self)

    @property
    def stat(self):
        """Statistics (reference: DataFrameStatFunctions.scala)."""
        from spark_tpu_torch.api.na_stat import DataFrameStatFunctions

        return DataFrameStatFunctions(self)

    def dropna(self, how: str = "any", thresh=None, subset=None):
        return self.na.drop(how, thresh, subset)

    def fillna(self, value, subset=None):
        return self.na.fill(value, subset)

    def replace(self, to_replace, value=None, subset=None):
        return self.na.replace(to_replace, value, subset)

    def describe(self, *cols: str):
        from spark_tpu_torch.api.na_stat import describe

        return describe(self, list(cols) or None)

    summary = describe

    def corr(self, col1: str, col2: str, method: str = "pearson") -> float:
        return self.stat.corr(col1, col2, method)

    def cov(self, col1: str, col2: str) -> float:
        return self.stat.cov(col1, col2)

    def approxQuantile(self, col, probabilities, relativeError=0.0):
        return self.stat.approxQuantile(col, probabilities, relativeError)

    def crosstab(self, col1: str, col2: str):
        return self.stat.crosstab(col1, col2)

    def freqItems(self, cols, support: float = 0.01):
        return self.stat.freqItems(cols, support)

    def sampleBy(self, col: str, fractions, seed: int = 42):
        return self.stat.sampleBy(col, fractions, seed)

    # ---- streaming ---------------------------------------------------------

    @property
    def isStreaming(self) -> bool:
        from spark_tpu_torch.streaming.execution import StreamingSource

        return bool(L.collect_nodes(self._plan, StreamingSource))

    @property
    def writeStream(self):
        """A ``DataStreamWriter`` over this streaming frame
        (``streaming/readwriter.py``)."""
        from spark_tpu_torch.streaming.readwriter import DataStreamWriter

        return DataStreamWriter(self)

    def withWatermark(self, col_name: str, delay) -> "DataFrame":
        """Mark ``col_name`` as the event time, rows later than ``delay``
        behind its largest value dropped (reference: EventTimeWatermark)."""
        from spark_tpu_torch.streaming.readwriter import with_watermark

        return with_watermark(self, col_name, delay)

    # ---- the RDD tier --------------------------------------------------------

    @property
    def rdd(self):
        """Bridge to the RDD tier (``rdd.py``): collected Rows,
        partitioned over the default parallelism (reference: Dataset.rdd
        — the escape hatch out of the columnar engine)."""
        return self._session.sparkContext.parallelize(self.collect())


def _fmt(v, truncate: bool) -> str:
    s = "NULL" if v is None else str(v)
    if truncate and len(s) > 20:
        s = s[:17] + "..."
    return s


class GroupedData:
    """The result of groupBy/rollup/cube (reference:
    sql/core/.../RelationalGroupedDataset.scala)."""

    def __init__(self, df: DataFrame, keys: Tuple[E.Expression, ...],
                 mode: str = "groupby"):
        self._df = df
        self._keys = keys
        self._mode = mode

    def agg(self, *exprs: E.Expression) -> DataFrame:
        outs = tuple(self._keys) + tuple(exprs)
        if self._mode == "groupby":
            return self._df._with(
                L.Aggregate(self._keys, outs, self._df._plan))
        from spark_tpu_torch.plan.grouping import (cube_sets,
                                                   grouping_sets_aggregate,
                                                   rollup_sets)

        sets = (rollup_sets(len(self._keys)) if self._mode == "rollup"
                else cube_sets(len(self._keys)))
        return self._df._with(grouping_sets_aggregate(
            self._df._plan, self._keys, sets, outs))

    def _simple(self, fn, cols: Tuple[str, ...]) -> DataFrame:
        key_names = {k.name for k in self._keys}
        names = cols or tuple(
            n for n in self._df.columns
            if self._df.schema.field(n).dtype.is_numeric
            and n not in key_names)
        return self.agg(*(E.Alias(fn(E.Col(n)), f"{fn.__name__.lower()}({n})")
                          for n in names))

    def sum(self, *cols: str) -> DataFrame:  # noqa: A003
        return self._simple(E.Sum, cols)

    def avg(self, *cols: str) -> DataFrame:
        return self._simple(E.Avg, cols)

    mean = avg

    def min(self, *cols: str) -> DataFrame:  # noqa: A003
        return self._simple(E.Min, cols)

    def max(self, *cols: str) -> DataFrame:  # noqa: A003
        return self._simple(E.Max, cols)

    def count(self) -> DataFrame:
        return self.agg(E.Alias(E.Count(None), "count"))

    def applyInPandasWithState(self, func, outputStructType,
                               stateStructType=None,
                               outputMode: str = "append",
                               timeoutConf: str = "NoTimeout") -> DataFrame:
        """Arbitrary stateful per-group streaming transform (reference:
        pyspark group_ops.py applyInPandasWithState,
        FlatMapGroupsWithStateExec): ``func(key_tuple, pandas_df,
        GroupState) -> pandas_df``, started with ``writeStream``.
        ``stateStructType`` is accepted for the surface (the state is
        pickled whole); ``timeoutConf="ProcessingTimeTimeout"`` enables
        ``state.setTimeoutDuration(ms)``."""
        from spark_tpu_torch.streaming.groups import FlatMapGroupsWithState
        from spark_tpu_torch.types import parse_ddl_schema

        out_schema = (outputStructType
                      if isinstance(outputStructType, Schema)
                      else parse_ddl_schema(outputStructType))
        key_names = []
        for k in self._keys:
            inner = E.strip_alias(k)
            if not isinstance(inner, E.Col):
                raise NotImplementedError(
                    "applyInPandasWithState keys must be plain columns")
            key_names.append(inner.col_name)
        if timeoutConf not in ("NoTimeout", "ProcessingTimeTimeout"):
            raise NotImplementedError(
                "timeoutConf: NoTimeout | ProcessingTimeTimeout "
                "(event-time timeouts not implemented)")
        node = FlatMapGroupsWithState(
            tuple(key_names), func, out_schema, self._df._plan,
            timeout_conf=timeoutConf)
        return self._df._with(node)
