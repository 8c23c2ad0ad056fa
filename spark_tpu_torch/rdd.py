"""RDD tier: SparkContext + lineage-tracked partitioned collections.

The port of ``spark_tpu/rdd.py`` (reference: core/.../rdd/RDD.scala —
checkpoint:1627; Dependency.scala; Partitioner.scala) and of the
task-retry half of the scheduler (reference:
scheduler/DAGScheduler.scala:1762 handleTaskCompletion resubmits lost
tasks by recomputing their lineage; TaskSetManager maxTaskFailures).

The RDD is the arbitrary-Python-object escape hatch, as in modern
PySpark: closures cannot run on the device, so this tier executes on
the host over partitioned lists, while ``toDF()`` / ``DataFrame.rdd``
bridge to the columnar engine, which runs on the session's device. What
is kept from the reference is the semantics users rely on: lazy lineage
(a partition is recomputed from its parents on failure — recompute is
the fault-tolerance story, there is no replication), narrow vs shuffle
dependencies, hash partitioning for *ByKey ops, ``cache()`` as
materialized partitions, and ``checkpoint()`` as lineage truncation to
durable storage.

Failure handling: every partition computation runs as a *task* with
``spark.task.maxFailures`` attempts (reference: TaskSetManager.scala) —
a flaky closure (e.g. transient IO) is retried from lineage, a
deterministic error surfaces after the attempt budget; each re-attempt
draws from the query's retry budget (``recovery.retry_allowed``).

``SparkContext.defaultParallelism`` is ``max(2, n)`` with ``n`` the
number of devices the session runs on: 1 for one card or a CPU session,
N under ``mesh[N]``. (The reference counts its JAX devices, 8 under its
test harness's virtual CPU devices, so a parity test passes
``numSlices`` explicitly.)
"""

from __future__ import annotations

import builtins
import itertools
import os
import pickle
import random
from collections import defaultdict
from typing import Any, Callable, Iterable, List, Optional, Tuple

from spark_tpu_torch.conf import TASK_MAX_FAILURES


class Broadcast:
    """Read-only value shared with every task (reference:
    broadcast/TorrentBroadcast.scala:59 — in a single driver process the
    torrent protocol collapses to a handle; on the mesh tier large
    columnar broadcasts ride the exchange in parallel/exchange.py)."""

    def __init__(self, value: Any):
        self._value = value

    @property
    def value(self) -> Any:
        return self._value

    def unpersist(self) -> None:
        self._value = None

    def destroy(self) -> None:
        self._value = None


class Accumulator:
    """Add-only shared counter (reference: util/AccumulatorV2.scala)."""

    def __init__(self, value: Any):
        self.value = value

    def add(self, term: Any) -> None:
        self.value = self.value + term

    def __iadd__(self, term: Any) -> "Accumulator":
        self.add(term)
        return self


class RDD:
    """A lazily-evaluated, partitioned collection with lineage."""

    _next_id = itertools.count()

    def __init__(self, sc: "SparkContext", num_partitions: int,
                 compute: Callable[[int], List[Any]],
                 parents: Tuple["RDD", ...] = (),
                 name: str = "rdd"):
        self._sc = sc
        self._num_partitions = num_partitions
        self._compute = compute
        self._parents = parents
        self._name = name
        self.id = next(RDD._next_id)
        self._cached: Optional[List[List[Any]]] = None
        self._cache_requested = False
        self._checkpoint_requested = False
        self._checkpoint_dir: Optional[str] = None

    # -- partitions & tasks --------------------------------------------------

    def getNumPartitions(self) -> int:
        return self._num_partitions

    def _partition(self, i: int) -> List[Any]:
        """Materialize partition i, honoring cache/checkpoint tiers and
        running the compute as a retried task."""
        if self._cached is not None:
            return self._cached[i]
        if self._checkpoint_dir is not None:
            with open(self._ckpt_path(i), "rb") as f:
                return pickle.load(f)
        part = self._run_task(i)
        if self._cache_requested:
            # materialize ALL partitions on first touch so cache state
            # is consistent (reference: BlockManager.getOrElseUpdate)
            self._cached = [part if j == i else self._run_task(j)
                            for j in range(self._num_partitions)]
        if self._checkpoint_requested:
            self._do_checkpoint()
        return part

    def _run_task(self, i: int) -> List[Any]:
        from spark_tpu_torch import recovery

        attempts = int(self._sc._conf_get(TASK_MAX_FAILURES))
        last: Optional[BaseException] = None
        for attempt in range(max(1, attempts)):
            try:
                return list(self._compute(i))
            except Exception as e:  # lineage recompute on next attempt
                last = e
                if attempt + 1 < max(1, attempts) \
                        and not recovery.retry_allowed("rdd.task"):
                    break
        raise RuntimeError(
            f"task failed {attempts} times: {self._name} partition {i}"
        ) from last

    def _all_partitions(self) -> List[List[Any]]:
        return [self._partition(i) for i in range(self._num_partitions)]

    # -- persistence ---------------------------------------------------------

    def cache(self) -> "RDD":
        self._cache_requested = True
        return self

    persist = cache

    def unpersist(self) -> "RDD":
        self._cache_requested = False
        self._cached = None
        return self

    def checkpoint(self) -> None:
        """Mark for truncation to durable storage on next materialization
        (reference: RDD.scala:1627 — checkpointed data replaces lineage,
        bounding recompute chains)."""
        if self._sc._checkpoint_dir is None:
            raise RuntimeError("call sc.setCheckpointDir(path) first")
        self._checkpoint_requested = True

    def localCheckpoint(self) -> None:
        self.cache()

    def isCheckpointed(self) -> bool:
        return self._checkpoint_dir is not None

    def _ckpt_path(self, i: int) -> str:
        assert self._checkpoint_dir is not None
        return os.path.join(self._checkpoint_dir, f"part-{i:05d}.pkl")

    def _do_checkpoint(self) -> None:
        d = os.path.join(self._sc._checkpoint_dir, f"rdd-{self.id}")
        os.makedirs(d, exist_ok=True)
        parts = [self._run_task(i) for i in range(self._num_partitions)]
        self._checkpoint_dir = d
        for i, p in enumerate(parts):
            with open(self._ckpt_path(i), "wb") as f:
                pickle.dump(p, f)
        self._parents = ()  # lineage truncated

    # -- narrow transformations ----------------------------------------------

    def _derive(self, fn: Callable[[int, List[Any]], List[Any]],
                name: str) -> "RDD":
        parent = self

        def compute(i: int) -> List[Any]:
            return fn(i, parent._partition(i))

        return RDD(self._sc, self._num_partitions, compute,
                   (parent,), name)

    def map(self, f: Callable) -> "RDD":
        return self._derive(lambda i, p: [f(x) for x in p], "map")

    def filter(self, f: Callable) -> "RDD":
        return self._derive(lambda i, p: [x for x in p if f(x)], "filter")

    def flatMap(self, f: Callable) -> "RDD":
        return self._derive(
            lambda i, p: [y for x in p for y in f(x)], "flatMap")

    def mapPartitions(self, f: Callable[[Iterable], Iterable]) -> "RDD":
        return self._derive(lambda i, p: list(f(iter(p))), "mapPartitions")

    def mapPartitionsWithIndex(self, f) -> "RDD":
        return self._derive(lambda i, p: list(f(i, iter(p))),
                            "mapPartitionsWithIndex")

    def mapValues(self, f: Callable) -> "RDD":
        return self.map(lambda kv: (kv[0], f(kv[1])))

    def flatMapValues(self, f: Callable) -> "RDD":
        return self.flatMap(lambda kv: [(kv[0], v) for v in f(kv[1])])

    def keyBy(self, f: Callable) -> "RDD":
        return self.map(lambda x: (f(x), x))

    def keys(self) -> "RDD":
        return self.map(lambda kv: kv[0])

    def values(self) -> "RDD":
        return self.map(lambda kv: kv[1])

    def zipWithIndex(self) -> "RDD":
        parent = self
        sizes = [len(p) for p in self._all_partitions()]
        offsets = [0]
        for s in sizes[:-1]:
            offsets.append(offsets[-1] + s)

        def compute(i: int) -> List[Any]:
            return [(x, offsets[i] + j)
                    for j, x in enumerate(parent._partition(i))]

        return RDD(self._sc, self._num_partitions, compute, (parent,),
                   "zipWithIndex")

    def sample(self, withReplacement: bool, fraction: float,
               seed: Optional[int] = None) -> "RDD":
        base = seed if seed is not None else 17

        def fn(i: int, p: List[Any]) -> List[Any]:
            rng = random.Random(base * 1000003 + i)
            if withReplacement:
                n = int(len(p) * fraction + 0.5)
                return [rng.choice(p) for _ in range(n)] if p else []
            return [x for x in p if rng.random() < fraction]

        return self._derive(fn, "sample")

    def union(self, other: "RDD") -> "RDD":
        left, right = self, other

        def compute(i: int) -> List[Any]:
            if i < left._num_partitions:
                return left._partition(i)
            return right._partition(i - left._num_partitions)

        return RDD(self._sc, left._num_partitions + right._num_partitions,
                   compute, (left, right), "union")

    def glom(self) -> "RDD":
        return self._derive(lambda i, p: [p], "glom")

    # -- shuffle transformations ---------------------------------------------

    def _shuffle_by_key(self, num_partitions: Optional[int]) -> "RDD":
        """Hash-partition (k, v) pairs (reference: Partitioner.scala
        HashPartitioner; the mesh engine's peer is the all_to_all
        exchange in parallel/exchange.py)."""
        parent = self
        n = num_partitions or self._num_partitions
        state: dict = {}

        def compute(i: int) -> List[Any]:
            if "buckets" not in state:
                buckets: List[List[Any]] = [[] for _ in range(n)]
                for p in range(parent._num_partitions):
                    for kv in parent._partition(p):
                        buckets[hash(kv[0]) % n].append(kv)
                state["buckets"] = buckets
            return state["buckets"][i]

        return RDD(self._sc, n, compute, (parent,), "shuffle")

    def partitionBy(self, numPartitions: int) -> "RDD":
        return self._shuffle_by_key(numPartitions)

    def groupByKey(self, numPartitions: Optional[int] = None) -> "RDD":
        shuffled = self._shuffle_by_key(numPartitions)

        def fn(i: int, p: List[Any]) -> List[Any]:
            groups: dict = defaultdict(list)
            for k, v in p:
                groups[k].append(v)
            return list(groups.items())

        return shuffled._derive(fn, "groupByKey")

    def reduceByKey(self, f: Callable,
                    numPartitions: Optional[int] = None) -> "RDD":
        parent = self

        # map-side combine before the shuffle (reference:
        # Aggregator.scala combineValuesByKey)
        def combine(i: int, p: List[Any]) -> List[Any]:
            acc: dict = {}
            for k, v in p:
                acc[k] = f(acc[k], v) if k in acc else v
            return list(acc.items())

        return parent._derive(combine, "mapSideCombine") \
            ._shuffle_by_key(numPartitions) \
            ._derive(combine, "reduceByKey")

    def combineByKey(self, createCombiner, mergeValue, mergeCombiners,
                     numPartitions: Optional[int] = None) -> "RDD":
        def fn(i: int, p: List[Any]) -> List[Any]:
            acc: dict = {}
            for k, v in p:
                acc[k] = mergeValue(acc[k], v) if k in acc \
                    else createCombiner(v)
            return list(acc.items())

        shuffled = self._derive(fn, "combineLocal") \
            ._shuffle_by_key(numPartitions)

        def merge(i: int, p: List[Any]) -> List[Any]:
            acc: dict = {}
            for k, c in p:
                acc[k] = mergeCombiners(acc[k], c) if k in acc else c
            return list(acc.items())

        return shuffled._derive(merge, "combineByKey")

    def aggregateByKey(self, zeroValue, seqFunc, combFunc,
                       numPartitions: Optional[int] = None) -> "RDD":
        import copy

        return self.combineByKey(
            lambda v: seqFunc(copy.deepcopy(zeroValue), v),
            seqFunc, combFunc, numPartitions)

    def distinct(self, numPartitions: Optional[int] = None) -> "RDD":
        return self.map(lambda x: (x, None)) \
            .reduceByKey(lambda a, b: a, numPartitions) \
            .map(lambda kv: kv[0])

    def cogroup(self, other: "RDD",
                numPartitions: Optional[int] = None) -> "RDD":
        tagged = self.mapValues(lambda v: (0, v)) \
            .union(other.mapValues(lambda v: (1, v)))
        grouped = tagged.groupByKey(
            numPartitions or max(self._num_partitions,
                                 other._num_partitions))

        def fn(i: int, p: List[Any]) -> List[Any]:
            out = []
            for k, tags in p:
                ls = [v for t, v in tags if t == 0]
                rs = [v for t, v in tags if t == 1]
                out.append((k, (ls, rs)))
            return out

        return grouped._derive(fn, "cogroup")

    def join(self, other: "RDD",
             numPartitions: Optional[int] = None) -> "RDD":
        return self.cogroup(other, numPartitions).flatMap(
            lambda kv: [(kv[0], (l, r)) for l in kv[1][0]
                        for r in kv[1][1]])

    def leftOuterJoin(self, other: "RDD",
                      numPartitions: Optional[int] = None) -> "RDD":
        def expand(kv):
            k, (ls, rs) = kv
            return [(k, (l, r)) for l in ls for r in (rs or [None])]

        return self.cogroup(other, numPartitions).flatMap(expand)

    def sortBy(self, keyfunc: Callable, ascending: bool = True,
               numPartitions: Optional[int] = None) -> "RDD":
        parent = self
        n = numPartitions or self._num_partitions
        state: dict = {}

        def compute(i: int) -> List[Any]:
            if "parts" not in state:
                data = sorted((x for p in parent._all_partitions()
                               for x in p),
                              key=keyfunc, reverse=not ascending)
                step = max(1, (len(data) + n - 1) // n)
                state["parts"] = [data[j * step:(j + 1) * step]
                                  for j in range(n)]
            return state["parts"][i]

        return RDD(self._sc, n, compute, (parent,), "sortBy")

    def sortByKey(self, ascending: bool = True,
                  numPartitions: Optional[int] = None) -> "RDD":
        return self.sortBy(lambda kv: kv[0], ascending, numPartitions)

    def repartition(self, numPartitions: int) -> "RDD":
        parent = self
        state: dict = {}

        def compute(i: int) -> List[Any]:
            if "parts" not in state:
                data = [x for p in parent._all_partitions() for x in p]
                state["parts"] = [data[j::numPartitions]
                                  for j in range(numPartitions)]
            return state["parts"][i]

        return RDD(self._sc, numPartitions, compute, (parent,),
                   "repartition")

    def coalesce(self, numPartitions: int) -> "RDD":
        return self.repartition(min(numPartitions, self._num_partitions))

    # -- actions -------------------------------------------------------------

    def collect(self) -> List[Any]:
        return [x for p in self._all_partitions() for x in p]

    def count(self) -> int:
        return sum(len(p) for p in self._all_partitions())

    def first(self) -> Any:
        got = self.take(1)
        if not got:
            raise ValueError("RDD is empty")
        return got[0]

    def take(self, n: int) -> List[Any]:
        out: List[Any] = []
        for i in range(self._num_partitions):
            out.extend(self._partition(i))
            if len(out) >= n:
                break
        return out[:n]

    def top(self, n: int, key: Optional[Callable] = None) -> List[Any]:
        return sorted(self.collect(), key=key, reverse=True)[:n]

    def reduce(self, f: Callable) -> Any:
        parts = [p for p in self._all_partitions() if p]
        if not parts:
            raise ValueError("RDD is empty")
        import functools

        partials = [functools.reduce(f, p) for p in parts]
        return functools.reduce(f, partials)

    def fold(self, zeroValue, f: Callable) -> Any:
        acc = zeroValue
        for p in self._all_partitions():
            part = zeroValue
            for x in p:
                part = f(part, x)
            acc = f(acc, part)
        return acc

    def aggregate(self, zeroValue, seqOp, combOp) -> Any:
        import copy

        acc = copy.deepcopy(zeroValue)
        for p in self._all_partitions():
            part = copy.deepcopy(zeroValue)
            for x in p:
                part = seqOp(part, x)
            acc = combOp(acc, part)
        return acc

    def countByKey(self) -> dict:
        out: dict = defaultdict(int)
        for p in self._all_partitions():
            for k, _ in p:
                out[k] += 1
        return dict(out)

    def countByValue(self) -> dict:
        out: dict = defaultdict(int)
        for p in self._all_partitions():
            for x in p:
                out[x] += 1
        return dict(out)

    def foreach(self, f: Callable) -> None:
        for p in self._all_partitions():
            for x in p:
                f(x)

    def foreachPartition(self, f: Callable) -> None:
        for p in self._all_partitions():
            f(iter(p))

    def sum(self) -> Any:
        return builtins.sum(x for p in self._all_partitions() for x in p)

    def mean(self) -> float:
        total, n = 0.0, 0
        for p in self._all_partitions():
            total += builtins.sum(p)
            n += len(p)
        if n == 0:
            raise ValueError("RDD is empty")
        return total / n

    def max(self, key: Optional[Callable] = None) -> Any:
        return builtins.max(self.collect(), key=key)

    def min(self, key: Optional[Callable] = None) -> Any:
        return builtins.min(self.collect(), key=key)

    def isEmpty(self) -> bool:
        return not self.take(1)

    def saveAsTextFile(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        for i in range(self._num_partitions):
            with open(os.path.join(path, f"part-{i:05d}"), "w") as f:
                for x in self._partition(i):
                    f.write(str(x) + "\n")
        with open(os.path.join(path, "_SUCCESS"), "w"):
            pass

    # -- bridge to the columnar engine ---------------------------------------

    def toDF(self, schema: Optional[List[str]] = None):
        """Materialize into the columnar engine, on the session's
        device."""
        session = self._sc._session
        rows = self.collect()
        if rows and isinstance(rows[0], tuple) and schema is not None:
            return session.createDataFrame(rows, schema)
        if rows and isinstance(rows[0], dict):
            return session.createDataFrame(rows)
        if schema is None:
            schema = ["value"]
        return session.createDataFrame([(r,) if not isinstance(r, tuple)
                                        else r for r in rows], schema)

    def toDebugString(self) -> bytes:
        lines = []

        def walk(r: "RDD", depth: int) -> None:
            lines.append("  " * depth + f"({r._num_partitions}) "
                         f"{r._name} [{r.id}]")
            for p in r._parents:
                walk(p, depth + 1)

        walk(self, 0)
        return "\n".join(lines).encode()

    def __repr__(self):
        return f"RDD[{self.id}] {self._name} ({self._num_partitions} parts)"


class SparkContext:
    """Driver-side entry point for the RDD tier (reference:
    SparkContext.scala:85, pared to what exists without a JVM cluster:
    the 'cluster' is this process plus the session's devices)."""

    def __init__(self, session):
        self._session = session
        self._checkpoint_dir: Optional[str] = None

    def _conf_get(self, entry) -> Any:
        return self._session.conf.get(entry)

    @property
    def defaultParallelism(self) -> int:
        """``max(2, n)``: ``n`` devices under ``mesh[n]``, else 1."""
        mesh = self._session._mesh
        return max(2, 1 if mesh is None else len(mesh.devices))

    def parallelize(self, data: Iterable,
                    numSlices: Optional[int] = None) -> RDD:
        items = list(data)
        n = numSlices or min(self.defaultParallelism,
                             builtins.max(1, len(items)))
        step = (len(items) + n - 1) // n if items else 1
        parts = [items[i * step:(i + 1) * step] for i in range(n)]

        return RDD(self, n, lambda i: parts[i], (), "parallelize")

    def range(self, start: int, end: Optional[int] = None,
              step: int = 1, numSlices: Optional[int] = None) -> RDD:
        if end is None:
            start, end = 0, start
        return self.parallelize(builtins.range(start, end, step), numSlices)

    def emptyRDD(self) -> RDD:
        return RDD(self, 1, lambda i: [], (), "empty")

    def textFile(self, path: str,
                 minPartitions: Optional[int] = None) -> RDD:
        """One element per line; a directory reads every part file
        (reference: SparkContext.textFile -> HadoopRDD)."""
        paths: List[str]
        if os.path.isdir(path):
            paths = sorted(
                os.path.join(path, f) for f in os.listdir(path)
                if not f.startswith("_") and not f.startswith("."))
        else:
            paths = [path]

        def compute(i: int) -> List[str]:
            with open(paths[i]) as f:
                return [ln.rstrip("\n") for ln in f]

        return RDD(self, len(paths), compute, (), "textFile")

    def wholeTextFiles(self, path: str) -> RDD:
        files = sorted(
            os.path.join(path, f) for f in os.listdir(path)
            if os.path.isfile(os.path.join(path, f)))

        def compute(i: int) -> List[Tuple[str, str]]:
            with open(files[i]) as f:
                return [(files[i], f.read())]

        return RDD(self, builtins.max(1, len(files)), compute, (),
                   "wholeTextFiles")

    def union(self, rdds: List[RDD]) -> RDD:
        out = rdds[0]
        for r in rdds[1:]:
            out = out.union(r)
        return out

    def broadcast(self, value: Any) -> Broadcast:
        return Broadcast(value)

    def accumulator(self, value: Any) -> Accumulator:
        return Accumulator(value)

    def setCheckpointDir(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        self._checkpoint_dir = path
        # shared with DataFrame.checkpoint() (recovery.CHECKPOINT_DIR)
        self._session.conf.set("spark.checkpoint.dir", path)

    def stop(self) -> None:
        self._session.stop()
