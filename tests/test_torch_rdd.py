"""The port's RDD tier (``spark_tpu_torch/rdd.py``) against the JAX
package's on the cases of tests/test_rdd.py: each case is written once,
over a ``SparkContext`` (and its session), runs through both packages
and must give equal results, exactly (the tier is host Python over
partitioned lists in both). Partition counts are passed explicitly where
a case depends on them: the default parallelism counts the session's
devices (1 here, so 2) where the reference counts its 8 virtual CPU
devices.
"""

import os

import pytest

from spark_tpu_torch.api.session import SparkSession as PortSession


@pytest.fixture(scope="module")
def engines(spark):
    """(SparkContext, session) of each package."""
    port = PortSession.builder.device("cpu").master("local").getOrCreate()
    return {"ref": (spark.sparkContext, spark),
            "port": (port.sparkContext, port)}


def _both(engines, case):
    """``case(sc, session)`` through both packages; the port's result
    equals the reference's, and is returned."""
    got = case(*engines["port"])
    want = case(*engines["ref"])
    assert got == want, (got, want)
    return got


def test_parallelize_map_filter_collect(engines):
    def case(sc, _):
        r = sc.parallelize(range(100), 4)
        return (r.getNumPartitions(),
                r.map(lambda x: x * 2).filter(lambda x: x % 10 == 0)
                .collect(),
                r.count(), r.sum(), r.take(3), r.first())

    assert _both(engines, case)[2:] == (100, 4950, [0, 1, 2], 0)


def test_flatmap_distinct_union(engines):
    def case(sc, _):
        words = sc.parallelize(["a b", "b c", "a c"], 3).flatMap(str.split)
        u = sc.parallelize([1, 2], 2).union(sc.parallelize([3], 1))
        return (words.count(), words.distinct().collect(),
                u.collect(), u.getNumPartitions())

    got = _both(engines, case)
    assert got[0] == 6 and sorted(got[1]) == ["a", "b", "c"]


def test_reduce_fold_aggregate(engines):
    def case(sc, _):
        r = sc.parallelize(range(1, 11), 3)
        return (r.reduce(lambda a, b: a + b), r.fold(0, lambda a, b: a + b),
                r.aggregate((0, 0), lambda acc, x: (acc[0] + 1, acc[1] + x),
                            lambda a, b: (a[0] + b[0], a[1] + b[1])),
                r.mean(), r.max(), r.min(), r.top(2), r.isEmpty())

    assert _both(engines, case)[:3] == (55, 55, (10, 55))


def test_bykey_ops(engines):
    def case(sc, _):
        pairs = sc.parallelize(
            [("a", 1), ("b", 2), ("a", 3), ("c", 4), ("b", 5)], 3)
        avg = pairs.combineByKey(
            lambda v: (v, 1),
            lambda c, v: (c[0] + v, c[1] + 1),
            lambda a, b: (a[0] + b[0], a[1] + b[1]))
        return (pairs.reduceByKey(lambda a, b: a + b).collect(),
                pairs.groupByKey().mapValues(sorted).collect(),
                pairs.countByKey(), pairs.countByValue(),
                avg.mapValues(lambda c: c[0] / c[1]).collect(),
                pairs.aggregateByKey([], lambda acc, v: acc + [v],
                                     lambda a, b: a + b, 2).collect(),
                pairs.partitionBy(2).glom().collect(),
                pairs.keys().collect(), pairs.values().collect(),
                pairs.flatMapValues(lambda v: range(v % 3)).collect(),
                pairs.keyBy(lambda kv: kv[1] % 2).collect())

    got = _both(engines, case)
    assert dict(got[0]) == {"a": 4, "b": 7, "c": 4}
    assert dict(got[4]) == {"a": 2.0, "b": 3.5, "c": 4.0}


def test_join_cogroup(engines):
    def case(sc, _):
        left = sc.parallelize([("a", 1), ("b", 2), ("a", 3)], 2)
        right = sc.parallelize([("a", "x"), ("c", "y")], 2)
        return (left.join(right).collect(),
                left.leftOuterJoin(right).collect(),
                left.cogroup(right).collect())

    got = _both(engines, case)
    assert sorted(got[0]) == [("a", (1, "x")), ("a", (3, "x"))]
    assert ("b", (2, None)) in got[1]


def test_sort_and_glom(engines):
    def case(sc, _):
        r = sc.parallelize([5, 3, 1, 4, 2], 2)
        pairs = sc.parallelize([(2, "b"), (1, "a")], 2)
        return (r.sortBy(lambda x: x).collect(),
                r.sortBy(lambda x: x, ascending=False).collect(),
                pairs.sortByKey().collect(), r.glom().collect(),
                r.repartition(3).glom().collect(),
                r.coalesce(1).collect(),
                r.mapPartitions(lambda it: [sum(it)]).collect(),
                r.mapPartitionsWithIndex(
                    lambda i, it: [(i, list(it))]).collect())

    assert _both(engines, case)[:3] == (
        [1, 2, 3, 4, 5], [5, 4, 3, 2, 1], [(1, "a"), (2, "b")])


def test_task_retry_recomputes_from_lineage(engines):
    """A transiently failing closure succeeds through a lineage recompute
    (reference: TaskSetManager maxTaskFailures; DAGScheduler resubmit)."""
    def case(sc, _):
        attempts = {"n": 0}

        def flaky(x):
            attempts["n"] += 1
            if attempts["n"] <= 2:
                raise IOError("transient")
            return x

        return sc.parallelize([1], 1).map(flaky).collect(), attempts["n"]

    assert _both(engines, case) == ([1], 3)


def test_task_fails_after_budget(engines):
    def case(sc, spark):
        calls = {"n": 0}

        def always(x):
            calls["n"] += 1
            raise ValueError("deterministic")

        with pytest.raises(RuntimeError, match="task failed 4 times"):
            sc.parallelize([1], 1).map(always).collect()
        spark.conf.set("spark.task.maxFailures", 2)
        try:
            with pytest.raises(RuntimeError, match="task failed 2 times"):
                sc.parallelize([1], 1).map(always).collect()
        finally:
            spark.conf.unset("spark.task.maxFailures")
        return calls["n"]

    assert _both(engines, case) == 6


def test_checkpoint_truncates_lineage(engines, tmp_path):
    def case(sc, spark):
        d = tmp_path / type(spark).__module__
        sc.setCheckpointDir(str(d))
        r = sc.parallelize(range(10), 2).map(lambda x: x + 1)
        r.checkpoint()
        first = r.collect()
        files = sorted(os.listdir(d / f"rdd-{r.id}"))
        # reads come from the checkpoint files now
        return (first, r.isCheckpointed(), r._parents, r.collect(), files,
                spark.conf.get("spark.checkpoint.dir") == str(d))

    assert _both(engines, case)[:4] == (list(range(1, 11)), True, (),
                                        list(range(1, 11)))


def test_checkpoint_needs_a_directory(engines):
    def case(sc, _):
        saved = sc._checkpoint_dir
        sc._checkpoint_dir = None
        try:
            with pytest.raises(RuntimeError, match="setCheckpointDir"):
                sc.parallelize([1], 1).checkpoint()
        finally:
            sc._checkpoint_dir = saved
        return True

    _both(engines, case)


def test_cache(engines):
    def case(sc, _):
        calls = {"n": 0}

        def tracked(x):
            calls["n"] += 1
            return x

        r = sc.parallelize(range(8), 2).map(tracked).cache()
        counts = [r.count()]
        first = calls["n"]
        counts.append(r.count())  # served from the cache
        r.unpersist()
        counts.append(r.count())
        return counts, first, calls["n"]

    assert _both(engines, case) == ([8, 8, 8], 8, 16)


def test_textfile_roundtrip(engines, tmp_path):
    def case(sc, spark):
        out = str(tmp_path / type(spark).__module__ / "out")
        sc.parallelize(["x", "y", "z"], 2).saveAsTextFile(out)
        whole = sc.wholeTextFiles(out).map(
            lambda kv: (os.path.basename(kv[0]), kv[1])).collect()
        return (os.path.exists(os.path.join(out, "_SUCCESS")),
                sc.textFile(out).collect(), whole)

    got = _both(engines, case)
    assert got[0] and sorted(got[1]) == ["x", "y", "z"]


def test_broadcast_accumulator(engines):
    def case(sc, _):
        b = sc.broadcast({"k": 10})
        acc = sc.accumulator(0)
        sc.parallelize(range(5), 2).foreach(
            lambda x: acc.add(x * b.value["k"]))
        acc += 1
        seen = []
        sc.parallelize(range(5), 2).foreachPartition(
            lambda it: seen.append(list(it)))
        return acc.value, seen

    assert _both(engines, case)[0] == 101


def test_df_rdd_bridge(engines):
    """``DataFrame.rdd`` and ``toDF`` (the bridge to the columnar
    engine)."""
    def case(sc, spark):
        r = spark.range(10).rdd
        df2 = sc.parallelize([(1, "a"), (2, "b")], 2).toDF(["n", "s"])
        dicts = sc.parallelize([{"p": 1.5}, {"p": 2.5}], 2).toDF()
        plain = sc.parallelize([3, 4], 2).toDF()
        return (r.count(), sorted(row["id"] for row in r.collect()),
                df2.count(), sorted(df2.columns),
                [tuple(x) for x in df2.collect()],
                [tuple(x) for x in dicts.collect()], plain.columns,
                [tuple(x) for x in plain.collect()])

    assert _both(engines, case)[:4] == (10, list(range(10)), 2, ["n", "s"])


def test_zip_with_index_sample(engines):
    def case(sc, _):
        r = sc.parallelize(list("abcdef"), 3).zipWithIndex()
        s = sc.parallelize(range(1000), 4).sample(False, 0.1, seed=1)
        w = sc.parallelize(range(100), 4).sample(True, 0.5, seed=3)
        return r.collect(), s.collect(), w.collect()

    got = _both(engines, case)
    assert got[0] == [(c, i) for i, c in enumerate("abcdef")]
    assert 50 < len(got[1]) < 200


def test_debug_string_shows_lineage(engines):
    def case(sc, _):
        r = sc.parallelize([1], 1).map(lambda x: x).filter(bool)
        s = r.toDebugString().decode()
        return ["(1) filter", "(1) map", "(1) parallelize"] == [
            line.strip().split(" [")[0] for line in s.splitlines()]

    assert _both(engines, case)


def test_context_sources(engines):
    """``range``, ``emptyRDD`` and ``sc.union``."""
    def case(sc, _):
        return (sc.range(2, 12, 3, numSlices=2).glom().collect(),
                sc.range(5, numSlices=2).collect(),
                sc.emptyRDD().collect(), sc.emptyRDD().isEmpty(),
                sc.union([sc.parallelize([1], 1), sc.parallelize([2], 1),
                          sc.parallelize([3], 1)]).collect())

    _both(engines, case)


def test_default_parallelism_counts_the_session_devices():
    """One device (or the CPU): 2; ``mesh[N]``: N. The reference counts
    its JAX devices instead."""
    from spark_tpu_torch import conf as CF

    one = PortSession(device="cpu")
    mesh = PortSession(device="cpu", conf={CF.MESH_DEVICES.key: 4},
                       mesh_devices=["cpu"] * 4)
    assert one.sparkContext.defaultParallelism == 2
    assert mesh.sparkContext.defaultParallelism == 4
    assert mesh.sparkContext.parallelize(range(10)).getNumPartitions() == 4
    assert one.sparkContext.parallelize(range(10)).getNumPartitions() == 2
    assert one.sparkContext is one.sparkContext
    from spark_tpu_torch.rdd import SparkContext

    assert type(one.sparkContext) is SparkContext
