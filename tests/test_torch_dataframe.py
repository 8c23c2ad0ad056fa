"""The port's DataFrame and Column API (``spark_tpu_torch/api``) against
the JAX package on the inputs of tests/test_dataframe.py: each case is
written once, over a session and the matching ``functions`` and
``Window`` modules, and run through both packages. Rows must be equal:
exactly for integers, strings, dates, decimals and nulls, within rel
1e-6 for floats (the reference sums in another order). ``show()``'s
output is compared as text. The flagship stage of
``__graft_entry__._example_plan`` (filter ``k > 10``, project ``tag,
v * 2``, sum/count/avg by tag, sort by ``s`` desc), written with the
DataFrame API over a Parquet file, equals the same stage run by the
reference's physical operators.

``test_cache`` of tests/test_dataframe.py is a parity case here, as
are ``persist`` and ``localCheckpoint`` (the out-of-memory slice ported
the memory store); ``sample``, ``F.explode`` and ``F.collect_list``,
which the refusal test also held before the nested-type slice, have
parity cases too.
"""

import datetime
import math

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import __graft_entry__
from spark_tpu.api import functions as RF
from spark_tpu.api.window import Window as RWindow
from spark_tpu.physical.planner import execute as ref_execute
from spark_tpu_torch.api import functions as PF
from spark_tpu_torch.api.session import SparkSession as PortSession
from spark_tpu_torch.api.window import Window as PWindow

from test_torch_threads import one_torch_thread  # noqa: F401

REL = 1e-6

PEOPLE = [
    {"name": "alice", "dept": "eng", "salary": 100, "age": 30},
    {"name": "bob", "dept": "eng", "salary": 200, "age": 40},
    {"name": "carol", "dept": "ops", "salary": 150, "age": None},
    {"name": "dave", "dept": "ops", "salary": 50, "age": 25},
    {"name": "erin", "dept": "sales", "salary": 300, "age": 35},
]
DEPTS = [{"dept": "eng", "floor": 1}, {"dept": "ops", "floor": 2},
         {"dept": "hr", "floor": 3}]


@pytest.fixture(scope="module")
def engines(spark):
    """(session, functions, Window) of each package."""
    port = PortSession.builder.device("cpu").getOrCreate()
    return {"ref": (spark, RF, RWindow), "port": (port, PF, PWindow)}


def _same(got, want):
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        assert len(g) == len(w), (g, w)
        for a, b in zip(g, w):
            if isinstance(a, float) and isinstance(b, float):
                assert (math.isnan(a) and math.isnan(b)) \
                    or a == pytest.approx(b, rel=REL), (g, w)
            else:
                assert a == b and type(a) is type(b), (g, w)


def _rows(df):
    return [tuple(r) for r in df.collect()]


def _both(engines, case):
    """``case(session, F, Window)`` through both packages; the port's
    result equals the reference's, and is returned."""
    got = case(*engines["port"])
    want = case(*engines["ref"])
    _same(got, want)
    return got


# ---- the cases of tests/test_dataframe.py ---------------------------------------


def test_select_filter(engines):
    def case(s, F, W):
        people = s.createDataFrame(PEOPLE)
        return _rows(people.filter(F.col("salary") > 100)
                     .select("name", (F.col("salary") * 2).alias("s2"))
                     .orderBy("name"))
    assert _both(engines, case) == [("bob", 400), ("carol", 300),
                                    ("erin", 600)]


def test_filter_string_condition(engines):
    def case(s, F, W):
        people = s.createDataFrame(PEOPLE)
        return [(people.filter(F.col("dept") == "eng").count(),
                 people.filter("salary >= 150 and dept <> 'eng'").count(),
                 people.where(people["age"].is_null()).count())]
    assert _both(engines, case) == [(2, 2, 1)]


def test_groupby_agg(engines):
    def case(s, F, W):
        people = s.createDataFrame(PEOPLE)
        return _rows(people.groupBy("dept")
                     .agg(F.sum("salary").alias("total"),
                          F.avg("salary").alias("mean"),
                          F.count().alias("n"),
                          F.max("name").alias("mx"))
                     .orderBy("dept"))
    assert _both(engines, case) == [("eng", 300, 150.0, 2, "bob"),
                                    ("ops", 200, 100.0, 2, "dave"),
                                    ("sales", 300, 300.0, 1, "erin")]


def test_agg_nulls(engines):
    def case(s, F, W):
        people = s.createDataFrame(PEOPLE)
        return _rows(people.agg(F.count("age").alias("c"),
                                F.avg("age").alias("a"),
                                F.min("age").alias("mn")))
    assert _both(engines, case) == [(4, (30 + 40 + 25 + 35) / 4, 25)]


def test_global_agg_no_group(engines):
    def case(s, F, W):
        return _rows(s.createDataFrame(PEOPLE)
                     .agg(F.sum("salary").alias("s")))
    assert _both(engines, case) == [(800,)]


def test_withcolumn_drop_rename(engines):
    def case(s, F, W):
        df = (s.createDataFrame(PEOPLE)
              .withColumn("double", F.col("salary") * 2)
              .withColumnRenamed("name", "who")
              .drop("dept", "age"))
        top = df.orderBy(F.desc("double")).first()
        # withColumn over an existing name replaces it in place
        again = df.withColumn("salary", F.col("salary") + 1)
        return [tuple(df.columns), tuple(top), tuple(again.columns),
                tuple(again.orderBy("who").first())]
    assert _both(engines, case) == [("who", "salary", "double"),
                                    ("erin", 300, 600),
                                    ("who", "salary", "double"),
                                    ("alice", 101, 200)]


def test_distinct_dropduplicates(engines):
    def case(s, F, W):
        df = s.createDataFrame([{"a": 1, "b": "x"}, {"a": 1, "b": "x"},
                                {"a": 2, "b": "y"}])
        return [(df.distinct().count(), df.dropDuplicates(["a"]).count(),
                 df.drop_duplicates().count())]
    assert _both(engines, case) == [(2, 2, 2)]


def test_sort_nulls(engines):
    def case(s, F, W):
        people = s.createDataFrame(PEOPLE)
        return [tuple(r.name for r in people.orderBy(F.col("age").asc())
                      .collect()),
                tuple(r.name for r in people.orderBy(F.desc("age"))
                      .collect()),
                tuple(r.name for r in people.orderBy(
                    F.asc_nulls_last("age")).collect())]
    got = _both(engines, case)
    assert got[0][0] == "carol"  # NULLS FIRST for ASC (Spark's default)
    assert got[1][-1] == "carol"  # NULLS LAST for DESC
    assert got[2][-1] == "carol"


def test_limit_offset(engines):
    def case(s, F, W):
        people = s.createDataFrame(PEOPLE)
        return [tuple(r.name for r in people.orderBy("salary").limit(2)
                      .collect()),
                tuple(r.name for r in people.orderBy("salary").offset(3)
                      .collect())]
    assert _both(engines, case) == [("dave", "alice"), ("bob", "erin")]


def test_union(engines):
    def case(s, F, W):
        people = s.createDataFrame(PEOPLE)
        more = s.createDataFrame(
            [{"name": "zed", "dept": "eng", "salary": 10, "age": 20}])
        flipped = more.select("age", "salary", "dept", "name")
        return [(people.union(more).count(),
                 people.unionAll(more).count()),
                tuple(people.unionByName(flipped)
                      .orderBy("salary").first())]
    assert _both(engines, case) == [(6, 6), ("zed", "eng", 10, 20)]


def test_joins(engines):
    def case(s, F, W):
        people = s.createDataFrame(PEOPLE)
        depts = s.createDataFrame(DEPTS)
        inner = people.join(depts, on="dept").orderBy("name")
        left = people.join(depts, on="dept", how="left").orderBy("name")
        full = people.join(depts, on=["dept"], how="full_outer") \
            .orderBy("dept", "name")
        right = people.join(depts, on="dept", how="right") \
            .orderBy("dept", "name")
        return [tuple((r.name, r.floor) for r in inner.collect()),
                tuple(r.floor for r in left.collect()),
                (people.join(depts, on="dept", how="left_semi").count(),),
                tuple(r.name for r in people.join(
                    depts, on="dept", how="anti").collect()),
                tuple(inner.columns),
                tuple(tuple(r) for r in full.collect()),
                tuple(tuple(r) for r in right.collect())]
    got = _both(engines, case)
    assert got[:5] == [
        (("alice", 1), ("bob", 1), ("carol", 2), ("dave", 2)),
        (1, 1, 2, 2, None), (4,), ("erin",),
        ("name", "dept", "salary", "age", "floor")]
    # full outer merges the key: 'hr' (right only) and 'sales' (left only)
    assert [r[1] for r in got[5]] == ["eng", "eng", "hr", "ops", "ops",
                                      "sales"]


def test_join_expr_condition(engines):
    def case(s, F, W):
        left = s.createDataFrame([{"k": 1, "v": 10}, {"k": 2, "v": 20}])
        right = s.createDataFrame([{"k2": 1, "w": 5}, {"k2": 1, "w": 50},
                                   {"k2": 2, "w": 7}])
        j = left.join(right, on=(F.col("k") == F.col("k2"))
                      & (F.col("w") > F.col("v") - 10))
        lo = left.join(right, on=F.col("k") == F.col("k2"), how="left")
        return [tuple(sorted((x.k, x.w) for x in j.collect())),
                (lo.count(),)]
    # v=10: w>0 keeps both 5 and 50; v=20: w>10 fails for 7
    assert _both(engines, case) == [((1, 5), (1, 50)), (3,)]


def test_when_otherwise(engines):
    def case(s, F, W):
        people = s.createDataFrame(PEOPLE)
        return _rows(people.select(
            "name",
            F.when(F.col("salary") >= 200, "high")
             .when(F.col("salary") >= 100, "mid")
             .otherwise("low").alias("band"),
            F.when(F.col("salary") > 250, 1).alias("top"))
            .orderBy("name"))
    assert [r[1] for r in _both(engines, case)] == [
        "mid", "high", "mid", "low", "high"]


def test_range(engines):
    def case(s, F, W):
        return [(s.range(10).count(), s.range(2, 10, 3).count(),
                 s.range(100).agg(F.sum("id").alias("s")).collect()[0].s)]
    assert _both(engines, case) == [(10, 3, 4950)]


def test_cross_join(engines):
    def case(s, F, W):
        a = s.createDataFrame([{"x": 1}, {"x": 2}])
        b = s.createDataFrame([{"y": 10}, {"y": 20}, {"y": 30}])
        return [(a.crossJoin(b).count(), a.join(b).count())]
    assert _both(engines, case) == [(6, 6)]


def test_temp_view_and_table(engines):
    def case(s, F, W):
        s.createDataFrame(PEOPLE).createOrReplaceTempView("people")
        return [(s.catalog.tableExists("people"), s.table("people").count(),
                 s.sql("select count(*) as n from people "
                       "where dept = 'ops'").collect()[0].n)]
    assert _both(engines, case) == [(True, 5, 2)]


def test_cache_waits_for_memory_store(engines):
    """The members that raised here before run: ``rdd`` (the RDD tier,
    tests/test_torch_rdd.py) gives the reference's rows, and the
    front-end slice's members run (``saveAsTable`` is held in
    tests/test_torch_saveastable.py, the statistics against the reference
    in tests/test_torch_na_stat.py, ``writeStream`` in
    tests/test_torch_streaming.py)."""
    port, ref = engines["port"][0], engines["ref"][0]
    people = port.createDataFrame(PEOPLE)
    got = [r.asDict() for r in people.rdd.collect()]
    assert got == [r.asDict()
                   for r in ref.createDataFrame(PEOPLE).rdd.collect()]
    assert got == PEOPLE
    assert not people.isStreaming
    assert type(people.writeStream).__name__ == "DataStreamWriter"
    assert people.repartition(2).count() == 5
    assert people.coalesce(1).count() == 5
    assert people.fillna(0).count() == 5
    assert [r.summary for r in people.describe().collect()] == [
        "count", "mean", "stddev", "min", "max"]
    assert people.na.drop().count() <= 5
    assert people.stat.freqItems(["dept"]).count() == 1


@pytest.mark.parametrize("how", ["cache", "persist", "localCheckpoint"])
def test_cache(engines, how):
    """``cache`` (tests/test_dataframe.py::test_cache), ``persist`` and
    ``localCheckpoint``: the counts of the cached frame and of a query
    over it, as in the reference; ``unpersist`` drops the entry."""
    def case(s, F, W):
        c = getattr(s.createDataFrame(PEOPLE), how)()
        out = [c.count(), c.groupBy("dept").count().count()]
        c.unpersist()
        return [tuple(out)]
    assert _both(engines, case) == [(5, 3)]


def test_sample(engines):
    """``sample`` (refused before the nested-type slice): the same rows as
    the reference, from the same counter-based stream."""
    def case(s, F, W):
        df = s.createDataFrame(PEOPLE * 40)
        return sorted(tuple(r) for r in df.sample(0.3, seed=5).collect())
    assert _both(engines, case)


def test_explode(engines):
    """``F.explode`` (refused before the nested-type slice) in a select
    and in a grouped count."""
    def case(s, F, W):
        df = s.createDataFrame(PEOPLE).select(
            "name", F.explode(F.array(F.col("salary"), F.lit(1)))
            .alias("x"))
        return (_rows(df.orderBy("name", "x"))
                + _rows(df.groupBy("x").agg(F.count("*").alias("n"))
                        .orderBy("x")))
    assert _both(engines, case)


def test_collect_list(engines):
    """``F.collect_list`` (refused before the nested-type slice) keeps the
    rows' order per group; ``F.collect_set`` each value once."""
    def case(s, F, W):
        df = s.createDataFrame(PEOPLE)
        return _rows(df.groupBy("dept").agg(
            F.collect_list("name").alias("names"),
            F.collect_set("salary").alias("pays"),
            F.size(F.collect_list("age")).alias("n_age")).orderBy("dept"))
    assert _both(engines, case)[0] == ("eng", ["alice", "bob"], [100, 200],
                                       2)


def test_stddev(engines):
    def case(s, F, W):
        df = s.createDataFrame([{"x": float(v)}
                                for v in [2, 4, 4, 4, 5, 5, 7, 9]])
        return _rows(df.agg(F.stddev_pop("x").alias("sp"),
                            F.stddev("x").alias("ss"),
                            F.var_pop("x").alias("vp"),
                            F.variance("x").alias("vs")))
    got = _both(engines, case)[0]
    assert got[0] == pytest.approx(2.0) and got[2] == pytest.approx(4.0)
    assert got[1] == pytest.approx(2.138089935299395)


def test_dates(engines):
    d = datetime.date

    def case(s, F, W):
        df = s.createDataFrame([{"d": d(2024, 1, 31), "v": 1},
                                {"d": d(2024, 3, 1), "v": 2}])
        rows = _rows(df.select(F.year("d").alias("y"),
                               F.month("d").alias("m"),
                               F.dayofmonth("d").alias("dd"),
                               F.add_months("d", 1).alias("plus"),
                               F.date_add("d", 30).alias("later"),
                               F.dayofweek("d").alias("dow"),
                               F.last_day("d").alias("ld"))
                     .orderBy("m"))
        return rows + [(df.filter(F.col("d") >= d(2024, 2, 1)).count(),)]
    got = _both(engines, case)
    assert got[0][:4] == (2024, 1, 31, d(2024, 2, 29))  # leap-year clamp
    assert got[1][3] == d(2024, 4, 1) and got[2] == (1,)


def test_sort_multi_key(engines):
    def case(s, F, W):
        df = s.createDataFrame([{"a": 1, "b": 2}, {"a": 1, "b": 1},
                                {"a": 0, "b": 9}])
        return [tuple(r) for r in df.orderBy(F.col("a").asc(), F.desc("b"))
                .collect()] + [tuple(r) for r in df.sort(
                    "a", "b", ascending=[False, True]).collect()]
    assert _both(engines, case) == [(0, 9), (1, 2), (1, 1),
                                    (1, 1), (1, 2), (0, 9)]


def test_show_output_as_text(engines, capsys):
    out = {}
    for name in ("ref", "port"):
        s = engines[name][0]
        people = s.createDataFrame(PEOPLE)
        people.show()
        people.select("name", "age").show(2)
        s.createDataFrame([{"t": "x" * 30, "n": 1}]).show()
        out[name] = capsys.readouterr().out
    assert out["port"] == out["ref"]
    assert "alice" in out["port"] and "NULL" in out["port"]
    assert "x" * 17 + "..." in out["port"]


# ---- the rest of the port's API, against the reference ------------------------


def test_select_expr_getitem_getattr(engines):
    def case(s, F, W):
        people = s.createDataFrame(PEOPLE)
        a = _rows(people.selectExpr("name", "salary * 2 as s2",
                                    "upper(dept) d").orderBy("name"))
        b = _rows(people[people.salary > 150].select(people["name"],
                                                     people.age))
        return a + b
    got = _both(engines, case)
    assert got[0] == ("alice", 200, "ENG") and got[-1] == ("erin", 35)


def test_duplicate_output_names(engines):
    """Rows are keyed by name, as in the reference: of two equal names
    the last value wins."""
    def case(s, F, W):
        people = s.createDataFrame(PEOPLE)
        return [tuple(r) for r in people.select(
            "name", "salary", (F.col("salary") + 1).alias("name"))
            .orderBy("salary").collect()]
    assert _both(engines, case)[0] == (51, 50)


def test_grouped_shorthands_rollup_cube(engines):
    def case(s, F, W):
        people = s.createDataFrame(PEOPLE)
        sums = _rows(people.groupBy("dept").sum("salary").orderBy("dept"))
        mins = _rows(people.groupBy("dept").min().orderBy("dept"))
        counts = _rows(people.groupBy("dept").count().orderBy("dept"))
        roll = _rows(people.rollup("dept").agg(
            F.sum("salary").alias("t")).orderBy("dept"))
        cube = _rows(people.cube("dept", F.col("age") > 30).agg(
            F.count("*").alias("n")).orderBy("dept", "n"))
        return sums + mins + counts + roll + [(len(cube),)]
    got = _both(engines, case)
    assert got[0] == ("eng", 300) and (None, 800) in got


def test_window_spec(engines):
    def case(s, F, W):
        people = s.createDataFrame(PEOPLE)
        w = W.partitionBy("dept").orderBy(F.desc("salary"))
        run = W.partitionBy("dept").orderBy("salary") \
            .rowsBetween(W.unboundedPreceding, W.currentRow)
        return _rows(people.select(
            "name", F.rank().over(w).alias("rk"),
            F.row_number().over(w).alias("rn"),
            F.lag("salary", 1, 0).over(w).alias("prev"),
            F.sum("salary").over(run).alias("running"))
            .orderBy("name"))
    assert _both(engines, case)[1] == ("bob", 1, 1, 0, 300)


def test_functions_breadth(engines):
    def case(s, F, W):
        df = s.createDataFrame([{"s": " Ab c ", "x": 4.0, "n": -7},
                                {"s": "de", "x": 2.25, "n": 3}])
        return _rows(df.select(
            "n", F.trim("s").alias("t"), F.lower("s").alias("lo"),
            F.length("s").alias("len"), F.substring("s", 2, 2).alias("sub"),
            F.concat_ws("-", "s", F.lit("z")).alias("cw"),
            F.regexp_replace("s", "[a-c]", "_").alias("rr"),
            F.sqrt("x").alias("sq"), F.abs("n").alias("ab"),
            F.round(F.col("x") / 3, 2).alias("r"), F.pmod("n", 5).alias("pm"),
            F.greatest(F.col("n"), F.lit(0)).alias("g"),
            F.coalesce(F.col("n"), F.lit(1)).alias("c"),
            F.col("n").isin(3, 5).alias("in"),
            F.col("x").between(2, 3).alias("bt"),
            F.col("s").like("%e").alias("lk"),
            F.expr("n * 10 + 1").alias("ex"),
            (-F.col("n")).alias("neg"), (~(F.col("n") > 0)).alias("np"))
            .orderBy("n"))
    got = _both(engines, case)
    assert got[0][:5] == (-7, "Ab c", " ab c ", 6, "Ab")


def test_actions(engines):
    def case(s, F, W):
        people = s.createDataFrame(PEOPLE)
        ordered = people.orderBy("salary")
        return [tuple(ordered.first()), tuple(ordered.head()),
                tuple(tuple(r) for r in ordered.head(2)),
                tuple(tuple(r) for r in ordered.take(1)),
                (people.isEmpty(), people.filter("salary > 999").isEmpty()),
                tuple(people.toArrow().column("name").to_pylist()),
                tuple(people.toPandas()["salary"].tolist())]
    got = _both(engines, case)
    assert got[0] == ("dave", "ops", 50, 25) and got[4] == (False, True)


def test_create_dataframe_inputs(engines):
    import pandas as pd

    def case(s, F, W):
        tuples = s.createDataFrame([(1, "a"), (2, "b")], ["k", "v"])
        pdf = s.createDataFrame(pd.DataFrame({"k": [3, 4],
                                              "v": ["c", "d"]}))
        renamed = s.createDataFrame([{"a": 1, "b": "x"}], ["k", "v"])
        arrow = s.createDataFrame(pa.table({"k": [5], "v": ["e"]}))
        return [tuple(df.columns) + tuple(tuple(r) for r in df.collect())
                for df in (tuples, pdf, renamed, arrow)]
    assert _both(engines, case)[0] == ("k", "v", (1, "a"), (2, "b"))
    port = engines["port"][0]
    with pytest.raises(ValueError, match="column names"):
        port.createDataFrame([(1, 2)])


def test_explain_prints_plans(engines, capsys):
    port = engines["port"][0]
    port.createDataFrame(PEOPLE).filter("salary > 100").explain(True)
    out = capsys.readouterr().out
    assert "== Optimized Logical Plan ==" in out and "Filter" in out


# ---- the flagship stage over a Parquet file ------------------------------------


def test_flagship_stage_from_parquet(engines, tmp_path):
    """scan -> filter k > 10 -> project tag, v * 2 -> sum/count/avg by
    tag -> sort by s desc, with the DataFrame API over the flagship
    batch written to Parquet, against the reference's physical operators
    over the batch itself."""
    plan, ref_batch = __graft_entry__._example_plan()
    want = [tuple(r.values()) for r in ref_execute(plan).to_pylist()]
    p = str(tmp_path / "flagship.parquet")
    pq.write_table(pa.Table.from_pylist(ref_batch.to_pylist()), p)
    port, F, _ = engines["port"]
    df = (port.read.parquet(p)
          .filter(F.col("k") > 10)
          .select("tag", (F.col("v") * 2.0).alias("v2"))
          .groupBy("tag")
          .agg(F.sum("v2").alias("s"), F.count("*").alias("n"),
               F.avg("v2").alias("a"))
          .orderBy(F.desc("s")))
    got = _rows(df)
    assert len(got) == 4
    _same(got, want)
    assert np.isfinite([r[1] for r in got]).all()
