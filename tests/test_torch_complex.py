"""Array, map and struct columns, explode/posexplode/LATERAL VIEW, the
higher-order functions and collect_list/collect_set through the port
(``device("cpu")``) against the JAX package, on the inputs of
tests/test_complex_types.py, tests/test_map_type.py, the collect and
higher-order tests of tests/test_higher_order.py and nested round trips
of tests/test_columnar.py; then a case through each row operator that
moves 2-D columns: outer joins, a UNION of arrays of different widths,
ROLLUP over a table with an array column, a sort, a limit and a
compaction of arrays, a window query passing an array through, and a
collect_list as wide as its row capacity.

Each case is written once over a session and its ``functions`` module
and run through both packages; rows must be equal (exact: the cases hold
integers, strings, decimals and arrays of them; floats are exact sums of
a few small values). Where the reference has no working path (reading
nested Parquet back, ORDER BY an array), the port's rows are held against
pyarrow or the case's own values (ROADMAP C).
"""

import decimal

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_tpu.api import functions as RF
from spark_tpu.columnar import from_arrow as ref_from_arrow
from spark_tpu.columnar import to_arrow as ref_to_arrow
from spark_tpu_torch.api import functions as PF
from spark_tpu_torch.api.session import SparkSession as PortSession
from spark_tpu_torch.columnar.arrow import from_arrow as port_from_arrow
from spark_tpu_torch.columnar.arrow import to_arrow as port_to_arrow

from test_torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def engines(spark):
    return {"ref": (spark, RF), "port": (PortSession(device="cpu"), PF)}


def _rows(df):
    return [tuple(r) for r in df.collect()]


def _both(engines, case):
    """``case(session, F)`` through both packages: equal results, the
    port's returned."""
    got = case(*engines["port"])
    want = case(*engines["ref"])
    assert got == want, (got, want)
    return got


ARRS = pa.table({
    "id": pa.array([1, 2, 3, 4], pa.int64()),
    "xs": pa.array([[10, 11], [20], [], [30, 31, 32]],
                   pa.list_(pa.int64())),
    "tags": pa.array([["a", "b"], ["c"], None, ["a"]],
                     pa.list_(pa.string())),
    "csv": pa.array(["x,y", "z", "p,q,r", ""]),
})


def _arrs(s):
    df = s.createDataFrame(ARRS)
    df.createOrReplaceTempView("arrs")
    return df


# ---- tests/test_complex_types.py ---------------------------------------------


def test_roundtrip_and_size(engines):
    got = _both(engines, lambda s, F: _rows(_arrs(s).select(
        F.col("id"), F.col("xs"), F.size("xs").alias("n"))))
    assert [r[1] for r in got] == [[10, 11], [20], [], [30, 31, 32]]
    assert [r[2] for r in got] == [2, 1, 0, 3]


def test_string_array_roundtrip_and_null(engines):
    got = _both(engines, lambda s, F: _rows(_arrs(s).select("tags")))
    assert [r[0] for r in got] == [["a", "b"], ["c"], None, ["a"]]


def test_element_at(engines):
    got = _both(engines, lambda s, F: _rows(_arrs(s).select(
        F.element_at("xs", 1).alias("first"),
        F.element_at("xs", -1).alias("last"),
        F.element_at("xs", 5).alias("oob"))))
    assert got == [(10, 11, None), (20, 20, None), (None, None, None),
                   (30, 32, None)]


def test_array_contains(engines):
    got = _both(engines, lambda s, F: _rows(_arrs(s).select(
        F.array_contains("xs", 20).alias("i"),
        F.array_contains("tags", "a").alias("s"))))
    assert got == [(False, True), (True, False), (False, None),
                   (False, True)]


def test_make_array_and_split(engines):
    got = _both(engines, lambda s, F: _rows(_arrs(s).select(
        F.array(F.col("id"), F.lit(0)).alias("pair"),
        F.split("csv", ",").alias("parts"))))
    assert [r[1] for r in got] == [["x", "y"], ["z"], ["p", "q", "r"], [""]]


def test_explode_select(engines):
    got = _both(engines, lambda s, F: _rows(_arrs(s).select(
        F.col("id"), F.explode("xs").alias("x"))))
    assert got == [(1, 10), (1, 11), (2, 20), (4, 30), (4, 31), (4, 32)]


def test_explode_reexecution(engines):
    def case(s, F):
        df = _arrs(s).select(F.col("id"), F.explode("xs").alias("x"))
        first = _rows(df)
        assert _rows(df) == first
        return first
    _both(engines, case)


def test_posexplode(engines):
    got = _both(engines, lambda s, F: _rows(_arrs(s) and s.sql(
        "select id, pos, x from arrs "
        "lateral view posexplode(xs) v as pos, x")))
    assert got == [(1, 0, 10), (1, 1, 11), (2, 0, 20), (4, 0, 30),
                   (4, 1, 31), (4, 2, 32)]


def test_lateral_view_sql(engines):
    got = _both(engines, lambda s, F: _rows(_arrs(s) and s.sql(
        "select id, t from arrs lateral view explode(tags) v as t "
        "where t = 'a'")))
    assert got == [(1, "a"), (4, "a")]


def test_explode_then_aggregate(engines):
    got = _both(engines, lambda s, F: _rows(_arrs(s) and s.sql(
        "select t, count(*) as c from arrs "
        "lateral view explode(tags) v as t group by t order by t")))
    assert got == [("a", 2), ("b", 1), ("c", 1)]


def test_split_explode_wordcount(engines):
    def case(s, F):
        s.createDataFrame(pa.table({"line": pa.array(
            ["a b a", "b c", "a", " a", ""])})) \
            .createOrReplaceTempView("lines")
        return _rows(s.sql(
            "select w, count(*) as c from lines "
            "lateral view explode(split(line, ' ')) v as w "
            "group by w order by c desc, w"))
    got = _both(engines, case)
    # the empty pieces count, as Python's str.split(' ') gives them
    want = {}
    for line in ["a b a", "b c", "a", " a", ""]:
        for w in line.split(" "):
            want[w] = want.get(w, 0) + 1
    assert got == sorted(want.items(), key=lambda kv: (-kv[1], kv[0]))


STRUCTS = pa.table({
    "s": pa.array([{"x": 1, "y": "u"}, {"x": 2, "y": "v"}],
                  pa.struct([("x", pa.int64()), ("y", pa.string())])),
    "k": pa.array([10, 20], pa.int64()),
})


def test_struct_flatten_field_access(engines):
    def case(s, F):
        df = s.createDataFrame(STRUCTS)
        df.createOrReplaceTempView("st")
        return (_rows(df.select(F.col("s.x"), F.col("k"))),
                _rows(s.sql("select `s.y` as y from st where `s.x` = 2")))
    assert _both(engines, case) == ([(1, 10), (2, 20)], [("v",)])


def test_arrays_through_joins(engines):
    def case(s, F):
        left = s.createDataFrame(pa.table({
            "k": pa.array([1, 2], pa.int64()),
            "xs": pa.array([[7, 8], [9]], pa.list_(pa.int64()))}))
        right = s.createDataFrame(pa.table({
            "k": pa.array([1, 2], pa.int64()),
            "v": pa.array(["l", "r"])}))
        return _rows(left.join(right, on="k").select("k", "xs", "v")
                     .orderBy("k"))
    assert _both(engines, case) == [(1, [7, 8], "l"), (2, [9], "r")]


def test_list_ingest_null_row_with_value_range(engines):
    arr = pa.ListArray.from_arrays(
        pa.array([0, 2, 5, 7], pa.int32()),
        pa.array([1, 2, 3, 4, 5, 6, 7], pa.int64()),
        mask=pa.array([False, True, False]))
    got = _both(engines, lambda s, F: _rows(
        s.createDataFrame(pa.table({"xs": arr})).select("xs")))
    assert got == [([1, 2],), (None,), ([6, 7],)]


def test_list_ingest_all_empty(engines):
    got = _both(engines, lambda s, F: _rows(s.createDataFrame(pa.table({
        "xs": pa.array([[], []], pa.list_(pa.int64()))})).select(
            F.size("xs").alias("n"))))
    assert got == [(0,), (0,)]


def test_struct_null_rows_propagate(engines):
    tbl = pa.table({"s": pa.array(
        [{"a": 1, "b": 2.0}, None, {"a": 3, "b": 4.0}],
        pa.struct([("a", pa.int64()), ("b", pa.float64())]))})
    got = _both(engines, lambda s, F: _rows(
        s.createDataFrame(tbl).select(F.col("s.a"), F.col("s.b"))))
    assert got == [(1, 2.0), (None, None), (3, 4.0)]


def test_make_array_nullable_input_nulls_whole_row(engines):
    tbl = pa.table({"x": pa.array([1, None], pa.int64())})
    got = _both(engines, lambda s, F: _rows(s.createDataFrame(tbl).select(
        F.array(F.col("x"), F.lit(1)).alias("a"))))
    assert got == [([1, 1],), (None,)]


def test_array_contains_float_needle_no_truncate(engines):
    got = _both(engines, lambda s, F: _rows(_arrs(s).select(
        F.array_contains("xs", F.lit(10.5)).alias("c"))))
    assert got == [(False,)] * 4


def test_lateral_view_without_view_alias(engines):
    got = _both(engines, lambda s, F: _rows(_arrs(s) and s.sql(
        "select id, t from arrs lateral view explode(tags) as t "
        "where t = 'c'")))
    assert got == [(2, "c")]


# ---- tests/test_map_type.py --------------------------------------------------

MAPS = pa.table({
    "m": pa.array([{"a": 1, "b": 2}, {"c": 3}, None, {}],
                  pa.map_(pa.string(), pa.int64())),
    "k": pa.array(["a", "c", "a", "z"]),
    "x": pa.array([10, 20, 30, 40], pa.int64()),
})


def _maps(s):
    df = s.createDataFrame(MAPS)
    df.createOrReplaceTempView("mt")
    return df


def test_map_ingest_and_roundtrip(engines):
    def case(s, F):
        _maps(s)
        return (_rows(s.sql("select m, x from mt")),
                s.sql("select m from mt").toArrow().column("m").to_pylist())
    rows, arrow = _both(engines, case)
    assert [r[0] for r in rows] == [{"a": 1, "b": 2}, {"c": 3}, None, {}]
    assert arrow == [[("a", 1), ("b", 2)], [("c", 3)], None, []]


def test_map_element_at_and_subscript(engines):
    got = _both(engines, lambda s, F: _rows(_maps(s) and s.sql(
        "select element_at(m, 'a') as a, m['b'] as b, "
        "element_at(m, k) as dyn, size(m) as s from mt")))
    assert got == [(1, 2, 1, 2), (None, None, 3, 1),
                   (None, None, None, None), (None, None, None, 0)]


def test_map_keys_values_contains(engines):
    got = _both(engines, lambda s, F: _rows(_maps(s) and s.sql(
        "select map_keys(m) as mk, map_values(m) as mv, "
        "map_contains_key(m, 'c') as c from mt")))
    assert got == [(["a", "b"], [1, 2], False), (["c"], [3], True),
                   (None, None, None), ([], [], False)]


def test_create_map_and_from_arrays(engines):
    def case(s, F):
        _maps(s)
        return (_rows(s.sql("select map('x', x, 'y', x * 2) as built "
                            "from mt")),
                _rows(s.sql("select map_from_arrays(array('u', 'v'), "
                            "array(7, 8)) as mfa from mt limit 1")))
    built, mfa = _both(engines, case)
    assert built[0] == ({"x": 10, "y": 20},)
    assert mfa == [({"u": 7, "v": 8},)]


def test_create_map_api_and_write(engines, tmp_path):
    """A map column written with ``df.write.parquet``: the file equals the
    reference's file, and the port reads it back (the reference cannot
    read a nested Parquet column: ROADMAP C)."""
    files = {}

    def case(s, F):
        df = _maps(s).select(F.create_map(F.lit("k"), F.col("x"))
                             .alias("m2"), F.col("x"))
        name = "port" if s is engines["port"][0] else "ref"
        files[name] = str(tmp_path / f"{name}.parquet")
        df.write.parquet(files[name])
        return _rows(df)
    assert [r[0] for r in _both(engines, case)] == [
        {"k": 10}, {"k": 20}, {"k": 30}, {"k": 40}]
    port_file = pq.read_table(files["port"])
    assert port_file.column("m2").to_pylist() == \
        pq.read_table(files["ref"]).column("m2").to_pylist()
    back = engines["port"][0].read.parquet(files["port"])
    assert [r.m2 for r in back.collect()] == [
        {"k": 10}, {"k": 20}, {"k": 30}, {"k": 40}]


def test_subscript_zero_based_array(engines):
    got = _both(engines, lambda s, F: _rows(_maps(s) and s.sql(
        "select array(5, 6, 7)[0] as a0, array(5, 6, 7)[2] as a2, "
        "array(5, 6, 7)[3] as oob from mt limit 1")))
    assert got == [(5, 7, None)]


def test_map_handle_alias_and_star(engines):
    def case(s, F):
        _maps(s)
        return (_rows(s.sql("select m as q, x from mt where x = 10")),
                [r.asDict() for r in
                 s.sql("select * from mt where x = 20").collect()])
    rows, star = _both(engines, case)
    assert rows == [({"a": 1, "b": 2}, 10)]
    assert star[0]["m"] == {"c": 3} and star[0]["k"] == "c"


def test_int_key_map(engines):
    tbl = pa.table({"m": pa.array([{1: 10.5, 2: 20.5}, {3: 30.5}],
                                  pa.map_(pa.int64(), pa.float64()))})

    def case(s, F):
        s.createDataFrame(tbl).createOrReplaceTempView("imt")
        return _rows(s.sql("select m[2] as v, element_at(m, 3) as w "
                           "from imt"))
    assert _both(engines, case) == [(20.5, None), (None, 30.5)]


# ---- tests/test_higher_order.py: lambdas and the collect aggregates ---------

HOF = [{"k": 1, "a": [1, 2, 3], "b": 10}, {"k": 1, "a": [4], "b": 20},
       {"k": 2, "a": [], "b": 30}, {"k": 2, "a": [7, 7, 8], "b": 40}]


def _hof(s):
    df = s.createDataFrame(HOF)
    df.createOrReplaceTempView("hof")
    return df


def test_transform(engines):
    got = _both(engines, lambda s, F: _rows(_hof(s) and s.sql(
        "select transform(a, x -> x * 2) as t from hof")))
    assert got == [([2, 4, 6],), ([8],), ([],), ([14, 14, 16],)]


def test_transform_outer_column_and_index(engines):
    def case(s, F):
        df = _hof(s)
        return (_rows(s.sql("select transform(a, x -> x + b) as t "
                            "from hof")),
                _rows(df.select(F.transform("a", lambda x, i: x * 10 + i)
                                .alias("t"))))
    outer, index = _both(engines, case)
    assert [r[0] for r in outer] == [[11, 12, 13], [24], [], [47, 47, 48]]
    assert [r[0] for r in index] == [[10, 21, 32], [40], [], [70, 71, 82]]


def test_filter_exists_forall(engines):
    got = _both(engines, lambda s, F: _rows(_hof(s) and s.sql(
        "select filter(a, x -> x % 2 = 0) as f, exists(a, x -> x > 5) "
        "as e, forall(a, x -> x < 5) as fa from hof")))
    assert got == [([2], False, True), ([4], False, True),
                   ([], False, True), ([8], True, False)]


def test_exists_subquery_still_parses(engines):
    got = _both(engines, lambda s, F: sorted(_rows(_hof(s) and s.sql(
        "select k from hof h where exists "
        "(select 1 from hof i where i.k = h.k and i.b > 35)"))))
    assert got == [(2,), (2,)]


def test_aggregate_fold(engines):
    got = _both(engines, lambda s, F: _rows(_hof(s) and s.sql(
        "select aggregate(a, 0, (acc, x) -> acc + x) as s, "
        "aggregate(a, 1, (acc, x) -> acc * x, acc -> -acc) as p "
        "from hof")))
    assert got == [(6, -6), (4, -4), (0, -1), (22, -392)]


def test_collect_list_and_set(engines):
    got = _both(engines, lambda s, F: _rows(_hof(s) and s.sql(
        "select k, collect_list(b) as l, collect_set(b % 20) as s "
        "from hof group by k order by k")))
    assert got == [(1, [10, 20], [0, 10]), (2, [30, 40], [0, 10])]


def test_collect_list_strings_and_nulls(engines):
    def case(s, F):
        s.createDataFrame([
            {"k": 1, "s": "b"}, {"k": 1, "s": "a"}, {"k": 1, "s": None},
            {"k": 2, "s": "a"}, {"k": 1, "s": "a"},
        ]).createOrReplaceTempView("cstr")
        return _rows(s.sql("select k, collect_list(s) as l, "
                           "collect_set(s) as d from cstr group by k "
                           "order by k"))
    assert _both(engines, case) == [(1, ["b", "a", "a"], ["a", "b"]),
                                    (2, ["a"], ["a"])]


def test_collect_roundtrip_to_arrow(engines):
    got = _both(engines, lambda s, F: _hof(s).groupBy("k").agg(
        F.collect_list("b").alias("l")).orderBy("k").toArrow()
        .column("l").to_pylist())
    assert got == [[10, 20], [30, 40]]


def test_transform_nullable_body_refuses(engines):
    for s, F in engines.values():
        df = s.createDataFrame([{"a": [1, 2], "n": 5},
                                {"a": [3], "n": None}])
        with pytest.raises(NotImplementedError, match="nullable"):
            df.select(F.transform("a", lambda x: x + F.col("n"))
                      .alias("t")).collect()


# ---- tests/test_columnar.py: nested round trips ------------------------------

NESTED = pa.table({
    "i": pa.array([1, None, 3], pa.int64()),
    "xs": pa.array([[1, 2], None, []], pa.list_(pa.int64())),
    "ss": pa.array([["x"], ["y", "z"], None], pa.list_(pa.string())),
    "ds": pa.array([[decimal.Decimal("1.25")], [], [decimal.Decimal("-2.50"),
                                                    decimal.Decimal("3.00")]],
                   pa.list_(pa.decimal128(12, 2))),
    "m": pa.array([{"a": 1.5}, None, {"b": 2.5, "c": 3.5}],
                  pa.map_(pa.string(), pa.float64())),
    "st": pa.array([{"p": 1, "q": "u"}, None, {"p": 3, "q": None}],
                   pa.struct([("p", pa.int64()), ("q", pa.string())])),
})


def test_nested_arrow_roundtrip():
    """from_arrow then to_arrow of list, map and struct columns: the
    port's schema, rows and Arrow table equal the reference's."""
    port = port_from_arrow(NESTED, device="cpu")
    ref = ref_from_arrow(NESTED)
    assert [(f.name, repr(f.dtype), f.nullable) for f in port.schema] == \
        [(f.name, repr(f.dtype), f.nullable) for f in ref.schema]
    assert port.to_pylist() == ref.to_pylist()
    assert port_to_arrow(port).to_pylist() == ref_to_arrow(ref).to_pylist()
    assert port_to_arrow(port).column("xs").to_pylist() == \
        NESTED.column("xs").to_pylist()


def test_batch_helpers_with_arrays():
    """``device_nbytes`` counts the 2-D values as the reference does;
    ``empty_batch`` of a schema with an array column has no row;
    ``to_pandas`` holds lists and dicts."""
    from spark_tpu_torch.columnar.batch import empty_batch

    port = port_from_arrow(NESTED, device="cpu")
    assert port.device_nbytes() == ref_from_arrow(NESTED).device_nbytes()
    empty = empty_batch(port.schema, device="cpu")
    assert empty.capacity == 1024 and empty.to_pylist() == []
    frame = port.to_pandas()
    assert list(frame.columns) == ["i", "xs", "ss", "ds", "m", "st.p",
                                   "st.q"]
    assert frame["m"].tolist()[2] == {"b": 2.5, "c": 3.5}
    assert frame["xs"].tolist()[0] == [1, 2]


def test_nested_parquet_roundtrip(engines, tmp_path):
    """A list, map and struct table written with ``df.write.parquet`` and
    read back with ``spark.read.parquet`` through the port: the same rows
    as in memory, from the whole file and from a pruned projection (the
    reference writes the same file and cannot read it back: ROADMAP C)."""
    port, _ = engines["port"]
    df = port.createDataFrame(NESTED)
    path = str(tmp_path / "nested")
    df.write.parquet(path)
    back = port.read.parquet(path)
    assert _rows(back) == _rows(df)
    q = "select i, size(xs) as n, m['b'] as b, `st.q` as q from {}"
    df.createOrReplaceTempView("nested_mem")
    back.createOrReplaceTempView("nested_file")
    assert _rows(port.sql(q.format("nested_file"))) == \
        _rows(port.sql(q.format("nested_mem"))) == \
        [(1, 2, None, "u"), (None, None, None, None), (3, 0, 2.5, None)]
    spark, _ = engines["ref"]
    ref_path = str(tmp_path / "nested_ref")
    spark.createDataFrame(NESTED).write.parquet(ref_path)
    assert pq.read_table(ref_path).to_pylist() == \
        pq.read_table(path).to_pylist()


# ---- row operators that move 2-D columns -------------------------------------


def _pairs(s):
    left = s.createDataFrame(pa.table({
        "k": pa.array([1, 2, 3], pa.int64()),
        "xs": pa.array([[7, 8], [9], []], pa.list_(pa.int64())),
        "ts": pa.array([["a"], None, ["b", "c"]], pa.list_(pa.string()))}))
    right = s.createDataFrame(pa.table({
        "k2": pa.array([2, 3, 4, 4], pa.int64()),
        "ys": pa.array([[1, 2, 3, 4], [5], [6, 6], []],
                       pa.list_(pa.int64()))}))
    left.createOrReplaceTempView("jl")
    right.createOrReplaceTempView("jr")


@pytest.mark.parametrize("how", ["left", "right", "full"])
def test_outer_join_pads_arrays(engines, how):
    """Outer joins append NULL rows as wide as the array columns they
    pad: the unmatched side's arrays are NULL, the matched rows keep
    theirs. The reference cannot concatenate the 1-D NULL padding onto
    2-D arrays (ROADMAP C); the port's rows are the case's own values."""
    s, F = engines["port"]
    _pairs(s)
    got = sorted(_rows(s.sql(
        f"select k, xs, ts, k2, ys from jl {how} join jr on k = k2")),
        key=repr)
    matched = [(2, [9], None, 2, [1, 2, 3, 4]), (3, [], ["b", "c"], 3, [5])]
    left_only = [(1, [7, 8], ["a"], None, None)]
    right_only = [(None, None, None, 4, [6, 6]), (None, None, None, 4, [])]
    want = matched + {"left": left_only, "right": right_only,
                      "full": left_only + right_only}[how]
    assert got == sorted(want, key=repr)


def test_inner_join_and_sort_limit_carry_arrays(engines):
    def case(s, F):
        _pairs(s)
        return _rows(s.sql("select k, xs, ys from jl join jr on k = k2 "
                           "order by k desc limit 1"))
    assert _both(engines, case) == [(3, [], [5])]


def test_union_of_arrays_of_different_widths(engines):
    """UNION ALL of arrays 2 and 4 wide, and of string arrays over two
    dictionaries: the port pads to the widest and re-codes the strings.
    The reference cannot concatenate the two widths (ROADMAP C); the
    port's rows are the inputs' own."""
    def case(s, F):
        _pairs(s)
        return _rows(s.sql(
            "select k, xs, ts from jl union all "
            "select k2, ys, array('q', 'a', 'zz') from jr"))
    assert case(*engines["port"]) == [
        (1, [7, 8], ["a"]), (2, [9], None), (3, [], ["b", "c"]),
        (2, [1, 2, 3, 4], ["q", "a", "zz"]), (3, [5], ["q", "a", "zz"]),
        (4, [6, 6], ["q", "a", "zz"]), (4, [], ["q", "a", "zz"])]
    with pytest.raises(TypeError, match="concatenate"):
        case(*engines["ref"])
    # arrays of one width: both engines
    assert _both(engines, lambda s, F: _rows(_pairs(s) or s.sql(
        "select k2, ys from jr union all select k2, ys from jr "
        "order by k2")))[0] == (2, [1, 2, 3, 4])


def test_rollup_over_a_table_with_an_array_column(engines):
    got = _both(engines, lambda s, F: _rows(_arrs(s) and s.sql(
        "select id % 2 as p, sum(size(xs)) as n, count(*) as c "
        "from arrs group by rollup(id % 2) order by p")))
    assert got == [(None, 6, 4), (0, 4, 2), (1, 2, 2)]


def test_window_passes_arrays_through(engines):
    got = _both(engines, lambda s, F: _rows(_arrs(s) and s.sql(
        "select id, xs, row_number() over (partition by id % 2 "
        "order by id) as rn from arrs order by id")))
    assert [r[1] for r in got] == [[10, 11], [20], [], [30, 31, 32]]


def test_window_refuses_array_partitions(engines):
    s, _ = engines["port"]
    _arrs(s)
    with pytest.raises(NotImplementedError, match="array or map"):
        s.sql("select id, row_number() over (partition by xs order by id) "
              "from arrs").collect()


def test_maps_and_arrays_are_not_groupable(engines):
    for name, (s, F) in engines.items():
        _maps(s)
        _arrs(s)
        for q in ("select m, count(*) from mt group by m",
                  "select xs, count(*) from arrs group by xs"):
            with pytest.raises((ValueError, TypeError)):
                s.sql(q).collect()


def test_order_by_an_array_is_refused(engines):
    """The reference sorts garbage rows for ORDER BY an array (ROADMAP C);
    the port refuses it."""
    s, _ = engines["port"]
    _arrs(s)
    with pytest.raises(ValueError, match="not orderable"):
        s.sql("select * from arrs order by xs").collect()


def test_compaction_of_a_sparse_array_input(engines):
    """A join input of 8192 rows with 100 live carries its arrays through
    the stage boundary's compaction."""
    def case(s, F):
        n = 8192
        big = s.createDataFrame(pa.table({
            "id": pa.array(np.arange(n), pa.int64()),
            "xs": pa.array([[i, i + 1][: i % 3] for i in range(n)],
                           pa.list_(pa.int64()))}))
        small = s.createDataFrame(pa.table({
            "j": pa.array(np.arange(0, 200, 7), pa.int64())}))
        return _rows(big.filter(F.col("id") < 100)
                     .join(small, F.col("id") == F.col("j"))
                     .select("id", "xs", F.size("xs").alias("n"))
                     .orderBy("id"))
    got = _both(engines, case)
    assert got[1] == (7, [7], 1) and len(got) == 15


def test_collect_list_as_wide_as_its_capacity(engines):
    """1024 groups whose largest holds 1024 rows: the collected array is
    (1024 groups x 1024 wide), square, where a per-row mask applied along
    the wrong axis would pass silently. A filter over the arrays, a sort
    and a limit follow."""
    keys = ["g0000"] * 1024 + [f"g{i:04d}" for i in range(1, 1024)]
    vals = list(range(1024)) + [5000 + i for i in range(1, 1024)]
    tbl = pa.table({"g": pa.array(keys), "v": pa.array(vals, pa.int64())})

    def case(s, F):
        s.createDataFrame(tbl).createOrReplaceTempView("wide")
        return _rows(s.sql(
            "select g, size(l) as n, element_at(l, -1) as last, "
            "element_at(l, 2) as second "
            "from (select g, collect_list(v) as l from wide group by g) t "
            "where size(l) > 0 order by n desc, g limit 3"))
    got = _both(engines, case)
    assert got == [("g0000", 1024, 1023, 1), ("g0001", 1, 5001, None),
                   ("g0002", 1, 5002, None)]
    # a CASE over the square arrays and a narrower one: the port pads to
    # the wider (the reference cannot broadcast them, ROADMAP C)
    s, _ = engines["port"]
    got = _rows(s.sql(
        "select g, size(c) as n, element_at(c, 2) as e from (select g, "
        "case when g = 'g0000' then l else array(1, 2) end as c from "
        "(select g, collect_list(v) as l from wide group by g) t) u "
        "order by n desc, g limit 2"))
    assert got == [("g0000", 1024, 1), ("g0001", 2, 2)]
