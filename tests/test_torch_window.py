"""The window slice on the CPU: window functions, grouping sets, set
operations, ``Range`` and FROM-less SELECT in ``spark_tpu_torch``.

- Operators against the JAX package's on the same host arrays
  (``columnar/batch.py:from_host_arrays``): ``WindowExec`` (ranking,
  offsets, running, sliding and RANGE frames, NULL and NaN keys),
  ``ExpandExec``, ``UnionExec`` and ``RangeExec``.
- The SQL inputs of tests/test_window.py against sqlite (an independent
  window implementation) and those of tests/test_grouping_sets.py
  against the same hand-computed rows, through the port's session.
- The sparse table's refusal of bounded min/max frames over batches
  past ``SPARSE_TABLE_MAX_ROWS`` (4M rows; lowered in the test only).
- The segmented scan and the exact floor(log2) of the sparse table.

Tolerances: integers, decimals, strings, dates and validity exact;
float64 window sums and averages rel 1e-9 against the reference and
sqlite (differences of a cumulative sum over the batch, whose additions
XLA and torch may associate differently; sqlite adds each frame).
"""

import decimal
import math
import sqlite3

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_tpu import types as RT
from spark_tpu.columnar.batch import from_numpy as ref_from_numpy
from spark_tpu.expr import expressions as RE
from spark_tpu.physical import operators as RP
from spark_tpu.physical.planner import execute as ref_execute
from spark_tpu.physical.window import WindowExec as RefWindowExec
from spark_tpu_torch.api.session import SparkSession as PortSession
from spark_tpu_torch.expr import expressions as PE
from spark_tpu_torch.physical import kernels as PK
from spark_tpu_torch.physical import operators as PP
from spark_tpu_torch.physical import window as PW
from spark_tpu_torch.physical.planner import execute as port_execute

from test_torch_operators import _assert_rows, _carry


@pytest.fixture(scope="module")
def port():
    return PortSession(device="cpu")


# ---- operators against the reference's ---------------------------------------


def _window_batch():
    """Two partition keys (one nullable), an int64 order key with ties,
    a nullable float64 with NaNs, a dictionary string, a decimal and
    ``rid``, each row's position (unique); padding rows dead."""
    rng = np.random.default_rng(5)
    n = 600
    tags = ("ant", "bee", "cat", "dog")
    schema = RT.Schema((
        RT.Field("p", RT.INT64, nullable=False),
        RT.Field("q", RT.INT32, nullable=True),
        RT.Field("o", RT.INT64, nullable=False),
        RT.Field("f", RT.FLOAT64, nullable=True),
        RT.Field("s", RT.STRING, nullable=True, dictionary=tags),
        RT.Field("d", RT.DecimalType(12, 2), nullable=True),
        RT.Field("rid", RT.INT64, nullable=False),
        RT.Field("g", RT.FLOAT64, nullable=True),
    ))
    f = rng.normal(size=n) * 50
    f[rng.random(n) < 0.02] = np.nan
    return ref_from_numpy(schema, [
        rng.integers(0, 7, n),
        rng.integers(0, 3, n).astype(np.int32),
        rng.integers(0, 40, n),
        f,
        rng.integers(0, 4, n).astype(np.int32),
        rng.integers(-10 ** 6, 10 ** 6, n),
        np.arange(n),
        rng.normal(size=n) * 1e3,
    ], validities=[None, rng.random(n) < 0.9, None, rng.random(n) < 0.9,
                   rng.random(n) < 0.95, rng.random(n) < 0.9, None,
                   rng.random(n) < 0.9])


def _spec(E, fn, part, order, frame=None):
    return E.WindowExpr(fn, tuple(E.Col(c) for c in part),
                        tuple(E.SortOrder(E.Col(c), asc, nf)
                              for c, asc, nf in order), frame)


#: (function, partition columns, (column, ascending, nulls_first) order
#: keys, frame); every order ends on a unique row id where a function's
#: result depends on the order among ties
_WINDOWS = {
    "ranking": lambda E: [
        ("rn", _spec(E, E.RowNumber(), ["p"], [("o", True, None),
                                               ("rid", True, None)])),
        ("rk", _spec(E, E.Rank(), ["p", "q"], [("o", False, None)])),
        ("dr", _spec(E, E.Rank(dense=True), ["q"], [("f", True, None)])),
        ("nt", _spec(E, E.NTile(3), ["p"], [("rid", True, None)])),
    ],
    "offsets": lambda E: [
        ("lg", _spec(E, E.LagLead(E.Col("f"), 1, None, False), ["p"],
                     [("o", True, None), ("rid", True, None)])),
        ("ld", _spec(E, E.LagLead(E.Col("o"), 2, E.Literal(-1), True),
                     ["q"], [("rid", False, None)])),
        ("ls", _spec(E, E.LagLead(E.Col("s"), 3, None, False), [],
                     [("rid", True, None)])),
    ],
    "running": lambda E: [
        ("sd", _spec(E, E.Sum(E.Col("d")), ["p"], [("o", True, None)])),
        ("cf", _spec(E, E.Count(E.Col("f")), ["p"],
                     [("o", True, None), ("rid", True, None)],
                     ("rows", None, 0))),
        ("mx", _spec(E, E.Max(E.Col("f")), ["q"], [("o", True, None)])),
        ("mn", _spec(E, E.Min(E.Col("s")), [], [("o", False, None)])),
        ("aw", _spec(E, E.Avg(E.Col("d")), ["p"], [])),
    ],
    "sliding": lambda E: [
        ("s3", _spec(E, E.Sum(E.Col("o")), ["p"], [("rid", True, None)],
                     ("rows", -2, 1))),
        ("n3", _spec(E, E.Min(E.Col("f")), ["p"], [("rid", True, None)],
                     ("rows", -3, 0))),
        ("x3", _spec(E, E.Max(E.Col("d")), ["q"], [("rid", True, None)],
                     ("rows", 0, None))),
        ("a3", _spec(E, E.Avg(E.Col("d")), ["p"], [("rid", True, None)],
                     ("rows", -1, 1))),
        ("c0", _spec(E, E.Count(None), ["p"], [("rid", True, None)],
                     ("rows", 2, 5))),
        ("sg", _spec(E, E.Sum(E.Col("g")), ["q"], [("rid", True, None)],
                     ("rows", -3, 0))),
        ("ag", _spec(E, E.Avg(E.Col("g")), [], [("rid", True, None)],
                     ("rows", -1, 1))),
    ],
    "range": lambda E: [
        ("ro", _spec(E, E.Sum(E.Col("d")), ["p"], [("o", True, None)],
                     ("range", -5, 5))),
        ("rf", _spec(E, E.Count(None), ["q"], [("f", False, True)],
                     ("range", -10, 0))),
        ("rd", _spec(E, E.Sum(E.Col("o")), [], [("d", True, None)],
                     ("range", None, 1))),
    ],
}


def _window_plan(M, E, W, scan, kind):
    """The kind's windows over the batch less the rows with o = 13 (dead
    rows inside the batch, not only its padding)."""
    live = M.FilterExec(E.Cmp("!=", E.Col("o"), E.Literal(13)), scan)
    return W(tuple(E.Alias(w, name) for name, w in _WINDOWS[kind](E)), live)


@pytest.mark.parametrize("kind", sorted(_WINDOWS))
def test_window_exec_matches_reference(kind):
    ref_batch = _window_batch()
    want = ref_execute(_window_plan(RP, RE, RefWindowExec,
                                    RP.BatchScanExec(ref_batch), kind))
    got = port_execute(_window_plan(PP, PE, PW.WindowExec,
                                    PP.BatchScanExec(_carry(ref_batch)),
                                    kind))
    _assert_rows(got.to_pylist(), want.to_pylist(), rel=1e-9)
    # validity and the row mask too, not only the live rows
    assert np.array_equal(got.data.row_mask.numpy(),
                          np.asarray(want.data.row_mask))
    for gc, wc in zip(got.data.columns, want.data.columns):
        assert (gc.validity is None) == (wc.validity is None)


def _expand_union_plan(M, E, scan, kind):
    if kind == "expand":
        keys = ("s", "q")
        projections = []
        for gid, kept in ((0, keys), (1, ("s",)), (3, ())):
            projections.append(tuple(
                [E.Col("d")]
                + [E.Col(k) if k in kept else E.NullOf(E.Col(k))
                   for k in keys]
                + [E.Literal(gid)]))
        expand = M.ExpandExec(tuple(projections), ("d", "gs", "gq", "gid"),
                              scan)
        agg = M.HashAggregateExec(
            (E.Col("gs"), E.Col("gq"), E.Col("gid")),
            (E.Col("gs"), E.Col("gq"), E.Col("gid"),
             E.Alias(E.Sum(E.Col("d")), "sd"), E.Alias(E.Count(None), "n")),
            expand)
        return M.SortExec(tuple(E.SortOrder(E.Col(c)) for c in
                                ("gid", "gs", "gq")), agg)
    left = M.ProjectExec((E.Col("s"), E.Col("q"), E.Col("d")),
                         M.FilterExec(E.Cmp("<", E.Col("p"), E.Literal(3)),
                                      scan))
    right = M.ProjectExec(
        (E.Alias(E.Case(((E.Cmp(">", E.Col("o"), E.Literal(20)),
                          E.Literal("zebra")),), E.Col("s")), "s"),
         E.Alias(E.Col("p"), "q"), E.Alias(E.Col("o"), "d")),
        M.FilterExec(E.Cmp(">=", E.Col("p"), E.Literal(5)), scan))
    return M.UnionExec(left, right)


@pytest.mark.parametrize("kind", ["expand", "union"])
def test_expand_and_union_exec_match_reference(kind):
    ref_batch = _window_batch()
    want = ref_execute(_expand_union_plan(RP, RE,
                                          RP.BatchScanExec(ref_batch), kind))
    got = port_execute(_expand_union_plan(
        PP, PE, PP.BatchScanExec(_carry(ref_batch)), kind))
    w, g = want.to_pylist(), got.to_pylist()
    assert w
    if kind == "union":
        # rows in position order: both engines concatenate left, right
        assert g == w
        assert got.capacity == want.capacity
        assert got.schema.field("s").dictionary == \
            want.schema.field("s").dictionary
    else:
        _assert_rows(g, w)


@pytest.mark.parametrize("start,end,step", [(0, 10, 1), (5, -7, -3),
                                            (3, 3, 1), (-4, 2000, 7)])
def test_range_exec_matches_reference(start, end, step):
    want = ref_execute(RP.RangeExec(start, end, step))
    got = port_execute(PP.RangeExec(start, end, step, "id", "cpu"))
    assert got.to_pylist() == want.to_pylist()
    assert got.capacity == want.capacity


# ---- SQL: the inputs of tests/test_window.py against sqlite ------------------

EMP = [("a", "n1", 100), ("a", "n2", 300), ("a", "n3", 300),
       ("a", "n4", 50), ("b", "n5", 700), ("b", "n6", 100),
       ("c", "n7", 42)]


@pytest.fixture(scope="module")
def wdb(port):
    port.createDataFrame(pa.table({
        "dept": [r[0] for r in EMP], "name": [r[1] for r in EMP],
        "sal": pa.array([r[2] for r in EMP], pa.int64())})) \
        .createOrReplaceTempView("emp")
    port.createDataFrame(pa.table({
        "sal": pa.array([100, 200, 350, None], pa.int64())})) \
        .createOrReplaceTempView("empn")
    conn = sqlite3.connect(":memory:")
    conn.execute("create table emp (dept text, name text, sal int)")
    conn.executemany("insert into emp values (?,?,?)", EMP)
    conn.execute("create table empn (sal int)")
    conn.executemany("insert into empn values (?)",
                     [(100,), (200,), (350,), (None,)])
    yield conn
    conn.close()


def _key(t):
    return tuple((x is None, x if x is not None else 0) for x in t)


def _check_sqlite(port, conn, sql):
    got = sorted((tuple(r) for r in port.sql(sql).collect()), key=_key)
    want = sorted((tuple(r) for r in conn.execute(sql).fetchall()), key=_key)
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(a, float) or isinstance(b, float):
                assert a == pytest.approx(b, rel=1e-9), (sql, g, w)
            else:
                assert a == b, (sql, g, w)


_EMP_WINDOWS = [
    *[f"select name, {fn} over (partition by dept order by sal desc, name) "
      "as r from emp"
      for fn in ("row_number()", "rank()", "dense_rank()", "ntile(2)")],
    "select name, rank() over (partition by dept order by sal) as r, "
    "dense_rank() over (partition by dept order by sal) as d from emp",
    *[f"select name, {fn} over (partition by dept order by sal, name) "
      "as v from emp"
      for fn in ("lag(sal)", "lead(sal)", "lag(sal, 2)", "lag(sal, 1, -1)")],
    "select name, sum(sal) over (partition by dept order by sal) as s "
    "from emp",
    *[f"select name, {agg} over (partition by dept) as v from emp"
      for agg in ("sum(sal)", "count(*)", "count(sal)", "avg(sal)",
                  "min(sal)", "max(sal)")],
    "select name, sum(sal) over (partition by dept order by sal, name "
    "rows between 1 preceding and 1 following) as v from emp",
    "select name, sum(sal) over (partition by dept order by sal, name "
    "rows between unbounded preceding and current row) as v from emp",
    "select name, row_number() over (order by sal desc, name) as r "
    "from emp",
    "select name, sum(sal) over (partition by dept order by sal "
    "range between 100 preceding and 100 following) as s from emp",
    "select name, count(*) over (partition by dept order by sal "
    "range between 250 preceding and current row) as c from emp",
    "select name, sum(sal) over (order by sal "
    "range between current row and 200 following) as s from emp",
    "select name, sum(sal) over (partition by dept order by sal desc "
    "range between 100 preceding and 100 following) as s from emp",
    "select sal, count(*) over (order by sal desc range between "
    "100 preceding and 100 following) as c from empn",
    "select name, sal * 100.0 / sum(sal) over (partition by dept) as pct "
    "from emp",
    "select name, lag(sal) over (partition by dept order by sal, name) "
    "as p from emp",
    "select name, lag(name, 1, 'none') over (partition by dept order by "
    "sal, name) as p from emp",
]


@pytest.mark.parametrize("sql", _EMP_WINDOWS)
def test_window_sql_matches_sqlite(port, wdb, sql):
    _check_sqlite(port, wdb, sql)


def test_string_window_carries_dictionary(port):
    port.createDataFrame(pa.table({
        "id": pa.array([0, 1, 2], pa.int64()), "s": ["a", "b", "c"]})) \
        .createOrReplaceTempView("sw")
    rows = port.sql("select id, lag(s) over (order by id) as prev, "
                    "max(s) over () as m from sw order by id").collect()
    assert [(r["prev"], r["m"]) for r in rows] == [
        (None, "c"), ("a", "c"), ("b", "c")]


def test_float_window_sums_keep_nan_and_infinity_in_their_frames(port):
    """A NaN or an infinity reaches only the frames that hold it (IEEE
    addition per frame); the reference's cumulative sum carries it into
    every later frame (ROADMAP C)."""
    v = [1.0, math.nan, 2.0, 3.0, 4.0, math.inf, 5.0, -math.inf, 6.0, 7.0]
    port.createDataFrame(pa.table({
        "k": pa.array(range(10), pa.int64()),
        "v": pa.array(v, pa.float64())})).createOrReplaceTempView("fw")
    rows = port.sql("select sum(v) over (order by k rows between 2 "
                    "preceding and current row) as s, avg(v) over (order "
                    "by k rows between 2 preceding and current row) as a "
                    "from fw order by k").collect()
    for i, r in enumerate(rows):
        frame = v[max(0, i - 2):i + 1]
        for got, want in ((r["s"], sum(frame)),
                          (r["a"], sum(frame) / len(frame))):
            assert got == want or (math.isnan(got) and math.isnan(want)), (
                i, got, want)


def test_lag_default_takes_the_column_type(port):
    """A lag/lead default is cast to the column's type: a decimal keeps
    its scale and a string joins the column's dictionary, as sqlite
    answers. The reference gives 0.07 and 'b' here (ROADMAP C)."""
    port.createDataFrame(pa.table({
        "k": pa.array([1, 2, 3], pa.int64()),
        "d": pa.array([decimal.Decimal("1.50"), decimal.Decimal("2.25"),
                       None], pa.decimal128(12, 2)),
        "s": ["b", "c", "d"]})).createOrReplaceTempView("lagdef")
    rows = port.sql("select lag(d, 1, 7) over (order by k) as x, "
                    "lag(s, 1, 'zz') over (order by k) as y from lagdef "
                    "order by k").collect()
    assert [tuple(r) for r in rows] == [
        (decimal.Decimal("7.00"), "zz"), (decimal.Decimal("1.50"), "b"),
        (decimal.Decimal("2.25"), "c")]


def test_nan_and_null_order_keys(port):
    """NaN sorts greatest but is a peer group apart from NULL; NaNs are
    mutual peers (the reference's regression tests, same rows)."""
    port.createDataFrame(pa.table({
        "k": pa.array([1, 1, 1, 1], pa.int64()),
        "o": pa.array([1.0, 2.0, math.nan, None], pa.float64()),
        "v": pa.array([10, 20, 300, 4000], pa.int64())})) \
        .createOrReplaceTempView("nanwin")

    def by_o(sql):
        return {("nan" if isinstance(r["o"], float) and math.isnan(r["o"])
                 else r["o"]): r["s"] for r in port.sql(sql).collect()}

    assert by_o("select o, sum(v) over (partition by k order by o asc "
                "nulls last) as s from nanwin") == {
        1.0: 10, 2.0: 30, "nan": 330, None: 4330}
    got = by_o("select o, sum(v) over (partition by k order by o asc nulls "
               "last range between 1 preceding and 1 following) as s "
               "from nanwin")
    assert got["nan"] == 300 and got[None] == 4000
    got = by_o("select o, sum(v) over (partition by k order by o desc "
               "nulls first) as s from nanwin")
    assert got[None] == 4000 and got["nan"] == 4300

    port.createDataFrame(pa.table({
        "o": pa.array([1.0, math.nan, math.nan], pa.float64()),
        "v": pa.array([10, 100, 200], pa.int64())})) \
        .createOrReplaceTempView("nan2")
    rows = port.sql("select v, sum(v) over (order by o) as s, rank() over "
                    "(order by o) as r from nan2").collect()
    assert {r["v"]: (r["s"], r["r"]) for r in rows} == {
        10: (10, 1), 100: (310, 2), 200: (310, 2)}


# ---- SQL: the inputs of tests/test_grouping_sets.py ---------------------------


@pytest.fixture(scope="module")
def gview(port):
    rows = [("x", "p", 1), ("x", "q", 2), ("y", "p", 4), ("y", "p", 8),
            ("x", "p", 16)]
    port.createDataFrame(pa.table({
        "a": [r[0] for r in rows], "b": [r[1] for r in rows],
        "v": pa.array([r[2] for r in rows], pa.int64())})) \
        .createOrReplaceTempView("g")
    port.createDataFrame(pa.table({
        "a": pa.array(["x", None, "x"]),
        "v": pa.array([1, 2, 4], pa.int64())})).createOrReplaceTempView("gn")


def _gkey(t):
    return tuple((x is None, str(x)) for x in t)


def _grows(port, sql):
    return sorted((tuple(r) for r in port.sql(sql).collect()), key=_gkey)


@pytest.mark.parametrize("sql,want", [
    ("select a, b, sum(v) as s from g group by rollup(a, b)",
     [("x", "p", 17), ("x", "q", 2), ("y", "p", 12), ("x", None, 19),
      ("y", None, 12), (None, None, 31)]),
    ("select a, b, sum(v) as s from g group by cube(a, b)",
     [("x", "p", 17), ("x", "q", 2), ("y", "p", 12), ("x", None, 19),
      ("y", None, 12), (None, "p", 29), (None, "q", 2), (None, None, 31)]),
    ("select a, b, sum(v) as s from g "
     "group by grouping sets ((a, b), (b), ())",
     [("x", "p", 17), ("x", "q", 2), ("y", "p", 12), (None, "p", 29),
      (None, "q", 2), (None, None, 31)]),
    ("select a, b, sum(v) as s from g group by rollup(a, b) "
     "having sum(v) > 15",
     [("x", "p", 17), ("x", None, 19), (None, None, 31)]),
    ("select a, b, sum(v) as s from g group by rollup(a, b) "
     "having a = 'x'",
     [("x", "p", 17), ("x", "q", 2), ("x", None, 19)]),
    ("select a, sum(v) as s from g group by rollup(a) "
     "having grouping(a) = 1", [(None, 31)]),
    ("select a, sum(v) as s from g group by grouping sets (a, ())",
     [("x", 19), ("y", 12), (None, 31)]),
    # a real NULL key stays apart from the subtotal's NULL
    ("select a, grouping(a) as ga, sum(v) as s from gn group by rollup(a)",
     [("x", 0, 5), (None, 0, 2), (None, 1, 7)]),
])
def test_grouping_sets_sql(port, gview, sql, want):
    assert _grows(port, sql) == sorted(want, key=_gkey)


def test_grouping_and_grouping_id(port, gview):
    rows = port.sql("select a, grouping(a) as ga, grouping(b) as gb, "
                    "grouping_id() as gid, sum(v) as s from g "
                    "group by rollup(a, b)").collect()
    assert len(rows) == 6
    for r in rows:
        assert r["gid"] == r["ga"] * 2 + r["gb"]
        assert r["ga"] == (1 if r["a"] is None else 0)


@pytest.mark.parametrize("keys,group_by", [
    ("a,", "rollup(a)"), ("a, b,", "cube(a, b)"), ("", "grouping sets (())")])
def test_grouping_sets_over_no_rows_are_empty(port, gview, keys, group_by):
    """An Expand of no rows feeds no group, the grand total included:
    Spark's semantics. sqlite's UNION ALL equivalent returns a grand
    total (NULL, 0, NULL), and the reference one empty group for ROLLUP
    (its sorted-path fault, ROADMAP C)."""
    assert port.sql(f"select {keys} count(*) as n, sum(v) as s from g "
                    f"where v > 100 group by {group_by}").collect() == []


# ---- FROM-less SELECT and range ----------------------------------------------


def test_select_without_from_and_range(port):
    assert [tuple(r) for r in port.sql("select 1 + 1").collect()] == [(2,)]
    assert [tuple(r) for r in port.sql(
        "select 3 * 4 as x, 'a' as s").collect()] == [(12, "a")]
    assert [r["id"] for r in port.range(5).collect()] == [0, 1, 2, 3, 4]
    assert [r["id"] for r in port.range(10, 0, -4).collect()] == [10, 6, 2]
    port.range(1, 100, 3).createOrReplaceTempView("r")
    even = [i for i in range(1, 100, 3) if i % 2 == 0]
    assert [tuple(r) for r in port.sql(
        "select count(*), sum(id), max(id) from r where id % 2 = 0"
    ).collect()] == [(len(even), sum(even), max(even))]


# ---- the sparse table --------------------------------------------------------


def test_bounded_min_max_refused_past_the_sparse_table_limit(port,
                                                             monkeypatch):
    """The reference refuses a bounded min/max frame over a batch of more
    than 4M rows (the sparse table's memory); the limit is lowered here
    so a small batch reaches it."""
    port.range(0, 5000).createOrReplaceTempView("big")
    sql = ("select sum(m) from (select min(id) over (order by id rows "
           "between 2 preceding and current row) as m from big) t")
    assert port.sql(sql).collect()[0][0] == sum(max(0, i - 2)
                                                for i in range(5000))
    monkeypatch.setattr(PW, "SPARSE_TABLE_MAX_ROWS", 4096)
    with pytest.raises(NotImplementedError, match="4M-row"):
        port.sql(sql).collect()
    # prefix frames need no sparse table
    assert port.sql("select sum(m) from (select min(id) over (order by id "
                    "desc) as m from big) t").collect()[0][0] == \
        sum(range(5000))


def test_floor_log2_is_exact_at_powers_of_two():
    x = torch.tensor([1, 2, 3, 4, 7, 8, (1 << 22) - 1, 1 << 22,
                      (1 << 40) + 1, (1 << 62)], dtype=torch.int64)
    want = [v.bit_length() - 1 for v in x.tolist()]
    assert PW._floor_log2(x).tolist() == want


@pytest.mark.parametrize("dtype", [torch.int64, torch.float64])
def test_segmented_scan_restarts_at_segments(dtype):
    rng = np.random.default_rng(3)
    seg = torch.from_numpy(np.sort(rng.integers(0, 9, 300))).to(torch.int32)
    x = torch.from_numpy(rng.integers(-50, 50, 300)).to(dtype)
    if dtype == torch.float64:
        x[17] = float("nan")
    for combine, np_acc in ((torch.maximum, np.maximum.accumulate),
                            (torch.minimum, np.minimum.accumulate)):
        got = PK.seg_scan(seg, x, combine).numpy()
        want = np.empty(300)
        for s in torch.unique(seg).tolist():
            idx = (seg == s).numpy()
            want[idx] = np_acc(x.numpy()[idx])
        assert np.array_equal(got, want.astype(got.dtype), equal_nan=True)
