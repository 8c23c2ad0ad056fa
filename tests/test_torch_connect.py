"""The port's connect server and client (``spark_tpu_torch/connect/``) on the
cases of tests/test_connect.py: SQL over HTTP with Arrow IPC results,
tables and errors, the typed JSON plan protocol (filters, aggregates,
USING joins of each type, the function allowlist), the lint endpoint
and ``/trace/<id>``.

Held against the reference: JSON plans decoded by ``connect/proto`` of
each package run to the same rows (the reference runs once, in a module
fixture). Held against the port itself: served rows equal the
session's own ``toArrow()`` bit for bit.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from spark_tpu.api.dataframe import DataFrame as RefDataFrame
from spark_tpu.connect import proto as ref_proto
from spark_tpu_torch.api.dataframe import DataFrame
from spark_tpu_torch.api.session import SparkSession
from spark_tpu_torch.connect import proto
from spark_tpu_torch.connect.server import (Client, ConnectServer, col, fn,
                                            lit)
from spark_tpu_torch.serve.result_cache import table_to_ipc

from test_torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.timeout(120)


def _rows(seed: int, n: int = 300):
    rng = np.random.default_rng(seed)
    return ([{"k": int(k), "v": int(v), "s": "abc"[int(i)],
              "x": float(x)}
             for k, v, i, x in zip(rng.integers(0, 6, n),
                                   rng.integers(-50, 500, n),
                                   rng.integers(0, 3, n),
                                   rng.integers(0, 1000, n) / 8.0)],
            [{"k": i, "w": i * 10} for i in range(0, 8, 2)])


@pytest.fixture(scope="module")
def port():
    s = SparkSession(device="cpu")
    fact, dim = _rows(5)
    s.createDataFrame(fact).createOrReplaceTempView("cp_t")
    s.createDataFrame(dim).createOrReplaceTempView("cp_d")
    return s


@pytest.fixture(scope="module")
def server(port):
    srv = ConnectServer(port, port=0).start()
    yield srv
    srv.stop()


def _plans():
    """JSON plans as the client builds them (no engine imports)."""
    t, d = {"op": "read", "table": "cp_t"}, {"op": "read", "table": "cp_d"}
    gt4 = {"e": "bin", "op": ">", "left": col("v"), "right": lit(4)}
    agg = {"op": "aggregate", "groupings": [col("k")],
           "aggregates": [{"e": "alias", "name": "n",
                           "child": fn("count", "v")},
                          {"e": "alias", "name": "sv",
                           "child": fn("sum", "v")},
                          {"e": "alias", "name": "ds",
                           "child": fn("count", "s", distinct=True)},
                          {"e": "alias", "name": "mx",
                           "child": fn("max", "x")}],
           "child": {"op": "filter", "condition": gt4, "child": t}}
    sort_k = [{"expr": col("k"), "asc": True}]
    plans = {"aggregate": {"op": "sort", "orders": sort_k, "child": agg}}
    for how in ("inner", "left", "right", "full"):
        plans[f"join_{how}"] = {
            "op": "sort",
            "orders": [{"expr": col("k"), "asc": True},
                       {"expr": col("v"), "asc": True},
                       {"expr": col("x"), "asc": True}],
            "child": {"op": "join", "how": how, "on": ["k"],
                      "left": t, "right": d}}
    plans["project_limit"] = {
        "op": "limit", "n": 7, "offset": 2,
        "child": {"op": "sort", "orders": [{"expr": col("v2"), "asc": False},
                                           {"expr": col("k"), "asc": True}],
                  "child": {"op": "project",
                            "exprs": [col("k"), fn("upper", "s"),
                                      {"e": "alias", "name": "v2",
                                       "child": {"e": "bin", "op": "*",
                                                 "left": col("v"),
                                                 "right": lit(2)}}],
                            "child": t}}}
    plans["union_distinct"] = {
        "op": "sort", "orders": sort_k,
        "child": {"op": "distinct", "child": {
            "op": "union",
            "left": {"op": "project", "exprs": [col("k")], "child": t},
            "right": {"op": "project", "exprs": [col("k")], "child": d}}}}
    return plans


@pytest.fixture(scope="module")
def ref_rows(spark):
    fact, dim = _rows(5)
    spark.createDataFrame(fact).createOrReplaceTempView("cp_t")
    spark.createDataFrame(dim).createOrReplaceTempView("cp_d")
    out = {}
    for name, plan in _plans().items():
        df = RefDataFrame(spark, ref_proto.decode_plan(plan, spark))
        out[name] = (list(df.columns), [tuple(r) for r in df.collect()])
    return out


@pytest.mark.parametrize("name", sorted(_plans()))
def test_json_plan_rows_match_reference(port, server, ref_rows, name):
    plan = _plans()[name]
    df = DataFrame(port, proto.decode_plan(plan, port))
    cols, want = ref_rows[name]
    assert list(df.columns) == cols
    assert [tuple(r) for r in df.collect()] == want
    # through the server: the session's own bytes
    served = Client(server.url)._execute_plan(plan)
    assert table_to_ipc(served) == table_to_ipc(df.toArrow())


def test_sql_roundtrip(server, port):
    q = "select k, sum(v) as s, count(*) as n from cp_t group by k order by k"
    got = Client(server.url).sql(q)
    assert table_to_ipc(got) == table_to_ipc(port.sql(q).toArrow())
    assert got.to_pylist() == [r.asDict() for r in port.sql(q).collect()]


def test_tables_and_errors(server):
    c = Client(server.url)
    assert {"cp_t", "cp_d"} <= set(c.tables())
    with pytest.raises(RuntimeError, match="server traceback"):
        c.sql("select * from does_not_exist")


def test_remote_dataframe_builders(server, port):
    c = Client(server.url)
    out = (c.table("cp_t")
           .filter({"e": "bin", "op": ">", "left": col("v"),
                    "right": lit(4)})
           .groupBy("k")
           .agg(n=fn("count", "v"), sv=fn("sum", "v"),
                ds=fn("count", "s", distinct=True))
           .sort("k").toArrow())
    want = port.sql("select k, count(v) as n, sum(v) as sv, "
                    "count(distinct s) as ds from cp_t where v > 4 "
                    "group by k order by k").toArrow()
    assert out.to_pylist() == want.to_pylist()
    j = (c.table("cp_t").join(c.table("cp_d"), on="k")
         .select("k", "v", "w").sort("v").limit(5).toArrow())
    assert j.column_names == ["k", "v", "w"] and j.num_rows == 5
    assert all(r["w"] == r["k"] * 10 for r in j.to_pylist())
    with pytest.raises(RuntimeError, match="no_such_fn"):
        c.table("cp_t").select(fn("no_such_fn", "v")).toArrow()


def test_using_right_and_full_join_keys(server, port):
    port.createDataFrame([{"k": 1, "v": 10}, {"k": 2, "v": 20}]) \
        .createOrReplaceTempView("cpr_l")
    port.createDataFrame([{"k": 2, "w": 200}, {"k": 3, "w": 300}]) \
        .createOrReplaceTempView("cpr_r")
    c = Client(server.url)
    right = (c.table("cpr_l").join(c.table("cpr_r"), on="k", how="right")
             .sort("k").toArrow())
    assert right.column_names == ["k", "v", "w"]
    assert right.to_pylist() == [{"k": 2, "v": 20, "w": 200},
                                 {"k": 3, "v": None, "w": 300}]
    full = (c.table("cpr_l").join(c.table("cpr_r"), on="k", how="full")
            .sort("k").toArrow())
    assert full.to_pylist() == [{"k": 1, "v": 10, "w": None},
                                {"k": 2, "v": 20, "w": 200},
                                {"k": 3, "v": None, "w": 300}]


def test_fn_dispatch_is_allowlisted():
    for name in ("expr", "col", "lit", "window", "udf"):
        with pytest.raises(ValueError, match="unknown function"):
            proto.decode_expr({"e": "fn", "name": name,
                               "args": [{"e": "lit", "value": "x"}]})
    assert proto.decode_expr({"e": "fn", "name": "upper",
                              "args": [{"e": "col", "name": "s"}]}) \
        is not None
    assert proto._SCALAR_FNS == ref_proto._SCALAR_FNS


def test_lint_endpoint(server):
    req = urllib.request.Request(
        server.url + "/lint",
        data=json.dumps({"query": "select k, sum(x) as s from cp_t "
                                  "group by k"}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        report = json.loads(resp.read())
    assert report["node_count"] > 0 and "diagnostics" in report
    bad = urllib.request.Request(
        server.url + "/lint", data=json.dumps({"query": "selec"}).encode(),
        headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(bad, timeout=30)
    assert ei.value.code == 400


def test_trace_endpoint_and_client_span(server):
    c = Client(server.url)
    c.sql("select k, max(v) as m from cp_t group by k order by k")
    tid = c.last_trace_id
    assert tid and c.last_query["trace_id"] == tid
    chrome = c.trace()
    names = {e["name"] for e in chrome["traceEvents"] if e.get("ph") == "X"}
    assert {"connect.client", "connect.request", "scheduler.run",
            "scheduler.queue", "query.execute", "stage.run"} <= names
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(server.url + "/trace/no-such-trace",
                               timeout=10)
    assert ei.value.code == 404


def test_cancel_unknown_query_is_404(server):
    assert Client(server.url).cancel(987654) is False
