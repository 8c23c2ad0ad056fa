"""The port's session extensions (``spark_tpu_torch/extensions.py``) on the
inputs of tests/test_extensions.py: injected functions from SQL, optimizer
rules after the fixpoint, parser hooks, ``spark.plugins`` with their
lifecycle (``session.stop()`` shuts them down) and
``SparkSessionBuilder.withExtensions``.
"""

import pytest

from spark_tpu_torch.api.session import SparkSession
from spark_tpu_torch.expr import expressions as E
from spark_tpu_torch.plan import logical as L
from spark_tpu_torch.sql.parser import SQLParseError

from test_torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture()
def port():
    s = SparkSession(device="cpu")
    yield s
    s.stop()


def test_inject_function_sql_and_resolution(port):
    port.extensions.inject_function(
        "double_it", lambda e: E.Alias(E.Arith("*", e, E.Literal(2)),
                                       "double_it"))
    rows = port.sql("select double_it(id) as d from "
                    "(select 21 as id)").collect()
    assert rows[0]["d"] == 42


def test_injected_function_is_per_session(port):
    port.extensions.inject_function("triple_it", lambda e: e)
    other = SparkSession(device="cpu")
    with pytest.raises(SQLParseError, match="unknown function"):
        other.sql("select triple_it(1) as x")


def test_inject_optimizer_rule_runs(port):
    seen = {"n": 0}

    def rule(plan):
        seen["n"] += 1
        return plan

    port.extensions.inject_optimizer_rule(rule)
    assert port.range(10).filter("id > 3").count() == 6
    assert seen["n"] >= 1


def test_optimizer_rule_rewrites_the_plan(port):
    def drop_filters(plan):
        return plan.transform_up(
            lambda n: n.child if isinstance(n, L.Filter) else n)

    port.extensions.inject_optimizer_rule(drop_filters)
    assert port.range(10).filter("id > 3").count() == 10


def test_inject_parser_hook(port):
    def hook(sql, catalog, default_parse):
        if sql.strip() == "SHOW MAGIC":
            return L.Range(0, 3, 1, "magic")
        return None

    port.extensions.inject_parser(hook)
    assert [r["magic"] for r in port.sql("SHOW MAGIC").collect()] == [0, 1, 2]
    assert port.sql("select 1 as x").collect()[0]["x"] == 1


class _Plugin:
    inited = 0
    shut = 0

    def init(self, session):
        _Plugin.inited += 1

    def shutdown(self):
        _Plugin.shut += 1


def test_plugin_lifecycle():
    _Plugin.inited = _Plugin.shut = 0
    s = SparkSession(device="cpu",
                     conf={"spark.plugins": f"{__name__}:_Plugin"})
    assert _Plugin.inited == 1
    s.stop()
    assert _Plugin.shut == 1
    s.conf.set("spark.plugins", f"{__name__}:_Plugin")
    s.extensions.load_plugins(s)
    assert _Plugin.inited == 2
    s.extensions.shutdown_plugins()
    assert _Plugin.shut == 2


def test_builder_with_extensions():
    seen = []
    s = (SparkSession.builder.device("cpu")
         .withExtensions(lambda ext: ext.inject_function(
             "seven", lambda: E.Literal(7)))
         .withExtensions(lambda ext: seen.append(ext))
         .getOrCreate())
    try:
        assert seen == [s.extensions]
        assert s.sql("select seven() as x").collect()[0]["x"] == 7
    finally:
        s.stop()
    assert SparkSession.getActiveSession() is not s


def test_unknown_function_still_errors(port):
    with pytest.raises(SQLParseError, match="unknown function"):
        port.sql("select no_such_fn(1)")
