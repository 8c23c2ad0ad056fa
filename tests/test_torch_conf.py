"""The port's session settings (``spark_tpu_torch/conf.py``) against the
JAX package's: ``RuntimeConf.set/get/unset``, the value types of the
registered keys and undeclared keys under each
``spark.tpu.analysis.level``; ``spark.sql.cbo.joinReorder.enabled`` off
keeps the parsed join order, as the reference's does, with the same
rows; and the runtime semi-join filters
(``spark.tpu.runtimeFilter.semiJoinReduction``) on and off give the same
rows as the reference with the same settings, on the reference's own
runtime-filter input (a filtered dimension joined to a large Parquet
scan) and on TPC-H q3 read from Parquet. Counts, integers and decimals
are exact; float sums within rel 1e-9, the reference test's bound.
"""

import warnings

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_tpu import conf as RC
from spark_tpu.plan import logical as RL
from spark_tpu.plan.optimizer import optimize as ref_optimize
from spark_tpu_torch import conf as PC
from spark_tpu_torch.api.session import SparkSession as PortSession
from spark_tpu_torch.plan import logical as PL
from spark_tpu_torch.plan.optimizer import optimize as port_optimize

CBO = "spark.sql.cbo.joinReorder.enabled"
RF_ON = "spark.tpu.runtimeFilter.semiJoinReduction"
RF_MIN = "spark.tpu.runtimeFilter.minRows"
LEVEL = "spark.tpu.analysis.level"


@pytest.mark.parametrize("mod", [RC, PC], ids=["ref", "port"])
def test_set_get_unset_and_types(mod):
    conf = mod.RuntimeConf()
    assert conf.get(CBO) is True
    assert conf.get(mod.CBO_JOIN_REORDER) is True
    conf.set(CBO, 0)
    assert conf.get(CBO) is False  # coerced by the entry's type
    conf.set(RF_MIN, "64")
    assert conf.get(RF_MIN) == 64
    conf.unset(CBO)
    assert conf.get(CBO) is True
    with pytest.raises(KeyError, match="unknown config key"):
        conf.get("spark.no.such.key")
    assert conf.entries()[RF_MIN] == 64


def test_port_keys_match_the_reference():
    """Every key the port registers has the reference's default."""
    # the reference registers these keys in the modules that read them,
    # loaded lazily; the port's session loads its counterparts at import
    import spark_tpu.deadline  # noqa: F401
    import spark_tpu.extensions  # noqa: F401
    import spark_tpu.faults  # noqa: F401
    import spark_tpu.physical.pipeline  # noqa: F401
    import spark_tpu.plan.optimizer  # noqa: F401  (registers its keys)
    import spark_tpu.rdd  # noqa: F401  (spark.task.maxFailures)
    import spark_tpu.recovery  # noqa: F401
    import spark_tpu.serve  # noqa: F401  (breaker, ownership, cache keys)
    import spark_tpu.trace  # noqa: F401
    import spark_tpu.ui  # noqa: F401

    for key, entry in PC._REGISTRY.items():
        assert RC.is_registered(key), key
        assert entry.default == RC._REGISTRY[key].default, key
    assert {CBO, RF_ON, RF_MIN, LEVEL} <= set(PC._REGISTRY)
    assert not PC.is_registered("spark.sql.shuffle.partitions")
    prefix = PC.register_prefix("spark.test.family.", "a test family")
    assert PC.is_registered(prefix + "anything")


@pytest.mark.parametrize("level", ["off", "warn", "error"])
def test_undeclared_key_under_each_level(level):
    outcomes = []
    for mod in (RC, PC):
        conf = mod.RuntimeConf({LEVEL: level})
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                conf.set("spark.typo.key", 1)
                outcome = "set"
            except KeyError:
                outcome = "raised"
        warned = any("undeclared key" in str(w.message) for w in caught)
        outcomes.append((outcome, warned))
    assert outcomes[0] == outcomes[1]
    assert outcomes[1] == {"off": ("set", False), "warn": ("set", True),
                           "error": ("raised", False)}[level]


def test_builder_config_and_active_session():
    s = PortSession.builder.device("cpu").config(RF_MIN, 128).getOrCreate()
    assert s.conf.get(RF_MIN) == 128
    again = PortSession.builder.device("cpu").config(CBO, False) \
        .getOrCreate()
    assert again is s and PortSession.getActiveSession() is s
    assert s.conf.get(CBO) is False and s.conf.get(RF_MIN) == 128
    s.conf.unset(CBO)
    s.conf.unset(RF_MIN)


# ---- join reordering under the setting ------------------------------------------


def _star_tables():
    rng = np.random.default_rng(7)
    return (pa.table({
        "f_id": pa.array(np.arange(2000), pa.int64()),
        "f_a": pa.array(rng.integers(0, 10, 2000), pa.int64()),
        "f_b": pa.array(rng.integers(0, 5, 2000), pa.int64())}),
        pa.table({"a_id": pa.array(np.arange(10), pa.int64()),
                  "a_name": pa.array([f"a{i}" for i in range(10)])}),
        pa.table({"b_id": pa.array(np.arange(5), pa.int64()),
                  "b_name": pa.array([f"b{i}" for i in range(5)])}))


STAR = """select a_name, b_name, count(*) as n
from fact join dim_a on f_a = a_id join dim_b on f_b = b_id
group by a_name, b_name order by a_name, b_name"""


def _join_keys(plan, join_type) -> list:
    out = []

    def walk(node):
        if isinstance(node, join_type):
            out.append(tuple(str(k) for k in node.left_keys + node.right_keys))
        for c in node.children():
            walk(c)

    walk(plan)
    return out


def test_join_reorder_setting(spark):
    port = PortSession(device="cpu")
    for sess in (spark, port):
        for name, tbl in zip(("fact", "dim_a", "dim_b"), _star_tables()):
            sess.createDataFrame(tbl).createOrReplaceTempView(name)
    orders, rows = {}, {}
    for enabled in (False, True):
        spark.conf.set(CBO, enabled)
        port.conf.set(CBO, enabled)
        try:
            ref_df, port_df = spark.sql(STAR), port.sql(STAR)
            orders[enabled] = (
                _join_keys(ref_optimize(ref_df._plan), RL.Join),
                _join_keys(port_optimize(port_df._plan, port.conf), PL.Join),
                _join_keys(port_df._plan, PL.Join))
            rows[enabled] = ([tuple(r) for r in port_df.collect()],
                             [tuple(r) for r in ref_df.collect()])
        finally:
            spark.conf.set(CBO, True)
    ref_off, port_off, parsed = orders[False]
    assert port_off == ref_off == parsed  # off: the parsed order
    assert orders[True][1] == orders[True][0] != parsed  # on: reordered
    assert rows[False][0] == rows[False][1] == rows[True][0] \
        == rows[True][1]
    assert sum(r[2] for r in rows[True][0]) == 2000


# ---- runtime filters under the setting -------------------------------------------


def _rf_run(sess, opt_plan, query, conf_of):
    """(rows, number of left-semi joins in the optimized plan) with
    runtime filters off, then on."""
    out = []
    for on in (False, True):
        sess.conf.set(RF_ON, on)
        try:
            df = sess.sql(query)
            semis = [j for j in opt_plan(df._plan, conf_of(sess))
                     if j.how == "left_semi"]
            out.append(([tuple(r) for r in df.collect()], len(semis)))
        finally:
            sess.conf.unset(RF_ON)
    return out


def _ref_joins(plan, conf):
    return RL.collect_nodes(ref_optimize(plan), RL.Join)


def _port_joins(plan, conf):
    return PL.collect_nodes(port_optimize(plan, conf), PL.Join)


def _close(got, want, rel=1e-9):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(a, float):
                assert abs(a - b) <= rel * max(1.0, abs(b)), (g, w)
            else:
                assert a == b, (g, w)


def test_runtime_filter_rows_match_reference(spark, tmp_path):
    n = 1 << 15
    rng = np.random.default_rng(5)
    big = str(tmp_path / "big.parquet")
    pq.write_table(pa.table({
        "k": pa.array(rng.integers(0, 1000, n), pa.int64()),
        "v": pa.array(rng.random(n)),
    }), big)
    small = pa.table({"k": pa.array(np.arange(1000), pa.int64()),
                      "grp": pa.array((np.arange(1000) % 7).astype("int64"))})
    query = ("select count(*) as c, sum(v) as s from rf_big "
             "join rf_small on rf_big.k = rf_small.k")
    port = PortSession(device="cpu")
    results = {}
    for name, sess, opt in (("ref", spark, _ref_joins),
                            ("port", port, _port_joins)):
        sess.conf.set(RF_MIN, n)
        try:
            sess.read.parquet(big).createOrReplaceTempView("rf_big")
            sess.createDataFrame(small).filter("grp = 3") \
                .createOrReplaceTempView("rf_small")
            results[name] = _rf_run(sess, opt, query, lambda s: s.conf)
        finally:
            sess.conf.unset(RF_MIN)
    (port_off, semis_off), (port_on, semis_on) = results["port"]
    (ref_off, ref_semis_off), (ref_on, ref_semis_on) = results["ref"]
    assert (semis_off, semis_on) == (ref_semis_off, ref_semis_on) == (0, 1)
    assert port_on[0][0] == port_off[0][0] == ref_on[0][0] == ref_off[0][0]
    _close(port_on, ref_on)
    _close(port_off, ref_off)
    _close(port_on, port_off)


def test_runtime_filter_tpch_q3_from_parquet(spark, tmp_path):
    """TPC-H q3 (sf 0.02) over Parquet files: the same rows with runtime
    filters on and off, and the reference's rows with them on."""
    from spark_tpu.tpch.gen import generate_tables
    from spark_tpu_torch.tpch import QUERIES

    tables = generate_tables(0.02, seed=99)
    port = PortSession(device="cpu")
    for name in ("customer", "orders", "lineitem"):
        path = str(tmp_path / name)
        pq.write_table(tables[name], path + ".parquet")
        port.read.parquet(path + ".parquet").createOrReplaceTempView(name)
    port.conf.set(RF_MIN, 1000)
    try:
        (off, semis_off), (on, semis_on) = _rf_run(
            port, _port_joins, QUERIES[3], lambda s: s.conf)
    finally:
        port.conf.unset(RF_MIN)
    assert semis_off == 0 and semis_on >= 1
    assert on and on == off
    for name in ("customer", "orders", "lineitem"):
        spark.read.parquet(str(tmp_path / name) + ".parquet") \
            .createOrReplaceTempView(name)
    spark.conf.set(RF_MIN, 1000)
    spark.conf.set(RF_ON, True)
    try:
        want = [tuple(r) for r in spark.sql(QUERIES[3]).collect()]
    finally:
        spark.conf.unset(RF_ON)
        spark.conf.unset(RF_MIN)
        for name in ("customer", "orders", "lineitem"):
            spark.catalog.dropTempView(name)
    assert on == want
