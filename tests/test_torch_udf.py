"""The port's UDFs (``spark_tpu_torch/api/udf.py``) against the JAX
package on the inputs of tests/test_udf.py, each function written once
per package: a tensor UDF (the reference's jax UDF) runs inside the
stage, an arrow UDF on the host once per batch. Rows must be equal
(floats within rel 1e-12: sqrt and sums may round apart between the
two packages' kernels).

A tensor UDF inside a grouped aggregate runs twice: the second run binds
the first run's statistics and runs its stages traced under
``HostTrafficGuard`` (no host sync, no tensor made from host data), as
the card's CUDA-graph capture needs; an arrow UDF keeps its operator
blocking, outside every traced stage."""

import math

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest
import torch

from spark_tpu import types as RT
from spark_tpu.api import functions as RF
from spark_tpu_torch import types as PT
from spark_tpu_torch.api import functions as PF
from spark_tpu_torch.api.session import SparkSession as PortSession
from spark_tpu_torch.expr import expressions as PE
from spark_tpu_torch.physical import graphs, planner

from test_torch_threads import one_torch_thread  # noqa: F401

REL = 1e-12


@pytest.fixture(scope="module")
def engines(spark):
    port = PortSession.builder.device("cpu").getOrCreate()
    return {"ref": (spark, RF, RT, jnp), "port": (port, PF, PT, torch)}


def _same(got, want):
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(a, float) and isinstance(b, float):
                assert math.isclose(a, b, rel_tol=REL), (g, w)
            else:
                assert a == b, (g, w)


def _both(engines, case):
    got = case(*engines["port"])
    want = case(*engines["ref"])
    _same(got, want)
    return got


def _rows(df):
    return [tuple(r) for r in df.collect()]


def test_tensor_udf_fuses(engines):
    def case(s, F, T, xp):
        @F.udf(returnType=T.FLOAT64)
        def hypot(a, b):
            return xp.sqrt(a * a + b * b)

        df = s.createDataFrame([{"a": 3.0, "b": 4.0}, {"a": 6.0, "b": 8.0}])
        return sorted(_rows(df.select(hypot("a", "b").alias("h"))))
    assert _both(engines, case) == [(5.0,), (10.0,)]
    hypot = PF.udf(lambda a, b: torch.sqrt(a * a + b * b), PT.FLOAT64)
    assert not PE.contains_blocking(hypot(PF.col("a"), PF.col("b")))


def test_tensor_udf_null_propagation(engines):
    def case(s, F, T, xp):
        @F.udf(returnType=T.INT64)
        def double(x):
            return x * 2

        df = s.createDataFrame([{"x": 1}, {"x": None}, {"x": 3}])
        got = [r.d for r in df.select(double("x").alias("d")).collect()]
        return [tuple(sorted((v is None, v or 0) for v in got))]
    assert _both(engines, case) == [((False, 2), (False, 6), (True, 0))]


def test_tensor_udf_in_filter_and_agg(engines):
    def case(s, F, T, xp):
        @F.udf(returnType=T.BOOLEAN)
        def is_even(x):
            return x % 2 == 0

        df = s.range(100)
        return [(df.filter(is_even("id")).count(),
                 df.filter(is_even("id")).agg(
                     F.sum("id").alias("s")).collect()[0].s)]
    assert _both(engines, case) == [(50, sum(range(0, 100, 2)))]


def test_arrow_udf_host_roundtrip(engines):
    def case(s, F, T, xp):
        @F.arrow_udf(returnType=T.STRING)
        def shout(v):
            return pc.utf8_upper(v)

        df = s.createDataFrame([{"s": "ab"}, {"s": "cd"}, {"s": None}])
        return sorted(_rows(df.select(shout("s").alias("u"))), key=str)
    assert _both(engines, case) == [("AB",), ("CD",), (None,)]


def test_arrow_udf_python_logic(engines):
    def case(s, F, T, xp):
        @F.arrow_udf(returnType=T.INT64)
        def collatz_steps(v):
            def steps(n):
                if n is None:  # dead and NULL rows arrive as None
                    return None
                c = 0
                while n != 1:
                    n = n // 2 if n % 2 == 0 else 3 * n + 1
                    c += 1
                return c

            return pa.array([steps(x) for x in v.to_pylist()], pa.int64())

        df = s.createDataFrame([{"v": 6}, {"v": 27}, {"v": None}])
        return sorted(_rows(df.select(F.col("v"),
                                      collatz_steps("v").alias("c"))),
                      key=str)
    assert _both(engines, case) == [(27, 111), (6, 8), (None, None)]


def test_arrow_udf_blocks_fusion(engines):
    port = engines["port"][0]

    @PF.arrow_udf(returnType=PT.INT64)
    def ident(v):
        return v

    assert PE.contains_blocking(ident(PF.col("x")))
    df = port.createDataFrame([{"x": i} for i in range(20)])
    rows = df.filter(PF.col("x") > 4).select(ident("x").alias("y")).collect()
    assert sorted(r.y for r in rows) == list(range(5, 20))
    assert planner.last_run.untraceable["ProjectExec"] == 1


def _grouped_udf_table(n=5000, seed=3):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=n).astype(object)
    v[rng.random(n) < 0.05] = None
    return pa.table({
        "g": pa.array(list(np.array(["u", "v", "w", "x"])[
            rng.integers(0, 4, n)])),
        "k": pa.array(rng.integers(0, 300, n), pa.int64()),
        "v": pa.array(list(v), pa.float64()),
    })


def test_tensor_udf_in_grouped_aggregate_traced(engines):
    """A tensor UDF under a grouped aggregate (direct and sorted
    strategies): equal to the reference, and the second run over the same
    table binds the first run's stats and runs its stages traced under
    HostTrafficGuard, with the rows of the first run."""
    table = _grouped_udf_table()

    def query(s, F, T, xp):
        @F.udf(returnType=T.FLOAT64)
        def soft(x, k):
            return xp.abs(x) * 2.0 + k

        df = s.createDataFrame(table)
        return [
            df.groupBy("g").agg(F.sum(soft("v", "k")).alias("s"),
                                F.count(soft("v", "k")).alias("n"))
            .orderBy("g"),
            df.groupBy("k").agg(F.max(soft("v", "k")).alias("m"))
            .orderBy("k")]

    port_frames = query(*engines["port"])
    ref_frames = query(*engines["ref"])
    for pdf, rdf in zip(port_frames, ref_frames):
        first = _rows(pdf)
        _same(first, _rows(rdf))
        assert planner.last_run.first_run
        with graphs.guarding_stages():
            again = _rows(pdf)
        run = planner.last_run
        assert not run.first_run and run.stages >= 1
        assert not run.untraceable
        assert again == first
