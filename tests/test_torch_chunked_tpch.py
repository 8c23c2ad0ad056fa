"""chip_smoke.py's ooc phase on the CPU, at sf 0.01 from Parquet: for
every query of ``tpch/queries.py:OOC_QUERIES``, at the budget the phase
sets (one byte under the largest scan estimate, or the second largest),
the port's ``find_chunkable`` picks the tier the table names, and so does
the reference's on the same files (this test decides the table). The
chunked rows equal the port's resident rows: exactly, and F1's float
sums and averages within ``rel=1e-9``; pipeline depths 0 and 2 give the
same rows.

A1 of the scalar phase is not in the table: its stddev and variance are
not mergeable accumulators, and both packages run it resident; F1 takes
its place (float sums through seg_fsum on the card).
"""

import os

import pyarrow.parquet as pq
import pytest

from spark_tpu_torch.api.session import SparkSession as PortSession
from spark_tpu_torch.physical import chunked
from spark_tpu_torch.plan.optimizer import optimize
from spark_tpu_torch.tpch import generate_tables
from spark_tpu_torch.tpch.queries import (OOC_QUERIES, SCALAR_QUERIES,
                                          ooc_budget)

from test_torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def tpch_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("ooc_tpch")
    tables = generate_tables(0.01, seed=99)
    for name, t in tables.items():
        os.makedirs(root / name)
        pq.write_table(t, str(root / name / "part-0.parquet"))
    return str(root), list(tables)


@pytest.fixture(scope="module")
def port(tpch_files):
    root, names = tpch_files
    s = PortSession(device="cpu")
    for n in names:
        s.read.parquet(os.path.join(root, n)).createOrReplaceTempView(n)
    return s


@pytest.fixture(scope="module")
def ref_tiers(spark, tpch_files, port):
    """The reference's tier for each query at the port's budget."""
    from spark_tpu.physical.chunked import find_chunkable as ref_find
    from spark_tpu.plan.optimizer import optimize as ref_optimize

    root, names = tpch_files
    for n in names:
        spark.read.parquet(os.path.join(root, n)).createOrReplaceTempView(n)
    out = {}
    for name, (query, _, over) in OOC_QUERIES.items():
        budget = ooc_budget(optimize(port.sql(query)._plan, port.conf), over)
        spark.conf.set("spark.tpu.maxDeviceBatchBytes", budget)
        try:
            found = ref_find(ref_optimize(spark.sql(query)._plan), spark.conf)
        finally:
            spark.conf.unset("spark.tpu.maxDeviceBatchBytes")
        out[name] = None if found is None else type(found).__name__
    return out


def _rows(df):
    return [tuple(r) for r in df.collect()]


def _equal(name, got, want):
    if name != "f1_168":
        assert got == want
        return
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[:5] == w[:5]
        assert g[5:] == pytest.approx(w[5:], rel=1e-9)


@pytest.mark.parametrize("name", list(OOC_QUERIES))
def test_ooc_tier_and_rows(port, ref_tiers, name):
    query, tier, over = OOC_QUERIES[name]
    df = port.sql(query)
    resident = _rows(df)
    budget = ooc_budget(optimize(df._plan, port.conf), over)
    port.conf.set("spark.tpu.maxDeviceBatchBytes", budget)
    port.conf.set("spark.tpu.chunkRows", 16_384)
    try:
        found = chunked.find_chunkable(optimize(df._plan, port.conf),
                                       port.conf)
        assert (None if found is None else type(found).__name__) \
            == ref_tiers[name] == tier
        before = chunked.last_run
        by_depth = {}
        for depth in (0, 2):
            port.conf.set("spark.tpu.pipelineDepth", depth)
            by_depth[depth] = _rows(df)
            if tier is not None:
                assert chunked.last_run["tier"] == tier
                assert chunked.last_run["pipeline_depth"] == depth
            else:
                assert chunked.last_run is before  # ran resident
    finally:
        for k in ("spark.tpu.maxDeviceBatchBytes", "spark.tpu.chunkRows",
                  "spark.tpu.pipelineDepth"):
            port.conf.unset(k)
    assert by_depth[0] == by_depth[2]
    _equal(name, by_depth[0], resident)
    if name == "q3":
        rec = chunked.last_run
        assert rec["sidecars"] == 1 and rec["key_filters"] == 1
        assert rec["rows_kept"] < rec["rows_in"]


def test_a1_is_not_chunkable(port):
    """A1's stddev and variance do not decompose into mergeable
    accumulators: no tier, at any budget."""
    df = port.sql(SCALAR_QUERIES["a1_168"])
    port.conf.set("spark.tpu.maxDeviceBatchBytes", 1)
    try:
        assert chunked.find_chunkable(optimize(df._plan, port.conf),
                                      port.conf) is None
    finally:
        port.conf.unset("spark.tpu.maxDeviceBatchBytes")
