"""All 22 TPC-H queries through the port's mesh on 8 CPU ranks (sf 0.02,
seed 99, the tables of tests/test_torch_sql.py), through
``SparkSession.builder.master("mesh[8]").meshDevices(["cpu"] * 8)``:
each query's rows against the sqlite oracle (within rel 1e-6, the
oracle's own bound, ``assert_rows_match``) and against the port's
single-device run on the same tables (integers, decimals, dates and
strings exactly; floats within rel 1e-9 of it, since a mesh adds each
rank's partial sums in rank order; rows as multisets, since ORDER BY
ties may permute). The reference's own mesh runs all 22 in its slow
lane; the port's single-device rows are held against the reference in
the TPC-H files of the earlier slices."""

import pytest

from spark_tpu_torch.api.session import SparkSession
from spark_tpu_torch.tpch import QUERIES, generate_tables, register_views
from spark_tpu_torch.tpch.oracle import (assert_rows_match, index_keys,
                                         load_sqlite, run_oracle)

from test_torch_threads import one_torch_thread  # noqa: F401

REL = 1e-9


@pytest.fixture(scope="module")
def engines():
    tables = generate_tables(0.02, seed=99)
    mesh = SparkSession(device="cpu", conf={"spark_tpu.mesh.devices": 8},
                        mesh_devices=["cpu"] * 8)
    single = SparkSession(device="cpu")
    for s in (mesh, single):
        register_views(s, tables)
    conn = load_sqlite(tables)
    index_keys(conn)
    conn.execute("pragma case_sensitive_like = on")
    yield mesh, single, conn
    conn.close()


def _key(r):
    return tuple((v is None, str(type(v)), v) for v in r)


@pytest.mark.parametrize("qnum", sorted(QUERIES))
def test_tpch_on_8_ranks(engines, qnum):
    mesh, single, conn = engines
    got = [tuple(r) for r in mesh.sql(QUERIES[qnum]).collect()]
    assert got, f"q{qnum} returned no rows at this scale"
    assert mesh.mesh_executor.last_run["stages"]
    assert_rows_match(got, run_oracle(conn, QUERIES[qnum]),
                      label=f"q{qnum}[mesh 8]")
    want = sorted((tuple(r) for r in single.sql(QUERIES[qnum]).collect()),
                  key=_key)
    got = sorted(got, key=_key)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(a, float) and isinstance(b, float):
                assert a == pytest.approx(b, rel=REL, abs=1e-12), (g, w)
            else:
                assert a == b and type(a) is type(b), (g, w)
