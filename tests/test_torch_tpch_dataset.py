"""The port's TPC-H dataset layer (``spark_tpu_torch/tpch/gen.py``:
``write_parquet``, ``write_parquet_streamed``, ``ensure_dataset``,
``register_views(path=)``) against the JAX package's, at sf 0.01.

Both packages' writers give the same file names and equal tables, the
streamed one in several parts (``orders_per_slice=3000``: five), and the
port's in worker processes too. Over the multi-part directory q1 equals
the reference's run, q3 and q5 equal sqlite, and q1, q3 and q5 equal the
port's in-memory views over the same rows. The parts carry their own
string dictionaries: a string column that filters, groups, joins and
sorts gives the in-memory rows, and so does the chunked tier over the
parts. The pyarrow computations of q1, q3 and q5 that the scale phase
of ``chip_smoke.py`` holds the card against equal sqlite here. Last, the
session and native entry points the port took from the reference.

Tolerance: exact for integers, decimals and strings; rel 1e-6 for
floats against sqlite or the reference (``oracle.assert_rows_match``);
the port's multi-part and in-memory runs equal bit for bit.
"""

import os

import numpy as np
import pyarrow.parquet as pq
import pytest

from spark_tpu import native as ref_native
from spark_tpu.tpch import gen as ref_gen
from spark_tpu_torch import native
from spark_tpu_torch.api.session import SparkSession
from spark_tpu_torch.physical import chunked
from spark_tpu_torch.tpch import QUERIES, arrow_queries, gen
from spark_tpu_torch.tpch.oracle import (assert_rows_match, index_keys,
                                         load_sqlite, run_oracle)

SF = 0.01
SEED = 20260729
SLICE = 3000  # orders a part: five parts at sf 0.01

#: a string column (l_comment, a 4096-entry pool per part) that
#: filters, joins two scans of parts 0-2 and 2-4, groups and sorts
STRING_QUERY = """
select a.l_comment, count(*) as n, sum(a.l_quantity) as q
from (select l_comment, l_quantity from lineitem where l_orderkey < 9000) a
join (select distinct l_comment from lineitem where l_orderkey > 6000) b
  on a.l_comment = b.l_comment
where a.l_comment like '%ly%' and a.l_comment > 'b'
group by a.l_comment
order by a.l_comment
"""


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """The reference's and the port's streamed writers over the same
    sf and seed, and the port's again in two worker processes."""
    base = tmp_path_factory.mktemp("tpch_ds")
    out = {k: str(base / k) for k in ("ref", "port", "workers")}
    ref_gen.write_parquet_streamed(SF, out["ref"], SEED,
                                   orders_per_slice=SLICE)
    gen.write_parquet_streamed(SF, out["port"], SEED,
                               orders_per_slice=SLICE)
    gen.write_parquet_streamed(SF, out["workers"], SEED,
                               orders_per_slice=SLICE, workers=2)
    return out


@pytest.fixture(scope="module")
def host_tables(dirs):
    return {name: pq.read_table(os.path.join(dirs["port"],
                                             f"{name}.parquet"))
            for name in gen.TABLES}


@pytest.fixture(scope="module")
def oracle(host_tables):
    conn = load_sqlite(host_tables)
    index_keys(conn)
    conn.execute("pragma case_sensitive_like = on")
    return conn


@pytest.fixture(scope="module")
def sessions(dirs, host_tables):
    """A port session over the multi-part directory and one over the
    same rows in memory."""
    files = SparkSession(device="cpu")
    gen.register_views(files, path=dirs["port"])
    memory = SparkSession(device="cpu")
    gen.register_views(memory, host_tables)
    return files, memory


def test_write_parquet_matches_reference(tmp_path):
    tables = gen.generate_tables(SF, SEED)
    ref_gen.write_parquet(tables, str(tmp_path / "ref"))
    gen.write_parquet(tables, str(tmp_path / "port"))
    names = _files(tmp_path / "ref")
    assert names == _files(tmp_path / "port") \
        == sorted(f"{n}.parquet" for n in gen.TABLES)
    for name in names:
        assert pq.read_table(tmp_path / "port" / name).equals(
            pq.read_table(tmp_path / "ref" / name)), name


@pytest.mark.parametrize("mine", ["port", "workers"])
def test_streamed_writer_matches_reference(dirs, mine):
    names = _files(dirs["ref"])
    assert names == _files(dirs[mine])
    parts = [n for n in names if n.startswith("lineitem.parquet")]
    assert parts == [f"lineitem.parquet/part-{i:05d}.parquet"
                     for i in range(5)]
    for name in names:
        got = pq.read_table(os.path.join(dirs[mine], name))
        assert got.equals(pq.read_table(os.path.join(dirs["ref"], name))), \
            name
    assert pq.ParquetFile(os.path.join(dirs[mine], parts[0])) \
        .metadata.num_rows > 0


def test_parts_carry_their_own_dictionaries(dirs):
    first, second = (pq.read_table(os.path.join(
        dirs["port"], "lineitem.parquet", f"part-{i:05d}.parquet"))
        .column("l_comment").chunk(0).dictionary.to_pylist()
        for i in range(2))
    assert first != second


def test_ensure_dataset_names_marks_and_keeps(tmp_path, monkeypatch):
    path = gen.ensure_dataset(SF, base=str(tmp_path), seed=SEED)
    assert path == str(tmp_path / "tpch_sf0p01")
    assert _files(path) == sorted(
        ["_DONE"] + [f"{n}.parquet" for n in gen.TABLES])
    done = gen.dataset_report(path)
    assert done["recipe"] == {"sf": SF, "seed": SEED, "writer": "memory",
                              "orders_per_slice": None}
    assert done["report"]["bytes"] > 0
    ref = ref_gen.ensure_dataset(SF, base=str(tmp_path / "ref"), seed=SEED)
    for name in gen.TABLES:
        assert pq.read_table(os.path.join(path, f"{name}.parquet")).equals(
            pq.read_table(os.path.join(ref, f"{name}.parquet"))), name

    def no_write(*a, **k):
        raise AssertionError("a kept dataset was written again")

    monkeypatch.setattr(gen, "write_parquet", no_write)
    monkeypatch.setattr(gen, "write_parquet_streamed", no_write)
    assert gen.ensure_dataset(SF, base=str(tmp_path), seed=SEED) == path


def test_ensure_dataset_regenerates_without_marker(tmp_path):
    path = gen.ensure_dataset(SF, base=str(tmp_path), seed=SEED,
                              streamed=True, orders_per_slice=SLICE)
    os.remove(os.path.join(path, "_DONE"))
    stale = os.path.join(path, "stale.parquet")
    open(stale, "w").close()
    assert gen.ensure_dataset(SF, base=str(tmp_path), seed=SEED,
                              streamed=True, orders_per_slice=SLICE) == path
    assert not os.path.exists(stale)
    assert os.path.exists(os.path.join(path, "_DONE"))
    # another recipe (here the in-memory writer) is another dataset
    gen.ensure_dataset(SF, base=str(tmp_path), seed=SEED)
    assert gen.dataset_report(path)["recipe"]["writer"] == "memory"
    assert os.path.isfile(os.path.join(path, "lineitem.parquet"))


def test_ensure_dataset_streams_past_sf10(tmp_path, monkeypatch):
    calls = []

    def streamed(sf, path, seed, orders_per_slice, workers):
        calls.append((sf, seed, orders_per_slice, workers))
        os.makedirs(path)
        return {}

    def memory(*a, **k):
        raise AssertionError("sf > 10 took the in-memory writer")

    monkeypatch.setattr(gen, "write_parquet_streamed", streamed)
    monkeypatch.setattr(gen, "write_parquet", memory)
    path = gen.ensure_dataset(100, base=str(tmp_path), seed=7)
    assert path == str(tmp_path / "tpch_sf100")
    assert calls == [(100, 7, 4_000_000, 1)]
    assert gen.dataset_report(path)["recipe"]["writer"] == "streamed"


def test_register_views_takes_tables_or_path(dirs):
    spark = SparkSession(device="cpu")
    with pytest.raises(ValueError):
        gen.register_views(spark)
    with pytest.raises(ValueError):
        gen.register_views(spark, {}, path=dirs["port"])


def test_q1_from_parts_matches_reference(spark, dirs, sessions):
    ref_gen.register_views(spark, path=dirs["port"])
    want = spark.sql(QUERIES[1]).collect()
    got = sessions[0].sql(QUERIES[1]).collect()
    assert_rows_match([tuple(r) for r in got], [tuple(r) for r in want],
                      label="q1 parts vs reference")


@pytest.mark.parametrize("q", [1, 3, 5])
def test_parts_match_memory_and_oracle(sessions, oracle, q):
    files, memory = sessions
    got = [tuple(r) for r in files.sql(QUERIES[q]).collect()]
    assert got == [tuple(r) for r in memory.sql(QUERIES[q]).collect()]
    assert got
    assert_rows_match(got, run_oracle(oracle, QUERIES[q]), label=f"q{q}")


def test_part_dictionaries_filter_group_join_sort(sessions):
    files, memory = sessions
    got = [tuple(r) for r in files.sql(STRING_QUERY).collect()]
    assert len(got) > 50
    assert got == [tuple(r) for r in memory.sql(STRING_QUERY).collect()]
    assert [r[0] for r in got] == sorted(r[0] for r in got)


@pytest.mark.parametrize("q", [3, 18])
def test_joins_past_the_dense_table_limit(dirs, sessions, monkeypatch, q):
    """Past ``JOIN_TABLE_MAX`` (orders x lineitem at SF10: 15M keys over
    2^23) a join finds its ranges by binary search of the sorted build
    keys instead of dense tables: the same rows, first run and replay."""
    from spark_tpu_torch.physical import kernels

    want = [tuple(r) for r in sessions[1].sql(QUERIES[q]).collect()]
    monkeypatch.setattr(kernels, "JOIN_TABLE_MAX", 1000)
    spark = SparkSession(device="cpu")
    gen.register_views(spark, path=dirs["port"])
    for _ in range(2):
        assert [tuple(r) for r in spark.sql(QUERIES[q]).collect()] == want


@pytest.mark.parametrize("query", [QUERIES[1], STRING_QUERY],
                         ids=["q1", "strings"])
def test_chunked_tier_over_parts_equals_resident(dirs, query):
    spark = SparkSession(device="cpu")
    gen.register_views(spark, path=dirs["port"])
    want = spark.sql(query).collect()
    spark.conf.set("spark.tpu.maxDeviceBatchBytes", 1024)
    spark.conf.set("spark.tpu.chunkRows", 8192)
    got = spark.sql(query).collect()
    assert chunked.last_run is not None and chunked.last_run["chunks"] >= 5
    assert got == want


@pytest.mark.parametrize("q", sorted(arrow_queries.QUERIES))
def test_pyarrow_yardstick_matches_oracle(host_tables, oracle, q):
    got = arrow_queries.QUERIES[q](host_tables)
    assert got
    assert_rows_match(got, run_oracle(oracle, QUERIES[q]), label=f"q{q}")


def test_session_entry_points_match_reference():
    import spark_tpu
    from spark_tpu.api.session import SparkSession as RefSession

    port_before, ref_before = SparkSession._active, RefSession._active
    try:
        SparkSession._active = RefSession._active = None
        ref = RefSession.builder.appName("scale").getOrCreate()
        port = SparkSession.builder.device("cpu").appName("scale") \
            .getOrCreate()
        assert port.app_name == ref.app_name == "scale"
        # an active session keeps its name, in both
        assert SparkSession.builder.device("cpu").appName("other") \
            .getOrCreate().app_name == "scale"
        assert RefSession.builder.appName("other").getOrCreate() \
            .app_name == "scale"
        assert port.version == ref.version == spark_tpu.__version__
        assert port.ui_web_url is None and ref.ui_web_url is None
        other = SparkSession(device="cpu")
        SparkSession.setActiveSession(other)
        assert SparkSession.getActiveSession() is other
        RefSession.setActiveSession(None)
        assert RefSession.getActiveSession() is None
    finally:
        SparkSession._active, RefSession._active = port_before, ref_before


def test_native_hash_table64_matches_reference():
    rng = np.random.default_rng(5)
    words = ["", "a", "special", "Customer#000000001", "ünïcode ß",
             "x" * 40]
    words += ["".join(rng.choice(list("abcdefgh "), int(n)))
              for n in rng.integers(0, 30, 500)]
    assert native.available() and ref_native.available()
    for seed in (42, 1, 2 ** 63 + 5):
        got = native.hash_table64(words, seed=seed)
        assert got.dtype == np.uint64
        np.testing.assert_array_equal(got,
                                      ref_native.hash_table64(words, seed))
    h = native.hash_table64(words)
    assert len(np.unique(h)) >= len(set(words)) - 2
