"""The port's applyInPandasWithState (``spark_tpu_torch/streaming/
groups.py``) on the cases of tests/test_group_state.py: a running count
across batches, state removal, a checkpoint restart, a tuple-valued
state across a restart, the older checkpoint layouts, the plan below the
operator running on the engine, and the DDL schema parser.

Held against the reference: each scenario runs, as written, through both
packages (the same MemoryStream batches and user function); the sink
rows are equal exactly (strings and integers). The state is pickled
whole in the reference's tagged layout, so a checkpoint the reference
wrote is resumed by the port, and the rows after the resume equal the
reference's.
"""

import pickle

import pandas as pd
import pyarrow as pa
import pytest

from spark_tpu import types as RT
from spark_tpu.streaming import MemoryStream as RefStream
from spark_tpu_torch import types as T
from spark_tpu_torch.api.session import SparkSession
from spark_tpu_torch.streaming import MemoryStream
from spark_tpu_torch.types import parse_ddl_schema

from test_torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.timeout(300)


@pytest.fixture(scope="module")
def port():
    return SparkSession(device="cpu")


@pytest.fixture(scope="module")
def ref(spark):
    out = {}

    def get(scenario):
        if scenario.__name__ not in out:
            out[scenario.__name__] = scenario(spark, RefStream, "ref")
        return out[scenario.__name__]

    return get


def _both(port, ref, scenario):
    got = scenario(port, MemoryStream, "port")
    assert got == ref(scenario)
    return got


def _table(spark, name):
    return sorted(tuple(r.asDict().values())
                  for r in spark.table(name).collect())


def _counter(key, pdf, state):
    total = (state.get() if state.exists else 0) + len(pdf)
    state.update(total)
    return pd.DataFrame({"k": [key[0]], "cnt": [total]})


def _kv(MS):
    return MS(pa.schema([("k", pa.string()), ("v", pa.int64())]))


def _start(spark, MS, name, ckpt=None):
    src = _kv(MS)
    out = spark.readStream.load(src).groupBy("k").applyInPandasWithState(
        _counter, "k string, cnt long", "cnt long", "update")
    w = out.writeStream.outputMode("update").queryName(name)
    if ckpt:
        w = w.option("checkpointLocation", ckpt)
    return src, w.start()


# ---- scenarios ----------------------------------------------------------------


def s_running_count(spark, MS, tag):
    name = f"gs1_{tag}"
    src, q = _start(spark, MS, name)
    out = []
    src.add_data([{"k": "a", "v": 1}, {"k": "b", "v": 2},
                  {"k": "a", "v": 3}])
    q.processAllAvailable()
    out.append(_table(spark, name))
    src.add_data([{"k": "a", "v": 9}])
    q.processAllAvailable()
    out.append(_table(spark, name))
    return out


def _evictor(key, pdf, state):
    if state.exists:
        state.remove()
        return pd.DataFrame({"k": [key[0]], "cnt": [-1]})
    state.update(len(pdf))
    return None


def s_state_remove(spark, MS, tag):
    src = _kv(MS)
    name = f"gs2_{tag}"
    out_df = spark.readStream.load(src).groupBy("k").applyInPandasWithState(
        _evictor, "k string, cnt long")
    q = out_df.writeStream.outputMode("append").queryName(name).start()
    out = []
    for _ in range(3):
        src.add_data([{"k": "x", "v": 1}])
        q.processAllAvailable()
        out.append(_table(spark, name))
    return out


def s_plan_below(spark, MS, tag):
    src = _kv(MS)
    df = spark.readStream.load(src).filter("v > 0") \
        .withColumnRenamed("v", "val")
    name = f"gs4_{tag}"
    out = df.groupBy("k").applyInPandasWithState(
        lambda key, pdf, st: pd.DataFrame(
            {"k": [key[0]], "s": [int(pdf["val"].sum())]}),
        "k string, s long")
    q = out.writeStream.outputMode("append").queryName(name).start()
    src.add_data([{"k": "a", "v": -5}, {"k": "a", "v": 3},
                  {"k": "a", "v": 4}, {"k": "b", "v": 2}])
    q.processAllAvailable()
    return _table(spark, name)


def _pair_counter(key, pdf, state):
    cnt, tot = state.get() if state.exists else (0, 0)
    cnt, tot = cnt + len(pdf), tot + int(pdf["v"].sum())
    state.update((cnt, tot))
    return pd.DataFrame({"k": [key[0]], "cnt": [cnt], "tot": [tot]})


# ---- tests ----------------------------------------------------------------------


def test_running_count_across_batches(port, ref):
    first, second = _both(port, ref, s_running_count)
    assert first == [("a", 2), ("b", 1)]
    assert ("a", 3) in second  # update mode appends each batch's rows


def test_state_remove(port, ref):
    got = _both(port, ref, s_state_remove)
    assert got == [[], [("x", -1)], [("x", -1)]]


def test_checkpoint_restart_restores_state(port, spark, tmp_path):
    """The reference writes the checkpoint; the port resumes it: the
    restored count plus the new row."""
    ckpt = str(tmp_path / "gs")
    rsrc, rq = _start(spark, RefStream, "gs3_ref", ckpt)
    rsrc.add_data([{"k": "a", "v": 1}, {"k": "a", "v": 2}])
    rq.processAllAvailable()
    rq.stop()

    src = _kv(MemoryStream)
    src.add_data([{"k": "a", "v": 1}, {"k": "a", "v": 2}])
    df = port.readStream.load(src).groupBy("k").applyInPandasWithState(
        _counter, "k string, cnt long")
    q2 = df.writeStream.outputMode("update").queryName("gs3b") \
        .option("checkpointLocation", ckpt).start()
    src.add_data([{"k": "a", "v": 5}])
    q2.processAllAvailable()
    assert _table(port, "gs3b") == [("a", 3)]  # 2 restored + 1 new


def test_tuple_valued_state_roundtrips(port, tmp_path):
    """A user state that is itself a 2-tuple survives the port's own
    restart intact."""
    ckpt = str(tmp_path / "gs_pair")
    src = _kv(MemoryStream)
    df = port.readStream.load(src).groupBy("k").applyInPandasWithState(
        _pair_counter, "k string, cnt long, tot long")
    q = df.writeStream.outputMode("update").queryName("gsp") \
        .option("checkpointLocation", ckpt).start()
    src.add_data([{"k": "a", "v": 10}, {"k": "a", "v": 20}])
    q.processAllAvailable()
    q.stop()
    df2 = port.readStream.load(src).groupBy("k").applyInPandasWithState(
        _pair_counter, "k string, cnt long, tot long")
    q2 = df2.writeStream.outputMode("update").queryName("gspb") \
        .option("checkpointLocation", ckpt).start()
    src.add_data([{"k": "a", "v": 5}])
    q2.processAllAvailable()
    assert ("a", 3, 35) in _table(port, "gspb")


def test_legacy_checkpoint_layouts_load():
    """The tagged payload and both older layouts load; a newer format
    version raises instead of misreading. The same tables through the
    reference's loader give the same states."""
    from spark_tpu.streaming.groups import GroupStateQuery as RefQuery
    from spark_tpu_torch.streaming.groups import GroupStateQuery

    def loader(cls, tbl):
        class _Store:
            def get(self, version):
                return tbl

        class _Q:
            _load_states = cls._load_states
            _STATE_TAG = cls._STATE_TAG
            _STATE_VERSION = cls._STATE_VERSION
            _store = _Store()

        return _Q()._load_states(0)

    tbl = pa.table({
        "__key": pa.array([pickle.dumps(("a",)), pickle.dumps(("b",)),
                           pickle.dumps(("c",))], pa.binary()),
        "__state": pa.array([
            pickle.dumps({"__group_state__": 1, "value": 7,
                          "deadline_ms": 123}),
            pickle.dumps((5, None)),
            pickle.dumps(42),
        ], pa.binary())})
    states = loader(GroupStateQuery, tbl)
    ref_states = loader(RefQuery, tbl)
    assert states[("a",)].get() == 7
    assert states[("a",)]._deadline_ms == 123
    assert states[("b",)].get() == 5
    assert states[("c",)].get() == 42
    assert {k: (s.get(), s._deadline_ms) for k, s in states.items()} == \
        {k: (s.get(), s._deadline_ms) for k, s in ref_states.items()}

    newer = pa.table({
        "__key": pa.array([pickle.dumps(("z",))], pa.binary()),
        "__state": pa.array([pickle.dumps(
            {"__group_state__": 99, "value": 1})], pa.binary())})
    with pytest.raises(ValueError, match="newer"):
        loader(GroupStateQuery, newer)


def test_plan_below_group_runs_on_engine(port, ref):
    assert _both(port, ref, s_plan_below) == [("a", 7), ("b", 2)]


def test_ddl_schema_parsing():
    s = parse_ddl_schema("a bigint, b string, c double, d date")
    r = RT.parse_ddl_schema("a bigint, b string, c double, d date")
    assert s.names == r.names == ("a", "b", "c", "d")
    assert isinstance(s.field("a").dtype, T.Int64Type)
    assert isinstance(s.field("c").dtype, T.Float64Type)
    assert [type(f.dtype).__name__ for f in s.fields] == \
        [type(f.dtype).__name__ for f in r.fields]
    with pytest.raises(ValueError):
        parse_ddl_schema("bad")
