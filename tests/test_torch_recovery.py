"""The port's recovery (``spark_tpu_torch/recovery.py``) on the inputs of
tests/test_recovery.py and tests/test_out_of_core.py's ladder: error
classification against the reference's, stage retry, durable and local
checkpoints, and the OOM degradation ladder on the CPU.

The ladder is driven by an engine that raises
``torch.cuda.OutOfMemoryError`` (constructible without a card) when a
plan would hold more than a byte threshold on the device, and by one
that raises ``MemoryError`` once: the halvings, the replans, the chained
causes and the rows (equal to the resident run's) are checked, and an
error that is not an OOM is re-raised without a replan. The XLA status
prefixes, injected faults, the retry budget and the heartbeat monitor of
tests/test_recovery.py wait for ROADMAP A10/A12.
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_tpu import recovery as R
from spark_tpu_torch import recovery
from spark_tpu_torch.api import functions as F
from spark_tpu_torch.api.session import SparkSession as PortSession
from spark_tpu_torch.physical import chunked
from spark_tpu_torch.plan import logical as L
from spark_tpu_torch.plan.optimizer import optimize

from test_torch_threads import one_torch_thread  # noqa: F401


def _wrapped(inner, outer):
    try:
        try:
            raise inner
        except BaseException as e:
            raise outer from e
    except BaseException as w:
        return w


_ERRORS = [
    RuntimeError("DEADLINE_EXCEEDED: x"),
    OSError("Connection reset by peer"),
    ValueError("column not found: x"),
    ConnectionResetError(""),
    BrokenPipeError("x"),
    TimeoutError(""),
    MemoryError(),
    _wrapped(TimeoutError(""), RuntimeError("stage 3 failed")),
    _wrapped(MemoryError(), TimeoutError("gave up waiting")),
    RuntimeError("UNAVAILABLE: host dropped from collective"),
]


@pytest.mark.parametrize("i", range(len(_ERRORS)))
def test_classification_matches_reference(i):
    e = _ERRORS[i]
    assert recovery.is_transient(e) == R.is_transient(e)
    assert recovery.is_oom(e) == R.is_oom(e)


def test_cuda_oom_is_oom_and_never_transient():
    """``torch.cuda.OutOfMemoryError``, the allocator's text anywhere in
    the cause chain, and nothing else (the reference's XLA status is
    not an OOM here)."""
    oom = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                      "allocate 2.00 GiB")
    assert recovery.is_oom(oom) and not recovery.is_transient(oom)
    assert recovery.is_oom(_wrapped(oom, RuntimeError("stage failed")))
    assert recovery.is_oom(RuntimeError("CUDA out of memory. Tried ..."))
    assert not recovery.is_oom(RuntimeError("RESOURCE_EXHAUSTED"))
    assert not recovery.is_oom(RuntimeError("CUDA error: an illegal "
                                            "memory access"))
    assert not recovery.is_transient(_wrapped(
        oom, TimeoutError("gave up waiting")))


def test_stage_retry_recovers_from_transient():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] <= 2:
            raise RuntimeError("UNAVAILABLE: host dropped from collective")
        return 42

    assert recovery.run_stage_with_recovery(flaky) == 42
    assert calls["n"] == 3


def test_stage_retry_does_not_mask_bugs():
    calls = {"n": 0}

    def buggy():
        calls["n"] += 1
        raise ValueError("analysis error")

    with pytest.raises(ValueError):
        recovery.run_stage_with_recovery(buggy)
    assert calls["n"] == 1  # no retry of an error that is not transient


def test_stage_retry_attempts_exhausted(monkeypatch):
    monkeypatch.setattr(recovery.time, "sleep", lambda s: None)

    def always():
        raise RuntimeError("ABORTED: collective")

    with pytest.raises(RuntimeError, match="consecutive attempts"):
        recovery.run_stage_with_recovery(always)


@pytest.fixture()
def port():
    return PortSession(device="cpu")


def test_query_survives_transient_executor_failure(port, monkeypatch):
    """A query whose first run dies of a transient error completes on
    the retry, recomputed from the logical plan."""
    from spark_tpu_torch.physical import planner

    real = planner.execute_logical
    state = {"fails": 1}

    def flaky(plan, *a, **k):
        if state["fails"] > 0:
            state["fails"] -= 1
            raise RuntimeError("UNAVAILABLE: the device is gone")
        return real(plan, *a, **k)

    monkeypatch.setattr(planner, "execute_logical", flaky)
    assert port.range(100).filter("id % 2 = 0").count() == 50
    assert state["fails"] == 0


def test_dataframe_checkpoint_durable(spark, port, tmp_path):
    port.conf.set("spark.checkpoint.dir", str(tmp_path / "p"))
    ck = port.range(50).filter("id >= 10").checkpoint()
    # lineage truncated: a scan over files, not the range
    assert not L.collect_nodes(ck._plan, L.Range)
    assert ck.count() == 40
    assert sorted(r["id"] for r in ck.collect())[:3] == [10, 11, 12]
    spark.conf.set("spark.checkpoint.dir", str(tmp_path / "r"))
    try:
        ref = spark.range(50).filter("id >= 10").checkpoint()
        assert sorted(r["id"] for r in ck.collect()) \
            == sorted(r["id"] for r in ref.collect())
    finally:
        spark.conf.unset("spark.checkpoint.dir")


def test_dataframe_checkpoint_requires_dir(port):
    port.conf.set("spark.checkpoint.dir", "")
    with pytest.raises(RuntimeError, match="spark.checkpoint.dir"):
        port.range(5).checkpoint()
    # localCheckpoint works without a directory
    assert port.range(5).localCheckpoint().count() == 5
    assert port.cache_manager.materializations == 1


def test_checkpoint_paths_unique(port, tmp_path):
    port.conf.set("spark.checkpoint.dir", str(tmp_path))
    for _ in range(3):
        port.range(10).checkpoint()
    dirs = [d for d in os.listdir(tmp_path) if d.startswith("ckpt-")]
    assert len(dirs) == 3 and len(set(dirs)) == 3
    assert all(str(os.getpid()) in d for d in dirs)


# ---- the OOM degradation ladder ---------------------------------------------


@pytest.fixture(scope="module")
def big_file(tmp_path_factory):
    """tests/test_out_of_core.py's big table, cut to 60k rows."""
    rng = np.random.default_rng(11)
    n = 60_000
    tbl = pa.table({
        "k": pa.array(rng.integers(0, 1000, n), pa.int64()),
        "v": pa.array(rng.random(n)),
        "w": pa.array(rng.integers(0, 100, n), pa.int64()),
    })
    path = str(tmp_path_factory.mktemp("ladder") / "big.parquet")
    pq.write_table(tbl, path)
    return path


def _plan_bytes(plan) -> int:
    """The device bytes a plan's leaves hold: its relations' batches and
    its scans' estimates."""
    total = 0
    for r in L.collect_nodes(plan, L.Relation):
        total += r.batch.device_nbytes()
    for s in L.collect_nodes(plan, L.UnresolvedScan):
        total += chunked._est_scan(s)
    return total


def _engine(port, limit=None, memory_error_once=False, other=None):
    """An engine that runs plans on the port, raising a CUDA OOM above
    ``limit`` bytes, a MemoryError on its first call, or ``other``."""
    from spark_tpu_torch.physical.planner import execute_logical

    state = {"calls": 0, "ooms": 0}

    def run(lp):
        state["calls"] += 1
        if other is not None:
            raise other
        if memory_error_once and state["calls"] == 1:
            state["ooms"] += 1
            raise MemoryError("host staging buffer")
        if limit is not None and _plan_bytes(lp) > limit:
            state["ooms"] += 1
            raise torch.cuda.OutOfMemoryError(
                "CUDA out of memory. Tried to allocate "
                f"{_plan_bytes(lp)} bytes")
        return execute_logical(lp, optimize=False, device="cpu",
                               conf=port.conf)

    return run, state


def _agg(port, path):
    return port.read.parquet(path).groupBy("k").agg(
        F.count("v").alias("n"), F.sum("w").alias("s"),
        F.max("w").alias("hi"), F.sum("v").alias("f"))


def _rows(batch):
    return sorted(tuple(r.values()) for r in batch.to_pylist())


def test_ladder_halves_until_the_plan_fits(port, big_file):
    """A resident run over the threshold OOMs; the ladder halves the
    budget, replans through the chunked tier, and halves again while a
    chunk plan still OOMs; rows equal the resident run's."""
    df = _agg(port, big_file)
    lp = optimize(df._plan, port.conf)
    want = _rows(df._execute())
    est = _plan_bytes(lp)
    port.conf.set("spark.tpu.chunkRows", 4096)
    run, state = _engine(port, limit=est // 6)
    out = recovery.run_plan_with_oom_degradation(lp, port.conf, run, "cpu")
    rec = recovery.last_ladder
    assert rec["replans"] >= 1 and state["ooms"] >= 1
    budgets = rec["budgets"]
    assert budgets == sorted(budgets, reverse=True)
    assert all(b < est for b in budgets)
    assert rec["stages_dropped"] >= 0 and not rec["exhausted"]
    assert not rec["cache_emptied"]  # nothing to empty on the CPU
    assert "OutOfMemoryError" in rec["error"]
    # the session's budget is untouched: the ladder's is a shadow
    assert port.conf.get("spark.tpu.maxDeviceBatchBytes") == 5 << 30
    got = _rows(out)
    assert [r[:3] for r in got] == [r[:3] for r in want]
    for g, w in zip(got, want):
        assert g[3] == pytest.approx(w[3], rel=1e-9)


def test_ladder_replans_on_memory_error_once(port, big_file):
    df = _agg(port, big_file)
    lp = optimize(df._plan, port.conf)
    want = _rows(df._execute())
    run, state = _engine(port, memory_error_once=True)
    out = recovery.run_plan_with_oom_degradation(lp, port.conf, run, "cpu")
    assert recovery.last_ladder["replans"] == 1
    assert chunked.last_run["tier"] == "_ChunkedAgg"
    got = _rows(out)
    assert [r[:3] for r in got] == [r[:3] for r in want]


def test_ladder_chains_causes_when_it_runs_out(port, big_file):
    """Every chunk plan OOMs down to the floor: the final error chains
    the replan history and the ladder records that it ran out."""
    lp = optimize(_agg(port, big_file)._plan, port.conf)
    port.conf.set("spark.tpu.oomDegrade.floorBytes", 1 << 18)
    run, state = _engine(port, limit=0)
    with pytest.raises(RuntimeError, match="floor") as info:
        recovery.run_plan_with_oom_degradation(lp, port.conf, run, "cpu")
    chain = list(recovery._chain(info.value))
    ooms = [e for e in chain if isinstance(e, torch.cuda.OutOfMemoryError)]
    assert len(ooms) >= 2 and recovery.is_oom(info.value)
    assert recovery.last_ladder["exhausted"]
    assert recovery.last_ladder["replans"] == len(
        recovery.last_ladder["budgets"]) >= 2


def test_ladder_reraises_what_is_not_an_oom(port, big_file):
    lp = optimize(_agg(port, big_file)._plan, port.conf)
    run, state = _engine(port, other=ValueError("a bug"))
    with pytest.raises(ValueError, match="a bug"):
        recovery.run_plan_with_oom_degradation(lp, port.conf, run, "cpu")
    assert recovery.last_ladder["replans"] == 0 and state["calls"] == 1


def test_ladder_off_or_nothing_to_chunk_surfaces_the_oom(port, big_file):
    lp = optimize(_agg(port, big_file)._plan, port.conf)
    port.conf.set("spark.tpu.oomDegrade.enabled", False)
    run, _ = _engine(port, limit=0)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        recovery.run_plan_with_oom_degradation(lp, port.conf, run, "cpu")
    port.conf.unset("spark.tpu.oomDegrade.enabled")
    # a plan with no file scan has no chunkable shape
    rng = optimize(port.range(10)._plan, port.conf)
    run, _ = _engine(port, limit=-1)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        recovery.run_plan_with_oom_degradation(rng, port.conf, run, "cpu")
    assert recovery.last_ladder["replans"] == 0


def test_plan_chunk_first(port, big_file):
    lp = optimize(_agg(port, big_file)._plan, port.conf)
    found, shadow = recovery.plan_chunk_first(lp, port.conf, 1024)
    assert type(found).__name__ == "_ChunkedAgg"
    assert shadow.get("spark.tpu.maxDeviceBatchBytes") == 1024
    assert port.conf.get("spark.tpu.maxDeviceBatchBytes") == 5 << 30
    assert recovery.plan_chunk_first(
        optimize(port.range(5)._plan, port.conf), port.conf, 1) \
        == (None, None)
