"""The port's multi-process scaffolding (``spark_tpu_torch/parallel/
multihost.py``) on the CPU: the single-process cases of
tests/test_multihost.py (process facts, a no-op initialize, a mesh over
the listed devices, the per-process fragment scan feeding a
MeshExecutor) and one job of 2 gloo processes that run a hash exchange
and a grouped aggregate through ``DistComm``, each process one rank,
with each rank's rows equal bit for bit (floats by their bits) to the
same stages run in this process by ``ThreadComm`` threads, and a
rendezvous through the process group's store."""

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_tpu_torch.columnar.arrow import from_arrow
from spark_tpu_torch.expr import expressions as E
from spark_tpu_torch.parallel import multihost
from spark_tpu_torch.parallel import operators as D
from spark_tpu_torch.parallel.executor import MeshExecutor
from spark_tpu_torch.parallel.mesh import make_mesh
from spark_tpu_torch.parallel.sharded import ShardedBatch
from spark_tpu_torch.plan import logical as L

from test_torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_process_info_single_host():
    info = multihost.process_info()
    assert info["process_index"] == 0 and info["process_count"] == 1
    assert info["global_devices"] >= 1
    assert multihost.is_coordinator()


def test_initialize_single_process_noop():
    multihost.initialize(num_processes=1, process_id=0)  # must not raise
    multihost.initialize()


def test_global_mesh_spans_devices():
    mesh = multihost.global_mesh(["cpu"] * 4)
    assert len(mesh.devices) == 4 and mesh.shape == {"data": 4}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            multihost.global_mesh()


def test_sharded_batch_from_local_data_plane(tmp_path):
    """This process's fragments as a ShardedBatch the MeshExecutor reads
    directly: counts and sums per key over three files."""
    d = tmp_path / "frags"
    d.mkdir()
    for i in range(3):
        pq.write_table(pa.table({
            "k": pa.array(np.arange(50) % 4, pa.int64()),
            "v": pa.array(np.full(50, 10 * (i + 1)), pa.int64()),
        }), str(d / f"part-{i}.parquet"))
    mesh = multihost.global_mesh(["cpu"] * 8)
    assert len(multihost.local_fragments(str(d))) == 3
    sb = multihost.read_parquet_sharded(str(d), mesh=mesh)
    assert sb.num_valid_rows() == 150
    agg = L.Aggregate((E.Col("k"),), (
        E.Col("k"), E.Alias(E.Count(None), "n"),
        E.Alias(E.Sum(E.Col("v")), "s")), L.Relation(sb))
    rows = {r["k"]: (r["n"], r["s"])
            for r in MeshExecutor(mesh).execute_logical(agg).to_pylist()}
    want: dict = {}
    for i in range(3):
        for j in range(50):
            n0, s0 = want.get(j % 4, (0, 0))
            want[j % 4] = (n0 + 1, s0 + 10 * (i + 1))
    assert rows == want


_WORKER = textwrap.dedent('''
    import json, sys
    import numpy as np, pyarrow as pa, torch
    sys.path.insert(0, sys.argv[4])
    from spark_tpu_torch.parallel import exchange as X, multihost
    from spark_tpu_torch.parallel.executor import run_rank
    sys.path.insert(0, sys.argv[5])
    from test_torch_multihost import _stages, _encode

    port, rank, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    multihost.initialize(f"localhost:{port}", 2, rank, backend="gloo")
    comm = X.DistComm()
    res = {name: _encode(run_rank(p, rank, comm, "cpu"))
           for name, p in _stages().items()}
    res["peer"] = multihost.barrier_kv_exchange(
        f"rank{rank}", f"hello from {rank}", f"rank{1 - rank}")
    res["info"] = multihost.process_info()
    json.dump(res, open(out, "w"))
''')


def _stages():
    """A hash exchange and a grouped aggregate (partial, exchange,
    final) over a seeded table, planned for a 2-rank CPU mesh."""
    rng = np.random.default_rng(3)
    n = 3000
    t = pa.table({"k": pa.array(rng.integers(0, 40, n), pa.int64()),
                  "v": pa.array(rng.normal(size=n)),
                  "s": pa.array(list(np.array(["a", "b", "c"])[
                      rng.integers(0, 3, n)]))})
    ex = MeshExecutor(make_mesh(2, devices=["cpu", "cpu"]))
    batch = from_arrow(t, device="cpu")
    rel = D.ShardScanExec(ShardedBatch.from_batch(batch, ex.mesh))
    return {
        "hash": D.HashPartitionExchangeExec((E.Col("k"), E.Col("s")), rel),
        "agg": ex.plan(L.Aggregate((E.Col("k"),), (
            E.Col("k"), E.Alias(E.Sum(E.Col("v")), "s"),
            E.Alias(E.Count(None), "n"), E.Alias(E.Max(E.Col("s")), "m")),
            L.Relation(batch))),
    }


def _encode(batch):
    """A rank's output batch as JSON: mask, data (floats as their int64
    bits) and validity of every column, in slot order."""
    cols = []
    for cd in batch.data.columns:
        data = cd.data.view(torch.int64) if cd.data.is_floating_point() \
            else cd.data.to(torch.int64)
        cols.append([data.tolist(), None if cd.validity is None
                     else cd.validity.tolist()])
    return {"mask": batch.data.row_mask.tolist(), "cols": cols}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_distcomm_two_gloo_processes_equal_threadcomm(tmp_path):
    """Two processes, one rank each, over gloo: each rank's output of
    both stages equals, slot for slot and bit for bit, the rank's output
    when the same stages run on ThreadComm threads in this process."""
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    tests_dir = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(port), str(r),
         str(tmp_path / f"out{r}.json"), REPO, tests_dir],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)]
    try:
        logs = [p.communicate(timeout=120)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), logs
    got = [json.load(open(tmp_path / f"out{r}.json")) for r in range(2)]

    ex = MeshExecutor(make_mesh(2, devices=["cpu", "cpu"]))
    for name, plan in _stages().items():
        sb = ex._run_stage(plan)
        for r in range(2):
            want = _encode(sb.shard_batch(r))
            mine = got[r][name]
            # the stage runner may compact a sparse output; live rows and
            # their order are what the two communicators must agree on
            live = [i for i, m in enumerate(mine["mask"]) if m]
            live_want = [i for i, m in enumerate(want["mask"]) if m]
            assert len(live) == len(live_want), (name, r)
            for (gd, gv), (wd, wv) in zip(mine["cols"], want["cols"]):
                assert [gd[i] for i in live] == [wd[i] for i in live_want]
                if gv is not None or wv is not None:
                    assert [gv[i] if gv else True for i in live] == \
                        [wv[i] if wv else True for i in live_want]
    assert got[0]["peer"] == "hello from 1"
    assert got[1]["peer"] == "hello from 0"
    assert [g["info"]["process_index"] for g in got] == [0, 1]
    assert all(g["info"]["process_count"] == 2 for g in got)
