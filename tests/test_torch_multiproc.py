"""Query execution across processes (``spark_tpu_torch/parallel/``, one
rank a process) on the CPU: two gloo processes, spawned once for the
module, each one rank of ``master("mesh[*]")``, each reading its own
files with ``multihost.read_parquet_sharded``:

- (a) the data-plane case of tests/test_multihost.py across processes:
  four fragment files with string and int columns, one half a process,
  aggregated by ``MeshExecutor.execute_logical``; the rows equal the
  JAX package's ``read_parquet_sharded`` + ``MeshExecutor`` run over the
  same files in one process (the conftest's CPU mesh);
- (b) TPC-H q1, q1-wide, q3, q5, q9 and q18 at sf 0.01 from a dataset
  the port's ``write_parquet_streamed`` writes in 4 parts (each part
  with its own dictionaries; lineitem and orders read part by part, the
  six small tables whole with ``spark.read.parquet``), adaptive
  execution off, on and fused: both processes' rows equal, every mode
  the off run's bit for bit, and the port's single-device rows by the
  rules of tests/test_torch_mesh_tpch.py (integers, decimals, dates and
  strings exactly; floats within rel 1e-9; rows as multisets) and
  sqlite's (``assert_rows_match``);
- (c) the other 16 TPC-H queries with adaptive execution off, against
  the single-device rows;
- (d) a string column whose values differ between the processes: both
  hold the sorted union as its dictionary, and a group-by, a filter on
  a literal, a join on the string and an ORDER BY equal one process's
  run over the same files;
- (e) a rank that raises inside a stage (``exchange.all_to_all`` armed
  in one process only): both processes exit non-zero, each well within
  the process group's timeout.

Then the same two processes make a 2 x 2 mesh, two ranks a process, each
a thread (``meshDevices(["cpu"] * 4)``, owners (0, 0, 1, 1)): a
process's rows fill its two ranks in row order; (a) again; (b) with
adaptive execution off and q3 also adaptive and fused; (d) again; and
the collectives of ``exchange.ProcessThreadComm`` equal a 4-rank
``ThreadComm``'s in one process bit for bit. The fault children, after
(e), join a second group and raise inside a stage in the second thread
of one process: both exit non-zero, each well within the timeout.

The parent computes the references while the children run."""

import json
import os
import pickle
import socket
import subprocess
import sys
import textwrap
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from test_torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

HEAD = ("q1", "q1_wide", "q3", "q5", "q9", "q18")
REST = tuple(f"q{q}" for q in range(1, 23) if f"q{q}" not in HEAD)
MODES = ("off", "adaptive", "fused")
#: the 2 x 2 mesh's runs: HEAD with adaptive execution off, q3 also
#: adaptive and fused
MESH2 = tuple((n, "off") for n in HEAD) + (("q3", "adaptive"),
                                           ("q3", "fused"))
#: the collectives' seeded inputs, one set a global rank of the 2 x 2 mesh
COMM_RANKS = 4
#: seconds a collective waits for its peers in the fault case
FAULT_TIMEOUT_S = 30
#: floats against the single-device run (tests/test_torch_mesh_tpch.py)
REL = 1e-9

DISJOINT = {
    "group": "select s, count(*) as n, sum(v) as sv from t group by s",
    "filter": "select count(*) as n, sum(v) as sv from t where s = 'kiwi'",
    "join": "select t.s, d.w, sum(t.v) as sv from t join dim d "
            "on t.s = d.s group by t.s, d.w",
    "order": "select s, v from t order by s, v",
}

_WORKER = textwrap.dedent('''
    import json, os, pickle, sys, time
    sys.path.insert(0, sys.argv[1])
    port, rank, role, root, out = (int(sys.argv[2]), int(sys.argv[3]),
                                   sys.argv[4], sys.argv[5], sys.argv[6])
    timeout_s = float(sys.argv[7])
    from spark_tpu_torch.api.dataframe import DataFrame
    from spark_tpu_torch.api.session import SparkSession
    from spark_tpu_torch.expr import expressions as E
    from spark_tpu_torch.parallel import multihost
    from spark_tpu_torch.parallel.executor import MeshExecutor
    from spark_tpu_torch.plan import logical as L
    from spark_tpu_torch.tpch import Q1_WIDE, QUERIES

    multihost.initialize(f"localhost:{port}", 2, rank, backend="gloo",
                         timeout_s=timeout_s)
    spark = SparkSession.builder.device("cpu").master("mesh[*]") \\
        .getOrCreate()
    mesh = spark.mesh_executor.mesh
    res = {"mesh": repr(mesh), "ranks": len(mesh.devices)}

    def two_a_process():
        # the 2 x 2 mesh, the session's own; its views are its own too
        global spark, mesh
        spark = SparkSession.builder.device("cpu").master("mesh[*]") \\
            .meshDevices(["cpu"] * 4).getOrCreate()
        mesh = spark.mesh_executor.mesh

    def rows(q):
        return [tuple(r) for r in spark.sql(q).collect()]

    def sharded_view(name, path):
        sb = multihost.read_parquet_sharded(path, mesh=mesh)
        DataFrame(spark, L.Relation(sb)).createOrReplaceTempView(name)
        return sb

    if role == "fault":
        import pyarrow as pa
        spark.createDataFrame(pa.table({
            "k": pa.array([(i * 7919) % 1000003 for i in range(4000)],
                          pa.int64()),
            "v": pa.array(list(range(4000)), pa.int64())})) \\
            .createOrReplaceTempView("t")
        if rank == 1:
            spark.conf.set("spark.tpu.faultInjection.exchange.all_to_all",
                           "nth:1")
        def attempt():
            t0 = time.monotonic()
            try:
                rows("select k, count(*) from t group by k")
            except Exception as e:
                chain, x = [], e
                while x is not None:
                    chain.append(type(x).__name__)
                    x = x.__cause__ or x.__context__
                return {"elapsed": time.monotonic() - t0, "chain": chain,
                        "message": str(e)[:300]}
            return {"elapsed": time.monotonic() - t0, "chain": []}

        got = attempt()
        # the 2 x 2 mesh over a second group: the second thread of
        # process 1 (rank 3) raises inside the stage
        from spark_tpu_torch.parallel import exchange as X
        multihost.initialize(f"localhost:{sys.argv[10]}", 2, rank,
                             backend="gloo", timeout_s=timeout_s)
        two_a_process()
        spark.createDataFrame(pa.table({
            "k": pa.array([(i * 7919) % 1000003 for i in range(4000)],
                          pa.int64()),
            "v": pa.array(list(range(4000)), pa.int64())})) \\
            .createOrReplaceTempView("t")
        real = X.exchange

        def exchange(*args, **kwargs):
            if X.axis_index() == 3:
                raise RuntimeError("rank 3 fails inside the stage")
            return real(*args, **kwargs)

        X.exchange = exchange
        got["mesh2"] = attempt()
        json.dump(got, open(out, "w"))
        sys.exit(1 if got["chain"] or got["mesh2"]["chain"] else 0)

    def case_a(sb):
        agg = L.Aggregate((E.Col("s"), E.Col("k")), (
            E.Col("s"), E.Col("k"), E.Alias(E.Count(None), "n"),
            E.Alias(E.Sum(E.Col("v")), "sv"),
            E.Alias(E.Max(E.Col("v")), "mx")), L.Relation(sb))
        return MeshExecutor(mesh).execute_logical(agg).to_pylist()

    # (a) the data plane: fragments to an aggregate
    sb = multihost.read_parquet_sharded(os.path.join(root, "frags"),
                                        mesh=mesh)
    res["a_live"] = sb.live_counts()
    res["a"] = case_a(sb)

    # (b), (c): TPC-H from the parts
    tpch = os.path.join(root, "tpch")
    for name in ("lineitem", "orders"):
        sharded_view(name, os.path.join(tpch, f"{name}.parquet"))
    for name in ("customer", "supplier", "nation", "region", "part",
                 "partsupp"):
        spark.read.parquet(os.path.join(tpch, f"{name}.parquet")) \\
            .createOrReplaceTempView(name)
    text = {f"q{q}": t for q, t in QUERIES.items()}
    text["q1_wide"] = Q1_WIDE
    res["tpch"], res["events"] = {}, {}
    for mode in ("off", "adaptive", "fused"):
        spark.conf.set("spark.tpu.adaptive.enabled", mode != "off")
        spark.conf.set("spark.tpu.fusion.enabled", mode == "fused")
        names = list(text) if mode == "off" else sys.argv[8].split(",")
        for name in names:
            res["tpch"][(name, mode)] = rows(text[name])
            res["events"][(name, mode)] = sorted({
                e["kind"] for e in spark.mesh_executor.last_run["events"]})
    spark.conf.set("spark.tpu.adaptive.enabled", False)
    spark.conf.set("spark.tpu.fusion.enabled", False)

    # (d) disjoint dictionaries
    sb = sharded_view("t", os.path.join(root, "disjoint", "t"))
    res["d_dict"] = sb.schema.field("s").dictionary
    spark.read.parquet(os.path.join(root, "disjoint", "dim.parquet")) \\
        .createOrReplaceTempView("dim")
    res["d"] = {k: rows(q) for k, q in json.loads(sys.argv[9]).items()}

    # the 2 x 2 mesh: two ranks a process
    two_a_process()
    res["m_mesh"] = (len(mesh.devices), mesh.owners, mesh.local_ranks)
    sb = multihost.read_parquet_sharded(os.path.join(root, "frags"),
                                        mesh=mesh)
    res["m_live"] = sb.live_counts()
    v = sb.schema.names.index("v")
    res["m_v"] = [sb.shards[r].columns[v].data[sb.shards[r].row_mask]
                  .tolist() for r in mesh.local_ranks]
    res["m_a"] = case_a(sb)
    for name in ("lineitem", "orders"):
        sharded_view(name, os.path.join(tpch, f"{name}.parquet"))
    for name in ("customer", "supplier", "nation", "region", "part",
                 "partsupp"):
        spark.read.parquet(os.path.join(tpch, f"{name}.parquet")) \\
            .createOrReplaceTempView(name)
    res["m_tpch"], res["m_events"] = {}, {}
    for name, mode in json.loads(sys.argv[11]):
        spark.conf.set("spark.tpu.adaptive.enabled", mode != "off")
        spark.conf.set("spark.tpu.fusion.enabled", mode == "fused")
        res["m_tpch"][(name, mode)] = rows(text[name])
        res["m_events"][(name, mode)] = sorted({
            e["kind"] for e in spark.mesh_executor.last_run["events"]})
    spark.conf.set("spark.tpu.adaptive.enabled", False)
    spark.conf.set("spark.tpu.fusion.enabled", False)
    sb = sharded_view("t", os.path.join(root, "disjoint", "t"))
    res["m_d_dict"] = sb.schema.field("s").dictionary
    spark.read.parquet(os.path.join(root, "disjoint", "dim.parquet")) \\
        .createOrReplaceTempView("dim")
    res["m_d"] = {k: rows(q) for k, q in json.loads(sys.argv[9]).items()}

    # the communicator: each local rank a thread, seeded inputs
    import threading
    from spark_tpu_torch.parallel import exchange as X
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from comm_case import collectives
    comm = X.ProcessThreadComm(mesh.local_ranks, len(mesh.devices),
                               X.DistComm())
    res["m_comm"] = {}
    threads = [threading.Thread(target=lambda r=r: res["m_comm"].update(
        {r: collectives(comm, r)})) for r in mesh.local_ranks]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    pickle.dump(res, open(out, "wb"))
''')


_COMM_CASE = textwrap.dedent('''
    import numpy as np
    import torch


    def inputs(rank):
        g = np.random.default_rng(2000 + rank)
        return {"a": torch.as_tensor(g.integers(-10 ** 6, 10 ** 6, (12, 2))),
                "b": torch.as_tensor(g.random(20) < 0.5),
                # magnitudes 1e-8 .. 1e8: a sum's bits depend on its order
                "f": torch.as_tensor(g.standard_normal(9)
                                     * 10.0 ** g.integers(-8, 9, 9)),
                "v": torch.as_tensor(g.integers(0, 99, 1 + 2 * rank))}


    def collectives(comm, rank):
        """Every collective of ``comm`` as rank ``rank``, on seeded
        inputs."""
        t = inputs(rank)
        return {
            "all_to_all": comm.all_to_all(rank, "cpu", [t["a"], t["b"]]),
            "all_gather": comm.all_gather(rank, "cpu", [t["f"], t["b"]]),
            "all_gather_var": comm.all_gather_var(
                rank, "cpu", [t["v"], t["a"][:rank + 1]]),
            "psum": comm.all_reduce(rank, "cpu", t["f"], "sum"),
            "pmin": comm.all_reduce(rank, "cpu", t["f"], "min"),
            "pmax": comm.all_reduce(rank, "cpu", t["a"], "max"),
            "broadcast": comm.broadcast(rank, "cpu", [t["a"]], src=3)}
''')


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _write_data(root: str) -> dict:
    """The fragments of (a), the TPC-H parts of (b)/(c) and the disjoint
    tables of (d); returns each process's strings of (d)."""
    from spark_tpu_torch.tpch.gen import write_parquet_streamed

    frags = os.path.join(root, "frags")
    os.makedirs(frags)
    rng = np.random.default_rng(19)
    for i in range(4):
        n = 60 + 25 * i
        pq.write_table(pa.table({
            "k": pa.array(rng.integers(0, 5, n), pa.int64()),
            "s": pa.array([f"w{i}_{j}" for j in rng.integers(0, 6, n)]),
            "v": pa.array(rng.integers(-1000, 1000, n), pa.int64()),
        }), os.path.join(frags, f"part-{i}.parquet"))
    write_parquet_streamed(0.01, os.path.join(root, "tpch"), seed=99,
                           orders_per_slice=3_751)
    words = (["apple", "fig", "kiwi", "plum"], ["banana", "cherry", "date"])
    tdir = os.path.join(root, "disjoint", "t")
    os.makedirs(tdir)
    for i, ws in enumerate(words):
        n = 50 + 30 * i
        pq.write_table(pa.table({
            "s": pa.array([ws[j] for j in rng.integers(0, len(ws), n)]),
            "v": pa.array(rng.integers(0, 100, n), pa.int64()),
        }), os.path.join(tdir, f"part-{i}.parquet"))
    pq.write_table(pa.table({
        "s": pa.array(["banana", "date", "fig", "kiwi", "zucchini"]),
        "w": pa.array([10, 20, 30, 40, 50], pa.int64())}),
        os.path.join(root, "disjoint", "dim.parquet"))
    return {"words": words}


def _spawn(script: str, root: str, role: str, tmp: str) -> list:
    port, port2 = _free_port(), _free_port()
    while port2 == port:
        port2 = _free_port()
    # one compute thread a child: the suite's workers already fill the
    # cores, and the tables are small
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    timeout = FAULT_TIMEOUT_S if role == "fault" else 120
    return [(subprocess.Popen(
        [sys.executable, script, REPO, str(port), str(r), role, root,
         os.path.join(tmp, f"{role}{r}.out"), str(timeout), ",".join(HEAD),
         json.dumps(DISJOINT), str(port2), json.dumps(MESH2)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
        os.path.join(tmp, f"{role}{r}.out")) for r in range(2)]


def _wait(procs, timeout: float) -> list:
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for p, _ in procs:
            logs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0]
                .decode(errors="replace"))
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return logs


def _single_rows(spark, q: str) -> list:
    return [tuple(r) for r in spark.sql(q).collect()]


def _jax_case_a(frags: str) -> list:
    """Case (a) through the JAX package in this process, on the
    conftest's CPU mesh."""
    from spark_tpu.expr import expressions as JE
    from spark_tpu.parallel import multihost as JM
    from spark_tpu.parallel.executor import MeshExecutor as JMesh
    from spark_tpu.plan import logical as JL

    mesh = JM.global_mesh()
    sb = JM.read_parquet_sharded(frags, mesh=mesh)
    agg = JL.Aggregate((JE.Col("s"), JE.Col("k")), (
        JE.Col("s"), JE.Col("k"), JE.Alias(JE.Count(None), "n"),
        JE.Alias(JE.Sum(JE.Col("v")), "sv"),
        JE.Alias(JE.Max(JE.Col("v")), "mx")), JL.Relation(sb))
    return JMesh(mesh).execute_logical(agg).to_pylist()


def _thread_comm_case(tmp: str) -> dict:
    """The communicator case on a 4-rank ThreadComm in this process."""
    import importlib.util
    import threading

    from spark_tpu_torch.parallel.exchange import ThreadComm

    spec = importlib.util.spec_from_file_location(
        "comm_case", os.path.join(tmp, "comm_case.py"))
    case = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(case)
    comm, out = ThreadComm(COMM_RANKS), {}
    threads = [threading.Thread(target=lambda r=r: out.update(
        {r: case.collectives(comm, r)})) for r in range(COMM_RANKS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from spark_tpu_torch.api.session import SparkSession
    from spark_tpu_torch.tpch import Q1_WIDE, QUERIES, register_views
    from spark_tpu_torch.tpch.oracle import index_keys, load_sqlite

    tmp = str(tmp_path_factory.mktemp("multiproc"))
    root = os.path.join(tmp, "data")
    made = _write_data(root)
    script = os.path.join(tmp, "worker.py")
    with open(script, "w") as f:
        f.write(_WORKER)
    with open(os.path.join(tmp, "comm_case.py"), "w") as f:
        f.write(_COMM_CASE)
    t0 = time.monotonic()
    main = _spawn(script, root, "main", tmp)
    fault = _spawn(script, root, "fault", tmp)
    try:
        # the references, while the children run
        text = {f"q{q}": t for q, t in QUERIES.items()}
        text["q1_wide"] = Q1_WIDE
        single = SparkSession(device="cpu")
        tpch = os.path.join(root, "tpch")
        register_views(single, path=tpch)
        want = {n: _single_rows(single, q) for n, q in text.items()}
        tables = {n: pq.read_table(os.path.join(tpch, f"{n}.parquet"))
                  for n in ("lineitem", "orders", "customer", "supplier",
                            "nation", "region", "part", "partsupp")}
        conn = load_sqlite(tables)
        index_keys(conn)
        conn.execute("pragma case_sensitive_like = on")
        dj = SparkSession(device="cpu")
        dj.read.parquet(os.path.join(root, "disjoint", "t")) \
            .createOrReplaceTempView("t")
        dj.read.parquet(os.path.join(root, "disjoint", "dim.parquet")) \
            .createOrReplaceTempView("dim")
        d_want = {k: _single_rows(dj, q) for k, q in DISJOINT.items()}
        a_want = _jax_case_a(os.path.join(root, "frags"))
        comm_want = _thread_comm_case(tmp)
        fault_logs = _wait(fault, 3 * FAULT_TIMEOUT_S)
        main_logs = _wait(main, 240)
    finally:
        for p, _ in main + fault:
            if p.poll() is None:
                p.kill()
                p.wait()
    got = []
    for (p, out), log in zip(main, main_logs):
        assert p.returncode == 0, log[-4000:]
        with open(out, "rb") as f:
            got.append(pickle.load(f))
    faulted = []
    for (p, out), log in zip(fault, fault_logs):
        with open(out) as f:
            faulted.append((p.returncode, json.load(f), log[-2000:]))
    yield {"got": got, "want": want, "text": text, "conn": conn,
           "d_want": d_want, "a_want": a_want, "fault": faulted,
           "comm_want": comm_want, "root": root,
           "words": made["words"], "seconds": time.monotonic() - t0}
    conn.close()


def _key(r):
    return tuple((v is None, str(type(v)), v) for v in r)


def _match_single(got: list, want: list, label: str) -> None:
    """tests/test_torch_mesh_tpch.py's rules: multisets, floats within
    rel 1e-9, everything else equal and of one type."""
    got, want = sorted(got, key=_key), sorted(want, key=_key)
    assert len(got) == len(want), label
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(a, float) and isinstance(b, float):
                assert a == pytest.approx(b, rel=REL, abs=1e-12), (label, g,
                                                                    w)
            else:
                assert a == b and type(a) is type(b), (label, g, w)


def test_processes_form_one_mesh(world):
    for r, g in enumerate(world["got"]):
        assert g["ranks"] == 2
        assert f"this one {r}" in g["mesh"]
    # (a) each process read its own half of the four fragments
    assert sum(world["got"][0]["a_live"]) == 60 + 85 + 110 + 135
    assert world["got"][0]["a_live"] == world["got"][1]["a_live"]


def test_two_ranks_a_process_mesh(world):
    """The 2 x 2 mesh: four ranks, two threads of each process, and each
    process's rows over its two ranks in row order, p rows each."""
    from spark_tpu_torch.physical.kernels import bucket

    files = sorted(os.path.join(world["root"], "frags", f)
                   for f in os.listdir(os.path.join(world["root"], "frags")))
    tables = [pa.concat_tables([pq.read_table(f) for f in files[p::2]])
              for p in range(2)]
    cap = bucket(max(-(-t.num_rows // 2) for t in tables), 128)
    live = []
    for p, (g, t) in enumerate(zip(world["got"], tables)):
        assert g["m_mesh"] == (4, (0, 0, 1, 1), (2 * p, 2 * p + 1)), g
        v = t.column("v").to_pylist()
        assert g["m_v"] == [v[:cap], v[cap:2 * cap]], p
        live += [min(cap, t.num_rows), max(0, t.num_rows - cap)]
    for g in world["got"]:
        assert g["m_live"] == live
    assert all(live), live


def test_lost_group_is_never_retried():
    """A failed stage across processes is terminal, whatever the fault
    under it (a retry in one process would meet no peer)."""
    from spark_tpu_torch import faults, recovery
    from spark_tpu_torch.parallel.exchange import ProcessGroupLost

    inner = faults.InjectedTransientError("exchange.all_to_all", "x")
    assert recovery.is_transient(inner)
    try:
        raise ProcessGroupLost("stage failed") from inner
    except ProcessGroupLost as e:
        assert not recovery.is_transient(e)


def test_data_plane_equals_jax_single_process(world):
    """(a) against the JAX package's one-process run."""
    key = lambda r: (r["s"], r["k"])  # noqa: E731
    want = sorted(world["a_want"], key=key)
    for g in world["got"]:
        assert sorted(g["a"], key=key) == want


@pytest.mark.parametrize("name", HEAD)
@pytest.mark.parametrize("mode", MODES)
def test_tpch_from_parts_head(world, name, mode):
    """(b) both processes alike, each mode the off run's bit for bit,
    the single-device run's and sqlite's."""
    from spark_tpu_torch.tpch.oracle import assert_rows_match, run_oracle

    a, b = (g["tpch"][(name, mode)] for g in world["got"])
    assert a == b, f"{name} {mode}: the processes disagree"
    off = world["got"][0]["tpch"][(name, "off")]
    assert repr(a) == repr(off), f"{name} {mode} differs from the off run"
    assert a, f"{name} returned no rows at this scale"
    _match_single(a, world["want"][name], f"{name} {mode}")
    if name != "q1_wide":
        assert_rows_match(a, run_oracle(world["conn"], world["text"][name]),
                          label=f"{name}[2 processes {mode}]")
    kinds = world["got"][0]["events"][(name, mode)]
    if mode == "off":
        assert not kinds, kinds
    if name == "q3" and mode != "off":
        assert "aqe" in kinds, kinds


def test_fused_mode_fuses_somewhere(world):
    fused = [n for n in HEAD
             if "fusion" in world["got"][0]["events"][(n, "fused")]]
    assert fused, world["got"][0]["events"]


@pytest.mark.parametrize("name", REST)
def test_tpch_from_parts_rest(world, name):
    """(c) the other 16 queries, adaptive off."""
    a, b = (g["tpch"][(name, "off")] for g in world["got"])
    assert a == b, f"{name}: the processes disagree"
    _match_single(a, world["want"][name], name)


def test_disjoint_dictionaries_agree(world):
    """(d) each process's file holds strings the other's lacks; both
    hold their sorted union."""
    p0, p1 = world["words"]
    assert not set(p0) & set(p1)
    union = tuple(sorted(set(p0) | set(p1)))
    for g in world["got"]:
        assert g["d_dict"] == union


@pytest.mark.parametrize("case", sorted(DISJOINT))
def test_disjoint_dictionaries_queries(world, case):
    a, b = (g["d"][case] for g in world["got"])
    assert a == b
    want = world["d_want"][case]
    assert want
    if case == "order":
        assert a == want
    else:
        assert sorted(a, key=_key) == sorted(want, key=_key)


def test_failing_rank_stops_both_processes(world):
    """(e) the fault fires in process 1 only; both exit non-zero, each
    within the group's timeout."""
    (rc0, r0, log0), (rc1, r1, log1) = world["fault"]
    assert rc0 != 0 and rc1 != 0, (log0, log1)
    # process 1's own fault, then the group torn down; process 0's
    # collective failed: both terminal, neither retried
    assert r1["chain"][:2] == ["ProcessGroupLost", "InjectedTransientError"], r1
    assert r0["chain"][0] == "ProcessGroupLost", r0
    for r in (r0, r1):
        assert r["elapsed"] < FAULT_TIMEOUT_S, r


def test_two_ranks_a_process_data_plane(world):
    """(a) on the 2 x 2 mesh against the JAX package's one-process
    run."""
    key = lambda r: (r["s"], r["k"])  # noqa: E731
    want = sorted(world["a_want"], key=key)
    for g in world["got"]:
        assert sorted(g["m_a"], key=key) == want


@pytest.mark.parametrize("name,mode", MESH2)
def test_two_ranks_a_process_tpch(world, name, mode):
    """(b) on the 2 x 2 mesh: both processes alike, q3's adaptive and
    fused runs the off run's bit for bit, the single-device run's and
    sqlite's."""
    from spark_tpu_torch.tpch.oracle import assert_rows_match, run_oracle

    a, b = (g["m_tpch"][(name, mode)] for g in world["got"])
    assert a == b, f"{name} {mode}: the processes disagree"
    assert repr(a) == repr(world["got"][0]["m_tpch"][(name, "off")])
    assert a, f"{name} returned no rows at this scale"
    _match_single(a, world["want"][name], f"{name} {mode} 2 x 2")
    if name != "q1_wide":
        assert_rows_match(a, run_oracle(world["conn"], world["text"][name]),
                          label=f"{name}[2 x 2 {mode}]")
    kinds = world["got"][0]["m_events"][(name, mode)]
    assert bool(kinds) == (mode != "off"), kinds


def test_two_ranks_a_process_dictionaries_agree(world):
    """(d) on the 2 x 2 mesh: agreed once a process, one schema for its
    two ranks."""
    union = tuple(sorted(set(world["words"][0]) | set(world["words"][1])))
    for g in world["got"]:
        assert g["m_d_dict"] == union


@pytest.mark.parametrize("case", sorted(DISJOINT))
def test_two_ranks_a_process_dictionaries_queries(world, case):
    a, b = (g["m_d"][case] for g in world["got"])
    assert a == b
    want = world["d_want"][case]
    if case == "order":
        assert a == want
    else:
        assert sorted(a, key=_key) == sorted(want, key=_key)


def test_process_thread_comm_equals_thread_comm(world):
    """2 processes x 2 threads on ProcessThreadComm against a 4-rank
    ThreadComm: every collective's result, bit for bit, a float64
    all_reduce sum included."""
    import torch

    got = {**world["got"][0]["m_comm"], **world["got"][1]["m_comm"]}
    want = world["comm_want"]
    assert sorted(got) == sorted(want) == list(range(COMM_RANKS))

    def same(a, b):
        if isinstance(a, torch.Tensor):
            return (a.dtype == b.dtype and a.shape == b.shape
                    and torch.equal(a, b))
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))

    for r in range(COMM_RANKS):
        assert want[r]["psum"].dtype == torch.float64
        for op in want[r]:
            assert same(got[r][op], want[r][op]), (r, op)


def test_failing_local_thread_stops_both_processes(world):
    """(e) on the 2 x 2 mesh: the second thread of process 1 raises
    inside a stage; both processes exit non-zero, each within the
    group's timeout."""
    (rc0, r0, log0), (rc1, r1, log1) = world["fault"]
    assert rc0 != 0 and rc1 != 0, (log0, log1)
    m0, m1 = r0["mesh2"], r1["mesh2"]
    assert m1["chain"][:2] == ["ProcessGroupLost", "RuntimeError"], m1
    assert "rank 3" in m1["message"], m1
    assert m0["chain"][0] == "ProcessGroupLost", m0
    for m in (m0, m1):
        assert m["elapsed"] < FAULT_TIMEOUT_S, m
