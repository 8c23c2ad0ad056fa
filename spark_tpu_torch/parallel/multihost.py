"""Several processes: the port of ``spark_tpu/parallel/multihost.py``.

The reference joins ``jax.distributed``'s coordination service and then
sees every host's devices in one mesh. The port's control plane is
``torch.distributed``: ``initialize`` joins a process group (NCCL on the
card, gloo on the CPU; ``backend`` picks), whose store carries the
rendezvous (``barrier_kv_exchange``). Its data plane is one rank a
process: under an initialized group, ``global_mesh()`` (and a session's
``master("mesh[*]")``) is a mesh whose rank r runs in process r, and a
``MeshExecutor`` over it runs each stage's local rank in the calling
thread, its collectives on ``exchange.DistComm``. An identical program
runs in every process: each reads its own files
(``read_parquet_sharded``), every host decision reads values gathered
from all ranks, and ``collect()`` returns the same rows in every
process (the reference: on host 0).

Two repairs of the reference's ``sharded_batch_from_local``: the
per-rank capacity, when not given, is agreed by an all-gather of each
process's row count; and every string column's dictionary becomes the
sorted union of all processes' dictionaries, each process's codes
remapped to it on the device, so every process holds the same schema
(the reference stitched per-process dictionaries whose codes disagree).
Several ranks a process across processes is not ported yet (ROADMAP
A10).
"""

from __future__ import annotations

import datetime
import math
from typing import Optional, Sequence

import numpy as np
import torch

from spark_tpu_torch.parallel.mesh import Mesh, make_mesh, make_process_mesh


def _dist():
    import torch.distributed as dist

    return dist


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               timeout_s: Optional[float] = None) -> None:
    """Join the process group at ``coordinator`` (``host:port``) as
    process ``process_id`` of ``num_processes``: NCCL when CUDA is
    available, else gloo (``backend`` overrides). A collective waits at
    most ``timeout_s`` for its peers (``exchange.DEFAULT_TIMEOUT_S`` by
    default), then fails. One process, or no arguments at all, is a
    no-op."""
    from spark_tpu_torch.parallel.exchange import DEFAULT_TIMEOUT_S

    if num_processes is None or int(num_processes) <= 1:
        return
    if coordinator is None or process_id is None:
        raise ValueError("initialize needs coordinator and process_id for "
                         f"{num_processes} processes")
    dist = _dist()
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=float(
            DEFAULT_TIMEOUT_S if timeout_s is None else timeout_s)))


def barrier_kv_exchange(key: str, value: str, peer_key: str,
                        timeout_s: int = 30) -> str:
    """Publish ``key`` = ``value`` in the process group's store, wait for
    ``peer_key`` and return its value: the registration handshake of the
    reference's driver and executors, on the group's own control
    plane."""
    dist = _dist()
    if not dist.is_initialized():
        raise RuntimeError("multihost.initialize() has not run")
    store = dist.distributed_c10d._get_default_store()
    store.set(key, value)
    store.wait([peer_key], datetime.timedelta(seconds=timeout_s))
    return store.get(peer_key).decode()


def process_info() -> dict:
    """This process's place in the job (the executor-registration
    record)."""
    dist = _dist()
    up = dist.is_available() and dist.is_initialized()
    local = ([f"cuda:{i}" for i in range(torch.cuda.device_count())]
             if torch.cuda.is_available() else ["cpu"])
    count = dist.get_world_size() if up else 1
    return {"process_index": dist.get_rank() if up else 0,
            "process_count": count, "local_devices": local,
            "global_devices": count * len(local)}


def is_coordinator() -> bool:
    return process_info()["process_index"] == 0


def global_mesh(devices: Optional[Sequence] = None, device=None) -> Mesh:
    """Under an initialized group of several processes, the mesh over
    them, one rank a process (``mesh.make_process_mesh``): rank r on
    ``devices[r]`` when a list is given (one device a process), else on
    ``device`` (by default the process's own card). In one process, a
    mesh over ``devices``, by default every CUDA device."""
    if process_info()["process_count"] > 1:
        if devices is not None:
            devices = list(devices)
            n = _dist().get_world_size()
            if len(devices) != n:
                raise NotImplementedError(
                    f"not ported yet: {len(devices)} ranks over {n} "
                    "processes (several ranks a process across processes, "
                    "ROADMAP A10); list one device a process")
            device = devices[_dist().get_rank()]
        return make_process_mesh(device)
    return make_mesh(devices=list(devices) if devices is not None else None)


def local_fragments(path, fmt: str = "parquet") -> list:
    """This process's share of a multi-file dataset: the sorted files,
    round-robin over the processes (each host scans only its own, the
    preferred-location analogue)."""
    import pyarrow.dataset as pads

    info = process_info()
    files = sorted(pads.dataset(path, format=fmt).files)
    return files[info["process_index"]::info["process_count"]]


def sharded_batch_from_local(table, mesh: Optional[Mesh] = None,
                             per_device_capacity: Optional[int] = None):
    """A ShardedBatch over ``mesh`` of this process's rows (contiguous
    blocks of ``per_device_capacity`` over its ranks, on their devices).
    Every process of a mesh that spans processes calls it with its own
    table: the capacity, when not given, is bucket(the largest process's
    rows, 128), agreed by one all-gather, which also carries each
    process's string dictionaries, null flags and array widths; every
    dictionary becomes the sorted union (codes remapped on the device),
    a column with nulls anywhere has a validity everywhere, and arrays
    pad to the widest, so every process holds one schema. In one
    process the capacity defaults to ceil(rows / D) rounded up to 128."""
    from spark_tpu_torch.columnar.arrow import from_arrow
    from spark_tpu_torch.parallel.sharded import ShardedBatch
    from spark_tpu_torch.physical.kernels import bucket

    if mesh is None:
        mesh = global_mesh()
    d = len(mesh.devices)
    if not mesh.spans_processes:
        p = per_device_capacity or bucket(
            math.ceil(max(1, table.num_rows) / d), 128)
        if table.num_rows > p * d:
            raise ValueError(f"local rows {table.num_rows} exceed local "
                             f"capacity {p * d}; raise per_device_capacity")
        batch = from_arrow(table, capacity=p * d, device=mesh.devices[0])
        return ShardedBatch.from_batch(batch, mesh, per_device_capacity=p)
    (r,) = mesh.local_ranks
    most = max(mesh.comm.gather_objects(table.num_rows))
    p = per_device_capacity or bucket(max(1, most), 128)
    if most > p:  # every process raises alike
        raise ValueError(f"a process's rows {most} exceed the per-rank "
                         f"capacity {p}; raise per_device_capacity")
    batch = from_arrow(table, capacity=p, device=mesh.devices[r])
    everyone = mesh.comm.gather_objects({
        "dicts": [f.dictionary for f in batch.schema.fields],
        "nullable": [cd.validity is not None for cd in batch.data.columns],
        "widths": [cd.data.shape[1] if cd.data.dim() == 2 else 0
                   for cd in batch.data.columns]})
    batch = _agree(batch, everyone)
    shards = [batch.data if q == r else None for q in range(d)]
    return ShardedBatch(batch.schema, shards, mesh, capacities=[p] * d)


def _agree(batch, everyone: list):
    """``batch`` (this process's rows) under the schema every process
    agrees on (``everyone``: each process's dictionaries, null flags and
    array widths)."""
    import dataclasses

    from spark_tpu_torch.columnar.batch import Batch, BatchData, ColumnData
    from spark_tpu_torch.expr.compiler import pad_width
    from spark_tpu_torch.types import Schema

    fields, cols = [], []
    n = batch.capacity
    for i, (f, cd) in enumerate(zip(batch.schema.fields,
                                    batch.data.columns)):
        data, validity = cd.data, cd.validity
        if f.dictionary is not None:
            union = tuple(sorted(set().union(
                *(e["dicts"][i] or () for e in everyone))))
            if union != f.dictionary:
                if f.dictionary:
                    # code order is string order on every process: the
                    # local dictionary's place in the union, on the device
                    remap = np.searchsorted(np.array(union, dtype=object),
                                            np.array(f.dictionary,
                                                     dtype=object))
                    data = torch.as_tensor(remap.astype(np.int32),
                                           device=data.device)[data.long()]
                else:  # no row here: every code is a dead row's
                    data = torch.zeros_like(data)
            f = dataclasses.replace(f, dictionary=union)
        if any(e["nullable"][i] for e in everyone):
            if validity is None:
                validity = torch.ones(n, dtype=torch.bool, device=data.device)
            f = dataclasses.replace(f, nullable=True)
        width = max(e["widths"][i] for e in everyone)
        if data.dim() == 2 and data.shape[1] < width:
            data = pad_width(data, width)
        fields.append(f)
        cols.append(ColumnData(data, validity))
    return Batch(Schema(tuple(fields)),
                 BatchData(tuple(cols), batch.data.row_mask))


def read_parquet_sharded(path, mesh: Optional[Mesh] = None, columns=None,
                         per_device_capacity: Optional[int] = None):
    """A distributed scan: this process reads its own fragments and
    contributes their rows as the mesh's shards."""
    import pyarrow.dataset as pads

    frags = local_fragments(path)
    if frags:
        table = pads.dataset(frags, format="parquet").to_table(
            columns=list(columns) if columns is not None else None)
    else:
        table = pads.dataset(path, format="parquet").schema.empty_table()
    return sharded_batch_from_local(table, mesh,
                                    per_device_capacity=per_device_capacity)
