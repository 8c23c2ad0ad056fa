"""Several processes: the port of ``spark_tpu/parallel/multihost.py``.

The reference joins ``jax.distributed``'s coordination service and then
sees every host's devices in one mesh. The port's control plane is
``torch.distributed``: ``initialize`` joins a process group (NCCL on the
card, gloo on the CPU), whose store carries the rendezvous
(``barrier_kv_exchange``), and ``parallel/exchange.DistComm`` runs a
mesh stage's collectives over it, one rank per process
(``executor.run_rank``). Query execution across processes is not ported
yet (ROADMAP A10): a session's mesh is the devices of one process, and
``sharded_batch_from_local`` builds a ShardedBatch from this process's
rows only when it is the only process.
"""

from __future__ import annotations

import datetime
import math
from typing import Optional, Sequence

import torch

from spark_tpu_torch.parallel.mesh import Mesh, make_mesh


def _dist():
    import torch.distributed as dist

    return dist


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> None:
    """Join the process group at ``coordinator`` (``host:port``) as
    process ``process_id`` of ``num_processes``: NCCL when CUDA is
    available, else gloo (``backend`` overrides). One process, or no
    arguments at all, is a no-op."""
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
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=int(num_processes),
                            rank=int(process_id))


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


def global_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over ``devices``, by default every CUDA device of this
    process (the only process a mesh spans yet)."""
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
    blocks of ``per_device_capacity``, by default ceil(rows / D) rounded
    up to 128), on the ranks' devices."""
    from spark_tpu_torch.columnar.arrow import from_arrow
    from spark_tpu_torch.parallel.sharded import ShardedBatch
    from spark_tpu_torch.physical.kernels import bucket

    if process_info()["process_count"] > 1:
        raise NotImplementedError(
            "not ported yet: a ShardedBatch across processes (ROADMAP A10)")
    if mesh is None:
        mesh = global_mesh()
    d = len(mesh.devices)
    p = per_device_capacity or bucket(math.ceil(max(1, table.num_rows) / d),
                                      128)
    if table.num_rows > p * d:
        raise ValueError(f"local rows {table.num_rows} exceed local capacity "
                         f"{p * d}; raise per_device_capacity")
    batch = from_arrow(table, capacity=p * d, device=mesh.devices[0])
    return ShardedBatch.from_batch(batch, mesh, per_device_capacity=p)


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
