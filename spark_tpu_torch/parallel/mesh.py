"""Device mesh construction (the port of ``spark_tpu/parallel/mesh.py``).

The mesh plays the role of the reference's cluster topology: a static,
agreed list of devices, one per rank, on one axis, ``data``, which
carries partition parallelism (the analogue of Spark's task slots).

A mesh is of one process (``make_mesh``: its ranks are threads of this
process) or spans the processes of an initialized ``torch.distributed``
group (``make_process_mesh``: rank r runs in process r, one rank a
process). Each rank has a device and an owning process; a process runs,
and holds the shards of, its own ranks only.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from spark_tpu_torch.device import resolve_device

DATA_AXIS = "data"


class Mesh:
    """A 1-D ``data`` mesh: rank r runs on ``devices[r]`` in process
    ``owners[r]``. ``comm``, on a mesh that spans processes, is the
    process group's communicator (``exchange.DistComm``) that host
    decisions gather through; None on a mesh of one process."""

    __slots__ = ("devices", "owners", "process_index", "comm")

    def __init__(self, devices: Sequence[torch.device],
                 owners: Optional[Sequence[int]] = None,
                 process_index: int = 0, comm=None):
        self.devices: Tuple[torch.device, ...] = tuple(devices)
        self.owners: Tuple[int, ...] = (
            tuple(owners) if owners is not None else (0,) * len(devices))
        self.process_index = int(process_index)
        self.comm = comm

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: len(self.devices)}

    @property
    def spans_processes(self) -> bool:
        return self.comm is not None

    @property
    def local_ranks(self) -> Tuple[int, ...]:
        """The ranks this process runs."""
        return tuple(r for r, o in enumerate(self.owners)
                     if o == self.process_index)

    @property
    def home_device(self) -> torch.device:
        """The device of this process's first rank (where it reads its
        scans and gathers results)."""
        return self.devices[self.local_ranks[0]]

    def __repr__(self):
        if self.spans_processes:
            return (f"Mesh({[str(d) for d in self.devices]}, processes "
                    f"{list(self.owners)}, this one {self.process_index})")
        return f"Mesh({[str(d) for d in self.devices]})"


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ``data`` mesh over the first ``n_devices`` of ``devices``. With
    no list, the card's devices ``cuda:0`` .. ``cuda:n-1`` (all of them
    for ``n_devices=None``), raising when there are fewer than asked for
    or no CUDA at all: ranks share a device only when the caller lists
    it more than once (``devices=["cuda:0"] * 4``, ``["cpu"] * 8``)."""
    if devices is None:
        resolve_device("cuda")  # raises without CUDA
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"mesh[{n_devices}] requested but only {len(devices)} "
                f"devices are available")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return Mesh(devices)


def make_process_mesh(device=None) -> Mesh:
    """A mesh over the initialized process group, one rank a process:
    rank r is process r, on that process's ``device``. A CUDA device
    without an index (or None) is the process's own card, ``cuda:(r mod
    the cards)``: two processes that share one card both use ``cuda:0``;
    without CUDA it raises. ``"cpu"`` puts every rank on its process's
    CPU (a gloo group). The ranks' devices are all-gathered, so every
    process holds the same list."""
    import torch.distributed as dist

    from spark_tpu_torch.parallel.exchange import DistComm

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("a mesh over processes needs an initialized "
                           "process group (multihost.initialize)")
    n, me = dist.get_world_size(), dist.get_rank()
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and dev.index is None:
        resolve_device("cuda")  # raises without CUDA
        dev = torch.device("cuda", me % torch.cuda.device_count())
    dev = resolve_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)  # NCCL's object collectives use it
    names: list = [None] * n
    dist.all_gather_object(names, str(dev))
    return Mesh([torch.device(x) for x in names], owners=range(n),
                process_index=me, comm=DistComm())


def mesh_size(mesh: Mesh) -> int:
    return len(mesh.devices)
