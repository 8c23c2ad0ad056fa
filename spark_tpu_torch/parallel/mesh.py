"""Device mesh construction (the port of ``spark_tpu/parallel/mesh.py``).

The mesh plays the role of the reference's cluster topology: a static,
agreed list of devices, one per rank, on one axis, ``data``, which
carries partition parallelism (the analogue of Spark's task slots).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from spark_tpu_torch.device import resolve_device

DATA_AXIS = "data"


class Mesh:
    """A 1-D ``data`` mesh: rank r runs on ``devices[r]``."""

    __slots__ = ("devices",)

    def __init__(self, devices: Sequence[torch.device]):
        self.devices: Tuple[torch.device, ...] = tuple(devices)

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: len(self.devices)}

    def __repr__(self):
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


def mesh_size(mesh: Mesh) -> int:
    return len(mesh.devices)
