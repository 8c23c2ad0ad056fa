"""Mesh execution: the port of ``spark_tpu/parallel``.

The reference's ``mesh[N]`` is one process driving N devices: data lives
sharded over a 1-D ``data`` mesh, a stage is one SPMD program whose
per-device view runs the single-device operators, and the shuffle is a
collective (``all_to_all``) inside it. The port keeps that model: one
process, one Python thread per rank, each on its rank's
``torch.device``, running the same per-rank operator code on its shard;
every collective goes through the communicator seam of
``parallel/exchange.py`` (``ThreadComm`` in process, ``DistComm`` over
``torch.distributed``). Ranks may share a device when the caller lists
the devices (``make_mesh(n, devices=[...])``).
"""

from spark_tpu_torch.parallel.mesh import (DATA_AXIS, Mesh,  # noqa: F401
                                           make_mesh)
from spark_tpu_torch.parallel.sharded import ShardedBatch  # noqa: F401
