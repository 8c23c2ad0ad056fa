"""Scheduling pools (the port of ``spark_tpu/scheduler/pool.py``;
reference: core/.../scheduler/Pool.scala +
SchedulableBuilder.scala's FairSchedulableBuilder, collapsed to the
query level: there is no XML file, pools are declared through ordinary
conf keys ``spark.tpu.scheduler.pool.<name>.{weight,minShare}`` and
materialize lazily on first use).

Ranking mirrors the reference's FairSchedulingAlgorithm: pools running
below their ``minShare`` come first (most starved first); the rest are
ordered by accumulated *device time* over ``weight`` — stride
scheduling, so a weight-2 pool receives twice the device time of a
weight-1 pool under contention. FIFO mode ignores pools and ranks by
global submit order.
"""

from __future__ import annotations

from collections import deque
from typing import Dict

from spark_tpu_torch import locks
from spark_tpu_torch import conf as CF


class Pool:
    """One scheduling pool: a FIFO queue of tickets plus the running
    count and accumulated device-time the fair ranking feeds on."""

    def __init__(self, name: str, weight: int = 1, min_share: int = 0):
        self.name = name
        self.weight = max(1, int(weight))
        self.min_share = max(0, int(min_share))
        #: tickets submitted but not yet dequeued by a worker
        self.queue: deque = deque()
        #: dequeued-but-unfinished queries (host or device phase)
        self.running = 0
        #: queries currently holding a device admission
        self.device_running = 0
        #: accumulated device-gate wall time (the fair-share currency)
        self.device_ms = 0.0
        self.finished = 0

    def fair_rank(self):
        """Sort key: starved pools (device_running < minShare) first,
        most starved first; then least device_ms/weight (stride)."""
        if self.device_running < self.min_share:
            return (0, self.device_running / max(1, self.min_share),
                    self.name)
        return (1, self.device_ms / self.weight, self.name)

    def snapshot(self) -> dict:
        return {"name": self.name, "weight": self.weight,
                "min_share": self.min_share, "queued": len(self.queue),
                # running counts dequeued-but-unfinished queries only;
                # self.running also includes the still-queued ones
                "running": self.running - len(self.queue),
                "device_running": self.device_running,
                "device_ms": round(self.device_ms, 2),
                "finished": self.finished}


def build_pools(conf) -> Dict[str, Pool]:
    """Materialize the pools declared in ``conf`` (prefix scan over
    ``spark.tpu.scheduler.pool.<name>.*``) plus the default pool."""
    specs: Dict[str, Dict[str, int]] = {}
    prefix = CF.SCHEDULER_POOL_PREFIX
    for key, value in conf.entries().items():
        if not key.startswith(prefix):
            continue
        rest = key[len(prefix):]
        if "." not in rest:
            continue
        name, attr = rest.rsplit(".", 1)
        if attr in ("weight", "minShare"):
            specs.setdefault(name, {})[attr] = int(value)
    pools = {
        name: Pool(name, weight=spec.get("weight", 1),
                   min_share=spec.get("minShare", 0))
        for name, spec in specs.items()}
    default = str(conf.get(CF.SCHEDULER_DEFAULT_POOL))
    pools.setdefault(default, Pool(default))
    return pools


class PoolRegistry:
    """Thread-safe pool lookup that materializes unknown pool names on
    demand (the reference logs a warning and creates the pool with
    default weight — same here, a client naming a new pool must not
    fail its query)."""

    def __init__(self, conf):
        self._conf = conf
        self._lock = locks.named_lock("scheduler.pools")
        self._pools = build_pools(conf)
        self.default_name = str(conf.get(CF.SCHEDULER_DEFAULT_POOL))

    def get(self, name=None) -> Pool:
        name = str(name) if name else self.default_name
        with self._lock:
            pool = self._pools.get(name)
            if pool is None:
                pool = self._pools[name] = Pool(name)
            return pool

    def all(self):
        with self._lock:
            return list(self._pools.values())
