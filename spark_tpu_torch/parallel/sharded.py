"""Sharded columnar batches: the distributed dataset (the port of
``spark_tpu/parallel/sharded.py``).

The reference's ShardedBatch is one global (D * capacity,) array per
column, sharded so device d owns slice d. The port keeps one
``BatchData`` per rank, on that rank's device, under one schema (the
shards of a relation share its string dictionaries). The flat order,
rank 0's rows first, is the global row order: a range-partitioned and
locally sorted result reads back sorted, and ``limit`` over a relation
keeps the rows a single device would.

On a mesh that spans processes (``Mesh.spans_processes``) a process
holds the shards of its own ranks only (``None`` at the others'), and
``capacities`` lists every rank's. Host decisions over the shards read
through ``rank_values``, which all-gathers every rank's values in one
call, so every process decides alike; ``to_batch`` gathers every rank's
live rows to every process.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from spark_tpu_torch.columnar.batch import Batch, BatchData, ColumnData
from spark_tpu_torch.parallel.mesh import Mesh, mesh_size
from spark_tpu_torch.physical.kernels import bucket
from spark_tpu_torch.types import Schema


def _rows(t: Optional[torch.Tensor], lo: int, hi: int, p: int, device):
    """Rows [lo, hi) of ``t`` padded with zeros to ``p`` rows, on
    ``device``."""
    if t is None:
        return None
    part = t[lo:hi]
    if part.shape[0] < p:
        part = torch.cat([part, part.new_zeros(
            (p - part.shape[0],) + tuple(t.shape[1:]))])
    return part.to(device)


class ShardedBatch:
    """A schema and one ``BatchData`` per rank (``shards[r]`` on
    ``mesh.devices[r]``; None for a rank of another process)."""

    __slots__ = ("schema", "shards", "mesh", "sorted_by", "capacities")

    def __init__(self, schema: Schema, shards: Sequence[Optional[BatchData]],
                 mesh: Mesh, sorted_by=None,
                 capacities: Optional[Sequence[int]] = None):
        assert len(shards) == mesh_size(mesh), (len(shards), mesh)
        self.schema = schema
        self.shards = tuple(shards)
        self.mesh = mesh
        #: a global order the flat rows already satisfy, or None (advisory,
        #: as in the reference)
        self.sorted_by = sorted_by
        #: every rank's capacity (gathered where the mesh spans processes)
        self.capacities = tuple(int(c) for c in capacities) \
            if capacities is not None \
            else tuple(s.capacity for s in self.shards)

    @property
    def per_device_capacity(self) -> int:
        return max(self.capacities)

    @property
    def capacity(self) -> int:
        return sum(self.capacities)

    def rank_values(self, fn) -> list:
        """Per rank, in rank order, ``fn(shard)`` (a 1-D integer tensor of
        one length on every rank) as a host list, in one read: the local
        shards' values, stacked and, where the mesh spans processes,
        all-gathered in one call (a process's block holds its ranks'
        values, the blocks in process order, which is rank order). Every
        host decision over the shards reads through here."""
        local = self.mesh.local_ranks
        dev = self.mesh.home_device
        vals = torch.stack([fn(self.shards[r]).to(torch.int64).reshape(-1)
                            .to(dev) for r in local])
        comm = self.mesh.comm
        if comm is None:
            return vals.tolist()
        parts = comm.all_gather(0, "cpu", [vals])[0]
        return torch.cat(parts).tolist()

    def live_counts(self) -> list:
        """Each rank's live rows."""
        return [v[0] for v in self.rank_values(
            lambda s: s.row_mask.sum().reshape(1))]

    def num_valid_rows(self) -> int:
        return sum(self.live_counts())

    def shard_batch(self, rank: int) -> Batch:
        if self.shards[rank] is None:
            raise ValueError(f"rank {rank}'s shard lives in process "
                             f"{self.mesh.owners[rank]}")
        return Batch(self.schema, self.shards[rank])

    @classmethod
    def from_batch(cls, batch: Batch, mesh: Mesh,
                   per_device_capacity: Optional[int] = None
                   ) -> "ShardedBatch":
        """Contiguous blocks: rank r owns source rows [r*p, (r+1)*p),
        padded with dead rows to p = bucket(ceil(n / D), 128), as the
        reference splits (source batches are live-prefix-packed, so the
        blocks are balanced too). Across processes, where every process
        holds the whole ``batch``, each copies only its own ranks'
        blocks."""
        d = mesh_size(mesh)
        p = per_device_capacity or bucket(math.ceil(batch.capacity / d), 128)
        return cls._place(batch, mesh, p, {r: r for r in mesh.local_ranks})

    @classmethod
    def from_local(cls, batch: Batch, mesh: Mesh, p: int) -> "ShardedBatch":
        """This process's rows over its own ranks in row order, p each:
        its i-th rank owns rows [i*p, (i+1)*p) (across processes, each
        process calls it with its own ``batch``)."""
        return cls._place(batch, mesh, p,
                          {r: i for i, r in enumerate(mesh.local_ranks)})

    @classmethod
    def _place(cls, batch: Batch, mesh: Mesh, p: int, block: dict
               ) -> "ShardedBatch":
        """Rank r (a key of ``block``) gets rows [b*p, (b+1)*p) of
        ``batch``, b = ``block[r]``, on its device; the others None."""
        n = batch.capacity
        shards = []
        for r, dev in enumerate(mesh.devices):
            if r not in block:
                shards.append(None)
                continue
            lo, hi = min(n, block[r] * p), min(n, (block[r] + 1) * p)
            cols = tuple(ColumnData(_rows(cd.data, lo, hi, p, dev),
                                    _rows(cd.validity, lo, hi, p, dev))
                         for cd in batch.data.columns)
            shards.append(BatchData(cols, _rows(batch.data.row_mask, lo, hi,
                                                p, dev)))
        return cls(batch.schema, shards, mesh,
                   capacities=[p] * mesh_size(mesh))

    def to_batch(self, device=None) -> Batch:
        """The shards concatenated in rank order into one batch on
        ``device`` (by default the device of this process's first rank).
        Across processes, every rank's live rows, gathered to every
        process."""
        if self.mesh.spans_processes:
            return self._gather(device)
        dev = torch.device(device) if device is not None \
            else self.mesh.devices[0]

        def cat(ts):
            ts = [t.to(dev) for t in ts]
            return ts[0] if len(ts) == 1 else torch.cat(ts)

        cols = []
        for i in range(len(self.schema)):
            cds = [s.columns[i] for s in self.shards]
            data = [cd.data for cd in cds]
            if data[0].dim() == 2:  # arrays: pad to the widest shard
                from spark_tpu_torch.expr.compiler import pad_width

                width = max(t.shape[1] for t in data)
                data = [pad_width(t, width) for t in data]
            validity = None
            if any(cd.validity is not None for cd in cds):
                validity = cat([cd.validity if cd.validity is not None
                                else torch.ones(cd.data.shape[0],
                                                dtype=torch.bool,
                                                device=cd.data.device)
                                for cd in cds])
            cols.append(ColumnData(cat(data), validity))
        return Batch(self.schema, BatchData(
            tuple(cols), cat([s.row_mask for s in self.shards])))

    def _gather(self, device=None) -> Batch:
        """Every rank's live rows on every process, in rank order: one
        gather of each process's live rows, array widths and validity
        flags, then each column's live rows of this process's ranks
        (concatenated in rank order), padded to the largest process's
        (``Comm.all_gather_var``), cut back and concatenated in process
        order, which is rank order."""
        from spark_tpu_torch.expr.compiler import pad_width

        comm = self.mesh.comm
        shards = [self.shards[r] for r in self.mesh.local_ranks]
        home = self.mesh.home_device
        dev = torch.device(device) if device is not None else home
        keeps = [torch.nonzero(s.row_mask).reshape(-1) for s in shards]
        k = len(self.schema)
        meta = torch.tensor(
            [[sum(int(x.shape[0]) for x in keeps), 0]]
            + [[max(s.columns[i].data.shape[1]
                    if s.columns[i].data.dim() == 2 else 0 for s in shards),
                int(any(s.columns[i].validity is not None for s in shards))]
               for i in range(k)], dtype=torch.int64).reshape(-1)
        metas = torch.stack(comm.all_gather(0, "cpu", [meta])[0]) \
            .reshape(comm.size, -1, 2)
        n = int(metas[:, 0, 0].sum())
        widths = metas[:, 1:, 0].max(dim=0).values.tolist()
        valid = metas[:, 1:, 1].any(dim=0).tolist()

        def live(i: int, validity: bool) -> torch.Tensor:
            out = []
            for s, keep in zip(shards, keeps):
                cd = s.columns[i]
                if not validity:
                    t = cd.data[keep]
                    if t.dim() == 2:
                        t = pad_width(t, int(widths[i]))
                elif cd.validity is not None:
                    t = cd.validity[keep]
                else:
                    t = torch.ones(keep.shape[0], dtype=torch.bool,
                                   device=keep.device)
                out.append(t.to(home))
            return out[0] if len(out) == 1 else torch.cat(out)

        send = []
        for i in range(k):
            send.append(live(i, False))
            if valid[i]:
                send.append(live(i, True))
        got = iter(comm.all_gather_var(0, dev, send))
        cols = []
        for i in range(k):
            data = torch.cat(next(got))
            validity = torch.cat(next(got)) if valid[i] else None
            cols.append(ColumnData(data, validity))
        mask = torch.ones(n, dtype=torch.bool, device=dev)
        if n == 0:  # one dead row: a batch has a slot
            cols = [ColumnData(torch.zeros((1,) + tuple(c.data.shape[1:]),
                                           dtype=c.data.dtype, device=dev),
                               None if c.validity is None else
                               torch.zeros(1, dtype=torch.bool, device=dev))
                    for c in cols]
            mask = torch.zeros(1, dtype=torch.bool, device=dev)
        return Batch(self.schema, BatchData(tuple(cols), mask))

    def __repr__(self):
        return (f"ShardedBatch(D={mesh_size(self.mesh)}, "
                f"per_device={self.per_device_capacity}, "
                f"schema={list(self.schema.names)})")
