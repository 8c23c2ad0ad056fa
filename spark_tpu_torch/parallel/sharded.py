"""Sharded columnar batches: the distributed dataset (the port of
``spark_tpu/parallel/sharded.py``).

The reference's ShardedBatch is one global (D * capacity,) array per
column, sharded so device d owns slice d. The port keeps one
``BatchData`` per rank, on that rank's device, under one schema (the
shards of a relation share its string dictionaries). The flat order,
rank 0's rows first, is the global row order: a range-partitioned and
locally sorted result reads back sorted, and ``limit`` over a relation
keeps the rows a single device would.
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
    ``mesh.devices[r]``)."""

    __slots__ = ("schema", "shards", "mesh", "sorted_by")

    def __init__(self, schema: Schema, shards: Sequence[BatchData],
                 mesh: Mesh, sorted_by=None):
        assert len(shards) == mesh_size(mesh), (len(shards), mesh)
        self.schema = schema
        self.shards = tuple(shards)
        self.mesh = mesh
        #: a global order the flat rows already satisfy, or None (advisory,
        #: as in the reference)
        self.sorted_by = sorted_by

    @property
    def per_device_capacity(self) -> int:
        return max(s.capacity for s in self.shards)

    @property
    def capacity(self) -> int:
        return sum(s.capacity for s in self.shards)

    def live_counts(self) -> list:
        """Each rank's live rows (one host copy per rank)."""
        return [int(s.row_mask.sum()) for s in self.shards]

    def num_valid_rows(self) -> int:
        return sum(self.live_counts())

    def shard_batch(self, rank: int) -> Batch:
        return Batch(self.schema, self.shards[rank])

    @classmethod
    def from_batch(cls, batch: Batch, mesh: Mesh,
                   per_device_capacity: Optional[int] = None
                   ) -> "ShardedBatch":
        """Contiguous blocks: rank r owns source rows [r*p, (r+1)*p),
        padded with dead rows to p = bucket(ceil(n / D), 128), as the
        reference splits (source batches are live-prefix-packed, so the
        blocks are balanced too)."""
        d = mesh_size(mesh)
        n = batch.capacity
        p = per_device_capacity or bucket(math.ceil(n / d), 128)
        shards = []
        for r, dev in enumerate(mesh.devices):
            lo, hi = min(n, r * p), min(n, (r + 1) * p)
            cols = tuple(ColumnData(_rows(cd.data, lo, hi, p, dev),
                                    _rows(cd.validity, lo, hi, p, dev))
                         for cd in batch.data.columns)
            shards.append(BatchData(cols, _rows(batch.data.row_mask, lo, hi,
                                                p, dev)))
        return cls(batch.schema, shards, mesh)

    def to_batch(self, device=None) -> Batch:
        """The shards concatenated in rank order into one batch on
        ``device`` (rank 0's by default)."""
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

    def __repr__(self):
        return (f"ShardedBatch(D={mesh_size(self.mesh)}, "
                f"per_device={self.per_device_capacity}, "
                f"schema={list(self.schema.names)})")
