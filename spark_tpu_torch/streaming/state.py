"""Versioned streaming state store and offset log (the port of
``spark_tpu/streaming/state.py``; reference:
sql/core/.../execution/streaming/state/StateStore.scala,
HDFSBackedStateStoreProvider.scala, OffsetSeqLog and CommitLog).

State is one Arrow table per committed version (group keys and
accumulator columns), kept on the host and, when a checkpoint location
is set, written to Parquet per version. A restart reads the newest
committed version. Exactly-once comes from the offset log committing a
batch only after its state is durable (``execution.py``). The layout on
disk is the reference's (``state/<v>.parquet``, ``offsets/<b>.json``,
``commits/<b>.json``), so either package resumes the other's
checkpoint of a streaming aggregate.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import pyarrow as pa
import pyarrow.parquet as pq


class StateStore:
    def __init__(self, checkpoint_dir: Optional[str] = None):
        self._versions: Dict[int, pa.Table] = {}
        self._dir = checkpoint_dir
        if self._dir:
            os.makedirs(os.path.join(self._dir, "state"), exist_ok=True)

    def get(self, version: int) -> Optional[pa.Table]:
        if version in self._versions:
            return self._versions[version]
        if self._dir:
            path = os.path.join(self._dir, "state", f"{version}.parquet")
            if os.path.exists(path):
                tbl = pq.read_table(path)
                self._versions[version] = tbl
                return tbl
        return None

    def commit(self, version: int, table: pa.Table) -> None:
        self._versions[version] = table
        if self._dir:
            path = os.path.join(self._dir, "state", f"{version}.parquet")
            tmp = path + ".tmp"
            pq.write_table(table, tmp)
            os.replace(tmp, path)  # atomic rename (CheckpointFileManager)
        # keep a small window of versions in memory
        for v in sorted(self._versions):
            if v < version - 2:
                del self._versions[v]


class OffsetLog:
    """Write-ahead offset log and commit log (reference: OffsetSeqLog,
    CommitLog, HDFSMetadataLog): batch N's offsets are logged before it
    runs and committed after its state is durable; a restart replays the
    last uncommitted batch with the same offsets (exactly once with a
    deterministic source)."""

    def __init__(self, checkpoint_dir: Optional[str] = None):
        self._dir = checkpoint_dir
        self._offsets: Dict[int, dict] = {}
        self._commits: set = set()
        self._commit_meta: Dict[int, dict] = {}
        if self._dir:
            for sub in ("offsets", "commits"):
                os.makedirs(os.path.join(self._dir, sub), exist_ok=True)
            for fn in os.listdir(os.path.join(self._dir, "offsets")):
                if not fn.endswith(".json"):
                    continue  # a .tmp left by a crash mid-write
                b = int(fn.split(".")[0])
                with open(os.path.join(self._dir, "offsets", fn)) as f:
                    self._offsets[b] = json.load(f)
            for fn in os.listdir(os.path.join(self._dir, "commits")):
                if not fn.endswith(".json"):
                    continue
                b = int(fn.split(".")[0])
                self._commits.add(b)
                with open(os.path.join(self._dir, "commits", fn)) as f:
                    self._commit_meta[b] = json.load(f)

    @property
    def last_committed(self) -> int:
        return max(self._commits) if self._commits else -1

    @property
    def last_logged(self) -> int:
        return max(self._offsets) if self._offsets else -1

    def offsets_for(self, batch_id: int) -> Optional[dict]:
        return self._offsets.get(batch_id)

    def log_offsets(self, batch_id: int, offsets: dict) -> None:
        self._offsets[batch_id] = offsets
        if self._dir:
            path = os.path.join(self._dir, "offsets", f"{batch_id}.json")
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(offsets, f)
            os.replace(tmp, path)

    def commit(self, batch_id: int, watermark=None) -> None:
        self._commits.add(batch_id)
        self._commit_meta[batch_id] = {"batch": batch_id,
                                       "watermark": watermark}
        if self._dir:
            path = os.path.join(self._dir, "commits", f"{batch_id}.json")
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(self._commit_meta[batch_id], f)
            os.replace(tmp, path)

    def last_watermark(self):
        if not self._commits:
            return None
        meta = self._commit_meta.get(max(self._commits))
        return None if meta is None else meta.get("watermark")
