"""The cross-session statistics store (the port of
``spark_tpu/compile/store.py``).

What is persisted, and why. The reference persists the compiled XLA
executables of its stages (``jax.experimental.serialize_executable``), so
a restarted worker loads them instead of compiling. The port's compiled
form of a stage is a CUDA graph, which cannot be serialized: it holds
device addresses of one process. What makes a graph possible is the
plan's runtime statistics: a plan's first run in a process runs its
joins, sorted aggregates and explodes blocking, syncing with the host to
size their outputs, and records those sizes (``physical/planner.py``
``_OUTPUT_STATS`` and ``_COMPACT_STATS``, ``physical/operators.py``
``_AGG_STATS``, ``_GEN_STATS`` and ``_JOIN_STATS``); a later run binds
them, runs traced and captures its stages. So the store keeps, per plan,
the statistics its first run recorded, and a restarted process that
meets the same plan over the same data binds them under its own
``stats_key``s: its first run of that plan is not a first run
(``RunStats.first_run`` is False), and it captures at once. The join
build indexes (``_JOIN_INDEX``) are device tensors and are not kept; a
traced join without one builds its ranges in the stage.

The key. ``plan_key`` and ``stats_key`` cannot be used on disk: a scan's
key carries ``hash()`` of its string dictionary, which Python salts per
process, and ``stats_key`` the ids of the leaf tensors. The stable key
here is the plan key with each scan's part replaced by digests of its
dictionaries' contents and of its columns' bytes (a statistic is a fact
about the data: a group count holds only for the rows it was counted
over). The digests are taken once per tensor and dictionary in a
process (on the host: one copy and one hash of each leaf), and only on
the store's path, never on the plan's hot path.

Policies, the reference's: an entry that cannot be read, parsed or bound
is a miss and is removed; the directory is held to ``maxBytes``, least
recently used entries first; with the store off nothing here runs.
Entries are Python literals (``repr``/``ast.literal_eval``), written
atomically (temp file and rename).
"""

from __future__ import annotations

import ast
import datetime
import decimal
import hashlib
import os
import threading
import weakref
from typing import Any, Dict, List, Optional

from spark_tpu_torch import locks, metrics

_ENTRY_SUFFIX = ".stats"
_FORMAT = 1

#: process-global map (store root, digest) -> loaded entry, so a second
#: session over the same directory in one process skips the disk read.
#: Tests clear it to force the disk path (a new process).
_LOADED: dict = {}
_LOADED_LOCK = locks.named_lock("compile.loaded")


# ---- content digests ----------------------------------------------------------

#: id(object) -> (weakref to the object, its digest); an entry whose
#: object died is never hit (the weakref no longer points at the object
#: asked about)
_DIGESTS: Dict[int, tuple] = {}
_DIGEST_LOCK = locks.named_lock("compile.dict_fp")


def _memo(obj, compute) -> str:
    with _DIGEST_LOCK:
        hit = _DIGESTS.get(id(obj))
    if hit is not None and hit[0]() is obj:
        return hit[1]
    digest = compute()
    with _DIGEST_LOCK:
        if len(_DIGESTS) > 8192:
            for k in [k for k, (ref, _) in _DIGESTS.items()
                      if ref() is None]:
                del _DIGESTS[k]
        _DIGESTS[id(obj)] = (weakref.ref(obj), digest)
    return digest


def _dictionary_digest(field) -> Optional[str]:
    if field.dictionary is None:
        return None

    def compute():
        import numpy as np

        words = field.dictionary
        # the entries' lengths, then their text: one update each, and no
        # two dictionaries share an encoding
        h = hashlib.sha256(np.fromiter(map(len, words), np.int64,
                                       len(words)).tobytes())
        h.update("".join(words).encode("utf-8", "surrogatepass"))
        return h.hexdigest()[:24]

    return _memo(field, compute)


def tensor_digest(t) -> str:
    """Digest of a tensor's dtype, shape and bytes (copied to the host
    once per tensor in a process; SHA-256, which the host's SHA
    instructions run at about 1 GB/s)."""

    def compute():
        import numpy as np

        h = hashlib.sha256(f"{t.dtype}{tuple(t.shape)}".encode())
        arr = np.ascontiguousarray(t.detach().cpu().numpy())
        h.update(arr.view(np.uint8).reshape(-1))
        return h.hexdigest()[:32]

    return _memo(t, compute)


def _batch_leaf_key(batch) -> tuple:
    fields = batch.schema.fields
    data = batch.data
    tensors = [data.row_mask] + [x for cd in data.columns
                                 for x in (cd.data, cd.validity)]
    live = [t for t in tensors if t is not None]
    if len(live) > 1:
        # hashlib and the copies release the interpreter's lock: a
        # table's columns digest at once
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(min(8, len(live))) as pool:
            list(pool.map(tensor_digest, live))
    return ("BatchScan", int(batch.capacity),
            tuple((f.name, repr(f.dtype)) for f in fields),
            tuple(_dictionary_digest(f) for f in fields),
            tuple(None if t is None else tensor_digest(t)
                  for t in tensors))


# ---- stable plan keys ---------------------------------------------------------


class _Unstable(Exception):
    """A key part that is not the same in another process (an object's
    address): such a plan is not persisted."""


def _stable(v) -> Any:
    if isinstance(v, tuple):
        return tuple(_stable(x) for x in v)
    if isinstance(v, str):
        if " at 0x" in v or " object at " in v:
            raise _Unstable(v)
        return v
    if v is None or isinstance(v, (bool, int, float, bytes)):
        return v
    if isinstance(v, (decimal.Decimal, datetime.date, datetime.timedelta)):
        return (type(v).__name__, str(v))  # literal values
    item = getattr(v, "item", None)
    if callable(item) and type(v).__module__ == "numpy":
        return _stable(item())
    raise _Unstable(repr(type(v)))


def _physical_key(plan) -> tuple:
    """``plan.plan_key()`` with every scan's key (the very tuple the
    scan memoized, which its ancestors embed) replaced by its content
    key."""
    from spark_tpu_torch.physical import operators as P

    subst: Dict[int, tuple] = {}

    def scans(p) -> None:
        if isinstance(p, P.BatchScanExec):
            subst[id(p.plan_key())] = _batch_leaf_key(p.batch)
            return
        for c in p.children():
            scans(c)

    scans(plan)

    def walk(k):
        hit = subst.get(id(k))
        if hit is not None:
            return hit
        if isinstance(k, tuple):
            return tuple(walk(x) for x in k)
        return k

    return _stable(walk(plan.plan_key()))


def stable_plan_key(plan) -> Optional[tuple]:
    """The physical plan's structure with content digests at its data
    leaves, the same in every process; None where a part of the plan has
    no stable form (a user function, say)."""
    try:
        return _physical_key(plan)
    except _Unstable:
        return None


def environment_fingerprint() -> tuple:
    """The device half: the platform, the device's name and the torch
    version."""
    import torch

    if torch.cuda.is_available():
        return ("cuda", torch.cuda.get_device_name(0), torch.__version__)
    return ("cpu", "cpu", torch.__version__)


def stable_plan_fingerprint(tier: str, plan) -> Optional[str]:
    """Hex digest naming one physical plan over its data across sessions
    and processes: ``tier`` (what the digest keys: a plan's entry, one
    node's statistics), its stable key and the environment; None for a
    plan with no stable key."""
    key = stable_plan_key(plan)
    if key is None:
        return None
    payload = (tier, key, environment_fingerprint())
    return hashlib.sha256(repr(payload).encode()).hexdigest()[:32]


# ---- what a plan's first run recorded -------------------------------------------


def _caches() -> Dict[str, Any]:
    from spark_tpu_torch.physical import operators as P
    from spark_tpu_torch.physical import planner as PL

    return {"output": PL._OUTPUT_STATS, "compact": PL._COMPACT_STATS,
            "agg": P._AGG_STATS, "gen": P._GEN_STATS,
            "join": P._JOIN_STATS}


def _nodes(plan) -> List[Any]:
    """The plan's nodes in pre-order, without scans and without the
    compactions a replay inserts (transparent to every key)."""
    from spark_tpu_torch.physical import operators as P

    out: list = []

    def go(p) -> None:
        if isinstance(p, P.BatchScanExec):
            return
        if not isinstance(p, P.CompactExec):
            out.append(p)
        for c in p.children():
            go(c)

    go(plan)
    return out


def _literal(v) -> bool:
    try:
        return ast.literal_eval(repr(v)) == v
    except (ValueError, SyntaxError, TypeError, MemoryError,
            RecursionError):
        return False


def collect_stats(plan) -> Optional[list]:
    """[(node digest, {cache: value})] for every node of ``plan``, in
    pre-order; None when a node has no stable key or a value no literal
    form."""
    caches = _caches()
    out = []
    for node in _nodes(plan):
        digest = stable_plan_fingerprint("stats", node)
        if digest is None:
            return None
        sk = node.stats_key()
        vals = {}
        for name, cache in caches.items():
            v = cache.get(sk)
            if v is not None:
                if not _literal(v):
                    return None
                vals[name] = v
        out.append((digest, vals))
    return out


def bind_stats(plan, nodes: list) -> None:
    """Insert an entry's statistics under this process's ``stats_key``s
    of ``plan``'s nodes; raises when the entry does not fit the plan."""
    caches = _caches()
    mine = _nodes(plan)
    if len(mine) != len(nodes):
        raise ValueError("entry has another number of nodes")
    for node, (digest, vals) in zip(mine, nodes):
        if stable_plan_fingerprint("stats", node) != digest:
            raise ValueError("entry names other nodes")
        sk = node.stats_key()
        for name, v in vals.items():
            caches[name].insert(sk, v)


# ---- the store --------------------------------------------------------------------


class StatsStore:
    """Disk-backed statistics store with a byte bound and LRU eviction.

    Layout under ``root``::

        entries/<digest>.stats   one plan's statistics, a Python literal
                                 {"format", "nodes": [(node digest,
                                 {cache: value})]}
        plan_history.jsonl       the served-plan history (service.py)

    Writes are atomic (temp file and rename); a load treats any failure
    as a miss and removes the entry. Eviction goes by mtime, and a hit
    touches its entry, so mtime is the last use."""

    def __init__(self, root: str, max_bytes: int = 1 << 30):
        self.root = os.path.abspath(root)
        self.entries_dir = os.path.join(self.root, "entries")
        self.max_bytes = int(max_bytes)
        os.makedirs(self.entries_dir, exist_ok=True)
        self._lock = locks.named_lock("compile.store")

    def _entry_path(self, digest: str) -> str:
        return os.path.join(self.entries_dir, digest + _ENTRY_SUFFIX)

    # -- read side

    def load(self, digest: str) -> Optional[dict]:
        """The stored entry, or None; an entry that cannot be read or
        parsed is counted corrupt and removed."""
        with _LOADED_LOCK:
            cached = _LOADED.get((self.root, digest))
        if cached is not None:
            return cached
        path = self._entry_path(digest)
        if not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                entry = ast.literal_eval(f.read())
            if not isinstance(entry, dict) \
                    or entry.get("format") != _FORMAT \
                    or not isinstance(entry.get("nodes"), list):
                raise ValueError("not a statistics entry")
        except Exception as e:  # noqa: BLE001 - any failure is a miss
            self.evict_corrupt(digest, e)
            return None
        try:
            os.utime(path)  # the LRU touch
        except OSError:
            pass
        with _LOADED_LOCK:
            _LOADED[(self.root, digest)] = entry
        return entry

    def evict_corrupt(self, digest: str, error: BaseException) -> None:
        """Count ``digest``'s entry corrupt and remove it (a poisoned
        entry must not wedge every later session)."""
        metrics.note_exec_store("corrupt")
        metrics.record("compile", phase="corrupt_entry", digest=digest,
                       error=repr(error))
        with _LOADED_LOCK:
            _LOADED.pop((self.root, digest), None)
        self._remove(self._entry_path(digest))

    # -- write side

    def put(self, digest: str, nodes: list) -> bool:
        """Write one plan's statistics (atomically); False when the
        write fails."""
        entry = {"format": _FORMAT, "nodes": nodes}
        path = self._entry_path(digest)
        tmp = f"{path}.tmp{os.getpid()}-{threading.get_ident()}"
        try:
            with open(tmp, "w") as f:
                f.write(repr(entry))
            os.replace(tmp, path)
        except OSError as e:
            metrics.record("compile", phase="put_failed", digest=digest,
                           error=repr(e))
            self._remove(tmp)
            return False
        with _LOADED_LOCK:
            _LOADED[(self.root, digest)] = entry
        metrics.note_exec_store("puts")
        self.enforce_budget()
        return True

    def _remove(self, path: str) -> None:
        try:
            os.unlink(path)
        except OSError:
            pass

    # -- the size bound

    def _walk_files(self):
        for dirpath, _dirnames, filenames in os.walk(self.root):
            for name in filenames:
                if name.endswith(".jsonl") or ".tmp" in name:
                    continue  # the history and writes in flight
                p = os.path.join(dirpath, name)
                try:
                    st = os.stat(p)
                except OSError:
                    continue
                yield p, st.st_size, st.st_mtime_ns

    def total_bytes(self) -> int:
        return sum(size for _p, size, _m in self._walk_files())

    def entry_count(self) -> int:
        try:
            return sum(1 for n in os.listdir(self.entries_dir)
                       if n.endswith(_ENTRY_SUFFIX))
        except OSError:
            return 0

    def enforce_budget(self) -> int:
        """Remove the least recently used files until the store fits
        ``max_bytes``; the number removed."""
        with self._lock:
            files = sorted(self._walk_files(), key=lambda t: t[2])
            total = sum(size for _p, size, _m in files)
            evicted = 0
            while total > self.max_bytes and files:
                path, size, _mtime = files.pop(0)
                self._remove(path)
                total -= size
                evicted += 1
                if path.endswith(_ENTRY_SUFFIX):
                    digest = os.path.basename(path)[:-len(_ENTRY_SUFFIX)]
                    with _LOADED_LOCK:
                        _LOADED.pop((self.root, digest), None)
        if evicted:
            metrics.note_exec_store("evictions", evicted)
            metrics.record("compile", phase="evict", count=evicted,
                           bytes_after=total)
        metrics.set_gauge("compile.store.bytes", total)
        metrics.set_gauge("compile.store.entries", self.entry_count())
        return evicted

    def stats(self) -> dict:
        with _LOADED_LOCK:
            loaded = sum(1 for (root, _d) in _LOADED if root == self.root)
        return {"root": self.root, "entries": self.entry_count(),
                "bytes": self.total_bytes(), "max_bytes": self.max_bytes,
                "loaded_in_process": loaded}



def clear_process_cache() -> None:
    """Forget the loaded entries and the content digests (tests use this
    to force the disk path, as a new process would)."""
    with _LOADED_LOCK:
        _LOADED.clear()
    with _DIGEST_LOCK:
        _DIGESTS.clear()
