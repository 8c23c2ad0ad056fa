"""Fused stages: the card's counterpart of the reference's jitted stage.

The reference compiles each maximal traceable subtree into one XLA
program (``spark_tpu/physical/planner.py:_run_fused``, cached in
``_STAGE_CACHE`` and built by ``compile.build_stage_callable``). Here the
planner hands such a stage to ``run_stage``:

- On a CUDA device, once the plan has run before (its statistics are
  bound, so the stage holds no host sync), the stage's first execution is
  a warm-up on a side stream, whose rows are the run's result, followed by
  a CUDA graph capture of the same stage function on that stream; every
  later execution over the same leaf tensors is ``graph.replay()``, one call
  that issues every launch of the stage, the ctypes launches of the hand
  kernels included (``ops/seg_agg.py`` launches on PyTorch's current
  stream, which is the capture stream during a capture). The graph reads
  the scan batches' own tensors in place: the entry holds only weakrefs
  to them and is dropped when any dies (the reference's ``_ScanSlot``
  pins no leaf either). After each replay the outputs are cloned out of
  the graph's memory, so a result survives the next replay of its stage.
- On the CPU, and on a plan's first run, the same stage function runs
  eagerly.
- There is no fallback: a capture that fails, or a stage that syncs with
  the host inside its capture, raises.

Several threads run stages on one card at once (the query scheduler's
workers, ``scheduler/scheduler.py``). The design that keeps them apart:

- A capture runs in CUDA's thread-local capture mode
  (``capture_error_mode="thread_local"``): a sync or another unsafe
  call on the capturing thread invalidates the capture and raises, while
  other threads go on launching, allocating and syncing on their own
  streams. The allocator sends only the capture stream's allocations to
  the graph pool. The process-wide ``torch.cuda.set_sync_debug_mode``
  is not touched: set to "error" around one thread's capture, it would
  make another thread's legitimate sync raise.
- Captures are serialized by ``_CAPTURE_LOCK`` (one capture at a time in
  the process, with its warm-up), so they share the side stream and the
  pool without overlapping.
- A replay and the clones of its outputs are one step under
  ``_REPLAY_LOCK``: graphs share the pool's blocks, so another graph's
  replay enqueued between a replay and its clones would overwrite the
  outputs before they are copied out. Replays and clones go to the
  current stream; stages of different queries still run one after
  another on the card, and their host work (planning, the copies of
  results, blocking operators) overlaps.
- The kernel-wrapper calls a capture records go to the capturing
  context's list (``seg_agg.logging_calls_into``), not a module global
  another thread's launches would append to.

A run's counts (captured, replayed) are the planner's ``RunStats``,
which a scheduler worker collects per query
(``planner.recording_runs``).

Memory: every graph captures into one pool per device
(``torch.cuda.graph_pool_handle``), and replays run one at a time on the
current stream. A graph's outputs are cloned right after its replay and
nothing else reads its memory later, so graphs may share the blocks each
frees at the end of its capture; the pool then holds the largest stage's
working set and each cached graph's outputs, not the sum of every
stage's. The cache (``_StageCache``) is bounded by entries
(``spark.tpu.jit.stageCacheEntries``) and by the bytes of those outputs
(``STAGE_CACHE_BYTES``). A capture does not run
``torch.cuda.graph``'s ``gc.collect()`` and ``empty_cache()``: it calls
``capture_begin`` / ``capture_end`` itself.

Launch counts: a capture records the kernel wrappers' launches without
running them, so the wrappers do not count them (``ops/seg_agg.py``), and
a replay does not pass through the wrappers at all. What a replay ran is
read on the device: each hand kernel counts its own runs there
(``seg_agg.device_runs``). ``recording_calls`` keeps the wrapper calls a
capture records, whose tensors hold each later replay's values.

``guarding_stages`` turns on the host-traffic guard (``HostTrafficGuard``)
around every traced stage: on the CPU it proves what a capture demands on
the card, no host sync and no tensor made from host data.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
import weakref
from typing import List, Optional

import torch
from torch.overrides import TorchFunctionMode

from spark_tpu_torch import conf as CF
from spark_tpu_torch import device as D
from spark_tpu_torch import locks, metrics
from spark_tpu_torch.expr.compiler import TV
from spark_tpu_torch.ops import seg_agg
from spark_tpu_torch.physical import operators as P


#: bytes of graph outputs the stage cache keeps in the pool at most
STAGE_CACHE_BYTES = 4 << 30


class _StageCache(P._AdaptiveStatsCache):
    """Captured stages, keyed on (plan_key, adaptive snapshot) and the ids
    of the stage's leaf tensors, whose weakrefs are the pins: a dead leaf
    drops its graph. LRU beyond ``spark.tpu.jit.stageCacheEntries``
    entries (read from the running session's settings at each insert) or
    ``max_bytes`` bytes of graph outputs; an evicted stage is captured
    again at its next use."""

    def __init__(self, max_bytes: int = STAGE_CACHE_BYTES):
        super().__init__(max_bytes=max_bytes)

    @staticmethod
    def nbytes(entry) -> int:
        return entry.nbytes

    def holds_device(self, index) -> bool:
        """Whether a cached graph was captured on device ``index``."""
        with self._lock:
            return any(e.dev_index == index for e, _ in self._data.values())

    def put(self, key_and_pins, entry, conf=None) -> None:
        """Insert ``entry`` under the entry cap ``conf`` sets (None: the
        active session's)."""
        self._maxsize = max(1, CF.active_int(CF.JIT_STAGE_CACHE_ENTRIES,
                                             conf))
        self.insert(key_and_pins, entry)


_STAGE_CACHE = _StageCache()
#: per device index: the shared graph memory pool and the warm-up stream
_POOLS: dict = {}
_SIDE_STREAMS: dict = {}
#: one capture (warm-up and capture) at a time in the process
_CAPTURE_LOCK = locks.named_lock("graphs.capture")
#: a replay and the clones of its outputs, as one step
_REPLAY_LOCK = locks.named_lock("graphs.replay")

_GUARD = contextvars.ContextVar("guard_stages", default=False)
_CAPTURE = contextvars.ContextVar("capture", default=True)
#: where set, the list ``recording_calls`` yields
_RECORD_CALLS = contextvars.ContextVar("record_calls", default=None)


# ---- the host-traffic guard -------------------------------------------------

#: calls that wait for the device (or read a data-dependent size)
_SYNCS = frozenset({
    "item", "tolist", "cpu", "numpy", "__int__", "__float__", "__bool__",
    "__index__", "__complex__", "nonzero", "argwhere", "unique",
    "unique_consecutive", "masked_select", "bincount", "equal", "allclose",
    "is_nonzero"})
#: calls that make a tensor from host data
_UPLOADS = frozenset({"tensor", "as_tensor", "asarray", "new_tensor"})


def _bool_index(index) -> bool:
    if isinstance(index, tuple):
        return any(_bool_index(i) for i in index)
    return torch.is_tensor(index) and index.dtype == torch.bool


def _crosses_devices(func_name: str, args, kwargs) -> bool:
    """A ``.to``/``.cuda``/``.copy_`` between the host and a device."""
    src = args[0] if args else None
    if not torch.is_tensor(src):
        return False
    if func_name == "cuda":
        return src.device.type == "cpu"
    if func_name == "copy_":
        return len(args) > 1 and torch.is_tensor(args[1]) \
            and args[1].device.type != src.device.type
    targets = [a for a in list(args[1:]) + [kwargs.get("device")]
               if isinstance(a, (str, torch.device))]
    targets += [a.device for a in args[1:] if torch.is_tensor(a)]
    return any(torch.device(t).type != src.device.type for t in targets)


class HostTrafficError(RuntimeError):
    """A traced stage synced with the host or made a tensor from host
    data."""


class HostTrafficGuard(TorchFunctionMode):
    """Raise on every call inside a traced stage that would sync with the
    host or make a tensor from host data: ``.item()``, ``int()`` /
    ``float()`` / ``bool()`` of a tensor, ``.tolist()``, ``.cpu()``,
    ``.numpy()``, ``nonzero``, ``unique``, ``masked_select``, boolean-mask
    indexing, ``repeat_interleave`` by a tensor without ``output_size``,
    one-argument ``where``, a copy between the host and a device,
    ``torch.tensor`` / ``as_tensor`` / ``from_numpy``. Host work the card
    does not do (``device.host_side``: a copy through ``device_table``,
    a kernel wrapper's plain version on CPU tensors) passes."""

    def __init__(self):
        super().__init__()
        self._from_numpy = None

    def __enter__(self):
        real = self._from_numpy = torch.from_numpy

        def from_numpy(arr):
            if not D.is_host_side():
                raise HostTrafficError(
                    "torch.from_numpy inside a traced stage")
            return real(arr)

        torch.from_numpy = from_numpy
        return super().__enter__()

    def __exit__(self, *exc):
        torch.from_numpy = self._from_numpy
        return super().__exit__(*exc)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not D.is_host_side():
            name = getattr(func, "__name__", "")
            bad = None
            if name in _SYNCS:
                bad = "syncs with the host"
            elif name in _UPLOADS:
                bad = "makes a tensor from host data"
            elif name in ("__getitem__", "__setitem__", "index_put_") \
                    and len(args) > 1 and _bool_index(args[1]):
                bad = "indexes by a boolean mask (a host sync)"
            elif name == "repeat_interleave" and len(args) > 1 \
                    and torch.is_tensor(args[1]) and args[1].numel() > 1 \
                    and kwargs.get("output_size") is None:
                bad = "repeats by a tensor without output_size (a sync)"
            elif name == "where" and len(args) + len(kwargs) == 1:
                bad = "is one-argument where (a host sync)"
            elif name in ("to", "cuda", "copy_") \
                    and _crosses_devices(name, args, kwargs):
                bad = "copies between the host and a device"
            if bad is not None:
                raise HostTrafficError(f"{name} inside a traced stage {bad}")
        return func(*args, **kwargs)


@contextlib.contextmanager
def guarding_stages():
    """Run every traced stage in the block under ``HostTrafficGuard``."""
    token = _GUARD.set(True)
    try:
        yield
    finally:
        _GUARD.reset(token)


# ---- stage execution ------------------------------------------------------


def _run_tree(plan: P.PhysicalPlan) -> P.Pipe:
    return plan.execute([_run_tree(c) for c in plan.children()])


def _stage_fn(plan: P.PhysicalPlan) -> P.Pipe:
    if not _GUARD.get():
        return _run_tree(plan)
    with HostTrafficGuard():
        return _run_tree(plan)


def _scans(plan: P.PhysicalPlan, out: list) -> list:
    if isinstance(plan, P.BatchScanExec):
        out.append(plan)
    for c in plan.children():
        _scans(c, out)
    return out


def _stage_device(plan: P.PhysicalPlan) -> torch.device:
    """The device a stage runs on: its scans', else its ranges'."""
    for s in _scans(plan, []):
        return s.batch.data.row_mask.device
    stack = [plan]
    while stack:
        p = stack.pop()
        if isinstance(p, P.RangeExec):
            return D.resolve_device(p.device)
        stack.extend(p.children())
    return torch.device("cpu")


def _leaf_tensors(plan: P.PhysicalPlan) -> List[torch.Tensor]:
    """Every tensor the stage reads from its scans (aux scans included),
    once each."""
    out, seen = [], set()
    for s in _scans(plan, []):
        d = s.batch.data
        for t in [d.row_mask] + [x for cd in d.columns
                                 for x in (cd.data, cd.validity)]:
            if t is not None and id(t) not in seen:
                seen.add(id(t))
                out.append(t)
    return out


def _pipe_tensors(pipe: P.Pipe):
    yield pipe.mask
    for tv in pipe.cols.values():
        for t in (tv.data, tv.validity, tv.lengths):
            if t is not None:
                yield t


class _Entry:
    """A captured stage: its graph, its output (leaf tensors in it held
    by index into ``leaves``, which are weakrefs), the host tables its
    graph reads and the bytes of its outputs in the pool."""

    __slots__ = ("graph", "out", "slots", "leaves", "tables", "nbytes",
                 "capture_ms", "dev_index")

    def output(self) -> P.Pipe:
        """The replayed output, cloned out of the graph's memory (a
        tensor cloned once however many names it carries)."""
        done: dict = {}

        def take(slot):
            if slot is None:
                return None
            kind, v = slot
            if kind == "leaf":
                return self.leaves[v]()
            if id(v) not in done:
                done[id(v)] = v if kind == "table" else v.clone()
            return done[id(v)]

        cols = {name: TV(take(d), take(vd), dt, dic, take(ln))
                for name, (d, vd, dt, dic, ln) in self.slots.items()}
        return P.Pipe(cols, take(self.out), list(self.slots))


def _pool(dev: torch.device):
    """The device's graph pool. Once no cached graph of the device is
    left (``drop_stages``, or leaves that died), the pool is released
    and PyTorch's host allocator refuses to capture into it again, so
    the next capture takes a fresh pool."""
    if dev.index not in _POOLS or not _STAGE_CACHE.holds_device(dev.index):
        _POOLS[dev.index] = torch.cuda.graph_pool_handle()
    return _POOLS[dev.index]


def _side_stream(dev: torch.device) -> torch.cuda.Stream:
    if dev.index not in _SIDE_STREAMS:
        _SIDE_STREAMS[dev.index] = torch.cuda.Stream(dev)
    return _SIDE_STREAMS[dev.index]


def _capture(plan: P.PhysicalPlan, leaves: List[torch.Tensor],
             dev: torch.device):
    """Warm up the stage on a side stream (its rows are this run's
    result), then capture it. The host tables both read are collected,
    which keeps ``device_table`` from evicting one between the two.
    Returns (warm-up pipe, entry)."""
    t0 = time.perf_counter()
    main = torch.cuda.current_stream(dev)
    tables: list = []
    with _CAPTURE_LOCK:
        side = _side_stream(dev)
        side.wait_stream(main)
        with D.collecting_tables(tables), torch.cuda.stream(side):
            warm = _stage_fn(plan)
            main.wait_stream(side)
            for t in _pipe_tensors(warm):
                t.record_stream(main)

            graph = torch.cuda.CUDAGraph()
            with seg_agg.logging_calls_into(_RECORD_CALLS.get()):
                graph.capture_begin(pool=_pool(dev),
                                    capture_error_mode="thread_local")
                try:
                    out = _stage_fn(plan)
                finally:
                    graph.capture_end()

    entry = _Entry()
    entry.graph = graph
    entry.dev_index = dev.index
    entry.leaves = tuple(weakref.ref(t) for t in leaves)
    entry.tables = tables
    leaf_index = {id(t): i for i, t in enumerate(leaves)}
    table_ids = {id(t) for t in tables}
    pooled: dict = {}

    def slot(t):
        if t is None:
            return None
        if id(t) in leaf_index:
            return ("leaf", leaf_index[id(t)])
        if id(t) in table_ids:
            return ("table", t)
        pooled[id(t)] = t.nbytes
        return ("pool", t)

    entry.out = slot(out.mask)
    entry.slots = {name: (slot(out.cols[name].data),
                          slot(out.cols[name].validity),
                          out.cols[name].dtype, out.cols[name].dictionary,
                          slot(out.cols[name].lengths))
                   for name in out.order}
    entry.nbytes = sum(pooled.values())
    entry.capture_ms = (time.perf_counter() - t0) * 1e3
    return warm, entry


def run_stage(plan: P.PhysicalPlan, snapshot: tuple, capture: bool,
              run, conf=None) -> P.Pipe:
    """Run one fused stage: eagerly on the CPU or where ``capture`` is
    False, else captured at its first execution and replayed after.
    ``snapshot`` is the stage's adaptive state (planner's
    ``_adaptive_snapshot``); ``run`` collects the run's stage counts;
    ``conf`` is the session's settings (None: the active session's)."""
    run.stages += 1
    dev = _stage_device(plan)
    if dev.type != "cuda" or not capture or not _CAPTURE.get():
        return _stage_fn(plan)
    leaves = _leaf_tensors(plan)
    key = ((plan.plan_key(), snapshot, tuple(id(t) for t in leaves)),
           leaves)
    entry = _STAGE_CACHE.get(key)
    if entry is None:
        warm, entry = _capture(plan, leaves, dev)
        _STAGE_CACHE.put(key, entry, conf)
        run.captured += 1
        run.capture_ms += entry.capture_ms
        # after the capture's checked region: host-only
        metrics.record("stage_compile", node=plan.node_string(),
                       ms=round(entry.capture_ms, 2))
        return warm
    with _REPLAY_LOCK:
        entry.graph.replay()
        out = entry.output()
    run.replayed += 1
    return out


@contextlib.contextmanager
def eager_stages():
    """Run every traced stage in the block eagerly: no capture, no
    replay (the eager side of a comparison with the graphs)."""
    token = _CAPTURE.set(False)
    try:
        yield
    finally:
        _CAPTURE.reset(token)


@contextlib.contextmanager
def recording_calls():
    """While the block runs, each capture appends the kernel-wrapper
    calls its stage records (arguments and result, the tensors
    themselves) to the list this yields; the list is the only holder of
    them. After each replay of that graph those tensors hold the replay's
    values, so each call can be held against the wrapper's plain version
    on them."""
    calls: list = []
    token = _RECORD_CALLS.set(calls)
    try:
        yield calls
    finally:
        _RECORD_CALLS.reset(token)


def cached_stages() -> int:
    return len(_STAGE_CACHE)


def drop_stages() -> int:
    """Drop every captured stage (their graphs and cached outputs), so
    the graph pool's memory can be returned to the allocator; the number
    dropped. The OOM ladder calls this before its first replan."""
    return _STAGE_CACHE.clear()


def pool_bytes(dev=None) -> Optional[int]:
    """Bytes the device's graph pool reserves (None without a pool or
    where the allocator's snapshot does not name pools)."""
    dev = torch.device("cuda" if dev is None else dev)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    pool = _POOLS.get(index)
    if pool is None:
        return None
    total, named = 0, False
    for seg in torch.cuda.memory_snapshot():
        if "segment_pool_id" not in seg:
            continue
        named = True
        if tuple(seg["segment_pool_id"]) == tuple(pool) \
                and seg.get("device", index) == index:
            total += seg["total_size"]
    return total if named else None
