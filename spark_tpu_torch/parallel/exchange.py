"""Exchange primitives: the shuffle as collectives (the port of
``spark_tpu/parallel/exchange.py``).

Everything here runs on one rank, inside a mesh stage: the calling
thread's rank, world size and communicator come from ``on_rank``
(``axis_index`` / ``axis_size``). The reference's sort-based spill files
and chunk fetches (SortShuffleManager.scala:73,
ShuffleBlockFetcherIterator.scala:86) become: bucket the live rows into
a (D, slice) send buffer by destination and ``all_to_all`` it.

**The communicator seam.** Every collective goes through a ``Comm``:

- ``ThreadComm``: the ranks of one process, one thread each. A
  ``threading.Barrier`` and one slot per rank; a rank reads the others'
  tensors and copies them to its own device with ``.to(device)`` (a
  no-op where ranks share a device, whose current stream orders the
  work). A wait has a timeout; a rank that fails aborts the barrier, so
  the others stop with ``CommAborted`` instead of waiting for it.
- ``DistComm``: one member per process over ``torch.distributed``
  (``all_to_all_single``, ``all_gather``; gloo on the CPU, NCCL on the
  card). Its route is fixed by the backend's name when it is made: on
  gloo a CUDA tensor is copied to the host, moved, and copied back
  (``route`` "host", the bytes counted in ``staged_bytes``), so two
  processes sharing one card (which NCCL refuses) run over gloo; NCCL
  and CPU tensors move directly. A collective that fails (a peer
  process died or tore the group down, or the wait passed the group's
  timeout, ``multihost.initialize``) tears the group down too and
  raises ``ProcessGroupLost``, which is terminal: a failure anywhere in
  the job stops every process within that timeout.
- ``ProcessThreadComm``: the ranks of a mesh that spans processes, k a
  process, one thread each. A process's ranks meet at a barrier, as in
  ``ThreadComm``; then its first rank makes the collective's one
  ``DistComm`` call for the tensors of all k (stacked: an all_to_all
  sends each process one block of (source thread, destination thread)
  chunks), and each rank takes its own part of the answer. No other
  thread touches the process group, so every process issues the same
  calls in the same order. Its statistics (``events``,
  ``staged_bytes``) are the ``DistComm``'s, kept once a process; a rank
  that fails aborts the barrier, and the executor tears the group down.

All give the same results for the same global ranks: chunks arrive in
global rank order, and a reduction gathers every rank's tensor and
combines them in rank order (rank 0 first), so a float ``psum``'s bits
depend on neither thread timing, the topology, nor the backend's
reduction tree.

**Capacities.** The reference's exchange is static-shaped: a rank
receives D times its capacity, the worst case. The port's ranks run
eagerly, so an exchange first all-gathers the (D, D) matrix of live rows
per (source, destination) and sizes the send slice by the largest cell
(rounded up to 128 rows, the same on every rank). The live rows and
their order are those of the reference's exchange; only the dead
padding differs. The matrix also gives each exchange's statistics: live
rows, rows moved to another rank, their bytes, and the rows and bytes
of those that cross to another process (``Comm.events``).
Adaptive execution passes the reference's measured bounds (a slice and
a receive capacity) instead, and a fused span picks its receive
capacity from the same matrix.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
from typing import Dict, List, NamedTuple, Optional, Sequence

import torch

from spark_tpu_torch import faults, locks
from spark_tpu_torch.expr.compiler import TV
from spark_tpu_torch.physical import kernels as K
from spark_tpu_torch.physical.operators import Pipe

#: seconds a rank waits at a collective for the others before the stage
#: fails (a rank that raises aborts the wait at once)
DEFAULT_TIMEOUT_S = 600.0

#: the send slice and the broadcast capacities round up to this
SLICE_BUCKET = 128


class CommAborted(RuntimeError):
    """Another rank failed (or a wait timed out) during a collective."""


class ProcessGroupLost(CommAborted):
    """A stage or a collective across processes failed, and the process
    group is torn down: terminal, never retried (a retry in one process
    would meet no peer; ``recovery.is_transient`` reads ``terminal``)."""

    terminal = True


class Comm:
    """The collectives a rank may call. ``tensors`` are lists, so one
    call moves all of a pipe's columns."""

    size: int
    #: reads of device values on the host, one per read all ranks make
    host_reads: int = 0

    def all_to_all(self, rank: int, device, tensors: List[torch.Tensor]
                   ) -> List[torch.Tensor]:
        """Each tensor's leading dimension is D * k; chunk r goes to rank
        r. Returns, per tensor, the D chunks received, in rank order,
        concatenated."""
        raise NotImplementedError

    def all_gather(self, rank: int, device, tensors: List[torch.Tensor]
                   ) -> List[List[torch.Tensor]]:
        """Per tensor, every rank's copy on ``device``, in rank order."""
        raise NotImplementedError

    def all_gather_var(self, rank: int, device,
                       tensors: List[torch.Tensor]
                       ) -> List[List[torch.Tensor]]:
        """``all_gather`` of tensors whose leading dimension may differ
        from rank to rank."""
        return self.all_gather(rank, device, tensors)

    def all_reduce(self, rank: int, device, tensor: torch.Tensor,
                   op: str) -> torch.Tensor:
        """``op`` in sum/min/max over the ranks' tensors, combined in rank
        order (rank 0 first)."""
        parts = self.all_gather(rank, device, [tensor])[0]
        out = parts[0]
        for part in parts[1:]:
            if op == "sum":
                out = out + part
            elif op == "min":
                out = torch.minimum(out, part)
            else:
                out = torch.maximum(out, part)
        return out

    def broadcast(self, rank: int, device, tensors: List[torch.Tensor],
                  src: int = 0) -> List[torch.Tensor]:
        return [parts[src] for parts in self.all_gather(rank, device,
                                                        tensors)]

    def keeps_stats(self, rank: int) -> bool:
        """Whether ``rank`` records the statistics every rank could: rank
        0 on a communicator of threads, every process's first rank on
        one that spans processes (each process keeps its own copy)."""
        return rank == 0

    def process_of(self, rank: int) -> int:
        """The process that runs ``rank``."""
        return 0

    def record(self, event: dict) -> None:
        """Keep one exchange's statistics (called by one rank)."""

    def note_host_read(self) -> None:
        """Count one read of device values on the host (called by one
        rank for the read every rank makes)."""
        self.host_reads += 1


class ThreadComm(Comm):
    """The ranks of one process, one thread each (see the module
    docstring)."""

    def __init__(self, size: int, timeout: float = DEFAULT_TIMEOUT_S):
        self.size = size
        self.timeout = timeout
        self._barrier = threading.Barrier(size)
        self._slots: list = [None] * size
        self._lock = locks.named_lock("exchange.thread_comm")
        #: one dict per exchange run on this communicator
        self.events: List[dict] = []

    def abort(self) -> None:
        self._barrier.abort()

    def _wait(self) -> None:
        try:
            self._barrier.wait(self.timeout)
        except threading.BrokenBarrierError:
            raise CommAborted("a collective was aborted: another rank "
                              "failed or a wait timed out") from None

    def _swap(self, rank: int, value) -> list:
        """Publish ``value``, wait for every rank's, read them all, and
        wait again so no slot is overwritten before all have read."""
        if self.size == 1:
            return [value]
        self._slots[rank] = value
        self._wait()
        got = list(self._slots)
        self._wait()
        return got

    def all_to_all(self, rank, device, tensors):
        got = self._swap(rank, tensors)
        out = []
        for j, t in enumerate(tensors):
            k = t.shape[0] // self.size
            parts = [got[s][j][rank * k:(rank + 1) * k].to(device)
                     for s in range(self.size)]
            out.append(parts[0] if self.size == 1 else torch.cat(parts))
        return out

    def all_gather(self, rank, device, tensors):
        got = self._swap(rank, tensors)
        return [[got[s][j].to(device) for s in range(self.size)]
                for j in range(len(tensors))]

    def record(self, event: dict) -> None:
        with self._lock:
            self.events.append(event)


def _wire(t: torch.Tensor) -> torch.Tensor:
    # gloo and NCCL move no bool tensors: bytes on the wire
    return t.to(torch.uint8) if t.dtype == torch.bool else t


class DistComm(Comm):
    """One rank per process over an initialized ``torch.distributed``
    process group (``multihost.initialize``); see the module docstring
    for its route and its failures."""

    def __init__(self, group=None):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise ProcessGroupLost("the process group was torn down after "
                                   "a failed stage")
        self._dist = dist
        self.group = group
        self.size = dist.get_world_size(group)
        self.backend = str(dist.get_backend(group))
        #: "host" (gloo: CUDA tensors staged through host copies) or
        #: "device"
        self.route = "host" if self.backend == "gloo" else "device"
        #: bytes copied between the card and the host for the route
        self.staged_bytes = 0
        self.events: List[dict] = []

    def _call(self, fn, *args):
        if not self._dist.is_initialized():
            raise ProcessGroupLost("the process group was torn down after "
                                   "a failed stage")
        try:
            return fn(*args, group=self.group)
        except RuntimeError as e:
            self.abort()
            raise ProcessGroupLost(
                f"a collective across processes failed (a peer failed, or "
                f"the wait passed the group's timeout): {e}") from None

    def _send(self, t: torch.Tensor) -> torch.Tensor:
        w = _wire(t).contiguous()
        if self.route == "host":
            if w.is_cuda:
                self.staged_bytes += w.numel() * w.element_size()
                w = w.cpu()
        elif not w.is_cuda:
            w = w.cuda()  # NCCL moves CUDA tensors only
        return w

    def _recv(self, w: torch.Tensor, like: torch.Tensor,
              device=None) -> torch.Tensor:
        dev = torch.device(device) if device is not None else like.device
        if w.device != dev:
            if dev.type == "cuda":
                self.staged_bytes += w.numel() * w.element_size()
            w = w.to(dev)
        return w.to(like.dtype)

    def all_to_all(self, rank, device, tensors):
        out = []
        for t in tensors:
            src = self._send(t)
            dst = torch.empty_like(src)
            self._call(self._dist.all_to_all_single, dst, src)
            out.append(self._recv(dst, t, device))
        return out

    def all_gather(self, rank, device, tensors):
        out = []
        for t in tensors:
            src = self._send(t)
            parts = [torch.empty_like(src) for _ in range(self.size)]
            self._call(self._dist.all_gather, parts, src)
            out.append([self._recv(p, t, device) for p in parts])
        return out

    def all_gather_var(self, rank: int, device,
                       tensors: List[torch.Tensor]
                       ) -> List[List[torch.Tensor]]:
        """``all_gather`` of tensors whose leading dimension differs from
        rank to rank: the sizes first, then every tensor padded to the
        largest (``all_gather`` moves equal shapes only) and cut back."""
        sizes = torch.tensor([t.shape[0] for t in tensors],
                             dtype=torch.int64)
        rows = torch.stack(self.all_gather(rank, "cpu", [sizes])[0]) \
            .tolist()
        out = []
        for j, t in enumerate(tensors):
            m = max(r[j] for r in rows)
            if t.shape[0] < m:
                t = torch.cat([t, t.new_zeros((m - t.shape[0],)
                                              + tuple(t.shape[1:]))])
            parts = self.all_gather(rank, device, [t])[0]
            out.append([p[:r[j]] for p, r in zip(parts, rows)])
        return out

    def gather_objects(self, obj) -> list:
        """Every process's picklable ``obj``, in rank order."""
        got: list = [None] * self.size
        self._call(self._dist.all_gather_object, got, obj)
        return got

    def keeps_stats(self, rank: int) -> bool:
        return True

    def process_of(self, rank: int) -> int:
        return rank

    def abort(self) -> None:
        """Tear the process group down: every peer's pending or next
        collective fails (``ProcessGroupLost``) instead of waiting out
        the timeout."""
        if self._dist.is_initialized():
            self._dist.destroy_process_group(self.group)

    def record(self, event: dict) -> None:
        self.events.append(event)


class ProcessThreadComm(Comm):
    """The ranks of a mesh that spans processes, k a process, each a
    thread (see the module docstring). ``size`` is every process's
    ranks; this process runs ``local``, which are consecutive (process
    p runs ranks p*k .. p*k+k-1, ``mesh.make_process_mesh``)."""

    def __init__(self, local: Sequence[int], size: int, dist: DistComm,
                 timeout: float = DEFAULT_TIMEOUT_S):
        self.local = tuple(local)
        self.k = len(self.local)
        self.size = size
        self.dist = dist
        self.timeout = timeout
        self._barrier = threading.Barrier(self.k)
        self._slots: list = [None] * self.k
        self._out: list = []

    @property
    def events(self) -> List[dict]:
        return self.dist.events

    @property
    def staged_bytes(self) -> int:
        return self.dist.staged_bytes

    def abort(self) -> None:
        """Stop this process's ranks' collectives (``CommAborted``); the
        executor then tears the process group down."""
        self._barrier.abort()

    def _wait(self, timeout: Optional[float]) -> None:
        try:
            self._barrier.wait(timeout)
        except threading.BrokenBarrierError:
            raise CommAborted("a collective was aborted: another rank "
                              "failed or a wait timed out") from None

    def _meet(self, rank: int, value, across) -> list:
        """Publish ``value``; once every local rank has, the first one
        calls ``across(values)`` (the one call over the process group;
        it returns one result per local rank), and each rank returns its
        own. The wait for the first rank's call has no timeout of its
        own: the process group's bounds the call, and a failure aborts
        the wait."""
        i = rank - self.local[0]
        self._slots[i] = value
        self._wait(self.timeout)
        if i == 0:
            try:
                self._out = across(list(self._slots))
            except BaseException:
                self._barrier.abort()
                raise
        self._wait(None)
        return self._out[i]

    def all_to_all(self, rank, device, tensors):
        def across(vals):
            k, w = self.k, self.size // self.k
            home = vals[0][0]
            sent, shapes = [], []
            for j in range(len(tensors)):
                x = _stack([v[1][j] for v in vals], home)
                c = x.shape[1] // self.size
                rest = tuple(x.shape[2:])
                shapes.append((c, rest))
                # (source thread, destination process, destination
                # thread, c) -> destination process first
                sent.append(x.reshape((k, w, k, c) + rest).transpose(0, 1)
                            .reshape((w * k * k * c,) + rest))
            got = self.dist.all_to_all(self.local[0], home, sent)
            # from each source process: (source thread, destination
            # thread, c); a thread's chunks in global source order
            return [[g.reshape((w, k, k, c) + rest)[:, :, i]
                     .reshape((self.size * c,) + rest)
                     for g, (c, rest) in zip(got, shapes)]
                    for i in range(k)]

        got = self._meet(rank, (torch.device(device), tensors), across)
        return [t.to(device) for t in got]

    def all_gather(self, rank, device, tensors):
        def across(vals):
            home = vals[0][0]
            got = self.dist.all_gather(
                self.local[0], home,
                [_stack([v[1][j] for v in vals], home)
                 for j in range(len(tensors))])
            flat = [[part[i] for part in parts for i in range(self.k)]
                    for parts in got]
            return [flat] * self.k

        got = self._meet(rank, (torch.device(device), tensors), across)
        return [[t.to(device) for t in parts] for parts in got]

    def all_gather_var(self, rank, device, tensors):
        def across(vals):
            home = vals[0][0]
            sizes = torch.tensor([[t.shape[0] for t in v[1]] for v in vals],
                                 dtype=torch.int64)
            cat = [torch.cat([v[1][j].to(home) for v in vals])
                   for j in range(len(tensors))]
            got = self.dist.all_gather_var(self.local[0], home,
                                           [sizes.to(home)] + cat)
            rows = [s.tolist() for s in got[0]]
            flat = []
            for j, parts in enumerate(got[1:]):
                flat.append([t for part, r in zip(parts, rows)
                             for t in part.split([x[j] for x in r])])
            return [flat] * self.k

        got = self._meet(rank, (torch.device(device), tensors), across)
        return [[t.to(device) for t in parts] for parts in got]

    def keeps_stats(self, rank: int) -> bool:
        return rank == self.local[0]

    def process_of(self, rank: int) -> int:
        return rank // self.k

    def record(self, event: dict) -> None:
        self.dist.record(event)


def _stack(ts: List[torch.Tensor], device) -> torch.Tensor:
    """``ts`` stacked on ``device`` (one tensor: a view)."""
    if len(ts) == 1:
        return ts[0].to(device).unsqueeze(0)
    return torch.stack([t.to(device) for t in ts])


# ---- the calling rank -------------------------------------------------------


class RankContext(NamedTuple):
    rank: int
    comm: Comm
    device: torch.device


_RANK: contextvars.ContextVar[Optional[RankContext]] = \
    contextvars.ContextVar("mesh_rank", default=None)


@contextlib.contextmanager
def on_rank(rank: int, comm: Comm, device):
    """Run the block as rank ``rank`` of ``comm`` on ``device``."""
    token = _RANK.set(RankContext(rank, comm, torch.device(device)))
    try:
        yield
    finally:
        _RANK.reset(token)


def current() -> RankContext:
    ctx = _RANK.get()
    if ctx is None:
        raise RuntimeError("a mesh collective outside a mesh stage")
    return ctx


def axis_index() -> int:
    """The calling rank."""
    return current().rank


def axis_size() -> int:
    """The number of ranks."""
    return current().comm.size


def note_host_read() -> None:
    """Count a read of device values on the host that every rank makes
    (rank 0 counts it once for the stage; across processes, each
    process for its own record)."""
    ctx = current()
    if ctx.comm.keeps_stats(ctx.rank):
        ctx.comm.note_host_read()


# ---- row routing ------------------------------------------------------------

_NULL_CODE = K._signed64(0xA5A5A5A5A5A5A5A5)


def hash_rows(tvs: Sequence[TV]) -> torch.Tensor:
    """The reference's full-width row hash of the key columns, one uint64
    per row held in int64 bits (B9): dictionary codes hash directly (the
    shards of a relation share its dictionary), floats by their float64
    bits with -0.0 as 0.0, NULL as a fixed sentinel (null keys collide
    and co-locate)."""
    cap = int(tvs[0].data.shape[0]) if tvs else 0
    dev = tvs[0].data.device if tvs else None
    h = torch.zeros((cap,), dtype=torch.int64, device=dev)
    for tv in tvs:
        code = K.key_int64(tv.data)
        if tv.validity is not None:
            code = torch.where(tv.validity, code,
                               torch.full((), _NULL_CODE, dtype=torch.int64,
                                          device=code.device))
        h = K.hash_combine(h, code)
    return h


def _umod(h: torch.Tensor, d: int) -> torch.Tensor:
    """``h mod d`` of the uint64 whose bits int64 ``h`` holds."""
    r = torch.remainder(h, d)
    return torch.where(h < 0, torch.remainder(r + (1 << 64) % d, d), r)


def hash_target(tvs: Sequence[TV], mask: torch.Tensor, d: int
                ) -> torch.Tensor:
    """Destination rank per row: the row hash mod D (HashPartitioning,
    reference: ShuffleExchangeExec.scala:275)."""
    if not tvs:
        return torch.zeros(mask.shape, dtype=torch.int64, device=mask.device)
    return _umod(hash_rows(tvs), d)


def range_target(key: TV, ascending: bool, nulls_first: bool, d: int,
                 mask: torch.Tensor, samples_per_device: int = 128
                 ) -> torch.Tensor:
    """Destination rank per row for range partitioning: each rank samples
    its sorted keys, the samples are all-gathered, and every rank cuts
    the same D-1 splitters (reference: RangePartitioner's sketch job,
    here one collective)."""
    y = K.orderable_int64(key.data, key.validity, ascending, nulls_first)
    cap = int(mask.shape[0])
    ys = torch.sort(torch.where(mask, y, torch.full(
        (), K.INT64_MAX, dtype=torch.int64, device=y.device))).values
    s = min(samples_per_device, cap)
    idx = (torch.arange(s, device=y.device) * cap) // s
    ctx = current()
    parts = ctx.comm.all_gather(ctx.rank, ctx.device, [ys[idx]])[0]
    all_samples = torch.sort(torch.cat(parts)).values
    total = int(all_samples.shape[0])
    cut = (torch.arange(1, d, device=y.device) * total) // d
    return K.searchsorted(all_samples[cut], y, side="right")


def fan_local(target: torch.Tensor, hot: Sequence[int]) -> torch.Tensor:
    """Rows bound for a hot destination stay on their own rank (the
    local-shuffle-reader move of the reference's skew fan)."""
    hot_mask = torch.zeros(target.shape, dtype=torch.bool,
                           device=target.device)
    for h in hot:
        hot_mask = hot_mask | (target == int(h))
    return torch.where(hot_mask, torch.full_like(target, axis_index()),
                       target)


# ---- the collective exchange ------------------------------------------------


def _row_bytes(pipe: Pipe) -> int:
    """Bytes one row of ``pipe`` moves: every column's data (an array's
    full width), validity and lengths, and the mask."""
    total = 1
    for tv in pipe.cols.values():
        total += tv.data.element_size() * max(1, tv.data[:1].numel())
        total += 0 if tv.validity is None else 1
        total += 0 if tv.lengths is None else 4
    return total


def _tensors(pipe: Pipe) -> list:
    out = [pipe.mask]
    for name in pipe.order:
        tv = pipe.cols[name]
        out.append(tv.data)
        if tv.validity is not None:
            out.append(tv.validity)
        if tv.lengths is not None:
            out.append(tv.lengths)
    return out


def _rebuild(pipe: Pipe, moved: list) -> Pipe:
    it = iter(moved)
    mask = next(it)
    cols: Dict[str, TV] = {}
    for name in pipe.order:
        tv = pipe.cols[name]
        data = next(it)
        validity = None if tv.validity is None else next(it)
        lengths = None if tv.lengths is None else next(it)
        cols[name] = TV(data, validity, tv.dtype, tv.dictionary, lengths)
    return Pipe(cols, mask, pipe.order)


def exchange(pipe: Pipe, target: torch.Tensor, op: str = "hash",
             slice_capacity: Optional[int] = None,
             out_capacity=None) -> Pipe:
    """Route each live row to rank ``target[row]``: sort by destination
    (stable), scatter into a (D, slice) send buffer, all_to_all, flatten.
    The slice is the largest (source, destination) live count of the
    all-gathered count matrix, so every rank agrees on it; a rank
    receives D slices, rank 0's first, each with its live rows first in
    their source order.

    Adaptive execution passes measured bounds (the reference's
    ``slice_capacity``/``out_capacity``): the send slice is
    ``slice_capacity`` rows, and the received rows compact to
    ``out_capacity`` slots, live rows first in the same order.
    ``out_capacity`` may be a function of the incoming live counts per
    destination (a fused span picks its capacity rung from this one
    count read). A bound below the measured counts raises: it would drop
    live rows.

    The fault point ``exchange.all_to_all`` fires on each rank's arrival
    (an nth spec on the first rank to arrive; the collectives abort and
    the stage re-raises the typed fault)."""
    faults.inject("exchange.all_to_all")
    ctx = current()
    d, dev, cap = ctx.comm.size, ctx.device, pipe.capacity
    live = pipe.mask
    t = torch.where(live, target.to(torch.int64).clamp(0, d - 1),
                    torch.full((), d, dtype=torch.int64, device=dev))
    counts = torch.bincount(t, minlength=d + 1)[:d]
    matrix = torch.stack(ctx.comm.all_gather(ctx.rank, dev, [counts])[0])
    rows = matrix.tolist()  # host sync: the slice size
    note_host_read()
    need = max(max(r) for r in rows)
    if slice_capacity is None:
        scap = K.bucket(need, SLICE_BUCKET)
    elif need > int(slice_capacity):
        raise RuntimeError(f"exchange slice capacity {slice_capacity} "
                           f"below the measured largest slice {need}")
    else:
        scap = int(slice_capacity)
    incoming = [sum(r[j] for r in rows) for j in range(d)]
    ocap = out_capacity(incoming) if callable(out_capacity) \
        else out_capacity
    if ocap is not None and ocap < max(incoming):
        raise RuntimeError(f"exchange out capacity {ocap} below the "
                           f"measured largest incoming {max(incoming)}")
    if ctx.comm.keeps_stats(ctx.rank):
        moved = sum(n for s, r in enumerate(rows) for j, n in enumerate(r)
                    if j != s)
        cross = sum(n for s, r in enumerate(rows) for j, n in enumerate(r)
                    if ctx.comm.process_of(j) != ctx.comm.process_of(s))
        ctx.comm.record({"op": op, "ranks": d,
                         "rows": sum(map(sum, rows)), "moved_rows": moved,
                         "moved_bytes": moved * _row_bytes(pipe),
                         "cross_rows": cross,
                         "cross_bytes": cross * _row_bytes(pipe),
                         "capacity_in": cap,
                         "capacity_out": d * scap if ocap is None
                         else min(d * scap, int(ocap))})
    order = torch.argsort(t, stable=True)
    st = t[order]
    starts = torch.searchsorted(st, torch.arange(d, device=dev))
    pos = torch.arange(cap, device=dev) - starts[st.clamp(0, d - 1)]
    # dead rows go to one dump slot past the buffer, cut off before
    # sending
    dest = torch.where(st < d, st * scap + pos,
                       torch.full((), d * scap, dtype=torch.int64,
                                  device=dev))

    def route(x: torch.Tensor) -> torch.Tensor:
        buf = x.new_zeros((d * scap + 1,) + tuple(x.shape[1:]))
        buf[dest] = x[order]
        return buf[:d * scap]

    sent = [route(x) for x in _tensors(pipe)]
    out = _rebuild(pipe, ctx.comm.all_to_all(ctx.rank, dev, sent))
    if ocap is not None and int(ocap) < d * scap:
        out = compact(out, int(ocap))
    return out


def compact(pipe: Pipe, new_capacity: int) -> Pipe:
    """Live rows to the front (order kept), cut to ``new_capacity``
    slots, which must hold every live row."""
    perm = K.compaction_permutation(pipe.mask)[:int(new_capacity)]
    return _rebuild(pipe, [x[perm] for x in _tensors(pipe)])


def broadcast_gather(pipe: Pipe) -> Pipe:
    """Every rank's rows on every rank, rank 0's first (the broadcast
    exchange's data plane, reference: BroadcastExchangeExec.scala:78)."""
    ctx = current()
    d = ctx.comm.size
    parts = ctx.comm.all_gather(ctx.rank, ctx.device, _tensors(pipe))
    if ctx.comm.keeps_stats(ctx.rank):
        lives = torch.stack([m.sum() for m in parts[0]]).tolist()  # sync
        ctx.comm.note_host_read()
        # the ranks of other processes each rank's rows reach
        away = [sum(ctx.comm.process_of(j) != ctx.comm.process_of(s)
                    for j in range(d)) for s in range(d)]
        live = int(sum(lives))
        ctx.comm.record({"op": "broadcast", "ranks": d, "rows": live,
                         "moved_rows": live * (d - 1),
                         "moved_bytes": d * (d - 1) * pipe.capacity
                         * _row_bytes(pipe),
                         "cross_rows": sum(n * a for n, a in zip(lives,
                                                                 away)),
                         "cross_bytes": sum(away) * pipe.capacity
                         * _row_bytes(pipe),
                         "capacity_in": pipe.capacity,
                         "capacity_out": pipe.capacity * d})
    return _rebuild(pipe, [p[0] if len(p) == 1 else torch.cat(p)
                           for p in parts])


def to_single_partition(pipe: Pipe) -> Pipe:
    """Every row on rank 0, in rank order (SinglePartition, reference:
    ShuffleExchangeExec.scala:301): the gather, masked off elsewhere."""
    g = broadcast_gather(pipe)
    if axis_index() != 0:
        g = Pipe(g.cols, torch.zeros_like(g.mask), g.order)
    return g


# ---- merged (cross-rank) reductions -----------------------------------------


def _reduce(x: torch.Tensor, op: str) -> torch.Tensor:
    ctx = current()
    return ctx.comm.all_reduce(ctx.rank, ctx.device, x, op)


def psum(x: torch.Tensor) -> torch.Tensor:
    return _reduce(x, "sum")


def pmin(x: torch.Tensor) -> torch.Tensor:
    return _reduce(x, "min")


def pmax(x: torch.Tensor) -> torch.Tensor:
    return _reduce(x, "max")


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` concatenated in rank order (tiled)."""
    ctx = current()
    parts = ctx.comm.all_gather(ctx.rank, ctx.device, [x])[0]
    return torch.cat(parts)
