"""The asynchronous chunk pipeline of the out-of-memory tier (the port of
``spark_tpu/physical/pipeline.py``).

A serial chunk loop (decode a chunk, filter it on the host, copy it to
the card, compute, repeat) leaves the card idle during every decode and
copy and the host idle during every device step. Here one producer
thread pulls the next chunks off the Arrow stream, applies the host key
filters, stages each chunk in pinned host memory and copies it to the
device with ``non_blocking=True`` on a side ``torch.cuda.Stream`` of its
own, recording an event, while the caller's thread merges the previous
chunks' partials on the device (reference analogue: the in-flight
window of ShuffleBlockFetcherIterator.scala:78).

- **Order.** One producer feeding a FIFO queue, consumed in source
  order: the device merge order is the serial loop's at every depth, so
  rows (float sums included) are bit-identical at depths 0, 1 and 2.
- **Streams.** The producer waits for its own copy's event before it
  hands the chunk over, so a chunk's pinned host buffers, which the
  chunk holds, are never freed while their copy runs (and the transfer
  time is the copy's). The consumer makes its stream wait on that event
  (``wait_event``) and calls ``record_stream`` on every tensor it takes
  over, so the caching allocator never hands their memory to another
  use while the consumer's stream may still read them.
- **Bounds.** ``spark.tpu.pipelineDepth`` caps the prepared chunks in
  flight and ``spark.tpu.prefetchBytesMax`` their device bytes (the
  producer stalls before decoding the next chunk once in-flight bytes
  reach it; one chunk is always admitted, so a cap below one chunk
  degrades to serial instead of deadlocking).
- **Errors.** A producer error reaches the consumer even while the
  queue is full (a stop-aware blocking put).

- **Retry.** One chunk's decode, filter and transfer retry up to
  ``spark.tpu.chunkRetryAttempts`` times on a transient failure (each
  re-attempt drawn from the query's retry budget and capped by its
  deadline) before the error reaches the consumer; the retried chunk
  keeps its place, so chunks still arrive in source order. The fault
  points ``pipeline.decode`` and ``pipeline.transfer`` sit at the two
  steps. The producer thread re-enters the caller's trace context,
  deadline and retry budget, so its ``pipeline.decode`` and
  ``pipeline.transfer`` spans join the query's trace.

``depth == 0`` runs the serial loop on the caller's thread with the same
staging, timers and retries.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Iterable, Iterator, List, Optional

import numpy as np
import torch

from spark_tpu_torch import conf as CF
from spark_tpu_torch import deadline, faults, locks, metrics, trace
from spark_tpu_torch.columnar.batch import (Batch, BatchData, ColumnData,
                                            pad_host)
from spark_tpu_torch.metrics import PipelineStats
from spark_tpu_torch.plan import logical as L

CHUNK_RETRY_ATTEMPTS = CF.register(
    "spark.tpu.chunkRetryAttempts", 3,
    "Bounded attempts for one chunk's decode/prepare/transfer in the "
    "out-of-memory pipeline before the failure is relayed to the "
    "consumer (reference analogue: ShuffleBlockFetcherIterator retrying "
    "one block fetch instead of failing the stage).", int)

_SENTINEL = object()


# ---- staging host chunks on the device --------------------------------------


class Staged:
    """A chunk's batch copied to the device on the staging stream: the
    relation over it, the copy's event and the pinned host buffers it
    was copied from (held until the event completes)."""

    __slots__ = ("rel", "event", "pinned")

    def __init__(self, rel: L.Relation, event=None, pinned=()):
        self.rel = rel
        self.event = event
        self.pinned = list(pinned)

    @property
    def nbytes(self) -> int:
        return self.rel.batch.device_nbytes()

    def adopt(self) -> L.Relation:
        """Hand the batch to the consumer's stream: wait for the copy,
        and mark every tensor as used there."""
        if self.event is not None:
            dev = self.rel.batch.data.row_mask.device
            cur = torch.cuda.current_stream(dev)
            cur.wait_event(self.event)
            for t in _batch_tensors(self.rel.batch):
                t.record_stream(cur)
        return self.rel


def _batch_tensors(batch: Batch) -> List[torch.Tensor]:
    out = [batch.data.row_mask]
    for cd in batch.data.columns:
        out.append(cd.data)
        if cd.validity is not None:
            out.append(cd.validity)
    return out


class Stager:
    """Copies host chunks to one device: on a CUDA device from pinned
    host memory, ``non_blocking`` on a side stream of its own, each copy
    followed by an event; on the CPU a plain copy."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)

    def stage(self, schema, arrays, validities, capacity: int) -> Staged:
        datas, valids, row_mask = pad_host(schema, arrays, validities,
                                           capacity)
        if self.stream is None:
            def put(arr, np_dtype):
                return torch.from_numpy(
                    np.array(arr, dtype=np_dtype)).to(self.device)

            return Staged(L.Relation(_assemble(schema, datas, valids,
                                               row_mask, put)))
        pinned: List[torch.Tensor] = []

        def put(arr, np_dtype):
            host = torch.from_numpy(np.ascontiguousarray(
                arr, dtype=np_dtype)).pin_memory()
            pinned.append(host)
            return host.to(self.device, non_blocking=True)

        with torch.cuda.stream(self.stream):
            batch = _assemble(schema, datas, valids, row_mask, put)
            event = torch.cuda.Event()
            event.record(self.stream)
        event.synchronize()
        return Staged(L.Relation(batch), event, pinned)


def _assemble(schema, datas, valids, row_mask, put) -> Batch:
    cols = [ColumnData(put(d, f.dtype.np_dtype),
                       None if v is None else put(v, bool))
            for f, d, v in zip(schema.fields, datas, valids)]
    return Batch(schema, BatchData(tuple(cols), put(row_mask, bool)))


def adopt(prepared):
    """``prepared`` with every ``Staged`` in it (inside lists, tuples
    and dicts) handed to the consumer's stream and replaced by its
    relation."""
    if isinstance(prepared, Staged):
        return prepared.adopt()
    if isinstance(prepared, dict):
        return {k: adopt(v) for k, v in prepared.items()}
    if isinstance(prepared, (list, tuple)):
        return type(prepared)(adopt(v) for v in prepared)
    return prepared


def staged_nbytes(prepared) -> int:
    """Device bytes of every ``Staged`` in ``prepared`` (inside lists,
    tuples and dicts)."""
    if isinstance(prepared, Staged):
        return prepared.nbytes
    if isinstance(prepared, dict):
        prepared = list(prepared.values())
    if isinstance(prepared, (list, tuple)):
        return sum(staged_nbytes(v) for v in prepared)
    return 0


# ---- the pipeline -----------------------------------------------------------


class _Err:
    """A producer-side exception, re-raised on the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class ChunkPipeline:
    """Bounded producer/consumer pipeline over an iterator of work items.

    ``source`` yields raw items (Arrow tables, partition ids); pulling
    the next one is timed as *decode*. ``prepare`` turns one item into a
    consumable result (timing its own filter and transfer stages against
    ``stats``), usually holding ``Staged`` chunks, or returns None to
    skip the item. ``nbytes_of(prepared)`` feeds the in-flight byte
    budget (default: the staged device bytes). Iterating yields the
    prepared results in source order, each ``Staged`` replaced by its
    adopted relation. With ``depth >= 1`` the producer starts at
    construction, so decoding can overlap work the caller does before
    it starts consuming (the sidecars' materialization). ``conf``: the
    settings the chunk retry and the fault points read (None: the
    running session's)."""

    def __init__(self, source: Iterable[Any],
                 prepare: Callable[[Any], Optional[Any]],
                 *, depth: int, byte_budget: int, stats: PipelineStats,
                 nbytes_of: Optional[Callable[[Any], int]] = None,
                 conf=None):
        from spark_tpu_torch import recovery

        self._source = iter(source)
        self._prepare = prepare
        self._depth = max(0, int(depth))
        self._budget = max(1, int(byte_budget))
        self._stats = stats
        self._nbytes = nbytes_of or staged_nbytes
        self._conf = faults._resolve_conf(conf)
        self._retry_attempts = max(1, int(
            self._conf.get(CHUNK_RETRY_ATTEMPTS) if self._conf is not None
            else CHUNK_RETRY_ATTEMPTS.default))
        # the producer thread re-enters the caller's span context,
        # deadline and retry budget (context variables do not cross
        # threads by themselves)
        self._trace_ctx = trace.current()
        self._deadline = deadline.current()
        self._retry_budget = recovery.current_budget()
        self._thread: Optional[threading.Thread] = None
        if self._depth >= 1:
            self._queue: queue.Queue = queue.Queue(maxsize=self._depth)
            self._cond = locks.named_condition("pipeline.cond")
            self._inflight_bytes = 0
            self._inflight_chunks = 0
            self._stop = False
            self._thread = threading.Thread(
                target=self._produce, daemon=True, name="chunk-pipeline")
            self._thread.start()

    def _next_prepared(self) -> Any:
        """``(prepared, size)``, None for a skipped item, or _SENTINEL at
        the end of the source. One chunk's decode, filter and transfer
        retry up to ``spark.tpu.chunkRetryAttempts`` times on a transient
        failure before the error is relayed. A generator that raised is
        exhausted, so a decode failure retries only when it is an
        injected fault (which fires before the source is touched); once
        the item is in hand, ``prepare`` is pure and always retryable."""
        from spark_tpu_torch import recovery

        st = self._stats
        item: Any = _SENTINEL  # also "not pulled yet"
        for attempt in range(self._retry_attempts):
            try:
                if item is _SENTINEL:
                    with trace.span("pipeline.decode"), st.timed("decode"):
                        faults.inject("pipeline.decode", self._conf)
                        nxt = next(self._source, _SENTINEL)
                    if nxt is _SENTINEL:
                        return _SENTINEL
                    item = nxt
                with trace.span("pipeline.transfer"):
                    faults.inject("pipeline.transfer", self._conf)
                    prepared = self._prepare(item)
                if attempt:
                    metrics.record("fault_recovered", point="pipeline",
                                   how="chunk_retry", attempts=attempt)
                if prepared is None:
                    return None
                return prepared, self._nbytes(prepared)
            except Exception as e:  # noqa: BLE001 - re-raised unless retried
                retryable = recovery.is_transient(e) and (
                    item is not _SENTINEL
                    or isinstance(e, faults.InjectedFault))
                if not retryable or attempt + 1 >= self._retry_attempts:
                    raise
                deadline.check("pipeline.chunk")
                if not recovery.retry_allowed("pipeline.chunk"):
                    raise recovery.RetryBudgetExhausted(
                        "pipeline.chunk", recovery.current_budget()) from e
                metrics.record("chunk_retry", attempt=attempt + 1,
                               error=repr(e))
                time.sleep(deadline.cap_sleep(min(0.05 * 2 ** attempt,
                                                  0.5)))
        raise AssertionError("unreachable")  # the loop returns or raises

    # ---- serial path (depth == 0) -------------------------------------------

    def _iter_serial(self) -> Iterator[Any]:
        try:
            while True:
                got = self._next_prepared()
                if got is _SENTINEL:
                    return
                if got is None:
                    continue
                prepared, size = got
                self._stats.note_inflight(size, 1)
                yield adopt(prepared)
        finally:
            self.close()

    # ---- threaded path ------------------------------------------------------

    def _produce(self) -> None:
        from spark_tpu_torch import recovery

        with trace.attach(self._trace_ctx), \
                deadline.bind(self._deadline), \
                recovery.bind_budget(self._retry_budget):
            self._produce_traced()

    def _produce_traced(self) -> None:
        st = self._stats
        try:
            while True:
                # byte-budget gate before decoding the next chunk (one
                # chunk is always admitted)
                t0 = time.perf_counter()
                with self._cond:
                    while (not self._stop and self._inflight_chunks > 0
                           and self._inflight_bytes >= self._budget):
                        self._cond.wait(0.5)
                    if self._stop:
                        return
                waited = (time.perf_counter() - t0) * 1e3
                if waited > 0.05:
                    st.add("stall_producer", waited)
                got = self._next_prepared()
                if got is _SENTINEL:
                    break
                if got is None:
                    continue
                prepared, size = got
                with self._cond:
                    self._inflight_bytes += size
                    self._inflight_chunks += 1
                    st.note_inflight(self._inflight_bytes,
                                     self._inflight_chunks)
                self._put((prepared, size))
            self._put(_SENTINEL)
        except BaseException as e:  # noqa: BLE001 - relayed to consumer
            # a full queue is the steady state, so the error goes through
            # the stop-aware blocking put
            self._put(_Err(e))

    def _put(self, obj: Any) -> None:
        """queue.put that gives up once the consumer has stopped."""
        t0 = time.perf_counter()
        while True:
            with self._cond:
                if self._stop:
                    return
            try:
                self._queue.put(obj, timeout=0.1)
                waited = (time.perf_counter() - t0) * 1e3
                if waited > 0.1:
                    self._stats.add("stall_producer", waited)
                return
            except queue.Full:
                continue

    def _iter_threaded(self) -> Iterator[Any]:
        st = self._stats
        try:
            while True:
                t0 = time.perf_counter()
                got = self._queue.get()
                waited = (time.perf_counter() - t0) * 1e3
                if waited > 0.05:
                    st.add("stall_consumer", waited)
                if got is _SENTINEL:
                    return
                if isinstance(got, _Err):
                    raise got.exc
                prepared, size = got
                try:
                    yield adopt(prepared)
                finally:
                    with self._cond:
                        self._inflight_bytes -= size
                        self._inflight_chunks -= 1
                        self._cond.notify_all()
        finally:
            self.close()

    def __iter__(self) -> Iterator[Any]:
        if self._depth == 0:
            return self._iter_serial()
        return self._iter_threaded()

    def close(self) -> None:
        """Stop the producer (idempotent; called when the consuming
        iterator ends or is abandoned)."""
        if self._thread is None:
            return
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        # drain, so a producer blocked on put() sees _stop
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=30.0)
        self._thread = None
