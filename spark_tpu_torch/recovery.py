"""Recovery: the OOM degradation ladder, stage retry and durable
checkpoints (the part of ``spark_tpu/recovery.py`` the out-of-memory
tier needs).

- ``run_plan_with_oom_degradation``: a plan whose scans exceed the
  device budget runs chunked (``physical/chunked.py``); a resident run
  that dies of a device OOM replans through the chunked tier at a halved
  ``spark.tpu.maxDeviceBatchBytes`` (on a shadow of the session's
  settings), halving again on a repeated OOM down to
  ``spark.tpu.oomDegrade.floorBytes`` (reference analogue:
  TungstenAggregationIterator.scala:82's fallback under memory
  pressure). It replans only on an OOM, never moves work to the CPU,
  and re-raises every other error.
- ``run_stage_with_recovery``: re-runs a query thunk on a transient
  environment failure, recomputing from the logical plan (reference:
  DAGScheduler.scala:1762 stage resubmission).
- ``checkpoint_dataframe``: Parquet under ``spark.checkpoint.dir`` and a
  DataFrame over the files, lineage truncated (reference:
  ReliableCheckpointRDD).

On torch, the caching allocator frees its cached blocks and retries
before it raises ``torch.cuda.OutOfMemoryError``, so an OOM that reaches
the ladder is real. The graph pool's memory is not freed by
``empty_cache()``: before its first replan the ladder drops the captured
stages (``graphs.drop_stages``) and then empties the allocator's cache.

The ladder's rung 0 (reference: ``spark_tpu/recovery.py:476-512``): on a
mesh session whose run ran out of memory with adaptive execution off,
the run is retried once with ``parallel/executor.FORCE_ADAPTIVE`` set
(measured post-exchange capacities shrink the receive buffers an
exchange-heavy plan runs out on, with the same rows), before the
chunked replans.

Waiting for later slices (ROADMAP A12): planned chunking from measured
bytes and the admission feedback; the shared retry budget, deadlines,
fault injection, trace spans and the heartbeat monitor.
"""

from __future__ import annotations

import os
import threading
import time
import uuid
from typing import Any, Callable, Dict, Iterator, Optional

from spark_tpu_torch import conf as CF

STAGE_MAX_ATTEMPTS = CF.register(
    "spark.stage.maxConsecutiveAttempts", 4,
    "Attempts for a query whose failure looks transient (reference: "
    "config/package.scala STAGE_MAX_CONSECUTIVE_ATTEMPTS).", int)

CHECKPOINT_DIR = CF.register(
    "spark.checkpoint.dir", "",
    "Durable checkpoint directory for DataFrame.checkpoint() (reference: "
    "SparkContext.setCheckpointDir).", str)

OOM_DEGRADE_ENABLED = CF.register(
    "spark.tpu.oomDegrade.enabled", True,
    "A resident run that dies of a device OOM replans through the "
    "chunked out-of-memory tier at a halved spark.tpu.maxDeviceBatchBytes "
    "(halving again on a repeated OOM) instead of failing.", bool)

OOM_DEGRADE_FLOOR = CF.register(
    "spark.tpu.oomDegrade.floorBytes", 1 << 20,
    "The smallest device-batch budget the OOM ladder tries before it "
    "surfaces the OOM. Default: the reference's.", int)

# fragments of error messages that say the environment failed (a peer
# went away, a deadline passed), not that the query is wrong: only these
# are retried
_TRANSIENT_MARKERS = (
    "DEADLINE_EXCEEDED",
    "UNAVAILABLE",
    "ABORTED",
    "connection reset",
    "Connection reset",
    "socket closed",
    "device or resource busy",
)

# exception types that are transient whatever their message says
_TRANSIENT_TYPES = (
    ConnectionResetError,
    ConnectionAbortedError,
    BrokenPipeError,
    TimeoutError,
)

# the caching allocator's message when it cannot serve an allocation
_OOM_MARKER = "CUDA out of memory"

#: the record of the newest ladder run: replans, the budgets tried, the
#: captured stages dropped and whether the allocator's cache was emptied
last_ladder: Dict[str, Any] = {}


def _oom_types() -> tuple:
    import torch

    oom = getattr(torch.cuda, "OutOfMemoryError", None)
    return (MemoryError,) if oom is None else (MemoryError, oom)


def _chain(exc: BaseException) -> Iterator[BaseException]:
    """The exception and its ``__cause__``/``__context__`` chain."""
    seen = set()
    node: Optional[BaseException] = exc
    while node is not None and id(node) not in seen:
        seen.add(id(node))
        yield node
        if node.__cause__ is not None:
            node = node.__cause__
        elif not node.__suppress_context__:
            node = node.__context__
        else:
            node = None


def is_oom(exc: BaseException) -> bool:
    """Memory exhaustion anywhere in the cause chain:
    ``torch.cuda.OutOfMemoryError``, ``MemoryError`` or the allocator's
    "CUDA out of memory" text, and nothing else. An OOM is never
    transient: rerunning the same plan would exhaust the same memory."""
    types = _oom_types()
    for e in _chain(exc):
        if isinstance(e, types) or _OOM_MARKER in str(e):
            return True
    return False


def is_transient(exc: BaseException) -> bool:
    """True when the failure looks like the environment's and rerunning
    the same plan can succeed: a transient type or message anywhere in
    the cause chain, and no OOM in it."""
    if is_oom(exc):
        return False
    for e in _chain(exc):
        if isinstance(e, _TRANSIENT_TYPES):
            return True
        msg = str(e)
        if any(m in msg for m in _TRANSIENT_MARKERS):
            return True
    return False


def _release_device_memory(device) -> Dict[str, Any]:
    """Before the ladder's first replan: drop the captured stages (the
    graph pool survives ``empty_cache``) and empty the allocator's
    cache on a CUDA device."""
    import torch

    from spark_tpu_torch.physical import graphs

    dropped = graphs.drop_stages()
    emptied = False
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
        emptied = True
    return {"stages_dropped": dropped, "cache_emptied": emptied}


def run_plan_with_oom_degradation(lp, conf, run_fn, device="cuda",
                                  manager=None, mesh=None):
    """Run an optimized logical plan with the degradation ladder: a plan
    whose scans exceed the device budget runs chunked; a run that dies of
    an OOM on a mesh (``mesh``: the session's mesh executor) with
    adaptive execution off is retried once with it forced on (rung 0);
    then the plan replans through ``find_chunkable``/``execute_chunked``
    at a halved budget, down to the floor. Every replan counts in
    ``last_ladder`` and chains the OOM that caused it as ``__cause__``.
    ``run_fn(plan) -> Batch`` is the engine."""
    from spark_tpu_torch.conf import RuntimeConf
    from spark_tpu_torch.physical.chunked import (MAX_DEVICE_BATCH_BYTES,
                                                  execute_chunked,
                                                  find_chunkable)

    global last_ladder
    record: Dict[str, Any] = {"replans": 0, "adaptive_retries": 0,
                              "budgets": [],
                              "stages_dropped": 0, "cache_emptied": False,
                              "exhausted": False, "error": None}
    last_ladder = record
    try:
        found = find_chunkable(lp, conf)
        if found is not None:
            return execute_chunked(found, conf, run_fn, device, manager)
        return run_fn(lp)
    except Exception as e:  # noqa: BLE001 - re-raised unless an OOM
        if not (conf.get(OOM_DEGRADE_ENABLED) and is_oom(e)):
            raise
        last = e
    record["error"] = repr(last)
    record.update(_release_device_memory(device))

    if mesh is not None:
        # rung 0: adaptive execution, cheaper than chunking (no re-decode)
        from spark_tpu_torch.parallel import executor as mex

        if not (mex.FORCE_ADAPTIVE.get()
                or bool(conf.get(mex.ADAPTIVE_ENABLED))):
            record["replans"] += 1
            record["adaptive_retries"] += 1
            token = mex.FORCE_ADAPTIVE.set(True)
            try:
                return run_fn(lp)
            except Exception as e2:  # noqa: BLE001 - re-raised unless OOM
                if not is_oom(e2):
                    raise
                if e2.__cause__ is None and e2 is not last:
                    e2.__cause__ = last
                last = e2  # compaction was not enough: chunk
            finally:
                mex.FORCE_ADAPTIVE.reset(token)

    budget = int(conf.get(MAX_DEVICE_BATCH_BYTES))
    floor = max(1, int(conf.get(OOM_DEGRADE_FLOOR)))
    # a shadow of the settings: the shrinking budget must not leak into
    # the session (its next query starts from the configured budget)
    shadow = RuntimeConf(dict(conf._overrides))
    attempted = False
    while budget // 2 >= floor:
        budget //= 2
        shadow.set(MAX_DEVICE_BATCH_BYTES.key, budget)
        found = find_chunkable(lp, shadow)
        if found is None:
            continue  # still under the halved budget: halve again
        attempted = True
        record["replans"] += 1
        record["budgets"].append(budget)
        try:
            return execute_chunked(found, shadow, run_fn, device, manager)
        except Exception as e2:  # noqa: BLE001 - re-raised unless an OOM
            if not is_oom(e2):
                raise
            if e2.__cause__ is None and e2 is not last:
                e2.__cause__ = last  # the replan history rides the chain
            last = e2
    record["exhausted"] = True
    if not attempted:
        # no budget made the plan chunkable (no file scan to stream):
        # the ladder has nothing to offer, so the original OOM surfaces
        raise last
    raise RuntimeError(
        f"device OOM persisted after degrading the batch budget down to "
        f"the {floor}-byte floor (last: {last!r})") from last


def plan_chunk_first(lp, conf, budget_bytes: int):
    """A forced chunked plan: the device budget shrunk to
    ``budget_bytes`` on a shadow of the settings, so ``find_chunkable``
    fires even for a plan that fits; ``(found, shadow_conf)`` for
    ``execute_chunked``, or ``(None, None)`` when the plan has no
    chunkable shape."""
    from spark_tpu_torch.conf import RuntimeConf
    from spark_tpu_torch.physical.chunked import (MAX_DEVICE_BATCH_BYTES,
                                                  find_chunkable)

    shadow = RuntimeConf(dict(conf._overrides))
    shadow.set(MAX_DEVICE_BATCH_BYTES.key, max(1, int(budget_bytes)))
    found = find_chunkable(lp, shadow)
    if found is None:
        return None, None
    return found, shadow


def run_stage_with_recovery(fn: Callable, *, conf=None,
                            label: str = "stage"):
    """Run ``fn`` (a query thunk that replans from the logical plan),
    retrying transient environment failures up to
    ``spark.stage.maxConsecutiveAttempts`` times with a capped
    exponential backoff. Anything else is raised at once."""
    attempts = int(conf.get(STAGE_MAX_ATTEMPTS)) if conf is not None \
        else STAGE_MAX_ATTEMPTS.default
    attempts = max(1, attempts)
    last: Optional[BaseException] = None
    for attempt in range(attempts):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 - re-raised unless transient
            if not is_transient(e):
                raise
            last = e
            if attempt + 1 < attempts:
                time.sleep(min(0.1 * 2 ** attempt, 2.0))
    raise RuntimeError(
        f"{label} failed {attempts} consecutive attempts "
        f"(last: {last!r})") from last


_CKPT_COUNTER = [0]
_CKPT_LOCK = threading.Lock()


def checkpoint_dataframe(df, eager: bool = True):
    """Durable checkpoint: the rows written as Parquet under
    ``spark.checkpoint.dir`` and a DataFrame scanning the files, lineage
    truncated (reference: ReliableCheckpointRDD; RDD.scala:1627)."""
    session = df.sparkSession
    d = str(session.conf.get(CHECKPOINT_DIR) or "")
    if not d:
        raise RuntimeError(
            "set spark.checkpoint.dir before calling checkpoint(); use "
            "localCheckpoint() for the in-memory variant")
    with _CKPT_LOCK:
        _CKPT_COUNTER[0] += 1
        seq = _CKPT_COUNTER[0]
    # the uuid keeps paths unique across sessions and processes
    path = os.path.join(
        d, f"ckpt-{os.getpid()}-{seq}-{uuid.uuid4().hex[:8]}")
    df.write.mode("overwrite").parquet(path)
    out = session.read.parquet(path)
    if eager:
        out.count()
    return out
