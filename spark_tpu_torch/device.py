"""Device and dtype resolution for the port.

The port runs on the card unless the caller asks for the CPU: asking for
``"cuda"`` (the default everywhere) on a machine without a usable CUDA
device raises instead of falling back. Tests pass ``"cpu"`` explicitly.

Host tables (a string dictionary's predicate or re-coding table, a rank
table, the month lengths) reach the device through ``device_table``,
which copies each distinct table once per device and keeps the copy, so
a stage captured into a CUDA graph finds every table already on the card
(a copy from the host cannot be captured).
"""

from __future__ import annotations

import contextlib
import contextvars
import hashlib
import threading
from collections import OrderedDict

import numpy as np
import torch

DEFAULT_DEVICE = "cuda"

_NP_TO_TORCH = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def resolve_device(name=DEFAULT_DEVICE) -> torch.device:
    """``"cuda"`` or ``"cpu"`` (or a torch.device) -> torch.device.
    Raises when CUDA is asked for and unavailable."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; ask for device('cpu') to run on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r}: use 'cuda' or 'cpu'")
    return dev


def torch_dtype(np_dtype) -> torch.dtype:
    """numpy dtype (or engine DataType's ``np_dtype``) -> torch dtype."""
    return _NP_TO_TORCH[np.dtype(np_dtype)]


#: distinct host tables kept on their devices, oldest use first, at
#: most TABLE_BYTES of them beyond the newest and those the active
#: ``collecting_tables`` block holds (a captured stage holds the tables
#: its graph reads itself, so an eviction never frees one under a graph)
_TABLES: "OrderedDict[tuple, torch.Tensor]" = OrderedDict()
_TABLES_LOCK = threading.Lock()
TABLE_BYTES = 1 << 28

#: True while host work runs that the card does not do (a copy through
#: ``device_table``, a kernel wrapper's plain version on CPU tensors):
#: the host-traffic guard (``physical/graphs.py``) lets it pass
_HOST_SIDE = contextvars.ContextVar("host_side", default=False)

#: where set, a list that collects every table ``device_table`` hands out
#: (a captured stage keeps the tables its graph reads)
_TABLE_USERS = contextvars.ContextVar("table_users", default=None)


@contextlib.contextmanager
def host_side():
    """Mark the block as host work the card does not do."""
    token = _HOST_SIDE.set(True)
    try:
        yield
    finally:
        _HOST_SIDE.reset(token)


def is_host_side() -> bool:
    return _HOST_SIDE.get()


def device_table(table, device) -> torch.Tensor:
    """The host array ``table`` as a tensor on ``device``: copied at its
    first use on that device, the same tensor after. While a CUDA stream
    is capturing, a table not copied before raises."""
    arr = np.ascontiguousarray(table)
    dev = torch.device(device)
    key = (dev, arr.dtype.str, arr.shape,
           hashlib.blake2b(arr.tobytes(), digest_size=16).digest())
    with _TABLES_LOCK:
        hit = _TABLES.get(key)
        if hit is not None:
            _TABLES.move_to_end(key)
    users = _TABLE_USERS.get()
    if hit is None:
        if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"host table {arr.dtype}{list(arr.shape)} was not copied to "
                f"{dev} before the stage's capture")
        with host_side():
            hit = torch.from_numpy(arr.copy()).to(dev)
        held = {id(t) for t in users or ()}
        with _TABLES_LOCK:
            _TABLES[key] = hit
            total = sum(t.nbytes for t in _TABLES.values())
            for k in list(_TABLES):
                if total <= TABLE_BYTES:
                    break
                if k != key and id(_TABLES[k]) not in held:
                    total -= _TABLES.pop(k).nbytes
    if users is not None:
        users.append(hit)
    return hit


@contextlib.contextmanager
def collecting_tables(into: list):
    """Collect into ``into`` every table ``device_table`` hands out in
    the block."""
    token = _TABLE_USERS.set(into)
    try:
        yield into
    finally:
        _TABLE_USERS.reset(token)
