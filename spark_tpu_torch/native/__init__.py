"""Host (C++) string tables for dictionary predicates, loaded via ctypes.

The port's copy of the reference's host string tier
(``spark_tpu/native``): every string predicate is evaluated on the host
over a column's dictionary, and the result becomes a code-indexed table
that the device gathers. A comment column can hold one entry per row
(dbgen's ``o_comment``: about 1.5M at SF1), where a CPython regex per
entry costs seconds, so ``strkernels.cpp`` streams over the
dictionary's Arrow buffers instead. It is built with g++ at first use into
``spark_tpu_torch/_build/`` (``ops/_build.py``); a failed build raises
with the compiler's output, and nothing falls back to the regex path.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Sequence

import numpy as np

from spark_tpu_torch.ops import _build

_SRC = Path(__file__).resolve().parent / "strkernels.cpp"
_I64P = ctypes.POINTER(ctypes.c_int64)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_U64P = ctypes.POINTER(ctypes.c_uint64)


def _lib() -> ctypes.CDLL:
    lib = _build.host_library("strkernels", _SRC)
    lib.like_table.argtypes = [ctypes.c_char_p, _I64P, ctypes.c_int64,
                               ctypes.c_char_p, ctypes.c_int64, _U8P]
    lib.like_table.restype = None
    lib.predicate_table.argtypes = [
        ctypes.c_char_p, _I64P, ctypes.c_int64, ctypes.c_char_p,
        ctypes.c_int64, ctypes.c_int32, _U8P]
    lib.predicate_table.restype = None
    lib.hash_table64.argtypes = [ctypes.c_char_p, _I64P, ctypes.c_int64,
                                 ctypes.c_uint64, _U64P]
    lib.hash_table64.restype = None
    return lib


def available() -> bool:
    """Whether the C++ tier builds and loads here (g++ on the PATH).
    Callers do not branch on it: every table call raises when the build
    fails."""
    try:
        _lib()
    except (RuntimeError, OSError):
        return False
    return True


def _arrow_buffers(strings: Sequence[str]):
    """Dictionary -> (data bytes, int64 offsets) in Arrow large_string
    layout. pyarrow does the UTF-8 encode in C."""
    import pyarrow as pa

    arr = pa.array(strings, type=pa.large_string())
    bufs = arr.buffers()  # [validity, offsets, data]
    offsets = np.frombuffer(bufs[1], dtype=np.int64,
                            count=len(strings) + 1)
    data = bufs[2]
    return (bytes(data) if data is not None else b""), offsets


def like_table(dictionary: Sequence[str], pattern: str) -> np.ndarray:
    """bool[n]: SQL LIKE over every dictionary entry (the semantics of
    ``expr/compiler._like_to_regex``: % any run, _ one codepoint)."""
    lib = _lib()
    data, offsets = _arrow_buffers(dictionary)
    out = np.zeros(len(dictionary), dtype=np.uint8)
    pat = pattern.encode("utf-8")
    lib.like_table(data, offsets.ctypes.data_as(_I64P), len(dictionary),
                   pat, len(pat), out.ctypes.data_as(_U8P))
    return out.astype(bool)


_PRED_OPS = {"contains": 0, "startswith": 1, "endswith": 2}


def predicate_table(dictionary: Sequence[str], op: str,
                    needle: str) -> np.ndarray:
    """bool[n]: ``op`` (contains, startswith, endswith) of ``needle`` over
    every dictionary entry."""
    lib = _lib()
    data, offsets = _arrow_buffers(dictionary)
    out = np.zeros(len(dictionary), dtype=np.uint8)
    nd = needle.encode("utf-8")
    lib.predicate_table(data, offsets.ctypes.data_as(_I64P),
                        len(dictionary), nd, len(nd), _PRED_OPS[op],
                        out.ctypes.data_as(_U8P))
    return out.astype(bool)


def hash_table64(dictionary: Sequence[str], seed: int = 42) -> np.ndarray:
    """uint64[n]: a 64-bit avalanche hash of every dictionary entry's
    UTF-8 bytes under ``seed``, the reference's bit for bit (partition
    routing of host-side string keys)."""
    lib = _lib()
    data, offsets = _arrow_buffers(dictionary)
    out = np.zeros(len(dictionary), dtype=np.uint64)
    lib.hash_table64(data, offsets.ctypes.data_as(_I64P), len(dictionary),
                     ctypes.c_uint64(seed), out.ctypes.data_as(_U64P))
    return out
