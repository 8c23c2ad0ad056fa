"""Scan-source freshness fingerprints (the port of
``spark_tpu/io/fingerprint.py``'s ``stat_paths``).

A fingerprint is a tuple of ``(path, mtime_ns, size)`` triples in a
deterministic order (sorted directory walks, paths in the order given),
so tuple equality is freshness equality and the tuple can key a cache.
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

#: one stat triple: (path, st_mtime_ns, st_size)
StatTriple = Tuple[str, int, int]


def _stat(path: str, out: list) -> None:
    try:
        st = os.stat(path)
    except OSError:
        return  # a vanished file changes the fingerprint, as it should
    out.append((path, st.st_mtime_ns, st.st_size))


def stat_paths(paths: Sequence[str]) -> Tuple[StatTriple, ...]:
    """Stat every file under ``paths`` (directories walk recursively,
    in name order, so the order is the same on every run);
    unreadable entries are skipped."""
    out: list = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs.sort()  # walk subdirectories in name order too
                for f in sorted(files):
                    _stat(os.path.join(root, f), out)
        else:
            _stat(p, out)
    return tuple(out)
