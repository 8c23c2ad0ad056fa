"""Scan-source freshness fingerprints (the port of
``spark_tpu/io/fingerprint.py``'s ``stat_paths``, ``source_fingerprint``,
``plan_fingerprints`` and ``classify_delta``): the one stat walk the file
scan's cache, the serve tier's result cache (``serve/result_cache.py``)
and the materialized views (``mview/``) all key on.

A fingerprint is a tuple of ``(path, mtime_ns, size)`` triples in a
deterministic order (sorted directory walks, paths in the order given),
so tuple equality is freshness equality and the tuple can key a cache.
"""

from __future__ import annotations

import os
from typing import Any, Optional, Sequence, Tuple

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


def source_fingerprint(source) -> Optional[Tuple[StatTriple, ...]]:
    """Fingerprint of one datasource, None where the source has no file
    identity (in-memory relations)."""
    fpf = getattr(source, "_fingerprint", None)
    if not callable(fpf):
        return None
    try:
        return fpf()
    except Exception:  # noqa: BLE001 - an unreadable source keys by id
        return None


def plan_fingerprints(plan) -> Tuple[Any, ...]:
    """Freshness token over every scan source of ``plan``, in plan
    order. A source without a file fingerprint keys by object identity,
    which the structural plan key already embeds, so pairing this tuple
    with ``structural_key()`` stays injective."""
    from spark_tpu_torch.plan import logical as L

    out = []
    for scan in L.collect_nodes(plan, L.UnresolvedScan):
        fp = source_fingerprint(scan.source)
        out.append(fp if fp is not None else ("src", id(scan.source)))
    return tuple(out)


def classify_delta(old: Tuple[StatTriple, ...],
                   new: Tuple[StatTriple, ...]):
    """How a source moved from fingerprint ``old`` to ``new``:

    - ``("unchanged", ())``   identical fingerprints;
    - ``("appended", added)``  every old file is there unchanged and only
                               new files appeared (the incremental
                               merge's case); ``added`` lists the new
                               paths in fingerprint order;
    - ``("changed", ())``     anything else (a rewrite, a truncation, a
                               deletion, an mtime bump): only a full
                               recompute is sound.
    """
    if old == new:
        return "unchanged", ()
    old_map = {p: (m, s) for p, m, s in old}
    new_map = {p: (m, s) for p, m, s in new}
    for p, stat in old_map.items():
        if new_map.get(p) != stat:
            return "changed", ()
    added = tuple(p for p, _, _ in new if p not in old_map)
    if not added:
        # the same paths in another order (the walk is deterministic,
        # but a merge never rests on a guess)
        return "changed", ()
    return "appended", added
