"""A bounded LRU mapping (the port of ``spark_tpu/storage/lru.py``).

Dict-shaped (get, [], len, clear, pop, keys); inserts evict the least
recently used entries beyond an entry cap, read live from a conf entry
when one is given (the active session's settings, or ``conf``), and,
with a ``weigher``, beyond a byte cap. The live size is published in
``gauges()`` under ``jit_cache.<name>.entries`` (and ``.bytes``).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Dict, Optional

from spark_tpu_torch import locks

_GAUGES: Dict[str, int] = {}
_GAUGES_LOCK = locks.named_lock("storage.lru_gauges")


def gauges() -> Dict[str, int]:
    """The live sizes of every LruDict, by gauge name."""
    with _GAUGES_LOCK:
        return dict(_GAUGES)


def _set_gauge(name: str, value: int) -> None:
    with _GAUGES_LOCK:
        _GAUGES[name] = int(value)


class LruDict:
    """Thread-safe LRU mapping with an entry cap and an optional byte
    cap."""

    def __init__(self, name: str, cap_entry=None, cap: int = 512,
                 max_bytes_entry=None, max_bytes: Optional[int] = None,
                 weigher: Optional[Callable[[Any], int]] = None,
                 conf=None):
        self._d: "OrderedDict[Any, Any]" = OrderedDict()
        self._name = name
        self._conf = conf
        self._cap_entry = cap_entry
        self._cap = int(cap)
        self._max_bytes_entry = max_bytes_entry
        self._max_bytes = max_bytes
        self._weigher = weigher
        self._weights: "OrderedDict[Any, int]" = OrderedDict()
        self._bytes = 0
        self._lock = locks.named_lock("storage.lru")
        self.evictions = 0

    def _conf_value(self, entry, fallback: int) -> int:
        try:
            conf = self._conf
            if conf is None:
                from spark_tpu_torch.api.session import SparkSession

                sess = SparkSession.getActiveSession()
                conf = None if sess is None else sess.conf
            return int(entry.default if conf is None else conf.get(entry))
        except (KeyError, TypeError, ValueError):
            return fallback

    def _capacity(self) -> int:
        if self._cap_entry is not None:
            return max(1, self._conf_value(self._cap_entry, self._cap))
        return max(1, self._cap)

    def _byte_capacity(self) -> Optional[int]:
        if self._max_bytes_entry is not None:
            default = self._max_bytes if self._max_bytes is not None \
                else int(self._max_bytes_entry.default)
            return max(0, self._conf_value(self._max_bytes_entry, default))
        if self._max_bytes is not None:
            return max(0, int(self._max_bytes))
        return None

    def _touch(self, key) -> None:
        self._d.move_to_end(key)
        if key in self._weights:
            self._weights.move_to_end(key)

    def get(self, key, default=None):
        with self._lock:
            if key not in self._d:
                return default
            self._touch(key)
            return self._d[key]

    def __getitem__(self, key):
        with self._lock:
            v = self._d[key]
            self._touch(key)
            return v

    def __setitem__(self, key, value) -> None:
        cap = self._capacity()
        byte_cap = self._byte_capacity()
        w = int(self._weigher(value)) if self._weigher is not None else 0
        with self._lock:
            if self._weigher is not None and key in self._weights:
                self._bytes -= self._weights[key]
            self._d[key] = value
            self._d.move_to_end(key)
            if self._weigher is not None:
                self._weights[key] = w
                self._weights.move_to_end(key)
                self._bytes += w
            while len(self._d) > cap or (
                    byte_cap is not None and self._bytes > byte_cap
                    and self._d):
                old_key, _ = self._d.popitem(last=False)
                self._bytes -= self._weights.pop(old_key, 0)
                self.evictions += 1
            size, total = len(self._d), self._bytes
        _set_gauge(f"jit_cache.{self._name}.entries", size)
        if self._weigher is not None:
            _set_gauge(f"jit_cache.{self._name}.bytes", total)

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._d

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)

    @property
    def total_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def clear(self) -> None:
        with self._lock:
            self._d.clear()
            self._weights.clear()
            self._bytes = 0
        _set_gauge(f"jit_cache.{self._name}.entries", 0)
        if self._weigher is not None:
            _set_gauge(f"jit_cache.{self._name}.bytes", 0)

    def pop(self, key, default=None):
        with self._lock:
            self._bytes -= self._weights.pop(key, 0)
            return self._d.pop(key, default)

    def keys(self) -> list:
        """A snapshot of the keys, least recently used first."""
        with self._lock:
            return list(self._d.keys())
