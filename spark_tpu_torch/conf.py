"""Typed configuration registry: the port of ``spark_tpu/conf.py``.

Typed entries with defaults and docs, and a session-scoped mutable view
over them (Spark: ConfigEntry.scala:74 and
SQLConf.scala:56). Only the keys that ported code reads are registered
here; the runtime-filter keys are registered by ``plan/optimizer.py``,
which reads them, as in the reference. Keys of tiers that are not ported
yet come with those tiers (ROADMAP queue A).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional


@dataclass(frozen=True)
class ConfigEntry:
    key: str
    default: Any
    doc: str
    value_type: Callable[[Any], Any] = lambda x: x


_REGISTRY: Dict[str, ConfigEntry] = {}

#: registered free-form key prefixes: prefix -> doc. A key matching a
#: registered prefix is declared even though its suffix is user-chosen.
_PREFIXES: Dict[str, str] = {}


def register(key: str, default: Any, doc: str,
             value_type: Callable[[Any], Any] = lambda x: x) -> ConfigEntry:
    entry = ConfigEntry(key, default, doc, value_type)
    _REGISTRY[key] = entry
    return entry


def register_prefix(prefix: str, doc: str) -> str:
    """Declare a free-form key family. Returns the prefix, so callers can
    keep it as a plain string constant."""
    _PREFIXES[prefix] = doc
    return prefix


def is_registered(key: str) -> bool:
    """True when ``key`` is a declared ConfigEntry or matches a
    registered prefix."""
    return key in _REGISTRY or any(key.startswith(p) for p in _PREFIXES)


CBO_JOIN_REORDER = register(
    "spark.sql.cbo.joinReorder.enabled", True,
    "Reorder maximal inner equi-join clusters greedily by estimated "
    "cardinality (reference: CostBasedJoinReorder.scala:1; here driven "
    "by batch capacities and Parquet metadata, not ANALYZE stats).", bool)

ANALYSIS_LEVEL = register(
    "spark.tpu.analysis.level", "off",
    "Governs conf.set of undeclared keys: off accepts them silently, "
    "warn emits a warning, error raises. (In the reference it also "
    "gates a static plan analysis before execution, which is not "
    "ported.)", str)


class RuntimeConf:
    """Session-scoped mutable view over the registry."""

    def __init__(self, overrides: Optional[Dict[str, Any]] = None):
        self._overrides: Dict[str, Any] = dict(overrides or {})

    def get(self, entry_or_key) -> Any:
        key = (entry_or_key.key if isinstance(entry_or_key, ConfigEntry)
               else entry_or_key)
        if key in self._overrides:
            return self._overrides[key]
        if key in _REGISTRY:
            return _REGISTRY[key].default
        raise KeyError(f"unknown config key: {key}")

    def set(self, key: str, value: Any) -> None:
        if key in _REGISTRY:
            value = _REGISTRY[key].value_type(value)
        elif not is_registered(key):
            # an undeclared key no-ops every read path (get() raises on
            # it): surface the typo at the level the session asked for
            level = str(self._overrides.get(
                ANALYSIS_LEVEL.key, ANALYSIS_LEVEL.default)).lower()
            if level == "error":
                raise KeyError(
                    f"unknown config key: {key} (not a registered "
                    "ConfigEntry or prefix; set "
                    "spark.tpu.analysis.level=warn to tolerate)")
            if level == "warn":
                warnings.warn(
                    f"conf.set of undeclared key {key!r}: not a "
                    "registered ConfigEntry or prefix; reads of it "
                    "will raise KeyError", stacklevel=2)
        self._overrides[key] = value

    def unset(self, key: str) -> None:
        self._overrides.pop(key, None)

    def entries(self) -> Dict[str, Any]:
        out = {k: e.default for k, e in _REGISTRY.items()}
        out.update(self._overrides)
        return out
