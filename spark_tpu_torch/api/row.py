"""Row: the result-row type returned by collect() (reference:
sql/catalyst/.../expressions/rows.scala GenericRow / python
pyspark/sql/types.py Row). Field access by name or position."""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple


class Row:
    __slots__ = ("_names", "_values")

    def __init__(self, names: Tuple[str, ...], values: Tuple[Any, ...]):
        self._names = names
        self._values = values

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Row":
        return cls(tuple(d.keys()), tuple(d.values()))

    def __getitem__(self, key):
        if isinstance(key, int):
            return self._values[key]
        return self._values[self._names.index(key)]

    def __getattr__(self, name: str):
        try:
            names = object.__getattribute__(self, "_names")
        except AttributeError:
            raise AttributeError(name)
        if name in names:
            return self._values[names.index(name)]
        raise AttributeError(name)

    def asDict(self) -> Dict[str, Any]:
        return dict(zip(self._names, self._values))

    def __iter__(self) -> Iterator[Any]:
        return iter(self._values)

    def __len__(self) -> int:
        return len(self._values)

    def __eq__(self, other) -> bool:
        if isinstance(other, Row):
            return self._values == other._values
        if isinstance(other, tuple):
            return self._values == other
        return NotImplemented

    def __hash__(self):
        return hash(self._values)

    def __repr__(self) -> str:
        inner = ", ".join(f"{n}={v!r}" for n, v in
                          zip(self._names, self._values))
        return f"Row({inner})"
