"""DDL schema strings: ``"a INT, b STRING NOT NULL, m MAP<STRING, INT>,
xs ARRAY<BIGINT>"`` -> Schema
(reference: sql/catalyst/.../parser/ParserInterface.parseTableSchema +
DataType.fromDDL)."""

from __future__ import annotations

from spark_tpu_torch import types as T
from spark_tpu_torch.types import Field, Schema

_TYPE_NAMES = {
    "boolean": T.BOOLEAN, "bool": T.BOOLEAN,
    "byte": T.INT8, "tinyint": T.INT8,
    "short": T.INT16, "smallint": T.INT16,
    "int": T.INT32, "integer": T.INT32,
    "long": T.INT64, "bigint": T.INT64,
    "float": T.FLOAT32, "real": T.FLOAT32,
    "double": T.FLOAT64,
    "string": T.STRING, "varchar": T.STRING, "char": T.STRING,
    "text": T.STRING,
    "date": T.DATE,
    "timestamp": T.TIMESTAMP,
}


def _split_top(text: str, sep: str = ",") -> list:
    """``text`` split at each ``sep`` outside (...) and <...>."""
    parts, depth, cur = [], 0, []
    for ch in text:
        if ch in "(<":
            depth += 1
        elif ch in ")>":
            depth -= 1
        if ch == sep and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return parts


def parse_type(s: str) -> T.DataType:
    s = s.strip().lower()
    flat = s.replace(" ", "")
    if flat.startswith("array<") and flat.endswith(">"):
        return T.ArrayType(parse_type(flat[6:-1]))
    if flat.startswith("map<") and flat.endswith(">"):
        key, value = _split_top(flat[4:-1])
        return T.MapType(parse_type(key), parse_type(value))
    if s.startswith("decimal") or s.startswith("numeric"):
        if "(" in s:
            inner = s[s.index("(") + 1:s.rindex(")")]
            parts = [p.strip() for p in inner.split(",")]
            p = int(parts[0])
            sc = int(parts[1]) if len(parts) > 1 else 0
            if p > T.DecimalType.MAX_PRECISION:
                raise NotImplementedError(
                    f"decimal({p},{sc}) exceeds the engine's "
                    f"{T.DecimalType.MAX_PRECISION}-digit (int64) cap")
            return T.DecimalType(p, sc)
        return T.DecimalType(10, 0)
    if "(" in s:  # varchar(32), char(1)
        s = s[:s.index("(")]
    if s in _TYPE_NAMES:
        return _TYPE_NAMES[s]
    raise ValueError(f"unknown SQL type {s!r}")


def parse_ddl_schema(ddl: str) -> Schema:
    """Parse ``name TYPE [NOT NULL], ...`` (a bracket-aware split, so the
    commas of decimal(12,2) and map<k, v> don't break fields)."""
    fields = []
    for part in _split_top(ddl):
        if not part.strip():
            continue
        toks = part.strip().split()
        if len(toks) < 2:
            raise ValueError(f"bad DDL field {part!r}")
        name = toks[0].strip("`\"")
        nullable = True
        if len(toks) >= 4 and toks[-2].lower() == "not" \
                and toks[-1].lower() == "null":
            nullable = False
            toks = toks[:-2]
        dtype = parse_type(" ".join(toks[1:]))
        fields.append(Field(name, dtype, nullable=nullable))
    return Schema(tuple(fields))
