"""Data type system of the port.

Maps the reference's Catalyst type system (reference:
sql/catalyst/src/main/scala/org/apache/spark/sql/types/) onto device
columns held as torch tensors:

- integers and floats map directly to torch dtypes,
- StringType is dictionary-encoded: int32 codes on device + a host-side
  tuple of strings (the dictionary) carried in the schema,
- DateType is int32 days since the Unix epoch (Arrow date32 layout),
- TimestampType is int64 microseconds since the epoch,
- DecimalType(p, s) is a scaled int64 (the unscaled value),
- ArrayType is a padded 2-D tensor (capacity, max_len) with a per-row
  int32 length, MapType two parallel arrays of keys and values, and a
  struct flattens into dotted columns at ingest.

Columns are plain dense tensors; nulls live in a separate validity mask
(Arrow-style).
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

import numpy as np


class DataType:
    """Base class for SQL data types."""

    #: numpy dtype used for the device representation of values.
    np_dtype: Any = None

    def __repr__(self) -> str:
        return self.__class__.__name__.replace("Type", "").lower()

    def __eq__(self, other: object) -> bool:
        return type(self) is type(other)

    def __hash__(self) -> int:
        return hash(type(self))

    @property
    def is_numeric(self) -> bool:
        return isinstance(self, (IntegralType, FractionalType, DecimalType))

    @property
    def is_integral(self) -> bool:
        return isinstance(self, IntegralType)

    @property
    def is_string(self) -> bool:
        return isinstance(self, StringType)


class IntegralType(DataType):
    pass


class FractionalType(DataType):
    pass


class BooleanType(DataType):
    np_dtype = np.bool_


class Int8Type(IntegralType):
    np_dtype = np.int8


class Int16Type(IntegralType):
    np_dtype = np.int16


class Int32Type(IntegralType):
    np_dtype = np.int32


class Int64Type(IntegralType):
    np_dtype = np.int64


class Float32Type(FractionalType):
    np_dtype = np.float32


class Float64Type(FractionalType):
    np_dtype = np.float64


class StringType(DataType):
    """Dictionary-encoded on device: values are int32 codes into a
    host-side dictionary (tuple of python strings) stored in the schema."""

    np_dtype = np.int32


class DateType(DataType):
    """Days since 1970-01-01, int32 (Arrow date32)."""

    np_dtype = np.int32


class TimestampType(DataType):
    """Microseconds since epoch, int64 (Arrow timestamp[us])."""

    np_dtype = np.int64


@dataclass(frozen=True)
class DecimalType(FractionalType):
    """Decimal(precision, scale). Device representation: SCALED int64
    (unscaled value = decimal * 10^scale), so money math is EXACT
    (reference: sql/catalyst/.../types/Decimal.scala — a JVM BigDecimal/
    long hybrid). Deviation from the reference: max precision is 18
    digits (int64) rather than 38 (int128); results whose Spark-rule
    precision would exceed 18 get their scale reduced to fit, like
    Spark's own DecimalPrecision.adjustPrecisionScale does past 38.
    Division and avg route through float64 then round back to the
    result scale (exact for quotients up to 2^53)."""

    precision: int = 18
    scale: int = 6
    np_dtype: Any = field(default=np.int64, compare=False, repr=False)

    MAX_PRECISION = 18

    def __repr__(self) -> str:
        return f"decimal({self.precision},{self.scale})"

    def __hash__(self) -> int:
        return hash((DecimalType, self.precision, self.scale))


@dataclass(frozen=True)
class ArrayType(DataType):
    """array<element>. Device layout (the reference's,
    ``spark_tpu/types.py:138``): padded 2-D values (capacity, max_len)
    plus a per-row int32 length, which rides in a batch as the hidden
    companion column ``<col>#len`` and in an evaluated value as
    ``TV.lengths``. Every row-level operator moves the pair as two
    ordinary columns. Memory is rows x max_len. Elements are never null:
    a null array is a null row."""

    element: DataType
    np_dtype: Any = field(default=None, compare=False, repr=False)

    def __post_init__(self):
        # the storage dtype of the 2-D values is the element's
        object.__setattr__(self, "np_dtype", self.element.np_dtype)

    def __repr__(self) -> str:
        return f"array<{self.element!r}>"

    def __hash__(self) -> int:
        return hash((ArrayType, self.element))


LEN_SUFFIX = "#len"


def array_len_col(name: str) -> str:
    """The hidden companion column carrying an array column's lengths."""
    return name + LEN_SUFFIX


@dataclass(frozen=True)
class MapType(DataType):
    """map<key, value>. A map column decomposes into two parallel array
    columns, ``<col>#keys`` and ``<col>#vals``, that share one length
    (the reference's layout, ``spark_tpu/types.py:168``). Lookups are a
    key match over the keys plane and a gather from the values plane.
    Maps are neither orderable nor groupable."""

    key: DataType
    value: DataType
    np_dtype: Any = field(default=np.int64, compare=False, repr=False)

    def __repr__(self) -> str:
        return f"map<{self.key!r},{self.value!r}>"

    def __hash__(self) -> int:
        return hash((MapType, self.key, self.value))


MAP_KEYS_SUFFIX = "#keys"
MAP_VALS_SUFFIX = "#vals"


def map_keys_col(name: str) -> str:
    return name + MAP_KEYS_SUFFIX


def map_vals_col(name: str) -> str:
    return name + MAP_VALS_SUFFIX


def map_base_name(name: str) -> Optional[str]:
    """'m#keys'/'m#vals' -> 'm'; None for any other name."""
    for suffix in (MAP_KEYS_SUFFIX, MAP_VALS_SUFFIX):
        if name.endswith(suffix):
            return name[:-len(suffix)]
    return None


@dataclass(frozen=True)
class StructType(DataType):
    """struct<...>. Structs flatten at ingest into dotted columns
    ('s.f1', 's.f2'); this marker survives only in error messages and
    casts."""

    names: Tuple[str, ...] = ()
    np_dtype: Any = field(default=np.int64, compare=False, repr=False)

    def __hash__(self) -> int:
        return hash((StructType, self.names))


# Singleton instances for convenience.
BOOLEAN = BooleanType()
INT8 = Int8Type()
INT16 = Int16Type()
INT32 = Int32Type()
INT64 = Int64Type()
FLOAT32 = Float32Type()
FLOAT64 = Float64Type()
STRING = StringType()
DATE = DateType()
TIMESTAMP = TimestampType()


_NUMERIC_WIDENING = [
    Int8Type(),
    Int16Type(),
    Int32Type(),
    Int64Type(),
    Float32Type(),
    Float64Type(),
]


def common_type(a: DataType, b: DataType) -> DataType:
    """Numeric/temporal type coercion, modelled after Catalyst's
    TypeCoercion (reference: sql/catalyst/.../analysis/TypeCoercion.scala).
    """
    if a == b:
        return a
    if isinstance(a, ArrayType) and isinstance(b, ArrayType):
        return ArrayType(common_type(a.element, b.element))
    if isinstance(a, MapType) and isinstance(b, MapType):
        return MapType(common_type(a.key, b.key),
                       common_type(a.value, b.value))
    if isinstance(a, DecimalType) or isinstance(b, DecimalType):
        if isinstance(a, (Float32Type, Float64Type)) or isinstance(
            b, (Float32Type, Float64Type)
        ):
            return FLOAT64
        # decimal vs decimal/integral: widest integral part + widest
        # scale (reference: DecimalPrecision.widerDecimalType)
        pa = a.precision if isinstance(a, DecimalType) else 19
        sa = a.scale if isinstance(a, DecimalType) else 0
        pb = b.precision if isinstance(b, DecimalType) else 19
        sb = b.scale if isinstance(b, DecimalType) else 0
        return bounded_decimal(max(pa - sa, pb - sb) + max(sa, sb),
                               max(sa, sb))
    if a.is_numeric and b.is_numeric:
        ia = _NUMERIC_WIDENING.index(a)
        ib = _NUMERIC_WIDENING.index(b)
        return _NUMERIC_WIDENING[max(ia, ib)]
    if isinstance(a, DateType) and isinstance(b, StringType):
        return a
    if isinstance(a, StringType) and isinstance(b, DateType):
        return b
    raise TypeError(f"cannot find common type for {a} and {b}")


def bounded_decimal(precision: int, scale: int) -> DecimalType:
    """Cap a derived decimal type at the int64-representable 18 digits,
    sacrificing scale first (the reference's adjustPrecisionScale
    discipline at ITS 38-digit cap, DecimalType.scala) while keeping at
    least 6 fractional digits when the integral part allows."""
    cap = DecimalType.MAX_PRECISION
    if precision <= cap:
        return DecimalType(precision, scale)
    intpart = precision - scale
    min_scale = min(scale, 6)
    new_scale = max(min_scale, cap - intpart)
    return DecimalType(cap, new_scale)


def infer_type(value: Any) -> DataType:
    """Infer the SQL type of a python literal."""
    if isinstance(value, bool):
        return BOOLEAN
    if isinstance(value, (int, np.integer)):
        return INT64
    if isinstance(value, (float, np.floating)):
        return FLOAT64
    if isinstance(value, str):
        return STRING
    if isinstance(value, datetime.datetime):
        return TIMESTAMP
    if isinstance(value, datetime.date):
        return DATE
    raise TypeError(f"cannot infer SQL type for literal {value!r}")


def date_to_days(d: datetime.date) -> int:
    return (d - datetime.date(1970, 1, 1)).days


def days_to_date(days: int) -> datetime.date:
    return datetime.date(1970, 1, 1) + datetime.timedelta(days=int(days))


@dataclass(frozen=True)
class Field:
    """A named, typed column in a schema. ``dictionary`` is the host-side
    string dictionary for StringType columns (None until bound to data)."""

    name: str
    dtype: DataType
    nullable: bool = True
    dictionary: Optional[Tuple[str, ...]] = None

    def with_name(self, name: str) -> "Field":
        return Field(name, self.dtype, self.nullable, self.dictionary)


@dataclass(frozen=True)
class Schema:
    """Ordered collection of fields; the host-side half of a batch
    (device half is columnar.batch.BatchData). Plays the role of
    Catalyst's StructType (reference: sql/catalyst/.../types/StructType.scala)."""

    fields: Tuple[Field, ...]

    def __post_init__(self):
        object.__setattr__(self, "fields", tuple(self.fields))

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(f.name for f in self.fields)

    def field(self, name: str) -> Field:
        for f in self.fields:
            if f.name == name:
                return f
        raise KeyError(f"column {name!r} not found in schema {self.names}")

    def index(self, name: str) -> int:
        for i, f in enumerate(self.fields):
            if f.name == name:
                return i
        raise KeyError(f"column {name!r} not found in schema {self.names}")

    def __contains__(self, name: str) -> bool:
        return any(f.name == name for f in self.fields)

    def __len__(self) -> int:
        return len(self.fields)

    def __iter__(self):
        return iter(self.fields)

    def __repr__(self) -> str:
        inner = ", ".join(f"{f.name}:{f.dtype}" for f in self.fields)
        return f"schema<{inner}>"


def parse_ddl_schema(ddl: str) -> Schema:
    """Parse a simple DDL schema string: ``"name type, name type"``
    (reference: StructType.fromDDL; the subset pyspark users pass to
    applyInPandas* — no nested types)."""
    mapping = {
        "boolean": BOOLEAN, "bool": BOOLEAN,
        "tinyint": INT8, "byte": INT8,
        "smallint": INT16, "short": INT16,
        "int": INT32, "integer": INT32,
        "bigint": INT64, "long": INT64,
        "float": FLOAT32, "real": FLOAT32,
        "double": FLOAT64,
        "string": STRING, "varchar": STRING,
        "date": DATE, "timestamp": TIMESTAMP,
    }
    fields = []
    for part in ddl.split(","):
        toks = part.strip().split()
        if len(toks) < 2:
            raise ValueError(f"bad DDL field: {part!r}")
        name, type_name = toks[0], toks[1].lower()
        base = type_name.split("(")[0]
        if base == "decimal":
            inner = type_name[type_name.index("(") + 1:
                              type_name.index(")")].split(",") \
                if "(" in type_name else ["10", "0"]
            dt: DataType = DecimalType(int(inner[0]), int(inner[1]))
        elif base in mapping:
            dt = mapping[base]
        else:
            raise ValueError(f"unsupported DDL type: {type_name!r}")
        fields.append(Field(name, dt, nullable=True))
    return Schema(tuple(fields))
