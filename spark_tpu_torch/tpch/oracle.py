"""sqlite3-backed external result oracle.

SURVEY §4's lesson is golden results from an INDEPENDENT engine (the
reference checks TPC-H/DS results against checked-in goldens,
TPCDSQueryTestSuite); round-1's tests compared the mesh engine against
this project's own single-device mode, which shares the compiler and
therefore its bugs. sqlite3 (stdlib) shares nothing. Queries are
translated to sqlite dialect: date literals become ISO strings (which
order correctly as text), interval arithmetic folds to literal dates,
extract(year)/substring map to strftime/substr.
"""

from __future__ import annotations

import datetime
import decimal
import re
import sqlite3
from typing import Dict, List, Tuple

import pyarrow as pa

_INTERVAL_RE = re.compile(
    r"date\s*'(\d{4}-\d{2}-\d{2})'\s*([+-])\s*interval\s*'(\d+)'"
    r"\s*(day|month|year|week)s?", re.IGNORECASE)
_DATE_RE = re.compile(r"date\s*'(\d{4}-\d{2}-\d{2})'", re.IGNORECASE)
_EXTRACT_RE = re.compile(
    r"extract\s*\(\s*year\s+from\s+([A-Za-z_0-9.]+)\s*\)", re.IGNORECASE)


def _shift(date_s: str, sign: str, qty: int, unit: str) -> str:
    d = datetime.date.fromisoformat(date_s)
    q = qty if sign == "+" else -qty
    unit = unit.lower()
    if unit == "day":
        d = d + datetime.timedelta(days=q)
    elif unit == "week":
        d = d + datetime.timedelta(days=7 * q)
    else:
        months = d.year * 12 + (d.month - 1) + (q if unit == "month"
                                                else 12 * q)
        y, m = divmod(months, 12)
        day = min(d.day, [31, 29 if y % 4 == 0 and (y % 100 != 0
                                                    or y % 400 == 0) else 28,
                          31, 30, 31, 30, 31, 31, 30, 31, 30, 31][m])
        d = datetime.date(y, m + 1, day)
    return d.isoformat()


def to_sqlite_sql(query: str) -> str:
    q = _INTERVAL_RE.sub(
        lambda m: "'" + _shift(m.group(1), m.group(2), int(m.group(3)),
                               m.group(4)) + "'", query)
    q = _DATE_RE.sub(lambda m: "'" + m.group(1) + "'", q)
    q = _EXTRACT_RE.sub(
        lambda m: f"CAST(strftime('%Y', {m.group(1)}) AS INTEGER)", q)
    q = re.sub(r"\bsubstring\s*\(", "substr(", q, flags=re.IGNORECASE)
    return q


def load_sqlite(tables: Dict[str, pa.Table]) -> sqlite3.Connection:
    conn = sqlite3.connect(":memory:")
    for name, tbl in tables.items():
        cols = []
        for f in tbl.schema:
            if pa.types.is_integer(f.type):
                t = "INTEGER"
            elif pa.types.is_floating(f.type) or pa.types.is_decimal(f.type):
                t = "REAL"
            else:
                t = "TEXT"  # strings and ISO dates
            cols.append(f'"{f.name}" {t}')
        conn.execute(f'CREATE TABLE {name} ({", ".join(cols)})')
        pydata = [_column_values(col) for col in tbl.columns]
        rows = list(zip(*pydata)) if pydata else []
        ph = ", ".join("?" * len(tbl.schema))
        conn.executemany(f"INSERT INTO {name} VALUES ({ph})", rows)
    conn.commit()
    return conn


def _column_values(col) -> list:
    """One arrow column as python values for sqlite, converted in bulk:
    decimals become floats (sqlite has no decimal type; its REAL
    arithmetic is the tolerance oracle), dates ISO strings, dictionary
    columns plain strings."""
    t = col.type
    if pa.types.is_dictionary(t):
        col = col.cast(t.value_type)
        t = t.value_type
    if pa.types.is_decimal(t):
        col = col.cast(pa.float64())
    elif pa.types.is_date(t):
        col = col.cast(pa.string())
    if col.null_count == 0 and (pa.types.is_integer(col.type)
                                or pa.types.is_floating(col.type)):
        return col.to_numpy().tolist()
    return col.to_pylist()


#: the TPC-H key columns the oracle indexes: without the indexes sqlite's
#: time on correlated and many-join queries (q21, q19, q5) grows with the
#: square of the scale
KEY_INDEXES = (
    ("lineitem", ("l_orderkey",)), ("lineitem", ("l_partkey", "l_suppkey")),
    ("orders", ("o_orderkey",)), ("orders", ("o_custkey",)),
    ("customer", ("c_custkey",)), ("partsupp", ("ps_partkey", "ps_suppkey")),
    ("part", ("p_partkey",)), ("supplier", ("s_suppkey",)),
    ("nation", ("n_nationkey",)), ("region", ("r_regionkey",)),
)


def index_keys(conn: sqlite3.Connection) -> None:
    """Index the key columns of ``KEY_INDEXES`` that the loaded tables
    hold, then gather the planner's statistics."""
    for i, (table, cols) in enumerate(KEY_INDEXES):
        have = {r[1] for r in conn.execute(f"pragma table_info({table})")}
        if set(cols) <= have:
            conn.execute(f"create index ix_key{i} on {table}"
                         f"({', '.join(cols)})")
    conn.execute("analyze")


def run_oracle(conn: sqlite3.Connection, query: str) -> List[Tuple]:
    cur = conn.execute(to_sqlite_sql(query))
    return [tuple(r) for r in cur.fetchall()]


# ---- result comparison ------------------------------------------------------


def normalize_rows(rows: List[Tuple], ndigits: int = 2) -> List[Tuple]:
    """Round floats, stringify dates, so engine and oracle rows are
    comparable; sort to neutralize tie order under ORDER BY."""
    out = []
    for r in rows:
        vals = []
        for v in r:
            if isinstance(v, bool):
                vals.append(int(v))
            elif isinstance(v, decimal.Decimal):
                vals.append(round(float(v), ndigits))
            elif isinstance(v, float):
                vals.append(round(v, ndigits))
            elif isinstance(v, (datetime.date, datetime.datetime)):
                vals.append(v.isoformat()[:10])
            else:
                vals.append(v)
        out.append(tuple(vals))
    return sorted(out, key=lambda t: tuple(
        (x is None, str(x)) for x in t))


def assert_rows_match(got: List[Tuple], want: List[Tuple],
                      rel: float = 1e-6, label: str = "") -> None:
    g = normalize_rows(got)
    w = normalize_rows(want)
    assert len(g) == len(w), (
        f"{label}: row count {len(g)} != oracle {len(w)}\n"
        f"got[:5]={g[:5]}\nwant[:5]={w[:5]}")
    for i, (gr, wr) in enumerate(zip(g, w)):
        assert len(gr) == len(wr), f"{label} row {i}: arity"
        for j, (a, b) in enumerate(zip(gr, wr)):
            if isinstance(a, float) or isinstance(b, float):
                if a is None or b is None:
                    assert a is None and b is None, \
                        f"{label} row {i} col {j}: {a!r} != {b!r}"
                    continue
                denom = max(abs(float(a)), abs(float(b)), 1.0)
                assert abs(float(a) - float(b)) / denom <= rel, (
                    f"{label} row {i} col {j}: {a!r} != {b!r}")
            else:
                assert a == b, f"{label} row {i} col {j}: {a!r} != {b!r}"
