"""Expression evaluator over torch tensors.

The port of ``spark_tpu/expr/compiler.py`` for the main-path subset:
columns, literals and aliases; arithmetic, including exact scaled-int64
decimals; comparisons, including date literals and dictionary-string
tables; three-valued boolean logic and null tests; casts; month
arithmetic on dates (``AddMonths``); IN lists, LIKE, string predicates,
substring, CASE, COALESCE and date parts. Null semantics follow SQL
three-valued logic, carried as (values, validity-mask) pairs.

String expressions never touch bytes on the device: predicates are
evaluated host-side over the column dictionary and become int32-code
lookup-table gathers. LIKE and the string predicates build their table
with the C++ kernels of ``spark_tpu_torch/native`` for dictionaries of
``_NATIVE_DICT_MIN`` entries or more, and with Python's ``re``/``str``
below that. Every tensor is created with an explicit dtype and device,
so torch's type promotion never decides a result type.
"""

from __future__ import annotations

import datetime
import decimal
import operator
import re
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from spark_tpu_torch import types as T
from spark_tpu_torch.device import torch_dtype
from spark_tpu_torch.expr import expressions as E
from spark_tpu_torch.types import DataType


class TV(NamedTuple):
    """Typed value: device data + validity + host metadata."""

    data: torch.Tensor
    validity: Optional[torch.Tensor]  # None = all valid
    dtype: DataType
    dictionary: Optional[Tuple[str, ...]] = None

    def valid_or_true(self, n: int) -> torch.Tensor:
        if self.validity is None:
            return torch.ones((n,), dtype=torch.bool, device=self.data.device)
        return self.validity


class Env:
    """Column environment for evaluation: name -> TV, plus row count and
    the device the rows live on."""

    def __init__(self, columns: Dict[str, TV], capacity: int, mask=None,
                 device=None):
        self.columns = columns
        self.capacity = capacity
        self.mask = mask
        if device is None:
            device = (mask.device if mask is not None
                      else next(iter(columns.values())).data.device)
        self.device = torch.device(device)


def _and_validity(a: Optional[torch.Tensor], b: Optional[torch.Tensor]):
    if a is None:
        return b
    if b is None:
        return a
    return a & b


def _torch_dtype(dt: DataType) -> torch.dtype:
    return torch_dtype(dt.np_dtype)


def _floordiv(a: torch.Tensor, b) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def _round_half_up_div(data: torch.Tensor, factor: int) -> torch.Tensor:
    """Exact scaled-int scale-down with HALF_UP rounding."""
    mag = _floordiv(data.abs() + factor // 2, factor)
    return torch.sign(data) * mag


def _float_to_scaled(data: torch.Tensor, scale: int) -> torch.Tensor:
    """float -> scaled int64 with HALF_UP rounding."""
    scaled = data.to(torch.float64) * float(10 ** scale)
    return (torch.sign(scaled)
            * torch.floor(scaled.abs() + 0.5)).to(torch.int64)


def _cast_data(data: torch.Tensor, src: DataType, dst: DataType
               ) -> torch.Tensor:
    sdec = isinstance(src, T.DecimalType)
    ddec = isinstance(dst, T.DecimalType)
    if sdec and ddec:
        if src.scale == dst.scale:
            return data
        if dst.scale > src.scale:
            return data * (10 ** (dst.scale - src.scale))
        return _round_half_up_div(data, 10 ** (src.scale - dst.scale))
    if sdec:
        if isinstance(dst, (T.Float32Type, T.Float64Type)):
            return (data.to(torch.float64)
                    / float(10 ** src.scale)).to(_torch_dtype(dst))
        # decimal -> integral truncates toward zero (Decimal.toLong)
        mag = _floordiv(data.abs(), 10 ** src.scale)
        return (torch.sign(data) * mag).to(_torch_dtype(dst))
    if ddec:
        if src.is_integral or isinstance(src, T.BooleanType):
            return data.to(torch.int64) * (10 ** dst.scale)
        return _float_to_scaled(data, dst.scale)
    if type(src) is type(dst):
        return data
    return data.to(_torch_dtype(dst))


def _dict_table(dictionary: Tuple[str, ...], fn) -> np.ndarray:
    """Evaluate a python predicate/transform over a dictionary host-side."""
    return np.array([fn(s) for s in dictionary])


def _gather(table: np.ndarray, codes: torch.Tensor) -> torch.Tensor:
    """Host lookup table indexed by device codes."""
    return torch.as_tensor(table, device=codes.device)[codes.long()]


def _gather_or_false(table: np.ndarray, codes: torch.Tensor) -> torch.Tensor:
    """A boolean dictionary table gathered by code; all False for an
    empty dictionary (every row is then NULL or dead)."""
    if len(table):
        return _gather(table, codes)
    return torch.zeros(codes.shape, dtype=torch.bool, device=codes.device)


#: dictionaries at least this large build LIKE / string-predicate tables
#: with the C++ kernels (the reference's ``_NATIVE_DICT_MIN``)
_NATIVE_DICT_MIN = 2048


def _use_native(dictionary) -> bool:
    """Per-entry CPython overhead dominates above a few thousand entries
    (a comment column can hold one entry per row)."""
    return len(dictionary) >= _NATIVE_DICT_MIN


def _like_to_regex(pattern: str) -> "re.Pattern":
    out = []
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return re.compile("^" + "".join(out) + "$", re.DOTALL)


def like_table(dictionary: Tuple[str, ...], pattern: str) -> np.ndarray:
    """bool per dictionary entry: ``entry LIKE pattern``."""
    if _use_native(dictionary):
        from spark_tpu_torch import native

        return native.like_table(dictionary, pattern)
    rx = _like_to_regex(pattern)
    return _dict_table(dictionary, lambda s: rx.match(s) is not None)


def predicate_table(dictionary: Tuple[str, ...], op: str,
                    needle: str) -> np.ndarray:
    """bool per dictionary entry: ``op`` (startswith, endswith,
    contains) of ``needle``."""
    if _use_native(dictionary):
        from spark_tpu_torch import native

        return native.predicate_table(dictionary, op, needle)
    fn = {
        "startswith": lambda s: s.startswith(needle),
        "endswith": lambda s: s.endswith(needle),
        "contains": lambda s: needle in s,
    }[op]
    return _dict_table(dictionary, fn)


def _translate(tv: TV, table: np.ndarray, union) -> TV:
    """A string TV re-coded into the union dictionary ``union`` through
    its translation table (``unify_dictionaries``)."""
    data = _gather(table, tv.data) if len(tv.dictionary or ()) else tv.data
    return TV(data, tv.validity, T.STRING, union)


def unify_dictionaries(
    dicts: Tuple[Tuple[str, ...], ...]
) -> Tuple[Tuple[str, ...], Tuple[np.ndarray, ...]]:
    """Merge several dictionaries into one (sorted) dictionary; returns
    (union, per-input translation tables old_code -> new_code)."""
    union = sorted(set().union(*[set(d) for d in dicts]))
    pos = {s: i for i, s in enumerate(union)}
    tables = tuple(
        np.array([pos[s] for s in d], dtype=np.int32) if d else
        np.zeros((0,), dtype=np.int32)
        for d in dicts
    )
    return tuple(union), tables


def _literal_tv(value, dtype: DataType, n: int, device) -> TV:
    if value is None:
        data = torch.zeros((n,), dtype=_torch_dtype(dtype), device=device)
        return TV(data, torch.zeros((n,), dtype=torch.bool, device=device),
                  dtype, None)
    if isinstance(dtype, T.StringType):
        # single-entry dictionary
        return TV(torch.zeros((n,), dtype=torch.int32, device=device), None,
                  dtype, (value,))
    if isinstance(dtype, T.DateType):
        value = (T.date_to_days(value) if isinstance(value, datetime.date)
                 else value)
    if isinstance(dtype, T.TimestampType) and isinstance(
            value, datetime.datetime):
        value = int(value.timestamp() * 1_000_000)
    if isinstance(dtype, T.DecimalType):
        q = decimal.Decimal(str(value)).scaleb(dtype.scale)
        value = int(q.to_integral_value(rounding=decimal.ROUND_HALF_UP))
    data = torch.full((n,), value, dtype=_torch_dtype(dtype), device=device)
    return TV(data, None, dtype, None)


def evaluate(expr: E.Expression, env: Env) -> TV:
    """Evaluate an expression to a TV over the rows of ``env``."""
    n = env.capacity

    if isinstance(expr, E.Literal):
        return _literal_tv(expr.value, expr.dtype, n, env.device)

    if isinstance(expr, E.Col):
        try:
            return env.columns[expr.col_name]
        except KeyError:
            raise KeyError(
                f"column {expr.col_name!r} not in {sorted(env.columns)}")

    if isinstance(expr, E.Alias):
        return evaluate(expr.child, env)

    if isinstance(expr, E.Neg):
        tv = evaluate(expr.child, env)
        return TV(-tv.data, tv.validity, tv.dtype, None)

    if isinstance(expr, E.Arith):
        return _eval_arith(expr, env)

    if isinstance(expr, E.Cmp):
        return _eval_cmp(expr, env)

    if isinstance(expr, E.And):
        lt = evaluate(expr.left, env)
        rt = evaluate(expr.right, env)
        lv = lt.valid_or_true(n)
        rv = rt.valid_or_true(n)
        vals = lt.data & rt.data
        # Kleene: valid if both valid, or either side is a valid False.
        valid = (lv & rv) | (lv & ~lt.data) | (rv & ~rt.data)
        if lt.validity is None and rt.validity is None:
            valid = None
        return TV(vals, valid, T.BOOLEAN, None)

    if isinstance(expr, E.Or):
        lt = evaluate(expr.left, env)
        rt = evaluate(expr.right, env)
        lv = lt.valid_or_true(n)
        rv = rt.valid_or_true(n)
        vals = lt.data | rt.data
        valid = (lv & rv) | (lv & lt.data) | (rv & rt.data)
        if lt.validity is None and rt.validity is None:
            valid = None
        return TV(vals, valid, T.BOOLEAN, None)

    if isinstance(expr, E.Not):
        tv = evaluate(expr.child, env)
        return TV(~tv.data, tv.validity, T.BOOLEAN, None)

    if isinstance(expr, E.IsNull):
        tv = evaluate(expr.child, env)
        if tv.validity is None:
            return TV(torch.zeros((n,), dtype=torch.bool, device=env.device),
                      None, T.BOOLEAN, None)
        return TV(~tv.validity, None, T.BOOLEAN, None)

    if isinstance(expr, E.Cast):
        return _eval_cast(expr, env)

    if isinstance(expr, E.In):
        return _eval_in(expr, env)

    if isinstance(expr, E.Like):
        tv = evaluate(expr.child, env)
        table = like_table(tv.dictionary or (), expr.pattern)
        return TV(_gather_or_false(table, tv.data), tv.validity, T.BOOLEAN,
                  None)

    if isinstance(expr, E.StringPredicate):
        tv = evaluate(expr.child, env)
        table = predicate_table(tv.dictionary or (), expr.op, expr.needle)
        return TV(_gather_or_false(table, tv.data), tv.validity, T.BOOLEAN,
                  None)

    if isinstance(expr, E.Substring):
        # a new sorted dictionary of the substrings, and a code remap
        tv = evaluate(expr.child, env)
        dictionary = tv.dictionary or ()
        transformed = [s[expr.pos - 1: expr.pos - 1 + expr.length]
                       for s in dictionary]
        new_dict = tuple(sorted(set(transformed)))
        pos = {s: i for i, s in enumerate(new_dict)}
        table = np.array([pos[t] for t in transformed], dtype=np.int32)
        codes = (_gather(table, tv.data) if len(table)
                 else torch.zeros((n,), dtype=torch.int32, device=env.device))
        return TV(codes, tv.validity, T.STRING, new_dict)

    if isinstance(expr, E.Case):
        return _eval_case(expr, env)

    if isinstance(expr, E.Coalesce):
        return _eval_coalesce(expr, env)

    if isinstance(expr, E.ExtractDatePart):
        tv = evaluate(expr.child, env)
        y, m, d = _civil_from_days(tv.data.to(torch.int64))
        part = {"year": y, "month": m, "day": d}[expr.part]
        return TV(part.to(torch.int32), tv.validity, T.INT32, None)

    if isinstance(expr, E.AddMonths):
        tv = evaluate(expr.child, env)
        y, m, d = _civil_from_days(tv.data.to(torch.int64))
        total = (y * 12 + (m - 1)) + expr.months
        ny = _floordiv(total, 12)
        nm = total - ny * 12 + 1
        nd = torch.minimum(d, _days_in_month(ny, nm))
        days = _days_from_civil(ny, nm, nd)
        return TV(days.to(torch.int32), tv.validity, T.DATE, None)

    raise NotImplementedError(
        f"expression {type(expr).__name__} is not ported yet: {expr}")


def _civil_from_days(days: torch.Tensor):
    """Days since the epoch -> (year, month, day), branch-free (Howard
    Hinnant's civil_from_days)."""
    z = days + 719468
    era = _floordiv(torch.where(z >= 0, z, z - 146096), 146097)
    doe = z - era * 146097
    yoe = _floordiv(doe - _floordiv(doe, 1460) + _floordiv(doe, 36524)
                    - _floordiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _floordiv(yoe, 4) - _floordiv(yoe, 100))
    mp = _floordiv(5 * doy + 2, 153)
    d = doy - _floordiv(153 * mp + 2, 5) + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = torch.where(m <= 2, y + 1, y)
    return y, m, d


def _days_from_civil(y: torch.Tensor, m: torch.Tensor, d: torch.Tensor):
    """(year, month, day) -> days since the epoch (Hinnant's
    days_from_civil)."""
    y = torch.where(m <= 2, y - 1, y)
    era = _floordiv(torch.where(y >= 0, y, y - 399), 400)
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = _floordiv(153 * mp + 2, 5) + d - 1
    doe = yoe * 365 + _floordiv(yoe, 4) - _floordiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


def _days_in_month(y: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    lengths = torch.tensor([31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31],
                           dtype=torch.int64, device=y.device)
    leap = ((y % 4 == 0) & (y % 100 != 0)) | (y % 400 == 0)
    base = lengths[m - 1]
    return torch.where((m == 2) & leap, base + 1, base)


def _eval_arith(expr: E.Arith, env: Env) -> TV:
    lt = evaluate(expr.left, env)
    rt = evaluate(expr.right, env)
    valid = _and_validity(lt.validity, rt.validity)

    # date arithmetic
    if isinstance(lt.dtype, T.DateType) and rt.dtype.is_integral:
        d = rt.data.to(torch.int32)
        return TV(lt.data + d if expr.op == "+" else lt.data - d, valid,
                  T.DATE, None)
    if isinstance(rt.dtype, T.DateType) and lt.dtype.is_integral \
            and expr.op == "+":
        return TV(rt.data + lt.data.to(torch.int32), valid, T.DATE, None)
    if isinstance(lt.dtype, T.DateType) and isinstance(rt.dtype, T.DateType):
        return TV((lt.data - rt.data).to(torch.int32), valid, T.INT32, None)

    if (isinstance(lt.dtype, T.DecimalType)
            or isinstance(rt.dtype, T.DecimalType)):
        dec_dt = expr._decimal_result(lt.dtype, rt.dtype)
        if dec_dt is not None:
            return _decimal_arith(expr.op, lt, rt, dec_dt, valid)

    out_dt = T.common_type(lt.dtype, rt.dtype)
    if expr.op == "/" and out_dt.is_integral:
        out_dt = T.FLOAT64
    ld = _cast_data(lt.data, lt.dtype, out_dt)
    rd = _cast_data(rt.data, rt.dtype, out_dt)

    if expr.op == "+":
        data = ld + rd
    elif expr.op == "-":
        data = ld - rd
    elif expr.op == "*":
        data = ld * rd
    elif expr.op in ("/", "%"):
        zero = rd == 0
        safe = torch.where(zero, torch.ones_like(rd), rd)
        if expr.op == "/":
            data = ld / safe
        elif out_dt.is_integral:
            # SQL remainder keeps the dividend's sign
            data = ld - (torch.sign(ld)
                         * _floordiv(ld.abs(), safe.abs())) * safe
        else:
            data = ld - torch.trunc(ld / safe) * safe
        valid = _and_validity(valid, ~zero)
    else:
        raise NotImplementedError(expr.op)
    return TV(data, valid, out_dt, None)


def _decimal_arith(op: str, lt: TV, rt: TV, out_dt, valid) -> TV:
    """Exact scaled-int64 decimal arithmetic: +,-,% align scales and
    stay integral; * adds scales then rescales to the bounded result
    type; / routes through float64 and rounds HALF_UP to the result
    scale."""
    def as_scaled(tv, scale):
        if isinstance(tv.dtype, T.DecimalType):
            return _cast_data(tv.data, tv.dtype,
                              T.DecimalType(T.DecimalType.MAX_PRECISION,
                                            scale))
        return tv.data.to(torch.int64) * (10 ** scale)

    s1 = lt.dtype.scale if isinstance(lt.dtype, T.DecimalType) else 0
    s2 = rt.dtype.scale if isinstance(rt.dtype, T.DecimalType) else 0
    if op in ("+", "-"):
        s = max(s1, s2)
        ld, rd = as_scaled(lt, s), as_scaled(rt, s)
        data = ld + rd if op == "+" else ld - rd
        data = _cast_data(data, T.DecimalType(38, s), out_dt)
        return TV(data, valid, out_dt, None)
    if op == "*":
        prod = as_scaled(lt, s1) * as_scaled(rt, s2)  # scale s1+s2
        data = _cast_data(prod, T.DecimalType(38, s1 + s2), out_dt)
        return TV(data, valid, out_dt, None)
    if op == "/":
        lf = as_scaled(lt, s1).to(torch.float64) / float(10 ** s1)
        rf = as_scaled(rt, s2).to(torch.float64) / float(10 ** s2)
        zero = rf == 0.0
        safe = torch.where(zero, torch.ones_like(rf), rf)
        data = _float_to_scaled(lf / safe, out_dt.scale)
        return TV(data, _and_validity(valid, ~zero), out_dt, None)
    if op == "%":
        s = max(s1, s2)
        ld, rd = as_scaled(lt, s), as_scaled(rt, s)
        zero = rd == 0
        safe = torch.where(zero, torch.ones_like(rd), rd)
        mag = ld.abs() - _floordiv(ld.abs(), safe.abs()) * safe.abs()
        data = torch.sign(ld) * mag
        data = _cast_data(data, T.DecimalType(38, s), out_dt)
        return TV(data, _and_validity(valid, ~zero), out_dt, None)
    raise NotImplementedError(op)


_PY_OPS = {"==": operator.eq, "!=": operator.ne, "<": operator.lt,
           "<=": operator.le, ">": operator.gt, ">=": operator.ge}


def _string_cmp_tables(lt: TV, rt: TV, op: str) -> torch.Tensor:
    """Comparison between two string TVs via host dictionaries."""
    pyop = _PY_OPS[op]
    ld = lt.dictionary or ()
    rd = rt.dictionary or ()
    if rt.dictionary is not None and len(rd) == 1 and rt.validity is None:
        # col OP literal: one table over the column dictionary
        needle = rd[0]
        return _gather_or_false(_dict_table(ld, lambda s: pyop(s, needle)),
                                lt.data)
    if lt.dictionary is not None and len(ld) == 1 and lt.validity is None:
        needle = ld[0]
        return _gather_or_false(_dict_table(rd, lambda s: pyop(needle, s)),
                                rt.data)
    # col OP col: translate both into a unified sorted dictionary, then
    # compare the (order-preserving) unified codes.
    union, (tl, tr) = unify_dictionaries((ld, rd))
    lcodes = _gather(tl, lt.data) if len(ld) else lt.data
    rcodes = _gather(tr, rt.data) if len(rd) else rt.data
    return pyop(lcodes, rcodes)


def _parse_date_days(s: str):
    """ISO date string -> days since epoch; None when unparseable."""
    try:
        return T.date_to_days(datetime.date.fromisoformat(s.strip()))
    except ValueError:
        return None


def _date_coerce(tv: TV, n: int) -> TV:
    """A string compared with a date coerces to a date via its dictionary
    ('YYYY-MM-DD' compares as days, not lexicographically)."""
    entries = tv.dictionary or ()
    parsed = [_parse_date_days(s) for s in entries]
    vals = np.array([v if v is not None else 0 for v in parsed] or [0],
                    dtype=np.int32)
    ok_tab = np.array([v is not None for v in parsed] or [False])
    if entries:
        data, ok = _gather(vals, tv.data), _gather(ok_tab, tv.data)
    else:
        data = tv.data.to(torch.int32)
        ok = torch.zeros((n,), dtype=torch.bool, device=tv.data.device)
    return TV(data, _and_validity(tv.validity, ok), T.DATE, None)


def _eval_cmp(expr: E.Cmp, env: Env) -> TV:
    n = env.capacity
    lt = evaluate(expr.left, env)
    rt = evaluate(expr.right, env)

    if isinstance(lt.dtype, T.DateType) and isinstance(rt.dtype, T.StringType):
        rt = _date_coerce(rt, n)
    elif isinstance(rt.dtype, T.DateType) \
            and isinstance(lt.dtype, T.StringType):
        lt = _date_coerce(lt, n)
    elif isinstance(lt.dtype, T.TimestampType) \
            and isinstance(rt.dtype, T.StringType) \
            or isinstance(rt.dtype, T.TimestampType) \
            and isinstance(lt.dtype, T.StringType):
        raise NotImplementedError(
            "timestamp-string comparison is not ported yet")
    valid = _and_validity(lt.validity, rt.validity)

    if isinstance(lt.dtype, T.StringType) or isinstance(rt.dtype, T.StringType):
        data = _string_cmp_tables(lt, rt, expr.op)
        return TV(data, valid, T.BOOLEAN, None)

    if isinstance(lt.dtype, T.DateType) or isinstance(rt.dtype, T.DateType):
        ld, rd = lt.data, rt.data
    else:
        out_dt = T.common_type(lt.dtype, rt.dtype)
        ld = _cast_data(lt.data, lt.dtype, out_dt)
        rd = _cast_data(rt.data, rt.dtype, out_dt)
    return TV(_PY_OPS[expr.op](ld, rd), valid, T.BOOLEAN, None)


def _eval_cast(expr: E.Cast, env: Env) -> TV:
    """CAST as the reference evaluates it. A decimal cast to a float or
    double goes through the final plain dtype conversion, as in
    ``spark_tpu/expr/compiler.py:_eval_cast``: it yields the UNSCALED
    integer (59655.18 -> 5965518.0). The port reproduces that."""
    n = env.capacity
    tv = evaluate(expr.child, env)
    dst = expr.dtype
    if isinstance(tv.dtype, T.DecimalType) and isinstance(
            dst, T.DecimalType):
        return TV(_cast_data(tv.data, tv.dtype, dst), tv.validity, dst, None)
    if type(tv.dtype) is type(dst):
        return tv
    if isinstance(dst, T.StringType):
        raise NotImplementedError("cast to string not yet supported")
    if isinstance(tv.dtype, T.StringType):
        # string -> numeric/date via dictionary
        entries = tv.dictionary or ()
        if isinstance(dst, T.DateType):
            table = np.array(
                [T.date_to_days(datetime.date.fromisoformat(s))
                 for s in entries], dtype=np.int32)
        elif isinstance(dst, T.DecimalType):
            table = np.array(
                [int(decimal.Decimal(s).scaleb(dst.scale).to_integral_value(
                    rounding=decimal.ROUND_HALF_UP))
                 for s in entries], dtype=np.int64)
        else:
            table = np.array([float(s) for s in entries],
                             dtype=dst.np_dtype)
        data = (_gather(table, tv.data) if len(table)
                else torch.zeros((n,), dtype=_torch_dtype(dst),
                                 device=env.device))
        return TV(data, tv.validity, dst, None)
    return TV(tv.data.to(_torch_dtype(dst)), tv.validity, dst, None)


def _eval_in(expr: E.In, env: Env) -> TV:
    """``x IN (literals)``. A NULL list item never matches: the engine's
    IN is two-valued, so a non-matching row is false, not NULL."""
    n = env.capacity
    tv = evaluate(expr.child, env)
    if isinstance(tv.dtype, T.StringType):
        values = set(expr.values)
        table = _dict_table(tv.dictionary or (), lambda s: s in values)
        return TV(_gather_or_false(table, tv.data), tv.validity, T.BOOLEAN,
                  None)
    res = torch.zeros((n,), dtype=torch.bool, device=env.device)
    for v in expr.values:
        if v is None:
            continue
        if isinstance(tv.dtype, T.DateType) and isinstance(v, datetime.date):
            v = T.date_to_days(v)
        if isinstance(tv.dtype, T.DecimalType):
            # the data is the scaled int64: scale the literal as
            # _literal_tv does. A literal off the scale grid (0.0501 at
            # scale 2) can never equal a stored value, so it is skipped
            # rather than rounded to a false hit.
            q = decimal.Decimal(str(v)).scaleb(tv.dtype.scale)
            if q != q.to_integral_value():
                continue
            v = int(q)
        res = res | (tv.data == v)
    return TV(res, tv.validity, T.BOOLEAN, None)


def _eval_case(expr: E.Case, env: Env) -> TV:
    n = env.capacity
    dev = env.device
    conds = [evaluate(c, env) for c, _ in expr.branches]
    vals = [evaluate(v, env) for _, v in expr.branches]
    else_tv = (evaluate(expr.else_value, env)
               if expr.else_value is not None else None)

    out_dict: Optional[Tuple[str, ...]] = None
    if any(isinstance(v.dtype, T.StringType) for v in vals):
        # branches carry different dictionaries: re-code every one into
        # their union before blending
        dicts = [v.dictionary or () for v in vals]
        if else_tv is not None:
            dicts.append(else_tv.dictionary or ())
        union, tables = unify_dictionaries(tuple(dicts))
        vals = [_translate(v, t, union) for v, t in zip(vals, tables)]
        if else_tv is not None:
            else_tv = _translate(else_tv, tables[-1], union)
        out_dt: DataType = T.STRING
        out_dict = union
    else:
        out_dt = vals[0].dtype
        for v in vals[1:]:
            out_dt = T.common_type(out_dt, v.dtype)
        if else_tv is not None:
            out_dt = T.common_type(out_dt, else_tv.dtype)

    if else_tv is not None:
        data = _cast_data(else_tv.data, else_tv.dtype, out_dt)
        valid = else_tv.validity
    else:
        data = torch.zeros((n,), dtype=_torch_dtype(out_dt), device=dev)
        valid = torch.zeros((n,), dtype=torch.bool, device=dev)

    matched = torch.zeros((n,), dtype=torch.bool, device=dev)
    for c, v in zip(conds, vals):
        fire = c.data & c.valid_or_true(n) & ~matched
        data = torch.where(fire, _cast_data(v.data, v.dtype, out_dt), data)
        valid_arr = valid if valid is not None else torch.ones(
            (n,), dtype=torch.bool, device=dev)
        valid = torch.where(fire, v.valid_or_true(n), valid_arr)
        matched = matched | fire
    return TV(data, valid, out_dt, out_dict)


def _eval_coalesce(expr: E.Coalesce, env: Env) -> TV:
    n = env.capacity
    tvs = [evaluate(a, env) for a in expr.args]
    out_dt = tvs[0].dtype
    out_dict = tvs[0].dictionary
    if isinstance(out_dt, T.StringType):
        # the args carry different dictionaries (a column and a fill
        # literal): re-code every one into the union, as Case does
        union, tables = unify_dictionaries(tuple(
            tv.dictionary or () for tv in tvs))
        tvs = [_translate(tv, t, union) for tv, t in zip(tvs, tables)]
        out_dict = union
    data = tvs[-1].data
    valid = tvs[-1].validity
    for tv in reversed(tvs[:-1]):
        v = tv.valid_or_true(n)
        data = torch.where(v, _cast_data(tv.data, tv.dtype, out_dt), data)
        # valid where this arg is valid or the later fallback was
        valid = None if valid is None else (v | valid)
    return TV(data, valid, out_dt, out_dict)
