"""Expression evaluator over torch tensors.

The port of ``spark_tpu/expr/compiler.py`` for the main-path subset:
columns, literals and aliases; arithmetic, including exact scaled-int64
decimals; comparisons, including date literals and dictionary-string
tables; three-valued boolean logic and null tests; casts. Null semantics
follow SQL three-valued logic, carried as (values, validity-mask) pairs.

String expressions never touch bytes on the device: predicates are
evaluated host-side over the column dictionary and become int32-code
lookup-table gathers. Every tensor is created with an explicit dtype and
device, so torch's type promotion never decides a result type.
"""

from __future__ import annotations

import datetime
import decimal
import operator
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

    raise NotImplementedError(
        f"expression {type(expr).__name__} is not ported yet: {expr}")


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


def _string_cmp_tables(lt: TV, rt: TV, op: str, n: int) -> torch.Tensor:
    """Comparison between two string TVs via host dictionaries."""
    pyop = _PY_OPS[op]
    ld = lt.dictionary or ()
    rd = rt.dictionary or ()
    dev = lt.data.device
    if rt.dictionary is not None and len(rd) == 1 and rt.validity is None:
        # col OP literal: one table over the column dictionary
        needle = rd[0]
        table = _dict_table(ld, lambda s: pyop(s, needle))
        return (_gather(table, lt.data) if len(ld)
                else torch.zeros((n,), dtype=torch.bool, device=dev))
    if lt.dictionary is not None and len(ld) == 1 and lt.validity is None:
        needle = ld[0]
        table = _dict_table(rd, lambda s: pyop(needle, s))
        return (_gather(table, rt.data) if len(rd)
                else torch.zeros((n,), dtype=torch.bool, device=dev))
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
        data = _string_cmp_tables(lt, rt, expr.op, n)
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
