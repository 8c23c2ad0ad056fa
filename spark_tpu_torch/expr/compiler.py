"""Expression evaluator over torch tensors.

The port of ``spark_tpu/expr/compiler.py`` for the main-path subset:
columns, literals and aliases; arithmetic, including exact scaled-int64
decimals; comparisons, including date and timestamp literals, strings
coerced to dates and timestamps, and dictionary-string tables;
three-valued boolean logic and null tests; casts; month arithmetic on
dates (``AddMonths``); IN lists, LIKE, string predicates, substring,
concatenation, the string transforms, length and regular expressions;
abs, floor/ceil/sqrt/exp/ln/log10/sign, round and power; date_trunc and
last_day; CASE, COALESCE, typed NULLs (``NullOf``) and date parts; arrays
(``array``, ``split``, ``size``, ``element_at`` and ``x[i]``,
``array_contains``), map lookups and the higher-order functions. Null
semantics follow SQL three-valued logic, carried as (values,
validity-mask) pairs.

An array value is a padded 2-D tensor (rows, max_len) with per-row
lengths (``TV.lengths``); a map is the pair of its keys and values arrays
(types.ArrayType, types.MapType). A higher-order function evaluates its
lambda body once over the flattened rows x max_len element plane, the
outer columns it reads repeated per element.

String expressions never touch bytes on the device: predicates are
evaluated host-side over the column dictionary and become int32-code
lookup-table gathers. LIKE and the string predicates build their table
with the C++ kernels of ``spark_tpu_torch/native`` for dictionaries of
``_NATIVE_DICT_MIN`` entries or more, and with Python's ``re``/``str``
below that. A string transform maps a dictionary to a new one
(``_dict_transform``): each entry through the Python ``str`` method the
reference uses (substring and length through pyarrow kernels, which
equal it on every entry), then one vectorised dedupe, sort and remap in
pyarrow.

Decimal inputs of the math functions and of round compute on the
decimal's value (the reference reads the unscaled integer: ROADMAP C).
Every tensor is created with an explicit dtype and device, so torch's
type promotion never decides a result type.
"""

from __future__ import annotations

import datetime
import decimal
import operator
import re
from collections import OrderedDict
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from spark_tpu_torch import locks
from spark_tpu_torch import types as T
from spark_tpu_torch.device import device_table, torch_dtype
from spark_tpu_torch.expr import expressions as E
from spark_tpu_torch.types import DataType


class TV(NamedTuple):
    """Typed value: device data + validity + host metadata. An array's
    ``data`` is 2-D (rows, max_len) and ``lengths`` its per-row int32
    lengths; in a batch they ride as the ``<col>#len`` companion."""

    data: torch.Tensor
    validity: Optional[torch.Tensor]  # None = all valid
    dtype: DataType
    dictionary: Optional[Tuple[str, ...]] = None
    lengths: Optional[torch.Tensor] = None  # int32[rows], arrays only

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

    @classmethod
    def from_batch(cls, batch) -> "Env":
        """The batch's columns, each array paired with its ``#len``
        companion."""
        by_name = {f.name: cd for f, cd in zip(batch.schema.fields,
                                               batch.data.columns)}
        cols = {}
        for f, cd in zip(batch.schema.fields, batch.data.columns):
            comp = (by_name.get(T.array_len_col(f.name))
                    if isinstance(f.dtype, T.ArrayType) else None)
            cols[f.name] = TV(cd.data, cd.validity, f.dtype, f.dictionary,
                              None if comp is None else comp.data)
        return cls(cols, batch.capacity, batch.data.row_mask)


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
    if isinstance(src, T.ArrayType) and isinstance(dst, T.ArrayType):
        return _cast_data(data, src.element, dst.element)
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
    """Host lookup table indexed by device codes (the table copied to the
    codes' device once, ``device_table``)."""
    return device_table(table, codes.device)[codes.long()]


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


# ---- dictionary transforms --------------------------------------------------

#: Arrow copies of recently transformed dictionaries, by identity: a
#: dictionary is an immutable tuple shared by every batch of its column,
#: and one query may transform it more than once (q22's substring)
_ARROW_DICTS: "OrderedDict[int, tuple]" = OrderedDict()
_ARROW_DICTS_MAX = 32
_ARROW_DICTS_LOCK = locks.named_lock("expr.arrow_dicts")


def _arrow_dictionary(dictionary: Tuple[str, ...]):
    """The dictionary as a pyarrow large_string array, cached."""
    import pyarrow as pa

    key = id(dictionary)
    with _ARROW_DICTS_LOCK:
        hit = _ARROW_DICTS.get(key)
        if hit is not None and hit[0] is dictionary:
            _ARROW_DICTS.move_to_end(key)
            return hit[1]
    arr = pa.array(dictionary, type=pa.large_string())
    with _ARROW_DICTS_LOCK:
        _ARROW_DICTS[key] = (dictionary, arr)
        while len(_ARROW_DICTS) > _ARROW_DICTS_MAX:
            _ARROW_DICTS.popitem(last=False)
    return arr


def _dedupe_sorted(values) -> Tuple[np.ndarray, Tuple[str, ...]]:
    """Dedupe, sort and remap transformed entries (a pyarrow string array)
    as whole arrays: the new dictionary in code-point order, as Python
    sorts ``str`` (UTF-8 byte order is code-point order), and each
    entry's int32 code in it."""
    import pyarrow as pa
    import pyarrow.compute as pc

    enc = pc.dictionary_encode(values)
    order = pc.sort_indices(enc.dictionary).to_numpy()
    rank = np.empty(len(order), dtype=np.int32)
    rank[order] = np.arange(len(order), dtype=np.int32)
    codes = rank[enc.indices.to_numpy(zero_copy_only=False)]
    return codes, tuple(enc.dictionary.take(pa.array(order)).to_pylist())


def _dict_transform(tv: TV, fn, n: int, arrow_fn=None) -> TV:
    """A string TV mapped to a new dictionary: each entry through ``fn``
    (a Python ``str`` function) or, where given, ``arrow_fn``, a pyarrow
    kernel over the whole dictionary that equals ``fn`` on every entry;
    then one dedupe, sort and remap (``_dedupe_sorted``) and a gather of
    the rows' codes on the device."""
    import pyarrow as pa

    dictionary = tv.dictionary or ()
    if not dictionary:
        codes = torch.zeros((n,), dtype=torch.int32, device=tv.data.device)
        return TV(codes, tv.validity, T.STRING, ())
    if arrow_fn is not None:
        values = arrow_fn(_arrow_dictionary(dictionary))
    else:
        values = pa.array([fn(s) for s in dictionary], type=pa.large_string())
    table, new_dict = _dedupe_sorted(values)
    return TV(_gather(table, tv.data), tv.validity, T.STRING, new_dict)


def _pad(s: str, width: int, pad: str, left: bool) -> str:
    """lpad/rpad as the reference: the pad repeats from its start, and a
    string at least ``width`` long is cut to it (UTF8String.lpad)."""
    if len(s) >= width:
        return s[:max(0, width)]
    if left:
        return (pad * width)[:width - len(s)] + s
    return (s + pad * width)[:width]


def _translate_fn(matching: str, replace: str):
    """Spark's translate: match characters beyond the replacement's length
    are deleted."""
    table = str.maketrans(matching[:len(replace)], replace[:len(matching)],
                          matching[len(replace):])
    return lambda s: s.translate(table)


def _string_transform(expr: E.StringTransform, tv: TV, n: int) -> TV:
    """upper/lower/trim/ltrim/rtrim/initcap/reverse/repeat/lpad/rpad/
    translate with the reference's Python ``str`` semantics, entry by
    entry (pyarrow's case mapping and trimming differ from them:
    ``'ß'.upper()`` is ``'SS'``)."""
    op, a = expr.op, expr.args
    if op == "translate":
        fn = _translate_fn(str(a[0]), str(a[1]))
    else:
        fn = {
            "upper": str.upper, "lower": str.lower, "trim": str.strip,
            "ltrim": str.lstrip, "rtrim": str.rstrip, "initcap": str.title,
            "reverse": lambda s: s[::-1],
            "repeat": lambda s: s * int(a[0]),
            "lpad": lambda s: _pad(s, int(a[0]), str(a[1]), True),
            "rpad": lambda s: _pad(s, int(a[0]), str(a[1]), False),
        }[op]
    return _dict_transform(tv, fn, n)


def _dict_product(name: str, tvs: List[TV], n: int, null_sentinel: bool,
                  join) -> TV:
    """Shared core of CONCAT and CONCAT_WS: the product of the input
    dictionaries joined entry by entry (at most 2^20 entries, as the
    reference), codes combined by mixed radix, then one dedupe, sort and
    remap. ``join`` maps one tuple of per-input entries (None for a NULL
    when ``null_sentinel``) to the output string; with ``null_sentinel``
    each nullable input's dictionary gains a last None entry that its
    NULL rows take."""
    import pyarrow as pa

    for tv in tvs:
        if not isinstance(tv.dtype, T.StringType):
            raise NotImplementedError(f"{name} supports strings only")
    dicts = [tuple(tv.dictionary or ("",))
             + ((None,) if null_sentinel and tv.validity is not None
                else ())
             for tv in tvs]
    total = 1
    for d in dicts:
        total *= len(d)
    if total > (1 << 20):
        raise NotImplementedError(
            f"{name} dictionary product too large ({total})")
    combo: List[tuple] = [()]
    for d in dicts:
        combo = [t + (s,) for t in combo for s in d]
    table, new_dict = _dedupe_sorted(
        pa.array([join(t) for t in combo], type=pa.large_string()))
    dev = tvs[0].data.device
    codes = torch.zeros((n,), dtype=torch.int64, device=dev)
    for tv, d in zip(tvs, dicts):
        c = (tv.data.to(torch.int64) if len(tv.dictionary or ())
             else torch.zeros((n,), dtype=torch.int64, device=dev))
        if null_sentinel and tv.validity is not None:
            c = torch.where(tv.validity, c,
                            torch.full((), len(d) - 1, dtype=torch.int64,
                                       device=dev))
        codes = codes * len(d) + c
    return TV(_gather(table, codes), None, T.STRING, new_dict)


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
        return _eval_col(expr.col_name, env)

    if isinstance(expr, E.Alias):
        return evaluate(expr.child, env)

    if isinstance(expr, E.TensorUdf):
        tvs = [evaluate(a, env) for a in expr.args]
        validity = None
        for tv in tvs:
            validity = _and_validity(validity, tv.validity)
        out = expr.fn(*[tv.data for tv in tvs])
        return TV(out.to(_torch_dtype(expr.return_type)), validity,
                  expr.return_type, None)

    if isinstance(expr, E.ArrowUdf):
        return _eval_arrow_udf(expr, env)

    if isinstance(expr, E.Neg):
        tv = evaluate(expr.child, env)
        return TV(-tv.data, tv.validity, tv.dtype, None)

    if isinstance(expr, E.TumblingWindow):
        # a batch query: the window start is child - child % width
        return evaluate(expr.as_arith(), env)

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
        tv = evaluate(expr.child, env)
        start, stop = expr.pos - 1, expr.pos - 1 + expr.length
        arrow_fn = None
        if start >= 0 and expr.length >= 0:
            # Python's slice of code points, the same on every entry
            import pyarrow.compute as pc

            arrow_fn = lambda arr: pc.utf8_slice_codeunits(arr, start, stop)
        return _dict_transform(tv, lambda s: s[start:stop], n, arrow_fn)

    if isinstance(expr, E.StringTransform):
        return _string_transform(expr, evaluate(expr.child, env), n)

    if isinstance(expr, E.StrLength):
        import pyarrow.compute as pc

        tv = evaluate(expr.child, env)
        d = tv.dictionary or ()
        table = (pc.utf8_length(_arrow_dictionary(d)).to_numpy()
                 .astype(np.int32) if d else np.zeros(1, dtype=np.int32))
        return TV(_gather(table, tv.data), tv.validity, T.INT32, None)

    if isinstance(expr, E.RegexpExtract):
        rx = re.compile(expr.pattern)

        def extract(s: str) -> str:
            m = rx.search(s)
            if m is None:
                return ""
            try:
                return m.group(expr.group) or ""
            except IndexError:
                return ""

        return _dict_transform(evaluate(expr.child, env), extract, n)

    if isinstance(expr, E.RegexpReplace):
        rx = re.compile(expr.pattern)
        return _dict_transform(evaluate(expr.child, env),
                               lambda s: rx.sub(expr.replacement, s), n)

    if isinstance(expr, E.RegexpLike):
        rx = re.compile(expr.pattern)
        tv = evaluate(expr.child, env)
        table = _dict_table(tv.dictionary or (),
                            lambda s: rx.search(s) is not None)
        return TV(_gather_or_false(table, tv.data), tv.validity, T.BOOLEAN,
                  None)

    if isinstance(expr, E.Concat):
        # a NULL input makes the row NULL (unlike CONCAT_WS)
        tvs = [evaluate(a, env) for a in expr.args]
        out = _dict_product("CONCAT", tvs, n, null_sentinel=False,
                            join="".join)
        validity = None
        for tv in tvs:
            validity = _and_validity(validity, tv.validity)
        return TV(out.data, validity, T.STRING, out.dictionary)

    if isinstance(expr, E.ConcatWs):
        # NULL inputs drop out with their separator; never NULL
        return _dict_product(
            "CONCAT_WS", [evaluate(a, env) for a in expr.args], n,
            null_sentinel=True,
            join=lambda t: expr.sep.join(p for p in t if p is not None))

    if isinstance(expr, E.Abs):
        tv = evaluate(expr.child, env)
        return TV(tv.data.abs(), tv.validity, tv.dtype, None)

    if isinstance(expr, E.UnaryMath):
        return _eval_unary_math(expr, evaluate(expr.child, env))

    if isinstance(expr, E.Round):
        return _eval_round(expr, evaluate(expr.child, env))

    if isinstance(expr, E.Pow):
        lt = evaluate(expr.left, env)
        rt = evaluate(expr.right, env)
        out = torch.pow(_cast_data(lt.data, lt.dtype, T.FLOAT64),
                        _cast_data(rt.data, rt.dtype, T.FLOAT64))
        return TV(out, _and_validity(lt.validity, rt.validity), T.FLOAT64,
                  None)

    if isinstance(expr, E.DateTrunc):
        tv = evaluate(expr.child, env)
        y, m, _ = _civil_from_days(tv.data.to(torch.int64))
        one = torch.ones_like(m)
        if expr.unit in ("year", "yy", "yyyy"):
            days = _days_from_civil(y, one, one)
        elif expr.unit in ("month", "mon", "mm"):
            days = _days_from_civil(y, m, one)
        else:
            raise NotImplementedError(f"date_trunc unit {expr.unit!r}")
        return TV(days.to(torch.int32), tv.validity, T.DATE, None)

    if isinstance(expr, E.LastDay):
        tv = evaluate(expr.child, env)
        y, m, _ = _civil_from_days(tv.data.to(torch.int64))
        days = _days_from_civil(y, m, _days_in_month(y, m))
        return TV(days.to(torch.int32), tv.validity, T.DATE, None)

    if isinstance(expr, E.NullOf):
        tv = evaluate(expr.like, env)
        return TV(tv.data, torch.zeros((n,), dtype=torch.bool,
                                       device=env.device),
                  tv.dtype, tv.dictionary)

    if isinstance(expr, E.Case):
        return _eval_case(expr, env)

    if isinstance(expr, E.Coalesce):
        return _eval_coalesce(expr, env)

    if isinstance(expr, E.ExtractDatePart):
        tv = evaluate(expr.child, env)
        y, m, d = _civil_from_days(tv.data.to(torch.int64))
        part = {"year": y, "month": m, "day": d}[expr.part]
        return TV(part.to(torch.int32), tv.validity, T.INT32, None)

    if isinstance(expr, E.MakeArray):
        return _eval_make_array(expr, env)

    if isinstance(expr, E.Split):
        return _eval_split(expr, evaluate(expr.child, env), n)

    if isinstance(expr, E.Size):
        tv = _array_tv(evaluate(expr.child, env), "size()")
        return TV(tv.lengths.to(torch.int32), tv.validity, T.INT32, None)

    if isinstance(expr, E.ElementAt):
        pair = _map_pair(expr.child, env)
        if pair is not None:
            return _map_get(pair, evaluate(expr.index, env), n)
        return _eval_element_at(expr, env, n)

    if isinstance(expr, E.ArrayContains):
        tv = _array_tv(evaluate(expr.child, env), "array_contains()")
        vt = evaluate(expr.value, env)
        eq = _elements_equal(tv, vt) & _alive(tv)
        return TV(eq.any(dim=1), _and_validity(tv.validity, vt.validity),
                  T.BOOLEAN, None)

    if isinstance(expr, E.HigherOrder):
        return _eval_higher_order(expr, env, n)

    if isinstance(expr, (E.CreateMap, E.MapFromArrays)):
        raise NotImplementedError(
            "a map-typed expression is legal only at the top of a "
            "projection, which expands it into its '#keys'/'#vals' "
            "columns (types.MapType)")

    if isinstance(expr, E.Explode):
        raise NotImplementedError(
            "explode() is a generator: legal only as a SELECT item or in "
            "LATERAL VIEW, not inside another expression")

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


def _eval_arrow_udf(expr, env: Env) -> TV:
    """A host UDF over this batch: its arguments come to the host as
    pyarrow arrays (NULL for NULL and dead rows, strings decoded), its
    result goes back to the device (strings dictionary-encoded)."""
    import pyarrow as pa

    from spark_tpu_torch.columnar.arrow import from_arrow, to_arrow
    from spark_tpu_torch.columnar.batch import Batch, BatchData, ColumnData
    from spark_tpu_torch.types import Field, Schema

    n = env.capacity
    live = (env.mask if env.mask is not None
            else torch.ones((n,), dtype=torch.bool, device=env.device))
    arrays = []
    for a in expr.args:
        tv = evaluate(a, env)
        batch = Batch(Schema((Field("x", tv.dtype, True, tv.dictionary),)),
                      BatchData((ColumnData(tv.data, live & tv.valid_or_true(
                          n)),), torch.ones_like(live)))
        arrays.append(to_arrow(batch).column(0).combine_chunks())
    out = expr.fn(*arrays)
    if len(out) != n:
        raise ValueError(f"arrow UDF returned {len(out)} rows, expected {n}")
    cd = from_arrow(pa.table({"x": out}), capacity=n, device=env.device)
    col = cd.data.columns[0]
    return TV(col.data.to(_torch_dtype(expr.return_type)), col.validity,
              expr.return_type, cd.schema.fields[0].dictionary)


def _eval_col(name: str, env: Env) -> TV:
    """A column of the environment. An array takes its lengths from the
    ``#len`` companion where the environment holds one (row operators
    move the companion as an ordinary column); a bare map name resolves
    to its ``#keys`` component, the map's handle (types.MapType)."""
    tv = env.columns.get(name)
    if tv is None:
        keys = T.map_keys_col(name)
        if keys in env.columns:
            return _eval_col(keys, env)
        raise KeyError(f"column {name!r} not in {sorted(env.columns)}")
    if isinstance(tv.dtype, T.ArrayType):
        comp = env.columns.get(T.array_len_col(name))
        if comp is not None:
            tv = tv._replace(lengths=comp.data)
        elif tv.lengths is None:
            tv = tv._replace(lengths=torch.full(
                (tv.data.shape[0],), tv.data.shape[1], dtype=torch.int32,
                device=tv.data.device))
    return tv


def _array_tv(tv: TV, what: str) -> TV:
    if tv.lengths is None or tv.data.dim() != 2:
        raise NotImplementedError(f"{what} over a non-array value")
    return tv


def _alive(tv: TV) -> torch.Tensor:
    """bool (rows, max_len): the positions inside each row's length."""
    width = tv.data.shape[1]
    pos = torch.arange(width, device=tv.data.device)
    return pos[None, :] < tv.lengths.to(torch.int64)[:, None]


def row_where(cond: torch.Tensor, a: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    """``torch.where`` of a per-row condition over 1-D or 2-D values: the
    condition spans each row, never a column (a (rows,) mask against
    (rows, L) data would broadcast along L)."""
    if a.dim() > 1:
        cond = cond.reshape(cond.shape + (1,) * (a.dim() - 1))
    return torch.where(cond, a, b)


def pad_width(data: torch.Tensor, width: int) -> torch.Tensor:
    """2-D values padded with zeros to ``width`` columns."""
    if data.shape[1] >= width:
        return data
    return torch.nn.functional.pad(data, (0, width - data.shape[1]))


def _coded(tv: TV, table: np.ndarray) -> torch.Tensor:
    """A string TV's codes (1-D or 2-D) re-coded through ``table``."""
    return _gather(table, tv.data) if len(tv.dictionary or ()) else tv.data


def _elements_equal(tv: TV, needle: TV) -> torch.Tensor:
    """bool (rows, max_len): each element of array ``tv`` equal to the
    row's ``needle``, strings through a shared dictionary, numbers in
    their common type (a needle of 10.5 never matches an element 10)."""
    if isinstance(tv.dtype.element, T.StringType):
        _, (ta, tb) = unify_dictionaries((tv.dictionary or (),
                                          needle.dictionary or ()))
        return _coded(tv, ta) == _coded(needle, tb)[:, None]
    ct = T.common_type(tv.dtype.element, needle.dtype)
    return (_cast_data(tv.data, tv.dtype.element, ct)
            == _cast_data(needle.data, needle.dtype, ct)[:, None])


def _eval_make_array(expr: E.MakeArray, env: Env) -> TV:
    """array(a, b, ...): the inputs stacked as columns, in their common
    type; a null input nulls the row (an element cannot be null)."""
    n = env.capacity
    tvs = [evaluate(a, env) for a in expr.args]
    validity = None
    for tv in tvs:
        validity = _and_validity(validity, tv.validity)
    el = tvs[0].dtype
    for tv in tvs[1:]:
        el = T.common_type(el, tv.dtype)
    if isinstance(el, T.StringType):
        union, tables = unify_dictionaries(
            tuple(tv.dictionary or () for tv in tvs))
        cols = [_coded(tv, tb) for tv, tb in zip(tvs, tables)]
        dictionary: Optional[Tuple[str, ...]] = union
    else:
        cols = [_cast_data(tv.data, tv.dtype, el) for tv in tvs]
        dictionary = None
    lengths = torch.full((n,), len(tvs), dtype=torch.int32,
                         device=env.device)
    if validity is not None:
        lengths = torch.where(validity, lengths, torch.zeros_like(lengths))
    return TV(torch.stack(cols, dim=1), validity, T.ArrayType(el),
              dictionary, lengths)


def split_table(dictionary: Tuple[str, ...], delim: str):
    """``s.split(delim)`` of every dictionary entry, as the entries'
    padded word-code table (entries x max words, int32), their word
    counts and the sorted dictionary of the words. pyarrow's literal
    split keeps empty pieces, as Python's ``str.split(sep)`` does."""
    import pyarrow.compute as pc

    parts = pc.split_pattern(_arrow_dictionary(dictionary), delim)
    lens = np.diff(parts.offsets.to_numpy()).astype(np.int32)
    codes, words = _dedupe_sorted(parts.flatten())
    width = max(1, int(lens.max()) if len(lens) else 1)
    table = np.zeros((max(1, len(dictionary)), width), dtype=np.int32)
    if len(codes):
        alive = np.arange(width)[None, :] < lens[:, None]
        table[:len(lens)][alive] = codes
    counts = np.zeros(max(1, len(dictionary)), dtype=np.int32)
    counts[:len(lens)] = lens
    return table, counts, words


def _eval_split(expr: E.Split, tv: TV, n: int) -> TV:
    """split(s, delim) over the host dictionary (``split_table``), then
    one gather of the rows' word codes and counts on the device."""
    if not isinstance(tv.dtype, T.StringType):
        raise NotImplementedError("split() needs a string input")
    dictionary = tv.dictionary or ()
    table, counts, words = split_table(dictionary, expr.delim)
    codes = (tv.data if dictionary
             else torch.zeros((n,), dtype=torch.int32, device=tv.data.device))
    return TV(_gather(table, codes), tv.validity, T.ArrayType(T.STRING),
              words, _gather(counts, codes))


def _eval_element_at(expr: E.ElementAt, env: Env, n: int) -> TV:
    """element_at(a, i) (1-based, negative from the end) or ``a[i]``
    (0-based); NULL out of range."""
    tv = _array_tv(evaluate(expr.child, env), "element_at()")
    it = evaluate(expr.index, env)
    idx = it.data.to(torch.int64)
    lens = tv.lengths.to(torch.int64)
    if expr.sql_subscript:
        pos = idx
        ok = (pos >= 0) & (pos < lens)
    else:
        pos = torch.where(idx > 0, idx - 1, lens + idx)
        ok = (pos >= 0) & (pos < lens) & (idx != 0)
    pos = pos.clamp(0, max(tv.data.shape[1] - 1, 0))
    got = torch.gather(tv.data, 1, pos[:, None])[:, 0]
    validity = tv.valid_or_true(n) & it.valid_or_true(n) & ok
    return TV(got, validity, tv.dtype.element, tv.dictionary)


def _eval_higher_order(expr: E.HigherOrder, env: Env, n: int) -> TV:
    """transform / filter / exists / forall / aggregate over the padded
    layout (reference: ``spark_tpu/expr/compiler.py:1116``): the lambda
    body is evaluated once over the rows x max_len element plane, with
    the outer columns it reads repeated per element. As in the
    reference, a NULL predicate counts as false in exists, forall and
    filter, and transform refuses a nullable body (an element cannot be
    null)."""
    tv = _array_tv(evaluate(expr.child, env), f"{expr.kind}()")
    if expr.kind == "aggregate":
        return _eval_array_aggregate(expr, tv, env, n)
    width = tv.data.shape[1]
    alive = _alive(tv)
    params = expr.fn.params
    cols: Dict[str, TV] = {}
    for name in expr.fn.references():
        otv = evaluate(E.Col(name), env)
        if otv.data.dim() != 1:
            raise NotImplementedError(
                f"{expr.kind}(): an outer array column ({name}) in the "
                "lambda body")
        cols[name] = TV(otv.data.repeat_interleave(width),
                        None if otv.validity is None
                        else otv.validity.repeat_interleave(width),
                        otv.dtype, otv.dictionary)
    cols[params[0]] = TV(tv.data.reshape(-1), None, tv.dtype.element,
                         tv.dictionary)
    if len(params) > 1:  # (x, i) -> ...: the 0-based position
        cols[params[1]] = TV(
            torch.arange(width, dtype=torch.int32,
                         device=env.device).repeat(n), None, T.INT32, None)
    res = evaluate(expr.fn.body, Env(cols, n * width, device=env.device))

    if expr.kind == "transform":
        if res.validity is not None:
            raise NotImplementedError(
                "transform() with a nullable lambda result: an array "
                "element cannot be null (coalesce() inside the lambda)")
        return TV(res.data.reshape(n, width), tv.validity,
                  T.ArrayType(res.dtype), res.dictionary, tv.lengths)
    pred = (res.data & res.valid_or_true(n * width)).reshape(n, width)
    if expr.kind == "filter":
        keep = pred & alive
        # a stable compaction of each row: kept elements slide left
        perm = torch.argsort((~keep).to(torch.uint8), dim=1, stable=True)
        return TV(torch.gather(tv.data, 1, perm), tv.validity, tv.dtype,
                  tv.dictionary, keep.sum(dim=1).to(torch.int32))
    if expr.kind == "exists":
        return TV((pred & alive).any(dim=1), tv.validity, T.BOOLEAN, None)
    if expr.kind == "forall":
        return TV((pred | ~alive).all(dim=1), tv.validity, T.BOOLEAN, None)
    raise NotImplementedError(f"higher-order function {expr.kind!r}")


def _eval_array_aggregate(expr: E.HigherOrder, tv: TV, env: Env,
                          n: int) -> TV:
    """aggregate(a, zero, (acc, x) -> ..., [acc -> ...]): a fold over the
    max_len positions, each step a whole-column op over all rows, the
    accumulator kept where the position is past the row's length."""
    acc = evaluate(expr.zero, env)
    if isinstance(acc.dtype, T.StringType):
        raise NotImplementedError("aggregate() with a string accumulator")
    acc_name, x_name = expr.fn.params
    lens = tv.lengths.to(torch.int64)
    for j in range(tv.data.shape[1]):
        cols = dict(env.columns)
        cols[acc_name] = acc
        cols[x_name] = TV(tv.data[:, j], None, tv.dtype.element,
                          tv.dictionary)
        new = evaluate(expr.fn.body, Env(cols, n, device=env.device))
        ct = T.common_type(acc.dtype, new.dtype)
        step = j < lens
        data = torch.where(step, _cast_data(new.data, new.dtype, ct),
                           _cast_data(acc.data, acc.dtype, ct))
        validity = None
        if acc.validity is not None or new.validity is not None:
            validity = torch.where(step, new.valid_or_true(n),
                                   acc.valid_or_true(n))
        acc = TV(data, validity, ct, None)
    if expr.finish is not None:
        cols = dict(env.columns)
        cols[expr.finish.params[0]] = acc
        acc = evaluate(expr.finish.body, Env(cols, n, device=env.device))
    return TV(acc.data, _and_validity(tv.validity, acc.validity), acc.dtype,
              acc.dictionary)


def _map_pair(child: E.Expression, env: Env):
    """(keys TV, values TV) when ``child`` is a map: a map column's
    component pair, ``map(...)`` or ``map_from_arrays(...)``; else None."""
    child = E.strip_alias(child)
    if isinstance(child, E.CreateMap):
        return (evaluate(E.MakeArray(child.args[::2]), env),
                evaluate(E.MakeArray(child.args[1::2]), env))
    if isinstance(child, E.MapFromArrays):
        return (_array_tv(evaluate(child.keys, env), "map_from_arrays()"),
                _array_tv(evaluate(child.vals, env), "map_from_arrays()"))
    if not isinstance(child, E.Col):
        return None
    base = T.map_base_name(child.col_name)
    if base is None:
        base = child.col_name
    kc, vc = T.map_keys_col(base), T.map_vals_col(base)
    if kc not in env.columns or vc not in env.columns:
        return None
    if child.col_name not in (base, kc):
        return None  # 'm#vals' itself is an ordinary array
    return _eval_col(kc, env), _eval_col(vc, env)


def _map_get(pair, needle: TV, n: int) -> TV:
    """element_at(m, k) and m[k]: the first key equal to the needle,
    its value gathered from the values plane; NULL when missing
    (reference: GetMapValue)."""
    ktv, vtv = pair
    _array_tv(ktv, "element_at()")
    eq = _elements_equal(ktv, needle) & _alive(ktv)
    found = eq.any(dim=1)
    pos = torch.argmax(eq.to(torch.uint8), dim=1)
    out = torch.gather(vtv.data, 1, pos[:, None])[:, 0]
    validity = ktv.valid_or_true(n) & needle.valid_or_true(n) & found
    return TV(out, validity, vtv.dtype.element, vtv.dictionary)


def evaluate_map_pair(expr: E.Expression, env: Env):
    """A map-typed projection item as its (keys TV, values TV) pair: the
    point where a Project expands ``map(...)``, ``map_from_arrays`` and
    map column references into ``#keys``/``#vals`` columns."""
    pair = _map_pair(expr, env)
    if pair is None:
        raise NotImplementedError(f"not a map-typed expression: {expr}")
    return pair


def _eval_unary_math(expr: E.UnaryMath, tv: TV) -> TV:
    """floor/ceil/sign/sqrt/exp/ln/log10 as the reference, except that a
    decimal computes on its value: floor and ceil are exact integer
    divisions by 10^scale (INT64), sign is -1, 0 or 1 scaled into the
    decimal's type, and the others read the float64 value."""
    x, op = tv.data, expr.op
    dec = isinstance(tv.dtype, T.DecimalType)
    if op in ("floor", "ceil"):
        if dec:
            f = 10 ** tv.dtype.scale
            out = _floordiv(x, f) if op == "floor" else -_floordiv(-x, f)
        elif tv.dtype.is_integral:
            # identity on integers: a float64 round trip would corrupt
            # values above 2^53
            out = x.to(torch.int64)
        else:
            xf = x.to(torch.float64)
            out = (torch.floor(xf) if op == "floor"
                   else torch.ceil(xf)).to(torch.int64)
        return TV(out, tv.validity, T.INT64, None)
    if op == "sign":
        out = torch.sign(x)
        if dec:
            out = out * 10 ** tv.dtype.scale
        elif x.is_floating_point():
            out = torch.where(torch.isnan(x), x, out)  # jnp.sign keeps NaN
        return TV(out, tv.validity, tv.dtype, None)
    fn = {"sqrt": torch.sqrt, "exp": torch.exp, "ln": torch.log,
          "log10": torch.log10}[op]
    return TV(fn(_cast_data(x, tv.dtype, T.FLOAT64)), tv.validity, T.FLOAT64,
              None)


def _eval_round(expr: E.Round, tv: TV) -> TV:
    """ROUND with HALF_UP ties. A decimal rounds exactly in scaled int64
    to ``round_decimal_type``; an integer is unchanged (a negative scale
    rounds it through float64, as the reference); a float gives
    sign(x) * floor(|x| * 10^s + 0.5) / 10^s in float64."""
    if isinstance(tv.dtype, T.DecimalType):
        out_dt = E.round_decimal_type(tv.dtype, expr.scale)
        data, scale = tv.data, tv.dtype.scale
        if expr.scale < scale:
            data = _round_half_up_div(data, 10 ** (scale - expr.scale))
            scale = expr.scale
            if scale < 0:
                data = data * 10 ** (-scale)
                scale = 0
        data = _cast_data(data, T.DecimalType(T.DecimalType.MAX_PRECISION,
                                              scale), out_dt)
        return TV(data, tv.validity, out_dt, None)
    if tv.dtype.is_integral and expr.scale >= 0:
        return tv
    x = tv.data.to(torch.float64)
    f = 10.0 ** expr.scale
    out = torch.sign(x) * torch.floor(x.abs() * f + 0.5) / f
    if tv.dtype.is_integral:
        return TV(out.to(torch.int64), tv.validity, T.INT64, None)
    return TV(out, tv.validity, T.FLOAT64, None)


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


_MONTH_DAYS = np.array([31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31],
                       dtype=np.int64)


def _days_in_month(y: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    lengths = device_table(_MONTH_DAYS, y.device)
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


def _parse_timestamp_micros(s: str):
    """ISO timestamp string -> microseconds since the epoch, a naive one
    read in the host's local timezone as the reference reads it (ROADMAP
    Notes); None when unparseable."""
    try:
        return int(datetime.datetime.fromisoformat(s).timestamp() * 1_000_000)
    except ValueError:
        return None


def _timestamp_coerce(tv: TV, n: int) -> TV:
    """A string compared with a timestamp coerces to a timestamp via its
    dictionary; an unparseable entry is NULL."""
    entries = tv.dictionary or ()
    parsed = [_parse_timestamp_micros(s) for s in entries]
    vals = np.array([v if v is not None else 0 for v in parsed] or [0],
                    dtype=np.int64)
    ok_tab = np.array([v is not None for v in parsed] or [False])
    if entries:
        data, ok = _gather(vals, tv.data), _gather(ok_tab, tv.data)
    else:
        data = tv.data.to(torch.int64)
        ok = torch.zeros((n,), dtype=torch.bool, device=tv.data.device)
    return TV(data, _and_validity(tv.validity, ok), T.TIMESTAMP, None)


def _eval_cmp(expr: E.Cmp, env: Env) -> TV:
    n = env.capacity
    lt = evaluate(expr.left, env)
    rt = evaluate(expr.right, env)

    # a string compared with a date or timestamp takes the temporal type
    # (reference: _temporal_coerce in _eval_cmp)
    coerce = {T.DateType: _date_coerce, T.TimestampType: _timestamp_coerce}
    if type(lt.dtype) in coerce and isinstance(rt.dtype, T.StringType):
        rt = coerce[type(lt.dtype)](rt, n)
    elif type(rt.dtype) in coerce and isinstance(lt.dtype, T.StringType):
        lt = coerce[type(rt.dtype)](lt, n)
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


def _is_stringish(dt: DataType) -> bool:
    """Strings and arrays of strings: values coded in a dictionary."""
    if isinstance(dt, T.ArrayType):
        dt = dt.element
    return isinstance(dt, T.StringType)


def _blend_inputs(tvs: List[TV], out_dt: DataType):
    """The TVs of a CASE or COALESCE in the output's coding: strings (and
    string arrays) re-coded into their dictionaries' union, numbers cast
    to ``out_dt``, arrays padded to the widest. Returns (datas, lengths
    or None per TV, the output dictionary)."""
    out_dict: Optional[Tuple[str, ...]] = None
    if _is_stringish(out_dt):
        out_dict, tables = unify_dictionaries(
            tuple(tv.dictionary or () for tv in tvs))
        datas = [_coded(tv, tb) for tv, tb in zip(tvs, tables)]
    else:
        datas = [_cast_data(tv.data, tv.dtype, out_dt) for tv in tvs]
    if isinstance(out_dt, T.ArrayType):
        width = max(d.shape[1] for d in datas)
        datas = [pad_width(d, width) for d in datas]
        tvs = [_array_tv(tv, "CASE/COALESCE") for tv in tvs]
    return datas, [tv.lengths for tv in tvs], out_dict


def _eval_case(expr: E.Case, env: Env) -> TV:
    n = env.capacity
    dev = env.device
    conds = [evaluate(c, env) for c, _ in expr.branches]
    vals = [evaluate(v, env) for _, v in expr.branches]
    else_tv = (evaluate(expr.else_value, env)
               if expr.else_value is not None else None)
    strings = [v.dtype for v in vals if _is_stringish(v.dtype)]
    if strings:
        out_dt = strings[0]  # branches re-coded into one dictionary
    else:
        out_dt = vals[0].dtype
        for v in vals[1:] + ([else_tv] if else_tv is not None else []):
            out_dt = T.common_type(out_dt, v.dtype)
    inputs = vals + ([else_tv] if else_tv is not None else [])
    datas, lengths, out_dict = _blend_inputs(inputs, out_dt)
    arr = isinstance(out_dt, T.ArrayType)

    if else_tv is not None:
        data, valid, lens = datas[-1], else_tv.validity, lengths[-1]
    else:
        shape = (n, datas[0].shape[1]) if arr else (n,)
        data = torch.zeros(shape, dtype=datas[0].dtype, device=dev)
        valid = torch.zeros((n,), dtype=torch.bool, device=dev)
        lens = (torch.zeros((n,), dtype=torch.int32, device=dev) if arr
                else None)

    matched = torch.zeros((n,), dtype=torch.bool, device=dev)
    for c, v, vd, vl in zip(conds, vals, datas, lengths):
        fire = c.data & c.valid_or_true(n) & ~matched
        data = row_where(fire, vd, data)
        valid_arr = valid if valid is not None else torch.ones(
            (n,), dtype=torch.bool, device=dev)
        valid = torch.where(fire, v.valid_or_true(n), valid_arr)
        if arr:
            lens = torch.where(fire, vl.to(torch.int32), lens.to(torch.int32))
        matched = matched | fire
    return TV(data, valid, out_dt, out_dict, lens)


def _eval_coalesce(expr: E.Coalesce, env: Env) -> TV:
    n = env.capacity
    tvs = [evaluate(a, env) for a in expr.args]
    out_dt = tvs[0].dtype
    datas, lengths, out_dict = _blend_inputs(tvs, out_dt)
    if out_dict is None:
        out_dict = tvs[0].dictionary
    arr = isinstance(out_dt, T.ArrayType)
    data, valid, lens = datas[-1], tvs[-1].validity, lengths[-1]
    for tv, d, ln in zip(reversed(tvs[:-1]), reversed(datas[:-1]),
                         reversed(lengths[:-1])):
        v = tv.valid_or_true(n)
        data = row_where(v, d, data)
        if arr:
            lens = torch.where(v, ln.to(torch.int32), lens.to(torch.int32))
        # valid where this arg is valid or the later fallback was
        valid = None if valid is None else (v | valid)
    return TV(data, valid, out_dt, out_dict, lens)
