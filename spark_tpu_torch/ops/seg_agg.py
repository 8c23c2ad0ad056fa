"""One-pass grouped (segmented) reductions: hand-written CUDA kernels for
Hopper, each beside its plain PyTorch version.

- ``seg_sum`` replaces ``spark_tpu/ops/pallas_agg.py:_kernel`` (wrapper
  ``pallas_seg_sum``). Three modes, chosen by the arguments: the grouped
  count of live rows (``exact_int``; int64), the exact grouped int64 sum
  (int64 data; wraps as ``index_add_`` on int64 does) and the grouped
  float32 sum (float32 data). The engine reaches it through counts
  (``physical/kernels.seg_count``) and int64 sums (``seg_sum``).
- ``seg_minmax`` replaces ``pallas_agg.py:_minmax_kernel`` (wrapper
  ``pallas_seg_minmax``): the grouped float32 min or max.
- ``seg_fsum`` is the port's kernel for the float branch of the
  reference's grouped sum (``jax.ops.segment_sum`` in
  ``spark_tpu/physical/kernels.py:seg_sum``), which has no Pallas
  kernel: a grouped float64 or float32 sum, exact until one rounding to
  nearest-even at the end, so its bits depend only on the multiset of
  live values in each group (a long accumulator of 32-bit digits at
  absolute positions, one read of the input, ``csrc/seg_fsum.cu``).
  ``physical/kernels.seg_sum`` sends every float sum over more than one
  group on a CUDA tensor to it. On the CPU the engine keeps
  ``index_add_``, which equals the reference's ``segment_sum`` bit for
  bit there, so the card's float groups differ from the CPU run's by
  the CPU's rounding only.

Semantics, shared with the reference: a row contributes when its mask is
true and ``0 <= seg < num_segments``. Empty groups sum to 0, count 0 and
have min +inf / max -inf; a group that holds a NaN has min/max NaN. On the
card a group holding both -0.0 and +0.0 has min -0.0 and max +0.0. A
float sum of a group holding a NaN, or both +inf and -inf, is NaN.

The kernels are bandwidth-bound: each reads every row once (5 bytes a row
for a count, 9 for a float32 sum or min/max, 13 for an int64 sum or a
float64 ``seg_fsum``), about 1.5, 2.7 and 3.9 us per million rows at
3.35 TB/s on an H100 SXM. ``csrc/seg_agg.cu`` and ``csrc/seg_fsum.cu``
hold the designs. Every ``seg_sum`` and ``seg_minmax`` call is one
kernel launch; a ``seg_fsum`` call is a memset and two kernels, of
which only the first reads the input (the second reads the K x D digit
words).

A wrapper given CPU tensors computes the plain version; given CUDA
tensors it launches the kernel or raises. Each wrapper counts its kernel
launches in ``<wrapper>.launches`` and, by mode, in
``<wrapper>.mode_launches``; ``reset_launches()`` sets all to 0. A call
made while the current stream captures a CUDA graph (``physical/graphs.py``)
runs nothing then and is not counted: the graph runs its launch at each
replay, without the wrapper. The kernels count their own runs on the
device (block 0 of every launch adds one), so ``device_runs()`` reads the
launches that ran, replayed ones included. Where ``call_log`` is a list,
each call appends its arguments and result there, so the calls a graph
replays can be held against the plain versions.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

MAX_K = 1024     # shared-memory accumulator bound, as the reference's _MAX_K
MAX_ROWS = 1 << 31
SUM_MODES = {"count": 0, "sum_f32": 1, "sum_i64": 2}  # seg_sum_launch's


def seg_sum_plain(data: Optional[torch.Tensor], seg: torch.Tensor,
                  mask: torch.Tensor, num_segments: int,
                  exact_int: bool = False) -> torch.Tensor:
    """Plain PyTorch version of ``seg_sum``."""
    live = mask & (seg >= 0) & (seg < num_segments)
    idx = seg[live].long()
    if exact_int:
        return torch.bincount(idx, minlength=num_segments).to(torch.int64)
    dtype = torch.int64 if data.dtype == torch.int64 else torch.float32
    out = torch.zeros(num_segments, dtype=dtype, device=seg.device)
    return out.index_add_(0, idx, data[live].to(dtype))


def seg_minmax_plain(data: torch.Tensor, seg: torch.Tensor,
                     mask: torch.Tensor, num_segments: int,
                     is_max: bool = False) -> torch.Tensor:
    """Plain PyTorch version of ``seg_minmax``."""
    live = mask & (seg >= 0) & (seg < num_segments)
    idx = seg[live].long()
    vals = data[live].to(torch.float32)
    ident = float("-inf") if is_max else float("inf")
    out = torch.full((num_segments,), ident, dtype=torch.float32,
                     device=seg.device)
    out.scatter_reduce_(0, idx, vals, "amax" if is_max else "amin",
                        include_self=True)
    has_nan = torch.zeros(num_segments, dtype=torch.bool, device=seg.device)
    has_nan[idx[torch.isnan(vals)]] = True
    return out.masked_fill_(has_nan, float("nan"))


#: digit words a group takes in seg_fsum's long accumulator, by dtype
#: (``csrc/seg_fsum.cu``: 32-bit digits at absolute positions)
FSUM_DIGITS = {torch.float64: 66, torch.float32: 9}
# per dtype: mantissa bits, largest exponent field, digits a value spans
_FSUM_FMT = {torch.float64: (52, 0x7FF, 3), torch.float32: (23, 0xFF, 2)}
_LOW32 = 0xFFFFFFFF


def _fsum_digits(x: torch.Tensor):
    """Each finite nonzero x as signed 32-bit digits at absolute
    positions: |x| / 2^-Q = m << (q mod 32) at digit q >> 5, with m the
    integer significand and q = max(e - 1, 0) from the exponent field e
    (Q: the exponent of the type's smallest subnormal). Returns (digit
    index d, int64[n, digits] digits from d up, each below 2^32, with x's
    sign)."""
    mant, _, per_value = _FSUM_FMT[x.dtype]
    bits = x.view(torch.int64 if x.dtype == torch.float64 else torch.int32)
    bits = bits.to(torch.int64)
    e = (bits >> mant) & _FSUM_FMT[x.dtype][1]
    m = (bits & ((1 << mant) - 1)) | torch.where(e > 0, 1 << mant, 0)
    q = (e - 1).clamp(min=0)
    o = q & 31
    lo = (m & _LOW32) << o           # below 2^63
    s = (lo >> 32) + ((m >> 32) << o)
    digits = torch.stack([lo & _LOW32, s & _LOW32, s >> 32][:per_value], 1)
    return q >> 5, torch.where((bits < 0)[:, None], -digits, digits)


def _fsum_finish(acc: torch.Tensor, nan: torch.Tensor, pinf: torch.Tensor,
                 ninf: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Each group's sum from its digit words (int64[D, K]) and flags,
    rounded once to nearest-even into ``dtype``: ``seg_fsum.cu:finish``,
    vectorised over the K groups."""
    mant, exp_max, _ = _FSUM_FMT[dtype]
    p = mant + 1
    n_digits, k = acc.shape
    zero = torch.zeros(k, dtype=torch.int64, device=acc.device)
    c = zero
    for i in range(n_digits):
        c = (acc[i] + c) >> 32
    neg = c < 0  # the sum's sign: the carry out of the top word
    acc = torch.where(neg, -acc, acc)
    # normalized digits r_0..r_D of |sum|: keep the top nonzero one (h0 at
    # index top), the two below it and whether any lower digit is nonzero
    c = zero
    top = zero - 1
    h0, h1, h2, p1, p2 = zero, zero, zero, zero, zero
    below = lower = torch.zeros(k, dtype=torch.bool, device=acc.device)
    for i in range(n_digits + 1):
        if i < n_digits:
            t = acc[i] + c
            r, c = t & _LOW32, t >> 32
        else:
            r = c
        hit = r != 0
        top = torch.where(hit, i, top)
        h0, h1, h2 = (torch.where(hit, a, b)
                      for a, b in ((r, h0), (p1, h1), (p2, h2)))
        below = torch.where(hit, lower, below)
        lower = lower | (p2 != 0)
        p2, p1 = p1, r
    # bits of h0 (1..32), read from its exact float64 exponent
    nb = (h0.clamp(min=1).to(torch.float64).view(torch.int64) >> 52) - 1022
    length = 32 * top + nb  # bits of |sum| / 2^-Q
    sh = 32 - nb            # left-align h0:h1:h2 to 96 bits a0:a1:a2
    a0 = ((h0 << sh) | (h1 >> (32 - sh))) & _LOW32
    a1 = ((h1 << sh) | (h2 >> (32 - sh))) & _LOW32
    a2 = (h2 << sh) & _LOW32
    if p > 32:  # the leading p bits, the round bit, the sticky bits
        m = (a0 << (p - 32)) | (a1 >> (64 - p))
        rnd = (a1 >> (63 - p)) & 1
        sticky = ((a1 & ((1 << (63 - p)) - 1)) | a2) != 0
    else:
        m = a0 >> (32 - p)
        rnd = (a0 >> (31 - p)) & 1
        sticky = ((a0 & ((1 << (31 - p)) - 1)) | a1 | a2) != 0
    sticky = sticky | below
    inf = exp_max << mant
    ex = (length - p).clamp(max=exp_max - 1)
    rounded = (ex.clamp(min=0) << mant) + m + (rnd & (sticky | (m & 1)).long())
    bits = torch.where(length <= p, m >> (p - length).clamp(0, 63),
                       rounded.clamp(max=inf))  # exact below 2^p
    sign = -(1 << 63) if dtype == torch.float64 else 1 << 31  # as int64
    bits = torch.where(top < 0, zero, bits | torch.where(neg, sign, 0))
    qnan = (exp_max << mant) | (1 << (mant - 1))
    bits = torch.where(pinf, inf, bits)
    bits = torch.where(ninf, sign | inf, bits)
    bits = torch.where(nan | (pinf & ninf), qnan, bits)
    if dtype == torch.float64:
        return bits.view(torch.float64)
    bits = bits - ((bits >> 31) << 32)  # uint32 bits as int32
    return bits.to(torch.int32).view(torch.float32)


def seg_fsum_plain(data: torch.Tensor, seg: torch.Tensor, mask: torch.Tensor,
                   num_segments: int) -> torch.Tensor:
    """Plain PyTorch version of ``seg_fsum``: the same digits, added
    with an exact int64 ``index_add_`` into the long accumulator, and the
    same carry and rounding steps, so it equals the kernel bit for bit:
    each group's exact sum rounded once to nearest-even."""
    k = num_segments
    dev = seg.device
    n_digits = FSUM_DIGITS[data.dtype]
    live = mask & (seg >= 0) & (seg < k)
    idx = seg[live].long()
    x = data[live]
    flags = []
    for hit in (torch.isnan(x), x == float("inf"), x == float("-inf")):
        flag = torch.zeros(k, dtype=torch.bool, device=dev)
        flag[idx[hit]] = True
        flags.append(flag)
    fin = torch.isfinite(x)
    d, digits = _fsum_digits(x[fin])
    idx = idx[fin]
    acc = torch.zeros(n_digits * k, dtype=torch.int64, device=dev)
    for j in range(digits.shape[1]):
        acc.index_add_(0, (d + j) * k + idx, digits[:, j])
    return _fsum_finish(acc.view(n_digits, k), *flags, data.dtype)


def _check(data: Optional[torch.Tensor], seg: torch.Tensor,
           mask: torch.Tensor, num_segments: int,
           data_dtypes=(torch.float32,)) -> None:
    if num_segments is not None and not 1 <= num_segments <= MAX_K:
        raise ValueError(f"num_segments {num_segments} outside [1, {MAX_K}]")
    n = seg.shape[0]
    if n >= MAX_ROWS:
        raise ValueError(f"{n} rows: the kernels take fewer than 2^31")
    want = [(seg, (torch.int32,), "seg"), (mask, (torch.bool,), "mask")]
    if data is not None:
        want.append((data, data_dtypes, "data"))
    for t, dtypes, name in want:
        if t.device != seg.device:
            raise ValueError(f"{name} on {t.device}, seg on {seg.device}")
        if t.dtype not in dtypes:
            raise TypeError(f"{name} must be one of {dtypes}, got {t.dtype}")
        if t.dim() != 1 or t.shape[0] != n:
            raise ValueError(f"{name} must be 1-D of length {n}, "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _lib():
    from spark_tpu_torch.ops._build import library

    lib = library("seg_agg")
    if not getattr(lib, "_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.seg_sum_f32_blocks.argtypes = []
        lib.seg_sum_f32_blocks.restype = i
        lib.seg_sum_launch.argtypes = [p, p, p, ll, i, i, p, p, p]
        lib.seg_sum_launch.restype = i
        lib.seg_minmax_launch.argtypes = [p, p, p, ll, i, i, p, p]
        lib.seg_minmax_launch.restype = i
        lib.seg_agg_runs.argtypes = [p]
        lib.seg_agg_runs.restype = i
        lib.f32_blocks = lib.seg_sum_f32_blocks()
        lib._typed = True
    return lib


def _fsum_lib():
    from spark_tpu_torch.ops._build import library

    lib = library("seg_fsum")
    if not getattr(lib, "_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.seg_fsum_launch.argtypes = [p, i, p, p, ll, i, p, p, p]
        lib.seg_fsum_launch.restype = i
        lib.seg_fsum_runs.argtypes = [p]
        lib.seg_fsum_runs.restype = i
        lib._typed = True
    return lib


def _stream(dev: torch.device) -> int:
    """PyTorch's current stream on ``dev`` as a raw cudaStream_t (the
    call Triton's launchers use: cheaper than building a Stream)."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


def seg_sum(data: Optional[torch.Tensor], seg: torch.Tensor,
            mask: torch.Tensor, num_segments: int,
            exact_int: bool = False) -> torch.Tensor:
    """Grouped sum of ``data`` by ``seg`` (int32[N]) over live rows
    (``mask``, bool[N]): float32 data -> float32[num_segments], int64
    data -> int64[num_segments] (exact, wrapping); with ``exact_int``,
    the count of live rows per group -> int64, and ``data`` is not read
    (pass None). Bit-identical from run to run on the card."""
    if exact_int:
        data = None
    if seg.device.type == "cpu":
        return seg_sum_plain(data, seg, mask, num_segments, exact_int)
    if data is None and not exact_int:
        raise ValueError("seg_sum needs data unless exact_int")
    _check(data, seg, mask, num_segments, (torch.float32, torch.int64))
    lib = _lib()
    k, dev = num_segments, seg.device
    if exact_int:
        mode, partials = "count", None
        out = torch.empty(k, dtype=torch.int64, device=dev)
    elif data.dtype == torch.int64:
        mode, partials = "sum_i64", None
        out = torch.empty(k, dtype=torch.int64, device=dev)
    else:  # the last word of out is the kernel's finished-block counter
        mode = "sum_f32"
        partials = torch.empty(lib.f32_blocks * k, dtype=torch.float32,
                               device=dev)
        out = torch.empty(k + 1, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.seg_sum_launch(
            None if data is None else data.data_ptr(), seg.data_ptr(),
            mask.data_ptr(), seg.shape[0], k, SUM_MODES[mode],
            None if partials is None else partials.data_ptr(),
            out.data_ptr(), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"seg_sum_launch ({mode}) failed: CUDA error {rc}")
    _count(seg_sum, mode)
    _log("seg_sum", out[:k], data=data, seg=seg, mask=mask, num_segments=k,
         exact_int=exact_int)
    return out[:k]


def seg_minmax(data: torch.Tensor, seg: torch.Tensor, mask: torch.Tensor,
               num_segments: int, is_max: bool = False) -> torch.Tensor:
    """Grouped min (or max) of ``data`` (float32[N]) by ``seg`` over live
    rows -> float32[num_segments]; empty groups +inf (min) / -inf (max),
    groups holding a NaN NaN."""
    if seg.device.type == "cpu":
        return seg_minmax_plain(data, seg, mask, num_segments, is_max)
    _check(data, seg, mask, num_segments)
    lib = _lib()
    dev = seg.device
    # the last word of out is the kernel's finished-block counter
    out = torch.empty(num_segments + 1, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.seg_minmax_launch(
            data.data_ptr(), seg.data_ptr(), mask.data_ptr(), seg.shape[0],
            num_segments, int(is_max), out.data_ptr(), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"seg_minmax_launch failed: CUDA error {rc}")
    _count(seg_minmax, "max" if is_max else "min")
    _log("seg_minmax", out[:num_segments], data=data, seg=seg, mask=mask,
         num_segments=num_segments, is_max=is_max)
    return out[:num_segments]


def seg_fsum(data: torch.Tensor, seg: torch.Tensor, mask: torch.Tensor,
             num_segments: int) -> torch.Tensor:
    """Grouped sum of float64 or float32 ``data`` by ``seg`` (int32[N])
    over live rows (``mask``, bool[N]), any ``num_segments`` >= 1 ->
    data's dtype[num_segments]: each group's exact sum, rounded once to
    nearest-even, so its bits depend only on the group's live values (not
    on the launch, the row order or where dead rows lie). A group holding
    a NaN, or both infinities, is NaN; one holding one infinity is that
    infinity; an empty group, or one summing to exactly zero, is +0.0."""
    if seg.device.type == "cpu":
        return seg_fsum_plain(data, seg, mask, num_segments)
    if num_segments < 1 or num_segments >= MAX_ROWS:
        raise ValueError(f"num_segments {num_segments} outside [1, 2^31)")
    _check(data, seg, mask, None, (torch.float64, torch.float32))
    lib = _fsum_lib()
    k, dev = num_segments, seg.device
    # the digit words [D][K], then the flags (int32[K])
    scratch = torch.empty(FSUM_DIGITS[data.dtype] * k + (k + 1) // 2,
                          dtype=torch.int64, device=dev)
    out = torch.empty(k, dtype=data.dtype, device=dev)
    is_f64 = data.dtype == torch.float64
    with torch.cuda.device(dev):
        rc = lib.seg_fsum_launch(
            data.data_ptr(), int(is_f64), seg.data_ptr(), mask.data_ptr(),
            seg.shape[0], k, scratch.data_ptr(), out.data_ptr(), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"seg_fsum_launch failed: CUDA error {rc}")
    _count(seg_fsum, "fsum_f64" if is_f64 else "fsum_f32")
    _log("seg_fsum", out, data=data, seg=seg, mask=mask, num_segments=k)
    return out


#: where a list, each launch appends (wrapper name, its arguments by
#: name, its result): the tensors themselves, not copies
call_log = None


def _log(name: str, out: torch.Tensor, **args) -> None:
    if call_log is not None:
        call_log.append((name, args, out))


def _count(fn, mode: str) -> None:
    """One launch of ``fn``'s kernel in ``mode``, unless a graph capture
    only recorded it."""
    if not torch.cuda.is_current_stream_capturing():
        fn.launches += 1
        fn.mode_launches[mode] += 1


#: ``device_runs`` keys, in the order of each library's counter array
_AGG_RUN_MODES = ("count", "sum_i64", "min", "max", "sum_f32")
_FSUM_RUN_MODES = ("fsum_f64", "fsum_f32")


def device_runs(dev=None) -> dict:
    """Runs of each kernel on ``dev`` (default: the current device), by
    mode, as the kernels counted them there since their library was
    loaded in this process. Waits for the device."""
    dev = torch.device("cuda" if dev is None else dev)
    out = {}
    for lib, fn, modes in ((_lib(), "seg_agg_runs", _AGG_RUN_MODES),
                           (_fsum_lib(), "seg_fsum_runs", _FSUM_RUN_MODES)):
        buf = (ctypes.c_ulonglong * len(modes))()
        with torch.cuda.device(dev):
            torch.cuda.synchronize()
            rc = getattr(lib, fn)(buf)
        if rc != 0:
            raise RuntimeError(f"{fn} failed: CUDA error {rc}")
        out.update(zip(modes, buf))
    return out


def reset_launches() -> None:
    """Set every launch count to 0."""
    for fn in (seg_sum, seg_minmax, seg_fsum):
        fn.launches = 0
        for mode in fn.mode_launches:
            fn.mode_launches[mode] = 0


seg_sum.launches = 0
seg_sum.mode_launches = dict.fromkeys(SUM_MODES, 0)
seg_minmax.launches = 0
seg_minmax.mode_launches = {"min": 0, "max": 0}
seg_fsum.launches = 0
seg_fsum.mode_launches = {"fsum_f64": 0, "fsum_f32": 0}
