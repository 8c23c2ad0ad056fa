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
  kernel: a grouped float64 or float32 sum whose bits depend only on the
  set of live values in each group (a two-pass fixed-point sum,
  ``csrc/seg_fsum.cu``). ``physical/kernels.seg_sum`` sends every float
  sum over more than one group on a CUDA tensor to it. On the CPU the
  engine keeps ``index_add_``, which equals the reference's
  ``segment_sum`` bit for bit there, so the card's float groups differ
  from the CPU run's by rounding only (a few ulps).

Semantics, shared with the reference: a row contributes when its mask is
true and ``0 <= seg < num_segments``. Empty groups sum to 0, count 0 and
have min +inf / max -inf; a group that holds a NaN has min/max NaN. On the
card a group holding both -0.0 and +0.0 has min -0.0 and max +0.0. A
float sum of a group holding a NaN, or both +inf and -inf, is NaN.

The kernels are bandwidth-bound: each reads every row once (5 bytes a row
for a count, 9 for a float32 sum or min/max, 13 for an int64 sum), about
1.5, 2.7 and 3.9 us per million rows at 3.35 TB/s on an H100 SXM; the
float sum of ``seg_fsum`` reads every row twice (13 bytes a row a pass
for float64). ``csrc/seg_agg.cu`` and ``csrc/seg_fsum.cu`` hold the
designs. Every ``seg_sum`` and ``seg_minmax`` call is one kernel launch;
a ``seg_fsum`` call is two kernels and a memset.

A wrapper given CPU tensors computes the plain version; given CUDA
tensors it launches the kernel or raises. Each wrapper counts its kernel
launches in ``<wrapper>.launches`` and, by mode, in
``<wrapper>.mode_launches``; ``reset_launches()`` sets all to 0.
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


def _pow2(e: torch.Tensor) -> torch.Tensor:
    """2.0 ** e as float64 for int64 ``e`` in [-1022, 1023], built from
    its bits (exact; ``torch.ldexp`` goes through ``pow`` in the default
    float dtype)."""
    return ((e + 1023) << 52).view(torch.float64)


FSUM_EXP_BIAS = 1100   # seg_fsum.cu's kExpBias: stored code e + bias > 0
_TWO30 = float(1 << 30)


def _fsum_split(x: torch.Tensor, code: torch.Tensor) -> torch.Tensor:
    """x * 2^(30 - e) (e = code - bias) as three 30-bit limbs, int64[n, 3],
    most significant first, each with x's sign: ``seg_fsum.cu:split``."""
    sh = 30 - (code - FSUM_EXP_BIAS)
    a = torch.div(sh, 2, rounding_mode="floor")
    y = x * _pow2(a)
    y = y * _pow2(sh - a)
    l0 = torch.trunc(y)
    r = (y - l0) * _TWO30
    l1 = torch.trunc(r)
    r = (r - l1) * _TWO30
    return torch.stack([l0, l1, torch.trunc(r)], 1).to(torch.int64)


def _fsum_compose(limbs: torch.Tensor, code: torch.Tensor, nan: torch.Tensor,
                  pinf: torch.Tensor, ninf: torch.Tensor) -> torch.Tensor:
    """Each group's float64 sum from its limb sums (int64[K, 3]), exponent
    code (0: no finite value) and flags: ``seg_fsum.cu:compose``."""
    l0, l1, l2 = limbs.unbind(1)
    c = l2 >> 30  # carry so that l1, l2 lie in [0, 2^30)
    l2 = l2 - c * (1 << 30)
    l1 = l1 + c
    c = l1 >> 30
    l1 = l1 - c * (1 << 30)
    l0 = l0 + c
    t = l2.to(torch.float64) * (1.0 / _TWO30)
    t = l1.to(torch.float64) + t
    t = t * (1.0 / _TWO30)
    v = l0.to(torch.float64) + t
    es = code - FSUM_EXP_BIAS - 30
    a = torch.div(es, 2, rounding_mode="floor")
    v = v * _pow2(a)
    v = v * _pow2(es - a)
    zero = torch.zeros((), dtype=torch.float64, device=v.device)
    v = torch.where(code == 0, zero, v)
    v = torch.where(pinf, zero + float("inf"), v)
    v = torch.where(ninf, zero - float("inf"), v)
    return torch.where(nan | (pinf & ninf), zero + float("nan"), v)


def seg_fsum_plain(data: torch.Tensor, seg: torch.Tensor, mask: torch.Tensor,
                   num_segments: int) -> torch.Tensor:
    """Plain PyTorch version of ``seg_fsum``: the same two-pass
    fixed-point arithmetic, with an exact int64 ``index_add_`` for the
    limbs, so it equals the kernel bit for bit."""
    k = num_segments
    dev = seg.device
    live = mask & (seg >= 0) & (seg < k)
    idx = seg[live].long()
    x = data[live].to(torch.float64)
    fin = torch.isfinite(x)
    flags = []
    for hit in (torch.isnan(x), x == float("inf"), x == float("-inf")):
        flag = torch.zeros(k, dtype=torch.bool, device=dev)
        flag[idx[hit]] = True
        flags.append(flag)
    x, idx = x[fin], idx[fin]
    field = (x.view(torch.int64) >> 52) & 0x7FF
    code = field.clamp(min=1) - 1022 + FSUM_EXP_BIAS
    emax = torch.zeros(k, dtype=torch.int64, device=dev)
    emax.scatter_reduce_(0, idx, code, "amax", include_self=True)
    limbs = torch.zeros((k, 3), dtype=torch.int64, device=dev)
    limbs.index_add_(0, idx, _fsum_split(x, emax[idx]))
    out = _fsum_compose(limbs, emax, *flags)
    return out if data.dtype == torch.float64 else out.to(torch.float32)


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
    seg_sum.launches += 1
    seg_sum.mode_launches[mode] += 1
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
    seg_minmax.launches += 1
    seg_minmax.mode_launches["max" if is_max else "min"] += 1
    return out[:num_segments]


def seg_fsum(data: torch.Tensor, seg: torch.Tensor, mask: torch.Tensor,
             num_segments: int) -> torch.Tensor:
    """Grouped sum of float64 or float32 ``data`` by ``seg`` (int32[N])
    over live rows (``mask``, bool[N]), any ``num_segments`` >= 1 ->
    data's dtype[num_segments]. Its bits depend only on the live values
    of each group: not on the launch, the row order or where dead rows
    lie. Within a few ulps of the exact sum; a group holding a NaN, or
    both infinities, is NaN."""
    if seg.device.type == "cpu":
        return seg_fsum_plain(data, seg, mask, num_segments)
    if num_segments < 1 or num_segments >= MAX_ROWS:
        raise ValueError(f"num_segments {num_segments} outside [1, 2^31)")
    _check(data, seg, mask, None, (torch.float64, torch.float32))
    lib = _fsum_lib()
    k, dev = num_segments, seg.device
    scratch = torch.empty(4 * k + 1, dtype=torch.int64, device=dev)
    out = torch.empty(k, dtype=data.dtype, device=dev)
    is_f64 = data.dtype == torch.float64
    with torch.cuda.device(dev):
        rc = lib.seg_fsum_launch(
            data.data_ptr(), int(is_f64), seg.data_ptr(), mask.data_ptr(),
            seg.shape[0], k, scratch.data_ptr(), out.data_ptr(), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"seg_fsum_launch failed: CUDA error {rc}")
    seg_fsum.launches += 1
    seg_fsum.mode_launches["fsum_f64" if is_f64 else "fsum_f32"] += 1
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
