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

Semantics, shared with the reference: a row contributes when its mask is
true and ``0 <= seg < num_segments``. Empty groups sum to 0, count 0 and
have min +inf / max -inf; a group that holds a NaN has min/max NaN. On the
card a group holding both -0.0 and +0.0 has min -0.0 and max +0.0.

The kernels are bandwidth-bound: each reads every row once (5 bytes a row
for a count, 9 for a float32 sum or min/max, 13 for an int64 sum), about
1.5, 2.7 and 3.9 us per million rows at 3.35 TB/s on an H100 SXM.
``csrc/seg_agg.cu`` holds the design. Every call is one kernel launch.

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


def _check(data: Optional[torch.Tensor], seg: torch.Tensor,
           mask: torch.Tensor, num_segments: int,
           data_dtypes=(torch.float32,)) -> None:
    if not 1 <= num_segments <= MAX_K:
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


def reset_launches() -> None:
    """Set every launch count to 0."""
    for fn in (seg_sum, seg_minmax):
        fn.launches = 0
        for mode in fn.mode_launches:
            fn.mode_launches[mode] = 0


seg_sum.launches = 0
seg_sum.mode_launches = dict.fromkeys(SUM_MODES, 0)
seg_minmax.launches = 0
seg_minmax.mode_launches = {"min": 0, "max": 0}
