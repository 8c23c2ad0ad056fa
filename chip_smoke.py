"""Drive the PyTorch/CUDA port (spark_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero and prints
no result line):

1. The card's name and power limit, as nvidia-smi reports them.
2. Build the CUDA kernels from spark_tpu_torch/ops/csrc with nvcc (one
   nvcc for each source, started together). ``TZ`` is set to UTC for the
   run: timestamp literals are read in the local timezone.
3. TPC-H SF1 generated on the host (spark_tpu_torch/tpch/gen.py).
   Kernel phase: every mode of each kernel (seg_sum: count, int64 sum,
   float32 sum; seg_minmax: min, max) against its plain PyTorch version
   on the card, on data made on the card from a seed, at the shape the
   main path gives it (the SF1 lineitem batch) and K in {65, 168, 1024},
   and on a skewed input (90% of rows in one group) at K = 168: about
   30% of rows masked, some empty groups, NaNs in a few groups, int64
   values in +-1e15. Counts and int64 sums must be equal; min/max equal
   with NaN in the same groups; float32 sums within rtol 1e-4 / atol
   1e-3 of the plain version (another summation order), and on the
   skewed input of a float64 sum (there the plain version's float32
   atomics drift by 1e-3 on their own); every mode
   bit-identical across two launches. Times of the kernel (CUDA events
   over back-to-back calls, device-only from torch.profiler, which must
   show one kernel per call, and the host's time per call), the plain
   version and one library call, beside the least time the card could
   take (bound).
   Crossover: the masked reduction (the path at K <= 64) against the
   kernel for counts and int64 sums at K in {2, 6, 16, 32, 64}.
   The exact float sum (seg_fsum) at the same shape, float64 and
   float32, K in {6, 168, 1024} with unsorted ids, K = 5000 unsorted with
   ids outside [0, K) on some live rows, K = 10,000 sorted, a skewed
   input at K = 168 and values spread over 2^-1000..2^1000 (float32:
   2^-120..2^120) at K = 168, with NaN, +-inf and empty groups:
   equal to its plain version bit for bit, and so are a second launch,
   the compacted live rows and a permutation of the rows; within 1e-12
   (float32: 1e-5) of each group's sum of |x| of a float64 index_add_; a
   sample of groups equal to the host's exact sum rounded once (math.fsum;
   float32 by exact integer sums); the digit kernel and the finish
   kernel once a call, in the profiler session that gives its device ms.
   Its device ms beside its one-read bound (the share), index_add_'s and
   the plain version's.
4. The sqlite oracle: every column of the eight SF1 tables, key columns
   indexed, LIKE case-sensitive as the engine's; one load for every
   phase.
5. Slice phase: the eight SF1 tables registered on a
   ``device("cuda")`` session and on a ``device("cpu")`` one, TPC-H q1
   and q1-wide run through ``spark.sql(...).collect()``. Every launch
   counter is set to 0 just before and read just after; q1-wide must
   launch the count mode 7 times, the int64 sum 2 times, min and max
   once each, and q1 none. Results must equal the port's own CPU run on
   the same tables, and q1 the sqlite oracle. Warm wall times and one
   profiled run of each follow; q1-wide's profile must hold no
   ``index_add_``.
6. Query phases (``run_phase``), on the same sessions: each query once
   with the launch counters set to 0 before and read after it and the
   host syncs of the run counted (``torch.cuda.set_sync_debug_mode``),
   its launches asserted; every result equal to the CPU run and, where
   named, to the sqlite oracle at SF1; then warm wall times, peak device
   memory and one profiled run of each.
   - Join phase: TPC-H q3 and q5 (no launch; oracle), a small left outer
     join with a residual condition (nation/supplier: its 1024-row probe
     side counts matches with the seg_sum kernel, one launch) and a left
     anti join with a residual condition (customer/orders, no launch).
   - Subquery phase: TPC-H q13, q14, q16, q18 and q22 (derived tables,
     LIKE, CASE, IN lists, count(DISTINCT), HAVING, NOT IN / IN / NOT
     EXISTS and scalar subqueries rewritten into joins; no launch;
     oracle), then the host time of q13's LIKE table over o_comment's
     dictionary: the C++ table against the Python regex path, and its
     copy to the card.
   - Window phase: window functions, ROLLUP, CUBE, INTERSECT, EXCEPT and
     UNION (``tpch/queries.py:WINDOW_QUERIES``; no launch; oracle, R1
     and C1 through the UNION ALL of their GROUP BYs).
   - TPC-H phase: the twelve other TPC-H queries (q2 one count launch,
     the others none; oracle for those of ``TPCH_ORACLE``).
   - Scalar phase (``tpch/queries.py:SCALAR_QUERIES``): grouped stddev,
     variance and avg of sqrt at K = 6, 168 and 10,000 (A1: five seg_fsum
     launches each, A1-168 also eight counts), percentiles (P1), string
     transforms over host dictionaries (S2a-c), date functions (D1),
     decimal math (M1) and timestamps over a 1.5M-row table made here from
     orders (T1). Floats equal the CPU run within 1e-12 of each group's
     sum of |x| (sum of x^2 for the variances); A1's floats are
     bit-identical across two runs on the card and its profiles hold no
     index_add_; oracle for those of ``SCALAR_ORACLE_QUERIES``.
   - io phase: the eight tables and the flagship stage's table at
     lineitem's rows written to Parquet with ``df.write.parquet`` (a
     temporary directory, removed at the end; bytes on disk and write
     seconds printed) and read back with ``spark.read.parquet`` on a
     session on the card and one on the CPU; q1, q1-wide, q3 and q5
     through SQL and q1, q3 and the flagship stage through the DataFrame
     API (``tpch/queries.py:DATAFRAME_QUERIES``). Each query's rows equal
     the in-memory card run's bit for bit and its launches the in-memory
     run's (q1-wide 7 counts, 2 int64 sums, 1 min, 1 max; the flagship
     stage 2 seg_fsum); the CPU run over the same files equal (the
     flagship stage's floats within 1e-12 of each group's sum of |x|);
     sqlite for the TPC-H queries. Each first run prints its scans (rows
     read of the table's, decode and transfer ms), and the in-memory
     runs' warm walls and profiles are taken in the phase beside the
     Parquet runs'.
   - Complex phase (``tpch/queries.py:COMPLEX_QUERIES``): X1 explode
     then aggregate (``LATERAL VIEW explode(array(l_partkey,
     l_suppkey))``, 12M rows, K = 168: 4 counts, 1 min, 1 max), X2
     collect_list/collect_set at K = 168 (7 counts), X3 per-order
     arrays (collect_list over 1.5M groups) joined to orders and read by
     transform/filter/exists/forall/aggregate, X4 a word count over
     ``split(o_comment, ' ')``, X5 maps over lineitem's 6M rows and the
     map functions, X6 a list/map/struct table of 1.5M rows built with
     pyarrow (``nested_table``), SM1 ``sample(0.01, seed=7)``; the oracle
     for the columns that do not depend on row order
     (``COMPLEX_ORACLE_QUERIES``), Python's ``str.split`` for X4; then X6
     over its table written with ``df.write.parquet`` and read back on
     the card and the CPU, equal to the in-memory card run bit for bit.
   Warm runs (``warm_runs``): after its first run, which is blocking and
   records the plan's runtime statistics, each query runs once with its
   traced stages eagerly (no graph), then once to capture each traced
   stage into a CUDA graph (``physical/graphs.py``; the capture run, timed
   on its own), then 3 times replaying the graphs. Each prints the stages
   run traced and blocking, the graphs captured and the capture ms, its
   wall, hand-kernel launches and host syncs (inside stages, in blocking
   operators, outside the engine). Every warm run's rows equal the first
   run's bit for bit; every traced stage
   of a replay is replayed; each replay launches what the eager warm run
   and the capture run did (``SAME_LAUNCHES``: also the first run); the
   kernel-wrapper calls each graph recorded at its capture are held
   against the plain versions on the tensors of a replay. A replay and an
   eager warm run are profiled, and the graph pool's bytes are printed
   after each phase.
   A profiled run whose session recorded fewer hand-written kernel
   launches than the wrappers counted is taken again (up to five
   sessions): the profiler now and then drops events.
   In every query phase and the slice phase, every call of a kernel's
   wrapper on the main path is recorded (its arguments and result), and
   each is held against its plain PyTorch version on those same
   tensors: counts, int64 sums and min/max equal, float32 sums within
   rtol 1e-4 / atol 1e-3, seg_fsum bit for bit.
7. A ``{"kernels": [...]}`` line (launches by path), the card line,
   and as the last line ``{"ok": true, "device": {...}}``. Each phase
   prints its seconds.
"""

from __future__ import annotations

import contextlib
import inspect
import json
import math
import os
import statistics
import struct
import subprocess
import sys
import time
import types
import warnings
from fractions import Fraction

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and non-tensor fp32
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
KS = (65, 168, 1024)
MAIN_K = 168  # q1-wide: 3 * 2 * 7 * 4 packed dictionary groups
CROSSOVER_KS = (2, 6, 16, 32, 64)  # q1 has K = 6


def log(*args):
    print(*args, flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def frame(spark, query):
    """The DataFrame of ``query``: SQL text, or a function of the session
    that builds one with the DataFrame API."""
    return spark.sql(query) if isinstance(query, str) else query(spark)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int = 50) -> float:
    """Host time per call of ``fn``, without waiting for the card: what
    the wrapper costs the CPU (its checks, allocation and launch)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed * 1e3 / reps


def bound_ms(n_bytes: float, n_ops: float):
    """Least time on the card: the larger of bytes over HBM bandwidth and
    operations over the fp32 (non-tensor) peak."""
    tb = n_bytes / HBM_BYTES_PER_S * 1e3
    to = n_ops / FP32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def make_inputs(n: int, k: int, live_rows: int, seed: int, dev="cuda",
                skew: bool = False):
    """seg int32 in [0, k) with every 10th group left empty, ~30% of rows
    masked (and every row past ``live_rows``), float32 data in [0, 100)
    with NaN in every 100th row of groups 3 and 17, and int64 data in
    +-1e15. ``skew`` moves 90% of the rows to group 7."""
    g = torch.Generator(device=dev).manual_seed(seed)
    used = torch.tensor([j for j in range(k) if j % 10 != 9],
                        dtype=torch.int32, device=dev)
    pick = torch.randint(0, used.numel(), (n,), generator=g, device=dev)
    seg = used[pick]
    if skew:
        hot = torch.rand(n, generator=g, device=dev) < 0.9
        seg = torch.where(hot, torch.full_like(seg, 7 % k), seg)
    seg = seg.contiguous()
    mask = torch.rand(n, generator=g, device=dev) >= 0.3
    mask[live_rows:] = False
    data = torch.rand(n, generator=g, device=dev) * 100.0
    nan_rows = torch.nonzero((seg == 3) | (seg == 17)).squeeze(1)[::100]
    data[nan_rows] = float("nan")
    i64 = torch.randint(-10 ** 15, 10 ** 15, (n,), generator=g, device=dev,
                        dtype=torch.int64)
    return data.contiguous(), i64, seg, mask.contiguous()


def profile_calls(fn, calls: int = 10):
    """Device-only ms per call from torch.profiler's kernel events, kernels
    per call and {kernel name: launches per call}, all from one profiler
    session (memsets and copies are not kernels). The profiler now and
    then drops kernel events of a session (seen on an H100: a session that
    recorded none, one that recorded 69 of about 100); a session in which
    some kernel's count is not a whole number per call is taken again, up
    to five sessions in all."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in _device_events(prof) if _is_kernel(e.key)]
        names = {e.key: e.count / calls for e in kernels}
        if names and all(v == int(v) for v in names.values()):
            break
    us = sum(e.self_device_time_total for e in kernels)
    return us / 1e3 / calls, sum(names.values()), names


def _device_events(prof):
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]


def _is_kernel(name: str) -> bool:
    return not name.startswith(("Memset", "Memcpy"))


# bytes each mode must read per row: int32 seg + bool mask (+ data)
ROW_BYTES = {"count": 5, "sum_i64": 13, "sum_f32": 9, "min": 9, "max": 9}


def mode_calls(seg_agg, data, i64, seg, mask, k: int):
    """{mode: (kernel call, plain version, one library call)}."""
    dev = seg.device
    finite = torch.nan_to_num(data, nan=0.0)
    seg_l = seg.long()
    mask_f = mask.to(torch.float32)
    masked_i64 = torch.where(mask, i64, torch.zeros((), dtype=torch.int64,
                                                    device=dev))
    masked_f = torch.where(mask, finite, torch.zeros((), device=dev))
    zeros_i = torch.zeros(k, dtype=torch.int64, device=dev)
    zeros_f = torch.zeros(k, dtype=torch.float32, device=dev)
    calls = {
        "count": (lambda: seg_agg.seg_sum(None, seg, mask, k, exact_int=True),
                  lambda: seg_agg.seg_sum_plain(None, seg, mask, k, True),
                  lambda: torch.bincount(seg, weights=mask_f, minlength=k)),
        "sum_i64": (lambda: seg_agg.seg_sum(i64, seg, mask, k),
                    lambda: seg_agg.seg_sum_plain(i64, seg, mask, k),
                    lambda: zeros_i.index_add(0, seg_l, masked_i64)),
        "sum_f32": (lambda: seg_agg.seg_sum(finite, seg, mask, k),
                    lambda: seg_agg.seg_sum_plain(finite, seg, mask, k),
                    lambda: zeros_f.index_add(0, seg_l, masked_f)),
    }
    for is_max, name, ident in ((False, "min", float("inf")),
                                (True, "max", float("-inf"))):
        fill = torch.full((k,), ident, device=dev)
        masked = torch.where(mask, data, fill.new_tensor(ident))
        calls[name] = (
            lambda m=is_max: seg_agg.seg_minmax(data, seg, mask, k, m),
            lambda m=is_max: seg_agg.seg_minmax_plain(data, seg, mask, k, m),
            lambda f=fill, x=masked, r="amax" if is_max else "amin":
                f.scatter_reduce(0, seg_l, x, r, include_self=True))
    return calls, finite


def _bits(t):
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t.view(torch.int64) if t.dtype == torch.float64 else t


def check_mode(name: str, got, again, want, k: int, data, seg, mask,
               truth=None):
    """Kernel result against its plain version; returns max |err|. A
    float32 sum is held against ``truth`` (a float64 sum) instead where
    that is given: on the skewed input the plain version adds 3.8M rows
    into one float32 word through atomics and drifts by 1e-3 itself."""
    check(torch.equal(_bits(got), _bits(again)),
          f"{name} K={k}: two launches differ")
    if name in ("count", "sum_i64"):
        check(got.dtype == torch.int64 and torch.equal(got, want),
              f"{name} K={k} differs")
        return 0
    if name == "sum_f32":
        ref = want if truth is None else truth.to(torch.float32)
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-3)
        return (got - ref).abs().max().item()
    has_nan = torch.zeros(k, dtype=torch.bool, device=seg.device)
    has_nan[seg.long()[mask & torch.isnan(data)]] = True
    check(torch.equal(torch.isnan(got), torch.isnan(want))
          and torch.equal(torch.isnan(got), has_nan),
          f"{name} K={k}: NaN groups differ")
    fin = ~torch.isnan(got)
    check(torch.equal(got[fin], want[fin]), f"{name} K={k} differs")
    empty = seg_agg_count(seg, mask, k) == 0
    check(bool(torch.isinf(got[empty]).all()),
          f"{name} K={k}: empty groups not +-inf")
    both = torch.isfinite(got) & torch.isfinite(want)
    return (got[both] - want[both]).abs().max().item() if both.any() else 0.0


def seg_agg_count(seg, mask, k):
    return torch.bincount(seg[mask].long(), minlength=k)[:k]


def kernel_phase(seg_agg, n: int, live_rows: int, dev="cuda"):
    """Every mode against its plain version on the card, on ``n`` rows
    of which the first ``live_rows`` can be live, at K in KS and on a
    skewed input. Returns {mode: stats at K=MAIN_K}."""
    on_card = dev == "cuda"
    main = {}
    cases = [(k, False) for k in KS] + [(MAIN_K, True)]
    for k, skew in cases:
        data, i64, seg, mask = make_inputs(n, k, live_rows, k + skew, dev,
                                           skew)
        empty = seg_agg_count(seg, mask, k) == 0
        has_nan = bool((mask & torch.isnan(data)).any())
        check(has_nan and bool(empty.any()), "inputs lack NaN/empty groups")
        calls, finite = mode_calls(seg_agg, data, i64, seg, mask, k)
        truth = torch.zeros(k, dtype=torch.float64, device=dev)
        truth.index_add_(0, seg.long()[mask], finite[mask].to(torch.float64))
        tag = f"N={n} K={k}{' skewed' if skew else ''}"
        for name, (kern, plain, lib) in calls.items():
            got, again, want = kern(), kern(), plain()
            torch.cuda.synchronize()
            if name == "sum_f32":
                log(f"kernel sum_f32 {tag}: max |err| against a float64 "
                    f"sum: kernel {(got - truth).abs().max().item():.6g}, "
                    f"plain {(want - truth).abs().max().item():.6g} (group "
                    f"sums up to {truth.abs().max().item():.6g})")
            err = check_mode(name, got, again, want, k,
                             finite if name == "sum_f32" else data, seg, mask,
                             truth if skew else None)
            ms = cuda_ms(kern)
            dev_ms, per_call, _ = (profile_calls(kern) if on_card
                                   else (None, None, None))
            if on_card:
                check(per_call == 1, f"{name} {tag}: {per_call} kernels "
                      "per call, want 1")
            out_bytes = k * got.element_size()
            bnd, by = bound_ms(n * ROW_BYTES[name] + out_bytes, n * 3)
            stats = dict(ms=ms, device_ms=dev_ms, kernels_per_call=per_call,
                         host_ms=host_ms(kern), bound_ms=bnd, bound_by=by,
                         max_abs_err=err)
            if not skew:
                stats.update(plain_ms=cuda_ms(plain), library_ms=cuda_ms(lib))
            log(f"kernel {name} {tag}: " + " ".join(
                f"{key}={val:.4f}" if isinstance(val, float) else
                f"{key}={val}" for key, val in stats.items()))
            if k == MAIN_K and not skew:
                main[name] = stats
            elif k == MAIN_K:
                main[name].update(skew_ms=ms, skew_device_ms=dev_ms)
        del data, i64, seg, mask, calls, finite, truth
    return main


def crossover_phase(seg_agg, n: int, live_rows: int, dev="cuda"):
    """The masked reduction (K passes, the path at K <= MIN_ENGINE_K)
    against the kernel, for counts and int64 sums at small K: ms per call
    by CUDA events over back-to-back calls (host dispatch included, as a
    query pays it) and device-only ms from the profiler."""
    from spark_tpu_torch.physical import kernels as PK

    for k in CROSSOVER_KS:
        data, i64, seg, mask = make_inputs(n, k, live_rows, 100 + k, dev)
        for name, masked, kern in (
                ("count", lambda: PK.seg_count(seg, mask, k),
                 lambda: seg_agg.seg_sum(None, seg, mask, k, exact_int=True)),
                ("sum_i64", lambda: PK.seg_sum(i64, seg, mask, k),
                 lambda: seg_agg.seg_sum(i64, seg, mask, k))):
            check(PK.select_path(k, False, True) == "masked",
                  f"K={k} is not on the masked path")
            check(torch.equal(masked(), kern()),
                  f"crossover {name} K={k}: masked != kernel")
            row = dict(masked_ms=cuda_ms(masked), kernel_ms=cuda_ms(kern))
            if dev == "cuda":
                row["masked_device_ms"], row["masked_kernels"], _ = \
                    profile_calls(masked)
                row["kernel_device_ms"], _, _ = profile_calls(kern)
            log(f"crossover {name} N={n} K={k}: " + " ".join(
                f"{key}={val:.4f}" for key, val in row.items()))
        del data, i64, seg, mask


# seg_fsum cases of the kernel phase: (K, sorted ids, skewed, exponent
# spread, ids outside [0, K)); the spread case puts float64 values over
# 2^-1000..2^1000 (float32 over 2^-120..2^120); K = 5000 is scattered past
# the 1024 groups a block privatizes
FSUM_CASES = ((6, False, False, 0, False), (168, False, False, 0, False),
              (1024, False, False, 0, False), (5000, False, False, 0, True),
              (10_000, True, False, 0, False), (MAIN_K, False, True, 0, False),
              (MAIN_K, False, False, 1000, False))


def fsum_inputs(n: int, k: int, live_rows: int, seed: int, dev="cuda",
                sorted_ids: bool = False, skew: bool = False,
                spread: int = 0, outside: bool = False):
    """int32 ids in [0, k) with every 10th group empty (sorted when
    ``sorted_ids``; 90% of rows in group 7 when ``skew``; ~5% of rows,
    live ones among them, given ids outside [0, k) when ``outside``: -2^31,
    -1, k, k + 1 and 2^31 - 1, which no group takes), ~30% of rows
    masked and every row past ``live_rows``, float64 values of both signs
    over six decades (``spread``: normal values times 2^e, e uniform in
    [-spread, spread]); group 3 holds a NaN, group 5 +inf and -inf, group
    8 -inf. The same seed gives the same ids and mask at any spread."""
    g = torch.Generator(device=dev).manual_seed(seed)
    used = torch.tensor([j for j in range(k) if j % 10 != 9],
                        dtype=torch.int32, device=dev)
    seg = used[torch.randint(0, used.numel(), (n,), generator=g, device=dev)]
    if skew:
        hot = torch.rand(n, generator=g, device=dev) < 0.9
        seg = torch.where(hot, torch.full_like(seg, 7), seg)
    if outside:
        bad = torch.tensor([-2 ** 31, -1, k, k + 1, 2 ** 31 - 1],
                           dtype=torch.int32, device=dev)
        pick = torch.randint(0, bad.numel(), (n,), generator=g, device=dev)
        off = torch.rand(n, generator=g, device=dev) < 0.05
        seg = torch.where(off, bad[pick], seg)
    if sorted_ids:
        seg = torch.sort(seg).values
    mask = torch.rand(n, generator=g, device=dev) >= 0.3
    mask[live_rows:] = False
    if spread:
        e = torch.randint(-spread, spread + 1, (n,), generator=g, device=dev)
        scale = torch.pow(2.0, e.to(torch.float64))
    else:
        scale = 10.0 ** torch.randint(-2, 4, (n,), generator=g, device=dev)
    x = torch.randn(n, generator=g, device=dev, dtype=torch.float64) * scale
    for group, value in ((3, float("nan")), (5, float("inf")),
                         (5, float("-inf")), (8, float("-inf"))):
        rows = torch.nonzero((seg == group) & mask).squeeze(1)
        if group < k and rows.numel():
            x[rows[rows.numel() // 2]] = value
    return x, seg.contiguous(), mask.contiguous()


# per dtype: significand bits, least normal exponent, largest exponent
FLOAT_FORMATS = {torch.float64: (53, -1022, 1023),
                 torch.float32: (24, -126, 127)}


def round_once(total: Fraction, dtype) -> float:
    """The exact ``total`` rounded once to nearest, ties to even, into
    ``dtype`` (subnormals included, +-inf past the largest finite)."""
    if total == 0:
        return 0.0
    bits, emin, emax = FLOAT_FORMATS[dtype]
    a = abs(total)
    e = a.numerator.bit_length() - a.denominator.bit_length()
    if Fraction(2) ** e > a:
        e -= 1
    q = max(e, emin) - (bits - 1)
    scaled = a / Fraction(2) ** q
    n, rem = divmod(scaled.numerator, scaled.denominator)
    if 2 * rem > scaled.denominator or (2 * rem == scaled.denominator
                                        and n % 2):
        n += 1
    sign = -1.0 if total < 0 else 1.0
    if Fraction(n) * Fraction(2) ** q >= Fraction(2) ** (emax + 1):
        return sign * math.inf
    return sign * math.ldexp(n, q)


def host_exact_sum(vals, dtype) -> float:
    """The exact sum of finite host values, rounded once into ``dtype``:
    math.fsum for float64 (correctly rounded); for float32 each value as
    an integer significand times 2^shift, summed by shift exactly."""
    if dtype == torch.float64:
        return math.fsum(vals.tolist())
    frac, exp = np.frexp(vals.astype(np.float64))
    sig = (frac * 2.0 ** 24).astype(np.int64)
    shift = exp.astype(np.int64) - 24
    total = Fraction(0)
    for sh in np.unique(shift).tolist():
        total += Fraction(int(sig[shift == sh].sum())) * Fraction(2) ** sh
    return round_once(total, dtype)


def fsum_phase(seg_agg, n: int, live_rows: int, dev="cuda"):
    """seg_fsum against its plain version, bit for bit, at the main path's
    shape and on values spread over the type's range: two launches, the
    compacted live rows and a permutation give the same bits; finite
    groups within 1e-12 (float32 1e-5) of each group's sum of |x| of a
    float64 index_add_, a sample of groups equal to the host's correctly
    rounded sum, NaN and +-inf groups as the rules say; two kernels a call
    (one reads the rows). Returns {dtype name: stats at K=MAIN_K}."""
    on_card = dev == "cuda"
    main = {}
    for k, sorted_ids, skew, spread, outside in FSUM_CASES:
        perm = None
        for dtype, tol, name in ((torch.float64, 1e-12, "fsum_f64"),
                                 (torch.float32, 1e-5, "fsum_f32")):
            wide = min(spread, 120) if dtype == torch.float32 else spread
            tag = (f"N={n} K={k}{' sorted' if sorted_ids else ''}"
                   f"{' skewed' if skew else ''}"
                   f"{f' spread 2^+-{wide}' if wide else ''}"
                   f"{' ids outside [0, K)' if outside else ''}")
            x64, seg, mask = fsum_inputs(n, k, live_rows, 500 + k, dev,
                                         sorted_ids, skew, wide, outside)
            if perm is None:
                perm = torch.randperm(n, device=dev)
            data = x64.to(dtype).contiguous()
            live = mask & (seg >= 0) & (seg < k)  # the rows a group takes
            idx = seg.long()[live]
            vals = data[live].to(torch.float64)
            fin = torch.isfinite(vals)
            truth = torch.zeros(k, dtype=torch.float64, device=dev)
            absum = torch.zeros(k, dtype=torch.float64, device=dev)
            truth.index_add_(0, idx[fin], vals[fin])
            absum.index_add_(0, idx[fin], vals[fin].abs())
            nonfinite = torch.zeros(k, dtype=torch.bool, device=dev)
            nonfinite[idx[~fin]] = True
            kern = (lambda d=data, s=seg, m=mask: seg_agg.seg_fsum(d, s, m,
                                                                   k))
            got, again = kern(), kern()
            plain = seg_agg.seg_fsum_plain(data, seg, mask, k)
            compact = seg_agg.seg_fsum(
                data[mask].contiguous(), seg[mask].contiguous(),
                torch.ones(int(mask.sum()), dtype=torch.bool, device=dev), k)
            shuffled = seg_agg.seg_fsum(data[perm].contiguous(),
                                        seg[perm].contiguous(),
                                        mask[perm].contiguous(), k)
            torch.cuda.synchronize()
            for label, other in (("a second launch", again),
                                 ("the plain version", plain),
                                 ("the compacted rows", compact),
                                 ("a permutation", shuffled)):
                check(torch.equal(_bits(got), _bits(other)),
                      f"seg_fsum {name} {tag}: bits differ from {label}")
            ok = ~nonfinite
            err = (got.to(torch.float64) - truth).abs()
            check(bool((err[ok] <= tol * absum[ok] + 1e-300).all()),
                  f"seg_fsum {name} {tag}: off the float64 sum by "
                  f"{(err[ok] / absum[ok].clamp(min=1e-300)).max().item()}"
                  " of sum|x|")
            check(bool((~torch.isfinite(got[nonfinite])).all()),
                  f"seg_fsum {name} {tag}: a non-finite group came out "
                  "finite")
            zero = (absum == 0) & ok
            check(bool((got[zero] == 0).all()),
                  f"seg_fsum {name} {tag}: an empty group is not 0")
            host = got.cpu().tolist()
            hvals, hidx = vals.cpu().numpy(), idx.cpu().numpy()
            sample = [g for g in range(0, k, max(1, k // 6))
                      if not bool(nonfinite[g])][:6]
            for g in sample:
                want = host_exact_sum(hvals[hidx == g], dtype)
                check(host[g] == want, f"seg_fsum {name} {tag}: group {g} "
                      f"is {host[g]!r}, its exact sum rounded once "
                      f"{want!r}")
            # the library call's inputs: dead rows zeroed, ids in range
            masked = torch.where(live, data, torch.zeros((), dtype=dtype,
                                                         device=dev))
            seg_l = seg.long().clamp(0, k - 1)
            lib_out = torch.zeros(k, dtype=dtype, device=dev)
            ms = cuda_ms(kern)
            dev_ms, per_call, names = (profile_calls(kern) if on_card
                                       else (None, None, None))
            if on_card:  # the device ms above come from this session
                check(sorted(names.values()) == [1, 1]
                      and sum("fsum_digit_kernel" in key for key in names)
                      == 1, f"seg_fsum {name} {tag}: kernels per call "
                      f"{names}, want the digit kernel and the finish kernel "
                      "once")
            # the function's own bytes: each row once, each group's result
            # once (the digit array is the design's scratch, not counted)
            row = data.element_size() + 5
            bnd, by = bound_ms(n * row + k * data.element_size(), n * 12)
            plain_fn = (lambda d=data, s=seg, m=mask:
                        seg_agg.seg_fsum_plain(d, s, m, k))
            stats = dict(ms=ms, device_ms=dev_ms, kernels_per_call=per_call,
                         host_ms=host_ms(kern), bound_ms=bnd, bound_by=by,
                         share=bnd / dev_ms if dev_ms else None,
                         max_abs_err=float(err[ok].max()) if ok.any()
                         else 0.0,
                         plain_ms=cuda_ms(plain_fn, reps=3, warmup=1),
                         library_ms=cuda_ms(lambda o=lib_out, m=masked,
                                            s=seg_l: o.index_add(0, s, m)))
            log(f"kernel seg_fsum {name} {tag}: " + " ".join(
                f"{key}={val:.6g}" if isinstance(val, float) else
                f"{key}={val}" for key, val in stats.items())
                + f"; {len(sample)} groups equal to the host's exact sum")
            if k == MAIN_K and not skew and not spread:
                main[name] = stats
            del x64, seg, mask, data, truth, absum, got, again, plain
    return main


def profile_query(spark, name: str, query) -> None:
    """One warm run under torch.profiler: host wall time, the card's
    summed device time, its share of the wall (the rest is the card
    idle while the host dispatches), and the top ops by device time. A
    session that recorded fewer events of the hand-written kernels
    (``seg_atomic_kernel``, ``seg_sum_f32_kernel``, ``fsum_digit_kernel``)
    than the kernels counted runs on the device in that run
    (``seg_agg.device_runs``, replayed launches included) has dropped
    events (``profile_calls``) and is taken again, up to five sessions in
    all; the device's own count is the measurement the checks use."""
    from torch.profiler import ProfilerActivity, profile

    from spark_tpu_torch.ops import seg_agg

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for _ in range(5):
        before = sum(seg_agg.device_runs().values())
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            frame(spark, query).collect()
            wall = (time.perf_counter() - t0) * 1e3
        ran = sum(seg_agg.device_runs().values()) - before
        # device events only: the aten op events above them repeat their
        # time
        events = _device_events(prof)
        seen = sum(e.count for e in events if _is_hand_kernel(e.key))
        if events and seen == ran:
            break
    else:
        log(f"profile {name}: the profiler recorded {seen} of the {ran} "
            "hand-kernel runs the device counted, in each of five "
            "sessions; the last one follows")
    dev_us = sum(e.self_device_time_total for e in events)
    n_kernels = sum(e.count for e in events if _is_kernel(e.key))
    ops = {e.key for e in prof.key_averages()}
    check(name not in NO_INDEX_ADD
          or not any(o.startswith("aten::index_add") for o in ops),
          f"{name} still calls index_add_")
    if dev_us <= 0:
        log(f"profile {name}: wall {wall:.2f} ms; device time not measured "
            "(the profiler recorded none)")
        return
    log(f"profile {name}: wall {wall:.2f} ms, device {dev_us / 1e3:.3f} ms "
        f"over {n_kernels} kernel launches, device busy "
        f"{dev_us / 1e3 / wall:.1%} of the wall")
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    for e in top:
        log(f"profile {name}:   {e.self_device_time_total / 1e3:8.3f} ms "
            f"x{e.count:<5} {e.key[:90]}")


def _is_hand_kernel(name: str) -> bool:
    """One event per wrapper launch: seg_sum's and seg_minmax's kernel,
    and the first of seg_fsum's two."""
    return any(k in name for k in ("seg_atomic_kernel", "seg_sum_f32_kernel",
                                   "fsum_digit_kernel"))


#: queries whose profiles must hold no index_add_: q1-wide's sums take the
#: seg_sum kernel, A1's float sums seg_fsum
NO_INDEX_ADD = ("q1_wide", "a1_6", "a1_168", "a1_sorted")


def mode_launches(seg_agg) -> dict:
    return {**seg_agg.seg_sum.mode_launches,
            **seg_agg.seg_minmax.mode_launches,
            **seg_agg.seg_fsum.mode_launches}


@contextlib.contextmanager
def recording_calls(seg_agg):
    """While the block runs, record every call the engine makes to the
    seg_agg wrappers (through ``physical/kernels.py``): its arguments
    (copied) and its result. The wrappers themselves are untouched and
    launch and count as they do without it; each record is held against
    the plain version afterwards (``hold_calls``)."""
    from spark_tpu_torch.physical import kernels as PK

    calls = []

    def recorder(name):
        fn = getattr(seg_agg, name)
        sig = inspect.signature(fn)

        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            kept = {key: val.clone() if torch.is_tensor(val) else val
                    for key, val in bound.arguments.items()}
            calls.append((name, kept, out.clone()))
            return out
        return call

    real = PK.seg_agg
    PK.seg_agg = types.SimpleNamespace(seg_sum=recorder("seg_sum"),
                                       seg_minmax=recorder("seg_minmax"),
                                       seg_fsum=recorder("seg_fsum"))
    try:
        yield calls
    finally:
        PK.seg_agg = real


def hold_calls(seg_agg, calls, label: str) -> None:
    """Each recorded wrapper call's result against the plain version on
    the same tensors: counts, int64 sums and min/max equal (NaN in the
    same groups), float32 sums within rtol 1e-4 / atol 1e-3, seg_fsum bit
    for bit."""
    for i, (name, args, got) in enumerate(calls):
        want = getattr(seg_agg, f"{name}_plain")(**args)
        seg = args["seg"]
        tag = (f"{label} call {i} ({name}, N={seg.shape[0]}, "
               f"K={args['num_segments']})")
        if name == "seg_fsum":
            check(torch.equal(_bits(got), _bits(want)),
                  f"{tag} differs from the plain version")
        elif not got.is_floating_point():
            check(got.dtype == torch.int64 and torch.equal(got, want),
                  f"{tag} differs from the plain version")
        elif name == "seg_sum":
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)
        else:
            nan = torch.isnan(got)
            check(torch.equal(nan, torch.isnan(want))
                  and torch.equal(got[~nan], want[~nan]),
                  f"{tag} differs from the plain version")
        sorted_ids = bool((seg[1:] >= seg[:-1]).all()) if seg.numel() else True
        log(f"{tag}: equal to the plain version on the path's own inputs "
            f"(ids sorted: {sorted_ids})")


def sessions(tables, dev="cuda"):
    """A session on ``dev`` and one on the CPU, each with the eight
    tables registered."""
    from spark_tpu_torch.api.session import SparkSession
    from spark_tpu_torch.tpch import register_views

    out = []
    for d in (dev, "cpu"):
        spark = SparkSession(device=d)
        t0 = time.perf_counter()
        register_views(spark, tables)
        torch.cuda.synchronize()
        log(f"views registered on {spark.device} in "
            f"{time.perf_counter() - t0:.1f} s")
        out.append(spark)
    return out


def oracle_connection(tables):
    """The sqlite oracle over every column of the eight tables, its key
    columns indexed (``tpch/oracle.py:index_keys``) and LIKE made
    case-sensitive, as the engine's is. One load serves every phase."""
    from spark_tpu_torch.tpch.oracle import index_keys, load_sqlite

    t0 = time.perf_counter()
    conn = load_sqlite(tables)
    index_keys(conn)
    conn.execute("pragma case_sensitive_like = on")
    log(f"oracle: sqlite loaded and indexed in "
        f"{time.perf_counter() - t0:.1f} s")
    return conn


def slice_phase(seg_agg, gpu, cpu, oracle, dev="cuda"):
    from spark_tpu_torch.physical import graphs
    from spark_tpu_torch.tpch import Q1_WIDE, QUERIES
    from spark_tpu_torch.tpch.oracle import assert_rows_match, run_oracle

    queries = {"q1": QUERIES[1], "q1_wide": Q1_WIDE}

    # the main path, once, with every launch counter read around it
    seg_agg.reset_launches()
    gpu_rows, launches = {}, {}
    with recording_calls(seg_agg) as calls:
        for name, q in queries.items():
            before = mode_launches(seg_agg)
            runs = device_runs(seg_agg, dev)
            gpu_rows[name] = [tuple(r) for r in gpu.sql(q).collect()]
            after = mode_launches(seg_agg)
            launches[name] = {m: after[m] - before[m] for m in after}
            check(dev != "cuda" or ran_since(seg_agg, runs)
                  == {m: n for m, n in launches[name].items() if n},
                  f"{name}: the device ran {ran_since(seg_agg, runs)}, "
                  f"the wrappers launched {launches[name]}")
    total = mode_launches(seg_agg)
    log(f"slice: kernel launches per query {launches}")
    if dev == "cuda":
        check(len(calls) == sum(total.values()),
              f"{len(calls)} wrapper calls, {total} launches")
    hold_calls(seg_agg, calls, "slice")
    check(not any(launches["q1"].values()),
          "q1 (K=6) should not launch kernels")
    if dev == "cuda":  # on the CPU the wrappers take their plain versions
        want = {"count": 7, "sum_i64": 2, "sum_f32": 0, "min": 1, "max": 1,
                "fsum_f64": 0, "fsum_f32": 0}
        check(launches["q1_wide"] == want,
              f"q1-wide launched {launches['q1_wide']}, want {want}")

    for name, q in queries.items():
        warm_runs("slice", seg_agg, gpu, name, q, gpu_rows[name],
                  launches[name], dev)
        if dev == "cuda":
            profile_query(gpu, name, q)
            with graphs.eager_stages():
                profile_query(gpu, f"{name} eager", q)
    log_pool("slice")

    t0 = time.perf_counter()
    for name, q in queries.items():
        cpu_rows = [tuple(r) for r in cpu.sql(q).collect()]
        check(cpu_rows == gpu_rows[name], f"{name}: card != CPU run")
        log(f"slice: {name} {len(cpu_rows)} rows, equal to the port's "
            "CPU run")
    log(f"slice: CPU runs took {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    assert_rows_match(gpu_rows["q1"], run_oracle(oracle, QUERIES[1]),
                      label="q1[sqlite]")
    log(f"slice: q1 equals the sqlite oracle "
        f"({time.perf_counter() - t0:.1f} s)")
    return total


def collect_split_syncs(spark, query, dev: str):
    """Rows of one run, and its host syncs split: inside traced stages
    (``graphs.run_stage``), in blocking operators (the rest of the
    engine's ``planner.execute``) and outside the engine (planning, the
    join reorder's distinct counts, the copies of the result). None on
    the CPU."""
    if dev != "cuda":
        return [tuple(r) for r in frame(spark, query).collect()], None
    from spark_tpu_torch.physical import graphs, planner

    counts = {"stage": 0, "engine": 0}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")

        def n_syncs():
            return sum(1 for w in caught
                       if "synchroniz" in str(w.message).lower())

        def counting(fn, key):
            def run(*args, **kwargs):
                before = n_syncs()
                try:
                    return fn(*args, **kwargs)
                finally:
                    counts[key] += n_syncs() - before
            return run

        real_stage, real_exec = graphs.run_stage, planner.execute
        graphs.run_stage = counting(real_stage, "stage")
        planner.execute = counting(real_exec, "engine")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            rows = [tuple(r) for r in frame(spark, query).collect()]
        finally:
            torch.cuda.set_sync_debug_mode("default")
            graphs.run_stage, planner.execute = real_stage, real_exec
        total = n_syncs()
    return rows, {"in stages": counts["stage"],
                  "blocking": counts["engine"] - counts["stage"],
                  "outside": total - counts["engine"]}


def row_bits(rows) -> list:
    """Rows with every float as its 8 bytes: equal lists mean equal bits
    (a -0.0 and a NaN compare as themselves)."""
    return [tuple(struct.pack("<d", v) if isinstance(v, float) else v
                  for v in r) for r in rows]


def run_phase(label: str, seg_agg, gpu, cpu, queries: dict, launches_want,
              oracle, oracle_queries: dict, dev="cuda", match_cpu=None,
              after_first=None):
    """One path of queries (SQL text, or functions of the session that
    build a DataFrame) on the card. Once, with every launch
    counter set to 0 before and read after each query and the host syncs
    of each run counted (``after_first(name)``, where given, is called
    after each): each query must launch what ``launches_want[name]`` says
    (an int: that many seg_sum counts; a dict: launches by mode) and
    nothing else (nothing where not named), and every wrapper call is
    held against the plain version. Then every result against the port's
    CPU run (equal rows, or ``match_cpu(name, card_rows, cpu_rows)`` where
    given) and the queries of ``oracle_queries`` (name -> sqlite text, or
    (text, the row's columns it holds)) against the sqlite oracle,
    then warm walls (3 runs, each bit-identical to the first run), peak
    device memory above the tables and one profiled run of each. Returns
    the launches of the path's run."""
    from spark_tpu_torch.physical import graphs
    from spark_tpu_torch.tpch.oracle import assert_rows_match, run_oracle

    seg_agg.reset_launches()
    rows, launches, syncs = {}, {}, {}
    with recording_calls(seg_agg) as calls:
        for name, q in queries.items():
            before = mode_launches(seg_agg)
            runs = device_runs(seg_agg, dev)
            t0 = time.perf_counter()
            rows[name], syncs[name] = collect_split_syncs(gpu, q, dev)
            wall = (time.perf_counter() - t0) * 1e3
            after = mode_launches(seg_agg)
            launches[name] = {m: after[m] - before[m] for m in after}
            log(f"{label}: {name} first run {wall:.1f} ms, "
                f"{len(rows[name])} rows, host syncs {syncs[name]}, "
                f"launches {launches[name]}")
            check(dev != "cuda" or ran_since(seg_agg, runs)
                  == {m: n for m, n in launches[name].items() if n},
                  f"{name}: the device ran {ran_since(seg_agg, runs)}, "
                  f"the wrappers launched {launches[name]}")
            if after_first is not None:
                after_first(name)
    total = mode_launches(seg_agg)
    if dev == "cuda":  # on the CPU the wrappers take their plain versions
        for name, got in launches.items():
            want = launches_want.get(name, 0)
            if isinstance(want, int):
                want = {"count": want}
            check(all(got[m] == want.get(m, 0) for m in got),
                  f"{name} launched {got}, want {want}")
        check(len(calls) == sum(total.values()),
              f"{len(calls)} wrapper calls, {total} launches")
    hold_calls(seg_agg, calls, label)

    t0 = time.perf_counter()
    for name, q in queries.items():
        cpu_rows = [tuple(r) for r in frame(cpu, q).collect()]
        check(rows[name], f"{name}: no rows")
        if match_cpu is None:
            check(cpu_rows == rows[name], f"{name}: card != CPU run")
        else:
            match_cpu(name, rows[name], cpu_rows)
        log(f"{label}: {name} {len(cpu_rows)} rows, equal to the port's "
            "CPU run")
    log(f"{label}: CPU runs took {time.perf_counter() - t0:.1f} s")

    for name, q in oracle_queries.items():
        t0 = time.perf_counter()
        sql, cols = q if isinstance(q, tuple) else (q, None)
        held = rows[name] if cols is None else [
            tuple(r[i] for i in cols) for r in rows[name]]
        assert_rows_match(held, run_oracle(oracle, sql),
                          label=f"{name}[sqlite]")
        log(f"{label}: {name} equals the sqlite oracle "
            f"({time.perf_counter() - t0:.1f} s)")

    for name, q in queries.items():
        warm_runs(label, seg_agg, gpu, name, q, rows[name], launches[name],
                  dev)
        if dev == "cuda":
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            frame(gpu, q).collect()
            peak = torch.cuda.max_memory_allocated() - base
            log(f"{label}: {name} peak device memory above the tables "
                f"{peak / 2 ** 20:.1f} MiB")
            profile_query(gpu, name, q)
            with graphs.eager_stages():
                profile_query(gpu, f"{name} eager", q)
    log_pool(label)
    return total


def device_runs(seg_agg, dev: str):
    """The kernels' own run counts on the card (None on the CPU)."""
    return seg_agg.device_runs() if dev == "cuda" else None


def ran_since(seg_agg, before):
    """The hand-kernel runs the card counted since ``before`` (modes that
    ran only)."""
    if before is None:
        return None
    after = seg_agg.device_runs()
    return {m: after[m] - before[m] for m in after if after[m] != before[m]}


#: queries whose replays must launch the hand kernels as their first run
#: did: their traced plan makes the same wrapper calls as the blocking one
#: (a traced join may count no matches where the blocking one did, so
#: elsewhere a replay's launches are held to the capture run's)
SAME_LAUNCHES = ("q1_wide", "a1_6", "a1_168", "a1_sorted", "x1_explode",
                 "x2_collect")


def warm_runs(label: str, seg_agg, spark, name: str, query, first_rows,
              first_launches: dict, dev: str) -> None:
    """A query's warm runs: one with its traced stages run eagerly, the
    capture run (timed on its own: each traced stage warmed up and
    captured into a CUDA graph, its rows the warm-up's), then 3 replays.
    Each prints its stages run traced and blocking, graphs captured and
    the capture ms, its wall, hand-kernel launches and host syncs (inside
    stages, in blocking operators, outside the engine: planning and the
    copies of the result); its rows must equal the first run's bit for
    bit and every traced stage of a replay must replay a graph. The
    hand-kernel runs are read on the card (``seg_agg.device_runs``: each
    kernel counts its own runs there): in the eager and capture runs they
    must equal the wrappers' launches, and in each replay, which launches
    through no wrapper, the capture run's (for ``SAME_LAUNCHES`` also the
    first run's). The kernel-wrapper calls the captures recorded are held
    against the plain versions on their own tensors, which hold the last
    replay's values."""
    from spark_tpu_torch.physical import graphs, planner

    def one_run():
        before = mode_launches(seg_agg)
        runs = device_runs(seg_agg, dev)
        t0 = time.perf_counter()
        got, syncs = collect_split_syncs(spark, query, dev)
        wall = (time.perf_counter() - t0) * 1e3
        after = mode_launches(seg_agg)
        check(row_bits(got) == row_bits(first_rows),
              f"{name}: a warm run differs from the first run")
        return wall, syncs, {m: after[m] - before[m] for m in after
                             if after[m] != before[m]}, \
            ran_since(seg_agg, runs), planner.last_run

    first = {m: n for m, n in first_launches.items() if n}
    with graphs.eager_stages():
        wall, syncs, eager_launches, ran, run = one_run()
    log(f"{label}: {name} eager warm run {wall:.1f} ms (traced stages run "
        f"eagerly): stages traced {run.stages}, blocking nodes "
        f"{dict(run.blocking)}; launches {eager_launches}; host syncs "
        f"{syncs}")
    check(dev != "cuda" or ran == eager_launches, f"{name}: the device ran "
          f"{ran} in the eager warm run, the wrappers launched "
          f"{eager_launches}")
    with graphs.recording_calls() as calls:
        wall, syncs, cap_launches, ran, run = one_run()
        check(not run.first_run, f"{name}: the capture run bound no stats")
        log(f"{label}: {name} capture run {wall:.1f} ms: stages traced "
            f"{run.stages} (nodes {dict(run.traced)}), blocking "
            f"{dict(run.blocking)}; graphs captured {run.captured} in "
            f"{run.capture_ms:.1f} ms, replayed {run.replayed}; launches "
            f"{cap_launches}; host syncs {syncs}")
        if dev == "cuda":
            check(run.stages >= 1
                  and run.captured + run.replayed == run.stages,
                  f"{name}: {run.stages} traced stages, {run.captured} "
                  f"captured, {run.replayed} replayed")
            check(ran == cap_launches, f"{name}: the device ran {ran} in "
                  f"the capture run, the wrappers launched {cap_launches}")
        check(cap_launches == eager_launches, f"{name}: the capture run "
              f"launched {cap_launches}, the eager warm run {eager_launches}")
        if name in SAME_LAUNCHES:
            check(cap_launches == first, f"{name}: the capture run "
                  f"launched {cap_launches}, the first run {first}")
        walls, warm_syncs = [], []
        for _ in range(3):
            wall, syncs, wrapped, ran, run = one_run()
            walls.append(wall)
            warm_syncs.append(syncs)
            if dev == "cuda":
                check(run.captured == 0 and run.replayed == run.stages >= 1,
                      f"{name}: a warm run replayed {run.replayed} of "
                      f"{run.stages} stages, captured {run.captured}")
                check(ran == cap_launches, f"{name}: the device ran {ran} "
                      f"in a replay, the capture run launched "
                      f"{cap_launches}")
    log(f"{label}: {name} replay walls ms on the card {walls} (median "
        f"{statistics.median(walls):.1f}); per warm run: stages traced "
        f"{run.stages}, blocking nodes {dict(run.blocking)}, hand-kernel "
        f"runs counted on the card {ran} (through the wrappers, in "
        f"blocking operators: {wrapped}), host syncs {warm_syncs[-1]}")
    if calls:
        hold_calls(seg_agg, calls, f"{label} {name} replay")


def log_pool(label: str) -> None:
    """The bytes the graphs' memory pool reserves, and the stages cached."""
    from spark_tpu_torch.physical import graphs

    if not torch.cuda.is_available():
        return
    held = graphs.pool_bytes()
    log(f"{label}: graph pool "
        f"{'not measured' if held is None else f'{held / 2 ** 20:.1f} MiB'}"
        f" reserved, {graphs.cached_stages()} captured stages cached, "
        "device memory allocated "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f}"
        " GiB")


def join_order(spark, query: str) -> list:
    """The optimized plan's joins, top-down, as key-pair strings."""
    from spark_tpu_torch.plan import logical as L
    from spark_tpu_torch.plan.optimizer import optimize
    from spark_tpu_torch.sql.parser import parse_sql

    out = []

    def walk(node):
        if isinstance(node, L.Join):
            out.append(", ".join(f"{lk}={rk}" for lk, rk in
                                 zip(node.left_keys, node.right_keys)))
        for c in node.children():
            walk(c)

    walk(optimize(parse_sql(query, spark.catalog)))
    return out


# the join phase's queries besides q3 and q5: a small left outer join
# (nation, 1024-row capacity, probes supplier; the residual condition
# sends it through the pair expansion, whose match count over 1024 probe
# rows takes the seg_sum kernel's count mode) and a left anti join with a
# residual condition (150k customers probe 1.5M orders; its match count
# over 150,528 probe rows is a scatter, no kernel)
JOIN_SMALL_OUTER = """
select n_name, s_suppkey, s_acctbal
from nation left join supplier
  on n_nationkey = s_nationkey and s_acctbal > 9990
order by n_name, s_suppkey
"""
JOIN_ANTI_RESIDUAL = """
select c_nationkey, count(*) as n
from customer left anti join orders
  on c_custkey = o_custkey and o_orderdate >= date '1998-01-01'
group by c_nationkey
order by c_nationkey
"""
# seg_sum count launches each join-phase query must make on the card
JOIN_LAUNCHES = {"q3": 0, "q5": 0, "small_outer": 1, "anti_residual": 0}


def join_phase(seg_agg, gpu, cpu, oracle, dev="cuda"):
    """q3, q5 and two residual-condition joins on the card (q3 and q5
    also against the oracle). Returns the launches of the join path's
    run."""
    from spark_tpu_torch.tpch import QUERIES

    queries = {"q3": QUERIES[3], "q5": QUERIES[5],
               "small_outer": JOIN_SMALL_OUTER,
               "anti_residual": JOIN_ANTI_RESIDUAL}
    for name in ("q3", "q5"):
        log(f"join: {name} join order {join_order(gpu, queries[name])}")
    return run_phase("join", seg_agg, gpu, cpu, queries, JOIN_LAUNCHES,
                     oracle, {n: queries[n] for n in ("q3", "q5")}, dev)


# the subquery phase's TPC-H queries: none may launch a seg_agg kernel
# (sorted, masked or single-group aggregates; semi and anti joins without
# a residual condition count no matches; q13's outer join counts over
# 150k probe rows, past the kernels' K)
SUBQUERY_QUERIES = (13, 14, 16, 18, 22)


def like_table_times(spark, dev: str) -> None:
    """Host time of q13's LIKE table over o_comment's dictionary: the C++
    kernels (the path at 2048 entries and more) against the Python regex
    path, and the table's copy to the card, which every evaluation
    makes (``expr/compiler._gather``)."""
    import numpy as np

    from spark_tpu_torch.expr import compiler as C
    from spark_tpu_torch.native import like_table

    field = spark.catalog.lookup("orders").batch.schema.field("o_comment")
    d = field.dictionary
    pattern = "%special%requests%"
    native_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        table = like_table(d, pattern)
        native_ms.append((time.perf_counter() - t0) * 1e3)
    rx = C._like_to_regex(pattern)
    t0 = time.perf_counter()
    regex = C._dict_table(d, lambda s: rx.match(s) is not None)
    regex_ms = (time.perf_counter() - t0) * 1e3
    check(np.array_equal(table, regex), "o_comment LIKE: C++ != regex")
    copy_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.as_tensor(table, device=dev)
        torch.cuda.synchronize()
        copy_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"subquery: o_comment LIKE {pattern!r} over {len(d)} dictionary "
        f"entries ({int(table.sum())} match): C++ table ms {native_ms} "
        f"(median {statistics.median(native_ms):.1f}), Python regex "
        f"{regex_ms:.1f} ms; table copy to {dev} ms {copy_ms} (median "
        f"{statistics.median(copy_ms):.2f})")


def subquery_phase(seg_agg, gpu, cpu, oracle, dev="cuda"):
    """q13, q14, q16, q18 and q22 on the card, each against the oracle,
    then the LIKE table's host times. Returns the launches of the
    subquery path's run."""
    from spark_tpu_torch.tpch import QUERIES

    queries = {f"q{q}": QUERIES[q] for q in SUBQUERY_QUERIES}
    for name, q in queries.items():
        log(f"subquery: {name} joins {join_order(gpu, q)}")
    total = run_phase("subquery", seg_agg, gpu, cpu, queries, {}, oracle,
                      queries, dev)
    like_table_times(gpu, dev)
    return total


def window_phase(seg_agg, gpu, cpu, oracle, dev="cuda"):
    """The window slice at SF1 (``tpch/queries.py:WINDOW_QUERIES``):
    row_number top-N per customer over orders (W1), a running sum and a
    rank over lineitem's 6M rows (W2: two specs, two sorts), lag and a
    sliding 7-row min/max/avg over orders (W3: the sparse table at 1.5M
    rows), ROLLUP with grouping_id (R1) and CUBE (C1) over lineitem, and
    INTERSECT, EXCEPT and UNION under count(*) (S1). None may launch a
    seg_agg kernel: the grouping-sets aggregates group by an int64 id and
    take the sorted path, UNION's DISTINCT is a sorted aggregate over an
    int64 key, the outer aggregates are masked (K <= 64) or single-group.
    Every window sums decimals or integers (exact int64 arithmetic), so
    the card's rows equal the CPU run's exactly. Each query equals the
    sqlite oracle at SF1; R1 and C1 through the UNION ALL of the GROUP
    BYs they stand for."""
    from spark_tpu_torch.tpch.queries import (WINDOW_ORACLE_QUERIES,
                                              WINDOW_QUERIES)

    oracle_queries = {name: WINDOW_ORACLE_QUERIES.get(name, q)
                      for name, q in WINDOW_QUERIES.items()}
    return run_phase("window", seg_agg, gpu, cpu, WINDOW_QUERIES, {},
                     oracle, oracle_queries, dev)


#: the TPC-H queries the earlier phases do not run
TPCH_REST = (2, 4, 7, 8, 9, 11, 12, 15, 17, 19, 20, 21)
#: those held against the sqlite oracle at SF1: all twelve, since the
#: indexed oracle answers each within 5 s there (PERF.md, measured with
#: tools/tpch_oracle_times.py on the chip machine)
TPCH_ORACLE = TPCH_REST
#: q2's correlated subquery joins about 800 filtered parts, compacted to
#: a 1,024-row probe side, with a residual condition: its match count
#: takes the seg_sum kernel (one count launch); the other queries'
#: aggregates are sorted, masked or single-group
TPCH_LAUNCHES = {"q2": 1}


def tpch_phase(seg_agg, gpu, cpu, oracle, dev="cuda"):
    """The twelve other TPC-H queries at SF1 on the card, with the
    launches of ``TPCH_LAUNCHES``, rows equal to the CPU run's, those of
    ``TPCH_ORACLE`` equal to the oracle's."""
    from spark_tpu_torch.tpch import QUERIES

    queries = {f"q{q}": QUERIES[q] for q in TPCH_REST}
    for name in ("q2", "q8", "q9"):
        log(f"tpch: {name} join order {join_order(gpu, queries[name])}")
    return run_phase("tpch", seg_agg, gpu, cpu, queries, TPCH_LAUNCHES,
                     oracle, {f"q{q}": QUERIES[q] for q in TPCH_ORACLE},
                     dev)


#: seg_agg launches each scalar-phase query makes on the card, by mode: A1's
#: stddev and variance sum x and x^2 in float64, its avg of sqrt sums once
#: (5 seg_fsum launches); at K = 168 its counts (count(*), three
#: any-valid tests, the counts of stddev, variance and avg, the
#: group-present test) take the seg_sum kernel. The other queries'
#: aggregates are masked (K <= 64) or sorted and sum no float.
SCALAR_LAUNCHES = {"a1_6": {"fsum_f64": 5},
                   "a1_168": {"count": 8, "fsum_f64": 5},
                   "a1_sorted": {"fsum_f64": 5}}
#: per group of each A1 query, the magnitudes its float columns are held
#: to against the CPU run: sum of x^2 for the stddev (compared squared)
#: and the variance, sum of |x| for the avg of sqrt
A1_BOUNDS = """count(*) as n,
       sum((l_extendedprice * 1.0) * (l_extendedprice * 1.0)) as b_sd,
       sum((l_quantity * 1.0) * (l_quantity * 1.0)) as b_var,
       sum(sqrt(l_extendedprice)) as b_avg"""
A1_TOL = 1e-12


def scalar_phase(seg_agg, gpu, cpu, oracle, dev="cuda"):
    """The scalar slice at SF1 (``tpch/queries.py:SCALAR_QUERIES``), with
    the launches of ``SCALAR_LAUNCHES``. A1's float columns equal the
    CPU run's within ``A1_TOL`` of each group's magnitude (the card sums
    floats with seg_fsum, the CPU with index_add_), the other queries'
    rows exactly; every warm run bit-identical to the first; those of
    ``SCALAR_ORACLE_QUERIES`` equal to the oracle's."""
    from spark_tpu_torch.tpch.queries import (A1_AGGS, SCALAR_ORACLE_QUERIES,
                                              SCALAR_QUERIES)

    bounds = {name: [tuple(r) for r in cpu.sql(
        SCALAR_QUERIES[name].replace(A1_AGGS, A1_BOUNDS)).collect()]
        for name in SCALAR_LAUNCHES}

    def match(name, card, cpu_rows):
        if name not in bounds:
            check(card == cpu_rows, f"{name}: card != CPU run")
            return
        check(len(card) == len(cpu_rows) == len(bounds[name]),
              f"{name}: row counts differ")
        worst = 0.0
        for g, c, b in zip(card, cpu_rows, bounds[name]):
            check(g[:-3] == c[:-3] == b[:-3], f"{name}: keys or counts "
                  f"differ: {g[:-3]} {c[:-3]} {b[:-3]}")
            for j, (x, y, mag) in enumerate(zip(g[-3:], c[-3:], b[-3:])):
                if x is None or y is None:
                    check(x is None and y is None, f"{name}: NULL differs")
                    continue
                if j == 0:  # the stddev, squared: a variance
                    x, y = x * x, y * y
                rel = abs(x - y) / mag
                check(rel <= A1_TOL, f"{name}: card {g} against CPU {c}: "
                      f"{rel:.3g} of the group's magnitude")
                worst = max(worst, rel)
        log(f"scalar: {name} floats within {worst:.3g} of each group's "
            f"magnitude of the CPU run's (bound {A1_TOL})")

    return run_phase("scalar", seg_agg, gpu, cpu, SCALAR_QUERIES,
                     SCALAR_LAUNCHES, oracle, SCALAR_ORACLE_QUERIES, dev,
                     match_cpu=match)


#: the io phase's tables: the eight TPC-H tables and the flagship stage's
IO_TABLES = ("lineitem", "orders", "customer", "supplier", "nation",
             "region", "part", "partsupp", "flagship")
#: float bound of the flagship stage on the CPU: its sums and averages
#: within this much of each group's sum of |v2| (the card sums with
#: seg_fsum, the CPU with index_add_ over another row layout)
FLAGSHIP_TOL = 1e-12


def write_parquet(spark, root: str) -> None:
    """Every table of ``IO_TABLES`` written to Parquet through the port's
    writer (``df.write.parquet``), one directory each under ``root``."""
    t0 = time.perf_counter()
    for name in IO_TABLES:
        spark.table(name).write.parquet(os.path.join(root, name))
    secs = time.perf_counter() - t0
    size = sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(root) for f in files)
    log(f"io: {len(IO_TABLES)} tables written with df.write.parquet in "
        f"{secs:.1f} s, {size} bytes on disk")


def io_phase(seg_agg, gpu, cpu, oracle, dev="cuda"):
    """The file scan at SF1: the tables written to Parquet by the port,
    read back with ``spark.read.parquet`` on a session on the card and
    one on the CPU; q1, q1-wide, q3 and q5 through SQL and q1, q3 and the
    flagship stage through the DataFrame API
    (``tpch/queries.py:DATAFRAME_QUERIES``). Each query's rows on the
    card equal the in-memory session's bit for bit, and its launches the
    in-memory run's (q1-wide: 7 counts, 2 int64 sums, 1 min, 1 max; the
    flagship stage 2 seg_fsum); the CPU run over the same files equal
    (the flagship stage's floats within ``FLAGSHIP_TOL`` of each group's
    magnitude); the TPC-H queries equal sqlite. Each first run prints its
    scans: rows read against the table's rows, decode and transfer ms.
    The files live in a temporary directory removed at the end."""
    import tempfile

    import pyarrow  # the phase needs pyarrow's Parquet and dataset
    import pyarrow.dataset  # noqa: F401  modules: fail loudly without
    import pyarrow.parquet  # noqa: F401  them

    from spark_tpu_torch.api.session import SparkSession
    from spark_tpu_torch.tpch import Q1_WIDE, QUERIES
    from spark_tpu_torch.tpch.queries import (DATAFRAME_QUERIES,
                                              flagship_table)

    log(f"io: pyarrow {pyarrow.__version__}")
    n_rows = gpu.table("lineitem").count()
    flag = flagship_table(n_rows, seed=20260729)
    for spark in (gpu, cpu):
        spark.createDataFrame(flag).createOrReplaceTempView("flagship")
    queries = {"q1": QUERIES[1], "q1_wide": Q1_WIDE, "q3": QUERIES[3],
               "q5": QUERIES[5], **DATAFRAME_QUERIES}
    oracle_queries = {"q1": QUERIES[1], "q3": QUERIES[3], "q5": QUERIES[5],
                      "df_q1": QUERIES[1], "df_q3": QUERIES[3]}

    # the in-memory runs on the card, whose rows and kernel runs the
    # Parquet runs must repeat; their warm walls and profiles, taken
    # here, are the same-process comparison for the Parquet runs'
    mem_rows, mem_launches = {}, {}
    for name, q in queries.items():
        # counted on the card: q1 and q1-wide replay the slice phase's
        # graphs, which launch through no wrapper
        runs = device_runs(seg_agg, dev)
        mem_rows[name] = [tuple(r) for r in frame(gpu, q).collect()]
        mem_launches[name] = ran_since(seg_agg, runs) or {}
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            frame(gpu, q).collect()
            walls.append((time.perf_counter() - t0) * 1e3)
        log(f"io: {name} in memory: warm wall ms on the card {walls} "
            f"(median {statistics.median(walls):.1f})")
        if dev == "cuda":
            profile_query(gpu, f"{name} in memory", q)
    log(f"io: launches of the in-memory runs {mem_launches}")
    if dev == "cuda":  # on the CPU the wrappers take their plain versions
        check(mem_launches["q1_wide"] == {"count": 7, "sum_i64": 2,
                                          "min": 1, "max": 1},
              f"in-memory q1-wide launched {mem_launches['q1_wide']}")
        check(mem_launches["df_flagship"] == {"fsum_f64": 2},
              f"in-memory flagship launched {mem_launches['df_flagship']}")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_io_") as root:
        write_parquet(gpu, root)
        fgpu, fcpu = SparkSession(device=dev), SparkSession(device="cpu")
        for spark in (fgpu, fcpu):
            for name in IO_TABLES:
                spark.read.parquet(os.path.join(root, name)) \
                    .createOrReplaceTempView(name)
        sources = {name: fgpu.table(name)._plan.source for name in IO_TABLES}
        last = {name: src.last_read for name, src in sources.items()}

        def scans(name):
            read = False
            for table, src in sources.items():
                if src.last_read is last[table]:
                    continue
                last[table] = r = src.last_read
                read = True
                log(f"io: {name} scan of {table}: {r['rows']} of "
                    f"{src.count_rows()} rows read, decode "
                    f"{r['decode_ms']:.1f} ms, transfer "
                    f"{r['transfer_ms']:.1f} ms")
            if not read:
                log(f"io: {name}: every scan served from the sources' "
                    "cache of device batches")

        bounds = {tuple(r)[0]: tuple(r)[1] for r in fcpu.sql(
            "select tag, sum(abs(v * 2.0)) as b from flagship where k > 10 "
            "group by tag").collect()}

        def match(name, card, cpu_rows):
            check(row_bits(card) == row_bits(mem_rows[name]),
                  f"{name}: rows from Parquet != the in-memory rows")
            if name != "df_flagship":
                check(card == cpu_rows, f"{name}: card != CPU run")
                return
            check(len(card) == len(cpu_rows) == len(bounds),
                  "df_flagship: row counts differ")
            by_tag = {r[0]: r for r in cpu_rows}
            worst = 0.0
            for g in card:
                c = by_tag.get(g[0])
                check(c is not None and g[2] == c[2],
                      f"df_flagship: keys or counts differ: {g} {c}")
                mag = bounds[g[0]]
                worst = max(worst, abs(g[1] - c[1]) / mag,
                            abs(g[3] - c[3]) * g[2] / mag)
            check(worst <= FLAGSHIP_TOL, f"df_flagship: card {card} "
                  f"against CPU {cpu_rows}: {worst:.3g} of the magnitude")
            log(f"io: df_flagship floats within {worst:.3g} of each "
                f"group's magnitude of the CPU run's (bound {FLAGSHIP_TOL})")

        return run_phase("io", seg_agg, fgpu, fcpu, queries, mem_launches,
                         oracle, oracle_queries, dev, match_cpu=match,
                         after_first=scans)


#: seg_agg launches each complex-phase query makes on the card, by mode
#: (the first card run's counts). X1 (K = 168, the direct path, 12M
#: exploded rows) counts its rows, its min's and max's any-valid tests
#: and its groups, and takes one min and one max; X2 (K = 168) counts its
#: rows and groups, the any-valid test of each of its three collects and
#: each collect's group widths. X3 (1.5M groups) and X4 (the words' code
#: ids) take the sorted path, X5, X6 and SM1 the masked one (K <= 64):
#: no launch.
COMPLEX_LAUNCHES = {"x1_explode": {"count": 4, "min": 1, "max": 1},
                    "x2_collect": {"count": 7}}


def complex_phase(seg_agg, gpu, cpu, oracle, dev="cuda"):
    """Arrays, maps, structs, explode/LATERAL VIEW, the higher-order
    functions, collect_list/collect_set and sample at SF1
    (``tpch/queries.py:COMPLEX_QUERIES``), with the launches of
    ``COMPLEX_LAUNCHES``: rows equal to the CPU run, the sqlite oracle
    (``COMPLEX_ORACLE_QUERIES``, the columns that do not depend on row
    order) and for X4 Python's ``str.split`` with ``Counter``. Then X6
    over its table written with ``df.write.parquet`` and read back with
    ``spark.read.parquet`` on the card and the CPU: rows equal to the
    in-memory card run bit for bit, the first read's decode and transfer
    ms printed. Returns the launches of the complex path's run."""
    import tempfile

    from spark_tpu_torch.api.session import SparkSession
    from spark_tpu_torch.tpch.queries import (COMPLEX_ORACLE_QUERIES,
                                              COMPLEX_QUERIES, word_counts)

    orders = cpu.catalog.lookup("orders").batch
    comments = orders.select(["o_comment"]).result_columns()[1][0]
    t0 = time.perf_counter()
    words = word_counts(comments)
    log(f"complex: Python str.split word count of {len(comments)} "
        f"o_comment rows ({len(orders.schema.field('o_comment').dictionary)}"
        f" dictionary entries, which X4's split reads) in "
        f"{time.perf_counter() - t0:.1f} s")
    total = run_phase("complex", seg_agg, gpu, cpu, COMPLEX_QUERIES,
                      COMPLEX_LAUNCHES, oracle, COMPLEX_ORACLE_QUERIES, dev)
    got = [tuple(r) for r in gpu.sql(COMPLEX_QUERIES["x4_wordcount"])
           .collect()]
    check(got == words, f"x4: {got[:3]} != Python's {words[:3]}")
    log("complex: x4 equals Python's str.split(' ') and Counter")

    q = COMPLEX_QUERIES["x6_nested"]
    mem = [tuple(r) for r in gpu.sql(q).collect()]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nested_") as root:
        path = os.path.join(root, "nested")
        t0 = time.perf_counter()
        gpu.table("nested").write.parquet(path)
        log(f"complex: nested written with df.write.parquet in "
            f"{time.perf_counter() - t0:.1f} s")
        for d in (dev, "cpu"):
            spark = SparkSession(device=d)
            spark.read.parquet(path).createOrReplaceTempView("nested")
            src = spark.table("nested")._plan.source
            t0 = time.perf_counter()
            rows = [tuple(r) for r in spark.sql(q).collect()]
            wall = (time.perf_counter() - t0) * 1e3
            r = src.last_read
            log(f"complex: x6 from Parquet on {d}: first run {wall:.1f} ms; "
                f"scan of {r['rows']} rows (list, map and struct columns): "
                f"decode {r['decode_ms']:.1f} ms, transfer "
                f"{r['transfer_ms']:.1f} ms")
            check(row_bits(rows) == row_bits(mem),
                  f"x6 from Parquet on {d} != the in-memory card run")
    log("complex: x6 from Parquet equals the in-memory card run bit for bit")
    return total


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from spark_tpu_torch.ops import _build, seg_agg
    from spark_tpu_torch.columnar.batch import round_capacity

    # timestamp literals and strings are read in the local timezone
    os.environ["TZ"] = "UTC"
    time.tzset()
    card = card_line()
    log(f"card: {card}")
    import pyarrow

    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"pyarrow {pyarrow.__version__} python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    sources = ("seg_agg", "seg_fsum")
    _build.libraries(sources)
    log(f"build: {', '.join(f'{n}.cu' for n in sources)} in "
        f"{time.perf_counter() - t0:.1f} s (one nvcc each, together)")
    for name in sources:
        for line in _build.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"build {name}: {line.strip()}")
    from spark_tpu_torch import native

    t0 = time.perf_counter()
    native.like_table(("x",), "%")  # builds strkernels.cpp with g++
    log(f"build: native/strkernels.cpp in {time.perf_counter() - t0:.1f} s")

    from spark_tpu_torch.tpch import generate_tables
    from spark_tpu_torch.tpch.queries import nested_table, timestamp_table

    t0 = time.perf_counter()
    tables = generate_tables(1.0, seed=20260729)
    n_rows = tables["lineitem"].num_rows
    log(f"TPC-H SF1 generated on the host in "
        f"{time.perf_counter() - t0:.1f} s (lineitem {n_rows} rows)")

    t0 = time.perf_counter()
    n = round_capacity(n_rows)
    main_stats = kernel_phase(seg_agg, n, n_rows)
    crossover_phase(seg_agg, n, n_rows)
    fsum_stats = fsum_phase(seg_agg, n, n_rows)
    log(f"kernel phase: {time.perf_counter() - t0:.1f} s")

    gpu, cpu = sessions(tables)
    ts = timestamp_table(tables["orders"], seed=20260729)
    t0 = time.perf_counter()
    nested = nested_table(tables["orders"], tables["lineitem"])
    log(f"complex: the nested table ({nested.num_rows} rows) built on the "
        f"host in {time.perf_counter() - t0:.1f} s")
    for spark in (gpu, cpu):
        spark.createDataFrame(ts).createOrReplaceTempView("ts_orders")
        spark.createDataFrame(nested).createOrReplaceTempView("nested")
    oracle = oracle_connection(tables)
    by_path = {}
    for path, phase in (("aggregate", slice_phase), ("join", join_phase),
                        ("subquery", subquery_phase),
                        ("window", window_phase), ("tpch", tpch_phase),
                        ("scalar", scalar_phase), ("io", io_phase),
                        ("complex", complex_phase)):
        t0 = time.perf_counter()
        by_path[path] = phase(seg_agg, gpu, cpu, oracle)
        log(f"{path} phase: {time.perf_counter() - t0:.1f} s")
    oracle.close()
    check(by_path["join"]["count"] >= 1,
          "the join path launched no seg_sum kernel")
    check(by_path["scalar"]["fsum_f64"] >= 1,
          "the scalar path launched no seg_fsum kernel")
    check(by_path["io"]["count"] >= 7 and by_path["io"]["min"] >= 1,
          "the io path launched no seg_sum or seg_minmax kernel")
    check(by_path["complex"]["count"] >= 1
          and by_path["complex"]["min"] >= 1,
          "the complex path launched no seg_sum count or seg_minmax min")
    check(not any(p["fsum_f64"] + p["fsum_f32"] for path, p in
                  by_path.items() if path not in ("scalar", "io")),
          "an earlier path summed floats on a grouped path")

    kernels = []
    for name, modes, headline, replaces, source, stats in (
            ("seg_sum", ("count", "sum_i64", "sum_f32"), "count",
             "spark_tpu/ops/pallas_agg.py:141", "seg_agg.cu", main_stats),
            ("seg_minmax", ("min", "max"), "min",
             "spark_tpu/ops/pallas_agg.py:215", "seg_agg.cu", main_stats),
            ("seg_fsum", ("fsum_f64", "fsum_f32"), "fsum_f64",
             "spark_tpu/physical/kernels.py:219", "seg_fsum.cu",
             fsum_stats)):
        per_mode = {m: dict(stats[m],
                            launches=sum(p[m] for p in by_path.values()))
                    for m in modes}
        # the top-level numbers are the mode the main path launches most
        top = {key: val for key, val in stats[headline].items()
               if not key.startswith("skew")}
        kernels.append(dict(
            name=name, route="cuda",
            source=f"spark_tpu_torch/ops/csrc/{source}", replaces=replaces,
            launches=sum(p[m] for p in by_path.values() for m in modes),
            launches_by_path={path: sum(p[m] for m in modes)
                              for path, p in by_path.items()},
            mode=headline, **top, modes=per_mode))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
