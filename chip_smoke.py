"""Drive the PyTorch/CUDA port (spark_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero and prints
no result line):

1. The card's name and power limit, as nvidia-smi reports them.
2. Build the CUDA kernels from spark_tpu_torch/ops/csrc with nvcc.
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
4. Slice phase: the eight SF1 tables registered on a
   ``device("cuda")`` session and on a ``device("cpu")`` one, TPC-H q1
   and q1-wide run through ``spark.sql(...).collect()``. Every launch
   counter is set to 0 just before and read just after; q1-wide must
   launch the count mode 7 times, the int64 sum 2 times, min and max
   once each, and q1 none. Results must equal the port's own CPU run on
   the same tables, and q1 the sqlite oracle. Warm wall times and one
   profiled run of each follow; q1-wide's profile must hold no
   ``index_add_``.
5. Join phase: TPC-H q3 and q5, a small left outer join with a residual
   condition (nation/supplier: its 1024-row probe side counts matches
   with the seg_sum kernel, one launch) and a left anti join with a
   residual condition (customer/orders), on the same sessions, with the
   launch counters set to 0 before and read after each, and the host
   syncs of each run counted (``torch.cuda.set_sync_debug_mode``). q3
   and q5 launch no kernel. Every result must equal the CPU run; q3 and
   q5 also the sqlite oracle at SF1. Warm wall times, peak device memory
   and one profiled run of each follow.
6. Subquery phase: TPC-H q13, q14, q16, q18 and q22 (derived tables,
   LIKE over o_comment's 1.5M-entry dictionary, CASE, IN lists,
   count(DISTINCT), HAVING, NOT IN / IN / NOT EXISTS and scalar
   subqueries rewritten into joins) on the same sessions, with the
   launch counters set to 0 before and read after each (none may launch
   a kernel) and the host syncs of each run counted. Every result must
   equal the CPU run and the sqlite oracle at SF1 (its LIKE made
   case-sensitive, as the engine's). Warm wall times, peak device
   memory and one profiled run of each follow, then the host time of
   q13's LIKE table over o_comment: the C++ table against the Python
   regex path, and its copy to the card.
   In the slice, join and subquery phases every call of a kernel's
   wrapper on the main path is recorded (its arguments and result), and
   each is held against its plain PyTorch version on those same
   tensors: counts, int64 sums and min/max equal, float32 sums within
   rtol 1e-4 / atol 1e-3.
7. A ``{"kernels": [...]}`` line, the card line, and as the last line
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import inspect
import json
import statistics
import subprocess
import sys
import time
import types
import warnings

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
    """Device-only ms per call from torch.profiler's kernel events, and
    kernels per call (memsets and copies are not kernels). The profiler
    now and then drops kernel events of a session (seen on an H100: a
    session that recorded none, one that recorded 69 of about 100); a
    session whose kernel count is not a whole number per call is taken
    once more."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in _device_events(prof) if _is_kernel(e.key)]
        count = sum(e.count for e in kernels)
        if count and count % calls == 0:
            break
    us = sum(e.self_device_time_total for e in kernels)
    return us / 1e3 / calls, count / calls


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
    return t.view(torch.int32) if t.dtype == torch.float32 else t


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
            dev_ms, per_call = profile_calls(kern) if on_card else (None,
                                                                    None)
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
                row["masked_device_ms"], row["masked_kernels"] = \
                    profile_calls(masked)
                row["kernel_device_ms"], _ = profile_calls(kern)
            log(f"crossover {name} N={n} K={k}: " + " ".join(
                f"{key}={val:.4f}" for key, val in row.items()))
        del data, i64, seg, mask


def profile_query(spark, name: str, query: str) -> None:
    """One warm run under torch.profiler: host wall time, the card's
    summed device time, its share of the wall (the rest is the card
    idle while the host dispatches), and the top ops by device time."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        spark.sql(query).collect()
        wall = (time.perf_counter() - t0) * 1e3
    # device events only: the aten op events above them repeat their time
    events = _device_events(prof)
    dev_us = sum(e.self_device_time_total for e in events)
    n_kernels = sum(e.count for e in events if _is_kernel(e.key))
    ops = {e.key for e in prof.key_averages()}
    check(name != "q1_wide" or not any(o.startswith("aten::index_add")
                                       for o in ops),
          "q1-wide still calls index_add_")
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


def mode_launches(seg_agg) -> dict:
    return {**seg_agg.seg_sum.mode_launches,
            **seg_agg.seg_minmax.mode_launches}


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
                                       seg_minmax=recorder("seg_minmax"))
    try:
        yield calls
    finally:
        PK.seg_agg = real


def hold_calls(seg_agg, calls, label: str) -> None:
    """Each recorded wrapper call's result against the plain version on
    the same tensors: counts, int64 sums and min/max equal (NaN in the
    same groups), float32 sums within rtol 1e-4 / atol 1e-3."""
    for i, (name, args, got) in enumerate(calls):
        want = getattr(seg_agg, f"{name}_plain")(**args)
        seg = args["seg"]
        tag = (f"{label} call {i} ({name}, N={seg.shape[0]}, "
               f"K={args['num_segments']})")
        if not got.is_floating_point():
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


def slice_phase(seg_agg, gpu, cpu, tables, dev="cuda"):
    from spark_tpu_torch.tpch import Q1_WIDE, QUERIES
    from spark_tpu_torch.tpch.oracle import (assert_rows_match,
                                             load_sqlite, run_oracle)

    queries = {"q1": QUERIES[1], "q1_wide": Q1_WIDE}

    # the main path, once, with every launch counter read around it
    seg_agg.reset_launches()
    gpu_rows, launches = {}, {}
    with recording_calls(seg_agg) as calls:
        for name, q in queries.items():
            before = mode_launches(seg_agg)
            gpu_rows[name] = [tuple(r) for r in gpu.sql(q).collect()]
            after = mode_launches(seg_agg)
            launches[name] = {m: after[m] - before[m] for m in after}
    total = mode_launches(seg_agg)
    log(f"slice: kernel launches per query {launches}")
    if dev == "cuda":
        check(len(calls) == sum(total.values()),
              f"{len(calls)} wrapper calls, {total} launches")
    hold_calls(seg_agg, calls, "slice")
    check(not any(launches["q1"].values()),
          "q1 (K=6) should not launch kernels")
    if dev == "cuda":  # on the CPU the wrappers take their plain versions
        want = {"count": 7, "sum_i64": 2, "sum_f32": 0, "min": 1, "max": 1}
        check(launches["q1_wide"] == want,
              f"q1-wide launched {launches['q1_wide']}, want {want}")

    for name, q in queries.items():
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            rows = [tuple(r) for r in gpu.sql(q).collect()]
            walls.append((time.perf_counter() - t0) * 1e3)
            check(rows == gpu_rows[name], f"{name}: run-to-run difference")
        log(f"slice: {name} warm wall ms on the card {walls} "
            f"(median {statistics.median(walls):.1f})")
        if dev == "cuda":
            profile_query(gpu, name, q)

    t0 = time.perf_counter()
    for name, q in queries.items():
        cpu_rows = [tuple(r) for r in cpu.sql(q).collect()]
        check(cpu_rows == gpu_rows[name], f"{name}: card != CPU run")
        log(f"slice: {name} {len(cpu_rows)} rows, equal to the port's "
            "CPU run")
    log(f"slice: CPU runs took {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    cols = ["l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice",
            "l_discount", "l_tax", "l_shipdate"]
    conn = load_sqlite({"lineitem": tables["lineitem"].select(cols)})
    assert_rows_match(gpu_rows["q1"], run_oracle(conn, QUERIES[1]),
                      label="q1[sqlite]")
    log(f"slice: q1 equals the sqlite oracle "
        f"({time.perf_counter() - t0:.1f} s)")
    return total


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
# the columns q3 and q5 read, loaded into the sqlite oracle
ORACLE_COLUMNS = {
    "customer": ["c_custkey", "c_mktsegment", "c_nationkey"],
    "orders": ["o_orderkey", "o_custkey", "o_orderdate", "o_shippriority"],
    "lineitem": ["l_orderkey", "l_suppkey", "l_extendedprice", "l_discount",
                 "l_shipdate"],
    "supplier": ["s_suppkey", "s_nationkey"],
    "nation": ["n_nationkey", "n_name", "n_regionkey"],
    "region": ["r_regionkey", "r_name"],
}
# indexes on the key columns: without them sqlite's q5 time grows with
# the square of the scale, far past the time limit at SF1
ORACLE_INDEXES = ("customer(c_custkey)", "orders(o_orderkey)",
                  "orders(o_custkey)", "lineitem(l_orderkey)",
                  "supplier(s_suppkey)", "nation(n_nationkey)",
                  "region(r_regionkey)")


def collect_counting_syncs(spark, query: str, dev: str):
    """Rows of one run, and the host syncs it made as PyTorch's sync
    debug mode reports them (None on the CPU, where there are none to
    count). The count includes the copies of the result to the host."""
    if dev != "cuda":
        return [tuple(r) for r in spark.sql(query).collect()], None
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            rows = [tuple(r) for r in spark.sql(query).collect()]
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum(1 for w in caught if "synchroniz" in str(w.message).lower())
    return rows, syncs


def oracle_rows(tables, names):
    """sqlite rows of the named TPC-H queries over the columns they
    read."""
    from spark_tpu_torch.tpch import QUERIES
    from spark_tpu_torch.tpch.oracle import load_sqlite, run_oracle

    t0 = time.perf_counter()
    conn = load_sqlite({t: tables[t].select(c)
                        for t, c in ORACLE_COLUMNS.items()})
    for i, ix in enumerate(ORACLE_INDEXES):
        conn.execute(f"create index ix{i} on {ix}")
    conn.execute("analyze")
    log(f"join: sqlite loaded and indexed in "
        f"{time.perf_counter() - t0:.1f} s")
    out = {}
    try:
        for name in names:
            t1 = time.perf_counter()
            out[name] = run_oracle(conn, QUERIES[int(name[1:])])
            log(f"join: sqlite {name} in {time.perf_counter() - t1:.1f} s")
    finally:
        conn.close()
    return out


# the subquery phase's TPC-H queries: seg_agg launches each must make on
# the card (none: sorted, masked or single-group aggregates; semi and
# anti joins without a residual condition count no matches; q13's outer
# join counts over 150k probe rows, past the kernels' K)
SUBQUERY_QUERIES = (13, 14, 16, 18, 22)
# the columns those queries read, loaded into the sqlite oracle, and the
# key columns indexed there
SUBQUERY_ORACLE_COLUMNS = {
    "customer": ["c_custkey", "c_name", "c_phone", "c_acctbal"],
    "orders": ["o_orderkey", "o_custkey", "o_orderdate", "o_totalprice",
               "o_comment"],
    "lineitem": ["l_orderkey", "l_partkey", "l_quantity", "l_extendedprice",
                 "l_discount", "l_shipdate"],
    "part": ["p_partkey", "p_brand", "p_type", "p_size"],
    "partsupp": ["ps_partkey", "ps_suppkey"],
    "supplier": ["s_suppkey", "s_comment"],
}
SUBQUERY_ORACLE_INDEXES = ("customer(c_custkey)", "orders(o_orderkey)",
                           "orders(o_custkey)", "lineitem(l_orderkey)",
                           "part(p_partkey)", "partsupp(ps_partkey)",
                           "supplier(s_suppkey)")


def subquery_oracle_rows(tables):
    """sqlite rows of the subquery phase's queries at SF1."""
    from spark_tpu_torch.tpch import QUERIES
    from spark_tpu_torch.tpch.oracle import load_sqlite, run_oracle

    t0 = time.perf_counter()
    conn = load_sqlite({t: tables[t].select(c)
                        for t, c in SUBQUERY_ORACLE_COLUMNS.items()})
    for i, ix in enumerate(SUBQUERY_ORACLE_INDEXES):
        conn.execute(f"create index ix{i} on {ix}")
    conn.execute("analyze")
    conn.execute("pragma case_sensitive_like = on")
    log(f"subquery: sqlite loaded and indexed in "
        f"{time.perf_counter() - t0:.1f} s")
    out = {}
    try:
        for q in SUBQUERY_QUERIES:
            t1 = time.perf_counter()
            out[f"q{q}"] = run_oracle(conn, QUERIES[q])
            log(f"subquery: sqlite q{q} in {time.perf_counter() - t1:.1f} s")
    finally:
        conn.close()
    return out


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


def subquery_phase(seg_agg, gpu, cpu, tables, dev="cuda"):
    """q13, q14, q16, q18 and q22 on the card: launches, host syncs,
    results against the CPU run and the oracle, walls, memory, profiles,
    and the LIKE table's host times. Returns the seg_agg launches of the
    subquery path's run."""
    from spark_tpu_torch.tpch import QUERIES
    from spark_tpu_torch.tpch.oracle import assert_rows_match

    queries = {f"q{q}": QUERIES[q] for q in SUBQUERY_QUERIES}
    for name, q in queries.items():
        log(f"subquery: {name} joins {join_order(gpu, q)}")

    # the subquery path, once, with every launch counter read around it
    seg_agg.reset_launches()
    rows, launches, syncs = {}, {}, {}
    with recording_calls(seg_agg) as calls:
        for name, q in queries.items():
            before = mode_launches(seg_agg)
            t0 = time.perf_counter()
            rows[name], syncs[name] = collect_counting_syncs(gpu, q, dev)
            wall = (time.perf_counter() - t0) * 1e3
            after = mode_launches(seg_agg)
            launches[name] = {m: after[m] - before[m] for m in after}
            log(f"subquery: {name} first run {wall:.1f} ms, "
                f"{len(rows[name])} rows, host syncs {syncs[name]}, "
                f"launches {launches[name]}")
    total = mode_launches(seg_agg)
    if dev == "cuda":  # on the CPU the wrappers take their plain versions
        for name, got in launches.items():
            check(not any(got.values()),
                  f"{name} launched {got}, want no launches")
        check(len(calls) == sum(total.values()),
              f"{len(calls)} wrapper calls, {total} launches")
    hold_calls(seg_agg, calls, "subquery")

    t0 = time.perf_counter()
    for name, q in queries.items():
        cpu_rows = [tuple(r) for r in cpu.sql(q).collect()]
        check(rows[name] and cpu_rows == rows[name],
              f"{name}: card != CPU run")
        log(f"subquery: {name} {len(cpu_rows)} rows, equal to the port's "
            "CPU run")
    log(f"subquery: CPU runs took {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    want = subquery_oracle_rows(tables)
    for name in queries:
        assert_rows_match(rows[name], want[name], label=f"{name}[sqlite]")
    log(f"subquery: {', '.join(queries)} equal the sqlite oracle "
        f"({time.perf_counter() - t0:.1f} s)")

    for name, q in queries.items():
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            again = [tuple(r) for r in gpu.sql(q).collect()]
            walls.append((time.perf_counter() - t0) * 1e3)
            check(again == rows[name], f"{name}: run-to-run difference")
        log(f"subquery: {name} warm wall ms on the card {walls} "
            f"(median {statistics.median(walls):.1f})")
        if dev == "cuda":
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            gpu.sql(q).collect()
            peak = torch.cuda.max_memory_allocated() - base
            log(f"subquery: {name} peak device memory above the tables "
                f"{peak / 2 ** 20:.1f} MiB")
            profile_query(gpu, name, q)
    like_table_times(gpu, dev)
    return total


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


def join_phase(seg_agg, gpu, cpu, tables, dev="cuda"):
    """q3, q5 and two residual-condition joins on the card: launches,
    host syncs, results against the CPU run and the oracle, walls,
    memory and profiles. Returns the seg_sum count launches of the join
    path's run."""
    from spark_tpu_torch.tpch import QUERIES
    from spark_tpu_torch.tpch.oracle import assert_rows_match

    queries = {"q3": QUERIES[3], "q5": QUERIES[5],
               "small_outer": JOIN_SMALL_OUTER,
               "anti_residual": JOIN_ANTI_RESIDUAL}
    for name in ("q3", "q5"):
        log(f"join: {name} join order {join_order(gpu, queries[name])}")

    # the join path, once, with every launch counter read around it
    seg_agg.reset_launches()
    rows, launches, syncs = {}, {}, {}
    with recording_calls(seg_agg) as calls:
        for name, q in queries.items():
            before = mode_launches(seg_agg)
            t0 = time.perf_counter()
            rows[name], syncs[name] = collect_counting_syncs(gpu, q, dev)
            wall = (time.perf_counter() - t0) * 1e3
            after = mode_launches(seg_agg)
            launches[name] = {m: after[m] - before[m] for m in after}
            log(f"join: {name} first run {wall:.1f} ms, "
                f"{len(rows[name])} rows, host syncs {syncs[name]}, "
                f"launches {launches[name]}")
    total = mode_launches(seg_agg)
    if dev == "cuda":  # on the CPU the wrappers take their plain versions
        for name, want in JOIN_LAUNCHES.items():
            got = launches[name]
            check(got["count"] == want and sum(got.values()) == want,
                  f"{name} launched {got}, want {want} count launches")
        check(len(calls) == sum(total.values()),
              f"{len(calls)} wrapper calls, {total} launches")
    hold_calls(seg_agg, calls, "join")

    t0 = time.perf_counter()
    for name, q in queries.items():
        cpu_rows = [tuple(r) for r in cpu.sql(q).collect()]
        check(rows[name] and cpu_rows == rows[name],
              f"{name}: card != CPU run")
        log(f"join: {name} {len(cpu_rows)} rows, equal to the port's CPU "
            "run")
    log(f"join: CPU runs took {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    want = oracle_rows(tables, ("q3", "q5"))
    for name in ("q3", "q5"):
        assert_rows_match(rows[name], want[name], label=f"{name}[sqlite]")
    log(f"join: q3 and q5 equal the sqlite oracle "
        f"({time.perf_counter() - t0:.1f} s)")

    for name, q in queries.items():
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            again = [tuple(r) for r in gpu.sql(q).collect()]
            walls.append((time.perf_counter() - t0) * 1e3)
            check(again == rows[name], f"{name}: run-to-run difference")
        log(f"join: {name} warm wall ms on the card {walls} "
            f"(median {statistics.median(walls):.1f})")
        if dev == "cuda":
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            gpu.sql(q).collect()
            peak = torch.cuda.max_memory_allocated() - base
            log(f"join: {name} peak device memory above the tables "
                f"{peak / 2 ** 20:.1f} MiB")
            profile_query(gpu, name, q)
    return total


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from spark_tpu_torch.ops import _build, seg_agg
    from spark_tpu_torch.columnar.batch import round_capacity

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    _build.library("seg_agg")
    log(f"build: seg_agg.cu in {time.perf_counter() - t0:.1f} s")
    for line in _build.build_logs.get("seg_agg", "").splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"build: {line.strip()}")
    from spark_tpu_torch import native

    t0 = time.perf_counter()
    native.like_table(("x",), "%")  # builds strkernels.cpp with g++
    log(f"build: native/strkernels.cpp in {time.perf_counter() - t0:.1f} s")

    from spark_tpu_torch.tpch import generate_tables

    t0 = time.perf_counter()
    tables = generate_tables(1.0, seed=20260729)
    n_rows = tables["lineitem"].num_rows
    log(f"TPC-H SF1 generated on the host in "
        f"{time.perf_counter() - t0:.1f} s (lineitem {n_rows} rows)")

    t0 = time.perf_counter()
    n = round_capacity(n_rows)
    main_stats = kernel_phase(seg_agg, n, n_rows)
    crossover_phase(seg_agg, n, n_rows)
    log(f"kernel phase: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    gpu, cpu = sessions(tables)
    launches = slice_phase(seg_agg, gpu, cpu, tables)
    log(f"slice phase: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    join_launches = join_phase(seg_agg, gpu, cpu, tables)
    log(f"join phase: {time.perf_counter() - t0:.1f} s")
    check(join_launches["count"] >= 1,
          "the join path launched no seg_sum kernel")

    t0 = time.perf_counter()
    subquery_launches = subquery_phase(seg_agg, gpu, cpu, tables)
    log(f"subquery phase: {time.perf_counter() - t0:.1f} s")
    by_path = {"aggregate": launches, "join": join_launches,
               "subquery": subquery_launches}

    kernels = []
    for name, modes, headline, replaces in (
            ("seg_sum", ("count", "sum_i64", "sum_f32"), "count",
             "spark_tpu/ops/pallas_agg.py:141"),
            ("seg_minmax", ("min", "max"), "min",
             "spark_tpu/ops/pallas_agg.py:215")):
        per_mode = {m: dict(main_stats[m],
                            launches=sum(p[m] for p in by_path.values()))
                    for m in modes}
        # the top-level numbers are the mode the main path launches most
        top = {key: val for key, val in main_stats[headline].items()
               if not key.startswith("skew")}
        kernels.append(dict(
            name=name, route="cuda",
            source="spark_tpu_torch/ops/csrc/seg_agg.cu", replaces=replaces,
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
