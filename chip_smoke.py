"""Drive the PyTorch/CUDA port (spark_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero and prints
no result line):

1. The card's name and power limit, as nvidia-smi reports them.
2. Build the CUDA kernels from spark_tpu_torch/ops/csrc with nvcc.
3. TPC-H SF1 generated on the host (spark_tpu_torch/tpch/gen.py).
   Kernel phase: each kernel against its plain PyTorch version on the
   card, on data made on the card from a seed, at the shape the main
   path gives it (the SF1 lineitem batch) and K in {65, 168, 1024}:
   about 30% of rows masked, some empty groups, NaNs in a few groups.
   Counts must be equal; min/max equal with NaN in the same groups;
   float32 sums within rtol 1e-4 / atol 1e-3 of the plain version
   (another summation order) and bit-identical across two launches.
   Times (CUDA events) of the kernel, the plain version and one library
   call, beside the least time the card could take (bound).
4. Slice phase: the SF1 tables registered on a ``device("cuda")``
   session, TPC-H q1 and q1-wide run through
   ``spark.sql(...).collect()``. Every launch counter is set to 0 just
   before and read just after; both kernels must have launched. Results
   must equal the port's own CPU run on the same tables, and q1 the
   sqlite oracle. Warm wall times follow.
5. A ``{"kernels": [...]}`` line, the card line, and as the last line
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and non-tensor fp32
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
KS = (65, 168, 1024)
MAIN_K = 168  # q1-wide: 3 * 2 * 7 * 4 packed dictionary groups


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


def bound_ms(n_bytes: float, n_ops: float):
    """Least time on the card: the larger of bytes over HBM bandwidth and
    operations over the fp32 (non-tensor) peak."""
    tb = n_bytes / HBM_BYTES_PER_S * 1e3
    to = n_ops / FP32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def make_inputs(n: int, k: int, live_rows: int, seed: int, dev="cuda"):
    """seg int32 in [0, k) with every 10th group left empty, ~30% of rows
    masked (and every row past ``live_rows``), float32 data in [0, 100)
    with NaN in every 100th row of groups 3 and 17."""
    g = torch.Generator(device=dev).manual_seed(seed)
    used = torch.tensor([j for j in range(k) if j % 10 != 9],
                        dtype=torch.int32, device=dev)
    pick = torch.randint(0, used.numel(), (n,), generator=g, device=dev)
    seg = used[pick].contiguous()
    mask = torch.rand(n, generator=g, device=dev) >= 0.3
    mask[live_rows:] = False
    data = torch.rand(n, generator=g, device=dev) * 100.0
    nan_rows = torch.nonzero((seg == 3) | (seg == 17)).squeeze(1)[::100]
    data[nan_rows] = float("nan")
    return data.contiguous(), seg, mask.contiguous()


def kernel_phase(seg_agg, n: int, live_rows: int, dev="cuda"):
    """Kernel vs plain on the card, on ``n`` rows of which the first
    ``live_rows`` can be live. Returns {kernel name: K=MAIN_K stats}."""
    main = {}
    for k in KS:
        data, seg, mask = make_inputs(n, k, live_rows, k, dev)
        finite = torch.nan_to_num(data, nan=0.0)
        seg_l = seg.long()
        has_nan = torch.zeros(k, dtype=torch.bool, device=dev)
        has_nan[seg_l[mask & torch.isnan(data)]] = True
        empty = seg_agg.seg_sum_plain(None, seg, mask, k, True) == 0
        check(bool(has_nan.any() and empty.any()),
              "inputs lack NaN/empty groups")

        # count: the exact_int mode of seg_sum, the path's use of B1
        got = seg_agg.seg_sum(None, seg, mask, k, exact_int=True)
        want = seg_agg.seg_sum_plain(None, seg, mask, k, True)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"seg_sum(exact_int) K={k} differs")
        count_err = (got - want).abs().max().item()
        mask_f = mask.to(torch.float32)
        count_ms = cuda_ms(
            lambda: seg_agg.seg_sum(None, seg, mask, k, exact_int=True))
        count_plain = cuda_ms(
            lambda: seg_agg.seg_sum_plain(None, seg, mask, k, True))
        count_lib = cuda_ms(
            lambda: torch.bincount(seg, weights=mask_f, minlength=k))
        count_bound = bound_ms(n * 5 + k * 8, n * 3)

        # float32 sum (exact_int off): deterministic, near the plain one
        a = seg_agg.seg_sum(finite, seg, mask, k)
        b = seg_agg.seg_sum(finite, seg, mask, k)
        want = seg_agg.seg_sum_plain(finite, seg, mask, k)
        torch.cuda.synchronize()
        check(torch.equal(a, b), f"seg_sum f32 K={k} not bit-identical")
        torch.testing.assert_close(a, want, rtol=1e-4, atol=1e-3)
        sum_err = (a - want).abs().max().item()
        truth = torch.zeros(k, dtype=torch.float64, device=dev).index_add_(
            0, seg_l[mask], finite[mask].to(torch.float64))
        log(f"kernel seg_sum[f32] K={k}: max |err| against a float64 sum: "
            f"kernel {(a - truth).abs().max().item():.6g}, plain "
            f"{(want - truth).abs().max().item():.6g} (group sums up to "
            f"{truth.abs().max().item():.6g})")
        masked0 = torch.where(mask, finite, torch.zeros((), device=dev))
        zeros = torch.zeros(k, dtype=torch.float32, device=dev)
        sum_ms = cuda_ms(lambda: seg_agg.seg_sum(finite, seg, mask, k))
        sum_plain = cuda_ms(lambda: seg_agg.seg_sum_plain(finite, seg, mask,
                                                          k))
        sum_lib = cuda_ms(lambda: zeros.index_add(0, seg_l, masked0))
        sum_bound = bound_ms(n * 9 + k * 4, n * 3)

        # min / max, with NaN groups
        mm = {}
        for is_max in (False, True):
            got = seg_agg.seg_minmax(data, seg, mask, k, is_max)
            want = seg_agg.seg_minmax_plain(data, seg, mask, k, is_max)
            torch.cuda.synchronize()
            check(torch.equal(torch.isnan(got), torch.isnan(want))
                  and torch.equal(torch.isnan(got), has_nan),
                  f"seg_minmax K={k} max={is_max}: NaN groups differ")
            fin = ~torch.isnan(got)
            check(torch.equal(got[fin], want[fin]),
                  f"seg_minmax K={k} max={is_max} differs")
            check(bool(torch.isinf(got[empty]).all()),
                  f"seg_minmax K={k}: empty groups not +-inf")
            both = torch.isfinite(got) & torch.isfinite(want)
            mm[is_max] = (got[both] - want[both]).abs().max().item()
        ident = torch.full((k,), float("inf"), device=dev)
        masked_inf = torch.where(mask, data, ident.new_tensor(float("inf")))
        min_ms = cuda_ms(lambda: seg_agg.seg_minmax(data, seg, mask, k))
        min_plain = cuda_ms(
            lambda: seg_agg.seg_minmax_plain(data, seg, mask, k))
        min_lib = cuda_ms(lambda: ident.scatter_reduce(
            0, seg_l, masked_inf, "amin", include_self=True))
        min_bound = bound_ms(n * 9 + k * 4, n * 3)

        for name, ms, plain, lib, (bnd, by), err in (
                ("seg_sum[exact_int]", count_ms, count_plain, count_lib,
                 count_bound, count_err),
                ("seg_sum[f32]", sum_ms, sum_plain, sum_lib, sum_bound,
                 sum_err),
                ("seg_minmax[min]", min_ms, min_plain, min_lib, min_bound,
                 max(mm.values()))):
            log(f"kernel {name} N={n} K={k}: kernel_ms={ms:.4f} "
                f"plain_ms={plain:.4f} library_ms={lib:.4f} "
                f"bound_ms={bnd:.4f} ({by}) max_abs_err={err}")
        if k == MAIN_K:
            main["seg_sum"] = dict(
                ms=count_ms, plain_ms=count_plain, library_ms=count_lib,
                bound_ms=count_bound[0], bound_by=count_bound[1],
                max_abs_err=count_err)
            main["seg_minmax"] = dict(
                ms=min_ms, plain_ms=min_plain, library_ms=min_lib,
                bound_ms=min_bound[0], bound_by=min_bound[1],
                max_abs_err=max(mm.values()))
        del data, seg, mask, finite, seg_l, mask_f, masked0, masked_inf
    return main


def profile_query(spark, name: str, query: str) -> None:
    """One warm run under torch.profiler: host wall time, the card's
    summed kernel time, its share of the wall (the rest is the card
    idle while the host dispatches), and the top ops by device time."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        spark.sql(query).collect()
        wall = (time.perf_counter() - t0) * 1e3
    # kernel events only: the aten op events above them repeat their time
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    dev_us = sum(e.self_device_time_total for e in kernels)
    n_kernels = sum(e.count for e in kernels)
    if dev_us <= 0:
        log(f"profile {name}: wall {wall:.2f} ms; device time not measured "
            "(the profiler recorded none)")
        return
    log(f"profile {name}: wall {wall:.2f} ms, device kernels "
        f"{dev_us / 1e3:.3f} ms over {n_kernels} launches, device busy "
        f"{dev_us / 1e3 / wall:.1%} of the wall")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    for e in top:
        log(f"profile {name}:   {e.self_device_time_total / 1e3:8.3f} ms "
            f"x{e.count:<5} {e.key[:90]}")


def slice_phase(seg_agg, tables, dev="cuda"):
    from spark_tpu_torch.api.session import SparkSession
    from spark_tpu_torch.tpch import Q1_WIDE, QUERIES, register_views
    from spark_tpu_torch.tpch.oracle import (assert_rows_match,
                                             load_sqlite, run_oracle)

    gpu = SparkSession.builder.device(dev).getOrCreate()
    t0 = time.perf_counter()
    register_views(gpu, tables)
    torch.cuda.synchronize()
    log(f"slice: views registered on {gpu.device} in "
        f"{time.perf_counter() - t0:.1f} s")
    queries = {"q1": QUERIES[1], "q1_wide": Q1_WIDE}

    # the main path, once, with every launch counter read around it
    seg_agg.seg_sum.launches = 0
    seg_agg.seg_minmax.launches = 0
    gpu_rows, launches = {}, {}
    for name, q in queries.items():
        before = (seg_agg.seg_sum.launches, seg_agg.seg_minmax.launches)
        gpu_rows[name] = [tuple(r) for r in gpu.sql(q).collect()]
        launches[name] = (seg_agg.seg_sum.launches - before[0],
                          seg_agg.seg_minmax.launches - before[1])
    total = {"seg_sum": seg_agg.seg_sum.launches,
             "seg_minmax": seg_agg.seg_minmax.launches}
    log(f"slice: kernel launches per query {launches}; total {total}")
    if dev == "cuda":  # on the CPU the wrappers take their plain versions
        check(launches["q1_wide"][0] > 0 and launches["q1_wide"][1] > 0,
              "q1-wide did not launch both kernels")
    check(launches["q1"] == (0, 0), "q1 (K=6) should not launch kernels")

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

    cpu = SparkSession(device="cpu")
    t0 = time.perf_counter()
    register_views(cpu, {"lineitem": tables["lineitem"]})
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

    from spark_tpu_torch.tpch import generate_tables

    t0 = time.perf_counter()
    tables = generate_tables(1.0, seed=20260729)
    n_rows = tables["lineitem"].num_rows
    log(f"TPC-H SF1 generated on the host in "
        f"{time.perf_counter() - t0:.1f} s (lineitem {n_rows} rows)")

    t0 = time.perf_counter()
    main_stats = kernel_phase(seg_agg, round_capacity(n_rows), n_rows)
    log(f"kernel phase: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    launches = slice_phase(seg_agg, tables)
    log(f"slice phase: {time.perf_counter() - t0:.1f} s")

    replaces = {"seg_sum": "spark_tpu/ops/pallas_agg.py:141",
                "seg_minmax": "spark_tpu/ops/pallas_agg.py:215"}
    kernels = [dict(name=name, route="cuda",
                    source="spark_tpu_torch/ops/csrc/seg_agg.cu",
                    replaces=replaces[name], launches=launches[name],
                    **main_stats[name])
               for name in ("seg_sum", "seg_minmax")]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
