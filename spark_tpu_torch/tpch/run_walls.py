"""First, second and warm wall times of named queries through the PyTorch
port on one GPU, and a host-side profile of one warm run, so that two
trees of the repo can be compared in one call on one card.

    python spark_tpu_torch/tpch/run_walls.py --tree DIR [--queries q2,q8|all]
        [--sf 1.0] [--reps 5] [--profile q2,q8 --out DIR] [--dataset BASE]

Imports ``spark_tpu_torch`` from DIR (a checkout of any commit that has
the port; the script itself may come from another), generates TPC-H at
``--sf`` with chip_smoke.py's seed, registers the eight tables on a
``device("cuda")`` session and, per query, times its first run (blocking,
recording statistics), its second run (where the tree captures CUDA
graphs, the capture run) and ``--reps`` warm runs of
``spark.sql(q).collect()`` on the host clock. For each query of
``--profile`` one more warm run runs under ``cProfile``; its 30 costliest
functions by own time go to ``--out/run_walls_<tree>_<query>.txt`` and the
top 8 into the JSON line. Prints one JSON line: the tree, the card's name
and power limit, and per query the walls in ms, the warm median and the
row count. Compare two trees in turns within one call (parent, change,
change, parent): walls move 30% between machines.

With ``--dataset BASE`` the tables come from disk instead: the tree's
own ``ensure_dataset`` makes (once) ``BASE/tpch_sf<sf>`` with the
streamed writer, 2,000,000 orders a part, in a process per CPU, and
``register_views(spark, path=...)`` reads it. A query that fails is
recorded with its error and the others still run (exit 1 if any
failed).
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import os
import pstats
import statistics
import subprocess
import sys
import time


def _profile(spark, query: str, path: str) -> list:
    prof = cProfile.Profile()
    prof.enable()
    spark.sql(query).collect()
    prof.disable()
    text = io.StringIO()
    stats = pstats.Stats(prof, stream=text)
    stats.sort_stats("tottime").print_stats(30)
    with open(path, "w") as f:
        f.write(text.getvalue())
    rows = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:8]
    return [{"fn": f"{os.path.basename(file)}:{line}:{fn}",
             "calls": nc, "tottime_ms": tt * 1e3, "cumtime_ms": ct * 1e3}
            for (file, line, fn), (_, nc, tt, ct, _) in rows]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True)
    ap.add_argument("--queries", default="q2,q8")
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--profile", default="")
    ap.add_argument("--out", help="directory for the --profile listings")
    ap.add_argument("--dataset", metavar="BASE",
                    help="read the tables from ensure_dataset(sf, BASE)")
    args = ap.parse_args()
    if args.profile and not args.out:
        ap.error("--profile needs --out")

    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    os.environ["TZ"] = "UTC"  # timestamp literals read in the local zone
    time.tzset()
    import torch

    if not torch.cuda.is_available():
        print("run_walls: needs a CUDA device", file=sys.stderr)
        return 1
    from spark_tpu_torch.api.session import SparkSession
    from spark_tpu_torch.tpch import QUERIES, generate_tables, register_views
    from spark_tpu_torch.tpch.queries import SCALAR_QUERIES

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    spark = SparkSession(device="cuda")
    out = {"tree": args.tree, "card": card, "sf": args.sf}
    if args.dataset:
        from spark_tpu_torch.tpch import dataset_report, ensure_dataset

        t0 = time.perf_counter()
        path = ensure_dataset(args.sf, base=args.dataset, seed=20260729,
                              streamed=True, orders_per_slice=2_000_000,
                              workers=os.cpu_count() or 1)
        out["dataset"] = {"path": path, "wall_s": time.perf_counter() - t0,
                          **dataset_report(path)}
        register_views(spark, path=path)
    else:
        register_views(spark, generate_tables(args.sf, seed=20260729))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    profiled = set(filter(None, args.profile.split(",")))
    names = (",".join(f"q{i}" for i in range(1, 23))
             if args.queries == "all" else args.queries)
    failed = []
    for name in names.split(","):
        query = (QUERIES[int(name[1:])] if name[1:].isdigit()
                 else SCALAR_QUERIES[name])
        walls = []
        try:
            for _ in range(2 + args.reps):
                t0 = time.perf_counter()
                rows = spark.sql(query).collect()
                walls.append((time.perf_counter() - t0) * 1e3)
        except Exception as exc:  # noqa: BLE001 - recorded, run goes on
            out[name] = {"error": f"{type(exc).__name__}: {exc}"[:500],
                         "walls_ms": walls}
            failed.append(name)
            print(f"run_walls: {name} failed: {exc!r}", file=sys.stderr,
                  flush=True)
            continue
        out[name] = {"first_ms": walls[0], "second_ms": walls[1],
                     "warm_ms": walls[2:],
                     "warm_median_ms": statistics.median(walls[2:]),
                     "rows": len(rows)}
        if name in profiled:
            path = os.path.join(
                args.out, f"run_walls_{os.path.basename(tree)}_{name}.txt")
            out[name]["host_profile"] = _profile(spark, query, path)
    print(json.dumps(out), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
