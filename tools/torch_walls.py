"""Warm wall times of named queries through the PyTorch port on one GPU,
so that two trees of the repo can be compared in one call on one card.

    python tools/torch_walls.py --tree DIR [--queries q16,a1_sorted]
                                [--sf 1.0] [--reps 5]

Imports ``spark_tpu_torch`` from DIR (a checkout of any commit that has
the port), generates TPC-H at ``--sf`` with chip_smoke.py's seed,
registers the eight tables on a ``device("cuda")`` session, runs each
query once, then ``--reps`` warm runs of ``spark.sql(q).collect()``, and
prints one JSON line: the tree, the card's name and power limit, and per
query the warm walls in ms (host clock around ``collect()``, which ends
in a copy to the host), their median and the row count. Query names are
``qN`` (TPC-H) or a key of ``SCALAR_QUERIES``. Compare two trees in
turns within one call (parent, change, change, parent): walls move 30%
between machines.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True)
    ap.add_argument("--queries", default="q16,a1_sorted")
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    sys.path.insert(0, os.path.abspath(args.tree))
    os.environ["TZ"] = "UTC"  # timestamp literals read in the local zone
    time.tzset()
    import torch

    if not torch.cuda.is_available():
        print("torch_walls: needs a CUDA device", file=sys.stderr)
        return 1
    from spark_tpu_torch.api.session import SparkSession
    from spark_tpu_torch.tpch import QUERIES, generate_tables, register_views
    from spark_tpu_torch.tpch.queries import SCALAR_QUERIES

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    spark = SparkSession(device="cuda")
    register_views(spark, generate_tables(args.sf, seed=20260729))
    out = {"tree": args.tree, "card": card, "sf": args.sf}
    for name in args.queries.split(","):
        query = (QUERIES[int(name[1:])] if name[1:].isdigit()
                 else SCALAR_QUERIES[name])
        rows = spark.sql(query).collect()
        walls = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            spark.sql(query).collect()
            walls.append((time.perf_counter() - t0) * 1e3)
        out[name] = {"walls_ms": walls, "median_ms": statistics.median(walls),
                     "rows": len(rows)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
