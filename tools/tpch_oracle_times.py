"""Time the sqlite oracle on TPC-H queries: how long the indexed oracle
that ``chip_smoke.py`` holds its results against takes for each query.

    python tools/tpch_oracle_times.py [--sf 1] [--seed 20260729]
        [--cap-s 120] [--queries 2,4,...]

Generates the tables (``spark_tpu_torch/tpch/gen.py``, the seed of
``chip_smoke.py`` by default), loads every column into an in-memory
sqlite with the key columns indexed (``tpch/oracle.py:index_keys``) and
runs each query once, interrupting it after ``--cap-s`` seconds. By
default the queries are the twelve of ``chip_smoke.py``'s TPC-H phase
and those of its window phase. Prints one line per query: its seconds
and rows, or that it passed the cap. Needs no GPU.
"""

from __future__ import annotations

import argparse
import sqlite3
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=20260729)
    ap.add_argument("--cap-s", type=float, default=120.0)
    ap.add_argument("--queries", default="2,4,7,8,9,11,12,15,17,19,20,21",
                    help="TPC-H query numbers; the window phase's queries "
                         "are always timed too")
    args = ap.parse_args()

    from spark_tpu_torch.tpch import QUERIES, generate_tables
    from spark_tpu_torch.tpch.oracle import (index_keys, load_sqlite,
                                             run_oracle)
    from spark_tpu_torch.tpch.queries import (WINDOW_ORACLE_QUERIES,
                                              WINDOW_QUERIES)

    t0 = time.perf_counter()
    tables = generate_tables(args.sf, seed=args.seed)
    print(f"tables generated at sf {args.sf} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    conn = load_sqlite(tables)
    print(f"loaded in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    index_keys(conn)
    conn.execute("pragma case_sensitive_like = on")
    print(f"indexed in {time.perf_counter() - t0:.1f} s", flush=True)

    queries = {f"q{q}": QUERIES[int(q)] for q in args.queries.split(",")}
    queries.update({name: WINDOW_ORACLE_QUERIES.get(name, q)
                    for name, q in WINDOW_QUERIES.items()})
    try:
        for name, q in queries.items():
            deadline = time.perf_counter() + args.cap_s
            conn.set_progress_handler(
                lambda: int(time.perf_counter() > deadline), 100_000)
            t0 = time.perf_counter()
            try:
                rows = run_oracle(conn, q)
            except sqlite3.OperationalError as e:
                if "interrupted" not in str(e):
                    raise
                print(f"{name}: past the cap of {args.cap_s:.0f} s",
                      flush=True)
                continue
            print(f"{name}: {time.perf_counter() - t0:.2f} s, "
                  f"{len(rows)} rows", flush=True)
    finally:
        conn.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
