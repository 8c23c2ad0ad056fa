"""Run all 22 TPC-H queries through the PyTorch port on the CPU and say,
for each, whether its rows equal the reference engine's and the sqlite
oracle's, or where it stops.

    JAX_PLATFORMS=cpu python tools/torch_tpch_census.py [--sf 0.02] [--seed 99]

The query texts are the port's (``spark_tpu_torch/tpch/queries.py``,
copied from the reference package's); both engines run on the same
generated tables, and sqlite's copy has its key columns indexed. Prints
one line per query and a summary; exits non-zero when any query fails.
Takes several minutes, most of it the reference engine's compiles.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=0.02)
    ap.add_argument("--seed", type=int, default=99)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from spark_tpu.api.session import SparkSession as RefSession
    from spark_tpu.tpch.gen import generate_tables
    from spark_tpu.tpch.gen import register_views as ref_register
    from spark_tpu_torch.api.session import SparkSession as PortSession
    from spark_tpu_torch.tpch import QUERIES
    from spark_tpu_torch.tpch import register_views as port_register
    from spark_tpu_torch.tpch.oracle import (assert_rows_match, index_keys,
                                             load_sqlite, run_oracle)

    tables = generate_tables(args.sf, seed=args.seed)
    ref = RefSession.builder.getOrCreate()
    ref_register(ref, tables)
    port = PortSession.builder.device("cpu").getOrCreate()
    port_register(port, tables)
    conn = load_sqlite(tables)
    index_keys(conn)
    conn.execute("pragma case_sensitive_like = on")
    failed = []
    for q in sorted(QUERIES):
        try:
            got = [tuple(r) for r in port.sql(QUERIES[q]).collect()]
            want = [tuple(r) for r in ref.sql(QUERIES[q]).collect()]
            if got != want:
                raise AssertionError(f"rows differ from the reference: "
                                     f"{got[:3]} vs {want[:3]}")
            assert_rows_match(got, run_oracle(conn, QUERIES[q]),
                              label=f"q{q}")
            print(f"q{q}: pass ({len(got)} rows)", flush=True)
        except (NotImplementedError, AssertionError, ValueError,
                KeyError, RuntimeError) as e:
            failed.append(q)
            print(f"q{q}: FAIL {type(e).__name__}: {str(e)[:300]}",
                  flush=True)
    print(f"{22 - len(failed)} of 22 pass at sf {args.sf}, seed "
          f"{args.seed}; failing: {failed or 'none'}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
