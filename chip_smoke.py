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
   phase, made in a child process (``--oracle-child``, the same seed)
   from the start, beside the build and the kernel phase. The same
   child then holds each result a phase sends it (``OracleChecks``: the
   main process only pickles the rows to the child's standard input)
   against the oracle, beside the phases; the command waits for the
   child, and fails on its first mismatch, before the result lines.
   Beside it from the start,
   the scale phase's SF10 dataset (``--dataset-child``: ``ensure_dataset``
   with the streamed writer, 8 parts, in a process per spare CPU) and
   the pyarrow computations of q1, q3 and q5 over it.
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
     UNION (``tpch/queries.py:WINDOW_QUERIES``; no launch; oracle for
     W1 and S1), and W4
     (``WINDOW_FLOAT_QUERIES``): float running and 7-row sliding sums
     and averages over lineitem's 6M rows, within 1e-12 of each frame's
     sum of |x| of the CPU run and of the host's numpy sums of each
     frame's rows (ROADMAP C3).
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
   - ooc phase (the out-of-memory tier, over the io phase's Parquet
     files, on a fresh session on the card): each query of
     ``tpch/queries.py:OOC_QUERIES`` resident, then chunked at a budget
     one byte under its largest scan's estimate (q12: under the second
     largest) at pipeline depths 0 and 2, 2^21 chunk rows (lineitem in
     3 chunks): q1, q1-wide (the seg_sum count and int64 sum and
     seg_minmax in every chunk and merge), F1 (float sums: seg_fsum), q3
     (lineitem streamed through one sidecar, the host key filter), K1 (a
     streamed top-k) through ``_ChunkedAgg``/``_ChunkedTopK``, q12
     through the hybrid hash join and again through the grace hash join,
     q18 through none (resident); q1-wide again at 2^19 chunk rows (12
     chunks). Each chunked run: the tier asserted, launches counted from
     0 and equal to the card's own count, every wrapper call held
     against its plain version, rows equal to the resident run's (F1's
     floats within 1e-12), the graph pool and the stage cache unchanged,
     no ladder replan and no hybrid fallback; it prints its chunks, rows
     in and kept, the pipeline's decode, filter, transfer, compute and
     wait ms and overlap share, and its wall beside the resident walls.
     Then a real device OOM in a subprocess (``--oom-child``): q1-wide
     under ``set_per_process_memory_fraction`` below its resident peak
     must replan through the ladder on ``torch.cuda.OutOfMemoryError``
     to the uncapped rows; and ``cache()`` of a lineitem aggregate: one
     materialization, a store hit, ``unpersist`` releasing the bytes.
   - Mesh phase (``parallel/``, ranks sharing the card): the 22 TPC-H
     queries on ``mesh[4]`` twice (bit-identical) and q1, q3, q5, q18 on
     ``mesh[1]``, with q1-wide and MESH_F168, against the single-device
     run and sqlite; launches, stages and exchanges printed.
   - Frontend phase: describe, corr, approxQuantile and na.fill against
     the CPU run, a tensor UDF in a K = 168 aggregate (``run_phase``), a
     view, saveAsTable read back by a fresh session.
   - aqe phase (adaptive execution over the mesh): a check that the mesh
     phase's sessions run with adaptive execution off; the 22 TPC-H
     queries on ``mesh[4]`` off, adaptive and fused, each run twice,
     every mode bit for bit the off run's and the sqlite oracle's, each
     run's walls, rank stages, host reads, decisions and exchanges
     (rows, capacity in and out, bytes) printed; one cell per
     aggregation strategy (``AQE_CELLS``: hash, bypass, sort with its
     ORDER BY elided, presplit, partial) whose pick ``auto`` must make,
     each bit for bit its off run; a join whose runtime broadcast switch
     flips (``AQE_BROADCAST``: measured bytes under the threshold, the
     static estimate over it); every wrapper call held, the card's runs
     equal the wrappers' launches, a fused run with fewer rank stages
     than its staged run, the graph pool and the stage cache unchanged;
     the stats stages' B1 count at K = 1024 and B2 max at K = 512 timed
     against their bounds, plain versions and library calls.
   - obs phase (observability and faults): q1-wide, q3, q5 and q18 on the
     card session with tracing on (the default) and off
     (``spark.tpu.trace.enabled``), alternating, 5 warm runs each: rows
     bit for bit, every stage a replay, no host sync inside a stage
     (``graphs.guarding_stages``), the card's hand-kernel runs a
     replay's; with tracing on, one ``stage`` event per stage stamped
     with the query's trace id and a ``trace_breakdown`` whose parts sum
     to its wall; the median walls on and off printed, and q3's
     ``format_trace`` and query profile. ``tracing.trace(dir)`` around
     one q1-wide run: its Chrome trace holds the ``annotate`` region and
     one CUDA kernel event per hand-kernel run (7 + 2 + 1 + 1), in one
     of five sessions; beside it, the kernel events a 100-addition CUDA
     graph with no engine code keeps in three bare profiler sessions and
     in three ``tracing.trace`` sessions (a reading: torch's profiler
     drops a session's first kernel records, more as a process ages, and
     ``tracing.trace`` launches a primer first). q3 and
     q18 on ``mesh[4]`` with adaptive execution: every rank's
     ``stage.device`` span and every ``exchange.stats`` span carry the
     query's trace id; the exchange and aggregation profiles of the five
     strategy cells. A seeded chaos campaign (8 schedules over mesh[4]
     q3's fault points) passing its contract; the status UI answering
     /api/v1/queries, /api/v1/exchange and /trace/<id>. Last, the fault
     matrix, each cell's point firing and its rows bit for bit the clean
     run's: ``execute.device`` transient (q1-wide, retried) and oom
     (q1-wide over Parquet, replanned chunked by the ladder),
     ``pipeline.decode``/``pipeline.transfer`` transient (the ooc
     phase's chunked q1, the chunk retry), ``join.spill`` transient and
     corrupt (hybrid q12 spilling, the spill retry and the grace
     fallback), ``exchange.all_to_all`` transient (mesh[4] q3),
     ``agg.strategy``, ``agg.presplit`` and ``fusion.decide`` on their
     aqe cells; retry draws within the budget, the fault profile
     printed. Every wrapper call held; the graph pool and the stage
     cache do not grow.
   - serve phase (scheduling and serving, last): a connect server over
     the card session with FAIR pools (``SERVE_POOLS``). q1-wide, q3,
     q5, q18 and A1-168 through ``Client.sql``, each twice after the
     stage cache is dropped: the first run captures its stages on a
     scheduler worker, the second replays them (the ticket's own run
     records), both bit for bit the direct ``toArrow()`` bytes, no host
     sync inside a stage (``counting_stage_syncs``), the card's runs the
     wrappers' launches. 8 client threads send 24 queries of q1-wide,
     q3, q5 and q18 over the two pools: each result its single-client
     bytes, every run a replay, the card's runs those of the replays;
     each query's queue and run ms and the served against the direct
     walls (median of 5) printed. Two q1-wide under a budget just above
     its estimate: never both admitted. The result cache: 8 identical
     q1-wide at once run once, every answer the uncached bytes. A fleet
     of two replicas behind the router: /health, a ``serve.dispatch``
     fault re-dispatched, a stale epoch's typed 409 and a newer epoch
     the router absorbs, a 3-schedule chaos campaign and a replica
     killed and revived. The SLO tier: EDF under a 60 s deadline, a
     0.5 ms deadline rejected with ``InfeasibleDeadline`` before any
     ticket. The fault cells ``scheduler.admit`` (transient, oom),
     ``connect.request``, ``slo.predict`` and ``slo.reject``, each the
     clean bytes or the typed error, counted in the fault profile.
   - stream phase (streaming and materialized views): q1 and q1-wide
     over SF1 lineitem through a MemoryStream in 8 equal micro-batches,
     complete mode, each equal to its batch run on the card bit for bit,
     and MESH_F168's float sums (``seg_fsum`` in every partial and
     merge) within 1e-12 of each group's sum of |x| of the batch run;
     q1-wide's triggers with the stages eager and with capture on (each
     trigger's wall, Arrow/transfer ms and captures printed); a
     ``streaming.commit`` crash at trigger 5 whose restart replays the
     logged batch from the WAL to the same bytes; a 7-day tumbling
     window count over orders in append mode with a watermark, equal to
     the batch GROUP BY window; a stream-stream inner join of the first
     tenth of the orders and their lineitems (row count and checksum of
     the batch join); a materialized view of a q1-like aggregate over
     lineitem written as four Parquet files, two files appended, each
     refresh an incremental merge equal to the uncached re-read bit for
     bit, the second under a transient ``mview.refresh`` fault, retried.
   - compile phase (the compile tier): a fresh card session with the
     statistics store and the history serves q1-wide, q3, q5 and q18
     through a connect server (a first run that writes its statistics,
     then a capture); a child process (``--compile-child prewarm``)
     restarts with the history and pre-warm: each journaled query's
     first client run captures nothing and replays every stage, with the
     parent's bytes; a child with the store alone (``--compile-child
     store``): q3's first run binds the statistics, runs no blocking
     operator and captures, with the same bytes; q5 with background
     capture: served eagerly while the capture runs off-thread, then
     replayed, bit for bit, swapped once; the ``compile.background``
     cell: a failed capture pins q3 to the eager path, the same bytes.
     The obs phase's fault cells cover the wired points but the serve
     phase's and these three (``TIER_POINTS``).
   - lib phase (the libraries): each part at full size on the
     card, and a stated cut of it on the CPU and on the card, held
     against each other. ml on lineitem (5,996,700 rows; the cut its
     first 599,670): a Pipeline of StringIndexer(l_shipmode),
     StandardScaler of l_quantity, l_extendedprice, l_discount and
     l_tax and LogisticRegression of ``l_returnflag = 'R'``, a
     LinearRegression, KMeans(k=8, maxIter=20),
     DecisionTreeClassifier(maxDepth=5), RandomForestClassifier(
     numTrees=10, maxDepth=5), StringIndexer(p_type) over part, and on
     the cut a 3-fold CrossValidator over maxDepth in {2, 5}, each
     evaluated; the card's cut fits KMeans and the trees on the rows the
     CPU's fitted indexer and scaler make (``ml.state.model_from_state``):
     centers bit for bit, every assignment, the trees split for split
     and leaf for leaf, the cross validation's metrics equal; scaler
     statistics within ``LIB_AGG_TOL``, linear and logistic
     coefficients within ``LIB_COEF_TOL``. graph: a Graph500 Kronecker
     graph (A, B, C = 0.57, 0.19, 0.19, edgefactor 16) of scale 20 on the
     card, PageRank 20 supersteps (its float32 merge the first caller of
     seg_fsum's float32 mode), connected components to a fixpoint and
     an SSSP by a custom pregel with a min merge; at scale 16 on the card
     and the CPU, components and SSSP equal, PageRank within 20 * (max
     in-degree + 2) * 2^-24 relative; triangle_count at scale 12 on
     both, equal. pandas (the io phase's Parquet, card and CPU): a merge
     on the part key, a groupby over p_type (K = 150: the B1 count and
     int64 sums), value_counts, nlargest, describe. rdd: customer
     through ``.rdd``, reduceByKey by nation, ``toDF()`` into a grouped
     query on the session's device; 2,000,000 numbers through
     reduceByKey, sortByKey and a checkpoint. Each part's wall and
     launches printed; a sample of the wrapper calls (the first 2 of
     each wrapper, dtype, K and N) held against the plain versions, the
     card's runs equal to the wrappers' launches; seg_fsum float32 and
     the B1 count timed at the phase's own shapes.
   - scale phase (TPC-H at SF10): the SF1 views and captured
     stages dropped; a fresh card session reads the child's multi-part
     dataset through ``register_views(spark, path=...)``; q1, q1-wide,
     q3, q5, q9 and q18 (``SCALE_QUERIES``) each with its largest scan
     estimate against ``spark.tpu.maxDeviceBatchBytes``, a first run
     (launches counted from 0: q1-wide 7 counts, 2 int64 sums, 1 min,
     1 max, the others none; every wrapper call held against its plain
     version), ``warm_runs`` (replays bit for bit with no capture and no
     host sync inside a stage), a replay under
     ``graphs.guarding_stages``, one profiled replay; q1, q3 and q5 equal
     an in-memory card session over the same rows read back with
     pyarrow bit for bit, and the child's pyarrow computations
     (``tpch/arrow_queries.py``; ``oracle.assert_rows_match``); q1
     chunked one byte under its scan estimate (29 chunks) equal to the
     resident run; B1 and B2 timed at q1-wide's N = 60M; the graph
     pool and the phase's peak device memory printed; the dataset, the
     rows and pyarrow's answers kept for the multiproc phase.
   - multiproc phase (query execution across processes, last): the
     parent frees its device state (``free_sf1``) and starts 2 child
     processes (``--multiproc-child RANK PORT DATASET OUT``) on the one
     card, each one rank of a ``master("mesh[*]")`` session on
     ``cuda:0`` over gloo (NCCL refuses two ranks on one device; gloo
     moves CUDA tensors through host copies, the route printed), each
     reading its own 4 of the 8 lineitem and orders parts
     (``multihost.local_fragments``) into Arrow tables, sharded with
     ``multihost.sharded_batch_from_local`` (dictionaries agreed across
     the processes), and the six small tables whole; q1, q1-wide, q3,
     q5, q9 and q18 with adaptive execution off, q1-wide and q3 also
     adaptive and fused, each twice (the second bit for bit the first),
     launches counted from 0 (the card's runs equal the wrappers'),
     every wrapper call held against its plain version. Then the 2 x 2
     mesh: each child makes a ``mesh[*]`` session over 4 devices listed
     with ``meshDevices`` (``cuda:0`` each), two ranks a child, threads
     of it, their collectives on ``exchange.ProcessThreadComm``, shards
     the same Arrow tables over its two ranks in row order (SF10's parts
     are not read again), and runs q1-wide, q3, q5 and q18 off and q3
     also adaptive and fused, twice each, held the same way. Each run's
     walls, stages, exchanges (the rows and bytes that cross to the
     other process, and those that stay between a child's threads),
     result gather ms, bytes staged through the host and peak device
     memory, and each child's read and shard ms printed; child 0 times
     B1 and B2 at q1-wide's N = 30M. The parent waits at most
     ``MULTIPROC_WAIT_S`` and kills the children's process groups after;
     on both meshes both children's rows equal bit for bit, the scale
     phase's by ``match_mesh``'s rules, q1, q3 and q5 pyarrow's, every
     mode the off run's bit for bit; the 2 x 2 mesh's rows the one-rank
     runs' by ``match_mesh``'s rules. The dataset is removed.
   Outside the ooc, obs, serve, stream and compile phases every query
   must run with no ladder replan. The sqlite comparisons of ``ORACLE_HELD_BY_TESTS``
   (W2, W3, R1, C1, X1, X2, A1-168) are left out at SF1: their card rows
   equal the CPU run's, and the named tests hold the CPU run against
   sqlite.
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
   sessions): the profiler now and then drops events. The profiler runs
   with ``acc_events=True`` where torch has it, and the end of the run
   prints how many profiled runs held every event in their first
   session.
   In every query phase and the slice phase, every call of a kernel's
   wrapper on the main path is recorded (its arguments and result), and
   each is held against its plain PyTorch version on those same
   tensors: counts, int64 sums and min/max equal, float32 sums within
   rtol 1e-4 / atol 1e-3, seg_fsum bit for bit.
7. A ``{"kernels": [...]}`` line (launches by path, the multiproc
   path's the sum of its children's one-rank first runs,
   ``multiproc_2x2``'s of their 2 x 2 mesh's; the scale and multiproc
   paths' B1/B2 shapes), the card line,
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


#: when the command's process began (the obs phase logs its age)
_T0 = time.perf_counter()


def log(*args):
    # one write a line: the multiproc phase's children share stdout
    sys.stdout.write(" ".join(map(str, args)) + "\n")
    sys.stdout.flush()


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
    all; the device's own count is the measurement the checks use. The
    profiler is asked for ``acc_events=True`` where this torch has it;
    ``_PROFILES`` counts the runs whose first session held every event
    (logged at the end: whether the option ends the dropped events).
    Returns the wall, device ms and kernel launches (None when the
    profiler recorded no device time)."""
    from torch.profiler import ProfilerActivity, profile

    from spark_tpu_torch.ops import seg_agg

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    _PROFILES["all"] += 1
    opts = ({"acc_events": True} if "acc_events"
            in inspect.signature(profile.__init__).parameters else {})
    _PROFILES["acc_events"] = bool(opts)
    for attempt in range(5):
        before = sum(seg_agg.device_runs().values())
        with profile(activities=acts, **opts) as prof:
            t0 = time.perf_counter()
            frame(spark, query).collect()
            wall = (time.perf_counter() - t0) * 1e3
        ran = sum(seg_agg.device_runs().values()) - before
        # device events only: the aten op events above them repeat their
        # time
        events = _device_events(prof)
        seen = sum(e.count for e in events if _is_hand_kernel(e.key))
        if events and seen == ran:
            _PROFILES["first"] += attempt == 0
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
        return None
    log(f"profile {name}: wall {wall:.2f} ms, device {dev_us / 1e3:.3f} ms "
        f"over {n_kernels} kernel launches, device busy "
        f"{dev_us / 1e3 / wall:.1%} of the wall")
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    for e in top:
        log(f"profile {name}:   {e.self_device_time_total / 1e3:8.3f} ms "
            f"x{e.count:<5} {e.key[:90]}")
    return {"wall_ms": wall, "device_ms": dev_us / 1e3,
            "kernels": n_kernels}


#: profiled runs, and those whose first profiler session recorded every
#: hand-kernel run the card counted
_PROFILES = {"all": 0, "first": 0, "acc_events": False}


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
            if torch.cuda.is_available() \
                    and torch.cuda.is_current_stream_capturing():
                return out  # a capture runs nothing: its warm-up is held
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


#: sqlite answers by statement: the mesh phase holds the TPC-H queries the
#: earlier phases already asked the oracle
_ORACLE_ROWS: dict = {}

#: queries whose SF1 sqlite comparison is left out, to keep the command in
#: its time: each one's card rows still equal its CPU run's bit for bit
#: here, and the named test holds the CPU run against sqlite (at sf 0.01
#: to 0.02) on every run of the suite
ORACLE_HELD_BY_TESTS = {
    "w2_running": "tests/test_torch_tpch.py", "w3_sliding":
    "tests/test_torch_tpch.py", "r1_rollup": "tests/test_torch_tpch.py",
    "c1_cube": "tests/test_torch_tpch.py",
    "x1_explode": "tests/test_torch_complex_tpch.py",
    "x2_collect": "tests/test_torch_complex_tpch.py",
    "a1_168": "tests/test_torch_scalar_tpch.py"}


def at_sf1(oracle_queries: dict) -> dict:
    """``oracle_queries`` without those ``ORACLE_HELD_BY_TESTS`` holds."""
    return {name: q for name, q in oracle_queries.items()
            if name not in ORACLE_HELD_BY_TESTS}


def oracle_rows(oracle, sql: str) -> list:
    """The sqlite oracle's rows for ``sql``, asked once per statement."""
    if sql not in _ORACLE_ROWS:
        from spark_tpu_torch.tpch.oracle import run_oracle

        _ORACLE_ROWS[sql] = run_oracle(oracle, sql)
    return _ORACLE_ROWS[sql]


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


#: the seed of the SF1 tables (the oracle's child makes the same ones)
SF1_SEED = 20260729


def oracle_child(root: str, sf: float = 1.0, seed: int = SF1_SEED) -> int:
    """``--oracle-child ROOT SF SEED``: the sqlite oracle of the tables at
    ``sf`` from ``seed`` (the command's: SF1, ``SF1_SEED``), built in a
    process of its own from the start of the command, which
    then holds each result the main process sends it (a pickled
    ``(rows, sql, label, line)`` on its standard input, read by a thread
    from the start so the main process never waits on the pipe) against
    the oracle's rows for its statement, in order, and logs ``line`` with
    the seconds it took. The first mismatch is written to
    ``ROOT/oracle_error.txt`` and ends the child with 1."""
    import pickle
    import queue
    import threading

    from spark_tpu_torch.tpch import generate_tables
    from spark_tpu_torch.tpch.oracle import assert_rows_match

    items = queue.Queue()

    def read() -> None:
        while True:
            try:
                items.put(pickle.load(sys.stdin.buffer))
            except EOFError:
                items.put(None)
                return

    threading.Thread(target=read, daemon=True).start()
    t0 = time.perf_counter()
    conn = oracle_connection(generate_tables(sf, seed=seed))
    log(f"oracle: the child process made its tables and sqlite database "
        f"in {time.perf_counter() - t0:.1f} s")
    while (item := items.get()) is not None:
        rows, sql, label, line = item
        t0 = time.perf_counter()
        try:
            assert_rows_match(rows, oracle_rows(conn, sql), label=label)
        except BaseException as e:
            with open(os.path.join(root, "oracle_error.txt"), "w") as f:
                f.write(f"{type(e).__name__}: {e}")
            return 1
        log(f"{line} ({time.perf_counter() - t0:.1f} s, in the oracle's "
            "process)")
    return 0


class OracleChecks:
    """The sqlite oracle's comparisons, in the oracle's child process
    (``oracle_child``), beside the phases: the main process only pickles
    each result to the child's standard input, and no thread of its own
    takes a share of its interpreter. ``expect`` raises the first
    mismatch once the child has ended on it; ``finish`` closes the input,
    waits for the child and raises it. ``sf`` and ``seed`` make the
    child's tables: those of the phases' sessions."""

    def __init__(self, root: str, sf: float = 1.0, seed: int = SF1_SEED):
        self._error_path = os.path.join(root, "oracle_error.txt")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--oracle-child",
             root, str(sf), str(seed)], stdin=subprocess.PIPE)

    def expect(self, rows, sql: str, label: str, line: str) -> None:
        """Send ``rows`` to be held against the oracle's for ``sql``;
        ``line`` is logged by the child, with the seconds the comparison
        took, when they match."""
        import pickle

        if self.proc.poll() is not None:
            self._raise()
        try:
            pickle.dump((list(rows), sql, label, line), self.proc.stdin)
            self.proc.stdin.flush()
        except BrokenPipeError:
            self.proc.wait()
            self._raise()

    def finish(self) -> None:
        t0 = time.perf_counter()
        try:
            self.proc.stdin.close()
        except BrokenPipeError:
            pass
        rc = self.proc.wait()
        log(f"oracle: waited {time.perf_counter() - t0:.1f} s for the "
            "child's comparisons at the end")
        if rc != 0:
            self._raise()

    def _raise(self) -> None:
        why = f"its process exited with {self.proc.returncode}"
        if os.path.exists(self._error_path):
            with open(self._error_path) as f:
                why = f.read()
        raise RuntimeError(f"chip_smoke check failed: the sqlite oracle: "
                           f"{why}")


def slice_phase(seg_agg, gpu, cpu, oracle, dev="cuda"):
    from spark_tpu_torch import recovery
    from spark_tpu_torch.physical import graphs
    from spark_tpu_torch.tpch import Q1_WIDE, QUERIES

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
            check(recovery.last_ladder.get("replans", 0) == 0,
                  f"{name}: the OOM ladder replanned: "
                  f"{recovery.last_ladder}")
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

    oracle.expect(gpu_rows["q1"], QUERIES[1], "q1[sqlite]",
                  "slice: q1 equals the sqlite oracle")
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
    from spark_tpu_torch import recovery
    from spark_tpu_torch.physical import graphs

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
            check(recovery.last_ladder.get("replans", 0) == 0,
                  f"{name}: the OOM ladder replanned: "
                  f"{recovery.last_ladder}")
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
        sql, cols = q if isinstance(q, tuple) else (q, None)
        held = rows[name] if cols is None else [
            tuple(r[i] for i in cols) for r in rows[name]]
        oracle.expect(held, sql, f"{name}[sqlite]",
                      f"{label}: {name} equals the sqlite oracle")

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
    replay's values. Returns the capture run's wall, the replays' walls
    and their host syncs."""
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
        capture_ms = wall
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
    return {"capture_ms": capture_ms, "replay_ms": walls,
            "replay_syncs": warm_syncs}


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


#: W4's float frame sums: within this much of each frame's sum of |x|,
#: against the CPU run and the host's numpy sums
W4_TOL = 1e-12


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
    W1-W3 sum decimals or integers (exact int64 arithmetic), so the
    card's rows equal the CPU run's exactly. W1 and S1 equal the sqlite
    oracle at SF1; W2, W3, R1 and C1 are held against it by the test
    ``ORACLE_HELD_BY_TESTS`` names. W4 (``WINDOW_FLOAT_QUERIES``): a float running
    sum and a 7-row sliding sum and average over lineitem's 6M rows per
    supplier (ROADMAP C3: frame sums of disjoint power-of-two blocks),
    the rows of one order in a thousand: within ``W4_TOL`` of each
    frame's sum of |x| of the CPU run and of the host's numpy sums of
    each frame's rows (sqlite's sliding sums subtract: no oracle)."""
    from spark_tpu_torch.columnar.arrow import to_arrow
    from spark_tpu_torch.tpch.queries import (WINDOW_FLOAT_QUERIES,
                                              WINDOW_ORACLE_QUERIES,
                                              WINDOW_QUERIES, w4_host_frames)

    oracle_queries = {name: WINDOW_ORACLE_QUERIES.get(name, q)
                      for name, q in WINDOW_QUERIES.items()}

    def match(name, card, cpu_rows):
        if name not in WINDOW_FLOAT_QUERIES:
            check(card == cpu_rows, f"{name}: card != CPU run")
            return
        check(len(card) == len(cpu_rows) > 0, f"{name}: row counts differ")
        t0 = time.perf_counter()
        host = w4_host_frames(to_arrow(cpu.catalog.lookup("lineitem").batch),
                              card)
        worst_cpu = worst_host = 0.0
        for g, c, (run, s7, a7, mrun, m7) in zip(card, cpu_rows, host):
            # v itself may differ by an ulp: the card's sqrt and decimal
            # descaling round as its own
            check(g[:3] == c[:3], f"{name}: keys differ: {g} {c}")
            for got, other, want, mag in ((g[3], c[3], g[3], abs(c[3])),
                                          (g[4], c[4], run, mrun),
                                          (g[5], c[5], s7, m7),
                                          (g[6], c[6], a7, m7 / 7)):
                mag = max(mag, 1e-300)
                worst_cpu = max(worst_cpu, abs(got - other) / mag)
                worst_host = max(worst_host, abs(got - want) / mag)
        check(worst_cpu <= W4_TOL and worst_host <= W4_TOL,
              f"{name}: {worst_cpu:.3g} of the frames' magnitude from the "
              f"CPU run, {worst_host:.3g} from the host sums")
        log(f"window: {name} {len(card)} rows: frame sums within "
            f"{worst_cpu:.3g} of the CPU run's and {worst_host:.3g} of the "
            f"host's numpy sums, of each frame's sum of |x| (bound "
            f"{W4_TOL}; host check {time.perf_counter() - t0:.1f} s)")

    return run_phase("window", seg_agg, gpu, cpu,
                     {**WINDOW_QUERIES, **WINDOW_FLOAT_QUERIES}, {},
                     oracle, at_sf1(oracle_queries), dev, match_cpu=match)


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
    ``SCALAR_ORACLE_QUERIES`` equal to the oracle's at SF1 but
    ``ORACLE_HELD_BY_TESTS``'s."""
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
                     SCALAR_LAUNCHES, oracle, at_sf1(SCALAR_ORACLE_QUERIES),
                     dev, match_cpu=match)


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


def io_phase(seg_agg, gpu, cpu, oracle, dev="cuda", root=None):
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
    The files go to ``root``, a temporary directory the caller removes
    (the ooc phase reads them too)."""
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
    at SF1 (``COMPLEX_ORACLE_QUERIES``, the columns that do not depend on
    row order, but ``ORACLE_HELD_BY_TESTS``'s) and for X4 Python's
    ``str.split`` with ``Counter``. Then X6
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
                      COMPLEX_LAUNCHES, oracle, at_sf1(COMPLEX_ORACLE_QUERIES),
                      dev)
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


#: the ooc phase's chunk rows (lineitem's 6M rows stream in 3 chunks),
#: and the smaller chunks of its one run at 12 chunks
OOC_CHUNK_ROWS = 1 << 21
OOC_SMALL_CHUNK_ROWS = 1 << 19
#: F1's float sums and averages: the chunked rows within this much of
#: each value's magnitude of the resident rows' (another summation order:
#: seg_fsum rounds each partial once)
OOC_TOL = 1e-12


def _ooc_session(root: str, dev: str):
    from spark_tpu_torch.api.session import SparkSession

    spark = SparkSession(device=dev)
    for name in IO_TABLES:
        spark.read.parquet(os.path.join(root, name)) \
            .createOrReplaceTempView(name)
    return spark


def _ooc_rows_equal(name: str, got, want) -> float:
    """Chunked rows against resident rows: exact, F1's floats within
    ``OOC_TOL`` of their magnitude; the worst relative gap."""
    if name != "f1_168":
        check(got == want, f"ooc {name}: chunked rows != resident rows")
        return 0.0
    check(len(got) == len(want), f"ooc {name}: row counts differ")
    worst = 0.0
    for g, w in zip(got, want):
        check(g[:5] == w[:5], f"ooc {name}: keys or counts differ")
        for a, b in zip(g[5:], w[5:]):
            worst = max(worst, abs(a - b) / max(abs(b), 1e-300))
    check(worst <= OOC_TOL, f"ooc {name}: floats {worst:.3g} apart")
    return worst


def ooc_run(seg_agg, spark, name: str, query, tier, over: int, depth: int,
            chunk_rows: int, want_rows, settings=None, dev="cuda") -> dict:
    """One chunked run of ``query`` on ``spark`` at the budget one byte
    under the ``over``-th largest scan: the tier ``find_chunkable`` picks
    must be ``tier``; launch counters set to 0 before and read after, the
    card's own kernel runs equal to the wrappers' launches and every
    wrapper call held against its plain version; rows equal to
    ``want_rows``; the graph pool and the stage cache unchanged; no
    ladder replan and no hybrid fallback. Returns the launches by mode."""
    from spark_tpu_torch import recovery
    from spark_tpu_torch.physical import chunked, graphs
    from spark_tpu_torch.plan.optimizer import optimize
    from spark_tpu_torch.tpch.queries import ooc_budget

    df = spark.sql(query)
    budget = ooc_budget(optimize(df._plan, spark.conf), over)
    conf = {"spark.tpu.maxDeviceBatchBytes": budget,
            "spark.tpu.chunkRows": chunk_rows,
            "spark.tpu.pipelineDepth": depth, **(settings or {})}
    for key, val in conf.items():
        spark.conf.set(key, val)
    try:
        found = chunked.find_chunkable(optimize(df._plan, spark.conf),
                                       spark.conf)
        got_tier = None if found is None else type(found).__name__
        check(got_tier == tier, f"ooc {name}: tier {got_tier}, want {tier}")
        def pool():
            return graphs.pool_bytes() if dev == "cuda" else None

        pool0, stages0 = pool(), graphs.cached_stages()
        rec0 = chunked.last_run
        seg_agg.reset_launches()
        runs = device_runs(seg_agg, dev)
        with recording_calls(seg_agg) as calls:
            t0 = time.perf_counter()
            rows = [tuple(r) for r in df.collect()]
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        launches = {m: n for m, n in mode_launches(seg_agg).items() if n}
        if dev == "cuda":  # on the CPU the wrappers take plain versions
            ran = ran_since(seg_agg, runs)
            check(ran == launches, f"ooc {name}: the card ran {ran}, the "
                  f"wrappers launched {launches}")
            check(len(calls) == sum(launches.values()),
                  f"ooc {name}: {len(calls)} wrapper calls, {launches}")
        hold_calls(seg_agg, calls, f"ooc {name}")
        check(pool() == pool0 and graphs.cached_stages() == stages0,
              f"ooc {name}: the graph pool or the stage cache changed "
              f"({pool0} -> {pool()} bytes, {stages0} -> "
              f"{graphs.cached_stages()} stages)")
        check(recovery.last_ladder.get("replans") == 0,
              f"ooc {name}: the ladder replanned: {recovery.last_ladder}")
    finally:
        for key in conf:
            spark.conf.unset(key)
    worst = _ooc_rows_equal(name, rows, want_rows)
    rec = chunked.last_run
    if tier is None:
        check(rec is rec0, f"ooc {name}: a tier ran: {rec}")
        log(f"ooc: {name} depth {depth}: no tier (runs resident), "
            f"{wall:.1f} ms, rows equal the resident run's; launches "
            f"{launches}")
        return launches
    check(rec is not rec0 and rec["tier"] == tier,
          f"ooc {name}: the run recorded {rec and rec['tier']}")
    check(rec.get("fallback") is None,
          f"ooc {name}: the hybrid join fell back: {rec}")
    log(f"ooc: {name} {tier} depth {depth} budget {budget} chunk rows "
        f"{chunk_rows}: {wall:.1f} ms chunked; chunks {rec['chunks']}, "
        + (f"rows in {rec['rows_in']} kept {rec['rows_kept']}, "
           if "rows_in" in rec else f"partitions {rec['partitions']}, ")
        + f"pipeline decode {rec['decode_ms']:.1f} ms, filter "
        f"{rec['filter_ms']:.1f} ms, transfer {rec['transfer_ms']:.1f} ms, "
        f"compute {rec['compute_ms']:.1f} ms, consumer wait "
        f"{rec['stall_consumer_ms']:.1f} ms, overlap "
        f"{rec['overlap_ms']:.1f} ms ({rec['overlap_ratio']:.1%} of the "
        f"tier's {rec['wall_ms']:.1f} ms), most in flight "
        f"{rec['max_inflight_chunks']} chunks / "
        f"{rec['max_inflight_bytes'] / 2 ** 20:.1f} MiB; launches "
        f"{launches} ({len(calls)} wrapper calls held against the plain "
        f"versions); rows equal the resident run's"
        + (f" (floats within {worst:.3g})" if worst else ""))
    if "sidecars" in rec:
        log(f"ooc: {name} sidecars {rec['sidecars']}, host key filters "
            f"{rec['key_filters']}, sidecar ms {rec['sidecar_ms']:.1f}")
    if "spilled_parts" in rec:
        log(f"ooc: {name} hybrid: granted {rec['granted_bytes']} bytes, "
            f"staged {rec['staged_bytes']}, spilled partitions "
            f"{rec['spilled_parts']}, recursion depth {rec['depth']}, key "
            f"NDV estimate {rec['ndv']}")
    return launches


def ooc_phase(seg_agg, gpu, cpu, oracle, dev="cuda", root=None):
    """The out-of-memory tier at SF1, over the io phase's Parquet tables
    (``root``) on a fresh session on the card: each query of
    ``tpch/queries.py:OOC_QUERIES`` resident (its rows, its first wall
    and its warm wall), then chunked at the budget one byte under its
    largest scan's estimate (q12: under the second largest, so both its
    scans are over it) at pipeline depths 0 and 2 (``ooc_run``: the
    tier asserted, launches counted on the card, rows equal to the
    resident run's, graph pool and stage cache unchanged, no replan);
    q12 again with ``spark.tpu.join.hybrid.enabled`` off (the grace hash
    join) and q1-wide at 2^19 chunk rows (12 chunks). q1-wide must run
    the seg_sum count and int64 sum and seg_minmax in its chunks and
    merges, F1 seg_fsum. Then a real device OOM in a subprocess
    (``oom_child``: the ladder must replan on ``torch.cuda.
    OutOfMemoryError`` to the resident rows) and ``cache()`` of a
    lineitem aggregate (one materialization, store bytes, hits,
    ``unpersist`` releasing the bytes). Returns the launches of the
    chunked runs."""
    from spark_tpu_torch.tpch.queries import OOC_QUERIES

    spark = _ooc_session(root, dev)
    total = {m: 0 for m in mode_launches(seg_agg)}

    def add(launches):
        for m, n in launches.items():
            total[m] += n

    resident = {}
    for name, (query, tier, over) in OOC_QUERIES.items():
        t0 = time.perf_counter()
        resident[name] = [tuple(r) for r in spark.sql(query).collect()]
        first = (time.perf_counter() - t0) * 1e3
        walls = []
        for _ in range(2):
            t0 = time.perf_counter()
            spark.sql(query).collect()
            walls.append((time.perf_counter() - t0) * 1e3)
        check(resident[name], f"ooc {name}: no rows")
        log(f"ooc: {name} resident: first run {first:.1f} ms (reads the "
            f"files), warm {walls} ms, {len(resident[name])} rows")
        for depth in (0, 2):
            launches = ooc_run(seg_agg, spark, name, query, tier, over,
                               depth, OOC_CHUNK_ROWS, resident[name],
                               dev=dev)
            add(launches)
            if name == "q1_wide" and dev == "cuda":
                check(all(launches.get(m) for m in
                          ("count", "sum_i64", "min", "max")),
                      f"ooc q1_wide launched {launches}")
            if name == "f1_168" and dev == "cuda":
                check(launches.get("fsum_f64", 0) >= 1,
                      f"ooc f1_168 launched {launches}")
    query, _, over = OOC_QUERIES["q12"]
    add(ooc_run(seg_agg, spark, "q12", query, "_GraceHashAgg", over, 2,
                OOC_CHUNK_ROWS, resident["q12"],
                {"spark.tpu.join.hybrid.enabled": False}, dev))
    query, tier, over = OOC_QUERIES["q1_wide"]
    add(ooc_run(seg_agg, spark, "q1_wide", query, tier, over, 2,
                OOC_SMALL_CHUNK_ROWS, resident["q1_wide"], dev=dev))
    if dev == "cuda":  # a CUDA OOM needs the card's allocator
        oom_check(root)
    cache_check(spark)
    return total


def oom_check(root: str) -> None:
    """Run ``oom_child`` in a subprocess (its memory cap is its own) and
    check what it reports: at least one ladder replan on a real
    ``torch.cuda.OutOfMemoryError``, rows equal to the uncapped run's."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--oom-child", root], capture_output=True,
                          text=True, timeout=600)
    for line in proc.stderr.splitlines():
        log(f"ooc oom child: {line}")
    check(proc.returncode == 0, f"the OOM subprocess exited "
          f"{proc.returncode}")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    check(got["replans"] >= 1 and got["oom_seen"] and got["rows_equal"],
          f"the OOM subprocess reported {got}")
    log(f"ooc: real OOM in a subprocess ({time.perf_counter() - t0:.1f} s): "
        f"resident peak {got['peak'] / 2 ** 20:.1f} MiB, cap "
        f"{got['cap'] / 2 ** 20:.1f} MiB; {got['replans']} replans on "
        f"{got['error'][:80]!r}, budgets tried {got['budgets']}, final "
        f"budget {got['budgets'][-1]}, captured stages dropped "
        f"{got['stages_dropped']}, allocator cache emptied "
        f"{got['cache_emptied']}; {got['chunks']} chunks; rows equal the "
        "uncapped run's")


def oom_child(root: str) -> int:
    """q1-wide from Parquet resident on a session on the card, its peak
    allocation read; then on a fresh session (new sources, so the same
    blocking first-run path) under ``set_per_process_memory_fraction`` at
    60% of the way from the baseline to that peak: the resident run must
    die of a CUDA OOM and the ladder replan it through the chunked tier.
    Prints one JSON line."""
    import gc

    from spark_tpu_torch import recovery
    from spark_tpu_torch.ops import _build
    from spark_tpu_torch.physical import chunked, graphs
    from spark_tpu_torch.tpch import Q1_WIDE

    os.environ["TZ"] = "UTC"
    time.tzset()
    _build.libraries(("seg_agg", "seg_fsum"))
    spark = _ooc_session(root, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    want = [tuple(r) for r in spark.sql(Q1_WIDE).collect()]
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del spark
    gc.collect()
    graphs.drop_stages()
    torch.cuda.empty_cache()
    spark = _ooc_session(root, "cuda")
    base2 = torch.cuda.memory_allocated()
    cap = base2 + int(0.6 * (peak - base))
    total = torch.cuda.get_device_properties(0).total_memory
    torch.cuda.set_per_process_memory_fraction(cap / total)
    print(f"baseline {base} bytes, peak {peak}, cap {cap} of {total}",
          file=sys.stderr, flush=True)
    rows = [tuple(r) for r in spark.sql(Q1_WIDE).collect()]
    rec = recovery.last_ladder
    out = {"peak": peak - base, "cap": cap - base2,
           "replans": rec.get("replans", 0), "budgets": rec.get("budgets"),
           "error": rec.get("error") or "",
           "oom_seen": "OutOfMemoryError" in (rec.get("error") or ""),
           "stages_dropped": rec.get("stages_dropped"),
           "cache_emptied": rec.get("cache_emptied"),
           "chunks": (chunked.last_run or {}).get("chunks"),
           "rows_equal": rows == want}
    print(json.dumps(out), flush=True)
    return 0


def cache_check(spark) -> None:
    """``cache()`` of a lineitem aggregate read from Parquet, two queries
    over it: one materialization, the store's bytes up by the cached
    batch's, a store hit for the second query, rows equal to the
    uncached plan's; ``unpersist()`` gives the bytes back."""
    from spark_tpu_torch.api import functions as F

    agg = spark.sql("select l_returnflag, l_linestatus, l_shipmode, "
                    "count(*) as n, sum(l_quantity) as q from lineitem "
                    "group by l_returnflag, l_linestatus, l_shipmode")
    want_n = sorted(tuple(r) for r in agg.filter(F.col("n") > 1000)
                    .collect())
    want_q = [tuple(r) for r in agg.groupBy("l_returnflag")
              .agg(F.sum("q").alias("q")).orderBy("l_returnflag").collect()]
    store, manager = spark.memory_store, spark.cache_manager
    bytes0, hits0 = store.bytes_used(), store.stats()["hits"]
    mats0 = manager.materializations
    agg.cache()
    t0 = time.perf_counter()
    got_n = sorted(tuple(r) for r in agg.filter(F.col("n") > 1000).collect())
    first = (time.perf_counter() - t0) * 1e3
    cached = store.bytes_used() - bytes0
    t0 = time.perf_counter()
    got_q = [tuple(r) for r in agg.groupBy("l_returnflag")
             .agg(F.sum("q").alias("q")).orderBy("l_returnflag").collect()]
    second = (time.perf_counter() - t0) * 1e3
    hits = store.stats()["hits"] - hits0
    check(got_n == want_n and got_q == want_q,
          "cache: rows over the cached aggregate differ")
    check(manager.materializations - mats0 == 1 and cached > 0
          and hits >= 1, f"cache: {manager.materializations - mats0} "
          f"materializations, {cached} bytes stored, {hits} hits")
    agg.unpersist()
    check(store.bytes_used() == bytes0,
          f"cache: unpersist left {store.bytes_used() - bytes0} bytes")
    log(f"ooc: cache of a lineitem aggregate: materialized once "
        f"({first:.1f} ms, {cached} bytes in the store), the second query "
        f"a store hit ({second:.1f} ms, {hits} hits); rows equal the "
        "uncached plan's; unpersist released the bytes")


#: the mesh phase's TPC-H queries on mesh[1] (all 22 run on mesh[4])
MESH1_QUERIES = (1, 3, 5, 18)
#: grouped float sums at K = 168 packed dictionary groups, beside each
#: group's sum of |x| (the bound its sums are held to): on the mesh a
#: PSumAgg whose ranks sum with seg_fsum and count with seg_sum
MESH_F168 = """select l_returnflag, l_linestatus, l_shipmode, l_shipinstruct,
       sum(l_extendedprice * (l_discount - 0.05) * 1.0) as s,
       sum(abs(l_extendedprice * (l_discount - 0.05) * 1.0)) as m,
       count(*) as n
from lineitem
group by l_returnflag, l_linestatus, l_shipmode, l_shipinstruct
order by l_returnflag, l_linestatus, l_shipmode, l_shipinstruct"""
#: floats of a mesh run against the single-device card run: within this
#: much of the magnitude (the f168 query: each group's sum of |x|; the
#: TPC-H queries, whose floats are quotients of exact decimal sums: the
#: value)
MESH_TOL = 1e-12


def mesh_session(gpu, ranks: int, dev: str):
    """A ``mesh[ranks]`` session whose ranks share ``gpu``'s device, over
    ``gpu``'s registered tables (the same batches: no copy)."""
    from spark_tpu_torch import conf as CF
    from spark_tpu_torch.api.session import SparkSession

    spark = SparkSession(device=dev, conf={CF.MESH_DEVICES.key: ranks},
                         mesh_devices=[str(gpu.device)] * ranks)
    spark.catalog._views.update(gpu.catalog._views)
    return spark


def match_mesh(name: str, got, want, mag_col=None) -> float:
    """Mesh rows against the single-device card run's: equal but for
    floats, within MESH_TOL of the value (or of column ``mag_col``, each
    group's sum of |x|). Returns the largest float difference seen, as a
    share of its bound."""
    check(len(got) == len(want), f"{name}: {len(got)} rows on the mesh, "
          f"{len(want)} on one device")
    worst = 0.0
    for g, w in zip(got, want):
        check(len(g) == len(w), f"{name}: arity")
        for j, (a, b) in enumerate(zip(g, w)):
            if isinstance(a, float) and isinstance(b, float):
                mag = abs(w[mag_col]) if mag_col is not None \
                    else max(abs(a), abs(b))
                err = abs(a - b) / max(mag, 1.0)
                check(err <= MESH_TOL, f"{name}: mesh {g} against one "
                      f"device {w}: {err:.3g} of the bound")
                worst = max(worst, err)
            else:
                check(a == b, f"{name}: mesh {g} != one device {w}")
    return worst


def mesh_run(seg_agg, spark, name: str, query, dev: str):
    """One mesh run of ``query``: its rows, wall ms, kernel launches (all
    ranks' wrappers, checked against the card's own run counts) and the
    executor's record of the run."""
    before = mode_launches(seg_agg)
    runs = device_runs(seg_agg, dev)
    t0 = time.perf_counter()
    rows = [tuple(r) for r in frame(spark, query).collect()]
    wall = (time.perf_counter() - t0) * 1e3
    after = mode_launches(seg_agg)
    launches = {m: after[m] - before[m] for m in after
                if after[m] != before[m]}
    check(dev != "cuda" or ran_since(seg_agg, runs) == launches,
          f"{name}: the device ran {ran_since(seg_agg, runs)}, the "
          f"wrappers launched {launches}")
    return rows, wall, launches, spark.mesh_executor.last_run


def log_exchanges(label: str, name: str, record: dict) -> None:
    ex = record["exchanges"]
    moved = sum(e["moved_rows"] or 0 for e in ex)
    nbytes = sum(e["moved_bytes"] or 0 for e in ex)
    per = [(e["op"], e["rows"], e["moved_rows"], e["moved_bytes"])
           for e in ex]
    ranks = [round(sum(s["rank_ms"][r] for s in record["stages"]), 1)
             for r in range(len(record["stages"][0]["rank_ms"]))] \
        if record["stages"] else []
    log(f"{label}: {name} {len(record['stages'])} stages, {len(ex)} "
        f"exchanges moving {moved} rows / {nbytes} bytes between ranks "
        f"(op, live rows, moved rows, moved bytes each: {per}); per-rank "
        f"stage wall ms {ranks}")


#: mesh[4] queries profiled for their device ms by rank
MESH_PROFILED = ("q1_wide", "q5", "q18")


def profile_mesh(spark, name: str, query) -> None:
    """One mesh run under torch.profiler: its wall, the card's device
    time (every kernel the ranks launched: the device events of the
    profile) and the card's busy share of the wall."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        frame(spark, query).collect()
        wall = (time.perf_counter() - t0) * 1e3
    events = _device_events(prof)
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    n_kernels = sum(e.count for e in events if _is_kernel(e.key))
    if dev_ms <= 0:
        log(f"mesh profile {name}: wall {wall:.1f} ms; device time not "
            "measured (the profiler recorded none)")
        return
    log(f"mesh profile {name}: wall {wall:.1f} ms, device {dev_ms:.3f} ms "
        f"over {n_kernels} kernel launches (busy {dev_ms / wall:.1%} of "
        "the wall)")


def mesh_phase(seg_agg, gpu, cpu, oracle, dev="cuda"):
    """TPC-H over a mesh of ranks sharing the card, at SF1 over the same
    tables: all 22 queries on ``mesh[4]`` and q1, q3, q5, q18 on
    ``mesh[1]``, with q1-wide (K = 168: seg_sum counts and int64 sums,
    seg_minmax) and MESH_F168 (seg_fsum on every rank, merged in rank
    order) beside them on both. Each mesh run: rows equal to the
    single-device card run (``match_mesh``) and the TPC-H queries to the
    sqlite oracle, a second mesh[4] run bit-identical, every kernel-
    wrapper call held against its plain version, the card's kernel runs
    equal to the wrappers' launches, q1-wide and f168 on mesh[4] launching
    4 times what mesh[1] does; its wall beside the single-device wall,
    its stages and every exchange's rows and bytes. Returns the path's
    launches (mesh[4] and mesh[1])."""
    from spark_tpu_torch.physical import graphs
    from spark_tpu_torch.tpch import Q1_WIDE, QUERIES

    queries = {f"q{q}": QUERIES[q] for q in sorted(QUERIES)}
    queries.update(q1_wide=Q1_WIDE, f168=MESH_F168)
    extra = ("q1_wide", "f168")
    # the single-device card runs first, outside the recorded window (a
    # stage captured there records its calls before they run)
    one, one_walls = {}, {}
    for name, q in queries.items():
        t0 = time.perf_counter()
        one[name] = [tuple(r) for r in gpu.sql(q).collect()]
        one_walls[name] = (time.perf_counter() - t0) * 1e3
    pools = graphs.pool_bytes() if dev == "cuda" else None
    cached = graphs.cached_stages()
    seg_agg.reset_launches()
    ratios, launches = {}, {}
    with recording_calls(seg_agg) as calls:
        for ranks, names in ((1, [f"q{q}" for q in MESH1_QUERIES]
                              + list(extra)), (4, list(queries))):
            spark = mesh_session(gpu, ranks, dev)
            for name in names:
                q, one_wall = queries[name], one_walls[name]
                rows, wall, launched, record = mesh_run(
                    seg_agg, spark, name, q, dev)
                launches[(ranks, name)] = launched
                worst = match_mesh(name, rows, one[name],
                                   5 if name == "f168" else None)
                if ranks == 4:
                    again, wall2, _, _ = mesh_run(seg_agg, spark, name, q,
                                                  dev)
                    check(row_bits(again) == row_bits(rows),
                          f"{name}: two mesh[4] runs differ")
                    ratios[name] = (wall, one_wall)
                if name not in extra:
                    oracle.expect(rows, q, f"{name}[mesh {ranks}]",
                                  f"mesh: {name} mesh[{ranks}] equals the "
                                  "sqlite oracle")
                log(f"mesh: {name} mesh[{ranks}] {wall:.1f} ms"
                    + (f" (again {wall2:.1f} ms)" if ranks == 4 else "")
                    + f", one device {one_wall:.1f} ms; {len(rows)} rows "
                    f"equal to one device (floats within {worst:.3g} of "
                    f"the bound {MESH_TOL})"
                    + ("" if name in extra else " (sqlite queued)")
                    + f"; launches {launched}")
                log_exchanges("mesh", f"{name} mesh[{ranks}]", record)
                if dev == "cuda" and ranks == 4 and name in MESH_PROFILED:
                    profile_mesh(spark, name, q)
    hold_calls(seg_agg, calls, "mesh")
    total = mode_launches(seg_agg)
    if dev == "cuda":
        check(len(calls) == sum(total.values()),
              f"{len(calls)} wrapper calls, {total} launches")
        for name in extra:
            one, four = launches[(1, name)], launches[(4, name)]
            check(four == {m: 4 * n for m, n in one.items()} and one,
                  f"{name}: mesh[4] launched {four}, mesh[1] {one}")
        for m in ("count", "sum_i64", "min", "max", "fsum_f64"):
            check(total[m] >= 1, f"the mesh path launched no {m} kernel")
        check(graphs.pool_bytes() == pools
              and graphs.cached_stages() == cached,
              "a mesh run changed the graph pool or the stage cache")
    tpch = [n for n in ratios if n not in extra]
    mesh_ms = sum(ratios[n][0] for n in tpch)
    one_ms = sum(ratios[n][1] for n in tpch)
    log(f"mesh: the 22 TPC-H queries took {mesh_ms:.1f} ms on mesh[4] "
        f"(first runs) and {one_ms:.1f} ms on one device (warm runs): "
        f"ratio {mesh_ms / max(one_ms, 1e-9):.2f}; by query "
        + ", ".join(f"{n} {w / max(o, 1e-9):.1f}x"
                    for n, (w, o) in ratios.items()))
    return total


#: the frontend phase's tensor UDFs inside a grouped aggregate at K =
#: 168: their float sums take seg_fsum, their counts seg_sum
FRONTEND_LAUNCHES = {"u168": {"count": 3, "fsum_f64": 2}}
FRONTEND_TOL = 1e-12


def _scaled(price, disc):
    return price.to(torch.float64) * (disc.to(torch.float64) - 5.0)


def _magnitude(price, disc):
    return torch.abs(_scaled(price, disc))


def frontend_udf_query(spark):
    """A tensor UDF (torch ops on the stage's device, over the columns'
    stored values) summed per group of lineitem's four dictionary keys,
    and its absolute value's sum: each group's bound."""
    from spark_tpu_torch import types as PT
    from spark_tpu_torch.api import functions as F

    scaled = F.udf(_scaled, returnType=PT.FLOAT64)
    magnitude = F.udf(_magnitude, returnType=PT.FLOAT64)
    df = spark.table("lineitem")
    keys = ["l_returnflag", "l_linestatus", "l_shipmode", "l_shipinstruct"]
    args = (F.col("l_extendedprice"), F.col("l_discount"))
    return df.groupBy(*keys).agg(F.sum(scaled(*args)).alias("s"),
                                 F.sum(magnitude(*args)).alias("m")) \
        .orderBy(*keys)


def frontend_phase(seg_agg, gpu, cpu, oracle, dev="cuda"):
    """The front end over SF1 on the card against the CPU run: describe,
    corr, approxQuantile and na.fill over lineitem; a tensor UDF inside a
    grouped aggregate run through ``run_phase`` (launches, every wrapper
    call held, the second run captured and replayed: no host sync inside
    its stages); create/drop temp view; saveAsTable read back by a fresh
    session on the card, equal to the source rows. Returns the launches
    of the path."""
    import tempfile

    from spark_tpu_torch import conf as CF
    from spark_tpu_torch.api.session import SparkSession

    num = ["l_orderkey", "l_partkey", "l_suppkey", "l_linenumber"]
    for label, fn in (
            ("describe", lambda s: [tuple(r) for r in s.table("lineitem")
                                    .describe(*num).collect()]),
            ("corr", lambda s: [(s.table("lineitem").corr("l_orderkey",
                                                          "l_partkey"),)]),
            ("approxQuantile", lambda s: [tuple(s.table("lineitem")
                                                .approxQuantile(
                "l_partkey", [0.1, 0.5, 0.9]))]),
            ("na.fill", lambda s: [(s.table("customer").na.fill(
                {"c_comment": "none"}).count(),)])):
        t0 = time.perf_counter()
        got = fn(gpu)
        wall = (time.perf_counter() - t0) * 1e3
        want = fn(cpu)
        worst = 0.0
        check(len(got) == len(want), f"{label}: rows differ")
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                if a is not None and b is not None and a != b:
                    a, b = float(a), float(b)  # describe's strings
                    worst = max(worst, abs(a - b) / max(abs(b), 1.0))
                else:
                    check(a == b, f"{label}: card {g} != CPU {w}")
        check(worst <= 1e-9, f"{label}: card {got} against CPU {want}")
        log(f"frontend: {label} on the card {wall:.1f} ms, equal to the "
            f"CPU run (floats within {worst:.3g} relative; bound 1e-9: "
            f"moments of 6M rows summed in another order)")

    def match(name, card, cpu_rows):
        check(len(card) == len(cpu_rows), f"{name}: row counts differ")
        worst = 0.0
        for g, c in zip(card, cpu_rows):
            check(g[:4] == c[:4], f"{name}: keys differ {g} {c}")
            mag = max(abs(c[5]), 1.0)
            worst = max(worst, abs(g[4] - c[4]) / mag,
                        abs(g[5] - c[5]) / mag)
            check(worst <= FRONTEND_TOL, f"{name}: card {g}, CPU {c}")
        log(f"frontend: {name} floats within {worst:.3g} of each group's "
            f"sum of |x| of the CPU run's (bound {FRONTEND_TOL})")

    total = run_phase("frontend", seg_agg, gpu, cpu,
                      {"u168": frontend_udf_query}, FRONTEND_LAUNCHES,
                      oracle, {}, dev, match_cpu=match)

    view = ("create or replace temp view fe_late as select l_orderkey, "
            "l_shipmode from lineitem where l_receiptdate > l_commitdate")
    q = ("select l_shipmode, count(*) as n from fe_late group by "
         "l_shipmode order by l_shipmode")
    got = []
    for s in (gpu, cpu):
        check(s.sql(view).collect() == [], "create view returned rows")
        got.append([tuple(r) for r in s.sql(q).collect()])
        s.sql("drop view fe_late")
        check(not s.catalog.tableExists("fe_late"), "view not dropped")
    check(got[0] == got[1] and got[0], "a query over the view: card != CPU")
    log(f"frontend: create/drop temp view: {len(got[0])} rows over the "
        "view, equal to the CPU run")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_wh_") as wh:
        gpu.conf.set(CF.WAREHOUSE_DIR.key, wh)
        src = [tuple(r) for r in gpu.table("customer")
               .orderBy("c_custkey").collect()]
        t0 = time.perf_counter()
        gpu.table("customer").write.saveAsTable("fe_customer")
        write_s = time.perf_counter() - t0
        fresh = SparkSession(device=dev, conf={CF.WAREHOUSE_DIR.key: wh})
        t0 = time.perf_counter()
        back = [tuple(r) for r in fresh.table("fe_customer")
                .orderBy("c_custkey").collect()]
        read_ms = (time.perf_counter() - t0) * 1e3
        gpu.conf.unset(CF.WAREHOUSE_DIR.key)
    check(row_bits(back) == row_bits(src),
          "saveAsTable: the table read back differs from its source")
    log(f"frontend: saveAsTable of customer ({len(src)} rows) written in "
        f"{write_s:.1f} s, read back by a fresh session on the card in "
        f"{read_ms:.1f} ms, equal to the source rows")
    return total


#: the aqe phase's modes on mesh[4]: adaptive execution off (the mesh
#: phase's path), on, and on with whole-query fusion
AQE_MODES = ("off", "adaptive", "fused")
#: the runtime broadcast switch's threshold: the reference's default,
#: 8 MiB of measured build-side bytes (a rehearsal at a smaller scale
#: lowers it with the static threshold beside it)
AQE_BROADCAST_BYTES = 8 * 1024 * 1024
#: one cell per aggregation strategy, over SF1 lineitem or part: name ->
#: (SQL, the strategy ``auto`` must pick, the cell's settings). hash:
#: lineitem's four dictionary keys, one of them through substr (a
#: computed key, so the static direct path does not take the group-by),
#: K = 3 * 2 * 7 * 4 = 168 measured packed codes; bypass: part by its
#: all-distinct p_partkey (domain 200,001 < sortDomainWidth); sort:
#: lineitem by (l_orderkey, l_linenumber), all distinct over a domain past
#: 2^20, ordered by the same keys (the sort is elided); presplit: a key
#: that 64% of lineitem's rows share (l_linenumber <= 3) over a
#: near-distinct tail: the hot key must pass presplitFactor times the
#: fair share rows / 4, so more than half the rows share it, and then
#: the NDV ratio is below the default bypassNdvRatio of 0.5: both are set
#: for the cell (factor 2, ratio 0.25); partial: a float sum, pinned.
AQE_CELLS = {
    "hash": ("""select l_returnflag, l_linestatus,
       substr(l_shipmode, 1, 10) as shipmode, l_shipinstruct,
       count(*) as n, sum(l_quantity) as q, min(l_linenumber) as lo,
       max(l_linenumber) as hi
from lineitem
group by l_returnflag, l_linestatus, substr(l_shipmode, 1, 10),
         l_shipinstruct
order by l_returnflag, l_linestatus, shipmode, l_shipinstruct""",
             "hash", {}),
    "bypass": ("""select p_partkey, count(*) as n, sum(p_size) as s,
       min(p_size) as lo, max(p_size) as hi
from part group by p_partkey order by p_partkey""", "bypass", {}),
    "sort": ("""select l_orderkey, l_linenumber, count(*) as n,
       sum(l_quantity) as q
from lineitem group by l_orderkey, l_linenumber
order by l_orderkey, l_linenumber""", "sort", {}),
    "presplit": ("""select hk, count(*) as n, sum(l_quantity) as q
from (select case when l_linenumber <= 3 then 0
                  else l_orderkey * 8 + l_linenumber end as hk,
             l_quantity
      from lineitem) t
group by hk order by hk""", "presplit",
                 {"spark.tpu.adaptive.agg.presplitFactor": 2,
                  "spark.tpu.adaptive.agg.bypassNdvRatio": 0.25}),
    "partial": ("""select l_suppkey, sum(l_extendedprice * 1.0) as s,
       count(*) as n
from lineitem group by l_suppkey order by l_suppkey""", "partial", {}),
}
#: a join whose build side (orders before 1994: about 30% of its rows,
#: too many for the between-stage compaction) the static estimate
#: (capacity x row width) puts past the threshold and the measured bytes
#: under it
AQE_BROADCAST = """select l_returnflag, count(*) as n, sum(l_quantity) as q
from lineitem join orders on l_orderkey = o_orderkey
where o_orderdate < date '1994-01-01'
group by l_returnflag order by l_returnflag"""


#: the skew step's cells over SF1 lineitem: name -> (the key's per-row
#: value, the join type, the skew handling). The probe side's key takes
#: one hot value (the column's least, so the build side holds it) where
#: l_orderkey % 10 <> 0, about 90% of the rows, and the row's own value
#: elsewhere; the build side is the column's distinct values with their
#: row counts as the int64 payload w (date_left's stops before 1998, so
#: the left join keeps unmatched rows). The split cells turn the broadcast
#: off and cap the demotion at 1 byte; the demotion cell keeps its default.
AQE_SKEW_CELLS = {
    "date": ("l_shipdate", "inner", "split"),
    "date_left": ("l_shipdate", "left", "split"),
    "timestamp": ("cast(l_shipdate as timestamp)", "inner", "split"),
    "decimal": ("l_extendedprice", "inner", "split"),
    "int64": ("l_suppkey", "inner", "split"),
    "string": ("l_shipmode", "inner", "split"),
    "int64_broadcast": ("l_suppkey", "inner", "broadcast"),
}


def _sql_literal(v) -> str:
    """``v`` as a SQL literal of its own type."""
    import datetime
    import decimal

    if isinstance(v, datetime.datetime):
        return f"timestamp '{v.isoformat(sep=' ')}'"
    if isinstance(v, datetime.date):
        return f"date '{v.isoformat()}'"
    if isinstance(v, decimal.Decimal):
        # from a string: a numeric literal is a double, whose CAST to a
        # decimal keeps the reference's unscaled reading (9.01 for 901.0)
        return f"cast('{v}' as decimal(12,{max(0, -v.as_tuple().exponent)}))"
    if isinstance(v, str):
        return "'" + v.replace("'", "''") + "'"
    return str(int(v))


def skew_query(gpu, value: str, how: str) -> str:
    """The skew step's join: counts and the payload's sum over the
    skewed probe side joined to the distinct values."""
    (hot,) = gpu.sql(f"select min({value}) from lineitem").collect()[0]
    where = (" where l_shipdate < date '1998-01-01'"
             if how == "left" else "")
    return f"""select count(*) as n, count(w) as m, sum(w) as s
from (select case when l_orderkey % 10 <> 0 then {_sql_literal(hot)}
                  else {value} end as hk
      from lineitem) p
{how} join (select k, count(*) as w
      from (select {value} as k from lineitem{where}) t group by k) b
  on p.hk = b.k"""


def aqe_skew_step(seg_agg, gpu, dev: str, aqe_total: dict) -> dict:
    """The skew join on mesh[4] at SF1 (``AQE_SKEW_CELLS``): each split
    cell logs a ``skew_join_split`` with a hot key and its branches'
    pairs, the demotion cell a ``skew_join_broadcast``; every cell's row
    equals, bit for bit, the one-device run's and the mesh run's with the
    skew handling off (minPairs past the row count). The one-device runs
    (and the hot values' and row count's) run their stages eagerly, so the
    graph pool and the stage cache stay as the phase checks them. Returns
    per cell the walls (first and second run), hot keys and branch
    pairs."""
    from spark_tpu_torch import conf as CF
    from spark_tpu_torch.parallel.executor import (
        BROADCAST_THRESHOLD, SKEW_MAX_BROADCAST_BYTES, SKEW_MIN_PAIRS)
    from spark_tpu_torch.physical import graphs

    def session(mode: str):
        spark = mesh_session(gpu, 4, dev)
        spark.conf.set(CF.ADAPTIVE_ENABLED.key, True)
        spark.conf.set(CF.ADAPTIVE_BROADCAST_THRESHOLD.key, -1)
        spark.conf.set(BROADCAST_THRESHOLD.key, -1)
        if mode != "broadcast":
            spark.conf.set(SKEW_MAX_BROADCAST_BYTES.key, 1)
        if mode == "off":
            spark.conf.set(SKEW_MIN_PAIRS.key, 1 << 40)
        return spark

    spark = {mode: session(mode) for mode in ("split", "broadcast", "off")}
    with graphs.eager_stages():
        (live,) = gpu.sql("select count(*) from lineitem").collect()[0]
    out = {}
    for cell, (value, how, mode) in AQE_SKEW_CELLS.items():
        t0 = time.perf_counter()
        with graphs.eager_stages():
            q = skew_query(gpu, value, how)
            one = [tuple(r) for r in gpu.sql(q).collect()]
        off, off_wall, _, off_rec = mesh_run(seg_agg, spark["off"], cell, q,
                                             dev)
        walls = []
        for _ in range(2):
            rows, wall, launched, record = mesh_run(seg_agg, spark[mode],
                                                    cell, q, dev)
            walls.append(wall)
            for m, k in launched.items():
                aqe_total[m] += k
        check(row_bits(rows) == row_bits(one) == row_bits(off),
              f"skew {cell}: mesh {rows}, skew off {off}, one device {one}")
        check(not any(e["kind"].startswith("skew_join")
                      for e in off_rec["events"]),
              f"skew {cell}: the skew-off run handled the skew")
        events = record["events"]
        split = [e for e in events if e["kind"] == "skew_join_split"]
        demoted = [e for e in events if e["kind"] == "skew_join_broadcast"]
        branches = [e for e in events if e["kind"] == "skew_join_branches"]
        if mode == "split":
            check(split and split[0]["hot_keys"] >= 1 and not demoted
                  and len(branches) == 1,
                  f"skew {cell}: no split around a hot key: {events}")
        else:
            check(demoted and not split,
                  f"skew {cell}: not demoted to a broadcast: {events}")
        n, m, _ = rows[0]
        check(n == live and m > 0.85 * live,
              f"skew {cell}: {n} rows, {m} matched of {live}: the hot key "
              "missed its build row")
        br = branches[0] if branches else {}
        check(not br or br["hot_pairs"] + br["rest_pairs"] == m,
              f"skew {cell}: branch pairs {br} against {m} matches")
        out[cell] = dict(walls_ms=walls, off_ms=off_wall, rows=n, matched=m,
                         hot_keys=split[0]["hot_keys"] if split else 0,
                         max_pairs=(split or demoted)[0]["max"],
                         median_pairs=(split or demoted)[0]["median"],
                         hot_pairs=br.get("hot_pairs"),
                         rest_pairs=br.get("rest_pairs"),
                         hot_max=br.get("hot_max"),
                         rest_max=br.get("rest_max"))
        log(f"aqe skew: {cell} ({how} join on {value}, {mode}): "
            f"{walls[0]:.1f} / {walls[1]:.1f} ms (first / second run), "
            f"{off_wall:.1f} ms with the skew handling off (first run); "
            f"{n} rows, {m} matched; " + ", ".join(
                f"{k} {v}" for k, v in out[cell].items()
                if k not in ("walls_ms", "off_ms", "rows", "matched"))
            + f"; equal to one device and to skew off "
            f"({(time.perf_counter() - t0):.1f} s with the reference runs)")
    return out


def aqe_sessions(gpu, dev: str, over=None) -> dict:
    """A mesh[4] session per mode over ``gpu``'s tables."""
    from spark_tpu_torch import conf as CF
    from spark_tpu_torch.parallel.executor import BROADCAST_THRESHOLD

    out = {}
    for mode in AQE_MODES:
        spark = mesh_session(gpu, 4, dev)
        spark.conf.set(CF.ADAPTIVE_ENABLED.key, mode != "off")
        spark.conf.set(CF.FUSION_ENABLED.key, mode == "fused")
        spark.conf.set(CF.ADAPTIVE_BROADCAST_THRESHOLD.key,
                       AQE_BROADCAST_BYTES)
        spark.conf.set(BROADCAST_THRESHOLD.key, AQE_BROADCAST_BYTES)
        for key, val in (over or {}).items():
            spark.conf.set(key, val)
        out[mode] = spark
    return out


def live_bits(batch) -> list:
    """A result batch's live rows, column by column (data, validity),
    floats as their bits: equal lists mean equal rows in equal order."""
    m = batch.data.row_mask
    out = []
    for cd in batch.data.columns:
        out.append(_bits(cd.data[m]))
        out.append(None if cd.validity is None else cd.validity[m])
    return out


def same_bits(a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        (x is None and y is None) or (x is not None and y is not None
                                      and torch.equal(x, y))
        for x, y in zip(a, b))


def _decision(e: dict) -> str:
    kind = e["kind"]
    if kind == "aqe":
        rest = {k: v for k, v in e.items() if k not in ("kind", "decision")}
        return f"aqe {e['decision']} {rest}"
    if kind == "agg":
        return (f"agg {e['strategy']} ({e['mode']}; ndv {e['ndv']} of "
                f"{e['rows']} rows, ratio {e['ratio']}, domain "
                f"{e['domain']}, hot keys {e['hot_keys']})")
    if kind == "fusion_bailout":
        return f"fusion_bailout {e['reason']}"
    if kind == "fusion":
        return f"fusion {e['spans']} spans, capacity {e['capacity']}"
    if kind == "exchange":
        return (f"exchange {e['op']} adaptive: {e['rows']} rows, capacity "
                f"{e['capacity_before']} -> {e['capacity_after']}, slice "
                f"{e['slice_capacity']}, buffer {e['buffer_bytes']} bytes")
    return f"{kind} {e}"


def log_aqe_run(name: str, mode: str, walls, record: dict) -> None:
    ex = [(e["op"], e["rows"], e["capacity_in"], e["capacity_out"],
           e["moved_bytes"]) for e in record["exchanges"]]
    runs = " / ".join(f"{w:.1f}" for w in walls)
    log(f"aqe: {name} {mode}: {runs} ms (first"
        f"{' / second run' if len(walls) > 1 else ' run'}), "
        f"{record['rank_stages']} rank stages, "
        f"{record['host_reads']} host reads; decisions "
        f"{[_decision(e) for e in record['events']]}; exchanges (op, live "
        f"rows, capacity in, capacity out, moved bytes) {ex}")


def aqe_kernel_times(seg_agg, calls, dev: str) -> dict:
    """The stats stages' hand-kernel shapes, timed: B1's count at K =
    cmWidth = 1024 (a Count-Min row) and B2's max at K = sketchRegisters
    = 512 (the HLL registers), each on the tensors of its widest recorded
    call (CUDA events, and the profiler's device ms on the card), beside
    its plain version, one library call and its bound."""
    out = {}
    for mode, name, k, pick in (
            ("count", "seg_sum", 1024,
             lambda a: a["data"] is None and a["exact_int"]),
            ("max", "seg_minmax", 512, lambda a: a["is_max"])):
        found = [a for n, a, _ in calls if n == name
                 and a["num_segments"] == k and pick(a)]
        check(found, f"aqe: no {name} {mode} call at K = {k}")
        a = max(found, key=lambda c: int(c["seg"].shape[0]))  # the widest
        seg, mask = a["seg"], a["mask"]
        n = int(seg.shape[0])
        if mode == "count":
            def kern():
                return seg_agg.seg_sum(None, seg, mask, k, exact_int=True)

            def plain():
                return seg_agg.seg_sum_plain(None, seg, mask, k, True)
            mask_f = mask.to(torch.float32)

            def lib():
                return torch.bincount(seg, weights=mask_f, minlength=k)
        else:
            data = a["data"]

            def kern():
                return seg_agg.seg_minmax(data, seg, mask, k, True)

            def plain():
                return seg_agg.seg_minmax_plain(data, seg, mask, k, True)
            fill = torch.full((k,), float("-inf"), device=seg.device)
            masked = torch.where(mask, data, fill.new_tensor(float("-inf")))
            seg_l = seg.long()

            def lib():
                return fill.scatter_reduce(0, seg_l, masked, "amax",
                                           include_self=True)
        got, want = kern(), plain()
        check(torch.equal(got, want), f"aqe: {mode} K={k} differs")
        timer = cuda_ms if dev == "cuda" else host_ms
        bnd, by = bound_ms(n * ROW_BYTES[mode] + k * got.element_size(),
                           n * 3)
        stats = dict(n=n, k=k, ms=timer(kern), plain_ms=timer(plain),
                     library_ms=timer(lib), bound_ms=bnd, bound_by=by)
        if dev == "cuda":
            # events over back-to-back calls read the launch at this
            # size; the profiler's kernel events give the device's own
            dev_ms, per_call, _ = profile_calls(kern)
            check(per_call == 1, f"aqe: {mode} K={k}: {per_call} kernels "
                  "per call, want 1")
            stats.update(device_ms=dev_ms, share=bnd / dev_ms)
        log(f"aqe kernel {mode} N={n} K={k} (the stats stage's shape): "
            + " ".join(f"{key}={val:.4f}" if isinstance(val, float)
                       else f"{key}={val}" for key, val in stats.items()))
        out[mode] = stats
    return out


def aqe_phase(seg_agg, gpu, cpu, oracle, dev="cuda"):
    """Adaptive execution over the mesh at SF1 on mesh[4] (four ranks
    sharing the card), after a check that the mesh phase's sessions run
    with adaptive execution off (the default): all 22 TPC-H queries off,
    adaptive and fused, each mode's rows bit for bit the off run's and
    the sqlite oracle's; one cell per aggregation strategy, whose pick
    ``auto`` must make (read from ``last_run``), each equal to its off
    run; a join whose runtime broadcast switch flips. Every kernel-wrapper
    call is held against its plain version, the card's kernel runs equal
    the wrappers' launches in every run, the stats stages run B1's count
    at K = 1024 and B2's max at K = 512 (timed against their bounds), a
    fused plan runs fewer rank stages than its staged one, and the graph
    pool and the stage cache stay unchanged. Returns the path's launches
    (adaptive and fused runs; the off runs are the mesh path's)."""
    from spark_tpu_torch import conf as CF
    from spark_tpu_torch import metrics
    from spark_tpu_torch.physical import graphs
    from spark_tpu_torch.tpch import QUERIES

    probe = mesh_session(gpu, 4, dev)
    check(not probe.conf.get(CF.ADAPTIVE_ENABLED)
          and not probe.conf.get(CF.FUSION_ENABLED),
          "the mesh phase's sessions run with adaptive execution on")
    sessions = aqe_sessions(gpu, dev)
    pools = graphs.pool_bytes() if dev == "cuda" else None
    cached = graphs.cached_stages()
    seg_agg.reset_launches()
    aqe_total = {m: 0 for m in mode_launches(seg_agg)}
    stages = {}
    with recording_calls(seg_agg) as calls:
        def run(spark, name, mode, q):
            rows, wall, launched, record = mesh_run(seg_agg, spark, name, q,
                                                    dev)
            if mode != "off":
                for m, k in launched.items():
                    aqe_total[m] += k
            return rows, wall, record

        for qn in sorted(QUERIES):
            name, q = f"q{qn}", QUERIES[qn]
            first = {}
            for mode in AQE_MODES:
                rows, wall, record = run(sessions[mode], name, mode, q)
                again, wall2, _ = run(sessions[mode], name, mode, q)
                check(row_bits(again) == row_bits(rows),
                      f"{name} {mode}: two runs differ")
                first[mode] = rows
                stages[(name, mode)] = record["rank_stages"]
                log_aqe_run(name, mode, (wall, wall2), record)
            for mode in ("adaptive", "fused"):
                check(row_bits(first[mode]) == row_bits(first["off"]),
                      f"{name}: the {mode} rows differ from the off run's")
            oracle.expect(first["adaptive"], q, f"{name}[aqe]",
                          f"aqe: {name} equals the sqlite oracle")
            log(f"aqe: {name} {len(first['off'])} rows: adaptive and fused "
                "bit for bit the off run's (sqlite queued)")

        for cell, (sql, want, over) in AQE_CELLS.items():
            cell_sessions = aqe_sessions(gpu, dev, over)
            out = {}
            for mode in ("off", "adaptive"):
                spark = cell_sessions[mode]
                before = mode_launches(seg_agg)
                runs = device_runs(seg_agg, dev)
                t0 = time.perf_counter()
                batch = spark.sql(sql)._execute()
                wall = (time.perf_counter() - t0) * 1e3
                after = mode_launches(seg_agg)
                launched = {m: after[m] - before[m] for m in after
                            if after[m] != before[m]}
                check(dev != "cuda" or ran_since(seg_agg, runs) == launched,
                      f"{cell} {mode}: the device ran "
                      f"{ran_since(seg_agg, runs)}, the wrappers launched "
                      f"{launched}")
                if mode == "adaptive":
                    for m, k in launched.items():
                        aqe_total[m] += k
                    # the obs phase prints this run's profiles
                    _AQE_CELL_EVENTS[cell] = metrics.last_query()
                record = spark.mesh_executor.last_run
                out[mode] = (live_bits(batch), record)
                log_aqe_run(f"cell {cell}", mode, (wall,), record)
            check(same_bits(out["adaptive"][0], out["off"][0]),
                  f"cell {cell}: the adaptive rows differ from the off run's")
            events = out["adaptive"][1]["events"]
            picks = [e["strategy"] for e in events if e["kind"] == "agg"]
            check(picks and picks[0] == want,
                  f"cell {cell}: auto picked {picks}, want {want}")
            if cell == "sort":
                check(any(e["kind"] == "aqe" and e["decision"] == "sort_elide"
                          for e in events), "cell sort: the sort not elided")
            rows = int(out["off"][0][0].shape[0])
            log(f"aqe: cell {cell}: auto picked {want}; {rows} rows bit for "
                "bit the off run's")

        spark = sessions["adaptive"]
        rows, wall, launched, record = mesh_run(seg_agg, spark,
                                                "broadcast", AQE_BROADCAST,
                                                dev)
        for m, k in launched.items():
            aqe_total[m] += k
        off_rows = [tuple(r) for r in sessions["off"].sql(AQE_BROADCAST)
                    .collect()]
        check(row_bits(rows) == row_bits(off_rows),
              "broadcast: the adaptive rows differ from the off run's")
        switch = [e for e in record["events"] if e["kind"] == "aqe"
                  and e["decision"] in ("broadcast_join", "exchange_join")]
        check(switch and switch[0]["decision"] == "broadcast_join"
              and switch[0]["measured_bytes"] <= AQE_BROADCAST_BYTES
              < switch[0]["static_bytes"],
              f"broadcast: the switch did not flip: {switch}")
        oracle.expect(rows, AQE_BROADCAST, "broadcast[aqe]",
                      "aqe: the broadcast switch's rows equal the sqlite "
                      "oracle")
        log(f"aqe: broadcast switch flipped: measured "
            f"{switch[0]['measured_bytes']} bytes, static estimate "
            f"{switch[0]['static_bytes']} bytes, threshold "
            f"{AQE_BROADCAST_BYTES}; {len(rows)} rows equal the off run's "
            f"(a partitioned join; sqlite queued), {wall:.1f} ms")

        t0 = time.perf_counter()
        _AQE_SKEW.update(aqe_skew_step(seg_agg, gpu, dev, aqe_total))
        log(f"aqe: skew step {time.perf_counter() - t0:.1f} s")
    hold_calls(seg_agg, calls, "aqe")
    total = mode_launches(seg_agg)
    if dev == "cuda":
        check(len(calls) == sum(total.values()),
              f"{len(calls)} wrapper calls, {total} launches")
        check(graphs.pool_bytes() == pools
              and graphs.cached_stages() == cached,
              "an aqe run changed the graph pool or the stage cache")
    times = aqe_kernel_times(seg_agg, calls, dev)
    fewer = [n for (n, m), s in stages.items()
             if m == "fused" and s < stages[(n, "adaptive")]]
    check(fewer, "no fused run took fewer rank stages than its staged run")
    check(all(stages[(n, "fused")] <= stages[(n, "adaptive")]
              for n, _ in stages), "a fused run took more rank stages")
    log("aqe: rank stages off / adaptive / fused: " + ", ".join(
        f"{n} {stages[(n, 'off')]}/{stages[(n, 'adaptive')]}/"
        f"{stages[(n, 'fused')]}" for n in dict.fromkeys(
            n for n, _ in stages)) + f"; fewer when fused: {fewer}")
    log(f"aqe: launches of the adaptive and fused runs {aqe_total}; all "
        f"runs {total}; {len(calls)} wrapper calls held")
    _AQE_KERNELS.update(times)
    return aqe_total


#: the aqe phase's timings of the stats stages' kernel shapes
_AQE_KERNELS: dict = {}
#: the aqe phase's skew cells: walls, hot keys, branch pairs
_AQE_SKEW: dict = {}
#: the events of each strategy cell's adaptive run in the aqe phase
_AQE_CELL_EVENTS: dict = {}


# ---- obs phase: observability and faults -----------------------------------

#: the single-device queries the obs phase traces on and off
OBS_QUERIES = ("q1_wide", "q3", "q5", "q18")
#: hand-kernel runs a replay of each makes on the card (q1-wide: B1's
#: count 7 times and int64 sum twice, B2's min and max once)
OBS_REPLAY_RUNS = {"q1_wide": {"count": 7, "sum_i64": 2, "min": 1, "max": 1}}
#: warm runs of each mode for the on/off walls
OBS_REPS = 5
#: the chaos campaign's seed and schedules (over mesh[4] q3)
OBS_CHAOS_SEED = 20261018
OBS_CHAOS_SCHEDULES = 8
#: the device budget (``spark.tpu.scheduler.hbmBudgetBytes``) that makes
#: the ooc phase's hybrid q12 spill partitions: its staged sides are larger
OBS_SPILL_BUDGET = 4 << 20


def _obs_query(name: str):
    from spark_tpu_torch.tpch import Q1_WIDE, QUERIES

    return Q1_WIDE if name == "q1_wide" else QUERIES[int(name[1:])]


def _kinds_since(events, *kinds) -> list:
    return [e for e in events if e["kind"] in kinds]


def _root_trace(events):
    spans = [e for e in events if e["kind"] == "span"]
    ids = {e["span_id"] for e in spans}
    roots = [e for e in spans if e.get("parent_id") not in ids]
    return roots[0] if len(roots) == 1 else None


def obs_traced_runs(seg_agg, gpu, dev: str) -> dict:
    """q1-wide, q3, q5 and q18 on the single-device session with tracing
    on, then off (``spark.tpu.trace.enabled``), alternating, OBS_REPS
    warm runs each (replays of the graphs the earlier phases captured,
    under ``graphs.guarding_stages``): rows equal bit for bit, every
    traced stage replayed, no host sync inside a stage, the card's
    hand-kernel runs those of a replay; with tracing on, one ``stage``
    event per stage stamped with the query's trace id and a breakdown
    whose parts sum to its wall. Returns the median walls on and off."""
    from spark_tpu_torch import metrics, tracing
    from spark_tpu_torch.physical import graphs, planner

    walls = {}
    for name in OBS_QUERIES:
        q = _obs_query(name)
        want_runs = OBS_REPLAY_RUNS.get(name, {})
        first = None
        on, off = [], []
        for rep in range(OBS_REPS):
            for traced, sink in ((True, on), (False, off)):
                gpu.conf.set("spark.tpu.trace.enabled", traced)
                runs = device_runs(seg_agg, dev)
                metrics.reset()
                t0 = time.perf_counter()
                with graphs.guarding_stages():
                    rows, syncs = collect_split_syncs(gpu, q, dev)
                sink.append((time.perf_counter() - t0) * 1e3)
                run = planner.last_run
                if first is None:
                    first = rows
                check(row_bits(rows) == row_bits(first),
                      f"obs: {name} traced={traced}: rows differ")
                if dev == "cuda":
                    check(run.replayed == run.stages >= 1
                          and run.captured == 0,
                          f"obs: {name} traced={traced}: replayed "
                          f"{run.replayed} of {run.stages} stages, "
                          f"captured {run.captured}")
                    check(syncs["in stages"] == 0,
                          f"obs: {name} traced={traced}: host syncs inside "
                          f"stages {syncs}")
                    ran = ran_since(seg_agg, runs)
                    check(ran == want_runs, f"obs: {name} traced={traced}: "
                          f"the card ran {ran}, a replay runs {want_runs}")
                evs = metrics.last_query()
                stages = _kinds_since(evs, "stage")
                n_stages = run.stages + sum(run.blocking.values())
                spans = _kinds_since(evs, "span")
                if not traced:
                    check(not spans, f"obs: {name}: spans with tracing off")
                    continue
                root = _root_trace(evs)
                check(root is not None and root["name"] == "query.execute",
                      f"obs: {name}: not one trace root")
                tid = root["trace_id"]
                check(len(stages) == n_stages
                      and all(e["trace_id"] == tid for e in stages),
                      f"obs: {name}: {len(stages)} stage events for "
                      f"{n_stages} stages, or not all of trace {tid}")
                bd = tracing.trace_breakdown(evs)
                parts = bd["queue_ms"] + bd["device_ms"] \
                    + bd["transfer_ms"] + bd["host_ms"]
                check(abs(parts - bd["wall_ms"]) <= 0.01,
                      f"obs: {name}: breakdown {bd} does not sum to wall")
                if rep == 0 and name == "q3":
                    log("obs: q3 trace:\n" + tracing.format_trace(evs))
                    log("obs: q3 query profile:\n"
                        + tracing.format_profile(tracing.query_profile(evs)))
                    log(f"obs: q3 breakdown {bd}")
        gpu.conf.unset("spark.tpu.trace.enabled")
        walls[name] = (statistics.median(on), statistics.median(off))
        log(f"obs: {name} warm walls ms, tracing on {[round(w, 3) for w in on]}"
            f" (median {walls[name][0]:.3f}), off "
            f"{[round(w, 3) for w in off]} (median {walls[name][1]:.3f}): "
            f"rows bit for bit, every stage replayed, no host sync inside "
            f"a stage, the card's runs {want_runs or 'none'} each")
    return walls


def obs_device_trace(seg_agg, gpu, dev: str, root: str) -> None:
    """``tracing.trace(dir)`` around one q1-wide run with an ``annotate``
    region: the Chrome trace it writes must hold the region and, on the
    card, CUDA kernel events, one for each hand-kernel run the card
    counted (7 + 2 + 1 + 1). A session that dropped kernel events is
    taken again, up to five in all (as ``profile_query``)."""
    from spark_tpu_torch import tracing

    q = _obs_query("q1_wide")
    for attempt in range(5):
        d = os.path.join(root, f"obs_trace_{attempt}")
        runs = device_runs(seg_agg, dev)
        with tracing.trace(d, cuda=dev == "cuda") as session:
            with tracing.annotate("obs:q1_wide"):
                frame(gpu, q).collect()
        ran = ran_since(seg_agg, runs)
        with open(session.path) as f:
            events = json.load(f)["traceEvents"]
        names = [e.get("name", "") for e in events]
        check("obs:q1_wide" in names,
              "obs: the device trace lacks the annotate region")
        if dev != "cuda":
            log(f"obs: device trace {session.path}: "
                f"{len(events)} events, the annotate region in it")
            return
        kernels = [e for e in events if e.get("cat") == "kernel"]
        check(kernels, "obs: the profiler recorded no CUDA kernel event "
              "(a CPU-only session)")
        hand = sum(1 for e in kernels if _is_hand_kernel(e.get("name", "")))
        want = sum(ran.values())
        log(f"obs: device trace {session.path} (session "
            f"{attempt + 1}): {len(events)} events, {len(kernels)} kernel "
            f"events, {hand} of B1/B2, the card ran {ran}")
        if hand == want == sum(OBS_REPLAY_RUNS["q1_wide"].values()):
            return
    check(False, f"obs: the device trace held {hand} hand-kernel events "
          f"for {want} runs in each of five sessions")


def obs_profiler_graph(dev: str, root: str) -> None:
    """torch's profiler on a CUDA graph with no engine code: 100
    additions captured in one graph, each replayed in three bare
    ``torch.profiler.profile`` sessions and in three ``tracing.trace``
    sessions. Logs the graph's kernel events each exported trace holds,
    beside the command's age. A reading, not a gate: the profiler drops
    a session's first kernel records, more the older the process, and
    ``tracing.trace`` launches a primer first (PERF.md §6-§7)."""
    from torch.profiler import ProfilerActivity, profile

    from spark_tpu_torch import tracing

    if dev != "cuda":
        return
    x = torch.zeros(1 << 16, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        x.add_(1)  # the first launch outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(100):
            x.add_(1)
    torch.cuda.synchronize()

    def kept(path: str) -> int:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        return sum(1 for e in events if e.get("cat") == "kernel"
                   and "_add" in e.get("name", ""))

    bare, traced = [], []
    for i in range(3):
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        with prof:
            graph.replay()
            torch.cuda.synchronize()
        path = os.path.join(root, f"obs_graph_bare_{i}.json")
        prof.export_chrome_trace(path)
        bare.append(kept(path))
        with tracing.trace(os.path.join(root, f"obs_graph_{i}"),
                           cuda=True) as session:
            graph.replay()
        traced.append(kept(session.path))
    log(f"obs: a CUDA graph of 100 additions, "
        f"{time.perf_counter() - _T0:.0f} s into the command: its kernel "
        f"events in three bare profiler sessions {bare}, in three "
        f"tracing.trace sessions {traced}")
    del graph, x


def obs_mesh_traced(seg_agg, gpu, dev: str) -> None:
    """q3 and q18 on mesh[4], adaptive on, the trace sampled: every rank
    stage's ``stage.device`` spans (one per rank, from the rank threads)
    and every ``exchange.stats`` span carry the query's trace id; their
    walls with tracing on and off, 3 of each in turns; then the exchange
    and aggregation profiles of the five strategy cells of
    the aqe phase, folded from the events of each cell's adaptive run
    there (traced: tracing is on by default)."""
    from spark_tpu_torch import metrics, tracing

    spark = aqe_sessions(gpu, dev)["adaptive"]
    for name in ("q3", "q18"):
        metrics.reset()
        rows, wall, launched, record = mesh_run(seg_agg, spark, name,
                                                _obs_query(name), dev)
        evs = metrics.last_query()
        root = _root_trace(evs)
        check(root is not None, f"obs: mesh {name}: not one trace root")
        tid = root["trace_id"]
        spans = _kinds_since(evs, "span")
        dev_spans = [e for e in spans if e["name"] == "stage.device"]
        stats = [e for e in spans if e["name"] == "exchange.stats"]
        check(len(dev_spans) == 4 * record["rank_stages"],
              f"obs: mesh {name}: {len(dev_spans)} stage.device spans for "
              f"{record['rank_stages']} rank stages of 4 ranks")
        check(stats and all(e["trace_id"] == tid
                            for e in dev_spans + stats),
              f"obs: mesh {name}: a rank span outside trace {tid}")
        check(len({e["tid"] for e in dev_spans}) >= 2,
              f"obs: mesh {name}: stage.device spans from one thread")
        bd = tracing.trace_breakdown(evs)
        per_rank = {r: round(sum(e["ms"] for e in dev_spans
                                 if e["rank"] == r), 3) for r in range(4)}
        log(f"obs: mesh {name} traced {wall:.1f} ms: {record['rank_stages']} "
            f"rank stages, {len(dev_spans)} stage.device and {len(stats)} "
            f"exchange.stats spans of trace {tid}; stage.device ms by rank "
            f"{per_rank} (the ranks share one stream: each also covers the "
            f"others' queued work), their union {bd['device_ms']} ms of the "
            f"{bd['wall_ms']} ms wall")
    # the cost of the sampled trace on a mesh (a span and a device sync
    # for each rank of each stage): warm walls on against off, in turns
    for name in ("q3", "q18"):
        on, off = [], []
        for _ in range(3):
            for traced, sink in ((True, on), (False, off)):
                spark.conf.set("spark.tpu.trace.enabled", traced)
                t0 = time.perf_counter()
                frame(spark, _obs_query(name)).collect()
                sink.append((time.perf_counter() - t0) * 1e3)
        spark.conf.unset("spark.tpu.trace.enabled")
        log(f"obs: mesh {name} walls ms, tracing on "
            f"{[round(w, 1) for w in on]} (median {statistics.median(on):.1f})"
            f", off {[round(w, 1) for w in off]} (median "
            f"{statistics.median(off):.1f})")
    for cell in AQE_CELLS:
        evs = _AQE_CELL_EVENTS[cell]
        check(_root_trace(evs) is not None
              and _kinds_since(evs, "agg", "exchange"),
              f"obs: cell {cell}: the aqe run's events hold no trace")
        log(f"obs: cell {cell} exchange profile:\n"
            + tracing.format_exchange_profile(tracing.exchange_profile(evs)))
        log(f"obs: cell {cell} aggregation profile:\n"
            + tracing.format_aggregation_profile(
                tracing.aggregation_profile(evs)))


#: injections of each fault point that fired inside an ``_Armed`` block
_FIRED: dict = {}


class _Armed:
    """Arm settings (fault specs) on a session for a block, then unset
    them and drop the arming counters (adding the points' fires to
    ``_FIRED``)."""

    def __init__(self, spark, settings: dict):
        self.spark, self.settings = spark, settings

    def __enter__(self):
        from spark_tpu_torch import faults

        for k, v in self.settings.items():
            self.spark.conf.set(k, v)
        faults.reset(self.spark.conf)
        return self

    def __exit__(self, *exc):
        from spark_tpu_torch import faults

        prefix = "spark.tpu.faultInjection."
        for k in self.settings:
            if k.startswith(prefix) and k[len(prefix):] in faults.POINTS:
                point = k[len(prefix):]
                _FIRED[point] = _FIRED.get(point, 0) \
                    + faults.fire_count(self.spark.conf, point)
            self.spark.conf.unset(k)
        faults.reset(self.spark.conf)
        return False


def _grab_rows(spark, query):
    """A run's rows, floats as their bits (for results of a few rows,
    and across tiers whose string dictionaries may differ)."""
    return row_bits([tuple(r) for r in frame(spark, query).collect()])


def _grab_bits(spark, query):
    """A run's live rows column by column, as ``live_bits`` (for large
    results of one session's tables)."""
    return live_bits(frame(spark, query)._execute())


def _same(a, b) -> bool:
    return same_bits(a, b) if a and torch.is_tensor(a[0]) else a == b


def obs_fault_cell(seg_agg, spark, cell: str, point: str, spec: str, query,
                   clean, grab, dev: str, expect, faulted: list,
                   settings=None, runs_want=None) -> None:
    """One fault cell: ``point`` armed with ``spec`` (and ``settings``)
    for one run of ``query``. The point must fire; the run must give the
    clean run's rows bit for bit (``grab(spark, query)`` against
    ``clean``), and ``expect(events)`` checks the recovery the reference
    performs (a cell whose reference raises a typed error would check it
    here; none of this matrix's cells does). The card's hand-kernel runs
    must equal the wrappers' launches (``runs_want``: a replay's runs,
    which go through no wrapper), and the retry budget's draws stay in
    its pool; ``tracing.fault_profile`` of the run counts the injection
    and a recovery. The run's events are added to ``faulted``."""
    from spark_tpu_torch import faults, metrics, recovery, tracing

    before = mode_launches(seg_agg)
    runs = device_runs(seg_agg, dev)
    draws0 = metrics.retry_budget_stats()
    metrics.reset()
    t0 = time.perf_counter()
    with _Armed(spark, dict(settings or {}, **{
            f"spark.tpu.faultInjection.{point}": spec})):
        got = grab(spark, query)
        fired = faults.fire_count(spark.conf, point)
    wall = (time.perf_counter() - t0) * 1e3
    check(fired >= 1, f"obs fault {cell}: {point} never fired")
    check(_same(got, clean), f"obs fault {cell}: rows differ from the clean "
          "run")
    evs = metrics.recent(4096)
    expect(evs)
    # the fault profile counts the injection at its point and a recovery
    prof = tracing.fault_profile(evs)
    check(prof.get("fault_injected", {}).get("points") == {point: fired}
          and any(prof.get(k) for k in (
              "fault_recovered", "stage_retry", "chunk_retry",
              "degraded_to_chunked", "degraded_to_adaptive")),
          f"obs fault {cell}: the fault profile {prof}")
    faulted.extend(evs)
    after = mode_launches(seg_agg)
    launched = {m: after[m] - before[m] for m in after
                if after[m] != before[m]}
    want_ran = launched if runs_want is None else runs_want
    check(dev != "cuda" or ran_since(seg_agg, runs) == want_ran,
          f"obs fault {cell}: the device ran {ran_since(seg_agg, runs)}, "
          f"want {want_ran} (wrappers launched {launched})")
    draws1 = metrics.retry_budget_stats()
    draws = draws1["draws"] - draws0["draws"]
    pool = int(spark.conf.get(recovery.RETRY_BUDGET_ATTEMPTS))
    check(draws - (draws1["floor_draws"] - draws0["floor_draws"]) <= pool,
          f"obs fault {cell}: {draws} retry draws past the pool of {pool}")
    kinds = sorted({e["kind"] for e in evs if e["kind"] in (
        "fault_injected", "fault_recovered", "stage_retry", "chunk_retry",
        "degraded_to_chunked", "degraded_to_adaptive", "fusion_bailout")})
    log(f"obs fault {cell}: {point}={spec} fired {fired}x: rows bit for bit "
        f"the clean run's in {wall:.1f} ms; events {kinds}; retry draws "
        f"{draws}; launches {launched}")


def obs_fault_matrix(seg_agg, gpu, dev: str, root: str) -> None:
    """The fault matrix, each cell against its clean run (``obs_fault_
    cell``), then ``tracing.fault_profile`` of every cell's run holding
    one injection a cell."""
    from spark_tpu_torch import faults, metrics, recovery, tracing
    from spark_tpu_torch.physical import chunked
    from spark_tpu_torch.plan.optimizer import optimize
    from spark_tpu_torch.tpch.queries import OOC_QUERIES, ooc_budget

    def has(*kinds):
        def expect(evs):
            got = {e["kind"] for e in evs}
            check(all(k in got for k in kinds),
                  f"obs: events {sorted(got)} lack {kinds}")
        return expect

    cells = []  # (cell, point) of every cell run
    faulted: list = []  # every cell's events

    def cell(name, spark, point, spec, query, clean, expect,
             grab=_grab_rows, **kw):
        obs_fault_cell(seg_agg, spark, name, point, spec, query, clean,
                       grab, dev, expect, faulted, **kw)
        cells.append((name, point))

    # execute.device: transient on q1-wide on the card session (retried
    # from the plan), oom on q1-wide over Parquet (replanned chunked)
    q1w = _obs_query("q1_wide")
    clean = _grab_rows(gpu, q1w)
    # the retried run replays q1-wide's graphs: its kernels run through no
    # wrapper
    cell("execute.device transient", gpu, "execute.device",
         "nth:1:transient", q1w, clean,
         has("fault_injected", "stage_retry", "fault_recovered"),
         runs_want=OBS_REPLAY_RUNS["q1_wide"])
    ooc = _ooc_session(root, dev)
    clean_pq = _grab_rows(ooc, q1w)
    check(clean_pq == clean, "obs: q1-wide from Parquet differs from the "
          "in-memory run")

    def replanned(evs):
        has("fault_injected", "degraded_to_chunked", "fault_recovered")(evs)
        check(recovery.last_ladder["replans"] >= 1
              and not _kinds_since(evs, "stage_retry"),
              f"obs: the oom was not replanned by the ladder: "
              f"{recovery.last_ladder}")

    cell("execute.device oom", ooc, "execute.device", "nth:1:oom", q1w,
         clean_pq, replanned, settings={
             "spark.tpu.chunkRows": OOC_CHUNK_ROWS})
    # pipeline.decode / pipeline.transfer: the ooc phase's chunked q1 at
    # depth 2, the chunk retry taking the fault
    q1, tier, over = OOC_QUERIES["q1"]
    chunk = {"spark.tpu.maxDeviceBatchBytes": ooc_budget(
                 optimize(ooc.sql(q1)._plan, ooc.conf), over),
             "spark.tpu.chunkRows": OOC_CHUNK_ROWS,
             "spark.tpu.pipelineDepth": 2}
    with _Armed(ooc, chunk):
        clean_q1 = _grab_rows(ooc, q1)
        check(chunked.last_run["tier"] == tier, "obs: q1 did not chunk")

    def chunk_retried(evs):
        has("fault_injected", "chunk_retry", "fault_recovered")(evs)
        check(not _kinds_since(evs, "stage_retry"),
              "obs: the chunk fault restarted the query")

    for point in ("pipeline.decode", "pipeline.transfer"):
        cell(f"{point} transient", ooc, point, "nth:2:transient", q1,
             clean_q1, chunk_retried, settings=chunk)
    # join.spill: the hybrid q12 with partitions spilled, transient (the
    # spill retry) and corrupt (one rung down: the grace join)
    q12, tier12, over12 = OOC_QUERIES["q12"]
    spill = {"spark.tpu.maxDeviceBatchBytes": ooc_budget(
                 optimize(ooc.sql(q12)._plan, ooc.conf), over12),
             "spark.tpu.chunkRows": OOC_CHUNK_ROWS,
             "spark.tpu.scheduler.hbmBudgetBytes": OBS_SPILL_BUDGET}
    with _Armed(ooc, spill):
        clean_q12 = _grab_rows(ooc, q12)
        rec = chunked.last_run
        check(rec["tier"] == tier12 and rec["spilled_parts"] >= 1,
              f"obs: q12 spilled nothing at {OBS_SPILL_BUDGET} bytes: {rec}")
        log(f"obs: q12 hybrid at a {OBS_SPILL_BUDGET}-byte budget: "
            f"{rec['spilled_parts']} partitions spilled, "
            f"{rec['spill_writes']} writes, {rec['spill_reads']} reads")

    def spill_retried(evs):
        has("fault_injected", "stage_retry")(evs)
        check(chunked.last_run["spill_retries"] == 1
              and chunked.last_run["fallback"] is None,
              f"obs: the spill retry did not take it: {chunked.last_run}")

    def spill_fell_back(evs):
        has("fault_injected", "fault_recovered")(evs)
        check(chunked.last_run["fallback"] == "grace",
              f"obs: no grace fallback: {chunked.last_run}")

    cell("join.spill transient", ooc, "join.spill", "nth:1:transient", q12,
         clean_q12, spill_retried, settings=spill)
    cell("join.spill corrupt", ooc, "join.spill", "nth:1:corrupt", q12,
         clean_q12, spill_fell_back, settings=spill)
    # exchange.all_to_all: transient on mesh[4] q3 (adaptive off)
    q3 = _obs_query("q3")
    mesh_off = aqe_sessions(gpu, dev)["off"]
    clean_q3 = _grab_rows(mesh_off, q3)
    cell("exchange.all_to_all transient", mesh_off, "exchange.all_to_all",
         "nth:1:transient", q3, clean_q3,
         has("fault_injected", "stage_retry", "fault_recovered"))
    # agg.strategy / agg.presplit / fusion.decide on their aqe cells
    for name, point, spec, mode, want in (
            ("hash", "agg.strategy", "nth:1:corrupt", "adaptive",
             ("partial", "fallback")),
            ("presplit", "agg.presplit", "nth:1:transient", "adaptive",
             ("partial", "presplit_fallback")),
            ("partial", "fusion.decide", "nth:1:transient", "fused", None)):
        sql, _, over_cell = AQE_CELLS[name]
        ss = aqe_sessions(gpu, dev, over_cell)
        clean_cell = _grab_bits(ss["off"], sql)

        def decided(evs, want=want):
            has("fault_injected", "fault_recovered")(evs)
            if want is None:
                bail = _kinds_since(evs, "fusion_bailout")
                check(bail and bail[0]["reason"] == "fault_injected",
                      f"obs: fusion.decide: no fault bailout: {bail}")
                return
            agg = _kinds_since(evs, "agg")
            check(agg and (agg[0]["strategy"], agg[0]["mode"]) == want,
                  f"obs: agg decision {agg[:1]}, want {want}")

        cell(f"{point} ({name} cell)", ss[mode], point, spec, sql,
             clean_cell, decided, grab=_grab_bits)
    prof = tracing.fault_profile(faulted)
    check(prof["fault_injected"]["count"] == len(cells),
          f"obs: {prof['fault_injected']['count']} injections in "
          f"{len(cells)} cells")
    log("obs: fault profile of every cell's run:\n"
        + tracing.format_fault_profile(prof))
    log(f"obs: fault cells {[c for c, _ in cells]}; retry budget "
        f"{metrics.retry_budget_stats()}")
    engine = set(faults.WIRED_POINTS) - set(SERVE_POINTS) - set(TIER_POINTS)
    check(engine and {p for _, p in cells} == engine,
          f"obs: cells cover {sorted({p for _, p in cells})}, the engine's "
          f"wired points are {sorted(engine)}")


def obs_chaos(seg_agg, gpu, dev: str) -> None:
    """A seeded chaos campaign (OBS_CHAOS_SCHEDULES schedules) over mesh[4]
    q3 with adaptive execution, adaptive aggregation and fusion on, over
    the points q3's mesh path reaches: every schedule byte-identical or
    typed, none hangs, retry draws within the budget, the memory
    invariant kept."""
    from spark_tpu_torch import chaos

    spark = aqe_sessions(gpu, dev)["fused"]
    q3 = _obs_query("q3")

    def ipc():
        import pyarrow as pa

        table = frame(spark, q3).toArrow()
        sink = pa.BufferOutputStream()
        with pa.ipc.new_stream(sink, table.schema) as w:
            w.write_table(table)
        return sink.getvalue().to_pybytes()

    points = ("execute.device", "exchange.all_to_all", "agg.strategy",
              "agg.presplit", "fusion.decide")
    schedules = chaos.generate_campaign(OBS_CHAOS_SEED, OBS_CHAOS_SCHEDULES,
                                        points=points, max_points=2)
    before = mode_launches(seg_agg)
    runs = device_runs(seg_agg, dev)
    clean = ipc()
    report = chaos.run_campaign(spark.conf, ipc, schedules, clean_bytes=clean,
                                alarm_s=120.0, memory_manager=spark.memory_manager,
                                log=lambda m: log(f"obs chaos: {m}"))
    after = mode_launches(seg_agg)
    launched = {m: after[m] - before[m] for m in after
                if after[m] != before[m]}
    check(dev != "cuda" or ran_since(seg_agg, runs) == launched,
          f"obs chaos: the device ran {ran_since(seg_agg, runs)}, the "
          f"wrappers launched {launched}")
    check(report.ok, f"obs chaos: {[r.to_dict() for r in report.failures]}")
    check(ipc() == clean, "obs chaos: the campaign left a fault armed")
    log(f"obs chaos: {report.summary()}")


def obs_ui(gpu) -> None:
    """The status server on 127.0.0.1: /api/v1/queries, /api/v1/exchange
    and /trace/<id> of the last traced query answer JSON (the last a
    Chrome trace)."""
    import urllib.request

    from spark_tpu_torch import metrics, ui

    frame(gpu, _obs_query("q3")).collect()
    tid = _root_trace(metrics.last_query())["trace_id"]
    srv = ui.StatusServer(gpu, port=0)
    try:
        got = {}
        for path in ("/api/v1/queries", "/api/v1/exchange", f"/trace/{tid}"):
            with urllib.request.urlopen(srv.url + path, timeout=30) as r:
                check(r.status == 200, f"obs ui: {path} answered {r.status}")
                got[path] = json.loads(r.read())
        check(isinstance(got["/api/v1/queries"], list)
              and got["/api/v1/queries"], "obs ui: no queries")
        check("profile" in got["/api/v1/exchange"], "obs ui: no exchange")
        xs = [e for e in got[f"/trace/{tid}"]["traceEvents"]
              if e.get("ph") == "X"]
        check(xs, "obs ui: the Chrome trace holds no span")
        log(f"obs ui: {srv.url} answered /api/v1/queries "
            f"({len(got['/api/v1/queries'])} queries), /api/v1/exchange and "
            f"/trace/{tid} ({len(xs)} spans)")
    finally:
        srv.stop()


def obs_phase(seg_agg, gpu, cpu, oracle, dev="cuda", root=None):
    """Observability and faults at SF1: tracing on against off on the
    single-device session (``obs_traced_runs``), the device trace of one
    q1-wide run (``obs_device_trace``), the mesh under trace
    (``obs_mesh_traced``), the fault matrix (``obs_fault_matrix``), a
    chaos campaign (``obs_chaos``) and the status UI (``obs_ui``). Every
    wrapper call is recorded and held against its plain version, the
    card's runs equal the wrappers' launches in every run, and the graph
    pool and the stage cache do not grow. Returns the launches of the
    phase's wrappers (every one of them held)."""
    from spark_tpu_torch.physical import graphs

    pools = graphs.pool_bytes() if dev == "cuda" else None
    cached = graphs.cached_stages()
    seg_agg.reset_launches()
    with recording_calls(seg_agg) as calls:
        t0 = time.perf_counter()
        walls = obs_traced_runs(seg_agg, gpu, dev)
        log(f"obs: traced runs {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        obs_device_trace(seg_agg, gpu, dev, root)
        log(f"obs: device trace {time.perf_counter() - t0:.1f} s")
        obs_profiler_graph(dev, root)
        # graphs captured by now: the rest may add none
        if dev == "cuda":
            check(graphs.pool_bytes() == pools
                  and graphs.cached_stages() == cached,
                  "obs: the traced runs changed the graph pool or the stage "
                  "cache")
        t0 = time.perf_counter()
        obs_mesh_traced(seg_agg, gpu, dev)
        log(f"obs: mesh under trace {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        obs_chaos(seg_agg, gpu, dev)
        log(f"obs: chaos campaign {time.perf_counter() - t0:.1f} s")
        obs_ui(gpu)
        t0 = time.perf_counter()
        # last: the oom cell's ladder drops the captured stages
        obs_fault_matrix(seg_agg, gpu, dev, root)
        log(f"obs: fault matrix {time.perf_counter() - t0:.1f} s")
    hold_calls(seg_agg, calls, "obs")
    wrapped = mode_launches(seg_agg)
    if dev == "cuda":
        check(len(calls) == sum(wrapped.values()),
              f"obs: {len(calls)} wrapper calls, {wrapped} launches")
        held = graphs.pool_bytes()
        check((held or 0) <= (pools or 0)
              and graphs.cached_stages() <= cached,
              "obs: the graph pool or the stage cache grew")
    log("obs: warm walls ms, tracing on / off (median of "
        f"{OBS_REPS}): " + ", ".join(
            f"{n} {on:.3f} / {off:.3f} ({on - off:+.3f})"
            for n, (on, off) in walls.items()))
    log(f"obs: launches through the wrappers {wrapped}; {len(calls)} "
        "wrapper calls held against the plain versions")
    return wrapped


#: the serve phase's queries: SQL text by name
SERVE_QUERIES = ("q1_wide", "q3", "q5", "q18", "a1_168")
#: the concurrency check's mix: 8 clients, 24 queries, two FAIR pools
SERVE_MIX = ("q1_wide", "q3", "q5", "q18")
SERVE_CLIENTS = 8
SERVE_PER_CLIENT = 3
SERVE_POOLS = {"light": 1, "heavy": 2}
#: served against direct walls: runs of each, in turns
SERVE_REPS = 5
#: the fleet's chaos campaign
SERVE_CHAOS_SEED = 20261019
SERVE_CHAOS_SCHEDULES = 3
#: the wired fault points the serve phase's cells cover (the obs phase
#: covers the engine's)
SERVE_POINTS = ("connect.request", "scheduler.admit", "serve.dispatch",
                "serve.ownership", "serve.invalidate", "slo.predict",
                "slo.reject")


def _serve_sql(name: str) -> str:
    if name == "a1_168":
        from spark_tpu_torch.tpch.queries import SCALAR_QUERIES

        return SCALAR_QUERIES["a1_168"]
    return _obs_query(name)


def _ipc(table) -> bytes:
    from spark_tpu_torch.serve.result_cache import table_to_ipc

    return table_to_ipc(table)


@contextlib.contextmanager
def counting_stage_syncs():
    """Host syncs on any thread while the block runs, and those inside a
    traced stage (``graphs.run_stage``) of the thread that made them:
    ``torch.cuda.set_sync_debug_mode("warn")`` turns each sync into a
    warning, and a flag each thread sets while it runs a stage says
    where it was. Yields {"stage": n, "all": n}."""
    import threading

    from spark_tpu_torch.physical import graphs

    where = threading.local()
    counts = {"stage": 0, "all": 0}
    lock = threading.Lock()
    real_stage = graphs.run_stage

    def run_stage(*args, **kwargs):
        where.depth = getattr(where, "depth", 0) + 1
        try:
            return real_stage(*args, **kwargs)
        finally:
            where.depth -= 1

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message).lower():
            with lock:
                counts["all"] += 1
                counts["stage"] += bool(getattr(where, "depth", 0))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        graphs.run_stage = run_stage
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield counts
        finally:
            torch.cuda.set_sync_debug_mode("default")
            graphs.run_stage = real_stage


def _served(client, server, name: str, **kw):
    """One query through ``client``: its IPC bytes, the scheduler's
    ticket (None for a result-cache hit), the client's wall ms."""
    t0 = time.perf_counter()
    table = client.sql(_serve_sql(name), **kw)
    wall = (time.perf_counter() - t0) * 1e3
    qid = client.last_query.get("query_id")
    ticket = server.scheduler.ticket(int(qid)) if qid else None
    return _ipc(table), ticket, wall


def serve_rows(seg_agg, gpu, server, client, dev: str) -> dict:
    """Each serve query through the connect server and its scheduler,
    twice: the first run captures its traced stages on a scheduler
    worker (the stage cache was dropped), the second replays them (the
    ticket's own run records); both equal the direct ``toArrow()`` of
    the query (an eager run, and a replay on this thread after) bit for
    bit, with no host sync inside a stage. Returns, by query, the
    hand-kernel runs one replay makes on the card."""
    from spark_tpu_torch.physical import graphs

    # the direct bytes, run eagerly (which also binds the statistics of a
    # query no earlier phase ran); then no stage is captured
    with graphs.eager_stages():
        directs = {name: _ipc(frame(gpu, _serve_sql(name)).toArrow())
                   for name in SERVE_QUERIES}
    graphs.drop_stages()
    per_run = {}
    for name in SERVE_QUERIES:
        runs = device_runs(seg_agg, dev)
        before = mode_launches(seg_agg)
        with counting_stage_syncs() if dev == "cuda" \
                else contextlib.nullcontext({"stage": 0, "all": 0}) as syncs:
            first, t1, w1 = _served(client, server, name)
            ran1 = ran_since(seg_agg, runs)
            runs = device_runs(seg_agg, dev)
            again, t2, w2 = _served(client, server, name)
            ran2 = ran_since(seg_agg, runs)
        after = mode_launches(seg_agg)
        launched = {m: after[m] - before[m] for m in after
                    if after[m] != before[m]}
        direct = directs[name]
        check(first == direct and again == direct
              and _ipc(frame(gpu, _serve_sql(name)).toArrow()) == direct,
              f"serve: {name} served bytes differ from the direct toArrow()")
        (r1,), (r2,) = t1.runs, t2.runs
        check(not r1.first_run and r1.stages >= 1 and r2.stages >= 1,
              f"serve: {name} served runs bound no stats: {r1}, {r2}")
        if dev == "cuda":  # on the CPU a traced stage runs eagerly
            check(r1.captured + r1.replayed == r1.stages,
                  f"serve: {name} first served run: {r1}")
            check(r2.captured == 0 and r2.replayed == r2.stages,
                  f"serve: {name} second served run did not replay: {r2}")
        check(syncs["stage"] == 0,
              f"serve: {name}: {syncs['stage']} host syncs inside a stage")
        if dev == "cuda":
            check(ran1 == launched, f"serve: {name}: the card ran {ran1} "
                  f"in the capture run, the wrappers launched {launched}")
            check(ran2 == ran1, f"serve: {name}: the replay ran {ran2}, "
                  f"the capture run {ran1}")
        per_run[name] = ran2 or {}
        log(f"serve: {name} served twice ({len(first)} IPC bytes, equal to "
            f"the direct toArrow() bit for bit): capture run {w1:.1f} ms "
            f"(stages {r1.stages}, captured {r1.captured} in "
            f"{r1.capture_ms:.1f} ms, queue {t1.queue_wait_ms():.2f} ms), "
            f"replay {w2:.1f} ms (stages {r2.stages}, replayed "
            f"{r2.replayed}, queue {t2.queue_wait_ms():.2f} ms); card runs "
            f"a replay {ran2}; host syncs {syncs['all']} ({syncs['stage']} "
            "inside stages)")
    return per_run


def serve_concurrency(seg_agg, gpu, server, per_run: dict, dev: str):
    """SERVE_CLIENTS client threads send SERVE_PER_CLIENT queries of each
    of SERVE_MIX... in all SERVE_CLIENTS * SERVE_PER_CLIENT queries over
    the FAIR pools SERVE_POOLS: every result equals its single-client
    bytes, every run replays, the card's hand-kernel runs equal what the
    queries' replays run; each query's queue and run ms printed. Then
    the served wall against the direct wall of each query, median of
    SERVE_REPS, in turns."""
    import threading

    from spark_tpu_torch.connect.server import Client

    single = {n: _ipc(frame(gpu, _serve_sql(n)).toArrow()) for n in SERVE_MIX}
    jobs = [(c, SERVE_MIX[(c + i) % len(SERVE_MIX)],
             list(SERVE_POOLS)[(c + i) % len(SERVE_POOLS)])
            for c in range(SERVE_CLIENTS) for i in range(SERVE_PER_CLIENT)]
    results, errors = [], []
    lock = threading.Lock()
    barrier = threading.Barrier(SERVE_CLIENTS)

    def client_loop(c):
        cl = Client(server.url, timeout=120.0, retries=3)
        barrier.wait(timeout=60)
        for cid, name, pool in jobs:
            if cid != c:
                continue
            try:
                t0 = time.perf_counter()
                blob = _ipc(cl.sql(_serve_sql(name), pool=pool))
                wall = (time.perf_counter() - t0) * 1e3
                qid = int(cl.last_query["query_id"])
                with lock:
                    results.append((name, pool, blob, wall, qid))
            except Exception as e:  # noqa: BLE001 - failed below
                with lock:
                    errors.append(f"{name}: {e!r}")

    runs = device_runs(seg_agg, dev)
    before = mode_launches(seg_agg)
    threads = [threading.Thread(target=client_loop, args=(c,), daemon=True)
               for c in range(SERVE_CLIENTS)]
    t0 = time.perf_counter()
    with counting_stage_syncs() if dev == "cuda" \
            else contextlib.nullcontext({"stage": 0, "all": 0}) as syncs:
        for th in threads:
            th.start()
        for th in threads:
            th.join(300)
    wall = time.perf_counter() - t0
    check(not any(th.is_alive() for th in threads), "serve: a client hung")
    check(not errors, f"serve: concurrent clients failed: {errors[:3]}")
    check(len(results) == len(jobs), f"serve: {len(results)} results of "
          f"{len(jobs)}")
    after = mode_launches(seg_agg)
    want = {}
    for name, pool, blob, ms, qid in sorted(results, key=lambda r: r[4]):
        check(blob == single[name], f"serve: concurrent {name} differs "
              "from its single-client bytes")
        t = server.scheduler.ticket(qid)
        (run,) = t.runs
        check(dev != "cuda"
              or run.captured == 0 and run.replayed == run.stages >= 1,
              f"serve: concurrent {name} did not replay: {run}")
        for m, n in per_run[name].items():
            want[m] = want.get(m, 0) + n
        log(f"serve: concurrent q{qid} {name} pool {pool}: queue "
            f"{t.queue_wait_ms():.2f} ms, run "
            f"{(t.finished_t - t.started_t) * 1e3:.2f} ms, client wall "
            f"{ms:.2f} ms")
    check(syncs["stage"] == 0,
          f"serve: {syncs['stage']} host syncs inside a stage")
    check(after == before, f"serve: the concurrent replays launched through "
          f"the wrappers: {before} -> {after}")
    if dev == "cuda":
        ran = ran_since(seg_agg, runs)
        check(ran == {m: n for m, n in want.items() if n},
              f"serve: the card ran {ran}, the queries' replays {want}")
        log(f"serve: {len(results)} queries from {SERVE_CLIENTS} clients in "
            f"{wall:.2f} s, each equal to its single-client bytes; the card "
            f"ran {ran} (the replays of the mix)")
    st = server.scheduler.status()
    log("serve: pools " + ", ".join(
        f"{p['name']} weight {p['weight']} finished {p['finished']} device "
        f"{p['device_ms']:.1f} ms" for p in st["pools"]))

    walls = {}
    cl = Client(server.url, timeout=120.0)
    for name in SERVE_MIX:
        served, direct = [], []
        for _ in range(SERVE_REPS):
            t0 = time.perf_counter()
            cl.sql(_serve_sql(name))
            served.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            _ipc(frame(gpu, _serve_sql(name)).toArrow())
            direct.append((time.perf_counter() - t0) * 1e3)
        walls[name] = (statistics.median(served), statistics.median(direct))
    log("serve: walls ms, served / direct toArrow() and IPC (median of "
        f"{SERVE_REPS}, in turns): " + ", ".join(
            f"{n} {a:.3f} / {b:.3f} ({a - b:+.3f})"
            for n, (a, b) in walls.items()))
    return walls


def serve_admission(gpu, server, client) -> None:
    """``spark.tpu.scheduler.hbmBudgetBytes`` just above q1-wide's
    estimate, and two q1-wide submitted at once: the admission snapshot
    never holds both, and both finish with the direct bytes."""
    import threading

    from spark_tpu_torch.connect.server import Client
    from spark_tpu_torch.scheduler import admission

    sql = _serve_sql("q1_wide")
    est = admission.estimate_plan_bytes(gpu.sql(sql)._plan, gpu.conf)
    key = "spark.tpu.scheduler.hbmBudgetBytes"
    gpu.conf.set(key, est + 1)
    snaps, stop = [], threading.Event()

    def sampler():
        while not stop.is_set():
            snaps.append(server.scheduler.admission.snapshot())
            time.sleep(0.0005)

    samp = threading.Thread(target=sampler, daemon=True)
    out = [None, None]

    def one(i):
        out[i] = _ipc(Client(server.url, timeout=120.0).sql(sql))

    try:
        samp.start()
        pair = [threading.Thread(target=one, args=(i,)) for i in (0, 1)]
        for th in pair:
            th.start()
        for th in pair:
            th.join(120)
    finally:
        stop.set()
        samp.join(5)
        gpu.conf.unset(key)
    direct = _ipc(frame(gpu, sql).toArrow())
    check(out[0] == direct and out[1] == direct,
          "serve: admission: a q1-wide differs from the direct bytes")
    most = max(s["admitted"] for s in snaps)
    check(most == 1, f"serve: admission held {most} q1-wide at once under "
          f"a budget of {est + 1} bytes")
    check(all(s["in_use_bytes"] <= s["budget_bytes"] for s in snaps),
          "serve: admission: execution over the budget")
    log(f"serve: admission at {est + 1} bytes (q1-wide's estimate {est}): "
        f"two q1-wide at once, at most {most} admitted over "
        f"{len(snaps)} samples, both equal to the direct bytes")


def serve_result_cache(seg_agg, gpu, server, per_run: dict, dev: str):
    """The result cache on: 8 identical q1-wide at once run once (one
    replay's runs on the card's counter, one execute event), and all 8
    answers are the uncached IPC bytes."""
    import threading

    from spark_tpu_torch import metrics
    from spark_tpu_torch.connect.server import Client
    from spark_tpu_torch.serve.result_cache import key_digest, plan_result_key

    sql = _serve_sql("q1_wide")
    uncached = _ipc(Client(server.url).sql(sql))
    gpu.conf.set("spark.tpu.serve.resultCache.enabled", True)
    server.result_cache.clear()
    kd = key_digest(plan_result_key(gpu.sql(sql)._plan))
    barrier = threading.Barrier(8)
    got, errors, status = [], [], []

    def one():
        cl = Client(server.url, timeout=120.0)
        barrier.wait(timeout=60)
        try:
            got.append(_ipc(cl.sql(sql)))
            status.append(cl.last_query["cache"])
        except Exception as e:  # noqa: BLE001 - failed below
            errors.append(repr(e))

    runs = device_runs(seg_agg, dev)
    n0 = len(metrics.recent(100000))
    try:
        herd = [threading.Thread(target=one) for _ in range(8)]
        for th in herd:
            th.start()
        for th in herd:
            th.join(120)
    finally:
        gpu.conf.unset("spark.tpu.serve.resultCache.enabled")
    check(not errors, f"serve: cache herd failed: {errors[:3]}")
    check(len(got) == 8 and all(b == uncached for b in got),
          "serve: a cached answer differs from the uncached IPC bytes")
    execs = [e for e in metrics.recent(100000)[n0:]
             if e.get("kind") == "serve_cache"
             and e.get("phase") == "execute" and e.get("key") == kd]
    check(len(execs) == 1, f"serve: the herd executed {len(execs)} times")
    if dev == "cuda":
        ran = ran_since(seg_agg, runs)
        check(ran == per_run["q1_wide"], f"serve: the herd ran {ran} on the "
              f"card, one q1-wide replay runs {per_run['q1_wide']}")
    log(f"serve: result cache: 8 q1-wide at once ({sorted(status)}), one "
        "execution, every answer the uncached IPC bytes")


def serve_fleet_checks(seg_agg, gpu, dev: str) -> None:
    """``serve_fleet(session, replicas=2)``: q3 through the router equal
    to the direct bytes, /health aggregating both replicas; a
    ``serve.dispatch`` fault killing the chosen replica mid-query,
    re-dispatched to the same bytes; a stale ownership epoch answered
    with a typed 409, and a newer epoch the router absorbs; a chaos
    campaign over the fleet and a replica killed and revived."""
    import urllib.error
    import urllib.request

    from spark_tpu_torch import chaos, faults, metrics
    from spark_tpu_torch.connect.server import Client
    from spark_tpu_torch.serve import ResultCache, serve_fleet
    from spark_tpu_torch.serve.ownership import (EPOCH_HEADER,
                                                 session_invalidation_log)

    sql = _serve_sql("q3")
    direct = _ipc(frame(gpu, sql).toArrow())
    fleet = serve_fleet(gpu, replicas=2)
    try:
        got = _ipc(Client(fleet.url, timeout=120.0).sql(sql))
        check(got == direct, "serve: q3 through the router differs")
        with urllib.request.urlopen(fleet.url + "/health", timeout=30) as r:
            h = json.loads(r.read())
        check(h["router"] and [x["healthy"] for x in h["replicas"]]
              == [True, True], f"serve: fleet health {h['replicas']}")
        log(f"serve: fleet of 2: q3 through the router equal to the direct "
            f"bytes; /health: {[(x['id'], x['healthy']) for x in h['replicas']]}")

        metrics.reset_serve()
        with _Armed(gpu, {"spark.tpu.faultInjection.serve.dispatch":
                          "nth:1:transient"}):
            got = _ipc(Client(fleet.url, timeout=120.0).sql(sql))
            fired = faults.fire_count(gpu.conf, "serve.dispatch")
        stats = metrics.serve_stats()
        check(got == direct and fired == 1 and stats["redispatches"] >= 1,
              f"serve: dispatch fault: fired {fired}, {stats}")
        log(f"serve: serve.dispatch fault killed the chosen replica "
            f"mid-query: re-dispatched ({stats['redispatches']}), the same "
            "bytes")
        fed = fleet.router.federation
        fed.probe(force=True)
        for r in fed.replicas:
            r.breaker.reset()

        gpu.conf.set("spark.tpu.serve.ownership.enabled", True)
        try:
            # the epoch's broadcast fails: the replicas adopt it lazily,
            # from the next stamped request
            with _Armed(gpu, {"spark.tpu.faultInjection.serve.ownership":
                              "prob:1.0:3"}):
                fed.probe(force=True)  # mints an epoch
            epoch = fed.ownership.epoch
            check(all(s.fleet_epoch < epoch for s in fleet.replicas),
                  "serve: serve.ownership: a replica got the broadcast")
            cl = Client(fleet.url, timeout=120.0)
            got = _ipc(cl.sql(sql))
            served = next(s for s in fleet.replicas
                          if s.replica_id == cl.last_query["replica"])
            check(got == direct and served.fleet_epoch == epoch
                  and cl.last_query["epoch"] == epoch,
                  f"serve: serve.ownership: epoch {served.fleet_epoch} "
                  f"of {epoch}, {cl.last_query}")
            log(f"serve: serve.ownership fault on the epoch {epoch} "
                "broadcast: the replica adopted it from the stamped "
                "request, the same bytes")
            req = urllib.request.Request(
                served.url + "/sql",
                data=json.dumps({"query": sql}).encode(), method="POST",
                headers={"Content-Type": "application/json",
                         EPOCH_HEADER: str(epoch - 1)})
            try:
                urllib.request.urlopen(req, timeout=30)
                code, detail = 200, {}
            except urllib.error.HTTPError as e:
                code, detail = e.code, json.loads(e.read())
            check(code == 409 and detail.get("error") == "EpochRetry",
                  f"serve: a stale epoch got {code} {detail}")
            for s in fleet.replicas:
                s.fleet_epoch = epoch + 5  # another router minted more
            retries = metrics.serve_stats().get("epoch_retries", 0)
            got = _ipc(Client(fleet.url, timeout=120.0).sql(sql))
            check(got == direct and metrics.serve_stats()["epoch_retries"]
                  > retries, "serve: the router did not absorb a 409")
            log(f"serve: a stale epoch ({epoch - 1} < {epoch}) answered "
                "409 EpochRetry; a newer replica epoch fenced the router, "
                "which adopted it and re-dispatched to the same bytes")
        finally:
            gpu.conf.unset("spark.tpu.serve.ownership.enabled")

        # an invalidation applied under a fault clears the whole cache
        log_ = session_invalidation_log(gpu)
        cache = ResultCache(gpu.conf).attach_invalidation_log(log_)
        try:
            cache.put(("k", ()), direct)
            with _Armed(gpu, {"spark.tpu.faultInjection.serve.invalidate":
                              "nth:1"}):
                version = log_.append("source_changed", ["/nowhere"])
            check(len(cache._lru) == 0
                  and cache.invalidation_watermark == version,
                  "serve: serve.invalidate left an entry")
        finally:
            cache.detach_invalidation_log()
        log("serve: serve.invalidate fault: the cache cleared whole")

        def workload():
            return _ipc(Client(fleet.url, timeout=120.0, retries=3).sql(sql))

        t0 = time.perf_counter()
        report = chaos.run_campaign(
            gpu.conf, workload,
            chaos.generate_campaign(SERVE_CHAOS_SEED, SERVE_CHAOS_SCHEDULES,
                                    points=faults.WIRED_POINTS),
            clean_bytes=direct, alarm_s=120.0,
            memory_manager=gpu.memory_manager,
            log=lambda m: log(f"serve chaos: {m}"))
        check(report.ok, f"serve chaos: {[r.to_dict() for r in report.failures]}")
        arc = chaos.kill_and_revive(fleet, workload, clean_bytes=direct)
        log(f"serve chaos: {report.summary()}; kill and revive {arc} "
            f"({time.perf_counter() - t0:.1f} s)")
    finally:
        fleet.stop()


def serve_slo_and_faults(seg_agg, gpu, dev: str) -> None:
    """SLO: a server whose scheduler has ``spark.tpu.slo.enabled``, trained
    on q3: with ``deadline_s=60`` the policy is EDF, with 0.0005 the
    client raises ``InfeasibleDeadline`` within milliseconds and nothing
    runs. Faults: ``scheduler.admit`` transient and oom (recovered, the
    same bytes), ``connect.request`` transient (typed UNAVAILABLE with
    the server's traceback), ``slo.predict`` (no prediction, the same
    bytes) and ``slo.reject`` (fails open: a doomed query is admitted
    and cancelled typed by its deadline); the fault profile counts each
    injection and the admission's recoveries."""
    from spark_tpu_torch import faults, metrics, tracing
    from spark_tpu_torch.connect.server import Client, ConnectServer
    from spark_tpu_torch.slo import InfeasibleDeadline, fingerprint_sql

    sql = _serve_sql("q3")
    direct = _ipc(frame(gpu, sql).toArrow())
    metrics.reset()
    server = ConnectServer(gpu).start()
    try:
        with _Armed(gpu, {"spark.tpu.faultInjection.scheduler.admit":
                          "nth:1:transient"}):
            check(_ipc(Client(server.url).sql(sql)) == direct,
                  "serve: scheduler.admit transient changed the bytes")
        with _Armed(gpu, {"spark.tpu.faultInjection.scheduler.admit":
                          "nth:1:oom"}):
            cl = Client(server.url)
            check(_ipc(cl.sql(sql)) == direct,
                  "serve: scheduler.admit oom changed the bytes")
            t = server.scheduler.ticket(int(cl.last_query["query_id"]))
        degraded = [e for e in metrics.recent(4096)
                    if e.get("kind") == "scheduler"
                    and e.get("phase") == "admit_degraded"]
        check(degraded and degraded[-1]["est_bytes"] == t.est_bytes,
              "serve: scheduler.admit oom did not halve the estimate")
        with _Armed(gpu, {"spark.tpu.faultInjection.connect.request":
                          "nth:1:transient"}):
            try:
                Client(server.url).sql(sql)
                err = None
            except RuntimeError as e:
                err = str(e)
        check(err is not None and "UNAVAILABLE" in err
              and "server traceback" in err,
              f"serve: connect.request transient raised {err!r}")
        check(_ipc(Client(server.url).sql(sql)) == direct,
              "serve: the server did not survive connect.request")
    finally:
        server.stop()

    gpu.conf.set("spark.tpu.slo.enabled", True)
    server = ConnectServer(gpu).start()
    try:
        cl = Client(server.url, timeout=120.0)
        for _ in range(3):
            check(_ipc(cl.sql(sql)) == direct, "serve: slo training run")
        model, fp = server.scheduler._slo.model, fingerprint_sql(sql)
        deadline = time.time() + 10
        while model.predict_run_ms(fp) is None and time.time() < deadline:
            time.sleep(0.01)  # the observation lands after the ticket
        got = _ipc(cl.sql(sql, deadline_s=60))
        check(got == direct and cl.last_query["sched_policy"] == "EDF",
              f"serve: slo deadline 60 s: {cl.last_query}")
        pred = cl.last_query["slo_predicted_ms"]
        runs = device_runs(seg_agg, dev)
        seq = server.scheduler._seq
        n0 = len(metrics.recent(100000))
        t0 = time.perf_counter()
        try:
            cl.sql(sql, deadline_s=0.0005)
            rejected = None
        except InfeasibleDeadline as e:
            rejected = e
        ms = (time.perf_counter() - t0) * 1e3
        check(rejected is not None and cl.last_query["slo_rejected"],
              "serve: a 0.5 ms deadline was not rejected")
        check(server.scheduler._seq == seq, "serve: the rejected query "
              "took a queue slot")
        check(not [e for e in metrics.recent(100000)[n0:]
                   if e["kind"] in ("stage", "query_start")],
              "serve: the rejected query ran")
        if dev == "cuda":
            check(not ran_since(seg_agg, runs),
                  "serve: the card ran during the rejected query")
        log(f"serve: slo: q3 trained (prediction {pred} ms), deadline 60 s "
            f"scheduled EDF; deadline 0.5 ms rejected with "
            f"InfeasibleDeadline ({rejected.predicted_ms:.2f} ms predicted) "
            f"in {ms:.2f} ms, no ticket, no stage")

        with _Armed(gpu, {"spark.tpu.faultInjection.slo.predict":
                          "prob:1.0:7"}):
            got = _ipc(cl.sql(sql, deadline_s=60))
            fired = faults.fire_count(gpu.conf, "slo.predict")
        check(got == direct and fired >= 1
              and cl.last_query["slo_predicted_ms"] is None,
              f"serve: slo.predict: fired {fired}, {cl.last_query}")
        with _Armed(gpu, {"spark.tpu.faultInjection.slo.reject": "nth:1"}):
            try:
                cl.sql(sql, deadline_s=0.0005)
                err = None
            except InfeasibleDeadline as e:
                err = e
            except RuntimeError as e:
                err = e
            fired = faults.fire_count(gpu.conf, "slo.reject")
        check(fired == 1 and isinstance(err, RuntimeError)
              and not isinstance(err, InfeasibleDeadline)
              and "DEADLINE_EXCEEDED" in str(err),
              f"serve: slo.reject did not fail open: {err!r}")
        log("serve: slo.predict absorbed (no prediction, the same bytes); "
            "slo.reject failed open (admitted, then DEADLINE_EXCEEDED)")
    finally:
        server.stop()
        gpu.conf.unset("spark.tpu.slo.enabled")
        metrics.set_brownout(0)

    prof = tracing.fault_profile()
    injected = prof.get("fault_injected", {}).get("points", {})
    recovered = prof.get("fault_recovered", {}).get("points", {})
    for point, n in (("scheduler.admit", 2), ("connect.request", 1),
                     ("slo.predict", 1), ("slo.reject", 1)):
        check(injected.get(point, 0) >= n,
              f"serve: the fault profile counts {injected} injections")
    check(recovered.get("scheduler.admit", 0) == 2,
          f"serve: the fault profile counts {recovered} recoveries")
    log("serve: fault profile\n" + tracing.format_fault_profile(prof))


def serve_phase(seg_agg, gpu, cpu, oracle, dev="cuda"):
    """Scheduling and serving at SF1 on the card session: served rows
    (``serve_rows``), eight concurrent clients over two FAIR pools
    (``serve_concurrency``), admission at a budget just above q1-wide's
    estimate (``serve_admission``), the result cache's herd
    (``serve_result_cache``), the fleet with its faults, epochs and chaos
    (``serve_fleet_checks``), and the SLO tier and the serving fault
    points (``serve_slo_and_faults``). Every wrapper call is recorded and
    held against its plain version. Returns the phase's launches."""
    from spark_tpu_torch.connect.server import Client, ConnectServer

    settings = {"spark.scheduler.mode": "FAIR",
                **{f"spark.tpu.scheduler.pool.{p}.weight": w
                   for p, w in SERVE_POOLS.items()}}
    for k, v in settings.items():
        gpu.conf.set(k, v)
    seg_agg.reset_launches()
    _FIRED.clear()
    try:
        with recording_calls(seg_agg) as calls:
            server = ConnectServer(gpu).start()
            try:
                client = Client(server.url, timeout=120.0)
                check(server.scheduler.mode == "FAIR"
                      and server.scheduler.pools.get("heavy").weight == 2,
                      "serve: the FAIR pools were not built")
                t0 = time.perf_counter()
                per_run = serve_rows(seg_agg, gpu, server, client, dev)
                log(f"serve: rows {time.perf_counter() - t0:.1f} s")
                t0 = time.perf_counter()
                serve_concurrency(seg_agg, gpu, server, per_run, dev)
                log(f"serve: concurrency {time.perf_counter() - t0:.1f} s")
                serve_admission(gpu, server, client)
                serve_result_cache(seg_agg, gpu, server, per_run, dev)
            finally:
                server.stop()
            t0 = time.perf_counter()
            serve_fleet_checks(seg_agg, gpu, dev)
            log(f"serve: fleet {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            serve_slo_and_faults(seg_agg, gpu, dev)
            log(f"serve: slo and faults {time.perf_counter() - t0:.1f} s")
    finally:
        for k in settings:
            gpu.conf.unset(k)
    hold_calls(seg_agg, calls, "serve")
    check(all(_FIRED.get(p, 0) >= 1 for p in SERVE_POINTS),
          f"serve: the cells fired {_FIRED}, the points are {SERVE_POINTS}")
    log(f"serve: fault cells fired {dict(sorted(_FIRED.items()))}")
    wrapped = mode_launches(seg_agg)
    if dev == "cuda":
        check(len(calls) == sum(wrapped.values()),
              f"serve: {len(calls)} wrapper calls, {wrapped} launches")
    log(f"serve: launches through the wrappers {wrapped}; {len(calls)} "
        "wrapper calls held against the plain versions")
    return wrapped


# ---- streaming and materialized views (the stream phase) ---------------------

#: the three points of the streaming, compile and mview tiers: their cells
#: are the stream and compile phases', not the obs phase's
TIER_POINTS = ("streaming.commit", "compile.background", "mview.refresh")
STREAM_TRIGGERS = 8
#: the lineitem columns the streamed aggregates and the view read
STREAM_COLS = ("l_returnflag", "l_linestatus", "l_shipmode", "l_shipinstruct",
               "l_quantity", "l_extendedprice", "l_discount", "l_tax",
               "l_shipdate", "l_partkey", "l_suppkey")
#: the stream-stream join's scale: the first 1/STREAM_JOIN_SHARE of the
#: orders (by key; 150,000 at SF1) and their lineitems, in
#: STREAM_JOIN_TRIGGERS triggers a side
STREAM_JOIN_SHARE = 10
STREAM_JOIN_TRIGGERS = 4
STREAM_WINDOW_DAYS = 7


def _stream_sql(query: str, view: str) -> str:
    """A TPC-H aggregate over a streaming view: lineitem read from
    ``view``, the ORDER BY dropped (the aggregate is the stream's root)."""
    import re

    body = query[:query.lower().rindex("order by")]
    return re.sub(r"\bfrom\s+lineitem\b", f"from {view}", body)


def _sorted_bits(table) -> list:
    return sorted(row_bits([tuple(r.values()) for r in table.to_pylist()]))


def stream_run(spark, name: str, sql: str, table, slices: int,
               ckpt=None, fault_at=None):
    """``sql`` over a MemoryStream of ``table`` in ``slices`` equal
    micro-batches, complete mode. With ``fault_at``, the streaming.commit
    point fails that trigger (a transient fault); the query restarts from
    ``ckpt``, replays the logged batch and drains the rest. Returns the
    sink's Arrow table, the trigger log and the fired count."""
    from spark_tpu_torch import faults, metrics
    from spark_tpu_torch.streaming import MemoryStream

    src = MemoryStream(table.schema)
    spark.readStream.load(src).createOrReplaceTempView(f"{name}_src")
    sdf = spark.sql(_stream_sql(sql, f"{name}_src"))

    def start():
        w = sdf.writeStream.outputMode("complete").queryName(name)
        return (w.option("checkpointLocation", ckpt) if ckpt else w).start()

    q = start()
    step = -(-table.num_rows // slices)
    log_ = []
    fired = 0
    for i in range(slices):
        src.add_data(table.slice(i * step, step))
        if fault_at is not None and i == fault_at:
            with _Armed(spark, {"spark.tpu.faultInjection.streaming.commit":
                                "nth:1:transient"}):
                try:
                    q.process_all_available()
                    raise RuntimeError("the commit fault did not fire")
                except faults.InjectedTransientError:
                    fired = faults.fire_count(spark.conf, "streaming.commit")
            log_ += q.trigger_log
            q.stop()
            q = start()  # the restart: the logged batch replays
            metrics.reset()
            q.process_all_available()
            check(any(e["kind"] == "fault_recovered"
                      and e.get("how") == "wal_replay"
                      for e in metrics.recent(256)),
                  "stream: the restart did not replay the WAL")
            continue
        q.process_all_available()
    log_ += q.trigger_log
    return spark.table(name).toArrow(), log_, fired


def _log_triggers(label: str, trig: list) -> None:
    walls = [round(t["wall_ms"], 1) for t in trig]
    arrow = [round(t["arrow_ms"], 1) for t in trig]
    log(f"stream: {label}: {len(trig)} triggers, walls ms {walls} "
        f"(sum {sum(walls):.1f}), Arrow/transfer ms {arrow} "
        f"(sum {sum(arrow):.1f}); captured "
        f"{sum(t['captured'] for t in trig)}, replayed "
        f"{sum(t['replayed'] for t in trig)}")


def stream_aggregates(gpu, tables) -> None:
    """q1 and q1-wide over SF1 lineitem in STREAM_TRIGGERS equal
    micro-batches, each equal to its batch run on the card bit for bit;
    q1-wide's trigger walls with its stages eager and with capture on;
    MESH_F168's float sums (seg_fsum in every partial and merge) within
    MESH_TOL of each group's sum of |x| of the batch run; the
    streaming.commit cell: a crash at trigger 5, the restart replays it
    from the WAL to the same bytes."""
    import tempfile

    from spark_tpu_torch.physical import graphs
    from spark_tpu_torch.tpch import Q1_WIDE, QUERIES

    li = tables["lineitem"].select(list(STREAM_COLS))
    for name, sql in (("q1", QUERIES[1]), ("q1_wide", Q1_WIDE)):
        want = _sorted_bits(gpu.sql(sql).toArrow())
        if name == "q1_wide":
            with graphs.eager_stages():
                got, trig, _ = stream_run(gpu, "s_q1w_eager", sql, li,
                                          STREAM_TRIGGERS)
            check(_sorted_bits(got) == want, "stream: q1-wide (eager "
                  "stages) differs from its batch run")
            _log_triggers("q1-wide, stages eager", trig)
        got, trig, _ = stream_run(gpu, f"s_{name}", sql, li, STREAM_TRIGGERS)
        got = _sorted_bits(got)
        check(got == want, f"stream: {name} differs from its batch run")
        check(all(t["runs"] >= 2 for t in trig),
              f"stream: {name} triggers ran no partial and merge")
        _log_triggers(f"{name}, capture on", trig)
        log(f"stream: {name} over {li.num_rows} lineitem rows in "
            f"{STREAM_TRIGGERS} micro-batches: {len(got)} groups, equal to "
            "the batch run on the card bit for bit")
    got, trig, _ = stream_run(gpu, "s_f168", MESH_F168, li, STREAM_TRIGGERS)

    def rows(tbl):
        return sorted(tuple(r.values()) for r in tbl.to_pylist())

    worst = match_mesh("stream: f168", rows(got),
                       rows(gpu.sql(MESH_F168).toArrow()), mag_col=5)
    _log_triggers("f168 (float sums), capture on", trig)
    log(f"stream: f168's float sums within {worst:.3g} of each group's sum "
        f"of |x| of the batch run (bound {MESH_TOL}); counts equal")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckpt:
        got, trig, fired = stream_run(gpu, "s_q1w_fault", Q1_WIDE, li,
                                      STREAM_TRIGGERS, ckpt=ckpt, fault_at=4)
    check(fired == 1 and _sorted_bits(got) == want,
          f"stream: the commit fault fired {fired}x; rows after the WAL "
          "replay differ from the batch run")
    check([t["batch"] for t in trig] == list(range(STREAM_TRIGGERS)),
          f"stream: the triggers ran batches {[t['batch'] for t in trig]}")
    log("stream fault streaming.commit: a transient crash at trigger 5; the "
        "restart replayed batch 4 from the WAL; rows bit for bit the batch "
        f"run's ({len(trig)} trigger runs)")


def stream_window(gpu, tables) -> None:
    """A tumbling STREAM_WINDOW_DAYS-day window count over orders by
    order day, append mode with a watermark, in STREAM_TRIGGERS
    micro-batches in time order and a last row that closes every window:
    equal to the batch GROUP BY window on the card."""
    import pyarrow as pa
    import pyarrow.compute as pc

    from spark_tpu_torch.api import functions as F
    from spark_tpu_torch.streaming import MemoryStream

    orders = tables["orders"]
    day = pc.cast(pc.cast(orders.column("o_orderdate"), pa.int32()),
                  pa.int64())
    tbl = pa.table({"o_day": day, "o_orderkey": orders.column("o_orderkey")}) \
        .sort_by("o_day")
    batch = gpu.createDataFrame(tbl).groupBy(
        F.window("o_day", STREAM_WINDOW_DAYS).alias("w")).agg(
        F.count("o_orderkey").alias("n"), F.sum("o_orderkey").alias("s"))
    want = _sorted_bits(batch.toArrow())
    src = MemoryStream(tbl.schema)
    q = (gpu.readStream.load(src).withWatermark("o_day", 0)
         .groupBy(F.window("o_day", STREAM_WINDOW_DAYS).alias("w"))
         .agg(F.count("o_orderkey").alias("n"), F.sum("o_orderkey").alias("s"))
         .writeStream.outputMode("append").queryName("s_window").start())
    step = -(-tbl.num_rows // STREAM_TRIGGERS)
    for i in range(STREAM_TRIGGERS):
        src.add_data(tbl.slice(i * step, step))
        q.process_all_available()
    last = int(pc.max(day).as_py()) + 10 * STREAM_WINDOW_DAYS
    src.add_data(pa.table({"o_day": pa.array([last], pa.int64()),
                           "o_orderkey": pa.array([0], pa.int64())}))
    q.process_all_available()
    got = _sorted_bits(gpu.table("s_window").toArrow())
    check(got == want, f"stream: the windowed count ({len(got)} windows) "
          f"differs from the batch GROUP BY window ({len(want)})")
    _log_triggers("window count over orders", q.trigger_log)
    log(f"stream: {STREAM_WINDOW_DAYS}-day windows over {tbl.num_rows} "
        f"orders, append mode: {len(got)} windows emitted, equal to the "
        "batch GROUP BY window bit for bit")


def stream_join(gpu, tables) -> None:
    """orders JOIN lineitem on the order key as a stream-stream inner
    join over the first tenth of the orders and their lineitems,
    STREAM_JOIN_TRIGGERS triggers a side: its row count and checksum
    equal the batch join's on the card."""
    import pyarrow.compute as pc

    from spark_tpu_torch.api import functions as F
    from spark_tpu_torch.streaming import MemoryStream

    o = tables["orders"].select(["o_orderkey", "o_custkey"]) \
        .sort_by("o_orderkey")
    n_orders = o.num_rows // STREAM_JOIN_SHARE
    cut = o.column("o_orderkey")[n_orders - 1].as_py()
    o = o.slice(0, n_orders)
    li = tables["lineitem"].select(["l_orderkey", "l_partkey", "l_suppkey"])
    li = li.filter(pc.less_equal(li.column("l_orderkey"), cut)) \
        .sort_by("l_orderkey")

    def checksum(t) -> tuple:
        cols = {n: t.column(n).to_numpy().astype(np.int64)
                for n in ("o_custkey", "l_partkey", "l_suppkey")}
        return (t.num_rows, int(np.sum(cols["o_custkey"] * 1_000_003
                                       + cols["l_partkey"] * 7919
                                       + cols["l_suppkey"])))

    cond = F.col("o_orderkey") == F.col("l_orderkey")
    want = checksum(gpu.createDataFrame(o).join(
        gpu.createDataFrame(li), cond).toArrow())
    left, right = MemoryStream(o.schema), MemoryStream(li.schema)
    q = (gpu.readStream.load(left).join(gpu.readStream.load(right), cond)
         .writeStream.outputMode("append").queryName("s_join").start())
    ls, rs = -(-o.num_rows // STREAM_JOIN_TRIGGERS), \
        -(-li.num_rows // STREAM_JOIN_TRIGGERS)
    for i in range(STREAM_JOIN_TRIGGERS):
        left.add_data(o.slice(i * ls, ls))
        # the right side one trigger behind: rows meet the other side's
        # state as well as its new rows
        if i:
            right.add_data(li.slice((i - 1) * rs, rs))
        q.processAllAvailable()
    right.add_data(li.slice((STREAM_JOIN_TRIGGERS - 1) * rs, rs))
    q.processAllAvailable()
    got = checksum(gpu.table("s_join").toArrow())
    check(got == want, f"stream: the stream-stream join gave {got}, the "
          f"batch join {want}")
    _log_triggers("orders x lineitem join", q.trigger_log)
    log(f"stream: stream-stream inner join of {o.num_rows} orders and "
        f"{li.num_rows} lineitems (a smaller scale: the first "
        f"1/{STREAM_JOIN_SHARE} of the orders by key): {got[0]} rows, "
        "checksum equal to the batch join's")


def stream_view(gpu, tables) -> None:
    """A materialized view of a q1-like aggregate (four dictionary keys,
    decimal sums, min and max) over SF1 lineitem written as four Parquet
    files: two files appended, each followed by a collect equal to the
    uncached re-read bit for bit and an incremental merge; the second
    under a transient mview.refresh fault, retried."""
    import tempfile

    import pyarrow.parquet as pq

    from spark_tpu_torch import faults, metrics
    from spark_tpu_torch.api import functions as F

    li = tables["lineitem"].select(list(STREAM_COLS))
    eighth = -(-li.num_rows // 8)

    def agg(df):
        return df.groupBy("l_returnflag", "l_linestatus", "l_shipmode",
                          "l_shipinstruct").agg(
            F.sum("l_quantity").alias("sq"),
            F.sum("l_extendedprice").alias("sp"),
            F.min("l_partkey").alias("mn"), F.max("l_suppkey").alias("mx"))

    gpu.conf.set("spark.tpu.mview.enabled", True)
    metrics.reset_mview()
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_mview_") as d:
            t0 = time.perf_counter()
            for i in range(4):
                pq.write_table(li.slice(2 * i * eighth, 2 * eighth),
                               os.path.join(d, f"part{i}.parquet"))
            log(f"stream: view files written in "
                f"{time.perf_counter() - t0:.1f} s")
            view = agg(gpu.read.parquet(d))
            view.cache()
            check(len(gpu.mview_manager.views()) == 1
                  and gpu.mview_manager.views()[0]["incremental"],
                  "stream: the view did not register as incremental")
            t0 = time.perf_counter()
            first = _sorted_bits(view.toArrow())
            log(f"stream: view materialized ({len(first)} groups) in "
                f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
            for step, part in enumerate((6, 7)):
                pq.write_table(li.slice(part * eighth, eighth),
                               os.path.join(d, f"part{part}.parquet"))
                arm = {} if step == 0 else {
                    "spark.tpu.faultInjection.mview.refresh":
                        "nth:1:transient"}
                t0 = time.perf_counter()
                with _Armed(gpu, arm):
                    got = _sorted_bits(view.toArrow())
                    fired = faults.fire_count(gpu.conf, "mview.refresh")
                wall = (time.perf_counter() - t0) * 1e3
                t0 = time.perf_counter()
                want = _sorted_bits(agg(gpu.read.parquet(d)).toArrow())
                reread = (time.perf_counter() - t0) * 1e3
                check(got == want, f"stream: the refreshed view after "
                      f"file {part} differs from the uncached re-read")
                check(fired == step, f"stream: mview.refresh fired {fired}x")
                log(f"stream: file {part} appended; the view refreshed in "
                    f"{wall:.1f} ms against an uncached re-read of "
                    f"{reread:.1f} ms, bit for bit equal"
                    + (f"; mview.refresh fired {fired}x and was retried"
                       if step else ""))
            v = gpu.mview_manager.views()[0]
            st = metrics.mview_stats()
            check(v["incremental_merges"] >= 1 and v["full_recomputes"] == 0
                  and st["refresh_retries"] >= 1,
                  f"stream: the view {v}, counters {st}")
            log(f"stream: view counters {v}; {st}")
            view.unpersist()
    finally:
        gpu.conf.unset("spark.tpu.mview.enabled")


def stream_phase(seg_agg, gpu, cpu, oracle, dev="cuda", tables=None):
    """Streaming and materialized views on the card session at SF1: the
    streamed aggregates (``stream_aggregates``), a windowed count
    (``stream_window``), a stream-stream join (``stream_join``) and a
    view (``stream_view``), with the streaming.commit and mview.refresh
    cells. Every wrapper call is recorded and held against its plain
    version; every micro-batch is a first run, so the card's hand-kernel
    runs equal the wrappers' launches. Returns the phase's launches."""
    seg_agg.reset_launches()
    runs = device_runs(seg_agg, dev)
    for point in TIER_POINTS:
        _FIRED.pop(point, None)
    with recording_calls(seg_agg) as calls:
        for part in (stream_aggregates, stream_window, stream_join,
                     stream_view):
            t0 = time.perf_counter()
            part(gpu, tables)
            log(f"stream: {part.__name__} {time.perf_counter() - t0:.1f} s")
    hold_calls(seg_agg, calls, "stream")
    wrapped = mode_launches(seg_agg)
    if dev == "cuda":
        check(len(calls) == sum(wrapped.values()),
              f"stream: {len(calls)} wrapper calls, {wrapped} launches")
    check(all(_FIRED.get(p, 0) >= 1
              for p in ("streaming.commit", "mview.refresh")),
          f"stream: the fault cells fired {_FIRED}")
    log(f"stream: launches through the wrappers {wrapped}; {len(calls)} "
        "wrapper calls held against the plain versions; the card ran "
        f"{ran_since(seg_agg, runs)}")
    return wrapped


# ---- the compile tier (the compile phase) ---------------------------------------

COMPILE_QUERIES = ("q1_wide", "q3", "q5", "q18")
#: the scale the restarted children generate: the parent's (SF1 on the
#: card; a CPU rehearsal lowers both)
COMPILE_SF = 1.0


def _served_runs(client, server, name: str):
    """One query through the connect server: its IPC bytes, its ticket's
    planner runs and the client's wall ms."""
    blob, ticket, wall = _served(client, server, name)
    return blob, list(ticket.runs), wall


def compile_child(mode: str, store: str, hist: str, out_dir: str,
                  sf: float) -> int:
    """``--compile-child MODE STORE HIST OUT SF``: a restarted process,
    which shares only the store directory and the history file with the
    parent. Builds (loads) the kernels, generates TPC-H at ``sf``
    (``SF1_SEED``) and registers it on a card session. ``prewarm``: a connect server with the history
    and prewarm on; after the pre-warm, each journaled query's first
    client run. ``store``: the store alone, q3's first run. Writes each
    run's IPC bytes and records to OUT."""
    import pyarrow as pa  # noqa: F401

    from spark_tpu_torch.api.session import SparkSession
    from spark_tpu_torch.ops import _build
    from spark_tpu_torch.physical import planner
    from spark_tpu_torch.tpch import generate_tables, register_views

    os.environ["TZ"] = "UTC"
    time.tzset()
    t_start = time.perf_counter()
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    if dev == "cuda":
        _build.libraries(("seg_agg", "seg_fsum"))
    conf = {"spark.tpu.compile.store.dir": store}
    if mode == "prewarm":
        conf.update({"spark.tpu.compile.history.path": hist,
                     "spark.tpu.compile.prewarm.enabled": True})
    spark = SparkSession(device=dev, conf=conf)
    register_views(spark, generate_tables(sf, seed=SF1_SEED))
    if dev == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    out = {"setup_s": setup_s, "runs": {}}
    if mode == "prewarm":
        from spark_tpu_torch.connect.server import Client, ConnectServer

        svc = spark.compile_service
        t0 = time.perf_counter()
        server = ConnectServer(spark).start()
        check(svc.wait_background(timeout=300), "child: pre-warm hung")
        out["prewarm_s"] = time.perf_counter() - t0
        out["prewarm"] = svc.status()["prewarm"]
        try:
            client = Client(server.url, timeout=120.0)
            for name in COMPILE_QUERIES:
                blob, runs, wall = _served_runs(client, server, name)
                with open(os.path.join(out_dir, f"{name}.ipc"), "wb") as f:
                    f.write(blob)
                out["runs"][name] = {
                    "wall_ms": wall, "first_run": [r.first_run for r in runs],
                    "stages": sum(r.stages for r in runs),
                    "captured": sum(r.captured for r in runs),
                    "replayed": sum(r.replayed for r in runs)}
        finally:
            server.stop()
    else:
        runs: list = []
        t0 = time.perf_counter()
        with planner.recording_runs(runs):
            blob = _ipc(spark.sql(_serve_sql("q3")).toArrow())
        wall = (time.perf_counter() - t0) * 1e3
        with open(os.path.join(out_dir, "q3.ipc"), "wb") as f:
            f.write(blob)
        out["runs"]["q3"] = {
            "wall_ms": wall, "first_run": [r.first_run for r in runs],
            "blocking": sum(sum(r.blocking.values()) for r in runs),
            "stages": sum(r.stages for r in runs),
            "captured": sum(r.captured for r in runs),
            "replayed": sum(r.replayed for r in runs),
            "capture_ms": sum(r.capture_ms for r in runs)}
    from spark_tpu_torch import metrics

    out["exec_store"] = metrics.exec_store_stats()
    with open(os.path.join(out_dir, "out.json"), "w") as f:
        json.dump(out, f)
    spark.stop()
    return 0


def _child(mode: str, store: str, hist: str, root: str) -> dict:
    out_dir = os.path.join(root, f"child_{mode}")
    os.makedirs(out_dir)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--compile-child", mode,
         store, hist, out_dir, str(COMPILE_SF)], capture_output=True,
        text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        log(proc.stdout[-4000:])
        log(proc.stderr[-4000:])
    check(proc.returncode == 0, f"compile: the {mode} child failed")
    with open(os.path.join(out_dir, "out.json")) as f:
        out = json.load(f)
    out["wall_s"] = wall
    out["ipc"] = {}
    for name in os.listdir(out_dir):
        if name.endswith(".ipc"):
            with open(os.path.join(out_dir, name), "rb") as f:
                out["ipc"][name[:-4]] = f.read()
    return out


def compile_phase(seg_agg, gpu, cpu, oracle, dev="cuda", tables=None):
    """The compile tier on the card. Journal: a fresh session (new
    leaves, so each query's first run records and writes its statistics)
    with the store and the history on serves q1-wide, q3, q5 and q18
    through a connect server, twice each (a first run, then a capture).
    Prewarm in a restart: a child process with the history and prewarm;
    each journaled query's first client run captures nothing and replays
    every traced stage, with the parent's bytes. Store in a restart: a
    child with the store alone; q3's first run binds, runs no blocking
    operator and captures, with the same bytes. Background: q5 on the
    parent with background capture, served eagerly while the capture
    runs off-thread, then replayed, the same bytes; the
    compile.background cell: a failed capture pins q3 eagerly, the same
    bytes. Every wrapper call held. Returns the phase's launches."""
    import tempfile

    from spark_tpu_torch import faults, metrics
    from spark_tpu_torch.api.session import SparkSession
    from spark_tpu_torch.connect.server import Client, ConnectServer
    from spark_tpu_torch.physical import graphs, planner
    from spark_tpu_torch.tpch import register_views

    seg_agg.reset_launches()
    graphs.drop_stages()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_compile_") as root, \
            recording_calls(seg_agg) as calls:
        store = os.path.join(root, "store")
        hist = os.path.join(root, "history.jsonl")
        metrics.reset_exec_store()
        parent = SparkSession(device=dev, conf={
            "spark.tpu.compile.store.dir": store,
            "spark.tpu.compile.history.path": hist,
            "spark.tpu.compile.prewarm.enabled": False})
        register_views(parent, tables)
        server = ConnectServer(parent).start()
        direct, cold = {}, {}
        try:
            client = Client(server.url, timeout=120.0)
            for name in COMPILE_QUERIES:
                first, r1, w1 = _served_runs(client, server, name)
                again, r2, w2 = _served_runs(client, server, name)
                check(first == again, f"compile: {name} served twice differs")
                check(all(r.first_run for r in r1),
                      f"compile: {name} journal run was not a first run")
                direct[name], cold[name] = first, w1
                log(f"compile: journal {name}: cold first run {w1:.1f} ms "
                    f"(blocking {sum(sum(r.blocking.values()) for r in r1)}"
                    f"), capture run {w2:.1f} ms (captured "
                    f"{sum(r.captured for r in r2)})")
        finally:
            server.stop()
        svc = parent.compile_service
        st = svc.status()
        check(st["history"]["entries"] == len(COMPILE_QUERIES)
              and st["store"]["entries"] >= len(COMPILE_QUERIES),
              f"compile: history {st['history']}, store {st['store']}")
        log(f"compile: journal {st['history']}; store {st['store']}; "
            f"{metrics.exec_store_stats()}")

        pre = _child("prewarm", store, hist, root)
        rep = pre["prewarm"]
        check(rep is not None and not rep["errors"]
              and len(rep["replayed"]) == len(COMPILE_QUERIES),
              f"compile: the pre-warm report {rep}")
        for name in COMPILE_QUERIES:
            r = pre["runs"][name]
            check(r["captured"] == 0 and r["stages"] >= 1
                  and (dev != "cuda" or r["replayed"] == r["stages"])
                  and not any(r["first_run"]),
                  f"compile: prewarmed {name}'s first client run {r}")
            check(pre["ipc"][name] == direct[name],
                  f"compile: prewarmed {name}'s bytes differ from the "
                  "parent's")
            log(f"compile: prewarmed restart {name}: first client run "
                f"{r['wall_ms']:.1f} ms (cold first run {cold[name]:.1f} "
                f"ms), {r['stages']} stages all replayed, 0 captured, the "
                "parent's bytes")
        log(f"compile: prewarm child: setup {pre['setup_s']:.1f} s, "
            f"pre-warm {pre['prewarm_s']:.1f} s ("
            + ", ".join(f"{e['sql'].split()[1]}... {e['ms']} ms"
                        for e in rep["replayed"])
            + f"), wall {pre['wall_s']:.1f} s; {pre['exec_store']}")

        only = _child("store", store, hist, root)
        r = only["runs"]["q3"]
        check(not any(r["first_run"]) and r["blocking"] == 0
              and (dev != "cuda" or r["captured"] >= 1),
              f"compile: store-only q3 {r}")
        check(only["ipc"]["q3"] == direct["q3"],
              "compile: the store-only restart's q3 bytes differ")
        log(f"compile: store-only restart q3: first run {r['wall_ms']:.1f} "
            f"ms bound its statistics (no blocking operator) and captured "
            f"{r['captured']} stages in {r['capture_ms']:.1f} ms; the "
            f"parent's bytes; child wall {only['wall_s']:.1f} s")

        # background capture and the hot swap on the parent
        parent.conf.set("spark.tpu.compile.background", True)
        graphs.drop_stages()
        metrics.reset_exec_store()
        svc = parent.compile_service
        q5 = _serve_sql("q5")
        seen = []
        for i in range(3):
            runs: list = []
            t0 = time.perf_counter()
            with planner.recording_runs(runs):
                blob = _ipc(parent.sql(q5).toArrow())
            seen.append((blob, runs, (time.perf_counter() - t0) * 1e3))
            if i == 1:
                check(svc.wait_background(timeout=120),
                      "compile: the background capture hung")
        check(all(b == direct["q5"] for b, _, _ in seen),
              "compile: background q5 bytes differ")
        (r1,), (r2,), (r3,) = (s[1] for s in seen)
        check(r1.captured == 0 and r3.captured == 0 and r3.stages >= 1
              and (dev != "cuda" or r3.replayed == r3.stages),
              f"compile: background q5 runs {r1}, {r2}, {r3}")
        st = metrics.exec_store_stats()
        check(st["swaps"] == 1 and st["fallbacks"] == 0
              and st["background"] >= 1, f"compile: background {st}")
        log(f"compile: background q5: served eagerly in {seen[0][2]:.1f} ms "
            f"and {seen[1][2]:.1f} ms while the capture ran off-thread, then "
            f"replayed in {seen[2][2]:.1f} ms ({r3.replayed} stages); bit "
            f"for bit; {st}")

        # the compile.background cell
        with _Armed(parent, {"spark.tpu.faultInjection.compile.background":
                             "nth:1:transient"}):
            q3 = _serve_sql("q3")
            a = _ipc(parent.sql(q3).toArrow())
            check(svc.wait_background(timeout=120),
                  "compile: the failing capture hung")
            b = _ipc(parent.sql(q3).toArrow())
            fired = faults.fire_count(parent.conf, "compile.background")
        st = metrics.exec_store_stats()
        check(fired == 1 and a == b == direct["q3"]
              and st["fallbacks"] == 1
              and svc.status()["background"]["by_status"].get("failed") == 1,
              f"compile: the compile.background cell fired {fired}x, {st}")
        check(_FIRED.get("compile.background", 0) >= 1,
              f"compile: the fault cells fired {_FIRED}")
        log("compile fault compile.background: the capture failed, q3 "
            "stays eager (pinned), no crash, bit for bit")
        parent.stop()
        del parent
    hold_calls(seg_agg, calls, "compile")
    wrapped = mode_launches(seg_agg)
    log(f"compile: launches through the wrappers {wrapped}; {len(calls)} "
        "wrapper calls held against the plain versions")
    return wrapped


# ---- the libraries (the lib phase) ----------------------------------------------

#: the ml part's cut: the first tenth of SF1's lineitem rows, which the
#: CPU session fits and the card's fit of the same rows is held against;
#: the CrossValidator runs on it (card and CPU)
LIB_ML_CUT = 599_670
LIB_ML_COLS = ("l_quantity", "l_extendedprice", "l_discount", "l_tax")
#: Graph500's Kronecker initiator (A, B, C; D = 1 - A - B - C), its
#: edgefactor, and the scales: the card's run, the CPU comparison, the
#: dense triangle count
LIB_KRON = (0.57, 0.19, 0.19)
LIB_EDGEFACTOR = 16
LIB_SCALE = 20
LIB_CPU_SCALE = 16
LIB_TRI_SCALE = 12
LIB_PR_ITERS = 20
LIB_SSSP_ITERS = 16
LIB_RDD_RANGE = 2_000_000
#: linear and logistic coefficients, card against CPU: |dw| <= this *
#: max(1, |w|). Both fit in float32 from the same rows (standardized
#: features), but each gram or gradient entry is a sum of 599,670
#: float32 products, blocked differently by the card's and the CPU's
#: matmuls (their difference is in the 5th-6th digit of a sum); the
#: 2x2..6x6 solve and 200 contracting gradient steps carry it to the
#: coefficients without growth past this (the measured difference and
#: the gram's condition number are printed)
LIB_COEF_TOL = 1e-3
#: the scaler's means and stds, card against CPU: each is a float64
#: sum of integer-valued doubles (the decimal columns' unscaled integers,
#: ROADMAP's reference quirk) over 599,670 rows; the means' sums stay
#: below 2^53 and are exact in any order, the squares' sums round at
#: most n * 2^-53 = 6.7e-11 of their size apart
LIB_AGG_TOL = 1e-9
#: a held sample of wrapper calls: the first calls of each (wrapper,
#: dtype, K, rows), against the plain version
LIB_HELD_PER_KEY = 2
#: the kernels' times at the lib phase's own shapes, by mode
_LIB_KERNELS: dict = {}


def ml_frame(df):
    """The ml part's columns of a lineitem frame: the four decimal
    columns as doubles (their unscaled integers, as the reference reads
    a decimal), the ship mode and the label ``l_returnflag = 'R'``."""
    from spark_tpu_torch import types as T
    from spark_tpu_torch.api import functions as F

    return df.select(
        *[F.col(c).cast(T.FLOAT64).alias(c) for c in LIB_ML_COLS],
        "l_shipmode",
        F.when(F.col("l_returnflag") == "R", 1.0).otherwise(0.0)
        .alias("label"))


@contextlib.contextmanager
def sampling_calls(seg_agg):
    """While the block runs, count every call the engine makes to the
    seg_agg wrappers and keep (cloned) the first ``LIB_HELD_PER_KEY`` of
    each (wrapper, dtype, K, N), to hold against the plain version after
    (``hold_calls``): the lib phase makes thousands of calls on tens of
    millions of rows, too many to keep."""
    from spark_tpu_torch.physical import kernels as PK

    kept, counts = [], {}

    def recorder(name):
        fn = getattr(seg_agg, name)
        sig = inspect.signature(fn)

        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            if torch.cuda.is_available() \
                    and torch.cuda.is_current_stream_capturing():
                return out
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            a = bound.arguments
            data = a.get("data")
            key = (name, None if data is None else str(data.dtype),
                   int(a["num_segments"]), int(a["seg"].shape[0]))
            counts[key] = counts.get(key, 0) + 1
            if counts[key] <= LIB_HELD_PER_KEY:
                kept.append((name, {k: v.clone() if torch.is_tensor(v)
                                    else v for k, v in a.items()},
                             out.clone()))
            return out
        return call

    real = PK.seg_agg
    PK.seg_agg = types.SimpleNamespace(seg_sum=recorder("seg_sum"),
                                       seg_minmax=recorder("seg_minmax"),
                                       seg_fsum=recorder("seg_fsum"))
    try:
        yield kept, counts
    finally:
        PK.seg_agg = real


def _lib_part(label: str, seg_agg, fn, *args):
    """Run one part of the lib phase; print its wall and the launches it
    made, by mode."""
    before = dict(mode_launches(seg_agg))
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = mode_launches(seg_agg)
    ran = {m: after[m] - before[m] for m in after if after[m] != before[m]}
    log(f"lib: {label}: wall {wall:.2f} s, launches {ran}")
    return out


def _coef_diff(label: str, got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    diff = np.abs(got - want)
    check(bool((diff <= LIB_COEF_TOL * np.maximum(1.0, np.abs(want))).all()),
          f"lib: {label} coefficients {got.tolist()} against the CPU's "
          f"{want.tolist()}")
    return float(diff.max())


def _tree_dicts(model):
    return [(f.splits, f.leaves) for f in model.fits]


def lib_ml_fits(df, ml):
    """The ml part's first fits on ``df`` (an ``ml_frame``): the pipeline
    (StringIndexer(l_shipmode), StandardScaler of the four columns,
    LogisticRegression of the label) and a LinearRegression of the
    scaled price on the other scaled columns, each evaluated; ``prep`` is
    ``df`` through the pipeline's indexer and scaler. Returns {name:
    model or value}."""
    scaled = [c + "_scaled" for c in LIB_ML_COLS]
    feats = scaled + ["l_shipmode_idx"]
    out = {}
    pipe = ml.Pipeline([ml.StringIndexer("l_shipmode"),
                        ml.StandardScaler(list(LIB_ML_COLS)),
                        ml.LogisticRegression(feats, "label")])
    out["pipeline"] = pipe.fit(df)
    acc = ml.MulticlassClassificationEvaluator(labelCol="label")
    out["logistic_acc"] = acc.evaluate(out["pipeline"].transform(df))
    prep = out["pipeline"].stages[1].transform(
        out["pipeline"].stages[0].transform(df))
    out["prep"] = prep
    lin = ml.LinearRegression(
        ["l_quantity_scaled", "l_discount_scaled", "l_tax_scaled"],
        "l_extendedprice_scaled")
    out["linear"] = lin.fit(prep)
    out["linear_rmse"] = ml.RegressionEvaluator(
        labelCol="l_extendedprice_scaled").evaluate(
            out["linear"].transform(prep))
    return out


def lib_ml_models(prep, ml, cv: bool):
    """KMeans(k=8, maxIter=20) of the scaled columns,
    DecisionTreeClassifier(maxDepth=5) and RandomForestClassifier(
    numTrees=10, maxDepth=5) of the label on prepared rows, each tree
    evaluated; with ``cv`` a 3-fold CrossValidator of the tree over
    maxDepth in {2, 5}. Returns {name: model or value}."""
    feats = [c + "_scaled" for c in LIB_ML_COLS] + ["l_shipmode_idx"]
    acc = ml.MulticlassClassificationEvaluator(labelCol="label")
    out = {"kmeans": ml.KMeans(feats[:4], k=8, maxIter=20).fit(prep)}
    out["tree"] = ml.DecisionTreeClassifier(feats, "label",
                                            maxDepth=5).fit(prep)
    out["tree_acc"] = acc.evaluate(out["tree"].transform(prep))
    out["forest"] = ml.RandomForestClassifier(feats, "label", numTrees=10,
                                              maxDepth=5).fit(prep)
    out["forest_acc"] = acc.evaluate(out["forest"].transform(prep))
    if cv:
        grid = ml.ParamGridBuilder().addGrid("max_depth", [2, 5]).build()
        c = ml.CrossValidator(
            ml.DecisionTreeClassifier(feats, "label"), grid, acc,
            numFolds=3)
        out["cv"] = c.fit(prep)
    return out


def lib_ml(seg_agg, gpu, cpu, tables, dev: str) -> None:
    """The ml part: every estimator at full size on the card; on the
    first ``LIB_ML_CUT`` rows on the CPU and on the card, held against
    each other."""
    import spark_tpu_torch.ml as ml
    from spark_tpu_torch.ml.state import model_from_state

    full = ml_frame(gpu.table("lineitem"))
    cut = tables["lineitem"].slice(0, LIB_ML_CUT)
    card_cut = ml_frame(gpu.createDataFrame(cut))
    cpu_cut = ml_frame(cpu.createDataFrame(cut))

    big = _lib_part("ml: pipeline + linear, full lineitem on the card",
                    seg_agg, lib_ml_fits, full, ml)
    models = _lib_part("ml: kmeans, tree, forest, full lineitem on the card",
                       seg_agg, lib_ml_models, big["prep"], ml, False)
    lr = big["pipeline"].stages[2]
    sizes = models["kmeans"].transform(big["prep"]).groupBy(
        "prediction").count().collect()
    check(all(np.isfinite(lr.coefficients)) and 0.5 < big["logistic_acc"] <= 1
          and 1 <= len(sizes) <= 8 and 0.5 < models["tree_acc"] <= 1
          and 0.5 < models["forest_acc"] <= 1
          and np.isfinite(big["linear_rmse"]),
          f"lib: full-size fits {big['logistic_acc']}, {models['tree_acc']},"
          f" {models['forest_acc']}, {sizes}")
    log(f"lib: full size: logistic accuracy {big['logistic_acc']:.6f}, "
        f"linear rmse {big['linear_rmse']:.6f}, tree accuracy "
        f"{models['tree_acc']:.6f}, forest accuracy "
        f"{models['forest_acc']:.6f}, KMeans cluster sizes "
        f"{sorted(r['count'] for r in sizes)}")

    want = _lib_part("ml: pipeline + linear, the cut on the CPU", seg_agg,
                     lib_ml_fits, cpu_cut, ml)
    got = _lib_part("ml: pipeline + linear, the cut on the card", seg_agg,
                    lib_ml_fits, card_cut, ml)
    gp, wp = got["pipeline"].stages, want["pipeline"].stages
    check(gp[0].labels == wp[0].labels,
          f"lib: ship mode labels {gp[0].labels} != {wp[0].labels}")
    stats = np.asarray(gp[1].means + gp[1].stds, np.float64)
    wstats = np.asarray(wp[1].means + wp[1].stds, np.float64)
    check(bool((np.abs(stats - wstats) <= LIB_AGG_TOL
                * np.abs(wstats)).all()),
          f"lib: scaler {stats.tolist()} != the CPU's {wstats.tolist()}")
    d_log = _coef_diff("logistic", gp[2].coefficients + [gp[2].intercept],
                       wp[2].coefficients + [wp[2].intercept])
    d_lin = _coef_diff("linear",
                       got["linear"].coefficients + [got["linear"].intercept],
                       want["linear"].coefficients
                       + [want["linear"].intercept])
    from spark_tpu_torch.ml.pipeline import features_matrix
    from spark_tpu_torch.ml.regression import with_intercept

    xa = with_intercept(features_matrix(
        want["prep"], ["l_quantity_scaled", "l_discount_scaled",
                       "l_tax_scaled"])).double()
    cond = float(torch.linalg.cond(xa.T @ xa))
    log(f"lib: the cut: scaler means and stds within {LIB_AGG_TOL:g} of the "
        f"CPU's; logistic coefficients off the CPU's by {d_log:.3g}, linear "
        f"by {d_lin:.3g} (bound {LIB_COEF_TOL:g} * max(1, |w|); the linear "
        f"gram's condition number {cond:.4g}); accuracy {got['logistic_acc']}"
        f" (CPU {want['logistic_acc']}), rmse {got['linear_rmse']} (CPU "
        f"{want['linear_rmse']})")

    # the card's models from the CPU's fitted indexer and scaler, so
    # both fit KMeans and the trees on the same doubles
    state = model_from_state("standard_scaler", {
        "params": {"inputCols": list(LIB_ML_COLS)},
        "means": wp[1].means, "stds": wp[1].stds})
    index = model_from_state("string_indexer", {
        "params": {"inputCol": "l_shipmode"}, "labels": wp[0].labels})
    card_prep = state.transform(index.transform(card_cut))
    want_m = _lib_part("ml: kmeans, tree, forest, cv, the cut on the CPU",
                       seg_agg, lib_ml_models, want["prep"], ml, True)
    got_m = _lib_part("ml: kmeans, tree, forest, cv, the cut on the card",
                      seg_agg, lib_ml_models, card_prep, ml, True)
    check(got_m["kmeans"].centers.tobytes()
          == want_m["kmeans"].centers.tobytes(),
          "lib: KMeans centers differ from the CPU's")
    def assignments(model, prep):
        return model.transform(prep).select("prediction").toArrow() \
            .column(0).to_numpy()

    a_card = assignments(got_m["kmeans"], card_prep)
    a_cpu = assignments(want_m["kmeans"], want["prep"])
    check(np.array_equal(a_card, a_cpu),
          f"lib: KMeans assignments differ on "
          f"{int((a_card != a_cpu).sum())} rows")
    for name in ("tree", "forest"):
        check(_tree_dicts(got_m[name]) == _tree_dicts(want_m[name]),
              f"lib: the {name} differs from the CPU's")
        check(got_m[f"{name}_acc"] == want_m[f"{name}_acc"],
              f"lib: the {name}'s accuracy differs")
    gc, wc = got_m["cv"], want_m["cv"]
    check(gc.bestParams == wc.bestParams and gc.avgMetrics == wc.avgMetrics
          and _tree_dicts(gc.bestModel) == _tree_dicts(wc.bestModel),
          f"lib: CrossValidator {gc.bestParams} {gc.avgMetrics} against "
          f"{wc.bestParams} {wc.avgMetrics}")
    # the replay of a transform equals its first run
    again = assignments(got_m["kmeans"], card_prep)
    check(np.array_equal(again, a_card), "lib: a KMeans replay differs")
    log(f"lib: the cut: KMeans centers bit for bit and all {len(a_card)} "
        f"assignments equal the CPU's; the tree and "
        f"the forest equal split for split and leaf for leaf (accuracy "
        f"{got_m['tree_acc']:.6f}, {got_m['forest_acc']:.6f}); the "
        f"CrossValidator picks {gc.bestParams} with {gc.avgMetrics}, as the "
        "CPU")

    def p_type_labels(spark):
        return ml.StringIndexer("p_type").fit(spark.table("part")).labels

    labels = _lib_part("ml: StringIndexer(p_type) over part on the card",
                       seg_agg, p_type_labels, gpu)
    check(labels == p_type_labels(cpu) and len(labels) == 150,
          f"lib: p_type labels ({len(labels)}) differ from the CPU's")


def kronecker_graph(scale: int, seed: int):
    """Graph500's Kronecker generator (initiator ``LIB_KRON``, edgefactor
    ``LIB_EDGEFACTOR``) in numpy: 2^scale vertices, 16 * 2^scale
    directed edges (duplicates and self-loops kept, as the generator
    makes them), the vertex labels and the edge order permuted."""
    a, b, c = LIB_KRON
    rng = np.random.default_rng(seed)
    n, m = 1 << scale, LIB_EDGEFACTOR << scale
    ab, c_norm, a_norm = a + b, c / (1 - a - b), a / (a + b)
    src = np.zeros(m, np.int64)
    dst = np.zeros(m, np.int64)
    for bit in range(scale):
        ii = rng.random(m) > ab
        jj = rng.random(m) > np.where(ii, c_norm, a_norm)
        src |= ii.astype(np.int64) << bit
        dst |= jj.astype(np.int64) << bit
    perm = rng.permutation(n)
    order = rng.permutation(m)
    weights = rng.integers(1, 64, m).astype(np.float32)
    return (np.arange(n, dtype=np.int64), perm[src][order],
            perm[dst][order], weights)


def lib_graph_runs(vid, src, dst, w, dev: str) -> dict:
    """PageRank (``LIB_PR_ITERS`` supersteps), connected components to a
    fixpoint and an SSSP by a custom ``pregel`` with a ``min`` merge from
    the vertex of most out-edges, on ``dev``."""
    from spark_tpu_torch.graph import Graph

    t0 = time.perf_counter()
    g = Graph(vid, src, dst, edge_attr=w, device=dev)
    torch.cuda.synchronize()
    out = {"build_s": time.perf_counter() - t0}
    out["pagerank"] = g.pagerank(num_iters=LIB_PR_ITERS).cpu()
    out["cc"] = g.connected_components()
    source = int(torch.argmax(g.out_degree))
    init = torch.full((g.n,), float("inf"), dtype=torch.float32,
                      device=g.device)
    init[source] = 0.0
    out["sssp"] = g.pregel(init, lambda d, e: d + e, torch.minimum,
                           num_iters=LIB_SSSP_ITERS, merge="min",
                           default_msg=float("inf")).cpu()
    out["max_in_degree"] = int(g.in_degree.max())
    return out


def lib_graph(seg_agg, dev: str) -> None:
    """The graph part: a Graph500 Kronecker graph at ``LIB_SCALE`` on the
    card; at ``LIB_CPU_SCALE`` on the card and on the CPU, held against
    each other; the triangle count at ``LIB_TRI_SCALE`` on both."""
    from spark_tpu_torch.graph import Graph

    t0 = time.perf_counter()
    big = kronecker_graph(LIB_SCALE, SF1_SEED)
    log(f"lib: graph: Kronecker scale {LIB_SCALE} ({len(big[0])} vertices, "
        f"{len(big[1])} edges) generated in {time.perf_counter() - t0:.1f} s")
    full = _lib_part(f"graph: scale {LIB_SCALE} on the card", seg_agg,
                     lib_graph_runs, *big, dev)
    pr = full["pagerank"]
    reached = torch.isfinite(full["sssp"])
    check(bool(torch.isfinite(pr).all()) and bool((pr >= 0.15 - 1e-6).all())
          and int(reached.sum()) > 1,
          "lib: the full-size PageRank or SSSP is off")
    log(f"lib: graph scale {LIB_SCALE}: build {full['build_s']:.1f} s, "
        f"{len(np.unique(full['cc']))} components, SSSP reached "
        f"{int(reached.sum())} vertices, max in-degree "
        f"{full['max_in_degree']}, ranks sum {float(pr.double().sum()):.6g}")
    del big, full

    small = kronecker_graph(LIB_CPU_SCALE, SF1_SEED)
    got = _lib_part(f"graph: scale {LIB_CPU_SCALE} on the card", seg_agg,
                    lib_graph_runs, *small, dev)
    want = _lib_part(f"graph: scale {LIB_CPU_SCALE} on the CPU", seg_agg,
                     lib_graph_runs, *small, "cpu")
    check(np.array_equal(got["cc"], want["cc"]),
          "lib: connected components differ from the CPU's")
    check(torch.equal(got["sssp"].view(torch.int32),
                      want["sssp"].view(torch.int32)),
          "lib: SSSP distances differ from the CPU's")
    # the CPU's merge (index_add_) rounds at each add, the card's
    # seg_fsum once: a vertex's sum of d in-edge messages is at most
    # (d + 2) * 2^-24 (the update's rounding included) relative off, and
    # an error carries through the later supersteps: LIB_PR_ITERS *
    # (max in-degree + 2) * 2^-24 relative bounds the difference
    bound = LIB_PR_ITERS * (want["max_in_degree"] + 2) * 2.0 ** -24
    rel = ((got["pagerank"].double() - want["pagerank"].double()).abs()
           / want["pagerank"].double()).max().item()
    check(rel <= bound, f"lib: PageRank off the CPU's by {rel} (bound "
          f"{bound})")
    log(f"lib: graph scale {LIB_CPU_SCALE}: components and SSSP equal the "
        f"CPU's; PageRank within {rel:.3g} relative (bound {bound:.3g})")

    tri = kronecker_graph(LIB_TRI_SCALE, SF1_SEED)

    def triangles(d):
        return Graph(tri[0], tri[1], tri[2], device=d).triangle_count()

    n_card = _lib_part(f"graph: triangles at scale {LIB_TRI_SCALE} on the "
                       "card", seg_agg, triangles, dev)
    n_cpu = _lib_part(f"graph: triangles at scale {LIB_TRI_SCALE} on the "
                      "CPU", seg_agg, triangles, "cpu")
    check(n_card == n_cpu and n_card > 0,
          f"lib: {n_card} triangles on the card, {n_cpu} on the CPU")
    log(f"lib: {n_card} triangles at scale {LIB_TRI_SCALE}, as the CPU")


def lib_pandas_runs(root: str, dev: str) -> dict:
    """The pandas part on a session on ``dev`` (made the active one):
    ``read_parquet`` of the io phase's lineitem and part, a merge on the
    part key, a groupby over p_type (K = 150), value_counts, nlargest and
    describe."""
    import spark_tpu_torch.pandas as ps
    from spark_tpu_torch.api.session import SparkSession

    SparkSession.builder.device(dev).master("local").getOrCreate()
    li = ps.read_parquet(os.path.join(root, "lineitem"))
    part = ps.read_parquet(os.path.join(root, "part")).rename(
        {"p_partkey": "l_partkey"})
    merged = li.merge(part[["l_partkey", "p_type", "p_size"]],
                      on="l_partkey")
    out = {"groups": merged.groupby("p_type").agg(
        {"l_quantity": ["sum", "count"], "l_extendedprice": "sum",
         "p_size": ["min", "max"]}).sort_values("p_type").to_pandas()}
    out["counts"] = li.value_counts("l_shipmode").to_pandas()
    out["top"] = li.nlargest(10, "l_extendedprice")[
        ["l_orderkey", "l_linenumber", "l_extendedprice"]].to_pandas()
    out["describe"] = li[["l_linenumber", "l_suppkey"]].describe()
    out["len"] = len(merged)
    return out


def lib_pandas(seg_agg, dev: str, root: str) -> None:
    import pandas as pd

    got = _lib_part("pandas on the card", seg_agg, lib_pandas_runs, root,
                    dev)
    want = _lib_part("pandas on the CPU", seg_agg, lib_pandas_runs, root,
                     "cpu")
    check(got["len"] == want["len"] and len(got["groups"]) == 150,
          f"lib: pandas merge {got['len']} rows, {len(got['groups'])} groups")
    for key in ("groups", "counts", "top"):
        pd.testing.assert_frame_equal(got[key], want[key])
    d, w = got["describe"], want["describe"]
    exact = ["count", "min", "max"]
    pd.testing.assert_frame_equal(d.loc[exact], w.loc[exact])
    # mean and std: float64 sums of integers below 2^53 (exact, any
    # order) and of their squares (within n * 2^-53 relative)
    pd.testing.assert_frame_equal(d, w, check_exact=False, rtol=1e-9)
    log(f"lib: pandas: the merge ({got['len']} rows), groupby over 150 "
        "p_types, value_counts and nlargest equal the CPU's; describe's "
        "counts, min and max equal, mean and std within 1e-9")


def lib_rdd_runs(spark, root: str) -> dict:
    """The rdd part on ``spark``: customer's rows through ``.rdd``, a map
    and a reduceByKey by nation, back through ``toDF()`` into a grouped
    query on the session's device; ``parallelize`` of a range through
    reduceByKey, sortByKey and a checkpoint."""
    sc = spark.sparkContext
    out = {}
    by_nation = spark.table("customer").rdd.map(
        lambda r: (r["c_nationkey"], (float(r["c_acctbal"]), 1))) \
        .reduceByKey(lambda a, b: (a[0] + b[0], a[1] + b[1]), 8) \
        .map(lambda kv: (kv[0], kv[1][0], kv[1][1]))
    by_nation.toDF(["nationkey", "balance", "customers"]) \
        .createOrReplaceTempView("rdd_nation")
    out["regions"] = [tuple(r) for r in spark.sql(
        "select r_name, sum(customers) as n, count(*) as nations "
        "from rdd_nation join nation on nationkey = n_nationkey "
        "join region on n_regionkey = r_regionkey "
        "group by r_name order by r_name").collect()]
    out["nations"] = sorted(by_nation.collect())
    sc.setCheckpointDir(os.path.join(root, f"rdd_ckpt_{spark.device.type}"))
    sums = sc.parallelize(range(LIB_RDD_RANGE), 16) \
        .map(lambda x: (x % 1000, x)) \
        .reduceByKey(lambda a, b: a + b).sortByKey()
    sums.checkpoint()
    out["sums"] = sums.collect()
    out["checkpointed"] = sums.isCheckpointed() and sums._parents == ()
    out["again"] = sums.collect()
    return out


def lib_rdd(seg_agg, gpu, cpu, root: str) -> None:
    got = _lib_part("rdd with the card session", seg_agg, lib_rdd_runs, gpu,
                    root)
    want = _lib_part("rdd with the CPU session", seg_agg, lib_rdd_runs, cpu,
                     root)
    n = LIB_RDD_RANGE
    truth = [(k, sum(range(k, n, 1000))) for k in range(1000)]
    check(got["sums"] == got["again"] == want["sums"] == truth
          and got["checkpointed"], "lib: the range's sums are off")
    check(got["nations"] == want["nations"] and len(got["nations"]) == 25
          and got["regions"] == want["regions"]
          and sum(r[1] for r in got["regions"])
          == gpu.table("customer").count(),
          f"lib: the customer rdd {got['regions']} != {want['regions']}")
    log(f"lib: rdd: {sum(r[1] for r in got['regions'])} customers by nation "
        f"and region {got['regions']} "
        f"equal the CPU's; {n} numbers through reduceByKey, sortByKey and a "
        "checkpoint equal their closed form")


def lib_kernel_times(seg_agg, kept) -> None:
    """seg_fsum float32 and the B1 count at the lib phase's own shapes
    (PageRank's merge at K = 2^LIB_SCALE over sorted ids, the deepest
    tree level's histogram, the p_type counts of StringIndexer over part
    and of PsGroupBy over the merge): the kernel's device ms against its
    bound, its plain version's and the library call's."""
    picks = {}
    for name, args, _ in kept:
        if not args["seg"].is_cuda:
            continue
        k = int(args["num_segments"])
        data = args.get("data")
        if name == "seg_fsum" and data.dtype == torch.float32:
            label = "pagerank_merge" if k == 1 << LIB_SCALE else (
                "tree_histogram" if k <= 1024 else None)
            if label and (label not in picks or
                          (label == "tree_histogram"
                           and k > int(picks[label][1]["num_segments"]))):
                picks[label] = (name, args)
        if name == "seg_sum" and data is None and k == 150:
            # StringIndexer's over part, PsGroupBy's over the merge
            label = ("p_type_count_merge" if args["seg"].shape[0] > 1 << 20
                     else "p_type_count_part")
            picks.setdefault(label, (name, args))
    check({"pagerank_merge", "tree_histogram", "p_type_count_part",
           "p_type_count_merge"} <= set(picks),
          f"lib: the timed shapes {sorted(picks)}")
    for label, (name, a) in picks.items():
        seg, mask, k = a["seg"], a["mask"], int(a["num_segments"])
        n = seg.shape[0]
        seg_l = seg.long().clamp(0, k - 1)
        if name == "seg_fsum":
            data = a["data"]
            fn = (lambda: seg_agg.seg_fsum(data, seg, mask, k))
            plain = (lambda: seg_agg.seg_fsum_plain(data, seg, mask, k))
            masked = torch.where(mask, data, torch.zeros((), device=data.device))
            zeros = torch.zeros(k, dtype=data.dtype, device=data.device)
            lib = (lambda: zeros.index_add(0, seg_l, masked))
            n_bytes, n_ops, mode = n * 9 + k * 4, n * 12, "fsum_f32"
        else:
            fn = (lambda: seg_agg.seg_sum(None, seg, mask, k, exact_int=True))
            plain = (lambda: seg_agg.seg_sum_plain(None, seg, mask, k, True))
            weights = mask.to(torch.float32)
            lib = (lambda: torch.bincount(seg, weights=weights, minlength=k))
            n_bytes, n_ops, mode = n * 5 + k * 8, n, "count"
        got, want = fn(), plain()
        err = (got.double() - want.double()).abs().max().item()
        check(torch.equal(_bits(got), _bits(want)),
              f"lib: {label} differs from the plain version")
        dev_ms, per_call, names = profile_calls(fn)
        bnd, by = bound_ms(n_bytes, n_ops)
        stats = dict(n=n, k=k, ms=cuda_ms(fn), device_ms=dev_ms,
                     kernels_per_call=per_call, bound_ms=bnd, bound_by=by,
                     share=bnd / dev_ms if dev_ms else None,
                     max_abs_err=err, plain_ms=cuda_ms(plain, reps=3,
                                                       warmup=1),
                     library_ms=cuda_ms(lib))
        _LIB_KERNELS.setdefault(mode, {})[label] = stats
        log(f"kernel {name} {mode} lib {label}: " + " ".join(
            f"{key}={val:.6g}" if isinstance(val, float) else
            f"{key}={val}" for key, val in stats.items()))


def lib_phase(seg_agg, gpu, cpu, oracle, dev="cuda", tables=None,
              root=None):
    """The libraries (A13) at SF1: spark.ml (``lib_ml``), Pregel graphs
    (``lib_graph``), the pandas API over the io phase's Parquet files
    (``lib_pandas``) and the RDD tier (``lib_rdd``). Every part runs at
    full size on the card and at its stated cut on the card and the CPU,
    held against each other. A sample of the wrapper calls is held
    against the plain versions, the card's runs equal the wrappers'
    launches, and the kernels are timed at the phase's shapes. Returns
    the phase's launches."""
    seg_agg.reset_launches()
    runs = device_runs(seg_agg, dev)
    with sampling_calls(seg_agg) as (kept, counts):
        for label, part in (
                ("ml", lambda: lib_ml(seg_agg, gpu, cpu, tables, dev)),
                ("graph", lambda: lib_graph(seg_agg, dev)),
                ("pandas", lambda: lib_pandas(seg_agg, dev, root)),
                ("rdd", lambda: lib_rdd(seg_agg, gpu, cpu, root))):
            t0 = time.perf_counter()
            part()
            log(f"lib: {label} part {time.perf_counter() - t0:.1f} s")
    wrapped = mode_launches(seg_agg)
    ran = ran_since(seg_agg, runs)
    if dev == "cuda":
        check(ran == {m: v for m, v in wrapped.items() if v},
              f"lib: the card ran {ran}, the wrappers launched {wrapped}")
    hold_calls(seg_agg, kept, "lib")
    log(f"lib: launches through the wrappers {wrapped}; {sum(counts.values())}"
        f" wrapper calls, {len(kept)} held against the plain versions "
        f"(the first {LIB_HELD_PER_KEY} of each wrapper, dtype, K and N); "
        "the "
        f"card ran {ran}")
    if dev == "cuda":
        lib_kernel_times(seg_agg, kept)
    return wrapped


#: the scale phase: TPC-H at SF10 from a multi-part Parquet dataset made
#: once by ``ensure_dataset`` with the streamed writer (2,000,000 orders a
#: part: 8 parts), in a child process started with the oracle's
SCALE_SF = 10.0
SCALE_SLICE_ORDERS = 2_000_000
#: BASELINE.md's three (q1, q3, q5), q1-wide (the hand kernels), q9 (the
#: widest join fan-out) and q18 (a group by l_orderkey, 15M groups)
SCALE_QUERIES = ("q1", "q1_wide", "q3", "q5", "q9", "q18")
#: held against an in-memory card session over the same rows and against
#: pyarrow (``tpch/arrow_queries.py``)
SCALE_HELD = (1, 3, 5)
SCALE_LAUNCHES = {"q1_wide": {"count": 7, "sum_i64": 2, "min": 1, "max": 1}}
#: B1 and B2 at the scale phase's q1-wide shapes (the kernels line)
_SCALE_KERNELS: dict = {}
#: the scale phase's dataset path, rows and pyarrow answers (``path``,
#: ``rows``, ``yardstick``), which the multiproc phase reads
_SCALE_DONE: dict = {}


def _scale_query(name: str) -> str:
    from spark_tpu_torch.tpch import Q1_WIDE, QUERIES

    return Q1_WIDE if name == "q1_wide" else QUERIES[int(name[1:])]


def read_scale_tables(path: str) -> dict:
    """The columns q1, q3 and q5 read, of each table of the dataset at
    ``path``, read back with pyarrow."""
    import pyarrow.parquet as pq

    from spark_tpu_torch.tpch.arrow_queries import COLUMNS

    return {name: pq.read_table(os.path.join(path, f"{name}.parquet"),
                                columns=list(cols))
            for name, cols in COLUMNS.items()}


def dataset_child(base: str, out: str) -> int:
    """``--dataset-child BASE OUT``: the scale phase's dataset
    (``ensure_dataset`` at ``SCALE_SF`` under ``BASE``, the streamed
    writer in a process per spare CPU) and the pyarrow computations of
    q1, q3 and q5 over it, made beside the earlier phases and pickled to
    ``OUT``."""
    import pickle

    from spark_tpu_torch.tpch import arrow_queries, ensure_dataset

    t0 = time.perf_counter()
    path = ensure_dataset(SCALE_SF, base=base, seed=SF1_SEED, streamed=True,
                          orders_per_slice=SCALE_SLICE_ORDERS,
                          workers=max(1, (os.cpu_count() or 1) - 3))
    done = {"path": path, "ensure_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    tables = read_scale_tables(path)
    done["read_s"] = time.perf_counter() - t0
    done["yardstick"], done["yardstick_s"] = {}, {}
    for q, fn in arrow_queries.QUERIES.items():
        t0 = time.perf_counter()
        done["yardstick"][q] = fn(tables)
        done["yardstick_s"][q] = time.perf_counter() - t0
    import resource

    done["peak_rss_bytes"] = \
        resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    with open(out, "wb") as f:
        pickle.dump(done, f)
    return 0


def start_dataset(root: str):
    """The dataset's child process (its own process group, so that its
    writer's workers stop with it) and the file it writes."""
    out = os.path.join(root, "scale.pickle")
    return subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             "--dataset-child", root, out],
                            start_new_session=True), out


def stop_child(proc) -> None:
    """Stop a child that still runs, with every process of its group
    where it leads one."""
    import signal

    if proc.poll() is None:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:  # not a group leader
            proc.kill()
    proc.wait()


def scale_dataset(dataset) -> dict:
    """Wait for the dataset's child; print what the generation took
    (the static tables and the slices, each slice's seconds and its
    process's peak RSS), the bytes on disk and the pyarrow runs."""
    import pickle

    from spark_tpu_torch.tpch import dataset_report

    proc, out = dataset
    t0 = time.perf_counter()
    rc = proc.wait()
    check(rc == 0, f"the dataset's child process exited with {rc}")
    with open(out, "rb") as f:
        done = pickle.load(f)
    rep = dataset_report(done["path"])
    gen, slices = rep["report"], rep["report"]["slices"]
    log(f"scale: waited {time.perf_counter() - t0:.1f} s for the dataset's "
        f"child; {rep['recipe']}: {gen['seconds']:.1f} s to generate "
        f"(static tables {gen['statics_s']:.1f} s, {len(slices)} slices "
        f"{gen['slices_s']:.1f} s of wall beside them), "
        f"{gen['bytes'] / 2 ** 30:.3f} GiB on disk, the writer's peak RSS "
        f"{gen['peak_rss_bytes'] / 2 ** 30:.2f} GiB")
    for s in slices:
        log(f"scale: slice {s['part']}: {s['orders']} orders, "
            f"{s['lineitem']} lineitems, {s['seconds']:.1f} s, its "
            f"process's peak RSS {s['peak_rss_bytes'] / 2 ** 30:.2f} GiB")
    log(f"scale: the child read q1/q3/q5's columns back in "
        f"{done['read_s']:.1f} s and ran the pyarrow queries in "
        + ", ".join(f"q{q} {s:.1f} s" for q, s in
                    done["yardstick_s"].items())
        + f"; its peak RSS {done['peak_rss_bytes'] / 2 ** 30:.2f} GiB")
    return done


def free_sf1(gpu) -> None:
    """Drop the SF1 views of the earlier phases' card session and every
    captured stage, and give the cached blocks back, before SF10."""
    import gc

    from spark_tpu_torch.physical import graphs

    before = torch.cuda.memory_allocated() if gpu.device.type == "cuda" \
        else 0
    for name in gpu.catalog.listTables():
        gpu.catalog.dropTempView(name)
    dropped = graphs.drop_stages()
    gc.collect()
    if gpu.device.type == "cuda":
        torch.cuda.empty_cache()
        log(f"scale: dropped the SF1 views and {dropped} captured stages: "
            f"device memory allocated {before / 2 ** 30:.2f} -> "
            f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")


def scale_scan_estimate(spark, query: str) -> int:
    """The largest scan estimate of ``query``'s optimized plan, the
    number the out-of-memory tier holds against
    ``spark.tpu.maxDeviceBatchBytes``."""
    from spark_tpu_torch.physical.chunked import _est_scan
    from spark_tpu_torch.plan import logical as L
    from spark_tpu_torch.plan.optimizer import optimize

    plan = optimize(spark.sql(query)._plan, spark.conf)
    return max(_est_scan(s) for s in L.collect_nodes(plan, L.UnresolvedScan))


def scale_kernel_times(seg_agg, calls, label: str = "scale",
                       into: dict = _SCALE_KERNELS) -> None:
    """B1 (count, int64 sum) and B2 (min, max) at q1-wide's SF10 shapes
    (``label``'s path): the first recorded call of each mode, timed
    (device ms from the profiler, CUDA events) against its bound, its
    plain version and the library call, kept in ``into``."""
    seen = set()
    for name, a, _ in calls:
        data, seg, mask = a.get("data"), a["seg"], a["mask"]
        k = int(a["num_segments"])
        if name == "seg_sum":
            mode = "count" if data is None else "sum_i64"
        else:
            mode = "max" if a["is_max"] else "min"
        if mode in seen or not seg.is_cuda:
            continue
        seen.add(mode)
        n = seg.shape[0]
        seg_l = seg.long()
        if mode == "count":
            fn = lambda: seg_agg.seg_sum(None, seg, mask, k, exact_int=True)
            plain = lambda: seg_agg.seg_sum_plain(None, seg, mask, k, True)
            weights = mask.to(torch.float32)
            lib = lambda: torch.bincount(seg, weights=weights, minlength=k)
        elif mode == "sum_i64":
            fn = lambda: seg_agg.seg_sum(data, seg, mask, k)
            plain = lambda: seg_agg.seg_sum_plain(data, seg, mask, k)
            masked = torch.where(mask, data, torch.zeros_like(data))
            zeros = torch.zeros(k, dtype=torch.int64, device=seg.device)
            lib = lambda: zeros.index_add(0, seg_l, masked)
        else:
            is_max = mode == "max"
            fn = lambda: seg_agg.seg_minmax(data, seg, mask, k, is_max)
            plain = lambda: seg_agg.seg_minmax_plain(data, seg, mask, k,
                                                     is_max)
            ident = float("-inf") if is_max else float("inf")
            fill = torch.full((k,), ident, dtype=data.dtype,
                              device=seg.device)
            masked = torch.where(mask, data, fill.new_tensor(ident))
            lib = lambda: fill.scatter_reduce(
                0, seg_l, masked, "amax" if is_max else "amin",
                include_self=True)
        got, want = fn(), plain()
        check(torch.equal(_bits(got), _bits(want)),
              f"{label}: {mode} at N={n} K={k} differs from the plain "
              "version")
        dev_ms, per_call, _ = profile_calls(fn)
        out_bytes = k * got.element_size()
        bnd, by = bound_ms(n * ROW_BYTES[mode] + out_bytes, n * 3)
        stats = dict(n=n, k=k, ms=cuda_ms(fn), device_ms=dev_ms,
                     kernels_per_call=per_call, bound_ms=bnd, bound_by=by,
                     share=bnd / dev_ms if dev_ms else None, max_abs_err=0.0,
                     plain_ms=cuda_ms(plain, reps=3, warmup=1),
                     library_ms=cuda_ms(lib, reps=5, warmup=1))
        into[mode] = stats
        log(f"kernel {name} {mode} {label} N={n} K={k}: " + " ".join(
            f"{key}={val:.6g}" if isinstance(val, float) else
            f"{key}={val}" for key, val in stats.items()))
    check(seen == {"count", "sum_i64", "min", "max"},
          f"{label}: q1-wide's calls covered {sorted(seen)}")


def scale_phase(seg_agg, gpu, cpu, oracle, dev="cuda", dataset=None):
    """TPC-H at SF10 from the multi-part dataset (``dataset``: the
    child's process and its pickle). After the SF1 state is dropped
    (``free_sf1``), a fresh card session registers the eight tables with
    ``register_views(spark, path=...)``; each query of ``SCALE_QUERIES``
    runs once with the launch counters set to 0 before and read after
    (q1-wide: 7 counts, 2 int64 sums, 1 min, 1 max; every wrapper call
    held against its plain version; the card's runs equal the wrappers'
    launches), then its warm runs (``warm_runs``: an eager run, the
    capture run and 3 replays, bit for bit, no capture in a replay) and
    a replay under ``graphs.guarding_stages`` (no host sync inside a
    stage), one profiled replay and its peak device memory. q1, q3 and
    q5 equal an in-memory card session over the same rows read back with
    pyarrow, bit for bit, and the pyarrow computations of the queries
    (``oracle.assert_rows_match``). q1 chunked at a budget one byte
    under its scan estimate equals the resident run. B1 and B2 are timed
    at q1-wide's shapes. The dataset, the rows and pyarrow's answers are
    kept for the multiproc phase (``_SCALE_DONE``). Returns the launches
    of the first runs and the chunked run."""
    from spark_tpu_torch import recovery
    from spark_tpu_torch.api.session import SparkSession
    from spark_tpu_torch.physical import chunked, graphs
    from spark_tpu_torch.tpch import register_views
    from spark_tpu_torch.tpch.oracle import assert_rows_match

    done = scale_dataset(dataset)
    path = done["path"]
    free_sf1(gpu)
    phase_peak = 0
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    spark = SparkSession(device=dev)
    register_views(spark, path=path)
    max_batch = int(spark.conf.get(chunked.MAX_DEVICE_BATCH_BYTES))
    rows, total = {}, {}
    for name in SCALE_QUERIES:
        query = _scale_query(name)
        est = scale_scan_estimate(spark, query)
        log(f"scale: {name} largest scan estimate {est / 2 ** 30:.3f} GiB, "
            f"{est / max_batch:.1%} of spark.tpu.maxDeviceBatchBytes "
            f"({max_batch / 2 ** 30:.0f} GiB)")
        seg_agg.reset_launches()
        runs = device_runs(seg_agg, dev)
        with recording_calls(seg_agg) as calls:
            t0 = time.perf_counter()
            rows[name], syncs = collect_split_syncs(spark, query, dev)
            first_ms = (time.perf_counter() - t0) * 1e3
        got = {m: n for m, n in mode_launches(seg_agg).items() if n}
        for m, n in got.items():
            total[m] = total.get(m, 0) + n
        check(rows[name], f"scale: {name}: no rows")
        check(recovery.last_ladder.get("replans", 0) == 0,
              f"scale: {name}: the OOM ladder replanned")
        if dev == "cuda":
            check(ran_since(seg_agg, runs) == got, f"scale: {name}: the "
                  f"device ran {ran_since(seg_agg, runs)}, the wrappers "
                  f"launched {got}")
            check(got == SCALE_LAUNCHES.get(name, {}),
                  f"scale: {name} launched {got}, want "
                  f"{SCALE_LAUNCHES.get(name, {})}")
            check(len(calls) == sum(got.values()),
                  f"scale: {name}: {len(calls)} wrapper calls, {got}")
        hold_calls(seg_agg, calls, f"scale {name}")
        log(f"scale: {name} first run {first_ms:.1f} ms, {len(rows[name])} "
            f"rows, host syncs {syncs}, launches {got}")
        if name == "q1_wide" and dev == "cuda":
            scale_kernel_times(seg_agg, calls)
        del calls
        warm = warm_runs("scale", seg_agg, spark, name, query, rows[name],
                         got, dev)
        check(all(s is None or s["in stages"] == 0
                  for s in warm["replay_syncs"]),
              f"scale: {name}: a replay synced inside a stage: "
              f"{warm['replay_syncs']}")
        with graphs.guarding_stages():
            again = [tuple(r) for r in spark.sql(query).collect()]
        check(row_bits(again) == row_bits(rows[name]),
              f"scale: {name}: the guarded replay differs")
        prof = None
        if dev == "cuda":
            torch.cuda.synchronize()
            phase_peak = max(phase_peak, torch.cuda.max_memory_allocated())
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            spark.sql(query).collect()
            peak = torch.cuda.max_memory_allocated() - base
            log(f"scale: {name} a replay's peak device memory above what "
                f"was allocated {peak / 2 ** 20:.1f} MiB")
            prof = profile_query(spark, f"scale {name}", query)
        log(f"scale: {name} first {first_ms:.1f} / capture "
            f"{warm['capture_ms']:.1f} / replay "
            f"{statistics.median(warm['replay_ms']):.1f} ms (median of 3), "
            + ("device not measured" if prof is None else
               f"device {prof['device_ms']:.3f} ms, {prof['kernels']} "
               "kernel launches")
            + f"; hand-kernel launches {got}")
    log_pool("scale")

    t0 = time.perf_counter()
    tables = read_scale_tables(path)
    memory = SparkSession(device=dev)
    for name, tbl in tables.items():
        memory.createDataFrame(tbl).createOrReplaceTempView(name)
    log(f"scale: q1/q3/q5's columns read back with pyarrow and registered "
        f"in memory on {memory.device} in {time.perf_counter() - t0:.1f} s")
    for q in SCALE_HELD:
        name = f"q{q}"
        t0 = time.perf_counter()
        mem_rows = [tuple(r) for r in memory.sql(_scale_query(name))
                    .collect()]
        check(row_bits(mem_rows) == row_bits(rows[name]),
              f"scale: {name} from the files differs from memory")
        assert_rows_match(rows[name], done["yardstick"][q],
                          label=f"scale {name}[pyarrow]")
        log(f"scale: {name} from the files equals the in-memory session "
            f"bit for bit ({time.perf_counter() - t0:.1f} s) and pyarrow's "
            "computation")
    del memory, tables

    ch = ooc_run(seg_agg, spark, "q1", _scale_query("q1"), "_ChunkedAgg", 1,
                 2, OOC_CHUNK_ROWS, rows["q1"], dev=dev)
    for m, n in ch.items():
        total[m] = total.get(m, 0) + n
    if dev == "cuda":
        phase_peak = max(phase_peak, torch.cuda.max_memory_allocated())
        log(f"scale: peak device memory of the phase "
            f"{phase_peak / 2 ** 30:.2f} GiB")
    log_pool("scale")
    # the multiproc phase reads the same parts and holds its rows to these
    _SCALE_DONE.update(path=path, rows=rows, yardstick=done["yardstick"])
    return {m: total.get(m, 0) for m in mode_launches(seg_agg)}


#: the multiproc phase (query execution across processes): this many
#: child processes on the one card, one rank each, over gloo (NCCL
#: refuses two ranks on one device)
MULTIPROC_PROCS = 2
MULTIPROC_BACKEND = "gloo"
#: the scale phase's queries with adaptive execution off; these also
#: adaptive and fused
MULTIPROC_MODES = {"q1_wide": ("off", "adaptive", "fused"),
                   "q3": ("off", "adaptive", "fused")}
#: then the 2 x 2 mesh: this many ranks a child, threads of it, and its
#: queries and modes
MULTIPROC_THREADS = 2
MULTIPROC_MESH2 = {"q1_wide": ("off",), "q3": ("off", "adaptive", "fused"),
                   "q5": ("off",), "q18": ("off",)}
#: a collective waits this long for its peers, then the child fails
MULTIPROC_TIMEOUT_S = 120.0
#: the parent waits this long for its children, then kills them
MULTIPROC_WAIT_S = 500.0
#: B1 and B2 at q1-wide's shapes in the multiproc children (child 0)
_MULTIPROC_KERNELS: dict = {}
#: the 2 x 2 mesh's launches (the children's first runs), for the
#: kernels line
_MULTIPROC_MESH2: dict = {}


def multiproc_child(rank: int, port: int, path: str, out: str,
                    dev: str = "cuda") -> int:
    """``--multiproc-child RANK PORT DATASET OUT``: rank ``rank`` of the
    multiproc phase. It joins the gloo group at ``localhost:PORT``, makes
    a ``master("mesh[*]")`` session on ``dev`` (the card: ``cuda:0`` in
    every child), reads its own parts of lineitem and orders (parts
    ``rank``, ``rank`` + N, ...: ``multihost.local_fragments``) into
    Arrow tables and shards them with ``sharded_batch_from_local``, reads
    the six small tables whole, and runs each query of
    ``SCALE_QUERIES`` (``MULTIPROC_MODES``: also adaptive and fused)
    twice (``multiproc_runs``). Then the 2 x 2 mesh: a session over
    ``MULTIPROC_THREADS`` ranks a child (``meshDevices``, the child's
    ranks threads of it on its card), the same Arrow tables sharded over
    them in row order (SF10's parts are not read again), and
    ``MULTIPROC_MESH2``'s queries and modes run twice each the same way.
    It pickles the rows and numbers to ``OUT``. Child 0 then times B1
    and B2 at q1-wide's shapes while the others wait."""
    import pickle

    import pyarrow.dataset as pads

    from spark_tpu_torch.api.dataframe import DataFrame
    from spark_tpu_torch.api.session import SparkSession
    from spark_tpu_torch.ops import _build, seg_agg
    from spark_tpu_torch.parallel import multihost
    from spark_tpu_torch.plan import logical as L

    os.environ["TZ"] = "UTC"
    time.tzset()
    t_start = time.perf_counter()
    if dev == "cuda":
        _build.libraries(("seg_agg", "seg_fsum"))  # the parent's build
    multihost.initialize(f"localhost:{port}", MULTIPROC_PROCS, rank,
                         backend=MULTIPROC_BACKEND,
                         timeout_s=MULTIPROC_TIMEOUT_S)
    spark = SparkSession.builder.device(dev).master("mesh[*]") \
        .getOrCreate()
    mesh = spark.mesh_executor.mesh
    comm = mesh.comm
    tag = f"multiproc[{rank}]"
    log(f"{tag}: {mesh}, backend {comm.backend}, route {comm.route}, "
        f"{time.perf_counter() - t_start:.1f} s to join")
    res = {"rank": rank, "backend": comm.backend, "route": comm.route,
           "reads": {}, "rows": {}, "runs": {}, "launches": {}, "calls": {},
           "mesh2": {}}
    tables = {}

    def views(session, label):
        m = session.mesh_executor.mesh
        for name, table in tables.items():
            t0 = time.perf_counter()
            sb = multihost.sharded_batch_from_local(table, mesh=m)
            if dev == "cuda":
                torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            live = sb.live_counts()
            res["reads"].setdefault(name, {})[label] = dict(ms=ms, live=live)
            log(f"{tag}: {label}: {name} sharded in {ms:.1f} ms: live rows "
                f"by rank {live}, capacity {sb.per_device_capacity} a rank")
            DataFrame(session, L.Relation(sb)) \
                .createOrReplaceTempView(name)
            del sb
        for name in ("customer", "supplier", "nation", "region", "part",
                     "partsupp"):
            session.read.parquet(os.path.join(path, f"{name}.parquet")) \
                .createOrReplaceTempView(name)

    for name in ("lineitem", "orders"):
        t0 = time.perf_counter()
        frags = multihost.local_fragments(
            os.path.join(path, f"{name}.parquet"))
        tables[name] = pads.dataset(frags, format="parquet").to_table()
        ms = (time.perf_counter() - t0) * 1e3
        parts = [os.path.basename(f) for f in frags]
        res["reads"][name] = dict(ms=ms, parts=parts)
        log(f"{tag}: read {name} parts {parts} in {ms:.1f} ms "
            f"({tables[name].num_rows} rows)")
    views(spark, "mesh[*]")
    kept = multiproc_runs(seg_agg, spark, SCALE_QUERIES, MULTIPROC_MODES,
                          tag, res, dev)
    if rank != 0:
        kept = None

    # the 2 x 2 mesh: this child's ranks are threads of it, on its card
    for name in tables:
        spark.catalog.dropTempView(name)
    del spark
    per = ([f"cuda:{p % torch.cuda.device_count()}"
            for p in range(MULTIPROC_PROCS) for _ in range(MULTIPROC_THREADS)]
           if dev == "cuda" else [dev] * MULTIPROC_PROCS * MULTIPROC_THREADS)
    spark = SparkSession.builder.device(dev).master("mesh[*]") \
        .meshDevices(per).getOrCreate()
    mesh = spark.mesh_executor.mesh
    log(f"{tag}: 2 x 2: {mesh}, this child's ranks {mesh.local_ranks}")
    check(mesh.local_ranks == tuple(range(rank * MULTIPROC_THREADS,
                                          (rank + 1) * MULTIPROC_THREADS)),
          f"{tag}: the 2 x 2 mesh's ranks {mesh.local_ranks}")
    views(spark, "2 x 2")
    del tables
    mesh2 = {"rows": {}, "runs": {}, "launches": {}, "calls": {}}
    res["mesh2"] = mesh2
    multiproc_runs(seg_agg, spark, tuple(MULTIPROC_MESH2), MULTIPROC_MESH2,
                   f"{tag} 2 x 2", mesh2, dev)
    res["device_runs"] = device_runs(seg_agg, dev)
    # child 0 times B1 and B2 at q1-wide's shapes while the others wait
    comm.gather_objects("timing")
    res["kernels"] = {}
    if kept is not None and rank == 0 and dev == "cuda":
        scale_kernel_times(seg_agg, kept, label=tag, into=res["kernels"])
    del kept
    comm.gather_objects("timed")
    res["seconds"] = time.perf_counter() - t_start
    with open(out, "wb") as f:
        pickle.dump(res, f)
    log(f"{tag}: {res['seconds']:.1f} s in all")
    return 0


def multiproc_runs(seg_agg, spark, names, modes: dict, tag: str, res: dict,
                   dev: str):
    """Each query of ``names`` in ``modes`` (by default off only) twice
    on ``spark``'s mesh: the first run with the launch counters set to 0
    before and read after, every kernel-wrapper call held against its
    plain version, the card's runs equal to the wrappers' launches; the
    second bit for bit the first. Prints each run's walls, stages,
    exchanges (the rows and bytes that cross to another process, and
    those that stay between the threads of one), result gather, bytes
    staged through the host and peak device memory; keeps them and the
    rows and launches in ``res``. Returns q1-wide's first calls of the
    off run."""
    kept = None
    for name in names:
        query = _scale_query(name)
        for mode in modes.get(name, ("off",)):
            spark.conf.set("spark.tpu.adaptive.enabled", mode != "off")
            spark.conf.set("spark.tpu.fusion.enabled", mode == "fused")
            label = f"{tag} {name} {mode}"
            seg_agg.reset_launches()
            runs = device_runs(seg_agg, dev)
            if dev == "cuda":
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
            with recording_calls(seg_agg) as calls:
                t0 = time.perf_counter()
                rows = [tuple(r) for r in spark.sql(query).collect()]
                first_ms = (time.perf_counter() - t0) * 1e3
            rec = spark.mesh_executor.last_run
            got = {m: n for m, n in mode_launches(seg_agg).items() if n}
            if dev == "cuda":
                check(ran_since(seg_agg, runs) == got, f"{label}: the "
                      f"device ran {ran_since(seg_agg, runs)}, the "
                      f"wrappers launched {got}")
                check(len(calls) == sum(got.values()),
                      f"{label}: {len(calls)} wrapper calls, {got}")
            hold_calls(seg_agg, calls, label)
            res["calls"][(name, mode)] = sorted({c[0] for c in calls})
            if name == "q1_wide" and mode == "off" and kept is None:
                kept = calls
            del calls
            peak = (torch.cuda.max_memory_allocated() - base
                    if dev == "cuda" else 0)
            t0 = time.perf_counter()
            again = [tuple(r) for r in spark.sql(query).collect()]
            second_ms = (time.perf_counter() - t0) * 1e3
            check(row_bits(again) == row_bits(rows),
                  f"{label}: the second run differs from the first")
            ex = rec["exchanges"]
            moved = sum(e["moved_rows"] or 0 for e in ex)
            moved_bytes = sum(e["moved_bytes"] or 0 for e in ex)
            cross = sum(e["cross_rows"] for e in ex)
            cross_bytes = sum(e["cross_bytes"] for e in ex)
            run = dict(first_ms=first_ms, second_ms=second_ms,
                       stages=[round(st["wall_ms"], 1)
                               for st in rec["stages"]],
                       exchanges=[(e["op"], e["rows"], e["moved_rows"],
                                   e["moved_bytes"]) for e in ex],
                       moved_rows=moved, moved_bytes=moved_bytes,
                       cross_rows=cross, cross_bytes=cross_bytes,
                       gather_ms=rec.get("gather_ms", 0.0),
                       staged_bytes=rec["staged_bytes"],
                       host_reads=rec["host_reads"], peak_bytes=peak,
                       events=sorted({e["kind"] for e in rec["events"]}))
            res["rows"][(name, mode)] = rows
            res["runs"][(name, mode)] = run
            res["launches"][(name, mode)] = got
            log(f"{label}: first {first_ms:.1f} ms, second "
                f"{second_ms:.1f} ms, {len(rows)} rows; "
                f"{len(run['stages'])} stages, wall ms {run['stages']}; "
                f"{len(ex)} exchanges moving {moved} rows / {moved_bytes} "
                f"bytes to other ranks, of them {cross} rows / "
                f"{cross_bytes} bytes to the other process and "
                f"{moved - cross} rows / {moved_bytes - cross_bytes} bytes "
                f"between this process's threads (op, live rows, moved "
                f"rows, moved bytes each: {run['exchanges']}); result "
                f"gather {run['gather_ms']:.1f} ms; staged through the "
                f"host {run['staged_bytes']} bytes; host reads "
                f"{run['host_reads']}; peak device memory above the "
                f"tables {peak / 2 ** 20:.1f} MiB; decisions "
                f"{run['events']}; launches {got}")
    spark.conf.set("spark.tpu.adaptive.enabled", False)
    spark.conf.set("spark.tpu.fusion.enabled", False)
    return kept


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def multiproc_phase(seg_agg, gpu, cpu, oracle, dev="cuda"):
    """Query execution across processes on the one card: after the
    parent's device state is freed (``free_sf1``), ``MULTIPROC_PROCS``
    children (``--multiproc-child``, each its own process group) join a
    gloo group, each one rank of a ``mesh[*]`` session on ``cuda:0``,
    each reading its own parts of the scale phase's SF10 lineitem and
    orders, then ``MULTIPROC_THREADS`` ranks each, threads of it, on the
    2 x 2 mesh (``multiproc_child``). The parent waits at most
    ``MULTIPROC_WAIT_S`` and kills them after. On both meshes every
    child's rows equal the other's bit for bit, the scale phase's
    single-process rows by ``match_mesh`` and, for q1, q3 and q5,
    pyarrow's answers; each mode equals the off run bit for bit; both
    children launch the same kernels, q1-wide B1's count and int64 sum
    and B2's min and max; the 2 x 2 mesh's rows equal the one-rank
    runs' by ``match_mesh``. Returns the children's one-rank first runs'
    launches (the 2 x 2 mesh's go to ``_MULTIPROC_MESH2``); removes the
    dataset."""
    import pickle
    import shutil
    import tempfile

    from spark_tpu_torch.tpch.oracle import assert_rows_match

    t_phase = time.perf_counter()
    path = _SCALE_DONE["path"]
    free_sf1(gpu)
    if dev == "cuda":
        log(f"multiproc: the parent holds "
            f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB on the card "
            "before its children start")
    port = _free_port()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_multiproc_") as tmp:
        outs = [os.path.join(tmp, f"child{r}.pickle")
                for r in range(MULTIPROC_PROCS)]
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--multiproc-child",
             str(r), str(port), path, outs[r]]
            + ([] if dev == "cuda" else [dev]), start_new_session=True)
            for r in range(MULTIPROC_PROCS)]
        try:
            deadline = time.monotonic() + MULTIPROC_WAIT_S
            for r, proc in enumerate(procs):
                try:
                    rc = proc.wait(max(1.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    rc = None
                check(rc == 0, f"multiproc: child {r} "
                      + ("did not finish within "
                         f"{MULTIPROC_WAIT_S:.0f} s" if rc is None
                         else f"exited with {rc}"))
        finally:
            for proc in procs:
                stop_child(proc)
        got = []
        for out in outs:
            with open(out, "rb") as f:
                got.append(pickle.load(f))
    first = got[0]
    check({g["backend"] for g in got} == {MULTIPROC_BACKEND},
          f"multiproc: backends {[g['backend'] for g in got]}")
    parts = sorted(p for g in got for p in g["reads"]["lineitem"]["parts"])
    check(len(parts) == len(set(parts)) and len(parts) > MULTIPROC_PROCS,
          f"multiproc: the children's lineitem parts {parts}")
    scale_rows, yardstick = _SCALE_DONE["rows"], _SCALE_DONE["yardstick"]

    def hold(runs, label_of, one_rank=None):
        """The children's runs (``runs(g)``: rows and launches by
        query and mode) against each other, the off run, the scale
        phase's rows and pyarrow's; returns their launches."""
        launches: dict = {}
        for (name, mode), rows in runs(first)["rows"].items():
            label = label_of(name, mode)
            for g in got[1:]:
                check(row_bits(runs(g)["rows"][(name, mode)])
                      == row_bits(rows), f"{label}: the children's rows "
                      "differ")
            check(row_bits(rows) == row_bits(runs(first)["rows"][
                (name, "off")]), f"{label}: differs from the off run")
            worst = match_mesh(label, rows, scale_rows[name])
            if one_rank is not None:
                worst = max(worst, match_mesh(
                    f"{label} against one rank a child", rows,
                    one_rank[(name, "off")]))
            held = name in (f"q{q}" for q in SCALE_HELD) and mode == "off"
            if held:
                assert_rows_match(rows, yardstick[int(name[1:])],
                                  label=f"{label}[pyarrow]")
            launched = [runs(g)["launches"][(name, mode)] for g in got]
            check(all(x == launched[0] for x in launched),
                  f"{label}: the children launched {launched}")
            for x in launched:
                for m, n in x.items():
                    launches[m] = launches.get(m, 0) + n
            if name == "q1_wide":
                # B1 and B2 inside the mesh stages (the wrappers' calls;
                # on the card their launches)
                check(all(runs(g)["calls"][(name, mode)]
                          == ["seg_minmax", "seg_sum"] for g in got),
                      f"{label}: wrapper calls "
                      f"{[runs(g)['calls'][(name, mode)] for g in got]}")
                check(dev != "cuda" or all(launched[0].get(m) for m in
                                           ("count", "sum_i64", "min",
                                            "max")),
                      f"{label}: launched {launched[0]}")
            walls = [runs(g)["runs"][(name, mode)] for g in got]
            log(f"{label}: {len(rows)} rows, the children's equal bit for "
                f"bit, the scale phase's single-process rows"
                + (" and the one-rank runs'" if one_rank is not None else "")
                + f" (floats within {worst:.3g} of the bound {MESH_TOL})"
                + (" and pyarrow's" if held else "")
                + "; walls by child (first / second ms) "
                + ", ".join(f"{w['first_ms']:.1f} / {w['second_ms']:.1f}"
                            for w in walls)
                + "; crossing the processes (rows / bytes) "
                + ", ".join(f"{w['cross_rows']} / {w['cross_bytes']}"
                            for w in walls))
        return launches

    total = hold(lambda g: g, lambda n, m: f"multiproc {n} {m}")
    mesh2 = hold(lambda g: g["mesh2"], lambda n, m: f"multiproc 2 x 2 {n} {m}",
                 one_rank=first["rows"])
    check(all(mesh2.get(m) for m in ("count", "sum_i64", "min", "max"))
          or dev != "cuda", f"multiproc 2 x 2: launched {mesh2}")
    _MULTIPROC_MESH2.clear()
    _MULTIPROC_MESH2.update(mesh2)
    _MULTIPROC_KERNELS.update(first["kernels"])
    staged = [sum(r["staged_bytes"] for g in got for r in g["runs"].values()),
              sum(r["staged_bytes"] for g in got
                  for r in g["mesh2"]["runs"].values())]
    log(f"multiproc: {MULTIPROC_PROCS} processes over {first['backend']} "
        f"(route {first['route']}), {staged[0]} bytes staged through the "
        f"host by the one-rank first runs and {staged[1]} by the 2 x 2 "
        f"mesh's, the children's own seconds "
        f"{[round(g['seconds'], 1) for g in got]}, the phase "
        f"{time.perf_counter() - t_phase:.1f} s; launches one rank a child "
        f"{total}, 2 x 2 {mesh2}")
    shutil.rmtree(path)
    return {m: total.get(m, 0) for m in mode_launches(seg_agg)}


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--oom-child":
        return oom_child(sys.argv[2])
    if len(sys.argv) == 5 and sys.argv[1] == "--oracle-child":
        return oracle_child(sys.argv[2], float(sys.argv[3]),
                            int(sys.argv[4]))
    if len(sys.argv) == 7 and sys.argv[1] == "--compile-child":
        return compile_child(*sys.argv[2:6], sf=float(sys.argv[6]))
    if len(sys.argv) == 4 and sys.argv[1] == "--dataset-child":
        return dataset_child(sys.argv[2], sys.argv[3])
    if len(sys.argv) in (6, 7) and sys.argv[1] == "--multiproc-child":
        return multiproc_child(int(sys.argv[2]), int(sys.argv[3]),
                               *sys.argv[4:])
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import tempfile

    # the sqlite oracle loads in a process of its own (about two minutes
    # of host time), beside the first phases, and so does the scale
    # phase's SF10 dataset
    with tempfile.TemporaryDirectory(prefix="chip_smoke_oracle_") as odir, \
            tempfile.TemporaryDirectory(prefix="chip_smoke_scale_") as sdir:
        oracle = OracleChecks(odir)
        dataset = start_dataset(sdir)
        try:
            return run_all(oracle, dataset)
        finally:
            stop_child(oracle.proc)
            stop_child(dataset[0])


def run_all(oracle, dataset) -> int:
    """Every phase, the kernels line, the card line and the result."""
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
    tables = generate_tables(1.0, seed=SF1_SEED)
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
    by_path = {}
    import functools
    import tempfile

    # the io phase's Parquet files, which the ooc phase reads too
    with tempfile.TemporaryDirectory(prefix="chip_smoke_io_") as root:
        for path, phase in (
                ("aggregate", slice_phase), ("join", join_phase),
                ("subquery", subquery_phase), ("window", window_phase),
                ("tpch", tpch_phase), ("scalar", scalar_phase),
                ("io", functools.partial(io_phase, root=root)),
                ("complex", complex_phase),
                ("ooc", functools.partial(ooc_phase, root=root)),
                ("mesh", mesh_phase), ("frontend", frontend_phase),
                ("aqe", aqe_phase),
                ("obs", functools.partial(obs_phase, root=root)),
                ("serve", serve_phase),
                ("stream", functools.partial(stream_phase, tables=tables)),
                ("compile", functools.partial(compile_phase,
                                              tables=tables)),
                ("lib", functools.partial(lib_phase, tables=tables,
                                          root=root)),
                ("scale", functools.partial(scale_phase,
                                            dataset=dataset)),
                ("multiproc", multiproc_phase)):
            t0 = time.perf_counter()
            by_path[path] = phase(seg_agg, gpu, cpu, oracle)
            log(f"{path} phase: {time.perf_counter() - t0:.1f} s")
    # the multiproc phase's 2 x 2 mesh, a path of its own in the line
    by_path["multiproc_2x2"] = {m: _MULTIPROC_MESH2.get(m, 0)
                                for m in mode_launches(seg_agg)}
    oracle.finish()
    log(f"profiler (acc_events={_PROFILES['acc_events']}): "
        f"{_PROFILES['first']} of "
        f"{_PROFILES['all']} profiled runs recorded every hand-kernel run "
        "the card counted in their first session")
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
                  by_path.items()
                  if path not in ("scalar", "io", "ooc", "mesh", "frontend",
                                  "aqe", "obs", "serve", "stream", "lib",
                                  "scale", "multiproc",
                                  "multiproc_2x2")),
          "an earlier path summed floats on a grouped path")
    check(by_path["frontend"]["fsum_f64"] >= 1
          and by_path["frontend"]["count"] >= 1,
          "the frontend path launched no seg_fsum or seg_sum kernel")
    check(by_path["ooc"]["count"] >= 1 and by_path["ooc"]["min"] >= 1
          and by_path["ooc"]["fsum_f64"] >= 1,
          "the ooc path launched no seg_sum, seg_minmax or seg_fsum kernel")
    check(by_path["aqe"]["count"] >= 1 and by_path["aqe"]["max"] >= 1
          and by_path["aqe"]["sum_i64"] >= 1,
          "the aqe path launched no seg_sum count or int64 sum or seg_minmax "
          "max kernel")
    check(by_path["obs"]["count"] >= 1 and by_path["obs"]["max"] >= 1
          and by_path["obs"]["min"] >= 1,
          "the obs path launched no seg_sum count or seg_minmax kernel")
    check(by_path["serve"]["count"] >= 1 and by_path["serve"]["sum_i64"] >= 1
          and by_path["serve"]["min"] >= 1 and by_path["serve"]["max"] >= 1
          and by_path["serve"]["fsum_f64"] >= 1,
          "the serve path launched no seg_sum, seg_minmax or seg_fsum kernel")
    check(by_path["stream"]["count"] >= 1 and by_path["stream"]["sum_i64"] >= 1
          and by_path["stream"]["min"] >= 1 and by_path["stream"]["max"] >= 1
          and by_path["stream"]["fsum_f64"] >= 1,
          "the stream path launched no seg_sum count or int64 sum, "
          "seg_minmax min or max, or seg_fsum kernel")
    check(by_path["compile"]["count"] >= 1,
          "the compile path launched no seg_sum kernel")
    check(by_path["lib"]["count"] >= 1 and by_path["lib"]["fsum_f32"] >= 1,
          "the lib path launched no seg_sum count or seg_fsum float32 kernel")
    check(all(by_path["scale"][m] >= 1
              for m in ("count", "sum_i64", "min", "max")),
          "the scale path launched no seg_sum count or int64 sum or "
          "seg_minmax kernel")
    check(all(by_path["multiproc"][m] >= 1
              for m in ("count", "sum_i64", "min", "max")),
          "the multiproc path launched no seg_sum count or int64 sum or "
          "seg_minmax kernel")
    check(all(by_path["multiproc_2x2"][m] >= 1
              for m in ("count", "sum_i64", "min", "max")),
          "the multiproc 2 x 2 path launched no seg_sum count or int64 sum "
          "or seg_minmax kernel")

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
        # the aqe path's stats-stage shapes: B1 count at K = 1024 (the
        # Count-Min rows), B2 max at K = 512 (the HLL registers)
        stats_shape = {m: _AQE_KERNELS[m] for m in modes
                       if m in _AQE_KERNELS}
        # the lib path's shapes: seg_fsum float32 at PageRank's merge and
        # the deepest tree histogram, the B1 count over p_type
        lib_shapes = {m: _LIB_KERNELS[m] for m in modes
                      if m in _LIB_KERNELS}
        # the scale path's shapes: q1-wide at SF10 (N = 60M)
        scale_shapes = {m: _SCALE_KERNELS[m] for m in modes
                        if m in _SCALE_KERNELS}
        # the multiproc path's shapes: q1-wide in a child (N = 30M)
        multiproc_shapes = {m: _MULTIPROC_KERNELS[m] for m in modes
                            if m in _MULTIPROC_KERNELS}
        kernels.append(dict(
            name=name, route="cuda",
            source=f"spark_tpu_torch/ops/csrc/{source}", replaces=replaces,
            launches=sum(p[m] for p in by_path.values() for m in modes),
            launches_by_path={path: sum(p[m] for m in modes)
                              for path, p in by_path.items()},
            mode=headline, **top, modes=per_mode,
            aqe_stats_stage=stats_shape, lib_shapes=lib_shapes,
            scale_shapes=scale_shapes, multiproc_shapes=multiproc_shapes))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
