"""The session's compile tier (the port of
``spark_tpu/compile/service.py``).

The reference keeps XLA compiles off the query's path with three
policies; the port's counterpart of "not compiled yet" is "not captured
yet" (a plan's first run is eager: ``physical/graphs.run_stage``), and
each policy carries over:

* **Statistics store** (``bind_stats`` / ``save_stats``, called by
  ``physical/planner.execute``): a plan's first run in a process looks
  its statistics up in ``store.StatsStore``; a hit binds them, so the
  run is traced and captures its stages; a first run that recorded
  them writes them for the next process.
* **Background capture and hot swap** (``execute_plan``): with
  ``spark.tpu.compile.background`` on, a plan whose stages are not
  captured yet is served eagerly (``graphs.eager_stages``) while a
  daemon thread runs it again, binding its statistics and capturing
  its CUDA graphs; the next execution replays them. The rows are the
  same either way. The reference serves through the chunked tier
  meanwhile; the port serves the whole plan eagerly instead, because a
  chunked float sum merges rounded partials and can differ in the last
  bit from the whole batch's ``seg_fsum``, which rounds once. A
  background failure pins the plan to the eager path (no swap, no
  crash).
* **History and pre-warm** (``note_served``, ``prewarm``): served SQL is
  journaled (``plan_history.jsonl``); a connect server's start replays
  it most frequent first on a bounded pool, each plan through its first
  run and its capture, so the first client query replays.

The reference also routes jax's persistent XLA cache into the store's
directory (``_route_jax_cache``). The port has no XLA cache, and its
nvcc build cache (``ops/_build.py``) persists on its own, so nothing is
routed.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
import weakref
from typing import Any, Dict, List, Optional, Tuple

from spark_tpu_torch import conf as CF
from spark_tpu_torch import faults, locks, metrics
from spark_tpu_torch.compile import store as store_mod
from spark_tpu_torch.compile.store import StatsStore, stable_plan_fingerprint


def maybe_service(session) -> Optional["CompileService"]:
    """The session's CompileService when a ``spark.tpu.compile.*``
    feature is on (a store directory, background capture, a history
    path), else None. Reused unless the store directory or the history
    path changed."""
    conf = session.conf
    try:
        root = str(conf.get(CF.COMPILE_STORE_DIR) or "")
        background = bool(conf.get(CF.COMPILE_BACKGROUND))
        hist = str(conf.get(CF.COMPILE_HISTORY_PATH) or "")
    except Exception:  # noqa: BLE001
        return None
    if not root and not background and not hist:
        old = session.__dict__.pop("_compile_service", None)
        if old is not None:
            old.stop(timeout=0.0)
        return None
    cur = session.__dict__.get("_compile_service")
    if cur is not None and cur.root == root \
            and cur._history_path_cfg == hist:
        return cur
    svc = CompileService(session)
    session.__dict__["_compile_service"] = svc
    return svc


class PlanHistory:
    """Append-only JSONL journal of served plans (a fingerprint, and the
    SQL when the plan came from SQL text), counted in memory for the
    most-frequent-first replay. Compacted once the file passes about
    twice ``maxEntries`` lines."""

    def __init__(self, path: str, max_entries: int = 512):
        self.path = path
        self.max_entries = max(1, int(max_entries))
        self._lock = locks.named_lock("compile.history")
        #: fp -> [count, sql or None]
        self._counts: Dict[str, List] = {}
        self._lines = 0
        self._load()

    def _load(self) -> None:
        # read outside the lock, apply under it (no file IO under a lock)
        try:
            with open(self.path) as f:
                raw = f.readlines()
        except OSError:
            return
        with self._lock:
            for line in raw:
                self._lines += 1
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                fp = rec.get("fp")
                if not fp:
                    continue
                ent = self._counts.setdefault(fp, [0, None])
                ent[0] += int(rec.get("n", 1))
                if rec.get("sql"):
                    ent[1] = rec["sql"]

    def note(self, fp: str, sql: Optional[str] = None) -> None:
        with self._lock:
            ent = self._counts.setdefault(fp, [0, None])
            ent[0] += 1
            if sql:
                ent[1] = sql
            rec = {"fp": fp, "ts": round(time.time(), 2)}
            if sql:
                rec["sql"] = sql
            try:
                os.makedirs(os.path.dirname(self.path) or ".",
                            exist_ok=True)
                with open(self.path, "a") as f:
                    f.write(json.dumps(rec) + "\n")
                self._lines += 1
            except OSError:
                return
            if self._lines > 2 * self.max_entries:
                self._compact_locked()

    def _compact_locked(self) -> None:
        top = sorted(self._counts.items(), key=lambda kv: -kv[1][0])
        top = top[:self.max_entries]
        tmp = f"{self.path}.tmp{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                for fp, (n, sql) in top:
                    rec = {"fp": fp, "n": n}
                    if sql:
                        rec["sql"] = sql
                    f.write(json.dumps(rec) + "\n")
            os.replace(tmp, self.path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return
        self._counts = {fp: [n, sql] for fp, (n, sql) in top}
        self._lines = len(top)

    def top(self, limit: int) -> List[Tuple[str, Optional[str], int]]:
        """[(fp, sql or None, count)], most frequent first."""
        with self._lock:
            items = sorted(self._counts.items(), key=lambda kv: -kv[1][0])
        return [(fp, sql, n) for fp, (n, sql) in items[:max(0, limit)]]

    def size(self) -> int:
        with self._lock:
            return len(self._counts)


def _replayable_sql(sql: Optional[str]) -> Optional[str]:
    """Only SELECT-shaped statements replay at the pre-warm (a CREATE or
    DROP VIEW would change the catalog)."""
    if not sql:
        return None
    head = sql.lstrip().upper()
    if head.startswith("SELECT") or head.startswith("WITH"):
        return sql
    return None


class CompileService:
    """One session's compile policies: the statistics store, background
    capture and the swap, the served-plan history, the pre-warm."""

    def __init__(self, session):
        self._session_ref = weakref.ref(session)
        conf = session.conf
        self.root = str(conf.get(CF.COMPILE_STORE_DIR) or "")
        self._history_path_cfg = str(
            conf.get(CF.COMPILE_HISTORY_PATH) or "")
        self.store: Optional[StatsStore] = None
        if self.root:
            self.store = StatsStore(
                self.root, int(conf.get(CF.COMPILE_STORE_MAX_BYTES)))
        hist_path = self._history_path_cfg or (
            os.path.join(self.root, "plan_history.jsonl")
            if self.root else "")
        self.history: Optional[PlanHistory] = None
        if hist_path:
            self.history = PlanHistory(
                hist_path, int(conf.get(CF.COMPILE_HISTORY_MAX_ENTRIES)))
        #: routing key -> {"status": new|compiling|ready|failed,
        #: "chunk_serves": eager serves meanwhile, "swapped", "error"}
        self._plans: Dict[Any, dict] = {}
        self._plans_lock = locks.named_lock("compile.plans")
        self._jobs: List[threading.Thread] = []
        self._jobs_lock = locks.named_lock("compile.jobs")
        self._prewarm_report: Optional[dict] = None
        self._stopped = False

    def _conf(self):
        sess = self._session_ref()
        return sess.conf if sess is not None else CF.RuntimeConf()

    # -- the statistics store (physical/planner.execute) ---------------------

    def bind_stats(self, plan) -> bool:
        """Bind the stored statistics of ``plan`` (a physical plan about
        to make its first run in this process); True on a hit. A miss,
        and an entry that does not bind (read as corrupt and removed),
        leave the run a plain first run."""
        if self.store is None:
            return False
        from spark_tpu_torch import trace

        with trace.span("compile.probe", tier="stats"):
            digest = stable_plan_fingerprint("plan", plan)
            if digest is None:
                return False
            entry = self.store.load(digest)
            if entry is None:
                metrics.note_exec_store("misses")
                metrics.note_compile_cache(False)
                return False
            try:
                store_mod.bind_stats(plan, entry["nodes"])
            except Exception as e:  # noqa: BLE001 - a miss, evicted
                self.store.evict_corrupt(digest, e)
                return False
        metrics.note_exec_store("hits")
        metrics.note_compile_cache(True)
        metrics.record("compile", phase="store_hit", digest=digest)
        return True

    def save_stats(self, plan) -> bool:
        """Write the statistics ``plan``'s first run recorded."""
        if self.store is None or not bool(
                self._conf().get(CF.COMPILE_STORE_SERIALIZE)):
            return False
        digest = stable_plan_fingerprint("plan", plan)
        nodes = None if digest is None else store_mod.collect_stats(plan)
        if nodes is None:
            metrics.record("compile", phase="not_persistable")
            return False
        return self.store.put(digest, nodes)

    # -- background capture and the swap ---------------------------------------

    def _routing_key(self, lp) -> Any:
        try:
            return lp.structural_key()
        except Exception:  # noqa: BLE001
            return id(lp)

    def execute_plan(self, lp, conf, run_fn):
        """``DataFrame._execute``'s entry: run one optimized plan through
        the background-capture state machine, or straight through
        ``run_fn`` (the degradation ladder) when backgrounding is off."""
        if not bool(conf.get(CF.COMPILE_BACKGROUND)):
            return run_fn(lp)
        from spark_tpu_torch.physical import graphs

        key = self._routing_key(lp)
        with self._plans_lock:
            info = self._plans.setdefault(
                key, {"status": "new", "chunk_serves": 0,
                      "swapped": False, "error": None})
            status = info["status"]

        if status == "ready":
            swap = False
            with self._plans_lock:
                if info["chunk_serves"] and not info["swapped"]:
                    info["swapped"] = True
                    swap = True
            if swap:
                metrics.note_exec_store("swaps")
                metrics.record("compile", phase="swap",
                               chunk_serves=info["chunk_serves"])
            return run_fn(lp)

        # new / compiling / failed: served eagerly, so this request never
        # waits on a capture
        with graphs.eager_stages():
            out = run_fn(lp)
        spawn = False
        with self._plans_lock:
            if info["status"] == "new":
                info["status"] = "compiling"
                spawn = True
            info["chunk_serves"] += 1
            serves = info["chunk_serves"]
        if spawn:
            # after the first (recording) run: the job binds its
            # statistics and captures
            self._spawn_background(key, lp, conf, run_fn)
        metrics.note_exec_store("background")
        metrics.record("compile", phase="eager_serve",
                       status=info["status"], serve=serves)
        return out

    def _spawn_background(self, key, lp, conf, run_fn) -> None:
        def job():
            t0 = time.perf_counter()
            metrics.record("compile", phase="background_start")
            try:
                faults.inject("compile.background", conf)
                # one more run of the plan is the capture: its stages
                # are traced, warmed up and captured
                run_fn(lp)
            except Exception as e:  # noqa: BLE001 - pins the plan
                with self._plans_lock:
                    self._plans[key]["status"] = "failed"
                    self._plans[key]["error"] = repr(e)
                metrics.note_exec_store("fallbacks")
                metrics.record("compile", phase="background_failed",
                               error=repr(e))
                return
            with self._plans_lock:
                self._plans[key]["status"] = "ready"
            metrics.record(
                "compile", phase="background_done",
                ms=round((time.perf_counter() - t0) * 1e3, 2))

        t = threading.Thread(target=job, name="spark-tpu-bg-capture",
                             daemon=True)
        with self._jobs_lock:
            self._jobs = [j for j in self._jobs if j.is_alive()]
            self._jobs.append(t)
        t.start()

    def wait_background(self, timeout: float = 30.0) -> bool:
        """Join the live background jobs (captures and a pre-warm); True
        when none is left alive."""
        deadline = time.monotonic() + timeout
        with self._jobs_lock:
            jobs = list(self._jobs)
        for t in jobs:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        return not any(t.is_alive() for t in jobs)

    # -- served-plan history and the pre-warm -----------------------------------

    def note_served(self, plan, sql: Optional[str] = None) -> None:
        """Journal one served plan (``DataFrame._execute`` calls this for
        every execution; SQL text comes with frames from
        ``session.sql``)."""
        if self.history is None:
            return
        sql = _replayable_sql(sql)
        if sql is not None:
            fp = "sql:" + hashlib.sha1(
                " ".join(sql.split()).encode()).hexdigest()[:24]
        else:
            fp = "plan:" + hashlib.sha1(
                repr(type(plan).__name__).encode()).hexdigest()[:24]
        try:
            self.history.note(fp, sql)
        except Exception:  # noqa: BLE001 - the journal never fails a query
            pass

    def prewarm(self, session=None, block: bool = True,
                budget_s: Optional[float] = None,
                max_queries: Optional[int] = None) -> Optional[dict]:
        """Replay the served-plan history most frequent first, within the
        time and count budgets: each plan runs until it has captured (a
        first run that records, or binds from the store, and a run that
        captures), so its first client run replays. ``block=False`` runs
        on a daemon thread (a connect server's start)."""
        session = session or self._session_ref()
        if session is None or self.history is None:
            return None
        if not block:
            t = threading.Thread(
                target=lambda: self.prewarm(session, block=True,
                                            budget_s=budget_s,
                                            max_queries=max_queries),
                name="spark-tpu-prewarm", daemon=True)
            with self._jobs_lock:
                self._jobs.append(t)
            t.start()
            return None
        if metrics.brownout_level() > 0:
            # the fleet sheds the pre-warm first under pressure: it costs
            # warmth, never correctness
            metrics.record("compile", phase="prewarm_brownout_skip",
                           level=metrics.brownout_level())
            return {"replayed": [], "skipped": [], "errors": [],
                    "brownout": True}
        conf = session.conf
        if budget_s is None:
            budget_s = float(conf.get(CF.COMPILE_PREWARM_BUDGET_S))
        if max_queries is None:
            max_queries = int(conf.get(CF.COMPILE_PREWARM_MAX_QUERIES))
        workers = max(1, int(conf.get(CF.COMPILE_PREWARM_WORKERS)))
        entries = self.history.top(max_queries)
        t0 = time.monotonic()
        report: dict = {"replayed": [], "skipped": [], "errors": [],
                        "budget_s": budget_s}
        report_lock = locks.named_lock("compile.prewarm")
        metrics.record("compile", phase="prewarm_start",
                       candidates=len(entries), workers=workers)

        def replay_one(fp: str, sql: str, count: int) -> None:
            from spark_tpu_torch.physical import planner

            q0 = time.perf_counter()
            runs: list = []
            try:
                with planner.recording_runs(runs):
                    session.sql(sql).collect()
                    if any(r.first_run for r in runs) \
                            and not any(r.captured for r in runs):
                        # it recorded its statistics: this run captures
                        session.sql(sql).collect()
            except Exception as e:  # noqa: BLE001 - reported
                with report_lock:
                    report["errors"].append(
                        {"fp": fp, "sql": sql[:120], "error": repr(e)})
                return
            metrics.note_exec_store("prewarmed")
            with report_lock:
                report["replayed"].append(
                    {"fp": fp, "sql": sql[:120], "count": count,
                     "runs": len(runs),
                     "captured": sum(r.captured for r in runs),
                     "ms": round((time.perf_counter() - q0) * 1e3, 1)})

        pending = []
        for fp, sql, count in entries:
            sql = _replayable_sql(sql)
            if sql is None:
                report["skipped"].append({"fp": fp, "reason": "no sql"})
                continue
            pending.append((fp, sql, count))

        idx = [0]
        idx_lock = locks.named_lock("compile.prewarm")

        def worker():
            while True:
                with idx_lock:
                    if idx[0] >= len(pending):
                        return
                    i = idx[0]
                    idx[0] += 1
                fp, sql, count = pending[i]
                if time.monotonic() - t0 > budget_s:
                    with report_lock:
                        report["skipped"].append(
                            {"fp": fp, "reason": "time budget"})
                    continue
                replay_one(fp, sql, count)

        if workers == 1:
            worker()  # in order, on this thread
        else:
            threads = [threading.Thread(target=worker, daemon=True,
                                        name=f"spark-tpu-prewarm-{i}")
                       for i in range(min(workers, max(1, len(pending))))]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        report["wall_s"] = round(time.monotonic() - t0, 2)
        metrics.record("compile", phase="prewarm_done",
                       replayed=len(report["replayed"]),
                       errors=len(report["errors"]),
                       skipped=len(report["skipped"]),
                       wall_s=report["wall_s"])
        self._prewarm_report = report
        return report

    # -- introspection ------------------------------------------------------------

    def status(self) -> dict:
        with self._plans_lock:
            by_status: Dict[str, int] = {}
            for info in self._plans.values():
                by_status[info["status"]] = \
                    by_status.get(info["status"], 0) + 1
            plans = len(self._plans)
        with self._jobs_lock:
            alive = sum(1 for t in self._jobs if t.is_alive())
        try:
            from spark_tpu_torch.scheduler import admission

            measured = admission.measured_snapshot()
        except Exception:  # noqa: BLE001
            measured = None
        return {
            "admission_measured": measured,
            "store": self.store.stats() if self.store else None,
            "exec_store": metrics.exec_store_stats(),
            "background": {"plans": plans, "by_status": by_status,
                           "jobs_alive": alive},
            "history": {"path": self.history.path,
                        "entries": self.history.size()}
            if self.history else None,
            "prewarm": self._prewarm_report,
        }

    def stop(self, timeout: float = 5.0) -> None:
        self._stopped = True
        self.wait_background(timeout=timeout)
