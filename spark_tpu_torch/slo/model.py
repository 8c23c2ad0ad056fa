"""Online per-plan latency model for SLO-driven serving (the port of
``spark_tpu/slo/model.py``).

Predicts how long a query will run BEFORE it runs, from what identical
plans cost in the past. State is one EWMA record per plan fingerprint
(the reference's ``sql:``-sha1 scheme, shared with its plan-history
journal):

    host_ms / device_ms / queue_ms / transfer_ms / run_ms / rows / n
    (+ cold_ms / cold_n — see below)

``run_ms`` is the directly-measured wall time of the scheduler's run
phase (always available); the component EWMAs come from trace span
events when sampling is on (best-effort — they refine the row-count
scaling but the prediction never depends on them existing).

Cold runs are quarantined: a query whose trace holds a
``stage_compile`` event folds its wall time into a separate
``cold_ms``/``cold_n`` component and leaves every warm EWMA untouched.
The reference quarantines on its compile store's misses (``compile``
events ``aot_compile``/``aot_failed``); the port's counterpart is the
``stage_compile`` event a CUDA-graph capture records
(``physical/graphs.py``): the run that captures a stage pays the
warm-up and the capture, which no replay pays again. One cold outlier
folded into the warm estimate would multiply the prediction and poison
admission for the next queries. ``predict_run_ms`` stays warm-only;
``cold_ms`` is for the snapshot. Journals without these fields load
with cold_ms = cold_n = 0.

Prediction scales the device+transfer share by the ratio of the
query's input-row count to the EWMA'd historical row count (scan-stat
driven, clamped to [0.1, 10] so one wild cardinality estimate cannot
produce an absurd prediction), leaving the host share fixed — host
overhead (parse/analyze/dispatch) is roughly size-independent.

Persistence: a JSONL journal (``spark.tpu.slo.model.path``) where each
line is a full state snapshot of one fingerprint, so load is
last-line-wins per fingerprint and a restarted replica predicts from
its first query. Compaction past 2x maxEntries rewrites one line per
live fingerprint via tmp + os.replace.

Locking: everything mutable sits under the registered ``slo.model``
lock (rank 320 — legal to take while holding ``scheduler.cond`` at
300, which is exactly what the submit-path feasibility check does).
"""

from __future__ import annotations

import hashlib
import json
import os
from collections import OrderedDict
from typing import Any, Dict, Optional

from spark_tpu_torch import locks


# -- fingerprints ------------------------------------------------------------

def fingerprint_sql(sql: str) -> str:
    """Whitespace-normalized SQL fingerprint, the reference's scheme
    (its compile service journals served plans under the same keys)."""
    return "sql:" + hashlib.sha1(
        " ".join(sql.split()).encode()).hexdigest()[:24]


def fingerprint_plan(plan) -> Optional[str]:
    """Structural plan fingerprint for non-SQL submissions; stable
    across restarts (node_string, not id()). Type-name as last resort;
    None when even that fails — no fingerprint means no prediction,
    which means FIFO-equivalent behaviour for that query."""
    try:
        return "plan:" + hashlib.sha1(
            plan.node_string().encode()).hexdigest()[:24]
    except Exception:
        try:
            return "plan:" + hashlib.sha1(
                type(plan).__name__.encode()).hexdigest()[:24]
        except Exception:
            return None


def plan_input_rows(plan) -> Optional[float]:
    """Total input cardinality: sum of scan-stat row estimates over the
    plan's leaves (exact for Parquet metadata / in-memory batches).
    None when the plan exposes no usable estimates."""
    try:
        from spark_tpu_torch.plan.join_reorder import estimate_rows

        total, found = 0.0, False
        stack = [plan]
        while stack:
            node = stack.pop()
            kids = list(node.children())
            if not kids:
                total += float(estimate_rows(node))
                found = True
            else:
                stack.extend(kids)
        return total if found else None
    except Exception:
        return None


# -- the model ---------------------------------------------------------------

class LatencyModel:
    """EWMA-per-fingerprint latency estimator with JSONL persistence.

    All public methods are safe to call from any thread and never
    raise out (prediction is advisory: a broken journal or a full disk
    must degrade to in-memory / cold-start, never fail a query).
    """

    def __init__(self, path: str = "", *, alpha: float = 0.3,
                 max_entries: int = 512):
        self.path = str(path or "")
        self.alpha = min(1.0, max(0.01, float(alpha)))
        self.max_entries = max(8, int(max_entries))
        self._lock = locks.named_lock("slo.model")
        #: fp -> {host_ms, device_ms, queue_ms, transfer_ms, run_ms,
        #:        rows, n, cold_ms, cold_n} — OrderedDict as LRU
        #: (move_to_end on touch)
        self._state: "OrderedDict[str, Dict[str, float]]" = OrderedDict()
        self._appends = 0
        self._load()

    # -- persistence ---------------------------------------------------------

    def _load(self) -> None:
        if not self.path:
            return
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                lines = f.readlines()
        except FileNotFoundError:
            return
        except Exception:
            return
        loaded: "OrderedDict[str, Dict[str, float]]" = OrderedDict()
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
                fp = rec.pop("fp")
                loaded.pop(fp, None)  # last-line-wins, refresh LRU slot
                cur = {k: float(rec[k]) for k in
                       ("host_ms", "device_ms", "queue_ms",
                        "transfer_ms", "run_ms", "rows", "n")}
                # cold component post-dates the journal format: old
                # lines load as never-cold rather than being dropped
                cur["cold_ms"] = float(rec.get("cold_ms", 0.0))
                cur["cold_n"] = float(rec.get("cold_n", 0.0))
                loaded[fp] = cur
            except Exception:
                continue  # tolerate torn/garbage lines
        while len(loaded) > self.max_entries:
            loaded.popitem(last=False)
        with self._lock:
            self._state = loaded
            self._appends = 0
        if loaded:
            try:
                from spark_tpu_torch import metrics

                metrics.note_slo("loads", len(loaded))
            except Exception:
                pass

    def _persist_locked(self, fp: str) -> None:
        """Append one full state snapshot for ``fp``; compact the
        journal once it holds 2x maxEntries lines. Runs under the
        model lock so the journal and the in-memory state cannot
        diverge (same trade as PlanHistory.note)."""
        if not self.path:
            return
        rec = dict(self._state[fp])
        rec["fp"] = fp
        line = json.dumps(rec, sort_keys=True) + "\n"
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(self.path, "a", encoding="utf-8") as f:
            f.write(line)
        self._appends += 1
        if self._appends >= 2 * self.max_entries:
            tmp = f"{self.path}.tmp{os.getpid()}"
            with open(tmp, "w", encoding="utf-8") as f:
                for k, v in self._state.items():
                    out = dict(v)
                    out["fp"] = k
                    f.write(json.dumps(out, sort_keys=True) + "\n")
            os.replace(tmp, self.path)
            self._appends = 0

    # -- observe / predict ---------------------------------------------------

    def observe(self, fp: str, *, run_ms: float, queue_ms: float = 0.0,
                rows: Optional[float] = None, device_ms: float = 0.0,
                transfer_ms: float = 0.0, cold: bool = False) -> None:
        """Fold one completed query into the fingerprint's EWMAs and
        journal the updated snapshot. ``cold=True`` (the trace showed a
        CUDA-graph capture) updates ONLY the quarantined cold
        component — the warm run-time estimate never sees the compile
        outlier. Never raises."""
        if not fp or run_ms is None or run_ms < 0:
            return
        host_ms = max(0.0, float(run_ms) - float(device_ms)
                      - float(transfer_ms))
        try:
            with self._lock:
                cur = self._state.pop(fp, None)
                a = self.alpha
                if cold:
                    if cur is None:
                        cur = {"host_ms": 0.0, "device_ms": 0.0,
                               "queue_ms": 0.0, "transfer_ms": 0.0,
                               "run_ms": 0.0,
                               "rows": float(rows) if rows else 0.0,
                               "n": 0.0, "cold_ms": float(run_ms),
                               "cold_n": 1.0}
                    elif cur.get("cold_n", 0.0) <= 0:
                        cur["cold_ms"] = float(run_ms)
                        cur["cold_n"] = 1.0
                    else:
                        cur["cold_ms"] = ((1 - a) * cur["cold_ms"]
                                          + a * float(run_ms))
                        cur["cold_n"] = cur.get("cold_n", 0.0) + 1.0
                elif cur is None:
                    cur = {"host_ms": host_ms,
                           "device_ms": float(device_ms),
                           "queue_ms": float(queue_ms),
                           "transfer_ms": float(transfer_ms),
                           "run_ms": float(run_ms),
                           "rows": float(rows) if rows else 0.0,
                           "n": 1.0, "cold_ms": 0.0, "cold_n": 0.0}
                elif cur.get("n", 0.0) <= 0:
                    # first WARM observation of an entry a cold run
                    # created: seed directly — folding against the
                    # zeroed placeholders would bias the estimate low
                    cur.update({"host_ms": host_ms,
                                "device_ms": float(device_ms),
                                "queue_ms": float(queue_ms),
                                "transfer_ms": float(transfer_ms),
                                "run_ms": float(run_ms)})
                    if rows:
                        cur["rows"] = float(rows)
                    cur["n"] = 1.0
                else:
                    for key, obs in (("host_ms", host_ms),
                                     ("device_ms", float(device_ms)),
                                     ("queue_ms", float(queue_ms)),
                                     ("transfer_ms", float(transfer_ms)),
                                     ("run_ms", float(run_ms))):
                        cur[key] = (1 - a) * cur[key] + a * obs
                    if rows:
                        prev = cur.get("rows", 0.0)
                        cur["rows"] = (float(rows) if prev <= 0
                                       else (1 - a) * prev + a * float(rows))
                    cur["n"] = cur.get("n", 0.0) + 1.0
                self._state[fp] = cur  # re-insert at LRU tail
                while len(self._state) > self.max_entries:
                    self._state.popitem(last=False)
                self._persist_locked(fp)
            try:
                from spark_tpu_torch import metrics

                metrics.note_slo("cold_observations" if cold
                                 else "observations")
            except Exception:
                pass
        except Exception:
            pass  # advisory: journal/disk failure must not fail queries

    def predict_run_ms(self, fp: Optional[str],
                       rows: Optional[float] = None) -> Optional[float]:
        """Predicted run time for one execution of ``fp``; None when
        the model has never seen the fingerprint (callers treat
        unpredictable as always-feasible / FIFO-equivalent)."""
        if not fp:
            return None
        with self._lock:
            cur = self._state.get(fp)
            if cur is None or cur.get("n", 0.0) < 1.0:
                # cold-only entries predict nothing: the only signal is
                # compile time, which a warm run never pays again
                return None
            self._state.move_to_end(fp)
            hist_rows = cur.get("rows", 0.0)
            scaled = cur["device_ms"] + cur["transfer_ms"]
            # size-independent host share + row-scaled device share;
            # when components were never traced, scale run_ms whole
            if scaled <= 0.0:
                base, fixed = cur["run_ms"], 0.0
            else:
                base, fixed = scaled, cur["host_ms"]
            ratio = 1.0
            if rows and hist_rows > 0:
                ratio = min(10.0, max(0.1, float(rows) / hist_rows))
            return fixed + base * ratio

    def predict_queue_ms(self, fp: Optional[str]) -> Optional[float]:
        """Historical queue-wait EWMA (controller fallback when it has
        no live backlog estimate)."""
        if not fp:
            return None
        with self._lock:
            cur = self._state.get(fp)
            return None if cur is None else cur["queue_ms"]

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"entries": len(self._state),
                    "path": self.path,
                    "alpha": self.alpha,
                    "observations": sum(v.get("n", 0.0)
                                        for v in self._state.values()),
                    "cold_observations": sum(
                        v.get("cold_n", 0.0)
                        for v in self._state.values())}


def model_path_from_conf(conf) -> str:
    """Journal location: ``spark.tpu.slo.model.path``, else beside the
    plan history under the compile store's root
    (``spark.tpu.compile.store.dir``), else "" (in memory only, a cold
    start each restart)."""
    from spark_tpu_torch import conf as CF

    try:
        explicit = str(conf.get(CF.SLO_MODEL_PATH) or "")
        if explicit:
            return explicit
        root = str(conf.get(CF.COMPILE_STORE_DIR) or "")
        return os.path.join(root, "slo_model.jsonl") if root else ""
    except Exception:  # noqa: BLE001 - advisory: in memory
        return ""
