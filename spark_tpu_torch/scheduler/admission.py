"""Device-bytes admission (the port of ``spark_tpu/scheduler/admission.py``):
a shared budget that decides when a query may run on the device and
under what memory budget.

The footprint estimate is the join reorderer's cost model
(``plan/join_reorder.estimate_rows``: exact at Parquet and batch leaves,
heuristic above) times 8 bytes a column, the largest over the plan's
nodes: the widest intermediate a plan holds presses the device, not its
(often small) output. These are the reference's numbers, so both
packages admit the same queries together.

Admission is optimistic at the edge: a query larger than the whole
budget still admits when nothing else runs, charged the whole budget,
and leans on the out-of-memory ladder
(``recovery.run_plan_with_oom_degradation``). Refusing it would make it
unservable on an idle device.
"""

from __future__ import annotations

from spark_tpu_torch import locks

#: floor of any footprint estimate: below it the noise exceeds the
#: signal and admission would thrash
MIN_ESTIMATE_BYTES = 64 * 1024

#: measured peak stage bytes of earlier runs, keyed on the logical
#: plan's ``structural_key()``: ``DataFrame._execute`` notes the largest
#: ``stage_bytes`` event of each finished query (the mesh records them)
#: and ``estimate_plan_bytes`` prefers a measurement to the static
#: estimate. A bounded LRU under a lock: structural keys hold sources
#: by identity, so an unbounded table would pin dead batches.
_MEASURED_LOCK = locks.named_lock("admission.measured")
_MEASURED_MAX_ENTRIES = 512
_MEASURED: dict = {}


def note_measured_bytes(plan, nbytes: int) -> None:
    """Record the measured peak stage footprint of an executed logical
    plan (nothing when the key cannot be computed or the value is not
    positive)."""
    if nbytes <= 0:
        return
    try:
        key = plan.structural_key()
    except Exception:  # noqa: BLE001 - an unkeyable plan is not recorded
        return
    with _MEASURED_LOCK:
        # re-insertion moves the key to the back (dicts keep order)
        prev = _MEASURED.pop(key, 0)
        _MEASURED[key] = max(int(nbytes), prev)
        while len(_MEASURED) > _MEASURED_MAX_ENTRIES:
            _MEASURED.pop(next(iter(_MEASURED)))


def measured_plan_bytes(plan):
    """The recorded measurement for this plan shape, or None."""
    try:
        key = plan.structural_key()
    except Exception:  # noqa: BLE001 - an unkeyable plan has none
        return None
    with _MEASURED_LOCK:
        return _MEASURED.get(key)


def measured_snapshot() -> dict:
    """Size and largest entry of the measured-footprint table."""
    with _MEASURED_LOCK:
        return {"plans": len(_MEASURED),
                "max_bytes": max(_MEASURED.values(), default=0)}


def estimate_plan_bytes(plan, conf) -> int:
    """Estimated device footprint of ``plan``: a measured peak of an
    earlier run of the same plan shape where there is one
    (``note_measured_bytes``), else the largest over the plan's nodes of
    estimated rows x 8 bytes a column. Where estimation fails, the device
    batch budget: an unknown plan admits alone rather than stampede the
    device."""
    from spark_tpu_torch.physical.chunked import MAX_DEVICE_BATCH_BYTES

    measured = measured_plan_bytes(plan)
    if measured is not None:
        return max(MIN_ESTIMATE_BYTES, int(measured))
    try:
        from spark_tpu_torch.plan.join_reorder import estimate_rows

        def node_bytes(node) -> float:
            try:
                width = 8 * max(1, len(node.schema.names))
            except Exception:  # noqa: BLE001 - an unresolvable schema
                width = 8
            own = estimate_rows(node) * width
            return max([own] + [node_bytes(c) for c in node.children()])

        est = int(node_bytes(plan))
    except Exception:  # noqa: BLE001 - no estimate: the whole budget
        est = int(conf.get(MAX_DEVICE_BATCH_BYTES))
    return max(MIN_ESTIMATE_BYTES, est)


def seeded_build_bytes(plan, fallback: int) -> int:
    """The grant the hybrid hash join asks for its build staging: the
    measured peak of this plan shape where an earlier run recorded one,
    else the planner's estimate ``fallback``. It does not fall back to
    the device batch budget as ``estimate_plan_bytes`` does: an unknown
    join asks for what the planner believes, not 5 GiB that would evict
    the whole cache for nothing."""
    measured = measured_plan_bytes(plan)
    if measured is not None and measured > 0:
        return max(MIN_ESTIMATE_BYTES, int(measured))
    return max(MIN_ESTIMATE_BYTES, int(fallback))


class AdmissionController:
    """Byte-budget gate over the execution side of the unified memory
    manager (``storage/unified.py``). With the session's manager,
    admission and cached storage share one budget: an admission that
    does not fit first evicts unpinned cached batches down to
    ``spark.tpu.storage.minBytes``. The scheduler holds its own
    condition around ``fits``/``acquire``, so the controller never
    blocks."""

    def __init__(self, budget_bytes: int, manager=None):
        from spark_tpu_torch.storage.unified import UnifiedMemoryManager

        self._m = manager if manager is not None \
            else UnifiedMemoryManager(budget_bytes)

    @property
    def budget(self) -> int:
        return self._m.budget

    @property
    def manager(self):
        """The shared UnifiedMemoryManager."""
        return self._m

    def charge_for(self, nbytes: int) -> int:
        """What an admission of ``nbytes`` costs: at most the whole
        budget, so an over-budget query can still admit alone."""
        return self._m.charge_for(nbytes)

    def fits(self, nbytes: int) -> bool:
        return self._m.fits_execution(nbytes)

    def acquire(self, nbytes: int) -> int:
        """Charge the budget (evicting unpinned storage where needed);
        returns the charge to pass to ``release``. The caller checked
        ``fits`` under the scheduler's lock."""
        return self._m.acquire_execution(nbytes)

    def release(self, charge: int) -> None:
        self._m.release_execution(charge)

    def snapshot(self) -> dict:
        return self._m.snapshot()
