"""The materialized-view refresh and merge engine (the port of
``spark_tpu/mview/manager.py``).

``ViewManager`` owns every registered view and sits behind the plan
cache: ``CacheManager._materialize`` hands it the keys that are views,
so reading a view is a cache read plus a freshness check against the
scan's file fingerprint (``io/fingerprint.py``). A stale file view
refreshes in place (``MemoryStore.update`` keeps the entry's key and LRU
place and accounts only the byte delta). When the delta is appended
files and the aggregate is exactly re-mergeable, the refresh runs the
aggregate over the appended files only and re-merges the partials with
the cached batch on the device; anything else recomputes in full. Both
give the same bytes: ``columnar/arrow.from_arrow`` sorts each string
dictionary, so the merged output is a function of the rows alone.

Stream views take the micro-batch rows that ``streaming/execution.py``
publishes before its WAL commit, deduplicated by batch id: a crash
between the merge and the commit replays the same batch id, which the
``batch_id <= last_batch_id`` watermark drops.

Incremental refreshes pass the ``mview.refresh`` fault point with
bounded transient retries (``spark.tpu.mview.refreshRetries``); past
them a file view falls back to a full recompute (files can be scanned
again) and a stream view raises, so the WAL delivers the delta again.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import pyarrow as pa

from spark_tpu_torch import conf as CF
from spark_tpu_torch import faults, locks, metrics, recovery
from spark_tpu_torch.io.fingerprint import classify_delta, source_fingerprint
from spark_tpu_torch.mview.view import MaterializedView, inspect_plan
from spark_tpu_torch.plan import logical as L


def _stream_key(name: str):
    return ("mview-stream", name)


class ViewManager:
    """Registry and refresh engine of one session's materialized views.

    Thread-safe: the registry changes under ``_lock``; each view
    refreshes under its own ``view.lock`` (a file view also under the
    CacheManager's entry lock, which the caller passes in)."""

    def __init__(self, session):
        self._session = session
        self._views: Dict[Any, MaterializedView] = {}
        self._by_stream: Dict[str, List[MaterializedView]] = {}
        self._lock = locks.named_lock("mview.manager")

    # -- settings -------------------------------------------------------------

    @property
    def _conf(self):
        return self._session.conf

    def enabled(self) -> bool:
        try:
            return bool(self._conf.get(CF.MVIEW_ENABLED))
        except Exception:  # noqa: BLE001 - a session without the key
            return False

    def _incremental_on(self) -> bool:
        try:
            return bool(self._conf.get(CF.MVIEW_INCREMENTAL))
        except Exception:  # noqa: BLE001
            return True

    # -- registration ---------------------------------------------------------

    def maybe_register(self, plan: L.LogicalPlan
                       ) -> Optional[MaterializedView]:
        """Promote a ``df.cache()`` registration to a file view when the
        tier is on and the plan qualifies (a root Aggregate over one
        fingerprinted file scan). Never raises: a plan that cannot be a
        view stays a plain cache entry."""
        if not self.enabled():
            return None
        try:
            insp = inspect_plan(plan)
        except Exception as exc:  # noqa: BLE001 - cache() never breaks
            metrics.record("mview", phase="inspect_error",
                           error=type(exc).__name__)
            return None
        if not insp.registrable or insp.kind != "file":
            return None
        key = plan.structural_key()
        with self._lock:
            view = self._views.get(key)
            if view is None:
                view = MaterializedView(key=key, plan=plan,
                                        inspection=insp)
                self._views[key] = view
                metrics.note_mview("registrations")
                metrics.record("mview", phase="register",
                               view_kind="file",
                               incremental=insp.incremental)
                metrics.set_gauge("mview.views", len(self._views))
        return view

    def register_stream_view(self, name: str, plan: L.LogicalPlan,
                             stream: str) -> MaterializedView:
        """Register a named view over a streaming aggregate: ``plan`` is
        a root Aggregate over the one StreamingSource of the query named
        ``stream``, and must be incrementally maintainable (a stream
        cannot be scanned again, so there is no full recompute to fall
        back to)."""
        insp = inspect_plan(plan)
        if not insp.registrable or insp.kind != "stream":
            why = "; ".join(m for _, m, _ in insp.diagnostics) \
                or "plan is not a stream-view candidate"
            raise ValueError(
                f"cannot register stream view {name!r}: {why}")
        key = _stream_key(name)
        view = MaterializedView(key=key, plan=plan, inspection=insp,
                                name=name, stream=stream)
        with self._lock:
            if key in self._views:
                raise ValueError(
                    f"stream view {name!r} is already registered")
            self._views[key] = view
            self._by_stream.setdefault(stream, []).append(view)
            metrics.note_mview("registrations")
            metrics.record("mview", phase="register",
                           view_kind="stream", view=name,
                           stream=stream)
            metrics.set_gauge("mview.views", len(self._views))
        return view

    def unregister(self, key) -> None:
        with self._lock:
            view = self._views.pop(key, None)
            if view is not None and view.stream:
                subs = self._by_stream.get(view.stream, [])
                if view in subs:
                    subs.remove(view)
            metrics.set_gauge("mview.views", len(self._views))

    def drop_stream_view(self, name: str) -> None:
        self.unregister(_stream_key(name))

    def clear_file_views(self) -> None:
        """Drop every file view (the CacheManager's clear); stream views
        were registered by name and survive a cache clear."""
        with self._lock:
            for key in [k for k, v in self._views.items()
                        if v.kind == "file"]:
                del self._views[key]
            metrics.set_gauge("mview.views", len(self._views))

    def view_for(self, key) -> Optional[MaterializedView]:
        with self._lock:
            return self._views.get(key)

    def stream_view(self, name: str) -> Optional[MaterializedView]:
        return self.view_for(_stream_key(name))

    def views(self) -> List[dict]:
        with self._lock:
            return [v.to_dict() for v in self._views.values()]

    # -- file-view refresh (the CacheManager's materialization) ---------------

    def materialize(self, view: MaterializedView, entry_lock, run,
                    store, skey):
        """The view's batch, refreshed first when the source fingerprint
        moved. The plain cache path's contract: the batch is pinned for
        the enclosing query's pin_scope, and a store rejection still
        serves this query its batch."""
        with entry_lock:  # one materialization at a time, as the cache's
            batch = store.get(skey, pin=True)
            fp = source_fingerprint(view.source())
            if batch is not None and fp is not None \
                    and fp == view.fingerprint:
                metrics.note_mview("hits")
                return batch
            if batch is None or view.fingerprint is None:
                # cold, or evicted since: a plain materialization
                batch = run(view.plan)
                store.put(skey, batch, pin=True)
                with view.lock:
                    view.fingerprint = fp
                metrics.record("mview", phase="materialize",
                               files=len(fp or ()))
                return batch
            kind, added = ("changed", ()) if fp is None \
                else classify_delta(view.fingerprint, fp)
            if kind == "unchanged":
                return batch
            fresh = self._refresh(view, batch, kind, added, run)
            store.update(skey, fresh, pin=True)
            with view.lock:
                view.fingerprint = fp
                view.refreshes += 1
            self._repopulate_serve(view, fresh)
            self._notify_invalidation(view)
            return fresh

    def _refresh(self, view: MaterializedView, cached_batch, kind: str,
                 added, run):
        """One stale file view's refresh: an incremental merge where it
        is legal and the delta is appended files, else a full recompute.
        The merge passes the ``mview.refresh`` fault point; transient
        faults retry, and past the retries it recomputes."""
        incremental = (kind == "appended" and bool(added)
                       and view.inspection.incremental
                       and self._incremental_on())
        if not incremental:
            view.full_recomputes += 1
            metrics.note_mview("full_recomputes")
            metrics.record("mview", phase="refresh", how="full",
                           reason=kind)
            return run(view.plan)

        def merge():
            faults.inject("mview.refresh", self._conf)
            return self._merge_file_delta(view, cached_batch, added, run)

        batch, merged = self._with_retries(
            merge, fallback=lambda: run(view.plan))
        if merged:
            view.incremental_merges += 1
            metrics.note_mview("incremental_merges")
            metrics.record("mview", phase="refresh", how="incremental",
                           files=len(added))
        else:
            view.full_recomputes += 1
            metrics.note_mview("full_recomputes")
            metrics.record("mview", phase="refresh", how="fallback")
        return batch

    def _merge_file_delta(self, view: MaterializedView, cached_batch,
                          added, run):
        """Aggregate the appended files only, then re-merge the delta's
        partials with the view's cached output through the MergeSpec's
        aggregate, on the cached batch's device."""
        from spark_tpu_torch.columnar.arrow import from_arrow, to_arrow

        delta_batch = run(self._delta_plan(view, added))
        old_tbl = to_arrow(cached_batch)
        delta_tbl = to_arrow(delta_batch)
        if delta_tbl.num_rows == 0:
            return cached_batch  # the appended files held no rows
        union = pa.concat_tables(
            [old_tbl, delta_tbl.select(old_tbl.column_names)])
        merge_plan = view.inspection.merge_spec.merge_plan(L.Relation(
            from_arrow(union, device=cached_batch.data.row_mask.device)))
        return run(merge_plan)

    def _delta_plan(self, view: MaterializedView, added
                    ) -> L.LogicalPlan:
        """The view's plan with its scan pointed at the appended files
        only: a fresh FileSource, so no cache of the original source
        serves the delta."""
        from spark_tpu_torch.io.datasource import FileSource

        scan = view.inspection.scan
        src = scan.source
        delta_src = FileSource(src.fmt, list(added), schema=src._schema,
                               options=dict(src.options))
        new_scan = dataclasses.replace(scan, source=delta_src)

        def fn(node):
            return new_scan if node is scan else node

        return view.plan.transform_up(fn)

    # -- stream views -----------------------------------------------------------

    def on_micro_batch(self, stream: str, batch_id: int,
                       delta_tbl: pa.Table) -> None:
        """A micro-batch of the query ``stream``, published before its
        WAL commit: merge its rows into every view on that query. Once
        per batch id: the WAL's replay after a commit crash delivers the
        same id, and it is dropped."""
        with self._lock:
            views = list(self._by_stream.get(stream, ()))
        for view in views:
            self._merge_stream_delta(view, batch_id, delta_tbl)

    def _merge_stream_delta(self, view: MaterializedView,
                            batch_id: int, delta_tbl: pa.Table) -> None:
        from spark_tpu_torch.columnar.arrow import from_arrow, to_arrow
        from spark_tpu_torch.streaming.execution import _splice

        dev = self._session.device
        with view.lock:
            if batch_id <= view.last_batch_id:
                metrics.note_mview("stream_dedups")
                metrics.record("mview", phase="dedup", view=view.name,
                               batch=batch_id)
                return

            def merge():
                faults.inject("mview.refresh", self._conf)
                delta_batch = self._run(_splice(view.plan, L.Relation(
                    from_arrow(delta_tbl, device=dev))))
                if view.state is None:
                    return delta_batch
                d_tbl = to_arrow(delta_batch)
                if d_tbl.num_rows == 0:
                    return view.state
                old_tbl = to_arrow(view.state)
                union = pa.concat_tables(
                    [old_tbl, d_tbl.select(old_tbl.column_names)])
                return self._run(view.inspection.merge_spec.merge_plan(
                    L.Relation(from_arrow(union, device=dev))))

            # fallback=None: past the retries it raises, failing the
            # batch before its WAL commit; the replay delivers the delta
            # again and the untouched last_batch_id takes it
            batch, _ = self._with_retries(merge, fallback=None)
            view.state = batch
            view.last_batch_id = batch_id
            view.refreshes += 1
            view.incremental_merges += 1
            store = getattr(self._session, "memory_store", None)
            if store is not None:
                # mirrored into the store for the byte accounting; the
                # view keeps its own reference, so an eviction costs
                # the bytes' visibility, never the state
                store.update(("mview", view.key), batch)
            metrics.note_mview("stream_merges")
            metrics.record("mview", phase="stream_merge",
                           view=view.name, batch=batch_id,
                           rows=delta_tbl.num_rows)
            self._repopulate_serve(view, batch)
            self._notify_invalidation(view)

    def read(self, name: str):
        """The state of stream view ``name`` now, as a DataFrame (a
        Relation over the state batch)."""
        view = self.stream_view(name)
        if view is None:
            raise KeyError(f"no stream view named {name!r}")
        with view.lock:
            state = view.state
        if state is None:
            raise ValueError(
                f"stream view {name!r} has no state yet (no "
                "micro-batch has committed)")
        from spark_tpu_torch.api.dataframe import DataFrame

        return DataFrame(self._session, L.Relation(state))

    # -- shared plumbing --------------------------------------------------------

    def _with_retries(self, fn, fallback):
        """``fn`` with bounded transient retries
        (spark.tpu.mview.refreshRetries): (result, True) from ``fn``, or
        (fallback(), False) past the retries or on a failure that is not
        transient; ``fallback=None`` raises instead."""
        from spark_tpu_torch import deadline

        try:
            retries = max(0, int(self._conf.get(CF.MVIEW_REFRESH_RETRIES)))
        except Exception:  # noqa: BLE001
            retries = 2
        last: Optional[BaseException] = None
        for attempt in range(retries + 1):
            try:
                return fn(), True
            except Exception as exc:  # noqa: BLE001 - classified below
                last = exc
                if (recovery.is_transient(exc) and attempt < retries
                        and not deadline.expired()
                        and recovery.retry_allowed("mview.refresh")):
                    metrics.note_mview("refresh_retries")
                    metrics.record("mview", phase="retry",
                                   error=type(exc).__name__,
                                   attempt=attempt + 1)
                    continue
                break
        if fallback is None:
            raise last
        metrics.note_mview("refresh_fallbacks")
        metrics.record("mview", phase="fallback",
                       error=type(last).__name__)
        metrics.record("fault_recovered", point="mview.refresh",
                       how="full_recompute")
        return fallback(), False

    def _run(self, plan: L.LogicalPlan):
        """The engine of stream-view delta and merge plans, the
        streaming runner's (the mesh when the session has one)."""
        ex = getattr(self._session, "mesh_executor", None)
        if ex is not None:
            return ex.execute_logical(plan)
        from spark_tpu_torch.physical.planner import execute_logical

        return execute_logical(plan, device=self._session.device,
                               conf=self._conf)

    def _repopulate_serve(self, view: MaterializedView, batch) -> None:
        """Put the refreshed result into the serve tier's result cache
        under the new fingerprint key, so the first request after the
        refresh hits. The bytes are what the connect server would send
        (``table_to_ipc`` of the same Arrow table)."""
        cache = getattr(self._session, "serve_result_cache", None)
        if cache is None or not cache.enabled():
            return
        try:
            if not bool(self._conf.get(CF.MVIEW_SERVE_REPOPULATE)):
                return
            from spark_tpu_torch.columnar.arrow import to_arrow
            from spark_tpu_torch.serve import result_cache as rc

            key = rc.plan_result_key(view.plan)
            cache.put(key, rc.table_to_ipc(to_arrow(batch)))
            metrics.note_mview("serve_repopulations")
            metrics.record("mview", phase="serve_repopulate",
                           key=rc.key_digest(key))
        except Exception as exc:  # noqa: BLE001 - best effort
            metrics.record("mview", phase="serve_repopulate_error",
                           error=type(exc).__name__)

    def _notify_invalidation(self, view: MaterializedView) -> None:
        """Append an ``mview_refresh`` record to the session's fleet
        invalidation log when a refresh commits: every subscribed
        replica's result cache drops the entries over the view's source
        paths. Only when a fleet attached a log (one replica keeps its
        path free of it)."""
        log = getattr(self._session, "serve_invalidation_log", None)
        if log is None:
            return
        try:
            scan = view.inspection.scan
            paths = getattr(getattr(scan, "source", None), "paths",
                            None) if scan is not None else None
            if paths:
                log.append("mview_refresh", paths)
        except Exception as exc:  # noqa: BLE001 - the fingerprint TTL
            # still bounds the staleness
            metrics.record("mview", phase="invalidate_error",
                           error=type(exc).__name__)

    def stats(self) -> dict:
        with self._lock:
            views = [v.to_dict() for v in self._views.values()]
        return {
            "views": len(views),
            "file_views": sum(1 for v in views if v["kind"] == "file"),
            "stream_views": sum(
                1 for v in views if v["kind"] == "stream"),
            "refreshes": sum(v["refreshes"] for v in views),
            "incremental_merges": sum(
                v["incremental_merges"] for v in views),
            "full_recomputes": sum(
                v["full_recomputes"] for v in views),
        }
