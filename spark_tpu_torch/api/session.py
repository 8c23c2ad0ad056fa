"""SparkSession for the port: the entry point a user calls.

``SparkSession.builder.device("cuda"|"cpu").config(key, value)
.getOrCreate()``, with ``.master("mesh[N]")`` (and ``.meshDevices([...])``
to list the ranks' devices) for a session whose queries run over a
mesh; ``createDataFrame`` from a ``pyarrow.Table``, a
``pandas.DataFrame`` or a list of dicts or tuples; ``read`` (Parquet,
CSV, JSON, ORC); ``range``; temp views; ``sql``; ``table``; ``conf``.
A session owns one ``UnifiedMemoryManager`` (``memory_manager``), the
``MemoryStore`` on it (``memory_store``) and the ``CacheManager`` of
``DataFrame.cache()`` over that store (``cache_manager``), with the
materialized views behind it (``mview_manager``), the streaming reader
(``readStream``) and, when a ``spark.tpu.compile.*`` feature is on, the
compile tier (``compile_service``).
The device defaults to ``"cuda"``; without a usable CUDA device the
session raises unless the caller asked for ``"cpu"``. Every relation the
session creates, and every file it reads, lives on its device.

A session also owns its ``extensions`` (``extensions.py``: optimizer
rules, functions, parser hooks and the ``spark.plugins`` plugins, which
``stop()`` shuts down; ``builder.withExtensions(fn)`` registers them),
and, with ``spark.ui.enabled``, the live status server (``ui.py``) at
``uiWebUrl``.
"""

from __future__ import annotations

import contextvars
import sys
from typing import Any, Dict, Iterable, List, Optional, Sequence, Union

import pyarrow as pa

# faults, recovery, the chunk pipeline, trace, deadline, extensions and
# ui register their settings at import
from spark_tpu_torch import deadline, faults, locks, recovery, trace, ui  # noqa: F401
from spark_tpu_torch.api.dataframe import DataFrame
from spark_tpu_torch.columnar.arrow import from_arrow
from spark_tpu_torch.columnar.batch import round_capacity
from spark_tpu_torch.conf import RuntimeConf
from spark_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from spark_tpu_torch.extensions import Extensions
from spark_tpu_torch.physical import pipeline  # noqa: F401
from spark_tpu_torch.plan import logical as L
from spark_tpu_torch.types import Schema


#: the session whose query runs, or whose SQL is parsed, in this context
#: (``DataFrame._execute`` and ``SparkSession.sql`` set it): the file
#: scan promotes hot reads into its store, and injected functions and
#: rules, fault points and trace sampling resolve against it
_EXECUTING: contextvars.ContextVar[Optional["SparkSession"]] = \
    contextvars.ContextVar("spark_tpu_torch_executing", default=None)


def executing_session() -> Optional["SparkSession"]:
    """The session whose query runs in this context, or None."""
    return _EXECUTING.get()


class CacheManager:
    """Lazy plan cache (reference: CacheManager.scala and
    InMemoryRelation; the port of ``spark_tpu/api/session.py``'s):
    ``cache()`` registers a logical plan; its first use materializes it
    into a device batch held in the session's MemoryStore, and every
    later query whose tree contains the plan reads the stored batch.
    Identity is ``structural_key()``: the plan's structure and the
    identity of its leaf batches and sources.

    The batches live in the byte-accounted store, so they are evictable:
    an execution grant or storage pressure may drop an unpinned entry,
    and the next query that needs it materializes it again (the
    registration survives; only the bytes go). ``drop``/``clear``
    remove the store entry too, releasing its bytes at once.

    Thread-safe: the registry changes under a lock, and each entry
    materializes under its own lock (single-flight: two queries meeting
    the same cold plan materialize it once), without the registry lock,
    so unrelated queries proceed. With ``spark.tpu.mview.enabled`` a
    cached aggregate over a file scan is a materialized view
    (``mview/``): its materialization goes to the session's
    ``ViewManager`` (``_mview``), which refreshes it when the files
    change."""

    def __init__(self, store):
        self._store = store
        # key -> [plan, entry lock]
        self._entries: Dict[Any, list] = {}
        self._lock = locks.named_lock("session.cache.registry")
        #: materializations run (a store hit is not one)
        self.materializations = 0
        #: the session's materialized-view manager; a cached key that is
        #: a registered view materializes through its freshness check
        self._mview = None

    @staticmethod
    def _key(plan: L.LogicalPlan):
        return plan.structural_key()

    @staticmethod
    def _skey(key):
        # apart from the auto-cached scans, which share the store
        return ("cache", key)

    def add(self, plan: L.LogicalPlan) -> None:
        with self._lock:
            self._entries.setdefault(self._key(plan),
                                     [plan, locks.named_lock(
                                         "session.cache.entry")])
        if self._mview is not None:
            self._mview.maybe_register(plan)

    def drop(self, plan: L.LogicalPlan) -> bool:
        key = self._key(plan)
        with self._lock:
            entry = self._entries.pop(key, None)
        if entry is None:
            return False
        if self._mview is not None:
            self._mview.unregister(key)
        self._store.remove(self._skey(key))  # releases the bytes
        return True

    def clear(self) -> None:
        with self._lock:
            keys = list(self._entries)
            self._entries.clear()
        if self._mview is not None:
            self._mview.clear_file_views()
        for key in keys:
            self._store.remove(self._skey(key))

    def is_cached(self, plan: L.LogicalPlan) -> bool:
        with self._lock:
            return self._key(plan) in self._entries

    def apply(self, plan: L.LogicalPlan, run) -> L.LogicalPlan:
        """``plan`` with its cached subtrees replaced by their batches,
        the largest first (top-down, as the reference's CacheManager
        matches the outermost plans first)."""
        with self._lock:
            if not self._entries:
                return plan

        def go(node: L.LogicalPlan) -> L.LogicalPlan:
            with self._lock:
                entry = self._entries.get(self._key(node))
            if entry is not None:
                return L.Relation(self._materialize(node, entry, run))
            children = tuple(go(c) for c in node.children())
            return node.with_children(children) if children else node

        return go(plan)

    def _materialize(self, node: L.LogicalPlan, entry: list, run):
        """A store hit, or a single-flight materialization; either is
        pinned for the enclosing query's ``pin_scope``."""
        key = self._key(node)
        skey = self._skey(key)
        if self._mview is not None:
            view = self._mview.view_for(key)
            if view is not None:
                # a registered view: the manager checks the source's
                # fingerprint and refreshes in place before serving
                return self._mview.materialize(view, entry[1], run,
                                               self._store, skey)
        batch = self._store.get(skey, pin=True)
        if batch is not None:
            return batch
        with entry[1]:
            batch = self._store.get(skey, pin=True)
            if batch is not None:
                return batch
            batch = run(entry[0])
            # a rejected put still serves this query its batch; the entry
            # stays recomputable
            self._store.put(skey, batch, pin=True)
        # the registry lock ranks outside the entry lock: count after it
        with self._lock:
            self.materializations += 1
        return batch


class Catalog:
    """Temp views and persistent tables (reference:
    sql/catalyst/.../catalog/SessionCatalog.scala:61). A table written by
    ``df.write.saveAsTable`` lives as
    ``<spark.sql.warehouse.dir>/<name>/{_table.json,data/}`` and any
    session pointing at that warehouse reads it back; the layout is the
    reference's."""

    def __init__(self, session: Optional["SparkSession"] = None):
        self._session = session
        self._views: Dict[str, L.LogicalPlan] = {}

    def _register_view(self, name: str, plan: L.LogicalPlan) -> None:
        self._views[name.lower()] = plan

    def lookup(self, name: str) -> L.LogicalPlan:
        key = name.lower()
        plan = self._views.get(key)
        if plan is None:
            plan = self._load_persistent(key)
        if plan is None:
            raise KeyError(f"table or view not found: {name}")
        return plan

    def _warehouse(self) -> Optional[str]:
        if self._session is None:
            return None
        from spark_tpu_torch import conf as CF

        return self._session.conf.get(CF.WAREHOUSE_DIR)

    def _load_persistent(self, key: str) -> Optional[L.LogicalPlan]:
        """The saveAsTable tier: a scan of ``<warehouse>/<key>/data`` in
        the format ``_table.json`` names, memoized for the session."""
        import json
        import os

        wh = self._warehouse()
        meta_path = None if wh is None else os.path.join(wh, key,
                                                         "_table.json")
        if meta_path is None or not os.path.exists(meta_path):
            return None
        with open(meta_path) as f:
            meta = json.load(f)
        from spark_tpu_torch.io.datasource import FileSource

        options = dict(meta.get("options") or {})
        if meta.get("partition_by"):
            options["partitioning"] = "hive"
        src = FileSource(meta.get("format", "parquet"),
                         [os.path.join(wh, key, "data")], options=options)
        plan = L.UnresolvedScan(src)
        self._views[key] = plan
        return plan

    def refresh_persistent(self, key: str) -> None:
        """Forget the memoized plan: the next lookup reads the table as
        it is now on disk."""
        self._views.pop(key, None)

    def listTables(self) -> List[str]:
        import os

        names = set(self._views)
        wh = self._warehouse()
        if wh is not None and os.path.isdir(wh):
            names |= {d for d in os.listdir(wh)
                      if os.path.exists(os.path.join(wh, d, "_table.json"))}
        return sorted(names)

    def dropTempView(self, name: str) -> bool:
        return self._views.pop(name.lower(), None) is not None

    def tableExists(self, name: str) -> bool:
        return name.lower() in self._views


class SparkSessionBuilder:
    def __init__(self):
        self._device = DEFAULT_DEVICE
        self._conf: Dict[str, Any] = {}
        self._mesh_devices: Optional[List[str]] = None
        self._ext_fns: list = []
        self._app_name = "spark-tpu-torch"

    def appName(self, name: str) -> "SparkSessionBuilder":
        """The name of the session this builder creates (an existing
        active session keeps its own, as in the reference)."""
        self._app_name = name
        return self

    def withExtensions(self, fn) -> "SparkSessionBuilder":
        """``fn(extensions)`` registers injection points on the session
        this builder returns (reference:
        SparkSession.Builder.withExtensions)."""
        self._ext_fns.append(fn)
        return self

    def device(self, name) -> "SparkSessionBuilder":
        """``"cuda"`` (the default) or ``"cpu"``."""
        self._device = name
        return self

    def master(self, url: str) -> "SparkSessionBuilder":
        """The master URL (reference: SparkContext's master parsing):
        ``local``, ``local[*]`` or ``local[N]`` run on the session's one
        device; ``mesh[N]`` (``mesh[*]``: every CUDA device) runs every
        query over an N-rank mesh (``parallel/executor.py``). Under an
        initialized process group of several processes
        (``parallel/multihost.initialize``), ``mesh[*]`` is the mesh over
        them: with ``meshDevices`` listing world size * k devices, k
        ranks a process (process p's on its k entries of the list,
        threads of that process); without, one rank a process, on its
        process's device (the session's: ``cpu``, or the process's own
        card)."""
        from spark_tpu_torch import conf as CF

        if url.startswith("mesh"):
            n = -1
            if "[" in url:
                inner = url[url.index("[") + 1:url.index("]")]
                n = -1 if inner == "*" else int(inner)
            self._conf[CF.MESH_DEVICES.key] = n
        elif url.startswith("local"):
            self._conf[CF.MESH_DEVICES.key] = None
        else:
            raise ValueError(f"unsupported master URL {url!r}: use "
                             "local, local[*] or mesh[N]")
        return self

    def meshDevices(self, devices) -> "SparkSessionBuilder":
        """The mesh's devices, one per rank (``["cuda:0"] * 4``, ``["cpu"]
        * 8``); a device may repeat only when listed here. Under a process
        group, ``mesh[*]`` over the whole world's devices, process-major
        (world size * k: k ranks a process)."""
        self._mesh_devices = [str(d) for d in devices]
        return self

    def config(self, key: str, value: Any) -> "SparkSessionBuilder":
        self._conf[key] = value
        return self

    def getOrCreate(self) -> "SparkSession":
        """The active session when it runs on the requested device and
        mesh, with this builder's settings applied to it; else a new
        session with them, which becomes the active one."""
        from spark_tpu_torch import conf as CF

        dev = resolve_device(self._device)
        active = SparkSession._active
        n = self._conf.get(CF.MESH_DEVICES.key,
                           None if active is None
                           else active.conf.get(CF.MESH_DEVICES))
        if active is None or active.device != dev \
                or active._mesh_spec != (n, self._mesh_devices):
            active = SparkSession(dev, self._conf, self._mesh_devices)
            active.app_name = self._app_name
            SparkSession._active = active
        else:
            for key, value in self._conf.items():
                active.conf.set(key, value)
        for fn in self._ext_fns:
            fn(active.extensions)
        self._ext_fns = []
        return active


def _is_pandas(data) -> bool:
    """Whether ``data`` is a pandas DataFrame, without importing pandas
    (a machine may lack it; then no caller can hold one)."""
    pd = sys.modules.get("pandas")
    return pd is not None and isinstance(data, pd.DataFrame)


class SparkSession:
    _active: Optional["SparkSession"] = None

    def __init__(self, device=DEFAULT_DEVICE,
                 conf: Optional[Dict[str, Any]] = None,
                 mesh_devices: Optional[Sequence] = None):
        from spark_tpu_torch import conf as CF
        from spark_tpu_torch.storage import MemoryStore, UnifiedMemoryManager

        self.device = resolve_device(device)
        self.conf = RuntimeConf(conf)
        n = self.conf.get(CF.MESH_DEVICES)
        self._mesh_spec = (n, None if mesh_devices is None
                           else [str(d) for d in mesh_devices])
        self._mesh = None
        self._mesh_executor = None
        if n is not None:
            from spark_tpu_torch.parallel import multihost
            from spark_tpu_torch.parallel.mesh import make_mesh

            if n == -1 and multihost.process_info()["process_count"] > 1:
                # the mesh over the initialized process group: k ranks a
                # process over the listed world's devices, else one
                self._mesh = multihost.global_mesh(mesh_devices,
                                                   device=self.device)
            else:
                self._mesh = make_mesh(None if n == -1 else int(n),
                                       devices=mesh_devices)
        # runtime lock-order validation (spark.tpu.debug.lockOrder)
        locks.configure(self.conf)
        self.catalog = Catalog(self)
        # storage and execution share one device byte budget
        self.memory_manager = UnifiedMemoryManager(conf=self.conf)
        self.memory_store = MemoryStore(self.memory_manager)
        self.cache_manager = CacheManager(store=self.memory_store)
        # materialized views ride on the plan cache (mview/)
        from spark_tpu_torch.mview import ViewManager

        self.mview_manager = ViewManager(self)
        self.cache_manager._mview = self.mview_manager
        self.extensions = Extensions()
        self.app_name = "spark-tpu-torch"
        #: the serving tier's attachments: the connect server's
        #: ``QueryScheduler`` (the UI reads it), a ``HeartbeatMonitor``
        #: for ``/health``, the result cache the in-process replicas
        #: share and the fleet's invalidation log (``serve/``)
        self.query_scheduler = None
        self.heartbeat_monitor = None
        self.serve_result_cache = None
        self.serve_invalidation_log = None
        self._stopped = False
        # the live status server (reference: SparkUI.scala:40), gated on
        # spark.ui.enabled
        self._ui = ui.maybe_start(self)
        # last: a plugin's init(session) may use any of the session
        self.extensions.load_plugins(self)

    class _BuilderDescriptor:
        def __get__(self, obj, cls):
            return SparkSessionBuilder()

    builder = _BuilderDescriptor()

    @classmethod
    def getActiveSession(cls) -> Optional["SparkSession"]:
        return cls._active

    @classmethod
    def setActiveSession(cls, session: "SparkSession") -> None:
        """Reference: SparkSession.setActiveSession."""
        cls._active = session

    @property
    def uiWebUrl(self) -> Optional[str]:
        """The live status server's URL with ``spark.ui.enabled``, else
        None (reference: SparkContext.uiWebUrl)."""
        return self._ui.url if self._ui is not None else None

    ui_web_url = uiWebUrl

    @property
    def version(self) -> str:
        """The package's ``__version__``."""
        from spark_tpu_torch import __version__

        return __version__

    @property
    def compile_service(self):
        """The compile tier (``compile/``) when a ``spark.tpu.compile.*``
        feature is on (the store, background capture, the history),
        else None; resolved at each access, so a change of the settings
        takes effect at once."""
        from spark_tpu_torch.compile import maybe_service

        return maybe_service(self)

    @property
    def readStream(self):
        """A ``DataStreamReader`` (``streaming/readwriter.py``)."""
        from spark_tpu_torch.streaming.readwriter import DataStreamReader

        return DataStreamReader(self)

    def stop(self) -> None:
        """Stop the session's services (the compile tier's background
        jobs, the query scheduler's workers, a heartbeat monitor, the
        status server) and shut the plugins down; the session stops
        being the active one."""
        self._stopped = True
        svc = self.__dict__.pop("_compile_service", None)
        if svc is not None:
            svc.stop()
        sched = self.query_scheduler
        if sched is not None:
            sched.stop()
            self.query_scheduler = None
        hb = self.heartbeat_monitor
        if hb is not None:
            hb.stop()
            self.heartbeat_monitor = None
        if self._ui is not None:
            self._ui.stop()
            self._ui = None
        self.extensions.shutdown_plugins()
        if SparkSession._active is self:
            SparkSession._active = None

    @property
    def mesh_executor(self):
        """The mesh executor under a ``mesh[N]`` master, else None."""
        if self._mesh is None:
            return None
        if self._mesh_executor is None:
            from spark_tpu_torch.parallel.executor import MeshExecutor

            self._mesh_executor = MeshExecutor(self._mesh, conf=self.conf)
        return self._mesh_executor

    @property
    def sparkContext(self):
        """RDD-tier entry point (``rdd.py``; reference:
        SparkContext.scala:85)."""
        if getattr(self, "_sc", None) is None:
            from spark_tpu_torch.rdd import SparkContext

            self._sc = SparkContext(self)
        return self._sc

    @property
    def read(self):
        from spark_tpu_torch.io.readwriter import DataFrameReader

        return DataFrameReader(self)

    def table(self, name: str) -> DataFrame:
        return DataFrame(self, self.catalog.lookup(name))

    def range(self, start: int, end: Optional[int] = None,
              step: int = 1) -> DataFrame:
        """One int64 column ``id``: start, start + step, ... below end
        (``range(n)`` is 0 .. n-1), made on the session's device."""
        if end is None:
            start, end = 0, start
        return DataFrame(self, L.Range(int(start), int(end), int(step)))

    def sql(self, query: str) -> DataFrame:
        from spark_tpu_torch.sql.parser import parse_sql

        token = _EXECUTING.set(self)
        try:
            # injected parser hooks first (reference: injectParser:318)
            plan = self.extensions.parse(query, self.catalog, parse_sql)
        finally:
            _EXECUTING.reset(token)
        df = DataFrame(self, plan)
        # the compile tier's history replays SQL text: the identity of
        # this plan in another process
        df._sql_text = query
        return df

    def createDataFrame(
        self,
        data: Union[pa.Table, Iterable],
        schema: Optional[Union[Schema, Sequence[str]]] = None,
    ) -> DataFrame:
        """A DataFrame over ``data``: a pyarrow Table, a pandas DataFrame,
        or rows as dicts (named by the first row's keys) or tuples (named
        by ``schema``). Names in ``schema`` rename the columns."""
        if isinstance(data, pa.Table):
            table = data
        elif _is_pandas(data):
            table = pa.Table.from_pandas(data, preserve_index=False)
        else:
            rows = list(data)
            if not rows:
                raise ValueError("cannot create DataFrame from empty data "
                                 "without an explicit arrow/pandas input")
            if isinstance(rows[0], dict):
                names = list(rows[0].keys())
                cols = {n: [r[n] for r in rows] for n in names}
            else:
                if schema is None:
                    raise ValueError("tuple rows require column names")
                names = (list(schema.names) if isinstance(schema, Schema)
                         else list(schema))
                cols = {n: [r[i] for r in rows] for i, n in enumerate(names)}
            table = pa.table(cols)
        batch = from_arrow(table, capacity=round_capacity(table.num_rows),
                           device=self.device)
        df = DataFrame(self, L.Relation(batch))
        if schema is not None and not isinstance(schema, (Schema, str)):
            new = list(schema)
            if new != df.columns and len(new) == len(df.columns):
                for old, name in zip(df.columns, new):
                    df = df.withColumnRenamed(old, name)
        return df

    def __repr__(self):
        mesh = "" if self._mesh is None else f", mesh={self._mesh}"
        return f"SparkSession(device={self.device}{mesh})"
