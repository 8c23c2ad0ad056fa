"""Tree-wide static concurrency analysis (the port of
``spark_tpu/analysis/concurrency.py``).

AST pass over the whole package that cross-checks the code against the
lock-hierarchy registry (``spark_tpu_torch/locks.py`` — the same table the
runtime validator behind ``spark.tpu.debug.lockOrder`` checks):

- **lock-acquisition graph** — which locks each function acquires,
  directly (``with self._lock:``) and transitively through calls it
  makes while holding one.  Edges that invert the registered ranks, or
  cycles among unranked locks, are ``CONC-ORDER-CYCLE``.
- **shared-state discipline** — module-level ``_NAME`` and
  ``self._attr`` state that is mutated under a lock anywhere must be
  mutated under a lock everywhere (``CONC-UNLOCKED-MUT``); ``__init__``
  and ``*_locked``-suffixed functions are locked-by-convention.
- **blocking under a lock** — queue put/get, HTTP, file IO,
  subprocess, ``time.sleep``, a device sync (``block_until_ready``,
  ``synchronize``), ``Thread.join``,
  ``Event.wait`` while any lock is held is ``CONC-BLOCKING-HELD``.
- **condition discipline** — ``Condition.wait`` not wrapped in a
  predicate loop is ``CONC-WAIT-NOLOOP`` (wakeups may be spurious).

Interprocedural resolution is name-based and deliberately
conservative: a call resolves only when exactly one function of that
name exists in the analyzed tree; ambiguous names (``get``, ``stop``,
…) contribute no edges.  Nested functions and lambdas are analyzed as
separate entry points (they run later, not at their definition site).

Findings are typed :class:`Diagnostic` s with ``node = "path:line"``.
``lint_package()`` runs the analysis over ``spark_tpu_torch`` itself
against this package's ``locks.LOCK_RANKS`` (``tools/lint_concurrency.py``
scans the reference package with its own table).
"""

from __future__ import annotations

import ast
import builtins
from typing import Dict, List, Optional, Sequence, Set, Tuple

from spark_tpu_torch.analysis.diagnostics import Diagnostic
from spark_tpu_torch.locks import LOCK_RANKS

#: constructor call suffixes -> lock kind
_LOCK_CTORS = {
    "Lock": "lock",
    "RLock": "rlock",
    "Condition": "condition",
}
_NAMED_FACTORIES = {
    "named_lock": "lock",
    "named_rlock": "rlock",
    "named_condition": "condition",
}
#: attribute-chain roots whose calls block on IO
_BLOCKING_ROOTS = {"subprocess", "requests", "urllib", "socket",
                   "shutil"}
#: os.<fn> calls that hit the filesystem
_BLOCKING_OS = {"makedirs", "replace", "rename", "remove", "unlink",
                "rmdir"}
#: dict/list/deque/set mutator method names (mirrors
#: the reference's tools/lint_invariants rule 4)
_MUTATORS = ("append", "appendleft", "pop", "popleft", "clear",
             "update", "extend", "setdefault", "insert", "remove",
             "add", "discard")
#: callee names never resolved interprocedurally: builtin-shadowing
#: names are ubiquitous on foreign objects (``all(...)``,
#: ``mask.all()`` on an ndarray), so a tree method that happens to be
#: uniquely named ``all`` would be misresolved at every such call
#: site. Cost: edges through legitimately-named methods (e.g.
#: ``pools.all()``) are not seen statically — the runtime validator
#: still observes them.
_PY_BUILTINS = frozenset(dir(builtins))


def _dotted(expr: ast.AST) -> Optional[str]:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(expr, ast.Attribute):
        parts.append(expr.attr)
        expr = expr.value
    if isinstance(expr, ast.Name):
        parts.append(expr.id)
        return ".".join(reversed(parts))
    return None


def _ctor_of(value: ast.AST) -> Optional[Tuple[str, Optional[str]]]:
    """(kind, registry_name) when ``value`` constructs a lock:
    ``locks.named_*("name")`` / ``threading.Lock()`` / bare
    ``Lock()``.  registry_name is None for anonymous constructions."""
    if not isinstance(value, ast.Call):
        return None
    fn = _dotted(value.func)
    if fn is None:
        return None
    tail = fn.rsplit(".", 1)[-1]
    if tail in _NAMED_FACTORIES:
        name = None
        if value.args and isinstance(value.args[0], ast.Constant) \
                and isinstance(value.args[0].value, str):
            name = value.args[0].value
        return (_NAMED_FACTORIES[tail], name)
    if tail in _LOCK_CTORS and (fn == tail
                                or fn == f"threading.{tail}"):
        return (_LOCK_CTORS[tail], None)
    return None


def _looks_like_lock(name: str) -> bool:
    low = name.lower()
    return ("lock" in low or "mutex" in low
            or low.endswith("_cond") or low == "cond")


class _Binding:
    """One lock the analyzer knows about."""

    __slots__ = ("name", "kind", "anonymous")

    def __init__(self, name: str, kind: str, anonymous: bool):
        self.name = name        # registry name, or "<rel>::<var>"
        self.kind = kind        # lock | rlock | condition | unknown
        self.anonymous = anonymous


class _Call:
    __slots__ = ("held", "callee", "line")

    def __init__(self, held: Tuple[str, ...], callee: str, line: int):
        self.held = held
        self.callee = callee
        self.line = line


class _Mutation:
    __slots__ = ("held", "line", "func", "in_init", "by_convention")

    def __init__(self, held: Tuple[str, ...], line: int, func: str,
                 in_init: bool, by_convention: bool):
        self.held = held
        self.line = line
        self.func = func
        self.in_init = in_init
        self.by_convention = by_convention


class _Blocking:
    __slots__ = ("held", "line", "func", "what")

    def __init__(self, held: Tuple[str, ...], line: int, func: str,
                 what: str):
        self.held = held
        self.line = line
        self.func = func
        self.what = what


class _FuncInfo:
    """Per-function summary used by the interprocedural pass."""

    def __init__(self, rel: str, qualname: str):
        self.rel = rel
        self.qualname = qualname
        self.acquires: Set[str] = set()        # directly acquired
        self.acquire_lines: Dict[str, int] = {}
        self.calls: List[_Call] = []
        self.effective: Set[str] = set()       # filled by fixpoint


class _ModuleScan(ast.NodeVisitor):
    """First pass over one module: lock bindings (module vars, class
    attrs, function locals), condition/queue/thread/event typed names,
    and `_`-prefixed module state."""

    def __init__(self, rel: str, aliases: Dict[str, str]):
        self.rel = rel
        self.aliases = aliases
        #: var or Class.attr -> _Binding
        self.locks: Dict[str, _Binding] = {}
        self.queues: Set[str] = set()
        self.threads: Set[str] = set()
        self.events: Set[str] = set()
        self.module_state: Set[str] = set()
        self._class: Optional[str] = None
        self._fdepth = 0

    def _bind(self, key: str, kind: str, reg_name: Optional[str]):
        alias = self.aliases.get(f"{self.rel}::{key}")
        if alias is not None:
            self.locks[key] = _Binding(alias, kind, False)
        elif reg_name is not None:
            self.locks[key] = _Binding(reg_name, kind, False)
        else:
            self.locks[key] = _Binding(f"{self.rel}::{key}", kind, True)

    def _scan_assign(self, target: ast.AST, value: ast.AST) -> None:
        key: Optional[str] = None
        if isinstance(target, ast.Name):
            if self._fdepth > 0:
                return  # function locals are _FunctionWalk's business
            key = target.id
            if self._class is not None:
                key = f"{self._class}.{key}"
        elif (isinstance(target, ast.Attribute)
              and isinstance(target.value, ast.Name)
              and target.value.id == "self" and self._class is not None):
            key = f"{self._class}.{target.attr}"
        if key is None:
            return
        ctor = _ctor_of(value)
        if ctor is not None:
            self._bind(key, ctor[0], ctor[1])
            return
        if isinstance(value, ast.Call):
            fn = _dotted(value.func) or ""
            tail = fn.rsplit(".", 1)[-1]
            if tail == "Queue":
                self.queues.add(key)
            elif tail == "Thread":
                self.threads.add(key)
            elif tail == "Event":
                self.events.add(key)
        # aliasing through config even without a recognized ctor
        # (e.g. MemoryStore._lock = manager.lock)
        if key not in self.locks \
                and f"{self.rel}::{key}" in self.aliases:
            self._bind(key, "unknown", None)

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        prev, self._class = self._class, node.name
        self.generic_visit(node)
        self._class = prev

    def visit_FunctionDef(self, node) -> None:
        self._fdepth += 1
        self.generic_visit(node)
        self._fdepth -= 1

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._scan_assign(t, node.value)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._scan_assign(node.target, node.value)
        self.generic_visit(node)

    def scan_module_state(self, tree: ast.Module) -> None:
        for stmt in tree.body:
            targets = []
            if isinstance(stmt, ast.Assign):
                targets = stmt.targets
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                targets = [stmt.target]
            for t in targets:
                if not (isinstance(t, ast.Name)
                        and t.id.startswith("_")
                        and not t.id.startswith("__")):
                    continue
                if t.id in self.locks or _looks_like_lock(t.id):
                    continue
                self.module_state.add(t.id)


class _FunctionWalk(ast.NodeVisitor):
    """Second pass: walk one function with a held-lock stack."""

    def __init__(self, analyzer: "_TreeAnalyzer", scan: _ModuleScan,
                 qualname: str, in_class: Optional[str]):
        self.a = analyzer
        self.scan = scan
        self.qualname = qualname
        self.in_class = in_class
        self.rel = scan.rel
        self.held: List[str] = []
        self.while_depth = 0
        self.local_locks: Dict[str, _Binding] = {}
        self.info = _FuncInfo(scan.rel, qualname)
        fname = qualname.rsplit(".", 1)[-1]
        self.in_init = fname == "__init__"
        self.by_convention = fname.endswith("_locked")

    # -- resolution ----------------------------------------------------------

    def _resolve_lock(self, expr: ast.AST) -> Optional[_Binding]:
        if isinstance(expr, ast.Name):
            b = self.local_locks.get(expr.id)
            if b is not None:
                return b
            b = self.scan.locks.get(expr.id)
            if b is not None:
                return b
            if self.in_class is not None:
                b = self.scan.locks.get(f"{self.in_class}.{expr.id}")
                if b is not None:
                    return b
            if _looks_like_lock(expr.id):
                alias = self.scan.aliases.get(f"{self.rel}::{expr.id}")
                if alias is not None:
                    return _Binding(alias, "unknown", False)
                return _Binding(f"{self.rel}::{expr.id}", "unknown",
                                True)
            return None
        if isinstance(expr, ast.Attribute):
            if isinstance(expr.value, ast.Name) \
                    and expr.value.id == "self" \
                    and self.in_class is not None:
                b = self.scan.locks.get(f"{self.in_class}.{expr.attr}")
                if b is not None:
                    return b
            dotted = _dotted(expr)
            if dotted is not None and _looks_like_lock(expr.attr):
                alias = self.scan.aliases.get(f"{self.rel}::{dotted}")
                if alias is not None:
                    return _Binding(alias, "unknown", False)
                return _Binding(f"{self.rel}::{dotted}", "unknown",
                                True)
        return None

    def _receiver_is(self, expr: ast.AST, names: Set[str]) -> bool:
        """Does the call receiver resolve to one of the typed names
        collected by the module scan (queues/threads/events)?"""
        if isinstance(expr, ast.Name):
            if expr.id in names:
                return True
            return self.in_class is not None \
                and f"{self.in_class}.{expr.id}" in names
        if isinstance(expr, ast.Attribute) \
                and isinstance(expr.value, ast.Name) \
                and expr.value.id == "self" and self.in_class is not None:
            return f"{self.in_class}.{expr.attr}" in names
        return False

    def _is_condition(self, expr: ast.AST) -> bool:
        b = self._resolve_lock(expr)
        if b is not None and b.kind == "condition":
            return True
        tail = expr.attr if isinstance(expr, ast.Attribute) else (
            expr.id if isinstance(expr, ast.Name) else "")
        return "cond" in tail.lower()

    # -- state mutation ------------------------------------------------------

    def _note_mutation(self, key: Optional[str], line: int) -> None:
        if key is None:
            return
        self.a.mutations.setdefault((self.rel, key), []).append(
            _Mutation(tuple(self.held), line, self.qualname,
                      self.in_init, self.by_convention))

    def _state_key(self, target: ast.AST) -> Optional[str]:
        if isinstance(target, ast.Name):
            if target.id in self.scan.module_state \
                    and (target.id in self.declared_global
                         or target.id not in self.local_names):
                return target.id
            return None
        if isinstance(target, ast.Attribute) \
                and isinstance(target.value, ast.Name) \
                and target.value.id == "self" \
                and self.in_class is not None \
                and target.attr.startswith("_") \
                and not target.attr.startswith("__"):
            key = f"{self.in_class}.{target.attr}"
            if key in self.scan.locks:
                return None
            return key
        return None

    # -- visitor -------------------------------------------------------------

    def run(self, node: ast.AST) -> _FuncInfo:
        self.local_names: Set[str] = set()
        self.declared_global: Set[str] = set()
        body = getattr(node, "body", [])
        args = getattr(node, "args", None)
        if args is not None:
            for a in (args.posonlyargs + args.args + args.kwonlyargs):
                self.local_names.add(a.arg)
        for stmt in body if isinstance(body, list) else [body]:
            self.visit(stmt)
        return self.info

    def visit_FunctionDef(self, node) -> None:
        self.a.walk_function(self.scan, node,
                             f"{self.qualname}.{node.name}",
                             self.in_class)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node: ast.Lambda) -> None:
        pass  # runs later, not at definition site

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        pass  # nested classes: out of scope

    def visit_While(self, node: ast.While) -> None:
        self.while_depth += 1
        self.generic_visit(node)
        self.while_depth -= 1

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            if isinstance(t, ast.Name):
                # rebinding a module _NAME requires `global` (plain
                # assignment makes a local, which is not a mutation of
                # the module state)
                if t.id in self.declared_global:
                    self._note_mutation(self._state_key(t), node.lineno)
                else:
                    self.local_names.add(t.id)
                # local lock constructions (with state_lock: ... later)
                ctor = _ctor_of(node.value)
                if ctor is not None:
                    kind, reg = ctor
                    name = reg if reg is not None \
                        else f"{self.rel}::{self.qualname}.{t.id}"
                    self.local_locks[t.id] = _Binding(
                        name, kind, reg is None)
            elif isinstance(t, ast.Subscript):
                self._note_mutation(self._state_key(t.value),
                                    node.lineno)
            else:
                self._note_mutation(self._state_key(t), node.lineno)
        self.generic_visit(node.value)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        t = node.target
        if isinstance(t, ast.Name) and t.id not in self.declared_global:
            pass  # augments a local (or is a SyntaxError anyway)
        elif isinstance(t, ast.Subscript):
            self._note_mutation(self._state_key(t.value), node.lineno)
        else:
            self._note_mutation(self._state_key(t), node.lineno)
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete) -> None:
        for t in node.targets:
            inner = t.value if isinstance(t, ast.Subscript) else t
            self._note_mutation(self._state_key(inner), node.lineno)
        self.generic_visit(node)

    def visit_Global(self, node: ast.Global) -> None:
        for n in node.names:
            self.declared_global.add(n)
            self.local_names.discard(n)

    def visit_With(self, node: ast.With) -> None:
        acquired: List[str] = []
        for item in node.items:
            b = self._resolve_lock(item.context_expr)
            if b is None:
                continue
            acquired.append(b.name)
            for h in self.held:
                self.a.note_edge(h, b.name, self.rel, node.lineno,
                                 f"{self.qualname}")
            if b.name not in self.info.acquires:
                self.info.acquires.add(b.name)
                self.info.acquire_lines[b.name] = node.lineno
            # evaluate the context expressions themselves
            self.visit(item.context_expr)
        self.held.extend(acquired)
        for stmt in node.body:
            self.visit(stmt)
        for _ in acquired:
            self.held.pop()

    visit_AsyncWith = visit_With

    def visit_Subscript(self, node: ast.Subscript) -> None:
        # _TABLE[key] = v / del _TABLE[key] are handled by Assign/
        # Delete; loads need no tracking
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        line = node.lineno
        held = tuple(self.held)
        fn = node.func
        dotted = _dotted(fn) or ""
        tail = dotted.rsplit(".", 1)[-1]
        root = dotted.split(".", 1)[0] if dotted else ""

        # ---- blocking-call rule -------------------------------------
        if held:
            what = None
            if isinstance(fn, ast.Name) and fn.id == "open":
                what = "open()"
            elif root in _BLOCKING_ROOTS:
                what = f"{dotted}()"
            elif dotted == "time.sleep":
                what = "time.sleep()"
            elif tail in ("block_until_ready", "synchronize"):
                # a device sync (the reference's block_until_ready; the
                # port's torch.cuda / stream / event synchronize)
                what = f".{tail}()"
            elif isinstance(fn, ast.Attribute):
                recv = fn.value
                if root == "os" and tail in _BLOCKING_OS:
                    what = f"os.{tail}()"
                elif tail in ("put", "get") \
                        and self._receiver_is(recv, self.scan.queues):
                    what = f"Queue.{tail}()"
                elif tail == "join" \
                        and self._receiver_is(recv, self.scan.threads):
                    what = "Thread.join()"
                elif tail == "wait" \
                        and self._receiver_is(recv, self.scan.events):
                    what = "Event.wait()"
            if what is not None:
                self.a.blocking.append(_Blocking(
                    held, line, f"{self.rel}::{self.qualname}", what))

        # ---- condition-wait rule ------------------------------------
        if tail == "wait" and isinstance(fn, ast.Attribute) \
                and self._is_condition(fn.value) \
                and self.while_depth == 0:
            self.a.bare_waits.append((self.rel, line, self.qualname))

        # ---- mutator-method state mutations -------------------------
        if tail in _MUTATORS and isinstance(fn, ast.Attribute):
            self._note_mutation(self._state_key(fn.value), line)

        # ---- interprocedural call edge ------------------------------
        if tail and tail not in _MUTATORS \
                and tail not in _PY_BUILTINS:
            self.info.calls.append(_Call(held, tail, line))

        # acquire()/release() style usage of known locks is out of
        # scope for edges (the tree uses `with`); still record calls
        self.generic_visit(node)


class _TreeAnalyzer:
    """Whole-tree analysis over {relpath: source}."""

    def __init__(self, sources: Dict[str, str],
                 aliases: Optional[Dict[str, str]] = None):
        self.sources = sources
        self.aliases = dict(aliases or {})
        #: (outer, inner) -> (rel, line, func) of first sighting
        self.edges: Dict[Tuple[str, str], Tuple[str, int, str]] = {}
        self.mutations: Dict[Tuple[str, str], List[_Mutation]] = {}
        self.blocking: List[_Blocking] = []
        self.bare_waits: List[Tuple[str, int, str]] = []
        self.functions: List[_FuncInfo] = []
        #: lock name -> kind (named locks keep the registry kind)
        self.kinds: Dict[str, str] = {}

    # -- collection ----------------------------------------------------------

    def note_edge(self, outer: str, inner: str, rel: str, line: int,
                  func: str) -> None:
        if outer == inner:
            return  # same-name re-entry is legal (RLock sharing)
        self.edges.setdefault((outer, inner), (rel, line, func))

    def walk_function(self, scan: _ModuleScan, node, qualname: str,
                      in_class: Optional[str]) -> None:
        w = _FunctionWalk(self, scan, qualname, in_class)
        self.functions.append(w.run(node))

    def _walk_module(self, rel: str, tree: ast.Module) -> None:
        scan = _ModuleScan(rel, self.aliases)
        scan.visit(tree)
        scan.scan_module_state(tree)
        for key, b in scan.locks.items():
            self.kinds.setdefault(b.name, b.kind)
        for stmt in tree.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.walk_function(scan, stmt, stmt.name, None)
            elif isinstance(stmt, ast.ClassDef):
                for sub in stmt.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        self.walk_function(
                            scan, sub, f"{stmt.name}.{sub.name}",
                            stmt.name)

    # -- interprocedural fixpoint -------------------------------------------

    def _propagate(self) -> None:
        by_name: Dict[str, List[_FuncInfo]] = {}
        for f in self.functions:
            by_name.setdefault(f.qualname.rsplit(".", 1)[-1],
                               []).append(f)
        for f in self.functions:
            f.effective = set(f.acquires)
        changed = True
        rounds = 0
        while changed and rounds < 50:
            changed = False
            rounds += 1
            for f in self.functions:
                for call in f.calls:
                    targets = by_name.get(call.callee, ())
                    if len(targets) != 1:
                        continue  # ambiguous/unknown: no edges
                    extra = targets[0].effective - f.effective
                    if extra:
                        f.effective |= extra
                        changed = True
        # now materialize edges: call under held H reaches everything
        # the (unambiguous) callee effectively acquires
        for f in self.functions:
            for call in f.calls:
                if not call.held:
                    continue
                targets = by_name.get(call.callee, ())
                if len(targets) != 1:
                    continue
                for inner in targets[0].effective:
                    for outer in call.held:
                        self.note_edge(outer, inner, f.rel, call.line,
                                       f.qualname)

    # -- reporting -----------------------------------------------------------

    def _cycles(self) -> List[List[str]]:
        """Strongly connected components with >1 node in the edge
        graph (Tarjan is overkill at this size: iterative DFS over
        <100 nodes)."""
        nodes = sorted({n for e in self.edges for n in e})
        index = {n: i for i, n in enumerate(nodes)}
        out: Dict[str, List[str]] = {n: [] for n in nodes}
        for (a, b) in self.edges:
            out[a].append(b)
        sccs: List[List[str]] = []
        visited: Set[str] = set()
        for start in nodes:
            if start in visited:
                continue
            # nodes reachable from start that can also reach start
            reach: Set[str] = set()
            stack = [start]
            while stack:
                n = stack.pop()
                if n in reach:
                    continue
                reach.add(n)
                stack.extend(out[n])
            back = {n for n in reach
                    if self._reaches(n, start, out)}
            comp = sorted(back & reach)
            if len(comp) > 1 and not any(
                    set(comp) <= set(s) for s in sccs):
                sccs.append(comp)
            visited |= set(comp) or {start}
        return sccs

    @staticmethod
    def _reaches(src: str, dst: str, out: Dict[str, List[str]]) -> bool:
        if src == dst:
            return True
        seen = {src}
        stack = [src]
        while stack:
            n = stack.pop()
            for m in out.get(n, ()):
                if m == dst:
                    return True
                if m not in seen:
                    seen.add(m)
                    stack.append(m)
        return False

    def diagnostics(self,
                    exempt_unlocked: Optional[Dict[str, str]] = None,
                    exempt_blocking: Optional[Dict[str, str]] = None
                    ) -> List[Diagnostic]:
        exempt_unlocked = exempt_unlocked or {}
        exempt_blocking = exempt_blocking or {}
        out: List[Diagnostic] = []

        # ---- CONC-ORDER-CYCLE: rank inversions ----------------------
        for (a, b), (rel, line, func) in sorted(self.edges.items()):
            ra, rb = LOCK_RANKS.get(a), LOCK_RANKS.get(b)
            if ra is None or rb is None:
                continue
            if rb <= ra:
                out.append(Diagnostic(
                    code="CONC-ORDER-CYCLE", level="error",
                    node=f"{rel}:{line}",
                    message=(
                        f"{func} acquires {b!r} (rank {rb}) while "
                        f"holding {a!r} (rank {ra}): inverts the "
                        f"registered lock hierarchy"),
                    hint="acquire in ascending locks.LOCK_RANKS order "
                         "or release the outer lock first"))
        # ---- CONC-ORDER-CYCLE: cycles (covers unranked locks) -------
        for comp in self._cycles():
            ranked = [n for n in comp if n in LOCK_RANKS]
            if len(ranked) == len(comp):
                continue  # fully ranked cycles already reported above
            sites = [self.edges[e] for e in self.edges
                     if e[0] in comp and e[1] in comp]
            rel, line, func = sorted(sites)[0]
            out.append(Diagnostic(
                code="CONC-ORDER-CYCLE", level="error",
                node=f"{rel}:{line}",
                message=(
                    "lock-acquisition cycle: "
                    + " -> ".join(comp + [comp[0]])),
                hint="break the cycle by ordering these locks in "
                     "locks.LOCK_RANKS and acquiring in rank order"))

        # ---- CONC-UNLOCKED-MUT --------------------------------------
        for (rel, key), sites in sorted(self.mutations.items()):
            locked = [s for s in sites if s.held]
            if not locked:
                continue
            for s in sites:
                if s.held or s.in_init or s.by_convention:
                    continue
                ekey = f"{rel}::{key}"
                if ekey in exempt_unlocked:
                    continue
                lock_names = sorted({h for ls in locked
                                     for h in ls.held})
                out.append(Diagnostic(
                    code="CONC-UNLOCKED-MUT", level="error",
                    node=f"{rel}:{s.line}",
                    message=(
                        f"{key} is mutated under "
                        f"{'/'.join(lock_names)} elsewhere but with "
                        f"no lock held in {s.func}"),
                    hint=f"hold the lock here, or exempt "
                         f"'{ekey}' with a justification in "
                         f"[tool.lint-concurrency.exempt-unlocked]"))

        # ---- CONC-BLOCKING-HELD -------------------------------------
        for blk in self.blocking:
            if blk.func in exempt_blocking:
                continue
            out.append(Diagnostic(
                code="CONC-BLOCKING-HELD", level="error",
                node=f"{blk.func.split('::')[0]}:{blk.line}",
                message=(
                    f"{blk.what} while holding "
                    f"{'/'.join(blk.held)} in "
                    f"{blk.func.split('::')[-1]}"),
                hint=f"move the blocking call outside the lock, or "
                     f"exempt '{blk.func}' with a justification in "
                     f"[tool.lint-concurrency.exempt-blocking]"))

        # ---- CONC-WAIT-NOLOOP ---------------------------------------
        for (rel, line, func) in self.bare_waits:
            out.append(Diagnostic(
                code="CONC-WAIT-NOLOOP", level="error",
                node=f"{rel}:{line}",
                message=(
                    f"Condition.wait in {func} is not wrapped in a "
                    f"predicate loop; wakeups may be spurious"),
                hint="use `while not predicate: cond.wait(...)` or "
                     "cond.wait_for(predicate)"))
        return out


def analyze_sources(sources: Dict[str, str],
                    aliases: Optional[Dict[str, str]] = None,
                    exempt_unlocked: Optional[Dict[str, str]] = None,
                    exempt_blocking: Optional[Dict[str, str]] = None
                    ) -> List[Diagnostic]:
    """Run the full analysis over ``{relpath: python_source}`` and
    return the findings (the importable core of run_lint; tests feed
    seeded sources here)."""
    t = _TreeAnalyzer(sources, aliases=aliases)
    for rel, src in sorted(sources.items()):
        t._walk_module(rel, ast.parse(src, filename=rel))
    t._propagate()
    return t.diagnostics(exempt_unlocked=exempt_unlocked,
                         exempt_blocking=exempt_blocking)


def lock_graph(sources: Dict[str, str],
               aliases: Optional[Dict[str, str]] = None
               ) -> Dict[str, object]:
    """The raw acquisition graph (edges + per-function acquires), for
    debugging and for the runtime cross-check test to compare observed
    edges against."""
    t = _TreeAnalyzer(sources, aliases=aliases)
    for rel, src in sorted(sources.items()):
        t._walk_module(rel, ast.parse(src, filename=rel))
    t._propagate()
    return {
        "edges": {f"{a} -> {b}": f"{rel}:{line} ({func})"
                  for (a, b), (rel, line, func)
                  in sorted(t.edges.items())},
        "acquires": {f.qualname: sorted(f.effective)
                     for f in t.functions if f.effective},
    }


#: lock bindings the AST cannot see through, for ``lint_package``:
#: MemoryStore borrows the unified manager's RLock (one lock spans both
#: layers by design, as in the reference)
PACKAGE_ALIASES = {
    "spark_tpu_torch/storage/store.py::MemoryStore._lock":
        "storage.unified",
    # ViewManager.materialize takes the cache entry's lock from the
    # CacheManager: the plain cache path's single-flight lock
    "spark_tpu_torch/mview/manager.py::entry_lock": "session.cache.entry",
    # MaterializedView.lock is a dataclass field (default_factory): the
    # manager takes it through the view
    "spark_tpu_torch/mview/manager.py::view.lock": "mview.view",
}

#: blocking calls under a lock that are so by design, with why
PACKAGE_EXEMPT_BLOCKING = {
    "spark_tpu_torch/metrics.py::_log_path":
        "the IO lock exists precisely to serialize event-log filesystem "
        "access; the mkdir and cache fill run once per configured "
        "directory",
    "spark_tpu_torch/compile/service.py::PlanHistory.note":
        "the history lock serializes the JSONL append and the compaction "
        "with the in-memory counts; IO on a lock of its own would let the "
        "journal and the counts diverge",
}

#: files ``lint_package`` does not scan: locks.py IS the proxy layer (its
#: acquire/release would read as self-nesting)
PACKAGE_EXCLUDE = ("spark_tpu_torch/locks.py",)


def package_sources() -> Dict[str, str]:
    """``{relpath: source}`` of every module of ``spark_tpu_torch``,
    paths relative to the directory that holds the package."""
    import os

    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    root = os.path.dirname(pkg)
    out: Dict[str, str] = {}
    for dirpath, dirnames, filenames in os.walk(pkg):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                path = os.path.join(dirpath, fn)
                rel = os.path.relpath(path, root).replace(os.sep, "/")
                if rel not in PACKAGE_EXCLUDE:
                    with open(path, encoding="utf-8") as f:
                        out[rel] = f.read()
    return out


def lint_package(codes: Optional[Sequence[str]] = None
                 ) -> List[Diagnostic]:
    """The analysis over this package's own source (every finding, or
    only those whose code is in ``codes``)."""
    found = analyze_sources(package_sources(), aliases=PACKAGE_ALIASES,
                            exempt_blocking=PACKAGE_EXEMPT_BLOCKING)
    if codes is not None:
        found = [d for d in found if d.code in set(codes)]
    return found
