"""AST linter for the invariants this package relies on but Python cannot
enforce (the port of ``tools/lint_invariants.py``, over
``spark_tpu_torch`` and against this package's own registries).

Seven rules:

1. **conf-keys**: every literal key passed to ``.get(...)``,
   ``.set(...)`` or ``.config(...)`` that looks like a config key
   (``spark.`` or ``spark_tpu.`` prefix) is a registered ``ConfigEntry``
   or matches a registered prefix (``conf.register_prefix``). An
   unregistered key reads as a KeyError at run time and dodges the
   analysis-level gate.
2. **fault-points**: every literal point passed to
   ``faults.inject("<point>", ...)`` is one of ``faults.POINTS``; a
   misspelt point is an injection site that can never fire.
3. **fingerprint-purity**: the functions on the fingerprint path (every
   function of ``compile/store.py``, whose digests name a plan across
   processes, and ``physical/planner.py``'s ``_adaptive_snapshot``, part
   of the stage cache's key) call neither ``hash()`` (salted per
   process) nor ``id()`` (an address), and iterate no dict's
   ``.items()``/``.keys()``/``.values()`` outside ``sorted(...)`` (an
   equal plan built in another order would key differently). The sites
   that only key an in-process memo or fill a value map are named in
   ``ALLOWED_SITES``, each with its reason; an allowance that matches
   no site is itself a finding.
4. **metrics-lock**: in ``metrics.py`` every mutation of module state
   is lexically inside ``with _LOCK:`` (``_IO_LOCK`` for the log
   buffer's state): the scheduler mutates metrics from many threads.
5. **dead-fault-points**: every point in ``faults.POINTS`` has at
   least one ``faults.inject("<point>", ...)`` site in the package; a
   declared point with none registers a conf key for a seam that does
   not exist.
6. **span-names**: every literal span name opened with
   ``trace.span("<name>", ...)`` (or a bare imported ``span(...)``) is
   in ``trace.SPAN_NAMES``; an undeclared name falls out of the
   waterfall's attribution.
7. **retry-budget**: a bounded retry loop (a ``for`` over ``range``
   whose target or bound names an attempt or a retry) sits in a
   function that draws from the query's retry budget
   (``recovery.retry_allowed``, ``RetryBudget``, ``.draw``); a private
   counter multiplies with every other layer's.

``lint_package()`` returns the findings over this package (none on a
clean tree); ``python -m spark_tpu_torch.analysis.invariants`` prints
them and exits 1 when there are any.
"""

from __future__ import annotations

import ast
import os
import sys
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

PACKAGE = "spark_tpu_torch"
KEY_PREFIXES = ("spark.", "spark_tpu.")
#: file -> the functions on the fingerprint path (() = every function)
FINGERPRINT_PATHS: Dict[str, Tuple[str, ...]] = {
    "spark_tpu_torch/compile/store.py": (),
    "spark_tpu_torch/physical/planner.py": ("_adaptive_snapshot",),
}
#: (file, innermost function, call) -> why the site feeds no digest
ALLOWED_SITES: Dict[Tuple[str, str, str], str] = {
    ("spark_tpu_torch/compile/store.py", "_memo", "id()"):
        "the memo's key; a hit is checked against the entry's weakref "
        "and the stored digest is of the object's contents",
    ("spark_tpu_torch/compile/store.py", "_memo", ".items()"):
        "sweeps the memo's dead entries; the order changes nothing",
    ("spark_tpu_torch/compile/store.py", "scans", "id()"):
        "keys the substitution by the scan key's identity; what goes "
        "into the digest is the scan's content key",
    ("spark_tpu_torch/compile/store.py", "walk", "id()"):
        "looks up that substitution; the key it returns is the content "
        "key",
    ("spark_tpu_torch/compile/store.py", "collect_stats", ".items()"):
        "fills a node's value map from the fixed table of caches; the "
        "map is the stored entry, not an input to its digest",
    ("spark_tpu_torch/compile/store.py", "bind_stats", ".items()"):
        "inserts an entry's values into their caches; the order "
        "changes nothing",
}
LOCKED_MODULES = ("spark_tpu_torch/metrics.py",)
#: module state -> the lock that guards its mutations (else DEFAULT_LOCK)
LOCK_MAP = {"_PATH_CACHE": "_IO_LOCK", "_LOG_BUF": "_IO_LOCK",
            "_LOG_BUF_PATH": "_IO_LOCK", "_LOG_LAST_FLUSH": "_IO_LOCK"}
DEFAULT_LOCK = "_LOCK"

_PURITY_CALLS = ("hash", "id")
_DICT_VIEWS = ("items", "keys", "values")


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


def _const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _call_name(node: ast.Call) -> Optional[str]:
    fn = node.func
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return None


# ---- rule 1: conf keys --------------------------------------------------------


def check_conf_keys(tree: ast.AST, rel: str, out: List[Finding]) -> None:
    from spark_tpu_torch import conf as CF

    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("get", "set", "config")
                and node.args):
            continue
        key = _const_str(node.args[0])
        if key is None or not key.startswith(KEY_PREFIXES):
            continue
        if not CF.is_registered(key):
            out.append(Finding(
                "conf-keys", rel, node.lineno,
                f"config key {key!r} is not a registered ConfigEntry or "
                "prefix (register it in spark_tpu_torch/conf.py)"))


# ---- rules 2 and 5: fault points ------------------------------------------------


def check_fault_points(tree: ast.AST, rel: str, out: List[Finding],
                       seen: Optional[Set[str]] = None) -> None:
    from spark_tpu_torch import faults

    valid = set(faults.POINTS)
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and node.args
                and _call_name(node) == "inject"):
            continue
        point = _const_str(node.args[0])
        if point is None:
            continue
        if point not in valid:
            out.append(Finding(
                "fault-points", rel, node.lineno,
                f"fault point {point!r} is not in faults.POINTS: this "
                "injection site can never fire"))
        elif seen is not None:
            seen.add(point)


def check_dead_fault_points(seen: Set[str], out: List[Finding]) -> None:
    from spark_tpu_torch import faults

    for point in sorted(set(faults.POINTS) - seen):
        out.append(Finding(
            "dead-fault-points", f"{PACKAGE}/faults.py", 0,
            f"fault point {point!r} is in faults.POINTS but no "
            "faults.inject(...) site names it: arming it tests nothing"))


# ---- rule 6: span names ---------------------------------------------------------


def check_span_names(tree: ast.AST, rel: str, out: List[Finding]) -> None:
    from spark_tpu_torch import trace

    valid = set(trace.SPAN_NAMES)
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and node.args):
            continue
        fn = node.func
        if isinstance(fn, ast.Attribute):
            if not (fn.attr == "span" and isinstance(fn.value, ast.Name)
                    and fn.value.id in ("trace", "_trace")):
                continue
        elif not (isinstance(fn, ast.Name) and fn.id == "span"):
            continue
        name = _const_str(node.args[0])
        if name is not None and name not in valid:
            out.append(Finding(
                "span-names", rel, node.lineno,
                f"span name {name!r} is not in trace.SPAN_NAMES: register "
                "it so the waterfall and its attribution see it"))


# ---- rule 7: retry loops draw from the budget -------------------------------------

_RETRY_HINTS = ("attempt", "retry", "retries")
_BUDGET_MARKERS = ("retry_allowed", "RetryBudget", "draw", "retry_budget",
                   "bind_budget")


def check_retry_budget(tree: ast.AST, rel: str, out: List[Finding]) -> None:
    def hinted(name: str) -> bool:
        return any(h in name.lower() for h in _RETRY_HINTS)

    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if any((isinstance(n, ast.Name) and n.id in _BUDGET_MARKERS)
                or (isinstance(n, ast.Attribute)
                    and n.attr in _BUDGET_MARKERS)
                for n in ast.walk(fn)):
            continue
        for node in ast.walk(fn):
            if not (isinstance(node, ast.For)
                    and isinstance(node.iter, ast.Call)
                    and isinstance(node.iter.func, ast.Name)
                    and node.iter.func.id == "range"):
                continue
            shaped = isinstance(node.target, ast.Name) \
                and hinted(node.target.id)
            shaped = shaped or any(
                hinted(sub.id if isinstance(sub, ast.Name) else sub.attr)
                for sub in ast.walk(node.iter)
                if isinstance(sub, (ast.Name, ast.Attribute)))
            if shaped:
                out.append(Finding(
                    "retry-budget", rel, node.lineno,
                    f"retry loop in {fn.name}() never draws from the "
                    "query's retry budget (recovery.retry_allowed / "
                    "budget.draw): a private counter multiplies with "
                    "every other layer's"))


# ---- rule 3: fingerprint purity ---------------------------------------------------


def _purity_sites(tree: ast.AST, only: Tuple[str, ...]):
    """(innermost function, call, line) of every impure call in a
    function on the path (``only`` names the path's functions, with
    their nested ones; () takes every function), once each."""
    sites = []

    def visit(node: ast.AST, stack: Tuple[str, ...],
              spans: List[Tuple[int, int]]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                inner = stack + (child.name,)
                on_path = not only or any(f in only for f in inner)
                own = spans
                if on_path and not spans:
                    # sorted(...) spans of the outermost function on the
                    # path, nested functions included
                    own = [(c.lineno, c.end_lineno or c.lineno)
                           for c in ast.walk(child)
                           if isinstance(c, ast.Call)
                           and isinstance(c.func, ast.Name)
                           and c.func.id == "sorted"] or [(-1, -1)]
                visit(child, inner, own if on_path else [])
                continue
            if spans and isinstance(child, ast.Call):
                fn = child.func
                if isinstance(fn, ast.Name) and fn.id in _PURITY_CALLS:
                    sites.append((stack[-1], f"{fn.id}()", child.lineno))
                elif (isinstance(fn, ast.Attribute)
                      and fn.attr in _DICT_VIEWS and not child.args
                      and not any(lo <= child.lineno <= hi
                                  for lo, hi in spans)):
                    sites.append((stack[-1], f".{fn.attr}()", child.lineno))
            visit(child, stack, spans)

    visit(tree, (), [])
    return sites


def check_fingerprint_purity(tree: ast.AST, rel: str,
                             only: Tuple[str, ...], out: List[Finding],
                             allowed: Optional[Dict] = None,
                             used: Optional[Set] = None) -> None:
    allowed = ALLOWED_SITES if allowed is None else allowed
    for fn, call, line in _purity_sites(tree, only):
        site = (rel, fn, call)
        if site in allowed:
            if used is not None:
                used.add(site)
            continue
        why = ("process-seeded or address-based values break the "
               "fingerprint across processes" if call.rstrip("()")
               in _PURITY_CALLS else "dict order decides the key; wrap it "
               "in sorted(...)")
        out.append(Finding("fingerprint-purity", rel, line,
                           f"{call} in fingerprint function {fn}(): {why}"))


def check_stale_allowances(used: Set, out: List[Finding],
                           allowed: Optional[Dict] = None) -> None:
    allowed = ALLOWED_SITES if allowed is None else allowed
    for rel, fn, call in sorted(set(allowed) - used):
        out.append(Finding(
            "fingerprint-purity", rel, 0,
            f"allowed site {call} in {fn}() matches no call: drop it from "
            "ALLOWED_SITES"))


# ---- rule 4: metrics mutations under their lock -----------------------------------

_MUTATORS = ("append", "pop", "popleft", "clear", "update", "extend",
             "setdefault", "insert", "remove")


def check_metrics_locks(tree: ast.Module, rel: str,
                        out: List[Finding]) -> None:
    state: Set[str] = set()
    for node in tree.body:
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target]
                   if isinstance(node, (ast.AnnAssign, ast.AugAssign))
                   else [])
        state.update(t.id for t in targets
                     if isinstance(t, ast.Name) and t.id.startswith("_"))
    locks = {DEFAULT_LOCK} | set(LOCK_MAP.values())
    state -= locks
    reported: Set[Tuple[str, int]] = set()

    def base_name(node: ast.AST) -> Optional[str]:
        while isinstance(node, (ast.Subscript, ast.Attribute)):
            node = node.value
        return node.id if isinstance(node, ast.Name) else None

    def walk(node: ast.AST, held: Set[str], depth: int) -> None:
        if isinstance(node, ast.With):
            got = held | {base_name(i.context_expr) for i in node.items
                          if base_name(i.context_expr) in locks}
            for child in node.body:
                walk(child, got, depth)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for child in node.body:
                walk(child, set(), depth + 1)
            return
        mutated: List[Tuple[str, int]] = []
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.Delete)):
            targets = node.targets if isinstance(
                node, (ast.Assign, ast.Delete)) else [node.target]
            for t in targets:
                n = base_name(t)
                if n in state and (depth > 0 or not isinstance(t, ast.Name)):
                    mutated.append((n, node.lineno))
        for sub in ast.walk(node):
            if (isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Attribute)
                    and sub.func.attr in _MUTATORS and depth > 0
                    and base_name(sub.func.value) in state):
                mutated.append((base_name(sub.func.value), sub.lineno))
        for name, line in mutated:
            need = LOCK_MAP.get(name, DEFAULT_LOCK)
            if need not in held and (name, line) not in reported:
                reported.add((name, line))
                out.append(Finding(
                    "metrics-lock", rel, line,
                    f"mutation of {name} outside `with {need}:`: the "
                    "scheduler mutates metrics from many threads"))
        for child in ast.iter_child_nodes(node):
            walk(child, held, depth)

    for top in tree.body:
        walk(top, set(), 0)


# ---- the package walk --------------------------------------------------------------


def _package_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _import_all_modules() -> None:
    """Conf keys register where their module is imported, so the registry
    is whole only once every module of the package is (a module that
    fails to import is skipped: its keys then read as unregistered)."""
    import importlib
    import pkgutil

    import spark_tpu_torch

    for info in pkgutil.walk_packages(spark_tpu_torch.__path__,
                                      prefix=f"{PACKAGE}."):
        try:
            importlib.import_module(info.name)
        except Exception:
            pass


def package_files() -> List[Tuple[str, str]]:
    """(path relative to the package's parent, absolute path) of every
    module of the package, in a fixed order."""
    pkg = _package_root()
    root = os.path.dirname(pkg)
    out = []
    for dirpath, dirnames, filenames in os.walk(pkg):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                path = os.path.join(dirpath, fn)
                out.append((os.path.relpath(path, root)
                            .replace(os.sep, "/"), path))
    return out


def lint_package() -> List[Finding]:
    """Every rule over every module of the package."""
    _import_all_modules()
    findings: List[Finding] = []
    injected: Set[str] = set()
    used: Set = set()
    for rel, path in package_files():
        with open(path, encoding="utf-8") as f:
            src = f.read()
        try:
            tree = ast.parse(src, filename=rel)
        except SyntaxError as e:
            findings.append(Finding("parse", rel, e.lineno or 0,
                                    f"syntax error: {e.msg}"))
            continue
        check_conf_keys(tree, rel, findings)
        check_fault_points(tree, rel, findings, injected)
        check_span_names(tree, rel, findings)
        check_retry_budget(tree, rel, findings)
        if rel in FINGERPRINT_PATHS:
            check_fingerprint_purity(tree, rel, FINGERPRINT_PATHS[rel],
                                     findings, used=used)
        if rel in LOCKED_MODULES:
            check_metrics_locks(tree, rel, findings)
    check_dead_fault_points(injected, findings)
    check_stale_allowances(used, findings)
    return findings


def main() -> int:
    findings = lint_package()
    for f in findings:
        print(f.format())
    print(f"invariants: {len(findings)} finding(s)" if findings
          else "invariants: clean")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
