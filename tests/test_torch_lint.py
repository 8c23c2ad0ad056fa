"""The port's invariant linter (``spark_tpu_torch/analysis/invariants.py``,
the port of ``tools/lint_invariants.py``): the package lints clean, each
of the seven rules finds its seeded violation (as tests/test_analysis.py
does for the reference's), the fingerprint path's allowed sites are
exactly the store's memo keys and value maps, and every ``<alias>.<name>``
that the package reads from one of its own modules exists there (a
missing ``T.days_to_date`` raised only when a skew split met a date
key)."""

import ast
import importlib

from spark_tpu_torch import faults
from spark_tpu_torch.analysis import invariants as INV

from test_torch_threads import one_torch_thread  # noqa: F401


def _run(check, src, *args, **kw):
    out = []
    check(ast.parse(src), "x.py", *args, out, **kw)
    return out


def test_port_lints_clean():
    findings = INV.lint_package()
    assert findings == [], "\n".join(f.format() for f in findings)


def test_rule_conf_keys_fires():
    out = _run(INV.check_conf_keys, "conf.get('spark.tpu.not.a.real.key')")
    assert [f.rule for f in out] == ["conf-keys"]
    assert _run(INV.check_conf_keys,
                "conf.get('spark.tpu.adaptive.enabled')") == []


def test_rule_fault_points_fires():
    out = _run(INV.check_fault_points, "faults.inject('bogus.point', c)")
    assert [f.rule for f in out] == ["fault-points"]
    assert _run(INV.check_fault_points,
                "faults.inject('execute.device', c)") == []


def test_rule_dead_fault_points_fires():
    out = []
    INV.check_dead_fault_points(set(faults.POINTS) - {"join.spill"}, out)
    assert [(f.rule, "'join.spill'" in f.message) for f in out] == [
        ("dead-fault-points", True)]


def test_rule_span_names_fires():
    out = _run(INV.check_span_names, "with trace.span('no.such.span'):\n"
               "    pass\n")
    assert [f.rule for f in out] == ["span-names"]
    assert _run(INV.check_span_names, "with trace.span('stage.run'):\n"
                "    pass\n") == []


def test_rule_retry_budget_fires():
    bad = ("def fetch(n_retries):\n"
           "    for attempt in range(n_retries):\n"
           "        pass\n")
    good = ("def fetch(n_retries):\n"
            "    for attempt in range(n_retries):\n"
            "        if not recovery.retry_allowed('x'):\n"
            "            break\n")
    assert [f.line for f in _run(INV.check_retry_budget, bad)] == [2]
    assert _run(INV.check_retry_budget, good) == []


def test_rule_fingerprint_purity_fires():
    src = ("def stable_plan_key(d):\n"
           "    a = hash(d)\n"
           "    for k, v in d.items():\n"
           "        pass\n"
           "    for k in sorted(d.items()):\n"
           "        pass\n"
           "    def inner(x):\n"
           "        return id(x)\n"
           "    return a\n")
    out = _run(INV.check_fingerprint_purity, src, (), allowed={})
    assert sorted(f.line for f in out) == [2, 3, 8]  # not the sorted one
    # a site is named by its innermost function; an unused name is stale
    allowed = {("x.py", "inner", "id()"): "test", ("x.py", "gone", "id()"):
               "test"}
    used = set()
    out = _run(INV.check_fingerprint_purity, src, (), allowed=allowed,
               used=used)
    assert sorted(f.line for f in out) == [2, 3]
    stale = []
    INV.check_stale_allowances(used, stale, allowed=allowed)
    assert [("gone()" in f.message, f.rule) for f in stale] == [
        (True, "fingerprint-purity")]
    # only the named functions (and theirs) are on the path
    assert _run(INV.check_fingerprint_purity, src, ("other",),
                allowed={}) == []


def test_fingerprint_allowances_are_the_store_s_memo_sites():
    """Without its allowances the rule finds exactly the named sites, each
    once, and every allowance gives its reason."""
    rel = "spark_tpu_torch/compile/store.py"
    path = dict(INV.package_files())[rel]
    with open(path) as f:
        tree = ast.parse(f.read())
    sites = {(rel, fn, call) for fn, call, _ in
             INV._purity_sites(tree, INV.FINGERPRINT_PATHS[rel])}
    assert sites == set(INV.ALLOWED_SITES)
    assert len(INV._purity_sites(tree, ())) == 7
    assert all(len(why) > 20 for why in INV.ALLOWED_SITES.values())


def test_rule_metrics_lock_fires():
    src = ("import threading\n"
           "_LOCK = threading.Lock()\n"
           "_EVENTS = []\n"
           "def bad(ev):\n"
           "    _EVENTS.append(ev)\n"
           "def good(ev):\n"
           "    with _LOCK:\n"
           "        _EVENTS.append(ev)\n")
    out = _run(INV.check_metrics_locks, src)
    assert [(f.rule, f.line) for f in out] == [("metrics-lock", 5)]


def _module_aliases(tree) -> dict:
    """Name -> the package module it is bound to, from the file's imports
    (``import spark_tpu_torch.x as y``, ``from spark_tpu_torch.x import
    y [as z]`` where y is a module)."""
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update((a.asname, a.name) for a in node.names
                       if a.name.startswith("spark_tpu_torch") and a.asname)
        elif (isinstance(node, ast.ImportFrom) and node.level == 0
              and (node.module or "").startswith("spark_tpu_torch")):
            for a in node.names:
                full = f"{node.module}.{a.name}"
                try:
                    importlib.import_module(full)
                except ImportError:
                    continue  # a name, not a module
                out[a.asname or a.name] = full
    return out


def _missing_attributes(src: str) -> list:
    tree = ast.parse(src)
    aliases = _module_aliases(tree)
    return [(node.lineno, aliases[node.value.id], node.attr)
            for node in ast.walk(tree)
            if isinstance(node, ast.Attribute)
            and isinstance(node.ctx, ast.Load)
            and isinstance(node.value, ast.Name)
            and node.value.id in aliases
            and not hasattr(importlib.import_module(aliases[node.value.id]),
                            node.attr)]


def test_module_attributes_exist():
    """Every ``T.<name>`` (and every other read of a package module
    through its alias) names something the module defines."""
    INV._import_all_modules()
    missing = []
    for rel, path in INV.package_files():
        with open(path, encoding="utf-8") as f:
            missing += [(rel,) + m for m in _missing_attributes(f.read())]
    assert missing == []


def test_missing_module_attribute_is_found():
    src = ("from spark_tpu_torch import types as T\n"
           "d = T.days_to_date(3)\n"
           "t = T.days_to_datetime(3)\n")
    assert _missing_attributes(src) == [
        (3, "spark_tpu_torch.types", "days_to_datetime")]
