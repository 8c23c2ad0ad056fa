"""Session extension points.

Analogue of SparkSessionExtensions (reference:
sql/core/.../SparkSessionExtensions.scala — injectOptimizerRule:268,
injectFunction:344, injectParser:318, injectPlannerStrategy:298) and the
plugin hook (core/.../api/plugin/SparkPlugin.java:37,
activated by the ``spark.plugins`` conf,
internal/config/package.scala:1718).

Kept deliberately small: extensions register *callables* —
  - optimizer rules: LogicalPlan -> LogicalPlan, run after the built-in
    fixpoint batch every optimize();
  - functions: name -> Expression builder, resolvable from SQL and the
    DataFrame API;
  - parser interceptors: (sql_text, catalog, default_parse) -> plan,
    first non-None wins (dialect front-ends);
  - plugins: objects with init(session)/shutdown() driven by the
    ``spark.plugins`` conf (module:attr paths).
"""

from __future__ import annotations

import importlib
from typing import Any, Callable, Dict, List, Optional

from spark_tpu_torch import conf as CF

PLUGINS = CF.register(
    "spark.plugins", "",
    "Comma-separated module:attr paths of plugin objects with "
    "init(session) / shutdown() (reference: SparkPlugin.java:37).", str)


class Extensions:
    """Per-session registry (reference: SparkSessionExtensions)."""

    def __init__(self):
        self._optimizer_rules: List[Callable] = []
        self._functions: Dict[str, Callable] = {}
        self._parser_hooks: List[Callable] = []
        self._plugins: List[Any] = []

    # -- injection points ----------------------------------------------------

    def inject_optimizer_rule(self, rule: Callable) -> None:
        """rule: LogicalPlan -> LogicalPlan, applied after the built-in
        batch (reference: injectOptimizerRule)."""
        self._optimizer_rules.append(rule)

    injectOptimizerRule = inject_optimizer_rule

    def inject_function(self, name: str, builder: Callable) -> None:
        """builder(*arg_exprs) -> Expression (reference: injectFunction).
        Resolvable from SQL calls and ``F.call_function``."""
        self._functions[name.lower()] = builder

    injectFunction = inject_function

    def inject_parser(self, hook: Callable) -> None:
        """hook(sql, catalog, default_parse) -> Optional[LogicalPlan];
        first non-None wins (reference: injectParser)."""
        self._parser_hooks.append(hook)

    injectParser = inject_parser

    # -- lookups used by the engine ------------------------------------------

    def optimizer_rules(self) -> List[Callable]:
        return list(self._optimizer_rules)

    def function(self, name: str) -> Optional[Callable]:
        return self._functions.get(name.lower())

    def parse(self, sql: str, catalog, default_parse):
        for hook in self._parser_hooks:
            plan = hook(sql, catalog, default_parse)
            if plan is not None:
                return plan
        return default_parse(sql, catalog)

    # -- plugin lifecycle ----------------------------------------------------

    def load_plugins(self, session) -> None:
        """Instantiate spark.plugins entries (module:attr) and call
        init(session) (reference: PluginContainer.scala:30)."""
        spec = str(session.conf.get(PLUGINS) or "")
        for path in filter(None, (p.strip() for p in spec.split(","))):
            mod_name, _, attr = path.partition(":")
            obj = getattr(importlib.import_module(mod_name), attr or "plugin")
            if isinstance(obj, type):
                obj = obj()
            if hasattr(obj, "init"):
                obj.init(session)
            self._plugins.append(obj)

    def shutdown_plugins(self) -> None:
        for p in self._plugins:
            if hasattr(p, "shutdown"):
                p.shutdown()
        self._plugins.clear()
