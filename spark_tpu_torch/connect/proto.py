"""Typed logical-plan protocol for decoupled clients (the port of
``spark_tpu/connect/proto.py``; reference:
connector/connect/common/src/main/protobuf/spark/connect/relations.proto
+ expressions.proto, decoded by SparkConnectPlanner.scala:67).

The wire format is plain JSON (no protoc dependency in clients): a
relation tree of ``{"op": ...}`` nodes over ``{"e": ...}`` expression
nodes. The client side (connect.server.Client.dataframe) builds these
dicts with no engine imports; the server decodes them into the SAME
logical plan nodes SQL parsing produces, so every optimizer rule and
physical path applies identically.

Relations: read, sql, project, filter, aggregate, join (USING names),
sort, limit, union, distinct.
Expressions: col, lit (typed), alias, bin (arith/cmp/bool), not,
isnull, fn (function-registry call, aggregates with distinct).
"""

from __future__ import annotations

import datetime
from typing import Any, Dict

from spark_tpu_torch import types as T
from spark_tpu_torch.expr import expressions as E
from spark_tpu_torch.plan import logical as L

_BIN_ARITH = {"+", "-", "*", "/", "%"}
_BIN_CMP = {"==", "!=", "<", "<=", ">", ">="}

_AGG_FNS = {
    "sum": E.Sum, "avg": E.Avg, "min": E.Min, "max": E.Max,
}

_TYPES = {
    "int": T.INT64, "long": T.INT64, "double": T.FLOAT64,
    "string": T.STRING, "boolean": T.BOOLEAN, "date": T.DATE,
    "timestamp": T.TIMESTAMP,
}

#: Scalar functions a remote client may call by name. An explicit
#: allowlist, not getattr-on-module: the function registry is the wire
#: protocol surface, and module attributes that happen to be callable
#: (helpers, imports, session-side constructors) are not part of it.
_SCALAR_FNS = frozenset({
    "abs", "coalesce", "isnull", "isnotnull", "floor", "ceil", "sqrt",
    "exp", "log", "log2", "log10", "signum", "round", "pow", "pmod",
    "degrees", "radians", "negative", "positive",
    "upper", "lower", "trim", "ltrim", "rtrim", "length", "initcap",
    "reverse", "repeat", "lpad", "rpad", "translate", "concat",
    "concat_ws", "substring", "startswith", "endswith", "contains",
    "like", "rlike", "regexp_extract", "regexp_replace", "replace",
    "split",
    "year", "month", "dayofmonth", "quarter", "dayofweek", "weekday",
    "dayofyear", "hour", "minute", "second", "add_months", "date_add",
    "date_sub", "datediff", "months_between", "to_date", "date_trunc",
    "last_day",
    "greatest", "least", "ifnull", "nvl2", "nullif",
})


def decode_expr(obj: Dict[str, Any]) -> E.Expression:
    kind = obj.get("e")
    if kind == "col":
        return E.Col(obj["name"])
    if kind == "lit":
        v = obj.get("value")
        t = obj.get("type")
        if t == "date" and isinstance(v, str):
            v = datetime.date.fromisoformat(v)
        dtype = _TYPES.get(t) if t else None
        return E.Literal(v, dtype) if dtype is not None else E.Literal(v)
    if kind == "alias":
        return E.Alias(decode_expr(obj["child"]), obj["name"])
    if kind == "bin":
        op = obj["op"]
        lhs = decode_expr(obj["left"])
        rhs = decode_expr(obj["right"])
        if op in _BIN_ARITH:
            return E.Arith(op, lhs, rhs)
        if op in _BIN_CMP:
            return E.Cmp(op, lhs, rhs)
        if op == "and":
            return E.And(lhs, rhs)
        if op == "or":
            return E.Or(lhs, rhs)
        raise ValueError(f"unknown binary op {op!r}")
    if kind == "not":
        return E.Not(decode_expr(obj["child"]))
    if kind == "isnull":
        return E.IsNull(decode_expr(obj["child"]))
    if kind == "fn":
        name = obj["name"].lower()
        args = [decode_expr(a) for a in obj.get("args", [])]
        if name == "count":
            child = args[0] if args else None
            return E.Count(child, distinct=bool(obj.get("distinct")))
        if name in _AGG_FNS:
            cls = _AGG_FNS[name]
            if name in ("min", "max"):
                return cls(args[0])
            return cls(args[0], distinct=bool(obj.get("distinct")))
        from spark_tpu_torch.api import functions as F

        if name not in _SCALAR_FNS:
            raise ValueError(f"unknown function {obj['name']!r}")
        return getattr(F, name)(*args)
    raise ValueError(f"unknown expression node {kind!r}")


def decode_plan(obj: Dict[str, Any], session) -> L.LogicalPlan:
    op = obj.get("op")
    if op == "read":
        df = session.table(obj["table"])
        return df._plan
    if op == "sql":
        return session.sql(obj["query"])._plan
    if op == "project":
        return L.Project(tuple(decode_expr(e) for e in obj["exprs"]),
                         decode_plan(obj["child"], session))
    if op == "filter":
        return L.Filter(decode_expr(obj["condition"]),
                        decode_plan(obj["child"], session))
    if op == "aggregate":
        groupings = tuple(decode_expr(e) for e in obj.get("groupings",
                                                          []))
        aggs = tuple(decode_expr(e) for e in obj["aggregates"])
        return L.Aggregate(groupings, groupings + aggs,
                           decode_plan(obj["child"], session))
    if op == "join":
        left = decode_plan(obj["left"], session)
        right = decode_plan(obj["right"], session)
        names = obj.get("on", [])
        keys = tuple(E.Col(n) for n in names)
        how = obj.get("how", "inner")
        joined = L.Join(left, right, how, keys, keys)
        # USING semantics: key columns appear once; output names map
        # positionally onto each side's schema. For a RIGHT join the
        # key values must come from the RIGHT side — unmatched right
        # rows carry NULL in the left region — surfaced under the
        # left's (un-suffixed) output name. For a FULL join either
        # region may hold the NULL, so the key is
        # coalesce(left_key, right_key).
        if names and how in ("inner", "left", "right", "full"):
            ln = len(left.schema.names)
            lout = list(joined.schema.names)[:ln]
            rout = list(joined.schema.names)[ln:]
            rmap = dict(zip(right.schema.names, rout))
            exprs = []
            for o, src in zip(lout, left.schema.names):
                if src in names and how == "right":
                    exprs.append(E.Alias(E.Col(rmap[src]), o))
                elif src in names and how == "full":
                    exprs.append(E.Alias(
                        E.Coalesce((E.Col(o), E.Col(rmap[src]))), o))
                else:
                    exprs.append(E.Col(o))
            exprs.extend(E.Col(o) for o, src in zip(rout, right.schema.names)
                         if src not in names)
            return L.Project(tuple(exprs), joined)
        return joined
    if op == "sort":
        orders = tuple(
            E.SortOrder(decode_expr(o["expr"]),
                        bool(o.get("asc", True)),
                        o.get("nulls_first"))
            for o in obj["orders"])
        return L.Sort(orders, decode_plan(obj["child"], session))
    if op == "limit":
        return L.Limit(int(obj["n"]),
                       decode_plan(obj["child"], session),
                       offset=int(obj.get("offset", 0)))
    if op == "union":
        return L.Union(decode_plan(obj["left"], session),
                       decode_plan(obj["right"], session))
    if op == "distinct":
        return L.Distinct(decode_plan(obj["child"], session))
    raise ValueError(f"unknown relation node {op!r}")
