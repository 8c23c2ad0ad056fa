"""TPC-H q1, q3 and q5 computed with pyarrow alone (filters, ``Table.join``,
``group_by`` and sorting over host tables): the yardstick of a scale that
the sqlite oracle (``tpch/oracle.py``) cannot load in time. Decimal
arithmetic stays decimal, as the engine's does; each function returns
the query's rows in its ORDER BY, as tuples (``oracle.assert_rows_match``
compares them with the engine's).

``tables`` maps a table name to a ``pyarrow.Table`` holding at least the
columns of ``COLUMNS``; dictionary-encoded columns are decoded first.
"""

from __future__ import annotations

import datetime
from decimal import Decimal
from typing import Dict, List, Tuple

import pyarrow as pa
import pyarrow.compute as pc

#: the columns q1, q3 and q5 read, by table
COLUMNS = {
    "lineitem": ("l_orderkey", "l_suppkey", "l_returnflag", "l_linestatus",
                 "l_quantity", "l_extendedprice", "l_discount", "l_tax",
                 "l_shipdate"),
    "orders": ("o_orderkey", "o_custkey", "o_orderdate", "o_shippriority"),
    "customer": ("c_custkey", "c_mktsegment", "c_nationkey"),
    "supplier": ("s_suppkey", "s_nationkey"),
    "nation": ("n_nationkey", "n_name", "n_regionkey"),
    "region": ("r_regionkey", "r_name"),
}


def _plain(table: pa.Table, columns) -> pa.Table:
    """``columns`` of ``table``, dictionary columns decoded to strings."""
    out = {}
    for name in columns:
        col = table.column(name)
        if pa.types.is_dictionary(col.type):
            col = col.cast(col.type.value_type)
        out[name] = col
    return pa.table(out)


#: 1 +- a rate (decimal(12,2) in [0, 1]) and a price times one, in the
#: narrowest decimals that hold them, so a product of three stays within
#: decimal128's 38 digits
_FACTOR = pa.decimal128(4, 2)
_PRODUCT = pa.decimal128(18, 4)


def _factor(rate, sign: int):
    one = pa.scalar(Decimal(1), rate.type)
    fn = pc.add_checked if sign > 0 else pc.subtract_checked
    return fn(one, rate).cast(_FACTOR)


def _disc_price(t: pa.Table):
    """l_extendedprice * (1 - l_discount), exact."""
    return pc.multiply_checked(t["l_extendedprice"],
                               _factor(t["l_discount"], -1)).cast(_PRODUCT)


def _rows(table: pa.Table) -> List[Tuple]:
    cols = [table.column(i).to_pylist() for i in range(table.num_columns)]
    return list(zip(*cols))


def _date(text: str):
    return pa.scalar(datetime.date.fromisoformat(text), pa.date32())


def q1(tables: Dict[str, pa.Table]) -> List[Tuple]:
    li = _plain(tables["lineitem"], COLUMNS["lineitem"])
    li = li.filter(pc.less_equal(li["l_shipdate"], _date("1998-09-02")))
    disc = _disc_price(li)
    charge = pc.multiply_checked(disc, _factor(li["l_tax"], 1))
    t = pa.table({"l_returnflag": li["l_returnflag"],
                  "l_linestatus": li["l_linestatus"],
                  "qty": li["l_quantity"], "price": li["l_extendedprice"],
                  "disc_price": disc, "charge": charge,
                  "disc": li["l_discount"]})
    g = t.group_by(["l_returnflag", "l_linestatus"]).aggregate([
        ("qty", "sum"), ("price", "sum"), ("disc_price", "sum"),
        ("charge", "sum"), ("qty", "mean"), ("price", "mean"),
        ("disc", "mean"), ("qty", "count")])
    g = g.sort_by([("l_returnflag", "ascending"),
                   ("l_linestatus", "ascending")])
    return _rows(g.select([
        "l_returnflag", "l_linestatus", "qty_sum", "price_sum",
        "disc_price_sum", "charge_sum", "qty_mean", "price_mean",
        "disc_mean", "qty_count"]))


def q3(tables: Dict[str, pa.Table]) -> List[Tuple]:
    cust = _plain(tables["customer"], COLUMNS["customer"])
    cust = cust.filter(pc.equal(cust["c_mktsegment"], "BUILDING"))
    orders = _plain(tables["orders"], COLUMNS["orders"])
    orders = orders.filter(pc.less(orders["o_orderdate"],
                                   _date("1995-03-15")))
    li = _plain(tables["lineitem"], ("l_orderkey", "l_extendedprice",
                                     "l_discount", "l_shipdate"))
    li = li.filter(pc.greater(li["l_shipdate"], _date("1995-03-15")))
    co = orders.join(cust.select(["c_custkey"]), "o_custkey", "c_custkey",
                     join_type="inner")
    j = pa.table({"l_orderkey": li["l_orderkey"],
                  "revenue": _disc_price(li)}).join(
        co.select(["o_orderkey", "o_orderdate", "o_shippriority"]),
        "l_orderkey", "o_orderkey", join_type="inner")
    g = j.group_by(["l_orderkey", "o_orderdate", "o_shippriority"]) \
        .aggregate([("revenue", "sum")])
    g = g.sort_by([("revenue_sum", "descending"),
                   ("o_orderdate", "ascending")]).slice(0, 10)
    return _rows(g.select(["l_orderkey", "revenue_sum", "o_orderdate",
                           "o_shippriority"]))


def q5(tables: Dict[str, pa.Table]) -> List[Tuple]:
    region = _plain(tables["region"], COLUMNS["region"])
    region = region.filter(pc.equal(region["r_name"], "ASIA"))
    nation = _plain(tables["nation"], COLUMNS["nation"]).join(
        region, "n_regionkey", "r_regionkey", join_type="inner")
    supp = _plain(tables["supplier"], COLUMNS["supplier"]).join(
        nation.select(["n_nationkey", "n_name"]), "s_nationkey",
        "n_nationkey", join_type="inner")
    orders = _plain(tables["orders"], COLUMNS["orders"])
    orders = orders.filter(pc.and_(
        pc.greater_equal(orders["o_orderdate"], _date("1994-01-01")),
        pc.less(orders["o_orderdate"], _date("1995-01-01"))))
    oc = orders.select(["o_orderkey", "o_custkey"]).join(
        _plain(tables["customer"], ("c_custkey", "c_nationkey")),
        "o_custkey", "c_custkey", join_type="inner")
    li = _plain(tables["lineitem"], ("l_orderkey", "l_suppkey",
                                     "l_extendedprice", "l_discount"))
    j = pa.table({"l_orderkey": li["l_orderkey"],
                  "l_suppkey": li["l_suppkey"],
                  "revenue": _disc_price(li)}).join(
        oc.select(["o_orderkey", "c_nationkey"]), "l_orderkey",
        "o_orderkey", join_type="inner")
    j = j.join(supp.select(["s_suppkey", "s_nationkey", "n_name"]),
               "l_suppkey", "s_suppkey", join_type="inner")
    j = j.filter(pc.equal(j["c_nationkey"], j["s_nationkey"]))
    g = j.group_by(["n_name"]).aggregate([("revenue", "sum")])
    g = g.sort_by([("revenue_sum", "descending")])
    return _rows(g.select(["n_name", "revenue_sum"]))


#: the yardstick of each query, by TPC-H number
QUERIES = {1: q1, 3: q3, 5: q5}
