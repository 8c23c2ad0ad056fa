"""TPC-H query texts used by the port: q1 from the TPC-H specification
(rev 2.18, default substitution parameters), copied from the reference
package's query set, plus ``Q1_WIDE``.

``Q1_WIDE`` is a q1-shaped aggregate grouped by four dictionary columns
(3 * 2 * 7 * 4 = 168 packed groups), so HashAggregate's direct path runs
its counts and float32 min/max through the segmented-aggregation kernels
(64 < K <= 1024). Plain q1 has K = 6 and takes the masked reduction. The
min/max cast integer keys to float: casting a DECIMAL to float returns the
unscaled integer in the reference engine (see ROADMAP's quirks).
"""

QUERIES = {
    1: """
select
    l_returnflag,
    l_linestatus,
    sum(l_quantity) as sum_qty,
    sum(l_extendedprice) as sum_base_price,
    sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
    sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge,
    avg(l_quantity) as avg_qty,
    avg(l_extendedprice) as avg_price,
    avg(l_discount) as avg_disc,
    count(*) as count_order
from
    lineitem
where
    l_shipdate <= date '1998-12-01' - interval '90' day
group by
    l_returnflag,
    l_linestatus
order by
    l_returnflag,
    l_linestatus
""",
}

Q1_WIDE = """
select l_returnflag, l_linestatus, l_shipmode, l_shipinstruct,
       count(*) as n, sum(l_quantity) as sq, avg(l_discount) as ad,
       min(cast(l_partkey as float)) as mn, max(cast(l_suppkey as float)) as mx
from lineitem where l_shipdate <= date '1998-09-02'
group by l_returnflag, l_linestatus, l_shipmode, l_shipinstruct
order by l_returnflag, l_linestatus, l_shipmode, l_shipinstruct
"""
