"""TPC-H query texts used by the port: all 22 queries of the TPC-H
specification (rev 2.18, default substitution parameters), copied from
the reference package's query set (``spark_tpu/tpch/queries.py``),
``Q1_WIDE``, and the queries of ``chip_smoke.py``'s window phase
(``WINDOW_QUERIES``) and scalar phase (``SCALAR_QUERIES``).

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
    2: """
select
    s_acctbal,
    s_name,
    n_name,
    p_partkey,
    p_mfgr,
    s_address,
    s_phone,
    s_comment
from
    part,
    supplier,
    partsupp,
    nation,
    region
where
    p_partkey = ps_partkey
    and s_suppkey = ps_suppkey
    and p_size = 15
    and p_type like '%BRASS'
    and s_nationkey = n_nationkey
    and n_regionkey = r_regionkey
    and r_name = 'EUROPE'
    and ps_supplycost = (
        select
            min(ps_supplycost)
        from
            partsupp,
            supplier,
            nation,
            region
        where
            p_partkey = ps_partkey
            and s_suppkey = ps_suppkey
            and s_nationkey = n_nationkey
            and n_regionkey = r_regionkey
            and r_name = 'EUROPE'
    )
order by
    s_acctbal desc,
    n_name,
    s_name,
    p_partkey
limit 100
""",
    3: """
select
    l_orderkey,
    sum(l_extendedprice * (1 - l_discount)) as revenue,
    o_orderdate,
    o_shippriority
from
    customer,
    orders,
    lineitem
where
    c_mktsegment = 'BUILDING'
    and c_custkey = o_custkey
    and l_orderkey = o_orderkey
    and o_orderdate < date '1995-03-15'
    and l_shipdate > date '1995-03-15'
group by
    l_orderkey,
    o_orderdate,
    o_shippriority
order by
    revenue desc,
    o_orderdate
limit 10
""",
    4: """
select
    o_orderpriority,
    count(*) as order_count
from
    orders
where
    o_orderdate >= date '1993-07-01'
    and o_orderdate < date '1993-07-01' + interval '3' month
    and exists (
        select
            *
        from
            lineitem
        where
            l_orderkey = o_orderkey
            and l_commitdate < l_receiptdate
    )
group by
    o_orderpriority
order by
    o_orderpriority
""",
    5: """
select
    n_name,
    sum(l_extendedprice * (1 - l_discount)) as revenue
from
    customer,
    orders,
    lineitem,
    supplier,
    nation,
    region
where
    c_custkey = o_custkey
    and l_orderkey = o_orderkey
    and l_suppkey = s_suppkey
    and c_nationkey = s_nationkey
    and s_nationkey = n_nationkey
    and n_regionkey = r_regionkey
    and r_name = 'ASIA'
    and o_orderdate >= date '1994-01-01'
    and o_orderdate < date '1994-01-01' + interval '1' year
group by
    n_name
order by
    revenue desc
""",
    6: """
select
    sum(l_extendedprice * l_discount) as revenue
from
    lineitem
where
    l_shipdate >= date '1994-01-01'
    and l_shipdate < date '1994-01-01' + interval '1' year
    and l_discount between 0.05 and 0.07
    and l_quantity < 24
""",
    7: """
select
    supp_nation,
    cust_nation,
    l_year,
    sum(volume) as revenue
from
    (
        select
            n1.n_name as supp_nation,
            n2.n_name as cust_nation,
            extract(year from l_shipdate) as l_year,
            l_extendedprice * (1 - l_discount) as volume
        from
            supplier,
            lineitem,
            orders,
            customer,
            nation n1,
            nation n2
        where
            s_suppkey = l_suppkey
            and o_orderkey = l_orderkey
            and c_custkey = o_custkey
            and s_nationkey = n1.n_nationkey
            and c_nationkey = n2.n_nationkey
            and (
                (n1.n_name = 'FRANCE' and n2.n_name = 'GERMANY')
                or (n1.n_name = 'GERMANY' and n2.n_name = 'FRANCE')
            )
            and l_shipdate between date '1995-01-01' and date '1996-12-31'
    ) as shipping
group by
    supp_nation,
    cust_nation,
    l_year
order by
    supp_nation,
    cust_nation,
    l_year
""",
    8: """
select
    o_year,
    sum(case
        when nation = 'BRAZIL' then volume
        else 0
    end) / sum(volume) as mkt_share
from
    (
        select
            extract(year from o_orderdate) as o_year,
            l_extendedprice * (1 - l_discount) as volume,
            n2.n_name as nation
        from
            part,
            supplier,
            lineitem,
            orders,
            customer,
            nation n1,
            nation n2,
            region
        where
            p_partkey = l_partkey
            and s_suppkey = l_suppkey
            and l_orderkey = o_orderkey
            and o_custkey = c_custkey
            and c_nationkey = n1.n_nationkey
            and n1.n_regionkey = r_regionkey
            and r_name = 'AMERICA'
            and s_nationkey = n2.n_nationkey
            and o_orderdate between date '1995-01-01' and date '1996-12-31'
            and p_type = 'ECONOMY ANODIZED STEEL'
    ) as all_nations
group by
    o_year
order by
    o_year
""",
    9: """
select
    nation,
    o_year,
    sum(amount) as sum_profit
from
    (
        select
            n_name as nation,
            extract(year from o_orderdate) as o_year,
            l_extendedprice * (1 - l_discount)
                - ps_supplycost * l_quantity as amount
        from
            part,
            supplier,
            lineitem,
            partsupp,
            orders,
            nation
        where
            s_suppkey = l_suppkey
            and ps_suppkey = l_suppkey
            and ps_partkey = l_partkey
            and p_partkey = l_partkey
            and o_orderkey = l_orderkey
            and s_nationkey = n_nationkey
            and p_name like '%green%'
    ) as profit
group by
    nation,
    o_year
order by
    nation,
    o_year desc
""",
    10: """
select
    c_custkey,
    c_name,
    sum(l_extendedprice * (1 - l_discount)) as revenue,
    c_acctbal,
    n_name,
    c_address,
    c_phone,
    c_comment
from
    customer,
    orders,
    lineitem,
    nation
where
    c_custkey = o_custkey
    and l_orderkey = o_orderkey
    and o_orderdate >= date '1993-10-01'
    and o_orderdate < date '1993-10-01' + interval '3' month
    and l_returnflag = 'R'
    and c_nationkey = n_nationkey
group by
    c_custkey,
    c_name,
    c_acctbal,
    c_phone,
    n_name,
    c_address,
    c_comment
order by
    revenue desc
limit 20
""",
    11: """
select
    ps_partkey,
    sum(ps_supplycost * ps_availqty) as value
from
    partsupp,
    supplier,
    nation
where
    ps_suppkey = s_suppkey
    and s_nationkey = n_nationkey
    and n_name = 'GERMANY'
group by
    ps_partkey
having
    sum(ps_supplycost * ps_availqty) > (
        select
            sum(ps_supplycost * ps_availqty) * 0.0001
        from
            partsupp,
            supplier,
            nation
        where
            ps_suppkey = s_suppkey
            and s_nationkey = n_nationkey
            and n_name = 'GERMANY'
    )
order by
    value desc
""",
    12: """
select
    l_shipmode,
    sum(case
        when o_orderpriority = '1-URGENT'
            or o_orderpriority = '2-HIGH'
        then 1
        else 0
    end) as high_line_count,
    sum(case
        when o_orderpriority <> '1-URGENT'
            and o_orderpriority <> '2-HIGH'
        then 1
        else 0
    end) as low_line_count
from
    orders,
    lineitem
where
    o_orderkey = l_orderkey
    and l_shipmode in ('MAIL', 'SHIP')
    and l_commitdate < l_receiptdate
    and l_shipdate < l_commitdate
    and l_receiptdate >= date '1994-01-01'
    and l_receiptdate < date '1994-01-01' + interval '1' year
group by
    l_shipmode
order by
    l_shipmode
""",
    13: """
select
    c_count,
    count(*) as custdist
from
    (
        select
            c_custkey,
            count(o_orderkey) as c_count
        from
            customer left outer join orders on
                c_custkey = o_custkey
                and o_comment not like '%special%requests%'
        group by
            c_custkey
    ) as c_orders
group by
    c_count
order by
    custdist desc,
    c_count desc
""",
    14: """
select
    100.00 * sum(case
        when p_type like 'PROMO%'
        then l_extendedprice * (1 - l_discount)
        else 0
    end) / sum(l_extendedprice * (1 - l_discount)) as promo_revenue
from
    lineitem,
    part
where
    l_partkey = p_partkey
    and l_shipdate >= date '1995-09-01'
    and l_shipdate < date '1995-09-01' + interval '1' month
""",
    15: """
select
    s_suppkey,
    s_name,
    s_address,
    s_phone,
    total_revenue
from
    supplier,
    (
        select
            l_suppkey as supplier_no,
            sum(l_extendedprice * (1 - l_discount)) as total_revenue
        from
            lineitem
        where
            l_shipdate >= date '1996-01-01'
            and l_shipdate < date '1996-01-01' + interval '3' month
        group by
            l_suppkey
    ) as revenue0
where
    s_suppkey = supplier_no
    and total_revenue = (
        select
            max(total_revenue)
        from
            (
                select
                    l_suppkey as supplier_no,
                    sum(l_extendedprice * (1 - l_discount)) as total_revenue
                from
                    lineitem
                where
                    l_shipdate >= date '1996-01-01'
                    and l_shipdate < date '1996-01-01' + interval '3' month
                group by
                    l_suppkey
            ) as revenue1
    )
order by
    s_suppkey
""",
    16: """
select
    p_brand,
    p_type,
    p_size,
    count(distinct ps_suppkey) as supplier_cnt
from
    partsupp,
    part
where
    p_partkey = ps_partkey
    and p_brand <> 'Brand#45'
    and p_type not like 'MEDIUM POLISHED%'
    and p_size in (49, 14, 23, 45, 19, 3, 36, 9)
    and ps_suppkey not in (
        select
            s_suppkey
        from
            supplier
        where
            s_comment like '%Customer%Complaints%'
    )
group by
    p_brand,
    p_type,
    p_size
order by
    supplier_cnt desc,
    p_brand,
    p_type,
    p_size
""",
    17: """
select
    sum(l_extendedprice) / 7.0 as avg_yearly
from
    lineitem,
    part
where
    p_partkey = l_partkey
    and p_brand = 'Brand#23'
    and p_container = 'MED BOX'
    and l_quantity < (
        select
            0.2 * avg(l_quantity)
        from
            lineitem
        where
            l_partkey = p_partkey
    )
""",
    18: """
select
    c_name,
    c_custkey,
    o_orderkey,
    o_orderdate,
    o_totalprice,
    sum(l_quantity)
from
    customer,
    orders,
    lineitem
where
    o_orderkey in (
        select
            l_orderkey
        from
            lineitem
        group by
            l_orderkey
        having
            sum(l_quantity) > 300
    )
    and c_custkey = o_custkey
    and o_orderkey = l_orderkey
group by
    c_name,
    c_custkey,
    o_orderkey,
    o_orderdate,
    o_totalprice
order by
    o_totalprice desc,
    o_orderdate
limit 100
""",
    19: """
select
    sum(l_extendedprice * (1 - l_discount)) as revenue
from
    lineitem,
    part
where
    (
        p_partkey = l_partkey
        and p_brand = 'Brand#12'
        and p_container in ('SM CASE', 'SM BOX', 'SM PACK', 'SM PKG')
        and l_quantity >= 1 and l_quantity <= 1 + 10
        and p_size between 1 and 5
        and l_shipmode in ('AIR', 'AIR REG')
        and l_shipinstruct = 'DELIVER IN PERSON'
    )
    or
    (
        p_partkey = l_partkey
        and p_brand = 'Brand#23'
        and p_container in ('MED BAG', 'MED BOX', 'MED PKG', 'MED PACK')
        and l_quantity >= 10 and l_quantity <= 10 + 10
        and p_size between 1 and 10
        and l_shipmode in ('AIR', 'AIR REG')
        and l_shipinstruct = 'DELIVER IN PERSON'
    )
    or
    (
        p_partkey = l_partkey
        and p_brand = 'Brand#34'
        and p_container in ('LG CASE', 'LG BOX', 'LG PACK', 'LG PKG')
        and l_quantity >= 20 and l_quantity <= 20 + 10
        and p_size between 1 and 15
        and l_shipmode in ('AIR', 'AIR REG')
        and l_shipinstruct = 'DELIVER IN PERSON'
    )
""",
    20: """
select
    s_name,
    s_address
from
    supplier,
    nation
where
    s_suppkey in (
        select
            ps_suppkey
        from
            partsupp
        where
            ps_partkey in (
                select
                    p_partkey
                from
                    part
                where
                    p_name like 'forest%'
            )
            and ps_availqty > (
                select
                    0.5 * sum(l_quantity)
                from
                    lineitem
                where
                    l_partkey = ps_partkey
                    and l_suppkey = ps_suppkey
                    and l_shipdate >= date '1994-01-01'
                    and l_shipdate < date '1994-01-01' + interval '1' year
            )
    )
    and s_nationkey = n_nationkey
    and n_name = 'CANADA'
order by
    s_name
""",
    21: """
select
    s_name,
    count(*) as numwait
from
    supplier,
    lineitem l1,
    orders,
    nation
where
    s_suppkey = l1.l_suppkey
    and o_orderkey = l1.l_orderkey
    and o_orderstatus = 'F'
    and l1.l_receiptdate > l1.l_commitdate
    and exists (
        select
            *
        from
            lineitem l2
        where
            l2.l_orderkey = l1.l_orderkey
            and l2.l_suppkey <> l1.l_suppkey
    )
    and not exists (
        select
            *
        from
            lineitem l3
        where
            l3.l_orderkey = l1.l_orderkey
            and l3.l_suppkey <> l1.l_suppkey
            and l3.l_receiptdate > l3.l_commitdate
    )
    and s_nationkey = n_nationkey
    and n_name = 'SAUDI ARABIA'
group by
    s_name
order by
    numwait desc,
    s_name
limit 100
""",
    22: """
select
    cntrycode,
    count(*) as numcust,
    sum(c_acctbal) as totacctbal
from
    (
        select
            substring(c_phone, 1, 2) as cntrycode,
            c_acctbal
        from
            customer
        where
            substring(c_phone, 1, 2) in
                ('13', '31', '23', '29', '30', '18', '17')
            and c_acctbal > (
                select
                    avg(c_acctbal)
                from
                    customer
                where
                    c_acctbal > 0.00
                    and substring(c_phone, 1, 2) in
                        ('13', '31', '23', '29', '30', '18', '17')
            )
            and not exists (
                select
                    *
                from
                    orders
                where
                    o_custkey = c_custkey
            )
    ) as custsale
group by
    cntrycode
order by
    cntrycode
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

# chip_smoke.py's window phase over the TPC-H tables: window functions,
# grouping sets and set operations, each reduced to a few rows. Every
# window is ordered by a unique key or computes what ties cannot change.
WINDOW_QUERIES = {
    # top 3 orders per customer: row_number over 1.5M orders
    "w1_topn": """
select count(*) as n, sum(o_totalprice) as total
from (select o_totalprice,
             row_number() over (partition by o_custkey
                                order by o_totalprice desc, o_orderkey) as rn
      from orders) t
where rn <= 3
""",
    # a running sum and a rank over lineitem's 6M rows: two specs, two
    # sorts
    "w2_running": """
select l_returnflag, count(*) as n, sum(running) as s_running,
       sum(rk) as s_rank, max(rk) as max_rank
from (select l_returnflag,
             sum(l_extendedprice) over (
                 partition by l_orderkey order by l_linenumber
                 rows between unbounded preceding and current row) as running,
             rank() over (partition by l_orderkey
                          order by l_quantity desc) as rk
      from lineitem) t
group by l_returnflag
order by l_returnflag
""",
    # lag and a sliding 7-row frame over orders: min and max through the
    # sparse table, avg through prefix differences
    "w3_sliding": """
select o_orderpriority, count(*) as n, sum(prev_price) as s_prev,
       count(prev_price) as n_prev, sum(min7) as s_min7,
       sum(max7) as s_max7, sum(avg7) as s_avg7
from (select o_orderpriority,
             lag(o_totalprice, 1) over (
                 partition by o_orderpriority
                 order by o_orderdate, o_orderkey) as prev_price,
             min(o_totalprice) over (
                 partition by o_orderpriority order by o_orderdate, o_orderkey
                 rows between 6 preceding and current row) as min7,
             max(o_totalprice) over (
                 partition by o_orderpriority order by o_orderdate, o_orderkey
                 rows between 6 preceding and current row) as max7,
             avg(o_totalprice) over (
                 partition by o_orderpriority order by o_orderdate, o_orderkey
                 rows between 6 preceding and current row) as avg7
      from orders) t
group by o_orderpriority
order by o_orderpriority
""",
    # TPC-H q1's filter and sums under ROLLUP
    "r1_rollup": """
select l_returnflag, l_linestatus, grouping_id() as gid,
       sum(l_quantity) as sum_qty, sum(l_extendedprice) as sum_base_price,
       sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
       count(*) as count_order
from lineitem
where l_shipdate <= date '1998-12-01' - interval '90' day
group by rollup (l_returnflag, l_linestatus)
order by l_returnflag, l_linestatus
""",
    "c1_cube": """
select l_shipmode, l_returnflag, count(*) as n,
       sum(l_extendedprice) as revenue
from lineitem
group by cube (l_shipmode, l_returnflag)
order by l_shipmode, l_returnflag
""",
    "s1_intersect": """
select count(*) as n
from (select o_custkey from orders where o_orderpriority = '1-URGENT'
      intersect
      select c_custkey from customer where c_mktsegment = 'BUILDING') t
""",
    "s1_except": """
select count(*) as n
from (select o_custkey from orders where o_orderpriority = '1-URGENT'
      except
      select c_custkey from customer where c_mktsegment = 'BUILDING') t
""",
    "s1_union": """
select count(*) as n
from (select l_orderkey from lineitem where l_shipmode = 'AIR'
      union
      select l_orderkey from lineitem where l_quantity > 45) t
""",
}

# sqlite has no ROLLUP or CUBE: the UNION ALL of the GROUP BYs that each
# grouping-sets query stands for; the other window-phase queries run in
# sqlite as written
_R1_SUMS = """sum(l_quantity), sum(l_extendedprice),
       sum(l_extendedprice * (1 - l_discount)), count(*)
from lineitem where l_shipdate <= date '1998-12-01' - interval '90' day"""
WINDOW_ORACLE_QUERIES = {
    "r1_rollup": f"""
select l_returnflag, l_linestatus, 0, {_R1_SUMS}
group by l_returnflag, l_linestatus
union all
select l_returnflag, null, 1, {_R1_SUMS}
group by l_returnflag
union all
select null, null, 3, {_R1_SUMS}
""",
    "c1_cube": """
select l_shipmode, l_returnflag, count(*), sum(l_extendedprice)
from lineitem group by l_shipmode, l_returnflag
union all
select l_shipmode, null, count(*), sum(l_extendedprice)
from lineitem group by l_shipmode
union all
select null, l_returnflag, count(*), sum(l_extendedprice)
from lineitem group by l_returnflag
union all
select null, null, count(*), sum(l_extendedprice) from lineitem
""",
}


# chip_smoke.py's scalar phase over the TPC-H tables (A1_AGGS: the float
# aggregates of each A1 query): grouped float
# aggregates (stddev, variance and avg of sqrt, whose float64 sums take
# seg_fsum on the card) at three group counts, percentiles, string
# transforms over host dictionaries, date functions, math over decimals,
# and timestamps (over ``ts_orders``, which ``timestamp_table`` builds).
A1_AGGS = """count(*) as n,
       stddev_samp(l_extendedprice) as sd_price,
       var_pop(l_quantity) as var_qty,
       avg(sqrt(l_extendedprice)) as avg_sqrt_price"""
_A1_ORACLE_AGGS = """count(*) as n,
       sqrt((sum(l_extendedprice * l_extendedprice)
             - sum(l_extendedprice) * sum(l_extendedprice) / count(*))
            / (count(*) - 1)) as sd_price,
       (sum(l_quantity * l_quantity)
        - sum(l_quantity) * sum(l_quantity) / count(*)) / count(*)
           as var_qty,
       avg(sqrt(l_extendedprice)) as avg_sqrt_price"""
_Q1_WIDE_KEYS = "l_returnflag, l_linestatus, l_shipmode, l_shipinstruct"
_M1_BODY = """from lineitem group by l_returnflag order by l_returnflag"""

SCALAR_QUERIES = {
    # K = 6: the masked path, float sums through seg_fsum
    "a1_6": f"""
select l_returnflag, l_linestatus, {A1_AGGS}
from lineitem group by l_returnflag, l_linestatus
order by l_returnflag, l_linestatus
""",
    # K = 168: the direct path (counts through the seg_sum kernel)
    "a1_168": f"""
select {_Q1_WIDE_KEYS}, {A1_AGGS}
from lineitem where l_shipdate <= date '1998-09-02'
group by {_Q1_WIDE_KEYS} order by {_Q1_WIDE_KEYS}
""",
    # 10,000 suppliers: the sorted path, K = 10,240 float groups
    "a1_sorted": f"""
select l_suppkey, {A1_AGGS}
from lineitem group by l_suppkey order by l_suppkey
""",
    "p1_percentile": """
select l_returnflag, l_linestatus,
       percentile_approx(l_quantity, 0.5) as p50_qty,
       median(l_extendedprice) as median_price,
       percentile(l_discount, 0.9) as p90_disc
from lineitem group by l_returnflag, l_linestatus
order by l_returnflag, l_linestatus
""",
    # country code (25 entries from c_phone's 150k) x segment (5)
    "s2a_strings": """
select cc, seg, count(*) as n, sum(name_len) as name_len
from (select substr(c_phone, 1, 2) as cc, upper(c_mktsegment) as seg,
             length(c_name) as name_len from customer) t
group by cc, seg order by cc, seg
""",
    "s2b_regexp": """
select prio, st, count(*) as n, max(clerk) as last_clerk
from (select replace(o_orderpriority, '-', ' ') as prio,
             lpad(trim(o_orderstatus), 3, '*') as st,
             lpad(o_clerk, 18, '_') as clerk
      from orders where regexp_like(o_comment, 'special.*requests')) t
group by prio, st order by prio, st
""",
    # n_name || '-' || r_name: a 25 x 5 dictionary product
    "s2c_concat": """
select n_name || '-' || r_name as place, count(*) as n
from customer, nation, region
where c_nationkey = n_nationkey and n_regionkey = r_regionkey
group by n_name || '-' || r_name order by place
""",
    "d1_dates": """
select m, count(*) as n, sum(q) as sq, sum(dw) as sdw, sum(ld) as sld,
       sum(d30) as sd30, max(lm) as last_month_end
from (select date_trunc('month', l_shipdate) as m,
             quarter(l_shipdate) as q, dayofweek(l_shipdate) as dw,
             day(last_day(l_shipdate)) as ld,
             day(date_add(l_shipdate, 30)) as d30,
             last_day(l_shipdate) as lm from lineitem) t
group by m order by m
""",
    "m1_decimal_math": f"""
select l_returnflag,
       sum(round(l_extendedprice * (1 - l_discount), 0)) as s_round,
       sum(floor(l_tax * 100)) as s_floor,
       max(greatest(l_tax, l_discount)) as g,
       count(nullif(l_linenumber, 1)) as n_nl,
       sum(pmod(l_orderkey, 7)) as s_pmod,
       sum(abs(l_extendedprice - 50000)) as s_abs,
       sum(sign(l_extendedprice - 50000)) as s_sign
{_M1_BODY}
""",
    "t1_timestamps": """
select h, count(*) as n, sum(mi) as s_minute, sum(se) as s_second,
       sum(after_lit) as n_after, sum(before_str) as n_before
from (select hour(o_ts) as h, minute(o_ts) as mi, second(o_ts) as se,
             case when o_ts >= timestamp '1995-06-17 12:00:00'
                  then 1 else 0 end as after_lit,
             case when o_ts < '1996-01-01 06:30:00'
                  then 1 else 0 end as before_str
      from ts_orders) t
group by h order by h
""",
}

#: the scalar queries in sqlite's spelling where sqlite computes the same
#: function: A1's variance through the sum of squares, greatest as the
#: two-argument max and pmod through sqlite's remainder
SCALAR_ORACLE_QUERIES = {
    "a1_6": f"""
select l_returnflag, l_linestatus, {_A1_ORACLE_AGGS}
from lineitem group by l_returnflag, l_linestatus
order by l_returnflag, l_linestatus
""",
    "a1_168": f"""
select {_Q1_WIDE_KEYS}, {_A1_ORACLE_AGGS}
from lineitem where l_shipdate <= date '1998-09-02'
group by {_Q1_WIDE_KEYS} order by {_Q1_WIDE_KEYS}
""",
    "a1_sorted": f"""
select l_suppkey, {_A1_ORACLE_AGGS}
from lineitem group by l_suppkey order by l_suppkey
""",
    "s2a_strings": SCALAR_QUERIES["s2a_strings"],
    "s2c_concat": SCALAR_QUERIES["s2c_concat"],
    "m1_decimal_math": f"""
select l_returnflag,
       sum(round(l_extendedprice * (1 - l_discount), 0)) as s_round,
       sum(floor(l_tax * 100)) as s_floor,
       max(max(l_tax, l_discount)) as g,
       count(nullif(l_linenumber, 1)) as n_nl,
       sum(((l_orderkey % 7) + 7) % 7) as s_pmod,
       sum(abs(l_extendedprice - 50000)) as s_abs,
       sum(sign(l_extendedprice - 50000)) as s_sign
{_M1_BODY}
""",
}


def timestamp_table(orders, seed: int):
    """``ts_orders``: o_orderkey and o_ts, a timestamp[us] at o_orderdate
    plus seconds of the day drawn from ``seed``, from the orders table
    (a pyarrow Table)."""
    import numpy as np
    import pyarrow as pa

    rng = np.random.default_rng(seed)
    days = orders.column("o_orderdate").cast(pa.int32()).to_numpy()
    secs = rng.integers(0, 86_400, len(days))
    micros = (days.astype(np.int64) * 86_400 + secs) * 1_000_000
    return pa.table({"o_orderkey": orders.column("o_orderkey"),
                     "o_ts": pa.array(micros, pa.timestamp("us"))})
