"""Vectorized TPC-H data generator (spec-shaped dbgen).

Produces the eight TPC-H tables as Arrow tables with the spec's schema,
key structure, value domains and the text patterns the 22 queries
predicate on (Brand#MN, container/type vocabularies, p_name words,
comment injections, phone country codes, date windows). Row counts and
distributions follow the TPC-H specification section 4.2; text is
simplified (random word sequences rather than the spec's grammar) except
where queries match on it. Reference peer: the dbgen tool invoked by
TPCHQuerySuite (reference: sql/core/.../TPCHQuerySuite.scala:26).
"""

from __future__ import annotations

import datetime
import json
import os
import resource
import shutil
import time
from typing import Dict, Optional

import numpy as np
import pyarrow as pa

EPOCH = datetime.date(1970, 1, 1)
START = (datetime.date(1992, 1, 1) - EPOCH).days      # o_orderdate low
END = (datetime.date(1998, 8, 2) - EPOCH).days        # o_orderdate high

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]

# (nation, region index) — spec Table 4.2.3
NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]

SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
INSTRUCTIONS = ["DELIVER IN PERSON", "COLLECT COD", "NONE",
                "TAKE BACK RETURN"]

TYPE_S1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_S2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_S3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
CONTAINER_S1 = ["SM", "LG", "MED", "JUMBO", "WRAP"]
CONTAINER_S2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]

P_NAME_WORDS = [
    "almond", "antique", "aquamarine", "azure", "beige", "bisque", "black",
    "blanched", "blue", "blush", "brown", "burlywood", "burnished",
    "chartreuse", "chiffon", "chocolate", "coral", "cornflower", "cornsilk",
    "cream", "cyan", "dark", "deep", "dim", "dodger", "drab", "firebrick",
    "floral", "forest", "frosted", "gainsboro", "ghost", "goldenrod",
    "green", "grey", "honeydew", "hot", "indian", "ivory", "khaki",
    "lace", "lavender", "lawn", "lemon", "light", "lime", "linen",
    "magenta", "maroon", "medium", "metallic", "midnight", "mint", "misty",
    "moccasin", "navajo", "navy", "olive", "orange", "orchid", "pale",
    "papaya", "peach", "peru", "pink", "plum", "powder", "puff", "purple",
    "red", "rose", "rosy", "royal", "saddle", "salmon", "sandy", "seashell",
    "sienna", "sky", "slate", "smoke", "snow", "spring", "steel", "tan",
    "thistle", "tomato", "turquoise", "violet", "wheat", "white", "yellow",
]

_COMMENT_WORDS = np.array([
    "carefully", "quickly", "furiously", "slyly", "blithely", "deposits",
    "requests", "packages", "accounts", "instructions", "foxes", "ideas",
    "theodolites", "pinto", "beans", "asymptotes", "dependencies", "somas",
    "platelets", "sleep", "haggle", "nag", "wake", "cajole", "detect",
    "integrate", "boost", "among", "final", "ironic", "express", "regular",
    "bold", "even", "silent", "pending", "special", "unusual",
])


MONEY = pa.decimal128(12, 2)


def _decimal_col(unscaled: np.ndarray, typ=MONEY) -> pa.Array:
    from spark_tpu_torch.columnar.arrow import decimal_from_unscaled

    return decimal_from_unscaled(unscaled, typ)


def _money(rng, n, lo, hi) -> pa.Array:
    """Money columns are DECIMAL(12,2) per the TPC-H spec (the engine
    executes them as exact scaled int64; reference: Decimal.scala)."""
    cents = rng.integers(round(lo * 100), round(hi * 100) + 1, n)
    return _decimal_col(cents)


def _words(rng, n: int, k: int) -> np.ndarray:
    """k-word random comment strings."""
    idx = rng.integers(0, len(_COMMENT_WORDS), (n, k))
    parts = _COMMENT_WORDS[idx]
    out = parts[:, 0]
    for j in range(1, k):
        out = np.char.add(np.char.add(out, " "), parts[:, j])
    return out


def _pick(rng, n, values) -> np.ndarray:
    return np.array(values)[rng.integers(0, len(values), n)]


# ---- dictionary-encoded column builders -------------------------------------
#
# Emitting pa.DictionaryArray (int32 indices + a small vocabulary)
# instead of materialized string arrays is the whole speedup: the old
# path built millions of numpy strings and then `list()`-converted them
# for pyarrow (~160 s at SF1). The engine dictionary-encodes strings on
# ingest anyway, so this also skips a conversion on the read side.


def _dict_col(indices: np.ndarray, vocab) -> pa.DictionaryArray:
    return pa.DictionaryArray.from_arrays(
        pa.array(indices.astype(np.int32), pa.int32()),
        pa.array(list(vocab), pa.string()))


def _pick_dict(rng, n, values) -> pa.DictionaryArray:
    return _dict_col(rng.integers(0, len(values), n), values)


def _words_dict(rng, n: int, k: int, pool: int = 4096,
                inject=None) -> pa.DictionaryArray:
    """Comment column as a dictionary over ``pool`` pre-built k-word
    strings. ``inject`` = (row_indices, strings) appends extra vocab
    entries and points those rows at them (q13/q16 pattern rows)."""
    pool = min(pool, max(64, n))
    vocab = list(_words(rng, pool, k))
    idx = rng.integers(0, pool, n)
    if inject is not None:
        rows, strings = inject
        strings = list(dict.fromkeys(strings))  # vocab must be unique
        if len(rows) and strings:
            base = len(vocab)
            vocab.extend(strings)
            idx[rows] = base + np.arange(len(rows)) % len(strings)
    return _dict_col(idx, vocab)


def _numbered(prefix: str, keys: np.ndarray) -> np.ndarray:
    """'Prefix#%09d' strings, vectorized (no Python format loop)."""
    return np.char.add(
        prefix, np.char.zfill(keys.astype(np.int64).astype(str), 9))


def _numbered_names(prefix: str, keys: np.ndarray) -> pa.Array:
    return pa.array(_numbered(prefix, keys))


def generate_tables(sf: float = 0.01,
                    seed: int = 20260729) -> Dict[str, pa.Table]:
    """All eight tables at scale factor ``sf`` (sf=1 is ~6M lineitems).
    In host RAM: for sf <= ~10; above that use write_parquet_streamed
    (SF100 lineitem alone would need ~80 GB of host arrays)."""
    rng = np.random.default_rng(seed)
    tables, ctx = _gen_static(sf, rng)
    n_ord = max(1, int(1_500_000 * sf))
    orders, lineitem = _gen_orders_slice(rng, 1, n_ord + 1, ctx)
    tables["orders"] = orders
    tables["lineitem"] = lineitem
    return tables


def _gen_static(sf: float, rng) -> tuple:
    """The six non-order tables plus the context the orders/lineitem
    generator needs (part retail prices, key cardinalities)."""
    tables: Dict[str, pa.Table] = {}
    ctx = _order_ctx(sf)

    # region / nation --------------------------------------------------------
    tables["region"] = pa.table({
        "r_regionkey": pa.array(np.arange(5), pa.int64()),
        "r_name": pa.array(REGIONS),
        "r_comment": pa.array(list(_words(rng, 5, 6))),
    })
    tables["nation"] = pa.table({
        "n_nationkey": pa.array(np.arange(25), pa.int64()),
        "n_name": pa.array([n for n, _ in NATIONS]),
        "n_regionkey": pa.array(np.array([r for _, r in NATIONS]),
                                pa.int64()),
        "n_comment": pa.array(list(_words(rng, 25, 8))),
    })

    # part --------------------------------------------------------------------
    n_part = ctx["n_part"]
    pk = np.arange(1, n_part + 1)
    # p_name: 5-word strings from a pooled vocabulary (q9 predicates on
    # '%green%' — the pool keeps every color word's hit rate intact)
    name_pool = min(8192, max(64, n_part))
    wl = np.array(P_NAME_WORDS)
    nm = wl[rng.integers(0, len(wl), (name_pool, 5))]
    name_vocab = nm[:, 0]
    for j in range(1, 5):
        name_vocab = np.char.add(np.char.add(name_vocab, " "), nm[:, j])
    brand_m = rng.integers(1, 6, n_part)
    brand_n = rng.integers(1, 6, n_part)
    brand_vocab = [f"Brand#{m}{n}" for m in range(1, 6)
                   for n in range(1, 6)]
    type_vocab = [f"{a} {b} {c}" for a in TYPE_S1 for b in TYPE_S2
                  for c in TYPE_S3]
    cont_vocab = [f"{a} {b}" for a in CONTAINER_S1 for b in CONTAINER_S2]
    retail_cents = ctx["retail_cents"]
    tables["part"] = pa.table({
        "p_partkey": pa.array(pk, pa.int64()),
        "p_name": _dict_col(rng.integers(0, name_pool, n_part),
                            name_vocab),
        "p_mfgr": _dict_col(brand_m - 1,
                            [f"Manufacturer#{m}" for m in range(1, 6)]),
        "p_brand": _dict_col((brand_m - 1) * 5 + (brand_n - 1),
                             brand_vocab),
        "p_type": _pick_dict(rng, n_part, type_vocab),
        "p_size": pa.array(rng.integers(1, 51, n_part), pa.int32()),
        "p_container": _pick_dict(rng, n_part, cont_vocab),
        "p_retailprice": _decimal_col(retail_cents),
        "p_comment": _words_dict(rng, n_part, 3),
    })

    # supplier ----------------------------------------------------------------
    n_supp = ctx["n_supp"]
    sk = np.arange(1, n_supp + 1)
    s_nation = rng.integers(0, 25, n_supp)
    # q16: ~5 per 10k suppliers carry 'Customer...Complaints'
    bad = rng.choice(n_supp, size=max(1, n_supp // 2000), replace=False)
    bad_strings = [f"Customer {w} Complaints"
                   for w in _words(rng, len(bad), 2)]
    tables["supplier"] = pa.table({
        "s_suppkey": pa.array(sk, pa.int64()),
        "s_name": _numbered_names("Supplier#", sk),
        "s_address": _words_dict(rng, n_supp, 3),
        "s_nationkey": pa.array(s_nation, pa.int64()),
        "s_phone": pa.array(_phones(rng, s_nation)),
        "s_acctbal": pa.array(_money(rng, n_supp, -999.99, 9999.99)),
        "s_comment": _words_dict(rng, n_supp, 8,
                                 inject=(bad, bad_strings)),
    })

    # partsupp ----------------------------------------------------------------
    ps_part = np.repeat(pk, 4)
    ps_supp = np.empty(len(ps_part), dtype=np.int64)
    for j in range(4):
        # spec: supplier = (partkey + j*(S/4 + (partkey-1)//S)) % S + 1
        ps_supp[j::4] = (pk + j * (n_supp // 4 + (pk - 1) // n_supp)) \
            % n_supp + 1
    tables["partsupp"] = pa.table({
        "ps_partkey": pa.array(ps_part, pa.int64()),
        "ps_suppkey": pa.array(ps_supp, pa.int64()),
        "ps_availqty": pa.array(rng.integers(1, 10_000, len(ps_part)),
                                pa.int32()),
        "ps_supplycost": pa.array(_money(rng, len(ps_part), 1.0, 1000.0)),
        "ps_comment": _words_dict(rng, len(ps_part), 5),
    })

    # customer ----------------------------------------------------------------
    n_cust, ck = ctx["n_cust"], ctx["ck"]
    c_nation = rng.integers(0, 25, n_cust)
    # q13: some customers' orders carry 'special ... requests' comments —
    # handled on orders below
    tables["customer"] = pa.table({
        "c_custkey": pa.array(ck, pa.int64()),
        "c_name": _numbered_names("Customer#", ck),
        "c_address": _words_dict(rng, n_cust, 3),
        "c_nationkey": pa.array(c_nation, pa.int64()),
        "c_phone": pa.array(_phones(rng, c_nation)),
        "c_acctbal": pa.array(_money(rng, n_cust, -999.99, 9999.99)),
        "c_mktsegment": _pick_dict(rng, n_cust, SEGMENTS),
        "c_comment": _words_dict(rng, n_cust, 6),
    })

    return tables, ctx


def _order_ctx(sf: float) -> Dict:
    """The key cardinalities, customer keys and part retail prices that
    the static tables and the orders/lineitem generator share: a function
    of ``sf`` alone, so a slice can be made without the static tables."""
    n_part = max(1, int(200_000 * sf))
    n_cust = max(1, int(150_000 * sf))
    pk = np.arange(1, n_part + 1)
    # spec: (90000 + ((partkey/10) mod 20001) + 100*(partkey mod 1000))/100
    return {"n_part": n_part, "n_supp": max(1, int(10_000 * sf)),
            "n_cust": n_cust, "ck": np.arange(1, n_cust + 1),
            "retail_cents": 90000 + (pk // 10) % 20001 + 100 * (pk % 1000)}


def _gen_orders_slice(rng, ok_lo: int, ok_hi: int,
                      ctx: Dict) -> tuple:
    """orders + their lineitems for order keys [ok_lo, ok_hi) — the unit
    of streamed generation (SF100 cannot hold all 600M lineitems as host
    arrays at once)."""
    n_part, n_supp, n_cust = ctx["n_part"], ctx["n_supp"], ctx["n_cust"]
    ck, retail_cents = ctx["ck"], ctx["retail_cents"]
    n_ord = ok_hi - ok_lo
    ok = np.arange(ok_lo, ok_hi)
    # spec: only 2/3 of customers have orders
    cust_with_orders = ck[ck % 3 != 0] if n_cust >= 3 else ck
    o_cust = cust_with_orders[rng.integers(0, len(cust_with_orders), n_ord)]
    o_date = rng.integers(START, END - 150, n_ord)
    special = np.nonzero(rng.random(n_ord) < 0.02)[0]
    special_strings = [f"special {w} requests"
                       for w in _words(rng, min(max(len(special), 1),
                                                512), 2)]
    n_clerks = max(2, n_ord // 1000)
    clerk_vocab = _numbered("Clerk#", np.arange(1, n_clerks))
    orders = pa.table({
        "o_orderkey": pa.array(ok, pa.int64()),
        "o_custkey": pa.array(o_cust, pa.int64()),
        "o_orderstatus": _pick_dict(rng, n_ord, ["O", "F", "P"]),
        "o_totalprice": pa.array(_money(rng, n_ord, 900.0, 450_000.0)),
        "o_orderdate": pa.array(o_date.astype("int32"), pa.int32()).cast(
            pa.date32()),
        "o_orderpriority": _pick_dict(rng, n_ord, PRIORITIES),
        "o_clerk": _dict_col(rng.integers(0, len(clerk_vocab), n_ord),
                             clerk_vocab),
        "o_shippriority": pa.array(np.zeros(n_ord, dtype=np.int32),
                                   pa.int32()),
        "o_comment": _words_dict(rng, n_ord, 5,
                                 inject=(special, special_strings)),
    })

    # lineitem ----------------------------------------------------------------
    lines_per = rng.integers(1, 8, n_ord)
    l_order = np.repeat(ok, lines_per)
    l_odate = np.repeat(o_date, lines_per)
    n_li = len(l_order)
    # per-order line numbers without a Python loop: global position
    # minus the order's starting offset
    starts = np.cumsum(lines_per) - lines_per
    l_line = (np.arange(n_li) - np.repeat(starts, lines_per) + 1) \
        .astype(np.int64)
    l_part = rng.integers(1, n_part + 1, n_li)
    # supplier must be one of the part's 4 partsupp suppliers (q9 join)
    which = rng.integers(0, 4, n_li)
    l_supp = (l_part + which * (n_supp // 4 + (l_part - 1) // n_supp)) \
        % n_supp + 1
    l_qty = rng.integers(1, 51, n_li)
    l_price_cents = l_qty * retail_cents[l_part - 1]
    ship = l_odate + rng.integers(1, 122, n_li)
    commit = l_odate + rng.integers(30, 91, n_li)
    receipt = ship + rng.integers(1, 31, n_li)
    today = (datetime.date(1995, 6, 17) - EPOCH).days
    # returnflag vocab [R, A, N]; linestatus vocab [O, F]
    rf_idx = np.where(receipt <= today, rng.integers(0, 2, n_li), 2)
    ls_idx = np.where(ship > today, 0, 1)
    lineitem = pa.table({
        "l_orderkey": pa.array(l_order, pa.int64()),
        "l_partkey": pa.array(l_part, pa.int64()),
        "l_suppkey": pa.array(l_supp, pa.int64()),
        "l_linenumber": pa.array(l_line, pa.int32()),
        "l_quantity": _decimal_col(l_qty * 100),
        "l_extendedprice": _decimal_col(l_price_cents),
        "l_discount": _decimal_col(rng.integers(0, 11, n_li)),
        "l_tax": _decimal_col(rng.integers(0, 9, n_li)),
        "l_returnflag": _dict_col(rf_idx, ["R", "A", "N"]),
        "l_linestatus": _dict_col(ls_idx, ["O", "F"]),
        "l_shipdate": pa.array(ship.astype("int32"), pa.int32()).cast(
            pa.date32()),
        "l_commitdate": pa.array(commit.astype("int32"), pa.int32()).cast(
            pa.date32()),
        "l_receiptdate": pa.array(receipt.astype("int32"), pa.int32()).cast(
            pa.date32()),
        "l_shipinstruct": _pick_dict(rng, n_li, INSTRUCTIONS),
        "l_shipmode": _pick_dict(rng, n_li, SHIPMODES),
        "l_comment": _words_dict(rng, n_li, 4),
    })
    return orders, lineitem


def _phones(rng, nationkeys: np.ndarray):
    """Spec phone format: 'CC-xxx-xxx-xxxx' with CC = nationkey + 10
    (q22 matches on the country-code prefix)."""
    cc = (nationkeys + 10).astype(str)
    parts = [rng.integers(100, 1000, len(nationkeys)).astype(str),
             rng.integers(100, 1000, len(nationkeys)).astype(str),
             rng.integers(1000, 10_000, len(nationkeys)).astype(str)]
    out = cc
    for p in parts:
        out = np.char.add(np.char.add(out, "-"), p)
    return out


#: the eight tables, in the order the writers and ``register_views`` take
TABLES = ("region", "nation", "part", "supplier", "partsupp", "customer",
          "orders", "lineitem")

#: row groups of the streamed writer's part files
ROW_GROUP_ROWS = 1 << 20


def write_parquet(tables: Dict[str, pa.Table], path: str) -> None:
    """Each table as ``<path>/<name>.parquet``, one file each."""
    import pyarrow.parquet as pq

    os.makedirs(path, exist_ok=True)
    for name, tbl in tables.items():
        pq.write_table(tbl, os.path.join(path, f"{name}.parquet"))


def _peak_rss_bytes() -> int:
    """This process's peak resident set (Linux reports KiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def _write_slice(sf: float, path: str, seed: int, i: int, lo: int,
                 hi: int) -> Dict:
    """Orders [lo, hi) and their lineitems, generated from
    ``default_rng([seed, i])`` and written as part ``i`` of
    ``orders.parquet/`` and ``lineitem.parquet/``; its seconds and the
    process's peak RSS."""
    import pyarrow.parquet as pq

    t0 = time.perf_counter()
    orders, lineitem = _gen_orders_slice(np.random.default_rng([seed, i]),
                                         lo, hi, _order_ctx(sf))
    part = f"part-{i:05d}.parquet"
    pq.write_table(orders, os.path.join(path, "orders.parquet", part),
                   row_group_size=ROW_GROUP_ROWS)
    pq.write_table(lineitem, os.path.join(path, "lineitem.parquet", part),
                   row_group_size=ROW_GROUP_ROWS)
    return {"part": i, "orders": hi - lo, "lineitem": lineitem.num_rows,
            "seconds": time.perf_counter() - t0,
            "peak_rss_bytes": _peak_rss_bytes()}


def write_parquet_streamed(sf: float, path: str, seed: int = 20260729,
                           orders_per_slice: int = 4_000_000,
                           workers: int = 1) -> Dict:
    """Generation past host RAM: the six static tables are written whole;
    orders and lineitem are generated and written in slices of
    ``orders_per_slice`` orders (~4x lineitems), so peak host RAM is one
    slice a process (PERF.md has the measured sizes) instead of the full
    ~100 GB at SF100.
    ``orders.parquet/`` and ``lineitem.parquet/`` become directories of
    ``part-%05d.parquet``, the multi-part layout every dbgen -S chunk run
    produces; slice i draws from ``default_rng([seed, i])``. Slices are
    seeded independently, so ``workers`` > 1 writes them in that many
    spawned processes (beside the static tables), to the same files.

    Returns the seconds of the static tables and of the slices (their
    wall, and each slice's own with its process's peak RSS)."""
    import pyarrow.parquet as pq

    for sub in ("orders.parquet", "lineitem.parquet"):
        os.makedirs(os.path.join(path, sub), exist_ok=True)
    n_ord = max(1, int(1_500_000 * sf))
    slices = [(i, lo, min(lo + orders_per_slice, n_ord + 1)) for i, lo in
              enumerate(range(1, n_ord + 1, orders_per_slice))]

    def statics() -> float:
        t0 = time.perf_counter()
        tables, _ = _gen_static(sf, np.random.default_rng(seed))
        for name, tbl in tables.items():
            pq.write_table(tbl, os.path.join(path, f"{name}.parquet"))
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    if workers > 1 and len(slices) > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(
                max_workers=min(workers, len(slices)),
                mp_context=multiprocessing.get_context("spawn")) as pool:
            futures = [pool.submit(_write_slice, sf, path, seed, *s)
                       for s in slices]
            statics_s = statics()
            done = [f.result() for f in futures]
    else:
        statics_s = statics()
        done = [_write_slice(sf, path, seed, *s) for s in slices]
    return {"statics_s": statics_s, "slices_s": time.perf_counter() - t0,
            "slices": done, "peak_rss_bytes": _peak_rss_bytes()}


def ensure_dataset(sf: float, base: str = "/tmp", seed: int = 20260729, *,
                   streamed: Optional[bool] = None,
                   orders_per_slice: int = 4_000_000,
                   workers: int = 1) -> str:
    """Generate once and keep on disk (SF100 is ~15 min of rng on one
    core; a benchmark must not pay it per run); returns the directory.
    ``write_parquet`` of ``generate_tables`` at sf <= 10, else
    ``write_parquet_streamed``; ``streamed`` forces either writer.

    A ``_DONE`` marker, written last, holds the recipe (sf, seed, writer,
    slice size) and what the generation took. A directory whose marker
    holds this recipe is returned as it is; any other (half written, or
    made by another recipe, whose rows differ) is removed and made
    again. ``workers`` only sets how the streamed writer runs. The
    directory is ``<base>/tpch_sf<sf>`` (sf 0.5: ``tpch_sf0p5``)."""
    path = os.path.join(base, "tpch_sf" + f"{sf:g}".replace(".", "p"))
    marker = os.path.join(path, "_DONE")
    if streamed is None:
        streamed = sf > 10
    recipe = {"sf": sf, "seed": seed,
              "writer": "streamed" if streamed else "memory",
              "orders_per_slice": orders_per_slice if streamed else None}
    if os.path.exists(marker):
        with open(marker) as f:
            try:
                done = json.load(f)
            except ValueError:
                done = {}
        if isinstance(done, dict) and done.get("recipe") == recipe:
            return path
    if os.path.exists(path):
        shutil.rmtree(path)
    t0 = time.perf_counter()
    if streamed:
        report = write_parquet_streamed(sf, path, seed, orders_per_slice,
                                        workers)
    else:
        write_parquet(generate_tables(sf, seed), path)
        report = {"peak_rss_bytes": _peak_rss_bytes()}
    report["seconds"] = time.perf_counter() - t0
    report["bytes"] = sum(
        os.path.getsize(os.path.join(d, f))
        for d, _, files in os.walk(path) for f in files)
    with open(marker, "w") as f:
        json.dump({"recipe": recipe, "report": report}, f)
    return path


def dataset_report(path: str) -> Dict:
    """What ``ensure_dataset`` recorded in ``path``'s marker: the recipe
    and the generation's seconds, bytes on disk and peak RSS."""
    with open(os.path.join(path, "_DONE")) as f:
        return json.load(f)


def register_views(spark, tables: Optional[Dict[str, pa.Table]] = None,
                   path: Optional[str] = None) -> None:
    """Register the TPC-H tables as temp views of ``spark``: each of
    ``tables`` from memory, or the eight of a ``write_parquet`` or
    ``ensure_dataset`` directory through ``spark.read.parquet`` (a part
    directory is one multi-file scan)."""
    if (tables is None) == (path is None):
        raise ValueError("register_views takes tables or path, not both")
    if path is not None:
        for name in TABLES:
            spark.read.parquet(os.path.join(path, f"{name}.parquet")) \
                .createOrReplaceTempView(name)
        return
    for name, tbl in tables.items():
        spark.createDataFrame(tbl).createOrReplaceTempView(name)
