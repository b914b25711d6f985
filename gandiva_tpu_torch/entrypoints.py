"""Canonical engine entry points.

``flagship_step`` — the engine's flagship single-card computation: the
BASELINE configs[0] query (filter ``a > 500``, project ``b*2 +
castFLOAT8(a)``) run through the real expression pipeline as one function.

``flagship_stream`` — the same query over K device-resident batches with no
host sync between batches, each batch reduced to a checksum on the device.

``distributed_step`` — the multi-partition execution step: per partition
filter → hash-partition shuffle (all-to-all over the mesh) → grouped
aggregation → row stats summed over the mesh. The shape of every
distributed query the engine runs (data parallel over a 1-axis partition
mesh, ``parallel/``).

``tpch_q1_scan`` / ``tpch_q6_scan`` / ``tpch_q12_scan`` /
``tpch_q19_scan`` — the LINEITEM scans of TPC-H Q1, Q6, Q12 and Q19
(filter and projections, no join, no aggregation) as FilterProject plans
over decimal(15,2) money columns, date32 dates and dictionary-encoded
string flags; ``lineitem`` makes their columns on the device with the
TPC-H distributions, each string column's codes over one fixed
module-level dictionary.

``tpch_q9_part_scan`` / ``tpch_q16_part_scan`` — the PART predicates of
Q9 and Q16; ``part_arrow`` makes PART as a pyarrow batch on the host, and
``part`` brings it onto the device through ``from_arrow``.

``tpch_q22_customer_scan`` — Q22's inner CUSTOMER predicate, a string →
string function (substring) under a string IN beside a decimal compare;
``customer_arrow`` and ``customer`` make CUSTOMER as ``part_arrow`` and
``part`` make PART.

All take ``device`` and default to the card.
"""
from __future__ import annotations

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import torch

from . import dtypes as dt
from .batch import Batch, Column, from_arrow
from .compiler.projector import Filter, FilterProject, Projector
from .device import DEFAULT_DEVICE, resolve_device
from .expr.builder import TreeExprBuilder as B


def _flagship_schema():
    return dt.Schema([dt.Field("a", dt.int64), dt.Field("b", dt.float64)])


def _flagship_plans(device=DEFAULT_DEVICE):
    schema = _flagship_schema()
    na, nb = B.make_field(schema.field("a")), B.make_field(schema.field("b"))
    cond = B.make_condition(
        B.make_function("greater_than", [na, B.make_int64_literal(500)],
                        dt.bool_))
    expr = B.make_expression(
        B.make_function(
            "add",
            [B.make_function("multiply", [nb, B.make_double_literal(2.0)],
                             dt.float64),
             B.make_function("castFLOAT8", [na], dt.float64)],
            dt.float64),
        dt.Field("out", dt.float64))
    return (Filter.make(schema, cond, device=device),
            Projector.make(schema, [expr], device=device))


def flagship_plan(device=DEFAULT_DEVICE) -> FilterProject:
    """The fused configs[0] plan on ``device``."""
    filt, proj = _flagship_plans(device)
    return FilterProject.make(filt.schema, filt.condition, proj.exprs,
                              device=device)


def flagship_step(device=DEFAULT_DEVICE):
    """Returns (fn, example_args): the fused filter+project step
    ``fn(a_data, a_valid, b_data, b_valid) -> (sel_idx, sel_count,
    out_value, out_valid)``, all outputs meaningful on ``[:sel_count]``."""
    dev = resolve_device(device)
    fp = flagship_plan(dev)

    def fn(a_data, a_valid, b_data, b_valid):
        cols = {"a": (a_data, a_valid), "b": (b_data, b_valid)}
        sel_idx, sel_count, packed = fp._run(cols, int(a_data.shape[0]), 0)
        return sel_idx, sel_count, packed[0], packed[1]

    n = 8192
    rng = np.random.default_rng(0)
    example_args = (
        torch.from_numpy(rng.integers(0, 1000, n).astype(np.int64)).to(dev),
        torch.ones(n, dtype=torch.bool, device=dev),
        torch.from_numpy(rng.random(n)).to(dev),
        torch.ones(n, dtype=torch.bool, device=dev),
    )
    return fn, example_args


def flagship_checksum(idx, count, packed):
    """One batch's outputs → an int64 checksum, over ``[:count]`` only (the
    tail of every output is unspecified): count + Σidx + int64(Σvalue) +
    Σvalid."""
    value, valid = packed[0], packed[1]
    live = torch.arange(idx.shape[0], device=idx.device) < count
    return (count.to(torch.int64)
            + torch.where(live, idx, 0).sum(dtype=torch.int64)
            + torch.where(live, value, 0.0).sum().to(torch.int64)
            + (valid & live).sum(dtype=torch.int64))


def flagship_stream(device=DEFAULT_DEVICE):
    """Device-resident multi-batch flagship pipeline (BASELINE configs[0]
    at steady state): returns (fn, make_inputs) where ``fn(cols)`` runs the
    plan over K stacked batches with no host sync between batches and sums
    every batch's ``flagship_checksum`` to one 0-d int64 device tensor."""
    dev = resolve_device(device)
    run = flagship_plan(dev).stream_fn(flagship_checksum)

    def fn(cols):
        return torch.sum(run(cols))

    def make_inputs(K: int, n: int, seed: int = 42,
                    null_frac: float = 0.05):
        """BASELINE configs[0] inputs, made on the device from a seeded
        generator: nullable int64 ``a`` uniform in [0, 1000) with
        ``null_frac`` nulls (bench_reference/bench_arrow.py:15-17),
        non-null float64 ``b`` uniform in [0, 1)."""
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        a = torch.randint(0, 1000, (K, n), generator=g, dtype=torch.int64,
                          device=dev)
        b = torch.rand((K, n), generator=g, dtype=torch.float64, device=dev)
        a_valid = torch.empty((K, n), dtype=torch.bool, device=dev)
        for k in range(K):   # one batch of uniforms at a time
            a_valid[k] = torch.rand(n, generator=g, device=dev) >= null_frac
        ones = torch.ones((K, n), dtype=torch.bool, device=dev)
        return {"a": (a, a_valid), "b": (b, ones)}

    return fn, make_inputs


def distributed_step(mesh, shuffle_capacity: int, num_groups: int = 64):
    """The distributed query step over ``mesh`` (a ``parallel.make_mesh``;
    its device is the plans').

    Per partition: the configs[0] filter (kernel K1 on a card) and its
    projection of the selected rows → shuffle by key hash → ``hash_aggregate``
    (GROUP BY key, sum and count of the projection; K5 on a card at up to
    1024 groups) over the received rows; then the received row count
    summed and the overflow flags max-reduced over the mesh. Returns
    ``fn(keys, vals, valid)`` on lists with one tensor per held partition
    (``parallel.shard``) → (group keys, sums, counts, group counts — each a
    per-partition list —, total_rows, overflow — each one tensor). Keys are
    co-located after the hash shuffle, so the partitions' groups are
    disjoint: no cross-partition combine."""
    from .ops.hash_aggregate import hash_aggregate
    from .parallel.shuffle import shuffle_by_key

    filt, proj = _flagship_plans(mesh.device)

    def fn(keys, vals, valid):
        sel_keys, sel_vals, sel_ok = [], [], []
        for k, v, ok in zip(keys, vals, valid):
            cols = {"a": (k, ok), "b": (v, ok)}
            n = int(k.shape[0])
            # 1. filter the partition, project its selected rows
            sel_idx, sel_count = filt._run(cols, n, 0)
            ((pval, pvalid),) = proj._run_selected(cols, 0, sel_idx,
                                                   sel_count)
            row_ok = torch.arange(n, device=k.device) < sel_count
            idx = torch.where(row_ok, sel_idx, 0).long()
            sel_keys.append(k.index_select(0, idx))
            sel_vals.append(pval)
            sel_ok.append(row_ok & pvalid)
        # 2. shuffle the filtered rows by key hash
        flat, fvalid, overflow = shuffle_by_key(
            sel_keys, sel_ok, {"key": sel_keys, "val": sel_vals}, mesh,
            shuffle_capacity)
        # 3. aggregate each partition's received rows
        res = [hash_aggregate(flat["key"][i],
                              [("val", "sum"), ("val", "count")],
                              {"val": (flat["val"][i], None)},
                              row_valid=fvalid[i], max_groups=num_groups,
                              group_null_keys=False)
               for i in range(mesh.local)]
        # 4. row stats over the mesh
        total_rows = mesh.psum([f.sum(dtype=torch.int64) for f in fvalid])
        agg_overflow = mesh.pmax([r["overflow"] for r in res])
        return ([r["keys"][:num_groups] for r in res],
                [r["agg:val:sum"][:num_groups] for r in res],
                [r["agg:val:count"][:num_groups] for r in res],
                [r["group_count"] for r in res], total_rows,
                overflow | agg_overflow)

    return fn


# ---------------------------------------------------------------------------
# TPC-H LINEITEM scans (TPC-H v3.0.1: Q1 §2.4.1, Q6 §2.4.6, Q7 §2.4.7,
# LINEITEM §4.2.3)
# ---------------------------------------------------------------------------

LINEITEM_SF10_ROWS = 59_986_052          # LINEITEM's row count at SF10
MONEY = dt.decimal128(15, 2)             # the spec's DECIMAL money columns
MONEY_COLUMNS = ("l_quantity", "l_extendedprice", "l_discount", "l_tax")
Q1_SHIPDATE = 10561                      # date '1998-12-01'
Q1_DELTA = 90                            # Q1's substitution parameter DELTA
Q6_FROM, Q6_TO = 8766, 9131              # date '1994-01-01', '1995-01-01'
Q12_FROM, Q12_TO = 8766, 9131            # Q12's DATE = 1994-01-01, + 1 year
Q7_FROM, Q7_TO = 9131, 9861              # date '1995-01-01', '1996-12-31'
ORDERDATE_FIRST, ORDERDATE_LAST = 8035, 10440   # 1992-01-01, 1998-08-02
CURRENTDATE = 9298                       # 1995-06-17 (§4.2.2.12)
DATE_COLUMNS = ("l_shipdate", "l_commitdate", "l_receiptdate")

# The string columns' one dictionary object each (TPC-H §4.2.3, §4.2.2.13):
# the codes the generator draws index these arrays, and every LINEITEM
# batch shares them, so the plans' host tables stay memoized across calls.
L_RETURNFLAG = pa.array(["R", "A", "N"])
L_LINESTATUS = pa.array(["O", "F"])
L_SHIPINSTRUCT = pa.array(["DELIVER IN PERSON", "COLLECT COD", "NONE",
                           "TAKE BACK RETURN"])
L_SHIPMODE = pa.array(["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL",
                       "FOB"])
STRING_COLUMNS = {"l_returnflag": L_RETURNFLAG, "l_linestatus": L_LINESTATUS,
                  "l_shipinstruct": L_SHIPINSTRUCT, "l_shipmode": L_SHIPMODE}


def lineitem_schema() -> dt.Schema:
    return dt.Schema([dt.Field(n, MONEY, nullable=False)
                      for n in MONEY_COLUMNS]
                     + [dt.Field(n, dt.date32, nullable=False)
                        for n in DATE_COLUMNS]
                     + [dt.Field(n, dt.string, nullable=False)
                        for n in STRING_COLUMNS])


def _dec(v: str, precision: int, scale: int):
    return B.make_decimal_literal(v, precision, scale)


def _call(name, args, rtype):
    """A function node whose return type comes from the registry (decimal
    results follow the Java rules of registry/decimal_ops.py)."""
    from .registry.decimal_ops import ensure_registered
    from .registry.registry import global_registry

    types = [a.dtype for a in args]
    ensure_registered(types)
    rt = global_registry().lookup_or_raise(name, types).signature.return_type
    return B.make_function(name, args, rt if rtype is None else rtype)


def tpch_q1_scan(device=DEFAULT_DEVICE) -> FilterProject:
    """Q1's scan: ``l_shipdate <= date '1998-12-01' - interval '90' day``;
    project l_returnflag, l_linestatus (Q1's group keys, strings),
    l_quantity, l_extendedprice, ``disc_price = l_extendedprice * (1 -
    l_discount)`` and ``charge = disc_price * (1 + l_tax)``."""
    schema = lineitem_schema()
    f = {n.name: B.make_field(n) for n in schema}
    bound = _call("add", [B.make_literal(Q1_SHIPDATE, dt.date32),
                          B.make_interval_day_literal(-Q1_DELTA)], dt.date32)
    cond = B.make_condition(_call("less_than_or_equal_to",
                                  [f["l_shipdate"], bound], dt.bool_))
    one = _dec("1", 1, 0)
    disc_price = _call("multiply", [
        f["l_extendedprice"],
        _call("subtract", [one, f["l_discount"]], None)], None)
    charge = _call("multiply", [
        disc_price, _call("add", [one, f["l_tax"]], None)], None)
    exprs = [B.make_expression(node, dt.Field(name, node.dtype))
             for name, node in (("l_returnflag", f["l_returnflag"]),
                                ("l_linestatus", f["l_linestatus"]),
                                ("l_quantity", f["l_quantity"]),
                                ("l_extendedprice", f["l_extendedprice"]),
                                ("disc_price", disc_price),
                                ("charge", charge))]
    return FilterProject.make(schema, cond, exprs, device=device)


def tpch_q6_scan(device=DEFAULT_DEVICE) -> FilterProject:
    """Q6's scan with DATE = 1994-01-01, DISCOUNT = 0.06, QUANTITY = 24:
    ``l_shipdate >= date '1994-01-01' and l_shipdate < date '1995-01-01'
    and l_discount between 0.05 and 0.07 and l_quantity < 24``; project
    ``l_extendedprice * l_discount``."""
    schema = lineitem_schema()
    f = {n.name: B.make_field(n) for n in schema}
    cond = B.make_condition(B.make_and([
        _call("greater_than_or_equal_to",
              [f["l_shipdate"], B.make_literal(Q6_FROM, dt.date32)],
              dt.bool_),
        _call("less_than",
              [f["l_shipdate"], B.make_literal(Q6_TO, dt.date32)], dt.bool_),
        _call("greater_than_or_equal_to",
              [f["l_discount"], _dec("0.05", 3, 2)], dt.bool_),
        _call("less_than_or_equal_to",
              [f["l_discount"], _dec("0.07", 3, 2)], dt.bool_),
        _call("less_than", [f["l_quantity"], _dec("24", 2, 0)], dt.bool_)]))
    revenue = _call("multiply", [f["l_extendedprice"], f["l_discount"]], None)
    return FilterProject.make(
        schema, cond, [B.make_expression(revenue,
                                         dt.Field("revenue", revenue.dtype))],
        device=device)


def tpch_q7_scan(device=DEFAULT_DEVICE) -> FilterProject:
    """Q7's LINEITEM scan (§2.4.7): ``l_shipdate between date '1995-01-01'
    and date '1996-12-31'``; project ``l_year = extract(year from
    l_shipdate)`` and ``volume = l_extendedprice * (1 - l_discount)``. The
    joins to SUPPLIER, ORDERS, CUSTOMER and NATION are not part of the
    scan."""
    schema = lineitem_schema()
    f = {n.name: B.make_field(n) for n in schema}
    cond = B.make_condition(B.make_and([
        _call("greater_than_or_equal_to",
              [f["l_shipdate"], B.make_literal(Q7_FROM, dt.date32)],
              dt.bool_),
        _call("less_than_or_equal_to",
              [f["l_shipdate"], B.make_literal(Q7_TO, dt.date32)],
              dt.bool_)]))
    l_year = _call("extractYear", [f["l_shipdate"]], dt.int64)
    volume = _call("multiply", [
        f["l_extendedprice"],
        _call("subtract", [_dec("1", 1, 0), f["l_discount"]], None)], None)
    exprs = [B.make_expression(node, dt.Field(name, node.dtype))
             for name, node in (("l_year", l_year), ("volume", volume))]
    return FilterProject.make(schema, cond, exprs, device=device)


def tpch_q12_scan(device=DEFAULT_DEVICE) -> FilterProject:
    """Q12's LINEITEM predicate with SHIPMODE1 = 'MAIL', SHIPMODE2 = 'SHIP'
    and DATE = 1994-01-01: ``l_shipmode in ('MAIL', 'SHIP') and
    l_commitdate < l_receiptdate and l_shipdate < l_commitdate and
    l_receiptdate >= date '1994-01-01' and l_receiptdate < date
    '1995-01-01'``; project l_shipmode."""
    schema = lineitem_schema()
    f = {n.name: B.make_field(n) for n in schema}
    cond = B.make_condition(B.make_and([
        B.make_in_expression_string(f["l_shipmode"], ["MAIL", "SHIP"]),
        _call("less_than", [f["l_commitdate"], f["l_receiptdate"]],
              dt.bool_),
        _call("less_than", [f["l_shipdate"], f["l_commitdate"]], dt.bool_),
        _call("greater_than_or_equal_to",
              [f["l_receiptdate"], B.make_literal(Q12_FROM, dt.date32)],
              dt.bool_),
        _call("less_than",
              [f["l_receiptdate"], B.make_literal(Q12_TO, dt.date32)],
              dt.bool_)]))
    return FilterProject.make(
        schema, cond, [B.make_expression(f["l_shipmode"],
                                         dt.Field("l_shipmode", dt.string))],
        device=device)


def tpch_q19_scan(device=DEFAULT_DEVICE) -> FilterProject:
    """Q19's LINEITEM-only predicate with QUANTITY1..3 = 1, 10, 20:
    ``l_shipmode in ('AIR', 'AIR REG') and l_shipinstruct = 'DELIVER IN
    PERSON' and (l_quantity between 1 and 11 or l_quantity between 10 and
    20 or l_quantity between 20 and 30)``; project l_extendedprice and
    l_discount. 'AIR REG' is the query text's and matches no row (dbgen
    writes 'REG AIR')."""
    schema = lineitem_schema()
    f = {n.name: B.make_field(n) for n in schema}

    def between(lo, hi):
        return B.make_and([
            _call("greater_than_or_equal_to",
                  [f["l_quantity"], _dec(str(lo), 2, 0)], dt.bool_),
            _call("less_than_or_equal_to",
                  [f["l_quantity"], _dec(str(hi), 2, 0)], dt.bool_)])

    cond = B.make_condition(B.make_and([
        B.make_in_expression_string(f["l_shipmode"], ["AIR", "AIR REG"]),
        B.make_function("equal", [
            f["l_shipinstruct"], B.make_string_literal("DELIVER IN PERSON")],
            dt.bool_),
        B.make_or([between(1, 11), between(10, 20), between(20, 30)])]))
    exprs = [B.make_expression(f[n], dt.Field(n, MONEY))
             for n in ("l_extendedprice", "l_discount")]
    return FilterProject.make(schema, cond, exprs, device=device)


def lineitem(n: int, seed: int = 0, device=DEFAULT_DEVICE) -> Batch:
    """``n`` LINEITEM rows of the scans' columns, made on ``device`` from a
    seeded generator with the distributions of TPC-H §4.2.3: l_quantity
    uniform 1..50; l_extendedprice = l_quantity × p_retailprice of a part
    key uniform 1..2,000,000 (p_retailprice = (90000 + ((pk/10) mod 20001)
    + 100·(pk mod 1000))/100); l_discount uniform 0.00..0.10; l_tax uniform
    0.00..0.08; l_shipdate = o_orderdate + uniform 1..121 days, o_orderdate
    uniform in [1992-01-01, 1998-08-02]; l_commitdate = o_orderdate +
    uniform 30..90; l_receiptdate = l_shipdate + uniform 1..30;
    l_returnflag 'R' or 'A' at random if l_receiptdate <= CURRENTDATE,
    else 'N'; l_linestatus 'O' if l_shipdate > CURRENTDATE, else 'F';
    l_shipinstruct and l_shipmode uniform over their lists. Each line draws
    its own order date (dbgen shares one across an order's lines). The
    columns of the Q1 and Q6 scans are drawn first, in the order they
    always were, so those scans see the same rows. Not null."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def uniform(lo, hi):
        return torch.randint(lo, hi + 1, (n,), generator=g,
                             dtype=torch.int64, device=dev)

    qty = uniform(1, 50)
    pk = uniform(1, 2_000_000)
    retail = 90000 + (pk // 10) % 20001 + 100 * (pk % 1000)   # cents
    del pk
    cents = {"l_quantity": qty * 100, "l_extendedprice": qty * retail,
             "l_discount": uniform(0, 10), "l_tax": uniform(0, 8)}
    del qty, retail
    order = uniform(ORDERDATE_FIRST, ORDERDATE_LAST)
    ship = order + uniform(1, 121)
    commit = (order + uniform(30, 90)).to(torch.int32)
    del order
    receipt = ship + uniform(1, 30)
    codes = {
        "l_returnflag": torch.where(receipt <= CURRENTDATE, uniform(0, 1),
                                    2),
        "l_linestatus": (ship <= CURRENTDATE).to(torch.int64),
        "l_shipinstruct": uniform(0, len(L_SHIPINSTRUCT) - 1),
        "l_shipmode": uniform(0, len(L_SHIPMODE) - 1)}
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    cols = {name: Column(lo, valid, MONEY, extra=torch.zeros_like(lo))
            for name, lo in cents.items()}
    for name, days in (("l_shipdate", ship), ("l_commitdate", commit),
                       ("l_receiptdate", receipt)):
        cols[name] = Column(days.to(torch.int32), valid, dt.date32)
    for name, c in codes.items():
        cols[name] = Column(c.to(torch.int32), valid, dt.string,
                            dictionary=STRING_COLUMNS[name])
    return Batch(cols, n)


# ---------------------------------------------------------------------------
# TPC-H PART (§4.2.3) and the PART predicates of Q9 (§2.4.9) and Q16
# (§2.4.16)
# ---------------------------------------------------------------------------

PART_SF10_ROWS = 2_000_000               # PART's row count at SF10
P_NAME_WORDS = (
    "almond antique aquamarine azure beige bisque black blanched blue blush "
    "brown burlywood burnished chartreuse chiffon chocolate coral cornflower "
    "cornsilk cream cyan dark deep dim dodger drab firebrick floral forest "
    "frosted gainsboro ghost goldenrod green grey honeydew hot indian ivory "
    "khaki lace lavender lawn lemon light lime linen magenta maroon medium "
    "metallic midnight mint misty moccasin navajo navy olive orange orchid "
    "pale papaya peach peru pink plum powder puff purple red rose rosy royal "
    "saddle salmon sandy seashell sienna sky slate smoke snow spring steel "
    "tan thistle tomato turquoise violet wheat white yellow").split()
P_TYPE_SYLLABLES = (
    ("STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"),
    ("ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"),
    ("TIN", "NICKEL", "BRASS", "STEEL", "COPPER"))
Q9_COLOR = "green"
Q16_BRAND, Q16_TYPE = "Brand#45", "MEDIUM POLISHED"
Q16_SIZES = (49, 14, 23, 45, 19, 3, 36, 9)


def part_schema() -> dt.Schema:
    return dt.Schema([dt.Field("p_partkey", dt.int64, nullable=False),
                      dt.Field("p_name", dt.string, nullable=False),
                      dt.Field("p_brand", dt.string, nullable=False),
                      dt.Field("p_type", dt.string, nullable=False),
                      dt.Field("p_size", dt.int32, nullable=False)])


def part_arrow(n: int, seed: int = 0) -> "pa.RecordBatch":
    """``n`` PART rows as a pyarrow batch made on the host from a numpy
    seed, with the distributions of TPC-H §4.2.3: p_partkey 1..n; p_name
    five distinct words of the 92-word list, space-separated; p_brand
    'Brand#MN', M and N uniform 1..5; p_type one of the 150 syllable
    triples; p_size uniform 1..50. Plain (not dictionary) string arrays,
    as a reader hands them over."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, len(P_NAME_WORDS), (n, 5))
    while True:      # redraw the rows that repeat a word
        s = np.sort(words, axis=1)
        dup = (s[:, 1:] == s[:, :-1]).any(axis=1)
        if not dup.any():
            break
        words[dup] = rng.integers(0, len(P_NAME_WORDS), (int(dup.sum()), 5))
    vocab = pa.array(P_NAME_WORDS)
    name = pc.binary_join_element_wise(
        *(vocab.take(pa.array(words[:, i])) for i in range(5)), " ")
    m, k = rng.integers(1, 6, n), rng.integers(1, 6, n)
    brands = pa.array([f"Brand#{a}{b}" for a in range(1, 6)
                       for b in range(1, 6)])
    types = pa.array([" ".join((a, b, c)) for a in P_TYPE_SYLLABLES[0]
                      for b in P_TYPE_SYLLABLES[1]
                      for c in P_TYPE_SYLLABLES[2]])
    return pa.RecordBatch.from_arrays(
        [pa.array(np.arange(1, n + 1, dtype=np.int64)), name,
         brands.take(pa.array((m - 1) * 5 + (k - 1))),
         types.take(pa.array(rng.integers(0, len(types), n))),
         pa.array(rng.integers(1, 51, n).astype(np.int32))],
        names=[f.name for f in part_schema()])


def part(n: int, seed: int = 0, device=DEFAULT_DEVICE) -> Batch:
    """``part_arrow(n, seed)`` on ``device``, through ``from_arrow``: the
    string columns are dictionary-encoded there."""
    return from_arrow(part_arrow(n, seed), device=device)


def tpch_q9_part_scan(device=DEFAULT_DEVICE) -> FilterProject:
    """Q9's PART predicate with COLOR = 'green': ``p_name like
    '%green%'``; project p_partkey."""
    schema = part_schema()
    f = {n.name: B.make_field(n) for n in schema}
    cond = B.make_condition(B.make_function(
        "like", [f["p_name"], B.make_string_literal(f"%{Q9_COLOR}%")],
        dt.bool_))
    return FilterProject.make(
        schema, cond, [B.make_expression(f["p_partkey"],
                                         dt.Field("p_partkey", dt.int64))],
        device=device)


def tpch_q16_part_scan(device=DEFAULT_DEVICE) -> FilterProject:
    """Q16's PART predicate with BRAND = 'Brand#45', TYPE = 'MEDIUM
    POLISHED' and SIZE1..8 = 49, 14, 23, 45, 19, 3, 36, 9: ``p_brand <>
    'Brand#45' and p_type not like 'MEDIUM POLISHED%' and p_size in (49,
    14, 23, 45, 19, 3, 36, 9)``; project p_brand, p_type and p_size."""
    schema = part_schema()
    f = {n.name: B.make_field(n) for n in schema}
    cond = B.make_condition(B.make_and([
        B.make_function("not_equal",
                        [f["p_brand"], B.make_string_literal(Q16_BRAND)],
                        dt.bool_),
        B.make_function("not", [B.make_function(
            "like", [f["p_type"], B.make_string_literal(f"{Q16_TYPE}%")],
            dt.bool_)],
            dt.bool_),
        B.make_in_expression_int32(f["p_size"], list(Q16_SIZES))]))
    exprs = [B.make_expression(f[n], dt.Field(n, schema.field(n).dtype))
             for n in ("p_brand", "p_type", "p_size")]
    return FilterProject.make(schema, cond, exprs, device=device)


# ---------------------------------------------------------------------------
# TPC-H CUSTOMER (§4.2.3) and Q22's inner predicate (§2.4.22)
# ---------------------------------------------------------------------------

CUSTOMER_SF10_ROWS = 1_500_000           # CUSTOMER's row count at SF10
ACCTBAL = dt.decimal128(12, 2)           # c_acctbal's DECIMAL
Q22_CODES = ("13", "31", "23", "29", "30", "18", "17")   # I1 .. I7


def customer_schema() -> dt.Schema:
    return dt.Schema([dt.Field("c_custkey", dt.int64, nullable=False),
                      dt.Field("c_nationkey", dt.int32, nullable=False),
                      dt.Field("c_phone", dt.string, nullable=False),
                      dt.Field("c_acctbal", ACCTBAL, nullable=False)])


def customer_arrow(n: int, seed: int = 0) -> "pa.RecordBatch":
    """``n`` CUSTOMER rows of Q22's columns as a pyarrow batch made on the
    host from a numpy seed, with the distributions of TPC-H §4.2.3:
    c_custkey 1..n; c_nationkey uniform 0..24; c_phone 'CC-LLL-LLL-LLLL'
    with the country code CC = c_nationkey + 10 and the three local
    numbers uniform in 100..999, 100..999 and 1000..9999 (so nearly every
    phone is distinct); c_acctbal uniform in -999.99 .. 9999.99. Plain
    string arrays, as a reader hands them over."""
    rng = np.random.default_rng(seed)
    nation = rng.integers(0, 25, n)
    parts = [nation + 10, rng.integers(100, 1000, n),
             rng.integers(100, 1000, n), rng.integers(1000, 10000, n)]
    phone = pc.binary_join_element_wise(
        *(pa.array(p).cast(pa.string()) for p in parts), "-")
    cents = rng.integers(-99_999, 1_000_000, n)
    words = np.stack([cents, cents >> 63], axis=1)       # lo, hi (LE)
    acctbal = pa.Array.from_buffers(
        pa.decimal128(ACCTBAL.precision, ACCTBAL.scale), n,
        [None, pa.py_buffer(np.ascontiguousarray(words).tobytes())])
    return pa.RecordBatch.from_arrays(
        [pa.array(np.arange(1, n + 1, dtype=np.int64)),
         pa.array(nation.astype(np.int32)), phone, acctbal],
        names=[f.name for f in customer_schema()])


def customer(n: int, seed: int = 0, device=DEFAULT_DEVICE) -> Batch:
    """``customer_arrow(n, seed)`` on ``device``, through ``from_arrow``:
    c_phone is dictionary-encoded there."""
    return from_arrow(customer_arrow(n, seed), device=device)


def tpch_q22_customer_scan(device=DEFAULT_DEVICE) -> FilterProject:
    """Q22's inner CUSTOMER predicate with I1..I7 = '13', '31', '23',
    '29', '30', '18', '17': ``substring(c_phone from 1 for 2) in (...)
    and c_acctbal > 0.00``; project c_custkey and c_acctbal."""
    schema = customer_schema()
    f = {n.name: B.make_field(n) for n in schema}
    code = B.make_function("substr", [f["c_phone"], B.make_int64_literal(1),
                                      B.make_int64_literal(2)], dt.string)
    cond = B.make_condition(B.make_and([
        B.make_in_expression_string(code, list(Q22_CODES)),
        _call("greater_than", [f["c_acctbal"], _dec("0.00", 3, 2)],
              dt.bool_)]))
    exprs = [B.make_expression(f[n], dt.Field(n, schema.field(n).dtype))
             for n in ("c_custkey", "c_acctbal")]
    return FilterProject.make(schema, cond, exprs, device=device)
