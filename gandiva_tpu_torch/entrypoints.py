"""Canonical engine entry points.

``flagship_step`` — the engine's flagship single-card computation: the
BASELINE configs[0] query (filter ``a > 500``, project ``b*2 +
castFLOAT8(a)``) run through the real expression pipeline as one function.

``flagship_stream`` — the same query over K device-resident batches with no
host sync between batches, each batch reduced to a checksum on the device.

``tpch_q1_scan`` / ``tpch_q6_scan`` — the LINEITEM scans of TPC-H Q1 and
Q6 (filter and projections, no aggregation) as FilterProject plans over
decimal(15,2) money columns and a date32 ship date; ``lineitem`` makes
their columns on the device with the TPC-H distributions.

All take ``device`` and default to the card.
"""
from __future__ import annotations

import numpy as np
import torch

from . import dtypes as dt
from .batch import Batch, Column
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


# ---------------------------------------------------------------------------
# TPC-H LINEITEM scans (TPC-H v3.0.1: Q1 §2.4.1, Q6 §2.4.6, LINEITEM §4.2.3)
# ---------------------------------------------------------------------------

LINEITEM_SF10_ROWS = 59_986_052          # LINEITEM's row count at SF10
MONEY = dt.decimal128(15, 2)             # the spec's DECIMAL money columns
MONEY_COLUMNS = ("l_quantity", "l_extendedprice", "l_discount", "l_tax")
Q1_SHIPDATE = 10561                      # date '1998-12-01'
Q1_DELTA = 90                            # Q1's substitution parameter DELTA
Q6_FROM, Q6_TO = 8766, 9131              # date '1994-01-01', '1995-01-01'
ORDERDATE_FIRST, ORDERDATE_LAST = 8035, 10440   # 1992-01-01, 1998-08-02


def lineitem_schema() -> dt.Schema:
    return dt.Schema([dt.Field(n, MONEY, nullable=False)
                      for n in MONEY_COLUMNS]
                     + [dt.Field("l_shipdate", dt.date32, nullable=False)])


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
    project l_quantity, l_extendedprice, ``disc_price = l_extendedprice *
    (1 - l_discount)`` and ``charge = disc_price * (1 + l_tax)``."""
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
             for name, node in (("l_quantity", f["l_quantity"]),
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


def lineitem(n: int, seed: int = 0, device=DEFAULT_DEVICE) -> Batch:
    """``n`` LINEITEM rows of the scans' columns, made on ``device`` from a
    seeded generator with the distributions of TPC-H §4.2.3: l_quantity
    uniform 1..50; l_extendedprice = l_quantity × p_retailprice of a part
    key uniform 1..2,000,000 (p_retailprice = (90000 + ((pk/10) mod 20001)
    + 100·(pk mod 1000))/100); l_discount uniform 0.00..0.10; l_tax uniform
    0.00..0.08; l_shipdate = o_orderdate + uniform 1..121 days, o_orderdate
    uniform in [1992-01-01, 1998-08-02]. Each line draws its own order date
    (dbgen shares one across an order's lines). Not null."""
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
    ship = (uniform(ORDERDATE_FIRST, ORDERDATE_LAST)
            + uniform(1, 121)).to(torch.int32)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    cols = {name: Column(lo, valid, MONEY, extra=torch.zeros_like(lo))
            for name, lo in cents.items()}
    cols["l_shipdate"] = Column(ship, valid, dt.date32)
    return Batch(cols, n)
