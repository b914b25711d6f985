"""TPC-H Q1's LINEITEM scan (§2.4.1, DELTA = 90): ``l_shipdate <= date
'1998-12-01' - interval '90' day``; project l_returnflag, l_linestatus,
l_quantity, l_extendedprice, l_discount, ``disc_price = l_extendedprice *
(1 - l_discount)`` and ``charge = disc_price * (1 + l_tax)``: every input
of Q1's aggregates (avg(l_discount) among them). A copy of
``gandiva_tpu_torch/entrypoints.py::tpch_q1_scan`` (lines 255-279), with
each node's return type written out and l_discount projected."""
from __future__ import annotations

from benchmark.queries import _lineitem


def build(gt):
    B, dt = gt.TreeExprBuilder, gt.dtypes
    s = _lineitem.schema(gt)
    f = _lineitem.fields(gt, s)
    bound = B.make_function("add", [B.make_literal(10561, dt.date32),
                                    B.make_interval_day_literal(-90)],
                            dt.date32)                  # 1998-12-01 - 90
    cond = B.make_condition(B.make_function(
        "less_than_or_equal_to", [f["l_shipdate"], bound], dt.bool_))
    one = B.make_decimal_literal("1", 1, 0)
    disc_price = B.make_function("multiply", [
        f["l_extendedprice"],
        B.make_function("subtract", [one, f["l_discount"]],
                        dt.decimal128(16, 2))], dt.decimal128(32, 4))
    charge = B.make_function("multiply", [
        disc_price, B.make_function("add", [one, f["l_tax"]],
                                    dt.decimal128(16, 2))],
        dt.decimal128(38, 6))
    exprs = [B.make_expression(node, dt.Field(name, node.dtype))
             for name, node in (("l_returnflag", f["l_returnflag"]),
                                ("l_linestatus", f["l_linestatus"]),
                                ("l_quantity", f["l_quantity"]),
                                ("l_extendedprice", f["l_extendedprice"]),
                                ("l_discount", f["l_discount"]),
                                ("disc_price", disc_price),
                                ("charge", charge))]
    return s, cond, exprs
