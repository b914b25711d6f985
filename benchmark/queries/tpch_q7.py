"""TPC-H Q7's LINEITEM scan (§2.4.7): ``l_shipdate between date
'1995-01-01' and date '1996-12-31'``; project l_orderkey and l_suppkey (the
joins with ORDERS and SUPPLIER), ``l_year = extract(year from
l_shipdate)`` and ``volume = l_extendedprice * (1 - l_discount)``. A copy
of ``gandiva_tpu_torch/entrypoints.py::tpch_q7_scan`` (lines 307-328),
with each node's return type written out and the join keys projected."""
from __future__ import annotations

from benchmark.queries import _lineitem


def build(gt):
    B, dt = gt.TreeExprBuilder, gt.dtypes
    s = _lineitem.schema(gt)
    f = _lineitem.fields(gt, s)
    cond = B.make_condition(B.make_and([
        B.make_function("greater_than_or_equal_to",
                        [f["l_shipdate"], B.make_literal(9131, dt.date32)],
                        dt.bool_),
        B.make_function("less_than_or_equal_to",
                        [f["l_shipdate"], B.make_literal(9861, dt.date32)],
                        dt.bool_)]))
    l_year = B.make_function("extractYear", [f["l_shipdate"]], dt.int64)
    volume = B.make_function("multiply", [
        f["l_extendedprice"],
        B.make_function("subtract", [B.make_decimal_literal("1", 1, 0),
                                     f["l_discount"]],
                        dt.decimal128(16, 2))], dt.decimal128(32, 4))
    exprs = [B.make_expression(node, dt.Field(name, node.dtype))
             for name, node in (("l_orderkey", f["l_orderkey"]),
                                ("l_suppkey", f["l_suppkey"]),
                                ("l_year", l_year), ("volume", volume))]
    return s, cond, exprs
