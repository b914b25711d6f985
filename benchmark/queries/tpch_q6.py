"""TPC-H Q6's scan (§2.4.6; DATE = 1994-01-01, DISCOUNT = 0.06, QUANTITY =
24): ``l_shipdate >= date '1994-01-01' and l_shipdate < date '1995-01-01'
and l_discount between 0.05 and 0.07 and l_quantity < 24``; project
``revenue = l_extendedprice * l_discount``. A copy of
``gandiva_tpu_torch/entrypoints.py::tpch_q6_scan`` (lines 282-304), with
each node's return type written out."""
from __future__ import annotations

from benchmark.queries import _lineitem


def build(gt):
    B, dt = gt.TreeExprBuilder, gt.dtypes
    s = _lineitem.schema(gt)
    f = _lineitem.fields(gt, s)

    def cmp(name, a, b):
        return B.make_function(name, [a, b], dt.bool_)

    cond = B.make_condition(B.make_and([
        cmp("greater_than_or_equal_to", f["l_shipdate"],
            B.make_literal(8766, dt.date32)),
        cmp("less_than", f["l_shipdate"], B.make_literal(9131, dt.date32)),
        cmp("greater_than_or_equal_to", f["l_discount"],
            B.make_decimal_literal("0.05", 3, 2)),
        cmp("less_than_or_equal_to", f["l_discount"],
            B.make_decimal_literal("0.07", 3, 2)),
        cmp("less_than", f["l_quantity"],
            B.make_decimal_literal("24", 2, 0))]))
    revenue = B.make_function("multiply", [f["l_extendedprice"],
                                           f["l_discount"]],
                              dt.decimal128(31, 4))
    return s, cond, [B.make_expression(revenue,
                                       dt.Field("revenue", revenue.dtype))]
