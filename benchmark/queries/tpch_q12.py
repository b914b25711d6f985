"""TPC-H Q12's LINEITEM predicate (§2.4.12; SHIPMODE1 = 'MAIL', SHIPMODE2
= 'SHIP', DATE = 1994-01-01): ``l_shipmode in ('MAIL', 'SHIP') and
l_commitdate < l_receiptdate and l_shipdate < l_commitdate and
l_receiptdate >= date '1994-01-01' and l_receiptdate < date
'1995-01-01'``; project l_orderkey (the join with ORDERS) and
l_shipmode. A copy of ``gandiva_tpu_torch/entrypoints.py::tpch_q12_scan``
(lines 331-353), with the join key projected."""
from __future__ import annotations

from benchmark.queries import _lineitem


def build(gt):
    B, dt = gt.TreeExprBuilder, gt.dtypes
    s = _lineitem.schema(gt)
    f = _lineitem.fields(gt, s)

    def cmp(name, a, b):
        return B.make_function(name, [a, b], dt.bool_)

    cond = B.make_condition(B.make_and([
        B.make_in_expression_string(f["l_shipmode"], ["MAIL", "SHIP"]),
        cmp("less_than", f["l_commitdate"], f["l_receiptdate"]),
        cmp("less_than", f["l_shipdate"], f["l_commitdate"]),
        cmp("greater_than_or_equal_to", f["l_receiptdate"],
            B.make_literal(8766, dt.date32)),
        cmp("less_than", f["l_receiptdate"],
            B.make_literal(9131, dt.date32))]))
    return s, cond, [B.make_expression(f[n], dt.Field(n, s.field(n).dtype))
                     for n in ("l_orderkey", "l_shipmode")]
