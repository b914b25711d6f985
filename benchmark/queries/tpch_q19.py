"""TPC-H Q19's LINEITEM-only terms (§2.4.19; QUANTITY1..3 = 1, 10, 20):
``l_shipmode in ('AIR', 'AIR REG') and l_shipinstruct = 'DELIVER IN
PERSON' and (l_quantity between 1 and 11 or l_quantity between 10 and 20
or l_quantity between 20 and 30)``; project l_partkey (the join with
PART), l_quantity (the per-brand ranges that follow the join),
l_extendedprice and l_discount. 'AIR REG' is the query text's and matches
no row (dbgen writes 'REG AIR'). A copy of
``gandiva_tpu_torch/entrypoints.py::tpch_q19_scan`` (lines 356-381), with
the join key and l_quantity projected."""
from __future__ import annotations

from benchmark.queries import _lineitem


def build(gt):
    B, dt = gt.TreeExprBuilder, gt.dtypes
    s = _lineitem.schema(gt)
    f = _lineitem.fields(gt, s)

    def between(lo, hi):
        return B.make_and([
            B.make_function("greater_than_or_equal_to", [
                f["l_quantity"], B.make_decimal_literal(str(lo), 2, 0)],
                dt.bool_),
            B.make_function("less_than_or_equal_to", [
                f["l_quantity"], B.make_decimal_literal(str(hi), 2, 0)],
                dt.bool_)])

    cond = B.make_condition(B.make_and([
        B.make_in_expression_string(f["l_shipmode"], ["AIR", "AIR REG"]),
        B.make_function("equal", [
            f["l_shipinstruct"],
            B.make_string_literal("DELIVER IN PERSON")], dt.bool_),
        B.make_or([between(1, 11), between(10, 20), between(20, 30)])]))
    exprs = [B.make_expression(f[n], dt.Field(n, s.field(n).dtype))
             for n in ("l_partkey", "l_quantity", "l_extendedprice",
                       "l_discount")]
    return s, cond, exprs
