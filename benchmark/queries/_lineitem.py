"""The LINEITEM schema the scans are planned over, all sixteen columns in
TPC-H's order, made with the program's public ``TreeExprBuilder`` (the
scan columns' fields a copy of ``gandiva_tpu_torch/entrypoints.py`` lines
206-237)."""
from __future__ import annotations

KEYS = ("l_orderkey", "l_partkey", "l_suppkey")
MONEY = ("l_quantity", "l_extendedprice", "l_discount", "l_tax")
FLAGS = ("l_returnflag", "l_linestatus")
DATES = ("l_shipdate", "l_commitdate", "l_receiptdate")
STRINGS = ("l_shipinstruct", "l_shipmode", "l_comment")


def schema(gt):
    dt = gt.dtypes

    def fields(names, dtype):
        return [dt.Field(n, dtype, nullable=False) for n in names]

    return dt.Schema(fields(KEYS, dt.int64)
                     + fields(["l_linenumber"], dt.int32)
                     + fields(MONEY, dt.decimal128(15, 2))
                     + fields(FLAGS, dt.string) + fields(DATES, dt.date32)
                     + fields(STRINGS, dt.string))


def fields(gt, s):
    return {f.name: gt.TreeExprBuilder.make_field(f) for f in s}
