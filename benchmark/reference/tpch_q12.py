"""Plain TPC-H Q12 LINEITEM predicate: a frozen copy of
``chip_smoke.py::string_scan_plain`` (lines 1286-1339), Q12's branch,
with the string IN decided on the dictionary's values."""
from __future__ import annotations

from benchmark.reference import _plain

FROM, TO = 8766, 9131                    # date '1994-01-01', '1995-01-01'


def plain(c: dict, dictionaries: dict, money: str = _plain.EXACT):
    # no money in this scan: the control computes it as the reference does
    mode = _plain.codes_where(c["l_shipmode"], dictionaries["l_shipmode"],
                              lambda v: v in ("MAIL", "SHIP"))
    keep = (mode & (c["l_commitdate"] < c["l_receiptdate"])
            & (c["l_shipdate"] < c["l_commitdate"])
            & (c["l_receiptdate"] >= FROM) & (c["l_receiptdate"] < TO))
    return keep, {"l_orderkey": c["l_orderkey"],
                  "l_shipmode": c["l_shipmode"]}
