"""Plain TPC-H Q19 LINEITEM-only terms: a frozen copy of
``chip_smoke.py::string_scan_plain`` (lines 1286-1339), Q19's branch,
with the string tests decided on the dictionaries' values."""
from __future__ import annotations

from benchmark.reference import _plain


def plain(c: dict, dictionaries: dict, money: str = _plain.EXACT):
    mode = _plain.codes_where(c["l_shipmode"], dictionaries["l_shipmode"],
                              lambda v: v in ("AIR", "AIR REG"))
    instruct = _plain.codes_where(
        c["l_shipinstruct"], dictionaries["l_shipinstruct"],
        lambda v: v == "DELIVER IN PERSON")
    if money == _plain.EXACT:
        q, ranges = c["l_quantity"], ((100, 1100), (1000, 2000),
                                      (2000, 3000))
    else:
        q, ranges = _plain.dollars(c["l_quantity"]), ((1, 11), (10, 20),
                                                      (20, 30))
    between = ((q >= ranges[0][0]) & (q <= ranges[0][1])
               | (q >= ranges[1][0]) & (q <= ranges[1][1])
               | (q >= ranges[2][0]) & (q <= ranges[2][1]))
    keep = mode & instruct & between
    qty, ep, disc = (c[n] for n in ("l_quantity", "l_extendedprice",
                                    "l_discount"))
    if money != _plain.EXACT:
        qty, ep, disc = (_plain.unscaled(_plain.dollars(x), 2)
                         for x in (qty, ep, disc))
    return keep, {"l_partkey": c["l_partkey"], "l_quantity": qty,
                  "l_extendedprice": ep, "l_discount": disc}
