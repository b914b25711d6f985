"""Plain TPC-H Q1 scan: a frozen copy of ``chip_smoke.py::tpch_plain``
(lines 825-851), Q1's branch. Outputs at their result scale: disc_price
= ep·(100 − disc) at scale 4, charge = ep·(100 − disc)·(100 + tax) at
scale 6; the flags as their codes; l_discount as it is."""
from __future__ import annotations

from benchmark.reference import _plain

SHIPDATE_BOUND = 10561 - 90              # date '1998-12-01' - 90 days


def plain(c: dict, dictionaries: dict, money: str = _plain.EXACT):
    qty, ep = c["l_quantity"], c["l_extendedprice"]
    disc, tax = c["l_discount"], c["l_tax"]
    keep = c["l_shipdate"] <= SHIPDATE_BOUND
    if money == _plain.EXACT:
        disc_price = ep * (100 - disc)
        charge = ep * (100 - disc) * (100 + tax)
    else:
        q, e, d, t = (_plain.dollars(x) for x in (qty, ep, disc, tax))
        disc_price = _plain.unscaled(e * (1 - d), 4)
        charge = _plain.unscaled(e * (1 - d) * (1 + t), 6)
        qty, ep, disc = (_plain.unscaled(x, 2) for x in (q, e, d))
    return keep, {"l_returnflag": c["l_returnflag"],
                  "l_linestatus": c["l_linestatus"],
                  "l_quantity": qty, "l_extendedprice": ep,
                  "l_discount": disc, "disc_price": disc_price,
                  "charge": charge}
