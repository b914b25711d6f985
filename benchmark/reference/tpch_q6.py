"""Plain TPC-H Q6 scan: a frozen copy of ``chip_smoke.py::tpch_plain``
(lines 825-851), Q6's branch. revenue = ep·disc at scale 4."""
from __future__ import annotations

from benchmark.reference import _plain

FROM, TO = 8766, 9131                    # date '1994-01-01', '1995-01-01'


def plain(c: dict, dictionaries: dict, money: str = _plain.EXACT):
    ship, ep = c["l_shipdate"], c["l_extendedprice"]
    disc, qty = c["l_discount"], c["l_quantity"]
    if money == _plain.EXACT:
        keep = ((ship >= FROM) & (ship < TO) & (disc >= 5) & (disc <= 7)
                & (qty < 2400))
        revenue = ep * disc
    else:
        d, q = _plain.dollars(disc), _plain.dollars(qty)
        keep = ((ship >= FROM) & (ship < TO) & (d >= 0.05) & (d <= 0.07)
                & (q < 24))
        revenue = _plain.unscaled(_plain.dollars(ep) * d, 4)
    return keep, {"revenue": revenue}
