"""Plain TPC-H Q7 LINEITEM scan: a frozen copy of
``chip_smoke.py::tpch_plain`` and ``plain_year`` (lines 814-851), Q7's
branch. The join keys as they are, l_year by the calendar, volume =
ep·(100 − disc) at scale 4."""
from __future__ import annotations

import datetime

import torch

from benchmark.reference import _plain

FROM, TO = 9131, 9861                    # date '1995-01-01', '1996-12-31'


def year(days: torch.Tensor) -> torch.Tensor:
    """The calendar year of each day since 1970-01-01, by a search over
    the first days of the years 1900 .. 2100 (Python's calendar)."""
    firsts = torch.tensor([(datetime.date(y, 1, 1)
                            - datetime.date(1970, 1, 1)).days
                           for y in range(1900, 2101)], device=days.device)
    return 1900 + torch.searchsorted(firsts, days.long(), right=True) - 1


def plain(c: dict, dictionaries: dict, money: str = _plain.EXACT):
    ship, ep, disc = c["l_shipdate"], c["l_extendedprice"], c["l_discount"]
    keep = (ship >= FROM) & (ship <= TO)
    if money == _plain.EXACT:
        volume = ep * (100 - disc)
    else:
        volume = _plain.unscaled(
            _plain.dollars(ep) * (1 - _plain.dollars(disc)), 4)
    return keep, {"l_orderkey": c["l_orderkey"],
                  "l_suppkey": c["l_suppkey"], "l_year": year(ship),
                  "volume": volume}
