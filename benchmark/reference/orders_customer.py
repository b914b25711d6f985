"""Plain ORDERS ⋈ CUSTOMER query of the configuration
``tpch_sf10_orders_customer``, in torch on the tables' device:

    SELECT c_mktsegment, SUM(o_totalprice), COUNT(*)
    FROM orders JOIN customer ON o_custkey = c_custkey
    WHERE o_totalprice > :X GROUP BY 1 ORDER BY 1

c_custkey is CUSTOMER's primary key, so each order joins at most one
customer: the join is a binary search of the order's key among the sorted
customer keys. Sums are exact int64 cents; the control sums float32
dollars. Built on the query's semantics, not on ``chip_smoke.py``'s
Acero call (lines 1630-1645), which needs host copies of the tables."""
from __future__ import annotations

import torch

from benchmark.reference import _plain


def plain(t: dict, threshold: int, groups: int,
          money: str = _plain.EXACT):
    """(segment codes ascending, sums in cents, counts, joined rows) of the
    groups present; c_mktsegment's codes lie in [0, groups)."""
    keep = t["o_totalprice"] > threshold
    okey, amt = t["o_custkey"][keep], t["o_totalprice"][keep]
    ckey, order = torch.sort(t["c_custkey"])
    pos = torch.searchsorted(ckey, okey).clamp(max=ckey.numel() - 1)
    hit = ckey[pos] == okey
    seg = t["c_mktsegment"][order][pos][hit]
    amt = amt[hit]
    counts = torch.bincount(seg, minlength=groups)
    if money == _plain.EXACT:
        sums = torch.zeros(groups, dtype=torch.int64, device=amt.device)
        sums.index_add_(0, seg, amt)
    else:
        s = torch.zeros(groups, dtype=torch.float32, device=amt.device)
        s.index_add_(0, seg, _plain.dollars(amt))
        sums = _plain.unscaled(s, 2)
    present = counts > 0
    codes = torch.arange(groups, device=amt.device)
    return (codes[present].cpu().numpy(), sums[present].cpu().numpy(),
            counts[present].cpu().numpy(), int(hit.sum()))
