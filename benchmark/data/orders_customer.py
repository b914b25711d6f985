"""TPC-H ORDERS and CUSTOMER's join columns, made on a device from a seed.

A frozen copy of ``chip_smoke.py::orders_customer`` (lines 1609-1627),
uniform o_custkey only, sized by the caller, with o_totalprice summed
from each order's lines as dbgen's ``mk_order`` sums it (the lines'
money drawn by ``benchmark/data/lineitem.py``).
"""
from __future__ import annotations

import torch

from benchmark.data.lineitem import line_counts, money, order_total

MKTSEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD",
               "MACHINERY"]                      # c_mktsegment (§4.2.3)


def orders_customer(orders: int, lines: int, customers: int, seed: int,
                    device) -> dict:
    """ORDERS (o_custkey, o_totalprice in cents as int64) and CUSTOMER
    (c_custkey 1..customers, c_mktsegment as a code into ``MKTSEGMENTS``).
    o_custkey is drawn as dbgen draws it: uniform over [1, customers]
    without the multiples of 3 (a third of the customers place no order).
    o_totalprice is the sum over the order's lines (``line_counts``, 1..7
    an order, ``lines`` in all) of ``order_total``: the lines' own
    extended prices, discounts and taxes, drawn as LINEITEM's are."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    n_keys = customers * 2 // 3              # customers that place orders
    j = torch.randint(0, n_keys, (orders,), generator=g, device=device)
    o_custkey = 3 * (j // 2) + 1 + j % 2     # 1, 2, 4, 5, 7, ...
    del j
    count = line_counts(orders, lines, g, device)
    share = order_total(money(lines, g, device))
    o_totalprice = torch.zeros(orders, dtype=torch.int64, device=device)
    o_totalprice.index_add_(0, torch.repeat_interleave(
        torch.arange(orders, device=device), count), share)
    del count, share
    c_custkey = torch.arange(1, customers + 1, device=device)
    c_mktsegment = torch.randint(0, len(MKTSEGMENTS), (customers,),
                                 generator=g, device=device)
    return {"o_custkey": o_custkey, "o_totalprice": o_totalprice,
            "c_custkey": c_custkey, "c_mktsegment": c_mktsegment}
