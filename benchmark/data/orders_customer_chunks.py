"""TPC-H ORDERS and CUSTOMER at a scale factor, as the chunks that
``dbgen -s <SF> -C <n> -S <k>`` writes: chunk k of n, made on its own card
from (seed, k), with no other chunk made there.

Chunk k holds the orders of the k-th range of o_orderkey and the customers
of the k-th range of c_custkey (ranges of equal length where the counts
divide). o_custkey is drawn as dbgen draws it, over all the customers of
the scale factor, so most orders join a customer of another chunk.
o_totalprice is summed over the order's lines as dbgen's ``mk_order`` sums
it, each line drawn as LINEITEM's are (``benchmark/data/lineitem.py``),
with l_partkey over the scale factor's SF·200,000 parts; the lines are
drawn in blocks of orders, so the draws never hold more than a block's
lines. c_mktsegment is one column for all the customers, drawn from the
seed alone: every chunk takes its own range of it, and the reference reads
it whole.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.data.lineitem import PARTS_PER_SF, line_counts, order_total
from benchmark.data.orders_customer import MKTSEGMENTS

BLOCK = 1 << 23             # orders whose lines are drawn at once (≈ 34M)


def chunk_range(total: int, chunks: int, k: int) -> tuple:
    """Rows [lo, hi) of chunk k: the k-th of ``chunks`` ranges."""
    return total * k // chunks, total * (k + 1) // chunks


def stream(seed: int, *key: int) -> int:
    """A generator seed of 64 bits for (seed, *key), from numpy's
    SeedSequence: every seed, the driver's large ones included, and every
    chunk its own stream."""
    return int(np.random.SeedSequence([seed, *key]).generate_state(
        1, np.uint64)[0])


def line_money(n: int, scale_factor: int, g, device) -> dict:
    """``lineitem.money``'s draws of n lines, in the same order, with
    l_partkey uniform over 1..SF·200,000."""
    def uniform(lo, hi):
        return torch.randint(lo, hi + 1, (n,), generator=g,
                             dtype=torch.int64, device=device)

    qty = uniform(1, 50)
    pk = uniform(1, scale_factor * PARTS_PER_SF)
    retail = 90000 + (pk // 10) % 20001 + 100 * (pk % 1000)   # cents
    return {"l_extendedprice": qty * retail, "l_discount": uniform(0, 10),
            "l_tax": uniform(0, 8)}


def segments(customers: int, seed: int, device) -> torch.Tensor:
    """c_mktsegment of every customer, as a code into ``MKTSEGMENTS``,
    from the seed alone."""
    g = torch.Generator(device=device)
    g.manual_seed(stream(seed, 1 << 20))
    return torch.randint(0, len(MKTSEGMENTS), (customers,), generator=g,
                         device=device)


def orders_customer_chunk(scale_factor: int, orders: int, lines: int,
                          customers: int, chunks: int, k: int, seed: int,
                          device) -> dict:
    """Chunk k of ``chunks``: ORDERS (o_custkey, o_totalprice in cents as
    int64) of its o_orderkey range, with its share of the ``lines``, and
    CUSTOMER (c_custkey, c_mktsegment) of its c_custkey range; beside
    them the ranges (``orders_range``, ``customers_range``, as row numbers
    from 0)."""
    lo, hi = chunk_range(orders, chunks, k)
    n = hi - lo
    llo, lhi = chunk_range(lines, chunks, k)
    g = torch.Generator(device=device)
    g.manual_seed(stream(seed, k))
    n_keys = customers * 2 // 3              # customers that place orders
    j = torch.randint(0, n_keys, (n,), generator=g, device=device)
    o_custkey = 3 * (j // 2) + 1 + j % 2     # 1, 2, 4, 5, 7, ...
    del j
    count = line_counts(n, lhi - llo, g, device)
    o_totalprice = torch.zeros(n, dtype=torch.int64, device=device)
    for b in range(0, n, BLOCK):
        c = count[b:b + BLOCK]
        m = int(c.sum())
        share = order_total(line_money(m, scale_factor, g, device))
        o_totalprice[b:b + c.numel()].index_add_(0, torch.repeat_interleave(
            torch.arange(c.numel(), device=device), c, output_size=m), share)
        del share
    del count
    clo, chi = chunk_range(customers, chunks, k)
    every = segments(customers, seed, device)
    return {"o_custkey": o_custkey, "o_totalprice": o_totalprice,
            "c_custkey": torch.arange(clo + 1, chi + 1, device=device),
            "c_mktsegment": every[clo:chi].clone(), "orders_range": (lo, hi),
            "customers_range": (clo, chi)}
