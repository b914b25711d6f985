"""Byte counts of the exchange between cards, shared by the link metrics:
what the query must move whatever implements it, and the link's peak.

An order above :X must reach its customer's card; CUSTOMER can stay where
the chunks put it if the orders are routed by their customer's chunk, and
the aggregate over five groups needs no row exchange (each card's partial
groups suffice). So the least that leaves a card is the (P−1)/P of its
surviving orders that belong to another card's customers, each its key
and its price: 16 B a row."""
from __future__ import annotations

# NVLink 4 on the H100 SXM in one direction (data sheet: 900 GB/s both
# ways); a card sends and receives at once, so its sends alone are bound
# by this rate
NVLINK_BYTES_PER_S = 450e9
ROW_BYTES = 16


def least_off_card_bytes(survivors: int, partitions: int) -> float:
    """Bytes one card must send in a query whose ``survivors`` orders (over
    all cards) pass the filter, with the orders spread evenly over
    ``partitions`` cards."""
    p = partitions
    return survivors / p * (p - 1) / p * ROW_BYTES
