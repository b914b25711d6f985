"""The NCCL send/recv kernel's share of its roofline: the least bytes a
card must send off the card in the query (``harness/link_bytes.py``: the
surviving orders that belong to another card's customers, 16 B each),
over rank 0's time in the kernels that carry the all-to-alls
(``ncclDevKernel_SendRecv``), at NVLink 4's data-sheet rate in one
direction. The kernel's time holds its waits for the other cards too.
The least bytes are below what any exchange sends, so the share is at
most 100%."""
from benchmark.harness.link_bytes import (NVLINK_BYTES_PER_S,
                                          least_off_card_bytes)


def is_sendrecv(name: str) -> bool:
    return name.startswith("nccl") and "SendRecv" in name


def read(run):
    need = took = 0
    for r in run.trace.requests:
        facts = r.request.facts or {}
        ns = r.device_ns(is_sendrecv)
        if ns and "partitions" in facts and r.request.survivors:
            need += least_off_card_bytes(r.request.survivors,
                                         facts["partitions"])
            took += ns
    if not took:
        return None
    return 100.0 * need / NVLINK_BYTES_PER_S / (took / 1e9)
